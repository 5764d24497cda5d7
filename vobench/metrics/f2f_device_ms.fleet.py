"""Device time of the frame-to-frame matching
(models/frontend.match_f2f_points and match_f2f_lines): from the stage
stamp before it to its own (vobench/stages.py), mean over the traced
replays of the captured step."""

from vobench.stages import stage_ms


def read(r):
    return stage_ms(r, "f2f")
