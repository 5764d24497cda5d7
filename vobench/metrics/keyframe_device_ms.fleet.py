"""Device time of the keyframe decision, the FAST controller and the
commit of the state (models/frontend.keyframe_update and what follows
it): from the stage stamp before it to its own (vobench/stages.py), mean
over the traced replays of the captured step."""

from vobench.stages import stage_ms


def read(r):
    return stage_ms(r, "keyframe")
