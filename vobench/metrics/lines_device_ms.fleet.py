"""Device time of the line half of the front end (models/frame: the line
detector, LBD and stereo line matching of both eyes): from the stage
stamp before it to its own (vobench/stages.py), mean over the traced
replays of the captured step."""

from vobench.stages import stage_ms


def read(r):
    return stage_ms(r, "lines")
