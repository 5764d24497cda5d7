"""Device time of the pose optimiser (models/optimizer.optimize_pose):
from the stage stamp before it to its own (vobench/stages.py), mean over
the traced replays of the captured step."""

from vobench.stages import stage_ms


def read(r):
    return stage_ms(r, "optimizer")
