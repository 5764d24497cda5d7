"""Device time of the points half of the front end (models/frame: FAST,
ORB and stereo point matching of both eyes): from the stage stamp before
it to its own (vobench/stages.py), mean over the traced replays of the
captured step.  Also prints each stage's kernels, device time and longest
kernels per step to standard error."""

from vobench.stages import log_breakdown, stage_ms


def read(r):
    ms = stage_ms(r, "points")
    if ms is not None:
        log_breakdown(r)
    return ms
