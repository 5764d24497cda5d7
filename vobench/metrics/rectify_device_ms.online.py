"""Device time of the rectification inside the one-lane captured step
(ops/camera.remap_taps of the rig's raw pair): from the `begin` stamp to
the `rectify` stamp (vobench/stamps.py), mean over the traced replays."""

from vobench.stamps import RECTIFIED, span_ms


def read(r):
    return span_ms(r, RECTIFIED, "begin", "rectify")
