"""Device time of the one-lane step after the rectification (points,
lines, f2f, optimizer, keyframe): from the `rectify` stamp to the
`keyframe` stamp (vobench/stamps.py), mean over the traced replays.  Also
prints each stage's device time to standard error."""

from vobench.stamps import RECTIFIED, log_stages, span_ms


def read(r):
    ms = span_ms(r, RECTIFIED, "rectify", "keyframe")
    if ms is not None:
        log_stages(r, RECTIFIED)
    return ms
