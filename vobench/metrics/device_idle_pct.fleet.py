"""Share of the traced window (the fleet loop's steps, with their copy-in,
telemetry and lane resets) in which no kernel, copy or memset ran on the
card: the union of the device intervals, from torch.profiler."""

from vobench.trace import busy_seconds, window_seconds


def read(r):
    if r.trace is None:
        return None
    return 100.0 * (1.0 - busy_seconds(r.trace) / window_seconds(r.trace))
