"""Device time of all kernels of the traced window (the captured step's
replays and the harness's own small kernels around them), summed, per
step traced."""


def read(r):
    if r.trace is None or not r.steps_traced:
        return None
    return sum(e.dur for e in r.trace.kernels) * 1e-3 / r.steps_traced
