"""Structured tracing / profiling (port of stvo_pl_tpu/utils/profiling.py;
the reference has only a manual chrono Timer printed to stdout,
src/timer.cpp:31-50).

Provides (a) the same simple wall-clock scope timer, (b) torch.profiler
trace capture into a Chrome-trace JSON file, and (c) a parser that ranks
the newest trace's device operations (kernels, copies, memsets) by total
time, or its CPU operators when the trace has no device events.
"""

from __future__ import annotations

import contextlib
import glob
import json
import os
import time
from collections import defaultdict

import torch

TRACE_SUFFIX = ".pt.trace.json"
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")


class Timer:
    """Reference-equivalent scope timer (ms).  It reads the host clock
    only: GPU work is asynchronous, so the caller synchronizes
    (`torch.cuda.synchronize()`) before the timer stops."""

    def __init__(self):
        self._t0 = None
        self.ms = 0.0

    def start(self):
        self._t0 = time.perf_counter()

    def stop(self) -> float:
        self.ms = (time.perf_counter() - self._t0) * 1e3
        return self.ms

    def __enter__(self):
        self.start()
        return self

    def __exit__(self, *a):
        self.stop()


@contextlib.contextmanager
def device_trace(logdir: str):
    """Trace a block with torch.profiler (CPU activity, and CUDA activity
    when a GPU is present) and write it as `<logdir>/trace-<ns>-<pid>`
    `.pt.trace.json`.  Yields the profiler."""
    from torch.profiler import ProfilerActivity, profile
    cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU] + (
        [ProfilerActivity.CUDA] if cuda else [])
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
        if cuda:
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(
        logdir, f"trace-{time.time_ns()}-{os.getpid()}{TRACE_SUFFIX}"))


def newest_trace(logdir: str) -> str:
    """The most recently written trace file under `logdir`."""
    files = glob.glob(os.path.join(logdir, "**", "*" + TRACE_SUFFIX),
                      recursive=True)
    if not files:
        raise FileNotFoundError(f"no *{TRACE_SUFFIX} under {logdir}")
    return max(files, key=lambda p: (os.path.getmtime(p), p))


def summarize_trace(logdir: str, top: int | None = 25):
    """Parse the newest trace under logdir; return [(name, total_ms,
    count)] of its device events (categories kernel, gpu_memcpy,
    gpu_memset), largest total first, or of its CPU operators when it has
    no device events.  `top=None` returns every name."""
    with open(newest_trace(logdir)) as f:
        trace = json.load(f)
    events = trace["traceEvents"] if isinstance(trace, dict) else trace
    spans = [e for e in events if e.get("ph") == "X" and "dur" in e]
    chosen = [e for e in spans if e.get("cat") in DEVICE_CATEGORIES]
    if not chosen:
        chosen = [e for e in spans if e.get("cat") == "cpu_op"]
    tot = defaultdict(float)        # us
    cnt = defaultdict(int)
    for e in chosen:
        tot[e["name"]] += float(e["dur"])
        cnt[e["name"]] += 1
    items = sorted(tot.items(), key=lambda kv: -kv[1])[:top]
    return [(name, us / 1e3, cnt[name]) for name, us in items]
