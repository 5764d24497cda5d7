"""The traced slice of a run: torch.profiler over a few steps, written as a
Chrome trace to the temporary directory, read back and deleted, and the
reductions that the per-layer readers and the breakdown take from it.

The drivers mark what the host is doing with spans of their own
(`Tracer.span`, recorded only while the profiler runs); the whole traced
slice is the span `WINDOW`.  Device time is that of the trace's kernels,
copies and memsets.
"""

from __future__ import annotations

import contextlib
import json
import os
import tempfile
from collections import defaultdict
from typing import NamedTuple

WINDOW = "vobench.window"
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")


class Event(NamedTuple):
    name: str
    ts: float       # microseconds, the trace's clock
    dur: float      # microseconds


class TraceSummary(NamedTuple):
    device: list            # [Event] kernels, copies, memsets
    kernels: list           # [Event] kernels only
    spans: list             # [Event] the drivers' host spans
    window: tuple           # (start, end) of the WINDOW span, us


class Tracer:
    """Spans around the calls into the program, and the profiler over the
    traced slice (`start` ... `stop`).  Off, or outside the slice, a span
    costs nothing."""

    def __init__(self, enabled: bool):
        self.enabled = enabled
        self._prof = None

    @property
    def active(self) -> bool:
        return self._prof is not None

    def span(self, name: str):
        if self._prof is None:
            return contextlib.nullcontext()
        import torch
        return torch.profiler.record_function(name)

    def start(self):
        import torch
        from torch.profiler import ProfilerActivity, profile
        torch.cuda.synchronize()
        self._prof = profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA])
        self._prof.__enter__()

    def stop(self) -> TraceSummary:
        import torch
        torch.cuda.synchronize()
        prof, self._prof = self._prof, None
        prof.__exit__(None, None, None)
        fd, path = tempfile.mkstemp(suffix=".pt.trace.json")
        os.close(fd)
        try:
            prof.export_chrome_trace(path)
            with open(path) as f:
                trace = json.load(f)
        finally:
            os.remove(path)
        return summarize(trace)


def summarize(trace) -> TraceSummary:
    """The device events, the drivers' spans and the window of a Chrome
    trace (a dict with `traceEvents`, or the list itself)."""
    events = trace["traceEvents"] if isinstance(trace, dict) else trace
    device, kernels, spans = [], [], []
    window = None
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        ev = Event(e.get("name", ""), float(e["ts"]), float(e["dur"]))
        cat = e.get("cat")
        if cat in DEVICE_CATEGORIES:
            device.append(ev)
            if cat == "kernel":
                kernels.append(ev)
        elif cat == "user_annotation" and ev.name.startswith("vobench."):
            if ev.name == WINDOW:
                window = (ev.ts, ev.ts + ev.dur)
            else:
                spans.append(ev)
    if window is None:
        raise RuntimeError(f"the trace has no {WINDOW} span")
    return TraceSummary(device=device, kernels=kernels, spans=spans,
                        window=window)


def busy_intervals(events, window) -> list[tuple[float, float]]:
    """The union of the events' intervals, clipped to the window, as
    sorted disjoint (start, end) pairs."""
    lo, hi = window
    ivs = sorted((max(e.ts, lo), min(e.ts + e.dur, hi)) for e in events
                 if e.ts < hi and e.ts + e.dur > lo)
    out: list = []
    for s, t in ivs:
        if out and s <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], t))
        else:
            out.append((s, t))
    return out


def busy_seconds(summary: TraceSummary) -> float:
    """Seconds of the window in which a kernel, copy or memset ran."""
    return sum(t - s for s, t in busy_intervals(summary.device,
                                                summary.window)) * 1e-6


def window_seconds(summary: TraceSummary) -> float:
    return (summary.window[1] - summary.window[0]) * 1e-6


def top_device_ops(summary: TraceSummary, n: int = 10) -> list:
    """[[name, seconds]] of the device operations that took most time in
    the window, summed by name."""
    tot: dict = defaultdict(float)
    for e in summary.device:
        tot[e.name[:120]] += e.dur * 1e-6
    return [[k, v] for k, v in sorted(tot.items(), key=lambda kv: -kv[1])[:n]]


def idle_by_host(summary: TraceSummary, n: int = 10) -> list:
    """[[what the host was doing, seconds]]: the window's idle device time
    summed by the innermost driver span open at the middle of each idle
    gap ("host outside the spans" where none is)."""
    lo, hi = summary.window
    busy = busy_intervals(summary.device, summary.window)
    gaps, t = [], lo
    for s, e in busy:
        if s > t:
            gaps.append((t, s))
        t = max(t, e)
    if t < hi:
        gaps.append((t, hi))
    spans = sorted(summary.spans, key=lambda e: e.ts)
    tot: dict = defaultdict(float)
    for s, e in gaps:
        mid = 0.5 * (s + e)
        label, width = "host outside the spans", float("inf")
        for sp in spans:
            if sp.ts > mid:
                break
            if sp.ts + sp.dur >= mid and sp.dur < width:
                label, width = "during " + sp.name, sp.dur
        tot[label] += (e - s) * 1e-6
    return [[k, v] for k, v in sorted(tot.items(), key=lambda kv: -kv[1])[:n]]
