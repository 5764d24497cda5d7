"""Structured tracing / profiling (port of stvo_pl_tpu/utils/profiling.py;
the reference has only a manual chrono Timer printed to stdout,
src/timer.cpp:31-50).

Provides (a) the same simple wall-clock scope timer, (b) torch.profiler
trace capture into a Chrome-trace JSON file, (c) a parser that ranks
the newest trace's device operations (kernels, copies, memsets) by total
time, or its CPU operators when the trace has no device events, and (d)
stage stamps, which time the stages of a captured program's every run.

Stage stamps.  A replay of a CUDA graph runs no Python, so no host span
can mark a stage inside it.  The step's code calls `stamp(name)` where a
stage ends (`begin` first); inside a `stamping(ring)` block each call
writes the time of that point into the ring's row of the current run.
On CUDA the stamp is a one-thread kernel (`csrc/stage_stamp.cu`) that
writes the device's nanosecond clock (%globaltimer) once the work queued
before it has finished; captured, it is one kernel node of the graph, and
each replay writes its own row.  On the CPU, where the body runs
synchronously, the stamp takes `time.perf_counter_ns()` of the host.
Outside a `stamping` block a stamp is one check and does nothing, so a
bare step (`vo_step_batched`) launches nothing more.  A stamp reads and
writes only the ring: the step's results are the same with or without.
`parallel/compiled._Program` owns one `StageRing` and stamps its warm-up,
its capture and, on the CPU, every run; `StageRing.stages()` reads the
rows back.
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
RING_ROWS = 4096        # runs a StageRing keeps


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


_rings: list = []           # the StageRings of the blocks open, innermost last


def stamp(name: str) -> None:
    """Mark the end of the stage before this point (`begin` starts a
    run) in the innermost open `stamping` block's ring; outside any such
    block, nothing."""
    if _rings:
        _rings[-1].stamp(name)


@contextlib.contextmanager
def stamping(ring: "StageRing"):
    """Inside the block, `stamp` writes into `ring`: the block is one run
    of the body (on CUDA the warm-up or the capture)."""
    ring.begin_run()
    _rings.append(ring)
    try:
        yield ring
    finally:
        _rings.pop()
    ring.end_run()


def stage_stamp(buf: torch.Tensor, rows: int, width: int, k: int,
                last: bool) -> None:
    """Launch `stage_stamp_kernel` on the current stream: the device clock
    into entry `k` of row `counter % rows` of `buf` (int64 [rows * width
    + 1], the counter last), and `counter += 1` if `last`.  Counted in
    `stage_stamp.launches`."""
    from stvo_pl_tpu_torch import build
    if buf.dtype != torch.int64 or buf.device.type != "cuda" \
            or buf.numel() != rows * width + 1:
        raise ValueError("stage_stamp takes an int64 CUDA buffer of rows x "
                         "width entries and a counter")
    ptr = buf.data_ptr()
    rc = build.library().stvo_stage_stamp(
        ptr, ptr + 8 * rows * width, rows, width, k, int(last),
        torch.cuda.current_stream(buf.device).cuda_stream)
    build.check(rc, "stage_stamp")
    stage_stamp.launches += 1


stage_stamp.launches = 0


class StageRing:
    """The stage stamps of one program's runs: `rows` rows of int64
    nanoseconds, one per run and one entry per stamp, and the count of
    runs written, in one buffer on `device` (the count last).  The first
    run (on CUDA the warm-up, whose stamps write into a scratch word)
    fixes the names; every later run must stamp the same names in the
    same order, or it raises.  A body that stamps nothing has no buffer
    and no names."""

    def __init__(self, device, rows: int = RING_ROWS):
        self.device = torch.device(device)
        self.rows = rows
        self.names: tuple | None = None     # fixed by the first run
        self.buf: torch.Tensor | None = None
        self._run: list = []                # the run's names so far
        self._host: list = []               # CPU: the run's host times
        self._scratch: torch.Tensor | None = None

    def begin_run(self):
        self._run, self._host = [], []

    def stamp(self, name: str):
        k = len(self._run)
        self._run.append(name)
        if self.device.type == "cpu":
            self._host.append(time.perf_counter_ns())
        elif self.names is None:
            # the warm-up: load the kernel before any capture, write
            # nowhere that matters (allocated on the stream that uses it)
            if self._scratch is None:
                self._scratch = torch.zeros(2, dtype=torch.int64,
                                            device=self.device)
            stage_stamp(self._scratch, 1, 1, 0, False)
        else:
            S = len(self.names)
            if k >= S or self.names[k] != name:
                raise RuntimeError(
                    f"stamp {name!r} at position {k}: the first run "
                    f"stamped {list(self.names)}")
            stage_stamp(self.buf, self.rows, S, k, k == S - 1)

    def end_run(self):
        run, self._run = tuple(self._run), []
        if self.names is None:
            self.names, self._scratch = run, None
            if run:
                self.buf = torch.zeros(self.rows * len(run) + 1,
                                       dtype=torch.int64, device=self.device)
        elif run != self.names:
            raise RuntimeError(f"a run stamped {list(run)}, the first run "
                               f"{list(self.names)}")
        if self.device.type == "cpu" and run:
            ring = self.buf.numpy()
            slot = int(ring[-1]) % self.rows
            ring[slot * len(run):(slot + 1) * len(run)] = self._host
            ring[-1] += 1

    def stages(self) -> tuple[list, torch.Tensor]:
        """(names, ns): ns int64 [min(runs, rows), len(names)] on the CPU,
        the stamps of the most recent runs, oldest first.  One copy from
        the device, which waits for the runs queued before it."""
        if not self.names:
            return [], torch.zeros((0, 0), dtype=torch.int64)
        host = self.buf.cpu()
        n, S = int(host[-1]), len(self.names)
        ring = host[:-1].view(self.rows, S)
        if n <= self.rows:
            return list(self.names), ring[:n].clone()
        start = n % self.rows
        return list(self.names), torch.cat([ring[start:], ring[:start]])
