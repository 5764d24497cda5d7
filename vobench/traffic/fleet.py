"""The `fleet` traffic kind: fleet replay, a closed loop of B lanes.

Each lane replays its own sequence of `seq_frames` frames from the pool
and, at the sequence's end, has its slice of the state reset to the
initial values on the device and starts the sequence again.  Lane i
starts at frame floor(seq_frames * i / B), so the resets are spread over
the steps.  As the program's CLI pipelines its loop, at most one step is
in flight beyond the one whose telemetry the host waits for.

- `frames_per_s`: lane-frames whose pose reached the host, over the time
  from the window's first dispatch to its last telemetry.
- `frame_ms_p95`: the 95th percentile over every step of the window (each
  carries B lane-frames) of the time from the step's dispatch to its
  telemetry on the host.

`attempted` and `failed` count the lane-frames of the window's first
2 x `seq_frames` steps only, in which every lane meets every frame of its
sequence twice (its first pass, one full pass after a reset, the start of
the next), so that a faster program is counted on the same lanes, frames
and passes, from the same states, as a slower one; the steps after them
repeat those passes from the same reset state.  A window that holds fewer
steps is followed by the rest of them, untimed.  `correct` judges every
lane-frame of the run.
"""

from __future__ import annotations

import time
from typing import NamedTuple

import numpy as np
import torch

from vobench.reference.compare import Frames
from vobench.system import TELEMETRY

_GOOD, _KF, _INL_LS = (16 + TELEMETRY.index(f) for f in
                       ("good", "is_kf", "n_inliers_ls"))


class Schedule(NamedTuple):
    lanes: int
    seq: int
    offsets: np.ndarray        # [B] start frame of each lane

    @classmethod
    def make(cls, lanes: int, seq: int) -> "Schedule":
        return cls(lanes, seq, np.array([seq * i // lanes
                                         for i in range(lanes)]))

    def frames(self, step: int) -> np.ndarray:
        """[B] sequence frame of each lane at global step `step`."""
        return (self.offsets + step) % self.seq

    def pass_start(self, step: int) -> np.ndarray:
        """[B] frame at which each lane's current pass started: its offset
        for its first pass, 0 for every later one."""
        return np.where(self.offsets + step < self.seq, self.offsets, 0)

    def pass_no(self, step: int) -> np.ndarray:
        return (self.offsets + step) // self.seq

    def resets(self, step: int) -> np.ndarray:
        """Lanes that start a new pass at `step` (never at step 0, where
        every lane starts from the initial state anyway)."""
        if step == 0:
            return np.zeros(0, np.int64)
        return np.nonzero(self.frames(step) == 0)[0]


class Result(NamedTuple):
    e2e: dict
    frames: Frames      # every answer of the run: `correct` judges them
    counted: Frames     # the answers that `attempted` and `failed` count
    steps_traced: int
    trace: object
    step_host_ms: list
    refine_s: list
    ba: object          # (events, frames) of the BA windows, or None


def run(system, pool, mix: dict, seconds: float, tracer,
        on_warm=None) -> Result:
    """Warm up (set-up), then drive the window for `seconds`, then, with
    the tracer on, a traced slice of `traced_steps` steps.  pool: (left,
    right) [B * seq, H, W] lane-major on the device."""
    B, T = system.lanes, mix["seq_frames"]
    sched = Schedule.make(B, T)
    dev = pool[0].device
    lane_base = np.arange(B) * T
    # per step phase: the pool rows of the lanes' frames, and the lanes
    # that reset there, as device tensors built once
    phase_idx = [torch.as_tensor(lane_base + sched.frames(p), device=dev)
                 for p in range(T)]
    phase_reset = [torch.as_tensor(sched.resets(p if p else T), device=dev)
                   for p in range(T)]
    host = [torch.empty((B, system.pack_width), dtype=torch.float32,
                        pin_memory=dev.type == "cuda") for _ in range(2)]
    frames, counted = Frames(), Frames()
    count_until = mix["warmup_steps"] + 2 * T   # steps before it count
    lat: list = []
    state = system.fresh()

    def dispatch(s, record):
        nonlocal state
        p = s % T
        if s and len(sched.resets(s)):
            with tracer.span("vobench.reset"):
                system.reset(state, phase_reset[p])
        with tracer.span("vobench.copy_in"):
            imgs_l = pool[0].index_select(0, phase_idx[p])
            imgs_r = pool[1].index_select(0, phase_idx[p])
        t0 = time.perf_counter()
        with tracer.span("vobench.step"):
            state, telem = system.step(state, imgs_l, imgs_r)
        with tracer.span("vobench.telemetry"):
            buf = host[s % 2]
            buf.copy_(system.pack(telem), non_blocking=True)
            done = None
            if dev.type == "cuda":
                done = torch.cuda.Event()
                done.record()
        return (s, t0, buf, done, record)

    def consume(entry):
        s, t0, buf, done, record = entry
        with tracer.span("vobench.wait"):
            if done is not None:
                done.synchronize()
        t1 = time.perf_counter()
        v = buf.numpy().copy()
        if record:
            lat.append(t1 - t0)
            rows = (np.arange(B), sched.pass_start(s), sched.pass_no(s),
                    sched.frames(s), v[:, :16].reshape(B, 4, 4),
                    v[:, _KF] > 0.5, v[:, _GOOD] > 0.5, v[:, _INL_LS])
            frames.add(*rows)
            if s < count_until:
                counted.add(*rows)
        return t1

    def drive(s, until=None, n=None, record=True):
        """Steps from `s` until the host clock passes `until` (or `n`
        steps), pipelined one deep; returns (next step, first dispatch
        time, last telemetry time)."""
        first, last, in_flight, k = None, None, None, 0
        while (n is None or k < n) and (until is None
                                         or time.perf_counter() < until):
            entry = dispatch(s, record)
            first = entry[1] if first is None else first
            if in_flight is not None:
                last = consume(in_flight)
            in_flight, s, k = entry, s + 1, k + 1
        if in_flight is not None:
            last = consume(in_flight)
        return s, first, last

    s, _, _ = drive(0, n=mix["warmup_steps"], record=False)
    if on_warm is not None:
        on_warm()
    s0 = s
    s, t_first, t_last = drive(s, until=time.perf_counter() + seconds)
    steps = s - s0
    e2e = dict(frames_per_s=steps * B / (t_last - t_first),
               frame_ms_p95=float(np.percentile(lat, 95)) * 1e3)
    if s < count_until:                     # the counted steps, untimed
        s, _, _ = drive(s, n=count_until - s)
    summary, traced = None, 0
    if tracer.enabled:
        tracer.start()
        with tracer.span("vobench.window"):
            s1 = s
            s, _, _ = drive(s, n=mix["traced_steps"])
            traced = s - s1
        summary = tracer.stop()
    return Result(e2e=e2e, frames=frames, counted=counted,
                  steps_traced=traced, trace=summary, step_host_ms=[],
                  refine_s=[], ba=None)


def build(config: dict, mix: dict, device):
    """The system this kind drives: B lanes of the captured batched
    step."""
    from vobench.system import Fleet
    return Fleet(config, mix["lanes"], device)
