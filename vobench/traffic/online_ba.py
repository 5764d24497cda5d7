"""The `online_ba` traffic kind: one robot on its sensor's schedule, an
open loop.

Frame k of the window is due at k / rate_hz seconds after the window's
start, whether or not the previous frame is done.  The lane drives through
`sequences` sequences of `seq_frames` frames in turn, each through a scene
of its own; at each sequence's start the VO state is reset and a fresh
`WindowedBA` (empty ring, no chain correction) takes over, so the ring and
the BA restart with each sequence.  Each frame runs
the captured one-lane step, brings its telemetry to the host and feeds
`WindowedBA.observe` as the CLI does; a frame that closes a BA window
refines it before the frame is done.

- `frame_ms_p95`: the 95th percentile over every frame of the window of
  the time from the frame's due time to its pose on the host with
  `observe` returned.
- How late the generator ran (a frame dispatched after its due time
  because the previous one was not done) is printed, not reported.

For the comparison it keeps, per pass, the windows `observe` returned,
and each frame's pose, keyframe flag and the point and line sets the step
handed to `observe` (the step's own outputs, held, not copied), so that
the reference refines the same windows after the window has closed.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from vobench.reference.compare import Frames
from vobench.system import TELEMETRY
from vobench.traffic.fleet import Result

_GOOD, _KF, _INL_LS = (16 + TELEMETRY.index(f) for f in
                       ("good", "is_kf", "n_inliers_ls"))


def run(system, pool, mix: dict, seconds: float, tracer,
        on_warm=None) -> Result:
    """Warm up (set-up: the step's capture and the first BA window's), then
    the window of `seconds`, then, with the tracer on, a traced slice of
    `traced_frames` frames on the same schedule.  pool: (left, right)
    [sequences * seq, H, W] on the device, sequence-major."""
    T, S = mix["seq_frames"], mix["sequences"]
    period = 1.0 / mix["rate_hz"]
    dev = pool[0].device
    host = torch.empty((1, system.pack_width), dtype=torch.float32,
                       pin_memory=dev.type == "cuda")
    frames = Frames()
    events: dict = {}
    ba_frames: list = []
    step_ms: list = []
    lat: list = []
    late: list = []
    refine_s: list = []
    run_state = dict(state=None, ba=None, k=0)

    def one(k, due, record):
        f = k % T
        row = (k // T) % S * T + f
        if f == 0:
            if run_state["ba"] is not None:
                refine_s.extend(run_state["ba"].refine_times)
            run_state["state"] = system.fresh()
            run_state["ba"] = system.new_ba()
        ba = run_state["ba"]
        t0 = time.perf_counter()
        with tracer.span("vobench.step"):
            state, telem = system.step(run_state["state"], pool[0][row],
                                       pool[1][row])
        with tracer.span("vobench.telemetry"):
            host.copy_(system.pack(telem), non_blocking=True)
            if dev.type == "cuda":
                torch.cuda.current_stream().synchronize()
        t1 = time.perf_counter()
        v = host.numpy()[0].copy()
        Tfw = v[:16].reshape(4, 4)
        with tracer.span("vobench.ba_observe"):
            ev = system.observe(ba, f, Tfw, bool(v[_KF] > 0.5), state)
        t2 = time.perf_counter()
        run_state["state"] = state
        if record:
            step_ms.append((t1 - t0) * 1e3)
            lat.append(t2 - due)
            late.append(max(0.0, t0 - due))
            frames.add([0], [0], [k // T], [f], Tfw[None], [v[_KF] > 0.5],
                       [v[_GOOD] > 0.5], [v[_INL_LS]])
            ba_frames.append((k // T, f, Tfw.copy(), bool(v[_KF] > 0.5),
                              *system.keyframe_sets(state)))
            if ev is not None:
                events.setdefault(k // T, []).append(
                    (list(ev[0]), np.asarray(ev[1])))

    def drive(n_frames, record=True, paced=True):
        t_start = time.perf_counter()
        for j in range(n_frames):
            due = t_start + j * period
            if paced:
                wait = due - time.perf_counter()
                if wait > 0:
                    with tracer.span("vobench.sleep"):
                        time.sleep(wait)
            else:
                due = time.perf_counter()
            one(run_state["k"], due, record)
            run_state["k"] += 1

    # set-up: the step's capture, and at least one BA window (its refiner's
    # capture) before the sequence starts over for the window
    drive(mix["warmup_frames"], record=False, paced=False)
    run_state.update(k=0, ba=None)
    refine_s.clear()
    if on_warm is not None:
        on_warm()
    drive(int(round(seconds * mix["rate_hz"])))
    e2e = dict(frame_ms_p95=float(np.percentile(lat, 95)) * 1e3)
    summary = None
    traced = 0
    if tracer.enabled:
        tracer.start()
        with tracer.span("vobench.window"):
            drive(mix["traced_frames"])
            traced = mix["traced_frames"]
        summary = tracer.stop()
    if run_state["ba"] is not None:
        refine_s.extend(run_state["ba"].refine_times)
        run_state["ba"] = None
    e2e["late_ms_p95"] = float(np.percentile(late, 95)) * 1e3
    e2e["late_ms_max"] = float(max(late)) * 1e3
    return Result(e2e=e2e, frames=frames, counted=frames,
                  steps_traced=traced, trace=summary, step_host_ms=step_ms,
                  refine_s=refine_s, ba=(events, ba_frames))


def build(config: dict, mix: dict, device):
    """The system this kind drives: the captured one-lane step and the
    windowed BA."""
    from vobench.system import Online
    return Online(config, mix["ba"], device)
