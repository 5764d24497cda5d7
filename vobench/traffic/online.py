"""The `online` traffic kind: one robot on its sensor's schedule, an open
loop, with no back end.

Frame k of the window is due at k / rate_hz seconds after the window's
start, whether or not the previous frame is done.  The lane drives through
`sequences` sequences of `seq_frames` frames in turn, each through a scene
of its own, its VO state reset at each sequence's start.  Each frame runs
the system's one-lane step and brings its telemetry to the host.  With
`raw: true` the rendered pool is first made the rig's raw frames
(vobench/reference/rectify.py `raw_pool`, part of the set-up), and the
system's step rectifies them.

- `frame_ms_p95`: the 95th percentile over every frame of the window of
  the time from the frame's due time to its pose on the host (as the
  `online_ba` kind counts it).
- How late the generator ran (a frame dispatched after its due time
  because the previous one was not done) is printed, not reported.

The generator sleeps until each due time, as the `online_ba` kind does.
The set-up runs `warmup_frames` frames unpaced, then the sequence starts
over for the window.
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
    """Set-up (the raw frames, the step's capture and warm-up), then the
    window of `seconds`, then, with the tracer on, a traced slice of
    `traced_frames` frames on the same schedule.  pool: (left, right)
    [sequences * seq, H, W] on the device, sequence-major."""
    T, S = mix["seq_frames"], mix["sequences"]
    if mix.get("raw"):
        from vobench.reference.rectify import raw_pool
        pool = raw_pool(pool, system.config)
    period = 1.0 / mix["rate_hz"]
    dev = pool[0].device
    cuda = dev.type == "cuda"
    host = torch.empty((1, system.pack_width), dtype=torch.float32,
                       pin_memory=cuda)
    frames = Frames()
    step_ms: list = []
    lat: list = []
    late: list = []
    run_state = dict(state=None, k=0)

    def one(k, due, record):
        f = k % T
        row = (k // T) % S * T + f
        if f == 0:
            run_state["state"] = system.fresh()
        t0 = time.perf_counter()
        with tracer.span("vobench.step"):
            state, telem = system.step(run_state["state"], pool[0][row],
                                       pool[1][row])
        with tracer.span("vobench.telemetry"):
            host.copy_(system.pack(telem), non_blocking=True)
            if cuda:
                torch.cuda.current_stream().synchronize()
        t1 = time.perf_counter()
        run_state["state"] = state
        if record:
            v = host.numpy()[0].copy()
            step_ms.append((t1 - t0) * 1e3)
            lat.append(t1 - due)
            late.append(max(0.0, t0 - due))
            frames.add([0], [0], [k // T], [f], v[:16].reshape(1, 4, 4),
                       [v[_KF] > 0.5], [v[_GOOD] > 0.5], [v[_INL_LS]])

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

    drive(mix["warmup_frames"], record=False, paced=False)
    run_state["k"] = 0
    if on_warm is not None:
        on_warm()
    drive(int(round(seconds * mix["rate_hz"])))
    e2e = dict(frame_ms_p95=float(np.percentile(lat, 95)) * 1e3,
               late_ms_p95=float(np.percentile(late, 95)) * 1e3,
               late_ms_max=float(max(late)) * 1e3)
    summary = None
    traced = 0
    if tracer.enabled:
        tracer.start()
        with tracer.span("vobench.window"):
            drive(mix["traced_frames"])
            traced = mix["traced_frames"]
        summary = tracer.stop()
    return Result(e2e=e2e, frames=frames, counted=frames,
                  steps_traced=traced, trace=summary, step_host_ms=step_ms,
                  refine_s=[], ba=None)


def build(config: dict, mix: dict, device):
    """The system this kind drives: the captured one-lane step, built with
    the rig's rectification where the frames are raw."""
    from vobench.system_online import RawOnline
    return RawOnline(config, device, rectify=bool(mix.get("raw")))
