"""Where the time of the port's batched point + line VO step goes, on a
GPU: the default configuration, or with `--dense` the dense single-octave
line detector (lsd_octaves=1) with the run candidate generator that
`--generator` names, or with `--edlines` the EDLine detector
(use_edlines=True) at `--edline-scale`.

    python3 tools/profile_torch_step.py [--steps 3] [--dense]
        [--generator all_direction|per_direction]
        [--edlines [--edline-scale 1|2]]

Renders chip_smoke.py's 8 KITTI-sized lanes, warms the step up, then
(1) times the step's phases with the host clock around synchronized calls
(front end, f2f matching of points and of lines, pose optimization, and
`track_and_update`, the whole of everything after the front end, which
runs the matching and the optimization once more; the line half of the
front end is run once more on its own as `front_end_lines`, and
`line_half_share` sets it, with the line f2f matching, against the
unprofiled step), (2) times
whole unprofiled steps with the host clock, synchronized only at the ends
(`step_ms`), and (3) traces whole steps with torch.profiler: device time
and kernel launches per step, and the operators with the most host and
device time.  `device_busy_share` is the traced device time per step over
the unprofiled `step_ms` (the profiler's own cost inflates the traced
step's wall time, `profiled_ms_per_step`).  Prints one JSON object and
writes it to chiprun_out/profile_torch_step.json
(profile_torch_step_edlines<scale>.json with `--edlines`).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from stvo_pl_tpu_torch.config import VOConfig  # noqa: E402
from stvo_pl_tpu_torch.models import frame as frame_mod  # noqa: E402
from stvo_pl_tpu_torch.models import frontend, optimizer  # noqa: E402
from stvo_pl_tpu_torch.ops import camera as cam_ops  # noqa: E402
from stvo_pl_tpu_torch.parallel import batched  # noqa: E402
from stvo_pl_tpu_torch.utils import synthetic  # noqa: E402

BATCH = 8


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--dense", action="store_true",
                    help="profile VOConfig(lsd_octaves=1)")
    ap.add_argument("--generator", default="all_direction",
                    choices=("all_direction", "per_direction"),
                    help="run candidate generator of the dense detector")
    ap.add_argument("--edlines", action="store_true",
                    help="profile VOConfig(use_edlines=True)")
    ap.add_argument("--edline-scale", type=int, default=2,
                    help="edline_scale with --edlines (2: the quality "
                    "mode's half-resolution detection)")
    args = ap.parse_args()
    if args.edlines and args.dense:
        ap.error("--edlines and --dense name two line detectors")
    if args.generator == "per_direction" and not args.dense:
        ap.error("--generator per_direction needs --dense: the octave "
                 "canvas always takes the all-direction generator")
    per_direction = args.generator == "per_direction"
    if not torch.cuda.is_available():
        raise SystemExit("profile_torch_step: needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    cam = cam_ops.StereoCamera(fx=718.856, fy=718.856, cx=613.0, cy=185.0,
                               b=0.5372, width=1226, height=370)
    if args.edlines:
        cfg = VOConfig(use_edlines=True, edline_scale=args.edline_scale)
        config = f"use_edlines=True, edline_scale={args.edline_scale}"
    elif args.dense:
        cfg, config = VOConfig(lsd_octaves=1), "lsd_octaves=1"
    else:
        cfg, config = VOConfig(), "default"
    llength = cfg.min_line_length * min(cam.width, cam.height)
    n = 2 + 3 * args.steps + 1
    poses = synthetic.smooth_trajectory(n, speed=0.8, device=dev)
    L, R = [], []
    for b in range(BATCH):
        gen = torch.Generator(device=dev).manual_seed(1000 + b)
        scene = synthetic.make_scene(gen, n_points=1400, n_lines=64,
                                     extent=(40.0, 15.0, 90.0), z_near=5.0)
        left, right = synthetic.render_sequence(scene, poses, cam)
        L.append(left)
        R.append(right)
    L, R = torch.stack(L), torch.stack(R)

    def step(state, i):
        return batched.vo_step_batched(
            state, L[:, i].contiguous(), R[:, i].contiguous(), cam, cfg,
            per_direction=per_direction)

    state = batched.init_batched_state(cfg, BATCH)
    for i in range(2):
        state, _ = step(state, i)
    torch.cuda.synchronize()

    # (1) phases, host clock around synchronized calls
    phases = {"front_end": 0.0, "front_end_lines": 0.0, "f2f_match": 0.0,
              "f2f_match_lines": 0.0, "optimize_pose": 0.0,
              "track_and_update": 0.0}

    def line_half(img_l, img_r):
        if args.dense or args.edlines:
            return frame_mod.extract_stereo_features(
                img_l, img_r, state.fast_th, llength, cam,
                cfg.replace(has_points=False),
                per_direction=per_direction).lines
        B = img_l.shape[0]
        cv = frame_mod.octave_canvas(torch.cat([img_l, img_r]), cfg)
        sl, ol, dl = frame_mod.lines_from_canvas(
            frame_mod._slice_canvas(cv, slice(0, B)), llength, cfg)
        sr, _, dr = frame_mod.lines_from_canvas(
            frame_mod._slice_canvas(cv, slice(B, 2 * B)), llength, cfg,
            pool=cfg.lsd_oct_pool_right)
        return frame_mod.match_stereo_lines(sl, dl, sr, dr, cam, cfg,
                                            level_l=ol)

    def clock(name, fn, *a):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*a)
        torch.cuda.synchronize()
        phases[name] += (time.perf_counter() - t0) * 1e3
        return out

    for i in range(2, 2 + args.steps):
        feats = clock("front_end", frame_mod.extract_stereo_features,
                      L[:, i].contiguous(), R[:, i].contiguous(),
                      state.fast_th, llength, cam, cfg, per_direction)
        clock("front_end_lines", line_half, L[:, i].contiguous(),
              R[:, i].contiguous())
        pm = clock("f2f_match", frontend.match_f2f_points,
                   state.prev_points, feats.points, cfg, cam)
        lm = clock("f2f_match_lines", frontend.match_f2f_lines,
                   state.prev_lines, feats.lines, cfg, cam)
        clock("optimize_pose", optimizer.optimize_pose, pm, lm, cam, cfg,
              state.DT, state.DT_cov, state.err_norm)
        state, _ = clock("track_and_update", frontend._track_and_update,
                         state, feats, cam, cfg)
    phases = {k: v / args.steps for k, v in phases.items()}

    # (2) whole steps, unprofiled
    s0 = 2 + args.steps
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(s0, s0 + args.steps):
        state, _ = step(state, i)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3 / args.steps

    # (3) whole steps under the profiler
    from torch.profiler import ProfilerActivity, profile
    s0 += args.steps
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for i in range(s0, s0 + args.steps):
            state, _ = step(state, i)
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / args.steps
    events = prof.key_averages()
    kernels = [e for e in events if e.device_type.name == "CUDA"]
    dev_us = sum(e.self_device_time_total for e in kernels)
    launches = sum(e.count for e in kernels)
    top_dev = sorted(kernels, key=lambda e: -e.self_device_time_total)[:12]
    ops = [e for e in events if e.device_type.name == "CPU"
           and e.key.startswith("aten::")]
    top_cpu = sorted(ops, key=lambda e: -e.self_cpu_time_total)[:12]
    out = {
        "card": smi, "lanes": BATCH, "steps": args.steps,
        "config": config,
        "generator": args.generator,
        "height": cam.height, "width": cam.width,
        "phase_ms_per_step": phases,
        "step_ms": step_ms,
        "line_half_share": (phases["front_end_lines"]
                            + phases["f2f_match_lines"]) / step_ms,
        "profiled_ms_per_step": wall_ms,
        "device_busy_ms_per_step": dev_us / 1e3 / args.steps,
        "device_busy_share": dev_us / 1e3 / args.steps / step_ms,
        "kernel_launches_per_step": launches / args.steps,
        "top_device": [{"name": e.key[:80], "count": e.count / args.steps,
                        "us_per_step": e.self_device_time_total / args.steps}
                       for e in top_dev],
        "top_host_ops": [{"name": e.key, "count": e.count / args.steps,
                          "us_per_step": e.self_cpu_time_total / args.steps}
                         for e in top_cpu],
    }
    os.makedirs("chiprun_out", exist_ok=True)
    name = (f"profile_torch_step_edlines{args.edline_scale}.json"
            if args.edlines else "profile_torch_step.json")
    with open(os.path.join("chiprun_out", name), "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
