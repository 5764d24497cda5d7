"""Replay time of the port's compiled VO step on a GPU, with its CUDA graph
kept (as chip_smoke.py keeps it, to read the graph's kernel nodes) and
not kept, in turns in one process.

    python3 tools/time_compiled_torch.py [--steps 10] [--turns 3]

Renders chip_smoke.py's 8 KITTI-sized lanes; for the default step and the
dense single-octave one (lsd_octaves=1) builds two `compile_vo_step`
programs, the second captured inside `chip_smoke.kept_graphs`, then
times `--steps` replays of each from a fresh state (after 2 untimed
ones), in turns: wall ms per step on the host clock and ms per step
between two CUDA events.  Also reads the SM clock under load.  Prints
one JSON object and writes it to chiprun_out/time_compiled_torch.json.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess
import sys
import time

import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import chip_smoke  # noqa: E402
from stvo_pl_tpu_torch import build  # noqa: E402
from stvo_pl_tpu_torch.config import VOConfig  # noqa: E402
from stvo_pl_tpu_torch.ops import camera as cam_ops  # noqa: E402
from stvo_pl_tpu_torch.parallel import batched  # noqa: E402
from stvo_pl_tpu_torch.utils import synthetic  # noqa: E402

BATCH = 8


def smi(query: str) -> str:
    return subprocess.run(["nvidia-smi", f"--query-gpu={query}",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--turns", type=int, default=3)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("time_compiled_torch: needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    build.build_all()
    dev = torch.device("cuda")
    cam = cam_ops.StereoCamera(fx=718.856, fy=718.856, cx=613.0, cy=185.0,
                               b=0.5372, width=1226, height=370)
    n = 2 + args.steps
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
    out = {"card": smi("name,power.limit"), "lanes": BATCH,
           "steps": args.steps, "turns": args.turns}
    for name, cfg in (("default", VOConfig()),
                      ("dense", VOConfig(lsd_octaves=1))):
        steps = {}
        for kind, ctx in (("plain", contextlib.nullcontext),
                          ("kept", chip_smoke.kept_graphs)):
            step = batched.compile_vo_step(cam, cfg, BATCH)
            with ctx():
                step(batched.init_batched_state(cfg, BATCH),
                     L[:, 0].contiguous(), R[:, 0].contiguous())
            steps[kind] = step
        wall = {k: [] for k in steps}
        event = {k: [] for k in steps}
        for _ in range(args.turns):
            for kind, step in steps.items():
                state = batched.init_batched_state(cfg, BATCH)
                for i in range(2):
                    state, _ = step(state, L[:, i].contiguous(),
                                    R[:, i].contiguous())
                torch.cuda.synchronize()
                e0 = torch.cuda.Event(enable_timing=True)
                e1 = torch.cuda.Event(enable_timing=True)
                t0 = time.perf_counter()
                e0.record()
                for i in range(2, n):
                    state, _ = step(state, L[:, i].contiguous(),
                                    R[:, i].contiguous())
                e1.record()
                torch.cuda.synchronize()
                wall[kind].append((time.perf_counter() - t0) * 1e3
                                  / args.steps)
                event[kind].append(e0.elapsed_time(e1) / args.steps)
        out[name] = dict(wall_ms_per_step=wall, event_ms_per_step=event)
        del steps
    out["sm_clock_after"] = smi("clocks.sm,clocks.max.sm")
    print(json.dumps(out))
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "time_compiled_torch.json"),
              "w") as f:
        json.dump(out, f)


if __name__ == "__main__":
    main()
