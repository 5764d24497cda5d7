"""Where one windowed-BA refinement's time goes on the GPU, for each
Hamming route of the track building.

    python3 tools/profile_torch_ba.py [--reps 5]

Writes chip_smoke.py's textured street (40 frames, the bundled
photograph, tools/export_street_torch.py) to build/chip_smoke_street/,
or keeps the one chip_smoke.py wrote there, takes the first window of 4
keyframes of its first 10 frames as `ba_popcount` does
(chip_smoke.first_window: the CLI's back end, VOConfig()), and for
`hamming_use_mxu` True (the bf16 product) and False (kernel B5) times
`parallel/window.refine_window_auto` unprofiled, the two routes in
turns, then profiles one call of each with torch.profiler: host wall
time, CUDA kernel launches and device time, the device's busy share
(device time over the profiled call's wall time), and the host
operators that take the most time.  Prints one JSON object, also
written to chiprun_out/profile_torch_ba.json.  Needs a CUDA device;
imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import torch

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tools"))


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_torch_ba: needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke as cs
    from export_street_torch import kitti_camera, write_street_dataset
    from stvo_pl_tpu_torch import build
    from stvo_pl_tpu_torch.config import VOConfig
    from stvo_pl_tpu_torch.parallel import window

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    build.build_all()
    cam = kitti_camera()
    root = os.path.join(ROOT, "build", "chip_smoke_street")
    write_street_dataset(root, cam, cs.CLI_FRAMES, photos="bundled")
    cfg = VOConfig()
    win, kf_frames = cs.first_window(root, cam, cfg)
    routes = {"bf16_product": cfg.replace(hamming_use_mxu=True),
              "popcount_kernel": cfg.replace(hamming_use_mxu=False)}

    def refine(c):
        return window.refine_window_auto(win, cam, c, n_iters=8)

    res = {name: dict(ms=[]) for name in routes}
    for c in routes.values():
        refine(c)
    torch.cuda.synchronize()
    for _ in range(args.reps):              # unprofiled, in turns
        for name, c in routes.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            refine(c)
            torch.cuda.synchronize()
            res[name]["ms"].append((time.perf_counter() - t0) * 1e3)
    for name, c in routes.items():          # profiled last
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            refine(c)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        ev = prof.key_averages()
        gpu = [e for e in ev if e.device_type.name == "CUDA"]
        device_ms = sum(e.self_device_time_total for e in gpu) / 1e3
        host = sorted((e for e in ev if e.device_type.name == "CPU"),
                      key=lambda e: e.self_cpu_time_total, reverse=True)
        res[name].update(
            profiled_wall_ms=wall_ms, device_ms=device_ms,
            busy_share=device_ms / wall_ms,
            device_launches=sum(e.count for e in gpu),
            top_host_ops=[dict(op=e.key[:60], calls=e.count,
                               self_ms=e.self_cpu_time_total / 1e3)
                          for e in host[:10]])
    out = dict(card=smi, keyframes=kf_frames, K=len(kf_frames),
               point_slots=int(win.points.valid.numel()),
               line_slots=int(win.lines.valid.numel()), routes=res)
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "profile_torch_ba.json"),
              "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
