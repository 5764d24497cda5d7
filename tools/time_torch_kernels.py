"""Device times of the port's FAST pack (B1), all-direction run pack (B3)
and one-direction run pack (B4) kernels at the main path's shapes, with
what the work of each depends on.

    python3 tools/time_torch_kernels.py [--tree DIR] [--tag NAME]
        [--kernels b1,b3,b4]

`--tree` names the directory whose `stvo_pl_tpu_torch` is imported (the
default is this checkout), so one call can time two trees in turns, e.g.
a `git archive` of the parent commit unpacked under `build/`:

    python3 tools/time_torch_kernels.py --tree build/parent --tag parent
    python3 tools/time_torch_kernels.py --tag change

Inputs are chip_smoke.py's: the first frames of its 8 KITTI-sized lanes,
both eyes (16 images), their 4 pyramid levels for B1, their octave
canvases' 8-direction bitmasks for B3 (and a 5%-dense random bitmask),
the 12 dense aligned masks for B4.  Times are CUDA-event device times
(chip_smoke.time_ms: calls queued behind a device-side sleep, least of 3
batch means).  The split of B3 into its kernels comes from torch.profiler.
Also reported: the share of pixels with a positive FAST response per
level, and per B3 direction the share of set bits, run pixels, run starts
and the hops a walk from every start would take (sum of min(run, 256)).
Prints one JSON object and writes it to chiprun_out/time_kernels_<tag>.json.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys

import torch

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, ".."))

from chip_smoke import fast_positive_share, time_ms  # noqa: E402

BATCH = 8
N_FRAMES = 26


def kernel_split_us(fn, reps: int = 10) -> dict:
    """Device microseconds per call of each CUDA kernel that fn launches."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return {e.key[:60]: e.self_device_time_total / reps
            for e in prof.key_averages() if e.device_type.name == "CUDA"}


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", default=os.path.join(HERE, ".."))
    ap.add_argument("--tag", default="change")
    ap.add_argument("--kernels", default="b1,b3,b4",
                    help="comma-separated subset of b1, b3, b4 to time")
    args = ap.parse_args()
    which = set(args.kernels.split(","))
    if not torch.cuda.is_available():
        raise SystemExit("time_torch_kernels: needs a CUDA device")
    sys.path.insert(0, os.path.abspath(args.tree))
    from stvo_pl_tpu_torch import build
    from stvo_pl_tpu_torch.config import VOConfig
    from stvo_pl_tpu_torch.models import frame as frame_mod
    from stvo_pl_tpu_torch.ops import camera as cam_ops
    from stvo_pl_tpu_torch.ops import fast_kernel, lsd, lsd_kernel
    from stvo_pl_tpu_torch.ops.image import pyramid_levels
    from stvo_pl_tpu_torch.utils import synthetic

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    dev = torch.device("cuda")
    build.build_all()
    cam = cam_ops.StereoCamera(fx=718.856, fy=718.856, cx=613.0, cy=185.0,
                               b=0.5372, width=1226, height=370)
    cfg = VOConfig()
    poses = synthetic.smooth_trajectory(N_FRAMES, speed=0.8, device=dev)
    L, R = [], []
    for b in range(BATCH):
        gen = torch.Generator(device=dev).manual_seed(1000 + b)
        scene = synthetic.make_scene(gen, n_points=1400, n_lines=64,
                                     extent=(40.0, 15.0, 90.0), z_near=5.0)
        left, right = synthetic.render_sequence(scene, poses[:1], cam)
        L.append(left[0])
        R.append(right[0])
    first = torch.cat([torch.stack(L), torch.stack(R)]).contiguous()
    out = {"tree": os.path.abspath(args.tree), "tag": args.tag, "card": smi,
           "ptxas": build.ptxas_report}

    tol = math.radians(cfg.lsd_ang_th)
    rho = cfg.lsd_quant / math.sin(tol)
    edge = cfg.orb_edge_th

    # ---- B1 per pyramid level ----------------------------------------------
    if "b1" in which:
        levels = [x.contiguous() for x in pyramid_levels(
            first, cfg.orb_nlevels, cfg.orb_scale_factor, blur_sigma=0.6)]
        rows = []
        for img in levels:
            N, H, W = img.shape
            ms = time_ms(lambda: fast_kernel.fast_pack(img, edge), 50)
            rows.append(dict(shape=[N, H, W], ms=ms,
                             positive_share=fast_positive_share(img)))
        out["B1"] = dict(levels=rows, step_ms=sum(r["ms"] for r in rows),
                         split_us=kernel_split_us(
                             lambda: fast_kernel.fast_pack(levels[0], edge)))

    # ---- B3 on the octave canvases -----------------------------------------
    if "b3" in which:
        n_dirs = frame_mod._oct_dirs(cfg)
        steps = lsd.direction_steps(n_dirs)
        cv = frame_mod.octave_canvas(first, cfg)
        bits = lsd.direction_bitmask(cv.ang, cv.mag, steps, tol,
                                     rho).contiguous()
        N, H, W = bits.shape
        g = torch.Generator(device=dev).manual_seed(7)
        noise = torch.zeros_like(bits)
        for d in range(n_dirs):
            noise |= (torch.rand(bits.shape, generator=g, device=dev)
                      < 0.05).to(torch.int32) << d
        _, Ht, Wp = lsd_kernel.packed_shape(H, W, n_dirs)
        bp = torch.nn.functional.pad(bits, (0, Wp - W, 0, Ht * 8 - H))
        sh = lsd_kernel._shift
        per_dir = []
        for d, (dx, dy) in enumerate(steps):
            a = (bp >> d) & 1
            if abs(dx) >= abs(dy):
                thick = a | sh(a, 1, 0) | sh(a, -1, 0)
            else:
                thick = a | sh(a, 0, 1) | sh(a, 0, -1)
            dil = thick | sh(thick, dy, dx) | sh(thick, -dy, -dx)
            run = (dil & sh(dil, dy, dx) & sh(dil, -dy, -dx)) | thick
            start = run & (1 - sh(run, -dy, -dx))
            words = lsd_kernel._run_words(a, dx, dy, 1, 8)
            per_dir.append(dict(step=[dx, dy],
                                set_share=float(a.float().mean()),
                                run_share=float(run.float().mean()),
                                starts=int(start.sum()),
                                walk_hops=int((words >> 6).sum())))
        multi = lsd_kernel.run_pack_multi
        out["B3"] = dict(
            shape=[N, H, W], dirs=n_dirs,
            set_pixel_share=float((bits != 0).float().mean()),
            ms=time_ms(lambda: multi(bits, steps), 20),
            noise_5pct_ms=time_ms(lambda: multi(noise, steps), 20),
            split_us=kernel_split_us(lambda: multi(bits, steps)),
            noise_split_us=kernel_split_us(lambda: multi(noise, steps)),
            per_direction=per_dir)
        del cv, bits, noise, bp

    # ---- B4: the 12 dense directions ---------------------------------------
    if "b4" in which:
        dsteps = lsd.direction_steps(cfg.lsd_n_dirs)
        ang, mag = lsd.line_field(first)
        strong = mag > lsd._f32(rho)
        b4 = []
        for dx, dy in dsteps:
            theta = lsd._f32(math.atan2(dy, dx) % math.pi)
            m = ((lsd._angle_dist_mod_pi(ang, theta) < lsd._f32(tol))
                 & strong).contiguous()
            b4.append(time_ms(lambda: lsd_kernel.run_pack(m, dx, dy), 20))
        out["B4"] = dict(step_ms=sum(b4), per_direction_ms=b4)

    os.makedirs("chiprun_out", exist_ok=True)
    with open(f"chiprun_out/time_kernels_{args.tag}.json", "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
