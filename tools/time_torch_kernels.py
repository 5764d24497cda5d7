"""Device times of the port's FAST pack (B1), patch gather (B2),
all-direction run pack (B3) and one-direction run pack (B4) kernels at the
main path's shapes, with what the work of each depends on.

    python3 tools/time_torch_kernels.py [--tree DIR] [--tag NAME]
        [--kernels b1,b2,b3,b4]

`--tree` names the directory whose `stvo_pl_tpu_torch` is imported (the
default is this checkout), so one call can time two trees in turns, e.g.
a `git archive` of the parent commit unpacked under `build/`:

    python3 tools/time_torch_kernels.py --tree build/parent --tag parent
    python3 tools/time_torch_kernels.py --tag change

Inputs are chip_smoke.py's: the first frames of its 8 KITTI-sized lanes,
both eyes (16 images), their 4 pyramid levels for B1, their blurred
levels and FAST corners for B2 (the per-level budgets of the default
step), their octave canvases' 8-direction bitmasks for B3 (and a 5%-dense
random bitmask), the 12 dense aligned masks for B4.  Times are CUDA-event
device times (chip_smoke.time_ms: calls queued behind a device-side
sleep, least of 3 batch means).  The split of B3 and B4 into their
kernels comes from torch.profiler.  Also reported: the share of pixels
with a positive FAST response per level; B2's bound per level and
`torch.gather` on precomputed indices; per B3 and B4 direction the share
of set bits, run pixels, run starts and the hops a walk from every start
would take (sum of min(run, 256)).
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

from chip_smoke import (bound_ms, covered_pixels,  # noqa: E402
                        fast_positive_share, kernel_split_us, time_ms)

BATCH = 8
N_FRAMES = 26


def run_pixels(sh, a, dx, dy):
    """The run bits of one direction of a padded 0/1 map, as the kernels'
    plain versions form them (sh: their zero-filled shift)."""
    if abs(dx) >= abs(dy):
        thick = a | sh(a, 1, 0) | sh(a, -1, 0)
    else:
        thick = a | sh(a, 0, 1) | sh(a, 0, -1)
    dil = thick | sh(thick, dy, dx) | sh(thick, -dy, -dx)
    return (dil & sh(dil, dy, dx) & sh(dil, -dy, -dx)) | thick


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", default=os.path.join(HERE, ".."))
    ap.add_argument("--tag", default="change")
    ap.add_argument("--kernels", default="b1,b2,b3,b4",
                    help="comma-separated subset of b1, b2, b3, b4 to time")
    args = ap.parse_args()
    which = set(args.kernels.split(","))
    if not torch.cuda.is_available():
        raise SystemExit("time_torch_kernels: needs a CUDA device")
    sys.path.insert(0, os.path.abspath(args.tree))
    from stvo_pl_tpu_torch import build
    from stvo_pl_tpu_torch.config import VOConfig
    from stvo_pl_tpu_torch.models import frame as frame_mod
    from stvo_pl_tpu_torch.ops import camera as cam_ops
    from stvo_pl_tpu_torch.ops import fast as fast_ops
    from stvo_pl_tpu_torch.ops import fast_kernel, lsd, lsd_kernel, orb
    from stvo_pl_tpu_torch.ops import patches
    from stvo_pl_tpu_torch.ops.image import gaussian_blur, pyramid_levels
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

    levels = [x.contiguous() for x in pyramid_levels(
        first, cfg.orb_nlevels, cfg.orb_scale_factor, blur_sigma=0.6)]

    # ---- B1 per pyramid level ----------------------------------------------
    if "b1" in which:
        rows = []
        for img in levels:
            N, H, W = img.shape
            ms = time_ms(lambda: fast_kernel.fast_pack(img, edge), 50)
            rows.append(dict(shape=[N, H, W], ms=ms,
                             positive_share=fast_positive_share(img)))
        out["B1"] = dict(levels=rows, step_ms=sum(r["ms"] for r in rows),
                         split_us=kernel_split_us(
                             lambda: fast_kernel.fast_pack(levels[0], edge)))

    # ---- B2 per pyramid level, at the default step's budgets ----------------
    if "b2" in which:
        budgets = frame_mod._per_level_budgets(cfg)
        th = torch.full((first.shape[0],), float(cfg.orb_fast_th), device=dev)
        P = orb.PATCH
        rows = []
        for lv, img in enumerate(levels):
            blur = gaussian_blur(img, 2.0, radius=3).contiguous()
            uv, _, _ = fast_ops.detect_keypoints(img, th, budgets[lv],
                                                 edge=edge)
            N, H, W = blur.shape
            x0 = torch.clamp(torch.round(uv[..., 0]).to(torch.int32)
                             - orb.PATCH_R, 0, W - P).contiguous()
            y0 = torch.clamp(torch.round(uv[..., 1]).to(torch.int32)
                             - orb.PATCH_R, 0, H - P).contiguous()
            K = y0.shape[1]
            ar = torch.arange(P, device=dev)
            flat_idx = ((y0.long()[..., None, None] + ar[:, None]) * W
                        + x0.long()[..., None, None] + ar[None, :]
                        ).reshape(N, -1)
            src = blur.reshape(N, -1)
            covered = covered_pixels(y0, x0, H, W, P)
            bnd, _ = bound_ms(covered * 4 + 2 * N * K * 4
                              + N * K * P * P * 4, 0)
            rows.append(dict(
                level=lv, shape=[N, H, W], K=K, covered_px=covered,
                out_mb=N * K * P * P * 4 / 1e6,
                ms=time_ms(lambda: patches.extract_patches(blur, y0, x0, P),
                           50),
                library_ms=time_ms(lambda: torch.gather(src, 1, flat_idx),
                                   50),
                bound_us=bnd * 1e3))
        out["B2"] = dict(levels=rows, step_ms=sum(r["ms"] for r in rows),
                         step_library_ms=sum(r["library_ms"] for r in rows),
                         step_bound_us=sum(r["bound_us"] for r in rows))

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
        per_dir = []
        for d, (dx, dy) in enumerate(steps):
            a = (bp >> d) & 1
            run = run_pixels(lsd_kernel._shift, a, dx, dy)
            start = run & (1 - lsd_kernel._shift(run, -dy, -dx))
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
        N, H, W = first.shape
        Hp, Wp = lsd_kernel.run_pack_shape(H, W)
        b4 = []
        for dx, dy in dsteps:
            theta = lsd._f32(math.atan2(dy, dx) % math.pi)
            m = ((lsd._angle_dist_mod_pi(ang, theta) < lsd._f32(tol))
                 & strong).contiguous()
            a = torch.nn.functional.pad(m.to(torch.int32),
                                        (0, Wp - W, 0, Hp - H))
            run = run_pixels(lsd_kernel._shift, a, dx, dy)
            words = lsd_kernel.run_pack_plain(m, dx, dy)
            b4.append(dict(
                step=[dx, dy],
                ms=time_ms(lambda: lsd_kernel.run_pack(m, dx, dy), 20),
                split_us=kernel_split_us(
                    lambda: lsd_kernel.run_pack(m, dx, dy)),
                set_share=float(m.float().mean()),
                run_share=float(run.float().mean()),
                start_share=float((words > 0).float().mean()),
                walk_hops=int((words >> 6).sum())))
        split = {}
        for r in b4:
            for k, v in r["split_us"].items():
                split[k] = split.get(k, 0.0) + v
        out["B4"] = dict(shape=[N, H, W], out_shape=[N, Hp, Wp],
                         step_ms=sum(r["ms"] for r in b4),
                         step_split_us=split, per_direction=b4)

    os.makedirs("chiprun_out", exist_ok=True)
    with open(f"chiprun_out/time_kernels_{args.tag}.json", "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
