"""Device times of the port's FAST pack (B1), patch gather (B2),
all-direction run pack (B3), one-direction run pack (B4) and Hamming (B5)
kernels at the main path's shapes, with what the work of each depends on.

    python3 tools/time_torch_kernels.py [--tree DIR] [--tag NAME]
        [--kernels b1,b2,b3,b4,b5]

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
would take (sum of min(run, 256)).  B5 at the popcount VO step's point
and line shapes and the binary matcher's (seeded random words with
distance-0 pairs), each held `torch.equal` to the plain version, beside
its byte bound, the bf16 product `hamming_matrix_mxu`, PyTorch's fill of
an output of the same size (the store alone), B5 followed by the VO
step's consumer of its output (`nnr_mutual_match` under a random 30%
candidate mask; points and lines) and the POPC issue floor of
XOR + popcount (8 POPCs per pair at 16 per clock per SM, at the SM clock
`nvidia-smi` reads while B5 runs); with the SASS instruction counts of
the tree's Hamming kernel (`cuobjdump -sass`).
Prints one JSON object and writes it to chiprun_out/time_kernels_<tag>.json.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import re
import shutil
import subprocess
import sys
import time

import torch

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, ".."))

from chip_smoke import (bound_ms, covered_pixels,  # noqa: E402
                        fast_positive_share, kernel_split_us, time_ms)

BATCH = 8
N_FRAMES = 26
POPC_PER_CLOCK_SM = 16      # CUDA's throughput table, compute 7.x-9.0
XOR_POPC_PER_PAIR = 8


def sass_counts(lib: str, match: str) -> dict:
    """Per kernel of `lib` whose name contains `match`: its SASS
    instruction count, by opcode (the first dot-separated part), and the
    full forms of its MMA instructions."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([tool, "-sass", lib], capture_output=True,
                          text=True, check=True).stdout
    out, cur = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            name = line.split("Function :")[1].strip()
            cur = out.setdefault(name, {"ops": {}, "mma": []}) \
                if match in name else None
            continue
        m = re.match(r"\s*/\*[0-9a-f]+\*/\s+(?:@!?U?P\w+\s+)?([A-Z0-9_.]+)",
                     line)
        if cur is None or not m:
            continue
        op = m.group(1).split(".")[0]
        cur["ops"][op] = cur["ops"].get(op, 0) + 1
        if "MMA" in op and m.group(1) not in cur["mma"]:
            cur["mma"].append(m.group(1))
    return {name: dict(total=sum(c["ops"].values()), mma_forms=c["mma"],
                       **dict(sorted(c["ops"].items())))
            for name, c in out.items()}


def sm_clock_mhz(fn, seconds: float = 2.0) -> list[float]:
    """SM clocks that nvidia-smi reads every 100 ms while fn runs back to
    back on the card."""
    smi = subprocess.Popen(["nvidia-smi", "--query-gpu=clocks.sm",
                            "--format=csv,noheader,nounits", "-lms", "100"],
                           stdout=subprocess.PIPE, text=True)
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        for _ in range(50):
            fn()
    smi.terminate()
    text = smi.communicate()[0]
    torch.cuda.synchronize()
    return [float(x) for x in text.split() if x.replace(".", "").isdigit()]


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
                    help="comma-separated subset of b1, b2, b3, b4, b5 to "
                         "time")
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
    from stvo_pl_tpu_torch.ops import fast_kernel, hamming, lsd, lsd_kernel
    from stvo_pl_tpu_torch.ops import matching, orb
    from stvo_pl_tpu_torch.ops import patches
    from stvo_pl_tpu_torch.ops.image import gaussian_blur, pyramid_levels
    from stvo_pl_tpu_torch.utils import synthetic

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    dev = torch.device("cuda")
    lib = str(build.build_all() / build.LIB)
    cam = cam_ops.StereoCamera(fx=718.856, fy=718.856, cx=613.0, cy=185.0,
                               b=0.5372, width=1226, height=370)
    cfg = VOConfig()
    out = {"tree": os.path.abspath(args.tree), "tag": args.tag, "card": smi,
           "ptxas": build.ptxas_report}

    tol = math.radians(cfg.lsd_ang_th)
    rho = cfg.lsd_quant / math.sin(tol)
    edge = cfg.orb_edge_th

    if which & {"b1", "b2", "b3", "b4"}:
        poses = synthetic.smooth_trajectory(N_FRAMES, speed=0.8, device=dev)
        L, R = [], []
        for b in range(BATCH):
            gen = torch.Generator(device=dev).manual_seed(1000 + b)
            scene = synthetic.make_scene(gen, n_points=1400, n_lines=64,
                                         extent=(40.0, 15.0, 90.0),
                                         z_near=5.0)
            left, right = synthetic.render_sequence(scene, poses[:1], cam)
            L.append(left[0])
            R.append(right[0])
        first = torch.cat([torch.stack(L), torch.stack(R)]).contiguous()
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

    # ---- B5 at the popcount step's and the matcher's shapes ---------------
    if "b5" in which:
        g = torch.Generator(device=dev).manual_seed(7)

        def words(*shape):
            return torch.randint(-2 ** 31, 2 ** 31 - 1, shape, generator=g,
                                 device=dev, dtype=torch.int32)

        K, Kl = cfg.point_capacity, cfg.line_capacity
        shapes = {"points": (words(BATCH, K, 8), words(BATCH, K, 8)),
                  "lines": (words(BATCH, Kl, 8), words(BATCH, Kl, 8)),
                  "matcher": (words(BATCH * Kl, 8), words(64 * Kl, 8))}
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        d1, d2 = shapes["points"]
        clocks = sm_clock_mhz(lambda: hamming.hamming_matrix_popc(d1, d2))
        clock = sorted(clocks)[len(clocks) // 2] if clocks else float("nan")
        rows = {}
        for name, (d1, d2) in shapes.items():
            d2[..., :5, :] = d1[..., :5, :]           # pairs at distance 0
            k = hamming.hamming_matrix_popc(d1, d2)
            equal = torch.equal(k, hamming.hamming_matrix_xla(d1, d2))
            pairs = k.numel()
            buf = torch.empty_like(k)
            bnd, _ = bound_ms((d1.numel() + d2.numel() + pairs) * 4, 0)
            reps = 10 if name == "matcher" else 50
            if name != "matcher":
                # B5 then its consumer on the VO path, which reads the
                # output at once
                cand = torch.rand(k.shape, generator=g, device=dev) < 0.3
                then_match = lambda: matching.nnr_mutual_match(
                    hamming.hamming_matrix_popc(d1, d2), cand, 0.75)
                rows[name] = dict(then_match_us=time_ms(then_match, reps)
                                  * 1e3)
            rows[name] = dict(rows.get(name, {}),
                shapes=[list(d1.shape), list(d2.shape)], equal=equal,
                us=time_ms(lambda: hamming.hamming_matrix_popc(d1, d2),
                           reps) * 1e3,
                bound_us=bnd * 1e3,
                library_us=time_ms(lambda: hamming.hamming_matrix_mxu(d1, d2),
                                   reps) * 1e3,
                fill_us=time_ms(lambda: buf.fill_(0), reps) * 1e3,
                popc_floor_us=pairs * XOR_POPC_PER_PAIR / (
                    sms * POPC_PER_CLOCK_SM * clock * 1e6) * 1e6)
            del k, buf
        per_step = lambda key: 2 * (rows["points"][key] + rows["lines"][key])
        out["B5"] = dict(
            step_then_match_ms=per_step("then_match_us") / 1e3,
            sm_clock_mhz=clock, sm_clock_samples=clocks, sms=sms,
            shapes=rows, step_ms=per_step("us") / 1e3,
            step_bound_ms=per_step("bound_us") / 1e3,
            step_library_ms=per_step("library_us") / 1e3,
            step_fill_ms=per_step("fill_us") / 1e3,
            step_popc_floor_ms=per_step("popc_floor_us") / 1e3,
            sass=sass_counts(lib, "hamming"))

    os.makedirs("chiprun_out", exist_ok=True)
    with open(f"chiprun_out/time_kernels_{args.tag}.json", "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
