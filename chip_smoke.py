"""GPU smoke run of the PyTorch/CUDA port (stvo_pl_tpu_torch).

    python3 chip_smoke.py

Builds the CUDA kernels from stvo_pl_tpu_torch/csrc, holds each kernel
(FAST pack, patch gather, LSD run pack) against its plain PyTorch version
at the shapes of the main path, then drives the default point + line VO
step (parallel.batched.vo_step_batched, VOConfig()) over 8 distinct
synthetic KITTI-sized sequences (1226x370, 26 frames) on the card and
checks the trajectories, and the points-only step over the first 6 frames
of the same sequences.  Every phase prints one JSON line; any failed check
exits non-zero.  The last three lines are the kernel table, the card's
name and power limit, and the result line.

Needs one CUDA device; exits non-zero without one.  Imports nothing of
JAX.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time

import numpy as np
import torch

# H100 SXM peaks (NVIDIA data sheet): HBM3 bandwidth and the float32 rate
# outside the tensor cores.  Used for the least-time bounds; 32-bit integer
# operations are counted against the same rate (the card issues them no
# faster), so an integer kernel's bound is a lower one.
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_OPS_PER_S = 67e12
# FAST response operations per pixel in the reference's shared-subtree
# form: 16 circle differences, 2 x 23 three-window min/max, 2 x 16 x 2
# arc min/max, 2 x 15 arc accumulations, 2 for the final max.
FAST_OPS_PER_PIXEL = 16 + 2 * 23 * 2 + 2 * 16 * 2 + 2 * 15 + 2

# Run-pack integer operations per pixel of the padded canvas and
# direction, in the cheapest sequential form of the function: bit extract
# 2, thicken 2, dilate 2, gap-close 3, run length as a reverse scan along
# the direction 3 (add, select, saturate), run start 2, packed word 4
# (hop weight, shift, position, select), 8-row maximum 1.
RUN_PACK_OPS_PER_PIXEL_DIR = 2 + 2 + 2 + 3 + 3 + 2 + 4 + 1

# device-side sleep ahead of each timed batch (~20 ms at the H100's clock)
SLEEP_CYCLES = 40_000_000

BATCH = 8
WARMUP_FRAMES = 2
BENCH_FRAMES = 24
POINTS_ONLY_FRAMES = 6
PARITY_FRAMES = 3


def fail(msg: str) -> None:
    sys.stderr.write(f"chip_smoke: FAILED: {msg}\n")
    raise SystemExit(1)


def require(cond, msg: str) -> None:
    if not cond:
        fail(msg)


def emit(phase: str, **kw) -> None:
    print(json.dumps({"phase": phase, **kw}), flush=True)


def time_ms(fn, reps: int, trials: int = 3) -> float:
    """Device time of one call of fn, by CUDA events: the least over
    `trials` of the mean over `reps` calls.  Each trial queues its calls
    behind a device-side sleep, so that the host's launch cost and its
    stalls (the host's cores are shared) stay outside the events."""
    fn()
    fn()
    torch.cuda.synchronize()
    best = float("inf")
    for _ in range(trials):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SLEEP_CYCLES)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        best = min(best, start.elapsed_time(end) / reps)
    return best


def bound_ms(n_bytes: float, n_ops: float) -> tuple[float, str]:
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    t_ops = n_ops / PEAK_F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def covered_pixels(y0: torch.Tensor, x0: torch.Tensor, H: int, W: int,
                   P: int) -> int:
    """Distinct pixels inside the P x P windows at top-left (y0, x0)
    ([N, K], inside the image), summed over the N images."""
    N = y0.shape[0]
    corners = torch.zeros((N, 1, H, W), device=y0.device)
    n = torch.arange(N, device=y0.device)[:, None].expand_as(y0)
    corners[n, 0, y0.long(), x0.long()] = 1.0
    # pixel (y, x) is covered when a corner lies in [y-P+1, y] x [x-P+1, x]
    cover = torch.nn.functional.max_pool2d(
        torch.nn.functional.pad(corners, (P - 1, 0, P - 1, 0)), P, stride=1)
    return int(cover.sum())


def main() -> None:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke run needs a "
             "CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from stvo_pl_tpu_torch import build
    from stvo_pl_tpu_torch.config import VOConfig
    from stvo_pl_tpu_torch.models import frame as frame_mod
    from stvo_pl_tpu_torch.models import frontend
    from stvo_pl_tpu_torch.ops import camera as cam_ops
    from stvo_pl_tpu_torch.ops import fast as fast_ops
    from stvo_pl_tpu_torch.ops import fast_kernel, lsd, lsd_kernel, orb, patches
    from stvo_pl_tpu_torch.ops.image import gaussian_blur, pyramid_levels
    from stvo_pl_tpu_torch.parallel import batched
    from stvo_pl_tpu_torch.utils import metrics, synthetic

    # ---- 1. device ----------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    emit("device", name=kind, nvidia_smi=smi, count=torch.cuda.device_count(),
         torch=torch.__version__, cuda=torch.version.cuda,
         allow_tf32=[torch.backends.cuda.matmul.allow_tf32,
                     torch.backends.cudnn.allow_tf32])

    # ---- 2. build -----------------------------------------------------
    t0 = time.perf_counter()
    out_dir = build.build_all()
    emit("build", seconds=time.perf_counter() - t0,
         nvcc_seconds=build.last_build_seconds, dir=str(out_dir),
         ptxas=build.ptxas_report)

    cam = cam_ops.StereoCamera(fx=718.856, fy=718.856, cx=613.0, cy=185.0,
                               b=0.5372, width=1226, height=370)
    cfg = VOConfig()                       # every default: points + lines
    cfg_points = VOConfig(has_lines=False)
    n_frames = WARMUP_FRAMES + BENCH_FRAMES

    # the 8 lanes' sequences (bench.py's scene parameters), rendered on
    # the card
    t0 = time.perf_counter()
    poses = synthetic.smooth_trajectory(n_frames, speed=0.8, device=dev)
    seq_l, seq_r = [], []
    for b in range(BATCH):
        gen = torch.Generator(device=dev).manual_seed(1000 + b)
        scene = synthetic.make_scene(gen, n_points=1400, n_lines=64,
                                     extent=(40.0, 15.0, 90.0), z_near=5.0)
        left, right = synthetic.render_sequence(scene, poses, cam)
        seq_l.append(left)
        seq_r.append(right)
    seq_l = torch.stack(seq_l)            # [B, T, H, W]
    seq_r = torch.stack(seq_r)
    torch.cuda.synchronize()
    require(bool(torch.isfinite(seq_l).all() & torch.isfinite(seq_r).all()),
            "rendered frames are not finite")
    emit("render", seconds=time.perf_counter() - t0,
         shape=list(seq_l.shape))

    # main-path kernel inputs: both eyes of every lane, each pyramid level
    first = torch.cat([seq_l[:, 0], seq_r[:, 0]]).contiguous()   # [16,H,W]
    levels = pyramid_levels(first, cfg.orb_nlevels, cfg.orb_scale_factor,
                            blur_sigma=0.6)
    budgets = frame_mod._per_level_budgets(cfg)
    th = torch.full((first.shape[0],), float(cfg.orb_fast_th), device=dev)
    gnoise = torch.Generator(device=dev).manual_seed(7)

    # ---- 3. B1: FAST pack ---------------------------------------------
    fast_rows = []
    tot = dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, err=0.0)
    b1_bound_by = set()
    for lv, img in enumerate(levels):
        img = img.contiguous()
        noise = (torch.rand(img.shape, generator=gnoise, device=dev)
                 * 255.0).contiguous()
        for name, x in (("rendered", img), ("noise", noise)):
            k = fast_kernel.fast_pack(x, cfg.orb_edge_th)
            p = fast_kernel.fast_pack_plain(x, cfg.orb_edge_th)
            torch.cuda.synchronize()
            err = float((k.long() - p.long()).abs().max())
            tot["err"] = max(tot["err"], err)
            require(torch.equal(k, p), f"B1 level {lv} {name}: kernel != "
                    f"plain at {int((k != p).sum())} words")
        N, H, W = img.shape
        Hs, Wp = fast_kernel.packed_shape(H, W)
        ms = time_ms(lambda: fast_kernel.fast_pack(img, cfg.orb_edge_th), 50)
        plain = time_ms(lambda: fast_kernel.fast_pack_plain(
            img, cfg.orb_edge_th), 3)
        bnd, by = bound_ms(N * H * W * 4 + N * Hs * Wp * 4,
                           N * H * W * FAST_OPS_PER_PIXEL)
        b1_bound_by.add(by)
        tot["ms"] += ms
        tot["plain_ms"] += plain
        tot["bound_ms"] += bnd
        fast_rows.append(dict(level=lv, shape=[N, H, W], ms=ms,
                              plain_ms=plain, bound_us=bnd * 1e3,
                              bound_by=by))
    emit("B1_fast_pack", equal=True, levels=fast_rows,
         step_ms=tot["ms"], step_plain_ms=tot["plain_ms"],
         step_bound_us=tot["bound_ms"] * 1e3)
    b1 = dict(name="fast_pack", route="cuda",
              source="stvo_pl_tpu_torch/csrc/fast_pack.cu",
              replaces="stvo_pl_tpu/ops/fast_kernel.py:151",
              max_abs_err=tot["err"], ms=tot["ms"],
              plain_ms=tot["plain_ms"], bound_ms=tot["bound_ms"],
              bound_by="operations" if "operations" in b1_bound_by
              else "bytes", library_ms=None)

    # ---- 4. B2: patch gather ------------------------------------------
    patch_rows = []
    tot = dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, lib_ms=0.0, err=0.0)
    P = orb.PATCH
    for lv, img in enumerate(levels):
        blur = gaussian_blur(img, 2.0, radius=3).contiguous()
        uv, _, _ = fast_ops.detect_keypoints(
            img.contiguous(), th, budgets[lv], edge=cfg.orb_edge_th)
        N, H, W = blur.shape
        x0 = torch.clamp(torch.round(uv[..., 0]).to(torch.int32) - orb.PATCH_R,
                         0, W - P).contiguous()
        y0 = torch.clamp(torch.round(uv[..., 1]).to(torch.int32) - orb.PATCH_R,
                         0, H - P).contiguous()
        k = patches.extract_patches(blur, y0, x0, P)
        p = patches.extract_patches_plain(blur, y0, x0, P)
        torch.cuda.synchronize()
        tot["err"] = max(tot["err"], float((k - p).abs().max()))
        require(torch.equal(k, p), f"B2 level {lv}: kernel != plain")
        K = y0.shape[1]
        ms = time_ms(lambda: patches.extract_patches(blur, y0, x0, P), 50)
        plain = time_ms(lambda: patches.extract_patches_plain(
            blur, y0, x0, P), 10)
        ar = torch.arange(P, device=dev)
        flat_idx = ((y0.long()[..., None, None] + ar[:, None]) * W
                    + x0.long()[..., None, None] + ar[None, :]).reshape(N, -1)
        src = blur.reshape(N, -1)
        lib = time_ms(lambda: torch.gather(src, 1, flat_idx), 50)
        # bytes the function must move: the distinct source pixels its
        # windows cover, the corners, and the patches written
        covered = covered_pixels(y0, x0, H, W, P)
        bnd, by = bound_ms(covered * 4 + 2 * N * K * 4 + N * K * P * P * 4,
                           0)
        tot["ms"] += ms
        tot["plain_ms"] += plain
        tot["bound_ms"] += bnd
        tot["lib_ms"] += lib
        patch_rows.append(dict(level=lv, shape=[N, H, W], K=K,
                               covered_px=covered, ms=ms,
                               plain_ms=plain, library_ms=lib,
                               bound_us=bnd * 1e3, bound_by=by))
    # row mode: 32-bit integers through bit for bit
    bits = levels[0].contiguous().view(torch.int32)
    Kr = 512
    yr = torch.randint(0, bits.shape[1], (bits.shape[0], Kr), device=dev,
                       generator=gnoise, dtype=torch.int32)
    xr = torch.randint(0, bits.shape[2] - 64, (bits.shape[0], Kr),
                       device=dev, generator=gnoise, dtype=torch.int32)
    rk = patches.extract_patches(bits, yr, xr, (1, 64))
    rp = patches.extract_patches_plain(bits, yr, xr, (1, 64))
    torch.cuda.synchronize()
    require(torch.equal(rk, rp), "B2 row mode: kernel != plain")
    emit("B2_extract_patches", equal=True, row_mode_equal=True,
         levels=patch_rows, step_ms=tot["ms"], step_plain_ms=tot["plain_ms"],
         step_library_ms=tot["lib_ms"], step_bound_us=tot["bound_ms"] * 1e3)
    b2 = dict(name="extract_patches", route="cuda",
              source="stvo_pl_tpu_torch/csrc/patches.cu",
              replaces="stvo_pl_tpu/ops/patches.py:29",
              max_abs_err=tot["err"],
              ms=tot["ms"], plain_ms=tot["plain_ms"],
              bound_ms=tot["bound_ms"], bound_by="bytes",
              library_ms=tot["lib_ms"])

    # ---- 5. B3: LSD run pack ------------------------------------------
    # main-path input: the direction bitmasks of the 16 first-frame octave
    # canvases, built as the detector builds them
    n_dirs = frame_mod._oct_dirs(cfg)
    steps = lsd.direction_steps(n_dirs)
    tol = math.radians(cfg.lsd_ang_th)
    rho = cfg.lsd_quant / math.sin(tol)
    cv = frame_mod.octave_canvas(first, cfg)
    bits = lsd.direction_bitmask(cv.ang, cv.mag, steps, tol, rho).contiguous()
    N, H, W = bits.shape
    D, Ht, Wp = lsd_kernel.packed_shape(H, W, n_dirs)

    def random_bits(n_bits, density):
        out = torch.zeros((N, H, W), dtype=torch.int32, device=dev)
        for d in range(n_bits):
            on = torch.rand((N, H, W), generator=gnoise, device=dev) < density
            out |= on.to(torch.int32) << d
        return out

    b3_err = 0.0
    cases = [("rendered", bits, steps),
             # set bits in the last row and column: runs continue into the
             # padded domain
             ("noise", random_bits(n_dirs, 0.05), steps),
             ("noise_dense", random_bits(n_dirs, 0.5), steps),
             ("noise_12_dirs", random_bits(12, 0.05), lsd.direction_steps(12))]
    for name, x, st in cases:
        k = lsd_kernel.run_pack_multi(x, st)
        p = lsd_kernel.run_pack_multi_plain(x, st)
        torch.cuda.synchronize()
        b3_err = max(b3_err, float((k.long() - p.long()).abs().max()))
        require(torch.equal(k, p), f"B3 {name}: kernel != plain at "
                f"{int((k != p).sum())} words")
        require(int((k > 0).sum()) > 0, f"B3 {name}: no run found")
        if name != "rendered":
            require(bool((x[:, -1, :] != 0).any() & (x[:, :, -1] != 0).any()),
                    f"B3 {name}: no set bits at the border")
    ms = time_ms(lambda: lsd_kernel.run_pack_multi(bits, steps), 20)
    plain = time_ms(lambda: lsd_kernel.run_pack_multi_plain(bits, steps), 2)
    noise_ms = time_ms(lambda: lsd_kernel.run_pack_multi(cases[1][1], steps),
                       20)
    bnd, by = bound_ms(N * H * W * 4 + N * D * Ht * Wp * 4,
                       N * Ht * 8 * Wp * D * RUN_PACK_OPS_PER_PIXEL_DIR)
    set_share = float((bits != 0).float().mean())
    emit("B3_run_pack_multi", equal=True, cases=[c[0] for c in cases],
         shape=[N, H, W], dirs=n_dirs, out_shape=[N, D, Ht, Wp],
         set_pixel_share=set_share, ms=ms, noise_ms=noise_ms, plain_ms=plain,
         bound_us=bnd * 1e3, bound_by=by)
    b3 = dict(name="run_pack_multi", route="cuda",
              source="stvo_pl_tpu_torch/csrc/lsd_run_pack.cu",
              replaces="stvo_pl_tpu/ops/lsd_kernel.py:215",
              max_abs_err=b3_err, ms=ms, plain_ms=plain, bound_ms=bnd,
              bound_by=by, library_ms=None)
    del cv, cases

    # ---- 6. VO: the batched step on 8 lanes ----------------------------
    wrappers = {"fast_pack": fast_kernel.fast_pack,
                "extract_patches": patches.extract_patches,
                "run_pack_multi": lsd_kernel.run_pack_multi}

    def drive(run_cfg, frames, warmup):
        """`frames` steps of the batched VO from a fresh state; the
        kernels' counts are set to 0 just before and read just after."""
        state = batched.init_batched_state(run_cfg, BATCH)
        for w in wrappers.values():
            w.launches = 0
        telems = []
        for i in range(frames):
            if i == warmup:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
            state, telem = batched.vo_step_batched(
                state, seq_l[:, i].contiguous(), seq_r[:, i].contiguous(),
                cam, run_cfg)
            telems.append(telem)
        torch.cuda.synchronize()
        elapsed = time.perf_counter() - t0
        launches = {k: w.launches for k, w in wrappers.items()}
        timed = telems[warmup:]
        est = torch.stack([t.Tfw for t in timed], dim=1).double().cpu().numpy()
        gt = poses[warmup:frames].double().cpu().numpy()
        ates = [metrics.ate_rmse(est[b], gt) for b in range(BATCH)]
        good = torch.stack([t.good for t in timed]).float().mean()
        stat = lambda f: torch.stack(
            [getattr(t, f) for t in timed]).float().mean(dim=0).tolist()
        return telems, dict(
            lanes=BATCH, frames=frames, timed_frames=frames - warmup,
            height=cam.height, width=cam.width,
            fps=(frames - warmup) * BATCH / elapsed,
            ms_per_step=elapsed / (frames - warmup) * 1e3, card=smi,
            ate_m=float(np.mean(ates)), ate_lanes=ates,
            good_frac=float(good), inliers_pt_lanes=stat("n_inliers_pt"),
            inliers_ls_lanes=stat("n_inliers_ls"), launches=launches)

    def check(name, r, expected):
        for k, n in expected.items():
            require(r["launches"][k] == n, f"{name}: {k} launched "
                    f"{r['launches'][k]} times in {r['frames']} steps, "
                    f"expected {n}")
        require(all(np.isfinite(a) for a in r["ate_lanes"]),
                f"{name}: non-finite ATE {r['ate_lanes']}")
        require(r["ate_m"] < 0.1, f"{name}: mean ATE {r['ate_m']} m")
        require(r["good_frac"] >= 0.9, f"{name}: good_frac {r['good_frac']}")

    # the points-only path, at a smaller depth
    _, r_pts = drive(cfg_points, POINTS_ONLY_FRAMES, WARMUP_FRAMES)
    emit("vo_points_only", **r_pts)
    check("vo_points_only", r_pts,
          {"fast_pack": POINTS_ONLY_FRAMES * cfg.orb_nlevels,
           "extract_patches": POINTS_ONLY_FRAMES * cfg.orb_nlevels,
           "run_pack_multi": 0})

    # the main path: VOConfig() with every default, points + lines
    telems, r_main = drive(cfg, n_frames, WARMUP_FRAMES)
    emit("vo", **r_main, points_only_ms_per_step=r_pts["ms_per_step"])
    check("vo", r_main, {"fast_pack": n_frames * cfg.orb_nlevels,
                         "extract_patches": n_frames * cfg.orb_nlevels,
                         "run_pack_multi": n_frames})
    require(min(r_main["inliers_ls_lanes"]) > 0,
            f"vo: a lane tracked no line: {r_main['inliers_ls_lanes']}")

    # ---- 7. the kernels' path against the plain path -------------------
    # lane 0's first frames through the port on the CPU (plain versions)
    cpu_state = frontend.init_state(cfg, device="cpu")
    dmax = 0.0
    for i in range(PARITY_FRAMES):
        cpu_state, ct = frontend.vo_step(cpu_state, seq_l[0, i].cpu(),
                                         seq_r[0, i].cpu(), cam, cfg)
        gpu_T = telems[i].Tfw[0].cpu()
        dmax = max(dmax, float((ct.Tfw[:3, 3] - gpu_T[:3, 3]).abs().max()))
    emit("cpu_parity", frames=PARITY_FRAMES, max_translation_diff_m=dmax)
    require(dmax < 0.01, f"GPU and CPU poses differ by {dmax} m")

    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    table = [{k: row[k] for k in keys} for row in
             (dict(r, launches=r_main["launches"][r["name"]])
              for r in (b1, b2, b3))]
    print(json.dumps({"kernels": table}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
