"""GPU smoke run of the PyTorch/CUDA port (stvo_pl_tpu_torch).

    python3 chip_smoke.py

Builds the CUDA kernels from stvo_pl_tpu_torch/csrc, holds each kernel
(FAST pack, patch gather, the all-direction and the one-direction LSD run
pack, the tensor-core Hamming) against its plain PyTorch version at the
shapes of the paths that run it (FAST also on a constant image, a dot
field and a 4x4 tiling; the patch gather also with K = 1, odd K, partial
last 16-byte groups, corners at the image's last row and column or
outside it, and u32 rows; both run packs also on runs longer than their
cap, in all 16 directions for the all-direction one and in the 12 dense
directions for the one-direction one, with caps 1, 8 and 256; Hamming
with the edge words 0, 0xFFFFFFFF, 0x80000000 and 0x7FFFFFFF and pairs
at distance 0 and 256), times them (B2 per pyramid level, B4 per
direction and per pass), then drives the default point + line VO
step (parallel.batched.vo_step_batched, VOConfig()) over 8 distinct
synthetic KITTI-sized sequences (1226x370, 26 frames) on the card and
checks the trajectories.  Over the first 6 frames of the same sequences it
also drives the points-only step, the dense single-octave line detector
(lsd_octaves=1) with either run candidate generator, the default step with
popcount Hamming distances (hamming_use_mxu=False), the binary descriptor
matcher over an index of the lanes' line descriptors, and the RGB-D step
on one lane.  Every phase prints one JSON line; any failed check exits
non-zero.  The last three lines are the kernel table, the card's name and
power limit, and the result line.

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
# operations are counted against the same rate, which the card does not
# reach for them (CUDA's throughput table, compute 9.0: 64 adds or logic
# operations per clock and SM against 128 float32, and 16 POPC, a quarter
# of the 32-bit integer rate), so an integer kernel's bound is a lower one.
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
# the one-direction kernel: the same without the hop weight and without the
# 8-row maximum
RUN_PACK_ONE_OPS_PER_PIXEL = RUN_PACK_OPS_PER_PIXEL_DIR - 2
# XOR + popcount Hamming: 8 XOR, 8 popcounts and 8 adds per pair (the
# kernel does the pair's work on the tensor cores; its bound is the output's
# bytes either way)
HAMMING_OPS_PER_PAIR = 24
# B5's edge words, each in rows of its own: 0, 0xFFFFFFFF, 0x80000000 and
# 0x7FFFFFFF
HAMMING_EDGE_WORDS = (0, -1, -2 ** 31, 2 ** 31 - 1)

# device-side sleep ahead of each timed batch (~20 ms at the H100's clock)
SLEEP_CYCLES = 40_000_000

BATCH = 8
WARMUP_FRAMES = 2
BENCH_FRAMES = 24
POINTS_ONLY_FRAMES = 6      # depth of every VO phase but the main one
PARITY_FRAMES = 3
DENSE_PARITY_FRAMES = 2
INDEX_IMAGES = 64           # the matcher phase: 64 x 300 index rows
LONG_RUN_SIZE = 1280        # B3's long-run masks: 300 hops of (1, 4) fit


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


def kernel_split_us(fn, reps: int = 10) -> dict:
    """Device microseconds per call of each CUDA kernel that fn launches,
    from torch.profiler."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return {e.key[:60]: e.self_device_time_total / reps
            for e in prof.key_averages() if e.device_type.name == "CUDA"}


def bound_ms(n_bytes: float, n_ops: float) -> tuple[float, str]:
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    t_ops = n_ops / PEAK_F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def fast_positive_share(img: torch.Tensor) -> float:
    """Share of the pixels of [N, H, W] whose FAST response is positive
    (circle pixels outside the image read as 0)."""
    from stvo_pl_tpu_torch.ops import fast as fast_ops
    H, W = img.shape[1:]
    p = torch.nn.functional.pad(img, (3, 3, 3, 3))
    diffs = [p[:, 3 + dy:3 + dy + H, 3 + dx:3 + dx + W] - img
             for dy, dx in fast_ops.CIRCLE.tolist()]
    return float((fast_ops.fast_response(diffs) > 0).float().mean())


def long_run_bits(gen: torch.Generator, n: int, size: int,
                  steps) -> torch.Tensor:
    """[n, size, size] direction bitmasks: 2% noise per direction, and per
    image and direction 8 straight chains of that direction's bit, 40 to
    300 hops long (the first always 300), from random starts that keep
    them inside the image; the last row and column are set at every third
    pixel."""
    dev = gen.device
    bits = torch.zeros((n, size, size), dtype=torch.int32, device=dev)
    for d, (dx, dy) in enumerate(steps):
        bits |= (torch.rand(bits.shape, generator=gen, device=dev)
                 < 0.02).to(torch.int32) << d
        for i in range(n):
            for c in range(8):
                hops = 300 if c == 0 else int(torch.randint(
                    40, 301, (1,), generator=gen, device=dev))
                span_y, span_x = (hops - 1) * abs(dy), (hops - 1) * abs(dx)
                y0 = int(torch.randint(0, size - span_y, (1,), generator=gen,
                                       device=dev)) + (span_y if dy < 0 else 0)
                x0 = int(torch.randint(0, size - span_x, (1,), generator=gen,
                                       device=dev)) + (span_x if dx < 0 else 0)
                k = torch.arange(hops, device=dev)
                ys, xs = y0 + k * dy, x0 + k * dx
                bits[i, ys, xs] |= 1 << d
    bits[:, -1, ::3] |= (1 << len(steps)) - 1
    bits[:, ::3, -1] |= (1 << len(steps)) - 1
    return bits


def long_run_mask(gen: torch.Generator, n: int, size: int,
                  step) -> torch.Tensor:
    """[n, size, size] 0/1 masks for one direction: 2% noise and per image
    8 straight chains of the step, 40 to 300 hops long (the first always
    300), inside the image; the last row and column set at every third
    pixel."""
    one = long_run_bits(gen, n, size, [step])
    return one != 0


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
    from stvo_pl_tpu_torch.ops import binary_matcher, fast_kernel, hamming
    from stvo_pl_tpu_torch.ops import lsd, lsd_kernel, orb, patches
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
        if b == 0:      # lane 0's depth maps, for the RGB-D phase
            depth0 = synthetic.render_depth(
                scene, poses[:POINTS_ONLY_FRAMES], cam)
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

    def check_fast(name, x):
        k = fast_kernel.fast_pack(x, cfg.orb_edge_th)
        p = fast_kernel.fast_pack_plain(x, cfg.orb_edge_th)
        torch.cuda.synchronize()
        tot["err"] = max(tot["err"], float((k.long() - p.long()).abs().max()))
        require(torch.equal(k, p), f"B1 {name}: kernel != plain at "
                f"{int((k != p).sum())} words")
        return k

    # where the kernel's survivor lists are empty or full: a constant
    # image (no response anywhere), bright dots 4 px apart on a dark
    # field (every dot a survivor), and a 4x4 tiling where 69% of the
    # pixels have a positive response
    N0, H0, W0 = levels[0].shape
    dots = torch.full((N0, H0, W0), 10.0, device=dev)
    dots[:, 2::4, 3::4] = 200.0
    tile = torch.tensor([[11, 9, 6, 15], [4, 7, 5, 1], [10, 8, 0, 3],
                         [13, 2, 12, 14]], dtype=torch.float32, device=dev)
    pattern = (tile * 10).repeat(N0, H0 // 4 + 1, W0 // 4 + 1)[:, :H0, :W0]
    design = {}
    for name, x in (("constant", torch.full((N0, H0, W0), 77.0, device=dev)),
                    ("dots", dots), ("pattern", pattern.contiguous())):
        k = check_fast(name, x)
        design[name] = dict(positive_share=fast_positive_share(x),
                            survivors=int((k > 0).sum()))
    require(design["constant"]["survivors"] == 0,
            "B1 constant: the kernel found corners")
    require(design["dots"]["survivors"] >= N0 * ((H0 - 40) // 4)
            * ((W0 - 40) // 4), "B1 dots: a dot was not kept")
    for lv, img in enumerate(levels):
        img = img.contiguous()
        noise = (torch.rand(img.shape, generator=gnoise, device=dev)
                 * 255.0).contiguous()
        for name, x in (("rendered", img), ("noise", noise)):
            check_fast(f"level {lv} {name}", x)
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
                              bound_by=by,
                              positive_share=fast_positive_share(img)))
    emit("B1_fast_pack", equal=True, levels=fast_rows, design_cases=design,
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
    # the kernel's edges: K = 1 and K a multiple of no block size, outputs
    # whose word count is not a multiple of 4 (a partial last 16-byte
    # group), corners at x0 = W - PX, y0 = H - PY and outside the image,
    # u32 data in the row mode
    b2_cases = []
    for name, K, patch, dtype, inside in (
            ("k1", 1, P, torch.float32, True),
            ("k37_edge", 37, P, torch.float32, True),
            ("k29_outside", 29, P, torch.float32, False),
            ("k13_5x7", 13, (5, 7), torch.float32, True),
            ("row_u32_edge", 45, (1, 64), torch.uint32, True),
            ("row_u32_outside", 1031, (1, 64), torch.uint32, False)):
        PY, PX = (patch, patch) if isinstance(patch, int) else patch
        img = levels[1][:3].contiguous()
        if dtype == torch.uint32:
            img = img.view(torch.uint32)
        N, H, W = img.shape
        lo_y, hi_y = (0, H - PY + 1) if inside else (-PY - 2, H + 2)
        lo_x, hi_x = (0, W - PX + 1) if inside else (-PX - 2, W + 2)
        yc = torch.randint(lo_y, hi_y, (N, K), device=dev, generator=gnoise,
                           dtype=torch.int32)
        xc = torch.randint(lo_x, hi_x, (N, K), device=dev, generator=gnoise,
                           dtype=torch.int32)
        if inside:
            yc[:, 0], xc[:, 0] = H - PY, W - PX
        k = patches.extract_patches(img, yc, xc, patch)
        p = patches.extract_patches_plain(img, yc, xc, patch)
        torch.cuda.synchronize()
        require(torch.equal(k.view(torch.int32), p.view(torch.int32)),
                f"B2 {name}: kernel != plain")
        b2_cases.append(dict(name=name, shape=[N, H, W], K=K,
                             patch=[PY, PX], words=k.numel()))
    require(any(c["words"] % 4 for c in b2_cases),
            "B2: no case with a partial last group")
    emit("B2_extract_patches", equal=True, row_mode_equal=True,
         cases=b2_cases, levels=patch_rows, step_ms=tot["ms"],
         step_plain_ms=tot["plain_ms"], step_library_ms=tot["lib_ms"],
         step_bound_us=tot["bound_ms"] * 1e3)
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
    # straight runs longer than the cap in each of the 16 directions: they
    # cross many tiles, start and end inside tiles, and reach the last row
    # and column; and the main-path bitmasks with caps 1 and 8
    all_steps = lsd.direction_steps(16)
    long_bits = long_run_bits(gnoise, 2, LONG_RUN_SIZE, all_steps)
    b3_long = {}
    for name, x, st, md in (
            [("long_runs", long_bits, all_steps, m) for m in (8, 3, 0)]
            + [("rendered", bits, steps, m) for m in (3, 0)]):
        k = lsd_kernel.run_pack_multi(x, st, md)
        p = lsd_kernel.run_pack_multi_plain(x, st, md)
        torch.cuda.synchronize()
        b3_err = max(b3_err, float((k.long() - p.long()).abs().max()))
        require(torch.equal(k, p), f"B3 {name} max_doublings={md}: kernel "
                f"!= plain at {int((k != p).sum())} words")
        if name == "long_runs":
            hq = torch.tensor([lsd_kernel._hop_q(*s) for s in st],
                              device=dev)[None, :, None, None]
            full = ((k >> 6) == hq * (1 << md)).flatten(2).any(-1)
            require(bool(full.all()), f"B3 long_runs max_doublings={md}: "
                    f"a direction has no run at the cap")
            b3_long[md] = int((k > 0).sum())
    del long_bits
    ms = time_ms(lambda: lsd_kernel.run_pack_multi(bits, steps), 20)
    plain = time_ms(lambda: lsd_kernel.run_pack_multi_plain(bits, steps), 2)
    noise_ms = time_ms(lambda: lsd_kernel.run_pack_multi(cases[1][1], steps),
                       20)
    bnd, by = bound_ms(N * H * W * 4 + N * D * Ht * Wp * 4,
                       N * Ht * 8 * Wp * D * RUN_PACK_OPS_PER_PIXEL_DIR)
    set_share = float((bits != 0).float().mean())
    emit("B3_run_pack_multi", equal=True, cases=[c[0] for c in cases],
         long_run_words=b3_long, long_run_shape=[2, LONG_RUN_SIZE,
                                                 LONG_RUN_SIZE],
         shape=[N, H, W], dirs=n_dirs, out_shape=[N, D, Ht, Wp],
         set_pixel_share=set_share, ms=ms, noise_ms=noise_ms, plain_ms=plain,
         bound_us=bnd * 1e3, bound_by=by)
    b3 = dict(name="run_pack_multi", route="cuda",
              source="stvo_pl_tpu_torch/csrc/lsd_run_pack.cu",
              replaces="stvo_pl_tpu/ops/lsd_kernel.py:215",
              max_abs_err=b3_err, ms=ms, plain_ms=plain, bound_ms=bnd,
              bound_by=by, library_ms=None)
    del cv, cases

    # ---- 5b. B4: one-direction LSD run pack ----------------------------
    # the dense detector's input: the aligned masks of the 16 first frames
    # for its 12 directions, built as the per-direction generator builds
    # them
    dsteps = lsd.direction_steps(cfg.lsd_n_dirs)
    ang, mag = lsd.line_field(first)
    strong = mag > lsd._f32(rho)
    N, H, W = first.shape
    Hp4, Wp4 = lsd_kernel.run_pack_shape(H, W)

    def aligned_mask(step):
        theta = lsd._f32(math.atan2(step[1], step[0]) % math.pi)
        return ((lsd._angle_dist_mod_pi(ang, theta) < lsd._f32(tol))
                & strong).contiguous()

    def noise_mask(shape, density):
        return torch.rand(shape, generator=gnoise, device=dev) < density

    masks = [aligned_mask(st) for st in dsteps]
    # one axis-aligned, one with dx < 0 and |dx| = 4, one with |dy| = 4
    named = {"axis": (1, 0), "neg_dx4": (-4, 1), "dy4": (1, 4)}
    require(all(st in dsteps for st in named.values()),
            f"B4: the dense directions {dsteps} lack one of {named}")
    b4_cases = [(f"rendered_{dx}_{dy}", m, (dx, dy))
                for m, (dx, dy) in zip(masks, dsteps)]
    # set bits in the last row and column: runs continue into the pad
    b4_cases += [("noise_5", noise_mask((N, H, W), 0.05), (-4, 1)),
                 ("noise_50", noise_mask((N, H, W), 0.5), (1, 4)),
                 ("noise_int8", noise_mask((N, H, W), 0.3).to(torch.int8),
                  (4, 3)),
                 # H % 8 != 0 and a ragged last 32-row tile
                 ("odd_shape", noise_mask((3, 203, 333), 0.3), (-3, 4))]
    b4_err = 0.0
    for name, x, (dx, dy) in b4_cases:
        k = lsd_kernel.run_pack(x, dx, dy)
        p = lsd_kernel.run_pack_plain(x, dx, dy)
        torch.cuda.synchronize()
        b4_err = max(b4_err, float((k.long() - p.long()).abs().max()))
        require(torch.equal(k, p), f"B4 {name}: kernel != plain at "
                f"{int((k != p).sum())} words")
        require(int((k > 0).sum()) > 0, f"B4 {name}: no run found")
        if name.startswith("noise"):
            require(bool((x[:, -1, :] != 0).any() & (x[:, :, -1] != 0).any()),
                    f"B4 {name}: no set bits at the border")
    # runs longer than the cap in each of the 12 dense directions (and two
    # steps with dy < 0 and with dy = 0, |dx| = 4), caps 1, 8 and 256
    b4_long = {0: 0, 3: 0, 8: 0}        # words at the cap, per max_doublings
    for dx, dy in dsteps + [(4, 0), (-3, -2)]:
        x = long_run_mask(gnoise, 2, LONG_RUN_SIZE, (dx, dy))
        for md in b4_long:
            k = lsd_kernel.run_pack(x, dx, dy, md)
            p = lsd_kernel.run_pack_plain(x, dx, dy, md)
            torch.cuda.synchronize()
            b4_err = max(b4_err, float((k.long() - p.long()).abs().max()))
            require(torch.equal(k, p), f"B4 long_runs {(dx, dy)} "
                    f"max_doublings={md}: kernel != plain at "
                    f"{int((k != p).sum())} words")
            at_cap = int(((k >> 6) == 1 << md).sum())
            require(at_cap > 0, f"B4 long_runs {(dx, dy)} "
                    f"max_doublings={md}: no run at the cap")
            b4_long[md] += at_cap
    # one step of the per-direction detector launches it once per direction
    b4_dirs = []
    b4_ms = b4_plain = 0.0
    for m, (dx, dy) in zip(masks, dsteps):
        ms = time_ms(lambda: lsd_kernel.run_pack(m, dx, dy), 20)
        plain = time_ms(lambda: lsd_kernel.run_pack_plain(m, dx, dy), 2)
        b4_ms += ms
        b4_plain += plain
        b4_dirs.append(dict(step=[dx, dy], ms=ms, plain_ms=plain,
                            set_share=float(m.float().mean())))
    b4_noise_ms = time_ms(
        lambda: lsd_kernel.run_pack(b4_cases[len(dsteps)][1], -4, 1), 20)
    bnd1, b4_by = bound_ms(N * H * W + N * Hp4 * Wp4 * 4,
                           N * Hp4 * Wp4 * RUN_PACK_ONE_OPS_PER_PIXEL)
    b4_bnd = bnd1 * len(dsteps)
    emit("B4_run_pack", equal=True, cases=[c[0] for c in b4_cases],
         long_run_words_at_cap=b4_long,
         long_run_shape=[2, LONG_RUN_SIZE, LONG_RUN_SIZE],
         shape=[N, H, W], out_shape=[N, Hp4, Wp4], dirs=b4_dirs,
         step_ms=b4_ms, step_plain_ms=b4_plain, noise_5_ms=b4_noise_ms,
         launch_bound_us=bnd1 * 1e3, step_bound_us=b4_bnd * 1e3,
         bound_by=b4_by)
    b4 = dict(name="run_pack", route="cuda",
              source="stvo_pl_tpu_torch/csrc/lsd_run_pack.cu",
              replaces="stvo_pl_tpu/ops/lsd_kernel.py:90",
              max_abs_err=b4_err, ms=b4_ms, plain_ms=b4_plain,
              bound_ms=b4_bnd, bound_by=b4_by, library_ms=None)
    del b4_cases, ang, mag, strong       # the masks stay for the pass split

    # ---- 5c. B5: Hamming distances on the tensor cores -----------------
    def words(*shape):
        return torch.randint(-2 ** 31, 2 ** 31 - 1, shape, generator=gnoise,
                             device=dev, dtype=torch.int32)

    K, Kl = cfg.point_capacity, cfg.line_capacity
    n_index = INDEX_IMAGES * Kl
    n_query = BATCH * Kl
    b5_shapes = {"points": (words(BATCH, K, 8), words(BATCH, K, 8)),
                 "lines": (words(BATCH, Kl, 8), words(BATCH, Kl, 8)),
                 "matcher": (words(n_query, 8), words(n_index, 8)),
                 "odd": (words(300, 8), words(257, 8))}
    b5_err = 0.0
    b5_rows = {}
    for name, (d1, d2) in b5_shapes.items():
        d2[..., :5, :] = d1[..., :5, :]           # pairs at distance 0
        for i, v in enumerate(HAMMING_EDGE_WORDS):
            d1[..., 5 + i, :] = v
            d2[..., -1 - i, :] = v
        d1[..., 9, :] = ~d2[..., 9, :]            # pairs at distance 256
        k = hamming.hamming_matrix_popc(d1, d2)
        p = hamming.hamming_matrix_xla(d1, d2)
        m = hamming.hamming_matrix_mxu(d1, d2)
        torch.cuda.synchronize()
        b5_err = max(b5_err, float((k - p).abs().max()))
        require(torch.equal(k, p), f"B5 {name}: kernel != plain at "
                f"{int((k != p).sum())} pairs")
        require(torch.equal(k, m), f"B5 {name}: kernel != bf16 product at "
                f"{int((k != m).sum())} pairs")
        require(int(k[..., 0, 0].max()) == 0
                and int(k[..., 9, 9].min()) == 256,
                f"B5 {name}: distances 0 and 256 not found")
        del p, m
        pairs = k.numel()
        bnd, by = bound_ms((d1.numel() + d2.numel() + pairs) * 4,
                           pairs * HAMMING_OPS_PER_PAIR)
        big = name == "matcher"
        b5_rows[name] = dict(
            shapes=[list(d1.shape), list(d2.shape)],
            ms=time_ms(lambda: hamming.hamming_matrix_popc(d1, d2),
                       10 if big else 50),
            plain_ms=time_ms(lambda: hamming.hamming_matrix_xla(d1, d2),
                             2 if big else 10),
            library_ms=time_ms(lambda: hamming.hamming_matrix_mxu(d1, d2),
                               10 if big else 50),
            bound_us=bnd * 1e3, bound_by=by)
        del k
    # one popcount VO step: stereo and frame-to-frame matching, of points
    # and of lines
    per_step = lambda key: 2 * (b5_rows["points"][key] + b5_rows["lines"][key])
    emit("B5_hamming_popc", equal=True, equal_to_bf16_product=True,
         shapes=b5_rows, step_ms=per_step("ms"),
         step_plain_ms=per_step("plain_ms"),
         step_library_ms=per_step("library_ms"),
         step_bound_us=per_step("bound_us"))
    b5 = dict(name="hamming_matrix_popc", route="cuda",
              source="stvo_pl_tpu_torch/csrc/hamming.cu",
              replaces="stvo_pl_tpu/ops/hamming.py:87",
              max_abs_err=b5_err, ms=per_step("ms"),
              plain_ms=per_step("plain_ms"),
              bound_ms=per_step("bound_us") / 1e3,
              bound_by=b5_rows["points"]["bound_by"],
              library_ms=per_step("library_ms"))
    del b5_shapes

    # ---- 6. VO: the batched step on 8 lanes ----------------------------
    wrappers = {"fast_pack": fast_kernel.fast_pack,
                "extract_patches": patches.extract_patches,
                "run_pack_multi": lsd_kernel.run_pack_multi,
                "run_pack": lsd_kernel.run_pack,
                "hamming_matrix_popc": hamming.hamming_matrix_popc}
    line_log = []       # (descriptors, validity) of each step's left lines

    def drive(run_cfg, frames, warmup, per_direction=False, log=None):
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
                cam, run_cfg, per_direction=per_direction)
            telems.append(telem)
            if log is not None:
                log.append((state.prev_lines.desc, state.prev_lines.valid))
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
        # a kernel that is not named must not have run
        for k in wrappers:
            n = expected.get(k, 0)
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
    telems, r_main = drive(cfg, n_frames, WARMUP_FRAMES, log=line_log)
    emit("vo", **r_main, points_only_ms_per_step=r_pts["ms_per_step"])
    check("vo", r_main, {"fast_pack": n_frames * cfg.orb_nlevels,
                         "extract_patches": n_frames * cfg.orb_nlevels,
                         "run_pack_multi": n_frames})
    require(min(r_main["inliers_ls_lanes"]) > 0,
            f"vo: a lane tracked no line: {r_main['inliers_ls_lanes']}")

    # the dense single-octave detector with either candidate generator
    nf = POINTS_ONLY_FRAMES
    points_launches = {"fast_pack": nf * cfg.orb_nlevels,
                       "extract_patches": nf * cfg.orb_nlevels}
    cfg_dense = VOConfig(lsd_octaves=1)
    r_dense = {}
    for gen_name, per_direction, lsd_launches in (
            ("all_direction", False, {"run_pack_multi": nf}),
            ("per_direction", True, {"run_pack": nf * cfg.lsd_n_dirs})):
        tel_d, r = drive(cfg_dense, nf, WARMUP_FRAMES,
                         per_direction=per_direction)
        check(f"vo_dense {gen_name}", r, {**points_launches, **lsd_launches})
        require(min(r["inliers_ls_lanes"]) > 0, f"vo_dense {gen_name}: a "
                f"lane tracked no line: {r['inliers_ls_lanes']}")
        r_dense[gen_name] = r
        if per_direction:
            telems_dense_pd = tel_d
    emit("vo_dense", generators=r_dense,
         ate_m={k: r["ate_m"] for k, r in r_dense.items()},
         inliers_ls={k: float(np.mean(r["inliers_ls_lanes"]))
                     for k, r in r_dense.items()},
         ms_per_step={k: r["ms_per_step"] for k, r in r_dense.items()})

    # the default step with XOR + popcount distances: the same integers
    # as the bf16 product's, so the same poses
    tel_p, r_popc = drive(VOConfig(hamming_use_mxu=False), nf, WARMUP_FRAMES)
    n_popc = r_popc["launches"]["hamming_matrix_popc"]
    require(n_popc > 0 and n_popc % nf == 0, f"vo_popcount: {n_popc} "
            f"Hamming launches in {nf} steps")
    check("vo_popcount", r_popc, {**points_launches, "run_pack_multi": nf,
                                  "hamming_matrix_popc": n_popc})
    pose_diff = max(float((a.Tfw[:, :3, 3] - b.Tfw[:, :3, 3]).abs().max())
                    for a, b in zip(tel_p, telems))
    emit("vo_popcount", **r_popc, hamming_launches_per_step=n_popc // nf,
         max_translation_diff_to_vo_m=pose_diff,
         poses_bit_equal=all(torch.equal(a.Tfw, b.Tfw)
                             for a, b in zip(tel_p, telems)))
    require(pose_diff <= 1e-6, f"vo_popcount: poses differ from the bf16 "
            f"product's by {pose_diff} m")

    # ---- 6b. the binary descriptor matcher -----------------------------
    # index: the left lines of the main run's first 8 steps x 8 lanes (64
    # images x 300 rows), rows without a line filled with seeded random
    # words; queries: the 9th step's lines, the first 100 replaced by rows
    # of the index
    steps_in_index = INDEX_IMAGES // BATCH
    descs, n_detected = [], 0
    for desc, valid in line_log[:steps_in_index]:
        fill = words(*desc.shape)
        descs += list(torch.where(valid[..., None], desc, fill))
        n_detected += int(valid.sum())
    index = binary_matcher.build_index(descs)
    qd, qv = line_log[steps_in_index]
    query = torch.where(qv[..., None], qd, words(*qd.shape)).reshape(-1, 8)
    planted = torch.arange(100, device=dev) * 191
    query[:100] = index.desc[planted]
    require(index.desc.shape == (n_index, 8) and query.shape == (n_query, 8),
            f"binary_matcher: index {tuple(index.desc.shape)}, queries "
            f"{tuple(query.shape)}")
    hamming.hamming_matrix_popc.launches = 0
    t0 = time.perf_counter()
    res = {}
    for use_mxu in (False, True):
        res[use_mxu] = (
            binary_matcher.knn_match(query, index, 2, use_mxu=use_mxu),
            binary_matcher.match(query, index, use_mxu=use_mxu),
            binary_matcher.radius_match(query, index, max_distance=40,
                                        max_results=4, use_mxu=use_mxu))
    torch.cuda.synchronize()
    matcher_s = time.perf_counter() - t0
    for a, b in zip(res[False], res[True]):
        for f, x, y in zip(a._fields, a, b):
            require(torch.equal(x, y), f"binary_matcher: {f} differs between "
                    f"the popcount kernel and the bf16 product")
    knn = res[False][0]
    require(bool((knn.dist[:100, 0] == 0).all())
            and bool((knn.dist[:, 0] <= knn.dist[:, 1]).all()),
            "binary_matcher: planted queries not at distance 0")
    # a planted query finds its own row, or an equal row before it
    found = knn.idx[:100, 0]
    require(bool((found <= planted).all())
            and torch.equal(index.desc[found], query[:100]),
            "binary_matcher: planted queries did not find themselves")
    require(hamming.hamming_matrix_popc.launches == 3,
            f"binary_matcher: {hamming.hamming_matrix_popc.launches} "
            f"Hamming launches in 3 popcount calls")
    emit("binary_matcher", index_rows=n_index, detected_rows=n_detected,
         queries=n_query, equal_to_bf16_product=True, planted_found=100,
         in_radius_40=int((res[False][2].idx >= 0).sum()),
         seconds_6_calls=matcher_s)
    del res, index, query, descs

    # ---- 6c. RGB-D: lane 0 with the renderer's depth maps --------------
    cfg_rgbd = VOConfig(rgbd_max_depth=200.0)     # the scene reaches 95 m
    for w in wrappers.values():
        w.launches = 0
    state = frontend.init_state(cfg_rgbd)
    traj, rgbd_ls, rgbd_pt = [], 0, 0
    for i in range(nf):
        state, t = frontend.vo_step_rgbd(state, seq_l[0, i].contiguous(),
                                         depth0[i], cam, cfg_rgbd)
        traj.append(t.Tfw)
        rgbd_ls += int(t.n_inliers_ls)
        rgbd_pt += int(t.n_inliers_pt)
    torch.cuda.synchronize()
    rgbd_ate = metrics.ate_rmse(torch.stack(traj).double().cpu().numpy(),
                                poses[:nf].double().cpu().numpy())
    emit("rgbd", frames=nf, ate_m=rgbd_ate,
         depth_share=float((depth0 > 0).float().mean()),
         inliers_pt_per_frame=rgbd_pt / (nf - 1),
         inliers_ls_per_frame=rgbd_ls / (nf - 1),
         launches={k: w.launches for k, w in wrappers.items()})
    require(np.isfinite(rgbd_ate) and rgbd_ate < 0.1,
            f"rgbd: ATE {rgbd_ate} m")
    require(fast_kernel.fast_pack.launches == nf * cfg.orb_nlevels
            and lsd_kernel.run_pack_multi.launches == nf,
            "rgbd: the step did not go through the FAST and run kernels")

    # ---- 7. the kernels' path against the plain path -------------------
    # lane 0's first frames through the port on the CPU (plain versions)
    cpu_state = frontend.init_state(cfg, device="cpu")
    dmax = 0.0
    for i in range(PARITY_FRAMES):
        cpu_state, ct = frontend.vo_step(cpu_state, seq_l[0, i].cpu(),
                                         seq_r[0, i].cpu(), cam, cfg)
        gpu_T = telems[i].Tfw[0].cpu()
        dmax = max(dmax, float((ct.Tfw[:3, 3] - gpu_T[:3, 3]).abs().max()))
    # and of the dense per-direction configuration
    cpu_state = frontend.init_state(cfg_dense, device="cpu")
    dmax_dense = 0.0
    for i in range(DENSE_PARITY_FRAMES):
        cpu_state, ct = frontend.vo_step(
            cpu_state, seq_l[0, i].cpu(), seq_r[0, i].cpu(), cam, cfg_dense,
            per_direction=True)
        gpu_T = telems_dense_pd[i].Tfw[0].cpu()
        dmax_dense = max(dmax_dense,
                         float((ct.Tfw[:3, 3] - gpu_T[:3, 3]).abs().max()))
    emit("cpu_parity", frames=PARITY_FRAMES, max_translation_diff_m=dmax,
         dense_per_direction_frames=DENSE_PARITY_FRAMES,
         dense_max_translation_diff_m=dmax_dense)
    require(dmax < 0.01, f"GPU and CPU poses differ by {dmax} m")
    require(dmax_dense < 0.01, f"dense per-direction: GPU and CPU poses "
            f"differ by {dmax_dense} m")

    # ---- 8. B4 split into its passes, by torch.profiler ----------------
    # last: after a profiler session in this process the VO phases' steps
    # read slower on the host clock (PERF.md §5)
    b4_split, b4_dir_split = {}, []
    for m, (dx, dy) in zip(masks, dsteps):
        split = kernel_split_us(lambda: lsd_kernel.run_pack(m, dx, dy))
        for key, us in split.items():
            b4_split[key] = b4_split.get(key, 0.0) + us
        b4_dir_split.append(dict(step=[dx, dy], split_us=split))
    emit("B4_pass_split", step_split_us=b4_split, dirs=b4_dir_split)
    del masks

    # each kernel's launches come from the phase whose path runs it
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    ran_in = [(b1, r_main), (b2, r_main), (b3, r_main),
              (b4, r_dense["per_direction"]), (b5, r_popc)]
    table = [{k: row[k] for k in keys} for row in
             (dict(r, launches=run["launches"][r["name"]])
              for r, run in ran_in)]
    require(all(row["launches"] > 0 for row in table),
            f"a kernel was launched no time on its path: {table}")
    print(json.dumps({"kernels": table}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
