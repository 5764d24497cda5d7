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
direction and per pass), holds ORB's descriptor kernel (orb_describe:
csrc/orb_describe.cu) bit for bit to the bf16 test-bank product and to
its plain twin on the fleet cells' patches (153,600 over 4 levels and
256,000 at one) and times the three, then drives the default point + line VO
step (parallel.batched.vo_step_batched, VOConfig()) over 8 distinct
synthetic KITTI-sized sequences (1226x370, 26 frames) on the card and
checks the trajectories.  Over the first 6 frames of the same sequences it
also drives the points-only step, the dense single-octave line detector
(lsd_octaves=1) with either run candidate generator, the default step with
popcount Hamming distances (hamming_use_mxu=False), the binary descriptor
matcher over an index of the lanes' line descriptors, and the RGB-D step
on one lane.  Every step runs the pose optimizer's kernel
(csrc/pose_optim.cu) once; pose_optim holds it against the plain
optimizer (optimize_pose_plain) on optimize_pose's arguments of 8 steps
of the 8 lanes stacked into 64, under VOConfig() (1,200 points, 300
lines) and the points-only preset (2,000 points): good, the inlier masks
and counts equal, DT, err and the covariance within the GPU test's
tolerances, bit for bit from call to call.  Then it writes 40 frames of the textured street canyon
(utils/world.py) at the KITTI size to disk under build/ and runs the
dataset CLI over them with windowed bundle adjustment (cli_ba: VOConfig(),
windows of 4 keyframes, every 3rd frame promoted, frames read through the
native prefetching loader; then the loader's 40 pairs against PIL's,
B1-B3 against their plain versions on the street's first pair, and the
CLI's first 3 frames on the CPU), and refines one
window of the first 10 frames with the bf16 product's and with B5's
Hamming distances (ba_popcount: equal problems and poses, 12 B5 launches,
the same window on the CPU).  Over the first 6 frames of the 8 lanes it
drives the EDLine detector (vo_edlines: use_edlines=True at edline_scale
2 and 1, with detect_edlines on the card against the CPU and two RGB-D
steps), and in an NCCL world of one (sharded) the compiled sharded step,
the same step with every matcher column-sharded over a model group of 1
(its all-gathers captured) and the unsharded compiled step, each timed in
turns with its eager body, then the compiled make_sharded_ba and the
compiled sharded window refiner (both Hamming routes) on the ba_popcount
window against their eager bodies, ba_solve, compile_refiner and
refine_window, and tp_match against the dense matcher, all `torch.equal`,
with the collectives each capture issued and what the graphs hold for
them.  Then it checkpoints the 8 lanes' state after 3 of 6
frames and resumes from the file (checkpoint: the resumed poses
`torch.equal` to the straight run's, or within the difference of two
straight runs), and, last, traces one default step and 3 replays of
the compiled step with utils.profiling (profiling: B1-B3's CUDA kernels
and the optimizer's in the eager trace as often as their wrappers counted them and in the
replays' as often as the graph's kernel nodes say, the device busy share
within each traced window), and one replay each of the compiled dense
per-direction and popcount steps (B4's and B5's kernels as the graphs
hold them), before B4's pass split.

The compiled programs (the VO step and the window refiner captured as
CUDA graphs, parallel/compiled.py) run beside their eager forms:
vo_graph takes the compiled default step over vo's 26 frames in turns
with the eager step (eager, graph, eager, graph: ms/step, fps, capture
seconds, the memory its first call keeps), every step's telemetry and
the final state `torch.equal` to eager and the kernels' counts equal
(a graph's are its kernel nodes, read from the captured graph through
the driver API, times its replays), then the compiled
points-only, dense (both generators), popcount and RGB-D steps against
their eager runs; vo_edlines holds its compiled step to the eager one
by its own rule; cli_ba runs the CLI compiled (its default on the card)
and the same CLI eagerly, poses, refined poses and ATEs equal; ba_graph
refines the ba_popcount window with the compiled and the eager refiner
in turns; ops_graph takes the compiled counterparts of the JAX package's
other jitted entry points at full width (the one-lane RGB-D step over
the rgbd phase's frames, ba_solve on the ba_popcount window, the binary
matcher's three forms with both distance routes on its index, both line
detectors with two values of min_length, select_keypoints,
orient_and_describe, compute_lbd, compute_lbd_atlas and build_pyramid on
the 16 images of two frames), each against eager on every input
(EDLines by its set rule) and in turns with it, its graph's wrapper
nodes equal to eager's launches, one program at a time.  The kernel
table's ops_graph_launches gives those graphs' launches of each kernel,
beside the launches of its own path.
Every phase prints one JSON line; any
failed check exits non-zero.  The last three lines are the kernel table
(with each kernel's launches per phase), the card's name and power
limit, and the result line.

Needs one CUDA device; exits non-zero without one.  Imports nothing of
JAX.
"""

from __future__ import annotations

import contextlib
import ctypes
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
# the pose optimizer's kernel against optimize_pose_plain, with the
# tolerances of tests/test_torch_optimizer_cuda.py: DT, err (relative),
# covariance and eigenvalues (of the lane's largest entry), iterations
POSE_DT_TOL, POSE_ERR_TOL, POSE_COV_TOL, POSE_ITERS_TOL = 2e-4, 1e-3, 2e-3, 2
# its float operations per solver iteration: residual, Jacobian, weight
# and normal-equation terms of a point and of a line
POSE_OPS_PER_POINT = 139
POSE_OPS_PER_LINE = 243
# ORB's descriptor kernel per keypoint: the 33 x 33 float32 patch read
# and 8 words, cos and sin written; integer operations: quantize (round,
# two clamps) each pixel, 2 multiply-adds per moment and pixel of the
# radius-15 disc (709 pixels), one comparison per test
ORB_BYTES_PER_KEYPOINT = 33 * 33 * 4 + 8 * 4 + 2 * 4
ORB_OPS_PER_KEYPOINT = 3 * 33 * 33 + 4 * 709 + 256
# the orb_describe phase: the fleet cells' patches, 64 lanes x 2 eyes
# from the 8 lanes' first 8 frames: kitti_pl (VOConfig(), 1,200 corners
# over 4 levels, 153,600 patches) and kitti_points (2,000 at one level,
# 256,000)
ORB_FLEET_FRAMES = 8
# B5's edge words, each in rows of its own: 0, 0xFFFFFFFF, 0x80000000 and
# 0x7FFFFFFF
HAMMING_EDGE_WORDS = (0, -1, -2 ** 31, 2 ** 31 - 1)

# the application phases: the textured street (tools/export_street_torch.py,
# 0.8 m/frame); windows of 4 keyframes, every 3rd frame promoted;
# GPU-vs-CPU tolerance of one window's refined poses (m and rotation
# entries)
CLI_FRAMES = 40
BA_FRAMES = 10
BA_WINDOW = 4
BA_KF_EVERY = 3
GPU_CPU_BA_TOL = 1e-3
CLI_PARITY_FRAMES = 3       # the CLI's first frames again on the CPU
GPU_CPU_CLI_TOL = 0.01      # m, as the batched step's cpu_parity

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
CHECKPOINT_FRAMES = 6       # the checkpoint phase: 6 frames, saved after 3
CHECKPOINT_AT = 3
PROFILED_AT = 2             # the profiling phase traces the 3rd step
POSE_STEPS = 8              # the pose_optim phase: 8 steps x 8 lanes = 64
POSE_PROBES = 4             # and the plain path on 4 reorderings of them
GRAPH_TRACED_REPLAYS = 3    # replays of the compiled step in one trace


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


def shared_fraction(a, b, tol: float = 0.5) -> float:
    """Share of the valid segments of the larger of two LineSegments (one
    image each, numpy leaves) that have a partner in the other with both
    endpoints within `tol` px (tests/test_torch_helpers.py's rule)."""
    pa = np.concatenate([a.sp, a.ep], axis=-1)[a.valid]
    pb = np.concatenate([b.sp, b.ep], axis=-1)[b.valid]
    if len(pa) == 0 or len(pb) == 0:
        return float(len(pa) == len(pb))
    d = np.abs(pa[:, None, :] - pb[None, :, :]).max(axis=-1)
    return float((d.min(axis=1) <= tol).sum()) / max(len(pa), len(pb))


def street_kernels_equal(root: str, cfg) -> dict:
    """B1, B2 and B3 against their plain versions (torch.equal) on the
    inputs the CLI's step gives them for the street's first stereo pair
    (`pair_kernels_equal`)."""
    from stvo_pl_tpu_torch.utils.dataset import ImageSequence

    dev = torch.device("cuda")
    img_l, img_r = ImageSequence(root, nmax=1, device=dev).frame(0)
    return pair_kernels_equal(img_l, img_r, cfg)


def pair_kernels_equal(img_l, img_r, cfg, where: str = "cli_ba") -> dict:
    """B1, B2 and B3 against their plain versions (torch.equal) on the
    inputs a one-lane step gives them for a rectified stereo pair on the
    card: [2, H, W] per pyramid level, the lane's two eyes, built as the
    main path's kernel checks build theirs; returns the shapes checked."""
    from stvo_pl_tpu_torch.models import frame as frame_mod
    from stvo_pl_tpu_torch.ops import fast as fast_ops
    from stvo_pl_tpu_torch.ops import fast_kernel, lsd, lsd_kernel, orb
    from stvo_pl_tpu_torch.ops import patches
    from stvo_pl_tpu_torch.ops.image import gaussian_blur, pyramid_levels

    dev = torch.device("cuda")
    pair = torch.stack([img_l, img_r]).to(dev).contiguous()
    levels = pyramid_levels(pair, cfg.orb_nlevels, cfg.orb_scale_factor,
                            blur_sigma=0.6)
    budgets = frame_mod._per_level_budgets(cfg)
    th = torch.full((2,), float(cfg.orb_fast_th), device=dev)
    P = orb.PATCH
    shapes = dict(fast_pack=[], extract_patches=[])
    for lv, img in enumerate(levels):
        img = img.contiguous()
        k = fast_kernel.fast_pack(img, cfg.orb_edge_th)
        p = fast_kernel.fast_pack_plain(img, cfg.orb_edge_th)
        torch.cuda.synchronize()
        require(torch.equal(k, p), f"{where}: B1 level {lv}: kernel != "
                f"plain at {int((k != p).sum())} words")
        shapes["fast_pack"].append(list(img.shape))
        blur = gaussian_blur(img, 2.0, radius=3).contiguous()
        uv, _, _ = fast_ops.detect_keypoints(img, th, budgets[lv],
                                             edge=cfg.orb_edge_th)
        N, H, W = blur.shape
        x0 = torch.clamp(torch.round(uv[..., 0]).to(torch.int32)
                         - orb.PATCH_R, 0, W - P).contiguous()
        y0 = torch.clamp(torch.round(uv[..., 1]).to(torch.int32)
                         - orb.PATCH_R, 0, H - P).contiguous()
        k = patches.extract_patches(blur, y0, x0, P)
        p = patches.extract_patches_plain(blur, y0, x0, P)
        torch.cuda.synchronize()
        require(torch.equal(k, p), f"{where}: B2 level {lv}: kernel != plain")
        shapes["extract_patches"].append([N, H, W, y0.shape[1]])
    n_dirs = frame_mod._oct_dirs(cfg)
    steps = lsd.direction_steps(n_dirs)
    tol = math.radians(cfg.lsd_ang_th)
    cv = frame_mod.octave_canvas(pair, cfg)
    bits = lsd.direction_bitmask(cv.ang, cv.mag, steps, tol,
                                 cfg.lsd_quant / math.sin(tol)).contiguous()
    k = lsd_kernel.run_pack_multi(bits, steps)
    p = lsd_kernel.run_pack_multi_plain(bits, steps)
    torch.cuda.synchronize()
    require(torch.equal(k, p), f"{where}: B3: kernel != plain")
    shapes["run_pack_multi"] = list(bits.shape)
    return shapes


def eager_cli(argv: list):
    """The CLI with the eager step and window refiner in place of their
    compiled programs (as it ran before it had them): `cli.run(argv)`
    with frontend.compile_vo_step and window.compile_refiner patched."""
    from unittest import mock

    from stvo_pl_tpu_torch import cli
    from stvo_pl_tpu_torch.models import frontend
    from stvo_pl_tpu_torch.parallel import window

    def step(cam, cfg, per_direction=False, device=None, rectify=None):
        def run(s, a, b):
            return frontend.vo_step(s, a.to(device, non_blocking=True),
                                    b.to(device, non_blocking=True), cam, cfg,
                                    rectify=rectify)
        # no program, so no stage ring: the CLI prints no stage line
        run.stages = lambda: ([], torch.zeros((0, 0), dtype=torch.int64))
        return run

    def refiner(cam, cfg, auto=True, device=None, **kw):
        if auto:
            return lambda win: window.refine_window_auto(win, cam, cfg, **kw)
        return lambda win: window.refine_window(win, cam, cfg, **kw)

    with mock.patch.object(frontend, "compile_vo_step", step), \
            mock.patch.object(window, "compile_refiner", refiner):
        return cli.run(argv)


def cli_ba_phase(root: str, gt: np.ndarray, cam, cfg, wrappers: dict,
                 smi: str, vo_ms_per_step: float) -> dict:
    """The dataset CLI with windowed BA over the street dataset on the
    card, on its compiled path (the step and the window refiner as CUDA
    graphs): checks the trajectories and the kernels' counts, and the
    poses, refined poses and ATEs equal to the same CLI run eagerly; then
    B1-B3 against their plain versions on the street's first pair and the
    first CLI_PARITY_FRAMES frames of the CLI on the CPU; returns the
    phase's numbers."""
    import contextlib
    import io
    import os

    from unittest import mock

    from stvo_pl_tpu_torch import cli
    from stvo_pl_tpu_torch.models import frontend
    from stvo_pl_tpu_torch.parallel import window
    from stvo_pl_tpu_torch.utils import metrics

    from stvo_pl_tpu_torch.native import loader as native
    from stvo_pl_tpu_torch.utils.dataset import ImageSequence, load_gray

    n = len(gt)
    traj = os.path.join(root, "traj.txt")
    argv = [root, "--ba-window", str(BA_WINDOW), "--ba-kf-every",
            str(BA_KF_EVERY), "--gt", os.path.join(root, "gt.txt"), "-t",
            traj, "--quiet"]
    # the compiled programs that the CLI builds, their graphs kept
    made = []

    def spy(build):
        return lambda *a, **kw: made.append(build(*a, **kw)) or made[-1]

    for w in wrappers.values():
        w.launches = 0
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf), kept_graphs(), \
            mock.patch.object(frontend, "compile_vo_step",
                              spy(frontend.compile_vo_step)), \
            mock.patch.object(window, "compile_refiner",
                              spy(window.compile_refiner)):
        run = cli.run(argv)
    seconds = time.perf_counter() - t0
    # the wrappers count the warm-up's and the capture's calls; the
    # replays launch each graph's kernel nodes
    wrapper_launches = {k: w.launches for k, w in wrappers.items()}
    graphs = []
    for c in made:
        for prog in c.programs.values():
            nodes = graph_nodes(prog.graph)[0]
            graphs.append(dict(prog=prog, nodes=wrapper_nodes(nodes),
                               kernel_nodes=sum(nodes.values())))
    graph_launches = replayed(graphs, wrappers, [0] * len(graphs))
    launches = {k: n + graph_launches[k]
                for k, n in wrapper_launches.items()}
    ba = run.backend
    require(run.loader == "native", f"cli_ba: the CLI read its frames "
            f"through the {run.loader} path, not the native loader")
    require(np.isfinite(run.poses).all(), "cli_ba: non-finite poses")
    require(run.poses_refined is not None and len(ba.events) >= 2,
            f"cli_ba: {len(ba.events)} windows refined, expected >= 2")
    raw = run.poses.astype(np.float64)
    ate = metrics.ate_rmse(raw, gt)
    ate_u = metrics.ate_rmse(raw, gt, align=False)
    ref_u = metrics.ate_rmse(run.poses_refined, gt, align=False)
    ref_a = metrics.ate_rmse(run.poses_refined, gt)
    written = metrics.read_tum(traj + ".refined")
    require(np.abs(written - run.poses_refined).max() < 1e-5,
            "cli_ba: the refined trajectory file differs from the run's")
    require(ate < 0.1, f"cli_ba: aligned raw ATE {ate} m")
    require(ref_u <= 1.05 * ate_u, f"cli_ba: refined unaligned ATE {ref_u} "
            f"m against raw {ate_u} m")
    # the same CLI, eager
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        eager = eager_cli(argv)
    eager_s = time.perf_counter() - t0
    require(np.array_equal(eager.poses, run.poses)
            and eager.poses_refined is not None
            and np.array_equal(eager.poses_refined, run.poses_refined)
            and len(eager.backend.events) == len(ba.events),
            "cli_ba: the compiled CLI's poses differ from the eager CLI's")
    eager_ms = np.array([s["ms"] for s in eager.stats][2:])
    # the native loader's pairs against PIL's, and the decode time per
    # pair of each (the loader's with its 2 threads, into pinned memory as
    # the CLI reads them, and into pageable memory); the frames it held
    # decoded ahead of the consumer stay within its window
    seq = ImageSequence(root, device="cuda")
    native_ms, held = {}, 0
    for pin in (False, True):
        t0 = time.perf_counter()
        with native.PrefetchingLoader(seq.paths_l, seq.paths_r, cam.width,
                                      cam.height, pin_memory=pin) as ld:
            pairs = []
            for pair in ld:
                pairs.append(pair)
                held = max(held, ld.buffered()[1])
        native_ms[pin] = (time.perf_counter() - t0) * 1e3 / n
    require(held <= native.CAPACITY, f"cli_ba: the loader held {held} "
            f"decoded frames, more than its window of {native.CAPACITY}")
    t0 = time.perf_counter()
    plain = [(load_gray(a), load_gray(b))
             for a, b in zip(seq.paths_l, seq.paths_r)]
    pil_ms = (time.perf_counter() - t0) * 1e3 / n
    require(len(pairs) == len(plain) == n and all(
        torch.equal(x, torch.from_numpy(y))
        for pair, ref in zip(pairs, plain) for x, y in zip(pair, ref)),
        "cli_ba: the native loader's pairs differ from PIL's")
    del pairs, plain
    # the kernels at the CLI's shapes, on its inputs
    kernel_shapes = street_kernels_equal(root, cfg)
    # the first frames of the same CLI on the CPU (the plain versions)
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        cpu_poses = cli.main([root, "-n", str(CLI_PARITY_FRAMES),
                              "--device", "cpu", "--quiet"])
    cpu_s = time.perf_counter() - t0
    cpu_dt = float(np.abs(cpu_poses[:, :3, 3]
                          - run.poses[:CLI_PARITY_FRAMES, :3, 3]).max())
    require(cpu_dt <= GPU_CPU_CLI_TOL, f"cli_ba: the CLI on the CPU differs "
            f"from the card's by {cpu_dt} m in {CLI_PARITY_FRAMES} frames")
    # what the CLI printed per frame: the interval between frames done,
    # which holds the BA windows refined in it
    ms = np.array([s["ms"] for s in run.stats][2:])
    t_ba = ba.refine_times
    e_ba = eager.backend.refine_times
    return dict(frames=n, height=cam.height, width=cam.width,
                seconds=seconds, compiled=True,
                cli_ms_per_frame=float(ms.mean()),
                eager_cli_ms_per_frame=float(eager_ms.mean()),
                eager_seconds=eager_s, vo_eager_ms_per_step=vo_ms_per_step,
                eager_ba_s=e_ba, equal_to_eager_cli=True,
                vo_ms_per_frame=float((ms.sum() - 1e3 * sum(t_ba))
                                      / len(ms)),
                ba_first_s=t_ba[0],
                ba_steady_s=float(np.median(t_ba[1:])) if len(t_ba) > 1
                else None, ba_s=t_ba, windows_refined=len(ba.events),
                windows_skipped=ba.n_skipped,
                windows_line_rejected=ba.n_lines_rejected,
                keyframe_windows=[e[0] for e in ba.events],
                ate_raw_aligned_m=ate, ate_raw_unaligned_m=ate_u,
                ate_refined_unaligned_m=ref_u, ate_refined_aligned_m=ref_a,
                launches=launches, wrapper_launches=wrapper_launches,
                graph_launches=graph_launches,
                programs=[dict(replays=g["prog"].replays,
                               kernel_nodes=g["kernel_nodes"])
                          for g in graphs],
                kernels_equal_at=kernel_shapes,
                loader=run.loader, loader_pairs_equal_to_pil=n,
                decode_ms_per_pair_native=native_ms[True],
                decode_ms_per_pair_native_pageable=native_ms[False],
                decode_ms_per_pair_pil=pil_ms,
                loader_peak_held=held, loader_window=native.CAPACITY,
                cpu_frames=CLI_PARITY_FRAMES, cpu_seconds=cpu_s,
                gpu_cpu_max_translation_diff_m=cpu_dt,
                cli_lines=[l for l in buf.getvalue().splitlines()
                           if l.startswith("[stvo]")], card=smi)


def ba_graph_phase(win, cam, cfg, smi: str) -> dict:
    """The ba_popcount window (B5's route) refined by the compiled
    refiner (a CUDA graph) and the eager one in turns: poses and every
    other output `torch.equal`, B5's launches per replayed window (its
    kernel nodes in the graph) equal to an eager window's, seconds per
    window of both."""
    from stvo_pl_tpu_torch.ops import hamming
    from stvo_pl_tpu_torch.parallel import window

    sync = torch.cuda.synchronize
    c = cfg.replace(hamming_use_mxu=False)
    g = first_call(window.compile_refiner(cam, c, n_iters=8), win)
    refine = g["fn"]
    n_pairs = BA_WINDOW * (BA_WINDOW - 1) // 2
    hamming.hamming_matrix_popc.launches = 0
    since = [g["prog"].replays]
    got = refine(win)
    sync()
    wrapper = hamming.hamming_matrix_popc.launches
    launches = (wrapper + replayed([g], {"hamming_matrix_popc": None},
                                   since)["hamming_matrix_popc"])
    hamming.hamming_matrix_popc.launches = 0
    want = window.refine_window_auto(win, cam, c, n_iters=8)
    sync()
    eager = hamming.hamming_matrix_popc.launches
    require(wrapper == 0 and launches == eager == 2 * n_pairs,
            f"ba_graph: B5 launched {launches} times by a replayed window "
            f"({wrapper} by its wrapper), {eager} by an eager one, "
            f"expected {2 * n_pairs}")
    require(same(got, want), "ba_graph: the compiled refiner's window "
            "differs from the eager refiner's")
    s_all = {"eager": [], "graph": []}
    for _ in range(3):                       # eager, graph in turns
        for name, fn in (("eager", lambda: window.refine_window_auto(
                win, cam, c, n_iters=8)), ("graph", lambda: refine(win))):
            sync()
            t0 = time.perf_counter()
            fn()
            sync()
            s_all[name].append(time.perf_counter() - t0)
    return dict(K=BA_WINDOW, n_iters=8, s_per_window=s_all,
                eager_over_graph=min(s_all["eager"]) / min(s_all["graph"]),
                capture_s=g["capture_s"],
                first_call_bytes=g["first_call_bytes"],
                graph_kernel_nodes=g["kernel_nodes"],
                b5_launches_per_window=launches, poses_equal=True,
                used_lines=bool(got[3]), card=smi)


def first_window(root: str, cam, cfg):
    """VO over the first BA_FRAMES frames of the dataset at `root` on the
    card, fed to a WindowedBA(window=BA_WINDOW, force_kf_every =
    BA_KF_EVERY) as the CLI feeds it; its first window, stacked.  Returns
    (window, keyframe indices)."""
    from stvo_pl_tpu_torch.models import frontend
    from stvo_pl_tpu_torch.models.backend import WindowedBA
    from stvo_pl_tpu_torch.utils.dataset import ImageSequence

    class Capture(WindowedBA):
        """Hands its first full window back unrefined."""

        def _refine(self):
            return [i for i, *_ in self._ring], self.stack_window()

    dev = torch.device("cuda")
    seq = ImageSequence(root, nmax=BA_FRAMES, device=dev)
    state = frontend.init_state(cfg, device=dev)
    ba = Capture(cam, cfg, window=BA_WINDOW, force_kf_every=BA_KF_EVERY,
                 device=dev)
    for i, (img_l, img_r) in enumerate(seq):
        state, t = frontend.vo_step(state, img_l.to(dev), img_r.to(dev), cam,
                                    cfg)
        got = ba.observe(i, t.Tfw, t.is_kf, state.prev_points,
                         state.prev_lines)
        if got is not None:
            kf_frames, win = got
            return win, kf_frames
    fail(f"ba_popcount: fewer than {BA_WINDOW} keyframes in {BA_FRAMES} "
         "frames")


def ba_popcount_phase(win, kf_frames, cam, cfg, smi: str) -> dict:
    """One window of K = 4 keyframes from the first BA_FRAMES frames,
    refined with the bf16 product's Hamming distances and with B5's:
    equal problems and poses, 12 B5 launches, B5 against its plain
    version at the window's shapes, and the window on the CPU."""
    from stvo_pl_tpu_torch.ops import hamming
    from stvo_pl_tpu_torch.parallel import window

    sync = torch.cuda.synchronize
    routes = {}
    for name, use_mxu in (("bf16_product", True), ("popcount_kernel", False)):
        c = cfg.replace(hamming_use_mxu=use_mxu)
        prob = window.build_problem_tracks(win, cam, c)
        hamming.hamming_matrix_popc.launches = 0
        out = window.refine_window_auto(win, cam, c, n_iters=8)
        sync()
        routes[name] = dict(cfg=c, prob=prob, out=out, ms_all=[],
                            launches=hamming.hamming_matrix_popc.launches)
    for _ in range(3):                  # the two routes in turns
        for r in routes.values():
            sync()
            t0 = time.perf_counter()
            window.refine_window_auto(win, cam, r["cfg"], n_iters=8)
            sync()
            r["ms_all"].append((time.perf_counter() - t0) * 1e3)
    for r in routes.values():
        r["ms"] = min(r["ms_all"])
    a, b = routes["bf16_product"], routes["popcount_kernel"]
    n_pairs = BA_WINDOW * (BA_WINDOW - 1) // 2
    require(a["launches"] == 0 and b["launches"] == 2 * n_pairs,
            f"ba_popcount: B5 launched {a['launches']} / {b['launches']} "
            f"times, expected 0 / {2 * n_pairs}")
    for f in a["prob"]._fields:
        require(torch.equal(getattr(a["prob"], f), getattr(b["prob"], f)),
                f"ba_popcount: the problems differ in {f}")
    for x, y in zip(a["out"], b["out"]):
        require(torch.equal(x, y), "ba_popcount: the refinements differ")
    # B5 at the window's unbatched shapes, against its plain version and
    # the bf16 product
    b5 = {}
    for kind, fs in (("points", win.points), ("lines", win.lines)):
        d1, d2 = fs.desc[0].contiguous(), fs.desc[1].contiguous()
        k = hamming.hamming_matrix_popc(d1, d2)
        p = hamming.hamming_matrix_xla(d1, d2)
        sync()
        require(torch.equal(k, p), f"ba_popcount: B5 != plain at {kind}")
        require(torch.equal(k, hamming.hamming_matrix_mxu(d1, d2)),
                f"ba_popcount: B5 != bf16 product at {kind}")
        bnd, by = bound_ms((d1.numel() + d2.numel() + k.numel()) * 4,
                           k.numel() * HAMMING_OPS_PER_PAIR)
        b5[kind] = dict(
            shapes=[list(d1.shape), list(d2.shape)],
            ms=time_ms(lambda: hamming.hamming_matrix_popc(d1, d2), 50),
            plain_ms=time_ms(lambda: hamming.hamming_matrix_xla(d1, d2), 10),
            library_ms=time_ms(lambda: hamming.hamming_matrix_mxu(d1, d2),
                               50),
            bound_ms=bnd, bound_by=by)
    per_window = {key: n_pairs * (b5["points"][key] + b5["lines"][key])
                  for key in ("ms", "plain_ms", "library_ms", "bound_ms")}
    # the same window on the CPU (plain versions)
    cpu = lambda fs: type(fs)(*[x.cpu() for x in fs])
    cwin = window.KeyframeWindow(Tfw=win.Tfw.cpu(), points=cpu(win.points),
                                 lines=cpu(win.lines))
    t0 = time.perf_counter()
    cT, _, _, c_used = window.refine_window_auto(cwin, cam, cfg, n_iters=8)
    cpu_s = time.perf_counter() - t0
    gT, _, _, g_used = a["out"]
    gT = gT.cpu()
    dt = float((cT[:, :3, 3] - gT[:, :3, 3]).abs().max())
    dr = float((cT[:, :3, :3] - gT[:, :3, :3]).abs().max())
    require(bool(c_used) == bool(g_used), "ba_popcount: GPU and CPU differ "
            "in used_lines")
    require(dt <= GPU_CPU_BA_TOL and dr <= GPU_CPU_BA_TOL,
            f"ba_popcount: GPU and CPU poses differ by {dt} m / {dr}")
    prob = a["prob"]
    return dict(frames=BA_FRAMES, keyframes=kf_frames, K=BA_WINDOW,
                landmark_slots=int(prob.mask.shape[0]),
                live_point_tracks=int(prob.mask.any(dim=1).sum()),
                live_line_tracks=int(prob.mask_l.any(dim=1).sum()),
                b5_launches={k: v["launches"] for k, v in routes.items()},
                problems_equal=True, poses_equal=True,
                used_lines=bool(g_used),
                ms_per_window={k: v["ms"] for k, v in routes.items()},
                ms_per_window_runs={k: v["ms_all"] for k, v in routes.items()},
                b5_ba_shapes=b5, b5_per_window=per_window,
                gpu_cpu_max_translation_diff_m=dt,
                gpu_cpu_max_rotation_diff=dr, cpu_window_s=cpu_s, card=smi)


def edlines_phase(drive, check, capture, seq_l, depth0, cam,
                  wrappers: dict, smi: str):
    """The VO step with use_edlines=True at edline_scale 2 (the quality
    mode) and 1 through `drive` (2 + 4 frames of the 8 lanes), each gated
    as the other VO phases with B3 never launched; detect_edlines on the
    card against the CPU on lane 0's first left frame, with the CPU
    test's tolerance; the compiled step (a CUDA graph) over the same
    frames, held to the eager run by the same rule (each lane's lines of
    the last frame, which the detector finds from the image alone), with
    the VO gates and equal launch counts; two RGB-D steps with EDLines on
    lane 0.  Returns (per-scale results, the RGB-D steps' launches)."""
    import types
    from stvo_pl_tpu_torch.config import VOConfig
    from stvo_pl_tpu_torch.models import frame as frame_mod
    from stvo_pl_tpu_torch.models import frontend
    from stvo_pl_tpu_torch.ops import lsd

    nf = POINTS_ONLY_FRAMES
    dev = seq_l.device
    r_ed = {}
    for scale in (2, 1):
        cfg_ed = VOConfig(use_edlines=True, edline_scale=scale)
        out_e = {}
        _, r = drive(cfg_ed, nf, WARMUP_FRAMES, out=out_e)
        name = f"vo_edlines scale {scale}"
        check(name, r, {"fast_pack": nf * cfg_ed.orb_nlevels,
                        "extract_patches": nf * cfg_ed.orb_nlevels,
                        "orb_describe": nf * cfg_ed.orb_nlevels,
                        "pose_optim": nf})
        g = capture(cfg_ed)
        out_g = {}
        _, r_g = drive(cfg_ed, nf, WARMUP_FRAMES, graph=g, out=out_g)
        cap_s = g["capture_s"]
        del g
        check(f"{name} graph", r_g, r["launches"])
        seg = lambda ls, b: types.SimpleNamespace(
            sp=ls.spl[b].cpu().numpy(), ep=ls.epl[b].cpu().numpy(),
            valid=ls.valid[b].cpu().numpy())
        g_shared, g_counts = [], []
        for b in range(seq_l.shape[0]):
            lg, le = (seg(o["state"].prev_lines, b) for o in (out_g, out_e))
            g_shared.append(shared_fraction(lg, le))
            g_counts.append(int(lg.valid.sum()) - int(le.valid.sum()))
        require(max(abs(c) for c in g_counts) <= 1 and min(g_shared) >= 0.9,
                f"{name} graph: line counts differ from eager by "
                f"{g_counts}, shared {g_shared}")
        require(min(r["inliers_ls_lanes"]) > 0, f"{name}: a lane tracked "
                f"no line: {r['inliers_ls_lanes']}")
        img = seq_l[0, :1].contiguous()
        min_len = cfg_ed.min_line_length * min(cam.width, cam.height)
        g, c = (lsd.LineSegments(*[t[0].cpu().numpy() for t in
                                   frame_mod.detect_edlines_stereo(
                                       x, min_len, cfg_ed)])
                for x in (img, img.cpu()))
        n_gpu, n_cpu = int(g.valid.sum()), int(c.valid.sum())
        shared = shared_fraction(g, c)
        require(abs(n_gpu - n_cpu) <= 1 and shared >= 0.9,
                f"{name}: detect_edlines on the card finds {n_gpu} lines, "
                f"on the CPU {n_cpu}, {shared:.3f} shared within 0.5 px")
        r_ed[f"scale{scale}"] = dict(
            r, detect_lines_gpu=n_gpu, detect_lines_cpu=n_cpu,
            detect_shared_0p5px=shared,
            graph=dict(ms_per_step=r_g["ms_per_step"], capture_s=cap_s,
                       ate_m=r_g["ate_m"], good_frac=r_g["good_frac"],
                       launches=r_g["launches"], replays=r_g["replays"],
                       graph_kernel_nodes=r_g["graph_kernel_nodes"],
                       last_lines_count_diff=g_counts,
                       last_lines_shared_0p5px=g_shared))
    # RGB-D with EDLines (full resolution, as its front end runs them)
    cfg_rgbd = VOConfig(rgbd_max_depth=200.0, use_edlines=True)
    for w in wrappers.values():
        w.launches = 0
    state = frontend.init_state(cfg_rgbd, device=dev)
    for i in range(2):
        state, t = frontend.vo_step_rgbd(state, seq_l[0, i].contiguous(),
                                         depth0[i], cam, cfg_rgbd)
    launches = {k: w.launches for k, w in wrappers.items()}
    n_lines = int(state.prev_lines.valid.sum())
    require(bool(torch.isfinite(t.Tfw).all()) and bool(t.good)
            and n_lines > 0 and not bool(state.prev_lines.level.any()),
            f"rgbd with EDLines: good {bool(t.good)}, {n_lines} valid lines")
    require(launches["fast_pack"] == 2 * cfg_rgbd.orb_nlevels
            and launches["run_pack_multi"] == 0
            and launches["pose_optim"] == 2,
            f"rgbd with EDLines: launches {launches}")
    emit("vo_edlines", scales=r_ed,
         ate_m={k: r["ate_m"] for k, r in r_ed.items()},
         ms_per_step={k: r["ms_per_step"] for k, r in r_ed.items()},
         launches_per_step={k: {n: c / nf for n, c in r["launches"].items()}
                            for k, r in r_ed.items()},
         rgbd_step=dict(lines=n_lines, inliers_ls=int(t.n_inliers_ls),
                        launches=launches), card=smi)
    return r_ed, launches


def _leaves(tree) -> list:
    """Every tensor of a (nested) NamedTuple; None leaves are skipped."""
    if tree is None:
        return []
    if isinstance(tree, tuple):
        return [x for f in tree for x in _leaves(f)]
    return [tree]


def same(a, b) -> bool:
    """Two (nested) NamedTuples of tensors `torch.equal` leaf by leaf."""
    la, lb = _leaves(a), _leaves(b)
    return len(la) == len(lb) and all(torch.equal(x, y)
                                      for x, y in zip(la, lb))


@contextlib.contextmanager
def collectives_in_capture():
    """Inside the block, counts by name the calls of torch.distributed's
    all_gather_into_tensor and all_reduce made while a CUDA graph is being
    captured (a Compiled's warm-up makes the same calls uncaptured)."""
    import torch.distributed as dist
    calls: dict = {}
    saved = {n: getattr(dist, n) for n in ("all_gather_into_tensor",
                                           "all_reduce")}

    def counted(name, fn):
        def call(*a, **kw):
            if torch.cuda.is_current_stream_capturing():
                calls[name] = calls.get(name, 0) + 1
            return fn(*a, **kw)
        return call

    for name, fn in saved.items():
        setattr(dist, name, counted(name, fn))
    try:
        yield calls
    finally:
        for name, fn in saved.items():
            setattr(dist, name, fn)


def sharded_phase(root: str, cam, cfg, seq_l, seq_r, wrappers: dict,
                  smi: str) -> dict:
    """An NCCL world of one on the card (parallel.mesh.init_distributed
    without torchrun's environment) running the sharded programs
    (sharded_programs).  Every program holds a graph that holds the
    world's communicator, so all of them are let go of, and the device
    synchronized, before the group is destroyed, also when a check
    failed."""
    import gc
    import traceback
    import torch.distributed as dist
    from stvo_pl_tpu_torch.parallel import mesh as mesh_mod

    mesh_mod.init_distributed(device_type="cuda")
    try:
        return sharded_programs(root, cam, cfg, seq_l, seq_r, wrappers, smi)
    except BaseException as e:
        # a failed check's frames hold their programs
        traceback.clear_frames(e.__traceback__)
        raise
    finally:
        gc.collect()
        torch.cuda.synchronize()
        dist.destroy_process_group()


TP_MIN_FEATURES = 16    # the TP-forced step column-shards every matcher


def sharded_programs(root: str, cam, cfg, seq_l, seq_r, wrappers: dict,
                     smi: str) -> dict:
    """In the NCCL world of one of sharded_phase: the compiled sharded
    step (make_sharded_vo_step) and the same step with every matcher
    column-sharded over the model group of 1 (`tp=(group, 1)`, compiled
    here: its all-gathers captured) over the 8 lanes, each in turns with
    its eager body and with the unsharded compiled step (compile_vo_step),
    `torch.equal` in every telemetry field and the final state, B1-B3's
    launches read from the graphs; on the ba_popcount window the compiled
    make_sharded_ba against its body and ba_solve, and the compiled
    sharded window refiner, with the bf16 product's and with B5's
    distances, against its body, compile_refiner and refine_window, B5's
    launches read from its graph; tp_match against the dense matcher.
    Prints the collectives each capture issued and what the graphs hold
    for them (two probe programs: one all-gather, one all-reduce)."""
    import torch.distributed as dist
    from stvo_pl_tpu_torch.ops import hamming, matching, se3
    from stvo_pl_tpu_torch.parallel import ba, batched, compiled, tp, window
    from stvo_pl_tpu_torch.parallel import mesh as mesh_mod

    sync = torch.cuda.synchronize
    nf = POINTS_ONLY_FRAMES
    dev = seq_l.device
    require(dist.get_backend() == "nccl" and dist.get_world_size() == 1,
            f"sharded: {dist.get_backend()} world of "
            f"{dist.get_world_size()}")
    mesh = mesh_mod.make_mesh(device_type=dev.type)
    group = mesh.get_group(mesh_mod.MODEL_AXIS)

    # what one collective becomes in a graph of a world of one
    def gathered(x):
        out = torch.empty_like(x)                 # n_shards = 1
        dist.all_gather_into_tensor(out, x, group=group)
        return out

    def reduced(x):
        y = x + 0
        dist.all_reduce(y, group=group)
        return y

    probes = {}
    for name, body, x in (
            ("all_gather_into_tensor", gathered,
             torch.arange(4 * 1200, dtype=torch.int64, device=dev)),
            ("all_reduce", reduced,
             torch.rand(24 * 24 + 24 + 1, device=dev))):
        with collectives_in_capture() as calls:
            g = first_call(compiled.Compiled(body, dev, groups=(group,)), x)
        require(torch.equal(g["fn"](x), x) and calls == {name: 1},
                f"sharded: the {name} probe returned another tensor or "
                f"captured {calls}")
        probes[name] = dict(captured_calls=calls, node_kinds=g["node_kinds"],
                            kernels=g["kernels"], capture_s=g["capture_s"])
        del g

    # ---- the steps --------------------------------------------------
    step, place = batched.make_sharded_vo_step(mesh, cam, cfg)
    require(isinstance(step, compiled.Compiled) and not step.groups,
            "sharded: make_sharded_vo_step's step is not a Compiled "
            "without collectives")
    cfg_tp = cfg.replace(tp_min_features=TP_MIN_FEATURES)
    tp_step = compiled.Compiled(
        lambda s, a, b: batched.vo_step_batched(s, a, b, cam, cfg_tp,
                                                tp=(group, 1)),
        dev, groups=(group,))
    lanes0 = lambda: place(batched.init_batched_state(cfg, BATCH, device=dev),
                           seq_l[:, 0].contiguous(), seq_r[:, 0].contiguous())
    graphs = {}
    for name, prog in (("sharded", step), ("tp", tp_step),
                       ("unsharded", batched.compile_vo_step(cam, cfg,
                                                             BATCH))):
        with collectives_in_capture() as calls:
            graphs[name] = first_call(prog, *lanes0())
        graphs[name]["captured_calls"] = calls
    require(graphs["sharded"]["kernels"] == graphs["unsharded"]["kernels"],
            "sharded: the sharded step's graph holds other kernel nodes "
            "than compile_vo_step's")
    require(graphs["sharded"]["captured_calls"] == {}
            and graphs["tp"]["captured_calls"].get(
                "all_gather_into_tensor", 0) > 0,
            f"sharded: collectives captured "
            f"{ {k: g['captured_calls'] for k, g in graphs.items()} }")

    arms = {"eager": (step.fn, None), "graph": (step, graphs["sharded"]),
            "tp_eager": (tp_step.fn, None),
            "tp_graph": (tp_step, graphs["tp"]),
            "unsharded_graph": (graphs["unsharded"]["fn"],
                                graphs["unsharded"])}
    ms = {k: [] for k in arms}
    runs, launches = {}, {}
    for rep in range(2):                 # in turns
        for name, (f, g) in arms.items():
            state, _, _ = lanes0()
            since = [g["prog"].replays] if g else []
            for w in wrappers.values():
                w.launches = 0
            tel = []
            for i in range(nf):
                if i == WARMUP_FRAMES:
                    sync()
                    t0 = time.perf_counter()
                il = mesh_mod.data_slice(mesh, seq_l[:, i].contiguous())
                ir = mesh_mod.data_slice(mesh, seq_r[:, i].contiguous())
                state, t = f(state, il, ir)
                tel.append(t)
            sync()
            ms[name].append((time.perf_counter() - t0)
                            / (nf - WARMUP_FRAMES) * 1e3)
            n = {k: w.launches for k, w in wrappers.items()}
            if g:
                rep_n = replayed([g], wrappers, since)
                n = {k: v + rep_n[k] for k, v in n.items()}
            if rep == 0:
                runs[name] = (tel, state)
                launches[name] = n
    ref_tel, ref_state = runs["eager"]
    for name, (tel, state) in runs.items():
        require(all(same(a, b) for a, b in zip(tel, ref_tel))
                and same(state, ref_state),
                f"sharded: the {name} step differs from the eager sharded "
                "step")
    expected = {"fast_pack": nf * cfg.orb_nlevels,
                "extract_patches": nf * cfg.orb_nlevels,
                "orb_describe": nf * cfg.orb_nlevels,
                "run_pack_multi": nf, "pose_optim": nf}
    for name, n in launches.items():
        for k in wrappers:
            require(n[k] == expected.get(k, 0),
                    f"sharded: {k} launched {n[k]} times in {nf} steps of "
                    f"{name}, expected {expected.get(k, 0)}")
    steps = dict(
        frames=nf, timed_frames=nf - WARMUP_FRAMES,
        order=", ".join(arms), ms_per_step=ms,
        eager_over_graph=min(ms["eager"]) / min(ms["graph"]),
        tp_eager_over_graph=min(ms["tp_eager"]) / min(ms["tp_graph"]),
        tp_min_features=TP_MIN_FEATURES, launches=launches,
        graphs={k: dict(capture_s=g["capture_s"],
                        first_call_bytes=g["first_call_bytes"],
                        kernel_nodes=g["kernel_nodes"],
                        node_kinds=g["node_kinds"],
                        captured_calls=g["captured_calls"])
                for k, g in graphs.items()},
        equal=True, same_kernel_nodes_as_compile_vo_step=True)
    # let the three 8-lane programs go (each keeps its graph's pool)
    del step, tp_step, prog, f, g, arms, graphs, runs

    # ---- the landmark-sharded BA, one window ------------------------
    win, kf_frames = first_window(root, cam, cfg)
    prob = window.build_problem_tracks(win, cam, cfg)
    poses_cw = se3.inverse_se3(win.Tfw)
    args = (poses_cw, prob.X, prob.obs, prob.mask, prob.sigma2, prob.Xl,
            prob.obs_l, prob.mask_l, prob.sigma2_l)
    solver = ba.make_sharded_ba(mesh, cam, n_iters=8, has_lines=True)
    require(isinstance(solver, compiled.Compiled),
            "sharded: make_sharded_ba's solver is not a Compiled")
    with collectives_in_capture() as calls:
        g = first_call(solver, *args)
    require(calls == {"all_reduce": 8},
            f"sharded: the BA's capture issued {calls}")
    ba_arms = {"eager": solver.fn, "graph": solver,
               "ba_solve": lambda *a: ba.ba_solve(poses_cw, prob, cam,
                                                  n_iters=8)}
    ba_ms = {k: [] for k in ba_arms}
    outs = {}
    for _ in range(3):                   # in turns
        for name, f in ba_arms.items():
            sync()
            t0 = time.perf_counter()
            outs[name] = f(*args)
            sync()
            ba_ms[name].append((time.perf_counter() - t0) * 1e3)
    require(same(outs["graph"], outs["eager"])
            and same(outs["eager"], outs["ba_solve"]),
            "sharded: make_sharded_ba (graph, eager) differs from ba_solve")
    ba_r = dict(ms=ba_ms, capture_s=g["capture_s"],
                first_call_bytes=g["first_call_bytes"],
                kernel_nodes=g["kernel_nodes"], node_kinds=g["node_kinds"],
                captured_calls=calls, equal=True)
    del solver, ba_arms, g, outs

    # ---- the sharded window refiner, both Hamming routes ------------
    n_pairs = BA_WINDOW * (BA_WINDOW - 1) // 2
    popc = {"hamming_matrix_popc": None}
    refiners = {}
    for route, use_mxu in (("bf16_product", True),
                           ("popcount_kernel", False)):
        c = cfg.replace(hamming_use_mxu=use_mxu)
        refine = window.make_sharded_window_refiner(mesh, cam, c, n_iters=8,
                                                    has_lines=True)
        require(isinstance(refine, compiled.Compiled),
                "sharded: the window refiner is not a Compiled")
        with collectives_in_capture() as calls:
            g = first_call(refine, win)
        require(calls == {"all_reduce": 8},
                f"sharded: the refiner's capture ({route}) issued {calls}")
        g_plain = first_call(window.compile_refiner(cam, c, n_iters=8,
                                                    auto=False), win)
        want = g_plain["fn"](win)
        ref = window.refine_window(win, cam, c, n_iters=8)
        require(same(want, ref), f"sharded: compile_refiner ({route}) "
                "differs from refine_window")
        r_ms = {"eager": [], "graph": []}
        b5 = {"eager": [], "graph": []}
        for _ in range(3):               # in turns
            for name, f in (("eager", refine.fn), ("graph", refine)):
                hamming.hamming_matrix_popc.launches = 0
                since = [g["prog"].replays]
                sync()
                t0 = time.perf_counter()
                got = f(win)
                sync()
                r_ms[name].append((time.perf_counter() - t0) * 1e3)
                b5[name].append(hamming.hamming_matrix_popc.launches
                                + replayed([g], popc, since)[
                                    "hamming_matrix_popc"])
                require(same(got, want), f"sharded: the {name} sharded "
                        f"refiner ({route}) differs from compile_refiner")
        n_b5 = 2 * n_pairs if not use_mxu else 0
        require(b5 == {"eager": [n_b5] * 3, "graph": [n_b5] * 3},
                f"sharded: B5 launched {b5} times per window ({route}), "
                f"expected {n_b5}")
        refiners[route] = dict(
            ms=r_ms, b5_launches_per_window=b5, capture_s=g["capture_s"],
            first_call_bytes=g["first_call_bytes"],
            kernel_nodes=g["kernel_nodes"], node_kinds=g["node_kinds"],
            b5_nodes=g["nodes"]["hamming_matrix_popc"],
            captured_calls=calls, equal=True)
        del refine, f, g, g_plain

    # the stand-alone TP matcher (one shard, eager as in the JAX package)
    d1, d2 = win.points.desc[0], win.points.desc[1]
    v1, v2 = win.points.valid[0], win.points.valid[1]
    res = tp.tp_match(d1, v1, d2, v2, cfg.min_ratio_12_p, mesh)
    dense = matching.nnr_mutual_match(
        hamming.hamming_matrix(d1, d2, use_mxu=False),
        v1[:, None] & v2[None, :], cfg.min_ratio_12_p)
    require(torch.equal(res.idx, dense.idx)
            and torch.equal(res.valid, dense.valid),
            "sharded: tp_match differs from nnr_mutual_match")
    return dict(backend=dist.get_backend(), world=dist.get_world_size(),
                lanes=BATCH, steps=steps, launches=launches["graph"],
                window_keyframes=kf_frames, ba=ba_r, refiners=refiners,
                refiner_b5_launches={k: r["b5_launches_per_window"]["graph"][0]
                                     for k, r in refiners.items()},
                collective_probes=probes, tp_match_equal=True,
                tp_matches=int(res.valid.sum()), card=smi)


def checkpoint_phase(cam, cfg, seq_l, seq_r, wrappers: dict,
                     smi: str) -> dict:
    """The default step on the 8 lanes: CHECKPOINT_FRAMES straight frames
    twice (is the card deterministic from run to run?), then
    CHECKPOINT_AT frames, save_state, load_state into a fresh template on
    the card, and the remaining frames.  The resumed poses must be
    torch.equal to the straight run's, or, where the two straight runs
    differ, within their difference."""
    import os
    from stvo_pl_tpu_torch.parallel import batched
    from stvo_pl_tpu_torch.utils import checkpoint

    here = os.path.dirname(os.path.abspath(__file__))
    path = os.path.join(here, "build", "chip_smoke_checkpoint")

    def run(state, frames):
        poses = []
        for i in frames:
            state, t = batched.vo_step_batched(
                state, seq_l[:, i].contiguous(), seq_r[:, i].contiguous(),
                cam, cfg)
            poses.append(t.Tfw)
        return state, poses

    t_phase = time.perf_counter()
    for w in wrappers.values():
        w.launches = 0
    frames = range(CHECKPOINT_FRAMES)
    straight = [torch.stack(run(batched.init_batched_state(cfg, BATCH),
                                frames)[1]) for _ in range(2)]
    state, head = run(batched.init_batched_state(cfg, BATCH),
                      frames[:CHECKPOINT_AT])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    checkpoint.save_state(path, state, CHECKPOINT_AT, {"lanes": BATCH})
    save_ms = (time.perf_counter() - t0) * 1e3
    template = batched.init_batched_state(cfg, BATCH, device="cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    loaded, idx, extra = checkpoint.load_state(path, template)
    torch.cuda.synchronize()
    load_ms = (time.perf_counter() - t0) * 1e3
    require(idx == CHECKPOINT_AT and extra == {"lanes": BATCH},
            f"checkpoint: meta {idx}, {extra}")
    flat_a, flat_b = checkpoint.flatten(state), checkpoint.flatten(loaded)
    require(flat_a.keys() == flat_b.keys() and all(
        flat_b[k].device == flat_a[k].device
        and flat_b[k].dtype == flat_a[k].dtype
        and torch.equal(flat_a[k], flat_b[k]) for k in flat_a),
        "checkpoint: the loaded state differs from the saved one")
    _, tail = run(loaded, frames[CHECKPOINT_AT:])
    resumed = torch.stack(head + tail)
    torch.cuda.synchronize()
    launches = {k: w.launches for k, w in wrappers.items()}
    n_steps = 3 * CHECKPOINT_FRAMES
    expected = {"fast_pack": n_steps * cfg.orb_nlevels,
                "extract_patches": n_steps * cfg.orb_nlevels,
                "orb_describe": n_steps * cfg.orb_nlevels,
                "run_pack_multi": n_steps, "pose_optim": n_steps}
    for k in wrappers:
        require(launches[k] == expected.get(k, 0), f"checkpoint: {k} "
                f"launched {launches[k]} times in {n_steps} steps")
    run_to_run = float((straight[0] - straight[1]).abs().max())
    resume_diff = float((resumed - straight[0]).abs().max())
    deterministic = torch.equal(straight[0], straight[1])
    if deterministic:
        require(torch.equal(resumed, straight[0]), f"checkpoint: the "
                f"resumed poses differ by {resume_diff} from the straight "
                f"run's, which repeats bit for bit")
    else:
        require(resume_diff <= run_to_run, f"checkpoint: the resumed poses "
                f"differ by {resume_diff}, two straight runs by "
                f"{run_to_run}")
    require(bool(torch.isfinite(resumed).all()),
            "checkpoint: non-finite poses")
    return dict(lanes=BATCH, frames=CHECKPOINT_FRAMES, saved_at=CHECKPOINT_AT,
                straight_runs_equal=deterministic,
                held="torch.equal" if deterministic
                else "within the run-to-run difference",
                straight_run_to_run_max_diff=run_to_run,
                resumed_max_diff=resume_diff,
                bytes=os.path.getsize(os.path.join(path,
                                                   checkpoint.STATE_FILE)),
                tensors=len(flat_a), save_ms=save_ms, load_ms=load_ms,
                launches=launches,
                seconds=time.perf_counter() - t_phase, card=smi)


# B1, B2 and B3's CUDA kernels, the pose optimizer's and ORB's descriptor
# kernel (csrc/), each launched once per call of its wrapper
TRACED_KERNELS = {"fast_pack_kernel": "fast_pack",
                  "extract_kernel": "extract_patches",
                  "run_planes_kernel": "run_pack_multi",
                  "chain_pack_kernel": "run_pack_multi",
                  "pose_optim_kernel": "pose_optim",
                  "orb_describe_kernel": "orb_describe"}
# every CUDA kernel of the seven wrappers: each wrapper's launch runs each
# of its kernels once
CUDA_KERNELS = {**TRACED_KERNELS, "run_plane_kernel": "run_pack",
                "start_pack_kernel": "run_pack",
                "hamming_mma_kernel": "hamming_matrix_popc"}


@contextlib.contextmanager
def kept_graphs():
    """Inside the block every torch.cuda.CUDAGraph is made with
    keep_graph=True, so that its captured graph can be read
    (graph_nodes); it is instantiated at its first replay."""
    base = torch.cuda.CUDAGraph

    class Kept(base):
        def __new__(cls, keep_graph=True):
            return super().__new__(cls, True)

        def __init__(self, keep_graph=True):
            super().__init__(True)

    torch.cuda.CUDAGraph = Kept
    try:
        yield
    finally:
        torch.cuda.CUDAGraph = base


class _KernelNodeParams(ctypes.Structure):
    # CUDA_KERNEL_NODE_PARAMS_v2 of the driver API (cuda.h)
    _fields_ = ([("func", ctypes.c_void_p)]
                + [(f, ctypes.c_uint) for f in ("gx", "gy", "gz", "bx",
                                                 "by", "bz", "smem")]
                + [(f, ctypes.c_void_p) for f in ("params", "extra", "kern",
                                                   "ctx")])


# CUgraphNodeType of the driver API (cuda.h)
NODE_KINDS = {0: "kernel", 1: "memcpy", 2: "memset", 3: "host", 4: "graph",
              5: "empty", 6: "wait_event", 7: "event_record",
              8: "semaphore_signal", 9: "semaphore_wait", 10: "mem_alloc",
              11: "mem_free", 12: "batch_mem_op", 13: "conditional"}


def graph_nodes(graph) -> tuple[dict, dict]:
    """The nodes of a captured graph (a torch.cuda.CUDAGraph made inside
    kept_graphs), child graphs included, read from the graph through the
    driver API: its kernel nodes counted by the CUDA function's (mangled)
    name, what one replay launches, and every node counted by kind."""
    cu = ctypes.CDLL("libcuda.so.1")
    P = ctypes.c_void_p

    def ok(res, what):
        require(res == 0, f"graph_nodes: {what} returned CUresult {res}")

    counts: dict = {}
    kinds: dict = {}

    def walk(g):
        n = ctypes.c_size_t(0)
        ok(cu.cuGraphGetNodes(P(g), None, ctypes.byref(n)), "cuGraphGetNodes")
        nodes = (P * n.value)()
        ok(cu.cuGraphGetNodes(P(g), nodes, ctypes.byref(n)), "cuGraphGetNodes")
        for node in nodes:
            kind = ctypes.c_int()
            ok(cu.cuGraphNodeGetType(P(node), ctypes.byref(kind)),
               "cuGraphNodeGetType")
            name = NODE_KINDS.get(kind.value, str(kind.value))
            kinds[name] = kinds.get(name, 0) + 1
            if name == "graph":
                child = P()
                ok(cu.cuGraphChildGraphNodeGetGraph(P(node),
                                                    ctypes.byref(child)),
                   "cuGraphChildGraphNodeGetGraph")
                walk(child.value)
            elif name == "kernel":
                p = _KernelNodeParams()
                ok(cu.cuGraphKernelNodeGetParams_v2(P(node), ctypes.byref(p)),
                   "cuGraphKernelNodeGetParams")
                fname = ctypes.c_char_p()
                if p.func:
                    ok(cu.cuFuncGetName(ctypes.byref(fname), P(p.func)),
                       "cuFuncGetName")
                else:
                    ok(cu.cuKernelGetName(ctypes.byref(fname), P(p.kern)),
                       "cuKernelGetName")
                key = fname.value.decode()
                counts[key] = counts.get(key, 0) + 1

    walk(graph.raw_cuda_graph())
    return counts, kinds


def wrapper_nodes(counts: dict) -> dict:
    """graph_nodes' kernel counts summed per kernel wrapper: a wrapper's count
    is the kernel nodes of its CUDA kernels (by their length-prefixed
    names in the mangled ones), all of which it launches once a call, so
    it must be the same for each of them."""
    per = {}
    for kernel, wrapper in CUDA_KERNELS.items():
        tag = f"{len(kernel)}{kernel}"
        n = sum(c for name, c in counts.items()
                if name == kernel or tag in name)
        require(per.setdefault(wrapper, n) == n, f"graph: {wrapper}'s "
                f"kernels appear {per[wrapper]} and {n} times")
    return per


def first_call(compiled, *args) -> dict:
    """The first call of a parallel.compiled.Compiled (warm-up, capture
    and one replay), its graph kept: the call's seconds, the device memory
    it left allocated (static buffers and the graph's pool), and the
    graph's kernel nodes (in all, per kernel wrapper and per CUDA
    function) and nodes by kind."""
    torch.cuda.synchronize()
    mem0 = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    with kept_graphs():
        compiled(*args)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    prog, = compiled.programs.values()
    nodes, kinds = graph_nodes(prog.graph)
    return dict(fn=compiled, prog=prog, capture_s=seconds,
                first_call_bytes=torch.cuda.memory_allocated() - mem0,
                kernel_nodes=sum(nodes.values()), nodes=wrapper_nodes(nodes),
                node_kinds=kinds, kernels=nodes)


def replayed(graphs: list, wrappers: dict, since: list) -> dict:
    """Kernel launches of the graphs' replays since `since` (each graph's
    replay count then): per wrapper, its kernel nodes times the replays."""
    out = dict.fromkeys(wrappers, 0)
    for g, r0 in zip(graphs, since):
        for k in wrappers:
            out[k] += g["nodes"][k] * (g["prog"].replays - r0)
    return out


def ops_graph_entries(cam, cfg, cfg_rgbd, seq_l, seq_r, depth0,
                      rgbd_states, index, queries, win) -> list:
    """ops_graph_phase's entries at full width, one per compiled
    counterpart of a jitted entry point of the JAX package: the one-lane
    RGB-D step over the rgbd phase's frames (from each eager step's
    incoming state); ba_solve (8 iterations) on the ba_popcount window's
    problem, its poses as built and perturbed; the binary matcher's three
    forms with both distance routes on the binary_matcher phase's index
    (two query sets, validity masks for the masked forms); both line
    detectors and, on their outputs, the operators of the front end on
    the 16 images (8 lanes x 2 eyes) of frames 0 and 1 at VOConfig()'s
    widths (1200 ORB corners, 300 lines), the detectors with the image
    of frame 0 and two values of min_length."""
    from stvo_pl_tpu_torch.models import frontend
    from stvo_pl_tpu_torch.ops import binary_matcher as bm
    from stvo_pl_tpu_torch.ops import edline, fast, image, lbd, lsd, orb, se3
    from stvo_pl_tpu_torch.parallel import ba, window

    dev = seq_l.device
    H, W = cam.height, cam.width
    imgs = [torch.cat([seq_l[:, i], seq_r[:, i]]).contiguous()
            for i in (0, 1)]                                # [16, H, W]
    min_len = cfg.min_line_length * min(W, H)
    mins = [torch.tensor(min_len, device=dev),
            torch.tensor(2.0 * min_len, device=dev)]
    det = dict(capacity=cfg.line_capacity, n_dirs=cfg.lsd_n_dirs,
               ang_th_deg=cfg.lsd_ang_th, quant=cfg.lsd_quant,
               density_th=cfg.lsd_density_th)
    scores = [fast.fast_score(x, float(cfg.orb_fast_th)) for x in imgs]
    n_kp = cfg.orb_nfeatures
    uvs = [fast.select_keypoints(sc, n_kp)[0] for sc in scores]
    blurs = [image.gaussian_blur(x, 2.0, radius=3) for x in imgs]
    lbd_calls = []
    for x in imgs:
        gx, gy = image.sobel(x)
        segs = lsd.detect_line_segments(x, min_len, **det)
        lbd_calls.append((gx, gy, segs.sp, segs.ep))
    zero = torch.zeros((len(imgs[0]), cfg.line_capacity), dtype=torch.int32,
                       device=dev)
    atlas_calls = [(torch.stack([gx, gy], -1), sp, ep, zero, zero,
                    zero + (W - 1), zero + (H - 1))
                   for gx, gy, sp, ep in lbd_calls]
    prob = window.build_problem_tracks(win, cam, cfg)
    poses = se3.inverse_se3(win.Tfw)
    xi = torch.tensor([0.02, -0.01, 0.03, 0.002, -0.001, 0.0015],
                      device=dev).expand(len(poses), 6).clone()
    xi[0] = 0.0
    ba_calls = [(poses, prob), (se3.mm(se3.expmap_se3(xi), poses), prob)]
    nf = len(rgbd_states)
    entries = [
        ("vo_step_rgbd",
         lambda: frontend.compile_vo_step_rgbd(cam, cfg_rgbd),
         lambda s, img, d: frontend.vo_step_rgbd(s, img, d, cam, cfg_rgbd),
         [(rgbd_states[i], seq_l[0, i].contiguous(), depth0[i])
          for i in range(nf)], 1, "equal"),
        ("ba_solve", lambda: ba.compile_ba_solve(cam, n_iters=8),
         lambda p, pr: ba.ba_solve(p, pr, cam, n_iters=8), ba_calls, 3,
         "equal")]
    for use_mxu in (False, True):
        route = "popcount" if not use_mxu else "bf16"
        entries += [
            (f"knn_match_{route}",
             lambda u=use_mxu: bm.compile_knn_match(2, use_mxu=u),
             lambda q, i, v, u=use_mxu: bm.knn_match(q, i, 2, v, use_mxu=u),
             [(q, index, v) for q, v in queries], 5, "equal"),
            (f"match_{route}", lambda u=use_mxu: bm.compile_match(use_mxu=u),
             lambda q, i, u=use_mxu: bm.match(q, i, use_mxu=u),
             [(q, index) for q, _ in queries], 5, "equal"),
            (f"radius_match_{route}",
             lambda u=use_mxu: bm.compile_radius_match(40, 4, use_mxu=u),
             lambda q, i, v, u=use_mxu: bm.radius_match(q, i, 40, 4, v,
                                                        use_mxu=u),
             [(q, index, v) for q, v in queries], 5, "equal")]
    for gen, pd in (("all_direction", False), ("per_direction", True)):
        entries.append((
            f"detect_line_segments_{gen}",
            lambda pd=pd: lsd.compile_detect_line_segments(per_direction=pd,
                                                           **det),
            lambda x, m, pd=pd: lsd.detect_line_segments(
                x, m, per_direction=pd, **det),
            [(imgs[0], m) for m in mins], 2, "equal"))
    entries += [
        ("detect_edlines",
         lambda: edline.compile_detect_edlines(capacity=cfg.line_capacity),
         lambda x, m: edline.detect_edlines(x, m,
                                            capacity=cfg.line_capacity),
         [(imgs[0], m) for m in mins], 2, "edlines"),
        ("select_keypoints", lambda: fast.compile_select_keypoints(n_kp),
         lambda sc, o: fast.select_keypoints(sc, n_kp, offset_src=o),
         [(sc, sc) for sc in scores], 5, "equal"),
        ("orient_and_describe", orb.compile_orient_and_describe,
         orb.orient_and_describe, list(zip(imgs, blurs, uvs)), 5, "equal"),
        ("compute_lbd", lbd.compile_compute_lbd, lbd.compute_lbd, lbd_calls,
         5, "equal"),
        ("compute_lbd_atlas", lbd.compile_compute_lbd_atlas,
         lbd.compute_lbd_atlas, atlas_calls, 5, "equal"),
        ("build_pyramid",
         lambda: image.compile_build_pyramid(cfg.orb_nlevels,
                                             cfg.orb_scale_factor),
         lambda x: tuple(image.build_pyramid(x, cfg.orb_nlevels,
                                             cfg.orb_scale_factor)),
         [(x,) for x in imgs], 5, "equal")]
    return entries


def ops_graph_phase(entries: list, wrappers: dict, smi: str) -> dict:
    """The compiled counterparts of the JAX package's remaining jitted
    entry points, one at a time: each entry is (name, make, eager, calls,
    reps, rule), `make()` building the program (a
    parallel.compiled.Compiled), `calls` two or more argument tuples of
    one static key.  Per entry: eager's answers and the kernel wrappers'
    launches of those calls; the program's first call (warm-up, capture,
    one replay; its graph kept and read); one replay per call, each held
    to eager's answer (`torch.equal`, or with rule "edlines" EDLines' set
    rule: per image the counts within 1 and >= 90% of the segments
    shared within 0.5 px); the graph's wrapper nodes times the calls
    equal to eager's launches; eager and graph in turns (eager, graph,
    eager, graph; `reps` passes over the calls each), ms per call.  The
    program is dropped and its pool released before the next one.
    Returns per entry its numbers, and in "launches" the graphs' launches
    per kernel wrapper (their wrappers' calls in warm-up and capture, and
    kernel nodes times replays)."""
    import gc
    import types

    sync = torch.cuda.synchronize
    out, total = {}, dict.fromkeys(wrappers, 0)
    t_phase = time.perf_counter()
    for name, make, eager, calls, reps, rule in entries:
        for w in wrappers.values():
            w.launches = 0
        want = [eager(*a) for a in calls]
        sync()
        eager_launches = {k: w.launches for k, w in wrappers.items()}
        for w in wrappers.values():
            w.launches = 0
        g = first_call(make(), *calls[0])
        prog = g["fn"]
        captured = {k: w.launches for k, w in wrappers.items()}
        got = [prog(*a) for a in calls]
        sync()
        sets = []        # EDLines: (line count diff, shared) per image
        for i, (a, b) in enumerate(zip(got, want)):
            if rule == "edlines":
                seg = lambda x, n: types.SimpleNamespace(
                    sp=x.sp[n].cpu().numpy(), ep=x.ep[n].cpu().numpy(),
                    valid=x.valid[n].cpu().numpy())
                for n in range(a.valid.shape[0]):
                    ga, gb = seg(a, n), seg(b, n)
                    diff = int(ga.valid.sum()) - int(gb.valid.sum())
                    shared = shared_fraction(ga, gb)
                    sets.append((diff, shared))
                    require(abs(diff) <= 1 and shared >= 0.9,
                            f"ops_graph {name}: call {i} image {n}: "
                            f"{diff:+d} lines against eager, {shared:.3f} "
                            f"shared within 0.5 px")
            else:
                require(same(a, b), f"ops_graph {name}: replay {i} differs "
                        f"from eager")
        per_call = {k: g["nodes"][k] * len(calls) for k in wrappers}
        require(per_call == eager_launches and not any(
            w.launches != captured[k] for k, w in wrappers.items()),
            f"ops_graph {name}: the graph's kernel wrapper nodes times "
            f"{len(calls)} calls, {per_call}, against eager's launches "
            f"{eager_launches}")
        ms = {"eager": [], "graph": []}
        for _ in range(2):
            for kind, fn in (("eager", eager), ("graph", prog)):
                sync()
                t0 = time.perf_counter()
                for _ in range(reps):
                    for a in calls:
                        fn(*a)
                sync()
                ms[kind].append((time.perf_counter() - t0) * 1e3
                                / (reps * len(calls)))
        p = g["prog"]
        launches = {k: captured[k] + g["nodes"][k] * p.replays
                    for k in wrappers}
        for k in wrappers:
            total[k] += launches[k]
        out[name] = dict(
            calls=len(calls), capture_s=g["capture_s"],
            first_call_bytes=g["first_call_bytes"],
            graph_kernel_nodes=g["kernel_nodes"], node_kinds=g["node_kinds"],
            eager_launches_per_call={k: n / len(calls) for k, n in
                                     eager_launches.items() if n},
            ms_eager=ms["eager"], ms_graph=ms["graph"],
            eager_over_graph=min(ms["eager"]) / min(ms["graph"]),
            replays=p.replays, launches={k: n for k, n in launches.items()
                                         if n},
            equal_to_eager=rule if rule == "edlines" else True,
            **(dict(max_line_count_diff=max(abs(d) for d, _ in sets),
                    min_shared_0p5px=min(x for _, x in sets))
               if sets else {}))
        del g, prog, p, got, want
        gc.collect()
        sync()
        torch.cuda.empty_cache()
    return dict(entries=out, launches=total, card=smi,
                seconds=time.perf_counter() - t_phase)


def profiling_phase(cam, cfg, seq_l, seq_r, wrappers: dict,
                    smi: str) -> dict:
    """One default step on the 8 lanes (after 2 unprofiled ones) inside
    utils.profiling.device_trace: summarize_trace's top 15, the device
    total and the step's wall time; every CUDA kernel of B1, B2, B3, the
    optimizer and ORB's descriptor kernel (TRACED_KERNELS) in the full
    summary as often as its wrapper counted its launches.  Then
    the compiled step (its graph captured by the first of 2 unprofiled
    calls): GRAPH_TRACED_REPLAYS replays in one trace, with their device
    total and wall time, and B1-B3's kernels in it as often as the
    graph's kernel nodes times the replays; and one traced replay each of
    the compiled dense per-direction and popcount steps, where B4's and
    B5's kernels appear as often as the graph holds them."""
    import os
    import re
    import shutil
    from stvo_pl_tpu_torch.parallel import batched
    from stvo_pl_tpu_torch.utils import profiling

    here = os.path.dirname(os.path.abspath(__file__))
    logdir = os.path.join(here, "build", "chip_smoke_trace")
    t_phase = time.perf_counter()
    shutil.rmtree(logdir, ignore_errors=True)    # one trace: this run's
    state = batched.init_batched_state(cfg, BATCH)
    for i in range(PROFILED_AT):
        state, _ = batched.vo_step_batched(
            state, seq_l[:, i].contiguous(), seq_r[:, i].contiguous(), cam,
            cfg)
    torch.cuda.synchronize()
    img_l = seq_l[:, PROFILED_AT].contiguous()
    img_r = seq_r[:, PROFILED_AT].contiguous()
    for w in wrappers.values():
        w.launches = 0
    with profiling.device_trace(logdir):
        with profiling.Timer() as timer:
            state, telem = batched.vo_step_batched(state, img_l, img_r, cam,
                                                   cfg)
            torch.cuda.synchronize()
    launches = {k: w.launches for k, w in wrappers.items()}
    t0 = time.perf_counter()
    rows = profiling.summarize_trace(logdir, top=None)
    parse_s = time.perf_counter() - t0
    require(bool(torch.isfinite(telem.Tfw).all()),
            "profiling: non-finite poses")

    def kernels_in(rows, launches, what, kernels=TRACED_KERNELS):
        counted = {}
        for kernel, wrapper in kernels.items():
            pat = re.compile(rf"(^|[\s:]){kernel}[<(]")
            n = sum(c for name, _, c in rows if pat.search(name))
            counted[kernel] = n
            require(n == launches[wrapper], f"profiling: {kernel} "
                    f"appears {n} times in the {what} trace, expected "
                    f"{launches[wrapper]} from {wrapper}")
        return counted

    require(all(launches[w] > 0 for w in TRACED_KERNELS.values()),
            f"profiling: a kernel of B1-B3, the optimizer or ORB's "
            f"descriptor kernel did not run: "
            f"{launches}")
    counted = kernels_in(rows, launches, "eager step's")
    trace = profiling.newest_trace(logdir)

    def traced_replays(g, n, args, tag):
        """n replays of g's graph in one trace (after one unprofiled
        replay): (summary rows, wall ms of the traced window)."""
        tdir = f"{logdir}_{tag}"
        shutil.rmtree(tdir, ignore_errors=True)
        g["fn"](*args)
        torch.cuda.synchronize()
        with profiling.device_trace(tdir):
            with profiling.Timer() as t:
                for _ in range(n):
                    g["fn"](*args)
                torch.cuda.synchronize()
        return profiling.summarize_trace(tdir, top=None), t.ms

    # the compiled default step: its first call captures
    g = first_call(batched.compile_vo_step(cam, cfg, BATCH),
                   batched.init_batched_state(cfg, BATCH),
                   seq_l[:, 0].contiguous(), seq_r[:, 0].contiguous())
    g_state = batched.init_batched_state(cfg, BATCH)
    for i in range(PROFILED_AT):
        g_state, _ = g["fn"](g_state, seq_l[:, i].contiguous(),
                             seq_r[:, i].contiguous())
    g_state, g_telem = g["fn"](g_state, img_l, img_r)
    require(torch.equal(g_telem.Tfw, telem.Tfw) and same(g_state, state),
            "profiling: the replayed step differs from the eager step")
    n = GRAPH_TRACED_REPLAYS
    g_rows, g_ms = traced_replays(g, n, (g_state, img_l, img_r), "graph")
    g_expected = {k: n * c for k, c in g["nodes"].items()}
    g_counted = kernels_in(g_rows, g_expected, f"{n} replays'")
    g_total = sum(ms for _, ms, _ in g_rows)
    graph = dict(replays=n, window_wall_ms=g_ms,
                 device_total_ms=g_total,
                 device_ms_per_replay=g_total / n,
                 device_events=sum(c for _, _, c in g_rows),
                 graph_kernel_nodes=g["kernel_nodes"],
                 distinct_names=len(g_rows),
                 top15=[[name[:100], ms, c] for name, ms, c in g_rows[:15]],
                 kernels_in_trace=g_counted, launches=g_expected)
    del g, g_state
    # B4 and B5 in replays of the dense per-direction and popcount steps
    others = {}
    for tag, run_cfg, per_direction, kernels in (
            ("dense_per_direction", cfg.replace(lsd_octaves=1), True,
             ("run_plane_kernel", "start_pack_kernel")),
            ("popcount", cfg.replace(hamming_use_mxu=False), False,
             ("hamming_mma_kernel",))):
        g = first_call(
            batched.compile_vo_step(cam, run_cfg, BATCH, per_direction),
            batched.init_batched_state(run_cfg, BATCH),
            seq_l[:, 0].contiguous(), seq_r[:, 0].contiguous())
        o_rows, _ = traced_replays(
            g, 1, (batched.init_batched_state(run_cfg, BATCH), img_l, img_r),
            tag)
        mine = {k: CUDA_KERNELS[k] for k in kernels}
        require(all(g["nodes"][w] > 0 for w in mine.values()),
                f"profiling: {tag}'s graph holds no {kernels}")
        others[tag] = dict(
            kernels_in_trace=kernels_in(o_rows, g["nodes"],
                                        f"{tag} replay's", mine),
            launches={w: g["nodes"][w] for w in set(mine.values())},
            graph_kernel_nodes=g["kernel_nodes"])
        del g
    return dict(lanes=BATCH, frame=PROFILED_AT, step_wall_ms=timer.ms,
                device_total_ms=sum(ms for _, ms, _ in rows),
                device_events=sum(c for _, _, c in rows),
                distinct_names=len(rows),
                top15=[[name[:100], ms, c] for name, ms, c in rows[:15]],
                kernels_in_trace=counted, launches=launches, graph=graph,
                replays_traced=others,
                trace_bytes=os.path.getsize(trace), parse_seconds=parse_s,
                seconds=time.perf_counter() - t_phase, card=smi)


def ptxas_lines(kernel: str) -> list:
    """The build's ptxas report for one kernel: its entry line and the
    lines after it up to the next entry (registers, spills)."""
    from stvo_pl_tpu_torch import build
    out, mine = [], False
    for line in build.ptxas_report:
        if "Compiling entry function" in line:
            mine = f"{len(kernel)}{kernel}" in line
        if mine:
            out.append(line)
    return out


def orb_describe_phase(seq_l, seq_r, smi: str) -> tuple[dict, dict]:
    """ORB's descriptor kernel (ops/orb.py orb_describe,
    csrc/orb_describe.cu) at the fleet cells' shapes: the patches the VO
    gathers from 128 images (the 8 lanes' first ORB_FLEET_FRAMES frames,
    both eyes) under kitti_pl (VOConfig(): 1,200 corners over 4 levels)
    and kitti_points (2,000 at one level).  Per pyramid level (one launch
    each): desc, cos and sin of the kernel, its plain twin
    (orient_describe_plain) and the bf16 test-bank product
    (orient_describe_product) `torch.equal`; ms of each (the product's
    as library_ms) beside the kernel's bound by bytes.  Returns (the
    phase's numbers, the kernel table's row for kitti_pl)."""
    from stvo_pl_tpu_torch.config import VOConfig
    from stvo_pl_tpu_torch.models import frame as frame_mod
    from stvo_pl_tpu_torch.ops import fast as fast_ops
    from stvo_pl_tpu_torch.ops import orb
    from stvo_pl_tpu_torch.ops.image import gaussian_blur, pyramid_levels

    t_phase = time.perf_counter()
    dev = seq_l.device
    imgs = torch.cat([seq_l[:, :ORB_FLEET_FRAMES],
                      seq_r[:, :ORB_FLEET_FRAMES]]).flatten(0, 1).contiguous()
    configs = {"kitti_pl": VOConfig(),
               "kitti_points": VOConfig(orb_nfeatures=2000, orb_nlevels=1)}
    rows = {}
    orb.orb_describe.launches = 0
    for name, run_cfg in configs.items():
        th = torch.full((imgs.shape[0],), float(run_cfg.orb_fast_th),
                        device=dev)
        budgets = frame_mod._per_level_budgets(run_cfg)
        levels, tot = [], dict(K=0, ms=0.0, plain_ms=0.0, library_ms=0.0,
                               bound_ms=0.0)
        for lv, img in enumerate(pyramid_levels(
                imgs, run_cfg.orb_nlevels, run_cfg.orb_scale_factor,
                blur_sigma=0.6)):
            uv, _, _ = fast_ops.detect_keypoints(
                img.contiguous(), th, budgets[lv], edge=run_cfg.orb_edge_th,
                cell=4, score_type=run_cfg.orb_score)
            p = orb.gather_patches(gaussian_blur(img, 2.0, radius=3), uv)
            del uv
            k = orb.orb_describe(p, run_cfg.orb_patch_size)
            for what, fn in (("product", orb.orient_describe_product),
                             ("plain", orb.orient_describe_plain)):
                ref = fn(p, run_cfg.orb_patch_size)
                torch.cuda.synchronize()
                for f, a, b in zip(("desc", "cos", "sin"), k, ref):
                    require(torch.equal(a, b), f"orb_describe {name} level "
                            f"{lv}: {f} differs from the {what} path at "
                            f"{int((a != b).sum())} values")
                del ref
            n_bins = len(set(orb._bin_index(k[1], k[2]).flatten().tolist()))
            K = p.shape[0] * p.shape[1]
            ms = time_ms(lambda: orb.orb_describe(p, run_cfg.orb_patch_size),
                         20)
            plain = time_ms(lambda: orb.orient_describe_plain(
                p, run_cfg.orb_patch_size), 3)
            lib = time_ms(lambda: orb.orient_describe_product(
                p, run_cfg.orb_patch_size), 5)
            bnd, by = bound_ms(K * ORB_BYTES_PER_KEYPOINT,
                               K * ORB_OPS_PER_KEYPOINT)
            require(by == "bytes", f"orb_describe {name}: bound by {by}")
            levels.append(dict(level=lv, shape=list(p.shape), K=K,
                               bins_seen=n_bins, ms=ms, plain_ms=plain,
                               library_ms=lib, bound_us=bnd * 1e3,
                               over_bound=ms / bnd))
            for key, v in (("K", K), ("ms", ms), ("plain_ms", plain),
                           ("library_ms", lib), ("bound_ms", bnd)):
                tot[key] += v
            del p, k
            torch.cuda.empty_cache()
        rows[name] = dict(levels=levels, **tot,
                          over_bound=tot["ms"] / tot["bound_ms"])
    launches = orb.orb_describe.launches
    out = dict(images=list(imgs.shape), configs=rows, equal_to_product=True,
               equal_to_plain=True, launches=launches,
               ptxas=ptxas_lines("orb_describe_kernel"),
               seconds=time.perf_counter() - t_phase, card=smi)
    row = rows["kitti_pl"]
    b_orb = dict(name="orb_describe", route="cuda",
                 source="stvo_pl_tpu_torch/csrc/orb_describe.cu",
                 replaces="none (XLA's test-bank product in "
                          "stvo_pl_tpu/ops/orb.py orient_describe)",
                 max_abs_err=0.0, ms=row["ms"], plain_ms=row["plain_ms"],
                 bound_ms=row["bound_ms"], bound_by="bytes",
                 library_ms=row["library_ms"])
    return out, b_orb


def pose_optim_phase(cam, seq_l, seq_r, smi: str) -> tuple[dict, dict]:
    """The pose optimizer's kernel (ops/pose_optim, csrc/pose_optim.cu) on
    the main path's inputs: optimize_pose's arguments in POSE_STEPS eager
    steps of the 8 lanes (frames 1-8; frame 0 has no previous frame),
    taken at the call site and stacked into 64 lanes, for VOConfig()
    (1,200 points, 300 lines) and configs/config_points_only.yaml (2,000
    points, no lines).  For each, the kernel against optimize_pose_plain
    on the same inputs: good, the inlier masks and their counts equal,
    DT and err within the tolerances of tests/test_torch_optimizer_cuda.py,
    the iterations within POSE_ITERS_TOL, the covariance and its
    eigenvalues within theirs plus twice the plain path's own spread
    there (as that test holds them: the covariance is H's inverse, and on
    an ill-conditioned lane it moves with the order and the precision of
    H's sums), the spread over the plain path on POSE_PROBES reorderings
    of the matches and in float64; a second call bit for bit the first;
    the launches
    (one a step, one a call); ms of the kernel and of the plain path, and
    the bound from the bytes the kernel reads and writes and the float
    operations of the iterations it ran.  Returns (the phase's numbers,
    the kernel table's row)."""
    import os
    from unittest import mock
    from stvo_pl_tpu_torch.config import VOConfig, load_config
    from stvo_pl_tpu_torch.models import optimizer
    from stvo_pl_tpu_torch.ops import pose_optim
    from stvo_pl_tpu_torch.parallel import batched

    here = os.path.dirname(os.path.abspath(__file__))
    configs = {"points_lines": VOConfig(),
               "points_only": load_config(os.path.join(
                   here, "configs", "config_points_only.yaml"))}
    stack = lambda nts: type(nts[0])(*[torch.cat(f) for f in zip(*nts)])
    real = optimizer.optimize_pose
    t_phase = time.perf_counter()
    rows, launches = {}, 0
    for name, run_cfg in configs.items():
        calls = []

        def spy(pm, lm, cam_, cfg_, *prev):
            keep = lambda nt: type(nt)(*[t.clone() for t in nt])
            calls.append((keep(pm), keep(lm), *[t.clone() for t in prev]))
            return real(pm, lm, cam_, cfg_, *prev)

        pose_optim.pose_optim.launches = 0
        state = batched.init_batched_state(run_cfg, BATCH)
        with mock.patch.object(optimizer, "optimize_pose", spy):
            for i in range(POSE_STEPS + 1):
                state, _ = batched.vo_step_batched(
                    state, seq_l[:, i].contiguous(),
                    seq_r[:, i].contiguous(), cam, run_cfg)
        calls = calls[1:]
        pm, lm = stack([c[0] for c in calls]), stack([c[1] for c in calls])
        prev = [torch.cat(x) for x in zip(*[c[2:] for c in calls])]
        run = lambda: pose_optim.pose_optim(pm, lm, cam, run_cfg, *prev)
        plain = lambda: optimizer.optimize_pose_plain(pm, lm, cam, run_cfg,
                                                      *prev)
        k, k2 = run(), run()
        est, pm_p, lm_p = plain()
        torch.cuda.synchronize()
        n = pose_optim.pose_optim.launches
        require(n == POSE_STEPS + 3, f"pose_optim {name}: {n} launches in "
                f"{POSE_STEPS + 1} steps and 2 calls")
        launches += n
        lanes = len(est.good)
        require(lanes == BATCH * POSE_STEPS and pm.P.shape[-2]
                == run_cfg.point_capacity, f"pose_optim {name}: "
                f"{lanes} lanes of {pm.P.shape[-2]} points")
        require(all(torch.equal(a, b) for a, b in zip(k, k2)),
                f"pose_optim {name}: two calls on the same inputs differ")
        require(bool(est.good.any()), f"pose_optim {name}: no lane good")
        for what, a, b in (("good", k.good, est.good),
                           ("point inliers", k.p_inlier, pm_p.inlier),
                           ("line inliers", k.l_inlier, lm_p.inlier),
                           ("point inlier counts", k.n_pt, est.n_inliers_pt),
                           ("line inlier counts", k.n_ls, est.n_inliers_ls)):
            diff = (a != b).reshape(lanes, -1).any(-1)
            require(not bool(diff.any()), f"pose_optim {name}: {what} "
                    f"differ from the plain path's on lanes "
                    f"{diff.nonzero().flatten().tolist()}")
        d64 = lambda nt: type(nt)(*[t.double() if t.is_floating_point()
                                    else t for t in nt])
        probes = [optimizer.optimize_pose_plain(
            d64(pm), d64(lm), cam, run_cfg, *[t.double() for t in prev])[0]]
        gen = torch.Generator().manual_seed(21)
        for _ in range(POSE_PROBES):
            pp = torch.randperm(pm.P.shape[-2], generator=gen).to(pm.P.device)
            lp = torch.randperm(lm.sP.shape[-2], generator=gen).to(pm.P.device)
            probes.append(optimizer.optimize_pose_plain(
                type(pm)(*[t[:, pp] for t in pm]),
                type(lm)(*[t[:, lp] for t in lm]), cam, run_cfg, *prev)[0])
        per_lane = lambda x: x.double().reshape(lanes, -1)
        gaps, spread = {}, {}
        for what, a, b, tol in (
                ("DT", k.DT, est.DT, POSE_DT_TOL),
                ("err", k.err, est.err_norm, None),
                ("cov", k.cov, est.DT_cov, None),
                ("eig", k.eig, est.DT_cov_eig, None),
                ("iters", k.iters, est.iters, POSE_ITERS_TOL)):
            gap = (per_lane(a) - per_lane(b)).abs().amax(-1)
            if what == "err":
                tol = POSE_ERR_TOL * per_lane(b)[:, 0].abs() + 1e-7
            elif tol is None:
                field = {"cov": "DT_cov", "eig": "DT_cov_eig"}[what]
                own = torch.stack([(per_lane(getattr(o, field))
                                    - per_lane(b)).abs().amax(-1)
                                   for o in probes]).amax(0)
                tol = POSE_COV_TOL * per_lane(b).abs().amax(-1) + 2 * own
                spread[what] = float(own.max())
            bad = ~(gap <= tol)
            require(not bool(bad.any()), f"pose_optim {name}: {what} "
                    f"differs from the plain path's by "
                    f"{gap[bad].tolist()} on lanes "
                    f"{bad.nonzero().flatten().tolist()}")
            gaps[what] = float(gap.max())
        read = [*pm, *prev] + (list(lm) if run_cfg.has_lines else [])
        n_bytes = sum(t.numel() * t.element_size() for t in read + list(k))
        n_ops = float(k.iters.sum()) * (
            POSE_OPS_PER_POINT * pm.P.shape[-2] * run_cfg.has_points
            + POSE_OPS_PER_LINE * lm.sP.shape[-2] * run_cfg.has_lines)
        bnd, by = bound_ms(n_bytes, n_ops)
        rows[name] = dict(
            lanes=lanes, points=pm.P.shape[-2], lines=lm.sP.shape[-2],
            has_lines=run_cfg.has_lines, good=int(est.good.sum()),
            point_inliers=int(est.n_inliers_pt.sum()),
            line_inliers=int(est.n_inliers_ls.sum()),
            iters=int(k.iters.sum()), plain_iters=int(est.iters.sum()),
            max_gap=gaps, plain_spread=spread, equal_discrete=True,
            bit_repeat=True,
            ms=time_ms(run, 20), plain_ms=time_ms(plain, 2),
            bytes=n_bytes, ops=n_ops, bound_ms=bnd, bound_by=by)
        del calls, pm, lm, prev, k, k2, est, pm_p, lm_p
    main = rows["points_lines"]
    row = dict(name="pose_optim", route="cuda",
               source="stvo_pl_tpu_torch/csrc/pose_optim.cu",
               replaces="stvo_pl_tpu/models/optimizer.py:369 (XLA, no "
               "Pallas kernel)",
               max_abs_err=max(r["max_gap"]["DT"] for r in rows.values()),
               ms=main["ms"], plain_ms=main["plain_ms"],
               bound_ms=main["bound_ms"], bound_by=main["bound_by"],
               library_ms=None)
    return dict(configs=rows, launches={"pose_optim": launches},
                seconds=time.perf_counter() - t_phase, card=smi), row


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
    from stvo_pl_tpu_torch.ops import pose_optim
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

    # ---- 5d. ORB's descriptor kernel at the fleet cells' shapes --------
    r_orb, b_orb = orb_describe_phase(seq_l, seq_r, smi)
    emit("orb_describe", **r_orb)

    # ---- 6. VO: the batched step on 8 lanes ----------------------------
    wrappers = {"fast_pack": fast_kernel.fast_pack,
                "extract_patches": patches.extract_patches,
                "run_pack_multi": lsd_kernel.run_pack_multi,
                "run_pack": lsd_kernel.run_pack,
                "hamming_matrix_popc": hamming.hamming_matrix_popc,
                "pose_optim": pose_optim.pose_optim,
                "orb_describe": orb.orb_describe}
    line_log = []       # (descriptors, validity) of each step's left lines

    def drive(run_cfg, frames, warmup, per_direction=False, log=None,
              graph=None, out=None):
        """`frames` steps of the batched VO from a fresh state; the
        kernels' counts are set to 0 just before and read just after.
        `graph` (a compiled step from `capture`, its graph captured
        before) replaces the eager vo_step_batched: its launches are the
        wrappers' counts (none: a replay runs no wrapper) and its kernel
        nodes times its replays in the run; `out` (a dict) receives the
        final state."""
        state = batched.init_batched_state(run_cfg, BATCH)
        step = graph["fn"] if graph else None
        since = [graph["prog"].replays] if graph else []
        for w in wrappers.values():
            w.launches = 0
        telems = []
        for i in range(frames):
            if i == warmup:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
            img_l, img_r = seq_l[:, i].contiguous(), seq_r[:, i].contiguous()
            if step is None:
                state, telem = batched.vo_step_batched(
                    state, img_l, img_r, cam, run_cfg,
                    per_direction=per_direction)
            else:
                state, telem = step(state, img_l, img_r)
            telems.append(telem)
            if log is not None:
                log.append((state.prev_lines.desc, state.prev_lines.valid))
        torch.cuda.synchronize()
        elapsed = time.perf_counter() - t0
        launches = {k: w.launches for k, w in wrappers.items()}
        graph_runs = {}
        if graph:
            rep = replayed([graph], wrappers, since)
            graph_runs = dict(wrapper_launches=launches,
                              replays=graph["prog"].replays - since[0],
                              graph_kernel_nodes=graph["kernel_nodes"])
            launches = {k: n + rep[k] for k, n in launches.items()}
        if out is not None:
            out["state"] = state
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
            inliers_ls_lanes=stat("n_inliers_ls"), launches=launches,
            **graph_runs)

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

    def capture(run_cfg, per_direction=False):
        """The compiled step for run_cfg on the 8 lanes, its graph
        captured by its first call, on a throwaway state (first_call)."""
        return first_call(
            batched.compile_vo_step(cam, run_cfg, BATCH, per_direction),
            batched.init_batched_state(run_cfg, BATCH),
            seq_l[:, 0].contiguous(), seq_r[:, 0].contiguous())

    graph_modes = {}    # vo_graph's shorter modes, each against its eager

    def graph_mode(name, run_cfg, tel_e, out_e, r_e, per_direction=False):
        """The compiled step over the frames of an eager run of run_cfg:
        every step's telemetry and the final state `torch.equal` to the
        eager run's, the kernels' counts equal, the VO gates held."""
        g = capture(run_cfg, per_direction)
        out_g = {}
        tel_g, r_g = drive(run_cfg, r_e["frames"], WARMUP_FRAMES,
                           per_direction=per_direction, graph=g, out=out_g)
        check(f"vo_graph {name}", r_g, r_e["launches"])
        require(len(tel_g) == len(tel_e) and all(
            same(a, b) for a, b in zip(tel_g, tel_e))
            and same(out_g["state"], out_e["state"]),
            f"vo_graph {name}: the graph's steps differ from eager")
        graph_modes[name] = dict(
            frames=r_e["frames"], ms_per_step=r_g["ms_per_step"],
            eager_ms_per_step=r_e["ms_per_step"], capture_s=g["capture_s"],
            first_call_bytes=g["first_call_bytes"],
            graph_kernel_nodes=g["kernel_nodes"], replays=r_g["replays"],
            launches=r_g["launches"], equal_to_eager=True)
        return r_g

    # the points-only path, at a smaller depth
    out_pts = {}
    tel_pts, r_pts = drive(cfg_points, POINTS_ONLY_FRAMES, WARMUP_FRAMES,
                           out=out_pts)
    emit("vo_points_only", **r_pts)
    check("vo_points_only", r_pts,
          {"fast_pack": POINTS_ONLY_FRAMES * cfg.orb_nlevels,
           "extract_patches": POINTS_ONLY_FRAMES * cfg.orb_nlevels,
           "orb_describe": POINTS_ONLY_FRAMES * cfg.orb_nlevels,
           "run_pack_multi": 0, "pose_optim": POINTS_ONLY_FRAMES})

    # the main path: VOConfig() with every default, points + lines
    out_main = {}
    telems, r_main = drive(cfg, n_frames, WARMUP_FRAMES, log=line_log,
                           out=out_main)
    emit("vo", **r_main, points_only_ms_per_step=r_pts["ms_per_step"])
    check("vo", r_main, {"fast_pack": n_frames * cfg.orb_nlevels,
                         "extract_patches": n_frames * cfg.orb_nlevels,
                         "orb_describe": n_frames * cfg.orb_nlevels,
                         "run_pack_multi": n_frames,
                         "pose_optim": n_frames})
    require(min(r_main["inliers_ls_lanes"]) > 0,
            f"vo: a lane tracked no line: {r_main['inliers_ls_lanes']}")

    # ---- 6a. the compiled step (a CUDA graph) in turns with the eager --
    # eager (the vo run above), graph, eager, graph: no profiler has run
    # in this process yet
    g_main = capture(cfg)
    runs = {"eager": [r_main], "graph": []}
    for turn in range(2):
        out_g = {}
        tel_g, r_g = drive(cfg, n_frames, WARMUP_FRAMES, graph=g_main,
                           out=out_g)
        check("vo_graph", r_g, r_main["launches"])
        require(all(torch.equal(a.Tfw, b.Tfw) for a, b in zip(tel_g, telems))
                and all(same(a, b) for a, b in zip(tel_g, telems))
                and same(out_g["state"], out_main["state"]),
                f"vo_graph: run {turn} of the graph differs from eager")
        runs["graph"].append(r_g)
        if turn == 0:
            runs["eager"].append(drive(cfg, n_frames, WARMUP_FRAMES)[1])
    cap_main = {k: g_main[k] for k in ("capture_s", "first_call_bytes")}
    del g_main, tel_g, out_g
    graph_ms = {k: [r["ms_per_step"] for r in v] for k, v in runs.items()}
    r_graph = dict(
        lanes=BATCH, frames=n_frames, timed_frames=n_frames - WARMUP_FRAMES,
        order="eager, graph, eager, graph", ms_per_step=graph_ms,
        fps={k: [r["fps"] for r in v] for k, v in runs.items()},
        eager_over_graph=min(graph_ms["eager"]) / min(graph_ms["graph"]),
        **cap_main, graph_kernel_nodes=runs["graph"][0]["graph_kernel_nodes"],
        replays=[r["replays"] for r in runs["graph"]],
        ate_m=runs["graph"][0]["ate_m"],
        good_frac=runs["graph"][0]["good_frac"],
        launches=runs["graph"][0]["launches"], steps_equal_to_eager=True,
        card=smi)

    # the dense single-octave detector with either candidate generator
    nf = POINTS_ONLY_FRAMES
    points_launches = {"fast_pack": nf * cfg.orb_nlevels,
                       "extract_patches": nf * cfg.orb_nlevels,
                       "orb_describe": nf * cfg.orb_nlevels,
                       "pose_optim": nf}
    cfg_dense = VOConfig(lsd_octaves=1)
    r_dense, dense_runs = {}, {}
    for gen_name, per_direction, lsd_launches in (
            ("all_direction", False, {"run_pack_multi": nf}),
            ("per_direction", True, {"run_pack": nf * cfg.lsd_n_dirs})):
        out_d = {}
        tel_d, r = drive(cfg_dense, nf, WARMUP_FRAMES,
                         per_direction=per_direction, out=out_d)
        dense_runs[gen_name] = (tel_d, out_d)
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
    cfg_popc = VOConfig(hamming_use_mxu=False)
    out_p = {}
    tel_p, r_popc = drive(cfg_popc, nf, WARMUP_FRAMES, out=out_p)
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
    # ops_graph's second queries: the 10th step's lines; validity masks
    # for the masked forms (the planted rows valid)
    qd2, qv2 = line_log[steps_in_index + 1]
    query2 = torch.where(qv2[..., None], qd2,
                         words(*qd2.shape)).reshape(-1, 8)
    q_valid = qv.reshape(-1).clone()
    q_valid[:100] = True
    queries = [(query, q_valid), (query2, qv2.reshape(-1))]
    del res, descs

    # ---- 6c. RGB-D: lane 0 with the renderer's depth maps --------------
    cfg_rgbd = VOConfig(rgbd_max_depth=200.0)     # the scene reaches 95 m
    for w in wrappers.values():
        w.launches = 0
    state = frontend.init_state(cfg_rgbd)
    rgbd_tels, rgbd_ls, rgbd_pt, rgbd_states = [], 0, 0, []
    t0 = time.perf_counter()
    for i in range(nf):
        rgbd_states.append(state)
        state, t = frontend.vo_step_rgbd(state, seq_l[0, i].contiguous(),
                                         depth0[i], cam, cfg_rgbd)
        rgbd_tels.append(t)
        rgbd_ls += int(t.n_inliers_ls)
        rgbd_pt += int(t.n_inliers_pt)
    torch.cuda.synchronize()
    rgbd_s = time.perf_counter() - t0
    rgbd_state = state
    traj = [t.Tfw for t in rgbd_tels]
    rgbd_ate = metrics.ate_rmse(torch.stack(traj).double().cpu().numpy(),
                                poses[:nf].double().cpu().numpy())
    rgbd_launches = {k: w.launches for k, w in wrappers.items()}
    emit("rgbd", frames=nf, ate_m=rgbd_ate,
         depth_share=float((depth0 > 0).float().mean()),
         inliers_pt_per_frame=rgbd_pt / (nf - 1),
         inliers_ls_per_frame=rgbd_ls / (nf - 1), launches=rgbd_launches)
    require(np.isfinite(rgbd_ate) and rgbd_ate < 0.1,
            f"rgbd: ATE {rgbd_ate} m")
    require(fast_kernel.fast_pack.launches == nf * cfg.orb_nlevels
            and lsd_kernel.run_pack_multi.launches == nf
            and pose_optim.pose_optim.launches == nf,
            "rgbd: the step did not go through the FAST, run and optimizer "
            "kernels")

    # ---- 6d. vo_graph's shorter modes, each against its eager run -----
    graph_mode("points_only", cfg_points, tel_pts, out_pts, r_pts)
    for gen_name, per_direction in (("all_direction", False),
                                    ("per_direction", True)):
        graph_mode(f"dense_{gen_name}", cfg_dense, *dense_runs[gen_name],
                   r_dense[gen_name], per_direction=per_direction)
    graph_mode("popcount", cfg_popc, tel_p, out_p, r_popc)
    # RGB-D: the compiled batched step on one lane against the eager
    # unbatched steps above
    g = first_call(batched.compile_vo_step_rgbd(cam, cfg_rgbd, 1),
                   batched.init_batched_state(cfg_rgbd, 1),
                   seq_l[:1, 0].contiguous(), depth0[None, 0])
    step, since = g["fn"], [g["prog"].replays]
    for w in wrappers.values():
        w.launches = 0
    state = batched.init_batched_state(cfg_rgbd, 1)
    t0 = time.perf_counter()
    tel_g = []
    for i in range(nf):
        state, t = step(state, seq_l[:1, i].contiguous(), depth0[None, i])
        tel_g.append(frontend._map(lambda x: x[0], t))
    torch.cuda.synchronize()
    g_s = time.perf_counter() - t0
    g_wrappers = {k: w.launches for k, w in wrappers.items()}
    g_rep = replayed([g], wrappers, since)
    g_launches = {k: n + g_rep[k] for k, n in g_wrappers.items()}
    require(all(same(a, b) for a, b in zip(tel_g, rgbd_tels))
            and same(frontend._map(lambda x: x[0], state), rgbd_state)
            and g_launches == rgbd_launches,
            f"vo_graph rgbd: the graph differs from eager (launches "
            f"{g_launches} against {rgbd_launches})")
    graph_modes["rgbd"] = dict(
        frames=nf, lanes=1, ms_per_step=g_s / nf * 1e3,
        eager_ms_per_step=rgbd_s / nf * 1e3, capture_s=g["capture_s"],
        first_call_bytes=g["first_call_bytes"],
        graph_kernel_nodes=g["kernel_nodes"],
        replays=g["prog"].replays - since[0], wrapper_launches=g_wrappers,
        launches=g_launches, equal_to_eager=True)
    del step, g, tel_g
    emit("vo_graph", **r_graph, modes=graph_modes)

    # ---- 6e. EDLines: the quality mode (edline_scale 2) and full size --
    r_ed, rgbd_ed_launches = edlines_phase(drive, check, capture, seq_l,
                                           depth0, cam, wrappers, smi)

    # ---- 6f. the pose optimizer's kernel on the main path's inputs ----
    r_popt, b_opt = pose_optim_phase(cam, seq_l, seq_r, smi)
    emit("pose_optim", **r_popt)

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

    # ---- 7b. the dataset CLI with windowed BA, textured street ---------
    # VOConfig() on the KITTI camera over 40 frames written to disk
    import os
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, os.path.join(here, "tools"))
    from export_street_torch import write_street_dataset
    street = os.path.join(here, "build", "chip_smoke_street")
    t0 = time.perf_counter()
    gt_street = write_street_dataset(street, cam, CLI_FRAMES,
                                     photos="bundled")
    render_s = time.perf_counter() - t0
    r_cli = cli_ba_phase(street, gt_street, cam, cfg, wrappers, smi,
                         r_main["ms_per_step"])
    # the step's wrappers run twice (the warm-up and the capture), its
    # graph is replayed once a frame
    per_step = {"fast_pack": cfg.orb_nlevels,
                "extract_patches": cfg.orb_nlevels,
                "orb_describe": cfg.orb_nlevels, "run_pack_multi": 1,
                "pose_optim": 1}
    for k in wrappers:
        n = per_step.get(k, 0)
        require(r_cli["wrapper_launches"][k] == 2 * n
                and r_cli["graph_launches"][k] == CLI_FRAMES * n,
                f"cli_ba: {k} launched {r_cli['wrapper_launches'][k]} times "
                f"by its wrapper and {r_cli['graph_launches'][k]} times by "
                f"replays in {CLI_FRAMES} frames, expected {2 * n} and "
                f"{CLI_FRAMES * n}")
    emit("cli_ba", render_seconds=render_s, **r_cli)

    # ---- 7c. one BA window, bf16 product against B5 --------------------
    win, kf_frames = first_window(street, cam, cfg)
    r_bap = ba_popcount_phase(win, kf_frames, cam, cfg, smi)
    emit("ba_popcount", **r_bap)

    # ---- 7c'. the same window through the compiled refiner --------------
    r_bag = ba_graph_phase(win, cam, cfg, smi)
    emit("ba_graph", **r_bag)

    # ---- 7c''. the other jitted entry points as compiled programs ------
    ops_entries = ops_graph_entries(
        cam, cfg, cfg_rgbd, seq_l, seq_r, depth0, rgbd_states, index,
        queries, win)
    del win, index, query, queries, rgbd_states
    r_ops = ops_graph_phase(ops_entries, wrappers, smi)
    emit("ops_graph", **r_ops)
    del ops_entries

    # ---- 7d. the sharded step, BA and refiner in an NCCL world of one --
    r_sh = sharded_phase(street, cam, cfg, seq_l, seq_r, wrappers, smi)
    emit("sharded", **r_sh)

    # ---- 7e. checkpoint and resume on the 8 lanes ----------------------
    r_ck = checkpoint_phase(cam, cfg, seq_l, seq_r, wrappers, smi)
    emit("checkpoint", **r_ck)

    # ---- 8. one default step under torch.profiler ----------------------
    # last, with the B4 split: after a profiler session in this process
    # the VO phases' steps read slower on the host clock (PERF.md §5)
    r_prof = profiling_phase(cam, cfg, seq_l, seq_r, wrappers, smi)
    # device busy: device time over wall time within one traced window
    # (the eager step; the compiled step's replays), beside the traced
    # device ms per step and the unprofiled wall ms per step of vo_graph
    busy = {"eager": r_prof["device_total_ms"] / r_prof["step_wall_ms"],
            "graph": (r_prof["graph"]["device_total_ms"]
                      / r_prof["graph"]["window_wall_ms"])}
    emit("profiling", **r_prof, device_busy_share_traced=busy,
         device_ms_per_step_traced={
             "eager": r_prof["device_total_ms"],
             "graph": r_prof["graph"]["device_ms_per_replay"]},
         wall_ms_per_step_unprofiled={k: min(v) for k, v in
                                      graph_ms.items()})

    # ---- 9. B4 split into its passes, by torch.profiler ----------------
    b4_split, b4_dir_split = {}, []
    for m, (dx, dy) in zip(masks, dsteps):
        split = kernel_split_us(lambda: lsd_kernel.run_pack(m, dx, dy))
        for key, us in split.items():
            b4_split[key] = b4_split.get(key, 0.0) + us
        b4_dir_split.append(dict(step=[dx, dy], split_us=split))
    emit("B4_pass_split", step_split_us=b4_split, dirs=b4_dir_split)
    del masks

    # each kernel's launches come from the phase whose path runs it;
    # "phases" lists its launches in every phase that ran it
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "phases",
            "ops_graph_launches")
    phase_launches = {
        "vo_points_only": r_pts["launches"], "vo": r_main["launches"],
        "vo_dense_all_direction": r_dense["all_direction"]["launches"],
        "vo_dense_per_direction": r_dense["per_direction"]["launches"],
        "vo_popcount": r_popc["launches"], "rgbd": rgbd_launches,
        "cli_ba": r_cli["launches"],
        "ba_popcount": {"hamming_matrix_popc":
                        r_bap["b5_launches"]["popcount_kernel"]},
        "vo_edlines_scale2": r_ed["scale2"]["launches"],
        "vo_edlines_scale1": r_ed["scale1"]["launches"],
        "rgbd_edlines": rgbd_ed_launches,
        "sharded": r_sh["launches"],
        "sharded_tp": r_sh["steps"]["launches"]["tp_graph"],
        "checkpoint": r_ck["launches"], "profiling": r_prof["launches"],
        "sharded_refiner": {"hamming_matrix_popc":
                            r_sh["refiner_b5_launches"]["popcount_kernel"]},
        "vo_graph": r_graph["launches"],
        **{f"vo_graph_{m}": g["launches"] for m, g in graph_modes.items()},
        "vo_edlines_graph_scale2": r_ed["scale2"]["graph"]["launches"],
        "vo_edlines_graph_scale1": r_ed["scale1"]["graph"]["launches"],
        "ba_graph": {"hamming_matrix_popc":
                     r_bag["b5_launches_per_window"]},
        "profiling_graph": r_prof["graph"]["launches"],
        "ops_graph": r_ops["launches"], "pose_optim": r_popt["launches"],
        "orb_describe": {"orb_describe": r_orb["launches"]},
        **{f"profiling_graph_{k}": o["launches"]
           for k, o in r_prof["replays_traced"].items()}}
    ran_in = [(b1, r_main), (b2, r_main), (b3, r_main),
              (b4, r_dense["per_direction"]), (b5, r_popc),
              (b_opt, r_popt), (b_orb, r_main)]
    # `launches`: the kernel's path's own run, counts zeroed just before;
    # `ops_graph_launches`: the ops_graph phase's graphs (no check reads it)
    table = [{k: row[k] for k in keys} for row in
             (dict(r, launches=run["launches"][r["name"]],
                   ops_graph_launches=r_ops["launches"][r["name"]],
                   phases={ph: n[r["name"]] for ph, n in
                           phase_launches.items()
                           if n.get(r["name"], 0) > 0})
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
