"""Dataset-driven VO runner (port of stvo_pl_tpu/cli.py; the reference CLI
app, app/imagesStVO.cpp:39-171).

Usage:
    python -m stvo_pl_tpu_torch.cli <dataset_dir> [-c config.yaml]
        [-o offset] [-n n_frames] [-s step] [-t traj_out] [--gt gt.txt]
        [--ba-window K] [--plot out.png] [--device cuda|cpu]

Flags -c/-o/-n/-s mirror the reference (app/imagesStVO.cpp:148-171).  The
dataset directory must contain dataset_params.yaml (reference schema).
Per-frame telemetry matches the reference console output
(app/imagesStVO.cpp:113-121): frame index, residual, processing time, FAST
threshold, matched/inlier counts.  The run is on the GPU unless
`--device cpu` asks for the CPU.
"""

from __future__ import annotations

import argparse
import time
from typing import NamedTuple

import numpy as np
import torch


def build_argparser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="stvo_pl_tpu_torch",
        description="stereo PL visual odometry on a GPU (PyTorch/CUDA)")
    ap.add_argument("dataset", help="dataset dir with dataset_params.yaml")
    ap.add_argument("-c", "--config", default=None,
                    help="algorithm config YAML (reference schema)")
    ap.add_argument("-o", "--offset", type=int, default=0,
                    help="start frame offset")
    ap.add_argument("-n", "--nmax", type=int, default=0,
                    help="number of frames (0 = all)")
    ap.add_argument("-s", "--step", type=int, default=1, help="frame step")
    ap.add_argument("-t", "--traj-out", default=None,
                    help="write trajectory (TUM format)")
    ap.add_argument("--kitti-out", default=None,
                    help="write trajectory (KITTI format)")
    ap.add_argument("--plot", default=None,
                    help="render trajectory + stats PNG")
    ap.add_argument("--gt", default=None,
                    help="ground-truth trajectory file (KITTI 12-col or "
                         "TUM 8-col, auto-detected); prints ATE/RPE and "
                         "overlays the plot")
    ap.add_argument("--ba-window", type=int, default=0, metavar="K",
                    help="refine the trajectory with windowed bundle "
                         "adjustment over K-keyframe windows (0 = off)")
    ap.add_argument("--ba-kf-every", type=int, default=0, metavar="N",
                    help="additionally promote every Nth frame to a "
                         "keyframe for the BA back end")
    ap.add_argument("--ba-no-lines", action="store_true",
                    help="exclude line-endpoint landmarks from the windowed "
                         "BA (A/B; default refines points AND lines)")
    ap.add_argument("--ba-line-trust-tol", type=float, default=0.25,
                    metavar="T",
                    help="automatic line-trust gate: reject a window's line "
                         "landmarks when the joint solution disagrees with "
                         "the points-only solution by > T meters (rotation "
                         "gated at 4*T degrees alongside)")
    ap.add_argument("--ba-forced-lines", action="store_true",
                    help="skip the automatic per-window line-trust check "
                         "and always solve the joint points+lines system")
    ap.add_argument("--ba-max-correction", type=float, default=1.0,
                    metavar="M",
                    help="per-window trust gate: skip any BA window whose "
                         "refined poses move more than M meters from the "
                         "window's input poses (corrupted-track defense)")
    ap.add_argument("--ba-max-rot-correction", type=float, default=15.0,
                    metavar="DEG",
                    help="rotation arm of the per-window trust gate "
                         "[degrees]; legitimate windows ask for a few "
                         "degrees on rotation-jittery scenes, corrupted "
                         "line tracks for tens")
    ap.add_argument("--ba-anchor-only", action="store_true",
                    help="restrict BA landmarks to the window's anchor "
                         "keyframe (legacy builder; default unions tracks "
                         "across all window keyframes)")
    ap.add_argument("--scene-every", type=int, default=0, metavar="N",
                    help="with --scene: rewrite the scene file every N "
                         "frames DURING the run (live view via browser "
                         "refresh)")
    ap.add_argument("--scene", default=None, metavar="OUT.html",
                    help="write an interactive 3-D scene (trajectory, "
                         "frustums, KF markers, covariance ellipsoid, "
                         "image viewport) as a self-contained HTML file")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the run (default cuda; cpu runs "
                         "the plain versions of the kernels)")
    ap.add_argument("--quiet", action="store_true")
    return ap


def _associate_gt(gt, gt_stamps, frame_stamps, args, n_poses):
    """Select one GT row per run frame, or None (with a message) on failure.

    KITTI GT (no time column) is strictly one row per source frame: index
    association with the run's offset/step decimation.  TUM GT written by
    write_tum also indexes by frame (integer stamps 0..N-1).  Real TUM
    groundtruth.txt is asynchronous ~100 Hz mocap: there, rows are matched
    to frame timestamps by nearest neighbor, never by index.
    """
    from stvo_pl_tpu_torch.utils import metrics

    per_frame_indexed = gt_stamps is None or (
        len(gt_stamps) and np.all(gt_stamps == np.arange(len(gt_stamps))))
    if per_frame_indexed:
        idx = np.arange(args.offset, args.offset + n_poses * args.step,
                        args.step)
        if len(gt) > idx[-1]:
            gt = gt[idx]
        if len(gt) == n_poses:
            return gt
        print(f"[stvo] GT length {len(gt)} != run length {n_poses}; "
              f"skipping ATE")
        return None
    # asynchronous (timestamped) GT: associate by time
    try:
        idx = metrics.associate_by_stamps(
            gt_stamps, np.asarray(frame_stamps[:n_poses], dtype=np.float64))
    except ValueError as e:
        print(f"[stvo] cannot associate timestamped GT to frames: {e}; "
              f"skipping ATE")
        return None
    return gt[idx]


class CliRun(NamedTuple):
    """What one run of the CLI produced."""
    poses: np.ndarray                 # [T, 4, 4] raw VO trajectory (f32)
    poses_refined: np.ndarray | None  # BA-refined trajectory, if any window
    stats: list[dict]                 # per-frame err, ms, inliers, kf
    backend: object | None            # the WindowedBA, with --ba-window
    loader: str                       # how frames were read: "native"
    #                                   (the C++ prefetcher) or "python"


# telemetry fields fetched per frame, packed into one float32 vector
_SCALARS = ("err_norm", "fast_th", "n_points", "n_inliers_pt", "n_lines",
            "n_inliers_ls", "is_kf")


def _pack(telem) -> torch.Tensor:
    """The frame's pose and counters as one float32 vector (counts are
    far below 2^24, so exact)."""
    return torch.cat([telem.Tfw.reshape(-1).float()]
                     + [getattr(telem, f).reshape(1).float()
                        for f in _SCALARS])


def _unpack(v: np.ndarray) -> dict:
    out = dict(Tfw=v[:16].reshape(4, 4).copy())
    out.update(zip(_SCALARS, v[16:].tolist()))
    return out


def run(argv=None) -> CliRun:
    """Parse argv, run the VO (and the BA back end) over the dataset, print
    the reference's telemetry and evaluation lines, write the requested
    files."""
    args = build_argparser().parse_args(argv)

    from stvo_pl_tpu_torch.config import load_config
    from stvo_pl_tpu_torch.device import resolve_device
    from stvo_pl_tpu_torch.models import frontend
    from stvo_pl_tpu_torch.utils.dataset import ImageSequence

    dev = resolve_device(args.device)
    cfg = load_config(args.config)
    seq = ImageSequence(args.dataset, offset=args.offset, nmax=args.nmax,
                        step=args.step, device=dev)
    cam = seq.calib.cam
    print(f"[stvo] {len(seq)} frames, cam {cam.width}x{cam.height} "
          f"fx={cam.fx:.1f} b={cam.b:.4f}")

    state = frontend.init_state(cfg, device=dev)
    backend = None
    if args.ba_window > 0:
        from stvo_pl_tpu_torch.models.backend import WindowedBA
        backend = WindowedBA(cam, cfg, window=args.ba_window,
                             force_kf_every=args.ba_kf_every,
                             multi_anchor=not args.ba_anchor_only,
                             use_lines=not args.ba_no_lines,
                             auto_lines=not args.ba_forced_lines,
                             max_correction=args.ba_max_correction,
                             max_rot_correction=args.ba_max_rot_correction,
                             max_disagree_t=args.ba_line_trust_tol,
                             max_disagree_r=4.0 * args.ba_line_trust_tol,
                             device=dev)
    poses = []
    stats = []
    scene_imgs = {}
    # Software-pipelined loop: frames are decoded ahead by the native
    # prefetching loader into pinned memory.  The step is its captured
    # program (frontend.compile_vo_step, as the JAX CLI drives its jitted
    # vo_step; with --device cpu it runs eagerly), which queues the pair's
    # host->device copy (non_blocking) into its static buffers ahead of
    # its replay; a distorted rig's raw pair is rectified inside it.  Each
    # frame's telemetry is packed into one vector and copied back
    # asynchronously, and consumed one frame later, so the host waits on
    # an already-finished frame and makes one transfer per frame instead
    # of one per field.
    cuda = dev.type == "cuda"
    rectify = seq.rectification
    step = frontend.compile_vo_step(cam, cfg, device=dev, rectify=rectify)
    if rectify is not None:
        print(f"[stvo] raw frames rectified inside the step; "
              f"{100.0 * rectify.outside_share:.3f}% of rectified pixels "
              f"sample outside the raw image")

    def _fetch(telem):
        v = _pack(telem)
        if not cuda:
            return v, None
        host = torch.empty(v.shape, dtype=v.dtype, pin_memory=True)
        host.copy_(v, non_blocking=True)
        done = torch.cuda.Event()
        done.record()
        return host, done

    last_done = [time.perf_counter()]

    def _shown(img):
        """A left image of the scene page, rectified as the step sees it."""
        if rectify is not None:
            from stvo_pl_tpu_torch.ops.camera import rectify_remap
            img = rectify_remap(img.to(torch.float32),
                                torch.from_numpy(seq.calib.map_l))
        return img.cpu().numpy()

    def _consume(entry):
        i, (host, done), prev_points, prev_lines, img_l = entry
        if done is not None:
            done.synchronize()          # the frame's one sync point
        t_np = _unpack(host.numpy())
        Tfw = t_np["Tfw"]
        # per-frame THROUGHPUT (completion interval): with the pipelined
        # loop, dispatch-to-fetch latency would double-count overlap
        now = time.perf_counter()
        dt_ms = (now - last_done[0]) * 1e3
        last_done[0] = now
        is_kf = bool(t_np["is_kf"])
        poses.append(Tfw)
        if backend is not None:
            done_ba = backend.observe(i, Tfw, i > 0 and is_kf,
                                      prev_points, prev_lines)
            if done_ba is not None and not args.quiet:
                print(f"[stvo] BA refined keyframes {done_ba[0]}")
        stats.append(dict(err=t_np["err_norm"], ms=dt_ms,
                          npt=int(t_np["n_inliers_pt"]),
                          nls=int(t_np["n_inliers_ls"]), kf=is_kf))
        if args.scene and (i == 0 or (is_kf and len(scene_imgs) < 12)):
            scene_imgs[i] = _shown(img_l)
        if (args.scene and args.scene_every > 0 and i > 0
                and i % args.scene_every == 0):
            from stvo_pl_tpu_torch.utils.scene_html import write_scene_html
            write_scene_html(args.scene, np.stack(poses), stats,
                             images=scene_imgs,
                             title=f"stvo_pl_tpu_torch (live, frame {i})")
        if not args.quiet:
            print(f"Frame #{i:5d}  err {t_np['err_norm']:8.5f}  "
                  f"{dt_ms:7.2f} ms  fast_th {t_np['fast_th']:4.0f}  "
                  f"pt {int(t_np['n_points']):4d}"
                  f"({int(t_np['n_inliers_pt']):4d})"
                  f"  ls {int(t_np['n_lines']):3d}"
                  f"({int(t_np['n_inliers_ls']):3d})"
                  + ("  [KF]" if i and is_kf else ""))

    it = iter(seq.prefetch(raw=rectify is not None))
    cur = next(it, None)
    in_flight = None   # frame dispatched but telemetry not yet consumed:
    i = -1             # the sync always lands on an already-finished frame
    img_l = None
    while cur is not None:
        i += 1
        img_l = cur[0]
        state, telem = step(state, cur[0], cur[1])
        fetched = _fetch(telem)
        cur = next(it, None)
        if in_flight is not None:
            _consume(in_flight)
        in_flight = (i, fetched, state.prev_points, state.prev_lines, img_l)
    if in_flight is not None:
        _consume(in_flight)

    poses = np.stack(poses)
    poses_refined = None
    if backend is not None and backend.events:
        poses_refined = backend.apply(poses)
        t_ba = backend.refine_times
        timing = ""
        if t_ba:
            steady = (f", steady {np.median(t_ba[1:]):.2f}s/window"
                      if len(t_ba) > 1 else "")
            timing = f" (first {t_ba[0]:.1f}s{steady})"
        print(f"[stvo] BA: {len(backend.events)} window(s) refined"
              + (f", {backend.n_lines_rejected} line-rejected"
                 if backend.n_lines_rejected else "")
              + (f", {backend.n_skipped} skipped by trust gate"
                 if backend.n_skipped else "")
              + timing)
    names, ns = step.stages()
    if len(ns):
        # each stage's median over the run's steps, from the step's stage
        # stamps (utils/profiling.py): the device's clock on the card, the
        # host's on the CPU, where the step runs synchronously
        med = np.median(np.diff(ns.numpy(), axis=1), axis=0) * 1e-6
        print(f"[stvo] stages: median {'device' if cuda else 'host'} ms "
              f"per step over {len(ns)} step(s): "
              + "  ".join(f"{n} {v:.2f}" for n, v in zip(names[1:], med)))
    from stvo_pl_tpu_torch.utils import metrics
    if args.traj_out:
        metrics.write_tum(args.traj_out, poses)
        print(f"[stvo] trajectory -> {args.traj_out}")
        if poses_refined is not None:
            metrics.write_tum(args.traj_out + ".refined", poses_refined)
            print(f"[stvo] BA-refined trajectory -> "
                  f"{args.traj_out}.refined")
    if args.kitti_out:
        metrics.write_kitti(args.kitti_out, poses)
        print(f"[stvo] trajectory -> {args.kitti_out}")
    gt = None
    if args.gt:
        gt, gt_stamps = metrics.read_trajectory(args.gt, return_stamps=True)
        gt = _associate_gt(gt, gt_stamps, seq.stamps, args, len(poses))
        if gt is not None:
            ate = metrics.ate_rmse(poses, gt)
            t_rmse, r_rmse = metrics.rpe(poses, gt)
            unit = ("frame" if args.step == 1
                    else f"{args.step}-frame step")
            print(f"[stvo] ATE {ate:.4f} m   RPE {t_rmse * 1e3:.1f} mm / "
                  f"{r_rmse:.4f} deg per {unit} "
                  f"(path {metrics.trajectory_length(gt):.1f} m)")
            if poses_refined is not None:
                ate_r = metrics.ate_rmse(poses_refined, gt)
                print(f"[stvo] ATE (BA-refined) {ate_r:.4f} m")
    if args.plot:
        from stvo_pl_tpu_torch.utils.visualization import plot_run
        plot_run(args.plot, poses, stats, gt_poses=gt)
        print(f"[stvo] plot -> {args.plot}")
    if args.scene and len(poses):
        from stvo_pl_tpu_torch.utils.scene_html import write_scene_html
        scene_imgs[len(poses) - 1] = _shown(img_l)
        write_scene_html(args.scene,
                         poses_refined if poses_refined is not None
                         else poses,
                         stats, gt_poses=gt, images=scene_imgs,
                         cov=state.Tfw_cov.cpu().numpy(),
                         title=f"stvo_pl_tpu_torch {args.dataset}")
        print(f"[stvo] scene -> {args.scene}")

    ms = np.array([s["ms"] for s in stats][2:])
    if len(ms):
        print(f"[stvo] mean {ms.mean():.2f} ms/frame "
              f"({1e3 / ms.mean():.1f} fps) after warmup")
    return CliRun(poses=poses, poses_refined=poses_refined, stats=stats,
                  backend=backend, loader=seq.loader)


def main(argv=None):
    """The CLI entry point: returns the raw trajectory [T, 4, 4]."""
    return run(argv).poses


if __name__ == "__main__":
    main()
