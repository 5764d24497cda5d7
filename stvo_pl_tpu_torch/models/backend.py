"""Windowed-BA back end driven by the live VO loop (port of
stvo_pl_tpu/models/backend.py).

A keyframe ring collects (pose, stereo point snapshot, line snapshot)
whenever the front end flags a keyframe (the reference's needNewKF /
currFrameIsKF hooks, src/stereoFrameHandler.cpp:1136-1218), and every full
window is jointly refined with the Schur-complement BA (parallel/window.py
+ parallel/ba.py).  Windows are CHAINED: the last refined keyframe of one
window anchors the next (the gauge holds pose 0 fixed), so drift
corrections compose along the trajectory.

Use from the CLI via --ba-window K, or directly:

    backend = WindowedBA(cam, cfg, window=4)
    for each frame: backend.observe(i, telem.Tfw, telem.is_kf,
                                    state.prev_points, state.prev_lines)
    refined = backend.apply(np.stack(raw_poses))

Snapshots are copies: the ring clones every tensor it keeps, so a later
step that reuses a buffer cannot change a window already in the ring.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from stvo_pl_tpu_torch.config import VOConfig
from stvo_pl_tpu_torch.device import resolve_device
from stvo_pl_tpu_torch.models.features import LineSet, PointSet
from stvo_pl_tpu_torch.ops import camera as cam_ops
from stvo_pl_tpu_torch.ops import se3
from stvo_pl_tpu_torch.parallel import window as window_mod


def _host64(T) -> np.ndarray:
    if torch.is_tensor(T):
        T = T.detach().cpu().numpy()
    return np.asarray(T, dtype=np.float64)


class WindowedBA:
    """Keyframe ring + chained window refinement on `device` ("cuda"
    unless the caller asks for the CPU).

    force_kf_every > 0 additionally promotes every Nth frame to a keyframe
    (useful when the entropy-ratio policy fires rarely on short runs).
    """

    def __init__(self, cam: cam_ops.StereoCamera, cfg: VOConfig,
                 window: int = 4, n_iters: int = 8,
                 force_kf_every: int = 0, multi_anchor: bool = True,
                 use_lines: bool = True, max_correction: float = 1.0,
                 max_rot_correction: float = 15.0, auto_lines: bool = True,
                 chi2_tol: float = 1.10, max_disagree_t: float = 0.25,
                 max_disagree_r: float = 1.0, device=None):
        self.device = resolve_device(device)
        self.cam = cam
        self.cfg = cfg
        self.window = window
        self.n_iters = n_iters
        self.force_kf_every = force_kf_every
        self.multi_anchor = multi_anchor
        self.use_lines = use_lines
        # automatic per-window line trust (window.refine_window_auto);
        # auto_lines=False forces the joint solve unconditionally
        self.auto_lines = auto_lines
        self.chi2_tol = chi2_tol
        self.max_disagree_t = max_disagree_t
        self.max_disagree_r = max_disagree_r
        self.n_lines_rejected = 0
        # per-window trust gate: the largest translation [m] / rotation
        # [deg] any window may move a keyframe against its input pose.  A
        # legitimate correction is centimeters and a few degrees; windows
        # asking for more are dragged by corrupted tracks and are SKIPPED
        # (raw poses kept, chain undisturbed).  Sizing as the reference's
        # (stvo_pl_tpu/models/backend.py:60-80).
        self.max_correction = max_correction
        self.max_rot_correction = max_rot_correction
        self.n_skipped = 0
        # wall-clock seconds per _refine call, synchronized
        self.refine_times: list[float] = []
        # ring entries: (frame_idx, T_corrected [4,4] np, T_raw, PointSet,
        #                LineSet | None)
        self._ring: list[tuple] = []
        # refinement events: (kf_indices, corrections C_k [K,4,4])
        self.events: list[tuple[list[int], np.ndarray]] = []
        self._frames_since_kf = 0
        self._C = np.eye(4)     # cumulative correction for incoming poses
        # the refiners are captured programs, built at first use (on CUDA
        # one graph per window size and structure; on the CPU they run
        # eagerly); the trust gate and the chaining stay on the host
        self._refiners: dict = {}

    def _snapshot(self, fs):
        return type(fs)(*[x.detach().to(self.device).clone() for x in fs])

    def observe(self, frame_idx: int, Tfw, is_kf, points: PointSet,
                lines: LineSet | None = None):
        """Feed one frame's outcome (unbatched: no lane axis); returns
        (kf_indices, refined_poses) when a window was just refined, else
        None.  Pass the frame's LineSet to include line-endpoint landmarks
        (use_lines=False drops them)."""
        take = frame_idx == 0 or bool(is_kf)
        if self.force_kf_every > 0:
            take = take or self._frames_since_kf + 1 >= self.force_kf_every
        self._frames_since_kf = 0 if take else self._frames_since_kf + 1
        if not take:
            return None
        T_raw = _host64(Tfw)
        T_in = self._C @ T_raw
        snap = self._snapshot(points)
        lsnap = None
        if self.use_lines and lines is not None:
            lsnap = self._snapshot(lines)
        self._ring.append((frame_idx, T_in, T_raw, snap, lsnap))
        if len(self._ring) == self.window:
            return self._refine()
        return None

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def stack_window(self) -> window_mod.KeyframeWindow:
        """The ring's keyframes as one window: input poses (chain
        corrections applied) and snapshots, stacked on the device."""
        return window_mod.stack_keyframes(
            [(torch.tensor(T_in, dtype=torch.float32, device=self.device),
              pts, ls) for _, T_in, _, pts, ls in self._ring])

    def refiner(self, auto: bool):
        """`refine(win)`: the captured program
        (`window.compile_refiner`) of `window.refine_window_auto`
        (`auto`) or `refine_window` with this back end's settings."""
        if auto not in self._refiners:
            kw = dict(n_iters=self.n_iters, multi_anchor=self.multi_anchor)
            if auto:
                kw.update(chi2_tol=self.chi2_tol,
                          max_disagree_t=self.max_disagree_t,
                          max_disagree_r=self.max_disagree_r)
            self._refiners[auto] = window_mod.compile_refiner(
                self.cam, self.cfg, auto=auto, device=self.device, **kw)
        return self._refiners[auto]

    def _refine(self):
        self._sync()
        t0 = time.perf_counter()
        win = self.stack_window()
        if win.lines is not None and self.auto_lines:
            Tfw_new, _, _, used_lines = self.refiner(True)(win)
            if not bool(used_lines):       # the window's one host sync
                self.n_lines_rejected += 1
        else:
            Tfw_new, _, _ = self.refiner(False)(win)
        Tfw_new = _host64(Tfw_new)
        self.refine_times.append(time.perf_counter() - t0)
        idxs = [i for i, *_ in self._ring]
        # trust gate on the WITHIN-WINDOW increment (refined vs the
        # window's own input poses; chain corrections excluded)
        incs = [Tfw_new[k] @ np.linalg.inv(self._ring[k][1])
                for k in range(len(idxs))]
        inc_t = max(np.linalg.norm(M[:3, 3]) for M in incs)
        inc_r = max(np.degrees(np.arccos(np.clip(
            (np.trace(M[:3, :3]) - 1.0) / 2.0, -1.0, 1.0))) for M in incs)
        if inc_t > self.max_correction or inc_r > self.max_rot_correction:
            self.n_skipped += 1
            self._ring = [self._ring[-1]]
            return None
        # per-KF output correction vs the RAW trajectory
        C = np.stack([Tfw_new[k] @ np.linalg.inv(self._ring[k][2])
                      for k in range(len(idxs))])
        self.events.append((idxs, C))
        # chain: refined last KF anchors the next window
        last_idx, _, last_raw, last_pts, last_ls = self._ring[-1]
        self._C = Tfw_new[-1] @ np.linalg.inv(last_raw)
        self._ring = [(last_idx, Tfw_new[-1], last_raw, last_pts, last_ls)]
        return idxs, Tfw_new

    def apply(self, poses: np.ndarray) -> np.ndarray:
        """Correct a raw trajectory [T, 4, 4].  Keyframe corrections are
        interpolated along se(3) between consecutive KFs, in float32 on
        the backend's device; the last correction extends unchanged to the
        end of the run."""
        out = np.array(poses, dtype=np.float64, copy=True)
        # flatten events into ordered (kf_frame, C) knots
        segs: list[tuple[int, np.ndarray]] = []
        for idxs, C in self.events:
            for k, i0 in enumerate(idxs):
                if segs and segs[-1][0] == i0:
                    segs[-1] = (i0, C[k])   # shared anchor: same correction
                else:
                    segs.append((i0, C[k]))
        f32 = dict(dtype=torch.float32, device=self.device)
        for s, (i0, C0) in enumerate(segs):
            if s + 1 < len(segs):
                i1, C1 = segs[s + 1]
                d = se3.logmap_se3(torch.tensor(
                    (C1 @ np.linalg.inv(C0)).astype(np.float32), **f32))
                d = d.cpu().numpy()
                a = ((np.arange(i0, i1) - i0) / float(i1 - i0)).astype(
                    np.float32)
                xi = a[:, None] * d[None, :]
                Ci = _host64(se3.expmap_se3(torch.tensor(xi, **f32))) @ C0
                out[i0:i1] = Ci @ out[i0:i1]
            else:
                out[i0:] = C0[None] @ out[i0:]
        return out
