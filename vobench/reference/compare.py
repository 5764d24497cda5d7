"""The comparison that decides `correct`: what the timed path answered,
frame by frame, against the renderer's ground truth, and in the online
cell each BA window against the plain reference's refinement
(vobench/reference/window_ba.py).

It imports nothing of the program.  Every answer of the window is judged
(no sample): each lane-frame's pose, keyframe flag and line-inlier count
as the program's telemetry reached the host, and in the online cell each
BA window's refined keyframe poses as `WindowedBA.observe` returned them.
The numbers, each worse when higher:

- `ate_med_m`: the median over the window's lane passes (at least 3
  frames of a pass in the window) of the pass's rigid-aligned absolute
  trajectory error, against the true poses relative to the pass's first
  frame.
- `ate_p90_m`: the 90th percentile of those errors (numpy's linear
  interpolation): a fault in a tenth of the lanes or more moves it where
  it leaves the median.
- `ate_m`: the largest of those errors (the hardest scene's).
- `rpe_m`: the largest translation error of one frame-to-frame motion.
- `kf_gap_m`: the largest true distance from the last keyframe (or the
  pass's first frame) at a frame the program did not make a keyframe:
  the decision must fire before `max_kf_t_dist` is passed.
- `line_miss`: the share of tracked lane-frames (all but a pass's first)
  with no line inlier; only where the configuration runs lines.
- `ba_gap_med_m`: the median over the BA windows (online cell only) of a
  window's gap: the largest distance between a keyframe position that the
  program's window returned and the reference's refinement of the same
  window from the same inputs (vobench/reference/window_ba.py).  Infinite
  where the two do not close and refine the same windows (a window
  skipped, or never closed), not a number where the reference refined
  none.  `ba_gap_m` is the largest window's gap, `ba_gap_deg` the largest
  rotation gap, `ba_windows` and `ba_windows_ref` the windows each
  refined.
"""

from __future__ import annotations

import numpy as np

from vobench.reference.trajectory import ate_rmse, relative, step_errors

# passes with fewer frames in the window give no ATE
MIN_ATE_FRAMES = 3


class Frames:
    """The window's answers, one row per lane-frame, as numpy arrays."""

    FIELDS = ("lane", "pass_start", "pass_no", "frame", "is_kf", "good",
              "n_inliers_ls")

    def __init__(self):
        self._rows: dict = {f: [] for f in self.FIELDS}
        self._T: list = []

    def add(self, lane, pass_start, pass_no, frame, Tfw, is_kf, good,
            n_inliers_ls):
        """Append a block of rows (equal-length array-likes; Tfw
        [n, 4, 4])."""
        for f, v in zip(self.FIELDS, (lane, pass_start, pass_no, frame,
                                      is_kf, good, n_inliers_ls)):
            self._rows[f].append(np.asarray(v).reshape(-1))
        self._T.append(np.asarray(Tfw, dtype=np.float64).reshape(-1, 4, 4))

    def arrays(self) -> dict:
        if not self._T:
            out = {f: np.zeros(0, np.int64) for f in self.FIELDS}
            out["Tfw"] = np.zeros((0, 4, 4))
            return out
        out = {f: np.concatenate(v) for f, v in self._rows.items()}
        out["Tfw"] = np.concatenate(self._T)
        return out

    def __len__(self) -> int:
        return sum(len(t) for t in self._T)


def _groups(a: dict):
    """(pass_start, frames, Tfw, is_kf, index rows) per lane pass, its rows
    in frame order."""
    key = a["lane"].astype(np.int64) * (1 << 32) + a["pass_no"]
    for k in np.unique(key):
        rows = np.nonzero(key == k)[0]
        rows = rows[np.argsort(a["frame"][rows], kind="stable")]
        yield int(a["pass_start"][rows[0]]), a["frame"][rows], rows


def judge(frames: Frames, truth: np.ndarray, has_lines: bool,
          max_kf_t_dist: float) -> dict:
    """The numbers of one run (see the module's docstring) but the BA's.
    truth: the true camera-to-world poses [T, 4, 4] of every lane's
    sequence."""
    a = frames.arrays()
    out = dict(ate_m=float("nan"), ate_med_m=float("nan"), rpe_m=0.0,
               kf_gap_m=0.0)
    ates, n_tracked, n_miss = [], 0, 0
    for start, fr, rows in _groups(a):
        est = a["Tfw"][rows]
        gt = relative(truth[fr], truth[start])
        if len(rows) >= MIN_ATE_FRAMES:
            ates.append(ate_rmse(est, gt))
        consecutive = np.diff(fr) == 1
        if consecutive.any():
            out["rpe_m"] = max(out["rpe_m"], float(
                step_errors(est, gt)[consecutive].max()))
        # keyframe gaps, counted from a keyframe seen in the window
        last_kf = 0 if fr[0] == start else None
        for j in range(len(rows)):
            if fr[j] == start:
                continue
            if a["is_kf"][rows[j]]:
                last_kf = j
            elif last_kf is not None:
                gap = np.linalg.norm(gt[j, :3, 3] - gt[last_kf, :3, 3])
                out["kf_gap_m"] = max(out["kf_gap_m"], float(gap))
        tracked = fr != start
        n_tracked += int(tracked.sum())
        n_miss += int((a["n_inliers_ls"][rows][tracked] == 0).sum())
    if ates:
        out["ate_m"] = max(ates)
        out["ate_med_m"] = float(np.median(ates))
        out["ate_p90_m"] = float(np.quantile(ates, 0.9))
    if has_lines:
        out["line_miss"] = n_miss / n_tracked if n_tracked else float("nan")
    return out


def judge_ba(program: dict, reference: dict) -> dict:
    """The BA's numbers (see the module's docstring).  program: {pass:
    [(frame indices, refined poses [K, 4, 4])]} as `observe` returned
    them; reference: {pass: [vobench.reference.window_ba.Window]} from the
    same keyframes."""
    gaps, degs, n_prog, same = [], [], 0, True
    for key in set(program) | set(reference):
        prog = {tuple(i): np.asarray(T, np.float64)
                for i, T in program.get(key, [])}
        ref = {w.idxs: w.T for w in reference.get(key, []) if w.refined}
        n_prog += len(prog)
        if set(prog) != set(ref):
            same = False
            continue
        for idxs, A in ref.items():
            T = prog[idxs]
            gaps.append(float(np.linalg.norm(T[:, :3, 3] - A[:, :3, 3],
                                             axis=-1).max()))
            degs.append(_rot_deg(T, A))
    n_ref = sum(w.refined for ws in reference.values() for w in ws)
    if not same:
        med = top = deg = float("inf")
    elif not gaps:
        med = top = deg = float("nan")
    else:
        med, top, deg = float(np.median(gaps)), max(gaps), max(degs)
    return dict(ba_gap_med_m=med, ba_gap_m=top, ba_gap_deg=deg,
                ba_windows=n_prog, ba_windows_ref=n_ref)


def _rot_deg(T: np.ndarray, A: np.ndarray) -> float:
    """The largest rotation angle between the poses of T and A [K, 4, 4]."""
    M = np.swapaxes(T[:, :3, :3], 1, 2) @ A[:, :3, :3]
    c = (np.trace(M, axis1=1, axis2=2) - 1.0) / 2.0
    s = np.linalg.norm(np.stack([M[:, 2, 1] - M[:, 1, 2],
                                 M[:, 0, 2] - M[:, 2, 0],
                                 M[:, 1, 0] - M[:, 0, 1]], -1), axis=-1) / 2
    return float(np.degrees(np.arctan2(s, c)).max())


def detail(frames: Frames, truth: np.ndarray) -> dict:
    """Distributions behind the numbers, for setting limits: per-pass ATE
    and per-frame motion error quantiles, and where the worst frame
    lies."""
    a = frames.arrays()
    ates, errs, at = [], [], []
    for start, fr, rows in _groups(a):
        est = a["Tfw"][rows]
        gt = relative(truth[fr], truth[start])
        if len(rows) >= MIN_ATE_FRAMES:
            ates.append(ate_rmse(est, gt))
        ok = np.diff(fr) == 1
        if ok.any():
            e = step_errors(est, gt)[ok]
            errs.append(e)
            at.append(np.stack([np.full(len(e), int(a["lane"][rows[0]])),
                                (fr[1:] - start)[ok]], axis=1))
    out = {}
    if ates:
        out["ate_q"] = np.quantile(ates, [0.5, 0.9, 1.0]).tolist()
    if errs:
        e, w = np.concatenate(errs), np.concatenate(at)
        out["step_err_q"] = np.quantile(e, [0.5, 0.99, 0.999, 1.0]).tolist()
        out["step_err_gt_0.1"] = float((e > 0.1).mean())
        worst = np.argsort(e)[-5:]
        out["worst_lane_frame"] = w[worst].tolist()
    return out


def failed_frames(frames: Frames) -> int:
    """Tracked lane-frames whose pose the program did not commit (its
    `good` flag false): frames the user gets no motion for."""
    a = frames.arrays()
    tracked = a["frame"] != a["pass_start"]
    return int((~a["good"].astype(bool) & tracked).sum())


def pass_disagreement(frames: Frames) -> dict:
    """How far the program's answers repeat: of the (lane, frame) cells
    met in two passes or more that started at the same frame (each from
    the initial state), `cells_differ` is the number whose `good` flag
    differs between those passes, and `pose_gap_m` the largest distance
    between the positions those passes answered."""
    a = frames.arrays()
    key = np.stack([a["lane"], a["pass_start"], a["frame"]],
                   1).astype(np.int64)
    _, first, inv, n = np.unique(key, axis=0, return_index=True,
                                 return_inverse=True, return_counts=True)
    inv = inv.reshape(-1)
    n_good = np.bincount(inv, weights=a["good"].astype(bool),
                         minlength=len(n))
    seen = n >= 2
    differ = seen & (n_good > 0) & (n_good < n)

    def cells(groups):
        return len(np.unique(key[first[groups]][:, [0, 2]], axis=0))

    t = a["Tfw"][:, :3, 3]
    gap = np.linalg.norm(t - t[first[inv]], axis=-1)
    return dict(cells_differ=cells(differ), cells_seen=cells(seen),
                pose_gap_m=float(gap.max()))


def verdict(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """(correct, {name: {"value", "limit"}}) over the numbers that have a
    limit; a number that is missing or not finite fails."""
    checks, ok = {}, True
    for name, limit in limits.items():
        value = numbers.get(name, float("nan"))
        finite = bool(np.isfinite(value))
        checks[name] = {"value": float(value) if finite else None,
                        "limit": limit}
        ok = ok and finite and value <= limit
    return ok, checks
