"""Trajectory evaluation and I/O: ATE / RPE, TUM and KITTI trajectory
files, timestamp association (numpy copy of stvo_pl_tpu/utils/metrics.py,
standard KITTI/TUM definitions)."""

from __future__ import annotations

import numpy as np


def umeyama_alignment(X: np.ndarray, Y: np.ndarray, with_scale=False):
    """Least-squares similarity/rigid transform aligning X -> Y.

    X, Y: [N, 3].  Returns (s, R, t) with Y ~ s R X + t.
    """
    mx = X.mean(0)
    my = Y.mean(0)
    Xc = X - mx
    Yc = Y - my
    C = Yc.T @ Xc / len(X)
    U, D, Vt = np.linalg.svd(C)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1
    R = U @ S @ Vt
    if with_scale:
        var = (Xc ** 2).sum() / len(X)
        s = float(np.trace(np.diag(D) @ S) / var)
    else:
        s = 1.0
    t = my - s * R @ mx
    return s, R, t


def ate_rmse(est_poses: np.ndarray, gt_poses: np.ndarray,
             align: bool = True) -> float:
    """Absolute trajectory error (RMSE of translation) after rigid
    alignment; est_poses, gt_poses: [T, 4, 4] camera-to-world."""
    Xe = est_poses[:, :3, 3]
    Xg = gt_poses[:, :3, 3]
    if align:
        s, R, t = umeyama_alignment(Xe, Xg)
        Xa = (s * (R @ Xe.T)).T + t
    else:
        Xa = Xe
    return float(np.sqrt(np.mean(np.sum((Xa - Xg) ** 2, axis=-1))))


def rpe(est_poses: np.ndarray, gt_poses: np.ndarray, delta: int = 1):
    """Relative pose error over a frame delta: (trans_rmse [m],
    rot_rmse [deg])."""
    t_errs, r_errs = [], []
    for i in range(len(est_poses) - delta):
        de = np.linalg.inv(est_poses[i]) @ est_poses[i + delta]
        dg = np.linalg.inv(gt_poses[i]) @ gt_poses[i + delta]
        err = np.linalg.inv(dg) @ de
        t_errs.append(np.linalg.norm(err[:3, 3]))
        c = np.clip((np.trace(err[:3, :3]) - 1.0) / 2.0, -1.0, 1.0)
        r_errs.append(np.degrees(np.arccos(c)))
    return (float(np.sqrt(np.mean(np.square(t_errs)))),
            float(np.sqrt(np.mean(np.square(r_errs)))))


def trajectory_length(poses: np.ndarray) -> float:
    d = np.diff(poses[:, :3, 3], axis=0)
    return float(np.linalg.norm(d, axis=-1).sum())


def write_tum(path: str, poses: np.ndarray, stamps=None):
    """TUM trajectory format: t x y z qx qy qz qw."""
    from scipy.spatial.transform import Rotation
    with open(path, "w") as f:
        for i, T in enumerate(poses):
            q = Rotation.from_matrix(T[:3, :3]).as_quat()
            ts = i if stamps is None else stamps[i]
            f.write(f"{ts} {T[0,3]} {T[1,3]} {T[2,3]} "
                    f"{q[0]} {q[1]} {q[2]} {q[3]}\n")


def write_kitti(path: str, poses: np.ndarray):
    """KITTI trajectory format: 12 floats per row (3x4 row-major)."""
    with open(path, "w") as f:
        for T in poses:
            f.write(" ".join(f"{v:.9e}" for v in T[:3, :4].reshape(-1))
                    + "\n")


def read_kitti(path: str) -> np.ndarray:
    """KITTI trajectory file (12 floats per row) -> [T, 4, 4]."""
    rows = np.loadtxt(path).reshape(-1, 3, 4)
    poses = np.tile(np.eye(4), (len(rows), 1, 1))
    poses[:, :3, :4] = rows
    return poses


def read_tum(path: str, return_stamps: bool = False):
    """TUM trajectory file (t x y z qx qy qz qw) -> [T, 4, 4].

    Quaternions are normalized before conversion (real mocap GT files can
    carry rounding drift).  With ``return_stamps=True`` also returns the
    timestamp column [T] so callers can associate by time — real TUM
    groundtruth.txt files are asynchronous ~100 Hz mocap, NOT one row per
    camera frame.
    """
    from scipy.spatial.transform import Rotation
    rows = np.loadtxt(path, comments="#").reshape(-1, 8)
    poses = np.tile(np.eye(4), (len(rows), 1, 1))
    poses[:, :3, 3] = rows[:, 1:4]
    q = rows[:, 4:8]
    q = q / np.maximum(np.linalg.norm(q, axis=-1, keepdims=True), 1e-12)
    poses[:, :3, :3] = Rotation.from_quat(q).as_matrix()
    if return_stamps:
        return poses, rows[:, 0].copy()
    return poses


def read_trajectory(path: str, return_stamps: bool = False):
    """Load a trajectory file, auto-detecting KITTI (12 cols) vs TUM
    (8 cols) layout.

    With ``return_stamps=True`` returns ``(poses, stamps_or_None)`` —
    stamps are None for KITTI files (which are strictly one row per frame
    and carry no time column).
    """
    first = np.loadtxt(path, comments="#", max_rows=1)
    n = first.size
    if n == 12:
        poses = read_kitti(path)
        return (poses, None) if return_stamps else poses
    if n == 8:
        return read_tum(path, return_stamps=return_stamps)
    raise ValueError(f"{path}: expected 12 (KITTI) or 8 (TUM) columns, "
                     f"got {n}")


def associate_by_stamps(gt_stamps: np.ndarray, frame_stamps: np.ndarray,
                        max_dt: float = 0.02) -> np.ndarray:
    """Nearest-neighbor association of GT rows to frame timestamps.

    Returns an index array [T] into gt_stamps, one GT row per frame.
    Raises ValueError when the stamp ranges do not overlap (unit mismatch,
    e.g. ns vs s) or when the median match distance exceeds ``max_dt`` —
    silently wrong association is worse than refusing.
    """
    gt_stamps = np.asarray(gt_stamps, dtype=np.float64)
    frame_stamps = np.asarray(frame_stamps, dtype=np.float64)
    lo = max(gt_stamps.min(), frame_stamps.min())
    hi = min(gt_stamps.max(), frame_stamps.max())
    if hi < lo:
        raise ValueError(
            "GT and frame timestamp ranges do not overlap "
            f"(gt [{gt_stamps.min():.3f}, {gt_stamps.max():.3f}] vs frames "
            f"[{frame_stamps.min():.3f}, {frame_stamps.max():.3f}]) — "
            "check units (ns vs s)")
    order = np.argsort(gt_stamps)
    pos = np.searchsorted(gt_stamps[order], frame_stamps)
    pos = np.clip(pos, 1, len(gt_stamps) - 1)
    left = order[pos - 1]
    right = order[np.minimum(pos, len(gt_stamps) - 1)]
    pick_right = (np.abs(gt_stamps[right] - frame_stamps)
                  < np.abs(gt_stamps[left] - frame_stamps))
    idx = np.where(pick_right, right, left)
    dts = np.abs(gt_stamps[idx] - frame_stamps)
    if np.median(dts) > max_dt:
        raise ValueError(
            f"timestamp association too loose (median |dt| "
            f"{np.median(dts):.4f} s > {max_dt} s)")
    return idx
