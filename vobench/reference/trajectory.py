"""Trajectory error arithmetic in float64 numpy.

`umeyama_alignment` and `ate_rmse` are frozen copies of
`stvo_pl_tpu_torch/utils/metrics.py:10-47` (the standard KITTI / TUM
definitions), so that no later change of the program moves the yardstick.
"""

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


def relative(poses: np.ndarray, start: np.ndarray) -> np.ndarray:
    """Poses [T, 4, 4] expressed in the frame of `start` [4, 4]."""
    return np.linalg.inv(start)[None] @ poses


def step_errors(est: np.ndarray, gt: np.ndarray) -> np.ndarray:
    """Translation error [m] of each frame-to-frame motion of `est`
    against `gt` ([T, 4, 4] each): T - 1 values."""
    de = np.linalg.inv(est[:-1]) @ est[1:]
    dg = np.linalg.inv(gt[:-1]) @ gt[1:]
    err = np.linalg.inv(dg) @ de
    return np.linalg.norm(err[:, :3, 3], axis=-1)
