"""Trajectory evaluation: ATE / RPE (numpy copy of the JAX package's
stvo_pl_tpu/utils/metrics.py, standard KITTI/TUM definitions)."""

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
