"""SE(3) Lie-group functions, broadcast over leading batch dims.

Port of stvo_pl_tpu/ops/se3.py (reference src/auxiliar.cpp:29-197): twist
convention xi = [t(3), w(3)], branch-free small-angle blends under
`torch.where`.  Every product of small matrices goes through `mm`, which
multiplies and sums elementwise in float32: the result never depends on
the TF32 switches of the matrix-multiply backends.
"""

from __future__ import annotations

import torch


def mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """[..., n, k] @ [..., k, m] in full float32 (elementwise products and
    a sum over k; no tensor-core rounding)."""
    return torch.sum(a[..., :, :, None] * b[..., None, :, :], dim=-2)


def _eye(n: int, like: torch.Tensor) -> torch.Tensor:
    return torch.eye(n, dtype=like.dtype, device=like.device)


def _homog(top: torch.Tensor) -> torch.Tensor:
    """[..., 3, 4] -> [..., 4, 4] with bottom row [0, 0, 0, 1]."""
    bottom = torch.zeros_like(top[..., :1, :])
    bottom[..., 0, 3] = 1.0
    return torch.cat([top, bottom], dim=-2)


def skew(v: torch.Tensor) -> torch.Tensor:
    """[..., 3] -> [..., 3, 3] cross-product matrix."""
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    zero = torch.zeros_like(x)
    return torch.stack([
        torch.stack([zero, -z, y], dim=-1),
        torch.stack([z, zero, -x], dim=-1),
        torch.stack([-y, x, zero], dim=-1),
    ], dim=-2)


def _sinc_coeffs_from_sq(t2: torch.Tensor):
    """A = sin(t)/t, B = (1-cos(t))/t^2, C = (t-sin(t))/t^3 from t^2."""
    small = t2 < 1e-8
    t2s = torch.where(small, torch.ones_like(t2), t2)
    theta = torch.sqrt(t2s)
    A = torch.where(small, 1.0 - t2 / 6.0, torch.sin(theta) / theta)
    B = torch.where(small, 0.5 - t2 / 24.0, (1.0 - torch.cos(theta)) / t2s)
    C = torch.where(small, 1.0 / 6.0 - t2 / 120.0,
                    (theta - torch.sin(theta)) / (t2s * theta))
    return A, B, C


def expmap_se3(x: torch.Tensor) -> torch.Tensor:
    """[..., 6] twist [t, w] -> [..., 4, 4] transform."""
    t, w = x[..., :3], x[..., 3:]
    A, B, C = _sinc_coeffs_from_sq(torch.sum(w * w, dim=-1))
    W = skew(w)
    W2 = mm(W, W)
    I = _eye(3, x)
    R = I + A[..., None, None] * W + B[..., None, None] * W2
    V = I + B[..., None, None] * W + C[..., None, None] * W2
    Vt = mm(V, t[..., None])[..., 0]
    return _homog(torch.cat([R, Vt[..., None]], dim=-1))


def so3_log(R: torch.Tensor) -> torch.Tensor:
    """[..., 3, 3] -> [..., 3] rotation vector, finite over the whole group
    (theta ~ pi falls back to the diagonal formula)."""
    tr = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos = torch.clamp((tr - 1.0) * 0.5, -1.0, 1.0)
    a = torch.stack([
        R[..., 2, 1] - R[..., 1, 2],
        R[..., 0, 2] - R[..., 2, 0],
        R[..., 1, 0] - R[..., 0, 1],
    ], dim=-1)
    a_norm = torch.linalg.vector_norm(a, dim=-1)
    sin = 0.5 * a_norm
    theta = torch.atan2(sin, cos)

    small = theta < 1e-6
    near_pi = (a_norm < 2e-3) & (cos < 0.0)
    generic_scale = theta / torch.where(near_pi | small,
                                        torch.ones_like(a_norm), a_norm)
    w_generic = generic_scale[..., None] * a

    B = R + _eye(3, R)
    diag = torch.stack([B[..., 0, 0], B[..., 1, 1], B[..., 2, 2]], dim=-1)
    k = torch.argmax(diag, dim=-1)
    col = torch.gather(B, -1, k[..., None, None].expand(
        B.shape[:-1] + (1,)))[..., 0]
    col_norm = torch.linalg.vector_norm(col, dim=-1, keepdim=True)
    axis = col / torch.clamp(col_norm, min=1e-12)
    sign = torch.where(torch.sum(axis * a, dim=-1) < 0, -1.0, 1.0).to(R.dtype)
    w_pi = (theta * sign)[..., None] * axis

    return torch.where(small[..., None], 0.5 * a,
                       torch.where(near_pi[..., None], w_pi, w_generic))


def logmap_se3(T: torch.Tensor) -> torch.Tensor:
    """[..., 4, 4] -> [..., 6] twist [t, w]."""
    R = T[..., :3, :3]
    p = T[..., :3, 3]
    w = so3_log(R)
    theta = torch.linalg.vector_norm(w, dim=-1)
    W = skew(w)
    W2 = mm(W, W)
    cos = torch.cos(theta)
    sin = torch.sin(theta)
    small = theta < 1e-4
    ts = torch.where(small, torch.ones_like(theta), theta)
    coef = torch.where(
        small,
        1.0 / 12.0 + theta * theta / 720.0,
        1.0 / (ts * ts) - (1.0 + cos) / (2.0 * ts * sin + 1e-30))
    Vinv = _eye(3, T) - 0.5 * W + coef[..., None, None] * W2
    t = mm(Vinv, p[..., None])[..., 0]
    return torch.cat([t, w], dim=-1)


def inverse_se3(T: torch.Tensor) -> torch.Tensor:
    """[..., 4, 4] rigid inverse."""
    Rt = T[..., :3, :3].transpose(-1, -2)
    tinv = -mm(Rt, T[..., :3, 3:4])
    return _homog(torch.cat([Rt, tinv], dim=-1))


def adjoint_se3(T: torch.Tensor) -> torch.Tensor:
    """[..., 4, 4] -> [..., 6, 6] adjoint."""
    R = T[..., :3, :3]
    tR = mm(skew(T[..., :3, 3]), R)
    Z = torch.zeros_like(R)
    top = torch.cat([R, tR], dim=-1)
    bottom = torch.cat([Z, R], dim=-1)
    return torch.cat([top, bottom], dim=-2)


def uncTinv_se3(T: torch.Tensor, covT: torch.Tensor) -> torch.Tensor:
    """Covariance of T^{-1}: Adj(T^{-1}) covT Adj(T^{-1})^T."""
    adj = adjoint_se3(inverse_se3(T))
    return mm(mm(adj, covT), adj.transpose(-1, -2))


def unccomp_se3(T1: torch.Tensor, covT1: torch.Tensor,
                covTinc: torch.Tensor) -> torch.Tensor:
    """Covariance composition for T2 = T1 * inv(Tinc)."""
    adj = adjoint_se3(T1)
    return covT1 + mm(mm(adj, covTinc), adj.transpose(-1, -2))


def transform_points(T: torch.Tensor, P: torch.Tensor) -> torch.Tensor:
    """Apply [..., 4, 4] to points [..., N, 3] -> [..., N, 3]."""
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    return mm(P, R.transpose(-1, -2)) + t[..., None, :]


def renormalize_se3(T: torch.Tensor) -> torch.Tensor:
    """expmap(logmap(T)): project back onto SE(3)."""
    return expmap_se3(logmap_se3(T))


def is_finite_mat(M: torch.Tensor) -> torch.Tensor:
    """All-finite predicate per batch element."""
    flat = M.reshape(M.shape[:-2] + (-1,)) if M.ndim >= 2 else M
    return torch.all(torch.isfinite(flat), dim=-1)
