"""Windowed bundle adjustment with Schur-complement reduction (port of
stvo_pl_tpu/parallel/ba.py): `ba_solve` on one device, `make_sharded_ba`
with the landmarks split over the ranks of a mesh's data axis.

Jointly refines a window of K keyframe poses against N tracked POINT
landmarks and Nl tracked LINE landmarks:

  * point residual r_ik = proj(T_k^w->c X_i) - obs_ik (stereo u_l, v, u_r);
  * line residual: the signed distance of each projected 3-D endpoint to
    the OBSERVED infinite line, le . [u, v, 1], weighted by Cauchy x
    segment overlap (the pose optimizer's endpoint-to-line error,
    reference src/stereoFrameHandler.cpp:610-684).  Each endpoint enters
    the normal equations as its own 3-DoF landmark block; sliding along
    the 3-D line is unobservable and the scale-aware damping freezes it;
  * normal equations split into pose blocks Hpp (6x6 per pose), landmark
    blocks Hll (3x3 per landmark or endpoint) and couplings U_ik; the
    reduced camera system S = Hpp - U Hll^-1 U^T is dense [6K, 6K].

Gauge: pose 0 is held fixed.  Robust Cauchy weights on the reprojection
residual (reference src/auxiliar.cpp:556-559).

Precision: every contraction is float32 with no TF32.  On a CUDA device
`ba_solve` refuses to run unless `torch.get_float32_matmul_precision()`
is "highest" and `torch.backends.cuda.matmul.allow_tf32` is False.  The
landmark blocks are inverted by the closed-form adjugate, which stays
finite at the conditioning that the damping exists for.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.distributed as dist

from stvo_pl_tpu_torch.models.optimizer import segment_overlap
from stvo_pl_tpu_torch.ops import camera as cam_ops
from stvo_pl_tpu_torch.ops import robust, se3
from stvo_pl_tpu_torch.parallel.compiled import Compiled, compile_fn
from stvo_pl_tpu_torch.parallel.mesh import DATA_AXIS, axis, mesh_device


class BAProblem(NamedTuple):
    X: torch.Tensor        # [N, 3] landmark positions (window/world frame)
    obs: torch.Tensor      # [N, K, 3] stereo observations (u_l, v, u_r)
    mask: torch.Tensor     # [N, K] bool: landmark i observed in keyframe k
    sigma2: torch.Tensor   # [N] per-landmark measurement variance factor
    # --- line landmarks (None when the problem is points-only) ----------
    Xl: torch.Tensor | None = None       # [Nl, 2, 3] 3-D endpoints (world)
    obs_l: torch.Tensor | None = None    # [Nl, K, 7] (a, b, c, sx, sy, ex,
    #   ey): observed infinite line (|(a,b)|=1) + observed 2-D endpoints
    mask_l: torch.Tensor | None = None   # [Nl, K]
    sigma2_l: torch.Tensor | None = None  # [Nl]


def check_precision(t: torch.Tensor) -> None:
    """Raise unless float32 products on t's device are full float32."""
    if t.device.type != "cuda":
        return
    if (torch.get_float32_matmul_precision() != "highest"
            or torch.backends.cuda.matmul.allow_tf32):
        raise RuntimeError(
            "stvo_pl_tpu_torch BA needs full float32 products: set "
            "torch.set_float32_matmul_precision('highest') and "
            "torch.backends.cuda.matmul.allow_tf32 = False")


def _inv3(M: torch.Tensor) -> torch.Tensor:
    """Batched closed-form 3x3 inverse (adjugate / det), det clamped."""
    a, b, c = M[..., 0, 0], M[..., 0, 1], M[..., 0, 2]
    d, e, f = M[..., 1, 0], M[..., 1, 1], M[..., 1, 2]
    g, h, i = M[..., 2, 0], M[..., 2, 1], M[..., 2, 2]
    A = e * i - f * h
    B = -(d * i - f * g)
    C = d * h - e * g
    det = a * A + b * B + c * C
    tiny = torch.where(det < 0, -1e-20, 1e-20).to(det.dtype)
    det = torch.where(torch.abs(det) < 1e-20, tiny, det)
    adj = torch.stack([
        torch.stack([A, -(b * i - c * h), b * f - c * e], dim=-1),
        torch.stack([B, a * i - c * g, -(a * f - c * d)], dim=-1),
        torch.stack([C, -(a * h - b * g), a * e - b * d], dim=-1),
    ], dim=-2)
    return adj / det[..., None, None]


def _residuals_jacobians(poses_cw: torch.Tensor, X: torch.Tensor,
                         obs: torch.Tensor, cam: cam_ops.StereoCamera):
    """poses_cw: [K, 4, 4] world->camera.  Returns the stereo residual
    [N, K, 3] (left u, v, right u), pose Jacobian A [N, K, 3, 6] (left
    perturbation of the world->camera transform) and landmark Jacobian B
    [N, K, 3, 3].  The right-camera u pins the window's metric scale."""
    R = poses_cw[:, :3, :3]                       # [K, 3, 3]
    t = poses_cw[:, :3, 3]
    Pc = torch.einsum("kab,nb->nka", R, X) + t[None]
    z = Pc[..., 2]
    z_safe = torch.where(torch.abs(z) < 1e-6, torch.full_like(z, 1e-6), z)
    u = cam.cx + cam.fx * Pc[..., 0] / z_safe
    v = cam.cy + cam.fy * Pc[..., 1] / z_safe
    u_r = cam.cx + cam.fx * (Pc[..., 0] - cam.b) / z_safe
    r = torch.stack([u, v, u_r], dim=-1) - obs    # [N, K, 3]

    x, y = Pc[..., 0], Pc[..., 1]
    iz = 1.0 / z_safe
    iz2 = iz * iz
    fx, fy = cam.fx, cam.fy
    zero = torch.zeros_like(z)
    # d (u, v, u_r) / d Pc  [N, K, 3, 3]
    Jp = torch.stack([
        torch.stack([fx * iz, zero, -fx * x * iz2], dim=-1),
        torch.stack([zero, fy * iz, -fy * y * iz2], dim=-1),
        torch.stack([fx * iz, zero, -fx * (x - cam.b) * iz2], dim=-1),
    ], dim=-2)
    # left perturbation: d Pc / d xi = [I | -[Pc]x]
    A_w = -torch.einsum("nkij,nkjl->nkil", Jp, se3.skew(Pc))
    A = torch.cat([Jp, A_w], dim=-1)              # [N, K, 3, 6]
    B = torch.einsum("nkij,kjl->nkil", Jp, R)     # d Pc / d X = R_k
    return r, A, B


def _line_residuals_jacobians(poses_cw: torch.Tensor, Xl: torch.Tensor,
                              obs_l: torch.Tensor,
                              cam: cam_ops.StereoCamera):
    """Endpoint-to-observed-infinite-line residuals.  Xl [Nl, 2, 3] world
    endpoints, obs_l [Nl, K, 7].  Returns r [Nl, K, 2], pose Jacobian A
    [Nl, K, 2, 6], endpoint Jacobian B [Nl, K, 2, 3] (row j against
    endpoint j only), projected endpoints [Nl, K, 2, 2] and depth z
    [Nl, K, 2]."""
    R = poses_cw[:, :3, :3]
    t = poses_cw[:, :3, 3]
    Pc = torch.einsum("kab,njb->nkja", R, Xl) + t[None, :, None]
    z = Pc[..., 2]
    z_safe = torch.where(torch.abs(z) < 1e-6, torch.full_like(z, 1e-6), z)
    u = cam.cx + cam.fx * Pc[..., 0] / z_safe
    v = cam.cy + cam.fy * Pc[..., 1] / z_safe
    le = obs_l[..., :3]                           # [Nl, K, 3]
    a_, b_, c_ = le[..., 0:1], le[..., 1:2], le[..., 2:3]
    r = a_ * u + b_ * v + c_                      # [Nl, K, 2]

    iz = 1.0 / z_safe
    iz2 = iz * iz
    g = torch.stack([
        a_ * cam.fx * iz,
        b_ * cam.fy * iz,
        -(a_ * cam.fx * Pc[..., 0] + b_ * cam.fy * Pc[..., 1]) * iz2,
    ], dim=-1)                                    # d r / d Pc
    gw = -torch.einsum("nkji,nkjil->nkjl", g, se3.skew(Pc))
    A = torch.cat([g, gw], dim=-1)                # [Nl, K, 2, 6]
    B = torch.einsum("nkji,kil->nkjl", g, R)      # [Nl, K, 2, 3]
    proj = torch.stack([u, v], dim=-1)            # [Nl, K, 2, 2]
    return r, A, B, proj, z


def _schur_partials(r, A, B, w):
    """Per-landmark normal-equation partials.  Every residual row of
    element m couples pose k and landmark m: r [M, K, a], A [M, K, a, 6],
    B [M, K, a, 3], w [M, K] (already masked)."""
    Aw = A * w[..., None, None]
    Bw = B * w[..., None, None]
    Hpp = torch.einsum("mkai,mkaj->kij", Aw, A)   # [K, 6, 6]
    Hll = torch.einsum("mkai,mkaj->mij", Bw, B)   # [M, 3, 3]
    U = torch.einsum("mkai,mkaj->mkij", Aw, B)    # [M, K, 6, 3]
    bp = -torch.einsum("mkai,mka->ki", Aw, r)     # [K, 6]
    bl = -torch.einsum("mkai,mka->mi", Bw, r)     # [M, 3]
    return Hpp, Hll, U, bp, bl


def _invert_landmark_blocks(Hll):
    """Damp + invert landmark blocks.  A landmark seen once has a rank-2
    (points) or rank-1 (line endpoints) block; the scale-aware damping
    keeps the adjugate inverse finite in float32, and null directions get
    a ~1e3-damped, effectively frozen, update."""
    I3 = torch.eye(3, dtype=Hll.dtype, device=Hll.device)
    tr = Hll[..., 0, 0] + Hll[..., 1, 1] + Hll[..., 2, 2]
    lam = 1e-3 * tr / 3.0 + 1e-6
    return _inv3(Hll + lam[:, None, None] * I3)


def _schur_reduce(Hll_inv, U, bl):
    """S_red[k, l] = sum_m U_mk Hll_m^-1 U_ml^T and its rhs."""
    UHinv = torch.einsum("mkij,mjl->mkil", U, Hll_inv)
    S_red = torch.einsum("mkil,mnjl->kinj", UHinv, U)
    b_red = torch.einsum("mkij,mj->ki", UHinv, bl)
    return S_red, b_red, UHinv


def _point_system(poses_cw, prob: BAProblem, cam, kernel):
    r, A, B = _residuals_jacobians(poses_cw, prob.X, prob.obs, cam)
    rn = torch.linalg.vector_norm(r, dim=-1)      # [N, K]
    w = robust.robust_weight(rn * torch.sqrt(prob.sigma2)[:, None], kernel)
    w = torch.where(prob.mask, w, torch.zeros_like(w))
    Hpp, Hll, U, bp, bl = _schur_partials(r, A, B, w)
    cost = torch.sum(w * rn * rn)
    nobs = torch.sum(w > 0)
    return Hpp, Hll, U, bp, bl, cost, nobs


def _line_system(poses_cw, prob: BAProblem, cam, kernel):
    """Line landmarks flattened to independent per-endpoint 3-DoF blocks
    (M = 2 Nl, one residual row each)."""
    r, A, B, proj, z = _line_residuals_jacobians(poses_cw, prob.Xl,
                                                 prob.obs_l, cam)
    rn = torch.linalg.vector_norm(r, dim=-1)      # [Nl, K]
    w = robust.robust_weight(rn * torch.sqrt(prob.sigma2_l)[:, None], kernel)
    # segment-overlap factor like the pose optimizer (reference :672-676)
    ov = segment_overlap(prob.obs_l[..., 3:5], prob.obs_l[..., 5:7],
                         proj[:, :, 0], proj[:, :, 1])
    w = torch.where(prob.mask_l & torch.all(z > 0.1, dim=-1), w * ov,
                    torch.zeros_like(w))
    cost = torch.sum(w * rn * rn)
    nobs = torch.sum(w > 0)

    Nl, K = rn.shape
    # endpoint-flatten: row j of line i -> element m = 2 i + j
    r2 = r.transpose(1, 2).reshape(2 * Nl, K, 1)
    A2 = A.transpose(1, 2).reshape(2 * Nl, K, 1, 6)
    B2 = B.transpose(1, 2).reshape(2 * Nl, K, 1, 3)
    w2 = w[:, None, :].expand(Nl, 2, K).reshape(2 * Nl, K)
    Hpp, Hll, U, bp, bl = _schur_partials(r2, A2, B2, w2)
    return Hpp, Hll, U, bp, bl, cost, nobs


def point_chi2(poses_cw, prob: BAProblem, cam, kernel="cauchy"):
    """Robust point-residual chi-square of a window solution: the
    acceptance statistic of the automatic line-trust policy (the
    window-level analogue of isGoodSolution,
    src/stereoFrameHandler.cpp:292-305).  Returns (cost, nobs)."""
    _, _, _, _, _, cost, nobs = _point_system(poses_cw, prob, cam, kernel)
    return cost, nobs


def _reduced_system(poses_cw, prob: BAProblem, cam, kernel="cauchy"):
    """The Schur-reduced camera system (S [K, 6, K, 6], b [K, 6]) plus the
    per-type landmark blocks for back-substitution."""
    K = poses_cw.shape[0]
    Hpp, Hll, U, bp, bl, cost, nobs = _point_system(poses_cw, prob, cam,
                                                    kernel)
    Hll_inv = _invert_landmark_blocks(Hll)
    S_red, b_red, _ = _schur_reduce(Hll_inv, U, bl)
    aux_l = None
    if prob.Xl is not None:
        Hpp_l, Hll_l, U_l, bp_l, bl_l, cost_l, nobs_l = _line_system(
            poses_cw, prob, cam, kernel)
        Hll_inv_l = _invert_landmark_blocks(Hll_l)
        S_red_l, b_red_l, _ = _schur_reduce(Hll_inv_l, U_l, bl_l)
        Hpp = Hpp + Hpp_l
        bp = bp + bp_l
        S_red = S_red + S_red_l
        b_red = b_red + b_red_l
        cost = cost + cost_l
        nobs = nobs + nobs_l
        aux_l = (Hll_inv_l, U_l, bl_l)

    S = -S_red
    k = torch.arange(K, device=S.device)
    S[k, :, k, :] = S[k, :, k, :] + Hpp
    b = bp - b_red
    return S, b, (Hll_inv, U, bl), aux_l, cost, nobs


def _apply_pose_update(poses_cw, dxi):
    """Left-multiplicative update exp(dxi_k) T_k, pose 0 pinned."""
    dxi = torch.cat([torch.zeros_like(dxi[:1]), dxi[1:]])
    return se3.mm(se3.expmap_se3(dxi), poses_cw)


def _solve_reduced(S, b, damping, K):
    """Solve the gauge-fixed reduced camera system for the pose update.
    No host sync: `solve_ex` leaves its status on the device (a singular
    system gives non-finite poses, as on the JAX package's device), so
    the solve can be captured in a CUDA graph."""
    n = 6 * K
    eye = torch.eye(n, dtype=S.dtype, device=S.device)
    S2 = S.reshape(n, n) + damping * eye
    # gauge fix: pin pose 0 by clearing its rows/cols and setting identity
    idx = torch.arange(n, device=S.device)
    pin = idx < 6
    S2 = torch.where(pin[:, None] | pin[None, :], eye, S2)
    b2 = torch.where(pin, torch.zeros_like(pin, dtype=b.dtype),
                     b.reshape(-1))
    return torch.linalg.solve_ex(S2, b2).result.reshape(K, 6)


def _back_substitute(aux, dxi, X, mask):
    """dX_m = Hll_m^-1 (bl_m - sum_k U_mk^T dxi_k), frozen where unseen."""
    Hll_inv, U, bl = aux
    Ud = torch.einsum("mkij,ki->mj", U, dxi)
    dX = torch.einsum("mij,mj->mi", Hll_inv, bl - Ud)
    seen = torch.any(mask, dim=1)
    return X + torch.where(seen[:, None], dX, torch.zeros_like(dX))


def _update(poses_cw, prob: BAProblem, S, b, aux_p, aux_l, damping,
            update_landmarks=True):
    """Solve the reduced system for the pose update, apply it and
    back-substitute the landmarks.  Returns (poses, X, Xl)."""
    K = poses_cw.shape[0]
    dxi = _solve_reduced(S, b, damping, K)
    poses_new = _apply_pose_update(poses_cw, dxi)
    X_new, Xl_new = prob.X, prob.Xl
    if update_landmarks:
        X_new = _back_substitute(aux_p, dxi, prob.X, prob.mask)
        if aux_l is not None:
            Nl = prob.Xl.shape[0]
            mask_ep = prob.mask_l[:, None, :].expand(
                Nl, 2, prob.mask_l.shape[1]).reshape(2 * Nl, -1)
            Xl_flat = _back_substitute(aux_l, dxi, prob.Xl.reshape(2 * Nl, 3),
                                       mask_ep)
            Xl_new = Xl_flat.reshape(Nl, 2, 3)
    return poses_new, X_new, Xl_new


def ba_iteration(poses_cw, prob: BAProblem, cam, damping=1e-4,
                 kernel="cauchy", update_landmarks=True):
    """One GN/LM step of windowed BA.  Returns (poses, X, Xl, cost); Xl is
    None for points-only problems."""
    S, b, aux_p, aux_l, cost, _ = _reduced_system(poses_cw, prob, cam,
                                                  kernel)
    return (*_update(poses_cw, prob, S, b, aux_p, aux_l, damping,
                     update_landmarks), cost)


def ba_solve(poses_cw, prob: BAProblem, cam, n_iters: int = 8,
             damping: float = 1e-4, kernel: str = "cauchy",
             update_landmarks: bool = True):
    """n_iters of windowed BA on the device of the inputs.  Returns
    (poses, X, Xl_or_None, costs [n_iters])."""
    check_precision(poses_cw)
    poses, X, Xl = poses_cw, prob.X, prob.Xl
    costs = []
    for _ in range(n_iters):
        poses, X, Xl, cost = ba_iteration(
            poses, prob._replace(X=X, Xl=Xl), cam, damping, kernel,
            update_landmarks)
        costs.append(cost)
    return poses, X, Xl, torch.stack(costs)


def compile_ba_solve(cam, n_iters: int = 8, damping: float = 1e-4,
                     kernel: str = "cauchy", update_landmarks: bool = True,
                     device=None) -> Compiled:
    """`ba_solve` as a captured program on `device` ("cuda" unless the
    caller asks for the CPU), one graph per problem structure and shape:
    `solve(poses_cw, prob) -> (poses, X, Xl_or_None, costs)`, equal to
    `ba_solve` bit for bit.  `damping`, a traced scalar of the JAX
    package's `ba_solve`, is fixed for the program's life here."""
    return compile_fn(ba_solve, ("poses_cw", "prob"), device, cam=cam,
                      n_iters=n_iters, damping=damping, kernel=kernel,
                      update_landmarks=update_landmarks)


def make_sharded_ba(mesh, cam, n_iters: int = 8, damping: float = 1e-4,
                    kernel: str = "cauchy", has_lines: bool = False):
    """Distributed windowed BA: landmarks sharded over the mesh's data
    axis (port of stvo_pl_tpu/parallel/ba.py:356-419).

    Returns `solve(poses_cw, X, obs, mask, sigma2[, Xl, obs_l, mask_l,
    sigma2_l])`, called by every rank with the whole problem (the window
    refiner builds it on each).  A rank keeps its contiguous 1/n_data of
    the point (and line) landmarks; per iteration it builds its partial
    reduced system S, b and cost, one all-reduce (SUM) over the data
    group sums them (packed into one buffer), every rank solves the
    [6K, 6K] system (cheaper than a gather), and the landmark update stays
    local.  Returns (poses, X_shard, costs) or, with has_lines, (poses,
    X_shard, Xl_shard, costs): the poses and costs are the same on every
    rank, the landmarks this rank's rows.  A landmark count that n_data
    does not divide raises ValueError on the first call, before the body
    does any device work.

    `solve` is a captured program on the mesh's device
    (parallel/compiled.py), one graph per problem shape with its n_iters
    all-reduces inside, the counterpart of the JAX package's
    `jax.jit(sharded)`; `solve.fn` is its eager body."""
    group, n_data, rank = axis(mesh, DATA_AXIS)

    def shard(name, *xs):
        n = xs[0].shape[0]
        if n % n_data != 0:
            raise ValueError(f"{n} {name} landmarks do not split over "
                             f"{n_data} data-axis ranks")
        m = n // n_data
        return [x[rank * m:(rank + 1) * m] for x in xs]

    def one_iter(poses_cw, prob: BAProblem):
        S, b, aux_p, aux_l, cost, _ = _reduced_system(poses_cw, prob, cam,
                                                      kernel)
        flat = torch.cat([S.reshape(-1), b.reshape(-1), cost.reshape(1)])
        if group is not None:
            dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=group)
        nS = S.numel()
        S = flat[:nS].reshape(S.shape)
        b = flat[nS:nS + b.numel()].reshape(b.shape)
        return (*_update(poses_cw, prob, S, b, aux_p, aux_l, damping),
                flat[-1])

    def solve(poses_cw, X, obs, mask, sigma2,
              Xl=None, obs_l=None, mask_l=None, sigma2_l=None):
        check_precision(poses_cw)
        X, obs, mask, sigma2 = shard("point", X, obs, mask, sigma2)
        if has_lines:
            Xl, obs_l, mask_l, sigma2_l = shard("line", Xl, obs_l, mask_l,
                                                sigma2_l)
        else:
            Xl = obs_l = mask_l = sigma2_l = None
        prob = BAProblem(X=X, obs=obs, mask=mask, sigma2=sigma2, Xl=Xl,
                         obs_l=obs_l, mask_l=mask_l, sigma2_l=sigma2_l)
        poses, costs = poses_cw, []
        for _ in range(n_iters):
            poses, X2, Xl2, cost = one_iter(poses, prob)
            prob = prob._replace(X=X2, Xl=Xl2)
            costs.append(cost)
        if has_lines:
            return poses, prob.X, prob.Xl, torch.stack(costs)
        return poses, prob.X, torch.stack(costs)

    return Compiled(solve, mesh_device(mesh),
                    groups=() if group is None else (group,))
