"""Robust 6-DoF pose optimization over matched point + line features,
batched over a leading lane axis (port of stvo_pl_tpu/models/optimizer.py;
reference src/stereoFrameHandler.cpp:307-1067).

  * residuals and Jacobians for all features at once, invalid lanes
    weighted 0; H = J^T W J and g = J^T W r as float32 sums;
  * each `lax.while_loop` of the reference is a loop of `max_iters` steps
    with a per-lane done mask: a lane whose status left 0 keeps its carry,
    so the early-exit semantics survive without a host sync;
  * the good/bad-solution branch of optimizePose computes both branches
    and selects per lane.

The update side matches the Jacobian convention (expmap(dx)^{-1} * DT),
the JAX package's deliberate fix of the reference's right-multiplied
update (see its module docstring): true Gauss-Newton with quadratic
convergence to the same optimum.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from stvo_pl_tpu_torch.config import VOConfig
from stvo_pl_tpu_torch.models.features import LineMatches, PointMatches
from stvo_pl_tpu_torch.ops import linalg, pose_optim, robust, se3

SQRT_CHI2_995_3DOF = 2.7955  # sqrt(7.815), robust-scale clamp
_BIG_ERR = 999999999.9


class OptimResult(NamedTuple):
    DT: torch.Tensor        # [..., 4, 4]
    cov: torch.Tensor       # [..., 6, 6]
    err: torch.Tensor       # [...]; -1 flags failure
    iters: torch.Tensor     # [...] int32


def _sel(mask: torch.Tensor, a: torch.Tensor, b: torch.Tensor):
    """Per-lane select: mask [...] broadcast over a's trailing dims."""
    m = mask.reshape(mask.shape + (1,) * (a.ndim - mask.ndim))
    return torch.where(m, a, b)


def _safe_project(cam, P_):
    z = P_[..., 2]
    z_safe = torch.where(torch.abs(z) < 1e-6, torch.full_like(z, 1e-6), z)
    u = cam.cx + cam.fx * P_[..., 0] / z_safe
    v = cam.cy + cam.fy * P_[..., 1] / z_safe
    return torch.stack([u, v], dim=-1)


def _point_jac(gx, gy, gz, lx, ly, fx, homog_th):
    fgz2 = fx / torch.clamp(gz * gz, min=homog_th)
    return torch.stack([
        + fgz2 * lx * gz,
        + fgz2 * ly * gz,
        - fgz2 * (gx * lx + gy * ly),
        - fgz2 * (gx * gy * lx + gy * gy * ly + gz * gz * ly),
        + fgz2 * (gx * gx * lx + gz * gz * lx + gx * gy * ly),
        + fgz2 * (gx * gz * ly - gy * gz * lx),
    ], dim=-1)


def _point_terms(DT, pm: PointMatches, cam, homog_th):
    """Per-point residual norm, unit-residual Jacobian, active mask."""
    P_ = se3.transform_points(DT, pm.P)
    err = _safe_project(cam, P_) - pm.obs
    err_norm = torch.linalg.vector_norm(err, dim=-1)
    J = _point_jac(P_[..., 0], P_[..., 1], P_[..., 2], err[..., 0],
                   err[..., 1], cam.fx, homog_th)
    J = J / torch.clamp(err_norm, min=homog_th)[..., None]
    return err_norm, J, pm.valid & pm.inlier


def segment_overlap(sp_obs, ep_obs, sp_proj, ep_proj):
    """[0, 1] overlap of the projected segment's parameter range on the
    observed segment's axis."""
    l = ep_obs - sp_obs
    denom = torch.clamp(torch.sum(l * l, dim=-1), min=1e-12)
    lam_s = torch.sum((sp_proj - sp_obs) * l, dim=-1) / denom
    lam_e = torch.sum((ep_proj - sp_obs) * l, dim=-1) / denom
    ov = (torch.clamp(torch.maximum(lam_s, lam_e), max=1.0)
          - torch.clamp(torch.minimum(lam_s, lam_e), min=0.0))
    return torch.clamp(ov, 0.0, 1.0)


def _line_terms(DT, lm: LineMatches, cam, homog_th):
    """Per-line residual norm, Jacobian, overlap factor, active mask."""
    sP_ = se3.transform_points(DT, lm.sP)
    eP_ = se3.transform_points(DT, lm.eP)
    sp_proj = _safe_project(cam, sP_)
    ep_proj = _safe_project(cam, eP_)
    l = lm.le_obs
    ds = l[..., 0] * sp_proj[..., 0] + l[..., 1] * sp_proj[..., 1] + l[..., 2]
    de = l[..., 0] * ep_proj[..., 0] + l[..., 1] * ep_proj[..., 1] + l[..., 2]
    err_norm = torch.sqrt(ds * ds + de * de)
    Js = _point_jac(sP_[..., 0], sP_[..., 1], sP_[..., 2], l[..., 0],
                    l[..., 1], cam.fx, homog_th)
    Je = _point_jac(eP_[..., 0], eP_[..., 1], eP_[..., 2], l[..., 0],
                    l[..., 1], cam.fx, homog_th)
    J = ((Js * ds[..., None] + Je * de[..., None])
         / torch.clamp(err_norm, min=homog_th)[..., None])
    overlap = segment_overlap(lm.spl, lm.epl, sp_proj, ep_proj)
    return err_norm, J, overlap, lm.valid & lm.inlier


def _accumulate(J, r, w, active):
    """(H, g, e) over the feature axis; inactive lanes are zeroed first so
    no NaN reaches the sums."""
    zero = torch.zeros_like(r)
    wm = torch.where(active, w, zero)
    r = torch.where(active, r, zero)
    J = torch.where(active[..., None], J, torch.zeros_like(J))
    Jw = J * wm[..., None]
    H = torch.sum(J[..., :, :, None] * Jw[..., :, None, :], dim=-3)
    g = torch.sum(J * (r * wm)[..., None], dim=-2)
    e = torch.sum(r * r * wm, dim=-1)
    return H, g, e


def build_normal_equations(DT, pm: PointMatches, lm: LineMatches, cam,
                           cfg: VOConfig, robust_scaled: bool,
                           s_p=None, s_l=None):
    """One evaluation of (H, g, err) over all active features.
    robust_scaled=False: residual x sqrt(sigma2), Cauchy weight on it;
    True: raw residual, weight on r / s with the per-modality MAD scale."""
    th = cfg.homog_th
    p_norm, Jp, p_active = _point_terms(DT, pm, cam, th)
    l_norm, Jl, l_overlap, l_active = _line_terms(DT, lm, cam, th)
    if robust_scaled:
        rp, rl = p_norm, l_norm
        wp = robust.robust_weight(rp / s_p[..., None], cfg.robust_kernel)
        wl = robust.robust_weight(rl / s_l[..., None],
                                  cfg.robust_kernel) * l_overlap
    else:
        rp = p_norm * torch.sqrt(pm.sigma2)
        rl = l_norm * torch.sqrt(lm.sigma2)
        wp = robust.robust_weight(rp, cfg.robust_kernel)
        wl = robust.robust_weight(rl, cfg.robust_kernel) * l_overlap
    Hp, gp, ep = _accumulate(Jp, rp, wp, p_active)
    Hl, gl, el = _accumulate(Jl, rl, wl, l_active)
    n = (torch.sum(p_active, dim=-1) + torch.sum(l_active, dim=-1)).to(
        DT.dtype)
    return Hp + Hl, gp + gl, (ep + el) / torch.clamp(n, min=1.0)


def _mad_scales(DT, pm, lm, cam):
    """Per-modality MAD scale of raw residual norms, clamped to
    [1e-4, sqrt(7.815)]."""
    p_norm, _, p_active = _point_terms(DT, pm, cam, 1e-7)
    l_norm, _, _, l_active = _line_terms(DT, lm, cam, 1e-7)
    s_p = robust.masked_stdv_mad(p_norm, p_active)
    s_l = robust.masked_stdv_mad(l_norm, l_active)
    return (torch.clamp(s_p, 1e-4, SQRT_CHI2_995_3DOF),
            torch.clamp(s_l, 1e-4, SQRT_CHI2_995_3DOF))


def _step(dx, DT):
    return se3.mm(se3.inverse_se3(se3.expmap_se3(dx)), DT)


def _eye(n, like):
    return torch.eye(n, dtype=like.dtype, device=like.device).expand(
        like.shape[:-2] + (n, n))


def gauss_newton(DT0, pm, lm, cam, cfg: VOConfig, max_iters: int,
                 robust_scaled: bool = False) -> OptimResult:
    """GN (gaussNewtonOptimization) and, with robust_scaled=True, robust GN
    (gaussNewtonOptimizationRobust): status 0 runs, 1 converged/stopped,
    2 failed."""
    lead = DT0.shape[:-2]
    dev, dtype = DT0.device, DT0.dtype
    DT = DT0
    H = _eye(6, DT0)
    err = torch.full(lead, -1.0, dtype=dtype, device=dev)
    err_prev = torch.full(lead, _BIG_ERR, dtype=dtype, device=dev)
    it = torch.zeros(lead, dtype=torch.int32, device=dev)
    status = torch.zeros(lead, dtype=torch.int32, device=dev)
    false = torch.zeros(lead, dtype=torch.bool, device=dev)
    for _ in range(max_iters):
        active = status == 0
        if robust_scaled:
            s_p, s_l = _mad_scales(DT, pm, lm, cam)
            H_new, g, e = build_normal_equations(DT, pm, lm, cam, cfg, True,
                                                 s_p, s_l)
            inc = fail_first = false
        else:
            H_new, g, e = build_normal_equations(DT, pm, lm, cam, cfg, False)
            inc = e > err_prev
            fail_first = inc & (it == 0)
        small = (e < cfg.min_error) | (torch.abs(e - err_prev)
                                       < cfg.min_error_change)
        dx, ok = linalg.solve6(H_new, g)
        solver_fail = ~ok if robust_scaled else false
        DT_new = _step(dx, DT)
        if robust_scaled:
            small_dx = (torch.linalg.vector_norm(dx, dim=-1)
                        < cfg.min_error_change)
        else:
            small_dx = ((torch.linalg.vector_norm(dx[..., :3], dim=-1)
                         < cfg.min_error_change)
                        & (torch.linalg.vector_norm(dx[..., 3:], dim=-1)
                           < cfg.min_error_change))
        stop_before_step = inc | small | solver_fail | fail_first
        DT_next = _sel(stop_before_step, DT, DT_new)
        status_new = torch.where(
            fail_first | solver_fail, 2,
            torch.where(inc | small | small_dx, 1, 0)).to(torch.int32)
        DT = _sel(active, DT_next, DT)
        H = _sel(active, H_new, H)
        err = torch.where(active, e, err)
        err_prev = torch.where(active, e, err_prev)
        it = it + active.to(torch.int32)
        status = torch.where(active, status_new, status)

    failed = status == 2
    cov = _sel(failed, _eye(6, DT0), linalg.inv6(H))
    err_out = torch.where(failed, torch.full_like(err, -1.0), err)
    return OptimResult(DT=_sel(failed, DT0, DT), cov=cov, err=err_out,
                       iters=it)


def levenberg_marquardt(DT0, pm, lm, cam, cfg: VOConfig,
                        max_iters: int) -> OptimResult:
    """LM (levenbergMarquardtOptimization): lambda seeded from max |diag H|,
    /4 on error increase, x4 + step on decrease."""
    lambda_k = 4.0
    lead = DT0.shape[:-2]
    dev = DT0.device
    I6 = _eye(6, DT0)
    H0, g0, err0 = build_normal_equations(DT0, pm, lm, cam, cfg, False)
    lam = 1e-9 * torch.amax(torch.abs(torch.diagonal(H0, dim1=-2, dim2=-1)),
                            dim=-1)
    dx0, _ = linalg.solve6(H0 + lam[..., None, None] * I6, g0)
    DT = _step(dx0, DT0)
    H, err_prev = H0, err0
    it = torch.ones(lead, dtype=torch.int32, device=dev)
    status = torch.zeros(lead, dtype=torch.int32, device=dev)
    for _ in range(max(0, max_iters - 1)):
        active = (status == 0) & (it < max_iters)
        H_new, g, e = build_normal_equations(DT, pm, lm, cam, cfg, False)
        small = (e < cfg.min_error) | (torch.abs(e - err_prev)
                                       < cfg.min_error_change)
        dx, _ = linalg.solve6(H_new + lam[..., None, None] * I6, g)
        worse = e > err_prev
        lam_new = torch.where(worse, lam / lambda_k, lam * lambda_k)
        DT_new = _sel(worse, DT, _step(dx, DT))
        small_dx = ((torch.linalg.vector_norm(dx[..., :3], dim=-1)
                     < cfg.min_error_change)
                    & (torch.linalg.vector_norm(dx[..., 3:], dim=-1)
                       < cfg.min_error_change))
        status_new = torch.where(small | small_dx, 1, 0).to(torch.int32)
        DT_next = _sel(small, DT, DT_new)
        DT = _sel(active, DT_next, DT)
        lam = torch.where(active, lam_new, lam)
        H = _sel(active, H_new, H)
        err_prev = torch.where(active, e, err_prev)
        it = it + active.to(torch.int32)
        status = torch.where(active, status_new, status)
    return OptimResult(DT=DT, cov=linalg.inv6(H), err=err_prev, iters=it)


def remove_outliers(DT, pm: PointMatches, lm: LineMatches, cam,
                    cfg: VOConfig):
    """MAD-threshold outlier rejection (removeOutliers): a feature is an
    outlier when |res - trimmed mean| > max(inlier_k * stdv, 1e-4)."""
    th_floor = 1e-4
    if cfg.has_points:
        p_norm, _, _ = _point_terms(DT, pm, cam, cfg.homog_th)
        res_p = p_norm * torch.sqrt(pm.sigma2)
        mean_p, stdv_p = robust.masked_mean_stdv_mad(res_p, pm.valid)
        th_p = torch.clamp(cfg.inlier_k * stdv_p, min=th_floor)
        out_p = torch.abs(res_p - mean_p[..., None]) > th_p[..., None]
        pm = pm._replace(inlier=pm.inlier & ~(out_p & pm.valid))
    if cfg.has_lines:
        l_norm, _, _, _ = _line_terms(DT, lm, cam, cfg.homog_th)
        res_l = l_norm * torch.sqrt(lm.sigma2)
        mean_l, stdv_l = robust.masked_mean_stdv_mad(res_l, lm.valid)
        th_l = torch.clamp(cfg.inlier_k * stdv_l, min=th_floor)
        out_l = torch.abs(res_l - mean_l[..., None]) > th_l[..., None]
        lm = lm._replace(inlier=lm.inlier & ~(out_l & lm.valid))
    return pm, lm


def is_good_solution(DT, cov, err):
    """isGoodSolution: cov eigenvalues in [0, 1], err in [0, 1], DT
    finite."""
    eig = linalg.eigvalsh6(cov)
    return ((eig[..., 0] >= 0.0) & (eig[..., 5] <= 1.0)
            & (err >= 0.0) & (err <= 1.0) & se3.is_finite_mat(DT)
            & torch.all(torch.isfinite(eig), dim=-1))


class PoseEstimate(NamedTuple):
    DT: torch.Tensor          # [..., 4, 4] committed increment T_prev_curr
    DT_cov: torch.Tensor      # [..., 6, 6]
    DT_cov_eig: torch.Tensor  # [..., 6]
    err_norm: torch.Tensor    # [...] (-1 on failure)
    good: torch.Tensor        # [...] bool
    n_inliers_pt: torch.Tensor
    n_inliers_ls: torch.Tensor
    iters: torch.Tensor       # total solver iterations (both stages)


def _solve(DT0, pm, lm, cam, cfg: VOConfig, iters: int) -> OptimResult:
    if cfg.optim_mode == 1:
        return gauss_newton(DT0, pm, lm, cam, cfg, iters, robust_scaled=True)
    if cfg.optim_mode == 2:
        return levenberg_marquardt(DT0, pm, lm, cam, cfg, iters)
    return gauss_newton(DT0, pm, lm, cam, cfg, iters)


def optimize_pose(pm: PointMatches, lm: LineMatches, cam, cfg: VOConfig,
                  DT_prev, DT_prev_cov, err_prev):
    """The optimizePose state machine (:307-392), per lane.  Returns the
    committed pose increment (inverted + renormalized) and the updated
    inlier masks.  CUDA tensors run it as one kernel
    (`ops/pose_optim.py`), CPU tensors as `optimize_pose_plain`."""
    if DT_prev.device.type == "cpu":
        return optimize_pose_plain(pm, lm, cam, cfg, DT_prev, DT_prev_cov,
                                   err_prev)
    o = pose_optim.pose_optim(pm, lm, cam, cfg, DT_prev, DT_prev_cov,
                              err_prev)
    return (PoseEstimate(*o[:8]), pm._replace(inlier=o.p_inlier),
            lm._replace(inlier=o.l_inlier))


def optimize_pose_plain(pm: PointMatches, lm: LineMatches, cam,
                        cfg: VOConfig, DT_prev, DT_prev_cov, err_prev):
    """`optimize_pose` in tensor operations: every solve of both branches
    unrolled, the branch a lane takes selected afterwards."""
    dtype = DT_prev.dtype
    I4 = _eye(4, DT_prev)
    Z6 = torch.zeros(DT_prev.shape[:-2] + (6, 6), dtype=dtype,
                     device=DT_prev.device)
    neg1 = torch.full(DT_prev.shape[:-2], -1.0, dtype=dtype,
                      device=DT_prev.device)

    if cfg.use_motion_model:
        prev_ok = is_good_solution(DT_prev, DT_prev_cov, err_prev)
        DT_init = _sel(prev_ok, DT_prev, I4)
    else:
        DT_init = I4

    enough = (pm.count() + lm.count()) >= cfg.min_features

    # stage 1
    first = _solve(DT_init, pm, lm, cam, cfg, cfg.max_iters)
    good1 = is_good_solution(first.DT, first.cov, first.err)

    # stage 2a: reject outliers against the stage-1 pose, refine from
    # DT_init; too few inliers left -> identity failure
    pm2, lm2 = remove_outliers(first.DT, pm, lm, cam, cfg)
    enough2 = (pm2.count() + lm2.count()) >= cfg.min_features
    r = _solve(DT_init, pm2, lm2, cam, cfg, cfg.max_iters_ref)
    refine = OptimResult(DT=_sel(enough2, r.DT, I4),
                         cov=_sel(enough2, r.cov, Z6),
                         err=torch.where(enough2, r.err, neg1),
                         iters=r.iters)
    # stage 2b: robust GN from DT_init
    fallback = gauss_newton(DT_init, pm, lm, cam, cfg, cfg.max_iters_ref,
                            robust_scaled=True)
    second = OptimResult(*[_sel(good1, a, b)
                           for a, b in zip(refine, fallback)])

    nontrivial = ((good1 & enough2) | ~good1) & enough
    DT_f = _sel(enough, second.DT, I4)
    cov_f = _sel(enough, second.cov, Z6)
    err_f = torch.where(enough, second.err, neg1)

    good_final = is_good_solution(DT_f, cov_f, err_f) & nontrivial
    DT_commit = _sel(good_final,
                     se3.renormalize_se3(se3.inverse_se3(DT_f)), I4)
    cov_commit = _sel(good_final, cov_f, Z6)
    err_commit = torch.where(good_final, err_f, neg1)
    eig = _sel(good_final, linalg.eigvalsh6(cov_f),
               torch.zeros(DT_f.shape[:-2] + (6,), dtype=dtype,
                           device=DT_f.device))

    took_refine = good1 & enough
    pm_out = pm._replace(inlier=_sel(took_refine, pm2.inlier, pm.inlier))
    lm_out = lm._replace(inlier=_sel(took_refine, lm2.inlier, lm.inlier))

    est = PoseEstimate(
        DT=DT_commit, DT_cov=cov_commit, DT_cov_eig=eig,
        err_norm=err_commit, good=good_final,
        n_inliers_pt=pm_out.count(), n_inliers_ls=lm_out.count(),
        iters=first.iters + second.iters)
    return est, pm_out, lm_out
