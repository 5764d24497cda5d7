"""The VO engine: frame-to-frame tracking state machine, batched over a
leading lane axis (port of stvo_pl_tpu/models/frontend.py; reference
src/stereoFrameHandler.cpp).

    state', telemetry = step_lanes(state, imgs_l, imgs_r, cam, cfg)

covers initialize, f2f tracking, optimizePose (models/optimizer.py), the
adaptive-FAST controller and the keyframe hooks.  Every field of VOState
carries the lane axis first.  `vo_step` runs one unbatched lane and
`vo_scan` a whole sequence as a Python loop; `step_lanes_rgbd` /
`vo_step_rgbd` take an intensity image and a registered depth map in place
of the stereo pair.  `per_direction` (an argument, not a config field)
selects the run candidate generator of the dense single-octave line
detector, see ops/lsd.py.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from stvo_pl_tpu_torch.config import VOConfig
from stvo_pl_tpu_torch.device import resolve_device
from stvo_pl_tpu_torch.models import frame as frame_mod
from stvo_pl_tpu_torch.models import optimizer
from stvo_pl_tpu_torch.models.features import (LineMatches, LineSet,
                                               PointMatches, PointSet,
                                               empty_lines, empty_points)
from stvo_pl_tpu_torch.ops import camera as cam_ops
from stvo_pl_tpu_torch.ops import linalg, matching, se3

_sel = optimizer._sel


class VOState(NamedTuple):
    """Carried across frames (the reference's prev_frame + handler
    fields)."""
    prev_points: PointSet
    prev_lines: LineSet
    Tfw: torch.Tensor          # [..., 4, 4] camera-to-world of prev frame
    Tfw_cov: torch.Tensor      # [..., 6, 6]
    DT: torch.Tensor           # [..., 4, 4] last pose increment
    DT_cov: torch.Tensor       # [..., 6, 6]
    err_norm: torch.Tensor     # [...]
    fast_th: torch.Tensor      # [...] adaptive FAST threshold
    initialized: torch.Tensor  # [...] bool
    T_prevKF: torch.Tensor
    cov_prevKF_currF: torch.Tensor
    entropy_first_prevKF: torch.Tensor
    prev_f_iskf: torch.Tensor
    N_prevKF_currF: torch.Tensor   # int32


class StepTelemetry(NamedTuple):
    """Per-frame telemetry of the reference CLI plus KF signals."""
    Tfw: torch.Tensor
    DT: torch.Tensor
    DT_cov_eig: torch.Tensor
    err_norm: torch.Tensor
    good: torch.Tensor
    n_points: torch.Tensor
    n_inliers_pt: torch.Tensor
    n_lines: torch.Tensor
    n_inliers_ls: torch.Tensor
    fast_th: torch.Tensor
    is_kf: torch.Tensor
    entropy_ratio: torch.Tensor
    opt_iters: torch.Tensor


def init_state(cfg: VOConfig, device=None, batch: tuple[int, ...] = (),
               dtype=torch.float32) -> VOState:
    """Initial state on `device` ("cuda" unless the caller asks for the
    CPU), with optional leading lane dims."""
    dev = resolve_device(device)
    kw = dict(dtype=dtype, device=dev)

    def full(shape, v, dt=dtype):
        return torch.full(batch + shape, v, dtype=dt, device=dev)

    I4 = torch.eye(4, **kw).expand(batch + (4, 4)).clone()
    I6 = torch.eye(6, **kw).expand(batch + (6, 6)).clone()
    return VOState(
        prev_points=empty_points(cfg.point_capacity, dtype, dev, batch),
        prev_lines=empty_lines(cfg.line_capacity, dtype, dev, batch),
        Tfw=I4, Tfw_cov=I6, DT=I4.clone(), DT_cov=full((6, 6), 0.0),
        err_norm=full((), -1.0), fast_th=full((), float(cfg.orb_fast_th)),
        initialized=full((), False, torch.bool),
        T_prevKF=I4.clone(), cov_prevKF_currF=full((6, 6), 0.0),
        entropy_first_prevKF=full((), -1e9),
        prev_f_iskf=full((), True, torch.bool),
        N_prevKF_currF=full((), 0, torch.int32))


# ---------------------------------------------------------------------------
# frame-to-frame matching (f2fTracking, :106-180)
# ---------------------------------------------------------------------------

def _grid_scales(cfg: VOConfig, cam: cam_ops.StereoCamera):
    return cfg.grid_cols / float(cam.width), cfg.grid_rows / float(cam.height)


def match_f2f_points(prev: PointSet, curr: PointSet, cfg: VOConfig,
                     cam: cam_ops.StereoCamera | None = None) -> PointMatches:
    """matchF2FPoints: descriptor matching (NNR + mutual) of the previous
    against the current stereo points; matching_strategy 1 adds a
    +-matching_f2f_ws grid-cell window."""
    cand = prev.valid[..., :, None] & curr.valid[..., None, :]
    if cfg.matching_strategy == 1 and cam is not None:
        inv_w, inv_h = _grid_scales(cfg, cam)
        cand = cand & matching.f2f_point_window_mask(
            prev.uv, curr.uv, inv_w, inv_h, cfg.matching_f2f_ws)
    res = matching.match_auto(prev.desc, curr.desc, cand, cfg.min_ratio_12_p,
                              cfg, wta_k=cfg.orb_wta_k)
    obs = frame_mod._take(curr.uv, torch.clamp(res.idx, min=0))
    valid = res.valid & prev.valid
    return PointMatches(P=prev.P,
                        obs=torch.where(valid[..., None], obs,
                                        torch.zeros_like(obs)),
                        sigma2=prev.sigma2, valid=valid,
                        inlier=torch.ones_like(valid))


def match_f2f_lines(prev: LineSet, curr: LineSet, cfg: VOConfig,
                    cam: cam_ops.StereoCamera | None = None) -> LineMatches:
    """matchF2FLines: descriptor matching; the observation is the current
    frame's infinite-line coefficients."""
    cand = prev.valid[..., :, None] & curr.valid[..., None, :]
    if cfg.matching_strategy == 1 and cam is not None:
        inv_w, inv_h = _grid_scales(cfg, cam)
        cand = cand & matching.f2f_point_window_mask(
            0.5 * (prev.spl + prev.epl), 0.5 * (curr.spl + curr.epl),
            inv_w, inv_h, cfg.matching_f2f_ws)
    res = matching.match_auto(prev.desc, curr.desc, cand, cfg.min_ratio_12_l,
                              cfg)
    le_obs = frame_mod._take(curr.le, torch.clamp(res.idx, min=0))
    valid = res.valid & prev.valid
    return LineMatches(sP=prev.sP, eP=prev.eP, spl=prev.spl, epl=prev.epl,
                       le_obs=torch.where(valid[..., None], le_obs,
                                          torch.zeros_like(le_obs)),
                       sigma2=prev.sigma2, valid=valid,
                       inlier=torch.ones_like(valid))


# ---------------------------------------------------------------------------
# adaptive FAST controller (updateFrame, :62-102)
# ---------------------------------------------------------------------------

def update_fast_threshold(fast_th, good, err_norm, n_inliers_pt,
                          cfg: VOConfig):
    if not cfg.adaptative_fast:
        return fast_th
    inc = float(cfg.fast_inc_th)
    feat = cfg.fast_feat_th
    bad = (~good) | (err_norm > cfg.fast_err_th)
    th = torch.where(
        bad, fast_th - 2 * inc,
        torch.where(n_inliers_pt < feat, fast_th - 2 * inc,
        torch.where(n_inliers_pt < feat * 2, fast_th - inc,
        torch.where(n_inliers_pt > feat * 4, fast_th + 2 * inc,
        torch.where(n_inliers_pt > feat * 3, fast_th + inc, fast_th)))))
    return torch.clamp(th, float(cfg.fast_min_th), float(cfg.fast_max_th))


# ---------------------------------------------------------------------------
# keyframe decision (needNewKF / currFrameIsKF, :1136-1218)
# ---------------------------------------------------------------------------

_ENTROPY_CONST = 3.0 * (1.0 + math.log(2.0 * math.pi))


def keyframe_update(state: VOState, est: optimizer.PoseEstimate,
                    Tfw_curr, cfg: VOConfig):
    """Returns (is_kf, T_prevKF, cov_prevKF_currF, entropy_first,
    N_prevKF_currF, entropy_ratio).  Poses are global, so T_prevKF stores
    the keyframe's global pose (the JAX package's fixed convention)."""
    dtype = Tfw_curr.dtype
    logdet_dt = linalg.logdet6(est.DT_cov)
    entropy_first = torch.where(
        state.prev_f_iskf,
        torch.where(torch.isfinite(logdet_dt),
                    _ENTROPY_CONST + 0.5 * logdet_dt,
                    torch.full_like(logdet_dt, -1e9)),
        state.entropy_first_prevKF).to(dtype)

    dX = se3.logmap_se3(se3.mm(se3.inverse_se3(Tfw_curr), state.T_prevKF))
    t = torch.linalg.vector_norm(dX[..., :3], dim=-1)
    r = torch.linalg.vector_norm(dX[..., 3:], dim=-1) * (180.0 / math.pi)

    cov_acc = state.cov_prevKF_currF + se3.uncTinv_se3(est.DT, est.DT_cov)
    entropy_curr = _ENTROPY_CONST + 0.5 * linalg.logdet6(cov_acc)
    entropy_ratio = entropy_curr / entropy_first

    is_kf = ((entropy_ratio < cfg.min_entropy_ratio)
             | ~torch.isfinite(entropy_ratio)
             | ~est.good
             | (t > cfg.max_kf_t_dist) | (r > cfg.max_kf_r_dist)
             | (state.N_prevKF_currF > 10))

    T_prevKF = _sel(is_kf, Tfw_curr, state.T_prevKF)
    cov_next = _sel(is_kf, torch.zeros_like(cov_acc), cov_acc)
    n_next = torch.where(is_kf, 0, state.N_prevKF_currF + 1).to(torch.int32)
    return is_kf, T_prevKF, cov_next, entropy_first, n_next, entropy_ratio


# ---------------------------------------------------------------------------
# one full VO step
# ---------------------------------------------------------------------------

def _check_images(state: VOState, cam: cam_ops.StereoCamera, **images):
    dev = state.Tfw.device
    for name, im in images.items():
        if im.device != dev:
            raise ValueError(f"{name} is on {im.device}, the state on {dev}")
        if im.shape != (state.Tfw.shape[0], cam.height, cam.width):
            raise ValueError(f"{name} has shape {tuple(im.shape)}, expected "
                             f"({state.Tfw.shape[0]}, {cam.height}, "
                             f"{cam.width})")


def step_lanes(state: VOState, imgs_l: torch.Tensor, imgs_r: torch.Tensor,
               cam: cam_ops.StereoCamera, cfg: VOConfig,
               per_direction: bool = False) -> tuple[VOState, StepTelemetry]:
    """Process B rectified stereo pairs [B, H, W] for B lanes of state."""
    _check_images(state, cam, imgs_l=imgs_l, imgs_r=imgs_r)
    llength_th = cfg.min_line_length * min(cam.width, cam.height)
    feats = frame_mod.extract_stereo_features(
        imgs_l.to(torch.float32), imgs_r.to(torch.float32), state.fast_th,
        llength_th, cam, cfg, per_direction=per_direction)
    return _track_and_update(state, feats, cam, cfg)


def step_lanes_rgbd(state: VOState, imgs: torch.Tensor, depths: torch.Tensor,
                    cam: cam_ops.StereoCamera, cfg: VOConfig,
                    per_direction: bool = False
                    ) -> tuple[VOState, StepTelemetry]:
    """RGB-D variant of `step_lanes`: B intensity images and registered
    metric depth maps [B, H, W] (reference extractRGBDFeatures path,
    src/stereoFrame.cpp:667-818)."""
    _check_images(state, cam, imgs=imgs, depths=depths)
    llength_th = cfg.min_line_length * min(cam.width, cam.height)
    feats = frame_mod.extract_rgbd_features(
        imgs.to(torch.float32), depths.to(torch.float32), state.fast_th,
        llength_th, cam, cfg, per_direction=per_direction)
    return _track_and_update(state, feats, cam, cfg)


def _track_and_update(state: VOState, feats, cam, cfg: VOConfig):
    dtype = state.Tfw.dtype
    pm = match_f2f_points(state.prev_points, feats.points, cfg, cam)
    lm = match_f2f_lines(state.prev_lines, feats.lines, cfg, cam)
    est, pm, lm = optimizer.optimize_pose(
        pm, lm, cam, cfg, state.DT, state.DT_cov, state.err_norm)

    first = ~state.initialized
    I4 = torch.eye(4, dtype=dtype, device=state.Tfw.device).expand_as(est.DT)
    Z6 = torch.zeros_like(est.DT_cov)
    DT_commit = _sel(first, I4, est.DT)
    good = first | est.good
    cov_commit = _sel(first, Z6, est.DT_cov)
    err_commit = torch.where(first, torch.full_like(est.err_norm, -1.0),
                             est.err_norm).to(dtype)

    moved = good & ~first
    Tfw_new = _sel(moved, se3.renormalize_se3(se3.mm(state.Tfw, DT_commit)),
                   state.Tfw)
    Tfw_cov_new = _sel(moved,
                       se3.unccomp_se3(state.Tfw, state.Tfw_cov, cov_commit),
                       state.Tfw_cov)

    est_for_kf = est._replace(DT=DT_commit, DT_cov=cov_commit, good=moved)
    (is_kf, T_prevKF, cov_kf, entropy_first, n_kf,
     entropy_ratio) = keyframe_update(state, est_for_kf, Tfw_new, cfg)

    fast_th_new = torch.where(
        first, state.fast_th,
        update_fast_threshold(state.fast_th, good, err_commit,
                              est.n_inliers_pt, cfg))

    new_state = VOState(
        prev_points=feats.points, prev_lines=feats.lines,
        Tfw=Tfw_new, Tfw_cov=Tfw_cov_new,
        DT=DT_commit, DT_cov=cov_commit, err_norm=err_commit,
        fast_th=fast_th_new,
        initialized=torch.ones_like(state.initialized),
        T_prevKF=T_prevKF, cov_prevKF_currF=cov_kf,
        entropy_first_prevKF=entropy_first,
        prev_f_iskf=is_kf, N_prevKF_currF=n_kf)
    telem = StepTelemetry(
        Tfw=Tfw_new, DT=DT_commit, DT_cov_eig=est.DT_cov_eig,
        err_norm=err_commit, good=good,
        n_points=torch.sum(pm.valid, dim=-1), n_inliers_pt=est.n_inliers_pt,
        n_lines=torch.sum(lm.valid, dim=-1), n_inliers_ls=est.n_inliers_ls,
        fast_th=fast_th_new, is_kf=is_kf & ~first,
        entropy_ratio=entropy_ratio, opt_iters=est.iters)
    return new_state, telem


def _map(fn, tree):
    """Apply fn to every tensor of a (nested) NamedTuple."""
    if isinstance(tree, tuple):
        return type(tree)(*[_map(fn, t) for t in tree])
    return fn(tree)


def vo_step(state: VOState, img_l: torch.Tensor, img_r: torch.Tensor,
            cam: cam_ops.StereoCamera, cfg: VOConfig,
            per_direction: bool = False) -> tuple[VOState, StepTelemetry]:
    """One unbatched step: [H, W] stereo pair, state without lane axis."""
    s, t = step_lanes(_map(lambda x: x[None], state), img_l[None],
                      img_r[None], cam, cfg, per_direction=per_direction)
    return _map(lambda x: x[0], s), _map(lambda x: x[0], t)


def vo_step_rgbd(state: VOState, img: torch.Tensor, depth: torch.Tensor,
                 cam: cam_ops.StereoCamera, cfg: VOConfig,
                 per_direction: bool = False
                 ) -> tuple[VOState, StepTelemetry]:
    """One unbatched RGB-D step: [H, W] intensity and depth."""
    s, t = step_lanes_rgbd(_map(lambda x: x[None], state), img[None],
                           depth[None], cam, cfg,
                           per_direction=per_direction)
    return _map(lambda x: x[0], s), _map(lambda x: x[0], t)


def vo_scan(state: VOState, imgs_l: torch.Tensor, imgs_r: torch.Tensor,
            cam: cam_ops.StereoCamera, cfg: VOConfig,
            per_direction: bool = False):
    """A whole sequence [T, H, W] through `vo_step`; telemetry stacked over
    frames."""
    telems = []
    for i in range(imgs_l.shape[0]):
        state, t = vo_step(state, imgs_l[i], imgs_r[i], cam, cfg,
                           per_direction=per_direction)
        telems.append(t)
    return state, StepTelemetry(*[torch.stack(f) for f in zip(*telems)])
