"""Sliding-window keyframe refinement: the bridge between the frame-to-frame
VO engine and the windowed BA (port of stvo_pl_tpu/parallel/window.py).

  * landmarks = MULTI-ANCHOR tracks unioned across all window keyframes
    (build_problem_tracks): every pair of keyframes is mutually matched
    (Hamming + NNR + mutual), the match graph's connected components are
    found by dense min-label propagation with pointer jumping, each
    component becomes one landmark anchored at its lowest-(kf, slot)
    member, and member observations are written into the [N, K]
    observation table with a reprojection gate;
  * observations = stereo (u_l, v, u_r) measurements from each member's
    own detection + disparity;
  * solve with parallel.ba (`make_sharded_window_refiner`: landmarks
    split over a mesh's data axis).

`compile_refiner` captures the whole refinement (problem build, both
solves, the line-trust select) as a CUDA graph per window size, the
counterpart of the JAX package's jitted refiners (parallel/compiled.py);
the sharded refiner is captured the same way, its collectives inside.

Two members of one component can sit in the same keyframe (features i
and j of keyframe 0 joined through keyframes 1 and 2).  The reference
writes the table with an XLA scatter whose duplicate updates land in
order, so the member with the highest flat index wins; `_write_members`
picks that member explicitly (a scatter-max of the member index, then a
gather), which gives the same table on every device.

Everything is fixed-capacity: a window of K keyframes with Np-point
capacity has K*Np landmark slots, non-root slots masked.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.distributed as dist

from stvo_pl_tpu_torch.config import VOConfig
from stvo_pl_tpu_torch.models.features import LineSet, PointSet
from stvo_pl_tpu_torch.ops import camera as cam_ops
from stvo_pl_tpu_torch.ops import hamming, matching, se3
from stvo_pl_tpu_torch.parallel import ba
from stvo_pl_tpu_torch.parallel.compiled import Compiled
from stvo_pl_tpu_torch.parallel.mesh import DATA_AXIS, axis, mesh_device


class KeyframeWindow(NamedTuple):
    """Stacked keyframe data ([K, ...] leaves).  lines is None when the
    window carries only point snapshots."""
    Tfw: torch.Tensor         # [K, 4, 4] camera-to-world
    points: PointSet          # leaves [K, Np, ...]
    lines: LineSet | None = None  # leaves [K, Nl, ...]


def stack_keyframes(kfs: list[tuple]) -> KeyframeWindow:
    """Each entry is (Tfw, PointSet) or (Tfw, PointSet, LineSet)."""
    Tfw = torch.stack([e[0] for e in kfs])
    pts = PointSet(*[torch.stack(xs) for xs in zip(*[e[1] for e in kfs])])
    lines = None
    if len(kfs[0]) > 2 and kfs[0][2] is not None:
        lines = LineSet(*[torch.stack(xs)
                          for xs in zip(*[e[2] for e in kfs])])
    return KeyframeWindow(Tfw=Tfw, points=pts, lines=lines)


def _lift(T: torch.Tensor, P: torch.Tensor) -> torch.Tensor:
    """Per-row transform: T [n, 4, 4], P [n, 3] -> [n, 3]."""
    return torch.einsum("nab,nb->na", T[:, :3, :3], P) + T[:, :3, 3]


def build_problem(win: KeyframeWindow, cam: cam_ops.StereoCamera,
                  cfg: VOConfig) -> ba.BAProblem:
    """Landmarks from keyframe 0; observations by descriptor matching into
    every keyframe (keyframe 0 observes its own detections)."""
    ba.check_precision(win.Tfw)
    anchor = PointSet(*[x[0] for x in win.points])
    X = se3.transform_points(win.Tfw[0], anchor.P)     # world frame
    K = win.Tfw.shape[0]

    obs_list, mask_list = [], []
    for k in range(K):
        pts_k = PointSet(*[x[k] for x in win.points])
        dist = hamming.distance_matrix(anchor.desc, pts_k.desc,
                                       cfg.hamming_use_mxu,
                                       wta_k=cfg.orb_wta_k)
        cand = anchor.valid[:, None] & pts_k.valid[None, :]
        res = matching.nnr_mutual_match(dist, cand, cfg.min_ratio_12_p,
                                        mutual=cfg.best_lr_matches)
        j = torch.clamp(res.idx, min=0)
        uv = pts_k.uv[j]
        disp = pts_k.disp[j]
        obs_list.append(torch.stack([uv[:, 0], uv[:, 1], uv[:, 0] - disp],
                                    dim=-1))
        mask_list.append(res.valid & anchor.valid)
    obs = torch.stack(obs_list, dim=1)                 # [Np, K, 3]
    mask = torch.stack(mask_list, dim=1)               # [Np, K]
    return ba.BAProblem(X=X, obs=obs, mask=mask, sigma2=anchor.sigma2)


def _track_labels(dist_fn, valid, K: int, N: int, ratio: float,
                  cfg: VOConfig, extra_cand=None) -> torch.Tensor:
    """Match-graph connected components over a [K, N] feature table.

    Every keyframe pair is mutually matched (dist_fn(a, b) -> [N, N]
    distances, NNR + mutual), then components are found by dense min-label
    propagation with pointer jumping.  Returns flat int64 labels [K*N]:
    each feature's component root (lowest flat index), K*N for invalid
    features."""
    Ntot = K * N
    BIG = Ntot
    match_idx = {}
    for a in range(K):
        for b in range(a + 1, K):
            cand = valid[a][:, None] & valid[b][None, :]
            if extra_cand is not None:
                cand = cand & extra_cand(a, b)
            res = matching.nnr_mutual_match(dist_fn(a, b), cand, ratio,
                                            mutual=cfg.best_lr_matches)
            match_idx[(a, b)] = (torch.clamp(res.idx, min=0), res.valid)

    flat0 = torch.arange(Ntot, device=valid.device).reshape(K, N)
    big = torch.full_like(flat0, BIG)
    L = torch.where(valid, flat0, big)
    rows = list(L)
    n_rounds = 2 + max(1, K.bit_length())
    for _ in range(n_rounds):
        for (a, b), (idx, ok) in match_idx.items():
            la, lb = rows[a], rows[b]
            rows[a] = torch.where(ok, torch.minimum(la, lb[idx]), la)
            rows[b] = lb.scatter_reduce(0, idx, torch.where(ok, la, big[a]),
                                        "amin", include_self=True)
        # pointer jump on the flat label array
        Lf = torch.stack(rows).reshape(-1)
        live = Lf < BIG
        Lj = torch.where(live, Lf, torch.zeros_like(Lf))
        Lf = torch.where(live, torch.minimum(Lf, Lf[Lj]),
                         torch.full_like(Lf, BIG))
        rows = list(Lf.reshape(K, N))
    return torch.stack(rows).reshape(-1)


def _write_members(root_idx: torch.Tensor, k_of_n: torch.Tensor,
                   obs_node: torch.Tensor, K: int):
    """The track table: row root_idx[n], column k_of_n[n] takes member n's
    observation; rows >= Ntot are dropped.  Where two members share a
    cell, the one with the highest flat index wins (the reference's
    in-order scatter).  Returns (obs [Ntot, K, C], written [Ntot, K])."""
    Ntot = root_idx.shape[0]
    keep = root_idx < Ntot
    cell = torch.where(keep, root_idx * K + k_of_n,
                       torch.full_like(root_idx, Ntot * K))
    member = torch.arange(Ntot, device=root_idx.device)
    winner = torch.full((Ntot * K + 1,), -1, dtype=member.dtype,
                        device=root_idx.device)
    winner = winner.scatter_reduce(0, cell, member, "amax",
                                   include_self=True)[:-1]
    written = winner >= 0
    rows = obs_node[torch.clamp(winner, min=0)]
    obs = torch.where(written[:, None], rows, torch.zeros_like(rows))
    return obs.reshape(Ntot, K, -1), written.reshape(Ntot, K)


def build_problem_tracks(win: KeyframeWindow, cam: cam_ops.StereoCamera,
                         cfg: VOConfig,
                         reproj_gate: float = 8.0) -> ba.BAProblem:
    """Multi-anchor landmark tracks unioned across ALL window keyframes.

    Returns a BAProblem with N = K*Np landmark slots: slot (k, i) is a
    live landmark iff feature i of keyframe k is the root (lowest flat
    index) of its match-graph component and the component spans >= 2
    keyframes.  Landmarks are initialized from the root's own stereo
    back-projection lifted to world; observations failing the
    reprojection gate against that initialization are masked out.
    """
    ba.check_precision(win.Tfw)
    K = win.Tfw.shape[0]
    pts = win.points
    Np = pts.uv.shape[1]
    Ntot = K * Np
    dev = pts.uv.device
    valid = pts.valid                                   # [K, Np]

    def dist_fn(a, b):
        return hamming.distance_matrix(pts.desc[a], pts.desc[b],
                                       cfg.hamming_use_mxu,
                                       wta_k=cfg.orb_wta_k)

    Lf = _track_labels(dist_fn, valid, K, Np, cfg.min_ratio_12_p, cfg)
    valid_f = valid.reshape(-1)
    k_of_n = torch.arange(K, device=dev)[:, None].expand(K, Np).reshape(-1)

    # --- member observations written into the track table -------------
    uv = pts.uv.reshape(-1, 2)
    disp = pts.disp.reshape(-1)
    obs_node = torch.stack([uv[:, 0], uv[:, 1], uv[:, 0] - disp], dim=-1)
    root_idx = torch.where(valid_f, Lf, torch.full_like(Lf, Ntot))
    obs, mask = _write_members(root_idx, k_of_n, obs_node, K)

    # --- landmark init from each root's own stereo back-projection ----
    disp_safe = torch.where(disp > 1e-3, disp, torch.ones_like(disp))
    P_node = cam_ops.back_project(cam, uv, disp_safe)  # camera frame
    X_node = _lift(win.Tfw[k_of_n], P_node)
    is_root = (Lf == torch.arange(Ntot, device=dev)) & valid_f
    nk = mask.sum(dim=-1)
    live = is_root & (nk >= 2)
    X = torch.where(live[:, None], X_node, torch.zeros_like(X_node))

    # --- reprojection gate against the initialization ------------------
    poses_cw = se3.inverse_se3(win.Tfw)                 # [K, 4, 4]
    Pc = (torch.einsum("kab,nb->nka", poses_cw[:, :3, :3], X)
          + poses_cw[:, :3, 3][None])
    z = Pc[..., 2]
    z = torch.where(torch.abs(z) < 1e-6, torch.full_like(z, 1e-6), z)
    u = cam.cx + cam.fx * Pc[..., 0] / z
    v = cam.cy + cam.fy * Pc[..., 1] / z
    err = torch.maximum(torch.abs(u - obs[..., 0]), torch.abs(v - obs[..., 1]))
    mask = mask & live[:, None] & (err < reproj_gate) & (z > 0.1)

    sigma2 = torch.where(live, pts.sigma2.reshape(-1),
                         torch.ones_like(pts.sigma2.reshape(-1)))
    prob = ba.BAProblem(X=X, obs=obs, mask=mask, sigma2=sigma2)
    if win.lines is not None and cfg.has_lines:
        prob = prob._replace(**_build_line_tracks(win, cam, cfg,
                                                  line_gate=reproj_gate))
    return prob


def _build_line_tracks(win: KeyframeWindow, cam: cam_ops.StereoCamera,
                       cfg: VOConfig, line_gate: float = 8.0) -> dict:
    """Multi-anchor LINE landmark tracks for the windowed BA.

    The point tracks' union-find on LBD descriptors, with the reference's
    direction-similarity candidate filter (src/matching.cpp:221-222).
    Each root contributes a 3-D endpoint pair from its own stereo endpoint
    disparities; member observations are the member's own infinite-line
    coefficients + 2-D endpoints.  Observations whose initialized
    endpoints project farther than line_gate px from the observed
    infinite line are masked.
    """
    K = win.Tfw.shape[0]
    ls = win.lines
    Nl = ls.spl.shape[1]
    Ntot = K * Nl
    dev = ls.spl.device
    valid = ls.valid                                     # [K, Nl]
    d = ls.epl - ls.spl
    dirs = d / torch.clamp(torch.linalg.vector_norm(d, dim=-1, keepdim=True),
                           min=1e-6)

    def dist_fn(a, b):
        return hamming.hamming_matrix(ls.desc[a], ls.desc[b],
                                      cfg.hamming_use_mxu)

    def dir_cand(a, b):
        cosang = torch.abs(torch.einsum("ic,jc->ij", dirs[a], dirs[b]))
        return cosang > cfg.line_sim_th

    Lf = _track_labels(dist_fn, valid, K, Nl, cfg.min_ratio_12_l, cfg,
                       extra_cand=dir_cand)
    valid_f = valid.reshape(-1)
    k_of_n = torch.arange(K, device=dev)[:, None].expand(K, Nl).reshape(-1)

    # --- member observations written into the track table ---------------
    obs_node = torch.cat([ls.le.reshape(-1, 3), ls.spl.reshape(-1, 2),
                          ls.epl.reshape(-1, 2)], dim=-1)   # [Ntot, 7]
    root_idx = torch.where(valid_f, Lf, torch.full_like(Lf, Ntot))
    obs_l, mask_l = _write_members(root_idx, k_of_n, obs_node, K)

    # --- endpoint init from each root's own stereo back-projection -----
    sdisp = torch.clamp(ls.sdisp.reshape(-1), min=1e-3)
    edisp = torch.clamp(ls.edisp.reshape(-1), min=1e-3)
    Ps = cam_ops.back_project(cam, ls.spl.reshape(-1, 2), sdisp)
    Pe = cam_ops.back_project(cam, ls.epl.reshape(-1, 2), edisp)
    T_node = win.Tfw[k_of_n]
    Xl_node = torch.stack([_lift(T_node, Ps), _lift(T_node, Pe)], dim=1)
    is_root = (Lf == torch.arange(Ntot, device=dev)) & valid_f
    nk = mask_l.sum(dim=-1)
    live = is_root & (nk >= 2)
    Xl = torch.where(live[:, None, None], Xl_node, torch.zeros_like(Xl_node))

    # --- endpoint-to-line gate against the initialization --------------
    poses_cw = se3.inverse_se3(win.Tfw)                  # [K, 4, 4]
    Pc = (torch.einsum("kab,njb->nkja", poses_cw[:, :3, :3], Xl)
          + poses_cw[:, :3, 3][None, :, None])           # [Ntot, K, 2, 3]
    z = Pc[..., 2]
    z_safe = torch.where(torch.abs(z) < 1e-6, torch.full_like(z, 1e-6), z)
    u = cam.cx + cam.fx * Pc[..., 0] / z_safe
    v = cam.cy + cam.fy * Pc[..., 1] / z_safe
    le = obs_l[..., :3]
    derr = torch.abs(le[..., 0:1] * u + le[..., 1:2] * v + le[..., 2:3])
    mask_l = (mask_l & live[:, None] & torch.all(derr < line_gate, dim=-1)
              & torch.all(z > 0.1, dim=-1))

    sigma2_l = torch.where(live, ls.sigma2.reshape(-1),
                           torch.ones_like(ls.sigma2.reshape(-1)))
    return dict(Xl=Xl, obs_l=obs_l, mask_l=mask_l, sigma2_l=sigma2_l)


def refine_window(win: KeyframeWindow, cam: cam_ops.StereoCamera,
                  cfg: VOConfig, n_iters: int = 6,
                  multi_anchor: bool = True):
    """Jointly refine the window's keyframe poses (and landmarks).

    Returns (Tfw_refined [K, 4, 4], X_refined, costs [n_iters])."""
    build = build_problem_tracks if multi_anchor else build_problem
    prob = build(win, cam, cfg)
    poses_cw = se3.inverse_se3(win.Tfw)
    poses_cw, X, _, costs = ba.ba_solve(poses_cw, prob, cam, n_iters=n_iters)
    return se3.inverse_se3(poses_cw), X, costs


def refine_window_auto(win: KeyframeWindow, cam: cam_ops.StereoCamera,
                       cfg: VOConfig, n_iters: int = 6,
                       multi_anchor: bool = True, chi2_tol: float = 1.10,
                       max_disagree_t: float = 0.25,
                       max_disagree_r: float = 1.0):
    """Window refinement with AUTOMATIC per-window line trust.

    Solves BOTH the points-only and the joint points+lines systems and
    accepts the joint solution only when it stays consistent with the
    point evidence (the window-level analogue of isGoodSolution,
    src/stereoFrameHandler.cpp:292-305):

      * the joint solution's point-residual chi-square may not exceed
        chi2_tol x the points-only solution's;
      * the joint poses may not disagree with the points-only poses by
        more than max_disagree_t meters / max_disagree_r degrees at any
        keyframe.

    Rejected lines fall back to the points-only solution.  Both solves
    always run and the choice is a device-side select: no host sync.

    Returns (Tfw_refined, X_refined, costs, used_lines: bool tensor)."""
    build = build_problem_tracks if multi_anchor else build_problem
    prob = build(win, cam, cfg)
    poses_cw0 = se3.inverse_se3(win.Tfw)
    prob_p = prob._replace(Xl=None, obs_l=None, mask_l=None, sigma2_l=None)
    poses_p, Xp, _, costs_p = ba.ba_solve(poses_cw0, prob_p, cam,
                                          n_iters=n_iters)
    if prob.Xl is None:
        return (se3.inverse_se3(poses_p), Xp, costs_p,
                torch.zeros((), dtype=torch.bool, device=Xp.device))
    poses_j, Xj, _, costs_j = ba.ba_solve(poses_cw0, prob, cam,
                                          n_iters=n_iters)
    chi_p, _ = ba.point_chi2(poses_p, prob_p, cam)
    chi_j, _ = ba.point_chi2(poses_j, prob_p, cam)
    # per-keyframe pose disagreement joint vs points-only
    D = se3.mm(poses_j, se3.inverse_se3(poses_p))        # [K, 4, 4]
    dis_t = torch.max(torch.linalg.vector_norm(D[:, :3, 3], dim=-1))
    tr = D[:, 0, 0] + D[:, 1, 1] + D[:, 2, 2]
    cos_r = torch.clamp((tr - 1.0) / 2.0, -1.0, 1.0)
    dis_r = torch.max(torch.rad2deg(torch.arccos(cos_r)))
    use_lines = ((chi_j <= chi2_tol * chi_p)
                 & (dis_t <= max_disagree_t)
                 & (dis_r <= max_disagree_r))
    poses = torch.where(use_lines, poses_j, poses_p)
    X = torch.where(use_lines, Xj, Xp)
    costs = torch.where(use_lines, costs_j, costs_p)
    return se3.inverse_se3(poses), X, costs, use_lines


def compile_refiner(cam: cam_ops.StereoCamera, cfg: VOConfig,
                    n_iters: int = 6, multi_anchor: bool = True,
                    auto: bool = True, chi2_tol: float = 1.10,
                    max_disagree_t: float = 0.25,
                    max_disagree_r: float = 1.0, device=None) -> Compiled:
    """`refine_window_auto` (`auto=False`: `refine_window`) as a captured
    program on `device` ("cuda" unless the caller asks for the CPU), one
    graph per window size K and per window structure (with or without
    line snapshots): `refine(win)` returns what the eager refiner returns,
    bit for bit, as tensors that belong to the caller."""
    if auto:
        def refine(win):
            return refine_window_auto(
                win, cam, cfg, n_iters=n_iters, multi_anchor=multi_anchor,
                chi2_tol=chi2_tol, max_disagree_t=max_disagree_t,
                max_disagree_r=max_disagree_r)
    else:
        def refine(win):
            return refine_window(win, cam, cfg, n_iters=n_iters,
                                 multi_anchor=multi_anchor)
    return Compiled(refine, device)


def make_sharded_window_refiner(mesh, cam: cam_ops.StereoCamera,
                                cfg: VOConfig, n_iters: int = 6,
                                multi_anchor: bool = True,
                                has_lines: bool = False):
    """Landmark-sharded window refinement (port of
    stvo_pl_tpu/parallel/window.py:359-384): every rank builds the whole
    problem (matching is cheap), then solves its landmark shard with
    parallel.ba.make_sharded_ba, whose reduced camera systems are summed
    over the data axis.  has_lines must match whether the windows carry
    LineSet snapshots.  `refine(win)` returns (Tfw refined [K, 4, 4],
    points [K * Np, 3] gathered in rank order, the shape `refine_window`
    returns, costs [n_iters]), the same on every rank.

    `refine` is a captured program on the mesh's device (problem build,
    sharded solve and, when n_data > 1, the points' all-gather; one graph
    per window size), as `compile_refiner` is for `refine_window`;
    `refine.fn` is its eager body.  The body calls the solver's eager
    body: a capture cannot hold another program's capture."""
    solver = ba.make_sharded_ba(mesh, cam, n_iters=n_iters,
                                has_lines=has_lines).fn
    build = build_problem_tracks if multi_anchor else build_problem
    group, n_data, _ = axis(mesh, DATA_AXIS)

    def refine(win: KeyframeWindow):
        prob = build(win, cam, cfg)
        poses_cw = se3.inverse_se3(win.Tfw)
        if has_lines:
            poses_cw, X, _, costs = solver(
                poses_cw, prob.X, prob.obs, prob.mask, prob.sigma2,
                prob.Xl, prob.obs_l, prob.mask_l, prob.sigma2_l)
        else:
            poses_cw, X, costs = solver(poses_cw, prob.X, prob.obs,
                                        prob.mask, prob.sigma2)
        if n_data > 1:
            X_all = torch.empty(n_data * X.numel(), dtype=X.dtype,
                                device=X.device)
            dist.all_gather_into_tensor(X_all, X.reshape(-1), group=group)
            X = X_all.reshape(-1, 3)
        return se3.inverse_se3(poses_cw), X, costs

    return Compiled(refine, mesh_device(mesh),
                    groups=() if group is None else (group,))
