"""Per-frame stereo feature extraction, points half (port of
stvo_pl_tpu/models/frame.py:37-178 and the points branch of
extract_stereo_features; reference src/stereoFrame.cpp:59-173).

Lanes and eyes are one leading image axis: the left images of all lanes
followed by the right images go through the pyramid, the FAST kernel and
the patch kernel together, one launch per pyramid level.  Stereo matching
is a dense masked Hamming matrix + grid-window predicate + NNR + mutual
check, then vectorized epipolar / disparity filters and back-projection
under the same mask.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from stvo_pl_tpu_torch.config import VOConfig
from stvo_pl_tpu_torch.models.features import (LineSet, PointSet,
                                               empty_lines, empty_points)
from stvo_pl_tpu_torch.ops import camera as cam_ops
from stvo_pl_tpu_torch.ops import fast as fast_ops
from stvo_pl_tpu_torch.ops import matching, orb, subpix
from stvo_pl_tpu_torch.ops.image import gaussian_blur, pyramid_levels


class FrameFeatures(NamedTuple):
    """Everything the VO engine needs from one stereo pair."""
    points: PointSet
    lines: LineSet


def _per_level_budgets(cfg: VOConfig) -> list[int]:
    """Geometric feature distribution over pyramid levels (cv::ORB style),
    summing to orb_nfeatures."""
    L = cfg.orb_nlevels
    q = 1.0 / cfg.orb_scale_factor
    weights = [q ** i for i in range(L)]
    s = sum(weights)
    budgets = [max(8, int(round(cfg.orb_nfeatures * w / s))) for w in weights]
    budgets[0] += cfg.orb_nfeatures - sum(budgets)
    return budgets


class DetectedPoints(NamedTuple):
    """Fixed-capacity multi-level point detections, [N, K, ...]."""
    uv: torch.Tensor      # [N, K, 2] sub-pixel level-0 coords
    desc: torch.Tensor    # [N, K, 8] int32
    level: torch.Tensor   # [N, K] int32
    score: torch.Tensor   # [N, K]
    valid: torch.Tensor   # [N, K] bool
    uvc: torch.Tensor     # [N, K, 2] integer patch centers * scale
    patch: torch.Tensor   # [N, K, Q, Q] central blurred-patch slice


_PATCH_SLICE_R = subpix.SSD_R + 1


def detect_points_multilevel(img: torch.Tensor, fast_th: torch.Tensor,
                             cfg: VOConfig) -> DetectedPoints:
    """Multi-level FAST + oriented BRIEF on [N, H, W] images with
    per-image thresholds [N]; K = cfg.orb_nfeatures."""
    N = img.shape[0]
    budgets = _per_level_budgets(cfg)
    out = {k: [] for k in DetectedPoints._fields}
    pyr = pyramid_levels(img, cfg.orb_nlevels, cfg.orb_scale_factor,
                         blur_sigma=0.6)
    R = orb.PATCH_R
    for lv in range(cfg.orb_nlevels):
        cur = pyr[lv]
        uv, sc, v = fast_ops.detect_keypoints(
            cur, fast_th, budgets[lv], edge=cfg.orb_edge_th, cell=4,
            score_type=cfg.orb_score, subpix=cfg.subpix_points)
        blur = gaussian_blur(cur, 2.0, radius=3)
        p = orb.gather_patches(blur, uv)
        if cfg.orb_wta_k == 2:
            desc, _, _ = orb.orient_describe(p, patch_size=cfg.orb_patch_size)
        else:
            q = torch.clamp(torch.round(p), 0.0, 255.0)
            c, s = orb.orientation(q)
            desc = orb.describe_wta(q, c, s, cfg.orb_wta_k,
                                    patch_size=cfg.orb_patch_size)
        scale = cfg.orb_scale_factor ** lv
        Hl, Wl = cur.shape[-2:]
        cx = torch.clamp(torch.round(uv[..., 0]), R, Wl - 1 - R)
        cy = torch.clamp(torch.round(uv[..., 1]), R, Hl - 1 - R)
        out["uvc"].append(torch.stack([cx, cy], dim=-1) * scale)
        if cfg.subpix_disp:
            qr = _PATCH_SLICE_R
            out["patch"].append(p[..., R - qr:R + qr + 1, R - qr:R + qr + 1])
        else:
            out["patch"].append(p[..., :0, :0])
        out["uv"].append(uv * scale)
        out["desc"].append(desc)
        out["level"].append(torch.full((N, budgets[lv]), lv,
                                       dtype=torch.int32, device=img.device))
        out["score"].append(sc)
        out["valid"].append(v)
    return DetectedPoints(**{k: torch.cat(v, dim=1) for k, v in out.items()})


def _take(x: torch.Tensor, j: torch.Tensor) -> torch.Tensor:
    """x [B, M, ...] gathered at j [B, K] along axis 1 -> [B, K, ...]."""
    idx = j.reshape(j.shape + (1,) * (x.ndim - 2)).expand(
        j.shape + x.shape[2:])
    return torch.gather(x, 1, idx)


def match_stereo_points(det_l: DetectedPoints, det_r: DetectedPoints,
                        cam: cam_ops.StereoCamera,
                        cfg: VOConfig) -> PointSet:
    """Grid-windowed stereo matching + epipolar / disparity filters +
    back-projection, [B, K] lanes.  With cfg.subpix_disp the disparity is
    re-estimated photometrically when both corners share a level."""
    uv_l, desc_l, level_l, valid_l = (det_l.uv, det_l.desc, det_l.level,
                                      det_l.valid)
    inv_w = cfg.grid_cols / float(cam.width)
    inv_h = cfg.grid_rows / float(cam.height)
    cand = matching.stereo_point_window_mask(uv_l, det_r.uv, inv_w, inv_h,
                                             cfg.matching_s_ws)
    cand = cand & valid_l[..., :, None] & det_r.valid[..., None, :]
    res = matching.match_auto(desc_l, det_r.desc, cand, cfg.min_ratio_12_p,
                              cfg, wta_k=cfg.orb_wta_k)

    j = torch.clamp(res.idx, min=0)
    uv_rm = _take(det_r.uv, j)
    epip_ok = torch.abs(uv_l[..., 1] - uv_rm[..., 1]) <= cfg.max_dist_epip
    disp = uv_l[..., 0] - uv_rm[..., 0]
    lvl_f = level_l.to(uv_l.dtype)
    if cfg.subpix_disp:
        scale_l = cfg.orb_scale_factor ** lvl_f
        shift, sok = subpix.disparity_shift(det_l.patch,
                                            _take(det_r.patch, j))
        d_photo = ((det_l.uvc[..., 0] - _take(det_r.uvc, j)[..., 0])
                   - scale_l * shift)
        use = (sok & (level_l == _take(det_r.level, j))
               & (torch.abs(d_photo - disp) <= 2.0 * scale_l))
        disp = torch.where(use, d_photo, disp)
    ok = res.valid & epip_ok & (disp >= cfg.min_disp)

    P = cam_ops.back_project(cam, uv_l,
                             torch.where(ok, disp, torch.ones_like(disp)))
    sigma2 = cfg.orb_scale_factor ** (-2.0 * lvl_f)
    return PointSet(uv=uv_l, disp=torch.where(ok, disp,
                                              torch.zeros_like(disp)),
                    P=P, desc=desc_l, level=level_l, sigma2=sigma2, valid=ok)


def extract_stereo_features(img_l: torch.Tensor, img_r: torch.Tensor,
                            fast_th: torch.Tensor,
                            cam: cam_ops.StereoCamera,
                            cfg: VOConfig) -> FrameFeatures:
    """Front end for B stereo pairs [B, H, W] with thresholds [B]: points
    (both eyes in one batch) and empty line sets."""
    if cfg.has_lines:
        raise NotImplementedError(
            "has_lines=True: the line half (LSD with its run kernel, LBD, "
            "stereo line matching) is slice 2 of the port")
    B = img_l.shape[0]
    dev, dtype = img_l.device, img_l.dtype
    if cfg.has_points:
        det = detect_points_multilevel(torch.cat([img_l, img_r]),
                                       torch.cat([fast_th, fast_th]), cfg)
        det_l = DetectedPoints(*[t[:B] for t in det])
        det_r = DetectedPoints(*[t[B:] for t in det])
        points = match_stereo_points(det_l, det_r, cam, cfg)
    else:
        points = empty_points(cfg.point_capacity, dtype, dev, (B,))
    lines = empty_lines(cfg.line_capacity, dtype, dev, (B,))
    return FrameFeatures(points=points, lines=lines)
