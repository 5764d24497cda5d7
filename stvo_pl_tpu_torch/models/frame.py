"""Per-frame stereo feature extraction (port of
stvo_pl_tpu/models/frame.py; reference src/stereoFrame.cpp:59-398).

Lanes and eyes are one leading image axis: the left images of all lanes
followed by the right images go through the pyramid, the FAST kernel and
the patch kernel together, one launch per pyramid level, and through the
octave canvas, its level-line field and ONE launch of the LSD run kernel.
Everything sized by a line capacity then runs per eye over the lanes (the
eyes have different detection pools).  Stereo matching is a dense masked
Hamming matrix + grid-window predicate + NNR + mutual check, then
vectorized epipolar / disparity (points) or direction / overlap /
disparity-ratio (lines) filters and back-projection under the same mask.

Lines come from the one-pass multi-octave canvas detector
(`lsd_octaves > 1`, the default) or from the dense single-octave detector
(`lsd_octaves <= 1`: `detect_lines_scaled` on the `lsd_scale`-resampled
image, LBD on the full-resolution Sobel planes), whose run candidates come
from either generator of ops/lsd.py (`per_direction`), or from the
EDLine detector (`use_edlines`, ops/edline.py, both eyes in one pass,
optionally at 1/edline_scale resolution).  `extract_rgbd_features` is the
RGB-D front end: one intensity image and a registered depth map per lane.
Both front ends stamp `points` and `lines` where each half ends
(utils/profiling.stamp).
"""

from __future__ import annotations

from typing import NamedTuple

import math

import numpy as np
import torch

from stvo_pl_tpu_torch.config import VOConfig
from stvo_pl_tpu_torch.device import const, device_cache
from stvo_pl_tpu_torch.models.features import (LineSet, PointSet,
                                               empty_lines, empty_points)
from stvo_pl_tpu_torch.ops import camera as cam_ops
from stvo_pl_tpu_torch.ops import fast as fast_ops
from stvo_pl_tpu_torch.ops import edline, lbd, lsd, matching, orb, subpix
from stvo_pl_tpu_torch.ops.image import (gaussian_blur, pyramid_levels,
                                         resize_bilinear, sobel)
from stvo_pl_tpu_torch.utils.profiling import stamp


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


_take = lsd.take      # x [B, M, ...] at j [B, K] along axis 1


def match_stereo_points(det_l: DetectedPoints, det_r: DetectedPoints,
                        cam: cam_ops.StereoCamera, cfg: VOConfig,
                        tp=None) -> PointSet:
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
                              cfg, tp=tp, wta_k=cfg.orb_wta_k)

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


def _line_coeffs(sp: torch.Tensor, ep: torch.Tensor) -> torch.Tensor:
    """Normalized infinite-line coefficients le = (sp x ep) / |(a, b)| of
    the homogeneous endpoints (src/stereoFrame.cpp:356-358)."""
    le = torch.stack([sp[..., 1] - ep[..., 1], ep[..., 0] - sp[..., 0],
                      sp[..., 0] * ep[..., 1] - sp[..., 1] * ep[..., 0]],
                     dim=-1)
    n = torch.sqrt(le[..., 0] ** 2 + le[..., 1] ** 2)
    return le / torch.clamp(n, min=1e-12)[..., None]


def _overlap_stereo(sy_l, ey_l, sy_r, ey_r, horiz_th: float):
    """Vertical-interval overlap ratio (lineSegmentOverlapStereo,
    src/stereoFrame.cpp:473-508)."""
    sln = torch.minimum(sy_l, ey_l)
    eln = torch.maximum(sy_l, ey_l)
    spn = torch.minimum(sy_r, ey_r)
    epn = torch.maximum(sy_r, ey_r)
    length = eln - spn
    disjoint = (epn < sln) | (spn > eln)
    contains = (epn > eln) & (spn < sln)
    zero = torch.zeros_like(length)
    ov = torch.where(contains, eln - sln,
                     torch.minimum(eln, epn) - torch.maximum(sln, spn))
    ov = torch.where(disjoint, zero, ov)
    ov = torch.where(length > 0.01, ov / length, zero)
    ov = torch.clamp(ov, max=1.0)
    # near-horizontal observed lines keep overlap = 1 (reference gate)
    return torch.where(torch.abs(ey_l - sy_l) > horiz_th, ov,
                       torch.ones_like(ov))


def match_stereo_lines(lines_l: lsd.LineSegments, desc_l: torch.Tensor,
                       lines_r: lsd.LineSegments, desc_r: torch.Tensor,
                       cam: cam_ops.StereoCamera, cfg: VOConfig,
                       level_l: torch.Tensor | None = None,
                       tp=None) -> LineSet:
    """Stereo line matching over [B, K] lanes: direction + grid proximity
    candidates, NNR + mutual, endpoint disparity by line intersection,
    overlap and disparity consistency filters, endpoint back-projection
    (matchStereoLines, src/stereoFrame.cpp:309-398)."""
    inv_w = cfg.grid_cols / float(cam.width)
    inv_h = cfg.grid_rows / float(cam.height)
    dtype = lines_l.sp.dtype

    cand = matching.stereo_line_window_mask(
        lines_l.sp, lines_l.ep, lines_r.sp, lines_r.ep, inv_w, inv_h,
        cfg.matching_s_ws)
    d_l = lines_l.ep - lines_l.sp
    d_r = lines_r.ep - lines_r.sp
    u_l = d_l / torch.clamp(lsd.norm2(d_l), min=1e-6)[..., None]
    u_r = d_r / torch.clamp(lsd.norm2(d_r), min=1e-6)[..., None]
    cand = cand & matching.line_direction_mask(u_l, u_r, cfg.line_sim_th)
    cand = cand & lines_l.valid[..., :, None] & lines_r.valid[..., None, :]
    res = matching.match_auto(desc_l, desc_r, cand, cfg.min_ratio_12_p, cfg,
                              tp=tp)

    j = torch.clamp(res.idx, min=0)
    sp_r = _take(lines_r.sp, j)
    ep_r = _take(lines_r.ep, j)
    sp_l, ep_l = lines_l.sp, lines_l.ep

    overlap = _overlap_stereo(sp_l[..., 1], ep_l[..., 1], sp_r[..., 1],
                              ep_r[..., 1], cfg.line_horiz_th)

    # x of the matched right line at the left endpoints' rows
    # (src/stereoFrame.cpp:366-368)
    dy_r = sp_r[..., 1] - ep_r[..., 1]
    dy_safe = torch.where(torch.abs(dy_r) < 1e-6,
                          torch.full_like(dy_r, 1e-6), dy_r)

    def x_at(y):
        return (sp_r[..., 0] * (y - ep_r[..., 1])
                + ep_r[..., 0] * (sp_r[..., 1] - y)) / dy_safe

    disp_s = sp_l[..., 0] - x_at(sp_l[..., 1])
    disp_e = ep_l[..., 0] - x_at(ep_l[..., 1])
    # disparity consistency (filterLineSegmentDisparity, :405-415)
    d_max = torch.maximum(disp_s, disp_e)
    ratio = torch.minimum(disp_s, disp_e) / torch.where(
        d_max == 0, torch.full_like(d_max, 1e-6), d_max)

    ok = (res.valid & (ratio >= cfg.ls_min_disp_ratio)
          & (disp_s >= cfg.min_disp) & (disp_e >= cfg.min_disp)
          & (torch.abs(sp_l[..., 1] - ep_l[..., 1]) > cfg.line_horiz_th)
          & (torch.abs(sp_r[..., 1] - ep_r[..., 1]) > cfg.line_horiz_th)
          & (overlap > cfg.stereo_overlap_th))

    one, zero = torch.ones_like(disp_s), torch.zeros_like(disp_s)
    sP = cam_ops.back_project(cam, sp_l, torch.where(ok, disp_s, one))
    eP = cam_ops.back_project(cam, ep_l, torch.where(ok, disp_e, one))
    # per-octave inverse variance sigma2 = lsd_scale^(-2 * level)
    # (src/stereoFeatures.cpp:107-115: the reference's formula uses
    # Config::lsdScale, not the pyramid ratio 2 the octaves were built
    # with; kept, so the default lsd_scale = 1.0 weighs every octave
    # equally)
    if level_l is None:
        level_l = torch.zeros(sp_l.shape[:-1], dtype=torch.int32,
                              device=sp_l.device)
    sigma2 = torch.pow(
        const(float(cfg.lsd_scale), dtype, sp_l.device),
        -2.0 * level_l.to(dtype))
    return LineSet(
        spl=sp_l, epl=ep_l, sdisp=torch.where(ok, disp_s, zero),
        edisp=torch.where(ok, disp_e, zero), sP=sP, eP=eP,
        le=_line_coeffs(sp_l, ep_l), angle=lines_l.angle, desc=desc_l,
        level=level_l, sigma2=sigma2, valid=ok)


def _length_buckets(length: torch.Tensor, valid: torch.Tensor, cap: int):
    """Split the capacity into a long half and a short half by measured
    length (two-bucket length-adaptive LBD, see config.lbd_long_samples).
    Returns (long_idx [B, cap // 2], short_idx [B, cap - cap // 2])."""
    key = -torch.where(valid, length, torch.zeros_like(length))
    order = torch.sort(key, dim=-1, stable=True).indices
    half = cap // 2
    return order[..., :half], order[..., half:]


class DenseField(NamedTuple):
    """What the dense single-octave detector computes once for every image
    of a batch: the level-line field of the detection image and its run
    maps."""
    src_hw: tuple          # (H0, W0) of the source images
    ang: torch.Tensor      # [N, Hs, Ws] field of the resampled images
    mag: torch.Tensor      # [N, Hs, Ws]
    packed: torch.Tensor   # run maps, as ops/lsd.run_maps returns them
    per_direction: bool    # the generator the maps come from


def dense_field(im: torch.Tensor, cfg: VOConfig,
                per_direction: bool = False) -> DenseField:
    """The image-sized half of `detect_lines_scaled` for [N, H, W] images:
    the `lsd_scale` resample (cv::LSD detects on a Gaussian-smoothed image
    resampled by `scale`; sigma = sigma_scale for upsampling, sigma_scale /
    scale for downsampling; the blur is composed into the resize), the
    level-line field and the run kernel(s) over all N images."""
    scale = float(cfg.lsd_scale)
    H0, W0 = im.shape[-2:]
    det_im = im
    if scale != 1.0:
        sigma = (cfg.lsd_sigma_scale / scale if scale < 1.0
                 else cfg.lsd_sigma_scale)
        det_im = resize_bilinear(im, int(round(H0 * scale)),
                                 int(round(W0 * scale)), blur_sigma=sigma)
    ang, mag = lsd.line_field(det_im)
    packed = lsd.run_maps(ang, mag, cfg.lsd_n_dirs, cfg.lsd_ang_th,
                          cfg.lsd_quant, per_direction)
    return DenseField(src_hw=(H0, W0), ang=ang, mag=mag, packed=packed,
                      per_direction=per_direction)


def lines_from_field(fd: DenseField, min_line_length: float, cfg: VOConfig,
                     lite: bool = False) -> lsd.LineSegments:
    """The capacity-sized half of `detect_lines_scaled` for the images of
    `fd`: candidates, merges, refit and validation in detection
    coordinates, then the exact per-axis half-pixel-centre map back to the
    source image (rounded output sizes make each axis' effective scale
    differ slightly from cfg.lsd_scale).

    `lite` halves the along-line refit samples (the right eye's lines feed
    only stereo matching).  cv::LSD always validates a-contrario
    (-log10(NFA) > 0); cfg.lsd_log_eps replaces that threshold only in
    advanced-refinement mode (lsd_refine >= 2)."""
    scale = float(cfg.lsd_scale)
    segs = lsd.segments_from_runs(
        fd.ang, fd.mag, fd.packed, min_line_length * scale,
        capacity=cfg.line_capacity, n_dirs=cfg.lsd_n_dirs,
        ang_th_deg=cfg.lsd_ang_th, density_th=cfg.lsd_density_th,
        refine=not cfg.use_fld_lines, refine_samples=8 if lite else 16,
        log_eps=(cfg.lsd_log_eps if cfg.lsd_refine >= 2 else 0.0),
        per_direction=fd.per_direction)
    if scale != 1.0:
        H0, W0 = fd.src_hw
        Hs, Ws = fd.mag.shape[-2:]
        inv = const((W0 / Ws, H0 / Hs), segs.sp.dtype, segs.sp.device)
        lim = const((W0 - 1.0, H0 - 1.0), segs.sp.dtype, segs.sp.device)

        def to_src(p):
            return torch.minimum(
                torch.clamp((p + 0.5) * inv - 0.5, min=0.0), lim)

        segs = segs._replace(sp=to_src(segs.sp), ep=to_src(segs.ep),
                             length=segs.length / scale)
    return segs


def detect_lines_scaled(im: torch.Tensor, min_line_length: float,
                        cfg: VOConfig, lite: bool = False,
                        per_direction: bool = False) -> lsd.LineSegments:
    """Dense single-octave LSD detection on [N, H, W] images honoring
    lsd_scale / lsd_sigma_scale: `dense_field` then `lines_from_field`."""
    return lines_from_field(dense_field(im, cfg, per_direction),
                            min_line_length, cfg, lite=lite)


def _lbd_two_bucket(gx: torch.Tensor, gy: torch.Tensor,
                    segs: lsd.LineSegments, cfg: VOConfig) -> torch.Tensor:
    """LBD with length-adaptive along-line sampling, [N, K, 8] int32.

    The longer half of the capacity gets cfg.lbd_long_samples samples, the
    shorter half keeps the 8-sample grid; band statistics are mean / std
    over samples, so both buckets' descriptors live in the same space."""
    if cfg.lbd_long_samples <= lbd.N_SAMPLES:
        return lbd.compute_lbd(gx, gy, segs.sp, segs.ep)[1]
    N, cap = segs.sp.shape[:2]
    li, si = _length_buckets(segs.length, segs.valid, cap)
    desc = torch.zeros((N, cap, 8), dtype=torch.int32, device=gx.device)
    for idx, n_samples in ((li, cfg.lbd_long_samples), (si, lbd.N_SAMPLES)):
        _, d = lbd.compute_lbd(gx, gy, _take(segs.sp, idx),
                               _take(segs.ep, idx), n_samples=n_samples)
        desc = desc.scatter(1, idx[..., None].expand(-1, -1, 8), d)
    return desc


def _slice_field(fd: DenseField, sl: slice) -> DenseField:
    return fd._replace(ang=fd.ang[sl], mag=fd.mag[sl], packed=fd.packed[sl])


def _octave_images(im: torch.Tensor, n_oct: int) -> list[torch.Tensor]:
    """Ratio-2 Gaussian pyramid of [N, H, W] images (pyrDown equivalent:
    the antialiasing blur composed into the resize product,
    LSDDetector_custom.cpp:56-73)."""
    imgs = [im]
    cur = im
    for _ in range(1, n_oct):
        H, W = cur.shape[-2:]
        if min(H, W) < 64:
            break
        cur = resize_bilinear(cur, H // 2, W // 2, blur_sigma=1.0)
        imgs.append(cur)
    return imgs


def _octave_layout(shapes: list[tuple], gap: int = 16):
    """Pack octave regions into one canvas: octave 0 at the top-left, the
    coarser octaves side by side in a strip below it, every region
    separated by `gap` zero pixels (wide enough that run thickening,
    collinear merging with gap_tol <= 8 and the +-2 px refine taps can
    never bridge two regions).  Returns ((y0, x0, Ho, Wo) per octave,
    canvas (H, W))."""
    H0, W0 = shapes[0]
    regs = [(0, 0, H0, W0)]
    if len(shapes) > 1:
        y = H0 + gap
        x = 0
        strip_h = shapes[1][0]
        for (Ho, Wo) in shapes[1:]:
            regs.append((y, x, Ho, Wo))
            x += Wo + gap
        Hc = H0 + gap + strip_h
        Wc = max(W0, x - gap)
    else:
        Hc, Wc = H0, W0
    return regs, (Hc, Wc)


@device_cache
def _interior_mask(regs: tuple, Hc: int, Wc: int, device: torch.device):
    """[Hc, Wc] bool: each region shrunk by 2 px (the zero gap makes the
    2x2 level-line field see a spurious strong edge along every region
    border)."""
    interior = np.zeros((Hc, Wc), bool)
    for (y0, x0, Ho, Wo) in regs:
        interior[y0 + 2:y0 + Ho - 2, x0 + 2:x0 + Wo - 2] = True
    return torch.from_numpy(interior).to(device)


class OctaveCanvas(NamedTuple):
    """What the line detector computes once for every image of a batch:
    the octave regions, the canvas' level-line field, its packed run maps
    and the same-layout Sobel atlas."""
    regs: tuple            # (y0, x0, Ho, Wo) per octave
    ang: torch.Tensor      # [N, Hc, Wc]
    mag: torch.Tensor      # [N, Hc, Wc]
    packed: torch.Tensor   # [N, D, Hp / 8, Wp] run maps
    g2: torch.Tensor       # [N, Hc, Wc, 2] (gx, gy) of each octave plane


def _oct_dirs(cfg: VOConfig) -> int:
    return cfg.lsd_oct_n_dirs if cfg.lsd_oct_n_dirs > 0 else cfg.lsd_n_dirs


def octave_canvas(im: torch.Tensor, cfg: VOConfig) -> OctaveCanvas:
    """All octave images of [N, H, W] packed into one canvas per image
    (`_octave_layout`, the guard gaps excluded from detection), its
    level-line field, ONE launch of the run kernel over all N canvases,
    and the Sobel atlas the descriptors read."""
    N = im.shape[0]
    imgs = _octave_images(im, max(1, cfg.lsd_octaves))
    regs, (Hc, Wc) = _octave_layout([tuple(i.shape[-2:]) for i in imgs])
    canvas = torch.zeros((N, Hc, Wc), dtype=im.dtype, device=im.device)
    g2 = torch.zeros((N, Hc, Wc, 2), dtype=im.dtype, device=im.device)
    for (y0, x0, Ho, Wo), img_o in zip(regs, imgs):
        canvas[:, y0:y0 + Ho, x0:x0 + Wo] = img_o
        gx, gy = sobel(img_o)
        g2[:, y0:y0 + Ho, x0:x0 + Wo, 0] = gx
        g2[:, y0:y0 + Ho, x0:x0 + Wo, 1] = gy
    ang, mag = lsd.line_field(
        canvas, valid_mask=_interior_mask(tuple(regs), Hc, Wc, im.device))
    packed = lsd.run_maps(ang, mag, _oct_dirs(cfg), cfg.lsd_ang_th,
                          cfg.lsd_quant)
    return OctaveCanvas(regs=tuple(regs), ang=ang, mag=mag, packed=packed,
                        g2=g2)


def lines_from_canvas(cv: OctaveCanvas, min_line_length: float,
                      cfg: VOConfig, pool: float | None = None):
    """The capacity-sized half of the multi-octave detector, for the
    images of `cv`: candidates -> merges -> refine -> validation in canvas
    (= octave) coordinates, so every octave competes by in-octave length;
    mapping back to level-0 coordinates; a level-0 re-refine of the
    coarse-octave survivors; one cross-octave duplicate suppression; the
    final capacity by level-0 length; and LBD once over the survivors,
    each line sampling its own octave's Sobel plane in the atlas.

    `pool` oversizes the detection pool (default cfg.lsd_oct_pool).
    Returns (LineSegments in octave-0 coords, octave [N, K] int32, LBD
    descriptors [N, K, 8] int32), K = cfg.line_capacity."""
    regs = cv.regs
    n_oct = len(regs)
    H0, W0 = regs[0][2], regs[0][3]
    cap = cfg.line_capacity
    dtype, dev = cv.mag.dtype, cv.mag.device
    N = cv.mag.shape[0]

    if pool is None:
        pool = cfg.lsd_oct_pool
    det_cap = int(round(cap * pool)) if n_oct > 1 else cap
    det_cap = max(det_cap, cap)
    # raw-run pool sized by content (octave pixels / level-0 pixels)
    content = sum(r[2] * r[3] for r in regs)
    kt = max(int(round(2 * cap * content / float(H0 * W0))),
             det_cap + cap // 2)
    segs = lsd.segments_from_runs(
        cv.ang, cv.mag, cv.packed, min_line_length, capacity=det_cap,
        n_dirs=_oct_dirs(cfg), ang_th_deg=cfg.lsd_ang_th,
        density_th=cfg.lsd_density_th, refine=not cfg.use_fld_lines,
        log_eps=(cfg.lsd_log_eps if cfg.lsd_refine >= 2 else 0.0),
        k_total=kt)

    # region -> octave attribution by midpoint, then region-local coords
    reg_t = const(tuple(regs), torch.int64, dev)                # [O, 4]
    y0s, x0s, Hos, Wos = reg_t[:, 0], reg_t[:, 1], reg_t[:, 2], reg_t[:, 3]
    mid = 0.5 * (segs.sp + segs.ep)
    octv = torch.zeros((N, det_cap), dtype=torch.int64, device=dev)
    in_any = torch.zeros((N, det_cap), dtype=torch.bool, device=dev)
    for o, (y0, x0, Ho, Wo) in enumerate(regs):
        inside = ((mid[..., 1] >= y0) & (mid[..., 1] < y0 + Ho)
                  & (mid[..., 0] >= x0) & (mid[..., 0] < x0 + Wo))
        octv = torch.where(inside, o, octv)
        in_any = in_any | inside
    off = torch.stack([x0s, y0s], dim=-1).to(dtype)[octv]        # [N, K, 2]
    ext = torch.stack([Wos, Hos], dim=-1).to(dtype)[octv]

    def clip(p, hi):
        return torch.minimum(torch.clamp(p, min=0.0), hi)

    sp_oct = clip(segs.sp - off, ext - 1.0)
    ep_oct = clip(segs.ep - off, ext - 1.0)
    len_oct = lsd.norm2(ep_oct - sp_oct)

    # exact half-pixel-center map to octave-0 coords (integer halving makes
    # the effective per-axis factor differ slightly from 2^o)
    inv = const((W0, H0), dtype, dev) / ext
    lim = const((W0 - 1.0, H0 - 1.0), dtype, dev)
    sp0 = clip((sp_oct + 0.5) * inv - 0.5, lim)
    ep0 = clip((ep_oct + 0.5) * inv - 0.5, lim)
    v = segs.valid & in_any
    zero = torch.zeros((), dtype=dtype, device=dev)

    if n_oct > 1:
        # level-0 precision pass for the coarse-octave survivors: a coarse
        # detection carries up to +-2^o px of level-0 position noise.  The
        # coarse lines are compacted to cap // 2 slots and re-refined by
        # the same weighted-LSQ fit against the canvas field's octave-0
        # region (== the level-0 field), with a widened +-3 px search.
        tol = math.radians(cfg.lsd_ang_th)
        coarse_score = torch.where(v & (octv > 0), len_oct,
                                   torch.full_like(len_oct, -1.0))
        csel, ci = lsd.top_k(coarse_score, max(cap // 2, 1))
        do_ref = csel > 0
        sp_c, ep_c = _take(sp0, ci), _take(ep0, ci)
        sp_r, ep_r, _, _, _ = lsd._refine_segments(
            cv.ang[:, :H0, :W0], cv.mag[:, :H0, :W0], sp_c[..., 0],
            sp_c[..., 1], ep_c[..., 0], ep_c[..., 1], do_ref, tol,
            n_samples=cfg.lsd_oct_l0_samples, search=3)
        upd = do_ref[..., None]
        ci2 = ci[..., None].expand(-1, -1, 2)
        sp0 = sp0.scatter(1, ci2, torch.where(upd, clip(sp_r, lim), sp_c))
        ep0 = ep0.scatter(1, ci2, torch.where(upd, clip(ep_r, lim), ep_c))
        # refined coarse endpoints feed the LBD in octave coords too
        sp_oct = clip((sp0 + 0.5) / inv - 0.5, ext - 1.0)
        ep_oct = clip((ep0 + 0.5) / inv - 0.5, ext - 1.0)

        # the same physical line detected at 2+ octaves: keep the copy
        # with the longer level-0 extent
        len0_d = lsd.norm2(ep0 - sp0)
        v = lsd._suppress_duplicates(sp0, ep0, torch.where(v, len0_d, zero),
                                     v, perp_tol=3.0, overlap_tol=0.5)

    if det_cap != cap:
        # final capacity: best cap lines by level-0 length after dedup
        resp_sel = torch.where(v, lsd.norm2(ep0 - sp0), zero)
        top, psel = lsd.top_k(resp_sel, cap)
        sp0, ep0, sp_oct, ep_oct, octv, len_oct = (
            _take(a, psel) for a in (sp0, ep0, sp_oct, ep_oct, octv, len_oct))
        v = top > 0

    # LBD once over the survivors: taps clip to the line's own region
    # before the offset, so support regions never cross the gaps
    x_off, y_off = x0s[octv], y0s[octv]
    x_hi, y_hi = (Wos - 1)[octv], (Hos - 1)[octv]
    if cfg.lbd_long_samples > lbd.N_SAMPLES:
        li, si = _length_buckets(len_oct, v, cap)
        desc = torch.zeros((N, cap, 8), dtype=torch.int32, device=dev)
        for idx, n_samples in ((li, cfg.lbd_long_samples),
                               (si, lbd.N_SAMPLES)):
            _, d = lbd.compute_lbd_atlas(
                cv.g2, _take(sp_oct, idx), _take(ep_oct, idx),
                _take(x_off, idx), _take(y_off, idx), _take(x_hi, idx),
                _take(y_hi, idx), n_samples=n_samples)
            desc = desc.scatter(1, idx[..., None].expand(-1, -1, 8), d)
    else:
        _, desc = lbd.compute_lbd_atlas(cv.g2, sp_oct, ep_oct, x_off, y_off,
                                        x_hi, y_hi)

    dvec = ep0 - sp0
    segs_out = lsd.LineSegments(
        sp=sp0, ep=ep0, angle=torch.atan2(dvec[..., 1], dvec[..., 0]),
        length=torch.where(v, lsd.norm2(dvec), zero),
        resp=torch.where(v, len_oct, zero), valid=v)
    return segs_out, octv.to(torch.int32), desc


def detect_lines_octaves(im: torch.Tensor, min_line_length: float,
                         cfg: VOConfig, pool: float | None = None):
    """One-pass multi-octave line detection + octave-correct LBD on
    [N, H, W] images: `octave_canvas` then `lines_from_canvas`."""
    return lines_from_canvas(octave_canvas(im, cfg), min_line_length, cfg,
                             pool=pool)


def _slice_segs(segs: lsd.LineSegments, sl: slice) -> lsd.LineSegments:
    return lsd.LineSegments(*[x[sl] for x in segs])


def _slice_canvas(cv: OctaveCanvas, sl: slice) -> OctaveCanvas:
    return cv._replace(ang=cv.ang[sl], mag=cv.mag[sl], packed=cv.packed[sl],
                       g2=cv.g2[sl])


def detect_edlines_stereo(im: torch.Tensor, min_line_length: float,
                          cfg: VOConfig) -> lsd.LineSegments:
    """EDLines on [N, H, W] images as the stereo front end runs it
    (stvo_pl_tpu/models/frame.py:622-654).  With edline_scale f > 1 the
    detection runs on the antialiased 1/f image: the resize low-passes, so
    the detector's own sigma-1 pre-smooth is skipped; support and length
    thresholds move to detection coordinates, the node budget shrinks with
    the pixel count (~7% edge area), and the segments are mapped back to
    the source image by the exact half-pixel-centre map."""
    f = max(1, int(cfg.edline_scale))
    H0, W0 = im.shape[-2:]
    det_im = im
    if f > 1:
        det_im = resize_bilinear(im, H0 // f, W0 // f, blur_sigma=1.0)
    Hd, Wd = det_im.shape[-2:]
    segs = edline.detect_edlines(
        det_im, min_line_length / f, capacity=cfg.line_capacity,
        grad_th=cfg.edline_grad_th, anchor_th=cfg.edline_anchor_th,
        ang_tol_deg=cfg.edline_ang_tol,
        min_support=max(4, cfg.edline_min_support // f),
        straight_tol=cfg.edline_straight_tol,
        density_th=cfg.edline_density_th,
        split_rounds=cfg.edline_split_rounds,
        smooth_sigma=0.0 if f > 1 else 1.0,
        node_capacity=min(16384, max(2048, (Hd * Wd) // 14)))
    if f > 1:
        inv = const((W0 / Wd, H0 / Hd), segs.sp.dtype, segs.sp.device)
        lim = const((W0 - 1.0, H0 - 1.0), segs.sp.dtype, segs.sp.device)

        def to0(p):
            return torch.minimum(torch.clamp((p + 0.5) * inv - 0.5, min=0.0),
                                 lim)

        sp0, ep0 = to0(segs.sp), to0(segs.ep)
        d0 = ep0 - sp0
        segs = segs._replace(sp=sp0, ep=ep0,
                             angle=torch.atan2(d0[..., 1], d0[..., 0]),
                             length=lsd.norm2(d0))
    return segs


def extract_stereo_features(img_l: torch.Tensor, img_r: torch.Tensor,
                            fast_th: torch.Tensor, min_line_length: float,
                            cam: cam_ops.StereoCamera, cfg: VOConfig,
                            per_direction: bool = False,
                            tp=None) -> FrameFeatures:
    """Front end for B stereo pairs [B, H, W] with FAST thresholds [B] and
    the line-length threshold in pixels: points and lines, both eyes in
    one batch through every kernel.  `per_direction` selects the run
    candidate generator of the dense single-octave detector
    (`lsd_octaves <= 1`); the octave canvas always takes the all-direction
    one.  With `use_edlines` both eyes go through one EDLines pass and one
    LBD pass at full density, level 0 for every line.  `tp` = (model-axis
    process group, shards) column-shards the matchers' distance matrices
    (ops/matching.match_auto)."""
    B = img_l.shape[0]
    dev, dtype = img_l.device, img_l.dtype
    both = torch.cat([img_l, img_r])
    if cfg.has_points:
        det = detect_points_multilevel(both, torch.cat([fast_th, fast_th]),
                                       cfg)
        det_l = DetectedPoints(*[t[:B] for t in det])
        det_r = DetectedPoints(*[t[B:] for t in det])
        points = match_stereo_points(det_l, det_r, cam, cfg, tp=tp)
    else:
        points = empty_points(cfg.point_capacity, dtype, dev, (B,))
    stamp("points")

    if cfg.has_lines and cfg.use_edlines:
        segs = detect_edlines_stereo(both, min_line_length, cfg)
        gx, gy = sobel(both)
        ldesc = _lbd_two_bucket(gx, gy, segs, cfg)
        lines = match_stereo_lines(
            _slice_segs(segs, slice(0, B)), ldesc[:B],
            _slice_segs(segs, slice(B, 2 * B)), ldesc[B:], cam, cfg, tp=tp)
    elif cfg.has_lines and cfg.lsd_octaves <= 1:
        fd = dense_field(both, cfg, per_direction)
        gx, gy = sobel(both)
        eyes = []
        for sl, lite in ((slice(0, B), False),
                         (slice(B, 2 * B), cfg.lsd_right_lite)):
            segs = lines_from_field(_slice_field(fd, sl), min_line_length,
                                    cfg, lite=lite)
            eyes.append((segs, _lbd_two_bucket(gx[sl], gy[sl], segs, cfg)))
        (segs_l, ldesc_l), (segs_r, ldesc_r) = eyes
        lines = match_stereo_lines(segs_l, ldesc_l, segs_r, ldesc_r, cam,
                                   cfg, tp=tp)
    elif cfg.has_lines:
        cv = octave_canvas(both, cfg)
        segs_l, octv_l, ldesc_l = lines_from_canvas(
            _slice_canvas(cv, slice(0, B)), min_line_length, cfg)
        segs_r, _, ldesc_r = lines_from_canvas(
            _slice_canvas(cv, slice(B, 2 * B)), min_line_length, cfg,
            pool=(cfg.lsd_oct_pool_right if cfg.lsd_oct_pool_right > 0
                  else None))
        lines = match_stereo_lines(segs_l, ldesc_l, segs_r, ldesc_r, cam,
                                   cfg, level_l=octv_l, tp=tp)
    else:
        lines = empty_lines(cfg.line_capacity, dtype, dev, (B,))
    stamp("lines")
    return FrameFeatures(points=points, lines=lines)



def _sample_depth(depth: torch.Tensor, uv: torch.Tensor) -> torch.Tensor:
    """Nearest-pixel lookup of depth [B, H, W] at uv [B, K, 2] (the
    reference reads img_r.at<float>(y, x), src/stereoFrame.cpp:710)."""
    H, W = depth.shape[-2:]
    x = torch.clamp(torch.round(uv[..., 0]).to(torch.int64), 0, W - 1)
    y = torch.clamp(torch.round(uv[..., 1]).to(torch.int64), 0, H - 1)
    return lsd._gather2d(depth, y, x)


def extract_rgbd_features(img: torch.Tensor, depth: torch.Tensor,
                          fast_th: torch.Tensor, min_line_length: float,
                          cam: cam_ops.StereoCamera, cfg: VOConfig,
                          per_direction: bool = False) -> FrameFeatures:
    """RGB-D front end for B lanes (extractRGBDFeatures,
    src/stereoFrame.cpp:667-818): detect on the intensity images [B, H, W]
    only; disparity comes from the registered metric depth maps [B, H, W]
    (disp = fx b / depth; invalid pixels <= 0), gated by rgbd_min/max_depth
    and min_disp.  Lines come from EDLines at full resolution with its
    default node budget and smoothing (`use_edlines`, edline_scale is not
    read) or else from the dense detector on the image as it is, whatever
    cfg.lsd_octaves says."""
    B = img.shape[0]
    dev, dtype = img.device, img.dtype
    fxb = cam.fx * cam.b

    def in_range(d):
        return (d > cfg.rgbd_min_depth) & (d < cfg.rgbd_max_depth)

    if cfg.has_points:
        det = detect_points_multilevel(img, fast_th, cfg)
        d = _sample_depth(depth, det.uv)
        depth_ok = in_range(d)
        disp = fxb / torch.where(depth_ok, d, torch.ones_like(d))
        ok = det.valid & depth_ok & (disp >= cfg.min_disp)
        P = cam_ops.back_project(cam, det.uv,
                                 torch.where(ok, disp, torch.ones_like(disp)))
        sigma2 = cfg.orb_scale_factor ** (-2.0 * det.level.to(dtype))
        points = PointSet(uv=det.uv,
                          disp=torch.where(ok, disp, torch.zeros_like(disp)),
                          P=P, desc=det.desc, level=det.level, sigma2=sigma2,
                          valid=ok)
    else:
        points = empty_points(cfg.point_capacity, dtype, dev, (B,))
    stamp("points")

    if cfg.has_lines:
        if cfg.use_edlines:
            segs = edline.detect_edlines(
                img, min_line_length, capacity=cfg.line_capacity,
                grad_th=cfg.edline_grad_th, anchor_th=cfg.edline_anchor_th,
                ang_tol_deg=cfg.edline_ang_tol,
                min_support=cfg.edline_min_support,
                straight_tol=cfg.edline_straight_tol,
                density_th=cfg.edline_density_th,
                split_rounds=cfg.edline_split_rounds)
        else:
            segs = lsd.detect_line_segments(
                img, min_line_length, capacity=cfg.line_capacity,
                n_dirs=cfg.lsd_n_dirs, ang_th_deg=cfg.lsd_ang_th,
                quant=cfg.lsd_quant, density_th=cfg.lsd_density_th,
                log_eps=(cfg.lsd_log_eps if cfg.lsd_refine >= 2 else -1.0),
                per_direction=per_direction)
        gx, gy = sobel(img)
        ldesc = _lbd_two_bucket(gx, gy, segs, cfg)
        ds = _sample_depth(depth, segs.sp)
        de = _sample_depth(depth, segs.ep)
        ok_d = in_range(ds) & in_range(de)
        one, zero = torch.ones_like(ds), torch.zeros_like(ds)
        disp_s = fxb / torch.where(ok_d, ds, one)
        disp_e = fxb / torch.where(ok_d, de, one)
        ok = (segs.valid & ok_d & (disp_s >= cfg.min_disp)
              & (disp_e >= cfg.min_disp))
        lines = LineSet(
            spl=segs.sp, epl=segs.ep, sdisp=torch.where(ok, disp_s, zero),
            edisp=torch.where(ok, disp_e, zero),
            sP=cam_ops.back_project(cam, segs.sp,
                                    torch.where(ok, disp_s, one)),
            eP=cam_ops.back_project(cam, segs.ep,
                                    torch.where(ok, disp_e, one)),
            le=_line_coeffs(segs.sp, segs.ep), angle=segs.angle, desc=ldesc,
            level=torch.zeros(segs.sp.shape[:-1], dtype=torch.int32,
                              device=dev),
            sigma2=torch.ones(segs.sp.shape[:-1], dtype=dtype, device=dev),
            valid=ok)
    else:
        lines = empty_lines(cfg.line_capacity, dtype, dev, (B,))
    stamp("lines")
    return FrameFeatures(points=points, lines=lines)
