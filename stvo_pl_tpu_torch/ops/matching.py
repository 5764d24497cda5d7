"""Dense masked correspondence search, batched over leading dims (port of
stvo_pl_tpu/ops/matching.py; the model-parallel matcher that `match_auto`
switches to is parallel/tp.py).

Every matcher is one dense distance matrix + candidate mask + top-2 and
argmin reductions; the reference's grid buckets become predicates on
grid-cell coordinates (src/gridStructure.cpp:64-76,
src/stereoFrame.cpp:134-146)."""

from __future__ import annotations

from typing import NamedTuple

import torch

from stvo_pl_tpu_torch.device import const
from stvo_pl_tpu_torch.ops import hamming

BIG = 2 ** 30


class MatchResult(NamedTuple):
    idx: torch.Tensor    # [..., N] int64 index into set 2, -1 = unmatched
    valid: torch.Tensor  # [..., N] bool


def nnr_mutual_match(dist: torch.Tensor, cand: torch.Tensor, nnr: float,
                     mutual: bool = True) -> MatchResult:
    """Nearest-neighbor-ratio + mutual-consistency matching on a masked
    [..., N, M] distance matrix: best < second * nnr, and the column's
    argmin points back at the row.  argmin keeps the first minimum, as
    the reference's."""
    big = torch.full((), BIG, dtype=dist.dtype, device=dist.device)
    d = torch.where(cand, dist, big)
    best = torch.amin(d, dim=-1)
    best_idx = torch.argmin(d, dim=-1)
    cols = torch.arange(d.shape[-1], device=d.device)
    d2 = torch.where(cols == best_idx[..., None], big, d)
    second = torch.amin(d2, dim=-1)
    ok = (best < big) & (best.to(torch.float32)
                         < second.to(torch.float32) * nnr)
    if mutual:
        best_row_for_col = torch.argmin(d, dim=-2)
        rows = torch.arange(d.shape[-2], device=d.device)
        ok = ok & (torch.gather(best_row_for_col, -1, best_idx) == rows)
    idx = torch.where(ok, best_idx, torch.full_like(best_idx, -1))
    return MatchResult(idx=idx, valid=ok)


def match_auto(desc1, desc2, cand, nnr, cfg, tp=None,
               wta_k: int = 2) -> MatchResult:
    """Brute-force NNR + mutual matching with the configured distance.

    tp = (model-axis process group, n_shards) inside a sharded step: the
    column-sharded matcher (parallel/tp.tp_match_inner) takes over when
    the query set reaches cfg.tp_min_features and the train set divides
    evenly; below that the duplicated front end outweighs the split
    distance matrix and the dense matcher stays.  Both give the same
    result bit for bit."""
    if (tp is not None and desc1.shape[-2] >= cfg.tp_min_features
            and desc2.shape[-2] % tp[1] == 0):
        from stvo_pl_tpu_torch.parallel.tp import tp_match_inner
        return tp_match_inner(desc1, desc2, cand, nnr, group=tp[0],
                              n_shards=tp[1], mutual=cfg.best_lr_matches,
                              wta_k=wta_k, use_mxu=cfg.hamming_use_mxu)
    dist = hamming.distance_matrix(desc1, desc2, cfg.hamming_use_mxu,
                                   wta_k=wta_k)
    return nnr_mutual_match(dist, cand, nnr, mutual=cfg.best_lr_matches)


def grid_cell(uv: torch.Tensor, inv_w: float, inv_h: float) -> torch.Tensor:
    """Pixel coords -> integer grid-cell coords."""
    cx = torch.floor(uv[..., 0] * inv_w).to(torch.int32)
    cy = torch.floor(uv[..., 1] * inv_h).to(torch.int32)
    return torch.stack([cx, cy], dim=-1)


def stereo_point_window_mask(uv_l: torch.Tensor, uv_r: torch.Tensor,
                             inv_w: float, inv_h: float,
                             ws: int) -> torch.Tensor:
    """[..., N, 2] x [..., M, 2] -> [..., N, M]: right candidates in cells
    [cx - ws, cx] of the same cell row."""
    c_l = grid_cell(uv_l, inv_w, inv_h)
    c_r = grid_cell(uv_r, inv_w, inv_h)
    dx = c_l[..., :, None, 0] - c_r[..., None, :, 0]
    same_row = c_l[..., :, None, 1] == c_r[..., None, :, 1]
    return same_row & (dx >= 0) & (dx <= ws)


def f2f_point_window_mask(uv_prev: torch.Tensor, uv_curr: torch.Tensor,
                          inv_w: float, inv_h: float,
                          ws: int) -> torch.Tensor:
    """Symmetric cell window for frame-to-frame tracking."""
    c_p = grid_cell(uv_prev, inv_w, inv_h)
    c_c = grid_cell(uv_curr, inv_w, inv_h)
    dx = torch.abs(c_p[..., :, None, 0] - c_c[..., None, :, 0])
    dy = torch.abs(c_p[..., :, None, 1] - c_c[..., None, :, 1])
    return (dx <= ws) & (dy <= ws)


def point_seg_dist2(p: torch.Tensor, a: torch.Tensor,
                    b: torch.Tensor) -> torch.Tensor:
    """Squared distance from points [..., N, 2] to segments (a, b)
    [..., M, 2] -> [..., N, M]."""
    ab = b - a
    ap = p[..., :, None, :] - a[..., None, :, :]
    denom = torch.clamp(torch.sum(ab * ab, dim=-1), min=1e-12)
    tt = torch.clamp(torch.sum(ap * ab[..., None, :, :], dim=-1)
                     / denom[..., None, :], 0.0, 1.0)
    closest = a[..., None, :, :] + tt[..., None] * ab[..., None, :, :]
    d = p[..., :, None, :] - closest
    return torch.sum(d * d, dim=-1)


def stereo_line_window_mask(sp_l, ep_l, sp_r, ep_r, inv_w, inv_h,
                            ws: int) -> torch.Tensor:
    """Left lines x right lines candidate mask: a right line is a
    candidate when either left endpoint lies within the window radius of
    it in grid-cell space."""
    scale = const((inv_w, inv_h), sp_l.dtype, sp_l.device)
    d_s = point_seg_dist2(sp_l * scale, sp_r * scale, ep_r * scale)
    d_e = point_seg_dist2(ep_l * scale, sp_r * scale, ep_r * scale)
    r2 = float((ws + 1) ** 2)
    return (d_s <= r2) | (d_e <= r2)


def line_direction_mask(dir1: torch.Tensor, dir2: torch.Tensor,
                        sim_th: float) -> torch.Tensor:
    """|cos| similarity between unit directions [..., N, 2] x [..., M, 2]."""
    return torch.abs(torch.matmul(dir1, dir2.transpose(-1, -2))) >= sim_th
