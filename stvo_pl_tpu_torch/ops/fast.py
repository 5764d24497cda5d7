"""FAST corner detection as a dense, branch-free score map, with
spatially-uniform fixed-capacity selection.  Port of stvo_pl_tpu/ops/fast.py.

`detect_keypoints` takes the fused-kernel semantics (ops/fast_kernel.py:
packed NMS map + `select_from_packed`) whenever the reference's kernel gate
holds (FAST ranking, 4x4 cells, smaller image side >= 64), on every device.
Otherwise it takes the dense twin path (`fast_score` + `select_keypoints`),
Harris ranking included.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from stvo_pl_tpu_torch.ops.image import box_filter, maxpool3, sobel

# 16-pixel Bresenham circle of radius 3, in contiguous angular order: (dy, dx)
CIRCLE = np.array([
    (-3, 0), (-3, 1), (-2, 2), (-1, 3), (0, 3), (1, 3), (2, 2), (3, 1),
    (3, 0), (3, -1), (2, -2), (1, -3), (0, -3), (-1, -3), (-2, -2), (-3, -1),
], dtype=np.int32)

ARC = 9  # contiguous arc length for FAST-9/16


def _bcast(threshold, img: torch.Tensor) -> torch.Tensor:
    """Per-image threshold [N] (or scalar) -> broadcastable to [N, H, W]."""
    th = torch.as_tensor(threshold, dtype=img.dtype, device=img.device)
    return th.reshape(th.shape + (1, 1)) if th.ndim else th


def fast_response(diffs: list[torch.Tensor]) -> torch.Tensor:
    """Un-thresholded FAST-9/16 response from the 16 circle differences
    (circle pixel minus center, in CIRCLE order): the max over the 16
    contiguous 9-arcs of the arc's min (bright) or minus its max (dark).
    The arc windows share 3-wide min/max subtrees, as in the reference."""
    wrap = diffs + diffs[:ARC - 1]
    min3 = [torch.minimum(torch.minimum(wrap[s], wrap[s + 1]), wrap[s + 2])
            for s in range(16 + ARC - 3)]
    max3 = [torch.maximum(torch.maximum(wrap[s], wrap[s + 1]), wrap[s + 2])
            for s in range(16 + ARC - 3)]
    bright = dark = None
    for s in range(16):
        wmin = torch.minimum(torch.minimum(min3[s], min3[s + 3]), min3[s + 6])
        wmax = torch.maximum(torch.maximum(max3[s], max3[s + 3]), max3[s + 6])
        bright = wmin if bright is None else torch.maximum(bright, wmin)
        dark = wmax if dark is None else torch.minimum(dark, wmax)
    return torch.maximum(bright, -dark)


def fast_score(img: torch.Tensor, threshold) -> torch.Tensor:
    """FAST-9/16 corner response of [..., H, W]: 0 for non-corners, else the
    largest threshold at which the pixel stays a corner."""
    resp = fast_response([
        torch.roll(img, (-int(dy), -int(dx)), dims=(-2, -1)) - img
        for dy, dx in CIRCLE])
    return torch.where(resp > _bcast(threshold, img), resp,
                       torch.zeros_like(resp))


def harris_score(img: torch.Tensor, block: int = 7,
                 k: float = 0.04) -> torch.Tensor:
    """Harris response det(M) - k tr(M)^2 over a block x block window of
    Sobel-gradient products (cv::ORB HARRIS_SCORE ranking)."""
    gx, gy = sobel(img)
    r = block // 2
    sxx = box_filter(gx * gx, r)
    syy = box_filter(gy * gy, r)
    sxy = box_filter(gx * gy, r)
    det = sxx * syy - sxy * sxy
    tr = sxx + syy
    scale = (1.0 / (4 * block * 255.0)) ** 4
    return (det - k * tr * tr) * scale


def _border_mask(H: int, W: int, edge: int, device) -> torch.Tensor:
    y = torch.arange(H, device=device)[:, None]
    x = torch.arange(W, device=device)[None, :]
    return (y >= edge) & (y < H - edge) & (x >= edge) & (x < W - edge)


def subpix_offset_maps(score: torch.Tensor):
    """Dense parabola offset maps (ox, oy) from a response map: 1-D
    quadratic fits through each pixel's 3x3 neighborhood, clamped to
    +-0.5."""
    rl = torch.roll(score, 1, dims=-1)
    rr = torch.roll(score, -1, dims=-1)
    ru = torch.roll(score, 1, dims=-2)
    rd = torch.roll(score, -1, dims=-2)
    denx = rl - 2.0 * score + rr
    deny = ru - 2.0 * score + rd
    zero = torch.zeros_like(score)
    negx = denx < -1e-6
    negy = deny < -1e-6
    ox = torch.where(negx, 0.5 * (rl - rr) / torch.where(negx, denx, -1.0),
                     zero)
    oy = torch.where(negy, 0.5 * (ru - rd) / torch.where(negy, deny, -1.0),
                     zero)
    return torch.clamp(ox, -0.5, 0.5), torch.clamp(oy, -0.5, 0.5)


def _top_k(x: torch.Tensor, k: int):
    """Exact top-k over the last axis, lower index first on ties (XLA
    TopK order)."""
    order = torch.sort(x, dim=-1, descending=True, stable=True).indices
    order = order[..., :k]
    return torch.gather(x, -1, order), order


def select_keypoints(score: torch.Tensor, capacity: int, edge: int = 16,
                     cell: int = 4, offset_src: torch.Tensor | None = None):
    """NMS + spatially-uniform top-K from [N, H, W] score maps.

    Returns (uv [N, K, 2] f32, score [N, K] f32, valid [N, K] bool)."""
    N, H, W = score.shape
    dev = score.device
    score = score * _border_mask(H, W, edge, dev).to(score.dtype)
    eps = (torch.arange(H * W, dtype=score.dtype, device=dev).reshape(H, W)
           * 1e-7)
    zero = torch.zeros((), dtype=score.dtype, device=dev)
    s = torch.where(score > 0, score - eps, zero)
    keep = (s >= maxpool3(s)) & (score > 0)
    s = torch.where(keep, s, zero)

    if cell > 1:
        Hp = -(-H // cell) * cell
        Wp = -(-W // cell) * cell
        sp = F.pad(s, (0, Wp - W, 0, Hp - H))
        tiles = sp.reshape(N, Hp // cell, cell, Wp // cell, cell)
        tiles = tiles.permute(0, 1, 3, 2, 4).reshape(
            N, Hp // cell, Wp // cell, cell * cell)
        best = tiles.amax(dim=-1)
        arg = torch.argmax(tiles, dim=-1)
        gy = torch.arange(Hp // cell, device=dev)[:, None] * cell + arg // cell
        gx = torch.arange(Wp // cell, device=dev)[None, :] * cell + arg % cell
        flat_scores = best.reshape(N, -1)
        flat_idx = (gy * Wp + gx).reshape(N, -1)
        k = min(capacity, flat_scores.shape[1])
        top, pos = _top_k(flat_scores, k)
        idx = torch.gather(flat_idx, 1, pos)
        ys = (idx // Wp).to(torch.float32)
        xs = (idx % Wp).to(torch.float32)
    else:
        flat = s.reshape(N, -1)
        k = min(capacity, flat.shape[1])
        top, idx = _top_k(flat, k)
        ys = (idx // W).to(torch.float32)
        xs = (idx % W).to(torch.float32)

    valid = top > 0
    if offset_src is not None:
        ox, oy = subpix_offset_maps(offset_src)
        flat_at = ys.long() * W + xs.long()
        xs = xs + torch.gather(ox.reshape(N, -1), 1, flat_at)
        ys = ys + torch.gather(oy.reshape(N, -1), 1, flat_at)
    uv = torch.stack([xs, ys], dim=-1)
    if k < capacity:
        pad = capacity - k
        uv = F.pad(uv, (0, 0, 0, pad))
        top = F.pad(top, (0, pad))
        valid = F.pad(valid, (0, pad))
    return uv, top, valid


def detect_keypoints(img: torch.Tensor, threshold, capacity: int,
                     edge: int = 16, cell: int = 4, score_type: int = 1,
                     subpix: bool = True):
    """FAST score + NMS + spatially-uniform top-K on [N, H, W] images with
    per-image thresholds [N].

    score_type 1 ranks by the FAST response; 0 detects with FAST and ranks
    by the Harris response at the surviving pixels.  subpix refines the
    coordinates with a parabola fit on the FAST response."""
    if score_type == 1 and cell == 4 and min(img.shape[-2:]) >= 64:
        from stvo_pl_tpu_torch.ops.fast_kernel import (fast_pack,
                                                       select_from_packed)
        packed = fast_pack(img.contiguous(), edge)
        return select_from_packed(packed, capacity, threshold, cell,
                                  subpix=subpix)
    score = fast_score(img, threshold)
    offset_src = score if subpix else None
    if score_type == 0:
        pos = score > 0
        h = torch.where(pos, harris_score(img), torch.zeros_like(score))
        hmax = h.amax(dim=(-2, -1), keepdim=True)
        h = h / torch.clamp(hmax, min=1e-30) * 1e3
        score = torch.where(pos, torch.clamp(h, min=1e-3),
                            torch.zeros_like(score))
    return select_keypoints(score, capacity, edge=edge, cell=cell,
                            offset_src=offset_src)
