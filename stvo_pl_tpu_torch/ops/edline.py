"""EDLine-style line-segment detector (Edge Drawing), batched over [N, H, W]
images (port of stvo_pl_tpu/ops/edline.py; capability of the reference's
vendored EDLineDetector, 3rdparty/line_descriptor/src/
binary_descriptor_custom.cpp:1398-2728).

Dense, fixed-capacity passes, no sequential pixel walking:

  1. Gaussian pre-smooth + Sobel gradient, magnitude + continuous
     orientation;
  2. directional non-maximum suppression (4 sectors of the gradient
     direction) + gradient threshold -> edge mask (EdgeDrawing's anchor
     test, :1442);
  3. edge pixels compacted to a fixed-capacity node list per image
     (strongest first; lower flat index first among equal magnitudes, the
     reference's top-k tie order);
  4. orientation-gated connected labeling over the node graph: every node
     carries the min flat index of its component, by masked 8-neighbour
     min-propagation plus two pointer jumps per round;
  5. curvature-break splitting: components that fail the straightness
     gate are cut at their maximum-deviation node and relabeled
     (`split_rounds` times);
  6. per-component moments by node-sized scatter-adds, the top components
     by support, the least-squares line fit from the moments
     (LeastSquaresLineFit_ :2484) and endpoints from the support's exact
     extent on the fitted axis;
  7. validation (LineValidation_ :2645 in spirit): support, length,
     straightness, density and anchor-magnitude gates.

Every gather and scatter runs along dim 1 of an [N, ...] tensor, so the
images of a batch never exchange nodes.  The moments are float32 sums,
as the reference's; on a CUDA device their scatter-adds are atomic and
the order of the adds, so the last bits of a sum, can change from run to
run.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from stvo_pl_tpu_torch.device import const
from stvo_pl_tpu_torch.ops.image import gaussian_blur, sobel
from stvo_pl_tpu_torch.ops.lsd import LineSegments, top_k
from stvo_pl_tpu_torch.parallel.compiled import Compiled, compile_fn

_N8 = ((-1, -1), (-1, 0), (-1, 1), (0, -1), (0, 1), (1, -1), (1, 0), (1, 1))


def _shift(a: torch.Tensor, dy: int, dx: int, fill: float) -> torch.Tensor:
    """Shift [..., H, W] by (dy, dx); out-of-range filled."""
    out = torch.roll(a, (dy, dx), dims=(-2, -1))
    if dy > 0:
        out[..., :dy, :].fill_(fill)
    elif dy < 0:
        out[..., dy:, :].fill_(fill)
    if dx > 0:
        out[..., :, :dx].fill_(fill)
    elif dx < 0:
        out[..., :, dx:].fill_(fill)
    return out


def _ang_diff_mod_pi(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    d = torch.remainder(torch.abs(a - b), math.pi)
    return torch.minimum(d, math.pi - d)


def _gather(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x [N, P] at idx [N, ...] along dim 1 -> [N, ...]."""
    return torch.gather(x, 1, idx.reshape(idx.shape[0], -1)).reshape(
        idx.shape)


def _label_nodes(gate: torch.Tensor, nbr_slot: torch.Tensor,
                 node_flat: torch.Tensor, node_valid: torch.Tensor,
                 inv: torch.Tensor, n_rounds: int, BIG: int) -> torch.Tensor:
    """Min-label propagation over the node graph with double pointer
    jumping per round, a fixed number of rounds (no host sync).

    gate: [N, M, 8] bool connection gates; nbr_slot: [N, M, 8] neighbour
    slots (M = sentinel); inv: [N, P] flat-pixel -> slot map.  Labels are
    FLAT PIXEL indices (min over the component), BIG for invalid nodes."""
    big = torch.full_like(node_flat, BIG)
    L = torch.where(node_valid, node_flat, big)
    pad = big[:, :1]
    for _ in range(n_rounds):
        Ln = _gather(torch.cat([L, pad], dim=1), nbr_slot)
        best = torch.minimum(L, torch.where(gate, Ln, BIG).amin(dim=-1))
        L = torch.where(node_valid, best, big)
        for _j in range(2):
            live = L < BIG
            slot = _gather(inv, torch.clamp(L, 0, BIG - 1))
            Lj = torch.where(live, _gather(L, slot), big)
            L = torch.where(live, torch.minimum(L, Lj), big)
    return L


def _fit(m: dict) -> dict:
    """Principal-axis line fit of per-component moments."""
    n = torch.clamp(m["cnt"], min=1.0)
    mx = m["sx"] / n
    my = m["sy"] / n
    cxx = m["sxx"] / n - mx * mx
    cyy = m["syy"] / n - my * my
    cxy = m["sxy"] / n - mx * my
    tr = cxx + cyy
    det = cxx * cyy - cxy * cxy
    disc = torch.sqrt(torch.clamp(tr * tr / 4.0 - det, min=0.0))
    lam1 = tr / 2.0 + disc                           # major
    lam2 = torch.clamp(tr / 2.0 - disc, min=0.0)     # minor
    # cxy ~ 0: the axis is one of the coordinate axes (the larger variance)
    one, zero = torch.ones_like(cxx), torch.zeros_like(cxx)
    tilted = torch.abs(cxy) > 1e-9
    x_axis = cxx >= cyy
    dx_dir = torch.where(tilted, lam1 - cyy, torch.where(x_axis, one, zero))
    dy_dir = torch.where(tilted, cxy, torch.where(x_axis, zero, one))
    norm = torch.clamp(torch.sqrt(dx_dir ** 2 + dy_dir ** 2), min=1e-9)
    return {"mx": mx, "my": my, "ux": dx_dir / norm, "uy": dy_dir / norm,
            "lam1": lam1, "lam2": lam2}


def detect_edlines(img: torch.Tensor, min_length,
                   capacity: int = 300, grad_th: float = 20.0,
                   anchor_th: float = 8.0, ang_tol_deg: float = 20.0,
                   min_support: int = 10, straight_tol: float = 0.1,
                   density_th: float = 0.4,
                   n_rounds: int = 12,
                   split_rounds: int = 2,
                   relabel_rounds: int = 8,
                   hyst_ratio: float = 1.0,
                   smooth_sigma: float = 1.0,
                   node_capacity: int = 16384) -> LineSegments:
    """Detect line segments in [N, H, W] float32 images; returns
    LineSegments with leaves [N, capacity, ...].  min_length: a number or
    a 0-d tensor (as the compiled program takes it).

    grad_th / anchor_th follow EDLine's gradient / anchor thresholds;
    n_rounds bounds the chaining diameter; split_rounds recursively cuts
    non-straight components at their max-deviation node (0 disables);
    relabel_rounds re-runs shorter labelings after each cut.
    node_capacity bounds the compacted edge-pixel set per image: overflow
    drops the weakest edge pixels."""
    N, H, W = img.shape
    P = H * W
    BIG = P
    M = min(node_capacity, P)      # small images: every pixel fits
    dev = img.device
    f32 = torch.float32

    # --- 1. smooth + gradient ------------------------------------------
    if smooth_sigma > 0:
        img = gaussian_blur(img, smooth_sigma, radius=2)
    gx, gy = sobel(img)
    mag = torch.sqrt(gx * gx + gy * gy)
    theta = torch.remainder(torch.atan2(gy, gx), math.pi)

    # --- 2. directional NMS (4 sectors of the gradient direction) ------
    sector = torch.remainder(
        torch.round(theta / (math.pi / 4.0)).to(torch.int32), 4)
    # neighbour offsets ALONG the gradient (across the edge), (dy, dx)
    nbr = [((0, 1), (0, -1)),     # sector 0: gradient ~ 0 deg
           ((1, 1), (-1, -1)),    # sector 1: gradient ~ 45 deg
           ((1, 0), (-1, 0)),     # sector 2: gradient ~ 90 deg
           ((1, -1), (-1, 1))]    # sector 3: gradient ~ 135 deg
    yy0 = torch.arange(H, device=dev)[:, None]
    xx0 = torch.arange(W, device=dev)[None, :]
    # a tiny position-dependent epsilon keeps one survivor per plateau of
    # exactly equal magnitudes (synthetic strokes); only neighbour pairs
    # are compared, so the bias stays < ~0.25 of a magnitude unit
    mag_e = mag + (yy0 * W + xx0).to(f32) * 1e-4
    keep = torch.zeros((N, H, W), dtype=torch.bool, device=dev)
    for s, ((dy1, dx1), (dy2, dx2)) in enumerate(nbr):
        m1 = _shift(mag_e, -dy1, -dx1, 0.0)
        m2 = _shift(mag_e, -dy2, -dx2, 0.0)
        keep = torch.where(sector == s, (mag_e > m1) & (mag_e > m2), keep)
    edge = keep & (mag > hyst_ratio * grad_th)
    # border guard (Sobel halo)
    edge = edge & (yy0 > 1) & (yy0 < H - 2) & (xx0 > 1) & (xx0 < W - 2)

    # --- 3. compact edge pixels to a fixed-capacity node list ----------
    edge_f = edge.reshape(N, P)
    mag_f = mag.reshape(N, P)
    theta_f = theta.reshape(N, P)
    prio = torch.where(edge_f, mag_f, torch.zeros_like(mag_f))
    _, node_flat = top_k(prio, M)                    # [N, M] int64
    node_valid = _gather(edge_f, node_flat)
    slots = torch.arange(M, device=dev).expand(N, M)
    inv = torch.zeros((N, P), dtype=torch.int64, device=dev).scatter(
        1, node_flat, slots)

    nx = node_flat % W
    ny = node_flat // W
    th_node = _gather(theta_f, node_flat)
    mag_node = torch.where(node_valid, _gather(mag_f, node_flat),
                           torch.zeros((), dtype=f32, device=dev))

    # neighbour slots + connection gates (orientation similarity); the
    # tolerance in float32 as the reference's deg2rad computes it
    tol = float(np.float32(ang_tol_deg) * np.float32(np.pi / 180.0))
    d8 = const(_N8, torch.int64, dev)                # [8, (dy, dx)]
    qx = nx[..., None] + d8[:, 1]
    qy = ny[..., None] + d8[:, 0]                    # [N, M, 8]
    inb = (qx >= 0) & (qx < W) & (qy >= 0) & (qy < H)
    q = torch.clamp(qy * W + qx, 0, P - 1)
    # membership: an edge pixel DROPPED by the capacity budget has
    # inv[q] == 0 (the init value), which would alias it to slot 0 —
    # require the round trip node_flat[inv[q]] == q
    slot_q = _gather(inv, q)
    q_edge = (_gather(edge_f, q) & inb & node_valid[..., None]
              & (_gather(node_flat, slot_q) == q))
    gate0 = q_edge & (_ang_diff_mod_pi(th_node[..., None],
                                       _gather(theta_f, q)) < tol)
    nbr_slot = torch.where(q_edge, slot_q, M)        # [N, M, 8]

    L = _label_nodes(gate0, nbr_slot, node_flat, node_valid, inv, n_rounds,
                     BIG)

    xf = nx.to(f32)
    yf = ny.to(f32)
    zero = torch.zeros((), dtype=f32, device=dev)

    def moments(L):
        idx = torch.where(node_valid, _gather(inv, torch.clamp(L, 0, P - 1)),
                          M - 1)

        def scat(vals):
            return torch.zeros((N, M), dtype=f32, device=dev).scatter_add(
                1, idx, torch.where(node_valid, vals, zero))

        return ({"cnt": scat(torch.ones_like(xf)), "sx": scat(xf),
                 "sy": scat(yf), "sxx": scat(xf * xf),
                 "syy": scat(yf * yf), "sxy": scat(xf * yf)}, idx)

    # --- 5. curvature-break splitting (Douglas-Peucker rounds) ---------
    # split-point packing: 11 bits of quantized residual (1/8 px up to
    # 255 px) above 19 bits of quantized axis parameter (1/4 px)
    T_BITS = 19
    T_HALF = 1 << (T_BITS - 1)
    T_MASK = (1 << T_BITS) - 1
    side = torch.zeros((N, M), dtype=torch.int32, device=dev)
    side_pad = torch.full((N, 1), -1, dtype=torch.int32, device=dev)
    big_pad = torch.full((N, 1), BIG, dtype=L.dtype, device=dev)
    for _round in range(split_rounds):
        m, idx = moments(L)
        f = _fit(m)
        mx, my = _gather(f["mx"], idx), _gather(f["my"], idx)
        ux, uy = _gather(f["ux"], idx), _gather(f["uy"], idx)
        t = (xf - mx) * ux + (yf - my) * uy
        res = torch.abs(-(xf - mx) * uy + (yf - my) * ux)
        # components that split: not straight, with enough support
        unstraight = f["lam2"] > straight_tol * f["lam1"]
        do_split = (_gather(unstraight, idx)
                    & (_gather(m["cnt"], idx) >= 2 * min_support)
                    & node_valid)
        # per-component argmax-residual node's t, by packed scatter-max
        rq = torch.clamp((res * 8.0).to(torch.int32), 0, 2047)
        tq = torch.clamp((t * 4.0).to(torch.int32) + T_HALF, 0, T_MASK)
        packed = torch.where(do_split, (rq << T_BITS) + tq,
                             torch.zeros_like(rq))
        best = torch.zeros((N, M), dtype=torch.int32, device=dev)
        best = best.scatter_reduce(1, idx, packed, "amax", include_self=True)
        t_split = ((_gather(best, idx) & T_MASK) - T_HALF).to(f32) * 0.25
        # side values only need to differ WITHIN a component (the relabel
        # gate also requires equal old labels), so +1 suffices
        side = torch.where(do_split & (t > t_split), side + 1, side)
        # relabel: connect only the same old component AND the same side
        Ln = _gather(torch.cat([L, big_pad], dim=1), nbr_slot)
        sn = _gather(torch.cat([side, side_pad], dim=1), nbr_slot)
        gate = (Ln == L[..., None]) & (sn == side[..., None]) & gate0
        L = _label_nodes(gate, nbr_slot, node_flat, node_valid, inv,
                         relabel_rounds, BIG)

    # --- 6. per-component stats of the final labels --------------------
    m, idx = moments(L)
    mag_live = torch.where(node_valid, mag_node, zero)
    # anchor test: the chain must contain one prominent pixel
    mmax = torch.zeros((N, M), dtype=f32, device=dev).scatter_reduce(
        1, idx, mag_live, "amax", include_self=True)
    smag = torch.zeros((N, M), dtype=f32, device=dev).scatter_add(
        1, idx, mag_live)

    # a slot is a live component root iff its own label maps back to it
    is_root = node_valid & (L == node_flat)
    score = torch.where((m["cnt"] >= min_support) & is_root, m["cnt"], zero)
    top, roots = top_k(score, capacity)

    def take(a):
        return torch.gather(a, 1, roots)

    f = _fit(m)
    n = take(m["cnt"])
    mx, my = take(f["mx"]), take(f["my"])
    ux, uy = take(f["ux"]), take(f["uy"])
    lam1, lam2 = take(f["lam1"]), take(f["lam2"])

    # endpoints: exact extent of the support on the fitted axis
    t_node = ((xf - _gather(f["mx"], idx)) * _gather(f["ux"], idx)
              + (yf - _gather(f["my"], idx)) * _gather(f["uy"], idx))
    t0 = take(torch.full((N, M), 1e9, dtype=f32, device=dev).scatter_reduce(
        1, idx, torch.where(node_valid, t_node, 1e9), "amin",
        include_self=True))
    t1 = take(torch.full((N, M), -1e9, dtype=f32, device=dev).scatter_reduce(
        1, idx, torch.where(node_valid, t_node, -1e9), "amax",
        include_self=True))
    sp = torch.stack([mx + t0 * ux, my + t0 * uy], dim=-1)
    ep = torch.stack([mx + t1 * ux, my + t1 * uy], dim=-1)
    length = t1 - t0

    # --- 7. validation -------------------------------------------------
    straight = lam2 / torch.clamp(lam1, min=1e-9)
    density = n / torch.clamp(length, min=1e-6)
    valid = ((n >= min_support)
             & (length >= min_length)
             & (straight < straight_tol)
             & (density > density_th)
             & (take(mmax) > grad_th + anchor_th)
             & (top > 0.0))

    angle = torch.atan2(ep[..., 1] - sp[..., 1], ep[..., 0] - sp[..., 0])
    v2 = valid[..., None]
    return LineSegments(sp=torch.where(v2, sp, zero),
                        ep=torch.where(v2, ep, zero),
                        angle=torch.where(valid, angle, zero),
                        length=torch.where(valid, length, zero),
                        resp=take(smag) * valid,
                        valid=valid)


def compile_detect_edlines(device=None, **static) -> Compiled:
    """`detect_edlines` as a captured program on `device` ("cuda" unless
    the caller asks for the CPU): `prog(img, min_length)`, `min_length` a
    0-d float32 tensor (traced in the JAX package); `static`: its other
    keyword arguments, fixed for the program's life (the JAX package
    traces the float thresholds too: here another value is another
    program).  On the CPU equal to the eager call bit for bit; on the card
    the moments are atomic float sums, so two runs agree as a set of
    segments (ROADMAP "Documented divergences", EDLines)."""
    return compile_fn(detect_edlines, ("img", "min_length"), device,
                      **static)
