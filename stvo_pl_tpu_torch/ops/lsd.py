"""Dense line-segment detection (LSD-equivalent) as a fixed-shape tensor
program, batched over a leading image axis (port of stvo_pl_tpu/ops/lsd.py;
reference LSDDetector_custom.cpp:218-324).

  1. level-line field: 2x2 gradients, line angle = atan2(gx, -gy),
     magnitude threshold rho = quant / sin(ang_th);
  2. every pixel's alignment to each of D integer direction vectors goes
     into one i32 bitmask image; ONE launch of the run kernel
     (ops/lsd_kernel.run_pack_multi) scores the maximal aligned runs of
     all directions, and one global top-k by metric length makes them
     segment candidates.  With `per_direction=True` the candidates come
     from the other generator of the JAX package (the one it runs off the
     TPU): one launch of the one-direction run kernel
     (ops/lsd_kernel.run_pack) per direction, the best `k_per_dir` runs of
     each direction, their union pruned to the pool size by raw length;
  3. collinear fragments are merged and near-duplicates suppressed with
     O(K^2) masked pairwise logic;
  4. survivors are refined by a weighted least-squares line fit over
     gradient-magnitude-weighted perpendicular centroids, validated
     (density, optional a-contrario NFA), merged again and ranked by
     length into fixed-capacity arrays with validity masks.

Every top-k is exact and keeps the lower index first among equal values
(the order of XLA's TopK on the CPU), on both devices.  Angle convention:
KeyLine.angle = atan2(dy, dx) of the endpoints.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from stvo_pl_tpu_torch.ops import lsd_kernel
from stvo_pl_tpu_torch.ops.image import gaussian_blur

_PI = float(np.float32(np.pi))


class LineSegments(NamedTuple):
    sp: torch.Tensor       # [N, K, 2] start point (x, y)
    ep: torch.Tensor       # [N, K, 2] end point (x, y)
    angle: torch.Tensor    # [N, K] atan2(dy, dx)
    length: torch.Tensor   # [N, K]
    resp: torch.Tensor     # [N, K] response (aligned support length)
    valid: torch.Tensor    # [N, K] bool


# primitive integer step vectors spanning 180 deg (dx, dy); runs advance in
# exact integer hops
DIR_STEPS = [
    (1, 0), (4, 1), (2, 1), (4, 3), (1, 1), (3, 4), (1, 2), (1, 4),
    (0, 1), (-1, 4), (-1, 2), (-3, 4), (-1, 1), (-4, 3), (-2, 1), (-4, 1),
]


def direction_steps(n_dirs: int) -> list[tuple[int, int]]:
    """`n_dirs` of the 16 directions, subsampled evenly over the
    half-circle so every angle keeps a nearby direction bin."""
    if n_dirs >= len(DIR_STEPS):
        return list(DIR_STEPS)
    idx = np.round(np.linspace(0, len(DIR_STEPS), n_dirs,
                               endpoint=False)).astype(int)
    return [DIR_STEPS[i] for i in idx]


def _f32(v: float) -> float:
    """A Python scalar rounded to float32, so that comparing or combining
    it with a float32 tensor means the same whatever width the scalar is
    carried in."""
    return float(np.float32(v))


def norm2(d: torch.Tensor) -> torch.Tensor:
    """Euclidean norm over a trailing axis of size 2."""
    return torch.sqrt(d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1])


def linspace01(n: int, device) -> torch.Tensor:
    """n float32 samples of [0, 1] as the reference's linspace rounds them:
    i / (n - 1) in float32, the endpoint exact."""
    if n == 1:
        return torch.zeros(1, device=device)
    t = np.arange(n - 1, dtype=np.float32) / np.float32(n - 1)
    return torch.from_numpy(np.append(t, np.float32(1.0))).to(device)


def top_k(x: torch.Tensor, k: int):
    """Exact top-k along the last axis, the lower index first among equal
    values.  Returns (values, indices) of width min(k, size)."""
    order = torch.sort(x, dim=-1, descending=True, stable=True).indices
    order = order[..., :k]
    return torch.gather(x, -1, order), order


def take(x: torch.Tensor, j: torch.Tensor) -> torch.Tensor:
    """x [N, M, ...] gathered at j [N, K] along axis 1 -> [N, K, ...]."""
    idx = j.reshape(j.shape + (1,) * (x.ndim - 2)).expand(
        j.shape + x.shape[2:])
    return torch.gather(x, 1, idx)


def _gather2d(field: torch.Tensor, py: torch.Tensor,
              px: torch.Tensor) -> torch.Tensor:
    """field [N, H, W] at integer (py, px) [N, ...] -> [N, ...]."""
    N, H, W = field.shape
    flat = (py * W + px).reshape(N, -1)
    return torch.gather(field.reshape(N, H * W), 1, flat).reshape(py.shape)


def level_line_field(img: torch.Tensor):
    """LSD 2x2 block gradient at pixel corners of [..., H, W] images.

    Returns (angle, mag): angle of the level line (edge direction,
    perpendicular to the gradient) and gradient magnitude, the last row
    and column zero."""
    a, b = img[..., :-1, :-1], img[..., :-1, 1:]
    c, d = img[..., 1:, :-1], img[..., 1:, 1:]
    gy = F.pad(0.5 * (c - a + d - b), (0, 1, 0, 1))
    gx = F.pad(0.5 * (b - a + d - c), (0, 1, 0, 1))
    mag = torch.sqrt(gx * gx + gy * gy)
    ang = torch.atan2(gx, -gy)
    return ang, mag


def _angle_dist_mod_pi(a: torch.Tensor, b) -> torch.Tensor:
    """Distance between undirected line angles (mod pi)."""
    d = torch.remainder(torch.abs(a - b), _PI)
    return torch.minimum(d, _PI - d)


def direction_bitmask(ang: torch.Tensor, mag: torch.Tensor, steps,
                      tol: float, rho: float) -> torch.Tensor:
    """[..., H, W] i32: bit d set where the pixel's level line lies within
    tol of direction steps[d] and its gradient exceeds rho."""
    strong = mag > _f32(rho)
    bits = torch.zeros(ang.shape, dtype=torch.int32, device=ang.device)
    for i, (dx, dy) in enumerate(steps):
        theta = _f32(math.atan2(dy, dx) % math.pi)
        aligned = (_angle_dist_mod_pi(ang, theta) < _f32(tol)) & strong
        bits = bits | (aligned.to(torch.int32) << i)
    return bits


def _candidates_from_packed_multi(packed: torch.Tensor, steps, k_total: int,
                                  min_len: float, tile: int = 8):
    """All-direction metric-packed run maps [N, D, Ht, Wp] (rows already
    pooled by the kernel) -> one global top-k candidate set per image:
    (xs, ys, xe, ye, score, support, valid), each [N, k_total].  Where the
    pool is smaller than k_total the tail is padded with invalid
    entries."""
    N, D, Ht, Wp = packed.shape
    Wt = Wp // tile
    dev = packed.device
    pooled = packed.reshape(N, D, Ht, Wt, tile).amax(dim=-1)
    flat = pooled.reshape(N, -1)
    top, pos = top_k(flat, k_total)
    if top.shape[1] < k_total:
        pad = k_total - top.shape[1]
        top, pos = F.pad(top, (0, pad)), F.pad(pos, (0, pad))
    d = pos // (Ht * Wt)
    rem = pos % (Ht * Wt)
    fm = top // 64
    idx = 63 - (top % 64)
    ys = ((rem // Wt) * tile + idx // 8).to(torch.float32)
    xs = ((rem % Wt) * tile + idx % 8).to(torch.float32)
    hq = torch.tensor([lsd_kernel._hop_q(sx, sy) for sx, sy in steps],
                      dtype=torch.int32, device=dev)[d]
    sx = torch.tensor([s[0] for s in steps], dtype=torch.float32,
                      device=dev)[d]
    sy = torch.tensor([s[1] for s in steps], dtype=torch.float32,
                      device=dev)[d]
    hops = (fm // hq).to(torch.float32)
    length = fm.to(torch.float32) * (1.0 / 16.0)
    score = torch.where(length >= _f32(min_len), length,
                        torch.zeros_like(length))
    reach = torch.clamp(hops - 1.0, min=0.0)
    xe = xs + reach * sx
    ye = ys + reach * sy
    return xs, ys, xe, ye, score, score, score > 0


def pool_tiles(packed: torch.Tensor, tile: int = 8) -> torch.Tensor:
    """[..., Hp, Wp] packed run words -> [..., Hp / tile, Wp / tile]: the
    maximum of every tile, which is its best run together with the run's
    position inside the tile."""
    Hp, Wp = packed.shape[-2:]
    lead = packed.shape[:-2]
    return packed.reshape(lead + (Hp // tile, tile, Wp // tile, tile)).amax(
        dim=(-3, -1))


def _candidates_from_packed(pooled: torch.Tensor, steps, k_per_dir: int,
                            min_len: float, tile: int = 8):
    """Tile-pooled one-direction run maps [N, D, Hp / 8, Wp / 8] (direction
    d's map from `run_pack` with steps[d], through `pool_tiles`) -> the best
    k_per_dir runs of every direction, concatenated over the directions:
    (xs, ys, xe, ye, score, support, valid), each [N, D * k] with k =
    min(k_per_dir, tiles)."""
    N, D, Ht, Wt = pooled.shape
    dev = pooled.device
    top, pos = top_k(pooled.reshape(N, D, Ht * Wt), k_per_dir)   # [N, D, k]
    f = top // 64
    idx = 63 - (top % 64)
    ys = ((pos // Wt) * tile + idx // 8).to(torch.float32)
    xs = ((pos % Wt) * tile + idx % 8).to(torch.float32)
    col = lambda v: torch.tensor(v, dtype=torch.float32, device=dev)[:, None]
    hop = col([math.hypot(dx, dy) for dx, dy in steps])
    sx, sy = col([s[0] for s in steps]), col([s[1] for s in steps])
    hops = f.to(torch.float32)
    length = hops * hop
    score = torch.where(length >= _f32(min_len), length,
                        torch.zeros_like(length))
    reach = torch.clamp(hops - 1.0, min=0.0)
    xe = xs + reach * sx
    ye = ys + reach * sy
    flat = lambda t: t.reshape(N, -1)
    return (flat(xs), flat(ys), flat(xe), flat(ye), flat(score), flat(score),
            flat(score > 0))


def _refine_segments(ang_field, mag, xs, ys, xe, ye, valid, tol: float,
                     n_samples: int = 16, search: int = 2):
    """Weighted least-squares refit of each candidate segment.

    ang_field, mag: [N, H, W]; xs, ys, xe, ye, valid: [N, K].  Samples
    n_samples points along the segment; at each, the gradient-magnitude-
    weighted perpendicular centroid of aligned pixels within +-search px;
    a PCA line through the corrected points; the endpoints projected onto
    it.  Returns (sp, ep, density, ok, align_frac)."""
    N, H, W = mag.shape
    dev = mag.device
    sp = torch.stack([xs, ys], dim=-1)
    ep = torch.stack([xe, ye], dim=-1)
    d = ep - sp
    length = torch.clamp(norm2(d), min=1e-6)
    u = d / length[..., None]                              # [N, K, 2]
    n = torch.stack([-u[..., 1], u[..., 0]], dim=-1)
    seg_ang = torch.atan2(d[..., 1], d[..., 0])

    t = linspace01(n_samples, dev)[None, None, :, None]
    base = sp[:, :, None, :] + d[:, :, None, :] * t        # [N, K, S, 2]
    offs = torch.arange(-search, search + 1, device=dev,
                        dtype=torch.float32)
    pts = (base[:, :, :, None, :]
           + n[:, :, None, None, :] * offs[None, None, None, :, None])
    px = torch.clamp(torch.round(pts[..., 0]).to(torch.int64), 0, W - 1)
    py = torch.clamp(torch.round(pts[..., 1]).to(torch.int64), 0, H - 1)
    a = _gather2d(ang_field, py, px)                       # [N, K, S, O]
    m = _gather2d(mag, py, px)
    da = _angle_dist_mod_pi(a, seg_ang[:, :, None, None])
    zero = torch.zeros((), dtype=m.dtype, device=dev)
    w = torch.where(da < _f32(tol), m, zero)
    wsum = torch.sum(w, dim=-1)
    delta = torch.sum(w * offs, dim=-1) / torch.clamp(wsum, min=1e-6)
    good = wsum > 1e-6
    corrected = base + delta[..., None] * n[:, :, None, :]

    wgt = torch.where(good, wsum, zero)
    wtot = torch.clamp(torch.sum(wgt, dim=2), min=1e-6)
    mean = torch.sum(corrected * wgt[..., None], dim=2) / wtot[..., None]
    c = corrected - mean[:, :, None, :]
    cov_xx = torch.sum(wgt * c[..., 0] * c[..., 0], dim=2)
    cov_xy = torch.sum(wgt * c[..., 0] * c[..., 1], dim=2)
    cov_yy = torch.sum(wgt * c[..., 1] * c[..., 1], dim=2)
    theta_fit = 0.5 * torch.atan2(2.0 * cov_xy, cov_xx - cov_yy)
    u_fit = torch.stack([torch.cos(theta_fit), torch.sin(theta_fit)], dim=-1)
    flip = torch.sum(u_fit * u, dim=-1) < 0
    u_fit = torch.where(flip[..., None], -u_fit, u_fit)

    sp_r = mean + u_fit * torch.sum((sp - mean) * u_fit, dim=-1, keepdim=True)
    ep_r = mean + u_fit * torch.sum((ep - mean) * u_fit, dim=-1, keepdim=True)

    density = torch.mean(good.to(torch.float32), dim=2)
    align_frac = torch.mean((w > 0).to(torch.float32), dim=(2, 3))
    ok = valid & (density > 0.0)
    degen = ~torch.isfinite(theta_fit) | (wtot <= 1e-5)
    sp_r = torch.where(degen[..., None], sp, sp_r)
    ep_r = torch.where(degen[..., None], ep, ep_r)
    return sp_r, ep_r, density, ok, align_frac


def nfa_neg_log10(length: torch.Tensor, align_frac: torch.Tensor, H: int,
                  W: int, tol: float, width: int) -> torch.Tensor:
    """-log10(NFA) of each candidate under the a-contrario model: N_tests =
    (WH)^(5/2), p = 2 tol / pi, n = round(length) * width rectangle pixels,
    the binomial tail bounded by its Chernoff/KL form."""
    p = 2.0 * tol / math.pi
    r = torch.clamp(align_frac, 1e-4, 1.0 - 1e-4)
    n = torch.clamp(torch.round(length), min=1.0) * width
    kl10 = (r * torch.log10(r / p)
            + (1.0 - r) * torch.log10((1.0 - r) / (1.0 - p)))
    tail = torch.where(r > _f32(p), n * kl10, torch.zeros_like(r))
    n_tests = 2.5 * math.log10(float(H) * float(W))
    return tail - n_tests


def _pair_geometry(sp: torch.Tensor, ep: torch.Tensor):
    """For segments [N, K, 2]: (L [N, K], u [N, K, 2], perp_s, perp_e, lo,
    hi [N, i, j]): j's endpoints against i's line, perpendicular distances
    and the ordered longitudinal projections onto i's axis."""
    d = ep - sp
    L = torch.clamp(norm2(d), min=1e-6)
    u = d / L[..., None]
    nx, ny = -u[..., 1:2], u[..., 0:1]                    # [N, K, 1]
    ux, uy = u[..., 0:1], u[..., 1:2]
    rsx = sp[:, None, :, 0] - sp[:, :, None, 0]           # [N, i, j]
    rsy = sp[:, None, :, 1] - sp[:, :, None, 1]
    rex = ep[:, None, :, 0] - sp[:, :, None, 0]
    rey = ep[:, None, :, 1] - sp[:, :, None, 1]
    perp_s = torch.abs(rsx * nx + rsy * ny)
    perp_e = torch.abs(rex * nx + rey * ny)
    t_s = rsx * ux + rsy * uy
    t_e = rex * ux + rey * uy
    return (L, u, perp_s, perp_e, torch.minimum(t_s, t_e),
            torch.maximum(t_s, t_e))


def _merge_collinear(sp, ep, length, valid, ang_tol: float, perp_tol: float,
                     gap_tol: float, n_rounds: int = 2):
    """Absorb collinear fragments into their longest member: for every pair
    (i, j) with j shorter, if directions agree (mod pi), j's endpoints lie
    within perp_tol of i's infinite line and the longitudinal gap is below
    gap_tol, i is extended to cover j and j is consumed.  [N, K] batched."""
    K = sp.shape[1]
    dev = sp.device
    ar = torch.arange(K, device=dev)
    eye = torch.eye(K, dtype=torch.bool, device=dev)
    later = ar[None, :] > ar[:, None]                     # [i, j]: j > i
    inf = torch.full((), float("inf"), dtype=sp.dtype, device=dev)
    for _ in range(n_rounds):
        L, u, perp_s, perp_e, lo, hi = _pair_geometry(sp, ep)
        d = ep - sp
        ang = torch.atan2(d[..., 1], d[..., 0])
        ang_ok = _angle_dist_mod_pi(ang[:, :, None],
                                    ang[:, None, :]) < _f32(ang_tol)
        perp_ok = (perp_s < perp_tol) & (perp_e < perp_tol)
        gap = torch.maximum(lo - L[:, :, None], -hi)
        gap_ok = gap < gap_tol
        both = valid[:, :, None] & valid[:, None, :]
        shorter = (L[:, None, :] < L[:, :, None]) | (
            (L[:, None, :] == L[:, :, None]) & later)
        absorb = both & ~eye & ang_ok & perp_ok & gap_ok & shorter

        lo_all = torch.where(absorb, lo, inf).amin(dim=2)
        hi_all = torch.where(absorb, hi, -inf).amax(dim=2)
        new_lo = torch.clamp(lo_all, max=0.0)
        new_hi = torch.maximum(L, hi_all)
        sp_new = sp + u * new_lo[..., None]
        ep_new = sp + u * new_hi[..., None]
        valid = valid & ~torch.any(absorb, dim=1)
        L_new = norm2(ep_new - sp_new)
        sp, ep = sp_new, ep_new
        length = torch.where(valid, L_new, torch.zeros_like(L_new))
    return sp, ep, length, valid


def _suppress_duplicates(sp, ep, resp, valid, perp_tol: float,
                         overlap_tol: float):
    """Kill near-duplicate segments: if j lies on i's line (both endpoints
    within perp_tol) and overlaps i longitudinally by more than
    overlap_tol of its own length, the weaker dies.  [N, K] batched."""
    K = sp.shape[1]
    dev = sp.device
    L, _, perp_s, perp_e, lo, hi = _pair_geometry(sp, ep)
    on_line = (perp_s < perp_tol) & (perp_e < perp_tol)
    ov = torch.minimum(hi, L[:, :, None]) - torch.clamp(lo, min=0.0)
    ov_frac = ov / torch.clamp(hi - lo, min=1e-6)
    dup = on_line & (ov_frac > _f32(overlap_tol))
    both = valid[:, :, None] & valid[:, None, :]
    ar = torch.arange(K, device=dev)
    stronger = (resp[:, :, None] > resp[:, None, :]) | (
        (resp[:, :, None] == resp[:, None, :]) & (ar[:, None] < ar[None, :]))
    eye = torch.eye(K, dtype=torch.bool, device=dev)
    killed = torch.any(dup & both & stronger & ~eye, dim=1)
    return valid & ~killed


def line_field(img: torch.Tensor, sigma: float = 0.8,
               valid_mask: torch.Tensor | None = None):
    """(ang, mag) level-line field of the smoothed [N, H, W] images, the
    magnitude zeroed outside `valid_mask` ([H, W] bool)."""
    ang, mag = level_line_field(gaussian_blur(img, sigma))
    if valid_mask is not None:
        mag = torch.where(valid_mask, mag, torch.zeros_like(mag))
    return ang, mag


def run_maps(ang: torch.Tensor, mag: torch.Tensor, n_dirs: int,
             ang_th_deg: float, quant: float, per_direction: bool = False):
    """The run kernels over the field of N images.

    All-direction generator: the direction bitmask and ONE launch for every
    image and direction; returns the packed run maps [N, D, Hp/8, Wp].
    Per-direction generator: one aligned mask and one launch of the
    one-direction kernel per direction, each map tile-pooled at once;
    returns [N, D, Hp'/8, Wp/8] (Hp' = round_up(H, 8))."""
    tol = math.radians(ang_th_deg)
    rho = quant / math.sin(tol)
    steps = direction_steps(n_dirs)
    if not per_direction:
        bits = direction_bitmask(ang, mag, steps, tol, rho)
        return lsd_kernel.run_pack_multi(bits.contiguous(), steps)
    strong = mag > _f32(rho)
    pooled = []
    for dx, dy in steps:
        theta = _f32(math.atan2(dy, dx) % math.pi)
        aligned = (_angle_dist_mod_pi(ang, theta) < _f32(tol)) & strong
        pooled.append(pool_tiles(lsd_kernel.run_pack(aligned, dx, dy)))
    return torch.stack(pooled, dim=1)


def segments_from_runs(ang: torch.Tensor, mag: torch.Tensor,
                       packed: torch.Tensor, min_length: float,
                       capacity: int = 300, n_dirs: int = 16,
                       ang_th_deg: float = 22.5, density_th: float = 0.6,
                       refine: bool = True, log_eps: float = -1.0,
                       refine_samples: int = 16, refine_search: int = 2,
                       k_total: int | None = None,
                       per_direction: bool = False,
                       k_per_dir: int = 64) -> LineSegments:
    """Everything after the run kernel: candidates, merges, refinement,
    validation and the final ranking, for the images whose field and run
    maps are given ([N, H, W] and what `run_maps` returned with the same
    `per_direction`)."""
    N, H, W = mag.shape
    tol = math.radians(ang_th_deg)
    steps = direction_steps(n_dirs)
    if k_total is None:
        k_total = max(2 * capacity, 256)
    if per_direction:
        xs, ys, xe, ye, ln, _, v = _candidates_from_packed(
            packed, steps, k_per_dir, min_length)
    else:
        xs, ys, xe, ye, ln, _, v = _candidates_from_packed_multi(
            packed, steps, k_total, min_length)
    sp = torch.stack([xs, ys], dim=-1)
    ep = torch.stack([xe, ye], dim=-1)
    zero = torch.zeros((), dtype=ln.dtype, device=ln.device)
    length = torch.where(v, ln, zero)
    if per_direction and length.shape[1] > k_total:
        # prune the union of the directions' quotas by raw run length
        # before the O(K^2) merges
        _, keep = top_k(length, k_total)
        sp, ep, length, v = (take(a, keep) for a in (sp, ep, length, v))

    # merge collinear fragments on the raw integer-direction endpoints and
    # kill only hard duplicates (off-bin lines fragment into staircase runs
    # that only refinement can reassemble)
    sp, ep, length, v = _merge_collinear(
        sp, ep, length, v, ang_tol=tol * 0.5, perp_tol=2.5, gap_tol=6.0)
    resp = torch.where(v, length, zero)
    v = _suppress_duplicates(sp, ep, resp, v, perp_tol=2.0, overlap_tol=0.8)
    resp = torch.where(v & (length >= _f32(min_length)), length, zero)

    def select(resp, *fields):
        """The best `capacity` entries by resp, padded with invalid ones
        where the pool is smaller."""
        top, pos = top_k(resp, capacity)
        out = [take(f, pos) for f in fields]
        pad = capacity - top.shape[1]
        if pad > 0:
            top = F.pad(top, (0, pad))
            out = [F.pad(f, (0, 0) * (f.ndim - 2) + (0, pad)) for f in out]
        return top, out

    # reduce to final capacity, then refine only the survivors
    top, (sp, ep) = select(resp, sp, ep)
    v = top > 0

    if refine:
        sp, ep, density, v, align_frac = _refine_segments(
            ang, mag, sp[..., 0], sp[..., 1], ep[..., 0], ep[..., 1], v, tol,
            n_samples=refine_samples, search=refine_search)
        v = v & (density >= _f32(density_th))
        if log_eps >= 0:
            nl10 = nfa_neg_log10(norm2(ep - sp), align_frac, H, W, tol,
                                 width=5)
            v = v & (nl10 >= _f32(log_eps))
        length = norm2(ep - sp)
        sp, ep, length, v = _merge_collinear(
            sp, ep, length, v, ang_tol=tol * 0.25, perp_tol=2.5, gap_tol=8.0)
        resp = torch.where(v, length, zero)
    else:
        # FLD-like fast path: raw run endpoints, ranked by length
        resp = torch.where(v, norm2(ep - sp), zero)
    v = _suppress_duplicates(sp, ep, resp, v, perp_tol=4.0, overlap_tol=0.4)

    # clamp to image bounds, final filters, re-rank by (refined) length
    lim = torch.tensor([W - 1.0, H - 1.0], dtype=sp.dtype, device=sp.device)
    sp = torch.minimum(torch.clamp(sp, min=0.0), lim)
    ep = torch.minimum(torch.clamp(ep, min=0.0), lim)
    length = norm2(ep - sp)
    resp = torch.where(v & (length >= _f32(min_length)), length, zero)
    top, (sp_o, ep_o, len_o) = select(resp, sp, ep, length)
    dvec = ep_o - sp_o
    return LineSegments(sp=sp_o, ep=ep_o,
                        angle=torch.atan2(dvec[..., 1], dvec[..., 0]),
                        length=len_o, resp=top, valid=top > 0)


def detect_line_segments(img: torch.Tensor, min_length: float,
                         capacity: int = 300, n_dirs: int = 16,
                         ang_th_deg: float = 22.5, quant: float = 2.0,
                         density_th: float = 0.6, sigma: float = 0.8,
                         refine: bool = True, log_eps: float = -1.0,
                         refine_samples: int = 16, refine_search: int = 2,
                         valid_mask: torch.Tensor | None = None,
                         with_field: bool = False,
                         k_total: int | None = None,
                         per_direction: bool = False, k_per_dir: int = 64):
    """Full dense line-segment detection on grayscale images [N, H, W].

    min_length: threshold in pixels (reference: min_line_length *
    min(W, H)).  log_eps >= 0 adds the a-contrario NFA validation (keep a
    segment iff -log10(NFA) >= log_eps); -1 disables it.  valid_mask
    ([H, W] bool) restricts detection to True pixels.  refine=False is the
    FLD-like mode: raw run endpoints.  with_field=True also returns the
    (ang, mag) field of the smoothed input.  k_total: size of the raw-run
    candidate pool fed to the O(K^2) merges (default max(2 capacity,
    256)).  per_direction selects the candidate generator: False (the
    default) is the all-direction run kernel with one global top-k, True
    one launch of the one-direction kernel per direction with the best
    k_per_dir runs of each."""
    ang, mag = line_field(img, sigma, valid_mask)
    packed = run_maps(ang, mag, n_dirs, ang_th_deg, quant, per_direction)
    segs = segments_from_runs(
        ang, mag, packed, min_length, capacity=capacity, n_dirs=n_dirs,
        ang_th_deg=ang_th_deg, density_th=density_th, refine=refine,
        log_eps=log_eps, refine_samples=refine_samples,
        refine_search=refine_search, k_total=k_total,
        per_direction=per_direction, k_per_dir=k_per_dir)
    if with_field:
        return segs, ang, mag
    return segs
