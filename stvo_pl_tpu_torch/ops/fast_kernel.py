"""Fused FAST-9/16 score + sub-pixel fit + 3x3 NMS + cell packing.

`fast_pack` launches the CUDA kernel `csrc/fast_pack.cu` on CUDA tensors;
`fast_pack_plain` is its plain PyTorch twin, used for CPU tensors and as
the reference the kernel is checked against.  Both produce, for [N, H, W]
f32 images, the packed map of the JAX package's Pallas kernel
(stvo_pl_tpu/ops/fast_kernel.py _fast_pack_pallas), bit for bit:

    packed[p] = floor(score * 256) * 2^14 + (15 - cell_idx(p)) * 2^10
                + oy5 * 2^5 + ox5
                at 3x3-NMS survivors inside the detector border, 0 elsewhere

in shape [N, ceil(H/40)*40, round_up(W, 128)].  `select_from_packed`
turns it into fixed-capacity keypoints with one 4x4 max-pool and an exact
top-k.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from stvo_pl_tpu_torch import build
from stvo_pl_tpu_torch.device import const
from stvo_pl_tpu_torch.ops.fast import CIRCLE, fast_response

STRIP = 40     # output rows come in multiples of the reference's strip
HALO = 4       # circle radius 3 + 1 NMS row
_F32 = torch.float32


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def packed_shape(H: int, W: int) -> tuple[int, int]:
    return _round_up(H, STRIP), _round_up(W, 128)


def _c(v: float, device) -> torch.Tensor:
    return const(float(v), _F32, device)


def fast_pack_plain(img: torch.Tensor, edge: int) -> torch.Tensor:
    """Plain PyTorch version of the kernel: same operations in the same
    order as the Pallas body, over the whole image at once (the strips of
    the reference are independent given their halo)."""
    N, H, W = img.shape
    Hs, Wp = packed_shape(H, W)
    dev = img.device
    img_p = F.pad(img, (0, Wp - W, HALO, Hs + HALO - H))   # [N, Hs+8, Wp]
    R = Hs + 2                      # response rows y = -1 .. Hs
    center = img_p[:, HALO - 1:HALO - 1 + R, :]
    diffs = []
    for dy, dx in CIRCLE.tolist():
        sh = img_p[:, HALO - 1 + dy:HALO - 1 + dy + R, :]
        if dx:
            sh = torch.roll(sh, -dx, dims=-1)
        diffs.append(sh - center)
    resp = fast_response(diffs)                             # [N, R, Wp]

    gy = torch.arange(R, device=dev)[:, None] - 1
    gx = torch.arange(Wp, device=dev)[None, :]
    inside = (gy >= edge) & (gy < H - edge) & (gx >= edge) & (gx < W - edge)

    zero = _c(0.0, dev)
    neg_eps6 = _c(-1e-6, dev)
    half = _c(0.5, dev)
    rp = torch.where(resp > 0, resp, zero)
    rc = rp[:, 1:1 + Hs]
    rl = torch.roll(rc, 1, dims=-1)
    rr = torch.roll(rc, -1, dims=-1)
    ru = rp[:, 0:Hs]
    rd = rp[:, 2:2 + Hs]

    def offset(a, b):
        den = a - _c(2.0, dev) * rc + b
        neg = den < neg_eps6
        o = torch.where(neg, half * (a - b) / torch.where(neg, den,
                                                          _c(-1.0, dev)),
                        zero)
        o = torch.clamp(o, -0.5, 0.5)
        return ((o + half) * _c(31.0, dev) + half).to(torch.int32)

    oqx = offset(rl, rr)
    oqy = offset(ru, rd)

    resp = torch.where((resp > 0) & inside, resp, zero)
    eps = (gy * W + gx).to(_F32) * _c(1e-7, dev)
    se = torch.where(resp > 0, resp - eps, zero)
    nmax = None
    for dy in (-1, 0, 1):
        row = se[:, 1 + dy:1 + dy + Hs]
        for dx in (-1, 0, 1):
            if dy == 0 and dx == 0:
                continue
            v = torch.roll(row, -dx, dims=-1) if dx else row
            nmax = v if nmax is None else torch.maximum(nmax, v)
    sc = se[:, 1:1 + Hs]
    r0 = resp[:, 1:1 + Hs]
    keep = (sc >= nmax) & (r0 > 0)

    q = (r0 * _c(256.0, dev)).to(torch.int32)
    sy = torch.arange(Hs, device=dev)[:, None]
    sx = torch.arange(Wp, device=dev)[None, :]
    idx = ((sy % 4) * 4 + sx % 4).to(torch.int32)
    word = q * 16384 + (15 - idx) * 1024 + oqy * 32 + oqx
    return torch.where(keep, word, torch.zeros((), dtype=torch.int32,
                                               device=dev))


def fast_pack(img: torch.Tensor, edge: int) -> torch.Tensor:
    """[N, H, W] f32 images -> [N, ceil(H/40)*40, round_up(W,128)] i32
    packed corner maps.  CPU tensors take the plain version; CUDA tensors
    launch the kernel (counted in `fast_pack.launches`)."""
    if img.ndim != 3 or img.dtype != _F32:
        raise ValueError(f"fast_pack wants [N, H, W] float32, got "
                         f"{tuple(img.shape)} {img.dtype}")
    if edge < HALO:
        raise ValueError(f"fast_pack needs edge >= {HALO} (got {edge}): the "
                         "border mask must cover the circle's reach")
    if img.device.type == "cpu":
        return fast_pack_plain(img, edge)
    if img.device.type != "cuda":
        raise ValueError(f"fast_pack: unsupported device {img.device}")
    if not img.is_contiguous():
        raise ValueError("fast_pack wants a contiguous image tensor")
    N, H, W = img.shape
    Hs, Wp = packed_shape(H, W)
    out = torch.empty((N, Hs, Wp), dtype=torch.int32, device=img.device)
    if N == 0:
        return out
    lib = build.library()
    with torch.cuda.device(img.device):
        stream = torch.cuda.current_stream(img.device).cuda_stream
        rc = lib.stvo_fast_pack(img.data_ptr(), out.data_ptr(), N, H, W, Hs,
                                Wp, edge, stream)
    build.check(rc, "fast_pack")
    fast_pack.launches += 1
    return out


fast_pack.launches = 0


def select_from_packed(packed: torch.Tensor, capacity: int,
                       threshold: torch.Tensor, cell: int = 4,
                       subpix: bool = True):
    """[N, Hs, Wp] packed maps -> (uv [N, K, 2] f32, score [N, K] f32,
    valid [N, K] bool).

    A 4x4 max-pool recovers each cell's best survivor, its in-cell position
    and its sub-pixel offset; the cells are ranked by the f32 cast of the
    packed word (which rounds to multiples of 64-128, so equal keys occur)
    with an exact top-k that keeps the lower flat index first on ties, as
    XLA's TopK does.  `threshold` ([N] or scalar) gates the decoded scores.
    """
    N, Hs, Wp = packed.shape
    Hc, Wc = Hs // cell, Wp // cell
    pooled = packed[:, :Hc * cell, :Wc * cell].reshape(
        N, Hc, cell, Wc, cell).amax(dim=(2, 4))
    flat = pooled.reshape(N, -1)
    k = min(capacity, flat.shape[1])
    order = torch.sort(flat.to(_F32), dim=1, descending=True,
                       stable=True).indices[:, :k]
    top = torch.gather(flat, 1, order)
    idx = 15 - ((top >> 10) & 15)
    score = (top >> 14).to(_F32) * (1.0 / 256.0)
    ys = ((order // Wc) * cell + idx // 4).to(_F32)
    xs = ((order % Wc) * cell + idx % 4).to(_F32)
    if subpix:
        # a Python float multiplies a float32 tensor as float32(1/31)
        xs = xs + ((top & 31).to(_F32) * (1.0 / 31.0) - 0.5)
        ys = ys + (((top >> 5) & 31).to(_F32) * (1.0 / 31.0) - 0.5)
    th = (torch.as_tensor(threshold, dtype=_F32, device=packed.device)
          if isinstance(threshold, torch.Tensor)
          else const(float(threshold), _F32, packed.device))
    th = th.reshape(-1, 1) if th.ndim else th
    valid = (top > 0) & (score > th)
    uv = torch.stack([xs, ys], dim=-1)
    if k < capacity:
        pad = capacity - k
        uv = F.pad(uv, (0, 0, 0, pad))
        score = F.pad(score, (0, pad))
        valid = F.pad(valid, (0, pad))
    return uv, score, valid
