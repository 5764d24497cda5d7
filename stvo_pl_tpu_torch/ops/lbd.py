"""Line Band Descriptor (LBD-equivalent) as batched gather + reductions
(port of stvo_pl_tpu/ops/lbd.py; reference
3rdparty/line_descriptor/src/binary_descriptor_custom.cpp:1026-1330).

9 bands x width-7 line-support region rotated to the line direction,
per-band mean / std of 4 rectified gradient sums with local + global
Gaussian weighting, a normalized 72-float vector, then a 32-byte
binarization by pairwise band comparisons over a deterministic band-pair
table.  Gradients are computed once per image (Sobel); each line gathers a
rotated [S, R] grid of nearest-pixel (gx, gy) taps.

Outputs the 72-float descriptor and the packed 256-bit form as [..., 8]
int32 words (the bits of the reference's uint32 words), so lines share the
Hamming matching path with points.
"""

from __future__ import annotations

import numpy as np
import torch

from stvo_pl_tpu_torch.device import device_cache
from stvo_pl_tpu_torch.ops.lsd import linspace01, norm2
from stvo_pl_tpu_torch.ops.orb import _pack_words
from stvo_pl_tpu_torch.parallel.compiled import Compiled, compile_fn

N_BANDS = 9
BAND_W = 7           # widthOfBand_ = 7 (descriptor_custom.hpp:189-213)
N_SAMPLES = 8        # samples along the line direction
REGION_PX = N_BANDS * BAND_W   # 63-pixel-wide support region
N_TAPS = 7           # perpendicular taps (stride ~10 px): the band
                     # statistics are Gaussian-weighted sums, so
                     # subsampling the region trades nothing measurable
DESC_F = N_BANDS * 8  # 72 floats

# perpendicular tap positions in pixels, spanning the 63-px region
_TAP_OFF = np.linspace(-(REGION_PX - 1) / 2.0, (REGION_PX - 1) / 2.0,
                       N_TAPS).astype(np.float64)


def _band_row_assignment() -> np.ndarray:
    """[B, N_TAPS] weight matrix folding perpendicular taps into bands: each
    band k aggregates taps within its own +/- neighbor bands, weighted by
    the global (whole-region) and local (band-distance) Gaussians evaluated
    at the true pixel offset of each tap."""
    sg = 0.5 * (REGION_PX - 1)
    wg = np.exp(-0.5 * (_TAP_OFF / sg) ** 2) / (np.sqrt(2 * np.pi) * sg)
    sl = float(BAND_W)
    centers = (np.arange(N_BANDS) - (N_BANDS - 1) / 2.0) * BAND_W
    A = np.zeros((N_BANDS, N_TAPS), np.float32)
    tap_band = np.clip(np.round(_TAP_OFF / BAND_W + (N_BANDS - 1) / 2.0),
                       0, N_BANDS - 1).astype(int)
    for k in range(N_BANDS):
        m = np.abs(tap_band - k) <= 1
        wl = np.exp(-0.5 * ((_TAP_OFF - centers[k]) / sl) ** 2) \
            / (np.sqrt(2 * np.pi) * sl)
        A[k, m] = (wg * wl)[m]
    return A


def _binarization_pairs() -> np.ndarray:
    """Deterministic 32 band-pair table (i, j), i < j: all pairs with
    j - i in {1..6} (8+7+6+5+4+3 = 33), trimmed to 32.  8 dims per pair ->
    exactly 256 bits."""
    pairs = []
    for gap in (1, 2, 3, 4, 5, 6):
        for i in range(N_BANDS - gap):
            pairs.append((i, i + gap))
    pairs = pairs[:32]
    return np.asarray(pairs, np.int32)


_BAND_A = _band_row_assignment()     # [B, N_TAPS] float32
_PAIRS = _binarization_pairs()       # [32, 2]


@device_cache
def _tables(device: torch.device):
    """(tap offsets, band rows, binarization pairs) on `device`, uploaded
    once (constants of the step)."""
    return (torch.from_numpy(_TAP_OFF.astype(np.float32)).to(device),
            torch.from_numpy(_BAND_A).to(device),
            torch.from_numpy(_PAIRS).to(device).long())


def _tap_grid(sp: torch.Tensor, ep: torch.Tensor,
              n_samples: int = N_SAMPLES):
    """Rotated line-support sampling grid for endpoints [..., K, 2].
    Returns (px, py [..., K, S, R] float tap coordinates, dl, do
    [..., K, 2] the line / orthogonal unit frame)."""
    d = ep - sp
    length = torch.clamp(norm2(d), min=1e-6)
    dl = d / length[..., None]
    do = torch.stack([-dl[..., 1], dl[..., 0]], dim=-1)
    t = linspace01(n_samples, sp.device)
    along = sp[..., None, :] + d[..., None, :] * t[:, None]      # [.., S, 2]
    off = _tables(sp.device)[0]
    pts = (along[..., :, None, :]
           + do[..., None, None, :] * off[:, None])           # [.., S, R, 2]
    return pts[..., 0], pts[..., 1], dl, do


def _gather_taps(g2: torch.Tensor, yi: torch.Tensor,
                 xi: torch.Tensor) -> torch.Tensor:
    """g2 [N, H, W, 2] at integer (yi, xi) [N, K, S, R] -> [N, K, S, R, 2]."""
    N, H, W, _ = g2.shape
    flat = (yi * W + xi).reshape(N, -1, 1).expand(-1, -1, 2)
    return torch.gather(g2.reshape(N, H * W, 2), 1, flat).reshape(
        yi.shape + (2,))


def compute_lbd(gx: torch.Tensor, gy: torch.Tensor, sp: torch.Tensor,
                ep: torch.Tensor, n_samples: int = N_SAMPLES):
    """LBD descriptors for K lines in each of N images.

    gx, gy: [N, H, W] image gradients (Sobel).  sp, ep: [N, K, 2]
    endpoints.  n_samples: along-line sample count (the band statistics
    are mean / std over samples, so descriptors with different sample
    counts live in the same space).
    Returns (desc_f [N, K, 72] float32, desc_b [N, K, 8] int32)."""
    H, W = gx.shape[-2:]
    px, py, dl, do = _tap_grid(sp, ep, n_samples)
    xi = torch.clamp(torch.round(px).to(torch.int64), 0, W - 1)
    yi = torch.clamp(torch.round(py).to(torch.int64), 0, H - 1)
    sg = _gather_taps(torch.stack([gx, gy], dim=-1), yi, xi)
    return _lbd_from_taps(sg, dl, do)


def compute_lbd_atlas(g2: torch.Tensor, sp: torch.Tensor, ep: torch.Tensor,
                      x_off: torch.Tensor, y_off: torch.Tensor,
                      x_hi: torch.Tensor, y_hi: torch.Tensor,
                      n_samples: int = N_SAMPLES):
    """LBD from a packed multi-octave gradient atlas.

    g2: [N, H, W, 2] atlas of (gx, gy), each octave's plane at its region
    of the canvas.  sp, ep: [N, K, 2] endpoints in each line's own octave
    coordinates.  x_off, y_off, x_hi, y_hi: [N, K] integer region offset
    and inclusive region-local clip bounds per line (taps are clipped to
    the line's own octave plane before the offset, so the support region
    never reads a neighboring region through the atlas).
    Returns (desc_f [N, K, 72], desc_b [N, K, 8] int32)."""
    px, py, dl, do = _tap_grid(sp, ep, n_samples)
    zero = torch.zeros((), dtype=torch.int64, device=g2.device)
    x_hi, y_hi = x_hi.to(torch.int64), y_hi.to(torch.int64)
    xi = (torch.minimum(torch.maximum(torch.round(px).to(torch.int64), zero),
                        x_hi[..., None, None])
          + x_off.to(torch.int64)[..., None, None])
    yi = (torch.minimum(torch.maximum(torch.round(py).to(torch.int64), zero),
                        y_hi[..., None, None])
          + y_off.to(torch.int64)[..., None, None])
    return _lbd_from_taps(_gather_taps(g2, yi, xi), dl, do)


def compile_compute_lbd(n_samples: int = N_SAMPLES,
                        device=None) -> Compiled:
    """`compute_lbd` as a captured program on `device` ("cuda" unless the
    caller asks for the CPU): `prog(gx, gy, sp, ep) -> (desc_f, desc_b)`,
    equal to the eager call bit for bit."""
    return compile_fn(compute_lbd, ("gx", "gy", "sp", "ep"), device,
                      n_samples=n_samples)


def compile_compute_lbd_atlas(n_samples: int = N_SAMPLES,
                              device=None) -> Compiled:
    """`compute_lbd_atlas` as a captured program on `device` ("cuda"
    unless the caller asks for the CPU): `prog(g2, sp, ep, x_off, y_off,
    x_hi, y_hi) -> (desc_f, desc_b)`, equal to the eager call bit for
    bit."""
    return compile_fn(compute_lbd_atlas,
                      ("g2", "sp", "ep", "x_off", "y_off", "x_hi", "y_hi"),
                      device, n_samples=n_samples)


def _unit(v: torch.Tensor) -> torch.Tensor:
    return v / torch.clamp(
        torch.sqrt(torch.sum(v * v, dim=-1, keepdim=True)), min=1e-12)


def _lbd_from_taps(sg: torch.Tensor, dl: torch.Tensor, do: torch.Tensor):
    """Band statistics + normalization + binarization from gathered taps
    (sg [N, K, S, R, 2] sampled (gx, gy); dl / do [N, K, 2] the line
    frame)."""
    lead = sg.shape[:-3]                           # (N, K)
    sgx, sgy = sg[..., 0], sg[..., 1]
    g_dl = sgx * dl[..., None, None, 0] + sgy * dl[..., None, None, 1]
    g_do = sgx * do[..., None, None, 0] + sgy * do[..., None, None, 1]

    # 4 rectified channels [N, K, S, R, 4]
    ch = torch.stack([torch.clamp(g_do, min=0.0), torch.clamp(-g_do, min=0.0),
                      torch.clamp(g_dl, min=0.0), torch.clamp(-g_dl, min=0.0)],
                     dim=-1)
    # fold taps into bands with Gaussian weights: [N, K, S, B, 4]
    band_a = _tables(sg.device)[1]
    band_vals = torch.matmul(band_a, ch)

    n_s = band_vals.shape[-3]
    mean = torch.sum(band_vals, dim=-3) / n_s               # [N, K, B, 4]
    dev = band_vals - mean[..., None, :, :]
    std = torch.sqrt(torch.sum(dev * dev, dim=-3) / n_s)    # population

    # normalize mean and std halves separately, clamp outliers at 0.4 and
    # renormalize (reference normalization, :1282-1311)
    mean_part = _unit(mean.reshape(lead + (N_BANDS * 4,)))
    std_part = _unit(std.reshape(lead + (N_BANDS * 4,)))
    mean_part = _unit(torch.clamp(mean_part, max=0.4))
    std_part = _unit(torch.clamp(std_part, max=0.4))
    per_band = torch.cat([mean_part.reshape(lead + (N_BANDS, 4)),
                          std_part.reshape(lead + (N_BANDS, 4))], dim=-1)
    desc_f = per_band.reshape(lead + (DESC_F,))

    # binarize: 32 band pairs x 8 dims (reference binaryConversion, :401-412)
    pairs = _tables(sg.device)[2]
    a = per_band[..., pairs[:, 0], :]                       # [N, K, 32, 8]
    b = per_band[..., pairs[:, 1], :]
    bits = (a > b).reshape(lead + (8, 32))
    return desc_f, _pack_words(bits, 1)
