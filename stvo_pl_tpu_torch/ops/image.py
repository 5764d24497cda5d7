"""Image primitives: separable Gaussian blur, Sobel gradients and the
composed-operator image pyramid, batched over leading dims of [..., H, W]
float32 tensors.

Port of stvo_pl_tpu/ops/image.py.  Blur and Sobel are shift-multiply-
accumulate with edge replication, in the reference's tap order.  The
resampling operators are built in numpy exactly as in the reference
(`_resample_matrix`, `_pyramid_matrices`) and applied as two float32
matrix products.  The products run in full float32: the reference's TPU
default of bf16 operands is not reproduced, so the port's pyramid equals
the JAX package's CPU semantics.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch
import torch.nn.functional as F

from stvo_pl_tpu_torch.device import device_cache
from stvo_pl_tpu_torch.parallel.compiled import Compiled, compile_fn


def gaussian_kernel1d(sigma: float, radius: int | None = None) -> np.ndarray:
    if radius is None:
        radius = max(1, int(math.ceil(3.0 * sigma)))
    x = np.arange(-radius, radius + 1, dtype=np.float64)
    k = np.exp(-0.5 * (x / sigma) ** 2)
    return (k / k.sum()).astype(np.float32)


def _axis_shift(x: torch.Tensor, d: int, axis: int) -> torch.Tensor:
    """out[i] = x[clip(i + d, 0, n - 1)] along `axis` (edge replication)."""
    n = x.shape[axis]
    idx = torch.clamp(torch.arange(n, device=x.device) + d, 0, n - 1)
    return torch.index_select(x, axis, idx)


def _sep_conv(img: torch.Tensor, k: np.ndarray) -> torch.Tensor:
    r = (len(k) - 1) // 2
    out = torch.zeros_like(img)
    for i, kv in enumerate(k):
        out = out + float(kv) * _axis_shift(img, i - r, img.ndim - 2)
    img2 = out
    out = torch.zeros_like(img)
    for i, kv in enumerate(k):
        out = out + float(kv) * _axis_shift(img2, i - r, img.ndim - 1)
    return out


def gaussian_blur(img: torch.Tensor, sigma: float,
                  radius: int | None = None) -> torch.Tensor:
    return _sep_conv(img, gaussian_kernel1d(sigma, radius))


def sobel(img: torch.Tensor):
    """(gx, gy) Sobel gradients with edge replication, batched."""
    def conv2(x, kr, kc):
        y = torch.zeros_like(x)
        for i, kv in enumerate(kr):
            if kv:
                y = y + float(kv) * _axis_shift(x, i - 1, x.ndim - 2)
        out = torch.zeros_like(x)
        for i, kv in enumerate(kc):
            if kv:
                out = out + float(kv) * _axis_shift(y, i - 1, x.ndim - 1)
        return out

    smooth = (1.0, 2.0, 1.0)
    diff = (-1.0, 0.0, 1.0)
    return conv2(img, smooth, diff), conv2(img, diff, smooth)


@functools.lru_cache(maxsize=64)
def _resample_matrix(n_in: int, n_out: int, blur_sigma: float) -> np.ndarray:
    """[n_in, n_out] 1-D resampling operator: optional edge-replicated
    Gaussian blur composed with antialiased bilinear interpolation
    (half-pixel centers, triangle kernel scaled by the downsample ratio).
    A numpy copy of the reference's builder; tests assert equal arrays."""
    scale = n_in / n_out
    M = np.zeros((n_in, n_out), np.float64)
    if scale <= 1.0:
        pos = (np.arange(n_out) + 0.5) * scale - 0.5
        i0 = np.floor(pos)
        f = (pos - i0).astype(np.float64)
        a = np.clip(i0, 0, n_in - 1).astype(int)
        b = np.clip(i0 + 1, 0, n_in - 1).astype(int)
        M[a, np.arange(n_out)] += 1.0 - f
        M[b, np.arange(n_out)] += f
    else:
        for j in range(n_out):
            c = (j + 0.5) * scale - 0.5
            idx = np.arange(int(np.floor(c - scale)),
                            int(np.ceil(c + scale)) + 1)
            w = np.maximum(0.0, 1.0 - np.abs(idx - c) / scale)
            keep = (idx >= 0) & (idx < n_in) & (w > 0)
            idx, w = idx[keep], w[keep]
            M[idx, j] = w / w.sum()
    if blur_sigma > 0:
        k = gaussian_kernel1d(blur_sigma).astype(np.float64)
        r = (len(k) - 1) // 2
        B = np.zeros((n_in, n_in), np.float64)
        for i, kv in enumerate(k):
            src = np.clip(np.arange(n_in) + (i - r), 0, n_in - 1)
            B[src, np.arange(n_in)] += kv
        M = B @ M
    return M.astype(np.float32)


@functools.lru_cache(maxsize=16)
def _pyramid_matrices(H: int, W: int, n_levels: int, scale: float,
                      blur_sigma: float):
    """Per-level composed (My_l, Mx_l) operators from the base image: the
    cascade blur + resize, folded in float64 into one pair per level."""
    mats = []
    My = Mx = None
    for lv in range(1, n_levels):
        s = scale ** lv
        nh, nw = max(16, int(round(H / s))), max(16, int(round(W / s)))
        step_y = _resample_matrix(My.shape[1] if My is not None else H,
                                  nh, blur_sigma).astype(np.float64)
        step_x = _resample_matrix(Mx.shape[1] if Mx is not None else W,
                                  nw, blur_sigma).astype(np.float64)
        My = step_y if My is None else My @ step_y
        Mx = step_x if Mx is None else Mx @ step_x
        mats.append((My.astype(np.float32), Mx.astype(np.float32)))
    return mats


@device_cache
def _device_pyramid(H: int, W: int, n_levels: int, scale: float,
                    blur_sigma: float, device: torch.device):
    return [(torch.from_numpy(My.T.copy()).to(device),
             torch.from_numpy(Mx).to(device))
            for My, Mx in _pyramid_matrices(H, W, n_levels, scale,
                                            blur_sigma)]


@device_cache
def _device_resize(H: int, W: int, out_h: int, out_w: int, blur_sigma: float,
                   device: torch.device):
    """(My^T, Mx) of one resize on `device`, uploaded once."""
    return (torch.from_numpy(
                _resample_matrix(H, out_h, blur_sigma).T.copy()).to(device),
            torch.from_numpy(_resample_matrix(W, out_w, blur_sigma)).to(
                device))


def _apply_separable(img: torch.Tensor, MyT: torch.Tensor,
                     Mx: torch.Tensor) -> torch.Tensor:
    return torch.matmul(torch.matmul(MyT, img), Mx)


def resize_bilinear(img: torch.Tensor, out_h: int, out_w: int,
                    blur_sigma: float = 0.0) -> torch.Tensor:
    """Antialiased bilinear resize of [..., H, W] as two float32 products
    against the reference's interpolation matrices."""
    H, W = img.shape[-2:]
    MyT, Mx = _device_resize(H, W, out_h, out_w, float(blur_sigma),
                             img.device)
    return _apply_separable(img, MyT, Mx)


def pyramid_levels(img: torch.Tensor, n_levels: int, scale: float,
                   blur_sigma: float = 0.6) -> list[torch.Tensor]:
    """[img, level1, ..., level_{n-1}], each level computed directly from
    the base image through its composed operator pair."""
    H, W = img.shape[-2:]
    out = [img]
    for MyT, Mx in _device_pyramid(H, W, n_levels, float(scale),
                                   float(blur_sigma), img.device):
        out.append(_apply_separable(img, MyT, Mx))
    return out


def build_pyramid(img: torch.Tensor, n_levels: int,
                  scale_factor: float) -> list[torch.Tensor]:
    """Image pyramid as a cascade: each level blurs the one above
    (sigma = 0.5 * scale_factor) and resamples it to round(H / scale^i)
    (at least 8).  The cascade of the reference's ORB and line pyramids
    (LSDDetector computeGaussianPyramid); the VO step uses the composed
    operators of `pyramid_levels` instead."""
    H, W = img.shape[-2:]
    levels = [img]
    cur = img
    for i in range(1, n_levels):
        s = scale_factor ** i
        nh, nw = max(8, int(round(H / s))), max(8, int(round(W / s)))
        cur = gaussian_blur(cur, sigma=0.5 * scale_factor)
        cur = resize_bilinear(cur, nh, nw)
        levels.append(cur)
    return levels


def _pyramid_tuple(img: torch.Tensor, n_levels: int,
                   scale_factor: float) -> tuple[torch.Tensor, ...]:
    return tuple(build_pyramid(img, n_levels, scale_factor))


def compile_build_pyramid(n_levels: int, scale_factor: float,
                          device=None) -> Compiled:
    """`build_pyramid` as a captured program on `device` ("cuda" unless
    the caller asks for the CPU): `prog(img)` -> the levels as a tuple
    (a program returns tuples, not lists), each equal to the eager
    level bit for bit."""
    return compile_fn(_pyramid_tuple, ("img",), device, n_levels=n_levels,
                      scale_factor=scale_factor)


def box_filter(img: torch.Tensor, radius: int) -> torch.Tensor:
    """(2r+1)^2 box mean via the separable shift-accumulate, edge
    replicated."""
    k = np.ones(2 * radius + 1, np.float32) / (2 * radius + 1)
    return _sep_conv(img, k)


def maxpool3(img: torch.Tensor) -> torch.Tensor:
    """3x3 max filter (for NMS), batched, same size, -inf padding."""
    lead = img.shape[:-2]
    x = img.reshape((-1, 1) + img.shape[-2:])
    y = F.max_pool2d(x, 3, stride=1, padding=1)
    return y.reshape(lead + img.shape[-2:])
