"""Oriented binary point descriptors (ORB-equivalent), port of
stvo_pl_tpu/ops/orb.py.

Patches are gathered once per keypoint by the patch kernel
(ops/patches.py), quantized to the uint8 grid, oriented by the intensity
centroid, and described by rotated-BRIEF tests under the orientation
quantized to 30 bins.  The tables (`_make_pattern`, `_binned_test_matrix`,
`_circular_mask`, the WTA sampling matrix) are numpy copies of the
reference's builders; tests assert equal arrays.

`orient_describe` takes one of two formulations by the tensor's device:

  * CPU tensors: ONE product against the static orientation-binned +/-1
    test matrix, then each keypoint's own bin's 256 columns
    (`orient_describe_product`), as the reference computes it.
  * CUDA tensors: the kernel `csrc/orb_describe.cu` (`orb_describe`),
    which evaluates only the keypoint's 256 tests, q[i1] > q[i0], from the
    [30, 256, 2] table of test pixels (`_test_index_table`).  Its plain
    twin is `orient_describe_plain`.

Descriptors are [..., 8] int32 words holding the bits of the reference's
uint32 words.  Both formulations give the same bits: the test-bank
product is exact on every device (the quantized patch values (<= 255) and
the +/-1 entries are exact in bf16 and each output sums two of them), so
its output is q[i1] - q[i0].  `describe_wta` (WTA_K = 3/4) keeps the
product.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from stvo_pl_tpu_torch import build
from stvo_pl_tpu_torch.device import device_cache
from stvo_pl_tpu_torch.ops.patches import extract_patches
from stvo_pl_tpu_torch.parallel.compiled import Compiled, compile_fn

PATCH_R = 16          # gathered patch radius -> 33x33 patches
PATCH = 2 * PATCH_R + 1
ORI_R = 15            # intensity-centroid radius
PATTERN_R = 13.0      # max test-point radius (rotation-safe)
N_BITS = 256
N_ORI_BINS = 30
N_CELLS = 128


@functools.lru_cache(maxsize=8)
def _make_pattern(patch_size: int = 31, seed: int = 8861) -> np.ndarray:
    """[256, 2, 2] float32 (pair, point, (dx, dy)) Gaussian BRIEF pattern,
    sigma = patch/5, clipped to the rotation-safe radius."""
    rng = np.random.default_rng(seed)
    sigma = patch_size / 5.0
    pattern_r = min(PATTERN_R, patch_size / 2.0 - 2.0)
    pts = rng.normal(0.0, sigma, size=(N_BITS, 2, 2))
    r = np.linalg.norm(pts, axis=-1, keepdims=True)
    scale = np.minimum(1.0, pattern_r / np.maximum(r, 1e-9))
    return (pts * scale).astype(np.float32)


def _circular_mask(radius: int, size: int) -> np.ndarray:
    c = (size - 1) / 2.0
    y, x = np.mgrid[0:size, 0:size]
    return (((x - c) ** 2 + (y - c) ** 2) <= radius ** 2).astype(np.float32)


_ORI_MASK = _circular_mask(ORI_R, PATCH)
_ORI_X = ((np.mgrid[0:PATCH, 0:PATCH][1] - PATCH_R)
          * _ORI_MASK).astype(np.float32)
_ORI_Y = ((np.mgrid[0:PATCH, 0:PATCH][0] - PATCH_R)
          * _ORI_MASK).astype(np.float32)


def _rotated_index(pattern: np.ndarray, b: int) -> np.ndarray:
    """Flat patch pixel indices [...] of the points `pattern` [..., 2]
    (dx, dy) rotated to orientation bin b, rounded and clipped inside the
    patch."""
    th = 2.0 * np.pi * b / N_ORI_BINS
    c, s = np.cos(th), np.sin(th)
    px = pattern[..., 0]
    py = pattern[..., 1]
    rx = np.clip(np.round(c * px - s * py + PATCH_R), 0, PATCH - 1)
    ry = np.clip(np.round(s * px + c * py + PATCH_R), 0, PATCH - 1)
    return (ry * PATCH + rx).astype(np.int32)


@functools.lru_cache(maxsize=8)
def _test_index_table(patch_size: int = 31) -> np.ndarray:
    """[N_ORI_BINS, 256, 2] int16 flat pixel indices (i0, i1) of each
    bit's two test points under each orientation bin: bit c of bin b is
    q[i1] > q[i0]."""
    pattern = _make_pattern(patch_size)
    return np.stack([_rotated_index(pattern, b)
                     for b in range(N_ORI_BINS)]).astype(np.int16)


@functools.lru_cache(maxsize=8)
def _binned_test_matrix(patch_size: int = 31) -> np.ndarray:
    """[P*P, N_ORI_BINS * 256] +/-1 difference matrix: column (b, c) has +1
    at the rotated position of test point 1 and -1 at test point 0 of bit
    c under orientation bin b."""
    D = np.zeros((PATCH * PATCH, N_ORI_BINS * N_BITS), np.float32)
    pattern = _make_pattern(patch_size)
    for b in range(N_ORI_BINS):
        idx = _rotated_index(pattern, b)
        cols = b * N_BITS + np.arange(N_BITS)
        np.add.at(D, (idx[:, 1], cols), 1.0)
        np.add.at(D, (idx[:, 0], cols), -1.0)
    return D


@functools.lru_cache(maxsize=8)
def _make_wta_pattern(patch_size: int, wta_k: int,
                      seed: int = 8861) -> np.ndarray:
    """[128, wta_k, 2] float32 sample tuples."""
    rng = np.random.default_rng(seed + wta_k)
    sigma = patch_size / 5.0
    pattern_r = min(PATTERN_R, patch_size / 2.0 - 2.0)
    pts = rng.normal(0.0, sigma, size=(N_CELLS, wta_k, 2))
    r = np.linalg.norm(pts, axis=-1, keepdims=True)
    scale = np.minimum(1.0, pattern_r / np.maximum(r, 1e-9))
    return (pts * scale).astype(np.float32)


@functools.lru_cache(maxsize=8)
def _binned_sample_matrix(patch_size: int, wta_k: int) -> np.ndarray:
    """[P*P, N_ORI_BINS * 128 * wta_k] one-hot sampling matrix."""
    S = np.zeros((PATCH * PATCH, N_ORI_BINS * N_CELLS * wta_k), np.float32)
    pattern = _make_wta_pattern(patch_size, wta_k)
    for b in range(N_ORI_BINS):
        idx = _rotated_index(pattern, b)
        cols = (b * N_CELLS * wta_k
                + np.arange(N_CELLS)[:, None] * wta_k
                + np.arange(wta_k)[None, :])
        np.add.at(S, (idx, cols), 1.0)
    return S


def _matmul_dtype(device: torch.device) -> torch.dtype:
    return torch.bfloat16 if device.type == "cuda" else torch.float32


@device_cache
def _device_table(kind: str, patch_size: int, wta_k: int,
                  device: torch.device) -> torch.Tensor:
    M = (_binned_test_matrix(patch_size) if kind == "test"
         else _binned_sample_matrix(patch_size, wta_k))
    return torch.from_numpy(M).to(device=device,
                                  dtype=_matmul_dtype(device))


@device_cache
def _device_index_table(patch_size: int,
                        device: torch.device) -> torch.Tensor:
    return torch.from_numpy(_test_index_table(patch_size)).to(device)


@device_cache
def _ori_weights(device: torch.device):
    return (torch.from_numpy(_ORI_X).to(device),
            torch.from_numpy(_ORI_Y).to(device))


def gather_patches(img: torch.Tensor, uv: torch.Tensor,
                   radius: int = PATCH_R) -> torch.Tensor:
    """[N, H, W] x [N, K, 2] -> [N, K, 2r+1, 2r+1] integer-centered
    patches, clamped inside the image (the patch kernel on CUDA)."""
    N, H, W = img.shape
    P = 2 * radius + 1
    x0 = torch.clamp(torch.round(uv[..., 0]).to(torch.int32) - radius,
                     0, W - P)
    y0 = torch.clamp(torch.round(uv[..., 1]).to(torch.int32) - radius,
                     0, H - P)
    return extract_patches(img.contiguous(), y0.contiguous(),
                           x0.contiguous(), patch=P)


def orientation(patches: torch.Tensor):
    """Intensity-centroid orientation per patch [..., P, P] ->
    (cos, sin) [...]."""
    p = patches.to(torch.float32)
    mx, my = _ori_weights(p.device)
    m10 = torch.sum(p * mx, dim=(-2, -1))
    m01 = torch.sum(p * my, dim=(-2, -1))
    norm = torch.sqrt(m10 * m10 + m01 * m01)
    safe = norm > 1e-6
    den = torch.clamp(norm, min=1e-6)
    c = torch.where(safe, m10 / den, torch.ones_like(m10))
    s = torch.where(safe, m01 / den, torch.zeros_like(m01))
    return c, s


def _bin_index(cos_t: torch.Tensor, sin_t: torch.Tensor) -> torch.Tensor:
    angle = torch.atan2(sin_t, cos_t)
    b = torch.round(angle * (N_ORI_BINS / (2.0 * np.pi)))
    return torch.remainder(b, N_ORI_BINS).to(torch.int64)


def _binned_product(patches: torch.Tensor, kind: str, patch_size: int,
                    wta_k: int, bin_idx: torch.Tensor, width: int):
    """flat patches @ table, then each keypoint's own orientation block of
    `width` outputs: [K, width] float32."""
    flat = patches.reshape(-1, patches.shape[-2] * patches.shape[-1])
    table = _device_table(kind, patch_size, wta_k, flat.device)
    out = torch.matmul(flat.to(torch.bfloat16).to(table.dtype), table)
    out = out.reshape(-1, N_ORI_BINS, width)
    idx = bin_idx.reshape(-1, 1, 1).expand(-1, 1, width)
    return torch.gather(out, 1, idx)[:, 0].to(torch.float32)


def _pack_words(fields: torch.Tensor, bits_per_field: int) -> torch.Tensor:
    """[..., 8, 32 / bits] small ints -> [..., 8] int32 words (field i at
    bit i * bits)."""
    n = fields.shape[-1]
    shifts = torch.arange(n, device=fields.device) * bits_per_field
    v = torch.sum(fields.to(torch.int64) << shifts, dim=-1)
    return torch.where(v >= 2 ** 31, v - 2 ** 32, v).to(torch.int32)


def describe(patches: torch.Tensor, cos_t: torch.Tensor,
             sin_t: torch.Tensor, patch_size: int = 31) -> torch.Tensor:
    """Rotated-BRIEF descriptors: [..., P, P] -> [..., 8] int32, with the
    orientation quantized to 30 bins."""
    lead = patches.shape[:-2]
    mine = _binned_product(patches, "test", patch_size, 0,
                           _bin_index(cos_t, sin_t), N_BITS)
    bits = (mine > 0).reshape(-1, 8, 32)
    return _pack_words(bits, 1).reshape(lead + (8,))


def _quantize(patches: torch.Tensor) -> torch.Tensor:
    return torch.clamp(torch.round(patches.to(torch.float32)), 0.0, 255.0)


def orient_describe_product(patches: torch.Tensor, patch_size: int = 31):
    """`orient_describe` by the test-bank product (its path on the CPU)."""
    q = _quantize(patches)
    cos_t, sin_t = orientation(q)
    return describe(q, cos_t, sin_t, patch_size=patch_size), cos_t, sin_t


def orient_describe_plain(patches: torch.Tensor, patch_size: int = 31):
    """`orient_describe` as the kernel computes it, in plain PyTorch (the
    kernel's twin): each keypoint's 256 tests q[i1] > q[i0] under its
    orientation bin, gathered from the index table and packed, bit for bit
    `orient_describe_product`."""
    lead = patches.shape[:-2]
    q = _quantize(patches)
    cos_t, sin_t = orientation(q)
    flat = q.reshape(-1, PATCH * PATCH)
    table = _device_index_table(patch_size, flat.device).long()
    pairs = table[_bin_index(cos_t, sin_t).reshape(-1)]     # [K, 256, 2]
    bits = (torch.gather(flat, 1, pairs[..., 1])
            > torch.gather(flat, 1, pairs[..., 0])).reshape(-1, 8, 32)
    return _pack_words(bits, 1).reshape(lead + (8,)), cos_t, sin_t


def orb_describe(patches: torch.Tensor, patch_size: int = 31):
    """The kernel `csrc/orb_describe.cu` on CUDA patches [..., 33, 33]:
    (desc [..., 8] int32, cos [...], sin [...]), bit for bit
    `orient_describe_product`.  Counted in `orb_describe.launches`."""
    if patches.ndim < 2 or tuple(patches.shape[-2:]) != (PATCH, PATCH):
        raise ValueError(f"orb_describe wants [..., {PATCH}, {PATCH}] "
                         f"patches, got {tuple(patches.shape)}")
    if patches.device.type != "cuda":
        raise ValueError(f"orb_describe: unsupported device {patches.device}")
    lead = patches.shape[:-2]
    flat = patches.to(torch.float32).reshape(-1, PATCH, PATCH).contiguous()
    K = flat.shape[0]
    dev = flat.device
    desc = torch.empty((K, 8), dtype=torch.int32, device=dev)
    cos_t = torch.empty((K,), dtype=torch.float32, device=dev)
    sin_t = torch.empty((K,), dtype=torch.float32, device=dev)
    if K:
        table = _device_index_table(patch_size, dev)
        lib = build.library()
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            rc = lib.stvo_orb_describe(flat.data_ptr(), table.data_ptr(),
                                       desc.data_ptr(), cos_t.data_ptr(),
                                       sin_t.data_ptr(), K, stream)
        build.check(rc, "orb_describe")
        orb_describe.launches += 1
    return desc.reshape(lead + (8,)), cos_t.reshape(lead), sin_t.reshape(lead)


orb_describe.launches = 0


def orient_describe(patches: torch.Tensor, patch_size: int = 31):
    """Quantized orientation + rotated BRIEF: [..., P, P] ->
    (desc [..., 8] int32, cos [...], sin [...]).  Patches are snapped to
    the 0..255 grid first, so near-tie tests are deterministic.  CUDA
    tensors launch the kernel (`orb_describe`), CPU tensors take the
    product (`orient_describe_product`): the same bits."""
    if patches.device.type == "cuda":
        return orb_describe(patches, patch_size=patch_size)
    return orient_describe_product(patches, patch_size=patch_size)


def orient_and_describe(img: torch.Tensor, img_blur: torch.Tensor,
                        uv: torch.Tensor, patch_size: int = 31):
    """Full per-level descriptor pass: one patch gather per keypoint (the
    patch kernel on CUDA) from the blurred image, then orientation and
    rotated BRIEF.  img_blur [H, W] with uv [K, 2] level coords, or
    [N, H, W] with [N, K, 2]; returns (desc [..., K, 8] int32, cos, sin).
    `img` is unused: the orientation reads the blurred patch too."""
    del img
    single = img_blur.ndim == 2
    if single:
        img_blur, uv = img_blur[None], uv[None]
    out = orient_describe(gather_patches(img_blur, uv),
                          patch_size=patch_size)
    return tuple(x[0] for x in out) if single else out


def compile_orient_and_describe(patch_size: int = 31,
                                device=None) -> Compiled:
    """`orient_and_describe` as a captured program on `device` ("cuda"
    unless the caller asks for the CPU): `prog(img, img_blur, uv) ->
    (desc, cos, sin)`, equal to the eager call bit for bit; on the card
    its graph holds the patch gather and the descriptor kernels."""
    return compile_fn(orient_and_describe, ("img", "img_blur", "uv"),
                      device, patch_size=patch_size)


def describe_wta(patches: torch.Tensor, cos_t: torch.Tensor,
                 sin_t: torch.Tensor, wta_k: int,
                 patch_size: int = 31) -> torch.Tensor:
    """WTA_K = 3/4 descriptors: [..., P, P] -> [..., 8] int32 of 128 2-bit
    argmax cells (ties to the lowest tuple index)."""
    if wta_k not in (3, 4):
        raise ValueError(f"describe_wta: wta_k must be 3 or 4, got {wta_k}")
    lead = patches.shape[:-2]
    mine = _binned_product(patches, "wta", patch_size, wta_k,
                           _bin_index(cos_t, sin_t), N_CELLS * wta_k)
    cell = torch.argmax(mine.reshape(-1, N_CELLS, wta_k), dim=-1)
    return _pack_words(cell.reshape(-1, 8, 16), 2).reshape(lead + (8,))
