"""Batched patch extraction: [N, H, W] images + [N, K] top-left corners
-> [N, K, PY, PX] windows.

`extract_patches` launches the CUDA kernel `csrc/patches.cu` on CUDA
tensors and takes the plain PyTorch twin `extract_patches_plain` on CPU
tensors.  Both reproduce the JAX package's Pallas kernel
(stvo_pl_tpu/ops/patches.py _pallas_extract): square patches of f32, and
the (1, PX) row mode in which 32-bit integers pass through bit for bit.
Reads outside the image give 0, as the reference's zero-padded staging.
"""

from __future__ import annotations

import torch

from stvo_pl_tpu_torch import build

_KINDS = {torch.float32: "f32", torch.int32: "b32", torch.uint32: "b32"}


def _patch_dims(patch) -> tuple[int, int]:
    return (patch, patch) if isinstance(patch, int) else tuple(patch)


def extract_patches_plain(img: torch.Tensor, y0: torch.Tensor,
                          x0: torch.Tensor, patch=33) -> torch.Tensor:
    """Plain PyTorch version: one gather over precomputed flat indices."""
    N, H, W = img.shape
    K = y0.shape[-1]
    PY, PX = _patch_dims(patch)
    src = img.view(torch.int32) if img.dtype == torch.uint32 else img
    dev = img.device
    ys = y0.to(torch.int64)[..., None] + torch.arange(PY, device=dev)
    xs = x0.to(torch.int64)[..., None] + torch.arange(PX, device=dev)
    inb = (((ys >= 0) & (ys < H))[..., :, None]
           & ((xs >= 0) & (xs < W))[..., None, :])
    flat = (ys.clamp(0, H - 1)[..., :, None] * W
            + xs.clamp(0, W - 1)[..., None, :])
    vals = torch.gather(src.reshape(N, H * W), 1,
                        flat.reshape(N, K * PY * PX)).reshape(N, K, PY, PX)
    out = torch.where(inb, vals, torch.zeros((), dtype=src.dtype,
                                             device=dev))
    return out.view(torch.uint32) if img.dtype == torch.uint32 else out


def extract_patches(img: torch.Tensor, y0: torch.Tensor, x0: torch.Tensor,
                    patch=33) -> torch.Tensor:
    """[N, H, W] (f32, i32 or u32) + [N, K] i32 top-left corners ->
    [N, K, PY, PX] in the image's type.  `patch` is an int (square) or a
    (PY, PX) pair.  CUDA tensors launch the kernel (counted in
    `extract_patches.launches`)."""
    if img.ndim != 3 or img.dtype not in _KINDS:
        raise ValueError(f"extract_patches wants [N, H, W] f32/i32/u32, got "
                         f"{tuple(img.shape)} {img.dtype}")
    N, H, W = img.shape
    if y0.shape != x0.shape or y0.ndim != 2 or y0.shape[0] != N:
        raise ValueError(f"corner shapes {tuple(y0.shape)} / "
                         f"{tuple(x0.shape)} do not match {N} images")
    if img.device.type == "cpu":
        return extract_patches_plain(img, y0, x0, patch)
    if img.device.type != "cuda":
        raise ValueError(f"extract_patches: unsupported device {img.device}")
    if y0.device != img.device or x0.device != img.device:
        raise ValueError("extract_patches: corners and image on different "
                         "devices")
    if y0.dtype != torch.int32 or x0.dtype != torch.int32:
        raise ValueError("extract_patches wants int32 corners")
    if not (img.is_contiguous() and y0.is_contiguous()
            and x0.is_contiguous()):
        raise ValueError("extract_patches wants contiguous tensors")
    K = y0.shape[1]
    PY, PX = _patch_dims(patch)
    out = torch.empty((N, K, PY, PX), dtype=img.dtype, device=img.device)
    lib = build.library()
    fn = (lib.stvo_extract_patches_f32 if _KINDS[img.dtype] == "f32"
          else lib.stvo_extract_patches_b32)
    with torch.cuda.device(img.device):
        stream = torch.cuda.current_stream(img.device).cuda_stream
        rc = fn(img.data_ptr(), y0.data_ptr(), x0.data_ptr(), out.data_ptr(),
                N, H, W, K, PY, PX, stream)
    build.check(rc, "extract_patches")
    extract_patches.launches += 1
    return out


extract_patches.launches = 0
