"""Batched Hamming-distance matrices for 256-bit binary descriptors
(port of stvo_pl_tpu/ops/hamming.py).

Descriptors are [..., N, 8] int32 words.  Right shifts of int32 are
arithmetic, so every extracted field is masked after the shift.

  * `hamming_matrix_mxu`: bits unpacked to +/-1 and ONE matrix product,
    d = (256 - <a, b>) / 2.  Exact: every partial sum is an integer of
    magnitude <= 256 (bf16 operands on the GPU, float32 on the CPU).
  * `hamming_matrix_popc`: XOR + popcount distances from a CUDA kernel
    (`csrc/hamming.cu`, the port of the Pallas kernel
    hamming_matrix_pallas: 1-bit tensor-core MMA, popc(a & b) per pair)
    on CUDA tensors, any N and M; CPU tensors take its plain version
    `hamming_matrix_xla`.  `hamming_matrix(...,
    use_mxu=False)` is this path.
  * `hamming_matrix_xla`: XOR + popcount, the plain formulation.
  * HAMMING2 (WTA_K = 3/4): the same two formulations over 2-bit cells.
"""

from __future__ import annotations

import torch

from stvo_pl_tpu_torch import build

DESC_WORDS = 8
DESC_BITS = 32 * DESC_WORDS
N_CELLS = DESC_BITS // 2


def _mm_dtype(t: torch.Tensor) -> torch.dtype:
    return torch.bfloat16 if t.device.type == "cuda" else torch.float32


def unpack_bits_pm1(desc: torch.Tensor, dtype=None) -> torch.Tensor:
    """[..., 8] int32 -> [..., 256] in {-1, +1}."""
    shifts = torch.arange(32, device=desc.device, dtype=torch.int32)
    bits = (desc[..., :, None] >> shifts) & 1
    bits = bits.reshape(desc.shape[:-1] + (DESC_BITS,))
    return (2 * bits - 1).to(dtype or _mm_dtype(desc))


def hamming_matrix_mxu(desc1: torch.Tensor,
                       desc2: torch.Tensor) -> torch.Tensor:
    """[..., N, 8] x [..., M, 8] -> [..., N, M] int32 via one product."""
    a = unpack_bits_pm1(desc1)
    b = unpack_bits_pm1(desc2)
    dot = torch.matmul(a, b.transpose(-1, -2)).to(torch.float32)
    return ((DESC_BITS - dot) * 0.5).to(torch.int32)


def _popcount32(v: torch.Tensor) -> torch.Tensor:
    """Bit-parallel popcount of the low 32 bits of int64 lanes."""
    v = v - ((v >> 1) & 0x55555555)
    v = (v & 0x33333333) + ((v >> 2) & 0x33333333)
    v = (v + (v >> 4)) & 0x0F0F0F0F
    return (((v * 0x01010101) & 0xFFFFFFFF) >> 24).to(torch.int32)


def _words_u(desc: torch.Tensor) -> torch.Tensor:
    return desc.to(torch.int64) & 0xFFFFFFFF


def hamming_matrix_xla(desc1: torch.Tensor,
                       desc2: torch.Tensor) -> torch.Tensor:
    """XOR + popcount, word by word."""
    a, b = _words_u(desc1), _words_u(desc2)
    total = 0
    for w in range(DESC_WORDS):
        total = total + _popcount32(a[..., :, None, w] ^ b[..., None, :, w])
    return total.to(torch.int32)


def hamming_matrix_popc(desc1: torch.Tensor,
                        desc2: torch.Tensor) -> torch.Tensor:
    """[..., N, 8] x [..., M, 8] int32 words -> [..., N, M] int32 by XOR +
    popcount, the leading dims broadcast against each other.  CPU tensors
    take the plain version; CUDA tensors launch the kernel (counted in
    `hamming_matrix_popc.launches`)."""
    for d in (desc1, desc2):
        if d.ndim < 2 or d.shape[-1] != DESC_WORDS or d.dtype != torch.int32:
            raise ValueError(f"hamming_matrix_popc wants [..., N, "
                             f"{DESC_WORDS}] int32 descriptors, got "
                             f"{tuple(d.shape)} {d.dtype}")
    if desc1.device != desc2.device:
        raise ValueError(f"hamming_matrix_popc: descriptors on "
                         f"{desc1.device} and {desc2.device}")
    if desc1.device.type == "cpu":
        return hamming_matrix_xla(desc1, desc2)
    if desc1.device.type != "cuda":
        raise ValueError(f"hamming_matrix_popc: unsupported device "
                         f"{desc1.device}")
    lead = torch.broadcast_shapes(desc1.shape[:-2], desc2.shape[:-2])
    N, M = desc1.shape[-2], desc2.shape[-2]
    a = desc1.expand(lead + (N, DESC_WORDS)).reshape(-1, N, DESC_WORDS)
    b = desc2.expand(lead + (M, DESC_WORDS)).reshape(-1, M, DESC_WORDS)
    a, b = a.contiguous(), b.contiguous()
    # the kernel reads each descriptor as 8-byte word pairs
    a, b = (x if x.data_ptr() % 8 == 0 else x.clone() for x in (a, b))
    B = a.shape[0]
    out = torch.empty((B, N, M), dtype=torch.int32, device=a.device)
    if out.numel() == 0:
        return out.reshape(lead + (N, M))
    lib = build.library()
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        rc = lib.stvo_hamming_popc(a.data_ptr(), b.data_ptr(),
                                   out.data_ptr(), B, N, M, stream)
    build.check(rc, "hamming_matrix_popc")
    hamming_matrix_popc.launches += 1
    return out.reshape(lead + (N, M))


hamming_matrix_popc.launches = 0


def hamming_matrix(desc1, desc2, use_mxu: bool = True) -> torch.Tensor:
    """The bf16 product, or with `use_mxu=False` XOR + popcount (the CUDA
    kernel on CUDA tensors)."""
    if use_mxu:
        return hamming_matrix_mxu(desc1, desc2)
    return hamming_matrix_popc(desc1, desc2)


def unpack_cells_onehot(desc: torch.Tensor, dtype=None) -> torch.Tensor:
    """[..., 8] int32 -> [..., 128*4] one-hot encoding of the 2-bit
    cells."""
    shifts = torch.arange(16, device=desc.device, dtype=torch.int32) * 2
    cells = (desc[..., :, None] >> shifts) & 3
    cells = cells.reshape(desc.shape[:-1] + (N_CELLS,))
    onehot = cells[..., None] == torch.arange(4, device=desc.device,
                                              dtype=torch.int32)
    return onehot.to(dtype or _mm_dtype(desc)).reshape(
        desc.shape[:-1] + (N_CELLS * 4,))


def hamming2_matrix_mxu(desc1: torch.Tensor,
                        desc2: torch.Tensor) -> torch.Tensor:
    a = unpack_cells_onehot(desc1)
    b = unpack_cells_onehot(desc2)
    agree = torch.matmul(a, b.transpose(-1, -2)).to(torch.float32)
    return (N_CELLS - agree).to(torch.int32)


def hamming2_matrix_xla(desc1: torch.Tensor,
                        desc2: torch.Tensor) -> torch.Tensor:
    """XOR + cell-collapse popcount: a cell differs iff either bit does."""
    a, b = _words_u(desc1), _words_u(desc2)
    total = 0
    for w in range(DESC_WORDS):
        x = a[..., :, None, w] ^ b[..., None, :, w]
        total = total + _popcount32((x | (x >> 1)) & 0x55555555)
    return total.to(torch.int32)


def hamming2_matrix(desc1, desc2, use_mxu: bool = True) -> torch.Tensor:
    if use_mxu:
        return hamming2_matrix_mxu(desc1, desc2)
    return hamming2_matrix_xla(desc1, desc2)


def distance_matrix(desc1, desc2, use_mxu: bool = True,
                    wta_k: int = 2) -> torch.Tensor:
    """HAMMING for WTA_K=2 descriptors, HAMMING2 for WTA_K=3/4."""
    if wta_k == 2:
        return hamming_matrix(desc1, desc2, use_mxu)
    return hamming2_matrix(desc1, desc2, use_mxu)
