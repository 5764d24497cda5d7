"""The least time a kernel could take on one NVIDIA H100, from its bytes
and operations.

Frozen copies of `chip_smoke.py:100-130` (the peaks and the per-pixel and
per-pair operation counts) and `chip_smoke.py:210-213` (`bound_ms`).
Bytes count each input read once and each output written once; 32-bit
integer operations are counted at the float32 rate, which the card does
not reach for them, so an integer kernel's bound is a lower one.
"""

from __future__ import annotations

# H100 SXM peaks (NVIDIA data sheet): HBM3 bandwidth and the float32 rate
# outside the tensor cores
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_OPS_PER_S = 67e12
# FAST response operations per pixel in the reference's shared-subtree
# form: 16 circle differences, 2 x 23 three-window min/max, 2 x 16 x 2
# arc min/max, 2 x 15 arc accumulations, 2 for the final max.
FAST_OPS_PER_PIXEL = 16 + 2 * 23 * 2 + 2 * 16 * 2 + 2 * 15 + 2
# Run-pack integer operations per pixel of the padded canvas and
# direction, in the cheapest sequential form of the function: bit extract
# 2, thicken 2, dilate 2, gap-close 3, run length as a reverse scan along
# the direction 3 (add, select, saturate), run start 2, packed word 4
# (hop weight, shift, position, select), 8-row maximum 1.
RUN_PACK_OPS_PER_PIXEL_DIR = 2 + 2 + 2 + 3 + 3 + 2 + 4 + 1
# the one-direction kernel: the same without the hop weight and without the
# 8-row maximum
RUN_PACK_ONE_OPS_PER_PIXEL = RUN_PACK_OPS_PER_PIXEL_DIR - 2
# XOR + popcount Hamming: 8 XOR, 8 popcounts and 8 adds per pair
HAMMING_OPS_PER_PAIR = 24


def bound_ms(n_bytes: float, n_ops: float) -> tuple[float, str]:
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    t_ops = n_ops / PEAK_F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m
