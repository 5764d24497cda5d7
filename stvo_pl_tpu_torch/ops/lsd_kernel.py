"""Aligned-run scoring for the dense line detector: all directions in one
launch (`run_pack_multi`) and one direction per launch (`run_pack`).

`run_pack_multi` launches the CUDA kernel `csrc/lsd_run_pack.cu` on CUDA
tensors; `run_pack_multi_plain` is its plain PyTorch twin, used for CPU
tensors and as the reference the kernel is checked against.  Both
produce, for [N, H, W] i32 direction bitmasks (bit d = pixel aligned to
`steps[d]`), the row-pooled packed run maps of the JAX package's Pallas
kernel (stvo_pl_tpu/ops/lsd_kernel.py _run_pack_multi_pallas), bit for
bit:

    packed[n, d, y // 8, x] = max over the 8 rows of
        (hops * hq_d) * 64 + (63 - (y % 8) * 8 - x % 8)   at run starts
        0                                                 elsewhere

with hq_d = round(16 * |steps[d]|), so one global top-k ranks runs of all
directions by their length in pixels, and a plain max recovers the best
run of a tile together with its position.  Every shift is zero-filled at
the border of the PADDED domain Hp x Wp (Hp = round_up(H, 64), Wp =
round_up(W, 128)): thickening may set pixels in the pad and runs may
continue into it, which is part of the function.

`run_pack` / `run_pack_plain` are the one-direction form (the JAX
package's _run_pack_pallas), a function of its own: a 0/1 aligned mask in,
every pixel's own word `hops * 64 + (63 - (y % 8) * 8 - x % 8)` out,
without hop weight and without the 8-row maximum, on the padded domain
Hp = round_up(H, 8) (not 64), Wp = round_up(W, 128).  The smaller padded
height changes which runs exist near the bottom edge, so it is not the
D = 1 case of `run_pack_multi`.
"""

from __future__ import annotations

import ctypes
import math

import torch
import torch.nn.functional as F

from stvo_pl_tpu_torch import build

MAX_DIRS = 16      # directions the kernel takes (its direction tables)
MAX_STEP = 4       # |dx|, |dy| the kernel's shared-memory halo covers


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def _hop_q(dx: int, dy: int) -> int:
    """Hop length in 1/16 px, the per-direction weight of the packed word."""
    return int(round(16.0 * math.hypot(dx, dy)))


def packed_shape(H: int, W: int, D: int) -> tuple[int, int, int]:
    """(D, Hp / 8, Wp) of the packed maps of one [H, W] bitmask."""
    return D, _round_up(H, 64) // 8, _round_up(W, 128)


def _shift(x: torch.Tensor, sy: int, sx: int) -> torch.Tensor:
    """r[p] = x[p + (sy, sx)] over the last two dims, zero-filled."""
    Hp, Wp = x.shape[-2:]
    if abs(sy) >= Hp or abs(sx) >= Wp:
        return torch.zeros_like(x)
    core = x[..., max(sy, 0):Hp + min(sy, 0), max(sx, 0):Wp + min(sx, 0)]
    return F.pad(core, (max(-sx, 0), max(sx, 0), max(-sy, 0), max(sy, 0)))


def _run_words(a: torch.Tensor, dx: int, dy: int, hq: int,
               max_doublings: int) -> torch.Tensor:
    """The reference's program for one direction on an already padded 0/1
    i32 domain [N, Hp, Wp]: thicken, dilate, gap-close, pointer doubling,
    run starts, packing.  Returns every pixel's word
    (hops * hq) * 64 + (63 - (y % 8) * 8 - x % 8) at run starts, 0
    elsewhere."""
    Hp, Wp = a.shape[-2:]
    yy = torch.arange(Hp, device=a.device, dtype=torch.int32)[:, None]
    xx = torch.arange(Wp, device=a.device, dtype=torch.int32)[None, :]
    tail = 63 - ((yy % 8) * 8 + xx % 8)
    if abs(dx) >= abs(dy):
        thick = a | _shift(a, 1, 0) | _shift(a, -1, 0)
    else:
        thick = a | _shift(a, 0, 1) | _shift(a, 0, -1)
    dil = thick | _shift(thick, dy, dx) | _shift(thick, -dy, -dx)
    run = (dil & _shift(dil, dy, dx) & _shift(dil, -dy, -dx)) | thick
    f = run
    for k in range(max_doublings):
        h = 1 << k
        f = torch.where(f == h, f + _shift(f, dy * h, dx * h), f)
    is_start = run & (1 - _shift(run, -dy, -dx))
    return torch.where(is_start == 1, (f * hq) * 64 + tail, 0)


def run_pack_multi_plain(bits: torch.Tensor, steps,
                         max_doublings: int = 8) -> torch.Tensor:
    """Plain PyTorch version of the all-direction kernel: the reference's
    program on the zero-padded domain, one direction at a time, then the
    8-row maximum."""
    N, H, W = bits.shape
    D, Ht, Wp = packed_shape(H, W, len(steps))
    bits_p = F.pad(bits, (0, Wp - W, 0, Ht * 8 - H))
    out = []
    for di, (dx, dy) in enumerate(steps):
        packed = _run_words((bits_p >> di) & 1, dx, dy, _hop_q(dx, dy),
                            max_doublings)
        out.append(packed.reshape(N, Ht, 8, Wp).amax(dim=2))
    return torch.stack(out, dim=1).to(torch.int32)


def _check_steps(what: str, steps, max_doublings: int) -> None:
    if any(max(abs(dx), abs(dy)) > MAX_STEP or (dx, dy) == (0, 0)
           for dx, dy in steps):
        raise ValueError(f"{what}: steps must be non-zero with "
                         f"|dx|, |dy| <= {MAX_STEP}, got {steps}")
    if not 0 <= max_doublings <= 8:
        raise ValueError(f"{what}: max_doublings must be in 0..8")


def run_pack_multi(bits: torch.Tensor, steps,
                   max_doublings: int = 8) -> torch.Tensor:
    """[N, H, W] i32 direction bitmasks -> [N, D, Hp/8, Wp] i32 packed run
    maps for the D integer directions `steps` ((dx, dy) pairs).  CPU
    tensors take the plain version; CUDA tensors launch the kernel
    (counted in `run_pack_multi.launches`)."""
    steps = tuple((int(dx), int(dy)) for dx, dy in steps)
    if bits.ndim != 3 or bits.dtype != torch.int32:
        raise ValueError(f"run_pack_multi wants [N, H, W] int32, got "
                         f"{tuple(bits.shape)} {bits.dtype}")
    if not 1 <= len(steps) <= MAX_DIRS:
        raise ValueError(f"run_pack_multi takes 1..{MAX_DIRS} directions, "
                         f"got {len(steps)}")
    _check_steps("run_pack_multi", steps, max_doublings)
    if bits.device.type == "cpu":
        return run_pack_multi_plain(bits, steps, max_doublings)
    if bits.device.type != "cuda":
        raise ValueError(f"run_pack_multi: unsupported device {bits.device}")
    if not bits.is_contiguous():
        raise ValueError("run_pack_multi wants a contiguous bitmask tensor")
    N, H, W = bits.shape
    D, Ht, Wp = packed_shape(H, W, len(steps))
    Hp = Ht * 8
    out = torch.empty((N, D, Ht, Wp), dtype=torch.int32, device=bits.device)
    if N == 0:
        return out
    # the run planes of all directions (one bit per pixel and direction),
    # between the kernel's two passes
    scratch = torch.empty((N, D, Hp, Wp // 32), dtype=torch.int32,
                          device=bits.device)
    table = (ctypes.c_int * (3 * D))(
        *[s[0] for s in steps], *[s[1] for s in steps],
        *[_hop_q(*s) for s in steps])
    lib = build.library()
    with torch.cuda.device(bits.device):
        stream = torch.cuda.current_stream(bits.device).cuda_stream
        rc = lib.stvo_lsd_run_pack_multi(
            bits.data_ptr(), scratch.data_ptr(), out.data_ptr(), N, H, W, Hp,
            Wp, D, table, 1 << max_doublings, stream)
    build.check(rc, "run_pack_multi")
    run_pack_multi.launches += 1
    return out


run_pack_multi.launches = 0


def run_pack_shape(H: int, W: int) -> tuple[int, int]:
    """(Hp, Wp) of the one-direction packed map of one [H, W] mask."""
    return _round_up(H, 8), _round_up(W, 128)


_MASK_DTYPES = (torch.bool, torch.int8, torch.int32)


def run_pack_plain(aligned: torch.Tensor, dx: int, dy: int,
                   max_doublings: int = 8) -> torch.Tensor:
    """Plain PyTorch version of the one-direction kernel: the reference's
    program on the zero-padded Hp x Wp domain, every pixel's word kept."""
    N, H, W = aligned.shape
    Hp, Wp = run_pack_shape(H, W)
    a = F.pad((aligned != 0).to(torch.int32), (0, Wp - W, 0, Hp - H))
    return _run_words(a, dx, dy, 1, max_doublings).to(torch.int32)


def run_pack(aligned: torch.Tensor, dx: int, dy: int,
             max_doublings: int = 8) -> torch.Tensor:
    """[N, H, W] 0/1 aligned masks (bool, int8 or int32) ->
    [N, Hp, Wp] i32 packed run maps of the ONE integer direction (dx, dy):
    hops * 64 + (63 - (y % 8) * 8 - x % 8) at run starts, 0 elsewhere.  One
    launch covers all N images.  CPU tensors take the plain version; CUDA
    tensors launch the kernel (counted in `run_pack.launches`)."""
    dx, dy = int(dx), int(dy)
    if aligned.ndim != 3 or aligned.dtype not in _MASK_DTYPES:
        raise ValueError(f"run_pack wants an [N, H, W] bool / int8 / int32 "
                         f"mask, got {tuple(aligned.shape)} {aligned.dtype}")
    _check_steps("run_pack", ((dx, dy),), max_doublings)
    if aligned.device.type == "cpu":
        return run_pack_plain(aligned, dx, dy, max_doublings)
    if aligned.device.type != "cuda":
        raise ValueError(f"run_pack: unsupported device {aligned.device}")
    # one byte of 0 or 1 per pixel for the kernel: bool masks pass as they
    # are
    if aligned.dtype != torch.bool:
        aligned = aligned != 0
    mask = aligned.contiguous().view(torch.uint8)
    if mask.data_ptr() % 16:
        # the kernel reads the mask as aligned 16-byte vectors
        mask = mask.clone()
    N, H, W = mask.shape
    Hp, Wp = run_pack_shape(H, W)
    out = torch.empty((N, Hp, Wp), dtype=torch.int32, device=mask.device)
    if N == 0:
        return out
    # the run plane (one bit per pixel) between the kernel's passes
    scratch = torch.empty((N, Hp, Wp // 32), dtype=torch.int32,
                          device=mask.device)
    lib = build.library()
    with torch.cuda.device(mask.device):
        stream = torch.cuda.current_stream(mask.device).cuda_stream
        rc = lib.stvo_lsd_run_pack(
            mask.data_ptr(), scratch.data_ptr(), out.data_ptr(), N, H, W, Hp,
            Wp, dx, dy, 1 << max_doublings, stream)
    build.check(rc, "run_pack")
    run_pack.launches += 1
    return out


run_pack.launches = 0
