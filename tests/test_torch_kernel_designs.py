"""Plain models of the decompositions that the CUDA kernels B1
(csrc/fast_pack.cu), B2 (csrc/patches.cu), B3 and B4 (csrc/lsd_run_pack.cu
`stvo_lsd_run_pack_multi` and `stvo_lsd_run_pack`) use, held on the CPU
to the plain versions and to interpret-mode Pallas.

The kernels themselves run only on a card (tests/test_torch_kernels_cuda.py,
chip_smoke.py).  These models repeat their arithmetic step for step in
numpy, so a wrong decomposition shows here first:

- B1: the response on order-preserving integer keys of the raw pixel
  values with three-input min/max windows (no circle differences), and the
  exact 9-contiguous-sign classification of a positive response.
- B2: the flat output cut into 16-byte groups per thread and block (groups
  that cross patches and images, the partial last group, a ragged last
  block), with the index divisions by host-computed magic numbers.
- B3: run planes (one 32-bit word per direction, row and 32 columns,
  thickened and gap-closed with funnel shifts across words), then the run
  lengths by 32-step blocks of 32 chains: a tile of run bits transposed
  across the warp, trailing-ones counts inside the tile, and the carry
  from the tile before (the tile-local scan and its boundary carries),
  then the 8-row maximum of the start words.
- B4: each bitmask word cut out of the aligned 16-byte vectors of mask
  bytes that hold it (one multiply per 4 bytes), the run plane on the
  round_up(H, 8) domain; then a lane per plane word: starts against the
  window one step back, lengths by trailing ones along rows or by ANDed
  hop windows, and the warp's 32-hop rounds for long runs.
- B5: the lanes' fragments of the 1-bit MMA (m16n8k256 .and.popc) read
  straight from the descriptor words, popc(a) and popc(b) summed over a
  quad and shuffled to the lanes that hold each column, the epilogue
  popc(a) + popc(b) - 2 popc(a & b), the warp's tile staged and stored
  as 16-byte row pieces, the ragged edge masked.
"""

import functools

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from stvo_pl_tpu_torch.ops import camera as tcam
from stvo_pl_tpu_torch.ops import fast as tfast
from stvo_pl_tpu_torch.ops import fast_kernel as tfk
from stvo_pl_tpu_torch.ops import hamming as tham
from stvo_pl_tpu_torch.ops import lsd as tlsd
from stvo_pl_tpu_torch.ops import lsd_kernel as tlk
from stvo_pl_tpu_torch.utils import synthetic as tsyn

torch.set_num_threads(1)

EDGE = 19
HT = 8            # B3's thick halo: p +- 2 * step with |dx|, |dy| <= 4


@pytest.fixture
def pallas_interpret(monkeypatch):
    from jax.experimental import pallas as pl
    monkeypatch.setattr(pl, "pallas_call",
                        functools.partial(pl.pallas_call, interpret=True))


# ---- B1: FAST ----------------------------------------------------------


def _rendered():
    """One rendered 240x180 frame (the port's renderer, on the CPU)."""
    cam = tcam.StereoCamera(fx=160.0, fy=160.0, cx=120.0, cy=90.0, b=0.3,
                            width=240, height=180)
    scene = tsyn.make_scene(torch.Generator().manual_seed(5), n_points=260,
                            n_lines=24, extent=(14.0, 8.0, 40.0), z_near=3.0)
    left, _ = tsyn.render_sequence(scene, tsyn.smooth_trajectory(1), cam)
    return left.numpy()


def _fast_image(kind, rng):
    if kind == "random":
        return (rng.random((2, 70, 150)) * 255).astype(np.float32)
    if kind == "signed":        # negative values and signed zeros too
        img = ((rng.random((1, 64, 140)) - 0.5) * 8).round().astype(
            np.float32)
        img[img == 0] = np.where(rng.random((img == 0).sum()) < 0.5,
                                 np.float32(-0.0), np.float32(0.0))
        return img
    if kind == "constant":
        return np.full((1, 64, 130), 77.0, np.float32)
    if kind == "dots":          # bright dots 4 px apart on a dark field
        img = np.full((1, 80, 150), 10.0, np.float32)
        img[:, 2::4, 3::4] = 200.0
        return img
    if kind == "pattern":       # a 4x4 tiling where 69% of pixels pass
        v = np.array([[11, 9, 6, 15], [4, 7, 5, 1], [10, 8, 0, 3],
                      [13, 2, 12, 14]], np.float32) * 10
        return np.tile(v, (1, 18, 40))[:, :70, :150].copy()
    if kind == "rendered":
        return _rendered()
    raise ValueError(kind)


def _plain_diffs(img: torch.Tensor):
    """The 16 circle differences exactly as fast_pack_plain forms them, over
    its response rows y = -1 .. Hs."""
    N, H, W = img.shape
    Hs, Wp = tfk.packed_shape(H, W)
    img_p = torch.nn.functional.pad(img, (0, Wp - W, tfk.HALO,
                                          Hs + tfk.HALO - H))
    R = Hs + 2
    center = img_p[:, tfk.HALO - 1:tfk.HALO - 1 + R, :]
    diffs = []
    for dy, dx in tfast.CIRCLE.tolist():
        sh = img_p[:, tfk.HALO - 1 + dy:tfk.HALO - 1 + dy + R, :]
        if dx:
            sh = torch.roll(sh, -dx, dims=-1)
        diffs.append(sh - center)
    return diffs, img_p, R


def _nine_contiguous(bits: list[torch.Tensor]) -> torch.Tensor:
    """True where 9 circularly contiguous of the 16 masks are set: the
    16-bit mask doubled to 32 bits, then runs of 2, 4, 8, 9 by shift-and."""
    m = torch.zeros_like(bits[0], dtype=torch.int64)
    for k, b in enumerate(bits):
        m |= b.to(torch.int64) << k
    m |= m << 16
    x = m & (m >> 1)
    x &= x >> 2
    x &= x >> 4
    x &= m >> 8
    return (x & 0xFFFF) != 0


def _keys(v: np.ndarray) -> np.ndarray:
    b = v.view(np.int32)
    return b ^ ((b >> 31) & np.int32(0x7FFFFFFF))


def _key_response(img_p: torch.Tensor, R: int) -> np.ndarray:
    """The kernel's response: three-input min/max windows on integer keys
    of the raw neighbours, max(fl(B - c), fl(c - D))."""
    p = img_p.numpy()
    center = p[:, tfk.HALO - 1:tfk.HALO - 1 + R, :]
    k = []
    for dy, dx in tfast.CIRCLE.tolist():
        sh = p[:, tfk.HALO - 1 + dy:tfk.HALO - 1 + dy + R, :]
        k.append(_keys(np.ascontiguousarray(np.roll(sh, -dx, axis=-1))))

    def side(inner, outer):
        m3 = [inner(inner(k[i], k[(i + 1) % 16]), k[(i + 2) % 16])
              for i in range(16)]
        w = [inner(inner(m3[s], m3[(s + 3) % 16]), m3[(s + 6) % 16])
             for s in range(16)]
        return functools.reduce(outer, w)

    B = _keys(side(np.minimum, np.maximum)).view(np.float32)
    D = _keys(side(np.maximum, np.minimum)).view(np.float32)
    return np.maximum(B - center, center - D)


@pytest.mark.parametrize("kind", ["random", "signed", "constant", "dots",
                                  "pattern", "rendered"])
def test_fast_design_equals_plain_response(rng, kind):
    img = torch.from_numpy(_fast_image(kind, rng))
    diffs, img_p, R = _plain_diffs(img)
    resp = tfast.fast_response(diffs)
    rp = torch.where(resp > 0, resp, torch.zeros(()))
    # the classification: bright passes / dark passes / neither, exactly
    bright = _nine_contiguous([d > 0 for d in diffs])
    dark = _nine_contiguous([d < 0 for d in diffs])
    assert not bool((bright & dark).any())
    assert torch.equal(bright | dark, resp > 0)
    # the integer-key response: the same float bits where it is positive
    kr = torch.from_numpy(_key_response(img_p, R))
    assert torch.equal(torch.where(kr > 0, kr, torch.zeros(())), rp)
    H, W = img.shape[1:]
    inner = resp[:, 1 + 3:1 + H - 3, 3:W - 3]     # away from the zero pad
    share = float((inner > 0).float().mean())
    if kind == "constant":
        assert share == 0.0
    if kind == "dots":
        on = resp[:, 1 + 2:1 + 70:4, 3:147:4]
        assert bool((on > 0).all())
    if kind == "pattern":
        assert share > 0.6


@pytest.mark.parametrize("kind", ["constant", "dots", "pattern"])
def test_fast_pack_plain_design_cases_equal_pallas(pallas_interpret, rng,
                                                   kind):
    from stvo_pl_tpu.ops import fast_kernel as jfk
    img = _fast_image(kind, rng)
    ref = np.asarray(jfk._fast_pack_pallas(jnp.asarray(img), EDGE))
    out = tfk.fast_pack(torch.from_numpy(img), EDGE).numpy()
    np.testing.assert_array_equal(out, ref)
    if kind == "constant":
        assert not ref.any()
    else:
        assert (ref > 0).sum() > 50


# ---- B3: all-direction run pack ------------------------------------------


def _words(a: np.ndarray) -> np.ndarray:
    """[..., Wp] 0/1 -> [..., Wp / 32] uint32, bit j of word w = column
    32 w + j."""
    b = np.packbits(a.astype(np.uint8), axis=-1, bitorder="little")
    return np.ascontiguousarray(b).view("<u4").astype(np.uint32)


def _funnel_r(lo, hi, s):
    v = (hi.astype(np.uint64) << np.uint64(32)) | lo.astype(np.uint64)
    return (v >> np.uint64(s)).astype(np.uint32)


def _shifted(P: np.ndarray, dy: int, shift: int) -> np.ndarray:
    """bits j of word w <- plane row y + dy, column 32 w + j + shift, with
    zero words and rows outside the domain (the kernel's zero thick
    planes there)."""
    N, Hp, WW = P.shape
    Z = np.zeros((N, Hp + 2 * HT, WW + 2), np.uint32)
    Z[:, HT:HT + Hp, 1:1 + WW] = P
    rows = Z[:, HT + dy:HT + dy + Hp]
    prev, cur, nxt = rows[..., :WW], rows[..., 1:1 + WW], rows[..., 2:]
    if shift > 0:
        return _funnel_r(cur, nxt, shift)
    if shift < 0:
        return _funnel_r(prev, cur, 32 + shift)
    return cur.copy()


def _dom(Hp: int, WW: int, dy: int, shift: int) -> np.ndarray:
    """[Hp, WW] masks of the bits whose pixel + (dy, shift) lies in the
    padded domain (the kernel's row test and col_mask)."""
    Wp = 32 * WW
    cols = np.full(WW, 0xFFFFFFFF, np.uint64)
    for w in range(WW):
        if 32 * w + shift < 0:
            cols[w] = (0xFFFFFFFF << -shift) & 0xFFFFFFFF
        elif 32 * w + 31 + shift >= Wp:
            cols[w] = 0xFFFFFFFF >> shift
    rows = (np.arange(Hp) + dy >= 0) & (np.arange(Hp) + dy < Hp)
    return np.where(rows[:, None], cols[None, :], 0).astype(np.uint32)


def run_planes_model(bits: np.ndarray, steps) -> np.ndarray:
    """Pass 1: [N, H, W] bitmasks -> [N, D, Hp, Wp / 32] run planes."""
    N, H, W = bits.shape
    D, Ht, Wp = tlk.packed_shape(H, W, len(steps))
    Hp, WW = Ht * 8, Wp // 32
    bp = np.pad(bits, ((0, 0), (0, Hp - H), (0, Wp - W)))
    planes = np.zeros((N, D, Hp, WW), np.uint32)
    for d, (dx, dy) in enumerate(steps):
        A = _words((bp >> d) & 1)
        if abs(dx) >= abs(dy):
            T = A | _shifted(A, -1, 0) | _shifted(A, 1, 0)
        else:
            z = np.zeros((N, Hp, 1), np.uint32)
            left = np.concatenate([z, A[..., :-1]], axis=-1)
            right = np.concatenate([A[..., 1:], z], axis=-1)
            T = A | ((A << 1) | (left >> 31)) | ((A >> 1) | (right << 31))
        tm1, tm2 = _shifted(T, -dy, -dx), _shifted(T, -2 * dy, -2 * dx)
        tp1, tp2 = _shifted(T, dy, dx), _shifted(T, 2 * dy, 2 * dx)
        dil0 = T | tm1 | tp1
        dilm = (tm2 | tm1 | T) & _dom(Hp, WW, -dy, -dx)
        dilp = (T | tp1 | tp2) & _dom(Hp, WW, dy, dx)
        planes[:, d] = (dil0 & dilm & dilp) | T
    return planes


def _transpose32(R: np.ndarray) -> np.ndarray:
    """The kernel's 5-stage shuffle transpose over the last axis (32
    lanes): lane L's bit j in, lane j's bit L out."""
    x = R.astype(np.uint32).copy()
    lane = np.arange(32)
    for j, m in ((16, 0x0000FFFF), (8, 0x00FF00FF), (4, 0x0F0F0F0F),
                 (2, 0x33333333), (1, 0x55555555)):
        m = np.uint32(m)
        y = x[..., lane ^ j]
        hi = (lane & j) != 0
        x = np.where(hi, (x & ~m) | ((y >> np.uint32(j)) & m),
                     (x & m) | ((y & m) << np.uint32(j)))
    return x


def _ffs0(x: np.ndarray) -> np.ndarray:
    """Index of the lowest set bit of uint32 x (32 where x == 0)."""
    x = x.astype(np.uint64)
    low = x & (~x + np.uint64(1))
    return np.where(x == 0, 32, np.log2(np.maximum(low, 1)).astype(np.int64))


def _scan_block(W, brk, run0, f0, qb, cap, emit):
    """The kernel's scan_block over arrays of lanes; emit(mask, q, f)."""
    u32 = np.uint32
    cont = ((W >> u32(1)) | (run0.astype(np.uint32) << u32(31))) & ~brk
    emit((run0 == 1) & (((W & ~brk) >> u32(31)) == 0),
         np.full(W.shape, qb + 32), f0)
    starts = W & ~((W << u32(1)) & ~(brk << u32(1))) & ~u32(1)
    for i in range(1, 32):
        on = ((starts >> u32(i)) & u32(1)) == 1
        if on.any():
            n = _ffs0(~(cont >> u32(i)))
            f = np.where(n >= 32 - i, np.minimum(32 - i + f0, cap),
                         np.minimum(n + 1, cap))
            emit(on, np.full(W.shape, qb + i), f)
    n = _ffs0(~cont)
    run_next = (W & u32(1)).astype(np.int64)
    f_next = np.where(run_next == 1,
                      np.where(n >= 32, np.minimum(32 + f0, cap),
                               np.minimum(n + 1, cap)), 0)
    return run_next, f_next


def chain_pack_model(planes: np.ndarray, steps, cap: int) -> np.ndarray:
    """Pass 2: 32-step blocks of 32 chains, loaded as row words and
    transposed (rows) or taken as the row's own words (|dx| = 1 along
    rows), scanned with the block carry, start words to the 8-row
    maximum.  (Row steps |dx| >= 2 with dy = 0, which no direction of
    DIR_STEPS has, take the kernel's scalar walk and are not modelled.)"""
    N, D, Hp, WW = planes.shape
    Wp = WW * 32
    out = np.zeros((N, D, Hp // 8, Wp), np.int64)
    for d, (dx, dy) in enumerate(steps):
        hq = tlk._hop_q(dx, dy)
        P = planes[:, d]                                 # [N, Hp, WW]
        if dy != 0:
            U, V, su, sv = Hp, Wp, dy, dx
        else:
            assert abs(dx) == 1
            U, V, su, sv = Wp, Hp, dx, 0
        DM, flip = abs(su), su < 0
        t = np.broadcast_to(np.arange(V), (N, V))
        n_of = np.broadcast_to(np.arange(N)[:, None], (N, V))

        def emit_at(rho):
            def emit(mask, qs, f):
                if not mask.any():
                    return
                us = qs * DM + rho
                uu = np.where(flip, U - 1 - us, us)
                vv = (t + sv * qs) % V
                y, x = (uu, vv) if dy != 0 else (vv, uu)
                word = (f * hq) * 64 + (63 - (y & 7) * 8 - (x & 7))
                np.maximum.at(out[:, d], (n_of[mask], (y >> 3)[mask],
                                          x[mask]), word[mask])
            return emit

        for rho in range(DM):
            run0 = np.zeros((N, V), np.int64)
            f0 = np.zeros((N, V), np.int64)
            qb = (U - 1) // DM - 31 if dy != 0 else U - 32
            while qb >= -32:
                if dy != 0:
                    # loader lane L of each warp: step qb + L, 32 columns
                    # from the warp's first chain
                    lane = np.arange(V) % 32
                    t0 = np.arange(V) - lane
                    q = qb + lane
                    up = q * DM + rho
                    ok = (up >= 0) & (up < U)
                    y = np.clip(np.where(flip, U - 1 - up, up), 0, U - 1)
                    col = (t0 + sv * q) % V
                    w = col >> 5
                    lo = P[:, y, w]
                    hi = P[:, y, np.where(w + 1 == WW, 0, w + 1)]
                    R = np.stack([_funnel_r(lo[:, k], hi[:, k], col[k] & 31)
                                  for k in range(V)], axis=1)
                    R = np.where(ok, R, 0).astype(np.uint32)
                    W = _transpose32(R.reshape(N, V // 32, 32)).reshape(N, V)
                    c0 = (t + sv * qb) % V
                    brk = np.zeros((N, V), np.uint32)
                    if sv != 0:
                        i1 = (V - c0 - 1) // sv if sv > 0 else c0 // (-sv)
                        brk = np.where(i1 < 32, np.uint32(1) << np.uint32(
                            np.minimum(i1, 31)), 0).astype(np.uint32)
                else:
                    W = np.zeros((N, V), np.uint32)
                    if qb >= 0:
                        if flip:
                            words = P[:, :, (U - 32 - qb) // 32]
                            bits = (words[..., None] >> np.arange(
                                32, dtype=np.uint32)) & np.uint32(1)
                            W = (bits[..., ::-1] << np.arange(
                                32, dtype=np.uint32)).sum(-1).astype(
                                    np.uint32)
                        else:
                            W = P[:, :, qb // 32].astype(np.uint32)
                    brk = np.zeros((N, V), np.uint32)
                run0, f0 = _scan_block(W, brk, run0, f0, qb, cap,
                                       emit_at(rho))
                qb -= 32
    return out.astype(np.int32)


def _long_run_bits(rng, shape, steps, length, density):
    """Sparse noise plus, per direction, straight chains of `length` hops
    of that direction's bit from random starts; the last row and column
    keep set bits, from which runs continue into the padded domain."""
    N, H, W = shape
    bits = np.zeros(shape, np.int32)
    for d, (dx, dy) in enumerate(steps):
        bits |= (rng.random(shape) < density).astype(np.int32) << d
        for n in range(N):
            for _ in range(3):
                y, x = int(rng.integers(0, H)), int(rng.integers(0, W))
                for _k in range(length):
                    if not (0 <= y < H and 0 <= x < W):
                        break
                    bits[n, y, x] |= 1 << d
                    y, x = y + dy, x + dx
    bits[:, -1, ::5] |= (1 << len(steps)) - 1
    bits[:, ::3, -1] |= (1 << len(steps)) - 1
    return bits


B3_CASES = [
    # shape, directions, max_doublings, chain length, noise density
    ((2, 70, 150), 8, 8, 90, 0.03),      # runs longer than the 64-row tile
    ((1, 64, 128), 16, 3, 40, 0.05),     # cap 8, no padding
    ((2, 97, 130), 12, 0, 30, 0.1),      # cap 1
    ((1, 120, 300), 16, 8, 200, 0.01),   # all 16 directions, long chains
    ((1, 120, 300), 16, 3, 200, 0.2),
    ((2, 33, 200), 8, 8, 60, 0.3),       # H far below the padded height
]


# steps with dy < 0 and dx = -1 along rows (the walks run the other way);
# DIR_STEPS has neither
OTHER_STEPS = [(-1, 0), (1, -1), (-2, -1), (0, -1), (3, -4), (-4, -3),
               (1, 0), (2, 1)]


@pytest.mark.parametrize("shape,n_dirs,md,length,density",
                         B3_CASES + [((2, 70, 150), 0, 8, 90, 0.05),
                                     ((1, 97, 130), 0, 3, 60, 0.2)])
def test_run_pack_design_equals_plain(rng, shape, n_dirs, md, length,
                                      density):
    steps = tlsd.direction_steps(n_dirs) if n_dirs else OTHER_STEPS
    bits = _long_run_bits(rng, shape, steps, length, density)
    model = chain_pack_model(run_planes_model(bits, steps), steps, 1 << md)
    plain = tlk.run_pack_multi_plain(torch.from_numpy(bits), steps,
                                     md).numpy()
    np.testing.assert_array_equal(model, plain)
    assert (plain > 0).sum() > 20, "the masks must hold runs"
    if md > 0:
        # some run reached the cap
        hops = (plain >> 6) // np.array([tlk._hop_q(*s) for s in steps])[
            None, :, None, None]
        assert (hops == 1 << md).any() or length < 1 << md


@pytest.mark.parametrize("case", [0, 1])
def test_run_pack_design_equals_pallas(pallas_interpret, rng, case):
    from stvo_pl_tpu.ops import lsd_kernel as jlk
    shape, n_dirs, md, length, density = B3_CASES[case]
    steps = tlsd.direction_steps(n_dirs)
    bits = _long_run_bits(rng, shape, steps, length, density)
    model = chain_pack_model(run_planes_model(bits, steps), steps, 1 << md)
    ref = np.asarray(jlk._run_pack_multi_pallas(jnp.asarray(bits),
                                                tuple(steps), md))
    np.testing.assert_array_equal(model, ref)


# ---- B2: patch gather ----------------------------------------------------

B2_THREADS, B2_UNROLL = 256, 4     # csrc/patches.cu: threads, groups/thread


def _div_magic(d: int) -> tuple[int, int]:
    """The kernel's make_div: x // d = (x * m) >> (31 + l) for x < 2^31."""
    l = (d - 1).bit_length()
    return -(-(1 << (31 + l)) // d), l


def _div(x: np.ndarray, d: int) -> np.ndarray:
    m, l = _div_magic(d)
    return ((x.astype(np.uint64) * np.uint64(m))
            >> np.uint64(31 + l)).astype(np.int64)


def extract_model(img, y0, x0, patch):
    """csrc/patches.cu: thread t of block b takes the 16-byte groups g =
    (b * UNROLL + u) * THREADS + t of the flat [N * K * PY * PX] output;
    word e = 4 g + c is element (j, r, col) of patch j = n * K + k, image
    j // K (divisions by magic numbers, or by constants for 33 x 33); full
    groups are one 16-byte store, the partial last group is written word
    by word.  Returns the output and the number of groups that cross an
    image boundary."""
    N, H, W = img.shape
    K = y0.shape[1]
    PY, PX = (patch, patch) if isinstance(patch, int) else patch
    per, total = PY * PX, N * K * PY * PX
    bits = img.view(np.uint32).reshape(-1)
    group_words = B2_UNROLL * B2_THREADS * 4
    blocks = -(-total // group_words)
    b, u, t = np.meshgrid(np.arange(blocks), np.arange(B2_UNROLL),
                          np.arange(B2_THREADS), indexing="ij")
    g = ((b * B2_UNROLL + u) * B2_THREADS + t).reshape(-1)
    e = g[:, None] * 4 + np.arange(4)                      # [groups, 4]
    valid = e < total
    if (PY, PX) == (33, 33):
        j = e // per
        r = (e - j * per) // PX
    else:
        j = _div(e, per)
        r = _div(e - j * per, PX)
    col = e - j * per - r * PX
    n = _div(j, K)
    jc = np.minimum(j, N * K - 1)
    y = y0.reshape(-1)[jc] + r
    x = x0.reshape(-1)[jc] + col
    inb = valid & (y >= 0) & (y < H) & (x >= 0) & (x < W)
    src = (np.minimum(n, N - 1) * H + np.clip(y, 0, H - 1)) * W + np.clip(
        x, 0, W - 1)
    v = np.where(inb, bits[src], np.uint32(0))
    out = np.full(total, 0xDEADBEEF, np.uint32)
    count = np.zeros(total, np.int64)
    full = e[:, 3] < total
    out[e[full].reshape(-1)] = v[full].reshape(-1)         # 16-byte stores
    np.add.at(count, e[full].reshape(-1), 1)
    tail = valid & ~full[:, None]
    out[e[tail]] = v[tail]                                 # word by word
    np.add.at(count, e[tail], 1)
    assert (count == 1).all(), "every output word is written once"
    crossing = int((full & (n[:, 0] != n[:, 3])).sum())
    return out.view(img.dtype).reshape(N, K, PY, PX), crossing


def test_div_magic_exact(rng):
    ds = list(range(1, 3000)) + [1089, 33, 2 ** 30, 2 ** 31 - 1] + list(
        rng.integers(1, 2 ** 31 - 1, 300))
    for d in ds:
        m, _ = _div_magic(int(d))
        assert m < 2 ** 32
        x = np.concatenate([[0, 1, d - 1, d, d + 1, 2 ** 31 - 1],
                            rng.integers(0, 2 ** 31, 50)]).astype(np.int64)
        np.testing.assert_array_equal(_div(x, int(d)), x // int(d))


B2_CASES = [
    # N, H, W, K, patch, dtype, corners inside the image
    (3, 90, 140, 37, 33, np.float32, True),      # groups cross images
    (2, 70, 100, 1, 33, np.float32, True),       # K = 1
    (5, 40, 60, 13, (5, 7), np.float32, True),   # N K PY PX % 4 != 0
    (2, 40, 200, 45, (1, 64), np.uint32, True),  # the row mode
    (3, 90, 140, 29, 33, np.float32, False),     # corners outside
    (2, 40, 61, 23, (5, 7), np.int32, False),
]


def _b2_inputs(rng, N, H, W, K, patch, dtype, inside):
    PY, PX = (patch, patch) if isinstance(patch, int) else patch
    if dtype == np.float32:
        img = ((rng.random((N, H, W)) - 0.3) * 255).astype(np.float32)
    else:
        img = rng.integers(0, 2 ** 32, (N, H, W), dtype=np.uint64).astype(
            np.uint32).view(dtype)
    if inside:
        y0 = rng.integers(0, H - PY + 1, (N, K))
        x0 = rng.integers(0, W - PX + 1, (N, K))
        y0[:, 0], x0[:, 0] = H - PY, W - PX          # the last corner
    else:
        y0 = rng.integers(-PY - 2, H + 2, (N, K))
        x0 = rng.integers(-PX - 2, W + 2, (N, K))
    return img, y0.astype(np.int32), x0.astype(np.int32)


@pytest.mark.parametrize("case", range(len(B2_CASES)))
def test_extract_design_equals_plain(rng, case):
    N, H, W, K, patch, dtype, inside = B2_CASES[case]
    img, y0, x0 = _b2_inputs(rng, N, H, W, K, patch, dtype, inside)
    model, crossing = extract_model(img, y0, x0, patch)
    from stvo_pl_tpu_torch.ops import patches as tpat
    src = torch.from_numpy(img.view(np.int32) if dtype == np.uint32
                           else img)
    plain = tpat.extract_patches_plain(src, torch.from_numpy(y0),
                                       torch.from_numpy(x0), patch).numpy()
    np.testing.assert_array_equal(model.view(np.uint32),
                                  plain.view(np.uint32))
    per = model.shape[2] * model.shape[3]
    if any((n * K * per) % 4 for n in range(1, N)):
        assert crossing > 0, "a 16-byte group crosses an image boundary"


@pytest.mark.parametrize("case", [0, 2, 3])
def test_extract_design_equals_pallas(pallas_interpret, rng, case):
    from stvo_pl_tpu.ops import patches as jpat
    N, H, W, K, patch, dtype, inside = B2_CASES[case]
    img, y0, x0 = _b2_inputs(rng, N, H, W, K, patch, dtype, inside)
    model, _ = extract_model(img, y0, x0, patch)
    ref = np.asarray(jpat._pallas_extract(jnp.asarray(img), jnp.asarray(y0),
                                          jnp.asarray(x0), patch, 8))
    np.testing.assert_array_equal(model.view(np.uint32),
                                  ref.view(np.uint32))


# ---- B4: one-direction run pack -------------------------------------------

B4_RT = 16                 # csrc/lsd_run_pack.cu: rows of a pass-1 tile


def _u32(x):
    return (np.asarray(x, np.uint64) & np.uint64(0xFFFFFFFF)).astype(
        np.uint32)


def _byte_bits4(v: np.ndarray) -> np.ndarray:
    """Bytes of 0 or 1 -> 4 bits: v * 0x01020408, bits 24..27 (byte k
    lands on bit 24 + k; the partial products set distinct bits)."""
    prod = (v.astype(np.uint64) * np.uint64(0x01020408)) & np.uint64(
        0xFFFFFFFF)
    return (prod >> np.uint64(24)).astype(np.uint32)


def _vector_bits(mask: np.ndarray) -> np.ndarray:
    """16 bits per aligned 16-byte vector of the flat byte mask (4 x
    _byte_bits4 of its 32-bit words), two vectors of zeros appended: the
    bytes past the mask read as 0 (the kernel's byte-wise tail)."""
    pad = -len(mask) % 16 + 32
    s = np.concatenate([mask, np.zeros(pad, np.uint8)])
    words = s.view("<u4").astype(np.uint32).reshape(-1, 4)
    bits = np.zeros(len(words), np.uint32)
    for k in range(4):
        bits |= _byte_bits4(words[:, k]) << np.uint32(4 * k)
    return bits


def _mask_word(V: np.ndarray, b: int) -> np.uint32:
    """Bits of mask bytes b .. b + 31: the vectors at a, a + 16 and a +
    32 (a = b rounded down to 16) as one 48-bit field, shifted by b % 16."""
    c = b >> 4
    v = (int(V[c]) | int(V[c + 1]) << 16 | int(V[c + 2]) << 32) >> (b & 15)
    return np.uint32(v & 0xFFFFFFFF)


def run_plane_model(mask: np.ndarray, dx: int, dy: int) -> np.ndarray:
    """Pass 1 tile by tile: each bitmask word cut out of the three aligned
    16-byte vectors that hold its 32 mask bytes, columns >= W cleared;
    thick rows (zero outside the padded domain); run words by shifted /
    col_mask.  -> [N, Hp, Wp / 32] uint32."""
    N, H, W = mask.shape
    Hp, Wp = tlk.run_pack_shape(H, W)
    WW, SW, ady = Wp // 32, Wp // 32 + 2, abs(dy)
    V = _vector_bits(mask.reshape(-1))
    nw = -(-W // 32)
    plane = np.zeros((N, Hp, WW), np.uint32)
    for n in range(N):
        for y0 in range(0, Hp, B4_RT):
            AR, TR = B4_RT + 4 * ady + 2, B4_RT + 4 * ady
            A = np.zeros((AR, SW), np.uint32)
            for ar in range(AR):
                y = y0 - 2 * ady - 1 + ar
                if not 0 <= y < H:
                    continue
                rs = (n * H + y) * W
                for w in range(nw):
                    a = _mask_word(V, rs + 32 * w)
                    if W - 32 * w < 32:
                        a &= np.uint32((1 << (W - 32 * w)) - 1)
                    A[ar, 1 + w] = a
            T = np.zeros((TR, SW), np.uint32)
            for tr in range(TR):
                y = y0 - 2 * ady + tr
                if not 0 <= y < Hp:
                    continue
                a = A[tr + 1, 1:-1]
                if abs(dx) >= abs(dy):
                    T[tr, 1:-1] = a | A[tr, 1:-1] | A[tr + 2, 1:-1]
                else:
                    T[tr, 1:-1] = (a | _u32(a.astype(np.uint64) << 1)
                                   | (A[tr + 1, :-2] >> np.uint32(31))
                                   | (a >> np.uint32(1))
                                   | _u32(A[tr + 1, 2:].astype(np.uint64)
                                          << 31))

            def sh(tr, shift):
                row = T[tr]
                prev, cur, nxt = row[:-2], row[1:-1], row[2:]
                if shift > 0:
                    return _funnel_r(cur, nxt, shift)
                if shift < 0:
                    return _funnel_r(prev, cur, 32 + shift)
                return cur.copy()

            cols = _dom(1, WW, 0, 0)[0]
            for r in range(B4_RT):
                y = y0 + r
                if y >= Hp:
                    break
                tr = r + 2 * ady
                t0 = T[tr, 1:-1]
                tm1, tm2 = sh(tr - dy, -dx), sh(tr - 2 * dy, -2 * dx)
                tp1, tp2 = sh(tr + dy, dx), sh(tr + 2 * dy, 2 * dx)
                dom_m = (_dom(1, WW, 0, -dx)[0] if 0 <= y - dy < Hp
                         else 0 * cols)
                dom_p = (_dom(1, WW, 0, dx)[0] if 0 <= y + dy < Hp
                         else 0 * cols)
                dil0 = t0 | tm1 | tp1
                dilm = (tm2 | tm1 | t0) & dom_m
                dilp = (t0 | tp1 | tp2) & dom_p
                plane[n, y] = (dil0 & dilm & dilp) | t0
    return plane


def _window32(P, n, y, x):
    """Bit j = run bit of row y at column x + j (0 outside the domain),
    arrays of lanes: two words funnel-shifted by x & 31."""
    N, Hp, WW = P.shape
    w, b = x >> 5, x & 31

    def word(wi):
        ok = (y >= 0) & (y < Hp) & (wi >= 0) & (wi < WW)
        return np.where(ok, P[n, np.clip(y, 0, Hp - 1),
                              np.clip(wi, 0, WW - 1)], np.uint32(0))

    lo = word(w)
    hi = np.where(b > 0, word(w + 1), np.uint32(0))
    v = (hi.astype(np.uint64) << np.uint64(32)) | lo.astype(np.uint64)
    return ((v >> b.astype(np.uint64)) & np.uint64(0xFFFFFFFF)).astype(
        np.uint32)


def _row_ones(P, n, y, x, dx, cap):
    """Trailing (dx > 0) or leading (dx < 0) ones of the row's words from
    column x, word by word, at most cap (arrays of starts)."""
    N, Hp, WW = P.shape
    total = np.zeros(x.shape, np.int64)
    live = np.ones(x.shape, bool)
    x = x.copy()
    while live.any():
        w, b = x >> 5, x & 31
        word = np.where((w >= 0) & (w < WW),
                        P[n, y, np.clip(w, 0, WW - 1)], 0).astype(np.uint64)
        if dx > 0:
            v = (~(word >> b.astype(np.uint64))) & np.uint64(0xFFFFFFFF)
            t = np.where(v == 0, 32, _ffs0(v.astype(np.uint32)))
            avail = 32 - b
        else:
            v = (~(word << (31 - b).astype(np.uint64))) & np.uint64(
                0xFFFFFFFF)
            t = 32 - np.where(v == 0, 0, np.floor(np.log2(np.maximum(
                v, 1))).astype(np.int64) + 1)                # __clz
            avail = b + 1
        total = np.where(live, total + t, total)
        live &= (t >= avail) & (total < cap)
        x = x + dx * t
    return np.minimum(total, cap)


B4_HOPS = 8                # hops of every start loaded at once


def start_pack_model(P: np.ndarray, dx: int, dy: int, cap: int):
    """Pass 2: a lane per plane word (32 pixels); starts = own & ~window
    one step back; lengths by row_ones (dy = 0, |dx| = 1), or by ANDing
    the windows of hops 1 .. HOPS (a start's length up to HOPS + 1 is a
    count of set bits), then, for a word with runs alive after them, the
    warp's rounds of 32 hops (the word's window at hop h + j from lane j,
    the first clear bit of each run's ballot ends it); every word written
    once.  Returns the words and the number of warp rounds."""
    N, Hp, WW = P.shape
    Wp = WW * 32
    n, y, w = np.meshgrid(np.arange(N), np.arange(Hp), np.arange(WW),
                          indexing="ij")
    n, y, w = n.reshape(-1), y.reshape(-1), w.reshape(-1)
    own = P[n, y, w]
    st = own & ~_window32(P, n, y - dy, 32 * w - dx)
    bit = np.arange(32, dtype=np.uint32)
    is_start = ((st[:, None] >> bit) & np.uint32(1)) == 1     # [lanes, 32]
    f = np.zeros((len(w), 32), np.int64)
    rounds = 0
    if dy == 0 and abs(dx) == 1:
        lane, i = np.nonzero(is_start)
        f[lane, i] = _row_ones(P, n[lane], y[lane], 32 * w[lane] + i, dx,
                               cap)
    else:
        a = st.copy()
        f[is_start] = 1
        for k in range(1, B4_HOPS + 1):
            win = _window32(P, n, y + k * dy, 32 * w + k * dx)
            a = a & win if k < cap else np.zeros_like(a)
            f += (((a[:, None] >> bit) & np.uint32(1)) == 1)
        more = a if B4_HOPS + 1 < cap else np.zeros_like(a)
        for lane in np.nonzero(more)[0]:         # one word at a time
            lm, h = int(more[lane]), B4_HOPS + 1
            while lm and h < cap:
                hh = h + np.arange(32)
                win = np.where(hh < cap, _window32(
                    P, np.full(32, n[lane]), y[lane] + hh * dy,
                    32 * w[lane] + hh * dx), 0)
                for i in range(32):
                    if (lm >> i) & 1:
                        b = ((win >> i) & 1) == 1          # the ballot
                        t = 32 if b.all() else int(np.argmin(b))
                        f[lane, i] += t
                        if t < 32:
                            lm &= ~(1 << i)
                h += 32
                rounds += 1
    pos = 63 - (y[:, None] & 7) * 8 - (bit[None, :] & 7).astype(np.int64)
    words = np.where(is_start, f * 64 + pos, 0)
    return words.reshape(N, Hp, Wp).astype(np.int32), rounds


def _b4_mask(rng, shape, step, density, chains, length):
    """Uniform noise plus straight chains of `length` hops along the step
    from random starts; the last row and column keep set bits."""
    N, H, W = shape
    dx, dy = step
    m = rng.random(shape) < density
    for n in range(N):
        for _ in range(chains):
            y, x = int(rng.integers(0, H)), int(rng.integers(0, W))
            for _k in range(length):
                if not (0 <= y < H and 0 <= x < W):
                    break
                m[n, y, x] = True
                y, x = y + dy, x + dx
    m[:, -1, ::4] = True
    m[:, ::3, -1] = True
    return m


DENSE_STEPS = tlsd.direction_steps(12)
# steps with dy < 0, dy = 0 with |dx| >= 2 (the walk along a row) and
# dx = -1 along rows (leading ones)
B4_OTHER = [(-1, 0), (4, 0), (-2, 0), (1, -4), (-4, -1), (3, -2), (0, -1)]


@pytest.mark.parametrize("step", DENSE_STEPS + B4_OTHER)
def test_run_pack_one_design_equals_plain(rng, step):
    """H % 8 != 0, W % 128 != 0 and set bits in the last row and column,
    every cap of 1, 8 and 256."""
    dx, dy = step
    mask = _b4_mask(rng, (2, 37, 150), step, 0.12, 4, 40)
    P = run_plane_model(mask, dx, dy)
    t = torch.from_numpy(mask)
    for md in (0, 3, 8):
        model, _ = start_pack_model(P, dx, dy, 1 << md)
        plain = tlk.run_pack_plain(t, dx, dy, md).numpy()
        np.testing.assert_array_equal(model, plain)
        assert (plain > 0).sum() > 20
        assert (plain >> 6).max() == min(1 << md, (plain >> 6).max())
    # runs start in the pad below and right of the image
    assert (plain[:, 37:] > 0).any() or (plain[:, :, 150:] > 0).any()


@pytest.mark.parametrize("shape,step,md", [
    ((1, 20, 300), (1, 0), 8),       # a 270-pixel row run at cap 256
    ((1, 20, 300), (-1, 0), 8),
    ((1, 300, 40), (0, 1), 8),       # a column run at cap 256 (walks)
    ((1, 300, 40), (0, -1), 8),
    ((2, 45, 130), (-4, 1), 3),      # runs at cap 8
    ((2, 45, 130), (1, 4), 0),       # cap 1
])
def test_run_pack_one_design_runs_at_cap(rng, shape, step, md):
    dx, dy = step
    N, H, W = shape
    mask = rng.random(shape) < 0.05
    if dy == 0:
        mask[:, 5, 10:280] = True
    elif dx == 0:
        mask[:, 10:290, 7] = True
    else:
        for n in range(N):
            y, x = (2, 100) if dx < 0 else (2, 5)
            while 0 <= y < H and 0 <= x < W:
                mask[n, y, x] = True
                y, x = y + dy, x + dx
    P = run_plane_model(mask, dx, dy)
    model, rounds = start_pack_model(P, dx, dy, 1 << md)
    plain = tlk.run_pack_plain(torch.from_numpy(mask), dx, dy, md).numpy()
    np.testing.assert_array_equal(model, plain)
    assert ((plain >> 6) == 1 << md).any(), "a run reaches the cap"
    if dy != 0 and md == 8:
        assert rounds >= 8, "the warp finishes the long runs"


@pytest.mark.parametrize("step,md", [((4, 3), 8), ((-1, 4), 3), ((1, 0), 8),
                                     ((-4, 1), 0)])
def test_run_pack_one_design_equals_pallas(pallas_interpret, rng, step, md):
    from stvo_pl_tpu.ops import lsd_kernel as jlk
    dx, dy = step
    mask = _b4_mask(rng, (2, 45, 130), step, 0.15, 4, 60)
    model, _ = start_pack_model(run_plane_model(mask, dx, dy), dx, dy,
                                1 << md)
    ref = np.asarray(jlk._run_pack_pallas(jnp.asarray(mask), dx, dy, md))
    np.testing.assert_array_equal(model, ref)
    assert (ref > 0).sum() > 20


# ---- B5: Hamming distances on the tensor cores ----------------------------

# csrc/hamming.cu: a block of 2 x 2 warps, each warp a 32 x 32 tile of
# 16 x 8 MMA fragments
B5_WN, B5_WM, B5_WARPS_N, B5_WARPS_M = 32, 32, 2, 2
B5_LANE = np.arange(32)
B5_G, B5_T = B5_LANE >> 2, B5_LANE & 3
B5_EDGE_WORDS = np.array([0, 0xFFFFFFFF, 0x80000000, 0x7FFFFFFF], np.uint32)


def _popc(x: np.ndarray) -> np.ndarray:
    x = np.ascontiguousarray(x, dtype=np.uint32)
    return np.unpackbits(x.view(np.uint8).reshape(x.shape + (4,)),
                         axis=-1).sum(-1).astype(np.int32)


def _quad_sum(v: np.ndarray) -> np.ndarray:
    """__shfl_xor_sync by 1, then by 2: every lane of a quad holds the
    quad's sum."""
    v = v + v[B5_LANE ^ 1]
    return v + v[B5_LANE ^ 2]


def _mma_and_popc(af: np.ndarray, bf: np.ndarray) -> np.ndarray:
    """One warp's mma.m16n8k256 .b1 .and.popc with C = 0, from and to the
    lanes' registers in the PTX ISA's fragment layout: af [32, 4] and bf
    [32, 2] 32-bit words -> d [32, 4]."""
    A = np.zeros((16, 8), np.uint32)        # rows x k-blocks of 32 bits
    Bm = np.zeros((8, 8), np.uint32)        # columns x k-blocks
    A[B5_G, B5_T], A[B5_G + 8, B5_T] = af[:, 0], af[:, 1]
    A[B5_G, 4 + B5_T], A[B5_G + 8, 4 + B5_T] = af[:, 2], af[:, 3]
    Bm[B5_G, B5_T], Bm[B5_G, 4 + B5_T] = bf[:, 0], bf[:, 1]
    D = _popc(A[:, None, :] & Bm[None, :, :]).sum(-1)      # [16, 8]
    c = 2 * B5_T
    return np.stack([D[B5_G, c], D[B5_G, c + 1], D[B5_G + 8, c],
                     D[B5_G + 8, c + 1]], axis=1)


def hamming_mma_model(d1: np.ndarray, d2: np.ndarray):
    """d1 [B, N, 8] x d2 [B, M, 8] uint32 -> ([B, N, M] int32, the number
    of times each output was written), block by block and warp by warp as
    the kernel computes and stores them."""
    Bn, N, _ = d1.shape
    M = d2.shape[1]
    FN, FM = B5_WN // 16, B5_WM // 8
    TN, TM = B5_WN * B5_WARPS_N, B5_WM * B5_WARPS_M
    LPR = B5_WM // 4
    RPI = 32 // LPR
    out = np.zeros((Bn, N, M), np.int32)
    writes = np.zeros((Bn, N, M), np.int32)
    for b in range(Bn):
        a = d1[b].reshape(N, 4, 2)           # word pairs (2t, 2t + 1)
        c = d2[b].reshape(M, 4, 2)
        for n_blk in range(0, N, TN):
            for m_blk in range(0, M, TM):
                for warp in range(B5_WARPS_N * B5_WARPS_M):
                    n0 = n_blk + (warp // B5_WARPS_M) * B5_WN
                    m0 = m_blk + (warp % B5_WARPS_M) * B5_WM
                    af, pa = [], []
                    for f in range(FN):
                        x = a[np.minimum(n0 + 16 * f + B5_G, N - 1), B5_T]
                        y = a[np.minimum(n0 + 16 * f + B5_G + 8, N - 1),
                              B5_T]
                        af.append(np.stack([x[:, 0], y[:, 0], x[:, 1],
                                            y[:, 1]], axis=1))
                        pa.append((_quad_sum(_popc(x).sum(-1)),
                                   _quad_sum(_popc(y).sum(-1))))
                    bf, pb = [], []
                    for j in range(FM):
                        z = c[np.minimum(m0 + 8 * j + B5_G, M - 1), B5_T]
                        bf.append(z)
                        p = _quad_sum(_popc(z).sum(-1))
                        pb.append((p[8 * B5_T], p[8 * B5_T + 4]))
                    st = np.zeros((B5_WN, B5_WM), np.int32)
                    for f in range(FN):
                        for j in range(FM):
                            d = _mma_and_popc(af[f], bf[j])
                            col = 8 * j + 2 * B5_T
                            for h in range(2):
                                r = 16 * f + B5_G + 8 * h
                                st[r, col] = pa[f][h] + pb[j][0] - 2 * d[:, 2 * h]
                                st[r, col + 1] = (pa[f][h] + pb[j][1]
                                                  - 2 * d[:, 2 * h + 1])
                    # the stores: LPR lanes a row, 4 words a lane
                    cq = 4 * (B5_LANE % LPR)
                    m = m0 + cq
                    vec = M % 4 == 0
                    for i in range(B5_WN // RPI):
                        r = RPI * i + B5_LANE // LPR
                        n = n0 + r
                        for lane in np.flatnonzero((n < N) & (m < M)):
                            k = 4 if vec else min(4, M - m[lane])
                            out[b, n[lane], m[lane]:m[lane] + k] = \
                                st[r[lane], cq[lane]:cq[lane] + k]
                            writes[b, n[lane], m[lane]:m[lane] + k] += 1
    return out, writes


def _b5_words(rng, shape):
    """Random words, the edge words in rows of their own, and pairs at
    distance 0 and 256."""
    d = rng.integers(0, 2 ** 32, shape, dtype=np.uint64).astype(np.uint32)
    flat = d.reshape(-1, 8)
    for i, v in enumerate(B5_EDGE_WORDS[:len(flat)]):
        flat[i] = v
    if len(flat) > 5:
        flat[4] = np.where(np.arange(8) % 2 == 0, 0x80000000, 0x7FFFFFFF)
        flat[5] = rng.integers(0, 2 ** 32, 8, dtype=np.uint64)
    return d


def _b5_pair(rng, s1, s2):
    d1, d2 = _b5_words(rng, s1), _b5_words(rng, s2)
    f1, f2 = d1.reshape(-1, 8), d2.reshape(-1, 8)
    k = min(len(f1), len(f2))
    if k > 5:
        f2[k - 1] = f1[5]               # distance 0
        f2[k - 2] = ~f1[5]              # distance 256
        f2[0] = ~f1[1]                  # 0xFFFFFFFF against 0: 256
    return d1, d2


@pytest.mark.parametrize("s1,s2", [
    ((1, 1, 8), (1, 1, 8)),
    ((1, 3, 8), (1, 257, 8)),           # M % 4 != 0: 4-byte stores
    ((2, 65, 8), (2, 3, 8)),
    ((1, 70, 8), (1, 130, 8)),          # ragged blocks and warp tiles
    ((1, 97, 8), (1, 300, 8)),          # the line capacity's columns
    ((2, 33, 8), (2, 68, 8)),
])
def test_hamming_design_equals_plain(rng, s1, s2):
    d1, d2 = _b5_pair(rng, s1, s2)
    model, writes = hamming_mma_model(d1, d2)
    assert (writes == 1).all(), "every output written once"
    plain = tham.hamming_matrix_xla(torch.from_numpy(d1.view(np.int32)),
                                    torch.from_numpy(d2.view(np.int32)))
    np.testing.assert_array_equal(model, plain.numpy())
    if min(s1[1], s2[1]) > 5:
        assert model.min() == 0 and model.max() == 256


def test_hamming_design_fragments_cover_every_word(rng):
    """A and B fragments hold each descriptor's 8 words once, at the same
    k-blocks: an MMA of a row with itself counts its set bits."""
    d = _b5_words(rng, (16, 8))
    x, y = d.reshape(16, 4, 2)[B5_G, B5_T], d.reshape(16, 4, 2)[B5_G + 8,
                                                                B5_T]
    af = np.stack([x[:, 0], y[:, 0], x[:, 1], y[:, 1]], axis=1)
    for j in range(2):
        z = d.reshape(16, 4, 2)[8 * j + B5_G, B5_T]
        D = _mma_and_popc(af, z)
        rows = np.stack([B5_G, B5_G, B5_G + 8, B5_G + 8], axis=1)
        cols = 8 * j + np.stack([2 * B5_T, 2 * B5_T + 1] * 2, axis=1)
        ref = _popc(d[rows] & d[cols]).sum(-1)
        np.testing.assert_array_equal(D, ref)
    assert _popc(d).sum(-1)[0] == 0 and _popc(d).sum(-1)[1] == 256


@pytest.mark.parametrize("n,m", [(256, 256), (512, 256)])
def test_hamming_design_equals_pallas(pallas_interpret, rng, n, m):
    from stvo_pl_tpu.ops import hamming as jham
    d1, d2 = _b5_pair(rng, (1, n, 8), (1, m, 8))
    model, _ = hamming_mma_model(d1, d2)
    ref = np.asarray(jham.hamming_matrix_pallas(jnp.asarray(d1[0]),
                                                jnp.asarray(d2[0])))
    np.testing.assert_array_equal(model[0], ref)
    plain = tham.hamming_matrix_xla(torch.from_numpy(d1[0].view(np.int32)),
                                    torch.from_numpy(d2[0].view(np.int32)))
    np.testing.assert_array_equal(plain.numpy(), ref)
    assert ref.min() == 0 and ref.max() == 256
