"""Plain models of the decompositions that the CUDA kernels B1
(csrc/fast_pack.cu) and B3 (csrc/lsd_run_pack.cu `stvo_lsd_run_pack_multi`)
use, held on the CPU to the plain versions and to interpret-mode Pallas.

The kernels themselves run only on a card (tests/test_torch_kernels_cuda.py,
chip_smoke.py).  These models repeat their arithmetic step for step in
numpy, so a wrong decomposition shows here first:

- B1: the response on order-preserving integer keys of the raw pixel
  values with three-input min/max windows (no circle differences), and the
  exact 9-contiguous-sign classification of a positive response.
- B3: run planes (one 32-bit word per direction, row and 32 columns,
  thickened and gap-closed with funnel shifts across words), then the run
  lengths by 32-step blocks of 32 chains: a tile of run bits transposed
  across the warp, trailing-ones counts inside the tile, and the carry
  from the tile before (the tile-local scan and its boundary carries),
  then the 8-row maximum of the start words.
"""

import functools

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from stvo_pl_tpu_torch.ops import camera as tcam
from stvo_pl_tpu_torch.ops import fast as tfast
from stvo_pl_tpu_torch.ops import fast_kernel as tfk
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
