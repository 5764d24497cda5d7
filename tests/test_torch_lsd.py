"""The dense line detector of the port (ops/lsd.py, ops/lsd_kernel.py)
against the JAX package on identical numpy inputs.

`run_pack_multi_plain` (the twin of csrc/lsd_run_pack.cu) must be
bit-equal to the Pallas kernel `_run_pack_multi_pallas` in interpret mode,
including masks with set bits in the last row and column (runs continue
into the kernel's zero padding there; the JAX package's unpadded XLA twin
differs on such masks, so it is not the reference).  The stages after the
kernel are fed the same packed maps, fields or segments on both sides:
discrete outputs must be equal, coordinates agree to 1e-5 px (the same
float32 operations; XLA may contract a multiply-add), the least-squares
refit and the NFA to 1e-4.  The whole detector is compared on a rendered
frame with the JAX package forced onto its kernel branch."""

import functools
import math

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from stvo_pl_tpu.ops import lsd as jlsd
from stvo_pl_tpu.ops import lsd_kernel as jlk
from stvo_pl_tpu_torch.ops import lsd as tlsd
from stvo_pl_tpu_torch.ops import lsd_kernel as tlk

from test_torch_helpers import (MIN_LEN, jax_kernel_branch,
                                rendered_sequence, shared_fraction)

torch.set_num_threads(1)

TOL = math.radians(22.5)


@pytest.fixture
def pallas_interpret(monkeypatch):
    from jax.experimental import pallas as pl
    monkeypatch.setattr(pl, "pallas_call",
                        functools.partial(pl.pallas_call, interpret=True))


def _random_bits(rng, shape, n_dirs, density, border):
    bits = np.zeros(shape, np.int32)
    for d in range(n_dirs):
        bits |= (rng.random(shape) < density).astype(np.int32) << d
    if border:
        bits[:, -1, ::3] |= (1 << n_dirs) - 1
        bits[:, ::2, -1] |= (1 << n_dirs) - 1
    else:
        bits[:, -1, :] = 0
        bits[:, :, -1] = 0
    return bits


def test_direction_tables_equal():
    assert tlsd.DIR_STEPS == jlsd.DIR_STEPS
    for dx, dy in jlsd.DIR_STEPS:
        assert tlk._hop_q(dx, dy) == jlk._hop_q(dx, dy)
    # the subsampling of lsd.py:495-502
    for n in (4, 8, 12, 16, 20):
        if n >= 16:
            ref = jlsd.DIR_STEPS
        else:
            idx = np.round(np.linspace(0, 16, n, endpoint=False)).astype(int)
            ref = [jlsd.DIR_STEPS[i] for i in idx]
        assert tlsd.direction_steps(n) == ref
    assert tlk.packed_shape(571, 1226, 8) == (8, 72, 1280)


@pytest.mark.parametrize("shape,n_dirs,density,border", [
    ((2, 70, 150), 8, 0.3, True),       # H % 64 != 0
    ((2, 70, 150), 16, 0.1, False),
    ((1, 64, 128), 16, 0.3, True),      # no padding at all
    ((1, 64, 128), 8, 0.5, False),
    ((2, 97, 130), 16, 0.05, True),
    ((2, 97, 130), 8, 0.02, False),
])
def test_run_pack_multi_plain_bit_equal_to_pallas(pallas_interpret, rng,
                                                  shape, n_dirs, density,
                                                  border):
    bits = _random_bits(rng, shape, n_dirs, density, border)
    steps = tlsd.direction_steps(n_dirs)
    ref = np.asarray(jlk._run_pack_multi_pallas(jnp.asarray(bits),
                                                tuple(steps), 8))
    out = tlk.run_pack_multi(torch.from_numpy(bits), steps).numpy()
    assert out.shape == ref.shape == (shape[0],) + tlk.packed_shape(
        shape[1], shape[2], n_dirs)
    np.testing.assert_array_equal(out, ref)
    assert (ref > 0).sum() > 20, "the masks must hold runs"
    if border and ref.shape[-1] > shape[2]:
        # the padded-domain case is really exercised: thickening carries
        # the last column's bits into the pad, and run starts appear there
        assert (ref[..., shape[2]:] > 0).any()


def test_run_pack_multi_rejects_bad_input():
    bits = torch.zeros((1, 64, 128), dtype=torch.int32)
    with pytest.raises(ValueError, match="int32"):
        tlk.run_pack_multi(bits.float(), [(1, 0)])
    with pytest.raises(ValueError, match="directions"):
        tlk.run_pack_multi(bits, [(1, 0)] * 17)
    with pytest.raises(ValueError, match="steps"):
        tlk.run_pack_multi(bits, [(5, 1)])
    assert tlk.run_pack_multi(bits, [(1, 0)]).shape == (1, 1, 8, 128)


def test_level_line_field_and_bitmask(rng):
    """Field to 1e-5 relative (sqrt / atan2 of the same float32 sums); the
    bitmask bit-equal when both sides are fed the same field."""
    img = (rng.random((2, 60, 90)) * 255).astype(np.float32)
    ang_t, mag_t = tlsd.level_line_field(torch.from_numpy(img))
    for i in range(2):
        ang_j, mag_j = jlsd.level_line_field(jnp.asarray(img[i]))
        np.testing.assert_allclose(mag_t[i].numpy(), np.asarray(mag_j),
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(ang_t[i].numpy(), np.asarray(ang_j),
                                   atol=1e-5)
    ang_j, mag_j = jlsd.level_line_field(jnp.asarray(img[0]))
    rho = 2.0 / math.sin(TOL)
    steps = tlsd.direction_steps(12)
    ref = jnp.zeros(ang_j.shape, jnp.int32)
    for i, (dx, dy) in enumerate(steps):          # lsd.py:516-520
        theta = math.atan2(dy, dx) % math.pi
        aligned = (jlsd._angle_dist_mod_pi(ang_j, theta) < TOL) & (mag_j > rho)
        ref = ref | (aligned.astype(jnp.int32) << i)
    out = tlsd.direction_bitmask(torch.from_numpy(np.array(ang_j)),
                                 torch.from_numpy(np.array(mag_j)), steps,
                                 TOL, rho)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
    assert (np.asarray(ref) != 0).mean() > 0.1


@pytest.mark.parametrize("n_dirs,k_total,min_len", [(8, 90, 6.0),
                                                    (16, 40, 3.0),
                                                    (8, 5000, 4.5)])
def test_candidates_from_packed_multi(rng, n_dirs, k_total, min_len):
    """Same packed maps in: positions, validity and order equal, the float
    outputs to 1e-5.  k_total beyond the pool is padded with invalid
    entries (the reference clamps k instead)."""
    steps = tlsd.direction_steps(n_dirs)
    bits = _random_bits(rng, (2, 70, 150), n_dirs, 0.04, True)
    packed = tlk.run_pack_multi(torch.from_numpy(bits), steps)
    out = tlsd._candidates_from_packed_multi(packed, steps, k_total, min_len)
    assert int(out[6].sum()) > 10
    for i in range(2):
        ref = jlsd._candidates_from_packed_multi(
            jnp.asarray(packed[i].numpy()), steps, k_total,
            jnp.float32(min_len))
        k = np.asarray(ref[0]).shape[0]
        assert out[0].shape[1] == k_total and k == min(k_total,
                                                      packed[i].numel() // 8)
        np.testing.assert_array_equal(out[6][i, :k].numpy(),
                                      np.asarray(ref[6]))
        assert not out[6][i, k:].any()
        runs = min(k, int((packed[i].reshape(n_dirs, -1, 8).amax(-1)
                           > 0).sum()))
        assert runs > 30
        rows_t = np.stack([a[i, :runs].numpy() for a in out[:6]], axis=1)
        rows_j = np.stack([np.asarray(b)[:runs] for b in ref[:6]], axis=1)
        if k_total > k:
            # with k at the pool size the reference's approximate top-k
            # orders equal words its own way: held as a set
            rows_t = rows_t[np.lexsort(rows_t.T)]
            rows_j = rows_j[np.lexsort(rows_j.T)]
        np.testing.assert_allclose(rows_t, rows_j, atol=1e-5)


def _fragments(rng, n_lines, K):
    """K segments: fragments of n_lines long lines (collinear up to 0.4 px
    of jitter, overlapping or separated by small gaps) plus loose ones."""
    sp, ep = [], []
    while len(sp) < K:
        p = rng.random(2) * np.array([200.0, 120.0]) + 10
        th = rng.random() * np.pi
        u = np.array([np.cos(th), np.sin(th)])
        t = 0.0
        for _ in range(int(rng.integers(1, 5))):
            length = 6 + rng.random() * 30
            jit = (rng.random((2, 2)) - 0.5) * 0.8
            sp.append(p + u * t + jit[0])
            ep.append(p + u * (t + length) + jit[1])
            t += length + (rng.random() - 0.4) * 10
    sp = np.asarray(sp[:K], np.float32)
    ep = np.asarray(ep[:K], np.float32)
    flip = rng.random(K) < 0.3
    sp[flip], ep[flip] = ep[flip].copy(), sp[flip].copy()
    valid = rng.random(K) < 0.9
    return sp, ep, valid


def test_merge_collinear_and_suppress_duplicates(rng):
    """Same segments in: validity equal, endpoints and lengths to 1e-5 px
    (the same float32 operations; XLA may contract a multiply-add)."""
    N, K = 2, 70
    segs = [_fragments(rng, 20, K) for _ in range(N)]
    sp = np.stack([s[0] for s in segs])
    ep = np.stack([s[1] for s in segs])
    valid = np.stack([s[2] for s in segs])
    length = np.where(valid, np.linalg.norm(ep - sp, axis=-1), 0).astype(
        np.float32)
    args = dict(ang_tol=TOL * 0.5, perp_tol=2.5, gap_tol=6.0)
    t_out = tlsd._merge_collinear(torch.from_numpy(sp), torch.from_numpy(ep),
                                  torch.from_numpy(length),
                                  torch.from_numpy(valid), **args)
    merged = 0
    for i in range(N):
        j_out = jlsd._merge_collinear(jnp.asarray(sp[i]), jnp.asarray(ep[i]),
                                      jnp.asarray(length[i]),
                                      jnp.asarray(valid[i]), **args)
        np.testing.assert_array_equal(t_out[3][i].numpy(),
                                      np.asarray(j_out[3]))
        for a, b in zip(t_out[:3], j_out[:3]):
            np.testing.assert_allclose(a[i].numpy(), np.asarray(b), atol=1e-5)
        merged += int(valid[i].sum() - np.asarray(j_out[3]).sum())
    assert merged > 10, "the fragments must merge"

    resp = np.where(valid, length + rng.integers(0, 2, length.shape), 0
                    ).astype(np.float32)          # equal responses occur
    for kw in (dict(perp_tol=2.0, overlap_tol=0.8),
               dict(perp_tol=4.0, overlap_tol=0.4)):
        t_v = tlsd._suppress_duplicates(
            torch.from_numpy(sp), torch.from_numpy(ep),
            torch.from_numpy(resp), torch.from_numpy(valid), **kw)
        for i in range(N):
            j_v = jlsd._suppress_duplicates(
                jnp.asarray(sp[i]), jnp.asarray(ep[i]), jnp.asarray(resp[i]),
                jnp.asarray(valid[i]), **kw)
            np.testing.assert_array_equal(t_v[i].numpy(), np.asarray(j_v))
    assert int(t_v.sum()) < int(valid.sum())


@pytest.fixture(scope="module")
def frame():
    L, R, _ = rendered_sequence(1)
    return np.stack([L[0], R[0]])


@pytest.mark.parametrize("n_samples,search", [(16, 2), (8, 3)])
def test_refine_segments_and_nfa(frame, n_samples, search):
    """The same field and candidates in: refit endpoints to 1e-4 px,
    density / validity equal, -log10(NFA) to 1e-4."""
    blur = [np.asarray(jlsd.gaussian_blur(jnp.asarray(f), 0.8)) for f in frame]
    field = [jlsd.level_line_field(jnp.asarray(b)) for b in blur]
    ang = np.stack([np.asarray(f[0]) for f in field])
    mag = np.stack([np.asarray(f[1]) for f in field])
    segs = tlsd.detect_line_segments(torch.from_numpy(frame), MIN_LEN,
                                     capacity=40, n_dirs=8, refine=False)
    assert int(segs.valid.sum()) > 30
    c = [segs.sp[..., 0], segs.sp[..., 1], segs.ep[..., 0], segs.ep[..., 1],
         segs.valid]
    t_out = tlsd._refine_segments(torch.from_numpy(ang),
                                  torch.from_numpy(mag), *c, TOL,
                                  n_samples=n_samples, search=search)
    H, W = frame.shape[1:]
    for i in range(2):
        j_out = jlsd._refine_segments(
            jnp.asarray(ang[i]), jnp.asarray(mag[i]),
            *[jnp.asarray(x[i].numpy()) for x in c], TOL,
            n_samples=n_samples, search=search)
        np.testing.assert_array_equal(t_out[3][i].numpy(),
                                      np.asarray(j_out[3]))
        for k in (0, 1, 2, 4):
            np.testing.assert_allclose(t_out[k][i].numpy(),
                                       np.asarray(j_out[k]), atol=1e-4)
        length = np.linalg.norm(np.asarray(j_out[1] - j_out[0]), axis=-1)
        t_nfa = tlsd.nfa_neg_log10(torch.from_numpy(length), t_out[4][i], H,
                                   W, TOL, width=5)
        j_nfa = jlsd.nfa_neg_log10(jnp.asarray(length), j_out[4], H, W, TOL,
                                   width=5)
        np.testing.assert_allclose(t_nfa.numpy(), np.asarray(j_nfa),
                                   atol=1e-4, rtol=1e-5)


def test_refine_segments_batch_dependence():
    """A lane's refit alone and inside a 4-lane batch (uniform random
    angle and magnitude fields, 300 random candidates per lane, 120x160,
    tol 0.39): in each package the two answers agree within 1e-4 px, and
    the port's agree with the JAX package's within this file's refit
    tolerance of 1e-4.  The last bits may depend on the batch in either
    package (the JAX package's batched sums over a middle axis split
    another way: 1.5e-5 / 7.6e-6 px in start / end points at these
    inputs, the port's 1.9e-6 / 3.8e-6 px; ROADMAP "Documented
    divergences")."""
    N, H, W, K, tol = 4, 120, 160, 300, 0.39
    rng = np.random.default_rng(0)
    ang = rng.uniform(-np.pi, np.pi, (N, H, W)).astype(np.float32)
    mag = rng.uniform(0.0, 10.0, (N, H, W)).astype(np.float32)
    xs, xe = (rng.uniform(2, W - 3, (N, K)).astype(np.float32)
              for _ in range(2))
    ys, ye = (rng.uniform(2, H - 3, (N, K)).astype(np.float32)
              for _ in range(2))
    valid = rng.random((N, K)) < 0.9
    args = (ang, mag, xs, ys, xe, ye, valid)
    j_refine = jax.jit(jax.vmap(functools.partial(jlsd._refine_segments,
                                                  tol=tol)))
    j_all = [np.asarray(a) for a in j_refine(*map(jnp.asarray, args))]
    j_one = [np.asarray(a) for a in j_refine(*(jnp.asarray(a[:1])
                                               for a in args))]
    t_all = [a.numpy() for a in tlsd._refine_segments(
        *map(torch.from_numpy, args), tol)]
    t_one = [a.numpy() for a in tlsd._refine_segments(
        *(torch.from_numpy(a[:1]) for a in args), tol)]
    for one, batch in ((j_one, j_all), (t_one, t_all)):
        np.testing.assert_array_equal(one[3], batch[3][:1])
        for k in (0, 1):                              # start, end points
            np.testing.assert_allclose(one[k], batch[k][:1], rtol=0,
                                       atol=1e-4)
    for k in (0, 1, 2, 4):
        np.testing.assert_allclose(t_all[k], j_all[k], rtol=0, atol=1e-4)
    np.testing.assert_array_equal(t_all[3], j_all[3])


@pytest.mark.parametrize("kw", [
    dict(capacity=48, n_dirs=8, log_eps=0.0),
    dict(capacity=60, n_dirs=16, log_eps=-1.0, k_total=100),
    dict(capacity=48, n_dirs=12, refine=False),
], ids=["nfa", "k_total", "fld"])
def test_detect_line_segments_against_kernel_branch(frame, kw):
    """The whole detector on a rendered 240x180 stereo pair against the JAX
    package on its kernel branch.  With the refit, the valid masks are
    equal and endpoints agree to 1e-3 px (the blur's multiply-adds are
    contracted by XLA, which moves the field by an ulp).  The FLD mode
    ranks raw integer-hop runs, whose lengths tie; an ulp in a merged
    endpoint reorders ties and changes who falls under the capacity, so it
    is held as a set: >= 90% of the segments shared within 0.5 px."""
    segs, ang, mag = tlsd.detect_line_segments(
        torch.from_numpy(frame), MIN_LEN, with_field=True, **kw)
    assert ang.shape == mag.shape == frame.shape
    with jax_kernel_branch():
        refs = [jlsd.detect_line_segments(jnp.asarray(f),
                                          jnp.float32(MIN_LEN), **kw)
                for f in frame]
        refs = [jax.tree_util.tree_map(np.asarray, r) for r in refs]
    for i, ref in enumerate(refs):
        assert ref.valid.sum() > 10
        if kw.get("refine", True):
            np.testing.assert_array_equal(segs.valid[i].numpy(), ref.valid)
            v = ref.valid
            for f in ("sp", "ep", "length", "resp"):
                np.testing.assert_allclose(getattr(segs, f)[i].numpy()[v],
                                           getattr(ref, f)[v], atol=1e-3)
            np.testing.assert_allclose(segs.angle[i].numpy()[v], ref.angle[v],
                                       atol=1e-4)
        else:
            share = shared_fraction(segs.sp[i].numpy(), segs.ep[i].numpy(),
                                    segs.valid[i].numpy(), ref.sp, ref.ep,
                                    ref.valid)
            assert share >= 0.9, share


def test_valid_mask_and_small_pool(frame):
    """valid_mask confines detection, and a capacity above the candidate
    pool pads with invalid entries instead of failing."""
    mask = np.zeros(frame.shape[1:], bool)
    mask[:, :120] = True
    segs = tlsd.detect_line_segments(
        torch.from_numpy(frame), MIN_LEN, capacity=300, n_dirs=8,
        valid_mask=torch.from_numpy(mask), k_total=64)
    assert segs.sp.shape == (2, 300, 2)
    v = segs.valid.numpy()
    assert 5 < v.sum() <= 2 * 64
    assert (segs.sp.numpy()[v][:, 0] < 123).all()
    assert (segs.ep.numpy()[v][:, 0] < 123).all()
