"""ORB description of the port, holding kernel B2's plain version.

`extract_patches_plain` (the twin of csrc/patches.cu) must be bit-equal
to the JAX package's Pallas kernel `_pallas_extract` run in interpret
mode, in the 33x33 float32 mode and in the (1, PX) row mode with uint32
input.  The descriptor tables are equal arrays; identical patches give
identical descriptor bits (also through `orient_and_describe`, the gather
and the description in one call); the photometric disparity shift
agrees.

The descriptor kernel's formulation (csrc/orb_describe.cu, which runs
only on a card: tests/test_torch_orb_cuda.py): its [30, 256, 2] table of
test pixels reproduces the test matrix, and its plain twin
`orient_describe_plain` (the tests as pixel comparisons) equals the
product path bit for bit on patches at every orientation bin's
boundaries (tests/orb_cases.py)."""

import functools

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from stvo_pl_tpu.ops import orb as jorb
from stvo_pl_tpu.ops import subpix as jsub
from stvo_pl_tpu_torch.ops import orb as torb
from stvo_pl_tpu_torch.ops import patches as tpat
from stvo_pl_tpu_torch.ops import subpix as tsub

from orb_cases import boundary_patches, moments

torch.set_num_threads(1)


@pytest.fixture
def pallas_patches(monkeypatch):
    """stvo_pl_tpu's _pallas_extract with pallas_call in interpret mode."""
    from jax.experimental import pallas as pl
    monkeypatch.setattr(pl, "pallas_call",
                        functools.partial(pl.pallas_call, interpret=True))
    from stvo_pl_tpu.ops import patches as jpat
    return jpat


def test_tables_equal():
    for size in (31, 21):
        np.testing.assert_array_equal(torb._make_pattern(size),
                                      jorb._make_pattern(size))
    np.testing.assert_array_equal(torb._binned_test_matrix(31),
                                  jorb._binned_test_matrix(31))
    np.testing.assert_array_equal(torb._circular_mask(15, 33),
                                  jorb._circular_mask(15, 33))
    np.testing.assert_array_equal(torb._ORI_X, jorb._ORI_X)
    np.testing.assert_array_equal(torb._ORI_Y, jorb._ORI_Y)
    for k in (3, 4):
        np.testing.assert_array_equal(torb._binned_sample_matrix(31, k),
                                      jorb._binned_sample_matrix(31, k))


def test_extract_square_f32_bit_equal(pallas_patches, rng):
    N, H, W, K, P = 2, 120, 160, 10, 33
    img = (rng.random((N, H, W)) * 255).astype(np.float32)
    y0 = rng.integers(0, H - P + 1, (N, K)).astype(np.int32)
    x0 = rng.integers(0, W - P + 1, (N, K)).astype(np.int32)
    ref = np.asarray(pallas_patches._pallas_extract(
        jnp.asarray(img), jnp.asarray(y0), jnp.asarray(x0), P, 8))
    out = tpat.extract_patches(torch.from_numpy(img), torch.from_numpy(y0),
                               torch.from_numpy(x0), P).numpy()
    assert out.dtype == np.float32 and out.shape == (N, K, P, P)
    np.testing.assert_array_equal(out, ref)


def test_extract_row_mode_uint32_bit_equal(pallas_patches, rng):
    N, H, W, K, PX = 2, 40, 200, 12, 24
    img = rng.integers(0, 2 ** 32, (N, H, W), dtype=np.uint64).astype(
        np.uint32)
    y0 = rng.integers(0, H, (N, K)).astype(np.int32)
    x0 = rng.integers(0, W - PX + 1, (N, K)).astype(np.int32)
    ref = np.asarray(pallas_patches._pallas_extract(
        jnp.asarray(img), jnp.asarray(y0), jnp.asarray(x0), (1, PX), 8))
    src = torch.from_numpy(img.view(np.int32))       # same bits as int32
    out = tpat.extract_patches(src, torch.from_numpy(y0),
                               torch.from_numpy(x0), (1, PX)).numpy()
    assert out.shape == (N, K, 1, PX)
    np.testing.assert_array_equal(out.view(np.uint32), ref)


def test_gather_patches_matches_jax(rng):
    N, H, W, K = 2, 90, 120, 40
    img = (rng.random((N, H, W)) * 255).astype(np.float32)
    uv = rng.uniform([-5, -5], [W + 5, H + 5], (N, K, 2)).astype(np.float32)
    out = torb.gather_patches(torch.from_numpy(img),
                              torch.from_numpy(uv)).numpy()
    for i in range(N):
        ref = np.asarray(jorb.gather_patches(jnp.asarray(img[i]),
                                             jnp.asarray(uv[i])))
        np.testing.assert_array_equal(out[i], ref)


def _patches(rng, K=96):
    base = rng.random((K, 1, 1)) * 120 + 40
    p = base + rng.normal(0, 30, (K, 33, 33))
    return np.clip(p, 0, 255).astype(np.float32)


def test_orient_describe_identical_bits(rng):
    p = _patches(rng)
    tdesc, tc, ts = torb.orient_describe(torch.from_numpy(p))
    jdesc, jc, js = jorb.orient_describe(jnp.asarray(p))
    np.testing.assert_array_equal(tdesc.numpy().view(np.uint32),
                                  np.asarray(jdesc))
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=1e-6)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=1e-6)
    # batched leading dims keep the same bits
    tdesc2, _, _ = torb.orient_describe(torch.from_numpy(p).reshape(
        2, -1, 33, 33))
    np.testing.assert_array_equal(tdesc2.reshape(-1, 8).numpy(),
                                  tdesc.numpy())


@pytest.mark.parametrize("patch_size", [31, 15])
def test_orient_and_describe_identical_bits(rng, patch_size):
    from stvo_pl_tpu.ops import image as jimg
    N, H, W, K = 2, 90, 120, 40
    img = (rng.random((N, H, W)) * 255).astype(np.float32)
    blur = np.stack([np.asarray(jimg.gaussian_blur(jnp.asarray(im), 2.0, 3))
                     for im in img])
    uv = rng.uniform([-5, -5], [W + 5, H + 5], (N, K, 2)).astype(np.float32)
    tout = torb.orient_and_describe(torch.from_numpy(img),
                                    torch.from_numpy(blur),
                                    torch.from_numpy(uv), patch_size)
    assert tout[0].shape == (N, K, 8)
    for i in range(N):
        jdesc, jc, js = jorb.orient_and_describe(
            jnp.asarray(img[i]), jnp.asarray(blur[i]), jnp.asarray(uv[i]),
            patch_size=patch_size)
        one = torb.orient_and_describe(torch.from_numpy(img[i]),
                                       torch.from_numpy(blur[i]),
                                       torch.from_numpy(uv[i]), patch_size)
        for a, b in zip(one, tout):
            assert torch.equal(a, b[i])
        np.testing.assert_array_equal(one[0].numpy().view(np.uint32),
                                      np.asarray(jdesc))
        np.testing.assert_allclose(one[1].numpy(), np.asarray(jc), atol=1e-6)
        np.testing.assert_allclose(one[2].numpy(), np.asarray(js), atol=1e-6)


@pytest.mark.parametrize("wta_k", [3, 4])
def test_describe_wta_identical_bits(rng, wta_k):
    q = np.round(_patches(rng))
    c, s = jorb.orientation(jnp.asarray(q))
    jdesc = jorb.describe_wta(jnp.asarray(q), c, s, wta_k)
    tdesc = torb.describe_wta(torch.from_numpy(q),
                              torch.from_numpy(np.asarray(c)),
                              torch.from_numpy(np.asarray(s)), wta_k)
    np.testing.assert_array_equal(tdesc.numpy().view(np.uint32),
                                  np.asarray(jdesc))


def test_disparity_shift_matches(rng):
    K, Q = 64, 13
    left = rng.random((K, Q, Q + 2)).astype(np.float32) * 200
    shift_px = rng.uniform(-0.4, 0.4, K)
    xs = np.arange(Q + 2)[None, None, :] + shift_px[:, None, None]
    right = np.stack([np.stack([np.interp(xs[k, 0], np.arange(Q + 2),
                                          left[k, r])
                                for r in range(Q)]) for k in range(K)])
    left = np.ascontiguousarray(left[:, :, 1:-1])
    right = np.ascontiguousarray(right[:, :, 1:-1]).astype(np.float32)
    ts, tok = tsub.disparity_shift(torch.from_numpy(left),
                                   torch.from_numpy(right))
    js, jok = jsub.disparity_shift(jnp.asarray(left), jnp.asarray(right))
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jok))
    # SSD sums of 121 products in another order: 1e-4 px
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=1e-4)


@pytest.mark.parametrize("patch_size", [31, 15])
def test_index_table_reproduces_test_matrix(patch_size):
    """+1 at i1 and -1 at i0 of every (bin, bit) column, and a zero column
    where the two test points coincide."""
    tab = torb._test_index_table(patch_size)
    assert tab.shape == (torb.N_ORI_BINS, torb.N_BITS, 2)
    assert tab.dtype == np.int16
    ref = torb._binned_test_matrix(patch_size)
    D = np.zeros_like(ref)
    for b in range(torb.N_ORI_BINS):
        i0, i1 = tab[b, :, 0], tab[b, :, 1]
        cols = (b * torb.N_BITS + np.arange(torb.N_BITS))[i0 != i1]
        D[i1[i0 != i1], cols] = 1.0
        D[i0[i0 != i1], cols] = -1.0
    np.testing.assert_array_equal(D, ref)


def test_boundary_patches_cover_every_bin_boundary():
    """The shared patch set: exact moments within 1e-5 rad on both sides
    of each of the 30 bin boundaries, zero moments, saturated values."""
    x, bins = boundary_patches()
    q = np.clip(np.round(x), 0, 255)
    m10, m01 = moments(q)
    u = np.arctan2(m01, m10) / (2 * np.pi / torb.N_ORI_BINS)
    for b in range(torb.N_ORI_BINS):
        off = (u - (b + 0.5) + torb.N_ORI_BINS / 2) % torb.N_ORI_BINS \
            - torb.N_ORI_BINS / 2
        rad = off * 2 * np.pi / torb.N_ORI_BINS
        assert ((rad > 0) & (rad < 1e-5)).any(), b
        assert ((rad < 0) & (rad > -1e-5)).any(), b
    assert ((m10 == 0) & (m01 == 0)).sum() >= 4
    assert (x < -0.5).any() and (x > 255.5).any()
    assert set(bins[bins >= 0].tolist()) == set(range(torb.N_ORI_BINS))


@pytest.mark.parametrize("patch_size", [31, 15])
def test_test_gather_equals_product_bit_for_bit(patch_size):
    """The kernel's formulation in plain PyTorch (`orient_describe_plain`)
    against the product path on the boundary set: the same words, cos and
    sin, every bin as the exact moments put it."""
    x, bins = boundary_patches()
    xt = torch.from_numpy(x)
    dp, cp, sp = torb.orient_describe_product(xt, patch_size)
    dg, cg, sg = torb.orient_describe_plain(xt, patch_size)
    assert torch.equal(dg, dp) and torch.equal(cg, cp) and torch.equal(sg, sp)
    got = torb._bin_index(cp, sp).numpy()
    np.testing.assert_array_equal(got[bins >= 0], bins[bins >= 0])
    assert set(got.tolist()) == set(range(torb.N_ORI_BINS))
    # leading dims keep the same bits
    dg2, _, _ = torb.orient_describe_plain(xt[:400].reshape(4, 100, 33, 33),
                                           patch_size)
    assert torch.equal(dg2.reshape(-1, 8), dg[:400])


def test_orient_describe_takes_product_on_cpu():
    """CPU tensors take the product path, never the kernel, whose wrapper
    refuses them."""
    x, _ = boundary_patches(n_random=16)
    xt = torch.from_numpy(x)
    before = torb.orb_describe.launches
    for a, b in zip(torb.orient_describe(xt),
                    torb.orient_describe_product(xt)):
        assert torch.equal(a, b)
    assert torb.orb_describe.launches == before
    with pytest.raises(ValueError, match="device"):
        torb.orb_describe(xt)
    with pytest.raises(ValueError, match="33"):
        torb.orb_describe(xt[:, :31, :31])
