"""ORB description of the port, holding kernel B2's plain version.

`extract_patches_plain` (the twin of csrc/patches.cu) must be bit-equal
to the JAX package's Pallas kernel `_pallas_extract` run in interpret
mode, in the 33x33 float32 mode and in the (1, PX) row mode with uint32
input.  The descriptor tables are equal arrays; identical patches give
identical descriptor bits; the photometric disparity shift agrees."""

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
