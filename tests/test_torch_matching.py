"""Hamming distances and matching of the port against the JAX package:
distance matrices equal, NNR + mutual matches and window masks equal
index for index."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from stvo_pl_tpu.ops import hamming as jham
from stvo_pl_tpu.ops import matching as jmat
from stvo_pl_tpu_torch.ops import hamming as tham
from stvo_pl_tpu_torch.ops import matching as tmat

torch.set_num_threads(1)


def _desc(rng, n):
    return rng.integers(0, 2 ** 32, (n, 8), dtype=np.uint64).astype(np.uint32)


def _t(d):
    return torch.from_numpy(d.view(np.int32))


@pytest.mark.parametrize("name", [
    "hamming_matrix_mxu", "hamming_matrix_xla", "hamming2_matrix_mxu",
    "hamming2_matrix_xla"])
def test_distance_matrices_equal(rng, name):
    a, b = _desc(rng, 50), _desc(rng, 70)
    b[:5] = a[:5]                       # some zero distances
    b[5, 0] ^= np.uint32(1 << 31)       # a sign-bit difference
    j = np.asarray(getattr(jham, name)(jnp.asarray(a), jnp.asarray(b)))
    t = getattr(tham, name)(_t(a), _t(b)).numpy()
    np.testing.assert_array_equal(t, j)
    # batched leading dims
    tb = getattr(tham, name)(_t(a)[None].repeat(2, 1, 1),
                             _t(b)[None].repeat(2, 1, 1)).numpy()
    np.testing.assert_array_equal(tb[1], j)


@pytest.mark.parametrize("wta_k,use_mxu", [(2, True), (2, False), (3, True),
                                           (4, False)])
def test_distance_dispatch(rng, wta_k, use_mxu):
    a, b = _desc(rng, 30), _desc(rng, 20)
    j = np.asarray(jham.distance_matrix(jnp.asarray(a), jnp.asarray(b),
                                        use_mxu, wta_k))
    t = tham.distance_matrix(_t(a), _t(b), use_mxu, wta_k).numpy()
    np.testing.assert_array_equal(t, j)


def test_unpack_bits(rng):
    a = _desc(rng, 7)
    np.testing.assert_array_equal(
        tham.unpack_bits_pm1(_t(a), torch.float32).numpy(),
        np.asarray(jham.unpack_bits_pm1(jnp.asarray(a), jnp.float32)))
    np.testing.assert_array_equal(
        tham.unpack_cells_onehot(_t(a), torch.float32).numpy(),
        np.asarray(jham.unpack_cells_onehot(jnp.asarray(a), jnp.float32)))


@pytest.mark.parametrize("mutual", [True, False])
def test_nnr_mutual_match(rng, mutual):
    # small integer distances: many ties exercise the first-index argmin
    dist = rng.integers(0, 12, (3, 60, 45)).astype(np.int32)
    cand = rng.random((3, 60, 45)) < 0.6
    cand[:, 7] = False                  # a row with no candidate
    t = tmat.nnr_mutual_match(torch.from_numpy(dist), torch.from_numpy(cand),
                              0.8, mutual=mutual)
    for b in range(3):
        j = jmat.nnr_mutual_match(jnp.asarray(dist[b]), jnp.asarray(cand[b]),
                                  0.8, mutual=mutual)
        np.testing.assert_array_equal(t.idx[b].numpy(), np.asarray(j.idx))
        np.testing.assert_array_equal(t.valid[b].numpy(), np.asarray(j.valid))


def test_window_masks(rng):
    W, H = 240.0, 180.0
    inv_w, inv_h = 64 / W, 48 / H
    uv1 = rng.uniform([0, 0], [W, H], (2, 80, 2)).astype(np.float32)
    uv2 = uv1 + rng.normal(0, [8, 2], (2, 80, 2)).astype(np.float32)
    for jf, tf, ws in ((jmat.stereo_point_window_mask,
                        tmat.stereo_point_window_mask, 10),
                       (jmat.f2f_point_window_mask,
                        tmat.f2f_point_window_mask, 3)):
        t = tf(torch.from_numpy(uv1), torch.from_numpy(uv2), inv_w, inv_h,
               ws).numpy()
        for b in range(2):
            j = np.asarray(jf(jnp.asarray(uv1[b]), jnp.asarray(uv2[b]),
                              inv_w, inv_h, ws))
            np.testing.assert_array_equal(t[b], j)
            assert j.any() and not j.all()

    sp_l, ep_l, sp_r, ep_r = (rng.uniform([0, 0], [W, H], (30, 2)).astype(
        np.float32) for _ in range(4))
    np.testing.assert_array_equal(
        tmat.stereo_line_window_mask(
            *[torch.from_numpy(x) for x in (sp_l, ep_l, sp_r, ep_r)],
            inv_w, inv_h, 4).numpy(),
        np.asarray(jmat.stereo_line_window_mask(
            *[jnp.asarray(x) for x in (sp_l, ep_l, sp_r, ep_r)],
            inv_w, inv_h, 4)))
    np.testing.assert_allclose(
        tmat.point_seg_dist2(torch.from_numpy(sp_l), torch.from_numpy(sp_r),
                             torch.from_numpy(ep_r)).numpy(),
        np.asarray(jmat.point_seg_dist2(jnp.asarray(sp_l),
                                        jnp.asarray(sp_r),
                                        jnp.asarray(ep_r))), rtol=1e-5,
        atol=1e-3)
    d1 = rng.normal(size=(20, 2)).astype(np.float32)
    d1 /= np.linalg.norm(d1, axis=-1, keepdims=True)
    d2 = np.roll(d1, 3, axis=0)
    np.testing.assert_array_equal(
        tmat.line_direction_mask(torch.from_numpy(d1), torch.from_numpy(d2),
                                 0.75).numpy(),
        np.asarray(jmat.line_direction_mask(jnp.asarray(d1),
                                            jnp.asarray(d2), 0.75)))
