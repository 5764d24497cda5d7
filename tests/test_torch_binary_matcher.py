"""The binary-descriptor matcher of the port (ops/binary_matcher.py) and
its XOR + popcount distances (ops/hamming.py) against the JAX package on
identical numpy descriptors.

Every output is an integer and must be equal: the five cases of
tests/test_binary_matcher.py, with `use_mxu` both ways (on the CPU the
popcount path is the plain version of the CUDA kernel).  The plain
popcount matrix is also held bit-equal to the Pallas kernel
`hamming_matrix_pallas` in interpret mode at sizes its tiling takes, and
to numpy at sizes it does not."""

import functools

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from stvo_pl_tpu.ops import binary_matcher as jbm
from stvo_pl_tpu.ops import hamming as jham
from stvo_pl_tpu_torch import convert
from stvo_pl_tpu_torch.ops import binary_matcher as tbm
from stvo_pl_tpu_torch.ops import hamming as tham

torch.set_num_threads(1)


def _rand_desc(rng, n):
    return rng.integers(0, 2 ** 32, (n, 8), dtype=np.uint64).astype(np.uint32)


def _oracle_dist(q, d):
    x = q[..., :, None, :] ^ d[..., None, :, :]
    return np.unpackbits(np.ascontiguousarray(x).view(np.uint8),
                         axis=-1).sum(-1).astype(np.int32)


def _t(a):
    a = np.asarray(a)
    return torch.from_numpy(a.view(np.int32) if a.dtype == np.uint32 else a)


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(7)
    imgs = [_rand_desc(rng, n) for n in (40, 25, 60)]
    # image 1 has some invalid rows
    valids = [np.ones(40, bool), np.arange(25) < 20, np.ones(60, bool)]
    q = _rand_desc(rng, 30)
    # exact duplicates, so that matches at distance 0 exist, and near
    # duplicates, so that distances tie
    q[3] = imgs[0][7]
    q[11] = imgs[2][42]
    imgs[2][5] = imgs[0][9]
    q[20] = imgs[0][9]
    q[20, 0] ^= np.uint32(1)
    j_idx = jbm.build_index([jnp.asarray(d) for d in imgs],
                            [jnp.asarray(v) for v in valids])
    t_idx = tbm.build_index([_t(d) for d in imgs], [_t(v) for v in valids])
    return q, j_idx, t_idx


def _same(t_res, j_res):
    for f in tbm.KnnMatches._fields:
        np.testing.assert_array_equal(getattr(t_res, f).numpy(),
                                      np.asarray(getattr(j_res, f)), f)


def test_index_layout(setup):
    q, j_idx, t_idx = setup
    assert t_idx.desc.dtype == torch.int32
    for f in tbm.DescriptorIndex._fields:
        a = getattr(t_idx, f).numpy()
        b = np.asarray(getattr(j_idx, f))
        np.testing.assert_array_equal(a.view(b.dtype) if f == "desc" else a,
                                      b)
    assert int(t_idx.valid.sum()) == 40 + 20 + 60
    assert int(t_idx.local_id[40]) == 0 and int(t_idx.image_id[40]) == 1
    # padded capacity, a capacity that is too small, the numpy round trip
    padded = tbm.build_index([t_idx.desc[:40], t_idx.desc[40:65]],
                             capacity=80)
    assert padded.desc.shape == (80, 8) and int(padded.valid.sum()) == 65
    assert int(padded.image_id[70]) == -1
    with pytest.raises(ValueError, match="capacity"):
        tbm.build_index([t_idx.desc], capacity=10)
    back = convert.index_to_numpy(t_idx)
    assert back.desc.dtype == np.uint32
    again = convert.index_from_numpy(back, device="cpu")
    for a, b in zip(again, t_idx):
        assert a.dtype == b.dtype and torch.equal(a, b)
    from_jax = convert.index_from_numpy(
        jbm.DescriptorIndex(*[np.asarray(x) for x in j_idx]), device="cpu")
    for a, b in zip(from_jax, t_idx):
        assert torch.equal(a, b)


@pytest.mark.parametrize("use_mxu", [True, False])
def test_match_best(setup, use_mxu):
    q, j_idx, t_idx = setup
    res = tbm.match(_t(q), t_idx, use_mxu=use_mxu)
    _same(res, jbm.match(jnp.asarray(q), j_idx, use_mxu=use_mxu))
    assert int(res.dist[3, 0]) == 0 and int(res.dist[11, 0]) == 0
    assert int(res.idx[3, 0]) == 7 and int(res.image_id[11, 0]) == 2
    # the lower index wins the tie between the two copies
    assert int(res.dist[20, 0]) == 1 and int(res.idx[20, 0]) == 9


@pytest.mark.parametrize("use_mxu", [True, False])
def test_knn_distances_sorted_and_exact(setup, use_mxu):
    q, j_idx, t_idx = setup
    k = 5
    res = tbm.knn_match(_t(q), t_idx, k, use_mxu=use_mxu)
    _same(res, jbm.knn_match(jnp.asarray(q), j_idx, k, use_mxu=use_mxu))
    d = res.dist.numpy()
    assert (np.diff(d, axis=1) >= 0).all()
    od = _oracle_dist(q, np.asarray(j_idx.desc))
    od[:, ~np.asarray(j_idx.valid)] = 10 ** 6
    np.testing.assert_array_equal(d, np.sort(od, axis=1)[:, :k])
    assert res.idx.numpy()[20, :2].tolist() == [9, 70]
    with pytest.raises(ValueError, match="k="):
        tbm.knn_match(_t(q), t_idx, 0)


@pytest.mark.parametrize("use_mxu", [True, False])
def test_radius(setup, use_mxu):
    q, j_idx, t_idx = setup
    r, cap = 100, 8
    res = tbm.radius_match(_t(q), t_idx, max_distance=r, max_results=cap,
                           use_mxu=use_mxu)
    _same(res, jbm.radius_match(jnp.asarray(q), j_idx, max_distance=r,
                                max_results=cap, use_mxu=use_mxu))
    got = res.dist.numpy()
    assert (res.idx.numpy()[got > r] == -1).all()
    assert (got[got > r] == tbm.INVALID_DIST).all()
    assert ((got <= r).sum(axis=1) >= 1)[[3, 11, 20]].all()
    assert int(tbm.INVALID_DIST) == int(jbm.INVALID_DIST)


@pytest.mark.parametrize("use_mxu", [True, False])
def test_query_mask(setup, use_mxu):
    q, j_idx, t_idx = setup
    qv = np.arange(q.shape[0]) % 2 == 0
    res = tbm.match(_t(q), t_idx, q_valid=_t(qv), use_mxu=use_mxu)
    _same(res, jbm.match(jnp.asarray(q), j_idx, q_valid=jnp.asarray(qv),
                         use_mxu=use_mxu))
    assert (res.idx.numpy()[~qv, 0] == -1).all()
    assert (res.idx.numpy()[qv, 0] >= 0).all()


@pytest.fixture
def pallas_interpret(monkeypatch):
    from jax.experimental import pallas as pl
    monkeypatch.setattr(pl, "pallas_call",
                        functools.partial(pl.pallas_call, interpret=True))


@pytest.mark.parametrize("n,m", [(256, 256), (512, 768)])
def test_popcount_matrix_bit_equal_to_pallas(pallas_interpret, rng, n, m):
    d1, d2 = _rand_desc(rng, n), _rand_desc(rng, m)
    d2[:5] = d1[:5]
    ref = np.asarray(jham.hamming_matrix_pallas(jnp.asarray(d1),
                                                jnp.asarray(d2)))
    for fn in (tham.hamming_matrix_popc, tham.hamming_matrix_xla,
               functools.partial(tham.hamming_matrix, use_mxu=False)):
        out = fn(_t(d1), _t(d2))
        assert out.dtype == torch.int32
        np.testing.assert_array_equal(out.numpy(), ref)
    assert ref[0, 0] == 0 and ref.max() > 140


@pytest.mark.parametrize("shape1,shape2", [((300, 8), (257, 8)),
                                           ((1, 8), (3, 8)),
                                           ((2, 33, 8), (2, 65, 8)),
                                           ((3, 1, 17, 8), (2, 9, 8))])
def test_popcount_matrix_any_size_against_numpy(rng, shape1, shape2):
    """Sizes the Pallas tiling does not take, and leading batch dims that
    broadcast."""
    d1 = rng.integers(0, 2 ** 32, shape1, dtype=np.uint64).astype(np.uint32)
    d2 = rng.integers(0, 2 ** 32, shape2, dtype=np.uint64).astype(np.uint32)
    ref = _oracle_dist(d1, d2)
    out = tham.hamming_matrix_popc(_t(d1), _t(d2))
    assert out.shape == ref.shape
    np.testing.assert_array_equal(out.numpy(), ref)
    np.testing.assert_array_equal(tham.hamming_matrix_mxu(_t(d1),
                                                          _t(d2)).numpy(), ref)
    with pytest.raises(ValueError, match="int32"):
        tham.hamming_matrix_popc(_t(d1).long(), _t(d2))
    with pytest.raises(ValueError, match="int32"):
        tham.hamming_matrix_popc(_t(d1)[..., :4], _t(d2))
