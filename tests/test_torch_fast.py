"""FAST detection of the port, holding kernel B1's plain version.

`fast_pack_plain` (the twin of csrc/fast_pack.cu) must be bit-equal to
the JAX package's Pallas kernel `_fast_pack_pallas`, run in interpret mode
on the CPU; `select_from_packed` must be bit-equal to JAX's on the CPU
(where approx_max_k is exact).  The dense twin path (Harris ranking,
small images) must match JAX's dense path."""

import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from stvo_pl_tpu.ops import camera as jcam
from stvo_pl_tpu.ops import fast as jfast
from stvo_pl_tpu.utils import synthetic as jsyn
from stvo_pl_tpu_torch.ops import fast as tfast
from stvo_pl_tpu_torch.ops import fast_kernel as tfk

torch.set_num_threads(1)

EDGE = 19


@pytest.fixture
def pallas_fast(monkeypatch):
    """stvo_pl_tpu's _fast_pack_pallas with pallas_call in interpret mode
    (patched for this test only)."""
    from jax.experimental import pallas as pl
    monkeypatch.setattr(pl, "pallas_call",
                        functools.partial(pl.pallas_call, interpret=True))
    from stvo_pl_tpu.ops import fast_kernel as jfk
    return jfk


def _rendered(n=2):
    cam = jcam.StereoCamera(fx=160.0, fy=160.0, cx=120.0, cy=90.0, b=0.3,
                            width=240, height=180)
    scene = jsyn.make_scene(jax.random.PRNGKey(3), n_points=260,
                            n_lines=24, extent=(14.0, 8.0, 40.0), z_near=3.0)
    poses = jsyn.smooth_trajectory(n, speed=0.25)
    left, right = jsyn.render_sequence(scene, poses, cam)
    return np.concatenate([np.asarray(left), np.asarray(right)])[:n]


def _inputs(kind, rng):
    if kind == "rendered":
        return _rendered()
    if kind == "h_not_mult_40":
        return (rng.random((2, 97, 150)) * 255).astype(np.float32)
    if kind == "w_mult_128":
        return (rng.random((1, 80, 256)) * 255).astype(np.float32)
    raise ValueError(kind)


@pytest.mark.parametrize("kind", ["rendered", "h_not_mult_40", "w_mult_128"])
def test_fast_pack_plain_bit_equal_to_pallas(pallas_fast, rng, kind):
    img = _inputs(kind, rng)
    ref = np.asarray(pallas_fast._fast_pack_pallas(jnp.asarray(img), EDGE))
    out = tfk.fast_pack(torch.from_numpy(img), EDGE).numpy()
    assert out.shape == ref.shape == (img.shape[0],) + tfk.packed_shape(
        *img.shape[1:])
    np.testing.assert_array_equal(out, ref)
    assert (ref > 0).sum() > 50, "the input must produce corners"

    # selection glue, per-image thresholds, bit for bit (uv, score, valid)
    th = np.array([20.0, 35.0][:img.shape[0]], np.float32)
    cap = 120
    tuv, tsc, tval = tfk.select_from_packed(torch.from_numpy(out), cap,
                                            torch.from_numpy(th))
    for i in range(img.shape[0]):
        juv, jsc, jval = pallas_fast.select_from_packed(
            jnp.asarray(ref[i]), cap, jnp.float32(th[i]))
        np.testing.assert_array_equal(tuv[i].numpy(), np.asarray(juv))
        np.testing.assert_array_equal(tsc[i].numpy(), np.asarray(jsc))
        np.testing.assert_array_equal(tval[i].numpy(), np.asarray(jval))
    tuv0, _, _ = tfk.select_from_packed(torch.from_numpy(out), cap,
                                        torch.from_numpy(th), subpix=False)
    juv0, _, _ = pallas_fast.select_from_packed(
        jnp.asarray(ref[0]), cap, jnp.float32(th[0]), subpix=False)
    np.testing.assert_array_equal(tuv0[0].numpy(), np.asarray(juv0))


def test_select_pads_to_capacity(pallas_fast, rng):
    img = (rng.random((1, 64, 64)) * 255).astype(np.float32)
    ref = np.asarray(pallas_fast._fast_pack_pallas(jnp.asarray(img), EDGE))
    cap = 2000      # more than the number of 4x4 cells
    tuv, tsc, tval = tfk.select_from_packed(torch.from_numpy(ref), cap, 20.0)
    juv, jsc, jval = pallas_fast.select_from_packed(jnp.asarray(ref[0]), cap,
                                                    jnp.float32(20.0))
    assert tuv.shape == (1, cap, 2)
    np.testing.assert_array_equal(tval[0].numpy(), np.asarray(jval))
    # beyond the valid corners the cells hold the word 0, and the order
    # among those ties is the sort's own; nothing reads them
    v = np.asarray(jval)
    assert v.sum() > 20
    np.testing.assert_array_equal(tuv[0].numpy()[v], np.asarray(juv)[v])
    np.testing.assert_array_equal(tsc[0].numpy()[v], np.asarray(jsc)[v])


def test_fast_score_equal(rng):
    img = (rng.random((2, 60, 80)) * 255).astype(np.float32)
    th = np.array([10.0, 30.0], np.float32)
    t = tfast.fast_score(torch.from_numpy(img), torch.from_numpy(th)).numpy()
    for i in range(2):
        j = np.asarray(jfast.fast_score(jnp.asarray(img[i]),
                                        jnp.float32(th[i])))
        np.testing.assert_array_equal(t[i], j)


@pytest.mark.parametrize("score_type,shape", [(0, (2, 120, 160)),
                                              (1, (2, 60, 62))])
def test_dense_twin_path_matches_jax(rng, score_type, shape):
    """Harris ranking (any size) and FAST ranking below the kernel's 64 px
    gate take the dense path, as in the JAX package.  Harris scores are
    products of sums in float32: compared to a relative 1e-5."""
    img = _rendered()[:, :shape[1], :shape[2]] if shape[1] > 64 else \
        (rng.random(shape) * 255).astype(np.float32)
    th = np.array([20.0, 25.0], np.float32)
    cap = 80
    tuv, tsc, tval = tfast.detect_keypoints(
        torch.from_numpy(np.ascontiguousarray(img)), torch.from_numpy(th),
        cap, edge=EDGE, score_type=score_type)
    for i in range(2):
        juv, jsc, jval = jfast.detect_keypoints(
            jnp.asarray(img[i]), jnp.float32(th[i]), cap, edge=EDGE,
            score_type=score_type)
        np.testing.assert_array_equal(tval[i].numpy(), np.asarray(jval))
        np.testing.assert_allclose(tuv[i].numpy(), np.asarray(juv), atol=1e-5)
        np.testing.assert_allclose(tsc[i].numpy(), np.asarray(jsc),
                                   rtol=1e-5)
