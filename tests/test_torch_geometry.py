"""se3, camera, linalg and robust of the port against the JAX package on
the same seeded numpy inputs (the cases of test_se3.py, test_camera.py
and test_robust.py).

Tolerances: both packages compute in float32 with different summation
orders and transcendental implementations, so results agree to a few
float32 ulps of the quantity (atol 1e-5 on unit-scale rotations and
transforms, rtol 1e-4 on covariances and inverses of well-conditioned
matrices).  Flags (ok, finite, -inf) must agree exactly."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from stvo_pl_tpu.ops import camera as jcam
from stvo_pl_tpu.ops import linalg as jlin
from stvo_pl_tpu.ops import robust as jrob
from stvo_pl_tpu.ops import se3 as jse3
from stvo_pl_tpu_torch.ops import camera as tcam
from stvo_pl_tpu_torch.ops import linalg as tlin
from stvo_pl_tpu_torch.ops import robust as trob
from stvo_pl_tpu_torch.ops import se3 as tse3

torch.set_num_threads(1)


def _j(f, *a):
    return np.asarray(f(*[jnp.asarray(x) for x in a]))


def _t(f, *a):
    out = f(*[torch.from_numpy(np.array(x, copy=True)) for x in a])
    return out.numpy()


def twists(rng, n, t_scale=1.0, w_scale=1.0):
    x = rng.standard_normal((n, 6)).astype(np.float32)
    x[:, :3] *= t_scale
    x[:, 3:] *= w_scale
    return x


@pytest.mark.parametrize("w_scale", [1e-6, 0.3, 0.8, 2.0])
def test_exp_log_inverse_adjoint(rng, w_scale):
    x = twists(rng, 64, 2.0, w_scale)
    T = _j(jse3.expmap_se3, x)
    np.testing.assert_allclose(_t(tse3.expmap_se3, x), T, atol=2e-5)
    np.testing.assert_allclose(_t(tse3.logmap_se3, T),
                               _j(jse3.logmap_se3, T), atol=5e-4, rtol=1e-3)
    np.testing.assert_allclose(_t(tse3.inverse_se3, T),
                               _j(jse3.inverse_se3, T), atol=2e-5)
    np.testing.assert_allclose(_t(tse3.adjoint_se3, T),
                               _j(jse3.adjoint_se3, T), atol=2e-5)
    np.testing.assert_allclose(_t(tse3.renormalize_se3, T),
                               _j(jse3.renormalize_se3, T), atol=5e-4)


@pytest.mark.parametrize("w_scale", [1e-6, 0.3, 2.0])
def test_so3_exp(rng, w_scale):
    w = twists(rng, 64, 1.0, w_scale)[:, 3:]
    R = _t(tse3.so3_exp, w)
    np.testing.assert_allclose(R, _j(jse3.so3_exp, w), rtol=0, atol=1e-6)
    np.testing.assert_allclose(R, _t(tse3.expmap_se3, np.concatenate(
        [np.zeros_like(w), w], axis=-1))[:, :3, :3], rtol=0, atol=1e-6)


def test_log_near_pi(rng):
    axes = rng.standard_normal((16, 3))
    axes /= np.linalg.norm(axes, axis=-1, keepdims=True)
    x = np.concatenate([np.zeros((16, 3)), axes * (np.pi - 1e-3)],
                       -1).astype(np.float32)
    T = _j(jse3.expmap_se3, x)
    # exp(log(T)) is the invariant (the axis sign may flip at pi)
    R_t = _t(tse3.expmap_se3, _t(tse3.logmap_se3, T))
    np.testing.assert_allclose(R_t, T, atol=2e-3)


def test_covariance_propagation_and_transform(rng):
    x = twists(rng, 16, 1.0, 0.5)
    T = _j(jse3.expmap_se3, x)
    A = rng.standard_normal((16, 6, 6)).astype(np.float32)
    cov = (A @ A.transpose(0, 2, 1) * 0.01).astype(np.float32)
    np.testing.assert_allclose(_t(tse3.uncTinv_se3, T, cov),
                               _j(jse3.uncTinv_se3, T, cov),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(_t(tse3.unccomp_se3, T, cov, cov),
                               _j(jse3.unccomp_se3, T, cov, cov),
                               rtol=1e-4, atol=1e-5)
    P = rng.uniform(-5, 5, (16, 40, 3)).astype(np.float32)
    np.testing.assert_allclose(_t(tse3.transform_points, T, P),
                               _j(jse3.transform_points, T, P), atol=1e-4)
    bad = T.copy()
    bad[3, 0, 0] = np.nan
    assert (_t(tse3.is_finite_mat, bad) == _j(jse3.is_finite_mat, bad)).all()


def test_camera_project_back_project(rng):
    cam_j = jcam.StereoCamera(fx=718.856, fy=718.856, cx=607.19, cy=185.21,
                              b=0.5371, width=1226, height=370)
    cam_t = tcam.StereoCamera(*cam_j)
    uv = rng.uniform([0, 0], [1226, 370], (100, 2)).astype(np.float32)
    disp = rng.uniform(1.0, 100.0, 100).astype(np.float32)
    P_j = np.asarray(jcam.back_project(cam_j, jnp.asarray(uv),
                                       jnp.asarray(disp)))
    P_t = tcam.back_project(cam_t, torch.from_numpy(uv),
                            torch.from_numpy(disp)).numpy()
    np.testing.assert_allclose(P_t, P_j, rtol=1e-6)
    np.testing.assert_allclose(
        tcam.project(cam_t, torch.from_numpy(P_j)).numpy(),
        np.asarray(jcam.project(cam_j, jnp.asarray(P_j))), rtol=1e-6)
    assert cam_t.bfx == cam_j.bfx


def _spd(rng, n, cond=1e3):
    Q, _ = np.linalg.qr(rng.standard_normal((n, 6, 6)))
    ev = np.exp(rng.uniform(0, np.log(cond), (n, 6)))
    return (Q * ev[:, None, :]) @ Q.transpose(0, 2, 1)


def test_solve_inv_on_spd(rng):
    H = (_spd(rng, 32) * 10.0).astype(np.float32)
    g = rng.standard_normal((32, 6)).astype(np.float32)
    xj, okj = jax.vmap(jlin.solve6)(jnp.asarray(H), jnp.asarray(g))
    xt, okt = tlin.solve6(torch.from_numpy(H), torch.from_numpy(g))
    assert (okt.numpy() == np.asarray(okj)).all() and okt.all()
    np.testing.assert_allclose(xt.numpy(), np.asarray(xj), rtol=2e-3,
                               atol=1e-5)
    np.testing.assert_allclose(_t(tlin.inv6, H), _j(jax.vmap(jlin.inv6), H),
                               rtol=2e-3, atol=1e-6)


def test_solve_failure_flags_agree(rng):
    good = (_spd(rng, 4) * 10.0).astype(np.float32)
    cases = np.stack([
        good[0],
        np.zeros((6, 6), np.float32),                        # singular
        np.diag([1, 1, 1, 1, 1, -1]).astype(np.float32),     # indefinite
        np.full((6, 6), np.nan, np.float32),                 # non-finite
        (good[1] * 1e-3).astype(np.float32),                 # logdet < 0
        good[2],
    ])
    g = np.ones((len(cases), 6), np.float32)
    xj, okj = jax.vmap(jlin.solve6)(jnp.asarray(cases), jnp.asarray(g))
    xt, okt = tlin.solve6(torch.from_numpy(cases), torch.from_numpy(g))
    np.testing.assert_array_equal(okt.numpy(), np.asarray(okj))
    np.testing.assert_array_equal(okt.numpy(),
                                  [True, False, False, False, False, True])
    assert (xt.numpy()[~okt.numpy()] == 0).all()
    # inverses where the factorization clearly succeeds or fails (the
    # zero and 1e-3-scaled matrices factor with jitter-sized pivots whose
    # inverses overflow float32 in either package)
    pick = [0, 2, 3, 5]
    inv_j = _j(jax.vmap(jlin.inv6), cases[pick])
    inv_t = _t(tlin.inv6, cases[pick])
    np.testing.assert_allclose(inv_t, inv_j, rtol=2e-3, atol=1e-6)
    np.testing.assert_array_equal(inv_t[1:3], 0.0)


def _assert_eig_close(t, j):
    # LAPACK's float32 syevd is accurate to ~eps * ||M|| per eigenvalue;
    # the port's Jacobi runs in float64, so the difference is LAPACK's
    # error: allow 5e-6 * max|eig| (~40 float32 ulps of the norm)
    tol = 5e-6 * np.abs(j).max(-1, keepdims=True)
    assert np.all(np.abs(t - j) <= tol), np.abs(t - j).max()


def test_eigvalsh_logdet(rng):
    M = _spd(rng, 32, cond=1e4).astype(np.float32) * 0.1
    _assert_eig_close(_t(tlin.eigvalsh6, M), _j(jlin.eigvalsh6, M))
    np.testing.assert_allclose(_t(tlin.logdet6, M), _j(jlin.logdet6, M),
                               rtol=1e-4, atol=1e-4)
    S = rng.standard_normal((8, 6, 6)).astype(np.float32)
    S = S + S.transpose(0, 2, 1)
    _assert_eig_close(_t(tlin.eigvalsh6, S), _j(jlin.eigvalsh6, S))
    singular = np.stack([np.zeros((6, 6)), -np.eye(6), np.eye(6),
                         np.diag([1, 2, 3, 4, 5, 0])]).astype(np.float32)
    np.testing.assert_array_equal(_t(tlin.logdet6, singular),
                                  _j(jlin.logdet6, singular))


@pytest.mark.parametrize("n", [1, 2, 5, 17, 100])
def test_masked_statistics(rng, n):
    v = rng.standard_normal(n).astype(np.float32)
    x = np.concatenate([v, np.full(16, 1e9, np.float32)])
    mask = np.concatenate([np.ones(n, bool), np.zeros(16, bool)])
    perm = rng.permutation(len(x))
    x, mask = x[perm], mask[perm]
    for jf, tf in ((jrob.masked_median, trob.masked_median),
                   (jrob.masked_stdv_mad, trob.masked_stdv_mad),
                   (jrob.masked_mean, trob.masked_mean)):
        np.testing.assert_allclose(_t(tf, x, mask), _j(jf, x, mask),
                                   rtol=1e-6)
    mj, sj = jrob.masked_mean_stdv_mad(jnp.asarray(x), jnp.asarray(mask))
    mt, st = trob.masked_mean_stdv_mad(torch.from_numpy(x),
                                       torch.from_numpy(mask))
    np.testing.assert_allclose([float(mt), float(st)],
                               [float(mj), float(sj)], rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("kernel", ["cauchy", "parabola", "tukey", "huber",
                                    "welsch", "tstudent"])
def test_robust_weights(kernel):
    r = np.linspace(0.0, 4.0, 41).astype(np.float32)
    np.testing.assert_allclose(
        trob.robust_weight(torch.from_numpy(r), kernel).numpy(),
        np.asarray(jrob.robust_weight(jnp.asarray(r), kernel)), rtol=1e-6)
