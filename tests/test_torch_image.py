"""Image primitives of the port against the JAX package on the CPU: the
numpy operator builders give equal arrays; blur, Sobel and the pyramid
agree within float32 rounding.

Tolerances: blur and Sobel are the same taps in the same order, so they
agree to 1 float32 ulp of 255 (atol 3e-5); the pyramid levels are float32
matrix products whose sums run in another order (atol 1e-3 on 0..255
intensities, ~20 ulps).  The cascade pyramid (`build_pyramid`: blur, then
resample, level by level) agrees within 6e-5, 4 ulps of 255: the blur's
FMA rounding (3e-5, XLA contracts its multiply-adds) carried through the
resample products (4.6e-5 seen)."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from stvo_pl_tpu.ops import image as jimg
from stvo_pl_tpu_torch.ops import image as timg

torch.set_num_threads(1)


@pytest.mark.parametrize("sigma,radius", [(0.6, None), (2.0, 3), (1.2, 5)])
def test_gaussian_kernel_equal(sigma, radius):
    np.testing.assert_array_equal(timg.gaussian_kernel1d(sigma, radius),
                                  jimg.gaussian_kernel1d(sigma, radius))


@pytest.mark.parametrize("n_in,n_out,sigma", [
    (180, 150, 0.6), (240, 200, 0.0), (370, 308, 0.6), (90, 180, 0.0),
    (1226, 1022, 0.6)])
def test_resample_matrix_equal(n_in, n_out, sigma):
    np.testing.assert_array_equal(timg._resample_matrix(n_in, n_out, sigma),
                                  jimg._resample_matrix(n_in, n_out, sigma))


@pytest.mark.parametrize("H,W,levels", [(180, 240, 2), (370, 1226, 4)])
def test_pyramid_matrices_equal(H, W, levels):
    t = timg._pyramid_matrices(H, W, levels, 1.2, 0.6)
    j = jimg._pyramid_matrices(H, W, levels, 1.2, 0.6)
    assert len(t) == len(j) == levels - 1
    for (tMy, tMx), (jMy, jMx) in zip(t, j):
        np.testing.assert_array_equal(tMy, jMy)
        np.testing.assert_array_equal(tMx, jMx)


def _imgs(rng, shape=(2, 90, 130)):
    return (rng.random(shape) * 255).astype(np.float32)


def test_blur_and_sobel(rng):
    x = _imgs(rng)
    for sigma, radius in ((2.0, 3), (0.6, None)):
        np.testing.assert_allclose(
            timg.gaussian_blur(torch.from_numpy(x), sigma, radius).numpy(),
            np.asarray(jimg.gaussian_blur(jnp.asarray(x), sigma, radius)),
            rtol=0, atol=3e-5)
    tgx, tgy = timg.sobel(torch.from_numpy(x))
    jgx, jgy = jimg.sobel(jnp.asarray(x))
    np.testing.assert_allclose(tgx.numpy(), np.asarray(jgx), atol=3e-5)
    np.testing.assert_allclose(tgy.numpy(), np.asarray(jgy), atol=3e-5)
    np.testing.assert_allclose(
        timg.box_filter(torch.from_numpy(x), 3).numpy(),
        np.asarray(jimg.box_filter(jnp.asarray(x), 3)), atol=3e-5)
    np.testing.assert_array_equal(timg.maxpool3(torch.from_numpy(x)).numpy(),
                                  np.asarray(jimg.maxpool3(jnp.asarray(x))))


def test_pyramid_and_resize(rng):
    x = _imgs(rng, (2, 180, 240))
    t = timg.pyramid_levels(torch.from_numpy(x), 3, 1.2, 0.6)
    j = jimg.pyramid_levels(jnp.asarray(x), 3, 1.2, 0.6)
    assert [tuple(a.shape) for a in t] == [tuple(a.shape) for a in j]
    for a, b in zip(t, j):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-3)
    np.testing.assert_allclose(
        timg.resize_bilinear(torch.from_numpy(x), 90, 120, 1.0).numpy(),
        np.asarray(jimg.resize_bilinear(jnp.asarray(x), 90, 120, 1.0)),
        atol=1e-3)


@pytest.mark.parametrize("n_levels,scale", [(3, 1.2), (4, 1.5), (2, 2.0)])
def test_build_pyramid_cascade(rng, n_levels, scale):
    x = _imgs(rng, (2, 90, 130))
    t = timg.build_pyramid(torch.from_numpy(x), n_levels, scale)
    j = jimg.build_pyramid(jnp.asarray(x), n_levels, scale)
    assert [tuple(a.shape) for a in t] == [tuple(a.shape) for a in j]
    assert len(t) == n_levels
    np.testing.assert_array_equal(t[0].numpy(), x)
    for a, b in zip(t, j):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=6e-5)
