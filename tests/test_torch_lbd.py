"""The line band descriptor of the port (ops/lbd.py) against the JAX
package: the numpy tables equal, and for identical gradients and
endpoints the 256 descriptor bits equal and the 72 floats to 1e-5 (the
band fold is a 7-term float32 product and the statistics 8..16-term
sums, taken in another order by the two frameworks)."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from stvo_pl_tpu.ops import image as jimage
from stvo_pl_tpu.ops import lbd as jlbd
from stvo_pl_tpu_torch.ops import lbd as tlbd

torch.set_num_threads(1)


def _lines(rng, K, W, H):
    """K segments of 5..80 px inside (and a few reaching over) the image."""
    c = rng.random((K, 2)) * np.array([W, H])
    th = rng.random(K) * 2 * np.pi
    half = (2.5 + rng.random(K) * 38)[:, None] * np.stack(
        [np.cos(th), np.sin(th)], axis=1)
    return (c - half).astype(np.float32), (c + half).astype(np.float32)


@pytest.fixture(scope="module")
def gradients():
    """Sobel gradients of two textured 180x240 images (smoothed uniform
    noise: every tap of every line sees structure.  On flat ground the
    std half of the descriptor is rounding noise divided by its own norm,
    which no two implementations share)."""
    rng = np.random.default_rng(11)
    imgs = (rng.random((2, 180, 240)) * 255).astype(np.float32)
    g = [jimage.sobel(jimage.gaussian_blur(jnp.asarray(im), 1.5))
         for im in imgs]
    return (np.stack([np.asarray(a[0]) for a in g]),
            np.stack([np.asarray(a[1]) for a in g]))


def test_tables_equal():
    np.testing.assert_array_equal(tlbd._BAND_A, np.asarray(jlbd._BAND_A))
    np.testing.assert_array_equal(tlbd._PAIRS, np.asarray(jlbd._PAIRS))
    np.testing.assert_array_equal(tlbd._TAP_OFF, jlbd._TAP_OFF)
    assert (tlbd.N_BANDS, tlbd.N_SAMPLES, tlbd.N_TAPS, tlbd.DESC_F) == (
        jlbd.N_BANDS, jlbd.N_SAMPLES, jlbd.N_TAPS, jlbd.DESC_F)


def _bits_differ(desc_t: torch.Tensor, desc_j) -> int:
    x = desc_t.numpy().view(np.uint32) ^ np.asarray(desc_j)
    return int(np.unpackbits(x.view(np.uint8)).sum())


@pytest.mark.parametrize("n_samples", [8, 16])
def test_compute_lbd(gradients, rng, n_samples):
    gx, gy = gradients
    N, H, W = gx.shape
    K = 60
    ends = [_lines(rng, K, W, H) for _ in range(N)]
    sp = np.stack([e[0] for e in ends])
    ep = np.stack([e[1] for e in ends])
    f_t, b_t = tlbd.compute_lbd(torch.from_numpy(gx), torch.from_numpy(gy),
                                torch.from_numpy(sp), torch.from_numpy(ep),
                                n_samples=n_samples)
    assert f_t.shape == (N, K, 72) and b_t.shape == (N, K, 8)
    assert b_t.dtype == torch.int32
    for i in range(N):
        f_j, b_j = jlbd.compute_lbd(jnp.asarray(gx[i]), jnp.asarray(gy[i]),
                                    jnp.asarray(sp[i]), jnp.asarray(ep[i]),
                                    n_samples=n_samples)
        np.testing.assert_allclose(f_t[i].numpy(), np.asarray(f_j), atol=1e-5)
        assert _bits_differ(b_t[i], b_j) == 0
    assert len({tuple(r) for r in b_t[0].tolist()}) > K // 2


def test_compute_lbd_atlas(gradients, rng):
    """Two regions of one atlas: each line reads its own region, clipped
    before the offset."""
    gx, gy = gradients
    N, H, W = gx.shape
    K = 50
    atlas = np.zeros((N, H + 40, 2 * W + 16, 2), np.float32)
    regions = [(0, 0), (24, W + 16)]              # (y_off, x_off)
    for k, (yo, xo) in enumerate(regions):
        atlas[:, yo:yo + H, xo:xo + W, 0] = gx[::-1] if k else gx
        atlas[:, yo:yo + H, xo:xo + W, 1] = gy[::-1] if k else gy
    ends = [_lines(rng, K, W, H) for _ in range(N)]
    sp = np.stack([e[0] for e in ends])
    ep = np.stack([e[1] for e in ends])
    reg = rng.integers(0, 2, (N, K))
    y_off = np.array([r[0] for r in regions], np.int32)[reg]
    x_off = np.array([r[1] for r in regions], np.int32)[reg]
    x_hi = np.full((N, K), W - 1, np.int32)
    y_hi = np.full((N, K), H - 1, np.int32)
    tt = torch.from_numpy
    f_t, b_t = tlbd.compute_lbd_atlas(tt(atlas), tt(sp), tt(ep), tt(x_off),
                                      tt(y_off), tt(x_hi), tt(y_hi))
    for i in range(N):
        f_j, b_j = jlbd.compute_lbd_atlas(
            jnp.asarray(atlas[i]), jnp.asarray(sp[i]), jnp.asarray(ep[i]),
            jnp.asarray(x_off[i]), jnp.asarray(y_off[i]),
            jnp.asarray(x_hi[i]), jnp.asarray(y_hi[i]))
        np.testing.assert_allclose(f_t[i].numpy(), np.asarray(f_j), atol=1e-5)
        assert _bits_differ(b_t[i], b_j) == 0
    # a line of region 0 equals the plain descriptor of that plane
    _, b_plain = tlbd.compute_lbd(tt(gx), tt(gy), tt(sp), tt(ep))
    sel = reg == 0
    assert sel.sum() > 10
    assert torch.equal(b_t[tt(sel)], b_plain[tt(sel)])
