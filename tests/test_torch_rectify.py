"""Stereo rectification of the port (ops/camera.py) against the JAX
package: the maps, built on the host in float64 by the same numpy code and
stored as float32, agree to 1e-5 px; the float32 bilinear remap of a 0..255
image agrees to 1e-3 (four products and three sums per pixel)."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch
from scipy.spatial.transform import Rotation

from stvo_pl_tpu.ops import camera as jcam
from stvo_pl_tpu_torch.ops import camera as tcam

torch.set_num_threads(1)

W, H = 160, 120
K_L = np.array([[120.0, 0, 80], [0, 120.0, 60], [0, 0, 1]])
K_R = np.array([[118.0, 0, 79], [0, 118.0, 61], [0, 0, 1]])
DIST = {
    "radtan": (np.array([-0.1, 0.02, 0.0005, -0.0004, 0.0]),
               np.array([-0.09, 0.015, -0.0003, 0.0002, 0.0])),
    "equidistant": (np.array([-0.01, 0.005, -0.002, 0.001]),
                    np.array([-0.012, 0.006, -0.001, 0.0015])),
}
R_REL = Rotation.from_rotvec([0.01, -0.02, 0.005]).as_matrix()
T_REL = np.array([0.11, 0.001, -0.002])


def _maps(mod, model):
    d_l, d_r = DIST[model]
    return mod.build_rectify_maps(K_L, d_l, K_R, d_r, R_REL, T_REL, W, H,
                                  model=model)


@pytest.mark.parametrize("model", ["radtan", "equidistant"])
def test_rectify_maps_against_jax(model):
    t_l, t_r, t_cam = _maps(tcam, model)
    j_l, j_r, j_cam = _maps(jcam, model)
    assert t_l.shape == (H, W, 2) and t_l.dtype == np.float32
    np.testing.assert_allclose(t_l, j_l, atol=1e-5)
    np.testing.assert_allclose(t_r, j_r, atol=1e-5)
    assert tuple(t_cam) == tuple(j_cam)
    assert isinstance(t_cam, tcam.StereoCamera)
    assert abs(t_cam.b - np.linalg.norm(T_REL)) < 1e-12
    # the maps do bend: they are not the identity grid
    yy, xx = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
    assert np.abs(t_l[..., 0] - xx).max() > 1.0
    for a, b in zip(tcam._rectifying_rotations(R_REL, T_REL),
                    jcam._rectifying_rotations(R_REL, T_REL)):
        np.testing.assert_allclose(a, b, atol=1e-14)


@pytest.mark.parametrize("model", ["radtan", "equidistant"])
def test_rectify_remap_against_jax(rng, model):
    map_l, map_r, _ = _maps(tcam, model)
    imgs = (rng.random((2, H, W)) * 255).astype(np.float32)
    for mp in (map_l, map_r):
        out = tcam.rectify_remap(torch.from_numpy(imgs), torch.from_numpy(mp))
        assert out.shape == (2, H, W) and out.dtype == torch.float32
        for i in range(2):
            ref = np.asarray(jcam.rectify_remap(jnp.asarray(imgs[i]),
                                                jnp.asarray(mp)))
            np.testing.assert_allclose(out[i].numpy(), ref, atol=1e-3)
        # taps outside the source image read 0
        outside = ((mp[..., 0] < -1) | (mp[..., 0] > W)
                   | (mp[..., 1] < -1) | (mp[..., 1] > H))
        assert not out[:, torch.from_numpy(outside)].any()


def test_remap_identity_shift_and_bad_model(rng):
    img = torch.from_numpy((rng.random((20, 30)) * 255).astype(np.float32))
    yy, xx = np.meshgrid(np.arange(20), np.arange(30), indexing="ij")
    ident = torch.from_numpy(np.stack([xx, yy], axis=-1).astype(np.float32))
    assert torch.equal(tcam.rectify_remap(img, ident), img)
    half = ident + torch.tensor([0.5, 0.0])
    out = tcam.rectify_remap(img, half)
    np.testing.assert_allclose(out[:, :-1].numpy(),
                               ((img[:, :-1] + img[:, 1:]) / 2).numpy(),
                               atol=1e-4)
    np.testing.assert_allclose(out[:, -1].numpy(), (img[:, -1] / 2).numpy(),
                               atol=1e-4)
    with pytest.raises(ValueError, match="model"):
        tcam.build_rectify_maps(K_L, DIST["radtan"][0], K_R,
                                DIST["radtan"][1], R_REL, T_REL, W, H,
                                model="fisheye")
