"""The port's synthetic renderer against the JAX package's on the JAX
package's Scene arrays.

Tolerance: the landmark stamps are scatter-added (another accumulation
order where stamps overlap) and the line fields use float32 exp from
another library, so intensities in 0..255 agree to atol 2e-3 (~250
float32 ulps at 255); the trajectory is computed in float64 by both and
is equal to float32 rounding.  The trajectory metrics are numpy in both
packages and must agree exactly."""

import numpy as np
import jax
import pytest
import torch

from stvo_pl_tpu.ops import camera as jcam
from stvo_pl_tpu.utils import metrics as jmetrics
from stvo_pl_tpu.utils import synthetic as jsyn
from stvo_pl_tpu_torch.ops import camera as tcam
from stvo_pl_tpu_torch.utils import metrics as tmetrics
from stvo_pl_tpu_torch.utils import synthetic as tsyn

torch.set_num_threads(1)

CAM = dict(fx=160.0, fy=160.0, cx=120.0, cy=90.0, b=0.3, width=240,
           height=180)


def test_trajectory_equal():
    j = np.asarray(jsyn.smooth_trajectory(12, speed=0.3, yaw_rate=0.003))
    t = tsyn.smooth_trajectory(12, speed=0.3, yaw_rate=0.003).numpy()
    np.testing.assert_array_equal(t, j)


@pytest.mark.parametrize("seed", [0, 5])
def test_render_matches_jax_on_jax_scene(seed):
    jscene = jsyn.make_scene(jax.random.PRNGKey(seed), n_points=260,
                             n_lines=24, extent=(14.0, 8.0, 40.0),
                             z_near=3.0)
    poses = jsyn.smooth_trajectory(3, speed=0.25, yaw_rate=0.003)
    jl, jr = jsyn.render_sequence(jscene, poses, jcam.StereoCamera(**CAM))
    tscene = tsyn.Scene(*[torch.from_numpy(np.asarray(x)) for x in jscene])
    tl, tr = tsyn.render_sequence(tscene, torch.from_numpy(np.asarray(poses)),
                                  tcam.StereoCamera(**CAM))
    assert tl.shape == (3, 180, 240)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=2e-3)
    np.testing.assert_allclose(tr.numpy(), np.asarray(jr), atol=2e-3)


def test_make_scene_ranges():
    g = torch.Generator().manual_seed(0)
    s = tsyn.make_scene(g, n_points=100, n_lines=10, extent=(5.0, 2.0, 9.0),
                        z_near=1.0)
    assert s.P.shape == (100, 3) and s.tex.shape == (100, 6, 6)
    P = s.P.numpy()
    assert (np.abs(P[:, 0]) <= 5).all() and (P[:, 2] >= 1).all()
    assert (P[:, 2] <= 10).all()
    L = np.linalg.norm((s.sB - s.sA).numpy(), axis=-1)
    assert ((L >= 3) & (L <= 10)).all()
    b = s.brightness.numpy()
    assert (b >= 90).all() and (b <= 200).all()
    again = tsyn.make_scene(torch.Generator().manual_seed(0), n_points=100,
                            n_lines=10, extent=(5.0, 2.0, 9.0), z_near=1.0)
    assert all(torch.equal(a, c) for a, c in zip(s, again))


@pytest.mark.parametrize("delta", [1, 3])
def test_metrics_equal_reference(delta):
    rng = np.random.default_rng(delta)
    gt = np.asarray(jsyn.smooth_trajectory(10, speed=0.4, yaw_rate=0.01),
                    dtype=np.float64)
    est = gt.copy()
    est[:, :3, 3] += rng.normal(scale=0.05, size=(10, 3))
    for align in (True, False):
        assert (tmetrics.ate_rmse(est, gt, align=align)
                == jmetrics.ate_rmse(est, gt, align=align))
    assert (tmetrics.rpe(est, gt, delta=delta)
            == jmetrics.rpe(est, gt, delta=delta))
