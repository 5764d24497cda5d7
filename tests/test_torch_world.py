"""The port's textured-world renderer (stvo_pl_tpu_torch/utils/world.py, a
numpy copy of the JAX package's) and the street trajectory and one-pose
renderer of its utils/synthetic.py, against the JAX package's.

Both world renderers are the same numpy code on the same seed, and both
street trajectories are float64 numpy rounded to float32, so they must be
bit-equal.  `render_stereo` renders the JAX package's stamp scene and is
held to the renderer tolerance of tests/test_torch_synthetic.py (atol
2e-3 on 0..255)."""

import numpy as np
import jax
import pytest
import torch

from stvo_pl_tpu.ops import camera as jcam
from stvo_pl_tpu.utils import synthetic as jsyn
from stvo_pl_tpu.utils import world as jworld
from stvo_pl_tpu_torch.ops import camera as tcam
from stvo_pl_tpu_torch.utils import synthetic as tsyn
from stvo_pl_tpu_torch.utils import world as tworld

torch.set_num_threads(1)

SMALL_CAM = dict(fx=120.0, fy=120.0, cx=80.0, cy=60.0, b=0.5, width=160,
                 height=120)


def test_street_trajectory_equal():
    j = np.asarray(jsyn.street_trajectory(30, speed=0.8))
    t = tsyn.street_trajectory(30, speed=0.8)
    assert t.dtype == torch.float32 and t.shape == (30, 4, 4)
    np.testing.assert_array_equal(t.numpy(), j)


@pytest.mark.parametrize("kw", [dict(seed=3, length=60.0),
                                dict(seed=200, length=150.0,
                                     exposure_amp=0.35, flicker_frame=1)],
                         ids=["textured", "adversarial_long"])
def test_world_sequence_bit_equal(kw):
    """make_world and render_sequence (ray cast, blur, exposure, sensor
    noise) on the street trajectory."""
    jw = jworld.make_world(**kw)
    tw = tworld.make_world(**kw)
    assert len(tw.quads) == len(jw.quads)
    for a, b in zip(tw.quads, jw.quads):
        np.testing.assert_array_equal(a.tex, b.tex)
        np.testing.assert_array_equal(a.p0, b.p0)
    poses = np.asarray(jsyn.street_trajectory(3, speed=0.8))
    jl, jr = jworld.render_sequence(jw, poses, jcam.StereoCamera(**SMALL_CAM))
    tl, tr = tworld.render_sequence(tw, tsyn.street_trajectory(3).numpy(),
                                    tcam.StereoCamera(**SMALL_CAM))
    assert tl.shape == (3, 120, 160) and tl.std() > 15.0
    np.testing.assert_array_equal(tl, jl)
    np.testing.assert_array_equal(tr, jr)


def test_world_without_matplotlib(monkeypatch):
    """Where matplotlib is missing, the port uses its own copy of
    matplotlib's photograph: the world is bit-equal to the JAX package's
    built from that photograph alone."""
    monkeypatch.setattr(tworld, "_site_packages", lambda: None)
    monkeypatch.setattr(jworld, "_PHOTO_CANDIDATES",
                        jworld._PHOTO_CANDIDATES[:1])
    photos = tworld.load_photos()
    assert len(photos) == len(jworld.load_photos()) == 1
    np.testing.assert_array_equal(photos[0], jworld.load_photos()[0])
    tw = tworld.make_world(seed=0, length=40.0)
    jw = jworld.make_world(seed=0, length=40.0)
    for a, b in zip(tw.quads, jw.quads):
        np.testing.assert_array_equal(a.tex, b.tex)
    cam = SMALL_CAM
    img = tworld.render_view(tw, np.eye(4), tcam.StereoCamera(**cam), 0.0)
    np.testing.assert_array_equal(
        img, jworld.render_view(jw, np.eye(4), jcam.StereoCamera(**cam), 0.0))
    assert img.std() > 15.0


@pytest.mark.parametrize("pinned", ["bundled", "none"])
def test_pinned_photographs_fix_the_world(monkeypatch, pinned):
    """`make_world(photos=...)` builds the same world whatever this host
    has installed: the bundled photograph gives the JAX package's world on
    a host with matplotlib alone, [] its world on one with neither."""
    if pinned == "bundled":
        photos = tworld.bundled_photos()
        monkeypatch.setattr(jworld, "_PHOTO_CANDIDATES",
                            jworld._PHOTO_CANDIDATES[:1])
        assert len(jworld.load_photos()) == 1
    else:
        photos = []
        monkeypatch.setattr(jworld, "load_photos", lambda: [])
    tw = tworld.make_world(seed=0, length=40.0, photos=photos)
    jw = jworld.make_world(seed=0, length=40.0)
    for a, b in zip(tw.quads, jw.quads):
        np.testing.assert_array_equal(a.tex, b.tex)


def test_render_stereo_matches_jax():
    cam = dict(fx=160.0, fy=160.0, cx=120.0, cy=90.0, b=0.3, width=240,
               height=180)
    jscene = jsyn.make_scene(jax.random.PRNGKey(2), n_points=200,
                             n_lines=16, extent=(14.0, 8.0, 40.0),
                             z_near=3.0)
    T = jsyn.smooth_trajectory(4, speed=0.25)[3]
    jl, jr = jsyn.render_stereo(jscene, T, jcam.StereoCamera(**cam))
    tscene = tsyn.Scene(*[torch.from_numpy(np.asarray(x)) for x in jscene])
    tl, tr = tsyn.render_stereo(tscene, torch.from_numpy(np.asarray(T)),
                                tcam.StereoCamera(**cam))
    assert tl.shape == (180, 240)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=2e-3)
    np.testing.assert_allclose(tr.numpy(), np.asarray(jr), atol=2e-3)
