"""The port's windowed-BA back end (stvo_pl_tpu_torch/models/backend.py)
against the JAX package's, both fed the same per-frame poses, keyframe
flags and point + line snapshots: 20 frames of the port's VO on the
240x180 point + line sequence (seed 7, 2 grey levels of image noise),
windows of 4 keyframes promoted every 3 frames.

Tolerances: event indices, skip and line-rejection counts are integers
and must be equal; corrections and the corrected trajectory are held to
2e-4 (m and rotation entries): each window's float32 solve differs by up
to 1e-4 between the packages (tests/test_torch_window.py), and chained
windows and the se(3) interpolation carry it on.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from stvo_pl_tpu.config import VOConfig as JCfg
from stvo_pl_tpu.models import backend as jback
from stvo_pl_tpu.models import features as jfeat
from stvo_pl_tpu_torch import convert
from stvo_pl_tpu_torch.config import VOConfig as TCfg
from stvo_pl_tpu_torch.models import backend as tback
from stvo_pl_tpu_torch.ops import camera as tcam
from stvo_pl_tpu_torch.utils import metrics

from test_torch_helpers import CAM_ARGS, JCAM, SMALL, port_vo_frames

torch.set_num_threads(1)

TCAM = tcam.StereoCamera(**CAM_ARGS)
N_FRAMES = 20


@pytest.fixture(scope="module")
def frames():
    return port_vo_frames(N_FRAMES, SMALL, seed=7, img_noise=2.0)


def _feed(frames, **kw):
    """Both back ends over the same frames; returns (jax, port, raw)."""
    jb = jback.WindowedBA(JCAM, JCfg(**SMALL), window=4, force_kf_every=3,
                          **kw)
    tb = tback.WindowedBA(TCAM, TCfg(**SMALL), window=4, force_kf_every=3,
                          device="cpu", **kw)
    raw = []
    for i, (Tfw, is_kf, pts, lns) in enumerate(frames):
        raw.append(Tfw)
        kf = i > 0 and is_kf
        jb.observe(i, jnp.asarray(Tfw), kf,
                   jfeat.PointSet(*[jnp.asarray(x) for x in pts]),
                   jfeat.LineSet(*[jnp.asarray(x) for x in lns]))
        tb.observe(i, torch.from_numpy(Tfw), kf,
                   convert.points_from_numpy(pts, device="cpu"),
                   convert.lines_from_numpy(lns, device="cpu"))
    return jb, tb, np.stack(raw)


def _assert_same_events(jb, tb):
    assert [e[0] for e in tb.events] == [e[0] for e in jb.events]
    for (_, tc), (_, jc) in zip(tb.events, jb.events):
        np.testing.assert_allclose(tc, jc, rtol=0, atol=2e-4)
    assert tb.n_skipped == jb.n_skipped
    assert tb.n_lines_rejected == jb.n_lines_rejected


def test_backend_against_jax(frames):
    (fr, gt) = frames
    jb, tb, raw = _feed(fr)
    assert len(tb.events) >= 2
    _assert_same_events(jb, tb)
    t_ref, j_ref = tb.apply(raw), jb.apply(raw)
    np.testing.assert_allclose(t_ref, j_ref, rtol=0, atol=2e-4)
    # the JAX package's own gate (tests/test_backend.py): refinement does
    # not corrupt the trajectory in the world frame
    ate_raw = metrics.ate_rmse(raw.astype(np.float64), gt, align=False)
    ate_ref = metrics.ate_rmse(t_ref, gt, align=False)
    assert ate_ref <= 1.05 * ate_raw, (ate_raw, ate_ref)


@pytest.mark.parametrize("gate", ["translation", "rotation"])
def test_trust_gate_skips_like_jax(frames, gate):
    """A gate far below every window's largest correction (measured: 0.18
    and 0.21 m, 0.45 and 0.44 deg for the two windows) skips every window
    in both packages."""
    kw = (dict(max_correction=1e-4) if gate == "translation"
          else dict(max_rot_correction=1e-3))
    jb, tb, raw = _feed(frames[0], **kw)
    assert tb.n_skipped == jb.n_skipped > 0
    assert tb.events == [] and jb.events == []
    np.testing.assert_array_equal(tb.apply(raw), jb.apply(raw))


def test_line_trust_rejects_like_jax(frames):
    """A 0.03 mm disagreement gate rejects the lines of the first window
    (its joint solution moves 0.15 mm from the points-only one) and keeps
    those of the second (0.002 mm), in both packages alike."""
    jb, tb, raw = _feed(frames[0], max_disagree_t=3e-5)
    assert tb.n_lines_rejected == 1
    _assert_same_events(jb, tb)
    np.testing.assert_allclose(tb.apply(raw), jb.apply(raw), rtol=0,
                               atol=2e-4)


def test_snapshots_are_copies():
    """The ring keeps copies: changing the caller's tensors after observe
    leaves the window's snapshot as it was."""
    from stvo_pl_tpu_torch.models.features import empty_lines, empty_points
    tb = tback.WindowedBA(TCAM, TCfg(**SMALL), window=4, device="cpu")
    pts, lns = empty_points(8), empty_lines(4)
    tb.observe(0, torch.eye(4), False, pts, lns)
    pts.uv.fill_(7.0)
    lns.spl.fill_(7.0)
    snap_pts, snap_lns = tb._ring[0][3], tb._ring[0][4]
    assert float(snap_pts.uv.abs().max()) == 0.0
    assert float(snap_lns.spl.abs().max()) == 0.0
