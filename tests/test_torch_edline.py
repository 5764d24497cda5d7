"""The port's EDLine detector (stvo_pl_tpu_torch/ops/edline.py) and the VO
step with `use_edlines=True` against the JAX package on the same seeded
numpy inputs: the cases of tests/test_edline.py (planted segments, the
rotation sweep, the empty image), a frame of the textured world, a frame
that overflows `node_capacity`, and a two-image batch against each image
alone.

Tolerances, set before measuring: the same number of valid segments
within 1, and at least 90% of the segments shared within 0.5 px at both
endpoints (the FLD-mode rule of ROADMAP §3).  Both packages sum the
moments in float32 in node order on the CPU, but XLA contracts the
blur's and the fit's multiply-adds into FMAs and the port does not, so
the last bits of a fit may differ.  Batching is exact: two images in one
call give what each gives alone, bit for bit (the angles' atan2 to 1e-6).

The 8-frame VO run of tests/test_edline.py (textured canyon, 240x180)
goes through both packages, the JAX one with FAST on its kernel branch,
at edline_scale 1 and 2: the port's ATE within 5 mm of the JAX
package's and below that test's 0.15 m gate.  One RGB-D step with
EDLines runs on the CPU.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from stvo_pl_tpu.config import VOConfig as JCfg
from stvo_pl_tpu.models import frontend as jfront
from stvo_pl_tpu.ops import camera as jcam
from stvo_pl_tpu.ops import edline as jed
from stvo_pl_tpu.utils import metrics as jmetrics
from stvo_pl_tpu.utils import world as jworld
from stvo_pl_tpu_torch.config import VOConfig as TCfg
from stvo_pl_tpu_torch.models import frontend as tfront
from stvo_pl_tpu_torch.ops import camera as tcam
from stvo_pl_tpu_torch.ops import edline as ted

from test_torch_helpers import jax_kernel_branch, shared_fraction

torch.set_num_threads(1)

CAM_ARGS = dict(fx=160.0, fy=160.0, cx=120.0, cy=90.0, b=0.3, width=240,
                height=180)
JCAM, TCAM = jcam.StereoCamera(**CAM_ARGS), tcam.StereoCamera(**CAM_ARGS)
# tests/test_edline.py's e2e configuration
VO_ARGS = dict(orb_nfeatures=300, orb_nlevels=2, lsd_nfeatures=48,
               min_features=8, fast_feat_th=20, use_edlines=True)
N_FRAMES = 8
PLANTED = [((30, 40), (200, 60)), ((60, 150), (80, 30)),
           ((120, 100), (190, 160))]


def _img_with_lines(lines, shape=(180, 240), bg=40.0, fg=210.0):
    cv2 = pytest.importorskip("cv2")
    img = np.full(shape, bg, np.float32)
    for (a, b) in lines:
        cv2.line(img, a, b, fg, 2)
    return img


def _rotated(deg):
    th = np.deg2rad(deg)
    c = np.array([120, 90])
    d = np.array([np.cos(th), np.sin(th)])
    a = (c - 70 * d).astype(int)
    b = (c + 70 * d).astype(int)
    return _img_with_lines([(tuple(a), tuple(b))])


@pytest.fixture(scope="module")
def canyon():
    """The textured canyon of tests/test_edline.py: (L, R, poses)."""
    w = jworld.make_world(seed=31, length=40.0)
    poses = np.tile(np.eye(4), (N_FRAMES, 1, 1))
    poses[:, 2, 3] = 0.3 * np.arange(N_FRAMES)
    L, R = jworld.render_sequence(w, poses, JCAM)
    return np.asarray(L, np.float32), np.asarray(R, np.float32), poses


def _both(img, min_len, **kw):
    """(JAX segments, port segments of the one-image batch) as numpy."""
    j = jed.detect_edlines(jnp.asarray(img), jnp.float32(min_len), **kw)
    t = ted.detect_edlines(torch.from_numpy(img)[None], min_len, **kw)
    j = {f: np.asarray(getattr(j, f)) for f in j._fields}
    t = {f: getattr(t, f)[0].numpy() for f in t._fields}
    return j, t


def _assert_close(j, t):
    nj, nt = int(j["valid"].sum()), int(t["valid"].sum())
    assert abs(nj - nt) <= 1, (nj, nt)
    frac = shared_fraction(j["sp"], j["ep"], j["valid"], t["sp"], t["ep"],
                           t["valid"], tol=0.5)
    assert frac >= 0.9, frac


@pytest.mark.parametrize("case", ["planted", "rotation_7", "rotation_23",
                                  "rotation_41", "rotation_68", "rotation_83",
                                  "empty", "canyon", "overflow"])
def test_detect_edlines_against_jax(case, canyon):
    if case == "planted":
        img, kw = _img_with_lines(PLANTED), dict(capacity=32)
        min_len = 20.0
    elif case.startswith("rotation"):
        img, kw = _rotated(float(case.split("_")[1])), dict(capacity=8)
        min_len = 30.0
    elif case == "empty":
        img, kw, min_len = np.full((120, 160), 77.0, np.float32), \
            dict(capacity=16), 15.0
    else:
        # the canyon's first left frame; "overflow" keeps 1500 of its
        # ~6000 edge pixels, so the strongest-first compaction decides
        img, min_len = canyon[0][0], 4.5
        kw = dict(capacity=48)
        if case == "overflow":
            kw["node_capacity"] = 1500
    j, t = _both(img, min_len, **kw)
    _assert_close(j, t)
    if case == "empty":
        assert not t["valid"].any()
    elif case == "overflow":
        # the budget really binds: fewer segments than the full node set
        full = ted.detect_edlines(torch.from_numpy(img)[None], min_len,
                                  capacity=48)
        assert t["valid"].sum() < int(full.valid.sum())
    else:
        assert t["valid"].sum() >= (3 if case == "planted" else 1)


def test_batch_equals_each_image_alone(canyon):
    """Gathers and scatters stay inside their image: a two-image batch
    gives what each image gives alone, bit for bit, but for the final
    atan2 of equal endpoints, which the CPU computes in a vector lane or
    in the scalar tail depending on the batch's length (1 ulp seen)."""
    imgs = torch.from_numpy(np.stack([canyon[0][0], canyon[1][3]]))
    kw = dict(capacity=48, node_capacity=3000)
    both = ted.detect_edlines(imgs, 4.5, **kw)
    for i in range(2):
        one = ted.detect_edlines(imgs[i:i + 1], 4.5, **kw)
        for f, a, b in zip(both._fields, both, one):
            if f == "angle":
                torch.testing.assert_close(a[i], b[0], rtol=0, atol=1e-6)
            else:
                assert torch.equal(a[i], b[0]), f
    assert int(both.valid[0].sum()) > 0 and int(both.valid[1].sum()) > 0


def _jax_vo(L, R, cfg):
    state = jfront.init_state(cfg)
    est = []
    for i in range(N_FRAMES):
        state, t = jfront.vo_step(state, jnp.asarray(L[i]),
                                  jnp.asarray(R[i]), JCAM, cfg)
        est.append(np.asarray(t.Tfw))
    return np.stack(est)


def _port_vo(L, R, cfg):
    state = tfront.init_state(cfg, device="cpu")
    est, nls = [], []
    for i in range(N_FRAMES):
        state, t = tfront.vo_step(state, torch.from_numpy(L[i]),
                                  torch.from_numpy(R[i]), TCAM, cfg)
        est.append(t.Tfw.numpy())
        nls.append(int(t.n_lines))
    return np.stack(est), nls


@pytest.mark.parametrize("scale", [1, 2])
def test_vo_with_edlines_against_jax(scale, canyon):
    L, R, poses = canyon
    args = dict(VO_ARGS, edline_scale=scale)
    with jax_kernel_branch(lsd=False):
        est_j = _jax_vo(L, R, JCfg(**args))
    est_t, nls = _port_vo(L, R, TCfg(**args))
    assert max(nls[1:]) > 0          # line features actually flowed
    ate_j = jmetrics.ate_rmse(est_j, poses)
    ate_t = jmetrics.ate_rmse(est_t, poses)
    assert ate_t < 0.15, ate_t
    assert abs(ate_t - ate_j) <= 0.005, (ate_t, ate_j)


def test_rgbd_step_with_edlines(canyon):
    """One RGB-D step runs with EDLines: level 0, finite output, lines
    on the planted depth."""
    L = canyon[0]
    cfg = TCfg(**VO_ARGS)
    state = tfront.init_state(cfg, device="cpu")
    depth = torch.full((180, 240), 6.0)
    img = torch.from_numpy(L[0])
    for _ in range(2):
        state, t = tfront.vo_step_rgbd(state, img, depth, TCAM, cfg)
    lines = state.prev_lines
    assert lines.spl.shape == (cfg.line_capacity, 2)
    assert not lines.level.any() and int(lines.valid.sum()) > 0
    assert bool(torch.isfinite(lines.sP).all() & torch.isfinite(t.Tfw).all())
    assert int(t.n_lines) > 0
