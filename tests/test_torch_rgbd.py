"""The RGB-D front end and step of the port (`extract_rgbd_features`,
`vo_step_rgbd`) against the JAX package on identical numpy intensity and
depth frames (the scene and depth maps of tests/test_rgbd.py).

With the JAX package on its kernel branches (interpret-mode Pallas for
FAST and the all-direction run kernel) both detect the same corners and
lines: validity and line descriptors equal, point descriptors up to 1e-4 of
their bits (XLA contracts the blur's multiply-adds into FMAs, the port does
not, which flips a few rBRIEF tests between near-equal pixels), disparities
and 3-D points to 1e-4 relative (one division), every step from JAX's state to 3e-4 m with match
counts within 1.  Unpatched
on the CPU the JAX package takes its per-direction line generator, which
the port's `per_direction=True` follows: the line sets are equal there
too.  The port's own depth renderer is checked against the projected
landmarks."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from stvo_pl_tpu.config import VOConfig as JCfg
from stvo_pl_tpu.models import frame as jframe
from stvo_pl_tpu.models import frontend as jfront
from stvo_pl_tpu.ops import camera as jcam
from stvo_pl_tpu.ops import se3 as jse3
from stvo_pl_tpu.utils import synthetic as jsyn
from stvo_pl_tpu_torch import convert
from stvo_pl_tpu_torch.config import VOConfig as TCfg
from stvo_pl_tpu_torch.models import frame as tframe
from stvo_pl_tpu_torch.models import frontend as tfront
from stvo_pl_tpu_torch.ops import camera as tcam
from stvo_pl_tpu_torch.utils import metrics as tmetrics
from stvo_pl_tpu_torch.utils import synthetic as tsyn

from test_torch_helpers import jax_kernel_branch

torch.set_num_threads(1)
tt = torch.from_numpy

CAM_ARGS = dict(fx=160.0, fy=160.0, cx=120.0, cy=90.0, b=0.2, width=240,
                height=180)
JCAM, TCAM = jcam.StereoCamera(**CAM_ARGS), tcam.StereoCamera(**CAM_ARGS)
CFG_ARGS = dict(orb_nfeatures=300, orb_nlevels=2, lsd_nfeatures=32,
                lsd_n_dirs=8, min_features=8, rgbd_max_depth=80.0)
MIN_LEN = 0.025 * 180
N_FRAMES = 6


def _render_rgbd(scene, T_wc):
    """tests/test_rgbd.py: a plane at 15 m with the landmarks' depths
    splatted over it in 13 x 13 windows."""
    img, _ = jsyn.render_stereo(scene, T_wc, JCAM)
    Pc = jse3.transform_points(jse3.inverse_se3(T_wc), scene.P)
    uv = np.asarray(jcam.project(JCAM, Pc))
    z = np.asarray(Pc[:, 2], np.float32)
    H, W = JCAM.height, JCAM.width
    depth = np.full((H, W), 15.0, np.float32)
    x = np.clip(np.round(uv[:, 0]).astype(int), 0, W - 1)
    y = np.clip(np.round(uv[:, 1]).astype(int), 0, H - 1)
    for i in np.nonzero(z > 0.5)[0]:
        depth[max(y[i] - 6, 0):y[i] + 7, max(x[i] - 6, 0):x[i] + 7] = z[i]
    return np.asarray(img), depth


@pytest.fixture(scope="module")
def frames():
    scene = jsyn.make_scene(jax.random.PRNGKey(5), n_points=260, n_lines=20,
                            extent=(6.0, 4.0, 12.0), z_near=1.5)
    poses = jsyn.smooth_trajectory(N_FRAMES, speed=0.1)
    fr = [_render_rgbd(scene, poses[i]) for i in range(N_FRAMES)]
    return (np.stack([f[0] for f in fr]), np.stack([f[1] for f in fr]),
            np.asarray(poses))


def _compare_lines(t_lines, j_lines, lane=0):
    v = np.asarray(j_lines.valid)
    np.testing.assert_array_equal(t_lines.valid[lane].numpy(), v)
    np.testing.assert_array_equal(
        t_lines.desc[lane].numpy().view(np.uint32)[v],
        np.asarray(j_lines.desc)[v])
    for f in ("spl", "epl", "sdisp", "edisp", "sP", "eP", "le", "angle",
              "sigma2"):
        np.testing.assert_allclose(
            getattr(t_lines, f)[lane].numpy()[v],
            np.asarray(getattr(j_lines, f))[v], rtol=1e-4, atol=2e-3,
            err_msg=f)
    assert not t_lines.level.any()
    return int(v.sum())


def test_rgbd_features_against_jax_kernel_branch(frames):
    imgs, depths, _ = frames
    jcfg, tcfg = JCfg(**CFG_ARGS), TCfg(**CFG_ARGS)
    feats = tframe.extract_rgbd_features(
        tt(imgs[:2]), tt(depths[:2]), torch.full((2,), 20.0), MIN_LEN, TCAM,
        tcfg)
    n_lines = 0
    with jax_kernel_branch():
        for i in range(2):
            ref = jax.tree_util.tree_map(
                np.asarray, jframe.extract_rgbd_features(
                    jnp.asarray(imgs[i]), jnp.asarray(depths[i]),
                    jnp.float32(20.0), jnp.float32(MIN_LEN), JCAM, jcfg))
            p, rp = feats.points, ref.points
            assert rp.valid.sum() > 100
            np.testing.assert_array_equal(p.valid[i].numpy(), rp.valid)
            np.testing.assert_array_equal(p.level[i].numpy(), rp.level)
            x = p.desc[i].numpy().view(np.uint32) ^ rp.desc
            flipped = int(np.unpackbits(x.view(np.uint8)).sum())
            assert flipped <= 1e-4 * x.size * 32, flipped
            np.testing.assert_array_equal(p.uv[i].numpy(), rp.uv)
            for f in ("disp", "P", "sigma2"):
                np.testing.assert_allclose(getattr(p, f)[i].numpy(),
                                           getattr(rp, f), rtol=1e-4,
                                           atol=1e-5, err_msg=f)
            n_lines += _compare_lines(feats.lines, ref.lines, lane=i)
    assert n_lines >= 6, "the frames must hold lines with depth"


def test_rgbd_lines_per_direction_against_jax(frames):
    """Unpatched, the JAX package detects RGB-D lines with its
    per-direction generator."""
    imgs, depths, _ = frames
    args = dict(CFG_ARGS, has_points=False)
    feats = tframe.extract_rgbd_features(
        tt(imgs[:1]), tt(depths[:1]), torch.full((1,), 20.0), MIN_LEN, TCAM,
        TCfg(**args), per_direction=True)
    ref = jframe.extract_rgbd_features(
        jnp.asarray(imgs[0]), jnp.asarray(depths[0]), jnp.float32(20.0),
        jnp.float32(MIN_LEN), JCAM, JCfg(**args))
    assert _compare_lines(feats.lines, ref.lines) >= 3
    assert not feats.points.valid.any()


def test_rgbd_depth_gating(rng):
    """Features on pixels with invalid or out-of-range depth are dropped;
    EDLines run (full-capacity lines at level 0, finite)."""
    img = tt((rng.random((1, 180, 240)) * 255).astype(np.float32))
    cfg = TCfg(**CFG_ARGS)
    th = torch.full((1,), 20.0)
    for depth in (torch.zeros((1, 180, 240)),
                  torch.full((1, 180, 240), 90.0)):
        feats = tframe.extract_rgbd_features(img, depth, th, 6.0, TCAM, cfg)
        assert not feats.points.valid.any() and not feats.lines.valid.any()
    feats = tframe.extract_rgbd_features(img, torch.full((1, 180, 240), 4.0),
                                         th, 6.0, TCAM, cfg)
    assert feats.points.valid.sum() > 50
    np.testing.assert_allclose(feats.points.disp[feats.points.valid].numpy(),
                               160.0 * 0.2 / 4.0, rtol=1e-6)
    feats = tframe.extract_rgbd_features(img, torch.full((1, 180, 240), 4.0),
                                         th, 6.0, TCAM,
                                         cfg.replace(use_edlines=True))
    assert feats.lines.spl.shape == (1, cfg.line_capacity, 2)
    assert not feats.lines.level.any()
    assert bool(torch.isfinite(feats.lines.sP).all())


def test_rgbd_every_step_from_jax_state(frames):
    """Points-only, as tests/test_rgbd.py runs it (this depth map carries
    depth at point landmarks only): every step started from the JAX kernel
    branch's incoming state agrees to 3e-4 m and 5e-5 in rotation, with
    match and inlier counts within 1 and the other discrete outputs equal
    (seen: 1e-4 m, 2e-5 and one match of ~190 on two of the six frames,
    where one of the 3-5 rBRIEF bits that the blur's rounding flips
    decides a ratio test), and the port's own chained run tracks with ATE
    < 0.12 m (the JAX test's gate)."""
    imgs, depths, poses = frames
    args = dict(CFG_ARGS, has_lines=False)
    jcfg, tcfg = JCfg(**args), TCfg(**args)
    with jax_kernel_branch():
        state = jfront.init_state(jcfg)
        states, tels = [], []
        for i in range(N_FRAMES):
            states.append(jax.tree_util.tree_map(np.asarray, state))
            state, t = jfront.vo_step_rgbd(state, jnp.asarray(imgs[i]),
                                           jnp.asarray(depths[i]), JCAM, jcfg)
            tels.append(jax.tree_util.tree_map(np.asarray, t))
    for i in range(N_FRAMES):
        st = convert.state_from_numpy(states[i], "cpu")
        _, tel = tfront.vo_step_rgbd(st, tt(imgs[i]), tt(depths[i]), TCAM,
                                     tcfg)
        np.testing.assert_allclose(tel.Tfw.numpy()[:3, 3], tels[i].Tfw[:3, 3],
                                   atol=3e-4, err_msg=f"frame {i}")
        np.testing.assert_allclose(tel.Tfw.numpy()[:3, :3],
                                   tels[i].Tfw[:3, :3], atol=5e-5)
        for f in ("good", "opt_iters", "fast_th", "is_kf"):
            assert getattr(tel, f).item() == getattr(tels[i], f).item(), (i, f)
        for f in ("n_points", "n_inliers_pt"):
            assert abs(getattr(tel, f).item()
                       - getattr(tels[i], f).item()) <= 1, (i, f)
    assert sum(int(t.n_inliers_pt) for t in tels) > 100

    st = tfront.init_state(tcfg, device="cpu")
    traj = []
    for i in range(N_FRAMES):
        st, tel = tfront.vo_step_rgbd(st, tt(imgs[i]), tt(depths[i]), TCAM,
                                      tcfg)
        traj.append(tel.Tfw.numpy())
    ate = tmetrics.ate_rmse(np.stack(traj).astype(np.float64),
                            poses.astype(np.float64))
    assert ate < 0.12, ate
    with pytest.raises(ValueError, match="shape"):
        tfront.vo_step_rgbd(st, tt(imgs[0]), tt(depths[0][:90]), TCAM, tcfg)


def test_render_depth_and_rgbd_sequence_with_lines():
    """The port's depth renderer: landmark pixels carry the landmark's z,
    line pixels the line's, background 0; an RGB-D run on its frames,
    points and lines, tracks (ATE < 0.1 m) with line inliers."""
    gen = torch.Generator().manual_seed(3)
    scene = tsyn.make_scene(gen, n_points=260, n_lines=24,
                            extent=(6.0, 4.0, 12.0), z_near=1.5)
    poses = tsyn.smooth_trajectory(N_FRAMES, speed=0.1)
    left, _ = tsyn.render_sequence(scene, poses, TCAM)
    depth = tsyn.render_depth(scene, poses, TCAM)
    assert depth.shape == left.shape and bool(torch.isfinite(depth).all())
    assert 0.05 < float((depth > 0).float().mean()) < 0.9
    # frame 0 is the world frame: a landmark's centre pixel holds a depth
    # no larger than its own z (nearer content may cover it)
    uv = tcam.project(TCAM, scene.P)
    x, y = uv[:, 0].floor().long(), uv[:, 1].floor().long()
    ok = (x >= 0) & (x < 240) & (y >= 0) & (y < 180)
    d = depth[0, y[ok], x[ok]]
    z = scene.P[ok, 2]
    assert bool((d > 0).all()) and bool((d <= z + 1e-4).all())
    assert float((d == z).float().mean()) > 0.6
    # the midpoint of a line in view carries about the line's depth
    mid = 0.5 * (scene.sA + scene.sB)
    uvm = tcam.project(TCAM, mid)
    xm, ym = uvm[:, 0].round().long(), uvm[:, 1].round().long()
    okm = (xm >= 0) & (xm < 240) & (ym >= 0) & (ym < 180)
    assert int(okm.sum()) >= 3
    dm = depth[0, ym[okm], xm[okm]]
    assert bool((dm > 0).all()) and bool((dm <= mid[okm, 2] * 1.05).all())

    cfg = TCfg(**dict(CFG_ARGS, rgbd_max_depth=20.0))
    st = tfront.init_state(cfg, device="cpu")
    traj, ls = [], 0
    for i in range(N_FRAMES):
        st, tel = tfront.vo_step_rgbd(st, left[i], depth[i], TCAM, cfg)
        traj.append(tel.Tfw.numpy())
        ls += int(tel.n_inliers_ls)
    ate = tmetrics.ate_rmse(np.stack(traj).astype(np.float64),
                            poses.numpy().astype(np.float64))
    assert ate < 0.1, ate
    assert ls > 0, "no line took part in an RGB-D pose"
