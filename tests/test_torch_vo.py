"""The points-only VO slice of the port end to end, against the JAX
package on the same frames (the 8-frame sequence of test_e2e_vo.py,
rendered by stvo_pl_tpu.utils.synthetic and handed to both as numpy).

The two packages select FAST corners by different code on the CPU: the
JAX package takes its dense XLA branch there, the port always takes the
fused-kernel semantics (held bit-exact to the Pallas kernel in
test_torch_fast.py).  Against that branch keypoints are compared as sets
and trajectories within loose tolerances.  The `kernel_run` fixture makes
the JAX package take its kernel branch too (interpret-mode Pallas), so
that both select identical corners; against it the port is held tightly.
"""

import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from stvo_pl_tpu.config import VOConfig as JCfg
from stvo_pl_tpu.models import frame as jframe
from stvo_pl_tpu.models import frontend as jfront
from stvo_pl_tpu.ops import camera as jcam
from stvo_pl_tpu.ops import fast as jfast
from stvo_pl_tpu.utils import metrics as jmetrics
from stvo_pl_tpu.utils import synthetic as jsyn
from stvo_pl_tpu_torch import convert
from stvo_pl_tpu_torch.config import VOConfig as TCfg
from stvo_pl_tpu_torch.models import frame as tframe
from stvo_pl_tpu_torch.models import frontend as tfront
from stvo_pl_tpu_torch.ops import camera as tcam
from stvo_pl_tpu_torch.parallel import batched
from stvo_pl_tpu_torch.utils import metrics as tmetrics

torch.set_num_threads(1)

CAM_ARGS = dict(fx=160.0, fy=160.0, cx=120.0, cy=90.0, b=0.3, width=240,
                height=180)
JCAM = jcam.StereoCamera(**CAM_ARGS)
TCAM = tcam.StereoCamera(**CAM_ARGS)
SMALL = dict(orb_nfeatures=300, orb_nlevels=2, lsd_nfeatures=48,
             lsd_n_dirs=8, min_features=8, fast_feat_th=20, has_lines=False)
JCFG = JCfg(**SMALL)
TCFG = TCfg(**SMALL)
N_FRAMES = 8
CARRY_AT = 3          # JAX runs frames 0..2, the port frame 3


def _tree_leaves(tree):
    return jax.tree_util.tree_leaves(tree)


@pytest.fixture(scope="module")
def run():
    scene = jsyn.make_scene(jax.random.PRNGKey(0), n_points=260,
                            n_lines=24, extent=(14.0, 8.0, 40.0), z_near=3.0)
    poses = jsyn.smooth_trajectory(N_FRAMES, speed=0.25, yaw_rate=0.003)
    L, R = jsyn.render_sequence(scene, poses, JCAM)
    L, R, poses = np.array(L), np.array(R), np.array(poses)

    state = jfront.init_state(JCFG)
    j_tfw, j_good, carried = [], [], None
    for i in range(N_FRAMES):
        if i == CARRY_AT:
            carried = jax.tree_util.tree_map(np.asarray, state)
        state, t = jfront.vo_step(state, jnp.asarray(L[i]), jnp.asarray(R[i]),
                                  JCAM, JCFG)
        j_tfw.append(np.asarray(t.Tfw))
        j_good.append(bool(t.good))

    t_state = tfront.init_state(TCFG, device="cpu")
    t_final, t_tel = tfront.vo_scan(t_state, torch.from_numpy(L),
                                    torch.from_numpy(R), TCAM, TCFG)
    return dict(L=L, R=R, poses=poses, j_tfw=np.stack(j_tfw),
                j_good=np.array(j_good), carried=carried, t_tel=t_tel)


class _GateOnTpu:
    """Stands in for `jax` inside stvo_pl_tpu.ops.fast, whose FAST branch
    is chosen by `jax.default_backend()`: there it reads "tpu", so the
    fused Pallas kernel runs.  Everything else is the real `jax`."""

    def __getattr__(self, name):
        return getattr(jax, name)

    @staticmethod
    def default_backend():
        return "tpu"


@pytest.fixture(scope="module")
def kernel_run(run):
    """The JAX package on its FAST kernel branch (pallas_call in interpret
    mode) over the same frames: each frame's incoming state as numpy, the
    poses and telemetry, and the first frame's detections per eye.  The
    patches hold for this fixture only, and the traces made under them are
    dropped on both sides."""
    from jax.experimental import pallas as pl
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(pl, "pallas_call",
                   functools.partial(pl.pallas_call, interpret=True))
        mp.setattr(jfast, "jax", _GateOnTpu())
        jax.clear_caches()
        imgs = np.stack([run["L"][0], run["R"][0]])
        detect_j = jax.jit(jframe.detect_points_multilevel,
                           static_argnames=("cfg",))
        dets = [jax.tree_util.tree_map(np.asarray, detect_j(
            jnp.asarray(imgs[eye]), jnp.float32(TCFG.orb_fast_th), cfg=JCFG))
            for eye in range(2)]
        state = jfront.init_state(JCFG)
        states, tels = [], []
        for i in range(N_FRAMES):
            states.append(jax.tree_util.tree_map(np.asarray, state))
            state, t = jfront.vo_step(state, jnp.asarray(run["L"][i]),
                                      jnp.asarray(run["R"][i]), JCAM, JCFG)
            tels.append(jax.tree_util.tree_map(np.asarray, t))
    jax.clear_caches()
    return dict(states=states, tels=tels, dets=dets)


def _keypoint_set(uv, level, valid, scale):
    s = scale ** level.astype(np.float64)
    grid = np.round(uv / s[:, None]).astype(np.int64)
    return {(int(lv), int(x), int(y))
            for (x, y), lv, ok in zip(grid, level, valid) if ok}


def test_first_frame_keypoints_shared(run):
    """(a) each eye's valid keypoints (level, integer position) share at
    least 95% with the JAX package's."""
    imgs = np.stack([run["L"][0], run["R"][0]])
    th = np.full(2, float(TCFG.orb_fast_th), np.float32)
    det_t = tframe.detect_points_multilevel(torch.from_numpy(imgs),
                                            torch.from_numpy(th), TCFG)
    detect_j = jax.jit(jframe.detect_points_multilevel,
                       static_argnames=("cfg",))
    for eye in range(2):
        det_j = detect_j(jnp.asarray(imgs[eye]), jnp.float32(th[eye]),
                         cfg=JCFG)
        sj = _keypoint_set(np.asarray(det_j.uv), np.asarray(det_j.level),
                           np.asarray(det_j.valid), JCFG.orb_scale_factor)
        st = _keypoint_set(det_t.uv[eye].numpy(), det_t.level[eye].numpy(),
                           det_t.valid[eye].numpy(), TCFG.orb_scale_factor)
        assert len(sj) > 100
        shared = len(sj & st) / max(len(sj), len(st))
        assert shared >= 0.95, (eye, shared, len(sj), len(st))


def test_first_frame_keypoints_equal_on_kernel_branch(run, kernel_run):
    """(a) against the JAX kernel branch: the same corners, bit for bit
    (uv, level, valid), in each eye."""
    imgs = np.stack([run["L"][0], run["R"][0]])
    th = np.full(2, float(TCFG.orb_fast_th), np.float32)
    det_t = tframe.detect_points_multilevel(torch.from_numpy(imgs),
                                            torch.from_numpy(th), TCFG)
    for eye, det_j in enumerate(kernel_run["dets"]):
        assert det_j.valid.sum() > 100
        for f in ("uv", "level", "valid"):
            np.testing.assert_array_equal(getattr(det_t, f)[eye].numpy(),
                                          getattr(det_j, f), err_msg=f)


def test_sequence_ate_against_jax(run):
    """(b) ATE < 0.1 m (the JAX e2e gate), good fraction > 0.7 on frames
    1-7, and |ATE_port - ATE_jax| <= 0.02 m: the two FAST branches pick
    ~2-5% different corners, which moves a cm-level ATE by a few mm."""
    tel = run["t_tel"]
    gt = run["poses"].astype(np.float64)
    ate_t = tmetrics.ate_rmse(tel.Tfw.numpy().astype(np.float64), gt)
    ate_j = jmetrics.ate_rmse(run["j_tfw"].astype(np.float64), gt)
    good = tel.good.numpy()
    assert ate_t < 0.1, ate_t
    assert good[1:].mean() > 0.7, good
    assert abs(ate_t - ate_j) <= 0.02, (ate_t, ate_j)
    assert run["j_good"][1:].mean() > 0.7
    np.testing.assert_array_equal(tel.Tfw[0].numpy(), np.eye(4))
    assert (tel.n_points[1:].numpy() > 20).all()
    th = tel.fast_th.numpy()
    assert (th >= TCFG.fast_min_th).all() and (th <= TCFG.fast_max_th).all()


def test_sequence_ate_against_jax_kernel_branch(run, kernel_run):
    """(b) against the JAX kernel branch: |ATE_port - ATE_jax| <= 5 mm.
    Corners are identical, but the blur before rBRIEF rounds differently
    (XLA contracts its multiply-adds, the port does not; <= 3e-5 on
    0..255, test_torch_image.py), which flips a few level-0 descriptor
    bits; on frame 1 that changes one stereo match, and the next frame's
    increment then moves by about 1 cm, which the later frames carry.
    Every single step is held to 1e-4 m in test_every_step_from_jax_state."""
    gt = run["poses"].astype(np.float64)
    ate_t = tmetrics.ate_rmse(run["t_tel"].Tfw.numpy().astype(np.float64),
                              gt)
    j_tfw = np.stack([t.Tfw for t in kernel_run["tels"]])
    ate_j = jmetrics.ate_rmse(j_tfw.astype(np.float64), gt)
    assert ate_j < 0.1, ate_j
    assert abs(ate_t - ate_j) <= 0.005, (ate_t, ate_j)


def test_every_step_from_jax_state(run, kernel_run):
    """Each frame of the sequence, started in the port from the JAX
    kernel branch's incoming state: the pose agrees to 1e-4 m and 1e-5 in
    rotation (float32 rounding of blur, disparity and GN sums: observed
    <= 2e-5 m), and the step's discrete outputs (matches, inliers,
    iterations, FAST threshold, keyframe flag) are equal."""
    for i in range(N_FRAMES):
        state = convert.state_from_numpy(kernel_run["states"][i], "cpu")
        _, tel = tfront.vo_step(state, torch.from_numpy(run["L"][i]),
                                torch.from_numpy(run["R"][i]), TCAM, TCFG)
        tj = kernel_run["tels"][i]
        T_t = tel.Tfw.numpy()
        np.testing.assert_allclose(T_t[:3, 3], tj.Tfw[:3, 3], atol=1e-4,
                                   err_msg=f"frame {i}")
        np.testing.assert_allclose(T_t[:3, :3], tj.Tfw[:3, :3], atol=1e-5,
                                   err_msg=f"frame {i}")
        for f in ("good", "n_points", "n_inliers_pt", "opt_iters", "fast_th",
                  "is_kf"):
            assert getattr(tel, f).item() == getattr(tj, f).item(), (i, f)


def test_batched_equals_unbatched(run):
    """(c) two lanes in one batched step equal two unbatched runs (lane 1
    starts at frame 3): the same per-lane arithmetic, bit for bit."""
    L, R = torch.from_numpy(run["L"]), torch.from_numpy(run["R"])
    n = 3
    st = batched.init_batched_state(TCFG, 2, device="cpu")
    tels = []
    for i in range(n):
        st, t = batched.vo_step_batched(
            st, torch.stack([L[i], L[3 + i]]), torch.stack([R[i], R[3 + i]]),
            TCAM, TCFG)
        tels.append(t)
    for lane, start in enumerate((0, 3)):
        s1 = tfront.init_state(TCFG, device="cpu")
        _, tel1 = tfront.vo_scan(s1, L[start:start + n], R[start:start + n],
                                 TCAM, TCFG)
        for i in range(n):
            assert torch.equal(tels[i].Tfw[lane], tel1.Tfw[i]), (lane, i)
            assert torch.equal(tels[i].n_inliers_pt[lane],
                               tel1.n_inliers_pt[i])
            assert bool(tels[i].good[lane]) == bool(tel1.good[i])


def test_state_carried_from_jax(run, kernel_run):
    """(d) the JAX state after frames 0..2 continues in the port for frame
    3, and the numpy round trip of the state is bit-exact.

    Against the XLA branch (which picks a few percent other corners, and a
    single-frame increment on this 240x180 scene scatters by 1-3 cm) the
    carried pose agrees with JAX's to 3 cm and 5e-3 in rotation and lies
    within 3 cm of the truth; against the kernel branch,
    which picks the same corners, it agrees to 1e-4 m and 1e-5 in rotation
    (float32 rounding, as in test_every_step_from_jax_state)."""
    for tree in (run["carried"], kernel_run["states"][CARRY_AT]):
        back = convert.state_to_numpy(convert.state_from_numpy(tree, "cpu"))
        for a, b in zip(_tree_leaves(tree), _tree_leaves(back)):
            assert a.dtype == b.dtype and a.shape == b.shape
            np.testing.assert_array_equal(a, b)

    i = CARRY_AT
    state = convert.state_from_numpy(run["carried"], device="cpu")
    assert state.prev_points.desc.dtype == torch.int32
    _, tel = tfront.vo_step(state, torch.from_numpy(run["L"][i]),
                            torch.from_numpy(run["R"][i]), TCAM, TCFG)
    assert bool(tel.good)
    T_t, T_j = tel.Tfw.numpy(), run["j_tfw"][i]
    np.testing.assert_allclose(T_t[:3, 3], T_j[:3, 3], atol=0.03)
    np.testing.assert_allclose(T_t[:3, :3], T_j[:3, :3], atol=5e-3)
    assert np.linalg.norm(T_t[:3, 3] - run["poses"][i, :3, 3]) < 0.03

    state = convert.state_from_numpy(kernel_run["states"][i], device="cpu")
    _, tel = tfront.vo_step(state, torch.from_numpy(run["L"][i]),
                            torch.from_numpy(run["R"][i]), TCAM, TCFG)
    T_t, T_j = tel.Tfw.numpy(), kernel_run["tels"][i].Tfw
    np.testing.assert_allclose(T_t[:3, 3], T_j[:3, 3], atol=1e-4)
    np.testing.assert_allclose(T_t[:3, :3], T_j[:3, :3], atol=1e-5)
