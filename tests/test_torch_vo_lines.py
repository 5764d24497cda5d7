"""The default point + line VO step of the port end to end, against the
JAX package on the same frames (the 8-frame 240x180 sequence of
tests/test_e2e_vo.py with its point + line configuration, rendered by
stvo_pl_tpu.utils.synthetic and handed to both as numpy).

On the CPU the JAX package detects FAST corners and line runs by other
code than on a TPU (its dense XLA branches); the port always follows the
kernel branches.  Against the XLA branches the trajectories are compared
within loose tolerances.  The `kernel_run` fixture makes the JAX package
take its kernel branches too (interpret-mode Pallas for FAST and for the
all-direction run kernel), so that both detect the same corners and
lines; against it every single step is held tightly.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from stvo_pl_tpu.config import VOConfig as JCfg
from stvo_pl_tpu.models import frontend as jfront
from stvo_pl_tpu.utils import metrics as jmetrics
from stvo_pl_tpu_torch import convert
from stvo_pl_tpu_torch.config import VOConfig as TCfg
from stvo_pl_tpu_torch.models import frontend as tfront
from stvo_pl_tpu_torch.ops import camera as tcam
from stvo_pl_tpu_torch.parallel import batched
from stvo_pl_tpu_torch.utils import metrics as tmetrics

from test_torch_helpers import (CAM_ARGS, JCAM, SMALL, jax_kernel_branch,
                                rendered_sequence)

torch.set_num_threads(1)

TCAM = tcam.StereoCamera(**CAM_ARGS)
JCFG = JCfg(**SMALL)
TCFG = TCfg(**SMALL)
N_FRAMES = 8


def _jax_run(L, R):
    """The JAX package over the sequence: each frame's incoming state and
    its telemetry, as numpy."""
    state = jfront.init_state(JCFG)
    states, tels = [], []
    for i in range(N_FRAMES):
        states.append(jax.tree_util.tree_map(np.asarray, state))
        state, t = jfront.vo_step(state, jnp.asarray(L[i]), jnp.asarray(R[i]),
                                  JCAM, JCFG)
        tels.append(jax.tree_util.tree_map(np.asarray, t))
    return states, tels


@pytest.fixture(scope="module")
def run():
    L, R, poses = rendered_sequence(N_FRAMES)
    _, j_tels = _jax_run(L, R)
    t_state = tfront.init_state(TCFG, device="cpu")
    _, t_tel = tfront.vo_scan(t_state, torch.from_numpy(L),
                              torch.from_numpy(R), TCAM, TCFG)
    return dict(L=L, R=R, poses=poses, j_tels=j_tels, t_tel=t_tel)


@pytest.fixture(scope="module")
def kernel_run(run):
    with jax_kernel_branch():
        states, tels = _jax_run(run["L"], run["R"])
    return dict(states=states, tels=tels)


def _ate(tfw, poses):
    return tmetrics.ate_rmse(np.asarray(tfw, np.float64),
                             poses.astype(np.float64))


def test_sequence_ate_with_lines_against_jax(run):
    """ATE < 0.1 m (the JAX e2e gate), good fraction > 0.7 on frames 1-7,
    and |ATE_port - ATE_jax| <= 0.02 m against the JAX package's CPU
    branches, which pick a few percent other corners and other line
    candidates: that moves a cm-level ATE by a few mm."""
    tel = run["t_tel"]
    ate_t = _ate(tel.Tfw.numpy(), run["poses"])
    j_tfw = np.stack([t.Tfw for t in run["j_tels"]])
    ate_j = jmetrics.ate_rmse(j_tfw.astype(np.float64),
                              run["poses"].astype(np.float64))
    good = tel.good.numpy()
    assert ate_t < 0.1, ate_t
    assert good[1:].mean() > 0.7, good
    assert abs(ate_t - ate_j) <= 0.02, (ate_t, ate_j)
    np.testing.assert_array_equal(tel.Tfw[0].numpy(), np.eye(4))
    assert (tel.n_points[1:].numpy() > 20).all()
    assert tel.n_lines.numpy().sum() > 0, "no line was ever tracked"


def test_sequence_ate_with_lines_against_jax_kernel_branch(run, kernel_run):
    """Against the JAX kernel branches the chained trajectories agree to
    5 mm of ATE (the blur's rounding flips a few descriptor bits, see
    tests/test_torch_vo.py)."""
    ate_t = _ate(run["t_tel"].Tfw.numpy(), run["poses"])
    ate_j = _ate(np.stack([t.Tfw for t in kernel_run["tels"]]), run["poses"])
    assert ate_j < 0.1, ate_j
    assert abs(ate_t - ate_j) <= 0.005, (ate_t, ate_j)


def test_every_step_with_lines_from_jax_state(run, kernel_run):
    """Each frame started in the port from the JAX kernel branches'
    incoming state (points AND lines of the previous frame): the pose
    agrees to 1e-4 m and 1e-5 in rotation, and the discrete outputs
    (point and line matches, inliers, iterations, FAST threshold, keyframe
    flag) are equal."""
    n_line_frames = 0
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
        for f in ("good", "n_points", "n_inliers_pt", "n_lines",
                  "n_inliers_ls", "opt_iters", "fast_th", "is_kf"):
            assert getattr(tel, f).item() == getattr(tj, f).item(), (i, f)
        n_line_frames += int(tj.n_inliers_ls > 0)
    assert n_line_frames >= 3, "lines must take part in the pose"


def test_batched_equals_unbatched_with_lines(run):
    """Two lanes in one batched step equal two unbatched runs (lane 1
    starts at frame 3), bit for bit, lines included."""
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
        s1, tel1 = tfront.vo_scan(s1, L[start:start + n], R[start:start + n],
                                  TCAM, TCFG)
        for i in range(n):
            assert torch.equal(tels[i].Tfw[lane], tel1.Tfw[i]), (lane, i)
            for f in ("n_inliers_pt", "n_lines", "n_inliers_ls", "good"):
                assert torch.equal(getattr(tels[i], f)[lane],
                                   getattr(tel1, f)[i]), (lane, i, f)
        for a, b in zip(st.prev_lines, s1.prev_lines):
            assert torch.equal(a[lane], b)


def test_state_with_lines_round_trips(kernel_run):
    """A JAX state whose previous frame holds valid lines goes through
    `convert` and back bit for bit, dtypes and shapes kept."""
    tree = next(s for s in kernel_run["states"][1:]
                if s.prev_lines.valid.sum() >= 2)
    state = convert.state_from_numpy(tree, "cpu")
    assert state.prev_lines.desc.dtype == torch.int32
    assert int(state.prev_lines.valid.sum()) >= 2
    back = convert.state_to_numpy(state)
    for a, b in zip(jax.tree_util.tree_leaves(tree),
                    jax.tree_util.tree_leaves(back)):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
