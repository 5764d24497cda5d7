"""The dense single-octave VO step of the port (`lsd_octaves=1`) end to
end against the JAX package on the same frames (the 8-frame 240x180
sequence of tests/test_e2e_vo.py), for both run candidate generators.

The JAX package picks its generator by backend; the port takes it as an
argument.  Both are held to JAX with FAST on its kernel branch
(interpret-mode Pallas), so that the corners are the same:

  * `per_direction`: the port with `per_direction=True` against the JAX
    line detector unpatched, i.e. on the per-direction generator it runs
    on the CPU;
  * `all_direction`: the port's default against the JAX line detector
    forced onto its all-direction kernel branch as well.

Every single step started from JAX's incoming state agrees to 1e-4 m and
1e-5 in rotation with equal point and line counts; the chained
trajectories agree to 5 mm of ATE (the blur's rounding flips a few
descriptor bits, see tests/test_torch_vo.py), each below the 0.1 m gate.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from stvo_pl_tpu.config import VOConfig as JCfg
from stvo_pl_tpu.models import frontend as jfront
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
JCFG = JCfg(lsd_octaves=1, **SMALL)
TCFG = TCfg(lsd_octaves=1, **SMALL)
N_FRAMES = 8
GENERATORS = ["per_direction", "all_direction"]


@pytest.fixture(scope="module")
def frames():
    return rendered_sequence(N_FRAMES)


@pytest.fixture(scope="module", params=GENERATORS)
def runs(request, frames):
    """One generator: JAX's incoming states and telemetry per frame, and
    the port's chained run."""
    L, R, poses = frames
    per_direction = request.param == "per_direction"
    with jax_kernel_branch(lsd=not per_direction):
        state = jfront.init_state(JCFG)
        states, tels = [], []
        for i in range(N_FRAMES):
            states.append(jax.tree_util.tree_map(np.asarray, state))
            state, t = jfront.vo_step(state, jnp.asarray(L[i]),
                                      jnp.asarray(R[i]), JCAM, JCFG)
            tels.append(jax.tree_util.tree_map(np.asarray, t))
    t_state = tfront.init_state(TCFG, device="cpu")
    _, t_tel = tfront.vo_scan(t_state, torch.from_numpy(L),
                              torch.from_numpy(R), TCAM, TCFG,
                              per_direction=per_direction)
    return dict(per_direction=per_direction, states=states, tels=tels,
                t_tel=t_tel)


def _ate(tfw, poses):
    return tmetrics.ate_rmse(np.asarray(tfw, np.float64),
                             poses.astype(np.float64))


def test_dense_sequence_ate_against_jax(frames, runs):
    poses = frames[2]
    tel = runs["t_tel"]
    ate_t = _ate(tel.Tfw.numpy(), poses)
    ate_j = _ate(np.stack([t.Tfw for t in runs["tels"]]), poses)
    assert ate_t < 0.1, ate_t
    assert ate_j < 0.1, ate_j
    assert abs(ate_t - ate_j) <= 0.005, (ate_t, ate_j)
    assert tel.good.numpy()[1:].mean() > 0.7
    np.testing.assert_array_equal(tel.Tfw[0].numpy(), np.eye(4))
    assert tel.n_lines.numpy().sum() > 0, "no line was ever tracked"


def test_every_dense_step_from_jax_state(frames, runs):
    L, R, _ = frames
    n_line_frames = 0
    for i in range(N_FRAMES):
        state = convert.state_from_numpy(runs["states"][i], "cpu")
        _, tel = tfront.vo_step(state, torch.from_numpy(L[i]),
                                torch.from_numpy(R[i]), TCAM, TCFG,
                                per_direction=runs["per_direction"])
        tj = runs["tels"][i]
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


@pytest.mark.parametrize("per_direction", [True, False],
                         ids=GENERATORS)
def test_dense_batched_equals_unbatched(frames, per_direction):
    """Two lanes in one batched dense step equal two unbatched runs (lane 1
    starts at frame 3), with `lsd_right_lite` on: poses to 1e-6 m and
    counts, validity and descriptors of the carried lines equal, their
    coordinates to 1e-3 (PyTorch's CPU kernels evaluate atan2, sin and cos
    in vector lanes or in a scalar tail depending on a tensor's size, an
    ulp apart, which the refit carries into the endpoints)."""
    cfg = TCFG.replace(lsd_right_lite=True)
    L, R = torch.from_numpy(frames[0]), torch.from_numpy(frames[1])
    n = 2
    st = batched.init_batched_state(cfg, 2, device="cpu")
    tels = []
    for i in range(n):
        st, t = batched.vo_step_batched(
            st, torch.stack([L[i], L[3 + i]]), torch.stack([R[i], R[3 + i]]),
            TCAM, cfg, per_direction=per_direction)
        tels.append(t)
    for lane, start in enumerate((0, 3)):
        s1 = tfront.init_state(cfg, device="cpu")
        s1, tel1 = tfront.vo_scan(s1, L[start:start + n], R[start:start + n],
                                  TCAM, cfg, per_direction=per_direction)
        for i in range(n):
            torch.testing.assert_close(tels[i].Tfw[lane], tel1.Tfw[i],
                                       atol=1e-6, rtol=0)
            for f in ("n_inliers_pt", "n_lines", "n_inliers_ls", "good"):
                assert torch.equal(getattr(tels[i], f)[lane],
                                   getattr(tel1, f)[i]), (lane, i, f)
        for f, a, b in zip(st.prev_lines._fields, st.prev_lines,
                           s1.prev_lines):
            if a.dtype.is_floating_point:
                torch.testing.assert_close(a[lane], b, atol=1e-3, rtol=1e-4,
                                           msg=f)
            else:
                assert torch.equal(a[lane], b), f
        assert int(s1.prev_lines.valid.sum()) > 0
