"""The port's windowed bundle adjustment (stvo_pl_tpu_torch/parallel/ba.py)
against the JAX package's on the same problem.

The problem is made from a numpy seed: 4 keyframes moving forward, 160
point landmarks and 24 line landmarks seen in random subsets of them,
with perturbed landmark and pose inits and pixel noise on the
observations; both packages get the same numpy arrays.

Tolerances: both sides compute in float32 and sum in other orders, so a
single evaluation (residuals, Jacobians, one Schur system) is held to
rtol 1e-5 / 2e-5 with an absolute floor of 1e-4 of the largest entry;
the iterated solve (8 Gauss-Newton steps, each a 24x24 float32 solve) to
2e-5 on the poses, 1e-3 m on the points, 5e-3 m on the line endpoints and
rtol 1e-4 on the costs.  Those are about 3x the distance of either
package's float32 result from a float64 solve of the same problem
(measured: 3.5e-6, 1.4e-4 and 8.5e-4 m after 8 steps), which is the
float32 floor of this conditioning, not a difference of method.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from stvo_pl_tpu.ops import camera as jcam
from stvo_pl_tpu.ops import se3 as jse3
from stvo_pl_tpu.parallel import ba as jba
from stvo_pl_tpu_torch import convert
from stvo_pl_tpu_torch.ops import camera as tcam
from stvo_pl_tpu_torch.parallel import ba as tba

torch.set_num_threads(1)

CAM_ARGS = dict(fx=160.0, fy=160.0, cx=120.0, cy=90.0, b=0.3, width=240,
                height=180)
JCAM = jcam.StereoCamera(**CAM_ARGS)
TCAM = tcam.StereoCamera(**CAM_ARGS)
K, N, NL = 4, 160, 24


def _project(T_cw, P):
    Pc = P @ T_cw[:3, :3].T + T_cw[:3, 3]
    u = CAM_ARGS["cx"] + CAM_ARGS["fx"] * Pc[..., 0] / Pc[..., 2]
    v = CAM_ARGS["cy"] + CAM_ARGS["fy"] * Pc[..., 1] / Pc[..., 2]
    return Pc, u, v


def _twist(rng, sigma_t, sigma_r):
    xi = np.concatenate([rng.normal(0, sigma_t, 3), rng.normal(0, sigma_r, 3)])
    return np.asarray(jse3.expmap_se3(jnp.asarray(xi, jnp.float32)),
                      np.float64)


def make_problem(seed=0, lines=True):
    """(poses_cw [K,4,4] f32 perturbed, true poses, BAProblem of numpy)."""
    rng = np.random.default_rng(seed)
    Tfw = np.stack([np.eye(4) for _ in range(K)])
    for k in range(K):
        Tfw[k, :3, 3] = [0.05 * k, 0.0, 0.4 * k]
    Tcw = np.linalg.inv(Tfw)
    X = np.stack([rng.uniform(-4, 4, N), rng.uniform(-2, 2, N),
                  rng.uniform(6, 20, N)], -1)
    obs = np.zeros((N, K, 3))
    for k in range(K):
        Pc, u, v = _project(Tcw[k], X)
        u_r = CAM_ARGS["cx"] + CAM_ARGS["fx"] * (Pc[:, 0] - CAM_ARGS["b"]) \
            / Pc[:, 2]
        obs[:, k] = np.stack([u, v, u_r], -1) + rng.normal(0, 0.3, (N, 3))
    mask = rng.uniform(size=(N, K)) < 0.7
    mask[:N // 8, 1:] = False            # seen once: rank-2 blocks
    prob = dict(X=(X + rng.normal(0, 0.05, X.shape)).astype(np.float32),
                obs=obs.astype(np.float32), mask=mask,
                sigma2=rng.choice([1.0, 1.44, 2.07], N).astype(np.float32))
    if lines:
        A = np.stack([rng.uniform(-4, 4, NL), rng.uniform(-2, 2, NL),
                      rng.uniform(7, 18, NL)], -1)
        d = rng.normal(size=(NL, 3))
        d /= np.linalg.norm(d, axis=-1, keepdims=True)
        Xl = np.stack([A, A + 2.5 * d], 1)                 # [NL, 2, 3]
        obs_l = np.zeros((NL, K, 7))
        for k in range(K):
            _, u, v = _project(Tcw[k], Xl)
            s = np.stack([u[:, 0], v[:, 0]], -1) + rng.normal(0, 0.3, (NL, 2))
            e = np.stack([u[:, 1], v[:, 1]], -1) + rng.normal(0, 0.3, (NL, 2))
            le = np.cross(np.concatenate([s, np.ones((NL, 1))], -1),
                          np.concatenate([e, np.ones((NL, 1))], -1))
            le /= np.linalg.norm(le[:, :2], axis=-1, keepdims=True)
            obs_l[:, k] = np.concatenate([le, s, e], -1)
        mask_l = rng.uniform(size=(NL, K)) < 0.8
        mask_l[:3, 1:] = False           # seen once: rank-1 endpoint blocks
        prob.update(
            Xl=(Xl + rng.normal(0, 0.05, Xl.shape)).astype(np.float32),
            obs_l=obs_l.astype(np.float32), mask_l=mask_l,
            sigma2_l=np.ones(NL, np.float32))
    else:
        prob.update(Xl=None, obs_l=None, mask_l=None, sigma2_l=None)
    pert = Tcw.copy()
    for k in range(1, K):
        pert[k] = _twist(rng, 0.03, 0.005) @ pert[k]
    return pert.astype(np.float32), Tcw, prob


def _both(prob, poses):
    jp = jba.BAProblem(**{k: None if v is None else jnp.asarray(v)
                          for k, v in prob.items()})
    tp = convert.problem_from_numpy(prob, device="cpu")
    return jp, tp, jnp.asarray(poses), torch.from_numpy(poses)


def _close(t, j, rtol, scale_atol=1e-4):
    t = t.detach().numpy() if torch.is_tensor(t) else np.asarray(t)
    j = np.asarray(j)
    atol = scale_atol * max(float(np.abs(j).max()), 1e-12)
    np.testing.assert_allclose(t, j, rtol=rtol, atol=atol)


def test_inv3_against_jax():
    """Random, rank-2 and rank-1 3x3 blocks (damped as the BA damps them)
    and an all-zero block (the clamped determinant): the adjugate inverse
    agrees, and damped rank-deficient blocks stay finite."""
    rng = np.random.default_rng(1)
    Ms = [rng.normal(size=(64, 3, 3)) + 4 * np.eye(3)]
    for rank in (2, 1):
        J = rng.normal(size=(64, rank, 3)) * rng.uniform(1, 300, (64, 1, 1))
        Ms.append(np.einsum("nai,naj->nij", J, J))
    M = np.concatenate(Ms).astype(np.float32)
    _close(tba._inv3(torch.from_numpy(M[:64])), jba._inv3(jnp.asarray(M[:64])),
           2e-5)
    t = tba._invert_landmark_blocks(torch.from_numpy(M))
    j = jba._invert_landmark_blocks(jnp.asarray(M))
    assert torch.isfinite(t).all()
    for lo in (0, 64, 128):      # each kind against its own scale
        _close(t[lo:lo + 64], np.asarray(j)[lo:lo + 64], 1e-4)
    z = np.zeros((2, 3, 3), np.float32)
    np.testing.assert_array_equal(tba._inv3(torch.from_numpy(z)).numpy(),
                                  np.asarray(jba._inv3(jnp.asarray(z))))


def test_residuals_and_jacobians_against_jax():
    poses, _, prob = make_problem()
    jp, tp, jP, tP = _both(prob, poses)
    for t, j in zip(tba._residuals_jacobians(tP, tp.X, tp.obs, TCAM),
                    jba._residuals_jacobians(jP, jp.X, jp.obs, JCAM)):
        _close(t, j, 1e-5)
    for t, j in zip(
            tba._line_residuals_jacobians(tP, tp.Xl, tp.obs_l, TCAM),
            jba._line_residuals_jacobians(jP, jp.Xl, jp.obs_l, JCAM)):
        _close(t, j, 1e-5)


@pytest.mark.parametrize("lines", [False, True], ids=["points", "lines"])
def test_reduced_system_and_chi2_against_jax(lines):
    poses, _, prob = make_problem(lines=lines)
    jp, tp, jP, tP = _both(prob, poses)
    tS, tb, _, t_aux_l, tcost, tn = tba._reduced_system(tP, tp, TCAM)
    jS, jb, _, j_aux_l, jcost, jn = jba._reduced_system(jP, jp, JCAM)
    assert (t_aux_l is None) == (j_aux_l is None) == (not lines)
    _close(tS, jS, 2e-5)
    _close(tb, jb, 2e-5)
    _close(tcost, jcost, 2e-5)
    assert int(tn) == int(jn)
    tc, tn2 = tba.point_chi2(tP, tp, TCAM)
    jc, jn2 = jba.point_chi2(jP, jp, JCAM)
    _close(tc, jc, 2e-5)
    assert int(tn2) == int(jn2)


def test_ba_iteration_against_jax():
    """One step from the perturbed start: the 24x24 solve amplifies the
    float32 rounding of S; each package's step lies 5e-5 to 1.5e-4 m from
    a float64 step of the same problem (poses), 2.7e-4 m (points) and
    1.2e-3 m (line endpoints, partly along their damped null direction),
    so they are held to each other at about 2x that."""
    poses, _, prob = make_problem()
    jp, tp, jP, tP = _both(prob, poses)
    t = tba.ba_iteration(tP, tp, TCAM)
    j = jba.ba_iteration(jP, jp, JCAM)
    for a, b, atol in zip(t[:3], j[:3], (3e-4, 1e-3, 5e-3)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=atol)
    np.testing.assert_allclose(float(t[3]), float(j[3]), rtol=1e-5)


@pytest.mark.parametrize("lines", [False, True], ids=["points", "lines"])
def test_ba_solve_against_jax(lines):
    """8 iterations: poses, landmarks and costs held to the JAX package's,
    and the solve brings the perturbed poses closer to the true ones."""
    poses, Tcw_true, prob = make_problem(lines=lines)
    jp, tp, jP, tP = _both(prob, poses)
    tP2, tX, tXl, tcosts = tba.ba_solve(tP, tp, TCAM, n_iters=8)
    jP2, jX, jXl, jcosts = jba.ba_solve(jP, jp, JCAM, n_iters=8)
    tP2 = tP2.numpy()
    jP2 = np.asarray(jP2)
    np.testing.assert_allclose(tP2[:, :3, 3], jP2[:, :3, 3], rtol=0,
                               atol=2e-5)
    np.testing.assert_allclose(tP2[:, :3, :3], jP2[:, :3, :3], rtol=0,
                               atol=2e-5)
    np.testing.assert_allclose(tX.numpy(), np.asarray(jX), rtol=0, atol=1e-3)
    if lines:
        np.testing.assert_allclose(tXl.numpy(), np.asarray(jXl), rtol=0,
                                   atol=5e-3)
    else:
        assert tXl is None and jXl is None
    np.testing.assert_allclose(tcosts.numpy(), np.asarray(jcosts), rtol=1e-4)
    assert tcosts[-1] < tcosts[0]
    # the solve moves the perturbed poses toward the true ones
    err0 = np.abs(poses[:, :3, 3] - Tcw_true[:, :3, 3]).max()
    err = np.abs(tP2[:, :3, 3] - Tcw_true[:, :3, 3]).max()
    assert err < err0, (err0, err)
