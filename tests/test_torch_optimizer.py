"""The port's pose optimizer against the JAX package's on the same point
and line matches (with injected outliers): GN, robust GN and LM, and the
whole optimizePose state machine.  The port solves all problems as lanes
of one batch; the JAX package solves each alone.

Tolerances: float32 in both, with other summation orders.  DT to 2e-4
(translations of ~0.3 m, rotations of ~0.02 rad); err to a relative 1e-3
(it is quadratic in the residuals); cov and its eigenvalues to 2e-3 of
the largest entry (cov = H^-1, and H's condition number, ~1e4 here,
amplifies the float32 rounding of H); the discrete outputs (good,
iteration counts, inlier masks) exactly."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from stvo_pl_tpu.config import VOConfig as JCfg
from stvo_pl_tpu.models import features as jfeat
from stvo_pl_tpu.models import optimizer as jopt
from stvo_pl_tpu.ops import camera as jcam
from stvo_pl_tpu_torch.config import VOConfig as TCfg
from stvo_pl_tpu_torch.models import features as tfeat
from stvo_pl_tpu_torch.models import optimizer as topt
from stvo_pl_tpu_torch.ops import camera as tcam

torch.set_num_threads(1)

CAM_ARGS = dict(fx=500.0, fy=500.0, cx=320.0, cy=240.0, b=0.12, width=640,
                height=480)
JCAM = jcam.StereoCamera(**CAM_ARGS)
TCAM = tcam.StereoCamera(**CAM_ARGS)


def _expmap(xi):
    from scipy.linalg import expm
    W = np.zeros((4, 4))
    W[:3, 3] = xi[:3]
    wx, wy, wz = xi[3:]
    W[:3, :3] = [[0, -wz, wy], [wz, 0, -wx], [-wy, wx, 0]]
    return expm(W)


def _proj(P, T):
    Pc = P @ T[:3, :3].T + T[:3, 3]
    return np.stack([CAM_ARGS["fx"] * Pc[:, 0] / Pc[:, 2] + CAM_ARGS["cx"],
                     CAM_ARGS["fy"] * Pc[:, 1] / Pc[:, 2] + CAM_ARGS["cy"]],
                    -1)


def make_problem(rng, n_pts=128, n_valid=100, n_out=12, n_lines=48,
                 n_lines_valid=32, noise=0.3):
    """Seeded numpy point + line matches under a small motion."""
    T = _expmap(rng.normal(0, [0.05, 0.02, 0.3, 0.01, 0.02, 0.005]))
    P = rng.uniform([-3, -2, 4], [3, 2, 15], (n_pts, 3))
    obs = _proj(P, T) + rng.normal(0, noise, (n_pts, 2))
    idx = rng.choice(n_valid, n_out, replace=False)
    obs[idx] += rng.uniform(20, 60, (n_out, 2)) * rng.choice([-1, 1],
                                                             (n_out, 2))
    valid = np.arange(n_pts) < n_valid
    sigma2 = 1.2 ** (-2.0 * rng.integers(0, 4, n_pts))
    pts = dict(P=P, obs=obs, sigma2=sigma2, valid=valid,
               inlier=np.ones(n_pts, bool))

    sP = rng.uniform([-3, -2, 4], [3, 2, 15], (n_lines, 3))
    d = rng.uniform(-1, 1, (n_lines, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    eP = sP + d * rng.uniform(0.5, 2.0, (n_lines, 1))
    sp_o = _proj(sP, T) + rng.normal(0, noise, (n_lines, 2))
    ep_o = _proj(eP, T) + rng.normal(0, noise, (n_lines, 2))
    one = np.ones((n_lines, 1))
    le = np.cross(np.concatenate([sp_o, one], -1),
                  np.concatenate([ep_o, one], -1))
    le /= np.linalg.norm(le[:, :2], axis=-1, keepdims=True)
    lines = dict(sP=sP, eP=eP, spl=_proj(sP, np.eye(4)),
                 epl=_proj(eP, np.eye(4)), le_obs=le,
                 sigma2=np.ones(n_lines), valid=np.arange(n_lines)
                 < n_lines_valid, inlier=np.ones(n_lines, bool))
    cast = lambda v: v if v.dtype == bool else v.astype(np.float32)
    return ({k: cast(v) for k, v in pts.items()},
            {k: cast(v) for k, v in lines.items()})


def _jax(cls, d):
    return cls(**{k: jnp.asarray(v) for k, v in d.items()})


def _torch_batch(cls, ds):
    return cls(**{k: torch.from_numpy(np.stack([d[k] for d in ds]))
                  for k in ds[0]})


def _close_scaled(t, j):
    np.testing.assert_allclose(t, j, rtol=0, atol=2e-3 * np.abs(j).max())


_J_GN = jax.jit(jopt.gauss_newton, static_argnames=(
    "cam", "cfg", "max_iters", "robust_scaled"))
_J_LM = jax.jit(jopt.levenberg_marquardt, static_argnames=(
    "cam", "cfg", "max_iters"))


CASES = {
    # name: (cfg overrides, number of lines valid)
    "gn_points": (dict(has_lines=False), 0),
    "gn_points_lines": (dict(), 32),
    "robust": (dict(optim_mode=1), 32),
    "lm": (dict(optim_mode=2), 32),
    "tukey_motion_model": (dict(robust_kernel="tukey",
                                use_motion_model=True), 0),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_optimize_pose_matches_jax(rng, case):
    over, n_lv = CASES[case]
    jcfg, tcfg = JCfg(**over), TCfg(**over)
    probs = [make_problem(rng, n_lines_valid=n_lv) for _ in range(3)]
    # a starved lane (too few features -> identity failure)
    probs.append(make_problem(rng, n_valid=6, n_out=1, n_lines_valid=0))
    DT_prev = np.stack([_expmap(rng.normal(0, 0.01, 6)).astype(np.float32)
                        for _ in probs])
    cov_prev = np.stack([np.eye(6, dtype=np.float32) * 1e-3] * len(probs))

    t_est, t_pm, t_lm = topt.optimize_pose(
        _torch_batch(tfeat.PointMatches, [p for p, _ in probs]),
        _torch_batch(tfeat.LineMatches, [l for _, l in probs]), TCAM, tcfg,
        torch.from_numpy(DT_prev), torch.from_numpy(cov_prev),
        torch.full((len(probs),), 0.5))
    for b, (pts, lines) in enumerate(probs):
        j_est, j_pm, j_lm = jopt.optimize_pose(
            _jax(jfeat.PointMatches, pts), _jax(jfeat.LineMatches, lines),
            JCAM, jcfg, jnp.asarray(DT_prev[b]), jnp.asarray(cov_prev[b]),
            jnp.float32(0.5))
        assert bool(t_est.good[b]) == bool(j_est.good), (case, b)
        if b < 3:
            # (the starved lane's discarded solves run on 6 points; their
            # iteration counts are not part of the committed result)
            assert int(t_est.iters[b]) == int(j_est.iters), (case, b)
        np.testing.assert_allclose(t_est.DT[b].numpy(), np.asarray(j_est.DT),
                                   atol=2e-4)
        np.testing.assert_allclose(t_est.err_norm[b].numpy(),
                                   np.asarray(j_est.err_norm), rtol=1e-3,
                                   atol=1e-7)
        _close_scaled(t_est.DT_cov[b].numpy(), np.asarray(j_est.DT_cov))
        _close_scaled(t_est.DT_cov_eig[b].numpy(),
                      np.asarray(j_est.DT_cov_eig))
        np.testing.assert_array_equal(t_pm.inlier[b].numpy(),
                                      np.asarray(j_pm.inlier))
        np.testing.assert_array_equal(t_lm.inlier[b].numpy(),
                                      np.asarray(j_lm.inlier))
        assert int(t_est.n_inliers_pt[b]) == int(j_est.n_inliers_pt)
    assert bool(t_est.good[:3].all()) and not bool(t_est.good[3])


@pytest.mark.parametrize("solver", ["gn", "robust_gn", "lm"])
def test_solvers_match_jax(rng, solver):
    probs = [make_problem(rng) for _ in range(3)]
    jcfg, tcfg = JCfg(), TCfg()
    DT0 = np.eye(4, dtype=np.float32)
    pm_t = _torch_batch(tfeat.PointMatches, [p for p, _ in probs])
    lm_t = _torch_batch(tfeat.LineMatches, [l for _, l in probs])
    DT0_t = torch.from_numpy(np.stack([DT0] * len(probs)))
    if solver == "lm":
        t_res = topt.levenberg_marquardt(DT0_t, pm_t, lm_t, TCAM, tcfg, 10)
    else:
        t_res = topt.gauss_newton(DT0_t, pm_t, lm_t, TCAM, tcfg, 10,
                                  robust_scaled=solver == "robust_gn")
    for b, (pts, lines) in enumerate(probs):
        args = (jnp.asarray(DT0), _jax(jfeat.PointMatches, pts),
                _jax(jfeat.LineMatches, lines))
        if solver == "lm":
            j_res = _J_LM(*args, cam=JCAM, cfg=jcfg, max_iters=10)
        else:
            j_res = _J_GN(*args, cam=JCAM, cfg=jcfg, max_iters=10,
                          robust_scaled=solver == "robust_gn")
        assert int(t_res.iters[b]) == int(j_res.iters)
        np.testing.assert_allclose(t_res.DT[b].numpy(), np.asarray(j_res.DT),
                                   atol=2e-4)
        np.testing.assert_allclose(t_res.err[b].numpy(),
                                   np.asarray(j_res.err), rtol=1e-3)
        _close_scaled(t_res.cov[b].numpy(), np.asarray(j_res.cov))
