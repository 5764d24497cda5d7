"""The pose optimizer's CUDA kernel (`ops/pose_optim.py`,
`csrc/pose_optim.cu`) against the plain `optimize_pose_plain` on the card.

Marked `gpu`: each test skips unless a CUDA device is present.  Run on a
machine with a card with
`pytest --noconftest -m gpu tests/test_torch_optimizer_cuda.py` (the
shared conftest imports jax).

The problems are those of tests/test_torch_optimizer.py (seeded point and
line matches under a small motion, with injected outliers, and a starved
lane), at 1, 3 and 64 lanes and at the shipped configurations'
capacities.  The kernel sums over the features in float32 in another
(fixed) order than the plain path, so it is held to the plain float32
path with the tolerances tests/test_torch_optimizer.py holds the port to
JAX with: DT to 2e-4, err to a relative 1e-3, cov and its eigenvalues to
2e-3 of the largest entry, good, the inlier masks and their counts
exactly, the iteration counts to +-2 (a solve the other side stops an
iteration or two earlier or later, at the min_error_change gates).

At these capacities the plain float32 answer itself moves with the order
and the platform of its arithmetic.  Run on the same matches in 16 other
orders (only its sums' order changes), on the CPU and in float64, the
plain path disagrees with itself in good or in the inlier masks on up to
57 of 64 lanes with the Tukey kernel and the motion model (a weight cut
off at r = 1, from a start where most are cut off, leaves H of rank one
or two, and whether its Cholesky factor passes is decided by the last
bits), its converged solves stop an iteration apart (half of 18 runs on
one lane take 14 iterations, half 15), and robust GN and LM by up to 4.
So each check holds where the plain path does.  A lane is "stable" where
all those runs agree on every discrete output and lie within the
tolerances of each other's DT, err and cov.  There the kernel agrees:
good exactly, each inlier mask (with its count) but for at most one
decision, a residual within rounding of its threshold, and DT, err, cov
and its eigenvalues within the tolerance plus twice the runs' spread:
against the plain path's answer where the masks are the plain path's,
and otherwise against the plain path's refine from the kernel's masks
(the stage that the masks feed, committed as the plain path commits
it).  The iteration counts of every lane are within 2 plus twice their
spread.

Besides the seeded problems, the kernel is held by the same rule on the
matches of real VO steps: optimize_pose's arguments in 8 steps of the
batched VO on 8 lanes of rendered KITTI-sized sequences, stacked into
64 lanes, under the fleet presets (VOConfig() and
configs/config_points_only.yaml, the default robust kernel); there the
plain path is stable on at least 3 lanes in 4."""

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

pytestmark = pytest.mark.gpu

CAM_ARGS = dict(fx=500.0, fy=500.0, cx=320.0, cy=240.0, b=0.12, width=640,
                height=480)

CASES = {
    # name: (cfg overrides, share of the line capacity valid)
    "gn_points": (dict(has_lines=False), 0.0),
    "gn_points_lines": (dict(), 2 / 3),
    "robust": (dict(optim_mode=1), 2 / 3),
    "lm": (dict(optim_mode=2), 2 / 3),
    "tukey_motion_model": (dict(robust_kernel="tukey",
                                use_motion_model=True), 0.0),
}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


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


def make_problem(rng, n_pts, n_valid, n_out, n_lines, n_lines_valid,
                 noise=0.3):
    """Seeded point + line matches under a small motion (the generator of
    tests/test_torch_optimizer.py, at any capacity)."""
    T = _expmap(rng.normal(0, [0.05, 0.02, 0.3, 0.01, 0.02, 0.005]))
    P = rng.uniform([-3, -2, 4], [3, 2, 15], (n_pts, 3))
    obs = _proj(P, T) + rng.normal(0, noise, (n_pts, 2))
    idx = rng.choice(n_valid, n_out, replace=False)
    obs[idx] += rng.uniform(20, 60, (n_out, 2)) * rng.choice([-1, 1],
                                                             (n_out, 2))
    sigma2 = 1.2 ** (-2.0 * rng.integers(0, 4, n_pts))
    pts = dict(P=P, obs=obs, sigma2=sigma2, valid=np.arange(n_pts) < n_valid,
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
                 sigma2=np.ones(n_lines),
                 valid=np.arange(n_lines) < n_lines_valid,
                 inlier=np.ones(n_lines, bool))
    cast = lambda v: v if v.dtype == bool else v.astype(np.float32)
    return ({k: cast(v) for k, v in pts.items()},
            {k: cast(v) for k, v in lines.items()})


def _batch(cls, ds, dev):
    return cls(**{k: torch.from_numpy(np.stack([d[k] for d in ds])).to(dev)
                  for k in ds[0]})


def _inputs(seed, lanes, n_pts, n_lines, line_share, dev):
    """Matches of `lanes` lanes (the last one starved when lanes > 1) and
    the previous increment, covariance and error."""
    from stvo_pl_tpu_torch.models import features as tfeat
    rng = np.random.default_rng(seed)
    n_valid = max(8, int(0.8 * n_pts))
    probs = [make_problem(rng, n_pts, n_valid, max(1, n_valid // 8),
                          max(n_lines, 1), int(line_share * n_lines))
             for _ in range(lanes - 1 if lanes > 1 else 1)]
    if lanes > 1:
        probs.append(make_problem(rng, n_pts, 6, 1, max(n_lines, 1), 0))
    DT_prev = np.stack([_expmap(rng.normal(0, 0.01, 6)).astype(np.float32)
                        for _ in probs])
    cov_prev = np.stack([np.eye(6, dtype=np.float32) * 1e-3] * len(probs))
    pm = _batch(tfeat.PointMatches, [p for p, _ in probs], dev)
    lm = _batch(tfeat.LineMatches, [l for _, l in probs], dev)
    prev = (torch.from_numpy(DT_prev).to(dev),
            torch.from_numpy(cov_prev).to(dev),
            torch.full((len(probs),), 0.5, device=dev))
    return pm, lm, prev


def _d64(nt):
    return type(nt)(*[t.double() if t.is_floating_point() else t
                      for t in nt])


def _permuted(plain, pm, lm, seed):
    """`plain` on the matches in another order, its inlier masks put back
    in the original order: the plain path with other sums."""
    g = torch.Generator().manual_seed(seed)
    pp = torch.randperm(pm.P.shape[-2], generator=g).to(pm.P.device)
    lp = torch.randperm(lm.sP.shape[-2], generator=g).to(lm.sP.device)
    est, pm2, lm2 = plain(type(pm)(*[t[:, pp] for t in pm]),
                          type(lm)(*[t[:, lp] for t in lm]))
    back = lambda m, perm: m._replace(
        inlier=torch.empty_like(m.inlier).index_copy_(1, perm, m.inlier))
    return est, back(pm2, pp), back(lm2, lp)


def _refined_on(kern, pm, lm, cam, cfg, prev):
    """The plain path's stage-2a refine from the kernel's output inlier
    masks, committed as optimize_pose_plain commits it: the DT, err and
    covariance that the kernel owes on a lane whose masks are not the
    plain path's (a lane that keeps its input masks took the fallback,
    and there the masks differ from no one's).  lm keeps its own masks
    where the kernel ran on a line axis of another size."""
    from stvo_pl_tpu_torch.models import optimizer
    from stvo_pl_tpu_torch.ops import linalg, se3
    DT_prev, cov_prev, err_prev = prev
    DT_init = torch.eye(4, device=DT_prev.device).expand_as(DT_prev)
    if cfg.use_motion_model:
        ok = optimizer.is_good_solution(DT_prev, cov_prev, err_prev)
        DT_init = torch.where(ok[:, None, None], DT_prev, DT_init)
    if kern[2].inlier.shape == lm.inlier.shape:
        lm = lm._replace(inlier=kern[2].inlier)
    r = optimizer._solve(DT_init, pm._replace(inlier=kern[1].inlier), lm,
                         cam, cfg, cfg.max_iters_ref)
    return dict(DT=se3.renormalize_se3(se3.inverse_se3(r.DT)),
                err_norm=r.err, DT_cov=r.cov,
                DT_cov_eig=linalg.eigvalsh6(r.cov))


def _assert_close(k, p, others, refined):
    """k, p: (PoseEstimate, PointMatches, LineMatches) of the kernel and
    of the plain path in float32; others: the plain path's other runs
    (on permuted matches, on the CPU, in float64); refined: _refined_on
    the kernel's masks.  Returns the stable lanes."""
    c = lambda t: t.double().cpu().numpy()
    lanes = lambda x: x.reshape(len(x), -1)
    discrete = lambda o: (o[0].good, o[1].inlier, o[2].inlier,
                          o[0].n_inliers_pt, o[0].n_inliers_ls)
    stable = np.ones(len(p[0].good), bool)
    for o in others:
        for a, b in zip(discrete(p), discrete(o)):
            stable &= lanes((a.cpu() == b.cpu()).numpy()).all(-1)
    names = ("iters", "DT", "err_norm", "DT_cov", "DT_cov_eig")
    own = {}
    for name in names:
        pv = lanes(c(getattr(p[0], name)))
        own[name] = np.max([np.abs(lanes(c(getattr(o[0], name))) - pv)
                            .max(-1) for o in others], axis=0)
        if name != "iters":
            stable &= own[name] <= _tol(name, pv)
    assert torch.equal(k[0].good.cpu()[stable], p[0].good.cpu()[stable])
    same_masks = np.ones_like(stable)
    for m, n in ((1, "n_inliers_pt"), (2, "n_inliers_ls")):
        flips = (k[m].inlier != p[m].inlier).sum(-1).cpu().numpy()
        dn = np.abs(c(getattr(k[0], n)) - c(getattr(p[0], n)))
        assert (flips[stable] <= 1).all() and (dn <= flips)[stable].all(), (
            m, np.nonzero(stable & (flips > 1))[0])
        same_masks &= flips == 0
    # where the masks differ and the lane is good, the plain path's
    # refine from the kernel's masks is the reference
    other_ref = ~same_masks & c(k[0].good).astype(bool)
    for name in names:
        ref = lanes(c(getattr(p[0], name)))
        if name != "iters":
            ref = np.where(other_ref[:, None],
                           lanes(c(refined[name])), ref)
        gap = np.abs(lanes(c(getattr(k[0], name))) - ref).max(-1)
        bad = ~(gap <= _tol(name, ref) + 2 * own[name])
        if name != "iters":
            bad &= stable
        assert not bad.any(), (name, np.nonzero(bad)[0], gap[bad],
                               own[name][bad])
    return stable


def _tol(name, ref):
    """The tolerance of each lane's `name` against ref ([lanes, n]): DT
    2e-4, err relative 1e-3, the covariance and its eigenvalues 2e-3 of
    the lane's largest entry, the iterations 2."""
    if name == "iters":
        return 2.0
    if name == "DT":
        return 2e-4
    if name == "err_norm":
        return 1e-3 * np.abs(ref[:, 0]) + 1e-7
    return 2e-3 * np.abs(ref).max(-1)


@pytest.mark.parametrize("lanes", [1, 3, 64])
@pytest.mark.parametrize("n_pts,n_lines", [(128, 48), (1200, 300),
                                           (2000, 300), (2000, 0)])
@pytest.mark.parametrize("case", sorted(CASES))
def test_kernel_matches_plain(cuda, case, lanes, n_pts, n_lines):
    from stvo_pl_tpu_torch.config import VOConfig
    from stvo_pl_tpu_torch.models import optimizer
    from stvo_pl_tpu_torch.ops import camera, pose_optim
    over, line_share = CASES[case]
    cfg = VOConfig(**over)
    cam = camera.StereoCamera(**CAM_ARGS)
    pm, lm, prev = _inputs(n_pts * 7 + lanes, lanes, n_pts, n_lines,
                           line_share, cuda)
    run = lambda pm, lm, prev=prev: optimizer.optimize_pose_plain(
        pm, lm, cam, cfg, *prev)
    plain = run(pm, lm)
    others = _probes(run, pm, lm, prev, lanes * 100)
    lm_k = lm
    if n_lines == 0:
        # the kernel takes a line axis of size 0; the plain path, whose
        # masked median gathers from the line axis, one invalid line
        lm_k = lm._replace(**{k: v[:, :0] for k, v in lm._asdict().items()})
    before = pose_optim.pose_optim.launches
    kern = optimizer.optimize_pose(pm, lm_k, cam, cfg, *prev)
    torch.cuda.synchronize()
    assert pose_optim.pose_optim.launches == before + 1
    refined = _refined_on(kern, pm, lm, cam, cfg, prev)
    if n_lines == 0:
        no_lines = lambda out: (out[0], out[1], out[2]._replace(
            **{k: v[:, :0] for k, v in out[2]._asdict().items()}))
        plain, others = no_lines(plain), [no_lines(o) for o in others]
    _assert_close(kern, plain, others, refined)
    # some lane holds a good solution; the starved lane fails
    good = kern[0].good.cpu()
    assert bool(good.any())
    if lanes > 1:
        assert not bool(good[-1])


def _probes(run, pm, lm, prev, seed):
    """The plain path's other runs: on 16 reorderings of the matches, on
    the CPU and in float64."""
    others = [_permuted(run, pm, lm, seed + i) for i in range(16)]
    cpu = lambda nt: type(nt)(*[t.cpu() for t in nt])
    others.append([cpu(o) for o in run(cpu(pm), cpu(lm),
                                       [t.cpu() for t in prev])])
    others.append(run(_d64(pm), _d64(lm), [t.double() for t in prev]))
    return others


KITTI_CAM = dict(fx=707.0912, fy=707.0912, cx=601.8873, cy=183.1104,
                 b=0.537150653, width=1226, height=370)


@pytest.mark.parametrize("preset", ["config_full", "config_points_only"])
def test_kernel_matches_plain_on_vo_steps(cuda, preset):
    """optimize_pose's arguments in steps 1-8 (step 0 has no previous
    frame) of the batched VO on 8 lanes, each a rendered scene of the
    fleet cells' kind on the KITTI camera, stacked into 64 lanes: the
    kernel against the plain path by _assert_close's rule, the plain
    path stable on at least 48 of the 64 lanes and good on most."""
    from pathlib import Path
    from unittest import mock
    from stvo_pl_tpu_torch.config import load_config
    from stvo_pl_tpu_torch.models import optimizer
    from stvo_pl_tpu_torch.ops import camera
    from stvo_pl_tpu_torch.parallel import batched
    from stvo_pl_tpu_torch.utils import synthetic
    cfg = load_config(str(Path(__file__).resolve().parent.parent / "configs"
                          / f"{preset}.yaml"))
    cam = camera.StereoCamera(**KITTI_CAM)
    poses = synthetic.smooth_trajectory(9, speed=0.8, device=cuda)
    left, right = [], []
    for b in range(8):
        gen = torch.Generator(device=cuda).manual_seed(2100 + b)
        scene = synthetic.make_scene(gen, n_points=1400, n_lines=64,
                                     extent=(40.0, 15.0, 90.0), z_near=5.0)
        l, r = synthetic.render_sequence(scene, poses, cam)
        left.append(l)
        right.append(r)
    left, right = torch.stack(left), torch.stack(right)
    calls, real = [], optimizer.optimize_pose

    def spy(pm, lm, cam_, cfg_, *prev):
        keep = lambda nt: type(nt)(*[t.clone() for t in nt])
        calls.append((keep(pm), keep(lm), [t.clone() for t in prev]))
        return real(pm, lm, cam_, cfg_, *prev)

    state = batched.init_batched_state(cfg, 8)
    with mock.patch.object(optimizer, "optimize_pose", spy):
        for i in range(9):
            state, _ = batched.vo_step_batched(
                state, left[:, i].contiguous(), right[:, i].contiguous(),
                cam, cfg)
    stack = lambda nts: type(nts[0])(*[torch.cat(f) for f in zip(*nts)])
    pm = stack([c[0] for c in calls[1:]])
    lm = stack([c[1] for c in calls[1:]])
    prev = [torch.cat(x) for x in zip(*[c[2] for c in calls[1:]])]
    assert pm.P.shape[:2] == (64, cfg.point_capacity)
    run = lambda pm, lm, prev=prev: optimizer.optimize_pose_plain(
        pm, lm, cam, cfg, *prev)
    plain = run(pm, lm)
    others = _probes(run, pm, lm, prev, 5000)
    kern = optimizer.optimize_pose(pm, lm, cam, cfg, *prev)
    stable = _assert_close(kern, plain, others,
                           _refined_on(kern, pm, lm, cam, cfg, prev))
    assert stable.sum() >= 48, stable.sum()
    assert int(plain[0].good.sum()) >= 48


def test_kernel_repeats_bit_for_bit_and_in_a_graph(cuda):
    """Two calls give the same bits, and a captured call the eager one's."""
    from stvo_pl_tpu_torch.config import VOConfig
    from stvo_pl_tpu_torch.models import optimizer
    from stvo_pl_tpu_torch.ops import camera
    cfg = VOConfig(optim_mode=1)      # the medians' path too
    cam = camera.StereoCamera(**CAM_ARGS)
    pm, lm, prev = _inputs(11, 64, 1200, 300, 2 / 3, cuda)
    leaves = lambda out: [t for nt in out for t in nt]
    a = leaves(optimizer.optimize_pose(pm, lm, cam, cfg, *prev))
    b = leaves(optimizer.optimize_pose(pm, lm, cam, cfg, *prev))
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    g = torch.cuda.CUDAGraph()
    s = torch.cuda.Stream()
    s.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(s):
        optimizer.optimize_pose(pm, lm, cam, cfg, *prev)
    torch.cuda.current_stream().wait_stream(s)
    with torch.cuda.graph(g):
        out = optimizer.optimize_pose(pm, lm, cam, cfg, *prev)
    g.replay()
    torch.cuda.synchronize()
    assert all(torch.equal(x, y) for x, y in zip(leaves(out), a))


def test_kernel_capacity_beyond_shared_memory_raises(cuda):
    from stvo_pl_tpu_torch.config import VOConfig
    from stvo_pl_tpu_torch.models import optimizer
    from stvo_pl_tpu_torch.ops import camera
    pm, lm, prev = _inputs(3, 2, 8192, 300, 0.5, cuda)
    with pytest.raises(ValueError, match="shared memory"):
        optimizer.optimize_pose(pm, lm, camera.StereoCamera(**CAM_ARGS),
                                VOConfig(), *prev)
