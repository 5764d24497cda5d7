"""The port's captured programs (stvo_pl_tpu_torch/parallel/compiled.py):
the compiled VO step and the compiled window refiner against the eager
ones and against the JAX package's jitted counterparts.

On the CPU a `Compiled` has no graph: it runs its body eagerly into its
static buffers and returns clones, so here it must be `torch.equal` to the
eager step on every step, its returned tensors must stay as they were
after later calls (the donated-state contract), the kernel wrappers'
counts must stay their own, and the program must hold the device
constants its first run read.  Against the
JAX package (on its kernel branches, tests/test_torch_helpers.py) the
tolerances are those of the port's VO and window tests: every step from
the JAX state within 1e-4 m and 1e-5 in rotation with equal counts,
|ATE_port - ATE_jax| <= 0.02 m for the chained runs
(tests/test_torch_vo_lines.py), refined poses within 1e-4 and equal
`used_lines` (tests/test_torch_window.py).

A step can be captured only if it copies nothing from the host and never
waits for the device.  `test_step_never_touches_the_host` runs every VO
mode and the window refiner under a dispatch mode that refuses the
operations that would (a tensor made from host data, `.item()` and
`bool()` of a tensor, `nonzero`, boolean-mask indexing, `unique`, ...):
what a CPU run can say of what the card's capture needs.  Its sharded
modes (the TP step, the sharded BA and refiner) run in a gloo world of
one, which `test_program_refuses_to_outlive_its_group` also uses: a
program with collectives refuses to run once its group is destroyed.

The `gpu` cases hold each VO mode's graph `torch.equal` to the eager step
on the card (EDLines, whose moments are atomic float sums, by
chip_smoke.py's rule for them), a replay after the constant caches
were cleared and their memory reused equal to eager, and in an NCCL
world of one the sharded programs' replays equal to their eager bodies
and the unsharded programs; they skip without a CUDA device.  They import no JAX, so on a
machine with a card they run as
`pytest --noconftest -m gpu tests/test_torch_compiled.py`.
"""

import numpy as np
import pytest
import torch

from stvo_pl_tpu_torch import convert
from stvo_pl_tpu_torch.config import VOConfig as TCfg
from stvo_pl_tpu_torch.ops import camera as tcam
from stvo_pl_tpu_torch.ops import fast_kernel, hamming, lsd_kernel, patches
from stvo_pl_tpu_torch.parallel import batched, compiled
from stvo_pl_tpu_torch.parallel import window as twin
from stvo_pl_tpu_torch.utils import metrics as tmetrics

torch.set_num_threads(1)

# the 240x180 camera and point + line configuration of tests/test_e2e_vo.py
CAM_ARGS = dict(fx=160.0, fy=160.0, cx=120.0, cy=90.0, b=0.3, width=240,
                height=180)
SMALL = dict(orb_nfeatures=300, orb_nlevels=2, lsd_nfeatures=48,
             lsd_n_dirs=8, min_features=8, fast_feat_th=20)
TCAM = tcam.StereoCamera(**CAM_ARGS)
TCFG = TCfg(**SMALL)
N_FRAMES = 8
# the kernel wrappers, each with its `launches` count
KERNELS = (fast_kernel.fast_pack, patches.extract_patches,
           lsd_kernel.run_pack_multi, lsd_kernel.run_pack,
           hamming.hamming_matrix_popc)


def _leaves(tree) -> list:
    out = []
    compiled._flatten(tree, out)
    return out


def _equal(a, b) -> bool:
    la, lb = _leaves(a), _leaves(b)
    return len(la) == len(lb) and all(torch.equal(x, y)
                                      for x, y in zip(la, lb))


@pytest.fixture(scope="module")
def frames():
    """Two lanes (scenes of seeds 0 and 7) of the 8-frame sequence, as
    numpy [2, T, H, W], and the true poses of lane 0."""
    from test_torch_helpers import rendered_sequence
    L0, R0, poses = rendered_sequence(N_FRAMES, seed=0)
    L7, R7, _ = rendered_sequence(N_FRAMES, seed=7)
    return np.stack([L0, L7]), np.stack([R0, R7]), poses


def test_compiled_step_equals_eager_on_every_step(frames):
    """Two lanes, two chains from the initial state: the compiled step's
    CPU route and `vo_step_batched` are `torch.equal` on every step, state
    and telemetry; every returned tensor is unchanged after the later
    calls."""
    L, R, _ = frames
    L, R = torch.from_numpy(L), torch.from_numpy(R)
    step = batched.compile_vo_step(TCAM, TCFG, 2, device="cpu")
    s_e = batched.init_batched_state(TCFG, 2, device="cpu")
    s_c = batched.init_batched_state(TCFG, 2, device="cpu")
    returned, kept = [], []
    for i in range(N_FRAMES):
        s_e, t_e = batched.vo_step_batched(s_e, L[:, i], R[:, i], TCAM, TCFG)
        s_c, t_c = step(s_c, L[:, i], R[:, i])
        assert _equal((s_c, t_c), (s_e, t_e)), f"frame {i}"
        returned.append((s_c, t_c))
        kept.append([x.clone() for x in _leaves((s_c, t_c))])
    assert len(step.programs) == 1           # one static key, one program
    for i, (out, copy) in enumerate(zip(returned, kept)):
        assert all(torch.equal(x, y) for x, y in zip(_leaves(out), copy)), \
            f"the outputs of call {i} changed after later calls"
    assert int(t_c.n_inliers_ls.sum()) > 0
    with pytest.raises(ValueError, match="compiled for 2 lanes"):
        step(batched.init_batched_state(TCFG, 1, device="cpu"),
             L[:1, 0], R[:1, 0])


class _Counter:
    """Stands in for a kernel wrapper: counts its calls in `launches`."""

    def __init__(self):
        self.launches = 0

    def __call__(self, x):
        self.launches += 1
        return x + 1


def test_program_outputs_keys_and_launch_counts():
    """Outputs keep the body's structure (NamedTuples, tuples, None) as
    fresh tensors; each static key has its own program; the counts stay
    the wrappers' own: a CPU call runs the body, and its wrapper calls
    count once each."""
    a, b = _Counter(), _Counter()

    def body(x, pair):
        for _ in range(3):
            x = a(x)
        return b(x) * pair[0], (pair[1] - x, None)

    prog = compiled.Compiled(body, "cpu")
    x, pair = torch.arange(4.0), (torch.full((4,), 2.0), torch.ones(4))
    for n in range(1, 5):
        y, (z, none) = prog(x, pair)
        assert torch.equal(y, (x + 4) * 2) and none is None
        assert torch.equal(z, 1 - (x + 3))
        assert (a.launches, b.launches) == (3 * n, n)
    y.add_(1)                               # a caller's output is its own
    assert torch.equal(prog(x, pair)[0], (x + 4) * 2)
    # another shape is another static key: a second program
    prog(torch.zeros(6), (torch.ones(6), torch.ones(6)))
    assert len(prog.programs) == 2 and (a.launches, b.launches) == (18, 6)
    assert all(p.graph is None and p.replays == 0
               for p in prog.programs.values())
    with pytest.raises(TypeError):
        prog(x, [x, x])


def test_program_owns_its_constants(frames):
    """Every per-device constant that the step's first run reads is held
    by its program (a graph holds none of them), so clearing the caches
    frees nothing the program reads; the step then still equals eager."""
    from stvo_pl_tpu_torch import device
    L, R, _ = frames
    L, R = torch.from_numpy(L[:1]), torch.from_numpy(R[:1])
    s_c = batched.init_batched_state(TCFG, 1, device="cpu")
    s_e = batched.init_batched_state(TCFG, 1, device="cpu")
    step = batched.compile_vo_step(TCAM, TCFG, 1, device="cpu")
    for cache in device.CACHES:
        cache.cache_clear()
    s_c, _ = step(s_c, L[:, 0], R[:, 0])
    prog, = step.programs.values()
    built = sum(cache.cache_info().currsize for cache in device.CACHES)
    assert built > 0 and len(prog.owned) == built
    for cache in device.CACHES:
        cache.cache_clear()
    s_e, _ = batched.vo_step_batched(s_e, L[:, 0], R[:, 0], TCAM, TCFG)
    assert _equal(step(s_c, L[:, 1], R[:, 1]),
                  batched.vo_step_batched(s_e, L[:, 1], R[:, 1], TCAM, TCFG))


@pytest.fixture(scope="module")
def jax_run(frames):
    """The JAX package's jitted `vo_step_batched` over lane 0 (one lane) on
    its kernel branches: each frame's incoming state and telemetry, as
    numpy."""
    import jax
    import jax.numpy as jnp
    from stvo_pl_tpu.config import VOConfig as JCfg
    from stvo_pl_tpu.parallel import batched as jbatched
    from test_torch_helpers import JCAM, jax_kernel_branch
    L, R, _ = frames
    cfg = JCfg(**SMALL)
    states, tels = [], []
    with jax_kernel_branch():
        state = jbatched.init_batched_state(cfg, 1)
        for i in range(N_FRAMES):
            states.append(jax.tree_util.tree_map(np.asarray, state))
            state, t = jbatched.vo_step_batched(
                state, jnp.asarray(L[:1, i]), jnp.asarray(R[:1, i]), JCAM,
                cfg)
            tels.append(jax.tree_util.tree_map(np.asarray, t))
    return states, tels


def test_compiled_step_against_jax(frames, jax_run):
    """Every step from the JAX state within 1e-4 m / 1e-5 with equal
    counts, and the chained ATEs within 0.02 m."""
    L, R, poses = frames
    L, R = torch.from_numpy(L[:1]), torch.from_numpy(R[:1])
    states, tels = jax_run
    step = batched.compile_vo_step(TCAM, TCFG, 1, device="cpu")
    for i in range(N_FRAMES):
        _, tel = step(convert.state_from_numpy(states[i], "cpu"), L[:, i],
                      R[:, i])
        tj = tels[i]
        T_t = tel.Tfw[0].numpy()
        np.testing.assert_allclose(T_t[:3, 3], tj.Tfw[0, :3, 3], atol=1e-4,
                                   err_msg=f"frame {i}")
        np.testing.assert_allclose(T_t[:3, :3], tj.Tfw[0, :3, :3],
                                   atol=1e-5, err_msg=f"frame {i}")
        for f in ("good", "n_points", "n_inliers_pt", "n_lines",
                  "n_inliers_ls", "opt_iters", "fast_th", "is_kf"):
            assert getattr(tel, f)[0].item() == getattr(tj, f)[0].item(), \
                (i, f)
    state = batched.init_batched_state(TCFG, 1, device="cpu")
    tfw = []
    for i in range(N_FRAMES):
        state, tel = step(state, L[:, i], R[:, i])
        tfw.append(tel.Tfw[0].numpy())
    gt = poses.astype(np.float64)
    ate_t = tmetrics.ate_rmse(np.stack(tfw).astype(np.float64), gt)
    ate_j = tmetrics.ate_rmse(
        np.stack([t.Tfw[0] for t in tels]).astype(np.float64), gt)
    assert ate_t < 0.1 and abs(ate_t - ate_j) <= 0.02, (ate_t, ate_j)


def test_compiled_refiner_against_jax():
    """A 5-keyframe window of the port's VO (every frame a keyframe, the
    scene of seed 7): the compiled refiner equals the eager one bit for
    bit and the JAX package's `refine_window_auto` within 1e-4, with the
    same line-trust decision."""
    import jax.numpy as jnp
    from stvo_pl_tpu.config import VOConfig as JCfg
    from stvo_pl_tpu.models import features as jfeat
    from stvo_pl_tpu.parallel import window as jwin
    from test_torch_helpers import JCAM, port_vo_frames
    frames5, _ = port_vo_frames(5, SMALL, seed=7)
    stack = lambda sets: {f: np.stack([getattr(s, f) for s in sets])
                          for f in sets[0]._fields}
    Tfw = np.stack([f[0] for f in frames5])
    pts, lns = stack([f[2] for f in frames5]), stack([f[3] for f in frames5])
    tw = convert.window_from_numpy(dict(Tfw=Tfw, points=pts, lines=lns),
                                   device="cpu")
    jw = jwin.KeyframeWindow(
        Tfw=jnp.asarray(Tfw),
        points=jfeat.PointSet(**{k: jnp.asarray(v) for k, v in pts.items()}),
        lines=jfeat.LineSet(**{k: jnp.asarray(v) for k, v in lns.items()}))
    refine = twin.compile_refiner(TCAM, TCFG, n_iters=8, device="cpu")
    out = refine(tw)
    assert _equal(out, twin.refine_window_auto(tw, TCAM, TCFG, n_iters=8))
    assert _equal(refine(tw), out)           # a second call, same answer
    jT, _, _, j_used = jwin.refine_window_auto(jw, JCAM, JCfg(**SMALL),
                                               n_iters=8)
    tT, _, _, t_used = out
    assert bool(t_used) == bool(j_used)
    np.testing.assert_allclose(tT[:, :3].numpy(), np.asarray(jT)[:, :3],
                               rtol=0, atol=1e-4)


# ---------------------------------------------------------------------------
# what a capture needs, on the CPU: no host data, no host sync
# ---------------------------------------------------------------------------

AUDIT_MODES = ["default", "points_only", "dense_all_direction",
               "dense_per_direction", "popcount", "rgbd", "edlines",
               "window_refiner", "sharded_tp_step", "sharded_ba",
               "sharded_refiner"]
# the collective that a sharded mode's audited call must make, and how
# often (None: at least once): one all-gather per column-sharded matcher,
# one all-reduce per BA iteration
AUDIT_COLLECTIVES = {"sharded_tp_step": ("all_gather_into_tensor", None),
                     "sharded_ba": ("all_reduce", 2),
                     "sharded_refiner": ("all_reduce", 2)}


@pytest.fixture
def gloo_world():
    """A gloo world of one in this process (parallel.mesh.init_distributed
    without torchrun's environment) and its 1 x 1 mesh; destroyed after
    the test, unless the test destroyed it, since one pytest worker runs
    several files."""
    import torch.distributed as dist
    from stvo_pl_tpu_torch.parallel import mesh as mesh_mod
    assert not dist.is_initialized(), "a process group leaked into the test"
    mesh_mod.init_distributed(device_type="cpu")
    try:
        yield mesh_mod.make_mesh(device_type="cpu")
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


@pytest.mark.parametrize("mode", AUDIT_MODES)
def test_step_never_touches_the_host(frames, mode, request):
    """One lane: the second step of every VO mode (the first builds the
    cached constants, as a capture's warm-up does), and a second
    refinement of a 3-keyframe window, run no operation that copies from
    the host or syncs, and upload nothing (`torch.from_numpy`).  The
    sharded modes run in a gloo world of one: the step with every matcher
    column-sharded over a model group of 1 (`tp=(group, 1)`, so the TP
    merge and its all-gather run), and second calls of the compiled
    sharded BA and sharded window refiner (their CPU route: copy in, the
    body with its all-reduces, clone out)."""
    from stvo_pl_tpu_torch.models import frontend
    from stvo_pl_tpu_torch.ops import se3
    from stvo_pl_tpu_torch.parallel import ba
    from test_torch_helpers import HostAudit
    L, R, _ = frames
    L, R = torch.from_numpy(L[:1]), torch.from_numpy(R[:1])
    kw, per_direction = GPU_MODES.get(mode, (dict(), False))
    mesh = (request.getfixturevalue("gloo_world")
            if mode.startswith("sharded") else None)
    if mode == "sharded_tp_step":
        kw = dict(tp_min_features=16)
    cfg = TCfg(**SMALL, **kw)
    if mode == "rgbd":
        second = torch.full_like(R, 5.0)       # a depth map: a wall at 5 m
        run = lambda s, i: frontend.step_lanes_rgbd(
            s, L[:, i], second[:, i], TCAM, cfg, per_direction=per_direction)
    else:
        tp = ((mesh.get_group("model"), 1) if mode == "sharded_tp_step"
              else None)
        run = lambda s, i: batched.vo_step_batched(
            s, L[:, i], R[:, i], TCAM, cfg, per_direction=per_direction,
            tp=tp)
    state = batched.init_batched_state(cfg, 1, device="cpu")
    windowed = mode in ("window_refiner", "sharded_ba", "sharded_refiner")
    n = 3 if windowed else 1
    kfs = []
    for i in range(n):
        state, tel = run(state, i)
        kfs.append((tel.Tfw[0], *(type(x)(*[f[0] for f in x])
                                  for x in (state.prev_points,
                                            state.prev_lines))))
    if windowed:
        win = twin.stack_keyframes(kfs)
    if mode == "window_refiner":
        go = lambda: twin.refine_window_auto(win, TCAM, cfg, n_iters=2)
    elif mode == "sharded_ba":
        prob = twin.build_problem_tracks(win, TCAM, cfg)
        solver = ba.make_sharded_ba(mesh, TCAM, n_iters=2, has_lines=True)
        go = lambda: solver(se3.inverse_se3(win.Tfw), prob.X, prob.obs,
                            prob.mask, prob.sigma2, prob.Xl, prob.obs_l,
                            prob.mask_l, prob.sigma2_l)
    elif mode == "sharded_refiner":
        go = lambda: twin.make_sharded_window_refiner(
            mesh, TCAM, cfg, n_iters=2, has_lines=True)(win)
    else:
        go = lambda: run(state, n)
    go()
    audit = HostAudit()
    uploads, calls = [], []
    real = torch.from_numpy
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(torch, "from_numpy",
                   lambda *a: uploads.append(a) or real(*a))
        if mode in AUDIT_COLLECTIVES:
            import torch.distributed as dist
            name, n_calls = AUDIT_COLLECTIVES[mode]
            real_c = getattr(dist, name)
            mp.setattr(dist, name, lambda *a, **k: calls.append(name)
                       or real_c(*a, **k))
        with audit:
            go()
    assert not audit.found, audit.found
    assert not uploads
    if mode in AUDIT_COLLECTIVES:
        assert calls and len(calls) == (n_calls or len(calls)), calls


def test_program_refuses_to_outlive_its_group(gloo_world):
    """A program whose body runs collectives (here the sharded BA) raises
    once its process group is destroyed, before it runs anything: a
    graph that replayed then would use a freed communicator."""
    import torch.distributed as dist
    from stvo_pl_tpu_torch.parallel import ba
    rng = np.random.default_rng(0)
    K, N = 3, 8
    poses = torch.eye(4).repeat(K, 1, 1)
    X = torch.from_numpy(rng.uniform(-1, 1, (N, 3)).astype(np.float32))
    X[:, 2] += 6.0
    obs = torch.from_numpy(rng.uniform(0, 200, (N, K, 3)).astype(np.float32))
    mask = torch.ones((N, K), dtype=torch.bool)
    sigma2 = torch.ones(N)
    solver = ba.make_sharded_ba(gloo_world, TCAM, n_iters=1)
    assert solver.groups
    first = solver(poses, X, obs, mask, sigma2)
    assert all(bool(torch.isfinite(t).all()) for t in first)
    dist.destroy_process_group()
    with pytest.raises(RuntimeError, match="outlived its process group"):
        solver(poses, X, obs, mask, sigma2)


# ---------------------------------------------------------------------------
# on the card: each VO mode's graph against its eager step
# ---------------------------------------------------------------------------

def _segments(lines, lane: int) -> np.ndarray:
    """[n, 4] endpoints of a lane's valid left lines."""
    seg = torch.cat([lines.spl[lane], lines.epl[lane]], dim=-1)
    return seg[lines.valid[lane]].cpu().numpy()


def _shared(a: np.ndarray, b: np.ndarray, tol: float = 0.5) -> float:
    """Share of the larger set's segments with a partner in the other
    set, both endpoints within `tol` px."""
    if len(a) == 0 or len(b) == 0:
        return float(len(a) == len(b))
    d = np.abs(a[:, None, :] - b[None, :, :]).max(axis=-1)
    return (d.min(axis=1) <= tol).sum() / max(len(a), len(b))


GPU_MODES = {
    "default": (dict(), False), "points_only": (dict(has_lines=False), False),
    "dense_all_direction": (dict(lsd_octaves=1), False),
    "dense_per_direction": (dict(lsd_octaves=1), True),
    "popcount": (dict(hamming_use_mxu=False), False),
    "rgbd": (dict(rgbd_max_depth=60.0), False),
    "edlines": (dict(use_edlines=True), False),
}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: a graph is captured on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _card_lanes(cuda, n: int):
    """Two lanes (scenes of seeds 0 and 7) of the port's renderer at
    240x180 on the card, n frames: left, right and depth [2, n, H, W]."""
    from stvo_pl_tpu_torch.utils import synthetic
    poses = synthetic.smooth_trajectory(n, speed=0.25, device=cuda)
    L, R, D = [], [], []
    for seed in (0, 7):
        gen = torch.Generator(device=cuda).manual_seed(seed)
        scene = synthetic.make_scene(gen, n_points=260, n_lines=24,
                                     extent=(14.0, 8.0, 40.0), z_near=3.0)
        left, right = synthetic.render_sequence(scene, poses, TCAM)
        L.append(left)
        R.append(right)
        D.append(synthetic.render_depth(scene, poses, TCAM))
    return torch.stack(L), torch.stack(R), torch.stack(D)


@pytest.mark.gpu
@pytest.mark.parametrize("mode", list(GPU_MODES))
def test_graph_equals_eager_on_the_card(cuda, mode):
    """Two lanes of the port's renderer at 240x180, 4 frames: the replayed
    graph `torch.equal` to the eager step (EDLines within 1e-3 m: its
    moment sums are float atomics), and a replay leaves the kernel
    wrappers' counts as they were."""
    from stvo_pl_tpu_torch.models import frontend
    kw, per_direction = GPU_MODES[mode]
    cfg = TCfg(**SMALL, **kw)
    n = 4
    L, R, D = _card_lanes(cuda, n)
    rgbd = mode == "rgbd"
    second = D if rgbd else R
    if rgbd:
        eager = lambda s, a, b: frontend.step_lanes_rgbd(
            s, a, b, TCAM, cfg, per_direction=per_direction)
        step = batched.compile_vo_step_rgbd(TCAM, cfg, 2, per_direction,
                                            device=cuda)
    else:
        eager = lambda s, a, b: batched.vo_step_batched(
            s, a, b, TCAM, cfg, per_direction=per_direction)
        step = batched.compile_vo_step(TCAM, cfg, 2, per_direction,
                                       device=cuda)
    s_e = batched.init_batched_state(cfg, 2, device=cuda)
    s_c = batched.init_batched_state(cfg, 2, device=cuda)
    step(s_c, L[:, 0], second[:, 0])          # warm-up and capture
    prog, = step.programs.values()
    for i in range(n):
        s_e, t_e = eager(s_e, L[:, i].contiguous(), second[:, i].contiguous())
        before = [k.launches for k in KERNELS]
        s_c, t_c = step(s_c, L[:, i], second[:, i])
        torch.cuda.synchronize()
        # a replay runs no wrapper: the counts stay where they were
        assert [k.launches for k in KERNELS] == before, (mode, i)
        assert prog.replays == i + 2
        if mode == "edlines":
            # chip_smoke.py's rule for EDLines on the card: per image the
            # counts within 1 and >= 90% of the segments within 0.5 px;
            # poses within cpu_parity's 0.01 m
            for lane in range(2):
                a, c = (_segments(s.prev_lines, lane) for s in (s_c, s_e))
                assert abs(len(a) - len(c)) <= 1, (i, lane)
                assert _shared(a, c) >= 0.9, (i, lane)
            assert float((t_c.Tfw - t_e.Tfw).abs().max()) <= 0.01, i
        else:
            assert _equal((s_c, t_c), (s_e, t_e)), (mode, i)
    assert len(step.programs) == 1


@pytest.mark.gpu
def test_replay_after_the_caches_are_cleared(cuda):
    """Capture the default step, clear every per-device constant cache,
    collect, and fill freshly allocated memory of the freed sizes: the
    replay still equals the eager step, because the program holds the
    constants its graph reads."""
    import gc
    from stvo_pl_tpu_torch import device
    gen = torch.Generator(device=cuda).manual_seed(3)
    L = torch.rand((3, 1, TCAM.height, TCAM.width), generator=gen,
                   device=cuda) * 255
    R = torch.roll(L, -6, dims=-1).contiguous()
    step = batched.compile_vo_step(TCAM, TCFG, 1, device=cuda)
    s_c = batched.init_batched_state(TCFG, 1, device=cuda)
    s_e = batched.init_batched_state(TCFG, 1, device=cuda)
    s_c, _ = step(s_c, L[0], R[0])
    s_e, _ = batched.vo_step_batched(s_e, L[0], R[0], TCAM, TCFG)
    def tensors(v):
        if isinstance(v, torch.Tensor):
            return [v]
        return [t for x in v for t in tensors(x)]

    prog, = step.programs.values()
    sizes = [t.numel() * t.element_size() for t in tensors(
        list(prog.owned.values()))]
    for cache in device.CACHES:
        cache.cache_clear()
    gc.collect()
    junk = [torch.full((max(1, n // 4),), float("nan"), device=cuda)
            for n in sizes for _ in range(2)]
    torch.cuda.synchronize()
    for i in (1, 2):
        s_c, t_c = step(s_c, L[i], R[i])
        s_e, t_e = batched.vo_step_batched(s_e, L[i], R[i], TCAM, TCFG)
        assert _equal((s_c, t_c), (s_e, t_e)), i
    del junk


@pytest.mark.gpu
def test_sharded_programs_replay_on_the_card(cuda):
    """In an NCCL world of one (parallel.mesh.init_distributed without
    torchrun's environment): the sharded step, the step with every
    matcher column-sharded over a model group of 1 (`tp=(group, 1)`: its
    all-gathers captured), the sharded BA and the sharded window refiner
    replay `torch.equal` to their eager bodies and to the unsharded
    programs (`compile_vo_step`, `ba_solve`, `compile_refiner`); every
    program is dropped and the device synchronized before the group is
    destroyed."""
    import gc
    import torch.distributed as dist
    from stvo_pl_tpu_torch.ops import se3
    from stvo_pl_tpu_torch.parallel import ba, compiled
    from stvo_pl_tpu_torch.parallel import mesh as mesh_mod
    assert not dist.is_initialized(), "a process group leaked into the test"
    L, R, _ = _card_lanes(cuda, 3)
    step = tp_step = plain = solver = refine = plain_refine = prog = None
    mesh_mod.init_distributed(device_type="cuda")
    try:
        assert dist.get_backend() == "nccl" and dist.get_world_size() == 1
        mesh = mesh_mod.make_mesh(device_type="cuda")
        group = mesh.get_group("model")
        cfg_tp = TCfg(**SMALL, tp_min_features=16)
        step, place = batched.make_sharded_vo_step(mesh, TCAM, TCFG)
        tp_step = compiled.Compiled(
            lambda s, a, b: batched.vo_step_batched(s, a, b, TCAM, cfg_tp,
                                                    tp=(group, 1)),
            cuda, groups=(group,))
        plain = batched.compile_vo_step(TCAM, TCFG, 2, device=cuda)
        assert isinstance(step, compiled.Compiled)
        runs = {name: [] for name in ("step", "fn", "tp", "tp_fn", "plain")}
        for name, f in (("step", step), ("fn", step.fn), ("tp", tp_step),
                        ("tp_fn", tp_step.fn), ("plain", plain)):
            s = place(batched.init_batched_state(TCFG, 2, device=cuda),
                      L[:, 0], R[:, 0])[0]
            for i in range(3):
                s, t = f(s, L[:, i].contiguous(), R[:, i].contiguous())
                runs[name].append((s, t))
        for name in ("step", "fn", "tp", "tp_fn"):
            assert all(_equal(a, b) for a, b in zip(runs[name],
                                                    runs["plain"])), name
        assert step.programs and tp_step.programs
        for prog in (*step.programs.values(), *tp_step.programs.values()):
            assert prog.graph is not None and prog.replays == 3

        # a 3-keyframe window of lane 0
        kfs = [(t.Tfw[0], *(type(x)(*[f[0] for f in x])
                            for x in (s.prev_points, s.prev_lines)))
               for s, t in runs["plain"]]
        del runs
        win = twin.stack_keyframes(kfs)
        prob = twin.build_problem_tracks(win, TCAM, TCFG)
        poses_cw = se3.inverse_se3(win.Tfw)
        solver = ba.make_sharded_ba(mesh, TCAM, n_iters=4, has_lines=True)
        args = (poses_cw, prob.X, prob.obs, prob.mask, prob.sigma2, prob.Xl,
                prob.obs_l, prob.mask_l, prob.sigma2_l)
        want = ba.ba_solve(poses_cw, prob, TCAM, n_iters=4)
        for _ in range(2):
            assert _equal(solver(*args), want)
        assert _equal(solver.fn(*args), want)
        refine = twin.make_sharded_window_refiner(mesh, TCAM, TCFG,
                                                  n_iters=4, has_lines=True)
        plain_refine = twin.compile_refiner(TCAM, TCFG, n_iters=4,
                                            auto=False, device=cuda)
        want = plain_refine(win)
        for _ in range(2):
            assert _equal(refine(win), want)
        assert _equal(refine.fn(win), want)
        for prog in (*solver.programs.values(), *refine.programs.values()):
            assert prog.graph is not None and prog.replays == 2
    finally:
        # every program (and the loop's last _Program) let go of first
        step = tp_step = plain = solver = refine = plain_refine = None
        prog = None
        gc.collect()
        torch.cuda.synchronize()
        dist.destroy_process_group()
