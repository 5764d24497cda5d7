"""The port's scale-out on torch.distributed (parallel/mesh.py, tp.py,
batched.py, groups.py, ba.py, window.py) in real multi-process gloo
worlds on the CPU, against the JAX package on its 8 virtual CPU devices
and against the port's own single-process results.

Two worlds are spawned once per module, as `subprocess` workers of
tools/torch_dist_worker.py (no JAX there): 4 ranks for the TP matcher,
the 2 x 2 data x model step and the config groups; 2 ranks for the
data-parallel step, the sharded BA and the sharded window refiner.  They
meet through a FileStore in tmp_path (no port to find), run with
OMP_NUM_THREADS=1, and exchange inputs and results as .npz files.

Tolerances: TP matching and the sharded steps are integer decisions or
the same float operations on the same lanes, so bit for bit; the sharded
BA sums per-rank partial systems, so it is held to the JAX package's own
sharded-BA tolerances (tests/test_ba.py:117, :243-246: poses rtol 1e-3,
atol 1e-4; line endpoints atol 1e-3), and the sharded window refiner to
tests/test_window.py:77's (rtol 1e-3, atol 1e-4).
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stvo_pl_tpu.parallel import ba as jba
from stvo_pl_tpu.parallel import mesh as jmesh
from stvo_pl_tpu.parallel import tp as jtp
from stvo_pl_tpu.utils import synthetic as jsyn
from stvo_pl_tpu_torch import convert
from stvo_pl_tpu_torch.config import VOConfig as TCfg
from stvo_pl_tpu_torch.ops import camera as tcam
from stvo_pl_tpu_torch.ops import hamming as tham
from stvo_pl_tpu_torch.ops import matching as tmatch
from stvo_pl_tpu_torch.parallel import ba as tba
from stvo_pl_tpu_torch.parallel import batched as tbatched
from stvo_pl_tpu_torch.parallel import window as twin

from test_ba import CAM as BA_JCAM
from test_ba import synth_problem, synth_problem_pl
from test_torch_helpers import CAM_ARGS, JCAM, SMALL, port_vo_frames

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(ROOT, "tools", "torch_dist_worker.py")
TCAM = tcam.StereoCamera(**CAM_ARGS)
BA_TCAM = tcam.StereoCamera(BA_JCAM.fx, BA_JCAM.fy, BA_JCAM.cx, BA_JCAM.cy,
                            BA_JCAM.b, BA_JCAM.width, BA_JCAM.height)
N_FRAMES = 3
BA_ITERS = 8


def _run_world(tmp, world: int, tasks: str, inputs: dict):
    """Start `world` worker ranks, wait for all, return their outputs."""
    inp = os.path.join(tmp, "in.npz")
    np.savez(inp, **inputs)
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH",
                                                             ""))
    logs = [open(os.path.join(tmp, f"rank{r}.log"), "w")
            for r in range(world)]
    procs = [subprocess.Popen(
        [sys.executable, WORKER, str(r), str(world),
         os.path.join(tmp, "store"), inp, str(tmp), tasks],
        stdout=logs[r], stderr=subprocess.STDOUT, env=env)
        for r in range(world)]
    try:
        for p in procs:
            p.wait(timeout=300)
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
            p.wait()
    finally:
        for f in logs:
            f.close()
    for r, p in enumerate(procs):
        if p.returncode != 0:
            with open(os.path.join(tmp, f"rank{r}.log")) as f:
                pytest.fail(f"rank {r} of {world} exited {p.returncode}:\n"
                            + f.read()[-4000:])
    return [dict(np.load(os.path.join(tmp, f"rank{r}.npz")))
            for r in range(world)]


def _descriptors(rng, n):
    return rng.integers(0, 2 ** 32, (n, 8), dtype=np.uint32)


def _tp_inputs():
    """tests/test_tp.py's matcher inputs: duplicated rows force distance
    ties across shards."""
    rng = np.random.default_rng(0)
    d1, d2 = _descriptors(rng, 160), _descriptors(rng, 256)
    d2[128:144] = d2[:16]
    return dict(tp_d1=d1.view(np.int32), tp_d2=d2.view(np.int32),
                tp_v1=rng.random(160) > 0.2, tp_v2=rng.random(256) > 0.2)


def _scene_frames(seed, n, n_points=220, n_lines=20):
    scene = jsyn.make_scene(jax.random.PRNGKey(seed), n_points=n_points,
                            n_lines=n_lines, extent=(14.0, 8.0, 40.0),
                            z_near=3.0)
    poses = jsyn.smooth_trajectory(n, speed=0.25)
    L, R = jsyn.render_sequence(scene, poses, JCAM)
    return np.asarray(L, np.float32), np.asarray(R, np.float32)


@pytest.fixture(scope="module")
def world4(tmp_path_factory):
    rng = np.random.default_rng(3)
    il = rng.uniform(0, 255, (2, 96, 128)).astype(np.float32)
    grp_l, grp_r = _scene_frames(0, N_FRAMES)
    inputs = dict(_tp_inputs(), tp_il=il, tp_ir=np.roll(il, -2, axis=2),
                  grp_l=grp_l, grp_r=grp_r)
    return _run_world(str(tmp_path_factory.mktemp("world4")), 4,
                      "tp,tp_step,groups", inputs)


def _ba_problems():
    """tests/test_ba.py's sharded problems: 256 points over 5 keyframes,
    and 64 points + 64 lines."""
    out = {}
    for kind, (poses0, _, prob) in (
            ("points", synth_problem(np.random.default_rng(0), N=256)),
            ("lines", synth_problem_pl(np.random.default_rng(1), N=64,
                                       Nl=64))):
        out[f"ba_{kind}_poses0"] = np.asarray(poses0)
        for f in prob._fields:
            if getattr(prob, f) is not None:
                out[f"ba_{kind}_{f}"] = np.asarray(getattr(prob, f))
    return out


@pytest.fixture(scope="module")
def window_frames():
    """4 frames of the port's VO on the 240x180 point + line sequence."""
    frames, _ = port_vo_frames(4, SMALL)
    return frames


def _window_numpy(frames):
    return {"Tfw": np.stack([f[0] for f in frames]),
            "points": {k: np.stack([f[2][i] for f in frames])
                       for i, k in enumerate(frames[0][2]._fields)},
            "lines": {k: np.stack([f[3][i] for f in frames])
                      for i, k in enumerate(frames[0][3]._fields)}}


@pytest.fixture(scope="module")
def world2(tmp_path_factory, window_frames):
    lanes = [_scene_frames(seed, N_FRAMES) for seed in (0, 1)]
    win = _window_numpy(window_frames)
    inputs = dict(
        _ba_problems(),
        dp_l=np.stack([lane[0] for lane in lanes]),
        dp_r=np.stack([lane[1] for lane in lanes]),
        win_Tfw=win["Tfw"],
        **{f"win_p_{k}": v for k, v in win["points"].items()},
        **{f"win_l_{k}": v for k, v in win["lines"].items()},
        **{f"cfg_{k}": v for k, v in SMALL.items()})
    return _run_world(str(tmp_path_factory.mktemp("world2")), 2,
                      "dp_step,ba,window", inputs)


# --------------------------------------------------------------------------
# (a) TP matching
# --------------------------------------------------------------------------

@pytest.mark.parametrize("n_model", [2, 4])
@pytest.mark.parametrize("mutual", [True, False])
def test_tp_match_equals_jax_and_dense(world4, n_model, mutual):
    """tests/test_tp.py:19 in a 4-rank world: every rank's result equals
    the JAX package's sharded matcher and the port's dense one."""
    inp = _tp_inputs()
    d1, d2 = (torch.from_numpy(inp[k]) for k in ("tp_d1", "tp_d2"))
    v1, v2 = (torch.from_numpy(inp[k]) for k in ("tp_v1", "tp_v2"))
    dense = tmatch.nnr_mutual_match(tham.hamming_matrix(d1, d2, False),
                                    v1[:, None] & v2[None, :], 0.8,
                                    mutual=mutual)
    mesh = jmesh.make_mesh(n_data=len(jax.devices()) // n_model,
                           n_model=n_model)
    ref = jtp.tp_match(jnp.asarray(inp["tp_d1"].view(np.uint32)),
                       jnp.asarray(inp["tp_v1"]),
                       jnp.asarray(inp["tp_d2"].view(np.uint32)),
                       jnp.asarray(inp["tp_v2"]), 0.8, mesh, mutual=mutual)
    np.testing.assert_array_equal(dense.idx.numpy(), np.asarray(ref.idx))
    np.testing.assert_array_equal(dense.valid.numpy(), np.asarray(ref.valid))
    for out in world4:
        key = f"tp_{n_model}_{int(mutual)}"
        np.testing.assert_array_equal(out[f"{key}_idx"], np.asarray(ref.idx))
        np.testing.assert_array_equal(out[f"{key}_valid"],
                                      np.asarray(ref.valid))


# --------------------------------------------------------------------------
# (b), (c) the sharded VO step
# --------------------------------------------------------------------------

FIELDS = ("Tfw", "good", "n_inliers_pt", "points_valid", "lines_valid")


def test_sharded_step_with_tp_equals_unsharded(world4):
    """tests/test_tp.py:42: a 2 x 2 data x model step with
    tp_min_features=16 column-shards every matcher and equals the
    unsharded step on each rank's lane, bit for bit."""
    for out in world4:
        assert out["tp_step_gathers"] > 0       # TP really engaged
        lanes = out["tp_step_lanes"]
        for f in FIELDS:
            np.testing.assert_array_equal(out[f"tp_step_{f}"],
                                          out[f"tp_dense_{f}"][lanes], f)
    # the two ranks of a data row hold the same lanes
    np.testing.assert_array_equal(world4[0]["tp_step_Tfw"],
                                  world4[1]["tp_step_Tfw"])
    assert list(world4[2]["tp_step_lanes"]) == [1]


def test_data_parallel_step_makes_no_collective_call(world2):
    """tests/test_sharded_step.py:32: with no model axis the sharded step
    issues no collective (every torch.distributed collective counted)."""
    assert [int(o["dp_collectives"]) for o in world2] == [0, 0]
    assert [list(o["dp_lanes"]) for o in world2] == [[0], [1]]


def test_data_parallel_step_equals_unsharded_per_lane(world2):
    dense = world2[0]
    for out in world2:
        lanes = out["dp_lanes"]
        for f in FIELDS:
            np.testing.assert_array_equal(out[f"dp_sharded_{f}"],
                                          dense[f"dp_dense_{f}"][lanes], f)
    assert dense["dp_dense_good"].all()


# --------------------------------------------------------------------------
# (d) landmark-sharded BA, (e) the sharded window refiner
# --------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["points", "lines"])
def test_sharded_ba_against_jax_and_ba_solve(world2, kind):
    probs = _ba_problems()
    g = {k[len(kind) + 4:]: v for k, v in probs.items()
         if k.startswith(f"ba_{kind}_")}
    has_lines = kind == "lines"
    names = ["X", "obs", "mask", "sigma2"]
    if has_lines:
        names += ["Xl", "obs_l", "mask_l", "sigma2_l"]
    mesh = jmesh.make_mesh(n_data=2, devices=jax.devices()[:2])
    solver = jba.make_sharded_ba(mesh, BA_JCAM, n_iters=BA_ITERS,
                                 has_lines=has_lines)
    ref = solver(jnp.asarray(g["poses0"]),
                 *[jnp.asarray(g[n]) for n in names])
    prob = convert.problem_from_numpy(
        {f: g.get(f) for f in tba.BAProblem._fields}, device="cpu")
    single = tba.ba_solve(torch.from_numpy(g["poses0"].copy()), prob, BA_TCAM,
                          n_iters=BA_ITERS)
    for out in world2:
        poses = out[f"ba_{kind}_poses"]
        np.testing.assert_allclose(poses, np.asarray(ref[0]), rtol=1e-3,
                                   atol=1e-4)
        np.testing.assert_allclose(poses, single[0].numpy(), rtol=1e-3,
                                   atol=1e-4)
        np.testing.assert_allclose(out[f"ba_{kind}_costs"],
                                   world2[0][f"ba_{kind}_costs"], rtol=0,
                                   atol=0)
    X = np.concatenate([o[f"ba_{kind}_X"] for o in world2])
    np.testing.assert_allclose(X, np.asarray(ref[1]), rtol=1e-3, atol=1e-3)
    if has_lines:
        Xl = np.concatenate([o[f"ba_{kind}_Xl"] for o in world2])
        np.testing.assert_allclose(Xl, np.asarray(ref[2]), rtol=1e-3,
                                   atol=1e-3)
        np.testing.assert_allclose(Xl, single[2].numpy(), rtol=1e-3,
                                   atol=1e-3)


def test_sharded_ba_rejects_uneven_landmarks(world2):
    """The compiled solver raises on the first call, and again on the
    next."""
    for out in world2:
        assert len(out["ba_uneven_error"]) == 2
        for msg in out["ba_uneven_error"]:
            assert "63 point landmarks do not split over 2" in str(msg)


@pytest.mark.parametrize("kind", ["points", "lines"])
def test_sharded_window_refiner_matches_refine_window(world2, window_frames,
                                                      kind):
    """tests/test_window.py:77 with the port's 4-frame window: the 2-rank
    refiner gives refine_window's poses on every rank and the points in
    refine_window's shape."""
    win = convert.window_from_numpy(_window_numpy(window_frames),
                                    device="cpu")
    if kind == "points":
        win = win._replace(lines=None)
    T, X, costs = twin.refine_window(win, TCAM, TCfg(**SMALL), n_iters=5)
    for out in world2:
        np.testing.assert_allclose(out[f"win_{kind}_Tfw"], T.numpy(),
                                   rtol=1e-3, atol=1e-4)
        assert out[f"win_{kind}_X"].shape == tuple(X.shape)
        np.testing.assert_allclose(out[f"win_{kind}_costs"], costs.numpy(),
                                   rtol=1e-3)
    np.testing.assert_array_equal(world2[0][f"win_{kind}_X"],
                                  world2[1][f"win_{kind}_X"])


# --------------------------------------------------------------------------
# the sharded programs compiled (parallel/compiled.Compiled)
# --------------------------------------------------------------------------

# collectives in 3 calls: the data-parallel step none, the BA one
# all-reduce per iteration, the refiner 5 all-reduces and the points'
# all-gather; the TP step one all-gather per column-sharded matcher
COMPILED = {"tp_step": ("world4", None), "dp_step": ("world2", 0),
            "ba_points": ("world2", 3 * BA_ITERS),
            "ba_lines": ("world2", 3 * BA_ITERS),
            "win_points": ("world2", 3 * (5 + 1)),
            "win_lines": ("world2", 3 * (5 + 1))}


@pytest.mark.parametrize("key", list(COMPILED))
def test_sharded_program_is_compiled_and_equals_its_body(request, key):
    """make_sharded_vo_step's step (data-only in the world of 2, 2 x 2
    data x model with TP in the world of 4), make_sharded_ba's solver and
    make_sharded_window_refiner's refiner are `Compiled` programs; on the
    CPU each runs its body on its static buffers, and each of 3
    consecutive calls (a chained step; moved landmarks; moved keyframes)
    equals the eager body `.fn` on the same inputs bit for bit, with the
    same collectives."""
    world, n = COMPILED[key]
    for out in request.getfixturevalue(world):
        assert bool(out[f"{key}_compiled"])
        equal = out[f"{key}_equal_fn"]
        assert equal.shape == (3,) and equal.all(), equal
        n_prog, n_fn = out[f"{key}_collectives"]
        assert n_prog == n_fn and (n_prog > 0 if n is None else n_prog == n)


def test_group_runner_steps_through_the_compiled_step(world4):
    """GroupRunner's step is the compiled sharded step: one program per
    rank, every step_all equal to the step's eager body."""
    for out in world4:
        assert bool(out["grp_compiled"])
        assert len(out["grp_equal_fn"]) == N_FRAMES
        assert out["grp_equal_fn"].all()


# --------------------------------------------------------------------------
# (f) config groups
# --------------------------------------------------------------------------

def test_group_runner_two_groups(world4):
    """tests/test_groups.py:38: two configs on disjoint halves of the
    world, each rank stepping only its own group, no collective."""
    assert [int(o["grp_index"]) for o in world4] == [0, 0, 1, 1]
    for out in world4:
        assert out["grp_ranks"].tolist() == [[0, 1], [2, 3]]
        assert int(out["grp_collectives"]) == 0
        assert int(out["grp_lanes"]) == 1
        assert bool(out["grp_place_equal"])
        assert out["grp_good"].all()
    # the point-only group really ran without lines, the other with them
    assert max(world4[2]["grp_n_lines"]) == 0
    assert max(world4[0]["grp_n_lines"]) > 0


def test_group_runner_validation(world4):
    """tests/test_groups.py:75, with the JAX package's messages, and a
    step of a group the rank is not in."""
    for out in world4:
        assert str(out["grp_err_split"]) == \
            "4 devices do not split into 3 equal groups"
        assert str(out["grp_err_batch"]) == \
            "group a: batch 3 not a multiple of its 4 devices"
        assert "not in group" in str(out["grp_err_other"])


def test_workers_run_gloo_and_refuse_cuda_without_gpu(world2):
    for out in world2:
        assert str(out["backend"]) == "gloo"
        assert "device='cpu'" in str(out["cuda_refused"])


# --------------------------------------------------------------------------
# (g) the whole-sequence scan
# --------------------------------------------------------------------------

def test_vo_scan_batched_equals_step_loop():
    cfg = TCfg(orb_nfeatures=128, orb_nlevels=1, lsd_nfeatures=16,
               lsd_n_dirs=4, min_features=8)
    cam = tcam.StereoCamera(fx=100.0, fy=100.0, cx=64.0, cy=48.0, b=0.2,
                            width=128, height=96)
    rng = np.random.default_rng(5)
    base = rng.uniform(0, 255, (2, 1, 96, 128)).astype(np.float32)
    seq_l = torch.from_numpy(np.concatenate(
        [np.roll(base, s, axis=3) for s in range(3)], axis=1))
    seq_r = torch.roll(seq_l, -2, dims=3)
    state, tel = tbatched.vo_scan_batched(
        tbatched.init_batched_state(cfg, 2, "cpu"), seq_l, seq_r, cam, cfg)
    assert tel.Tfw.shape == (3, 2, 4, 4) and tel.good.shape == (3, 2)
    s = tbatched.init_batched_state(cfg, 2, "cpu")
    for i in range(3):
        s, t = tbatched.vo_step_batched(s, seq_l[:, i], seq_r[:, i], cam, cfg)
        for a, b in zip(t, tel):
            assert torch.equal(a, b[i])
    for a, b in zip(s.prev_points, state.prev_points):
        assert torch.equal(a, b)
    assert torch.equal(s.Tfw, state.Tfw)
