"""One rank of a CPU (gloo) world for the port's scale-out checks.

    python tools/torch_dist_worker.py RANK WORLD STORE IN.npz OUT_DIR TASKS

Every rank of a world is started with the same arguments but its RANK;
they meet through the FileStore STORE (a path that does not exist yet),
read their inputs from IN.npz, run the comma-separated TASKS in order and
write what they computed to OUT_DIR/rank<RANK>.npz.  Spawned by
tests/test_torch_parallel.py, which checks the results; imports nothing
of JAX.  Tasks:

  tp        stand-alone `tp_match` on 1 x P meshes, P = 2 and the world
            size, mutual on and off
  tp_step   the sharded VO step on a 2 x 2 data x model mesh (matchers
            column-sharded) and the unsharded step on the whole batch
  dp_step   the data-parallel sharded step over 3 frames, every
            collective counted, and the unsharded step on the whole batch
  ba        `make_sharded_ba` with points and with lines, and a landmark
            count the data axis does not divide
  window    `make_sharded_window_refiner` without and with lines
  groups    a two-group `GroupRunner` and its validation errors

The sharded step, BA and refiner are captured programs
(parallel/compiled.Compiled; on the CPU they run their body eagerly on
static buffers): each task records whether they are, and holds each of
3 consecutive calls `torch.equal` to the program's eager body (`.fn`) on
the same inputs, with as many collectives.
"""

from __future__ import annotations

import os
import sys

import numpy as np
import torch
import torch.distributed as dist

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from stvo_pl_tpu_torch import convert  # noqa: E402
from stvo_pl_tpu_torch.config import VOConfig  # noqa: E402
from stvo_pl_tpu_torch.models.features import LineSet, PointSet  # noqa: E402
from stvo_pl_tpu_torch.ops import camera as cam_ops  # noqa: E402
from stvo_pl_tpu_torch.parallel import ba, batched, compiled  # noqa: E402
from stvo_pl_tpu_torch.parallel import groups  # noqa: E402
from stvo_pl_tpu_torch.parallel import mesh as mesh_mod  # noqa: E402
from stvo_pl_tpu_torch.parallel import tp, window  # noqa: E402

COLLECTIVES = ("all_reduce", "all_gather", "all_gather_into_tensor",
               "all_to_all", "all_to_all_single", "broadcast", "reduce",
               "reduce_scatter", "reduce_scatter_tensor", "gather",
               "scatter", "send", "recv", "isend", "irecv", "barrier")

# the 128x96 TP step of tests/test_tp.py and the 240x180 scenes of
# tests/test_sharded_step.py / tests/test_groups.py
TP_CFG = VOConfig(orb_nfeatures=128, orb_nlevels=1, lsd_nfeatures=16,
                  lsd_n_dirs=4, min_features=8, tp_min_features=16)
TP_CAM = cam_ops.StereoCamera(fx=100.0, fy=100.0, cx=64.0, cy=48.0, b=0.2,
                              width=128, height=96)
CAM = cam_ops.StereoCamera(fx=160.0, fy=160.0, cx=120.0, cy=90.0, b=0.3,
                           width=240, height=180)
DP_CFG = VOConfig(orb_nfeatures=200, orb_nlevels=2, lsd_nfeatures=32,
                  lsd_n_dirs=8, min_features=8, fast_feat_th=20)
GROUP_CFG = VOConfig(orb_nfeatures=300, orb_nlevels=2, lsd_nfeatures=48,
                     lsd_n_dirs=8, min_features=8, fast_feat_th=20,
                     lsd_octaves=1)
BA_CAM = cam_ops.StereoCamera(fx=400.0, fy=400.0, cx=160.0, cy=120.0, b=0.2,
                              width=320, height=240)


class CountCollectives:
    """Counts every call of torch.distributed's collectives while
    entered."""

    def __init__(self):
        self.calls = {}
        self._saved = {}

    def __enter__(self):
        for name in COLLECTIVES:
            fn = getattr(dist, name, None)
            if fn is None:
                continue
            self._saved[name] = fn

            def counted(*a, _fn=fn, _name=name, **kw):
                self.calls[_name] = self.calls.get(_name, 0) + 1
                return _fn(*a, **kw)

            setattr(dist, name, counted)
        return self

    def __exit__(self, *exc):
        for name, fn in self._saved.items():
            setattr(dist, name, fn)
        return False

    @property
    def total(self) -> int:
        return sum(self.calls.values())


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a))


def _same(a, b) -> bool:
    """Two trees of tensors (NamedTuples, tuples, None) `torch.equal` leaf
    by leaf."""
    la, lb = [], []
    compiled._flatten(a, la)
    compiled._flatten(b, lb)
    return len(la) == len(lb) and all(torch.equal(x, y)
                                      for x, y in zip(la, lb))


def _against_fn(out, key, prog, run) -> tuple:
    """`run(f)` makes consecutive calls of f and returns their results; it
    runs with the program and then with its eager body.  Records whether
    the program is a `Compiled` (key_compiled), one flag per call for
    `torch.equal` results (key_equal_fn) and the collectives of both runs
    (key_collectives: program, body).  Returns the program's results and
    the collectives it called by name."""
    runs, counts = [], []
    for f in (prog, prog.fn):
        with CountCollectives() as cc:
            runs.append(run(f))
        counts.append(cc)
    got, want = runs
    out[f"{key}_compiled"] = np.bool_(isinstance(prog, compiled.Compiled))
    out[f"{key}_equal_fn"] = np.array([_same(a, b)
                                       for a, b in zip(got, want)])
    out[f"{key}_collectives"] = np.array([c.total for c in counts])
    return got, counts[0].calls


def _error(fn) -> str:
    """The message of the ValueError that fn raises ('' if none)."""
    try:
        fn()
    except ValueError as e:
        return str(e)
    return ""


def task_tp(inp, out, rank, world):
    d1, v1 = _t(inp["tp_d1"]), _t(inp["tp_v1"])
    d2, v2 = _t(inp["tp_d2"]), _t(inp["tp_v2"])
    for n_model in sorted({2, world}):
        mesh = mesh_mod.make_mesh(n_model=n_model, device_type="cpu")
        p = mesh.get_local_rank(mesh_mod.MODEL_AXIS)
        m = d2.shape[0] // n_model
        for mutual in (True, False):
            res = tp.tp_match(d1, v1, d2[p * m:(p + 1) * m],
                              v2[p * m:(p + 1) * m], 0.8, mesh,
                              mutual=mutual)
            out[f"tp_{n_model}_{int(mutual)}_idx"] = res.idx.numpy()
            out[f"tp_{n_model}_{int(mutual)}_valid"] = res.valid.numpy()


def _step_out(out, key, state, telem):
    out[f"{key}_Tfw"] = telem.Tfw.numpy()
    out[f"{key}_good"] = telem.good.numpy()
    out[f"{key}_n_inliers_pt"] = telem.n_inliers_pt.numpy()
    out[f"{key}_points_valid"] = state.prev_points.valid.numpy()
    out[f"{key}_lines_valid"] = state.prev_lines.valid.numpy()


def task_tp_step(inp, out, rank, world):
    il, ir = _t(inp["tp_il"]), _t(inp["tp_ir"])
    B = il.shape[0]
    mesh = mesh_mod.make_mesh(n_data=world // 2, n_model=2,
                              device_type="cpu")
    step, place = batched.make_sharded_vo_step(mesh, TP_CAM, TP_CFG)
    state0, _, _ = place(batched.init_batched_state(TP_CFG, B, "cpu"), il,
                         ir)
    # frame f: the pair shifted f px to the left
    frames = [[mesh_mod.data_slice(mesh, torch.roll(x, -f, dims=-1))
               for x in (il, ir)] for f in range(3)]

    def run(f):
        state, res = state0, []
        for img_l, img_r in frames:
            state, t = f(state, img_l, img_r)
            res.append((state, t))
        return res

    res, calls = _against_fn(out, "tp_step", step, run)
    _step_out(out, "tp_step", *res[0])
    out["tp_step_gathers"] = np.int64(calls.get("all_gather_into_tensor", 0))
    out["tp_step_lanes"] = mesh_mod.data_slice(mesh,
                                               torch.arange(B)).numpy()
    s, t = batched.vo_step_batched(batched.init_batched_state(TP_CFG, B,
                                                              "cpu"),
                                   il, ir, TP_CAM, TP_CFG)
    _step_out(out, "tp_dense", s, t)


def task_dp_step(inp, out, rank, world):
    seq_l, seq_r = _t(inp["dp_l"]), _t(inp["dp_r"])     # [B, T, H, W]
    B, T = seq_l.shape[:2]
    mesh = mesh_mod.make_mesh(device_type="cpu")
    step, place = batched.make_sharded_vo_step(mesh, CAM, DP_CFG)
    state0, _, _ = place(batched.init_batched_state(DP_CFG, B, "cpu"),
                         seq_l[:, 0], seq_r[:, 0])

    def run(f):
        state, res = state0, []
        for i in range(T):
            state, t = f(state, mesh_mod.data_slice(mesh, seq_l[:, i]),
                         mesh_mod.data_slice(mesh, seq_r[:, i]))
            res.append((state, t))
        return res

    res, calls = _against_fn(out, "dp_step", step, run)
    out["dp_collectives"] = np.int64(sum(calls.values()))
    _step_out(out, "dp_sharded", *res[-1])
    out["dp_lanes"] = mesh_mod.data_slice(mesh, torch.arange(B)).numpy()
    state = batched.init_batched_state(DP_CFG, B, "cpu")
    for i in range(T):
        state, t = batched.vo_step_batched(state, seq_l[:, i], seq_r[:, i],
                                           CAM, DP_CFG)
    _step_out(out, "dp_dense", state, t)


def task_ba(inp, out, rank, world):
    mesh = mesh_mod.make_mesh(device_type="cpu")
    for kind, has_lines in (("points", False), ("lines", True)):
        g = {k[len(kind) + 4:]: _t(inp[k]) for k in inp.files
             if k.startswith(f"ba_{kind}_")}
        solver = ba.make_sharded_ba(mesh, BA_CAM, n_iters=8,
                                    has_lines=has_lines)
        args = [g["poses0"], g["X"], g["obs"], g["mask"], g["sigma2"]]
        if has_lines:
            args += [g["Xl"], g["obs_l"], g["mask_l"], g["sigma2_l"]]

        def moved(i):
            """The problem with every landmark moved by i cm."""
            a = list(args)
            for j in (1, 5) if has_lines else (1,):
                a[j] = a[j] + 0.01 * i
            return a

        res, _ = _against_fn(out, f"ba_{kind}", solver,
                             lambda f: [f(*moved(i)) for i in range(3)])
        res = res[0]
        out[f"ba_{kind}_poses"] = res[0].numpy()
        out[f"ba_{kind}_X"] = res[1].numpy()
        out[f"ba_{kind}_costs"] = res[-1].numpy()
        if has_lines:
            out[f"ba_{kind}_Xl"] = res[2].numpy()
    odd = [a[:-1] for a in args[1:5]]          # 63 of the lines problem's
    solver = ba.make_sharded_ba(mesh, BA_CAM, n_iters=1)
    out["ba_uneven_error"] = np.array([_error(lambda: solver(args[0], *odd))
                                       for _ in range(2)])


def task_window(inp, out, rank, world):
    mesh = mesh_mod.make_mesh(device_type="cpu")
    win = convert.window_from_numpy(
        {"Tfw": inp["win_Tfw"],
         "points": {f: inp[f"win_p_{f}"] for f in PointSet._fields},
         "lines": {f: inp[f"win_l_{f}"] for f in LineSet._fields}},
        device="cpu")
    cfg = VOConfig(**{k[len("cfg_"):]: inp[k].item() for k in inp.files
                      if k.startswith("cfg_")})
    for kind, has_lines in (("points", False), ("lines", True)):
        refine = window.make_sharded_window_refiner(
            mesh, CAM, cfg, n_iters=5, has_lines=has_lines)
        w = win if has_lines else win._replace(lines=None)

        def moved(i):
            """The window with every keyframe moved by i cm along x."""
            Tfw = w.Tfw.clone()
            Tfw[:, 0, 3] += 0.01 * i
            return w._replace(Tfw=Tfw)

        res, _ = _against_fn(out, f"win_{kind}", refine,
                             lambda f: [f(moved(i)) for i in range(3)])
        T, X, costs = res[0]
        out[f"win_{kind}_Tfw"] = T.numpy()
        out[f"win_{kind}_X"] = X.numpy()
        out[f"win_{kind}_costs"] = costs.numpy()


def task_groups(inp, out, rank, world):
    seq_l, seq_r = _t(inp["grp_l"]), _t(inp["grp_r"])   # [T, H, W]
    cfg_p = GROUP_CFG.replace(has_lines=False)
    batch = world // 2                  # one lane per rank of each group
    ga = groups.ConfigGroup("pt+ls", GROUP_CFG, CAM, batch=batch)
    gb = groups.ConfigGroup("pt-only", cfg_p, CAM, batch=batch)
    # validation first: a refused split makes no mesh
    out["grp_err_split"] = np.array(_error(lambda: groups.GroupRunner(
        [ga, gb, gb], device_type="cpu")))
    out["grp_err_batch"] = np.array(_error(lambda: groups.GroupRunner(
        [groups.ConfigGroup("a", cfg_p, CAM, batch=3)], device_type="cpu")))
    runner = groups.GroupRunner([ga, gb], device_type="cpu")
    i, other = runner.index, 1 - runner.index
    g = runner.groups[i]
    out["grp_err_other"] = np.array(_error(lambda: runner.step(
        other, None, None, None)))
    out["grp_index"] = np.int64(i)
    out["grp_ranks"] = np.array(runner.ranks)
    # place() of the global state equals init_state()
    state = runner.init_state(i)
    placed, _, _ = runner.place(
        i, batched.init_batched_state(g.cfg, batch, "cpu"), seq_l[:batch],
        seq_r[:batch])
    out["grp_place_equal"] = np.bool_(all(
        torch.equal(a, b) for a, b in zip(state.prev_points, placed.prev_points)
    ) and torch.equal(state.Tfw, placed.Tfw))
    states = [None, None]
    states[i] = fn_state = state
    n_lines, good, equal = [], [], []
    with CountCollectives() as cc:
        for f in range(seq_l.shape[0]):
            imgs = [None, None], [None, None]
            for side, seq in zip(imgs, (seq_l, seq_r)):
                side[i] = mesh_mod.data_slice(
                    runner.mesh, seq[f].expand(batch, -1, -1))
            states, telems = runner.step_all(states, *imgs)
            n_lines.append(int(telems[i].n_lines.max()))
            good.append(bool(telems[i].good.all()))
            assert telems[other] is None and states[other] is None
            # the compiled step against its eager body
            fn_state, fn_t = runner._step.fn(fn_state, imgs[0][i],
                                             imgs[1][i])
            equal.append(_same((states[i], telems[i]), (fn_state, fn_t)))
    out["grp_collectives"] = np.int64(cc.total)
    out["grp_compiled"] = np.bool_(
        isinstance(runner._step, compiled.Compiled)
        and len(runner._step.programs) == 1)
    out["grp_equal_fn"] = np.array(equal)
    out["grp_n_lines"] = np.array(n_lines)
    out["grp_good"] = np.array(good)
    out["grp_lanes"] = np.int64(states[i].Tfw.shape[0])


TASKS = {"tp": task_tp, "tp_step": task_tp_step, "dp_step": task_dp_step,
         "ba": task_ba, "window": task_window, "groups": task_groups}


def main(argv):
    rank, world = int(argv[1]), int(argv[2])
    store, inp_path, out_dir, tasks = argv[3], argv[4], argv[5], argv[6]
    torch.set_num_threads(1)
    out = {}
    # a CUDA world without a GPU is refused, never moved to gloo
    if not torch.cuda.is_available():
        try:
            mesh_mod.init_distributed(device_type="cuda")
        except RuntimeError as e:
            out["cuda_refused"] = np.array(str(e))
    mesh_mod.init_distributed(device_type="cpu",
                              init_method=f"file://{store}", rank=rank,
                              world_size=world)
    out["backend"] = np.array(dist.get_backend())
    inp = np.load(inp_path)
    try:
        for name in tasks.split(","):
            TASKS[name](inp, out, rank, world)
        np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **out)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv)
