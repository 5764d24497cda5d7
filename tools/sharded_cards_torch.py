"""The compiled sharded programs across the cards of one host: every replay
held `torch.equal` to its eager body, and the sharded results to the
unsharded ones, on every rank.

    torchrun --nproc-per-node 4 tools/sharded_cards_torch.py
    torchrun --nproc-per-node 4 tools/sharded_cards_torch.py --device cpu

One process per card, an NCCL world over all of them (`--device cpu`: a
gloo world on the CPU at the 240x180 size of the tests, a rehearsal).
Every rank renders the same lanes of synthetic frames (8 KITTI-sized
lanes of chip_smoke.py's scenes on the cards, 4 small ones on the CPU)
and runs, each program compiled and eager (its `.fn`) in turns:

  tp_step  make_sharded_vo_step on a (world / 2) x 2 data x model mesh
           with every matcher column-sharded (tp_min_features=16): its
           all-gathers between the two cards of a data row captured;
  dp_step  make_sharded_vo_step on a world x 1 mesh (no collective);
  ba       make_sharded_ba on a 4-keyframe window of lane 0, the
           landmarks split over the world's ranks (8 all-reduces);
  refiner  make_sharded_window_refiner on the same window (8 all-reduces
           and the points' all-gather).

The steps are also held `torch.equal` to the unsharded vo_step_batched
on this rank's lanes, and compared with it over all lanes (per frame:
whether every field of this rank's lanes is `torch.equal`, and the
largest pose difference: a step over fewer lanes may round otherwise);
the BA's and refiner's poses are compared with ba_solve and
refine_window (their partial systems are summed in another order).
Each rank prints one JSON line: equality, ms per step or window in
turns, the collectives each capture issued and the graph's nodes by
kind (its NCCL kernels counted apart).  Every program is let go of, and
the device synchronized, before the group is destroyed.  A failed check
exits non-zero.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import subprocess
import sys
import time
import traceback

import torch
import torch.distributed as dist

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402
from stvo_pl_tpu_torch.config import VOConfig  # noqa: E402
from stvo_pl_tpu_torch.models import frontend  # noqa: E402
from stvo_pl_tpu_torch.ops import camera as cam_ops  # noqa: E402
from stvo_pl_tpu_torch.ops import se3  # noqa: E402
from stvo_pl_tpu_torch.parallel import ba, batched, window  # noqa: E402
from stvo_pl_tpu_torch.parallel import mesh as mesh_mod  # noqa: E402
from stvo_pl_tpu_torch.utils import synthetic  # noqa: E402

FRAMES = 6
WARMUP = 2
WINDOW = 4
TURNS = 2


def sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize()


def first(prog, dev, *args) -> dict:
    """A program's first call; on the card its graph kept and read
    (chip_smoke.first_call) with the collectives its capture issued."""
    if dev.type != "cuda":
        prog(*args)
        return {}
    with cs.collectives_in_capture() as calls:
        g = cs.first_call(prog, *args)
    return dict(capture_s=g["capture_s"], kernel_nodes=g["kernel_nodes"],
                node_kinds=g["node_kinds"], captured_calls=calls,
                nccl_kernels={k: n for k, n in g["kernels"].items()
                              if "nccl" in k.lower()})


def in_turns(arms: dict, run, dev) -> tuple[dict, dict]:
    """run(f) -> (result, ms) for each arm, TURNS times in turns; the
    first turn's results."""
    ms = {k: [] for k in arms}
    out = {}
    for turn in range(TURNS):
        for name, f in arms.items():
            sync(dev)
            res, t = run(f)
            ms[name].append(t)
            out.setdefault(name, res)
    return out, ms


def scenario(device: str) -> tuple:
    if device == "cuda":
        cam = cam_ops.StereoCamera(fx=718.856, fy=718.856, cx=613.0,
                                   cy=185.0, b=0.5372, width=1226,
                                   height=370)
        return (cam, VOConfig(), 8,
                dict(n_points=1400, n_lines=64, extent=(40.0, 15.0, 90.0),
                     z_near=5.0), 0.8)
    cam = cam_ops.StereoCamera(fx=160.0, fy=160.0, cx=120.0, cy=90.0, b=0.3,
                               width=240, height=180)
    cfg = VOConfig(orb_nfeatures=300, orb_nlevels=2, lsd_nfeatures=48,
                   lsd_n_dirs=8, min_features=8, fast_feat_th=20)
    return (cam, cfg, 4, dict(n_points=260, n_lines=24,
                              extent=(14.0, 8.0, 40.0), z_near=3.0), 0.25)


def run(device: str) -> dict:
    cam, cfg, lanes, scene_kw, speed = scenario(device)
    world = dist.get_world_size()
    dev = torch.device(device, torch.cuda.current_device()) \
        if device == "cuda" else torch.device("cpu")
    poses = synthetic.smooth_trajectory(FRAMES, speed=speed, device=dev)
    L, R = [], []
    for b in range(lanes):
        gen = torch.Generator(device=dev).manual_seed(1000 + b)
        scene = synthetic.make_scene(gen, **scene_kw)
        left, right = synthetic.render_sequence(scene, poses, cam)
        L.append(left)
        R.append(right)
    L, R = torch.stack(L), torch.stack(R)
    frame = lambda i: (L[:, i].contiguous(), R[:, i].contiguous())

    # the unsharded reference over all lanes
    state = batched.init_batched_state(cfg, lanes, device=dev)
    dense = []
    for i in range(FRAMES):
        state, t = batched.vo_step_batched(state, *frame(i), cam, cfg)
        dense.append((state, t))
    out = {}

    def steps(key, mesh, step_cfg):
        step, place = batched.make_sharded_vo_step(mesh, cam, step_cfg)
        init = lambda: place(batched.init_batched_state(step_cfg, lanes,
                                                        device=dev),
                             *frame(0))[0]
        info = first(step, dev, init(), *[mesh_mod.data_slice(mesh, x)
                                           for x in frame(0)])

        def chain(f):
            state, res = init(), []
            for i in range(FRAMES):
                if i == WARMUP:
                    sync(dev)
                    t0 = time.perf_counter()
                state, t = f(state, *[mesh_mod.data_slice(mesh, x)
                                      for x in frame(i)])
                res.append((state, t))
            sync(dev)
            return res, (time.perf_counter() - t0) / (FRAMES - WARMUP) * 1e3

        got, ms = in_turns(
            {"graph": step, "eager": step.fn,
             "unsharded": lambda s, a, b: batched.vo_step_batched(
                 s, a, b, cam, cfg)}, chain, dev)
        cut = lambda tree: frontend._map(
            lambda x: mesh_mod.data_slice(mesh, x), tree)
        for ref in ("eager", "unsharded"):
            cs.require(all(cs.same(a, b) for a, b in zip(got["graph"],
                                                         got[ref])),
                       f"{key}: rank {dist.get_rank()}'s replays differ "
                       f"from the {ref} step on its lanes")
        out[key] = dict(
            mesh=list(mesh.shape), equal_fn=True, equal_unsharded=True,
            equal_all_lanes=[cs.same(a, (cut(s), cut(t)))
                             for a, (s, t) in zip(got["graph"], dense)],
            max_tfw_diff_to_all_lanes=max(
                float((a[1].Tfw - cut(t).Tfw).abs().max())
                for a, (_, t) in zip(got["graph"], dense)),
            ms_per_step=ms, **info)

    steps("tp_step", mesh_mod.make_mesh(n_data=world // 2, n_model=2,
                                        device_type=device),
          cfg.replace(tp_min_features=16))
    mesh = mesh_mod.make_mesh(n_data=world, n_model=1, device_type=device)
    steps("dp_step", mesh, cfg)

    # a window of lane 0, every frame a keyframe
    kfs = [(t.Tfw[0], *(type(x)(*[f[0] for f in x])
                        for x in (s.prev_points, s.prev_lines)))
           for s, t in dense[:WINDOW]]
    win = window.stack_keyframes(kfs)
    prob = window.build_problem_tracks(win, cam, cfg)
    poses_cw = se3.inverse_se3(win.Tfw)
    args = (poses_cw, prob.X, prob.obs, prob.mask, prob.sigma2, prob.Xl,
            prob.obs_l, prob.mask_l, prob.sigma2_l)

    def timed(call):
        def go(f):
            sync(dev)
            t0 = time.perf_counter()
            res = call(f)
            sync(dev)
            return res, (time.perf_counter() - t0) * 1e3
        return go

    for key, prog, call, ref in (
            ("ba", ba.make_sharded_ba(mesh, cam, n_iters=8, has_lines=True),
             lambda f: f(*args),
             lambda: ba.ba_solve(poses_cw, prob, cam, n_iters=8)[0]),
            ("refiner", window.make_sharded_window_refiner(
                mesh, cam, cfg, n_iters=8, has_lines=True),
             lambda f: f(win),
             lambda: window.refine_window(win, cam, cfg, n_iters=8)[0])):
        info = first(prog, dev, *((win,) if key == "refiner" else args))
        got, ms = in_turns({"graph": prog, "eager": prog.fn}, timed(call),
                           dev)
        cs.require(cs.same(got["graph"], got["eager"]),
                   f"{key}: rank {dist.get_rank()}'s replay differs from "
                   "its eager body")
        out[key] = dict(equal_fn=True, ms_per_window=ms,
                        max_pose_diff_to_unsharded=float(
                            (got["graph"][0] - ref()).abs().max()), **info)
        del prog
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    device = ap.parse_args().device
    if device == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    mesh_mod.init_distributed(device_type=device)
    rank, world = dist.get_rank(), dist.get_world_size()
    if world % 2:
        cs.fail(f"a world of {world}: the TP mesh needs an even one")
    card = (subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True,
                           text=True).stdout.strip().splitlines()
            if device == "cuda" else ["cpu"])
    try:
        out = run(device)
    except BaseException as e:
        # a failed check's frames hold their programs
        traceback.clear_frames(e.__traceback__)
        raise
    finally:
        gc.collect()
        if device == "cuda":
            torch.cuda.synchronize()
        dist.destroy_process_group()
    print(json.dumps(dict(rank=rank, world=world, backend=(
        "nccl" if device == "cuda" else "gloo"), cards=card, **out)),
        flush=True)


if __name__ == "__main__":
    main()
