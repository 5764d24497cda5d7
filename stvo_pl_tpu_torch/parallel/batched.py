"""Multi-sequence batched VO: B sequences advance in lock step, one lane of
VOState per sequence, and the batch split over the ranks of a device mesh
(port of stvo_pl_tpu/parallel/batched.py).

Sequences are independent, so the data-parallel step issues no
collective: each rank runs `vo_step_batched` on its own B / n_data lanes.
With a model axis the ranks of one data row hold the same lanes and
column-shard every matcher whose query set reaches cfg.tp_min_features
(parallel/tp.py); the result is the unsharded step's bit for bit.

`compile_vo_step` is the step captured as a CUDA graph, the counterpart of
the JAX package's jitted `vo_step_batched` (parallel/compiled.py);
`vo_scan_batched` replays it on CUDA.  The sharded step is captured the
same way, its TP all-gathers inside the graph.
"""

from __future__ import annotations

import torch

from stvo_pl_tpu_torch.config import VOConfig
from stvo_pl_tpu_torch.models import frontend
from stvo_pl_tpu_torch.ops import camera as cam_ops
from stvo_pl_tpu_torch.parallel.compiled import Compiled
from stvo_pl_tpu_torch.parallel.mesh import (MODEL_AXIS, axis, data_slice,
                                             mesh_device)


def init_batched_state(cfg: VOConfig, batch: int,
                       device=None) -> frontend.VOState:
    """[B]-batched VOState on `device` ("cuda" unless the caller asks for
    the CPU)."""
    return frontend.init_state(cfg, device=device, batch=(batch,))


def vo_step_batched(state: frontend.VOState, imgs_l: torch.Tensor,
                    imgs_r: torch.Tensor, cam: cam_ops.StereoCamera,
                    cfg: VOConfig, per_direction: bool = False, tp=None):
    """One step for B sequences at once: [B, H, W] stereo stacks.  All
    lanes and both eyes share each kernel launch (FAST and patches per
    pyramid level, the line-run kernel once per step; with the dense
    single-octave detector and `per_direction=True`, once per direction).
    tp = (model-axis process group, n_shards) enables column-sharded
    matching (see make_sharded_vo_step)."""
    return frontend.step_lanes(state, imgs_l, imgs_r, cam, cfg,
                               per_direction=per_direction, tp=tp)


def _lanes(batch: int, state: frontend.VOState) -> None:
    if state.Tfw.shape[:1] != (batch,):
        raise ValueError(f"the step was compiled for {batch} lanes, the "
                         f"state has {tuple(state.Tfw.shape[:-2])}")


def compile_vo_step(cam: cam_ops.StereoCamera, cfg: VOConfig, batch: int,
                    per_direction: bool = False, device=None) -> Compiled:
    """`vo_step_batched` for `batch` lanes as a captured program on
    `device` ("cuda" unless the caller asks for the CPU), the counterpart
    of the JAX package's jitted step with `donate_argnums=(0,)`:
    `step(state, imgs_l, imgs_r) -> (state, telemetry)`, equal to
    `vo_step_batched` bit for bit.  The input state is only read (a
    caller may drop or reuse it), and what a call returns stays the
    caller's: no later call changes it (parallel/compiled.py)."""
    def step(state, imgs_l, imgs_r):
        _lanes(batch, state)
        return vo_step_batched(state, imgs_l, imgs_r, cam, cfg,
                               per_direction=per_direction)
    return Compiled(step, device)


def compile_vo_step_rgbd(cam: cam_ops.StereoCamera, cfg: VOConfig,
                         batch: int, per_direction: bool = False,
                         device=None) -> Compiled:
    """`frontend.step_lanes_rgbd` for `batch` lanes as a captured
    program: `step(state, imgs, depths) -> (state, telemetry)`."""
    def step(state, imgs, depths):
        _lanes(batch, state)
        return frontend.step_lanes_rgbd(state, imgs, depths, cam, cfg,
                                        per_direction=per_direction)
    return Compiled(step, device)


def make_sharded_vo_step(mesh, cam: cam_ops.StereoCamera, cfg: VOConfig):
    """(step, place) for this rank of `mesh` (dimensions "data" and,
    optionally, "model"; other dimensions, such as the config groups'
    "group", are read by nobody here).

    `place(state, imgs_l, imgs_r)` takes the global [B, ...] state and
    images (B a multiple of the data-axis size) and returns this rank's
    B / n_data lanes on its device; `step(state, imgs_l, imgs_r)` advances
    them.  With a model axis of size > 1 every matcher whose budget
    reaches cfg.tp_min_features column-shards its distance matrix over it;
    without one the step issues no collective.

    `step` is a captured program on the mesh's device (parallel/compiled.py),
    the counterpart of the JAX package's jitted sharded step: with a model
    axis its graph holds the matchers' all-gathers; `step.fn` is its eager
    body.  `place` runs on the host side, outside the program."""
    group, n_model, _ = axis(mesh, MODEL_AXIS)
    tp = (group, n_model) if n_model > 1 else None
    dev = mesh_device(mesh)

    def step(state, imgs_l, imgs_r):
        return vo_step_batched(state, imgs_l, imgs_r, cam, cfg, tp=tp)

    def place(state, imgs_l, imgs_r):
        state = frontend._map(lambda x: data_slice(mesh, x).to(dev), state)
        return (state, data_slice(mesh, imgs_l).to(dev),
                data_slice(mesh, imgs_r).to(dev))

    return Compiled(step, dev, groups=(group,) if tp else ()), place


def vo_scan_batched(state: frontend.VOState, seq_l: torch.Tensor,
                    seq_r: torch.Tensor, cam: cam_ops.StereoCamera,
                    cfg: VOConfig):
    """Whole sequences for B lanes: [B, T, H, W] stacks -> (final state,
    telemetry stacked [T, B, ...], the JAX package's scan layout).  Every
    frame replays one captured step (`compile_vo_step`, built for this
    call; on the CPU it runs eagerly), as the JAX package's scan is one
    program."""
    step = compile_vo_step(cam, cfg, seq_l.shape[0],
                           device=state.Tfw.device)
    telems = []
    for i in range(seq_l.shape[1]):
        state, t = step(state, seq_l[:, i], seq_r[:, i])
        telems.append(t)
    return state, frontend.StepTelemetry(
        *[torch.stack(f) for f in zip(*telems)])
