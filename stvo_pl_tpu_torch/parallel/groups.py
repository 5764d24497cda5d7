"""Heterogeneous config groups over contiguous rank groups (port of
stvo_pl_tpu/parallel/groups.py).

Different pipeline configurations (feature budgets, robust kernels,
point-only vs point + line) run on disjoint sets of ranks at once, as
separate processes of the reference could: KITTI sequences with one
config on half the GPUs and EuRoC sequences with another on the other
half, one `torchrun` launch.  Groups exchange nothing, so no collective
crosses a group boundary.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh

from stvo_pl_tpu_torch.config import VOConfig
from stvo_pl_tpu_torch.ops import camera as cam_ops
from stvo_pl_tpu_torch.parallel import batched
from stvo_pl_tpu_torch.parallel.mesh import DATA_AXIS, MODEL_AXIS, mesh_device

GROUP_AXIS = "group"


@dataclass(frozen=True)
class ConfigGroup:
    """One VO configuration + camera bound to a group of ranks."""
    name: str
    cfg: VOConfig
    cam: cam_ops.StereoCamera
    batch: int  # sequences in this group (multiple of its rank count)


class GroupRunner:
    """Split the ranks of the default group into len(groups) contiguous
    groups (a ("group", "data", "model") mesh of shape (G, world / G, 1))
    and build, on each rank, the sharded VO step of its own group only: a
    captured program (batched.make_sharded_vo_step), the counterpart of
    the JAX package's one compiled step per group.

    Every rank of the world constructs the runner (making the mesh is
    collective).  `index` is this rank's group; `step(i, ...)` runs group
    i's step and raises for a group this rank is not in; `step_all`
    advances this rank's group."""

    def __init__(self, groups: Sequence[ConfigGroup],
                 device_type: str = "cuda"):
        world = dist.get_world_size()
        if world % len(groups) != 0:
            raise ValueError(
                f"{world} devices do not split into {len(groups)} "
                "equal groups")
        per = world // len(groups)
        for g in groups:
            if g.batch % per != 0:
                raise ValueError(
                    f"group {g.name}: batch {g.batch} not a multiple of its "
                    f"{per} devices")
        self.groups = list(groups)
        self.mesh = init_device_mesh(
            device_type, (len(groups), per, 1),
            mesh_dim_names=(GROUP_AXIS, DATA_AXIS, MODEL_AXIS))
        self.index = self.mesh.get_local_rank(GROUP_AXIS)
        self.ranks = [list(range(i * per, (i + 1) * per))
                      for i in range(len(groups))]
        g = self.groups[self.index]
        self._step, self._place = batched.make_sharded_vo_step(
            self.mesh, g.cam, g.cfg)

    def _own(self, i: int) -> ConfigGroup:
        if i != self.index:
            raise ValueError(f"rank {dist.get_rank()} is in group "
                             f"{self.index} ({self.groups[self.index].name}),"
                             f" not in group {i}")
        return self.groups[i]

    def init_state(self, i: int):
        """This rank's lanes of group i's batched VOState, on its device."""
        g = self._own(i)
        dev = mesh_device(self.mesh)
        state = batched.init_batched_state(g.cfg, g.batch, device=dev)
        img = torch.zeros((g.batch, g.cam.height, g.cam.width), device=dev)
        return self._place(state, img, img)[0]

    def place(self, i: int, state, imgs_l, imgs_r):
        """This rank's lanes of group i's global state and [B, H, W]
        images, on its device."""
        self._own(i)
        return self._place(state, imgs_l, imgs_r)

    def step(self, i: int, state, imgs_l, imgs_r):
        """One VO step of group i on this rank's lanes."""
        self._own(i)
        return self._step(state, imgs_l, imgs_r)

    def step_all(self, states, imgs_l_per_group, imgs_r_per_group):
        """Advance every group one frame: lists indexed by group, of which
        this rank reads and replaces its own group's entry only (the other
        entries may be None).  Returns (states, telemetries), None in the
        telemetry of every other group."""
        i = self.index
        states = list(states)
        telems = [None] * len(self.groups)
        states[i], telems[i] = self._step(states[i], imgs_l_per_group[i],
                                          imgs_r_per_group[i])
        return states, telems
