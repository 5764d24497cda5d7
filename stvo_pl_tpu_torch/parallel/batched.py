"""Multi-sequence batched VO on one device: B sequences advance in lock
step, one lane of VOState per sequence (port of
stvo_pl_tpu/parallel/batched.py:24-43; the mesh-sharded step is a later
slice)."""

from __future__ import annotations

import torch

from stvo_pl_tpu_torch.config import VOConfig
from stvo_pl_tpu_torch.models import frontend
from stvo_pl_tpu_torch.ops import camera as cam_ops


def init_batched_state(cfg: VOConfig, batch: int,
                       device=None) -> frontend.VOState:
    """[B]-batched VOState on `device` ("cuda" unless the caller asks for
    the CPU)."""
    return frontend.init_state(cfg, device=device, batch=(batch,))


def vo_step_batched(state: frontend.VOState, imgs_l: torch.Tensor,
                    imgs_r: torch.Tensor, cam: cam_ops.StereoCamera,
                    cfg: VOConfig, per_direction: bool = False):
    """One step for B sequences at once: [B, H, W] stereo stacks.  All
    lanes and both eyes share each kernel launch (FAST and patches per
    pyramid level, the line-run kernel once per step; with the dense
    single-octave detector and `per_direction=True`, once per direction)."""
    return frontend.step_lanes(state, imgs_l, imgs_r, cam, cfg,
                               per_direction=per_direction)
