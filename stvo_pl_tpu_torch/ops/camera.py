"""Rectified pinhole stereo camera: projection and back-projection
(port of stvo_pl_tpu/ops/camera.py:21-60; reference
src/pinholeStereoCamera.cpp:221-237).  Rectification maps wait for a later
slice."""

from __future__ import annotations

from typing import NamedTuple

import torch


class StereoCamera(NamedTuple):
    """Static rectified-stereo intrinsics (Python scalars)."""
    fx: float
    fy: float
    cx: float
    cy: float
    b: float          # baseline [m]
    width: int
    height: int

    @property
    def bfx(self) -> float:
        return self.b * self.fx


def project(cam: StereoCamera, P: torch.Tensor) -> torch.Tensor:
    """[..., 3] camera-frame points -> [..., 2] pixels."""
    z = P[..., 2]
    u = cam.cx + cam.fx * P[..., 0] / z
    v = cam.cy + cam.fy * P[..., 1] / z
    return torch.stack([u, v], dim=-1)


def back_project(cam: StereoCamera, uv: torch.Tensor,
                 disp: torch.Tensor) -> torch.Tensor:
    """[..., 2] pixels + [...] disparity -> [..., 3] points,
    P = (b/d) [u-cx, v-cy, fx]."""
    bd = cam.b / disp
    x = bd * (uv[..., 0] - cam.cx)
    y = bd * (uv[..., 1] - cam.cy)
    z = bd * cam.fx
    return torch.stack([x, y, z], dim=-1)
