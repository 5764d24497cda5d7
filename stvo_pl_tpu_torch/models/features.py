"""Feature sets: NamedTuples of tensors with static capacity and a validity
mask (port of stvo_pl_tpu/models/features.py).

Every field may carry leading batch dims ([B, N, ...]); "erasing" a feature
clears its mask bit.  Binary descriptors are int32 words holding the bits
of the reference's uint32 words.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class PointSet(NamedTuple):
    """Stereo-matched point features of one frame (capacity Np)."""
    uv: torch.Tensor       # [..., Np, 2] left pixel coords (level 0)
    disp: torch.Tensor     # [..., Np]
    P: torch.Tensor        # [..., Np, 3] camera-frame 3-D point
    desc: torch.Tensor     # [..., Np, 8] int32 (256-bit descriptor)
    level: torch.Tensor    # [..., Np] int32 pyramid level
    sigma2: torch.Tensor   # [..., Np] per-level variance factor
    valid: torch.Tensor    # [..., Np] bool


class LineSet(NamedTuple):
    """Stereo-matched line-segment features of one frame (capacity Nl)."""
    spl: torch.Tensor      # [..., Nl, 2]
    epl: torch.Tensor      # [..., Nl, 2]
    sdisp: torch.Tensor    # [..., Nl]
    edisp: torch.Tensor    # [..., Nl]
    sP: torch.Tensor       # [..., Nl, 3]
    eP: torch.Tensor       # [..., Nl, 3]
    le: torch.Tensor       # [..., Nl, 3] infinite-line coeffs
    angle: torch.Tensor    # [..., Nl]
    desc: torch.Tensor     # [..., Nl, 8] int32
    level: torch.Tensor    # [..., Nl] int32
    sigma2: torch.Tensor   # [..., Nl]
    valid: torch.Tensor    # [..., Nl] bool


class PointMatches(NamedTuple):
    """Frame-to-frame matched points, aligned with the previous frame's
    PointSet."""
    P: torch.Tensor        # [..., Np, 3] 3-D from previous frame
    obs: torch.Tensor      # [..., Np, 2] observation in current frame
    sigma2: torch.Tensor   # [..., Np]
    valid: torch.Tensor    # [..., Np] matched mask
    inlier: torch.Tensor   # [..., Np] survives outlier rejection

    def count(self) -> torch.Tensor:
        return torch.sum(self.valid & self.inlier, dim=-1)


class LineMatches(NamedTuple):
    """Frame-to-frame matched lines, aligned with the previous frame's
    LineSet."""
    sP: torch.Tensor
    eP: torch.Tensor
    spl: torch.Tensor
    epl: torch.Tensor
    le_obs: torch.Tensor
    sigma2: torch.Tensor
    valid: torch.Tensor
    inlier: torch.Tensor

    def count(self) -> torch.Tensor:
        return torch.sum(self.valid & self.inlier, dim=-1)


def empty_points(capacity: int, dtype=torch.float32, device="cpu",
                 batch: tuple[int, ...] = ()) -> PointSet:
    z = lambda *s, dt=dtype: torch.zeros(batch + s, dtype=dt, device=device)
    return PointSet(
        uv=z(capacity, 2), disp=z(capacity), P=z(capacity, 3),
        desc=z(capacity, 8, dt=torch.int32),
        level=z(capacity, dt=torch.int32),
        sigma2=torch.ones(batch + (capacity,), dtype=dtype, device=device),
        valid=z(capacity, dt=torch.bool))


def empty_lines(capacity: int, dtype=torch.float32, device="cpu",
                batch: tuple[int, ...] = ()) -> LineSet:
    z = lambda *s, dt=dtype: torch.zeros(batch + s, dtype=dt, device=device)
    return LineSet(
        spl=z(capacity, 2), epl=z(capacity, 2), sdisp=z(capacity),
        edisp=z(capacity), sP=z(capacity, 3), eP=z(capacity, 3),
        le=z(capacity, 3), angle=z(capacity),
        desc=z(capacity, 8, dt=torch.int32),
        level=z(capacity, dt=torch.int32),
        sigma2=torch.ones(batch + (capacity,), dtype=dtype, device=device),
        valid=z(capacity, dt=torch.bool))
