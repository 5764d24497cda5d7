"""Photometric sub-pixel stereo disparity (port of
stvo_pl_tpu/ops/subpix.py `disparity_shift`)."""

from __future__ import annotations

import torch

SSD_R = 5           # photometric alignment window radius -> 11x11


def disparity_shift(patch_l: torch.Tensor, patch_r: torch.Tensor,
                    radius: int = SSD_R):
    """Fractional epipolar alignment between matched stereo patches
    [..., K, Q, Q] centered on the integer gather centers.

    SSD between the left window and the right window shifted by dx in
    {-1, 0, +1}; a 1-D parabola through the three costs gives the shift.
    Returns (shift [..., K], ok [..., K]); the disparity is
    (x_center_l - x_center_r) - shift in level coordinates."""
    Q = patch_l.shape[-1]
    c = (Q - 1) // 2
    lo, hi = c - radius, c + radius + 1
    l_win = patch_l[..., lo:hi, lo:hi].to(torch.float32)
    ssd = []
    for dx in (-1, 0, 1):
        r_win = patch_r[..., lo:hi, lo + dx:hi + dx].to(torch.float32)
        diff = l_win - r_win
        ssd.append(torch.sum(diff * diff, dim=(-2, -1)))
    s_m, s_0, s_p = ssd
    denom = s_m - 2.0 * s_0 + s_p
    ok = (denom > 1e-6) & (s_0 <= s_m) & (s_0 <= s_p)
    frac = 0.5 * (s_m - s_p) / torch.where(ok, denom, torch.ones_like(denom))
    frac = torch.clamp(frac, -0.5, 0.5)
    return torch.where(ok, frac, torch.zeros_like(frac)), ok
