"""Masked robust statistics and M-estimator weights over the last axis
(port of stvo_pl_tpu/ops/robust.py; reference src/auxiliar.cpp:387-583).

Invalid lanes are pushed to +inf before a sort; the median is the
reference's upper median sorted[n // 2]."""

from __future__ import annotations

import torch

MAD_SCALE = 1.4826


def masked_median(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Median over valid lanes of [..., N]; zero valid lanes -> 0."""
    xs = torch.sort(torch.where(mask, x, torch.full_like(x, float("inf"))),
                    dim=-1).values
    n = torch.sum(mask, dim=-1)
    idx = torch.clamp(n // 2, 0, x.shape[-1] - 1)
    med = torch.gather(xs, -1, idx[..., None])[..., 0]
    return torch.where(n > 0, med, torch.zeros_like(med))


def masked_stdv_mad(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """1.4826 * median(|x - median(x)|) over valid lanes."""
    med = masked_median(x, mask)
    return MAD_SCALE * masked_median(torch.abs(x - med[..., None]), mask)


def masked_mean_stdv_mad(x: torch.Tensor, mask: torch.Tensor):
    """(trimmed mean, MAD stdv): the mean of lanes below 2 stdv, or the
    plain mean when fewer than 20% of the lanes qualify."""
    stdv = masked_stdv_mad(x, mask)
    n = torch.sum(mask, dim=-1)
    good = mask & (x < 2.0 * stdv[..., None])
    k = torch.sum(good, dim=-1)
    zero = torch.zeros_like(x)
    sum_good = torch.sum(torch.where(good, x, zero), dim=-1)
    sum_all = torch.sum(torch.where(mask, x, zero), dim=-1)
    use_trimmed = k >= torch.ceil(0.2 * n).to(k.dtype)
    denom_g = torch.clamp(k, min=1).to(x.dtype)
    denom_a = torch.clamp(n, min=1).to(x.dtype)
    mean = torch.where(use_trimmed, sum_good / denom_g, sum_all / denom_a)
    mean = torch.where(n > 0, mean, torch.zeros_like(mean))
    return mean, stdv


def masked_mean(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    n = torch.sum(mask, dim=-1)
    s = torch.sum(torch.where(mask, x, torch.zeros_like(x)), dim=-1)
    return torch.where(n > 0, s / torch.clamp(n, min=1).to(x.dtype),
                       torch.zeros_like(s))


def robust_weight(norm_res: torch.Tensor,
                  kernel: str = "cauchy") -> torch.Tensor:
    """M-estimator weight w(r) of a normalized residual."""
    r2 = norm_res * norm_res
    zero = torch.zeros_like(norm_res)
    if kernel == "cauchy":
        return 1.0 / (1.0 + r2)
    if kernel == "parabola":
        return torch.where(norm_res <= 1.0, 1.0 - r2, zero)
    if kernel == "tukey":
        return torch.where(norm_res <= 1.0, (1.0 - r2) ** 2, zero)
    if kernel == "huber":
        return torch.where(norm_res <= 1.0, torch.ones_like(norm_res),
                           1.0 / torch.clamp(norm_res, min=1e-12))
    if kernel == "welsch":
        return torch.exp(-r2)
    if kernel == "tstudent":
        return 1.0 / (5.0 + r2)
    raise ValueError(f"unknown robust kernel: {kernel}")
