"""Masked per-series statistics over padded [S, T] tensors.

Ports theia_tpu/ops/masked.py. The analytics jobs batch ragged
per-connection time series into padded tensors with a validity mask;
every statistic here honours the mask so the padding never leaks into
results. Sample standard deviation matches Spark's `stddev_samp`,
including its NULL for fewer than two points (NaN here).

Numerics against the reference: the sums over T reduce in another
order than XLA's, so means and deviations may differ in the last bits.
"""

from __future__ import annotations

import math

import torch


def masked_count(mask: torch.Tensor) -> torch.Tensor:
    return mask.to(torch.int32).sum(dim=-1)


def masked_mean(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    n = masked_count(mask).clamp_min(1)
    return torch.where(mask, x, 0.0).sum(dim=-1) / n


def masked_stddev_samp(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Sample stddev (ddof=1) per series; NaN when fewer than 2 points,
    mirroring SQL stddev_samp returning NULL."""
    n = masked_count(mask)
    mean = masked_mean(x, mask)
    dev = torch.where(mask, x - mean[..., None], 0.0)
    ss = (dev * dev).sum(dim=-1)
    var = ss / (n - 1).clamp_min(1)
    return torch.where(n >= 2, torch.sqrt(var), math.nan)
