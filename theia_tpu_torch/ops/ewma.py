"""EWMA anomaly scoring as a parallel (associative) scan.

Ports theia_tpu/ops/ewma.py. Reference semantics (the TAD job's
EWMA, anomaly_detection.py:146-212):

    ewma_t = (1-α)·ewma_{t-1} + α·x_t,  ewma_{-1} = 0,  α = 0.5
    anomaly_t = |x_t − ewma_t| > stddev_samp(x)

The recurrence is linear, so it runs as a scan over affine maps. The
scan is the same recursion as `jax.lax.associative_scan` (pair up
neighbours, scan the half, fix up the even positions), so every value
is combined from the same operands in the same order as in the
reference, and the values are bit-equal to its CPU results (a
sequential loop would sum in another order). Each combine rounds its
product and its sum apart; a backend that fused `a2·b1 + b2` into one
multiply-add would move the last bit.

DEFAULT_ALPHA is also the streaming detectors' smoothing factor.
"""

from __future__ import annotations

from typing import Tuple

import torch

from .masked import masked_stddev_samp

DEFAULT_ALPHA = 0.5


def _combine(lhs, rhs):
    a1, b1 = lhs
    a2, b2 = rhs
    return a1 * a2, a2 * b1 + b2


def _interleave(even: torch.Tensor, odd: torch.Tensor) -> torch.Tensor:
    out = even.new_empty(*even.shape[:-1],
                         even.shape[-1] + odd.shape[-1])
    out[..., 0::2] = even
    out[..., 1::2] = odd
    return out


def _affine_scan(a: torch.Tensor, b: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Inclusive scan of the affine maps (a, b) along the last axis,
    in the recursion order of jax.lax.associative_scan."""
    n = a.shape[-1]
    if n < 2:
        return a, b
    odd = _affine_scan(*_combine((a[..., 0:-1:2], b[..., 0:-1:2]),
                                 (a[..., 1::2], b[..., 1::2])))
    if n % 2 == 0:
        even = _combine((odd[0][..., :-1], odd[1][..., :-1]),
                        (a[..., 2::2], b[..., 2::2]))
    else:
        even = _combine(odd, (a[..., 2::2], b[..., 2::2]))
    even = (torch.cat([a[..., :1], even[0]], dim=-1),
            torch.cat([b[..., :1], even[1]], dim=-1))
    return (_interleave(even[0], odd[0]), _interleave(even[1], odd[1]))


def ewma(x: torch.Tensor, alpha: float = DEFAULT_ALPHA) -> torch.Tensor:
    """EWMA along the last axis with implicit zero initial state.

    Solves e_t = a·e_{t-1} + b_t (a = 1-α, b_t = α·x_t) by scanning the
    affine maps (A, B) under composition (A1,B1)∘(A2,B2) = (A1A2, A2B1+B2);
    with e_{-1}=0 the accumulated B is the answer.
    """
    a = torch.full_like(x, 1.0 - alpha)
    b = alpha * x
    _, e = _affine_scan(a, b)
    return e


def ewma_scores(x: torch.Tensor, mask: torch.Tensor,
                alpha: float = DEFAULT_ALPHA):
    """Full EWMA scoring for a padded series batch.

    Padding is squashed to 0 before the scan; because the reference also
    starts from ewma=0 and processes each series whole, leading valid
    points see exactly the reference recurrence as long as padding is
    trailing (the tensorizer guarantees that).

    Returns (ewma [S,T], stddev [S], anomaly [S,T] bool).
    """
    xz = torch.where(mask, x, 0.0)
    e = ewma(xz, alpha)
    std = masked_stddev_samp(x, mask)
    # NaN stddev (fewer than 2 points) compares False, matching the
    # reference's "too few values" → not anomalous path (:198-201).
    anomaly = ((xz - e).abs() > std[..., None]) & mask
    return e, std, anomaly
