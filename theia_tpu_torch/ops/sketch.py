"""Count-Min-Sketch + online k-means, as plain PyTorch ops.

Ports theia_tpu/ops/sketch.py. Both structures stay on the device and
advance once per ingest micro-batch:

  * CMS — D hash rows x W counters of traffic volume keyed by 32-bit
    flow keys. Update is a scatter-add per row; query is the min over
    the D estimates (the classic CMS upper bound).
  * Online k-means — mini-batch k-means (Sculley 2010): per-batch
    assignment, then a per-centroid learning-rate update with counts
    as the rate denominator.

Keys are uint32 in the reference. Here they travel as int32 tensors
holding the same bit patterns (torch has few uint32 kernels); hashing
runs in int64 with `& 0xFFFFFFFF` after every multiply, which keeps
the low 32 bits of the reference's wrapping uint32 arithmetic exactly.

Numerics against the reference: slot indices are bit-exact. On the
CPU the scatter-add visits updates in index order, as XLA's CPU
scatter does; on CUDA `index_add_` sums duplicates with atomics in no
fixed order, and `volumes.sum()` reduces in another order than XLA,
so counts and totals may differ in the last bits (the tolerance is
stated where they are compared). k-means matmuls run in full float32:
TF32 is switched off for the process's CUDA matmuls at import.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..utils.device import resolve_device

# The reference runs its distance product at Precision.HIGHEST; TF32
# would keep ~10 mantissa bits and flip close assignments.
torch.backends.cuda.matmul.allow_tf32 = False

# Distinct odd 32-bit seeds per hash row (the reference's).
_HASH_SEEDS = (
    0x9E3779B9, 0xBF58476D, 0x94D049BB, 0xD6E8FEB8, 0xA5A5A5A5,
    0xC2B2AE3D,
)
_MASK32 = 0xFFFFFFFF


class CmsState(NamedTuple):
    counts: torch.Tensor   # [D, W] float32 volume counters
    total: torch.Tensor    # scalar float32: total volume seen


def cms_init(depth: int = 4, width: int = 8192,
             device="cuda") -> CmsState:
    if depth > len(_HASH_SEEDS):
        raise ValueError(f"depth must be <= {len(_HASH_SEEDS)}")
    if width <= 0 or width & (width - 1):
        # slot masking is `h & (width-1)` — any other width silently
        # strands counters and inflates collisions
        raise ValueError(f"width must be a power of two, got {width}")
    device = resolve_device(device)
    return CmsState(
        counts=torch.zeros((depth, width), dtype=torch.float32,
                           device=device),
        total=torch.zeros((), dtype=torch.float32, device=device))


def keys_tensor(keys: np.ndarray, device) -> torch.Tensor:
    """uint32 host keys → the int32 tensor of the same bits that
    the sketch functions take."""
    keys = np.ascontiguousarray(keys, dtype=np.uint32)
    return torch.from_numpy(keys.view(np.int32)).to(device)


def _cms_slots(keys: torch.Tensor, depth: int,
               width: int) -> torch.Tensor:
    """keys [N] (int32 bit patterns of uint32, or any integer dtype
    whose low 32 bits are the key) → [D, N] int64 counter indices;
    murmur3-finalizer mixing with a distinct seed per row."""
    k = keys.to(torch.int64) & _MASK32
    rows = []
    for d in range(depth):
        h = k ^ _HASH_SEEDS[d]
        h = h ^ (h >> 16)
        h = (h * 0x85EBCA6B) & _MASK32
        h = h ^ (h >> 13)
        h = (h * 0xC2B2AE35) & _MASK32
        h = h ^ (h >> 16)
        rows.append(h & (width - 1))
    return torch.stack(rows)


def _flat_slots(keys: torch.Tensor, depth: int,
                width: int) -> torch.Tensor:
    """[D*N] offsets into the flattened [D, W] counter array."""
    slots = _cms_slots(keys, depth, width)
    rows = torch.arange(depth, device=slots.device)[:, None] * width
    return (slots + rows).reshape(-1)


def cms_update(state: CmsState, keys: torch.Tensor,
               volumes: torch.Tensor) -> CmsState:
    """Scatter one micro-batch of (key, volume) into the sketch
    (returns a new state; the old one is left as it was)."""
    d, w = state.counts.shape
    volumes = volumes.to(torch.float32)
    counts = state.counts.reshape(-1).index_add(
        0, _flat_slots(keys, d, w), volumes.repeat(d))
    return CmsState(counts.view(d, w), state.total + volumes.sum())


def cms_query(state: CmsState, keys: torch.Tensor) -> torch.Tensor:
    """Estimated volume per key (CMS upper bound, min over rows)."""
    d, w = state.counts.shape
    ests = state.counts.reshape(-1)[_flat_slots(keys, d, w)]
    return ests.view(d, -1).amin(dim=0)


class KMeansState(NamedTuple):
    centroids: torch.Tensor   # [K, F] float32
    counts: torch.Tensor      # [K] float32 points assigned so far


def kmeans_init(centroids, device="cuda") -> KMeansState:
    device = resolve_device(device)
    c = torch.as_tensor(np.asarray(centroids, np.float32),
                        device=device)
    return KMeansState(centroids=c,
                       counts=torch.zeros(c.shape[0],
                                          dtype=torch.float32,
                                          device=device))


def kmeans_step(state: KMeansState, points: torch.Tensor,
                valid: Optional[torch.Tensor] = None
                ) -> Tuple[KMeansState, torch.Tensor, torch.Tensor]:
    """One mini-batch update. points [N, F] → (state', assignment [N],
    distance [N] to the assigned centroid). `valid` [N] bool masks out
    padding rows: they get an assignment and a distance but add
    nothing to the centroid update."""
    points = points.to(torch.float32)
    if valid is None:
        valid = torch.ones(points.shape[0], dtype=torch.bool,
                           device=points.device)
    vf = valid.to(torch.float32)
    c = state.centroids
    x2 = (points * points).sum(-1, keepdim=True)
    c2 = (c * c).sum(-1)
    d2 = x2 + c2[None, :] - 2.0 * torch.matmul(points, c.T)
    assign = torch.argmin(d2, dim=1)
    dist = torch.sqrt(torch.clamp(
        torch.gather(d2, 1, assign[:, None])[:, 0], min=0.0))
    k = c.shape[0]
    one_hot = ((assign[:, None]
                == torch.arange(k, device=points.device)[None, :])
               .to(torch.float32) * vf[:, None])
    batch_n = one_hot.sum(0)                                  # [K]
    batch_sum = one_hot.T @ points                            # [K, F]
    new_counts = state.counts + batch_n
    safe_n = torch.clamp(batch_n, min=1.0)
    batch_mean = batch_sum / safe_n[:, None]
    rate = torch.where(new_counts > 0,
                       batch_n / torch.clamp(new_counts, min=1.0),
                       torch.zeros_like(new_counts))
    centroids = c + rate[:, None] * (batch_mean - c)
    return KMeansState(centroids, new_counts), assign, dist
