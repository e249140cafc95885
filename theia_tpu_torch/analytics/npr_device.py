"""On-device DISTINCT + support counting for the NPR job.

Ports theia_tpu/analytics/npr_device.py, one device. The reference's
NPR compute is a Spark `SELECT DISTINCT` over the flow 9-tuple
followed by RDD reduceByKey shuffles (policy_recommendation_job.py:
785-802,621-712). Here it is a lexicographic sort over the key
columns, boundary detection, and a segment scatter/add that produces
the unique rows and their multiplicities ("support counts").

The reference sorts with one `lax.sort(..., num_keys=K)`; torch has no
multi-key sort, so `distinct_rows` sorts by the last key column, then
stably by each earlier one, gathering the permutation each time: the
result is the same lexicographic order. Outputs are padded to the
input length with the count of valid rows beside them, as the
reference's; `device_distinct` slices them. Dictionary codes travel
as int32 (INT32_MAX is reserved as the reference's padding sentinel).

Below `_AUTO_THRESHOLD` rows the reference keeps the host path
(`store.views.group_reduce`), and so does the port. The multi-chip
form (`_sharded_distinct_step`, `make_sharded_distinct`) is left out
(ROADMAP A16).
"""

from __future__ import annotations

import os
from typing import Tuple

import numpy as np
import torch

from ..utils.device import resolve_device, single_device

_SENTINEL = np.iinfo(np.int32).max

# Host-side switch: "auto" uses the device path for large inputs only
# (the host numpy lexsort wins under ~64k rows once transfer overhead is
# counted), "1"/"0" force it on/off.
_AUTO_THRESHOLD = 65536


def _boundaries(sk: torch.Tensor) -> torch.Tensor:
    """is_new[i] = row i differs from row i-1 (sorted input)."""
    if sk.shape[0] <= 1:
        return torch.ones((sk.shape[0],), dtype=torch.bool,
                          device=sk.device)
    head = torch.ones((1,), dtype=torch.bool, device=sk.device)
    return torch.cat([head, (sk[1:] != sk[:-1]).any(dim=1)])


def _dedupe_sorted(sk: torch.Tensor, weights: torch.Tensor):
    """Segment-reduce a sorted key matrix: unique rows scattered to the
    front, weights summed per segment. Returns (uniq, counts, n_unique)
    padded to len(sk); n_unique is a 0-d tensor."""
    n = sk.shape[0]
    is_new = _boundaries(sk)
    seg = torch.cumsum(is_new.to(torch.int32), dim=0) - 1
    n_unique = seg[-1] + 1
    counts = torch.zeros((n,), dtype=weights.dtype, device=sk.device)
    counts.index_add_(0, seg, weights)
    uniq = torch.zeros_like(sk)
    uniq[seg] = sk    # rows of one segment are equal: any write wins
    return uniq, counts, n_unique


def distinct_rows(keys: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """DISTINCT over [N, K] int32 rows (N ≥ 1) with multiplicities, on
    keys' device.

    Returns (uniq [N, K], counts [N] int32, n_unique []): the first
    n_unique rows of `uniq` are the distinct key rows in lexicographic
    order; `counts[i]` is how many input rows equal `uniq[i]`.
    """
    n, k = keys.shape
    order = torch.arange(n, device=keys.device)
    for col in range(k - 1, -1, -1):
        perm = torch.sort(keys[order, col], stable=True).indices
        order = order[perm]
    sk = keys[order]
    # int32 counts: a single block never exceeds 2^31 rows (hosts
    # widen to int64).
    return _dedupe_sorted(sk, torch.ones((n,), dtype=torch.int32,
                                         device=keys.device))


def device_distinct(keys: np.ndarray,
                    use_device: str | bool | None = None,
                    mesh=None, device="cuda"
                    ) -> Tuple[np.ndarray, np.ndarray]:
    """Host wrapper: DISTINCT + counts for an [N, K] int code matrix.

    Returns (uniq [U, K] int64, counts [U] int64) in lexicographic row
    order — bit-identical to the numpy group_reduce path. `use_device`
    defaults to the THEIA_NPR_DEVICE env switch ("auto"/"1"/"0"); the
    device path runs on `device`. `mesh`: None (one device); any other
    raises (ROADMAP A16).
    """
    single_device(mesh)
    n = keys.shape[0]
    if n == 0:
        return (keys.astype(np.int64),
                np.zeros((0,), np.int64))
    if use_device is None:
        use_device = os.environ.get("THEIA_NPR_DEVICE", "auto")
    if use_device in ("0", False, "off", "false"):
        on_device = False
    elif use_device in ("1", True, "on", "true"):
        on_device = True
    else:
        on_device = n >= _AUTO_THRESHOLD
    if not on_device:
        from ..store.views import group_reduce

        uniq, counts = group_reduce(
            keys.astype(np.int64),
            np.ones((n, 1), np.int64))
        return uniq, counts[:, 0]

    if keys.max(initial=0) >= _SENTINEL:
        raise ValueError("dictionary code collides with the sentinel")
    dev = resolve_device(device)
    uniq, counts, n_unique = distinct_rows(
        torch.from_numpy(np.ascontiguousarray(keys, np.int32)).to(dev))
    u = int(n_unique)
    return (uniq[:u].cpu().numpy().astype(np.int64),
            counts[:u].cpu().numpy().astype(np.int64))
