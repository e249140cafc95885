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
(`store.views.group_reduce`), and so does the port. Over a mesh
(`make_sharded_distinct`) each shard dedupes its block of rows, the
shards' distinct rows are gathered, and one global DISTINCT with a
segment sum merges them, as the reference's shard_map does.
"""

from __future__ import annotations

import os
from typing import List, Tuple

import numpy as np
import torch

from ..utils.device import resolve_device

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


def _lex_order(keys: torch.Tensor) -> torch.Tensor:
    """The permutation that sorts [N, K] rows lexicographically: a
    stable sort by the last column, then by each earlier one."""
    n, k = keys.shape
    order = torch.arange(n, device=keys.device)
    for col in range(k - 1, -1, -1):
        perm = torch.sort(keys[order, col], stable=True).indices
        order = order[perm]
    return order


def distinct_rows(keys: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """DISTINCT over [N, K] int32 rows (N ≥ 1) with multiplicities, on
    keys' device.

    Returns (uniq [N, K], counts [N] int32, n_unique []): the first
    n_unique rows of `uniq` are the distinct key rows in lexicographic
    order; `counts[i]` is how many input rows equal `uniq[i]`.
    """
    n = keys.shape[0]
    sk = keys[_lex_order(keys)]
    # int32 counts: a single block never exceeds 2^31 rows (hosts
    # widen to int64).
    return _dedupe_sorted(sk, torch.ones((n,), dtype=torch.int32,
                                         device=keys.device))


def _sharded_distinct_step(blocks: List[torch.Tensor]):
    """Local dedupe per shard → all_gather → global dedupe
    (theia_tpu/analytics/npr_device.py:83-114).

    blocks: each shard's [N_loc, K] rows on its device. Returns (uniq
    [N, K], counts [N], n_unique) with N = N_loc * n_shards, on the
    first shard's device: the reference's output is replicated, and
    the port computes it once, where it is read.
    """
    uniqs, counts = [], []
    for keys in blocks:
        n_loc = keys.shape[0]
        uniq, cnt, n_unique = distinct_rows(keys)
        valid = torch.arange(n_loc, device=keys.device) < n_unique
        # Pad invalid slots with the sentinel so they sort to the end
        # and carry zero weight through the merge.
        uniqs.append(torch.where(valid[:, None], uniq, _SENTINEL))
        counts.append(torch.where(valid, cnt, 0))

    # the all_gather, onto the first shard only: the merge runs once
    dev = blocks[0].device
    flat_keys = torch.cat([u.to(dev) for u in uniqs])     # [S*N_loc, K]
    flat_counts = torch.cat([c.to(dev) for c in counts])  # [S*N_loc]
    order = _lex_order(flat_keys)
    merged, total, n_uniq = _dedupe_sorted(flat_keys[order],
                                           flat_counts[order])
    # Drop the sentinel segment (present iff any shard had padding):
    # padding rows are _SENTINEL in EVERY column, so a genuine row can
    # only be misidentified if all K of its codes equal INT32_MAX —
    # excluded by the module precondition (codes < INT32_MAX).
    has_pad = torch.all(merged[(n_uniq - 1).clamp_min(0)] == _SENTINEL)
    n_uniq = torch.where(has_pad, n_uniq - 1, n_uniq)
    return merged, total, n_uniq


def make_sharded_distinct(mesh):
    """DISTINCT over a mesh's shards (any mesh, read as its flattened
    rows axis).

    fn(keys [N, K] int32) with N divisible by the shard count; each
    shard's block of rows goes to its device. Returns (uniq, counts,
    n_unique) padded to N, on the first shard's device.

    Preconditions: key codes < INT32_MAX (the padding sentinel), and
    no single distinct key's GLOBAL multiplicity reaches 2^31 (counts
    merge in int32, as the reference's; callers needing exact counts
    beyond that must sum per-shard results host-side).
    """
    devs = list(mesh.devices.flat)

    def fn(keys: np.ndarray):
        keys = torch.from_numpy(np.ascontiguousarray(keys, np.int32))
        n_loc = keys.shape[0] // len(devs)
        return _sharded_distinct_step(
            [keys[s * n_loc:(s + 1) * n_loc].to(d)
             for s, d in enumerate(devs)])
    return fn


def device_distinct(keys: np.ndarray,
                    use_device: str | bool | None = None,
                    mesh=None, device="cuda"
                    ) -> Tuple[np.ndarray, np.ndarray]:
    """Host wrapper: DISTINCT + counts for an [N, K] int code matrix.

    Returns (uniq [U, K] int64, counts [U] int64) in lexicographic row
    order — bit-identical to the numpy group_reduce path. `use_device`
    defaults to the THEIA_NPR_DEVICE env switch ("auto"/"1"/"0"); the
    device path runs on `device`. With `mesh` (a parallel.mesh.Mesh
    with >1 shard), the device path shards input rows over the mesh's
    devices and merges the per-shard distincts with the all_gather +
    segment-sum collective (production scale-out of the Spark shuffle,
    SURVEY §2.7).
    """
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
    if mesh is not None and mesh.size > 1 and n >= mesh.size:
        from ..parallel import cached_kernel
        from ..parallel.mesh import pad_to_multiple

        # Pad rows to the shard multiple with the sentinel; padding
        # rows sort to the end of the merge and the step drops the
        # trailing all-sentinel segment.
        padded, _ = pad_to_multiple(keys.astype(np.int32), mesh.size,
                                    axis=0, fill=_SENTINEL)
        fn = cached_kernel(("npr_distinct", mesh),
                           lambda: make_sharded_distinct(mesh))
        uniq, counts, n_unique = fn(padded)
    else:
        # too few rows to shard: one device, the mesh's first if any
        dev = (mesh.devices.flat[0] if mesh is not None
               else resolve_device(device))
        uniq, counts, n_unique = distinct_rows(
            torch.from_numpy(np.ascontiguousarray(keys, np.int32))
            .to(dev))
    u = int(n_unique)
    return (uniq[:u].cpu().numpy().astype(np.int64),
            counts[:u].cpu().numpy().astype(np.int64))
