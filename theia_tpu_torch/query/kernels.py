"""Vectorized group-aggregation kernels for the query engine.

Ports theia_tpu/query/kernels.py. The per-part unit of work is always
the same shape: a key matrix [n, k] of int64 group keys (dictionary
codes / narrow ints already widened for the surviving rows) and a set
of int64 value columns, in; one row per distinct key with
count/sum/min/max columns, out. Two implementations share that
contract:

  * numpy (always available, the canonical semantics): one lexsort
    over the key columns, group boundaries from adjacent-row
    comparison, then `ufunc.reduceat` per aggregate — exact int64
    arithmetic, no Python-object work.
  * torch segment reductions on the engine's device
    (`THEIA_QUERY_JAX=1`, the reference's knob for its jitted `jnp`
    branch): the host still computes the group ids (sorting is host
    work either way); count is `bincount`, sum `index_add_`, min and
    max `scatter_reduce_`, all in int64, so the results equal numpy's
    bit for bit, wraparound included. `auto` (the default) is numpy:
    the reference turns its branch on only under x64, which its
    manager and runner never enable. A failure in the torch branch
    raises; nothing falls back to numpy.

Merging partials is the same operation: concat the per-part key
matrices + partial aggregates and re-reduce, with `count` partials
merged via sum and min/max via min/max.
"""

from __future__ import annotations

import os
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

#: reduction op per aggregate when MERGING partials (count becomes a
#: sum of partial counts; everything else merges with its own op)
MERGE_OP = {"count": "sum", "sum": "sum", "min": "min", "max": "max"}


def kernel_mode() -> str:
    """'torch' or 'numpy' — what `aggregate()` will use right now, per
    THEIA_QUERY_JAX (auto|1|0; 1 = torch on the engine's device, auto
    = numpy, the reference's answer without x64)."""
    raw = os.environ.get("THEIA_QUERY_JAX", "auto").strip().lower()
    return "torch" if raw in ("1", "force", "on", "yes") else "numpy"


def group_ids(keys: np.ndarray) -> Tuple[np.ndarray, np.ndarray, int]:
    """Factorize a key matrix: (order, sorted-group-start offsets,
    group count). `keys[order]` is lexicographically sorted; group g
    spans order[starts[g]:starts[g+1]]."""
    n = keys.shape[0]
    order = np.lexsort(keys.T[::-1])
    sk = keys[order]
    boundary = np.empty(n, dtype=bool)
    boundary[0] = True
    boundary[1:] = np.any(sk[1:] != sk[:-1], axis=1)
    starts = np.flatnonzero(boundary)
    return order, starts, len(starts)


def _reduce_numpy(sorted_vals: Dict[str, np.ndarray],
                  starts: np.ndarray, n: int,
                  specs: Sequence[Tuple[str, str, Optional[str]]]
                  ) -> Dict[str, np.ndarray]:
    out: Dict[str, np.ndarray] = {}
    counts: Optional[np.ndarray] = None
    for label, op, column in specs:
        if op == "count":
            if counts is None:
                counts = np.diff(starts, append=n).astype(np.int64)
            out[label] = counts
            continue
        sv = sorted_vals[column]
        ufunc = {"sum": np.add, "min": np.minimum,
                 "max": np.maximum}[op]
        out[label] = ufunc.reduceat(sv, starts)
    return out


def _reduce_torch(gids: np.ndarray, n_groups: int,
                  sorted_vals: Dict[str, np.ndarray],
                  specs: Sequence[Tuple[str, str, Optional[str]]],
                  device) -> Dict[str, np.ndarray]:
    """Every aggregate of one part as int64 torch segment reductions
    on `device` (None is the card, under the port's device rule)."""
    import torch

    from ..utils.device import resolve_device

    dev = resolve_device("cuda" if device is None else device)
    g = torch.from_numpy(gids).to(dev)
    cols = {c: torch.from_numpy(sorted_vals[c]).to(dev)
            for c in sorted({c for _, _, c in specs if c is not None})}
    out: Dict[str, np.ndarray] = {}
    for label, op, column in specs:
        if op == "count":
            r = torch.bincount(g, minlength=n_groups)
        elif op == "sum":
            r = torch.zeros(n_groups, dtype=torch.int64,
                            device=dev).index_add_(0, g, cols[column])
        else:
            r = torch.empty(n_groups, dtype=torch.int64,
                            device=dev).scatter_reduce_(
                0, g, cols[column], "amin" if op == "min" else "amax",
                include_self=False)
        out[label] = r.cpu().numpy()
    return out


def aggregate(keys: np.ndarray, values: Dict[str, np.ndarray],
              specs: Sequence[Tuple[str, str, Optional[str]]],
              presorted: bool = False, device=None
              ) -> Tuple[np.ndarray, Dict[str, np.ndarray]]:
    """GROUP BY `keys` ([n, k] int64) computing every spec
    (label, op, column) over int64 `values`. Returns (unique keys
    [g, k] in lexicographic order, {label: [g] int64}).

    `n == 0` returns empty outputs; `k == 0` (global aggregate)
    reduces everything into one group.

    `presorted=True` is the CONTIGUOUS-RUN fast path: the caller
    guarantees rows with equal keys are adjacent and keys are
    non-decreasing (a sorted part whose groupBy is a sort-key
    prefix — engine.py proves it from the part's sort key), so the
    lexsort is skipped entirely and group boundaries come from one
    adjacent-row comparison. Output is bit-identical to the sorted
    path: a stable lexsort of already-sorted keys is the identity
    permutation.

    Under kernel_mode() 'torch' the reductions run on `device`."""
    n = keys.shape[0]
    if n == 0:
        return (keys.reshape(0, keys.shape[1]),
                {label: np.zeros(0, np.int64) for label, _, _ in specs})
    order: Optional[np.ndarray] = None
    if keys.shape[1] == 0:
        starts = np.zeros(1, np.int64)
    elif presorted:
        boundary = np.empty(n, dtype=bool)
        boundary[0] = True
        boundary[1:] = np.any(keys[1:] != keys[:-1], axis=1)
        starts = np.flatnonzero(boundary)
    else:
        order, starts, _ = group_ids(keys)
    sorted_vals = {c: np.ascontiguousarray(
                       v if order is None else v[order])
                   for c, v in values.items()}
    uniq = (keys if order is None else keys[order])[starts]
    if kernel_mode() == "torch":
        gids = np.zeros(n, np.int64)
        gids[starts[1:]] = 1
        gids = np.cumsum(gids)
        return uniq, _reduce_torch(gids, len(starts), sorted_vals, specs,
                                   device)
    return uniq, _reduce_numpy(sorted_vals, starts, n, specs)


def merge_partials(partials: Sequence[
        Tuple[np.ndarray, Dict[str, np.ndarray]]],
        specs: Sequence[Tuple[str, str, Optional[str]]], device=None
        ) -> Tuple[np.ndarray, Dict[str, np.ndarray]]:
    """Combine per-part partial aggregates: concat their (keys, aggs)
    and re-reduce with each aggregate's MERGE op (partial counts sum;
    partial mins min; ...). Key spaces must be comparable (same table
    dictionary) — cross-table merges materialize first."""
    live = [p for p in partials if p is not None and len(p[0])]
    if not live:
        k = partials[0][0].shape[1] if partials else 0
        return (np.zeros((0, k), np.int64),
                {label: np.zeros(0, np.int64) for label, _, _ in specs})
    if len(live) == 1:
        return live[0]
    keys = np.concatenate([p[0] for p in live])
    merge_specs = [(label, MERGE_OP[op], label)
                   for label, op, _ in specs]
    values = {label: np.concatenate([p[1][label] for p in live])
              for label, _, _ in specs}
    return aggregate(keys, values, merge_specs, device=device)
