"""Vectorized group-aggregation kernels for the query engine.

Ports theia_tpu/query/kernels.py with its numpy path only. The
per-part unit of work is a key matrix [n, k] of int64 group keys and a
set of int64 value columns in; one row per distinct key with
count/sum/min/max columns out: one lexsort over the key columns, group
boundaries from adjacent-row comparison, then `ufunc.reduceat` per
aggregate, in exact int64 arithmetic. The reference's jitted segment
reductions (THEIA_QUERY_JAX) are not ported: `kernel_mode()` is always
"numpy", which is also the reference's own answer without x64.

Merging partials is the same operation: concat the per-part key
matrices + partial aggregates and re-reduce, with `count` partials
merged via sum and min/max via min/max.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np

#: reduction op per aggregate when MERGING partials (count becomes a
#: sum of partial counts; everything else merges with its own op)
MERGE_OP = {"count": "sum", "sum": "sum", "min": "min", "max": "max"}


def kernel_mode() -> str:
    """What `aggregate()` uses: always 'numpy' in the port."""
    return "numpy"


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


def aggregate(keys: np.ndarray, values: Dict[str, np.ndarray],
              specs: Sequence[Tuple[str, str, Optional[str]]],
              presorted: bool = False
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
    permutation."""
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
    return uniq, _reduce_numpy(sorted_vals, starts, n, specs)


def merge_partials(partials: Sequence[
        Tuple[np.ndarray, Dict[str, np.ndarray]]],
        specs: Sequence[Tuple[str, str, Optional[str]]]
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
    return aggregate(keys, values, merge_specs)
