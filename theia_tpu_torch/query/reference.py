"""Slow-but-correct reference query executor — the parity oracle.

Runs any QueryPlan over fully DECODED rows (a `ColumnarBatch` in table
code space, i.e. whatever `Table.scan()`/`select()` returns) with the
most obvious possible numpy: plain boolean masks for the filters,
`np.unique(..., return_inverse=True)` to factorize the group keys, and
`np.<ufunc>.at` accumulation for the aggregates. Deliberately a
DIFFERENT code path from query/kernels.py (lexsort + reduceat /
jitted segment reductions): the randomized oracle suite compares the
two bit-for-bit, so a bug in either one trips the gate instead of
hiding in shared code.

This executor is also the production read path for the FLAT engine
and any store without part structure — correctness first, speed from
the parts engine (the PR-7 pattern: the old path keeps working while
the new one proves itself against it).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

from ..schema import ColumnarBatch
from .plan import QueryPlan
from .result import empty_result, finalize, lower_specs

#: kept in sync with kernels: partial merge semantics for `.at` ufuncs
_ACC_UFUNC = {"sum": np.add, "min": np.minimum, "max": np.maximum}


def filter_mask(plan: QueryPlan, batch: ColumnarBatch,
                dicts) -> np.ndarray:
    """Row mask over a decoded (table-coded) batch: the time window
    plus every plan filter, AND-combined. String predicates resolve
    through `dicts` (string → code) so the comparison is integer work
    even here."""
    n = len(batch)
    mask = np.ones(n, dtype=bool)
    if plan.start is not None:
        mask &= np.asarray(batch[plan.time_column]) >= plan.start
    if plan.end is not None:
        mask &= np.asarray(batch[plan.end_column]) < plan.end
    for f in plan.filters:
        col = np.asarray(batch[f.column])
        d = dicts.get(f.column) if dicts else None
        if d is not None:
            values = (f.value if isinstance(f.value, tuple)
                      else (f.value,))
            codes = [c for c in (d.lookup(str(v)) for v in values)
                     if c is not None]
            if f.op == "ne":
                m = (~np.isin(col, codes) if codes
                     else np.ones(n, dtype=bool))
            else:   # eq / in
                m = (np.isin(col, codes) if codes
                     else np.zeros(n, dtype=bool))
        elif f.op == "in":
            m = np.isin(col, np.asarray(f.value, np.int64))
        else:
            v = f.value
            m = {"eq": col == v, "ne": col != v,
                 "ge": col >= v, "gt": col > v,
                 "le": col <= v, "lt": col < v}[f.op]
        mask &= m
    return mask


def reference_partial(plan: QueryPlan, batch: ColumnarBatch, dicts
                      ) -> Optional[Tuple[np.ndarray,
                                          Dict[str, np.ndarray]]]:
    """(unique group-key matrix [g, k] int64 in table code space,
    {lowered label: int64 [g]}) for one decoded batch, or None when no
    row survives the filters. np.unique + ufunc.at — the independent
    implementation the kernels are checked against."""
    specs = lower_specs(plan)
    mask = filter_mask(plan, batch, dicts)
    if not mask.any():
        return None
    if plan.group_by:
        keys = np.stack([np.asarray(batch[g], np.int64)[mask]
                         for g in plan.group_by], axis=1)
        uniq, inverse = np.unique(keys, axis=0, return_inverse=True)
        inverse = inverse.reshape(-1)
    else:
        uniq = np.zeros((1, 0), np.int64)
        inverse = np.zeros(int(mask.sum()), np.int64)
    g = len(uniq)
    aggs: Dict[str, np.ndarray] = {}
    for label, op, column in specs:
        if op == "count":
            acc = np.zeros(g, np.int64)
            np.add.at(acc, inverse, 1)
        else:
            vals = np.asarray(batch[column], np.int64)[mask]
            if op == "sum":
                acc = np.zeros(g, np.int64)
            elif op == "min":
                acc = np.full(g, np.iinfo(np.int64).max, np.int64)
            else:
                acc = np.full(g, np.iinfo(np.int64).min, np.int64)
            _ACC_UFUNC[op].at(acc, inverse, vals)
        aggs[label] = acc
    return uniq, aggs


def materialize_keys(plan: QueryPlan, uniq: np.ndarray, dicts, schema
                     ) -> List[np.ndarray]:
    """Group-key code columns → output values (strings decoded via
    the table dictionaries, numerics passed through)."""
    out: List[np.ndarray] = []
    for j, name in enumerate(plan.group_by):
        codes = uniq[:, j]
        d = dicts.get(name) if dicts else None
        out.append(d.decode(codes) if d is not None
                   else codes.astype(np.int64))
    return out


def reference_execute(plan: QueryPlan, batch: ColumnarBatch, dicts,
                      schema=None
                      ) -> Tuple[List[Dict[str, object]], int, int]:
    """Execute `plan` over one decoded batch. Returns
    (rows, group_count, rows_scanned)."""
    partial = reference_partial(plan, batch, dicts)
    if partial is None:
        rows, groups = empty_result(plan)
        return rows, groups, len(batch)
    uniq, aggs = partial
    keys = materialize_keys(plan, uniq, dicts, schema)
    rows, groups = finalize(plan, keys, aggs)
    return rows, groups, len(batch)
