"""Shared query-result machinery: aggregate lowering and the
finalization step both executors use.

The engine (vectorized, part-native) and the reference executor (slow,
obviously correct) must answer BIT-IDENTICALLY — that parity is the
gate the whole read path stands on (the PR-6/7 playbook). The safest
way to make the *presentation* identical is to share it: both sides
produce the same intermediate shape — materialized group-key columns +
int64 aggregate arrays — and this module turns that into ordered,
top-K-limited result rows. `mean` is never aggregated directly; it is
LOWERED to (sum, count) partials (which merge exactly) and divided
here, once, in float64 — so a mean computed from two part partials
equals the mean computed from one flat scan, bitwise.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .plan import QueryPlan

#: lowered spec: (label, op, column) with op in count/sum/min/max
Spec = Tuple[str, str, Optional[str]]


def lower_specs(plan: QueryPlan) -> List[Spec]:
    """Physical aggregates the kernels must compute: user aggregates
    minus `mean`, which lowers to sum + count (deduplicated — a plan
    asking for mean(x), sum(x) and count computes each once)."""
    specs: List[Spec] = []

    def add(label: str, op: str, column: Optional[str]) -> None:
        if all(s[0] != label for s in specs):
            specs.append((label, op, column))

    for a in plan.aggregates:
        if a.op == "mean":
            add(f"sum({a.column})", "sum", a.column)
            add("count", "count", None)
        else:
            add(a.label, a.op, a.column)
    return specs


def value_columns(specs: Sequence[Spec]) -> Tuple[str, ...]:
    """Distinct value columns the lowered specs read."""
    out: List[str] = []
    for _, op, column in specs:
        if column is not None and column not in out:
            out.append(column)
    return tuple(out)


def empty_result(plan: QueryPlan
                 ) -> Tuple[List[Dict[str, object]], int]:
    """Zero surviving rows: a grouped query has no groups; a GLOBAL
    aggregate still answers one row (count 0, every aggregate 0 —
    the convention both executors share so parity holds on empty
    windows)."""
    if plan.group_by:
        return [], 0
    row: Dict[str, object] = {}
    for a in plan.aggregates:
        row[a.label] = 0.0 if a.op == "mean" else 0
    return [row], 1


def finalize(plan: QueryPlan,
             key_columns: Sequence[np.ndarray],
             aggs: Dict[str, np.ndarray]
             ) -> Tuple[List[Dict[str, object]], int]:
    """Materialized groups → ordered result rows.

    `key_columns` are per-group arrays aligned with `plan.group_by`
    (strings already decoded); `aggs` carries one int64 array per
    LOWERED spec label. Rows are ordered by the `order_by` aggregate
    descending, ties broken by the group key ascending (decoded
    values, so the order is stable across engines, shards, and
    dictionary states), then truncated to `k` (0 = all). Returns
    (rows, total group count before the top-K cut)."""
    n_groups = len(aggs["count"]) if "count" in aggs else (
        len(key_columns[0]) if key_columns
        else len(next(iter(aggs.values()))))

    out_vals: Dict[str, np.ndarray] = {}
    for a in plan.aggregates:
        if a.op == "mean":
            s = aggs[f"sum({a.column})"].astype(np.float64)
            c = aggs["count"].astype(np.float64)
            with np.errstate(invalid="ignore", divide="ignore"):
                out_vals[a.label] = np.where(c > 0, s / c, 0.0)
        else:
            out_vals[a.label] = aggs[a.label]

    keys = [np.asarray(k) for k in key_columns]

    # fully vectorized ordering (a group-by can yield 10^5+ groups and
    # the top-K cut happens after the sort): lexsort the key columns
    # ascending (object/string columns widen to numpy unicode, whose
    # comparison matches Python's code-point order), then a STABLE
    # descending argsort on the order_by aggregate — value desc, ties
    # by group key asc, identical to the old per-tuple Python sort
    if keys:
        sort_cols = tuple(
            (k.astype(str) if k.dtype == object else k)
            for k in reversed(keys))
        order = np.lexsort(sort_cols)
    else:
        order = np.arange(n_groups)
    order_vals = np.asarray(out_vals[plan.order_by])
    order = order[np.argsort(-order_vals[order], kind="stable")]
    limited = order[:plan.k] if plan.k > 0 else order

    rows: List[Dict[str, object]] = []
    for i in limited:
        row: Dict[str, object] = {}
        for name, col in zip(plan.group_by, keys):
            v = col[i]
            row[name] = v.item() if isinstance(v, np.generic) else v
        for a in plan.aggregates:
            v = out_vals[a.label][i]
            row[a.label] = (float(v) if a.op == "mean" else int(v))
        rows.append(row)
    return rows, n_groups
