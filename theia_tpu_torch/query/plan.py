"""Query plans: the normalized, validated description of one filtered
aggregation the engine executes over the flow store.

The plan is deliberately small — a time window, a conjunction of
column predicates, a group-by key list, and a list of aggregates with
a top-K order — because that is the read shape the reference serves
from ClickHouse (the Grafana panels and the analytics jobs' SQL are
all `SELECT keys, agg(metrics) WHERE window AND predicates GROUP BY
keys ORDER BY agg LIMIT k`). Everything in a plan resolves against the
table SCHEMA at parse time, so a malformed query dies as a 400 at the
API edge, never inside a part decode.

Normalization matters beyond validation: `normalized()` is the
cache-key half of the query-result cache (engine.py) — two requests
spelling the same query differently (filter order, op aliases,
defaulted fields) must hash identically.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
from typing import Dict, List, Optional, Tuple

from ..schema import FLOW_SCHEMA, METRICS_SCHEMA, METRICS_TABLE

#: queryable tables: name → (schema, default window-start column,
#: default window-end column). `flows` is the data plane;
#: `__metrics__` is the self-scraped metrics history (obs/history.py)
#: — its rows are point-in-time samples, so both window columns
#: default to the sample time (a half-open [start, end) window over
#: `timeInserted`), and the same plan grammar that answers Grafana-
#: shaped flow queries answers "p95 ingest latency, last 6h".
QUERYABLE_TABLES: Dict[str, tuple] = {
    "flows": (FLOW_SCHEMA, "flowStartSeconds", "flowEndSeconds"),
    METRICS_TABLE: (METRICS_SCHEMA, "timeInserted", "timeInserted"),
}

#: filter operators, canonical spelling → accepted aliases
_OP_ALIASES = {
    "eq": ("eq", "=", "=="),
    "ne": ("ne", "!=", "<>"),
    "ge": ("ge", ">="),
    "gt": ("gt", ">"),
    "le": ("le", "<="),
    "lt": ("lt", "<"),
    "in": ("in",),
}
_CANON_OP = {alias: op for op, aliases in _OP_ALIASES.items()
             for alias in aliases}

#: aggregate operators the kernels implement
AGG_OPS = ("count", "sum", "min", "max", "mean")

#: default top-K when the caller does not bound the group-by (0 = all)
DEFAULT_K = 100


class PlanError(ValueError):
    """Malformed query (unknown column/op, bad types) — a client
    error (HTTP 400), never an engine bug."""


@dataclasses.dataclass(frozen=True)
class Filter:
    """One column predicate. String columns take string values (eq/ne/
    in); numeric columns take integers (any op)."""

    column: str
    op: str
    value: object           # str | int | tuple for `in`

    def to_doc(self) -> Dict[str, object]:
        v = self.value
        return {"column": self.column, "op": self.op,
                "value": list(v) if isinstance(v, tuple) else v}


@dataclasses.dataclass(frozen=True)
class Aggregate:
    """One output aggregate; `label` is its result-row key."""

    op: str
    column: Optional[str]   # None only for count

    @property
    def label(self) -> str:
        if self.op == "count":
            return "count"
        return f"{self.op}({self.column})"

    def to_doc(self) -> Dict[str, object]:
        return {"op": self.op, "column": self.column}


@dataclasses.dataclass(frozen=True)
class QueryPlan:
    """A validated, normalized query over one queryable table
    (`flows`, or the `__metrics__` history table)."""

    group_by: Tuple[str, ...]
    aggregates: Tuple[Aggregate, ...]
    filters: Tuple[Filter, ...]
    start: Optional[int]
    end: Optional[int]
    time_column: str
    end_column: str
    k: int
    order_by: str            # an aggregate label
    table: str = "flows"

    # -- normalization -----------------------------------------------------

    def to_doc(self) -> Dict[str, object]:
        """Canonical JSON-able form (sorted filters, explicit
        defaults) — the cache key substrate and the doc echoed back to
        API clients."""
        return {
            "table": self.table,
            "groupBy": list(self.group_by),
            "aggregates": [a.to_doc() for a in self.aggregates],
            "filters": sorted((f.to_doc() for f in self.filters),
                              key=lambda d: json.dumps(d,
                                                       sort_keys=True)),
            "start": self.start,
            "end": self.end,
            "timeColumn": self.time_column,
            "endColumn": self.end_column,
            "k": self.k,
            "orderBy": self.order_by,
        }

    def normalized(self) -> str:
        return json.dumps(self.to_doc(), sort_keys=True,
                          separators=(",", ":"))

    def fingerprint(self) -> str:
        return hashlib.sha1(
            self.normalized().encode("utf-8")).hexdigest()

    # -- column sets (what the engine must touch) --------------------------

    def columns_touched(self) -> Tuple[str, ...]:
        """Every column the plan reads — the column-subset a cold-part
        decode needs (everything else's bytes are skipped on disk)."""
        cols = list(self.group_by)
        for a in self.aggregates:
            if a.column is not None:
                cols.append(a.column)
        for f in self.filters:
            cols.append(f.column)
        if self.start is not None:
            cols.append(self.time_column)
        if self.end is not None:
            cols.append(self.end_column)
        out: List[str] = []
        for c in cols:
            if c not in out:
                out.append(c)
        return tuple(out)


def _schema_column(schema, name: str):
    for c in schema:
        if c.name == name:
            return c
    raise PlanError(f"unknown column {name!r}")


def _parse_filter(doc: Dict[str, object], schema) -> Filter:
    if not isinstance(doc, dict):
        raise PlanError(f"filter must be an object, got {doc!r}")
    name = doc.get("column")
    col = _schema_column(schema, str(name))
    op = _CANON_OP.get(str(doc.get("op", "eq")).strip().lower())
    if op is None:
        raise PlanError(f"unknown filter op {doc.get('op')!r}")
    value = doc.get("value")
    if op == "in":
        if not isinstance(value, (list, tuple)) or not value:
            raise PlanError(
                f"filter {name}: `in` needs a non-empty list")
        if col.is_string:
            value = tuple(str(v) for v in value)
        else:
            value = tuple(int(v) for v in value)
    elif col.is_string:
        if op not in ("eq", "ne"):
            raise PlanError(
                f"filter {name}: string columns support eq/ne/in, "
                f"not {op}")
        value = str(value)
    else:
        try:
            value = int(value)   # all flow numerics are integer-typed
        except (TypeError, ValueError):
            raise PlanError(
                f"filter {name}: numeric column needs an integer, "
                f"got {value!r}")
    return Filter(str(name), op, value)


def _parse_aggregate(doc, schema) -> Aggregate:
    if isinstance(doc, str):
        # "sum:octetDeltaCount" / "count" shorthand (CLI, GET params)
        op, _, column = doc.partition(":")
        doc = {"op": op, "column": column or None}
    op = str(doc.get("op", "")).strip().lower()
    if op not in AGG_OPS:
        raise PlanError(
            f"unknown aggregate op {doc.get('op')!r} "
            f"(expected one of {AGG_OPS})")
    column = doc.get("column")
    if op == "count":
        return Aggregate("count", None)
    if not column:
        raise PlanError(f"aggregate {op} needs a column")
    col = _schema_column(schema, str(column))
    if col.is_string:
        raise PlanError(
            f"aggregate {op}({column}): string columns cannot be "
            f"aggregated (group by them instead)")
    return Aggregate(op, str(column))


def parse_plan(doc: Dict[str, object], schema=None) -> QueryPlan:
    """Build a validated QueryPlan from a request body (or any dict in
    the same shape). Raises PlanError (a ValueError → HTTP 400) on
    anything malformed. The plan's `table` (default `flows`) picks the
    schema every column resolves against and the window-column
    defaults; an explicit `schema` argument overrides (tests querying
    synthetic tables)."""
    if not isinstance(doc, dict):
        raise PlanError("query body must be a JSON object")
    table = str(doc.get("table") or "flows")
    default_time, default_end = "flowStartSeconds", "flowEndSeconds"
    if schema is None:
        if table not in QUERYABLE_TABLES:
            raise PlanError(
                f"unknown table {table!r} (expected one of "
                f"{sorted(QUERYABLE_TABLES)})")
        schema, default_time, default_end = QUERYABLE_TABLES[table]
    group_by = doc.get("groupBy") or []
    if isinstance(group_by, str):
        group_by = [g for g in group_by.split(",") if g]
    group_cols = []
    for g in group_by:
        _schema_column(schema, str(g))
        if str(g) in group_cols:
            raise PlanError(f"duplicate group-by column {g!r}")
        group_cols.append(str(g))
    aggs_doc = doc.get("aggregates") or doc.get("agg") or []
    if isinstance(aggs_doc, (str, dict)):
        aggs_doc = [aggs_doc]
    aggregates = [_parse_aggregate(a, schema) for a in aggs_doc]
    if not aggregates:
        aggregates = [Aggregate("count", None)]
    labels = [a.label for a in aggregates]
    if len(set(labels)) != len(labels):
        raise PlanError(f"duplicate aggregates: {labels}")
    filters = tuple(_parse_filter(f, schema)
                    for f in (doc.get("filters") or []))

    def _opt_int(key):
        v = doc.get(key)
        if v is None or v == "":
            return None
        try:
            return int(v)
        except (TypeError, ValueError):
            raise PlanError(f"{key} must be an integer, got {v!r}")

    start, end = _opt_int("start"), _opt_int("end")
    time_column = str(doc.get("timeColumn") or default_time)
    end_column = str(doc.get("endColumn") or default_end)
    for name in (time_column, end_column):
        if _schema_column(schema, name).is_string:
            # the window compares integers; a dictionary column here
            # would die inside the encoded-part evaluator (a 500)
            # instead of at the API edge (a 400)
            raise PlanError(
                f"window column {name!r} is a string column — the "
                f"time window needs a numeric/datetime column")
    k = _opt_int("k")
    if k is None:
        k = DEFAULT_K if group_cols else 0
    if k < 0:
        raise PlanError(f"k must be >= 0, got {k}")
    order_by = str(doc.get("orderBy") or labels[0])
    if order_by not in labels:
        raise PlanError(
            f"orderBy {order_by!r} is not one of the aggregates "
            f"{labels}")
    return QueryPlan(
        group_by=tuple(group_cols),
        aggregates=tuple(aggregates),
        filters=filters,
        start=start, end=end,
        time_column=time_column, end_column=end_column,
        k=int(k), order_by=order_by, table=table)


def plan_from_params(params: Dict[str, str],
                     schema=None) -> QueryPlan:
    """GET /query adapter: flat query-string params → plan doc.

    `table=flows|__metrics__` · `group_by=a,b` ·
    `agg=sum:col,count` · `start`/`end` ·
    `time_column`/`end_column` · `k` · `order_by` ·
    `where=col:op:value;col2:op:v1|v2` (values for `in` joined
    with `|`)."""
    doc: Dict[str, object] = {}
    if params.get("table"):
        doc["table"] = params["table"]
    if params.get("group_by"):
        doc["groupBy"] = params["group_by"]
    if params.get("agg"):
        doc["aggregates"] = [a for a in params["agg"].split(",") if a]
    filters: List[Dict[str, object]] = []
    for clause in (params.get("where") or "").split(";"):
        clause = clause.strip()
        if not clause:
            continue
        bits = clause.split(":", 2)
        if len(bits) != 3:
            raise PlanError(
                f"where clause {clause!r} is not column:op:value")
        column, op, raw = bits
        value: object = raw
        if _CANON_OP.get(op.strip().lower()) == "in":
            value = raw.split("|")
        filters.append({"column": column, "op": op, "value": value})
    if filters:
        doc["filters"] = filters
    for src, dst in (("start", "start"), ("end", "end"),
                     ("k", "k"), ("order_by", "orderBy"),
                     ("time_column", "timeColumn"),
                     ("end_column", "endColumn")):
        if params.get(src):
            doc[dst] = params[src]
    return parse_plan(doc, schema)
