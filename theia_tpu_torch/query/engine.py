"""Vectorized query engine over the part-based column store.

The read-side twin of the PR-6 fused detector: where PR 7 made the
flows table a set of immutable, width-reduced, dictionary-coded column
parts, this module runs filtered aggregations DIRECTLY over that
encoding — the ARIMA_PLUS "push analytics into the store" pattern —
instead of decoding parts back to table code space and aggregating a
materialized copy:

  1. **Plan → prune.** Part min/max metadata (the PR-7 pruning
     substrate) drops parts that cannot overlap the time window or a
     numeric filter's range before any column is touched. Inside the
     surviving SORTED parts (store/parts.py format v2), the same
     decision repeats at GRANULE granularity from the resident index
     metadata: the sparse primary index (zone map of the sort-key
     prefix, ascending because the part is sorted), per-granule
     min/max zone maps on every column, and bounded set indexes of
     distinct dictionary codes on string columns. Predicates decide
     granules BEFORE any row is gathered; only surviving granule row
     ranges are evaluated (`pk:`/`skip_minmax:`/`skip_set:` reasons
     in EXPLAIN, theia_query_granules_{scanned,skipped}_total).
  2. **Filters in encoded space.** On a hot part, a numeric predicate
     compares the WIDTH-REDUCED stored array against the rebased
     threshold (`v - base`, clamped: an out-of-range threshold decides
     the whole part without widening a single row); a string predicate
     resolves to table-global dictionary codes ONCE per query, then
     per part intersects the part's unique-code set — a miss skips the
     part entirely, a hit turns into a boolean gather over the narrow
     local indices. No strings, no widening, no row materialization.
  3. **Late-materializing group-by.** Group keys aggregate in the
     part's LOCAL code space (u1/u2 indices); only the SURVIVING
     groups map local → global codes (strings) or `+ base`
     (numerics). Aggregation itself is query/kernels.py — lexsort +
     reduceat, or int64 torch segment reductions on the engine's
     device (`THEIA_QUERY_JAX=1`; no fallback to numpy). When the
     plan's groupBy is a PREFIX of the part's sort key, the part's
     rows are already key-clustered (local indices and width-reduced
     ints are monotone in the decoded values) and the kernel skips
     its lexsort entirely — group boundaries come from one
     adjacent-row comparison over contiguous runs, bit-identical
     output.
  4. **Parallel per-part execution.** Live parts are striped across a
     bounded pool (`THEIA_QUERY_WORKERS`); each worker folds its
     parts into ONE per-worker partial accumulator, and the partials
     merge exactly (count via sum, min via min, ...).
  5. **Cold tier stays cold.** A demoted part streams through a
     bounded decode buffer (`THEIA_QUERY_COLD_BUFFER` concurrent
     decodes), decoding ONLY the columns the plan touches
     (column-subset part-file decode), and is never promoted back to
     RAM — the hot/cold working-set split of arXiv:1902.04143 holds
     under scans.
  6. **Result cache.** Finalized results cache under (normalized
     plan, store-state fingerprint); any seal/merge/demote/delete/
     insert changes the fingerprint, so invalidation is structural,
     not timed (`THEIA_QUERY_CACHE_BYTES`).

The flat engine and the parts memtable take the slow-but-correct
reference executor path (query/reference.py); the randomized oracle
suite (tests/test_query.py) holds every path bit-identical.
"""

from __future__ import annotations

import collections
import hashlib
import os
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..obs import metrics as _metrics
from ..obs import trace as _trace
from ..schema import ColumnarBatch
from ..utils.env import env_int
from ..utils.logging import get_logger
from ..utils.pool import get_pool
from . import kernels
from .explain import SLOW_QUERIES, QueryProfiler
from .plan import QUERYABLE_TABLES, QueryPlan
from .reference import filter_mask, materialize_keys, reference_partial
from .result import empty_result, finalize, lower_specs, value_columns
from ..analysis.lockdep import named_lock

logger = get_logger("query")

DEFAULT_WORKERS = min(8, os.cpu_count() or 1)
DEFAULT_CACHE_BYTES = 16 << 20
DEFAULT_COLD_BUFFER = 2

_M_SECONDS = _metrics.histogram(
    "theia_query_seconds",
    "End-to-end query-engine execution time (cache misses; hits are "
    "counted separately)")
_M_ROWS_SCANNED = _metrics.counter(
    "theia_query_rows_scanned_total",
    "Rows evaluated by the query engine (part rows after pruning + "
    "memtable rows)")
_M_PARTS_SCANNED = _metrics.counter(
    "theia_query_parts_scanned_total",
    "Parts evaluated by queries after pruning")
_M_PARTS_PRUNED = _metrics.counter(
    "theia_query_parts_pruned_total",
    "Parts skipped by query min/max + dictionary-code pruning (read "
    "with theia_query_parts_scanned_total for the prune ratio)")
_M_GRANULES_SCANNED = _metrics.counter(
    "theia_query_granules_scanned_total",
    "Index granules evaluated inside sorted parts after granule-level "
    "skip-index pruning (sorted format-v2 parts only)")
_M_GRANULES_SKIPPED = _metrics.counter(
    "theia_query_granules_skipped_total",
    "Index granules skipped inside sorted parts by the sparse primary "
    "index and per-granule zone-map/set skip indexes (read with "
    "theia_query_granules_scanned_total for the intra-part prune "
    "ratio)")
_M_CACHE_HITS = _metrics.counter(
    "theia_query_cache_hits_total",
    "Queries answered from the result cache (same normalized plan, "
    "unchanged store fingerprint)")
_M_CACHE_MISSES = _metrics.counter(
    "theia_query_cache_misses_total",
    "Queries that had to execute (cold cache, or the store fingerprint "
    "moved under seal/merge/demote/insert/delete)")


class QueryError(Exception):
    """The engine could not execute a valid plan (store-side issue)."""


# -- compiled predicates ---------------------------------------------------

class _CompiledFilter:
    """One plan filter resolved against a concrete table: string
    values → sorted global dictionary codes (resolved once per query,
    not per part)."""

    __slots__ = ("column", "op", "value", "codes", "is_string")

    def __init__(self, f, table) -> None:
        self.column = f.column
        self.op = f.op
        self.value = f.value
        d = table.dicts.get(f.column)
        self.is_string = d is not None
        self.codes: Optional[np.ndarray] = None
        if self.is_string:
            values = (f.value if isinstance(f.value, tuple)
                      else (f.value,))
            # unique, not just sorted: isin(assume_unique=True)
            # downstream requires it, and `in` values may repeat.
            # int32 — the dictionaries' native code dtype — so the
            # per-part intersections below need no conversions.
            self.codes = np.unique(np.asarray(
                [c for c in (d.lookup(str(v)) for v in values)
                 if c is not None], np.int32))

    def excludes_part(self, part) -> bool:
        """True when this predicate PROVABLY matches no row of a hot
        part, from resident metadata alone: eq/in whose resolved code
        set misses the part's unique-code set (or resolved to nothing
        at all). The dictionary-code half of part pruning."""
        if not self.is_string or self.op == "ne":
            return False
        if not len(self.codes):
            return True        # value(s) not in the table dictionary
        chunks = part.chunks
        chunk = chunks.get(self.column) if chunks is not None else None
        if chunk is None or not hasattr(chunk, "uniq"):
            return False       # cold/lazy: no resident code set
        return not _sorted_intersects(self.codes, chunk.uniq)


def _minmax_excludes(mm: Tuple[int, int], op: str, value) -> bool:
    """True when part min/max PROVES no row can match a numeric
    predicate (the filter-level analogue of window pruning)."""
    lo, hi = mm
    if op == "ge":
        return hi < value
    if op == "gt":
        return hi <= value
    if op == "le":
        return lo > value
    if op == "lt":
        return lo >= value
    if op == "eq":
        return value < lo or value > hi
    if op == "in":
        return all(v < lo or v > hi for v in value)
    return False   # ne: metadata can't exclude


def _zone_excludes(mins: np.ndarray, maxs: np.ndarray, op: str,
                   value) -> np.ndarray:
    """Vectorized `_minmax_excludes` over per-granule zone maps: a
    bool array, True where granule g PROVABLY holds no matching row.
    `ne` proves nothing (a granule whose zone equals the value could
    still be all-equal — but so could any other)."""
    if op == "ge":
        return maxs < value
    if op == "gt":
        return maxs <= value
    if op == "le":
        return mins > value
    if op == "lt":
        return mins >= value
    if op == "eq":
        return (value < mins) | (value > maxs)
    if op == "in":
        drop = np.ones(len(mins), bool)
        for v in value:
            drop &= (v < mins) | (v > maxs)
        return drop
    return np.zeros(len(mins), bool)


def _sorted_intersects(a: np.ndarray, b: np.ndarray) -> bool:
    """Any common element between two SORTED unique integer arrays.
    This runs once per (surviving granule, string filter) — np.isin's
    dispatch overhead (dtype logic, zeros_like, min/max probing) is
    ~50us per call at that grain and was the dominant cost of a fully
    index-pruned query; two searchsorted-style ops are ~2us."""
    if not len(a) or not len(b):
        return False
    if len(a) > len(b):
        a, b = b, a
    pos = np.searchsorted(b, a)
    pos[pos == len(b)] = len(b) - 1
    return bool((b[pos] == a).any())


def _ranges_to_rows(starts: np.ndarray, ends: np.ndarray) -> np.ndarray:
    """Concatenated `arange(s, e)` for every surviving granule range,
    in one cumsum pass (no per-granule allocations): an all-ones array
    with each range's first element patched to jump from the previous
    range's end."""
    lens = (ends - starts).astype(np.int64)
    total = int(lens.sum())
    out = np.ones(total, np.int64)
    out[0] = starts[0]
    cuts = np.cumsum(lens)[:-1]
    out[cuts] = starts[1:] - ends[:-1] + 1
    return np.cumsum(out)


def _cmp_encoded(chunk, op: str, value: int,
                 rows: Optional[np.ndarray] = None) -> object:
    """Evaluate `col <op> value` on a width-reduced numeric chunk
    WITHOUT widening: compare the narrow stored array against the
    rebased threshold. Returns a bool array, or True/False when the
    rebased threshold falls outside the stored dtype's range (the
    whole part decides at once). `rows` restricts the comparison to
    that row selection (the granule-surviving rows)."""
    s = chunk.stored if rows is None else chunk.stored[rows]
    if op == "in":
        vals = np.asarray(value, np.int64) - chunk.base
        lo, hi = (np.iinfo(s.dtype).min, np.iinfo(s.dtype).max) \
            if s.dtype.kind in "iu" else (-np.inf, np.inf)
        vals = vals[(vals >= lo) & (vals <= hi)]
        if not len(vals):
            return False
        return np.isin(s, vals.astype(s.dtype))
    t = value - chunk.base
    if s.dtype.kind in "iu":
        info = np.iinfo(s.dtype)
        if t < info.min:     # every stored value is above t
            return {"ge": True, "gt": True, "le": False,
                    "lt": False, "eq": False, "ne": True}[op]
        if t > info.max:     # every stored value is below t
            return {"ge": False, "gt": False, "le": True,
                    "lt": True, "eq": False, "ne": True}[op]
        t = s.dtype.type(t)
    return {"eq": s == t, "ne": s != t, "ge": s >= t,
            "gt": s > t, "le": s <= t, "lt": s < t}[op]


def _and_mask(mask, m) -> object:
    """AND-combine masks where True means all rows / False means no
    rows (short-circuit forms the encoded comparisons return)."""
    if m is True or mask is False:
        return mask
    if mask is True or m is False:
        return m
    mask &= m
    return mask


# -- result cache ----------------------------------------------------------

class QueryCache:
    """LRU-by-bytes cache of finalized result docs keyed by
    (normalized plan, store-state fingerprint). Invalidation is the
    fingerprint moving — every seal, merge, demote, delete, and insert
    changes it — so a stale hit is structurally impossible."""

    def __init__(self, max_bytes: Optional[int] = None) -> None:
        self.max_bytes = (
            env_int("THEIA_QUERY_CACHE_BYTES", DEFAULT_CACHE_BYTES)
            if max_bytes is None else int(max_bytes))
        self._entries: "collections.OrderedDict[tuple, Tuple[dict, int]]" = (
            collections.OrderedDict())
        self._bytes = 0
        self._lock = named_lock("query.cache")
        self.hits = 0
        self.misses = 0

    def lookup(self, key: tuple) -> Optional[dict]:
        if self.max_bytes <= 0:
            return None
        with self._lock:
            entry = self._entries.get(key)
            if entry is None:
                self.misses += 1
                return None
            self._entries.move_to_end(key)
            self.hits += 1
            return entry[0]

    @staticmethod
    def _estimate_bytes(doc: dict) -> int:
        """Cheap structural size estimate for the LRU byte charge —
        a full json.dumps here would serialize every result doc a
        second time (the HTTP layer already pays one) just to weigh
        it, which is worst exactly on the large results the cache
        exists to help. String values are charged at their REAL
        length (sampled from the first row): pod-label group keys run
        to kilobytes, and a flat per-value charge would let the
        configured byte budget retain 10x its size."""
        rows = doc.get("rows") or ()
        if not rows:
            return 512
        per_row = 24 + sum(
            (len(k) + len(v) + 49) if isinstance(v, str)
            else (len(k) + 40)
            for k, v in rows[0].items())
        return 512 + len(rows) * per_row

    def store(self, key: tuple, doc: dict) -> None:
        if self.max_bytes <= 0:
            return
        nbytes = self._estimate_bytes(doc)
        if nbytes > self.max_bytes:
            return
        with self._lock:
            old = self._entries.pop(key, None)
            if old is not None:
                self._bytes -= old[1]
            self._entries[key] = (doc, nbytes)
            self._bytes += nbytes
            while self._bytes > self.max_bytes and self._entries:
                _, (_, n) = self._entries.popitem(last=False)
                self._bytes -= n

    def clear(self) -> None:
        with self._lock:
            self._entries.clear()
            self._bytes = 0

    def stats(self) -> Dict[str, object]:
        with self._lock:
            return {"entries": len(self._entries),
                    "bytes": self._bytes,
                    "maxBytes": self.max_bytes,
                    "hits": self.hits, "misses": self.misses}


# -- the engine ------------------------------------------------------------

Partial = Optional[Tuple[np.ndarray, Dict[str, np.ndarray]]]


class QueryEngine:
    """Executes QueryPlans over a FlowDatabase (plain, sharded, or
    replicated; parts or flat engine). Thread-safe; one instance per
    manager."""

    def __init__(self, db,
                 workers: Optional[int] = None,
                 cache_bytes: Optional[int] = None,
                 cold_buffer: Optional[int] = None,
                 device=None) -> None:
        self.db = db
        # where kernels.aggregate runs under THEIA_QUERY_JAX=1; None is
        # the card, resolved only when the torch branch runs
        self.device = device
        self.workers = max(1, (
            env_int("THEIA_QUERY_WORKERS", DEFAULT_WORKERS)
            if workers is None else int(workers)))
        self.cold_buffer = max(1, (
            env_int("THEIA_QUERY_COLD_BUFFER", DEFAULT_COLD_BUFFER)
            if cold_buffer is None else int(cold_buffer)))
        self._cold_sem = threading.Semaphore(self.cold_buffer)
        self.cache = QueryCache(cache_bytes)
        self.queries = 0
        self._lock = named_lock("query.engine")

    # -- store resolution --------------------------------------------------

    def _tables(self, table: str = "flows") -> List[object]:
        """Concrete tables to query for one plan's target: one for
        plain/replicated (the active replica resolves through
        __getattr__ — all replicas down raises, surfacing as 503),
        every shard for a sharded store. `flows` is the data plane;
        any other name resolves through the store's result-table
        registry (the `__metrics__` history table queries through
        the same engine)."""
        if table == "flows":
            root = self.db.flows
        else:
            try:
                root = self.db.result_tables[table]
            except (KeyError, AttributeError):
                raise QueryError(
                    f"table {table!r} is not present in this store")
        if hasattr(root, "tables"):
            return list(root.tables)
        return [root]

    @staticmethod
    def _table_state(table) -> tuple:
        """Cache-fingerprint component for one table: covers inserts/
        deletes (generation), seals (memtable length + part set),
        merges (part uids), and demotions (tiers)."""
        parts = getattr(table, "_parts", None)
        if parts is not None:
            with table._lock:
                return (table.generation, table._memtable_len,
                        tuple((p.uid, p.tier) for p in table._parts))
        return (table.generation, len(table))

    def fingerprint(self, tables: Optional[List[object]] = None
                    ) -> tuple:
        """Cache-key component covering one table set's state; pass
        `tables` to fingerprint an already-resolved snapshot (execute
        does — key and execution must cover the same table set). The
        default covers the FLOWS tables only — the `__metrics__`
        history mutates every scrape tick, so folding it in here
        would invalidate every flows cache (and re-trigger heartbeat
        bounds scans) each tick; per-table digests come from
        `table_fingerprints()`."""
        if tables is None:
            tables = self._tables()
        return tuple(self._table_state(t) for t in tables)

    def table_fingerprints(self) -> Dict[str, str]:
        """{table: digest} for every queryable table present in this
        store — what cluster heartbeats piggyback, so a coordinator
        keys its cache PER PLAN TABLE: a peer's scrape tick moves its
        `__metrics__` digest (invalidating metrics-history results
        within one heartbeat) without touching the flows digest that
        keys everything else."""
        out: Dict[str, str] = {}
        for name in QUERYABLE_TABLES:
            try:
                tables = self._tables(name)
            except Exception:
                continue   # a store predating the table
            out[name] = self.fingerprint_hash(self.fingerprint(tables))
        return out

    def fingerprint_hash(self, fingerprint: Optional[tuple] = None
                         ) -> str:
        """Compact digest of `fingerprint()` — what cluster heartbeats
        piggyback so a query coordinator can key its cluster-wide
        result cache on per-peer store states (any seal/merge/demote/
        insert/delete on any node moves its digest). Pass an
        already-computed fingerprint to digest the exact state an
        execution keyed on (EXPLAIN profiles do)."""
        if fingerprint is None:
            fingerprint = self.fingerprint()
        return hashlib.sha1(
            repr(fingerprint).encode()).hexdigest()[:16]

    # -- public API --------------------------------------------------------

    def execute(self, plan: QueryPlan,
                use_cache: bool = True,
                explain: bool = False,
                traceparent: Optional[str] = None,
                use_rollup: bool = True
                ) -> Dict[str, object]:
        """Run one plan; returns the result doc. Raises PlanError
        (from parsing, upstream), QueryError, or the store's
        availability errors. `explain=True` attaches the execution
        profile (query/explain.py) WITHOUT re-running anything — the
        result rows are bit-identical either way; `traceparent`
        adopts a caller's trace context (this is a trace ingress);
        `use_rollup=False` (the request's `rollup=0` flag) forces the
        raw-scan path even when a declared rollup view subsumes the
        plan — the bench's A/B lever and the parity tests' oracle
        side."""
        with _trace.ingress_span("query.request",
                                 traceparent=traceparent) as sp:
            doc = self._execute_traced(plan, use_cache, explain,
                                       use_rollup)
            sp.attrs["groups"] = doc.get("groupCount")
            sp.attrs["cache"] = doc.get("cache")
            return doc

    @staticmethod
    def _stamp_trace(doc: Dict[str, object]) -> None:
        """Attach the current sampled trace id to a result doc (the
        caller's handle into `theia trace <id>`)."""
        ctx = _trace.current_context()
        if ctx is not None:
            doc["traceId"] = ctx.trace_id

    def _execute_traced(self, plan: QueryPlan, use_cache: bool,
                        explain: bool,
                        use_rollup: bool = True) -> Dict[str, object]:
        with self._lock:
            self.queries += 1
        t0 = time.perf_counter()
        tables = self._tables(plan.table)
        fp = self.fingerprint(tables)
        # a disabled cache (THEIA_QUERY_CACHE_BYTES=0) reports "off",
        # not a permanent 0% hit ratio that reads as a broken cache —
        # and an uncached execution (every /query/partial, every
        # cache=0 probe) skips the key's plan-JSON normalization
        # entirely
        caching = use_cache and self.cache.max_bytes > 0
        if caching:
            # the rollup flag joins the key: the ROWS are identical
            # either way (the parity gate), but the doc's rollup/scan
            # accounting differs and must not leak across flags
            key = (plan.normalized(), fp, bool(use_rollup))
            hit = self.cache.lookup(key)
            if hit is not None:
                _M_CACHE_HITS.inc()
                doc = dict(hit)
                doc["cache"] = "hit"
                # THIS answer's latency, not the cached miss's —
                # anyone debugging from the footer would otherwise
                # read the slow path for a microsecond hit
                doc["tookMs"] = round(
                    (time.perf_counter() - t0) * 1000, 3)
                self._stamp_trace(doc)
                if explain:
                    # a hit has no per-part story to tell — the honest
                    # profile is "served from cache under this state"
                    doc["profile"] = {
                        "engine": doc.get("engine"),
                        "cache": "hit",
                        "fingerprint": self.fingerprint_hash(fp),
                    }
                return doc
            _M_CACHE_MISSES.inc()
        prof = QueryProfiler.maybe(explain)
        stats = {"rowsScanned": 0, "partsScanned": 0, "partsPruned": 0,
                 "granulesScanned": 0, "granulesSkipped": 0}
        t_exec = time.perf_counter()
        keys, aggs, rollup_info = self._partial_with_rollup(
            plan, tables, stats, prof, use_rollup)
        t_fin = time.perf_counter()
        if aggs is None or _n_groups(aggs) == 0:
            rows, groups = empty_result(plan)
        else:
            rows, groups = finalize(plan, keys, aggs)
        took = time.perf_counter() - t0
        _M_SECONDS.observe(took)
        _M_ROWS_SCANNED.inc(stats["rowsScanned"])
        _M_PARTS_SCANNED.inc(stats["partsScanned"])
        _M_PARTS_PRUNED.inc(stats["partsPruned"])
        _M_GRANULES_SCANNED.inc(stats["granulesScanned"])
        _M_GRANULES_SKIPPED.inc(stats["granulesSkipped"])
        doc = {
            "plan": plan.to_doc(),
            "rows": rows,
            "groupCount": groups,
            "rowsScanned": stats["rowsScanned"],
            "partsScanned": stats["partsScanned"],
            "partsPruned": stats["partsPruned"],
            "granulesScanned": stats["granulesScanned"],
            "granulesSkipped": stats["granulesSkipped"],
            "engine": ("parts" if any(
                getattr(t, "_parts", None) is not None
                for t in tables) else "flat"),
            "tookMs": round(took * 1000, 3),
            "cache": "miss" if caching else "off",
        }
        if rollup_info is not None:
            # the planner-rewrite story rides the result doc: which
            # view answered, the alignment tier, and the stitched
            # raw-scan edge spans — the rows are bit-identical to the
            # raw path either way
            doc["rollup"] = rollup_info
        if caching:
            # the cached doc carries no profile or trace id: a later
            # hit under the same key would serve a stale one
            self.cache.store(key, doc)
            doc = dict(doc)
        self._stamp_trace(doc)   # BEFORE slow capture: entries link
        profile = None           # back via theia trace <id>
        if prof is not None:
            prof.phase("execute", t_fin - t_exec)
            prof.phase("finalize", time.perf_counter() - t_fin)
            extra: Dict[str, object] = {}
            if rollup_info is not None:
                extra["rollup"] = rollup_info
            profile = prof.doc(
                engine=doc["engine"],
                kernel=kernels.kernel_mode(),
                cache=doc["cache"],
                fingerprint=self.fingerprint_hash(fp),
                rowsScanned=stats["rowsScanned"],
                partsScanned=stats["partsScanned"],
                partsPruned=stats["partsPruned"],
                granulesScanned=stats["granulesScanned"],
                granulesSkipped=stats["granulesSkipped"],
                **extra,
            )
            SLOW_QUERIES.observe(plan, doc, prof, profile)
        if explain and profile is not None:
            doc["profile"] = profile
        return doc

    def stats(self) -> Dict[str, object]:
        """Operator doc for /healthz `query`."""
        return {
            "queries": self.queries,
            "workers": self.workers,
            "coldBuffer": self.cold_buffer,
            "kernel": kernels.kernel_mode(),
            "cache": self.cache.stats(),
        }

    def execute_partial(self, plan: QueryPlan,
                        stats: Optional[Dict[str, int]] = None,
                        prof: Optional[QueryProfiler] = None,
                        use_rollup: bool = True
                        ) -> Tuple[Optional[List[np.ndarray]],
                                   Optional[Dict[str, np.ndarray]]]:
        """One node's share of a distributed query: (materialized
        group-key columns, merged LOWERED aggregates) over the local
        store only — the `/query/partial` server half. No finalize, no
        top-K, no cache: partials must merge exactly on the
        coordinator, and the top-K cut is only correct after that
        merge (query/distributed.py). The rollup planner rewrite
        applies HERE too, so a coordinator gets O(groups) partials
        even when this peer's window is cold month-scale history."""
        if stats is None:
            stats = {"rowsScanned": 0, "partsScanned": 0,
                     "partsPruned": 0, "granulesScanned": 0,
                     "granulesSkipped": 0}
        for k in ("granulesScanned", "granulesSkipped"):
            stats.setdefault(k, 0)
        keys, aggs, _ = self._partial_with_rollup(
            plan, self._tables(plan.table), stats, prof, use_rollup)
        return keys, aggs

    def _partial_with_rollup(self, plan: QueryPlan, tables, stats,
                             prof: Optional[QueryProfiler],
                             use_rollup: bool
                             ) -> Tuple[Optional[List[np.ndarray]],
                                        Optional[Dict[str,
                                                      np.ndarray]],
                                        Optional[Dict[str, object]]]:
        """(keys, aggs, rollup-info): the rollup planner rewrite when
        a declared view subsumes the plan (query/rollup.py — aligned
        middle from aggregate parts, raw-scan edges stitched), else
        the normal raw path with info=None."""
        if use_rollup:
            from . import rollup as _rollup
            view = _rollup.match_view(self.db, plan)
            if view is not None:
                res = _rollup.try_rollup_partial(self, plan, stats,
                                                 prof, view)
                if res is not None:
                    return res
        keys, aggs = self._partial_for_tables(plan, tables, stats,
                                              prof)
        return keys, aggs, None

    # -- per-table execution -----------------------------------------------

    def _partial_for_tables(self, plan: QueryPlan, tables, stats,
                            prof: Optional[QueryProfiler] = None
                            ) -> Tuple[Optional[List[np.ndarray]],
                                       Optional[Dict[str, np.ndarray]]]:
        table_results = [self._execute_table(plan, t, stats, prof)
                         for t in tables]
        if len(table_results) == 1:
            return table_results[0]
        return merge_materialized(plan, table_results)

    def _execute_table(self, plan: QueryPlan, table, stats,
                       prof: Optional[QueryProfiler] = None,
                       refs=None
                       ) -> Tuple[Optional[List[np.ndarray]],
                                  Optional[Dict[str, np.ndarray]]]:
        """One table → (materialized key columns, merged aggregates)
        or (None, None) when nothing survives. `refs` pins a caller's
        pre-captured (parts, memtable) snapshot — the rollup rewrite
        computes its window alignment from one capture and must
        evaluate exactly that capture."""
        if getattr(table, "_parts", None) is None:
            partial, scanned = self._flat_partial(plan, table, prof)
            stats["rowsScanned"] += scanned
        else:
            partial = self._parts_partials(plan, table, stats, prof,
                                           refs=refs)
        if partial is None:
            return None, None
        uniq, aggs = partial
        keys = materialize_keys(plan, uniq, table.dicts, table.schema)
        return keys, aggs

    def _flat_partial(self, plan, table,
                      prof: Optional[QueryProfiler] = None
                      ) -> Tuple[Partial, int]:
        """Flat engine: the reference executor over a (column-subset)
        scan — slow but correct, and the parity anchor."""
        cols = plan.columns_touched()
        batch = table.select(columns=cols) if cols else table.scan()
        if prof is not None and prof.detail and len(batch):
            # an extra mask evaluation — paid only under an explicit
            # explain=1, never on the always-on slow-capture profiler
            prof.add_matched(int(filter_mask(plan, batch,
                                             table.dicts).sum()))
        return reference_partial(plan, batch, table.dicts), len(batch)

    def _granule_prune(self, plan: QueryPlan, filters, part
                       ) -> Optional[Tuple[np.ndarray,
                                           Dict[str, int]]]:
        """Granule-level skip decisions for one SORTED part from its
        RESIDENT index metadata only — no chunk or file is touched.
        Returns (keep bool array over granules, {reason: granules
        skipped}) or None when the part carries no indexes (format
        v1, or a lazily-adopted v2 part whose indexes rebuild on
        promotion — scanned whole, exactly as pre-PR-12).

        Reasons mirror the part-level ones one tier down:
        `pk:<col>` — the sparse primary index (the zone map of the
        part's FIRST sort-key column, ascending because the part is
        sorted, so this is the binary-searchable MergeTree index);
        `skip_minmax:<col>` — any other column's zone map;
        `skip_set:<col>` — a string column's per-granule distinct-
        code set missed every resolved filter code."""
        idx = part.indexes
        if idx is None:
            return None
        keep = np.ones(idx.n_granules, bool)
        reasons: Dict[str, int] = {}
        pk = part.sort_key[0] if part.sort_key else None

        def drop(col: str, excluded: np.ndarray, kind: str) -> None:
            newly = int((excluded & keep).sum())
            if newly:
                label = (f"pk:{col}" if col == pk
                         else f"{kind}:{col}")
                reasons[label] = reasons.get(label, 0) + newly
                np.logical_and(keep, ~excluded, out=keep)

        if plan.start is not None:
            zm = idx.zones.get(plan.time_column)
            if zm is not None:
                drop(plan.time_column, zm[1] < plan.start,
                     "skip_minmax")
        if plan.end is not None and keep.any():
            zm = idx.zones.get(plan.end_column)
            if zm is not None:
                drop(plan.end_column, zm[0] >= plan.end,
                     "skip_minmax")
        for f in filters:
            if not keep.any():
                break
            if f.op == "ne":
                continue   # proves nothing at any granularity
            if f.is_string:
                if not len(f.codes):
                    # value(s) absent from the dictionary: no granule
                    # anywhere can match (cold parts reach here — the
                    # part-level code check needs resident chunks)
                    drop(f.column, np.ones(len(keep), bool),
                         "skip_set")
                    break
                zm = idx.zones.get(f.column)
                if zm is not None:
                    # zone maps over dictionary codes: f.codes is
                    # sorted unique, so "any code in [min, max]" is
                    # two searchsorteds, vectorized over granules
                    lo = np.searchsorted(f.codes, zm[0], side="left")
                    hi = np.searchsorted(f.codes, zm[1], side="right")
                    drop(f.column, hi == lo, "skip_minmax")
                sets = idx.sets.get(f.column)
                if sets is not None:
                    excluded = np.zeros(len(keep), bool)
                    for g in np.flatnonzero(keep):
                        s = sets[g]
                        if s is not None and not _sorted_intersects(
                                f.codes, s):
                            excluded[g] = True
                    drop(f.column, excluded, "skip_set")
            else:
                zm = idx.zones.get(f.column)
                if zm is not None:
                    drop(f.column, _zone_excludes(zm[0], zm[1],
                                                  f.op, f.value),
                         "skip_minmax")
        return keep, reasons

    def _parts_partials(self, plan: QueryPlan, table, stats,
                        prof: Optional[QueryProfiler] = None,
                        refs=None) -> Partial:
        """Parts engine: prune (whole parts from min/max + code sets,
        then GRANULES inside surviving sorted parts from their skip
        indexes) → stripe live parts across the worker pool (each
        worker folds its stripe into one partial accumulator) →
        evaluate the memtable via the reference path → merge
        everything exactly. `prof` (the EXPLAIN profiler) records each
        part's fate, the prune REASON, and the per-part granule
        scanned/skipped counts with reasons — the decisions are
        computed here regardless, so profiling adds bookkeeping,
        never work."""
        specs = lower_specs(plan)
        filters = [_CompiledFilter(f, table) for f in plan.filters]
        parts, mem = table._snapshot_refs() if refs is None else refs
        #: (part, surviving-row selection or None for all rows)
        live: List[Tuple[object, Optional[np.ndarray]]] = []
        pruned = 0
        for p in parts:
            reason = None
            if not p.overlaps(plan.start, plan.end, plan.time_column,
                              plan.end_column):
                reason = "time_window"
            else:
                for f in filters:
                    if f.is_string:
                        # dictionary-code pruning (hot parts: the
                        # unique code set is resident metadata)
                        if f.excludes_part(p):
                            reason = f"codes:{f.column}"
                            break
                        continue
                    if f.op == "ne":
                        continue
                    mm = p.minmax.get(f.column)
                    if mm is not None and _minmax_excludes(
                            mm, f.op, f.value):
                        reason = f"range:{f.column}"
                        break
            rows_sel = None
            gdetail = None
            if reason is None:
                gp = self._granule_prune(plan, filters, p)
                if gp is not None:
                    keep, greasons = gp
                    kept = int(keep.sum())
                    skipped = len(keep) - kept
                    stats["granulesScanned"] += kept
                    stats["granulesSkipped"] += skipped
                    gdetail = {"scanned": kept, "skipped": skipped}
                    if greasons:
                        gdetail["reasons"] = greasons
                    if kept == 0:
                        # every granule provably empty — the part
                        # prunes wholesale, one tier late
                        reason = "granules"
                    elif skipped:
                        idx = p.indexes
                        rows_sel = _ranges_to_rows(
                            idx.starts[keep],
                            idx.granule_ends()[keep])
            if reason is not None:
                pruned += 1
            else:
                live.append((p, rows_sel))
                stats["rowsScanned"] += (
                    len(rows_sel) if rows_sel is not None else p.rows)
            if prof is not None:
                prof.add_part(p.uid, p.tier, p.rows, pruned=reason,
                              granules=gdetail,
                              resolution=p.minmax.get("resolution"))
        partials: List[Partial] = []
        if live:
            stripes = [live[i::self.workers]
                       for i in range(min(self.workers, len(live)))]
            if len(stripes) == 1:
                partials.append(self._fold_stripe(
                    plan, table, specs, filters, stripes[0], prof))
            else:
                pool = get_pool("query", self.workers)
                futs = [pool.submit(self._fold_stripe, plan, table,
                                    specs, filters, s, prof)
                        for s in stripes]
                partials.extend(f.result() for f in futs)
        for b in mem:
            if len(b):
                partials.append(self._decoded_partial(plan, table,
                                                      specs, b, prof))
                stats["rowsScanned"] += len(b)
                if prof is not None:
                    prof.memtable_rows += len(b)
        stats["partsScanned"] += len(live)
        stats["partsPruned"] += pruned
        merged = kernels.merge_partials(
            [p for p in partials if p is not None], specs,
            device=self.device)
        return merged if len(merged[0]) else None

    def _fold_stripe(self, plan, table, specs, filters,
                     parts: Sequence,
                     prof: Optional[QueryProfiler] = None) -> Partial:
        """One worker's stripe of (part, row-selection) pairs:
        evaluate each part over its granule-surviving rows, fold the
        partials into a single per-worker accumulator."""
        partials = [self._part_partial(plan, table, specs, filters, p,
                                       rows_sel, prof)
                    for p, rows_sel in parts]
        partials = [p for p in partials if p is not None]
        if not partials:
            return None
        return kernels.merge_partials(partials, specs,
                                      device=self.device)

    # -- per-part evaluation -----------------------------------------------

    def _part_partial(self, plan, table, specs, filters, part,
                      rows_sel: Optional[np.ndarray] = None,
                      prof: Optional[QueryProfiler] = None
                      ) -> Partial:
        chunks = part.chunks
        if chunks is None:
            if part.tier == "cold":
                return self._cold_partial(plan, table, specs, part,
                                          rows_sel, prof)
            # lazy-recovery hot part: decode (and promote) once, then
            # evaluate in decoded space. rows_sel is normally None
            # here (a lazy part has no resident indexes when the
            # selection is computed), but a promotion racing the
            # planning loop can hand us one — honor it through the
            # freshly-promoted rowid so the rowsScanned accounting
            # stays truthful (the decoded batch is insertion-order;
            # rowid maps the sort-order selection back onto it).
            batch = table._decode_part(part)
            if rows_sel is not None:
                rid = part.rowid
                if rid is not None:
                    batch = batch.take(
                        np.asarray(rid, np.int64)[rows_sel])
            return self._decoded_partial(plan, table, specs, batch,
                                         prof)
        return self._encoded_partial(plan, table, specs, filters,
                                     part, chunks, rows_sel, prof)

    def _encoded_partial(self, plan, table, specs, filters,
                         part, chunks,
                         rows_sel: Optional[np.ndarray] = None,
                         prof: Optional[QueryProfiler] = None
                         ) -> Partial:
        """Hot part, no decode: predicates on width-reduced ints and
        local dictionary indices; group keys aggregate in local code
        space; only surviving groups widen to global codes. A non-None
        `rows_sel` (granule pruning) restricts every column touch to
        the surviving granules' rows — skipped granules cost nothing,
        not even the predicate comparison."""
        n_rows = part.rows if rows_sel is None else len(rows_sel)

        def take(arr: np.ndarray) -> np.ndarray:
            return arr if rows_sel is None else arr[rows_sel]

        mask: object = True
        if plan.start is not None:
            mask = _and_mask(mask, _cmp_encoded(
                chunks[plan.time_column], "ge", plan.start, rows_sel))
        if mask is not False and plan.end is not None:
            mask = _and_mask(mask, _cmp_encoded(
                chunks[plan.end_column], "lt", plan.end, rows_sel))
        for f in filters:
            if mask is False:
                return None
            chunk = chunks[f.column]
            if f.is_string:
                # global code set → positions in the part's unique
                # codes (both sorted unique: searchsorted, not a
                # linear isin over the part's whole code set); an
                # empty intersection decides the part
                sel = np.zeros(len(chunk.uniq), bool)
                if len(f.codes):
                    pos = np.searchsorted(chunk.uniq, f.codes)
                    ok = pos < len(chunk.uniq)
                    pos = pos[ok]
                    sel[pos[chunk.uniq[pos] == f.codes[ok]]] = True
                if f.op == "ne":
                    if not sel.any():
                        continue   # nothing excluded
                    m = ~sel[take(chunk.local)]
                else:
                    if not sel.any():
                        return None   # eq/in can never match here
                    m = sel[take(chunk.local)]
                mask = _and_mask(mask, m)
            else:
                mask = _and_mask(mask, _cmp_encoded(
                    chunk, f.op, f.value, rows_sel))
        if mask is False:
            return None
        full = mask is True
        if not full and not mask.any():
            return None
        if prof is not None and prof.detail:
            # explain-only: the always-on slow-capture profiler must
            # not tax every query with an extra reduction
            prof.add_matched(int(n_rows if full else mask.sum()))

        def masked(arr: np.ndarray) -> np.ndarray:
            rows = take(arr)
            return rows if full else rows[mask]

        # group keys in LOCAL narrow space; remember how to widen the
        # survivors. When the groupBy is a PREFIX of the part's sort
        # key the rows are already key-clustered (local indices and
        # width-reduced ints are monotone in the decoded values, and
        # granule selection/masking preserve row order), so the kernel
        # can skip its lexsort — boundaries from one adjacent-row
        # comparison over the contiguous runs.
        presorted = bool(plan.group_by) and part.sort_key and \
            tuple(plan.group_by) == \
            tuple(part.sort_key[:len(plan.group_by)])
        key_cols: List[np.ndarray] = []
        widen: List[Tuple[str, object]] = []
        for name in plan.group_by:
            chunk = chunks[name]
            if hasattr(chunk, "uniq"):      # string column
                key_cols.append(masked(chunk.local).astype(np.int64))
                widen.append(("uniq", chunk.uniq))
            else:
                key_cols.append(masked(chunk.stored).astype(np.int64))
                widen.append(("base", chunk.base))
        n_masked = int(n_rows if full else mask.sum())
        keys = (np.stack(key_cols, axis=1) if key_cols
                else np.zeros((n_masked, 0), np.int64))
        values: Dict[str, np.ndarray] = {}
        for column in value_columns(specs):
            chunk = chunks[column]
            arr = masked(chunk.stored).astype(np.int64)
            if chunk.base:
                arr += chunk.base
            values[column] = arr
        uniq, aggs = kernels.aggregate(keys, values, specs,
                                       presorted=bool(presorted),
                                       device=self.device)
        # late materialization: widen only surviving group keys
        for j, (kind, aux) in enumerate(widen):
            if kind == "uniq":
                uniq[:, j] = aux[uniq[:, j]].astype(np.int64)
            elif aux:
                uniq[:, j] += aux
        return uniq, aggs

    def _cold_partial(self, plan, table, specs, part,
                      rows_sel: Optional[np.ndarray] = None,
                      prof: Optional[QueryProfiler] = None) -> Partial:
        """Cold part: stream through the bounded decode buffer,
        decoding ONLY the plan's columns from the self-contained part
        file, adopt the subset into table code space, evaluate, drop —
        the part is never promoted (chunks stay None, tier stays
        cold). The decode is in FILE (sort) order — aggregation is
        row-order-insensitive in exact int64, and for a sorted part
        this skips reading the rowid column and the un-permute
        entirely; `rows_sel` (granule indexes survive demotion) then
        slices the surviving granules' rows before evaluation."""
        # a plan touching NO columns (global count, no filters/window)
        # still needs the row count — carry one cheap numeric column
        cols = plan.columns_touched() or (table.schema[0].name,)
        with self._cold_sem:
            batch = table._decode_part_sorted(part, columns=cols)
            if rows_sel is not None:
                batch = batch.take(rows_sel)
            return self._decoded_partial(plan, table, specs, batch,
                                         prof)

    def _decoded_partial(self, plan, table, specs,
                         batch: ColumnarBatch,
                         prof: Optional[QueryProfiler] = None
                         ) -> Partial:
        """Table-coded batch (memtable, cold subset, lazy part):
        reference-style mask, kernel aggregation — global code space
        throughout, so the partial merges directly with the encoded
        ones."""
        mask = filter_mask(plan, batch, table.dicts)
        if prof is not None and prof.detail:
            prof.add_matched(int(mask.sum()))
        if not mask.any():
            return None
        if plan.group_by:
            keys = np.stack(
                [np.asarray(batch[g], np.int64)[mask]
                 for g in plan.group_by], axis=1)
        else:
            keys = np.zeros((int(mask.sum()), 0), np.int64)
        values = {c: np.asarray(batch[c], np.int64)[mask]
                  for c in value_columns(specs)}
        return kernels.aggregate(keys, values, specs, device=self.device)


# -- cross-store merge (sharded stores, cluster partials) ------------------

def merge_materialized(plan, table_results
                       ) -> Tuple[Optional[List[np.ndarray]],
                                  Optional[Dict[str, np.ndarray]]]:
    """Shards — and cluster peers — own independent dictionaries, so
    cross-store merging happens in MATERIALIZED key space: fold each
    partial's (decoded keys, lowered aggregates) into one dict keyed
    by the group tuple. Count/sum partials merge via sum, min via min,
    max via max — exactly, in int64 — so the merged result is
    bit-identical to a single-store execution over the union of the
    rows."""
    specs = lower_specs(plan)
    acc: Dict[tuple, List[int]] = {}
    for keys, aggs in table_results:
        if aggs is None:
            continue
        g = _n_groups(aggs)
        for i in range(g):
            kt = tuple(
                (k[i].item() if isinstance(k[i], np.generic)
                 else k[i]) for k in keys) if keys else ()
            vals = acc.get(kt)
            if vals is None:
                acc[kt] = [int(aggs[label][i])
                           for label, _, _ in specs]
                continue
            for j, (label, op, _) in enumerate(specs):
                v = int(aggs[label][i])
                if kernels.MERGE_OP[op] == "sum":
                    vals[j] += v
                elif kernels.MERGE_OP[op] == "min":
                    vals[j] = min(vals[j], v)
                else:
                    vals[j] = max(vals[j], v)
    if not acc:
        return None, None
    keys_out: List[np.ndarray] = []
    ordered = list(acc.keys())
    for j in range(len(plan.group_by)):
        vals = [kt[j] for kt in ordered]
        # numeric group keys must stay int64 — an object array
        # would make finalize's tie-break compare them as STRINGS
        # ('80' < '9'), diverging from the single-table engines
        if all(isinstance(v, (int, np.integer)) for v in vals):
            keys_out.append(np.asarray(vals, np.int64))
        else:
            keys_out.append(np.asarray(vals, dtype=object))
    aggs_out = {
        label: np.asarray([acc[kt][j] for kt in ordered], np.int64)
        for j, (label, _, _) in enumerate(specs)}
    return keys_out, aggs_out


def _n_groups(aggs: Dict[str, np.ndarray]) -> int:
    return len(next(iter(aggs.values()))) if aggs else 0
