"""Cluster-wide scatter-gather query execution with partial-aggregate
pushdown.

PR 9 spreads ingested rows across the routing mesh by destination
hash; this module makes `/query` answer over ALL of them. The node
that receives a query becomes the **coordinator**: it fans the
normalized plan out to every live peer's `POST /query/partial`, each
peer executes the existing part-native engine locally and answers
**mergeable partials** — group keys plus count/sum/min/max columns
(`mean` stays lowered to sum+count, exactly like the sharded merge) —
and the coordinator merges them in materialized key space, applies
top-K ONCE, and serves the cluster-wide result. Per-group partials
ship, never rows: bytes on the wire are proportional to surviving
groups, so every node added multiplies query throughput instead of
multiplying transfer (the ARIMA_PLUS "push analytics into the store"
principle, applied across nodes; arXiv:1902.04143's in-DRAM
working-set argument says the hot data stays node-local, so
scatter-gather is the only shape that scales).

**Wire format (TQPF).** A partial response is a small envelope —
magic + version + JSON meta (node id, scan stats, store fingerprint) —
followed by ONE self-contained WAL record body (store/wal.py
`encode_record_body`): group-key columns (string keys ship their
unique strings + narrow local codes, numerics int64) plus one int64
column per lowered aggregate. The same encoding that ships WAL
frames and sealed parts ships query partials.

**Peer pruning.** Heartbeats piggyback each node's per-table time
min/max and row count (cluster/node.py `ping_doc`); a windowed query
skips peers whose data provably cannot overlap — before any fan-out
byte moves. Pruning decisions are as-of the peer's LAST HEARTBEAT
(bounded-staleness, like the cluster cache and follower reads): rows
a peer acked within the last heartbeat interval may be skipped by a
window that covers them. Two mitigations bound the exposure to that
one interval: a peer whose store is changing inside the bounds-scan
throttle window ships a bare fingerprint (no bounds) and is not
pruned at all, and the heartbeat cadence (THEIA_CLUSTER_HEARTBEAT,
default 1 s) is the hard ceiling on how stale a pruning decision can
be.

**Cluster result cache.** Complete results cache under (normalized
plan, local store fingerprint, membership epoch, per-peer store
fingerprints from the last heartbeat) — any peer's seal/merge/insert
moves its fingerprint and invalidates structurally within one
heartbeat; a peer going down or coming back bumps the membership
epoch. Partial results are never cached. Fingerprints are per PLAN
TABLE (heartbeats piggyback a per-table digest map): a scrape tick
moving a peer's `__metrics__` digest invalidates cached history
results without churning the flows caches.

**Degraded modes are first-class.** A down peer (no heartbeat inside
the liveness timeout) or a peer whose fan-out request fails/times out
yields `partial: true` with the missing peers named — or a 503 under
`THEIA_QUERY_STRICT=1`. Fan-out requests ride the per-peer
`net.send`/`peer.partition` fault sites, so partition drills sever
the read path with the data plane; `/query/partial` admits one rung
ahead of ingest on the PEER side too (a shed peer answers 429 and
degrades the coordinator to a partial result).
"""

from __future__ import annotations

import json
import os
import struct
import threading
import time
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..obs import metrics as _metrics
from ..obs import trace as _trace
from ..schema import FLOW_SCHEMA, ColumnarBatch, StringDictionary
from ..utils.env import env_float
from ..utils.logging import get_logger
from ..utils.pool import get_pool
from .engine import (
    _M_CACHE_HITS,
    _M_CACHE_MISSES,
    QueryCache,
    QueryEngine,
    QueryError,
    merge_materialized,
)
from .explain import SLOW_QUERIES, QueryProfiler
from .plan import QUERYABLE_TABLES, QueryPlan
from .result import empty_result, finalize, lower_specs
from ..analysis.lockdep import named_lock

logger = get_logger("query.distributed")

DEFAULT_FANOUT_TIMEOUT = 15.0

#: partial-frame envelope: magic, version, reserved, reserved,
#: JSON-meta length; the WAL record body follows the meta
_PF_MAGIC = b"TQPF"
_PF_HEADER = struct.Struct("<4sBBHI")

_M_FANOUT_SECONDS = _metrics.histogram(
    "theia_query_fanout_seconds",
    "End-to-end coordinator time for one distributed query (fan-out + "
    "local partial + merge + finalize; cache hits excluded)")
_M_FANOUT_BYTES = _metrics.counter(
    "theia_query_fanout_bytes_total",
    "Partial-frame bytes received from peers by this coordinator "
    "(proportional to surviving groups, never rows)")
_M_PEERS_QUERIED = _metrics.counter(
    "theia_query_peers_queried_total",
    "Peers that contributed a partial to a distributed query")
_M_PEERS_PRUNED = _metrics.counter(
    "theia_query_peers_pruned_total",
    "Peers skipped before fan-out because their heartbeat-reported "
    "time bounds (or empty store) provably cannot overlap the query")
_M_PEERS_FAILED = _metrics.counter(
    "theia_query_peers_failed_total",
    "Peers that were down or failed/timed out during fan-out "
    "(the query degraded to partial:true, or 503 under "
    "THEIA_QUERY_STRICT=1)")
_M_PARTIALS_SERVED = _metrics.counter(
    "theia_query_partials_served_total",
    "Partial-aggregate executions this node served to coordinators "
    "(POST /query/partial)")


class IncompleteResultError(Exception):
    """THEIA_QUERY_STRICT=1 and one or more peers could not contribute
    to a distributed query — HTTP 503: retry when the cluster heals
    (the default mode answers partial:true instead)."""


def strict_mode() -> bool:
    return os.environ.get("THEIA_QUERY_STRICT", "").strip().lower() \
        in ("1", "true", "yes", "on")


# -- the TQPF partial frame ------------------------------------------------

def pack_partial(meta: Dict[str, object], plan: QueryPlan,
                 keys: Optional[List[np.ndarray]],
                 aggs: Optional[Dict[str, np.ndarray]],
                 schema=None) -> bytes:
    """Serialize one node's partial: envelope meta + a WAL record body
    carrying the materialized group-key columns and one int64 column
    per LOWERED aggregate label. Self-contained — string keys ship
    their unique strings, so the coordinator decodes without any
    shared dictionary state. The schema defaults to the PLAN table's
    (a `__metrics__` plan groups by metric/labels/node/kind — string
    columns the flows schema doesn't know)."""
    from ..store.wal import encode_record_body
    if schema is None:
        schema = QUERYABLE_TABLES.get(plan.table,
                                      (FLOW_SCHEMA,))[0]
    specs = lower_specs(plan)
    string_cols = {c.name for c in schema if c.is_string}
    cols: Dict[str, np.ndarray] = {}
    dicts: Dict[str, StringDictionary] = {}
    for j, name in enumerate(plan.group_by):
        vals = (keys[j] if keys is not None
                else np.zeros(0, np.int64))
        if name in string_cols:
            d = StringDictionary()
            cols[name] = (d.encode([str(v) for v in vals])
                          if len(vals) else np.zeros(0, np.int32))
            dicts[name] = d
        else:
            cols[name] = np.asarray(vals, np.int64)
    for label, _, _ in specs:
        vals = (aggs[label] if aggs is not None
                else np.zeros(0, np.int64))
        cols[label] = np.asarray(vals, np.int64)
    body = encode_record_body("partial", ColumnarBatch(cols, dicts))
    header = json.dumps(meta).encode()
    return (_PF_HEADER.pack(_PF_MAGIC, 1, 0, 0, len(header))
            + header + body)


def unpack_partial(data: bytes
                   ) -> Tuple[Dict[str, object], ColumnarBatch]:
    """(meta, decoded partial batch). Raises QueryError on a frame
    that is not a TQPF partial (version skew, truncation, non-binary
    error body)."""
    from ..store.wal import WalCorruption, decode_record_body
    if len(data) < _PF_HEADER.size:
        raise QueryError("short partial frame")
    magic, ver, _, _, hlen = _PF_HEADER.unpack_from(data, 0)
    if magic != _PF_MAGIC or ver != 1:
        raise QueryError(
            f"bad partial frame magic/version ({magic!r} v{ver})")
    off = _PF_HEADER.size
    try:
        meta = json.loads(bytes(data[off:off + hlen]))
        _, batch = decode_record_body(bytes(data[off + hlen:]))
    except (ValueError, WalCorruption) as e:
        raise QueryError(f"undecodable partial frame: {e}")
    return meta, batch


def partial_from_batch(plan: QueryPlan, batch: ColumnarBatch
                       ) -> Tuple[Optional[List[np.ndarray]],
                                  Optional[Dict[str, np.ndarray]]]:
    """Decoded TQPF batch → the (keys, aggs) shape
    `merge_materialized` folds (string keys back to materialized
    strings, aggregates int64)."""
    specs = lower_specs(plan)
    if len(batch) == 0:
        return None, None
    keys = [(batch.strings(g) if g in batch.dicts
             else np.asarray(batch[g], np.int64))
            for g in plan.group_by]
    aggs = {label: np.asarray(batch[label], np.int64)
            for label, _, _ in specs}
    return keys, aggs


# -- peer pruning ----------------------------------------------------------

def _peer_table_fp(store_doc: Dict[str, object],
                   table: str) -> Optional[str]:
    """The digest a coordinator keys one peer's state on for a plan
    over `table`: the heartbeat's per-table digest when the peer
    ships one, else the legacy whole-store (flows) fingerprint —
    'maybe stale' beats 'never invalidates', and a peer reporting
    neither keeps the result uncacheable (the store guard)."""
    tables = store_doc.get("tables")
    if isinstance(tables, dict) and tables.get(table):
        return tables[table]
    return store_doc.get("fingerprint")


def peer_excluded(plan: QueryPlan,
                  store_doc: Optional[Dict[str, object]]) -> bool:
    """True when a peer's heartbeat-reported store state PROVES it can
    contribute nothing: zero rows, or time bounds that cannot overlap
    the plan's half-open window. Missing/partial state means 'maybe'
    — the peer is queried, never wrongly skipped. Heartbeat bounds
    and row counts describe the FLOWS tables only, so plans over any
    other table (`__metrics__`) never prune a peer here."""
    if plan.table != "flows":
        return False
    if not store_doc:
        return False
    if store_doc.get("rows") == 0:
        return True
    bounds = store_doc.get("bounds") or {}
    if plan.start is not None:
        mm = bounds.get(plan.time_column)
        if mm is not None and int(mm[1]) < plan.start:
            return True
    if plan.end is not None:
        mm = bounds.get(plan.end_column)
        if mm is not None and int(mm[0]) >= plan.end:
            return True
    return False


# -- the coordinator -------------------------------------------------------

class ClusterQueryCoordinator:
    """Scatter-gather executor for one node of the routing mesh: local
    partial + fan-out partials → exact merge → one finalize. Wired by
    TheiaManagerServer when the cluster role is `peer` (leader/
    follower topologies replicate the whole store, so their local
    engine already answers cluster-wide)."""

    def __init__(self, node, engine,
                 timeout: Optional[float] = None,
                 cache_bytes: Optional[int] = None) -> None:
        self.node = node
        self.engine = engine
        self.cmap = node.cmap
        self.transport = node.transport
        self.timeout = (
            env_float("THEIA_QUERY_FANOUT_TIMEOUT",
                      DEFAULT_FANOUT_TIMEOUT)
            if timeout is None else float(timeout))
        self.cache = QueryCache(cache_bytes)
        self.workers = max(2, len(self.cmap.order) - 1)
        self.fanouts = 0
        self.partial_results = 0
        self._lock = named_lock("query.coordinator")

    # -- execution ---------------------------------------------------------

    def execute(self, plan: QueryPlan,
                use_cache: bool = True,
                explain: bool = False,
                traceparent: Optional[str] = None,
                use_rollup: bool = True
                ) -> Dict[str, object]:
        """Coordinate one cluster-wide query. This is a trace ingress:
        the fan-out's `/query/partial` requests carry the minted (or
        adopted) context, so every peer's partial-execution spans join
        ONE cross-node trace. `explain=True` attaches the coordinator
        profile (per-peer timings/bytes/degraded reasons, merge and
        top-K time) without changing the result rows."""
        with _trace.ingress_span("query.request", engine="cluster",
                                 traceparent=traceparent) as sp:
            doc = self._execute_traced(plan, use_cache, explain,
                                       use_rollup)
            sp.attrs["groups"] = doc.get("groupCount")
            sp.attrs["cache"] = doc.get("cache")
            return doc

    def _execute_traced(self, plan: QueryPlan, use_cache: bool,
                        explain: bool,
                        use_rollup: bool = True) -> Dict[str, object]:
        t0 = time.perf_counter()
        others = self.cmap.others()
        epoch = self.cmap.membership_epoch()
        peer_store = {p: (self.cmap.peer_info(p).get("store") or {})
                      for p in others}
        pruned = [p for p in others
                  if peer_excluded(plan, peer_store[p])]
        candidates = [p for p in others if p not in pruned]
        live = [p for p in candidates if self.cmap.is_alive(p)]
        down = [p for p in candidates if p not in live]
        # fingerprints cover the PLAN's table set: the flows digest
        # never moves on a scrape tick, and the `__metrics__` digest
        # (heartbeat-piggybacked per table) moves on every one — so
        # cached history results invalidate within one heartbeat
        # while flows caches ignore the scrape churn entirely
        local_fp = self.engine.fingerprint(
            self.engine._tables(plan.table))
        key = (plan.normalized(), local_fp, epoch,
               bool(use_rollup),
               tuple(sorted((p, _peer_table_fp(peer_store[p],
                                               plan.table))
                            for p in others)))
        caching = use_cache and self.cache.max_bytes > 0
        if caching:
            hit = self.cache.lookup(key)
            if hit is not None:
                _M_CACHE_HITS.inc()
                doc = dict(hit)
                doc["cache"] = "hit"
                doc["tookMs"] = round(
                    (time.perf_counter() - t0) * 1000, 3)
                QueryEngine._stamp_trace(doc)
                if explain:
                    doc["profile"] = {
                        "engine": "cluster",
                        "cache": "hit",
                        "fingerprint":
                            self.engine.fingerprint_hash(local_fp),
                    }
                return doc
            _M_CACHE_MISSES.inc()
        if down and strict_mode():
            # guaranteed-incomplete: don't burn a full cluster scan
            # just to answer 503
            _M_PEERS_FAILED.inc(len(down))
            raise IncompleteResultError(
                f"distributed query incomplete: peers "
                f"{','.join(sorted(down))} down "
                f"(THEIA_QUERY_STRICT=1)")
        with self._lock:
            self.fanouts += 1
        prof = QueryProfiler.maybe(explain)
        # the pool workers run on other threads: hand them the trace
        # context so each peer fetch (and the traceparent it stamps)
        # joins this query's trace
        ctx = _trace.current_context()
        futs = []
        if live:
            pool = get_pool("query-fanout", self.workers)
            futs = [(p, pool.submit(self._fetch_partial, p, plan,
                                    ctx, use_rollup))
                    for p in live]
        # local partial executes on the coordinator thread while the
        # fan-out is in flight (sharing `prof`, so the local store's
        # per-part scanned/pruned detail lands in the profile)
        stats = {"rowsScanned": 0, "partsScanned": 0, "partsPruned": 0,
                 "granulesScanned": 0, "granulesSkipped": 0}
        results = [self.engine.execute_partial(plan, stats, prof,
                                               use_rollup)]
        failed: List[str] = []
        peer_errors: Dict[str, str] = {}
        bytes_shipped = 0
        for peer, fut in futs:
            try:
                meta, keys, aggs = fut.result()
            except Exception as e:
                failed.append(peer)
                peer_errors[peer] = f"{type(e).__name__}: {e}"
                logger.warning("partial from peer %s failed: %s: %s",
                               peer, type(e).__name__, e)
                continue
            bytes_shipped += int(meta.get("_bytes") or 0)
            for k in stats:
                stats[k] += int(meta.get(k) or 0)
            if prof is not None:
                prof.add_peer(
                    peer, "queried",
                    tookMs=round(float(meta.get("_tookMs") or 0.0), 3),
                    execMs=meta.get("execMs"),
                    bytes=int(meta.get("_bytes") or 0),
                    rowsScanned=int(meta.get("rowsScanned") or 0),
                    partsScanned=int(meta.get("partsScanned") or 0),
                    partsPruned=int(meta.get("partsPruned") or 0),
                    granulesScanned=int(
                        meta.get("granulesScanned") or 0),
                    granulesSkipped=int(
                        meta.get("granulesSkipped") or 0),
                    fingerprint=meta.get("fingerprint"))
            results.append((keys, aggs))
        missing = sorted(down + failed)
        if prof is not None:
            for p in pruned:
                prof.add_peer(p, "pruned",
                              bounds=(peer_store[p].get("bounds")
                                      or None))
            for p in down:
                prof.add_peer(p, "down",
                              reason="no heartbeat inside the "
                                     "liveness timeout")
            for p in failed:
                prof.add_peer(p, "failed", reason=peer_errors.get(p))
        _M_PEERS_QUERIED.inc(len(live) - len(failed))
        _M_PEERS_PRUNED.inc(len(pruned))
        _M_PEERS_FAILED.inc(len(missing))
        _M_FANOUT_BYTES.inc(bytes_shipped)
        if missing and strict_mode():
            raise IncompleteResultError(
                f"distributed query incomplete: peers "
                f"{','.join(missing)} unavailable "
                f"(THEIA_QUERY_STRICT=1)")
        t_merge = time.perf_counter()
        keys, aggs = merge_materialized(plan, results)
        t_fin = time.perf_counter()
        if aggs is None or not len(next(iter(aggs.values()))):
            rows, groups = empty_result(plan)
        else:
            rows, groups = finalize(plan, keys, aggs)
        if prof is not None:
            prof.phase("merge", t_fin - t_merge)
            prof.phase("finalize", time.perf_counter() - t_fin)
        took = time.perf_counter() - t0
        _M_FANOUT_SECONDS.observe(took)
        doc: Dict[str, object] = {
            "plan": plan.to_doc(),
            "rows": rows,
            "groupCount": groups,
            "rowsScanned": stats["rowsScanned"],
            "partsScanned": stats["partsScanned"],
            "partsPruned": stats["partsPruned"],
            "granulesScanned": stats["granulesScanned"],
            "granulesSkipped": stats["granulesSkipped"],
            "engine": "cluster",
            "peers": {
                "total": len(self.cmap.order),
                "queried": len(live) - len(failed),
                "pruned": len(pruned),
                "failed": len(missing),
            },
            "bytesShipped": bytes_shipped,
            "partial": bool(missing),
            "tookMs": round(took * 1000, 3),
            "cache": "miss" if caching else "off",
        }
        if missing:
            doc["missingPeers"] = missing
            with self._lock:
                self.partial_results += 1
        # cache only COMPLETE results whose key truly covers every
        # peer's state: a peer without a heartbeat-reported
        # fingerprint could change under an unchanged key — and never
        # the profile (a later hit would serve a stale per-peer story)
        if caching and not missing and all(
                _peer_table_fp(peer_store[p], plan.table)
                for p in others):
            self.cache.store(key, doc)
            doc = dict(doc)
        QueryEngine._stamp_trace(doc)   # before slow capture
        profile = None
        if prof is not None:
            profile = prof.doc(
                engine="cluster",
                cache=doc["cache"],
                fingerprint=self.engine.fingerprint_hash(local_fp),
                rowsScanned=stats["rowsScanned"],
                partsScanned=stats["partsScanned"],
                partsPruned=stats["partsPruned"],
                granulesScanned=stats["granulesScanned"],
                granulesSkipped=stats["granulesSkipped"],
                bytesShipped=bytes_shipped,
            )
            # the matched count (and any per-part detail) covers the
            # COORDINATOR'S local store only — peers profile their
            # own executions; label it so
            matched = profile.pop("rowsMatched", None)
            if matched is not None:
                profile["rowsMatchedLocal"] = matched
            SLOW_QUERIES.observe(plan, doc, prof, profile)
        if explain and profile is not None:
            doc["profile"] = profile
        return doc

    def _fetch_partial(self, peer: str, plan: QueryPlan, ctx=None,
                       use_rollup: bool = True):
        """One peer's partial over the cluster transport (persistent
        connection; `net.send`/`peer.partition` fault sites fire
        inside, so partition drills sever the read path too). Runs on
        a pool worker: `ctx` is the coordinator request's trace
        context, re-activated here so the wire request carries it."""
        t0 = time.perf_counter()
        with _trace.child_span("query.fanout", ctx, peer=peer):
            raw = self.transport.request_raw(
                peer, "/query/partial",
                data=json.dumps({"plan": plan.to_doc(),
                                 "rollup": bool(use_rollup)}).encode(),
                headers={"Content-Type": "application/json"},
                timeout=self.timeout)
        meta, batch = unpack_partial(raw)
        meta["_bytes"] = len(raw)
        meta["_tookMs"] = (time.perf_counter() - t0) * 1000
        keys, aggs = partial_from_batch(plan, batch)
        return meta, keys, aggs

    # -- operator surface --------------------------------------------------

    def stats(self) -> Dict[str, object]:
        """Doc for /healthz `query.distributed`."""
        with self._lock:
            fanouts = self.fanouts
            partials = self.partial_results
        return {
            "mode": "scatter-gather",
            "peers": len(self.cmap.order),
            "fanouts": fanouts,
            "partialResults": partials,
            "strict": strict_mode(),
            "fanoutTimeoutSeconds": self.timeout,
            "cache": self.cache.stats(),
        }


def serve_partial(engine, plan: QueryPlan,
                  node_id: str = "",
                  use_rollup: bool = True) -> bytes:
    """Server half of the fan-out (manager/api.py `/query/partial`):
    execute the local partial and pack the TQPF frame. The meta
    carries this node's scan stats (the coordinator sums them into
    the result doc) and its CURRENT store fingerprint."""
    t0 = time.perf_counter()
    stats = {"rowsScanned": 0, "partsScanned": 0, "partsPruned": 0,
             "granulesScanned": 0, "granulesSkipped": 0}
    keys, aggs = engine.execute_partial(plan, stats,
                                        use_rollup=use_rollup)
    _M_PARTIALS_SERVED.inc()
    meta: Dict[str, object] = {"node": node_id, **stats,
                               "fingerprint": engine.fingerprint_hash(
                                   engine.fingerprint(
                                       engine._tables(plan.table))),
                               "execMs": round(
                                   (time.perf_counter() - t0) * 1000,
                                   3)}
    return pack_partial(meta, plan, keys, aggs)
