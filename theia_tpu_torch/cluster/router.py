"""Ingest routing: forward decoded rows to their owner-shard node.

The reference fronts its shard grid with a Distributed table: an
insert lands anywhere, the engine re-routes each row to the shard that
owns its sharding key. The equivalent here: every peer in a routing
mesh (`--role peer`) accepts `POST /ingest`, splits the decoded batch
by the same stable destination hash the in-process detector shards use
(crc32 of the destination string into the peer-list order), keeps its
own rows, and forwards the rest as self-contained `TREC` record
payloads (the WAL record encoding — no stream delta chains, so any
node decodes them statelessly).

Exactly-once is BY CONSTRUCTION, not best-effort: a forwarded slice is
stamped `stream=<producer stream>@<origin node>, seq=<producer seq>` —
the origin's retry re-splits the batch identically (the hash is a pure
function of the rows), so each owner's dedup window resolves the
re-forward `duplicate:true`; the origin's own slice dedups under the
same `@<self>` sub-stream before touching store or detectors. The
producer-facing ack is recorded only after every slice landed, so a
crashed origin's retry settles every slice idempotently. Forwarding
reuses IngestClient wholesale: jittered capped backoff, Retry-After
honor, 5xx/transport retries — a routed retry storm behaves exactly
like a producer retry storm.

TREC payloads themselves are never re-routed (they are pre-routed by
their origin); a disagreeing peer list between nodes is a deployment
error the docs call out, not something the router loops on.
"""

from __future__ import annotations

import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..obs import metrics as _metrics
from ..obs import trace as _trace
from ..utils.env import env_int
from ..utils.logging import get_logger
from ..analysis.lockdep import named_lock

logger = get_logger("cluster")

_M_FWD_ROWS = _metrics.counter(
    "theia_router_forwarded_rows_total",
    "Rows forwarded to their owner-shard node", labelnames=("peer",))
_M_FWD_BATCHES = _metrics.counter(
    "theia_router_forwarded_batches_total",
    "Forwarded sub-batches, by outcome (ok / duplicate / failed)",
    labelnames=("result",))
_M_FWD_SECONDS = _metrics.histogram(
    "theia_router_forward_seconds",
    "Wall time of one forwarded sub-batch (send + owner ack)")
_M_LOCAL_ROWS = _metrics.counter(
    "theia_router_local_rows_total",
    "Rows this node owned and kept local")


class RouterForwardError(Exception):
    """A forwarded slice could not be acknowledged by its owner (after
    the client's full retry budget) — HTTP 503: the producer retries
    the whole batch; every already-landed slice resolves
    duplicate:true."""


class IngestRouter:
    """Splits decoded batches by owner node and forwards remote slices
    through per-peer IngestClients."""

    def __init__(self, cmap, token: str = "",
                 ca_cert: Optional[str] = None,
                 max_attempts: Optional[int] = None,
                 timeout: float = 30.0) -> None:
        from ..ingest.client import IngestClient
        self.cmap = cmap
        self.self_id = cmap.self_id
        self._client_cls = IngestClient
        self._token = token
        self._ca_cert = ca_cert
        self._timeout = timeout
        self.max_attempts = (env_int("THEIA_ROUTER_ATTEMPTS", 8)
                             if max_attempts is None
                             else int(max_attempts))
        self._clients: Dict[str, object] = {}
        self._clients_lock = named_lock("router.clients")
        self._pool = ThreadPoolExecutor(
            max_workers=max(2, 2 * len(cmap.order)),
            thread_name_prefix="theia-router")
        #: id(dict) -> (dict ref, owner index per code), grown lazily —
        #: each destination string is hashed ONCE; rows partition by a
        #: pure integer gather afterwards (the _dst_shard discipline)
        self._owner_lut: Dict[int, Tuple[object, np.ndarray]] = {}
        self.forwarded_rows = 0
        self.forward_failures = 0

    def close(self) -> None:
        self._pool.shutdown(wait=False)

    def _client(self, peer: str):
        with self._clients_lock:
            c = self._clients.get(peer)
            if c is None:
                c = self._clients[peer] = self._client_cls(
                    self.cmap.addr(peer), stream=f"router-{self.self_id}",
                    token=self._token, ca_cert=self._ca_cert,
                    timeout=self._timeout,
                    max_attempts=self.max_attempts)
            return c

    def sub_stream(self, stream: str) -> str:
        """The origin-scoped dedup namespace for forwarded (and local)
        slices of a producer batch: distinct origins forwarding the
        same producer stream id cannot collide on (stream, seq)."""
        return f"{stream}@{self.self_id}"

    # -- split -------------------------------------------------------------

    def split(self, batch) -> Tuple[object, List[Tuple[str, object]]]:
        """(local slice, [(peer, remote slice), ...]) by stable
        destination hash. Row order inside each slice is batch order —
        per-connection detector order is preserved on the owner."""
        n_peers = len(self.cmap.order)
        if n_peers <= 1 or "destinationIP" not in batch.columns:
            return batch, []
        codes = np.asarray(batch["destinationIP"], np.int64)
        d = batch.dicts.get("destinationIP")
        if d is None:
            return batch, []
        owners = self._owners_for(codes, d)
        self_i = self.cmap.order.index(self.self_id)
        out: List[Tuple[str, object]] = []
        if bool(np.all(owners == self_i)):
            return batch, []
        for i, peer in enumerate(self.cmap.order):
            if i == self_i:
                continue
            idx = np.flatnonzero(owners == i)
            if idx.size:
                out.append((peer, batch.take(idx)))
        local_idx = np.flatnonzero(owners == self_i)
        local = batch.take(local_idx)
        _M_LOCAL_ROWS.inc(len(local))
        return local, out

    def split_wire(self, wire) -> Optional[Tuple[bytes, List[
            Tuple[str, bytes, int]]]]:
        """Split an ENCODED TBLK column section by owner WITHOUT a
        full-batch decode: only the destinationIP column (plus its
        unique-string table) is decoded to compute owners; every slice
        — remote and local — is then cut by column GATHER on the
        encoded bytes (store/wire.py), so a 52-column batch never
        round-trips through decode→take→re-encode just to be
        forwarded. Remote slices are shipped as self-contained TREC
        payloads (exactly what `split`+`_send` produce, so owners
        cannot tell the paths apart).

        Returns None when no routing is needed — single-node mesh,
        no destination column, or every row already local — in which
        case the caller decodes the original payload whole; otherwise
        (local column section bytes, [(peer, TREC payload, rows)]).

        The owner LUT is keyed per dictionary; TBLK blocks carry fresh
        per-block dictionaries, so unlike the TFB2 path the LUT does
        not amortize across a stream — the per-request cost is one
        crc32 per unique destination, which the skipped re-encode
        repays many times over."""
        n_peers = len(self.cmap.order)
        if n_peers <= 1:
            return None
        from ..store import wire as _wirefmt
        from ..store.wal import RECORD_MAGIC, pack_table_header
        sub, end = _wirefmt.decode_columns(
            wire, 0, columns=frozenset(("destinationIP",)))
        if end != len(wire):
            raise _wirefmt.WireCorruption(
                f"block has {len(wire) - end} trailing bytes")
        d = sub.dicts.get("destinationIP")
        if "destinationIP" not in sub.columns or d is None:
            return None
        codes = np.asarray(sub["destinationIP"], np.int64)
        owners = self._owners_for(codes, d)
        self_i = self.cmap.order.index(self.self_id)
        if bool(np.all(owners == self_i)):
            return None
        thead = RECORD_MAGIC + pack_table_header("flows")
        remote: List[Tuple[str, bytes, int]] = []
        for i, peer in enumerate(self.cmap.order):
            if i == self_i:
                continue
            idx = np.flatnonzero(owners == i)
            if idx.size:
                parts, _ = _wirefmt.gather_parts(wire, idx)
                remote.append(
                    (peer, thead + b"".join(bytes(p) for p in parts),
                     int(idx.size)))
        local_idx = np.flatnonzero(owners == self_i)
        lparts, _ = _wirefmt.gather_parts(wire, local_idx)
        _M_LOCAL_ROWS.inc(int(local_idx.size))
        return b"".join(bytes(p) for p in lparts), remote

    def _owners_for(self, codes: np.ndarray, d) -> np.ndarray:
        """Owner peer INDEX per row. The per-dictionary LUT caches the
        hash of every code minted so far; dictionaries only grow, so
        the cache extends monotonically. The entry HOLDS the
        dictionary and verifies identity — keying by bare id() would
        let CPython reuse a reset stream's address and serve a stale
        LUT for a brand-new dictionary."""
        key = id(d)
        entry = self._owner_lut.get(key)
        lut = entry[1] if entry is not None and entry[0] is d else None
        have = 0 if lut is None else len(lut)
        need = int(codes.max()) + 1 if len(codes) else 0
        if have < need:
            order = self.cmap.order
            fresh = np.fromiter(
                (order.index(self.cmap.owner_of(s))
                 for s in d.decode(np.arange(have, need))),
                dtype=np.int64, count=need - have)
            lut = (fresh if lut is None
                   else np.concatenate([lut, fresh]))
            self._owner_lut[key] = (d, lut)
            if len(self._owner_lut) > 64:
                # stream resets mint fresh dictionaries; drop stale LUTs
                self._owner_lut = {key: (d, lut)}
        return lut[codes]

    # -- forward -----------------------------------------------------------

    def forward_all(self, remote: List[Tuple[str, object]],
                    stream: str, seq: Optional[int]) -> List:
        """Start one forward per remote slice; returns futures for
        `await_all`. The request thread's trace context is captured
        HERE (the pool workers run on other threads) so each forward's
        span — and the traceparent it stamps on the wire — joins the
        originating ingest trace."""
        sub = self.sub_stream(stream)
        ctx = _trace.current_context()
        return [self._pool.submit(self._send, peer, part, sub, seq,
                                  ctx)
                for peer, part in remote]

    def forward_all_wire(self, remote: List[Tuple[str, bytes, int]],
                         stream: str, seq: Optional[int]) -> List:
        """`forward_all` for `split_wire` output: the TREC payloads
        are already cut by column gather, so the pool workers only
        POST bytes."""
        sub = self.sub_stream(stream)
        ctx = _trace.current_context()
        return [self._pool.submit(self._send_payload, peer, payload,
                                  rows, sub, seq, ctx)
                for peer, payload, rows in remote]

    def _send(self, peer: str, part, sub_stream: str,
              seq: Optional[int], ctx=None) -> Dict[str, object]:
        from ..store.wal import RECORD_MAGIC, encode_record_body
        payload = RECORD_MAGIC + encode_record_body("flows", part)
        return self._send_payload(peer, payload, len(part),
                                  sub_stream, seq, ctx)

    def _send_payload(self, peer: str, payload: bytes, n_rows: int,
                      sub_stream: str, seq: Optional[int],
                      ctx=None) -> Dict[str, object]:
        import time as _time

        from ..utils.faults import fire as _fire_fault
        # the data plane is part of a partition drill too: a severed
        # link drops forwards exactly like replication and heartbeats
        _fire_fault("net.send", peer=peer, path="/ingest")
        _fire_fault("peer.partition", peer=peer, path="/ingest")
        t0 = _time.perf_counter()
        with _trace.child_span("router.forward", ctx, peer=peer,
                               rows=n_rows):
            out = self._client(peer).send(payload, seq=seq,
                                          stream=sub_stream)
        _M_FWD_SECONDS.observe(_time.perf_counter() - t0)
        _M_FWD_ROWS.labels(peer=peer).inc(n_rows)
        _M_FWD_BATCHES.labels(
            result="duplicate" if out.get("duplicate") else "ok").inc()
        return out

    def await_all(self, futures: List) -> Tuple[int, int]:
        """(remote rows acked, duplicate slices). Raises
        RouterForwardError when any slice exhausted its retry budget —
        the producer retries the whole batch and every landed slice
        resolves duplicate:true."""
        rows = 0
        dups = 0
        first_err: Optional[Exception] = None
        for fut in futures:
            try:
                out = fut.result()
                rows += int(out.get("rows") or 0)
                if out.get("duplicate"):
                    dups += 1
            except Exception as e:
                _M_FWD_BATCHES.labels(result="failed").inc()
                self.forward_failures += 1
                if first_err is None:
                    first_err = e
        if first_err is not None:
            raise RouterForwardError(
                f"forwarded slice not acknowledged by its owner: "
                f"{first_err}")
        self.forwarded_rows += rows
        return rows, dups

    def stats(self) -> Dict[str, object]:
        return {
            "peers": len(self.cmap.order),
            "self": self.self_id,
            "forwardedRows": self.forwarded_rows,
            "forwardFailures": self.forward_failures,
        }
