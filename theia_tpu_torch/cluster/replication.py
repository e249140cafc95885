"""WAL log-shipping replication: leader shippers, follower apply,
quorum acks, and part-manifest catch-up resync.

The PR-4 WAL was built self-contained (records carry their own string
dictionaries) precisely so a log written on one node replays on
another; this module ships it. Because frames ship byte-for-byte, the
TBLK zero-copy ingest path composes for free: a record whose body is
the producer's received column section journaled verbatim
(store/wire.py) replicates as those same bytes — the leader never
re-encodes, and the follower's log stays a byte-identical
continuation. One shipper thread per follower reads
raw frames from the leader's on-disk log above the follower's acked
LSN and POSTs them to the follower's `/cluster/replicate`; the
follower appends them VERBATIM to its own log (leader LSNs preserved —
its log is a byte-identical continuation, so `kill -9` + standard WAL
replay recovers a follower to an exact leader position) and applies
each record through the logical insert path (views update, dedup tags
seed the live window).

**Handshake (log matching).** Before streaming, the shipper verifies
the follower's (last LSN, last body CRC) against the leader's own
frame at that LSN. A match resumes frame shipping exactly there; a
mismatch, an unknown CRC, or a follower beyond the GC horizon
(WalShipGap) triggers a wholesale **resync**: the leader captures
(position, records) under its WAL quiesce latch — sealed cold parts
ship their file bodies verbatim, the PR-7 "ship sealed parts" path —
and the follower truncates, applies, resets its log to the leader's
position, and resumes frame shipping above it ("then the WAL tail").

**Ack quorum (THEIA_REPL_ACKS).** `leader` acknowledges after the
local WAL append alone; `quorum` waits until a majority of the
cluster (leader included) holds the batch's LSN; `all` waits for every
follower. The ingest path's durability gate calls `wait_durable(lsn)`
— a quorum that cannot be met within THEIA_REPL_ACK_TIMEOUT raises
ReplicationLagError (HTTP 503: retryable, the producer's retry is
idempotent via the dedup window). On the majority side of a partition
quorum still clears — degraded, not failed; the minority side refuses
acks rather than diverge.
"""

from __future__ import annotations

import json
import os
import struct
import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

from ..obs import metrics as _metrics
from ..obs import trace as _trace
from ..store.wal import WalShipGap
from ..utils.backoff import capped_backoff
from ..utils.env import env_float, env_int
from ..utils.logging import get_logger
from .transport import PeerUnreachable
from ..analysis.lockdep import named_condition, named_lock

logger = get_logger("cluster")

#: THEIA_REPL_ACKS values, least to most durable
ACK_POLICIES = ("leader", "quorum", "all")

#: resync stream envelope: magic, version, crc algo, reserved,
#: header-json length
_SNC_MAGIC = b"TSNC"
_SNC_HEADER = struct.Struct("<4sBBHI")
_SNC_REC = struct.Struct("<QI")        # body length, body crc

_M_SHIPPED_RECORDS = _metrics.counter(
    "theia_repl_shipped_records_total",
    "WAL records shipped to followers (counted per follower)")
_M_SHIPPED_BYTES = _metrics.counter(
    "theia_repl_shipped_bytes_total",
    "Raw frame bytes shipped to followers")
_M_ACKED = _metrics.gauge(
    "theia_repl_acked_lsn",
    "Highest LSN each follower has acknowledged (appended to its own "
    "log and applied)", labelnames=("peer",))
_M_LAG = _metrics.gauge(
    "theia_repl_lag_records",
    "Leader LSN minus the follower's acked LSN", labelnames=("peer",))
_M_RESYNCS = _metrics.counter(
    "theia_repl_resyncs_total",
    "Wholesale part-manifest catch-up resyncs shipped to followers")
_M_QUORUM_WAIT = _metrics.histogram(
    "theia_repl_quorum_wait_seconds",
    "Time the ingest ack path waited for the configured follower "
    "ack quorum")
_M_QUORUM_TIMEOUTS = _metrics.counter(
    "theia_repl_quorum_timeouts_total",
    "Ingest acks refused because the ack quorum could not be met in "
    "time (HTTP 503; the producer's retry is dedup-idempotent)")
_M_APPLIED_RECORDS = _metrics.counter(
    "theia_repl_applied_records_total",
    "Shipped WAL records applied on this node (follower side)")
_M_APPLIED_ROWS = _metrics.counter(
    "theia_repl_applied_rows_total",
    "Rows applied from shipped WAL records (follower side)")


class ReplicationLagError(Exception):
    """The configured ack quorum cannot be met right now (followers
    down/lagging/partitioned) — HTTP 503: retry later, the dedup
    window makes the retry idempotent."""


class StaleReadError(Exception):
    """A bounded-staleness follower read exceeded the staleness budget
    (HTTP 503 — read from the leader or retry after catch-up)."""


def default_ack_policy() -> str:
    raw = (os.environ.get("THEIA_REPL_ACKS", "") or "quorum").strip()
    if raw not in ACK_POLICIES:
        raise ValueError(
            f"THEIA_REPL_ACKS {raw!r}: expected one of {ACK_POLICIES}")
    return raw


def pack_resync_stream(position: int, position_crc: Optional[int],
                       term: int, records,
                       dedup_entries: List[Tuple[str, int, int]],
                       algo: int, crc_fn) -> bytes:
    """Serialize one wholesale resync: envelope header (position +
    handshake token + term + the leader's live dedup entries, so
    exactly-once survives a resync'd failover) followed by
    length-prefixed, checksummed record bodies."""
    header = json.dumps({
        "position": int(position),
        "positionCrc": position_crc,
        "term": int(term),
        "dedup": [[s, int(q), int(r)] for s, q, r in dedup_entries],
    }).encode()
    out = [_SNC_HEADER.pack(_SNC_MAGIC, 1, algo, 0, len(header)),
           header]
    for body in records:
        body = bytes(body)
        crc = (crc_fn(body, 0) & 0xFFFFFFFF) if crc_fn else 0
        out.append(_SNC_REC.pack(len(body), crc))
        out.append(body)
    return b"".join(out)


def unpack_resync_stream(data: bytes):
    """Inverse of pack_resync_stream: (header dict, body iterator)."""
    from ..store.wal import WalCorruption, _checksum_fn
    if len(data) < _SNC_HEADER.size:
        raise WalCorruption("short resync envelope")
    magic, ver, algo, _, hlen = _SNC_HEADER.unpack_from(data, 0)
    if magic != _SNC_MAGIC or ver != 1:
        raise WalCorruption("bad resync envelope magic/version")
    off = _SNC_HEADER.size
    header = json.loads(data[off:off + hlen])
    off += hlen
    crc_fn = _checksum_fn(algo)

    def bodies(off=off):
        while off < len(data):
            if off + _SNC_REC.size > len(data):
                raise WalCorruption("truncated resync record header")
            blen, crc = _SNC_REC.unpack_from(data, off)
            off += _SNC_REC.size
            if off + blen > len(data):
                raise WalCorruption("truncated resync record body")
            body = data[off:off + blen]
            if crc_fn is not None and \
                    (crc_fn(body, 0) & 0xFFFFFFFF) != crc:
                raise WalCorruption("resync record checksum mismatch")
            off += blen
            yield body

    return header, bodies()


class _Follower:
    """Leader-side state for one follower link."""

    def __init__(self, peer: str) -> None:
        self.peer = peer
        self.acked = -1            # -1 = handshake pending
        self.status = "handshake"  # handshake|streaming|resyncing|unreachable
        self.last_error: Optional[str] = None
        self.resyncs = 0
        self.shipped_records = 0
        self.fails = 0


class ReplicationLeader:
    """Ships this node's WAL to every follower; tracks acked LSNs;
    answers the ingest path's quorum waits."""

    def __init__(self, db, transport, followers: List[str],
                 acks: Optional[str] = None,
                 term: int = 1,
                 ack_timeout: Optional[float] = None,
                 ship_bytes: Optional[int] = None,
                 idle_wait: float = 0.05,
                 dedup_dump: Optional[Callable[[], List[tuple]]] = None,
                 clock: Callable[[], float] = time.monotonic) -> None:
        self.db = db
        self.transport = transport
        self.acks = acks if acks is not None else default_ack_policy()
        if self.acks not in ACK_POLICIES:
            raise ValueError(
                f"ack policy {self.acks!r}: expected one of "
                f"{ACK_POLICIES}")
        self.term = int(term)
        self.ack_timeout = (env_float("THEIA_REPL_ACK_TIMEOUT", 10.0)
                            if ack_timeout is None
                            else float(ack_timeout))
        if ship_bytes is None:
            # frames ship in batched POSTs up to this budget: every
            # frame pending when the shipper wakes rides ONE request
            # (one connection-pool roundtrip, one follower fsync),
            # which is what turns concurrent producers into larger
            # ship batches instead of more roundtrips. The old
            # THEIA_REPL_SHIP_BYTES spelling is honored for
            # deployments that pinned it.
            legacy = os.environ.get("THEIA_REPL_SHIP_BYTES")
            self.ship_bytes = (
                int(legacy) if legacy
                else env_int("THEIA_REPL_BATCH_BYTES", 256 << 10))
        else:
            self.ship_bytes = int(ship_bytes)
        self.idle_wait = idle_wait
        self.dedup_dump = dedup_dump
        self._clock = clock
        self._cond = named_condition("repl.leader")
        self._followers: Dict[str, _Follower] = {
            p: _Follower(p) for p in followers}
        self._stop = threading.Event()
        self._threads: List[threading.Thread] = []

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> None:
        for peer in self._followers:
            t = threading.Thread(
                target=self._ship_loop, args=(peer,), daemon=True,
                name=f"theia-repl-ship-{peer}")
            t.start()
            self._threads.append(t)

    def stop(self) -> None:
        self._stop.set()
        with self._cond:
            self._cond.notify_all()
        for t in self._threads:
            t.join(timeout=10)

    # -- ack bookkeeping ---------------------------------------------------

    def required_follower_acks(self) -> int:
        """Followers that must hold an LSN before it is quorum-durable:
        leader → 0; all → every follower; quorum → a majority of the
        whole cluster (leader included) minus the leader itself."""
        n_followers = len(self._followers)
        if self.acks == "leader" or n_followers == 0:
            return 0
        if self.acks == "all":
            return n_followers
        cluster = n_followers + 1
        return (cluster // 2 + 1) - 1

    def acked_followers(self, lsn: int) -> int:
        with self._cond:
            return sum(1 for f in self._followers.values()
                       if f.acked >= lsn)

    def note_appended(self) -> None:
        """Ingest-path hint that new records exist — wakes shippers
        without waiting out the idle poll."""
        with self._cond:
            self._cond.notify_all()

    def wait_durable(self, lsn: Optional[int],
                     timeout: Optional[float] = None) -> None:
        """Block until the configured quorum of followers acked `lsn`.
        Raises ReplicationLagError on timeout — the caller answers 503
        and the producer retries (idempotent via the dedup window)."""
        need = self.required_follower_acks()
        if need <= 0 or lsn is None:
            return
        lsn = int(lsn)
        deadline = self._clock() + (self.ack_timeout
                                    if timeout is None else timeout)
        t0 = time.perf_counter()
        with self._cond:
            self._cond.notify_all()   # wake shippers for this append
            while True:
                acked = sum(1 for f in self._followers.values()
                            if f.acked >= lsn)
                if acked >= need:
                    break
                left = deadline - self._clock()
                if left <= 0:
                    _M_QUORUM_TIMEOUTS.inc()
                    raise ReplicationLagError(
                        f"ack quorum not met: {acked}/{need} followers "
                        f"at LSN {lsn} within {self.ack_timeout:g}s "
                        f"(policy {self.acks})")
                self._cond.wait(min(left, 0.25))
        _M_QUORUM_WAIT.observe(time.perf_counter() - t0)

    def quorum_lag(self) -> int:
        """Lag of the follower that CLEARS the quorum (the `need`-th
        best acked): the admission plane's replication-pressure signal.
        A dead follower outside the quorum does not register — only
        risk to the ack path does."""
        need = self.required_follower_acks()
        if need <= 0:
            return 0
        pos = self.db.wal_position() or 0
        with self._cond:
            acked = sorted((f.acked for f in self._followers.values()),
                           reverse=True)
        mark = acked[need - 1] if need <= len(acked) else -1
        return max(0, int(pos) - max(mark, 0))

    # -- the shipper -------------------------------------------------------

    def _ship_loop(self, peer: str) -> None:
        f = self._followers[peer]
        while not self._stop.is_set():
            try:
                if f.acked < 0:
                    self._handshake(f)
                advanced = self._ship_once(f)
                f.fails = 0
                if not advanced:
                    with self._cond:
                        self._cond.wait(self.idle_wait)
            except _NeedsResync:
                try:
                    self._resync(f)
                    f.fails = 0
                except (PeerUnreachable, Exception) as e:
                    self._note_failure(f, e)
            except PeerUnreachable as e:
                self._note_failure(f, e)
            except Exception as e:      # keep the link alive
                self._note_failure(f, e)

    def _note_failure(self, f: _Follower, e: Exception) -> None:
        f.fails += 1
        f.status = "unreachable"
        f.last_error = f"{type(e).__name__}: {e}"
        # re-handshake after a disconnect: the follower may have
        # restarted (recovered from its own log) or been resynced
        with self._cond:
            f.acked = -1
            self._cond.notify_all()
        delay = capped_backoff(0.1, 5.0, f.fails)
        logger.v(1).info("replication to %s failed (%s); retry in "
                         "%.1fs", f.peer, e, delay)
        self._stop.wait(delay)

    def _handshake(self, f: _Follower) -> None:
        """Log-matching: resume streaming exactly where the follower's
        log ends, or declare a resync."""
        doc = self.transport.request(f.peer, "/cluster/ping")
        wal = doc.get("wal") or {}
        lsn = int(wal.get("lsn") or 0)
        crc = wal.get("crc")
        own = self.db.wal_position() or 0
        if lsn == 0:
            with self._cond:
                f.acked = 0
                self._cond.notify_all()
            f.status = "streaming"
            return
        if lsn > own or crc is None:
            raise _NeedsResync(
                f"follower at LSN {lsn} (crc {crc}) vs leader {own}")
        ours = self.db.wal_body_crc_at(lsn)
        if ours is None or int(ours) != int(crc):
            raise _NeedsResync(
                f"log mismatch at LSN {lsn}: follower crc {crc}, "
                f"leader {ours}")
        with self._cond:
            f.acked = lsn
            self._cond.notify_all()
        f.status = "streaming"
        logger.info("follower %s resumes frame shipping above LSN %d",
                    f.peer, lsn)

    def _ship_once(self, f: _Follower) -> bool:
        """Ship one batch of frames; returns True when the follower
        advanced (more may be pending)."""
        pos = self.db.wal_position() or 0
        if f.acked >= pos:
            f.status = "streaming"
            return False
        try:
            frames, last, algo = self.db.wal_read_frames(
                f.acked, max_bytes=self.ship_bytes)
        except WalShipGap as e:
            raise _NeedsResync(str(e))
        if not frames:
            return False
        # each ship batch is a trace root: the follower's apply span
        # joins it via the traceparent the transport stamps (minted
        # only when frames actually move — idle polls trace nothing)
        with _trace.ingress_span("repl.ship", peer=f.peer,
                                 bytes=len(frames)):
            doc = self.transport.request(
                f.peer, "/cluster/replicate", data=frames,
                headers={"Content-Type": "application/octet-stream",
                         "X-Theia-Algo": str(algo),
                         "X-Theia-Term": str(self.term),
                         "X-Theia-Leader-Lsn": str(pos)})
        if doc.get("needResync"):
            raise _NeedsResync(f"follower {f.peer} requested resync")
        acked = int(doc.get("ackedLsn") or 0)
        with self._cond:
            f.acked = max(f.acked, acked)
            self._cond.notify_all()
        f.status = "streaming"
        f.shipped_records += int(doc.get("applied") or 0)
        _M_SHIPPED_RECORDS.inc(int(doc.get("applied") or 0))
        _M_SHIPPED_BYTES.inc(len(frames))
        _M_ACKED.labels(peer=f.peer).set(f.acked)
        _M_LAG.labels(peer=f.peer).set(
            max(0, (self.db.wal_position() or 0) - f.acked))
        return True

    def _resync(self, f: _Follower) -> None:
        """Wholesale part-manifest catch-up: capture under the quiesce
        latch, ship parts + memtable + result tables + the live dedup
        window, land the follower at `position`, resume frames above."""
        from ..store.wal import _WRITE_ALGO, _write_crc
        f.status = "resyncing"
        logger.warning("resyncing follower %s wholesale (beyond frame "
                       "catch-up)", f.peer)
        position, position_crc, records = self.db.resync_export()
        dedup = (self.dedup_dump() if self.dedup_dump is not None
                 else [])
        payload = pack_resync_stream(position, position_crc, self.term,
                                     records, dedup, _WRITE_ALGO,
                                     _write_crc)
        with _trace.ingress_span("repl.resync", peer=f.peer,
                                 bytes=len(payload)):
            doc = self.transport.request(
                f.peer, "/cluster/resync", data=payload,
                headers={"Content-Type": "application/octet-stream"},
                timeout=max(self.transport.timeout, 120.0))
        acked = int(doc.get("ackedLsn") or 0)
        with self._cond:
            f.acked = acked
            self._cond.notify_all()
        f.status = "streaming"
        f.resyncs += 1
        _M_RESYNCS.inc()
        _M_ACKED.labels(peer=f.peer).set(acked)
        logger.info("follower %s resynced at LSN %d (%d resync bytes)",
                    f.peer, acked, len(payload))

    # -- operator surface --------------------------------------------------

    def stats(self) -> Dict[str, object]:
        pos = 0
        try:
            pos = self.db.wal_position() or 0
        except Exception:
            pass
        with self._cond:
            followers = [{
                "peer": f.peer,
                "ackedLsn": f.acked,
                "lag": max(0, pos - f.acked) if f.acked >= 0 else None,
                "status": f.status,
                "resyncs": f.resyncs,
                **({"lastError": f.last_error} if f.last_error else {}),
            } for f in self._followers.values()]
        return {
            "role": "leader",
            "term": self.term,
            "acks": self.acks,
            "requiredFollowerAcks": self.required_follower_acks(),
            "lastLsn": pos,
            "quorumLag": self.quorum_lag(),
            "followers": followers,
        }


class _NeedsResync(Exception):
    """Internal shipper signal: frame catch-up impossible, go
    wholesale."""


class FollowerApplier:
    """Follower-side server half: applies shipped frames / resync
    streams to the local store, seeds the live dedup window, and
    answers bounded-staleness read checks."""

    def __init__(self, db, dedup=None,
                 max_staleness: Optional[float] = None,
                 clock: Callable[[], float] = time.monotonic) -> None:
        self.db = db
        self.dedup = dedup
        self.max_staleness = (
            env_float("THEIA_REPL_MAX_STALENESS", 30.0)
            if max_staleness is None else float(max_staleness))
        self._clock = clock
        self._lock = named_lock("repl.follower")
        self.leader_lsn = 0
        self.leader_term = 0
        self.leader_id: Optional[str] = None
        self.last_contact: Optional[float] = None
        self.applied_rows = 0
        self.resyncs = 0
        #: divergent tail extracted by the last resync, for the caller
        #: (ClusterNode) to re-ingest through the new leader's dedup
        self.pending_tail: List[tuple] = []

    def handle_replicate(self, data: bytes, algo: int, term: int,
                         leader_lsn: int,
                         leader_id: Optional[str]) -> Dict[str, object]:
        from ..store.wal import WalError
        with self._lock:
            self.leader_term = max(self.leader_term, int(term))
            self.leader_lsn = max(self.leader_lsn, int(leader_lsn))
            self.leader_id = leader_id or self.leader_id
            self.last_contact = self._clock()
        try:
            out = self.db.apply_replicated_frames(data, algo)
        except WalError as e:
            # a gap (we missed a batch mid-stream) or closed log: ask
            # the leader to re-handshake/resync rather than 500
            logger.warning("replicate apply failed (%s); requesting "
                           "resync", e)
            return {"needResync": True,
                    "ackedLsn": self.db.wal_position() or 0}
        for stream, seq, rows, _total in out["acks"]:
            if self.dedup is not None:
                self.dedup.record(stream, seq, rows)
        with self._lock:
            self.applied_rows += int(out["rows"])
        if out["applied"]:
            _M_APPLIED_RECORDS.inc(int(out["applied"]))
            _M_APPLIED_ROWS.inc(int(out["rows"]))
        return {"ackedLsn": int(out["ackedLsn"]),
                "applied": int(out["applied"]),
                "rows": int(out["rows"])}

    def handle_resync(self, data: bytes,
                      leader_id: Optional[str]) -> Dict[str, object]:
        header, bodies = unpack_resync_stream(data)
        position = int(header.get("position") or 0)
        # extract the divergent tail BEFORE truncation: tagged batches
        # in our log that the new leader may never have seen re-ingest
        # through its dedup window (acked ones resolve duplicate:true)
        tail = []
        try:
            tail = self.db.wal_tail_tagged_records(0)
        except Exception as e:
            logger.error("tail extraction before resync failed: %s", e)
        rows = self.db.resync_apply(bodies, position,
                                    header.get("positionCrc"))
        if self.dedup is not None:
            for ent in header.get("dedup") or []:
                try:
                    stream, seq, n = ent[0], int(ent[1]), int(ent[2])
                except (TypeError, ValueError, IndexError):
                    continue
                self.dedup.record(stream, seq, n)
        with self._lock:
            self.leader_term = max(self.leader_term,
                                   int(header.get("term") or 0))
            self.leader_lsn = max(self.leader_lsn, position)
            self.leader_id = leader_id or self.leader_id
            self.last_contact = self._clock()
            self.resyncs += 1
            self.pending_tail = tail
        logger.warning(
            "resynced from leader at LSN %d: %d rows applied, %d "
            "tagged tail batches held for re-ingest", position, rows,
            len(tail))
        return {"ackedLsn": position, "rows": rows,
                "tailBatches": len(tail)}

    def take_pending_tail(self) -> List[tuple]:
        with self._lock:
            tail, self.pending_tail = self.pending_tail, []
        return tail

    # -- bounded-staleness reads -------------------------------------------

    def staleness(self) -> Dict[str, object]:
        with self._lock:
            applied = self.db.wal_position() or 0
            lag = max(0, self.leader_lsn - applied)
            age = (None if self.last_contact is None
                   else self._clock() - self.last_contact)
        return {"appliedLsn": applied, "leaderLsn": self.leader_lsn,
                "lagRecords": lag,
                "leaderContactAgeSeconds":
                    None if age is None else round(age, 3)}

    def check_read_staleness(self) -> None:
        """Gate a follower read: raise StaleReadError when this copy
        has not heard from the leader within the staleness budget
        (THEIA_REPL_MAX_STALENESS seconds; <= 0 disables — reads are
        then unbounded-staleness, the operator's call)."""
        if self.max_staleness <= 0:
            return
        with self._lock:
            age = (None if self.last_contact is None
                   else self._clock() - self.last_contact)
        if age is None or age > self.max_staleness:
            raise StaleReadError(
                f"follower read refused: no leader contact for "
                f"{'ever' if age is None else f'{age:.1f}s'} "
                f"(budget {self.max_staleness:g}s) — read from the "
                f"leader or retry after catch-up")

    def stats(self) -> Dict[str, object]:
        doc = self.staleness()
        with self._lock:
            doc.update({
                "role": "follower",
                "term": self.leader_term,
                "leader": self.leader_id,
                "appliedRows": self.applied_rows,
                "resyncs": self.resyncs,
                "maxStalenessSeconds": self.max_staleness,
            })
        return doc
