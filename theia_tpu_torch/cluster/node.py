"""ClusterNode: one manager's seat in the cluster.

Ties the membership map, heartbeat loop, and the role-specific plane
together behind the handful of hooks the manager needs:

  * role `leader`    — runs ReplicationLeader (WAL shippers toward
                       every other peer), provides the ingest
                       durability gate (quorum acks) and the
                       replication-lag admission signal.
  * role `follower`  — runs FollowerApplier (applies shipped frames /
                       resyncs), redirects `POST /ingest` to the
                       current leader (307 + Location), gates follower
                       reads on bounded staleness, and re-ingests a
                       divergent tail through the leader's dedup
                       window after a resync.
  * role `peer`      — routing mesh: every node accepts ingest and
                       runs IngestRouter (no replication plane).

Failover is WAL-delimited cutover: `POST /cluster/promote` on a
follower declares an LSN; the follower refuses (409) unless its
applied position covers it, then bumps the term and starts shipping to
the others. The demoted leader discovers the higher term through
heartbeats, steps down automatically, and its next handshake fails the
log-matching check → wholesale resync, with its unacked tagged tail
re-posted through the new leader's `/ingest` — acknowledged batches
resolve `duplicate:true` via the dedup window, unreplicated ones land.
Exactly the PR-5 exactly-once contract, operating across nodes.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Callable, Dict, List, Optional

from ..utils.env import env_float

from ..utils.logging import get_logger
from .membership import (
    ClusterConfigError,
    ClusterMap,
    HeartbeatLoop,
    parse_peers,
)
from .replication import (
    FollowerApplier,
    ReplicationLeader,
    StaleReadError,
)
from .router import IngestRouter, RouterForwardError
from .transport import ClusterTransport, PeerUnreachable
from ..analysis.lockdep import named_lock

logger = get_logger("cluster")

ROLES = ("leader", "follower", "peer")


class ClusterStateError(Exception):
    """A cluster control operation conflicts with this node's current
    state (promote below the applied LSN, promote on a leader, ...) —
    HTTP 409."""


def default_role() -> str:
    raw = (os.environ.get("THEIA_CLUSTER_ROLE", "") or "peer").strip()
    if raw not in ROLES:
        raise ClusterConfigError(
            f"THEIA_CLUSTER_ROLE {raw!r}: expected one of {ROLES}")
    return raw


class ClusterNode:
    """One node's cluster runtime. Constructed by TheiaManagerServer
    when a peer list is configured; `start()` after the HTTP socket is
    bound (peers probe us back), `stop()` on shutdown."""

    def __init__(self, db, ingest,
                 peers: Optional[str] = None,
                 self_id: Optional[str] = None,
                 role: Optional[str] = None,
                 token: str = "",
                 ca_cert: Optional[str] = None,
                 acks: Optional[str] = None,
                 heartbeat_interval: Optional[float] = None,
                 query_engine=None,
                 clock=None) -> None:
        spec = (peers if peers is not None
                else os.environ.get("THEIA_CLUSTER_PEERS", ""))
        parsed = parse_peers(spec)
        if not parsed:
            raise ClusterConfigError("empty --peers/THEIA_CLUSTER_PEERS")
        self_id = (self_id
                   or os.environ.get("THEIA_CLUSTER_SELF", "").strip()
                   or parsed[0][0])
        kwargs = {} if clock is None else {"clock": clock}
        self.cmap = ClusterMap(parsed, self_id, **kwargs)
        # the bounds-scan throttle rides the same injectable clock as
        # the heartbeat loop (tests step it without sleeping)
        self._clock = clock if clock is not None else time.monotonic
        self.db = db
        self.ingest = ingest
        self.role = role if role is not None else default_role()
        if self.role not in ROLES:
            raise ClusterConfigError(
                f"role {self.role!r}: expected one of {ROLES}")
        self._acks = acks
        self.term = 1
        self.token = token
        # Scatter-gather read path: heartbeats piggyback this node's
        # store fingerprint + time bounds so coordinators can cache
        # and prune (query/distributed.py). Optional — a node without
        # a query engine just pings without the store doc.
        self.query_engine = query_engine
        self._store_doc_cache: Optional[Dict[str, object]] = None
        self._store_doc_at = 0.0
        self._bounds_interval = env_float(
            "THEIA_CLUSTER_BOUNDS_INTERVAL", 5.0)
        self.transport = ClusterTransport(self.cmap, token=token,
                                          ca_cert=ca_cert)
        self._lock = named_lock("cluster.node")
        self.leader: Optional[ReplicationLeader] = None
        self.follower: Optional[FollowerApplier] = None
        self.router: Optional[IngestRouter] = None
        if self.role in ("leader", "follower"):
            self._require_replicable_db()
        if self.role == "leader":
            self.leader = self._make_leader()
        elif self.role == "follower":
            self.follower = self._make_follower()
        else:
            self.router = IngestRouter(self.cmap, token=token,
                                       ca_cert=ca_cert)
            if self.router is not None:
                ingest.router = self.router
        self.heartbeat = HeartbeatLoop(
            self.cmap,
            probe=lambda p: self.transport.request(p, "/cluster/ping"),
            interval=heartbeat_interval,
            on_seen=self._peer_seen)
        self._started = False

    def _require_replicable_db(self) -> None:
        if not callable(getattr(self.db, "wal_read_frames", None)):
            raise ClusterConfigError(
                "cluster replication roles need an UNWRAPPED "
                "FlowDatabase (no --shards/--replicas: cross-node "
                "shipping replaces the in-process fan-out; cross-node "
                "sharding is the router's job)")
        if self.db._wal is None:
            raise ClusterConfigError(
                "cluster replication requires --wal-dir (replication "
                "ships the WAL; there is nothing to ship without one)")

    def _make_leader(self) -> ReplicationLeader:
        dedup = getattr(self.ingest, "dedup", None)
        return ReplicationLeader(
            self.db, self.transport, followers=self.cmap.others(),
            acks=self._acks, term=self.term,
            dedup_dump=(dedup.dump if dedup is not None else None))

    def _make_follower(self) -> FollowerApplier:
        return FollowerApplier(
            self.db, dedup=getattr(self.ingest, "dedup", None))

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> None:
        with self._lock:
            if self._started:
                return
            self._started = True
        self.heartbeat.start()
        if self.leader is not None:
            self.leader.start()
        logger.info("cluster node %s up: role=%s peers=%s",
                    self.cmap.self_id, self.role,
                    ",".join(self.cmap.order))

    def stop(self) -> None:
        self.heartbeat.stop()
        if self.leader is not None:
            self.leader.stop()
        if self.router is not None:
            self.router.close()
        self.transport.close()

    # -- ingest-path hooks -------------------------------------------------

    def accepts_ingest(self) -> bool:
        return self.role != "follower"

    def leader_addr(self) -> Optional[str]:
        """Where a follower redirects producers (307 Location)."""
        if self.role == "leader":
            return self.cmap.addr(self.cmap.self_id)
        fol = self.follower
        if fol is not None and fol.leader_id in self.cmap.peers:
            return self.cmap.addr(fol.leader_id)
        # config fallback: the first peer is the conventional initial
        # leader until heartbeats teach us better
        others = self.cmap.others()
        return self.cmap.addr(others[0]) if others else None

    def durability_gate(self) -> None:
        """Called by the ingest path after the local insert leg
        (wired unconditionally — the role is checked HERE, so a
        follower promoted mid-flight starts enforcing the quorum):
        wake the shippers for the fresh append, then block the
        acknowledgement until the configured follower quorum holds the
        batch. Policy `leader` still gets the wake (sub-poll-interval
        shipping latency) without the wait."""
        leader = self.leader
        if leader is not None:
            leader.note_appended()
            leader.wait_durable(self.db.wal_position())

    def repl_lag(self) -> int:
        """Admission pressure signal: records the ack quorum is
        trailing behind the leader's log (leader role), or how stale
        this follower copy is (follower role)."""
        if self.leader is not None:
            return self.leader.quorum_lag()
        if self.follower is not None:
            return int(self.follower.staleness()["lagRecords"])
        return 0

    def check_query_staleness(self) -> None:
        if self.follower is not None:
            self.follower.check_read_staleness()

    # -- server-side handlers (wired by manager/api.py) --------------------

    def ping_doc(self) -> Dict[str, object]:
        doc: Dict[str, object] = {
            "node": self.cmap.self_id,
            "role": self.role,
            "term": self.current_term(),
            "appliedLsn": self.db.wal_position()
            if callable(getattr(self.db, "wal_position", None)) else None,
        }
        hs = getattr(self.db, "wal_handshake", None)
        if callable(hs):
            doc["wal"] = hs()
        if self.query_engine is not None:
            sd = self._store_ping_doc()
            if sd is not None:
                doc["store"] = sd
        return doc

    def _store_ping_doc(self) -> Optional[Dict[str, object]]:
        """Heartbeat piggyback for the scatter-gather read path: the
        CURRENT store fingerprint (coordinators key their cluster
        result cache on it — any insert/seal/merge here invalidates
        them within one heartbeat) plus per-table time bounds and row
        count (coordinators prune peers whose data cannot overlap a
        query window). The fingerprint is always fresh; the bounds
        scan is throttled to THEIA_CLUSTER_BOUNDS_INTERVAL — while a
        store is actively changing inside the throttle window only
        the bare fingerprint ships, so stale-narrow bounds can never
        wrongly prune this node. Per-table digests ride alongside
        (`tables`): coordinators key their cluster cache on the PLAN
        table's digest, so a scrape tick moving this node's
        `__metrics__` digest invalidates metrics-history results
        within one heartbeat without churning the flows digest that
        keys everything else."""
        try:
            fp = self.query_engine.fingerprint_hash()
            tfp = self.query_engine.table_fingerprints()
        except Exception:
            return None   # e.g. every replica down: peers skip pruning
        cached = self._store_doc_cache
        if cached is not None and cached.get("fingerprint") == fp:
            # bounds/rows describe the FLOWS tables only, so an
            # unchanged flows fingerprint keeps them valid — a scrape
            # tick refreshes just the per-table digest map instead of
            # re-running the O(rows) bounds scan every interval
            if cached.get("tables") != tfp:
                cached = dict(cached)
                cached["tables"] = tfp
                self._store_doc_cache = cached
            return cached
        now = self._clock()
        if cached is not None and \
                now - self._store_doc_at < self._bounds_interval:
            return {"fingerprint": fp, "tables": tfp}
        doc: Dict[str, object] = {"fingerprint": fp, "tables": tfp}
        try:
            rows = 0
            tabs: List[Dict[str, tuple]] = []
            for t in self.query_engine._tables():
                n = len(t)
                rows += n
                if n:
                    tb = getattr(t, "time_bounds", None)
                    tabs.append(tb() if callable(tb) else {})
            doc["rows"] = rows
            # a column's bounds are only safe when EVERY non-empty
            # table reported it — a shard with unknown bounds could
            # hold rows outside the others' range
            bounds: Dict[str, List[int]] = {}
            if tabs:
                for col in tabs[0]:
                    if all(col in tb for tb in tabs):
                        bounds[col] = [
                            int(min(tb[col][0] for tb in tabs)),
                            int(max(tb[col][1] for tb in tabs))]
            doc["bounds"] = bounds
        except Exception as e:
            logger.v(1).info("store bounds scan failed: %s", e)
        self._store_doc_cache = doc
        self._store_doc_at = now
        return doc

    def current_term(self) -> int:
        if self.follower is not None:
            return max(self.term, self.follower.leader_term)
        return self.term

    def handle_replicate(self, data: bytes,
                         headers) -> Dict[str, object]:
        term = int(headers.get("X-Theia-Term", "0") or 0)
        sender = headers.get("X-Theia-Node")
        if self.role == "leader":
            if term > self.term:
                # a newer leader exists: this node lost a failover it
                # never saw — step down and take the frames
                self.step_down(leader_id=sender, term=term)
            else:
                raise ClusterStateError(
                    f"node {self.cmap.self_id} is the leader "
                    f"(term {self.term}); not accepting replication "
                    f"from term {term}")
        if self.follower is None:
            raise ClusterStateError(
                f"role {self.role} does not accept replication")
        return self.follower.handle_replicate(
            data, algo=int(headers.get("X-Theia-Algo", "0") or 0),
            term=term,
            leader_lsn=int(headers.get("X-Theia-Leader-Lsn", "0") or 0),
            leader_id=sender)

    def handle_resync(self, data: bytes, headers) -> Dict[str, object]:
        sender = headers.get("X-Theia-Node")
        if self.role == "leader":
            term = 0
            try:
                from .replication import unpack_resync_stream
                term = int(unpack_resync_stream(data)[0].get("term")
                           or 0)
            except Exception:
                pass
            if term > self.term:
                self.step_down(leader_id=sender, term=term)
            else:
                raise ClusterStateError(
                    f"node {self.cmap.self_id} is the leader; not "
                    f"accepting a resync from term {term}")
        if self.follower is None:
            raise ClusterStateError(
                f"role {self.role} does not accept resyncs")
        out = self.follower.handle_resync(data, leader_id=sender)
        tail = self.follower.take_pending_tail()
        if tail and sender:
            self._schedule_tail_reingest(tail, sender)
        return out

    def promote(self, at_lsn: Optional[int] = None) -> Dict[str, object]:
        """WAL-delimited cutover: this follower becomes the leader at
        (at least) `at_lsn`. Refused unless the applied position
        covers the declared LSN — promoting an earlier copy would
        silently drop acknowledged records."""
        with self._lock:
            if self.role == "leader":
                raise ClusterStateError(
                    f"{self.cmap.self_id} is already the leader "
                    f"(term {self.term})")
            applied = self.db.wal_position() or 0
            if at_lsn is not None and applied < int(at_lsn):
                raise ClusterStateError(
                    f"cannot promote at LSN {at_lsn}: this follower "
                    f"has applied only {applied}")
            old_term = self.current_term()
            self.term = old_term + 1
            self.role = "leader"
            self.follower = None
            self.leader = self._make_leader()
            self.leader.term = self.term
            if self._started:
                self.leader.start()
        logger.warning(
            "node %s PROMOTED to leader at LSN %d (term %d)",
            self.cmap.self_id, applied, self.term)
        return {"node": self.cmap.self_id, "role": self.role,
                "term": self.term, "atLsn": applied}

    def step_down(self, leader_id: Optional[str],
                  term: int) -> None:
        """Demote this (stale) leader: a peer proved a higher term.
        The new leader's next handshake fails log matching → resync,
        and the divergent tagged tail re-ingests through its dedup
        window."""
        with self._lock:
            if self.role != "leader":
                return
            old = self.leader
            self.role = "follower"
            self.leader = None
            self.term = max(self.term, int(term))
            self.follower = self._make_follower()
            if leader_id:
                self.follower.leader_id = leader_id
                self.follower.leader_term = int(term)
        if old is not None:
            old.stop()
        logger.warning(
            "node %s STEPPED DOWN: peer %s leads at term %d",
            self.cmap.self_id, leader_id, term)

    def _peer_seen(self, peer: str, info: Dict[str, object]) -> None:
        """Heartbeat observation hook: a peer claiming leadership at a
        higher term demotes us (the healed-partition rejoin path); a
        follower learns who the current leader is for redirects."""
        try:
            role = info.get("role")
            term = int(info.get("term") or 0)
        except (TypeError, ValueError):
            return
        if role != "leader":
            return
        if self.role == "leader" and term > self.term:
            self.step_down(leader_id=peer, term=term)
            return
        fol = self.follower
        if fol is not None:
            with self._lock:
                # re-check under the lock: a racing promote() may have
                # just retired this follower object
                if self.follower is fol and term >= fol.leader_term:
                    fol.leader_id = peer
                    fol.leader_term = term

    # -- demoted-leader tail re-ingest -------------------------------------

    def _schedule_tail_reingest(self, tail: List[tuple],
                                leader_peer: str) -> None:
        t = threading.Thread(
            target=self._reingest_tail, args=(tail, leader_peer),
            daemon=True, name="theia-cluster-tail-reingest")
        t.start()

    def _reingest_tail(self, tail: List[tuple],
                       leader_peer: str) -> None:
        """Re-post every tagged batch from the pre-resync log through
        the current leader's /ingest: already-acknowledged batches
        resolve duplicate:true (the dedup window was replicated /
        resynced), unreplicated ones land — zero acked-row loss, zero
        duplication."""
        from ..ingest.client import IngestClient, IngestError
        from ..store.wal import RECORD_MAGIC
        try:
            addr = self.cmap.addr(leader_peer)
        except KeyError:
            logger.error("tail re-ingest: unknown leader %r",
                         leader_peer)
            return
        client = IngestClient(addr, stream="tail-reingest",
                              token=self.token)
        landed = dups = failed = 0
        for stream, seq, body in tail:
            try:
                out = client.send(RECORD_MAGIC + bytes(body), seq=seq,
                                  stream=stream)
            except (IngestError, Exception) as e:
                failed += 1
                logger.error("tail re-ingest (stream=%r seq=%s) "
                             "failed: %s", stream, seq, e)
                continue
            if out.get("duplicate"):
                dups += 1
            else:
                landed += 1
        logger.warning(
            "tail re-ingest through %s done: %d duplicate:true "
            "(already acknowledged), %d landed, %d failed",
            leader_peer, dups, landed, failed)

    # -- operator surface --------------------------------------------------

    def health_doc(self) -> Dict[str, object]:
        doc: Dict[str, object] = {
            "role": self.role,
            "term": self.current_term(),
            "peers": self.cmap.snapshot(),
        }
        rtts = dict(self.heartbeat.last_rtt)
        if rtts:
            doc["heartbeatRttSeconds"] = {
                p: round(v, 6) for p, v in sorted(rtts.items())}
        degraded = False
        others = self.cmap.others()
        down = [p for p in others if not self.cmap.is_alive(p)]
        if down:
            doc["peersDown"] = down
            degraded = True
        if self.leader is not None:
            repl = self.leader.stats()
            doc["replication"] = repl
            if any(f["status"] != "streaming"
                   for f in repl["followers"]):
                degraded = True
        if self.follower is not None:
            doc["replication"] = self.follower.stats()
        if self.router is not None:
            doc["router"] = self.router.stats()
        doc["degraded"] = degraded
        return doc
