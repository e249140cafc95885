"""Cluster membership: static seed config + heartbeat liveness.

The reference runs a fixed shards×replicas ClickHouse grid declared in
Helm values and coordinated by ZooKeeper (SURVEY.md §1); membership is
configuration, liveness is runtime. The same split here:

  * **Seed config** — `THEIA_CLUSTER_PEERS` / `--peers` names every
    node once, identically on every node (order matters: shard
    placement hashes into the PEER LIST ORDER, so two nodes with
    different orderings would route the same destination differently):

        THEIA_CLUSTER_PEERS="node0=http://10.0.0.1:11347,node1=http://10.0.0.2:11347"

    Bare addresses get positional ids (`node0`, `node1`, ...).
    `THEIA_CLUSTER_SELF` / `--node-id` names this node's entry.

  * **Liveness** — `HeartbeatLoop` probes every peer's
    `GET /cluster/ping` on a fixed interval; a peer whose last
    successful probe is older than `THEIA_CLUSTER_PEER_TIMEOUT`
    seconds is `down`. Probes ride the cluster transport, so the
    `net.send` / `peer.partition` fault sites sever them exactly like
    replication traffic — a partition drill takes liveness down WITH
    the data plane, never separately.

Placement: `owner_of(destination)` is the same stable crc32 placement
the in-process detector shards use (manager/ingest.py
`shard_of_destination`), lifted to the peer list — identical across
processes, restarts, and ingestion orders, so every node computes the
same owner without coordination.
"""

from __future__ import annotations

import threading
import time
import zlib
from typing import Callable, Dict, List, Optional, Tuple

from ..obs import metrics as _metrics
from ..utils.env import env_float
from ..utils.logging import get_logger
from ..analysis.lockdep import named_lock

logger = get_logger("cluster")

_M_PEER_UP = _metrics.gauge(
    "theia_cluster_peer_up",
    "1 while the peer's last heartbeat probe succeeded within the "
    "liveness timeout, else 0", labelnames=("peer",))
_M_HEARTBEATS = _metrics.counter(
    "theia_cluster_heartbeats_total",
    "Heartbeat probes sent, by outcome", labelnames=("result",))
_M_HEARTBEAT_RTT = _metrics.histogram(
    "theia_cluster_heartbeat_rtt_seconds",
    "Round-trip time of successful heartbeat probes, per peer — the "
    "cluster's live link-latency read (`theia top` renders the "
    "per-peer average in its cluster header)", labelnames=("peer",))


class ClusterConfigError(ValueError):
    """Malformed peer spec / unknown self id — fail at startup, not at
    the first forwarded batch."""


def parse_peers(spec: str) -> "List[Tuple[str, str]]":
    """`THEIA_CLUSTER_PEERS` grammar → ordered (node_id, base_url)
    pairs. Entries are `id=url` or bare `url` (positional ids
    `node<i>`); ids must be unique. The ORDER is part of the cluster
    contract (placement hashes into it)."""
    out: List[Tuple[str, str]] = []
    seen = set()
    for i, entry in enumerate(
            e.strip() for e in (spec or "").split(",")):
        if not entry:
            continue
        if "=" in entry.split("://", 1)[0]:
            node_id, _, addr = entry.partition("=")
            node_id = node_id.strip()
        else:
            node_id, addr = f"node{i}", entry
        addr = addr.strip().rstrip("/")
        if not addr.startswith(("http://", "https://")):
            raise ClusterConfigError(
                f"peer {entry!r}: address must be http(s)://host:port")
        if not node_id or node_id in seen:
            raise ClusterConfigError(
                f"peer {entry!r}: duplicate or empty node id")
        seen.add(node_id)
        out.append((node_id, addr))
    return out


class ClusterMap:
    """The static peer list + this node's identity + live heartbeat
    state. Thread-safe; the clock is injectable so liveness transitions
    are deterministic under test."""

    def __init__(self, peers: List[Tuple[str, str]], self_id: str,
                 peer_timeout: Optional[float] = None,
                 clock: Callable[[], float] = time.monotonic) -> None:
        if not peers:
            raise ClusterConfigError("empty peer list")
        ids = [p for p, _ in peers]
        if self_id not in ids:
            raise ClusterConfigError(
                f"--node-id {self_id!r} is not in the peer list "
                f"{ids}")
        self.peers: Dict[str, str] = dict(peers)
        self.order: List[str] = ids
        self.self_id = self_id
        self.peer_timeout = (
            env_float("THEIA_CLUSTER_PEER_TIMEOUT", 5.0)
            if peer_timeout is None else float(peer_timeout))
        self._clock = clock
        self._lock = named_lock("cluster.map")
        #: peer -> (last success monotonic, last ping doc)
        self._seen: Dict[str, Tuple[float, Dict[str, object]]] = {}
        self._last_err: Dict[str, str] = {}
        #: liveness-transition counter (see membership_epoch)
        self._epoch = 0
        self._alive_snap: Optional[Tuple[str, ...]] = None

    def others(self) -> List[str]:
        return [p for p in self.order if p != self.self_id]

    def addr(self, node_id: str) -> str:
        return self.peers[node_id]

    def owner_of(self, destination: str) -> str:
        """Stable owner node for a destination string — crc32 of the
        UTF-8 bytes into the peer-list order (the detector-shard
        placement, lifted to the cluster)."""
        h = zlib.crc32(destination.encode("utf-8", "surrogatepass"))
        return self.order[h % len(self.order)]

    # -- liveness ----------------------------------------------------------

    def mark_alive(self, peer: str,
                   info: Optional[Dict[str, object]] = None) -> None:
        with self._lock:
            self._seen[peer] = (self._clock(), dict(info or {}))
            self._last_err.pop(peer, None)
        _M_PEER_UP.labels(peer=peer).set(1)

    def mark_failed(self, peer: str, err: str) -> None:
        with self._lock:
            self._last_err[peer] = err
        if not self.is_alive(peer):
            _M_PEER_UP.labels(peer=peer).set(0)

    def is_alive(self, peer: str) -> bool:
        if peer == self.self_id:
            return True
        with self._lock:
            seen = self._seen.get(peer)
        return (seen is not None
                and self._clock() - seen[0] <= self.peer_timeout)

    def alive(self) -> List[str]:
        return [p for p in self.order if self.is_alive(p)]

    def membership_epoch(self) -> int:
        """Monotone counter of OBSERVED liveness transitions: any peer
        flipping alive ↔ down since the last call bumps it, so "the
        membership changed" is one integer comparison — the cluster
        query cache keys on it (query/distributed.py), and a peer
        coming back structurally invalidates every cached
        partial-coverage decision."""
        current = tuple(self.alive())
        with self._lock:
            if current != self._alive_snap:
                self._alive_snap = current
                self._epoch += 1
            return self._epoch

    def peer_info(self, peer: str) -> Dict[str, object]:
        with self._lock:
            seen = self._seen.get(peer)
            return dict(seen[1]) if seen else {}

    def snapshot(self) -> Dict[str, object]:
        """Operator view (served under /healthz `cluster.peers`)."""
        now = self._clock()
        out = []
        with self._lock:
            for p in self.order:
                seen = self._seen.get(p)
                doc: Dict[str, object] = {
                    "id": p, "addr": self.peers[p],
                    "self": p == self.self_id,
                }
                if p == self.self_id:
                    doc["up"] = True
                else:
                    doc["up"] = (seen is not None
                                 and now - seen[0] <= self.peer_timeout)
                    if seen is not None:
                        doc["lastSeenAgoSeconds"] = round(
                            now - seen[0], 3)
                        doc.update({k: v for k, v in seen[1].items()
                                    if k in ("role", "term",
                                             "appliedLsn", "lastLsn")})
                    if p in self._last_err:
                        doc["lastError"] = self._last_err[p]
                out.append(doc)
        return {"self": self.self_id, "peers": out}


class HeartbeatLoop:
    """Background liveness prober: `probe(peer)` → ping doc (raises on
    failure). The default probe is wired by ClusterNode to the cluster
    transport's GET /cluster/ping; tests inject both probe and clock
    and drive `beat_once()` directly — no sleeps."""

    def __init__(self, cmap: ClusterMap,
                 probe: Callable[[str], Dict[str, object]],
                 interval: Optional[float] = None,
                 on_seen: Optional[Callable[
                     [str, Dict[str, object]], None]] = None) -> None:
        self.cmap = cmap
        self.probe = probe
        self.interval = (env_float("THEIA_CLUSTER_HEARTBEAT", 1.0)
                         if interval is None else float(interval))
        self.on_seen = on_seen
        self.beats = 0
        #: peer -> last successful probe RTT in seconds (served under
        #: /healthz `cluster.heartbeatRttSeconds`)
        self.last_rtt: Dict[str, float] = {}
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def start(self) -> None:
        self._thread = threading.Thread(
            target=self._loop, daemon=True,
            name="theia-cluster-heartbeat")
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=10)

    def _loop(self) -> None:
        while not self._stop.wait(self.interval):
            try:
                self.beat_once()
            except Exception as e:   # keep beating after a bad pass
                logger.error("heartbeat pass failed: %s", e)

    def beat_once(self) -> List[str]:
        """Probe every other peer once; returns the ids that answered."""
        alive: List[str] = []
        for peer in self.cmap.others():
            t0 = time.perf_counter()
            try:
                info = self.probe(peer)
            except Exception as e:
                _M_HEARTBEATS.labels(result="failed").inc()
                self.cmap.mark_failed(peer, f"{type(e).__name__}: {e}")
            else:
                rtt = time.perf_counter() - t0
                _M_HEARTBEATS.labels(result="ok").inc()
                _M_HEARTBEAT_RTT.labels(peer=peer).observe(rtt)
                self.last_rtt[peer] = rtt
                self.cmap.mark_alive(peer, info)
                if self.on_seen is not None:
                    self.on_seen(peer, info)
                alive.append(peer)
        self.beats += 1
        return alive
