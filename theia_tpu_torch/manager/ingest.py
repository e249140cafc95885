"""Live alerting: the detector (scoring) half of the manager's ingest
path.

Ports the scoring half of theia_tpu/manager/ingest.py. A decoded flow
batch (a TBLK block through store/wire.decode_block, say) goes to
`IngestManager.score_batch`, which remaps its key columns to
ingest-global codes, partitions its rows by destination shard and
advances the per-shard detectors — the heavy-hitter / DDoS sketch and
the per-connection EWMA anomaly engine. Callers publish the alerts on
the bounded ring (`push_alert`) that `recent_alerts` serves.

The request half — POST /ingest decode, admission, WAL, dedup, the
store insert pool, cluster routing, the working-set state tier — is
not ported yet.

Concurrency shape: detector state is partitioned by destination into
N_SHARDS independent shards (THEIA_INGEST_SHARDS, default
min(8, cores)). Two engines score them (THEIA_DETECTOR_ENGINE):
"sharded" scores shard by shard under per-shard locks; "fused" rides
the coalescing device pipeline (ingest/device_path.py); "auto" picks
fused on a CUDA device and sharded on the CPU.

Ordering guarantee: alerts are deterministic PER CONNECTION. A
destination always hashes to the same shard (a stable string hash),
the connection 6-tuple contains the destination, and a shard applies
one stream's batches in ack order.
"""

from __future__ import annotations

import collections
import os
import time
import zlib
from typing import Deque, Dict, List, Optional, Tuple

import numpy as np

from ..analysis.lockdep import named_lock
from ..analytics.heavy_hitters import HeavyHitterDetector
from ..analytics.streaming import StreamingDetector
from ..obs import metrics as _metrics
from ..schema import ColumnarBatch, DictionaryMapper, StringDictionary
from ..utils import get_logger
from ..utils.device import resolve_device
from ..utils.env import env_int

logger = get_logger("ingest")

# Shard-scored rows use the striped increment path: the caller holds
# the shard lock (or is the fused scorer), so stripe=shard.index has
# exactly one writer.
_M_SCORED = _metrics.counter(
    "theia_ingest_scored_rows_total",
    "Rows scored by the detector shards (striped per shard)")
_M_LOCK_MISS = _metrics.counter(
    "theia_ingest_shard_lock_misses_total",
    "Opportunistic shard-lock acquisitions that found the shard busy "
    "(the request moved on to a free shard)")
_M_LOCK_WAIT = _metrics.counter(
    "theia_ingest_shard_lock_waits_total",
    "Forced blocking shard-lock acquisitions (every remaining shard "
    "was busy — the convoy case)")

MAX_ALERTS = 1000

MAX_STREAMS = 64

#: selectable scoring engines (THEIA_DETECTOR_ENGINE)
DETECTOR_ENGINES = ("sharded", "fused", "auto")


def default_ingest_shards() -> int:
    """Detector shard count: THEIA_INGEST_SHARDS wins, else one shard
    per host core up to 8."""
    n = env_int("THEIA_INGEST_SHARDS", 0)
    if n <= 0:
        n = min(8, os.cpu_count() or 1)
    return max(1, n)


def default_detector_engine() -> str:
    name = os.environ.get("THEIA_DETECTOR_ENGINE", "").strip().lower()
    return name or "sharded"


class DetectorShard:
    """One independently-lockable partition of detector state: its own
    CMS/k-means heavy-hitter detector and its own EWMA slot table."""

    def __init__(self, index: int, heavy: HeavyHitterDetector,
                 streaming: StreamingDetector) -> None:
        self.index = index
        self.heavy = heavy
        self.streaming = streaming
        self.lock = named_lock("ingest.shard")


class IngestManager:
    """Shard-parallel detector scoring over decoded flow batches.

    `db` is the flow store of the request half, which is not ported
    yet: pass None. `device` (default "cuda") is where detector state
    lives; without CUDA the constructor raises unless device="cpu".
    """

    #: string key columns remapped to ingest-global codes before
    #: scoring (both detectors key on them; see _remap_global)
    GLOBAL_COLUMNS = ("sourceIP", "destinationIP")

    def __init__(self, db=None,
                 detector: Optional[HeavyHitterDetector] = None,
                 streaming: Optional[StreamingDetector] = None,
                 n_shards: Optional[int] = None,
                 engine: Optional[str] = None,
                 streaming_capacity: Optional[int] = None,
                 device="cuda") -> None:
        if db is not None:
            raise ValueError("the flow store is not ported yet: "
                             "IngestManager takes db=None")
        self.device = resolve_device(device)
        # Injected detector instances pin the manager to ONE shard
        # (there is a single state table to keep coherent).
        if detector is not None or streaming is not None:
            n_shards = 1
        elif n_shards is None:
            n_shards = default_ingest_shards()
        self.n_shards = max(1, int(n_shards))
        engine = (engine or default_detector_engine()).strip().lower()
        if engine not in DETECTOR_ENGINES:
            raise ValueError(
                f"unknown detector engine {engine!r} "
                f"(THEIA_DETECTOR_ENGINE): expected one of "
                f"{DETECTOR_ENGINES}")
        self.engine_requested = engine
        if engine == "auto":
            engine = "fused" if self.device.type == "cuda" else "sharded"
            logger.info("detector engine auto → %s", engine)
        self.engine_name = engine
        _stream_kwargs = ({"capacity": int(streaming_capacity)}
                          if streaming_capacity else {})
        self.shards: List[DetectorShard] = [
            DetectorShard(i,
                          detector if detector is not None
                          else HeavyHitterDetector(device=self.device),
                          streaming if streaming is not None
                          else StreamingDetector(device=self.device,
                                                 **_stream_kwargs))
            for i in range(self.n_shards)]
        # Last-published CMS total per shard: peers read these without
        # taking the owner's lock (an eventually-consistent cluster
        # total for heavy-hitter shares).
        self._shard_totals = np.zeros(self.n_shards, np.float64)
        self._fused = None
        if engine == "fused":
            from ..ingest.device_path import FusedDetectorEngine
            self._fused = FusedDetectorEngine(
                self.shards, self._shard_totals,
                on_scored=lambda n, stripe: _M_SCORED.inc(
                    n, stripe=stripe))
        # The alert ring has its own cheap lock: reading alerts never
        # waits behind scoring.
        self._alerts_lock = named_lock("ingest.alerts")
        self._alerts: Deque[Dict[str, object]] = collections.deque(
            maxlen=MAX_ALERTS)
        # Detector keys must be stable across streams; stream-local
        # dictionary codes are not, so the key columns re-encode
        # against these ingest-global dictionaries before scoring,
        # under their OWN lock.
        self._dict_lock = named_lock("ingest.dict")
        self._global_dicts: Dict[str, StringDictionary] = {
            c: StringDictionary() for c in self.GLOBAL_COLUMNS}
        self._mappers: Dict[str, DictionaryMapper] = {
            c: DictionaryMapper(self._global_dicts[c],
                                max_entries=2 * MAX_STREAMS)
            for c in self.GLOBAL_COLUMNS}
        # destination global code → shard, extended lazily as codes
        # are minted (each new destination string is hashed ONCE).
        self._dst_shard = np.zeros(1, np.int64)   # code 0: ""

    def close(self) -> None:
        """Stop the fused scorer, if any (idempotent)."""
        if self._fused is not None:
            self._fused.close()

    # -- detector leg ----------------------------------------------------

    def score_batch(self, batch: ColumnarBatch
                    ) -> Tuple[List, List[Dict[str, object]], int]:
        """Advance every shard whose keys appear in `batch`; returns
        (heavy-hitter alerts, described connection alerts, raw
        connection-alert count)."""
        if len(batch) == 0:
            return [], [], 0
        scored, shard_ids = self._remap_global(batch)
        if self._fused is not None:
            return self._fused.score(scored, shard_ids)
        hh_alerts: List = []
        raw_alerts: List[Tuple[DetectorShard, ColumnarBatch, Dict]] = []
        n_conn = 0
        # Opportunistic acquisition: score whichever touched shard is
        # free NOW, blocking only when every remaining shard is busy.
        # Slices of one batch hold disjoint key sets, so visit order
        # across shards is free; per-connection order is enforced by
        # the shard lock alone.
        pending: Deque = collections.deque(
            self._partition(scored, shard_ids))
        while pending:
            progressed = False
            for _ in range(len(pending)):
                shard, part = pending.popleft()
                if shard.lock.acquire(blocking=False):
                    try:
                        n_conn += self._score_shard(
                            shard, part, hh_alerts, raw_alerts)
                    finally:
                        shard.lock.release()
                    progressed = True
                else:
                    _M_LOCK_MISS.inc()
                    pending.append((shard, part))
            if not progressed and pending:
                _M_LOCK_WAIT.inc()
                shard, part = pending.popleft()
                with shard.lock:
                    n_conn += self._score_shard(
                        shard, part, hh_alerts, raw_alerts)
        # The ring keeps MAX_ALERTS; only the newest survive, so only
        # those are decoded — outside any shard lock.
        conn_alerts: List[Dict[str, object]] = []
        for shard, part, a in raw_alerts[-MAX_ALERTS:]:
            described = shard.streaming.describe_alert(part, a)
            # "row" is batch-local; meaningless once published
            described.pop("row", None)
            described["kind"] = "connection_anomaly"
            conn_alerts.append(described)
        return hh_alerts, conn_alerts, n_conn

    def _score_shard(self, shard: DetectorShard, part: ColumnarBatch,
                     hh_alerts: List,
                     raw_alerts: List[Tuple["DetectorShard",
                                            ColumnarBatch, Dict]]) -> int:
        """Advance ONE shard with its slice (caller holds shard.lock);
        appends heavy-hitter alerts and undecoded connection alerts,
        returns the raw connection-alert count."""
        _M_SCORED.inc(len(part), stripe=shard.index)
        extra = float(self._shard_totals.sum()
                      - self._shard_totals[shard.index])
        hh_alerts.extend(shard.heavy.update(part, extra_total=extra))
        self._shard_totals[shard.index] = shard.heavy.total_volume
        raw_conn = shard.streaming.ingest(part)
        raw_alerts.extend((shard, part, a) for a in raw_conn)
        return len(raw_conn)

    def _remap_global(self, batch: ColumnarBatch
                      ) -> Tuple[ColumnarBatch, Optional[np.ndarray]]:
        """Stream-local → ingest-global codes for the key columns, and
        the per-row shard assignment. Only the dictionary lock is
        held."""
        with self._dict_lock:
            gcols = {c: self._mappers[c].remap(batch[c],
                                               batch.dicts[c])
                     for c in self.GLOBAL_COLUMNS}
            dst_shard = (self._dst_shard_table()
                         if self.n_shards > 1 else None)
        scored = ColumnarBatch(
            {**batch.columns, **gcols},
            {**batch.dicts,
             **{c: self._global_dicts[c]
                for c in self.GLOBAL_COLUMNS}})
        shard_ids = (dst_shard[gcols["destinationIP"]]
                     if dst_shard is not None else None)
        return scored, shard_ids

    def _dst_shard_table(self) -> np.ndarray:
        """code → shard for every destination code minted so far
        (caller holds the dictionary lock). The hash is over the
        string bytes, not the code, so the assignment is stable across
        restarts and ingestion orders."""
        d = self._global_dicts["destinationIP"]
        have = len(self._dst_shard)
        if have < len(d):
            fresh = np.fromiter(
                (self.shard_of_destination(s)
                 for s in d.entries_since(have)),
                dtype=np.int64)
            self._dst_shard = np.concatenate([self._dst_shard, fresh])
        return self._dst_shard

    def shard_of_destination(self, destination: str) -> int:
        """Stable shard assignment for a destination string (crc32 of
        the UTF-8 bytes mod n_shards)."""
        return zlib.crc32(
            destination.encode("utf-8", "surrogatepass")) % self.n_shards

    def _partition(self, scored: ColumnarBatch,
                   shard_ids: Optional[np.ndarray]):
        """Yield (shard, slice) for each shard with rows in `scored`,
        in shard-index order; row order within a slice is batch
        order."""
        if shard_ids is None:
            yield self.shards[0], scored
            return
        for s in range(self.n_shards):
            idx = np.flatnonzero(shard_ids == s)
            if idx.size == 0:
                continue
            if idx.size == len(scored):
                yield self.shards[s], scored
                return
            yield self.shards[s], scored.take(idx)

    def detector_stats(self) -> Dict[str, object]:
        """Operator view of the sharded detector ensemble."""
        return {
            "shards": self.n_shards,
            "series": [s.streaming.n_series for s in self.shards],
            "droppedSeries": [s.streaming.dropped_series
                              for s in self.shards],
            "totalVolume": float(self._shard_totals.sum()),
        }

    def shard_liveness(self) -> Dict[str, object]:
        """Per-shard series occupancy plus a non-blocking lock probe
        (`busy`: a request held the shard's lock at sample time), and
        the engine's own stats."""
        per_shard = []
        for s in self.shards:
            acquired = s.lock.acquire(blocking=False)
            if acquired:
                s.lock.release()
            per_shard.append({
                "shard": s.index,
                "busy": not acquired,
                "series": int(s.streaming.n_series),
                "capacity": int(s.streaming.capacity),
                "droppedSeries": int(s.streaming.dropped_series),
            })
        engine: Dict[str, object] = {"name": self.engine_name}
        if self.engine_requested != self.engine_name:
            # only informative when auto resolved the name
            engine["requested"] = self.engine_requested
        if self._fused is not None:
            engine.update(self._fused.stats())
        return {
            "shards": self.n_shards,
            "engine": engine,
            "perShard": per_shard,
        }

    def push_alert(self, alert: Dict[str, object]) -> None:
        """Publish an alert onto the ring, stamped with the time."""
        with self._alerts_lock:
            self._alerts.appendleft({**alert, "time": time.time()})

    def recent_alerts(self, limit: int = 100) -> List[Dict[str, object]]:
        with self._alerts_lock:
            return list(self._alerts)[:max(limit, 0)]
