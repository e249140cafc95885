"""Device-resident scoring pipeline: cross-shard micro-batch
coalescing, one fused step per micro-batch, double-buffered
host↔device transfer.

Ports theia_tpu/ingest/device_path.py.

  1. **Coalescing.** Score requests from all producers land in a
     bounded queue; the scorer thread drains whatever is waiting (up
     to THEIA_FUSED_RING_ROWS rows) and gathers the key/value columns
     of every pending block directly from the decode output into
     reused staging buffers.
  2. **One fused step.** The whole coalesced micro-batch — every
     shard's slice — is scored by ops/fused_detector.fused_step, with
     per-connection StreamState (and the CMS/centroid state) staying
     on the device between micro-batches.
  3. **Double buffering.** Staging buffers alternate between two
     generations and a dispatched step's results are fetched only
     after the NEXT step has been dispatched, so host staging of batch
     N+1 overlaps device scoring of batch N. On CUDA the staging
     buffers are pinned and copied with non_blocking=True, so the
     copy runs after the call returns: each generation carries a CUDA
     event recorded behind its copies, and the generation is not
     refilled until that event has completed.

Alert parity: the per-shard math is the sharded engine's own, the
host-side slot mapping and tick bucketing are the same code
(StreamingDetector.build_plan), and shards are thresholded in index
order against the same eventually-consistent cross-shard totals — so
a producer that awaits each ack (one block per step) gets the same
alert stream from either engine.

Each resolved step is one `fused.step` span (obs/trace.py) on the
scorer thread: B1's stream tiles `(T, U, live)` a shard, the blocks and
rows coalesced, the step's device time (CUDA events, ms; null on the
CPU), and `links`, the trace ids of the sampled requests it scored; a
step that served none is not recorded.
"""

from __future__ import annotations

import collections
import queue as _queue
import threading
import time
import traceback
from concurrent.futures import Future
from concurrent.futures import TimeoutError as _FutureTimeout
from typing import Callable, Deque, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..analytics import heavy_hitters as _hh
from ..analytics.streaming import (
    CONNECTION_KEY_COLUMNS,
    StreamPlan,
    alert_record,
)
from ..obs import metrics as _metrics
from ..obs import trace as _trace
from ..ops import fused_detector as _ops
from ..utils import get_logger
from ..utils.env import env_float, env_int

logger = get_logger("device_path")

_M_STEP = _metrics.histogram(
    "theia_fused_step_seconds",
    "One fused scoring step: staging + the fused step over every "
    "shard's coalesced slice + result fetch")
_M_QDEPTH = _metrics.gauge(
    "theia_fused_queue_depth",
    "Score requests waiting for the fused pipeline (bounded queue)")
_M_ROWS = _metrics.histogram(
    "theia_fused_batch_rows", "Rows per coalesced fused step")
_M_BLOCKS = _metrics.histogram(
    "theia_fused_coalesced_blocks",
    "Decoded blocks coalesced into one fused step")
_M_STEPS = _metrics.counter(
    "theia_fused_steps_total", "Fused scoring steps dispatched")

#: positions of the IP columns within CONNECTION_KEY_COLUMNS
_KEY_SRC = CONNECTION_KEY_COLUMNS.index("sourceIP")
_KEY_DST = CONNECTION_KEY_COLUMNS.index("destinationIP")

#: decode-batch columns gathered besides the connection key
_EXTRA_COLUMNS = ("flowEndSeconds", "octetDeltaCount",
                  "packetDeltaCount")

#: mirror of manager/ingest.py MAX_ALERTS — only the newest survive
#: the ring, so only those are worth decoding
_MAX_DESCRIBED_ALERTS = 1000

#: recent step device times (ms, CUDA only) and alert latencies
#: kept for stats
_DEVICE_TIMES_KEPT = 4096


class _StagingPool:
    """Reused host staging buffers, double-buffered by generation.

    `get` hands out the prefix view of a power-of-two-capacity buffer
    keyed by (tag, trailing shape, dtype), so a steady workload never
    allocates. On CUDA the buffers are pinned. Two generations
    alternate; `advance` waits for the event recorded behind the
    previous use of the generation it switches to, so a buffer is
    never rewritten while an asynchronous copy may still read it.
    """

    def __init__(self, device: torch.device,
                 generations: int = 2) -> None:
        self._pinned = device.type == "cuda"
        self._gens: List[Dict[tuple, np.ndarray]] = [
            {} for _ in range(generations)]
        self._events: List[Optional[torch.cuda.Event]] = \
            [None] * generations
        self._live = 0
        self.hits = 0
        self.misses = 0

    def advance(self) -> None:
        self._live = (self._live + 1) % len(self._gens)
        ev = self._events[self._live]
        if ev is not None:
            ev.synchronize()
            self._events[self._live] = None

    def record(self) -> None:
        """Mark the live generation's copies as enqueued (CUDA)."""
        if self._pinned:
            ev = torch.cuda.Event()
            ev.record()
            self._events[self._live] = ev

    def get(self, tag, shape, dtype) -> np.ndarray:
        shape = tuple(shape)
        cap = (_hh.pad_bucket(shape[0], minimum=8),) + shape[1:]
        dtype = np.dtype(dtype)
        key = (tag, cap[1:], dtype.str)
        pool = self._gens[self._live]
        arr = pool.get(key)
        if arr is None or arr.shape[0] < cap[0]:
            arr = pool[key] = self._alloc(cap, dtype)
            self.misses += 1
        else:
            self.hits += 1
        return arr[:shape[0]]

    def _alloc(self, shape, dtype: np.dtype) -> np.ndarray:
        if not self._pinned:
            return np.empty(shape, dtype)
        nbytes = int(np.prod(shape)) * dtype.itemsize
        raw = torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)
        return raw.numpy().view(dtype).reshape(shape)


def _to_device(arr: np.ndarray, device: torch.device) -> torch.Tensor:
    """Host staging array → device tensor (asynchronous from pinned
    memory). uint32 travels as int32 of the same bits."""
    if arr.dtype == np.uint32:
        arr = arr.view(np.int32)
    t = torch.from_numpy(arr)
    if device.type == "cpu":
        return t
    return t.to(device, non_blocking=True)


class _ScoreItem:
    """One request's remapped batch waiting for (or riding) a step."""

    __slots__ = ("batch", "shard_rows", "future", "t_arrival", "rows",
                 "trace")

    def __init__(self, batch, shard_rows: Dict[int, Optional[np.ndarray]],
                 t_arrival: float,
                 trace: Optional[_trace.TraceContext] = None) -> None:
        self.batch = batch
        #: shard index -> row indices (None = every row of the batch)
        self.shard_rows = shard_rows
        self.future: Future = Future()
        self.t_arrival = t_arrival
        self.rows = len(batch)
        #: the request's trace context where it is sampled (else None),
        #: linked by its step
        self.trace = trace


class _ShardWork:
    """Host-side bookkeeping for one shard's slice of one step."""

    __slots__ = ("shard", "splan", "hplan", "times", "vals",
                 "item_of", "row_of", "segments", "dst", "n")

    def __init__(self, shard, splan, hplan, times, vals, item_of,
                 row_of, segments, dst, n) -> None:
        self.shard = shard
        self.splan = splan
        self.hplan = hplan
        self.times = times
        self.vals = vals
        self.item_of = item_of
        self.row_of = row_of
        #: [(item index, start, stop)] coalescing segments, item order
        self.segments = segments
        self.dst = dst
        self.n = n


class _Step:
    """A dispatched-but-unresolved fused step (the in-flight half of
    the double buffer). `events` brackets its device work on CUDA."""

    __slots__ = ("items", "work", "outputs", "t0", "events")

    def __init__(self, items, work, outputs, t0, events) -> None:
        self.items = items
        self.work = work
        self.outputs = outputs
        self.t0 = t0
        self.events = events


class FusedDetectorEngine:
    """Scoring engine behind IngestManager (THEIA_DETECTOR_ENGINE=
    fused): same DetectorShard state objects, same (hh_alerts,
    conn_alerts, n_conn) contract as the sharded score path, scored
    through the coalescing fused pipeline on the shards' device."""

    def __init__(self, shards: Sequence, shard_totals: np.ndarray,
                 on_scored: Optional[Callable[[int, int], None]] = None,
                 queue_capacity: Optional[int] = None,
                 max_step_rows: Optional[int] = None,
                 step_timeout: Optional[float] = None) -> None:
        if not shards:
            raise ValueError("fused engine needs at least one shard")
        alphas = {s.streaming.alpha for s in shards}
        vcols = {s.streaming.value_column for s in shards}
        if len(alphas) != 1 or len(vcols) != 1:
            raise ValueError(
                "fused engine requires a uniform detector config "
                f"across shards (alpha={alphas}, value={vcols})")
        devices = {d for s in shards
                   for d in (s.streaming.device, s.heavy.device)}
        if len(devices) != 1:
            raise ValueError("fused engine requires every shard on one "
                             f"device, got {sorted(map(str, devices))}")
        self.device: torch.device = next(iter(devices))
        self.shards = list(shards)
        self.alpha = float(next(iter(alphas)))
        self.value_column = next(iter(vcols))
        #: the injectable latency clock (tests pin it); alert latency
        #: is enqueue -> resolve, the whole pipeline a point traversed
        self.clock = self.shards[0].streaming.clock
        self._totals = shard_totals
        self._on_scored = on_scored
        self.queue_capacity = (queue_capacity
                               or env_int("THEIA_FUSED_QUEUE", 8))
        self.max_step_rows = (max_step_rows
                              or env_int("THEIA_FUSED_RING_ROWS",
                                         131072))
        self.step_timeout = (step_timeout
                             or env_float("THEIA_FUSED_STEP_TIMEOUT",
                                          120.0))
        self._queue: _queue.Queue = _queue.Queue(self.queue_capacity)
        self._staging = _StagingPool(self.device)
        self.steps = 0
        self.coalesced_blocks = 0
        #: device time of each recent step, ms (CUDA events around the
        #: step's copies and kernels; empty on the CPU)
        self.device_ms: Deque[float] = collections.deque(
            maxlen=_DEVICE_TIMES_KEPT)
        #: (T, U, live slots) of every stream tile handed to the fused
        #: step, counted from the host plans (what B1 was given)
        self.tiles: collections.Counter = collections.Counter()
        #: the alert latency of each recent item that raised connection
        #: alerts, s (the latency_s its alerts carry)
        self.alert_latency_s: Deque[float] = collections.deque(
            maxlen=_DEVICE_TIMES_KEPT)
        self._closed = threading.Event()
        self._thread = threading.Thread(
            target=self._run, daemon=True, name="theia-fused-scorer")
        self._thread.start()

    # -- public surface --------------------------------------------------

    def queue_depth(self) -> int:
        """Live pipeline backlog."""
        return self._queue.qsize()

    def stats(self) -> Dict[str, object]:
        """Operator view of the pipeline."""
        return {
            "queueDepth": self.queue_depth(),
            "queueCapacity": self.queue_capacity,
            "maxStepRows": self.max_step_rows,
            "steps": self.steps,
            "coalescedBlocks": self.coalesced_blocks,
            "device": str(self.device),
            "stagingHits": self._staging.hits,
            "stagingMisses": self._staging.misses,
        }

    def score(self, scored, shard_ids: Optional[np.ndarray]
              ) -> Tuple[List, List[Dict[str, object]], int]:
        """Queue one globally-remapped batch for the next fused step
        and wait for its slice of the results: (heavy-hitter alerts,
        described connection alerts, raw connection-alert count)."""
        if self._closed.is_set():
            raise RuntimeError("fused scoring engine is closed")
        if len(scored) == 0:
            return [], [], 0
        if shard_ids is None:
            shard_rows: Dict[int, Optional[np.ndarray]] = {0: None}
        else:
            shard_rows = {}
            for s in range(len(self.shards)):
                idx = np.flatnonzero(shard_ids == s)
                if idx.size:
                    shard_rows[s] = (None if idx.size == len(scored)
                                     else idx)
        item = _ScoreItem(scored, shard_rows, self.clock(),
                          _trace.current_context())
        try:
            self._queue.put(item, timeout=self.step_timeout)
        except _queue.Full:
            raise RuntimeError(
                f"fused scoring queue stalled (capacity "
                f"{self.queue_capacity}, no step completed in "
                f"{self.step_timeout:.0f}s)")
        _M_QDEPTH.set(self._queue.qsize())
        deadline = time.monotonic() + self.step_timeout
        while True:
            try:
                # short poll instead of one long wait: an item that
                # slipped into the queue after the scorer's final
                # straggler drain (score/close race) must fail fast
                return item.future.result(timeout=0.25)
            except _FutureTimeout:
                if not self._thread.is_alive() \
                        and not item.future.done():
                    raise RuntimeError(
                        "fused scoring engine closed")
                if time.monotonic() >= deadline:
                    raise RuntimeError(
                        f"fused scoring step not resolved within "
                        f"{self.step_timeout:.0f}s")

    def close(self, timeout: float = 10.0) -> None:
        """Stop the scorer (idempotent): queued work is still scored,
        then the thread exits; anything enqueued after close fails."""
        if self._closed.is_set() and not self._thread.is_alive():
            return
        try:
            self._queue.put_nowait(None)   # wake + mark closed
        except _queue.Full:
            self._closed.set()
        self._thread.join(timeout=timeout)
        self._closed.set()

    # -- scorer thread ---------------------------------------------------

    def _run(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.set_device(self.device)
        pending: Optional[_Step] = None
        while True:
            try:
                got = self._queue.get(timeout=0.05)
            except _queue.Empty:
                if pending is not None:
                    self._finish(pending)
                    pending = None
                if self._closed.is_set():
                    break
                continue
            if got is None:
                self._closed.set()
                continue
            items = [got]
            rows = got.rows
            # Coalesce whatever else is already waiting (bounded by
            # the ring row capacity) into ONE step.
            while rows < self.max_step_rows:
                try:
                    nxt = self._queue.get_nowait()
                except _queue.Empty:
                    break
                if nxt is None:
                    self._closed.set()
                    break
                items.append(nxt)
                rows += nxt.rows
            _M_QDEPTH.set(self._queue.qsize())
            try:
                step = self._dispatch(items, rows)
            except Exception as e:   # noqa: BLE001 — fail the batch, not the loop
                logger.error("fused step dispatch failed: %s\n%s", e,
                             traceback.format_exc())
                for it in items:
                    if not it.future.done():
                        it.future.set_exception(e)
                if pending is not None:
                    # the failed dispatch already advanced the staging
                    # generation, so the NEXT dispatch would land back
                    # on the pending step's buffers — resolve it first
                    self._finish(pending)
                    pending = None
                continue
            # Double buffer: resolve the PREVIOUS step only after this
            # one is in flight.
            if pending is not None:
                self._finish(pending)
            pending = step
            if self._queue.empty():
                # idle: don't sit on results waiting for traffic
                self._finish(pending)
                pending = None
        if pending is not None:
            self._finish(pending)
        # fail any stragglers enqueued after close
        while True:
            try:
                it = self._queue.get_nowait()
            except _queue.Empty:
                break
            if it is not None and not it.future.done():
                it.future.set_exception(
                    RuntimeError("fused scoring engine closed"))

    def _dispatch(self, items: List[_ScoreItem],
                  total_rows: int) -> Optional[_Step]:
        t0 = time.perf_counter()
        self._staging.advance()
        dev = self.device
        work: List[_ShardWork] = []
        states = []
        host_inputs = []
        for s, shard in enumerate(self.shards):
            segments: List[Tuple[int, Optional[np.ndarray], int, int]] = []
            n_s = 0
            for ii, it in enumerate(items):
                if s not in it.shard_rows:
                    continue
                idx = it.shard_rows[s]
                cnt = len(it.batch) if idx is None else len(idx)
                if cnt == 0:
                    continue
                segments.append((ii, idx, n_s, n_s + cnt))
                n_s += cnt
            if n_s == 0:
                continue

            def st(tag, shape, dtype, _s=s):
                return self._staging.get((_s, tag), shape, dtype)

            # Direct gather from the decode output into the staging
            # ring: only the columns the detectors read.
            k6 = st("k6", (n_s, len(CONNECTION_KEY_COLUMNS)), np.int64)
            vals = st("vals", (n_s,), np.float64)
            times = st("times", (n_s,), np.int64)
            oct64 = st("oct", (n_s,), np.float64)
            pkt64 = st("pkt", (n_s,), np.float64)
            item_of = st("item", (n_s,), np.int32)
            row_of = st("row", (n_s,), np.int64)
            for ii, idx, a, b in segments:
                cols = items[ii].batch.columns
                for j, c in enumerate(CONNECTION_KEY_COLUMNS):
                    col = cols[c]
                    k6[a:b, j] = col if idx is None else col[idx]
                for buf, name in (
                        (vals, self.value_column),
                        (times, _EXTRA_COLUMNS[0]),
                        (oct64, _EXTRA_COLUMNS[1]),
                        (pkt64, _EXTRA_COLUMNS[2])):
                    col = cols[name]
                    buf[a:b] = col if idx is None else col[idx]
                item_of[a:b] = ii
                if idx is None:
                    row_of[a:b] = np.arange(b - a)
                else:
                    row_of[a:b] = idx
            splan = shard.streaming.build_plan(k6, vals, staging=st)
            if splan is None:
                # every row's series was dropped (capacity overflow):
                # the heavy-hitter half still advances, the streaming
                # half rides an all-padding tile that touches nothing
                splan = StreamPlan(
                    slots=np.full(64, shard.streaming.capacity,
                                  np.int32),
                    x=np.zeros((1, 64), np.float32),
                    active=np.zeros((1, 64), bool),
                    row_idx=np.full((1, 64), -1, np.int64),
                    present=np.zeros(0, np.int64))
            hplan = _hh.build_hh_plan(
                k6[:, _KEY_DST], k6[:, _KEY_SRC], oct64, pkt64,
                staging=st)
            self.tiles[(*splan.x.shape, len(splan.present))] += 1
            states.append(_ops.ShardStepState(
                shard.streaming.state, shard.heavy.cms,
                shard.heavy.kmeans))
            host_inputs.append((splan.slots, splan.x, splan.active,
                                hplan.keys, hplan.vols, hplan.q,
                                hplan.feats, hplan.valid))
            work.append(_ShardWork(shard, splan, hplan, times, vals,
                                   item_of, row_of, segments,
                                   k6[:, _KEY_DST], n_s))
        if not work:
            for it in items:
                if not it.future.done():
                    it.future.set_result(([], [], 0))
            return None
        events = None
        if dev.type == "cuda":
            events = (torch.cuda.Event(enable_timing=True),
                      torch.cuda.Event(enable_timing=True))
            events[0].record()
        inputs = tuple(
            _ops.ShardInputs(*(_to_device(a, dev) for a in arrays))
            for arrays in host_inputs)
        self._staging.record()
        new_states, outputs = _ops.fused_step(tuple(states), inputs,
                                              alpha=self.alpha)
        if events is not None:
            events[1].record()
        # State stays device-resident between micro-batches (the
        # stream half updated it in place; CMS/k-means are new).
        for w, ns in zip(work, new_states):
            w.shard.streaming.state = ns.stream
            w.shard.heavy.cms = ns.cms
            w.shard.heavy.kmeans = ns.km
        self.steps += 1
        self.coalesced_blocks += len(items)
        _M_STEPS.inc()
        _M_BLOCKS.observe(len(items))
        _M_ROWS.observe(total_rows)
        return _Step(items, work, outputs, t0, events)

    @staticmethod
    def _fetch(outputs) -> List[_ops.ShardOutputs]:
        return [_ops.ShardOutputs(
            anomaly=o.anomaly.cpu().numpy(), est=o.est.cpu().numpy(),
            total=o.total.item(), dist=o.dist.cpu().numpy())
            for o in outputs]

    def _finish(self, step: Optional[_Step]) -> None:
        if step is None:
            return
        items = step.items
        try:
            outs = self._fetch(step.outputs)
            dt = time.perf_counter() - step.t0
            _M_STEP.observe(dt)
            device_ms = None
            if step.events is not None:
                step.events[1].synchronize()
                device_ms = step.events[0].elapsed_time(step.events[1])
                self.device_ms.append(device_ms)
            links = [it.trace.trace_id for it in items
                     if it.trace is not None]
            if links and _metrics.enabled():
                # only a step that served a sampled request is kept
                _trace.record(
                    "fused.step", time.time() - dt, dt,
                    tiles=[(*w.splan.x.shape, len(w.splan.present))
                           for w in step.work],
                    blocks=len(items), rows=sum(it.rows for it in items),
                    device_ms=device_ms, links=links)
            now = self.clock()
            per_hh: List[List] = [[] for _ in items]
            per_conn: List[List] = [[] for _ in items]
            per_n = [0] * len(items)
            dst_dict = None
            for it in items:
                d = it.batch.dicts.get("destinationIP")
                if d is not None:
                    dst_dict = d
                    break
            # Shards threshold in index order (work is built that
            # way): shard s sees this step's fresh totals for shards
            # < s and the previous totals for shards > s.
            for w, out in zip(step.work, outs):
                if self._on_scored is not None:
                    self._on_scored(w.n, w.shard.index)
                extra = float(self._totals.sum()
                              - self._totals[w.shard.index])
                hits = w.shard.heavy.threshold(
                    w.hplan, out.est, out.total, out.dist, extra,
                    dst_dict)
                self._totals[w.shard.index] = \
                    w.shard.heavy.total_volume
                for alert, row, code in hits:
                    if row >= 0:
                        # shape outlier: row-scoped, exact attribution
                        per_hh[int(w.item_of[row])].append(alert)
                    else:
                        # heavy hitter: batch-scoped — attribute to
                        # every coalesced block that carried the
                        # destination
                        for ii, _, a, b in w.segments:
                            if np.any(w.dst[a:b] == code):
                                per_hh[ii].append(alert)
                anom = out.anomaly
                if anom.any():
                    for t, c in np.argwhere(anom):
                        r = int(w.splan.row_idx[t, c])
                        if r < 0:
                            continue
                        ii = int(w.item_of[r])
                        per_n[ii] += 1
                        per_conn[ii].append(
                            (w, r, int(w.splan.present[c])))
            for ii, it in enumerate(items):
                latency = now - it.t_arrival
                if per_conn[ii]:
                    self.alert_latency_s.append(latency)
                conn: List[Dict[str, object]] = []
                # newest-survive cap, mirroring the sharded path's
                # per-request MAX_ALERTS decode bound
                for w, r, slot in per_conn[ii][-_MAX_DESCRIBED_ALERTS:]:
                    row = int(w.row_of[r])
                    d = alert_record(slot, w.times[r], w.vals[r],
                                     latency)
                    for c in CONNECTION_KEY_COLUMNS:
                        cd = it.batch.dicts.get(c)
                        code = int(it.batch[c][row])
                        d[c] = (cd.decode_one(code)
                                if cd is not None else code)
                    d["kind"] = "connection_anomaly"
                    conn.append(d)
                if not it.future.done():
                    it.future.set_result(
                        (per_hh[ii], conn, per_n[ii]))
        except Exception as e:   # noqa: BLE001 — fail the step's batches, not the loop
            logger.error("fused step resolve failed: %s\n%s", e,
                         traceback.format_exc())
            for it in items:
                if not it.future.done():
                    it.future.set_exception(e)
