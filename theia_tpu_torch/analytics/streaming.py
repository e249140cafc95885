"""Streaming anomaly detection: micro-batch updates, sub-second alerts.

Ports theia_tpu/analytics/streaming.py. Per-connection detector state
lives on the device and every ingest micro-batch advances it with one
gather-scan-scatter step: the EWMA recurrence of the batch TAD job,
with a Welford running *sample* stddev over the points seen so far as
the band (the streaming detector cannot see the future).

Slot model: a fixed-capacity state table indexed by slot; the host
maps connection keys (packed 6-tuples of dictionary codes) to slots on
first sight. New series beyond capacity are dropped and counted.

State is updated IN PLACE: `stream_update_sparse` writes the scanned
rows back into the state tensors through `slots` (on CUDA the B1
kernel does so itself, see ops/fused_detector.py). The reference
returns new arrays instead; the values are the same.

A StreamingDetector is single-writer (callers serialize updates); the
manager scales it by running one instance per destination-hash shard.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..obs import metrics as _metrics
from ..ops.ewma import DEFAULT_ALPHA
from ..schema import ColumnarBatch
from ..utils.device import resolve_device

CONNECTION_KEY_COLUMNS = (
    "sourceIP", "sourceTransportPort", "destinationIP",
    "destinationTransportPort", "protocolIdentifier", "flowStartSeconds")

# Capacity overflow is silent at the data plane (new series simply stop
# being scored) — this counter is the operator's only line-rate signal
# that alerts are going missing before they do.
_M_DROPPED = _metrics.counter(
    "theia_detector_series_dropped_total",
    "New connection series dropped because every streaming-detector "
    "slot was taken (the series is never scored)")


class StreamState(NamedTuple):
    ewma: torch.Tensor    # [S] float32
    count: torch.Tensor   # [S] int32  points seen
    mean: torch.Tensor    # [S] float32 running mean (Welford)
    m2: torch.Tensor      # [S] float32 running sum of squared deviations


def init_state(capacity: int, device="cuda") -> StreamState:
    device = resolve_device(device)

    def z(dtype):
        return torch.zeros(capacity, dtype=dtype, device=device)
    return StreamState(ewma=z(torch.float32), count=z(torch.int32),
                       mean=z(torch.float32), m2=z(torch.float32))


def _update(state: StreamState, x: torch.Tensor, active: torch.Tensor,
            alpha) -> Tuple[StreamState, torch.Tensor]:
    """Elementwise detector recurrence (any shape): anomaly iff the
    slot is active, has seen ≥2 points, and |x − ewma| exceeds the
    running sample stddev. Each line is one rounded float32 op, as in
    the reference (no fused multiply-add)."""
    xa = torch.where(active, x, torch.zeros_like(x))
    count = state.count + active.to(torch.int32)
    delta = xa - state.mean
    mean = torch.where(active,
                       state.mean + delta / torch.clamp(count, min=1),
                       state.mean)
    m2 = torch.where(active, state.m2 + delta * (xa - mean), state.m2)
    ewma = torch.where(active,
                       (1.0 - alpha) * state.ewma + alpha * xa,
                       state.ewma)
    std = torch.sqrt(m2 / torch.clamp(count - 1, min=1))
    anomaly = active & (count >= 2) & (torch.abs(xa - ewma) > std)
    return StreamState(ewma, count, mean, m2), anomaly


def stream_update(state: StreamState, x: torch.Tensor,
                  active: torch.Tensor,
                  alpha: float = DEFAULT_ALPHA
                  ) -> Tuple[StreamState, torch.Tensor]:
    """Dense one-tick step: x [S] new values, active [S] validity
    (returns new tensors)."""
    return _update(state, x, active, alpha)


def stream_update_sparse(state: StreamState, slots: torch.Tensor,
                         x: torch.Tensor, active: torch.Tensor,
                         alpha: float = DEFAULT_ALPHA
                         ) -> Tuple[StreamState, torch.Tensor]:
    """Gather-scan-scatter step for one micro-batch, in place.

    slots [U] int32: the distinct state slots present in the batch;
    padding entries hold `capacity` and never touch real state.
    x, active [T, U]: tick-major values; tick t carries each
    connection's t-th point in this batch, so the recurrence sees
    duplicate points in arrival order.

    Returns (state — the same tensors, updated — and anomaly [T, U]).
    On CUDA tensors this is the B1 kernel; on CPU its plain version.
    """
    from ..ops.fused_detector import stream_scan
    return state, stream_scan(state, slots, x, active, alpha)


def _pad_pow2(n: int, minimum: int) -> int:
    """Next power-of-two bucket, so tile shapes repeat step to step."""
    size = minimum
    while size < n:
        size <<= 1
    return size


class StreamPlan(NamedTuple):
    """Host half of one micro-batch: the [T, U] tick tile plus the slot
    gather/scatter vector. Built by `StreamingDetector.build_plan` and
    consumed by `stream_update_sparse` (sharded engine) or by the
    fused engine's cross-shard step (ops/fused_detector.py)."""
    slots: np.ndarray     # [U_pad] int32; padding holds `capacity`
    x: np.ndarray         # [T_pad, U_pad] float32 values
    active: np.ndarray    # [T_pad, U_pad] bool validity
    row_idx: np.ndarray   # [T_pad, U_pad] int64 source row (-1 padding)
    present: np.ndarray   # [U] slot id per live column


def alert_record(slot: int, flow_end: int, value: float,
                 latency: float) -> Dict[str, object]:
    """The connection-anomaly alert record — ONE function for both
    engines so the published shape cannot drift."""
    return {
        "slot": int(slot),
        "flowEndSeconds": int(flow_end),
        "throughput": float(value),
        "latency_s": latency,
    }


def plan_alerts(plan: StreamPlan, hits: np.ndarray, times: np.ndarray,
                values: np.ndarray,
                latency: float) -> List[Dict[str, object]]:
    """Alert records for the anomaly hits of one plan's device step
    (sharded engine; `row` is batch-local and popped before
    publication by describe_alert's caller)."""
    alerts: List[Dict[str, object]] = []
    for t, c in hits:
        i = int(plan.row_idx[t, c])
        rec = alert_record(plan.present[c], times[i], values[i],
                           latency)
        rec["row"] = i
        alerts.append(rec)
    return alerts


class StreamingDetector:
    """Host side of the detector: key→slot mapping plus
    device-resident state."""

    def __init__(self, capacity: int = 65536,
                 alpha: float = DEFAULT_ALPHA,
                 value_column: str = "throughput",
                 clock=time.perf_counter, device="cuda") -> None:
        self.device = resolve_device(device)
        self.capacity = capacity
        self.alpha = alpha
        self.value_column = value_column
        #: injectable for deterministic latency_s in tests (the alert
        #: latency is a measurement, not detector state)
        self.clock = clock
        self.state = init_state(capacity, self.device)
        # packed key bytes → slot; dropped keys are remembered with
        # slot -1 so a series is only counted dropped once, however
        # many rows it keeps sending.
        self._slots: Dict[bytes, int] = {}
        self._slot_keys: List[Optional[bytes]] = []
        self._n_alloc = 0
        self.dropped_series = 0

    @property
    def n_series(self) -> int:
        return self._n_alloc

    def _slot_for(self, key: bytes) -> int:
        slot = self._slots.get(key)
        if slot is None:
            if self._n_alloc >= self.capacity:
                self._slots[key] = -1
                self.dropped_series += 1
                _M_DROPPED.inc()
                return -1
            slot = self._n_alloc
            self._n_alloc += 1
            self._slots[key] = slot
            self._slot_keys.append(key)
        return slot

    def build_plan(self, keys: np.ndarray, values: np.ndarray,
                   staging: Optional[Callable] = None
                   ) -> Optional[StreamPlan]:
        """Host half of `ingest`: key→slot mapping plus the [T, U]
        tick tile for one micro-batch, no device work.

        `keys` is the [N, 6] int64 connection-key matrix (in
        CONNECTION_KEY_COLUMNS order), `values` the [N] metric column.
        `staging(tag, shape, dtype)` returns a reusable array to fill
        — the fused engine's pinned ring; None allocates fresh arrays.
        Returns None when no row maps to a live slot. Live slots of
        one plan are distinct (`present` is a np.unique), which the
        B1 kernel relies on: no two columns write the same row.
        """
        keys = np.ascontiguousarray(keys, dtype=np.int64)
        packed = keys.view(np.dtype((np.void, keys.itemsize *
                                     keys.shape[1]))).ravel()
        uniq, inverse = np.unique(packed, return_inverse=True)
        slots_u = np.fromiter(
            (self._slot_for(k.tobytes()) for k in uniq),
            dtype=np.int64, count=len(uniq))
        slots = slots_u[inverse]
        ok = slots >= 0

        # Bucket duplicate slots into successive ticks (stable order).
        order = np.argsort(slots[ok], kind="stable")
        s_sorted = slots[ok][order]
        v_sorted = values[ok][order]
        idx_sorted = np.flatnonzero(ok)[order]
        # tick index = occurrence number of this slot within the batch:
        # position minus the start index of the slot's run.
        n = len(s_sorted)
        if n == 0:
            return None
        same = np.empty(n, bool)
        same[0] = False
        same[1:] = s_sorted[1:] == s_sorted[:-1]
        if not same.any():   # common case: one point per series
            tick = np.zeros(n, np.int64)
        else:
            idx = np.arange(n)
            run_start = np.maximum.accumulate(np.where(same, 0, idx))
            tick = idx - run_start
        n_ticks = int(tick.max()) + 1

        # [T, U] tile over the distinct slots present in this batch.
        present, col = np.unique(s_sorted, return_inverse=True)
        u = len(present)
        u_pad = _pad_pow2(u, 64)
        t_pad = _pad_pow2(n_ticks, 1)

        def _alloc(tag, shape, dtype, fill):
            if staging is None:
                return np.full(shape, fill, dtype)
            a = staging(tag, shape, dtype)
            a[...] = fill
            return a

        x = _alloc("x", (t_pad, u_pad), np.float32, 0)
        active = _alloc("active", (t_pad, u_pad), bool, False)
        row_idx = _alloc("row_idx", (t_pad, u_pad), np.int64, -1)
        x[tick, col] = v_sorted
        active[tick, col] = True
        row_idx[tick, col] = idx_sorted
        slots_pad = _alloc("slots", (u_pad,), np.int32, self.capacity)
        slots_pad[:u] = present
        return StreamPlan(slots_pad, x, active, row_idx, present)

    def ingest(self, batch: ColumnarBatch) -> List[Dict[str, object]]:
        """Advance state with one micro-batch; returns alert records.

        Rows are keyed by the 6-tuple connection columns; if a batch
        carries several points for one connection, each lands in a
        successive tick so the recurrence sees them in order.
        """
        if len(batch) == 0:
            return []
        t_arrival = self.clock()
        keys = np.stack(
            [np.asarray(batch[c], np.int64)
             for c in CONNECTION_KEY_COLUMNS], axis=1)
        values = np.asarray(batch[self.value_column], np.float64)
        times = np.asarray(batch["flowEndSeconds"], np.int64)
        plan = self.build_plan(keys, values)
        if plan is None:
            return []
        dev = self.device
        _, anomaly = stream_update_sparse(
            self.state, torch.from_numpy(plan.slots).to(dev),
            torch.from_numpy(plan.x).to(dev),
            torch.from_numpy(plan.active).to(dev), self.alpha)

        hits = np.argwhere(anomaly.cpu().numpy())
        if not hits.size:
            return []
        latency = self.clock() - t_arrival
        return plan_alerts(plan, hits, times, values, latency)

    def describe_alert(self, batch: ColumnarBatch,
                       alert: Dict[str, object]) -> Dict[str, object]:
        """Decode an alert's connection identity from its source row
        (per-cell decode_one, not a whole-column decode)."""
        i = int(alert["row"])
        out = dict(alert)
        for c in CONNECTION_KEY_COLUMNS:
            d = batch.dicts.get(c)
            out[c] = (d.decode_one(int(batch[c][i])) if d is not None
                      else int(batch[c][i]))
        return out
