"""Overload control for the ingest/API path: admission, backpressure,
brownout degradation, and the exactly-once dedup window.

The reference platform survives traffic spikes because ClickHouse
bounds its insert queues and sheds load explicitly (`max_concurrent_
queries`, `TOO_MANY_SIMULTANEOUS_QUERIES` → the client backs off and
retries); a manager that admits every POST unconditionally does not
degrade — it collapses (the insert backlog grows without bound, then
everything times out at once). This module gives the manager the same
discipline, built from three pieces:

**Admission + backpressure.** A per-manager token bucket in rows/sec
(`THEIA_INGEST_RATE`, burst `THEIA_INGEST_BURST`, default 2x rate) and
bytes/sec (`THEIA_INGEST_BYTES_RATE`/`THEIA_INGEST_BYTES_BURST`).
Bytes are charged at admission time (the payload length is known
before decode); rows are charged AFTER decode — the bucket may go into
debt, and a bucket in debt rejects until it refills, so sustained
overload converges on the configured rate without needing to know row
counts up front. A rejected request gets **429 + Retry-After** (a
capacity condition the producer should retry), never 503 (which means
the store itself is unavailable). Per-stream fair-share accounting (a
decayed per-stream rate estimate) keeps one hot producer from draining
the shared bucket dry while 63 polite streams starve: under bucket
contention, a stream consuming more than twice its fair share
(rate / active streams) is rejected first, and a stream running UNDER
its fair share keeps being admitted while the bucket pays off the
hog's debt — down to a floor of one extra burst of debt, so a fleet
minting fresh stream ids cannot make the rate unenforceable.

**Pressure watermarks.** Live signals the manager already has — the
in-flight store-insert backlog (`THEIA_INGEST_INFLIGHT_HIGH`, default
2x the insert pool), the WAL's unsynced-record lag behind `syncedLsn`
(`THEIA_WAL_LAG_HIGH`), and the job queue depth
(`THEIA_JOB_QUEUE_HIGH`) — each normalize to current/high; the
pressure score is the worst of them.

**Brownout ladder.** Under sustained pressure the manager degrades
deliberately instead of collapsing, durability-first (shed work is
always the *scoring* leg — rows still hit WAL + store and are
acknowledged):

    rung 0  ok             full service
    rung 1  sampled        detector/scoring leg runs on a declining
                           fraction of batches (fraction falls as
                           pressure rises through the band)
    rung 2  shed_detector  scoring fully shed; ingest stays durable;
                           heavy `/query` reads answer 429 (deferrable
                           analytics shed one rung before ingest does)
    rung 3  reject         new ingest answers 429 + Retry-After

Rung transitions are hysteretic: escalation is immediate, de-escalation
steps down one rung at a time only after the pressure has stayed below
the rung's entry threshold (minus a margin) for
`THEIA_ADMISSION_HOLD` seconds — a flapping signal cannot oscillate
the ladder. The current rung is served on `/healthz` (`admission`),
as the `theia_admission_level` gauge, and in `theia top`. The
`admission.pressure` fault site (utils/faults.py grammar) forces the
reject rung deterministically for drills, and
`THEIA_ADMISSION_FORCE_LEVEL=<rung|name>` pins any rung.

Control/observability endpoints (`/healthz`, `/readyz`, `/metrics`,
`/alerts`) are never shed — admission gates only `POST /ingest` — so
the operator can always see *why* the manager is rejecting.

**Exactly-once retried ingest.** Producers stamp batches with
`?stream=<id>&seq=<n>`; `DedupWindow` keeps a bounded per-stream
window (`THEIA_INGEST_DEDUP_WINDOW`, default 1024 seqs) of
acknowledged batches, so a retry of a timed-out, shed, or already-
acked batch is answered `{"duplicate": true}` instead of inserting
twice. The `(stream, seq)` tag rides the WAL record header
(store/wal.py `pack_dedup_tag`) and is restored on recovery, so the
idempotency guarantee survives kill -9: a producer retrying across a
crash cannot double-apply a batch whose WAL record was replayed.
"""

from __future__ import annotations

import collections
import math
import os
import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

from ..obs import metrics as _metrics
from ..utils.env import env_float, env_int
from ..utils.faults import FaultError
from ..utils.faults import fire as _fire_fault
from ..utils.logging import get_logger
from ..analysis.lockdep import named_lock

logger = get_logger("admission")

#: brownout ladder rungs, least to most degraded
LEVEL_OK, LEVEL_SAMPLED, LEVEL_SHED, LEVEL_REJECT = range(4)
LEVEL_NAMES = ("ok", "sampled", "shed_detector", "reject")

#: pressure score at which each rung engages (rung 0 has no entry)
LEVEL_THRESHOLDS = (0.0, 0.5, 0.75, 1.0)
#: de-escalation hysteresis: pressure must drop this far below a
#: rung's entry threshold before the ladder steps down
HYSTERESIS_MARGIN = 0.1

_M_LEVEL = _metrics.gauge(
    "theia_admission_level",
    "Current brownout rung (0 ok, 1 sampled, 2 shed_detector, "
    "3 reject)")
_M_PRESSURE = _metrics.gauge(
    "theia_admission_pressure",
    "Worst pressure-signal ratio (current/high watermark; >= 1 means "
    "a signal is past its watermark)")
_M_REJECTED = _metrics.counter(
    "theia_admission_rejected_total",
    "Ingest requests rejected with 429 + Retry-After, by reason",
    labelnames=("reason",))
_M_DEDUP_HITS = _metrics.counter(
    "theia_ingest_dedup_hits_total",
    "Retried (stream, seq) batches answered duplicate:true instead "
    "of re-inserting")
_M_DUP_ROWS = _metrics.counter(
    "theia_ingest_duplicate_rows_total",
    "Rows a retrying producer would have double-inserted without the "
    "dedup window")


class AdmissionRejected(Exception):
    """Request refused for CAPACITY (HTTP 429 + Retry-After), as
    opposed to unavailability (503). Retryable after `retry_after`
    seconds."""

    def __init__(self, reason: str, retry_after: float,
                 detail: str = "") -> None:
        super().__init__(
            f"ingest over capacity ({reason}): retry after "
            f"{retry_after:.2f}s" + (f" — {detail}" if detail else ""))
        self.reason = reason
        self.retry_after = float(retry_after)


class TokenBucket:
    """Deterministic token bucket (injectable clock). Supports the
    charge-after-the-fact discipline the row bucket needs: `charge()`
    may push the balance negative (the caller learns the true cost
    only after decode), and `wait_for_positive()` reports how long
    until the debt clears."""

    def __init__(self, rate: float, burst: float,
                 clock: Callable[[], float] = time.monotonic) -> None:
        if rate <= 0:
            raise ValueError(f"rate must be > 0, got {rate}")
        self.rate = float(rate)
        self.burst = float(max(burst, 1.0))
        self._clock = clock
        self._tokens = self.burst
        self._t = clock()
        self._lock = named_lock("admission.bucket")

    def _refill_locked(self) -> None:
        now = self._clock()
        dt = now - self._t
        if dt > 0:
            self._tokens = min(self.burst,
                               self._tokens + dt * self.rate)
        self._t = now

    def tokens(self) -> float:
        with self._lock:
            self._refill_locked()
            return self._tokens

    def try_charge(self, n: float) -> float:
        """Charge `n` tokens if covered; returns 0.0 on success, else
        the seconds until `n` tokens will be available. A request
        larger than the whole burst is admitted from a full bucket
        (into debt) — otherwise it could never be admitted at all."""
        with self._lock:
            self._refill_locked()
            if self._tokens >= min(n, self.burst):
                self._tokens -= n
                return 0.0
            return (min(n, self.burst) - self._tokens) / self.rate

    def charge(self, n: float) -> None:
        """Unconditional charge (post-decode row accounting); the
        balance may go negative — debt rejects future admissions until
        the refill clears it."""
        with self._lock:
            self._refill_locked()
            self._tokens -= n

    def wait_for_positive(self) -> float:
        """0.0 when the bucket holds at least one token, else seconds
        until it will."""
        with self._lock:
            self._refill_locked()
            if self._tokens >= 1.0:
                return 0.0
            return (1.0 - self._tokens) / self.rate


class DedupWindow:
    """Bounded per-stream window of acknowledged `(seq -> rows)`
    batches. `lookup` answers a retry without touching decoder, store,
    or detector state; beyond the window (or for unstamped batches)
    ingest degrades to at-least-once, which is the pre-existing
    contract.

    Cardinality hardening (the ROADMAP item-5 pre-work): every
    operation is O(1) — streams are an OrderedDict LRU
    (`THEIA_INGEST_DEDUP_STREAMS`, default 8192), total entries carry
    a RUNNING count (stats() no longer walks every stream), and a
    GLOBAL entry budget (`THEIA_INGEST_DEDUP_ENTRIES`, default 2^20)
    bounds aggregate memory by evicting whole least-recently-active
    streams — so ~100k distinct stream ids (a router mesh's
    `stream@origin` sub-streams, a fleet minting producer ids) cost
    bounded memory and constant-time ops, not 100k × window dicts."""

    def __init__(self, window: Optional[int] = None,
                 max_streams: Optional[int] = None,
                 max_entries: Optional[int] = None) -> None:
        self.window = (env_int("THEIA_INGEST_DEDUP_WINDOW", 1024)
                       if window is None else int(window))
        self.max_streams = (env_int("THEIA_INGEST_DEDUP_STREAMS", 8192)
                            if max_streams is None
                            else int(max_streams))
        self.max_entries = (env_int("THEIA_INGEST_DEDUP_ENTRIES",
                                    1 << 20)
                            if max_entries is None
                            else int(max_entries))
        self._streams: "collections.OrderedDict[str, collections.OrderedDict[int, int]]" = (
            collections.OrderedDict())
        self._entries = 0
        self._lock = named_lock("admission.dedup")
        self.hits = 0
        self.misses = 0
        self.evicted_streams = 0

    def lookup(self, stream: str, seq: Optional[int]) -> Optional[int]:
        """Rows acked for `(stream, seq)`, or None (unseen/evicted/
        unstamped — proceed with the insert)."""
        if seq is None or self.window <= 0:
            return None
        with self._lock:
            win = self._streams.get(stream)
            rows = None if win is None else win.get(int(seq))
            if rows is None:
                self.misses += 1
                return None
            # a hit is activity too: a producer replaying an
            # already-acked tail (lookups only, no new records) must
            # not age out of the stream LRU mid-replay
            self._streams.move_to_end(stream)
            self.hits += 1
            return rows

    def record(self, stream: str, seq: Optional[int],
               rows: int) -> None:
        if seq is None or self.window <= 0:
            return
        with self._lock:
            win = self._streams.get(stream)
            if win is None:
                win = self._streams[stream] = collections.OrderedDict()
            else:
                self._streams.move_to_end(stream)
            seq = int(seq)
            if seq not in win:
                self._entries += 1
            win[seq] = int(rows)
            win.move_to_end(seq)
            while len(win) > self.window:
                win.popitem(last=False)
                self._entries -= 1
            self._evict_over_budget_locked()

    def _evict_over_budget_locked(self) -> None:
        """Drop whole least-recently-active streams until both the
        stream LRU and the global entry budget hold — amortized O(1):
        each stream is inserted once and evicted at most once."""
        while (len(self._streams) > self.max_streams
               or (self.max_entries > 0
                   and self._entries > self.max_entries
                   and len(self._streams) > 1)):
            evicted, win = self._streams.popitem(last=False)
            self._entries -= len(win)
            self.evicted_streams += 1
            logger.v(1).info(
                "dedup window evicted idle stream %r (%d entries)",
                evicted, len(win))

    def dump(self, limit: int = 1 << 20) -> List[Tuple[str, int, int]]:
        """(stream, seq, rows) snapshot of every live entry — shipped
        inside a cluster resync so a freshly-synced follower answers
        producer retries duplicate:true after a failover. Bounded by
        `limit` newest-stream-first."""
        out: List[Tuple[str, int, int]] = []
        with self._lock:
            for stream in reversed(self._streams):
                win = self._streams[stream]
                for seq, rows in win.items():
                    out.append((stream, seq, rows))
                if len(out) >= limit:
                    break
        return out[:limit]

    def stats(self) -> Dict[str, object]:
        with self._lock:
            return {
                "window": self.window,
                "streams": len(self._streams),
                "maxStreams": self.max_streams,
                "entries": self._entries,
                "maxEntries": self.max_entries,
                "evictedStreams": self.evicted_streams,
                "hits": self.hits,
                "misses": self.misses,
            }


class AdmissionController:
    """The overload-control plane: token buckets + pressure ladder +
    fair share. One instance per IngestManager; every knob has an env
    default so a bare constructor is production-configured.

    Thread-safe; `clock` is injectable so every transition is
    deterministic under test."""

    #: decay constant for the per-stream rate estimate (seconds)
    STREAM_TAU = 5.0
    #: a stream may burst to this multiple of its fair share before
    #: fair-share rejection kicks in (under bucket contention only)
    FAIR_SHARE_SLACK = 2.0

    def __init__(self,
                 rate: Optional[float] = None,
                 burst: Optional[float] = None,
                 byte_rate: Optional[float] = None,
                 byte_burst: Optional[float] = None,
                 hold_seconds: Optional[float] = None,
                 retry_after_hint: Optional[float] = None,
                 clock: Callable[[], float] = time.monotonic) -> None:
        rate = env_float("THEIA_INGEST_RATE", 0.0) \
            if rate is None else float(rate)
        byte_rate = env_float("THEIA_INGEST_BYTES_RATE", 0.0) \
            if byte_rate is None else float(byte_rate)
        self._clock = clock
        self.rows = None
        if rate > 0:
            b = env_float("THEIA_INGEST_BURST", 0.0) \
                if burst is None else float(burst)
            self.rows = TokenBucket(rate, b if b > 0 else 2 * rate,
                                    clock=clock)
        self.bytes = None
        if byte_rate > 0:
            b = env_float("THEIA_INGEST_BYTES_BURST", 0.0) \
                if byte_burst is None else float(byte_burst)
            self.bytes = TokenBucket(byte_rate,
                                     b if b > 0 else 2 * byte_rate,
                                     clock=clock)
        self.hold_seconds = (env_float("THEIA_ADMISSION_HOLD", 1.0)
                             if hold_seconds is None
                             else float(hold_seconds))
        self.retry_after_hint = (
            env_float("THEIA_ADMISSION_RETRY_AFTER", 1.0)
            if retry_after_hint is None else float(retry_after_hint))
        #: name -> (current-value callable, high watermark)
        self._signals: Dict[str, Tuple[Callable[[], float], float]] = {}
        self._lock = named_lock("admission.controller")
        self._level = LEVEL_OK
        self._level_since = clock()
        #: first time pressure was seen below the de-escalation
        #: threshold (None while at/above it) — de-escalation needs
        #: hold_seconds of SUSTAINED low pressure, not one lucky dip
        self._below_since: Optional[float] = None
        self._score_credit = 0.0
        self._last_fraction = 1.0
        #: stream -> (decayed row count, last update) — estimate of a
        #: stream's recent rows/sec is acc / STREAM_TAU
        self._stream_acc: Dict[str, Tuple[float, float]] = {}
        self.rejected = 0
        self.admitted = 0

    # -- pressure signals --------------------------------------------------

    def add_signal(self, name: str, fn: Callable[[], float],
                   high: float) -> None:
        """Register a pressure signal: `fn()` is the live value, `high`
        the watermark at which it alone forces the reject rung."""
        if high <= 0:
            return
        self._signals[name] = (fn, float(high))

    def signal_ratios(self) -> Dict[str, float]:
        out: Dict[str, float] = {}
        for name, (fn, high) in self._signals.items():
            try:
                out[name] = max(0.0, float(fn())) / high
            except Exception:
                # a broken signal must not take ingest down with it
                out[name] = 0.0
        return out

    def pressure(self) -> float:
        """Worst signal ratio (>= 1.0 means some watermark is hit)."""
        ratios = self.signal_ratios()
        return max(ratios.values()) if ratios else 0.0

    # -- brownout ladder ---------------------------------------------------

    @staticmethod
    def _forced_level() -> Optional[int]:
        raw = os.environ.get("THEIA_ADMISSION_FORCE_LEVEL", "").strip()
        if not raw:
            return None
        if raw.lower() in LEVEL_NAMES:
            return LEVEL_NAMES.index(raw.lower())
        try:
            n = int(raw)
        except ValueError:
            return None
        return min(LEVEL_REJECT, max(LEVEL_OK, n))

    def evaluate(self) -> int:
        """Recompute the brownout rung from live pressure (with
        hysteresis) and publish the gauges. Escalation is immediate;
        de-escalation is one rung at a time, and only after pressure
        has stayed a margin below the current rung's entry threshold
        for `hold_seconds` CONTINUOUSLY (as observed by evaluate
        calls) — a single dip of a flapping signal does not step the
        ladder down."""
        forced = self._forced_level()
        p = self.pressure()
        with self._lock:
            if forced is not None:
                if forced != self._level:
                    # reset the age only on an actual change:
                    # /healthz levelAgeSeconds should report how long
                    # the drill has been pinned, not ~0 forever
                    self._level = forced
                    self._level_since = self._clock()
                self._below_since = None
            else:
                target = LEVEL_OK
                for lvl in (LEVEL_REJECT, LEVEL_SHED, LEVEL_SAMPLED):
                    if p >= LEVEL_THRESHOLDS[lvl]:
                        target = lvl
                        break
                now = self._clock()
                if target > self._level:
                    self._level = target
                    self._level_since = now
                    self._below_since = None
                    logger.warning(
                        "admission escalated to %s (pressure %.2f: %s)",
                        LEVEL_NAMES[target], p,
                        ", ".join(f"{k}={v:.2f}" for k, v
                                  in self.signal_ratios().items()))
                elif target < self._level:
                    # de-escalation needs pressure SUSTAINED below the
                    # current rung's entry threshold (minus margin)
                    # for hold_seconds — a single dip of a flapping
                    # signal must not step the ladder down
                    entry = LEVEL_THRESHOLDS[self._level]
                    if p > entry - HYSTERESIS_MARGIN:
                        self._below_since = None
                    else:
                        if self._below_since is None:
                            self._below_since = now
                        if (now - self._below_since
                                >= self.hold_seconds):
                            self._level -= 1   # one rung at a time
                            self._level_since = now
                            # the dip continues: restart its clock at
                            # the step-down so the NEXT rung needs its
                            # own hold_seconds of sustained calm (the
                            # next evaluate re-derives against the new
                            # rung's threshold)
                            self._below_since = now
                            logger.info(
                                "admission de-escalated to %s "
                                "(pressure %.2f)",
                                LEVEL_NAMES[self._level], p)
                else:
                    self._below_since = None
            level = self._level
            self._last_fraction = self._score_fraction_locked(level, p)
        _M_LEVEL.set(level)
        _M_PRESSURE.set(p)
        return level

    def level(self) -> int:
        with self._lock:
            return self._level

    def _score_fraction_locked(self, level: int, p: float) -> float:
        """Fraction of batches the detector leg should score at this
        rung: 1.0 at ok, declining linearly across the sampled band
        (floor 0.25), 0.0 at shed/reject."""
        if level == LEVEL_OK:
            return 1.0
        if level != LEVEL_SAMPLED:
            return 0.0
        lo = LEVEL_THRESHOLDS[LEVEL_SAMPLED]
        hi = LEVEL_THRESHOLDS[LEVEL_SHED]
        frac = 1.0 - (p - lo) / (hi - lo)
        return min(1.0, max(0.25, frac))

    def should_score(self, level: int) -> bool:
        """Deterministic sampling decision for one batch at `level`:
        a credit accumulator admits exactly the configured fraction
        (no RNG — the same pressure trajectory always sheds the same
        batches)."""
        if level == LEVEL_OK:
            return True
        if level >= LEVEL_SHED:
            return False
        with self._lock:
            self._score_credit += self._last_fraction
            if self._score_credit >= 1.0:
                self._score_credit -= 1.0
                return True
            return False

    # -- admission ---------------------------------------------------------

    def admit(self, stream: str, nbytes: int,
              rows_hint: Optional[int] = None) -> int:
        """Gate one ingest request BEFORE decode. Returns the current
        brownout rung on success; raises AdmissionRejected (→ HTTP 429
        + Retry-After) when the request must not proceed. Charges the
        byte bucket (payload size is known here); rows are charged
        after decode via `charge_rows` — UNLESS `rows_hint` gives the
        exact row count up front (a TBLK block header, validated
        against the payload size by `wire.peek_counts`), in which case
        the row bucket and the stream rate estimate are charged here
        and the caller skips `charge_rows` entirely: admission for a
        self-contained block never needs the decode."""
        try:
            _fire_fault("admission.pressure", stream=stream)
        except FaultError as e:
            self.reject("fault", self.retry_after_hint, str(e))
        level = self.evaluate()
        if level >= LEVEL_REJECT:
            self.reject("pressure", self.retry_after_hint,
                         f"brownout rung {LEVEL_NAMES[level]}, "
                         f"pressure {self.pressure():.2f}")
        if self.rows is not None:
            # fair share first: a hog over 2x its share under
            # contention gets the SPECIFIC rejection (it should slow
            # down), not the generic debt one (everyone should)
            self._check_fair_share(stream)
            wait = self.rows.wait_for_positive()
            if wait > 0.0 and not (
                    self._under_fair_share(stream)
                    and self.rows.tokens() > -self.rows.burst):
                # Bucket in debt — a stream running UNDER its fair
                # share is not the one that put it there, so it keeps
                # being admitted, but only down to ONE extra burst of
                # debt: without that floor, a fleet minting fresh
                # stream ids (each with no rate history, so trivially
                # "under share") could push the debt arbitrarily deep
                # and make the configured rate unenforceable.
                self.reject("rows", wait, "row budget in debt")
        if self.bytes is not None:
            wait = self.bytes.try_charge(max(nbytes, 0))
            if wait > 0.0:
                self.reject("bytes", wait,
                             f"{nbytes} payload bytes over budget")
        if rows_hint is not None:
            self.charge_rows(stream, int(rows_hint))
        with self._lock:
            self.admitted += 1
        return level

    def admit_query(self) -> int:
        """Gate one `/query` request. Analytics queries are DEFERRABLE
        read work, so they ride the pressure ladder one rung ahead of
        ingest: at `shed_detector` (rung 2) — where ingest is still
        accepted, just unscored — queries already answer 429 +
        Retry-After, and at `reject` likewise. Control/observability
        endpoints (/healthz, /readyz, /metrics, /alerts) never shed;
        only the heavy read path does. Returns the rung on success."""
        try:
            _fire_fault("admission.pressure", stream="__query__")
        except FaultError as e:
            self.reject("fault", self.retry_after_hint, str(e))
        level = self.evaluate()
        if level >= LEVEL_SHED:
            self.reject(
                "query_shed", self.retry_after_hint,
                f"brownout rung {LEVEL_NAMES[level]} sheds analytics "
                f"queries (pressure {self.pressure():.2f})")
        with self._lock:
            self.admitted += 1
        return level

    def note_rejected(self) -> None:
        """Count a rejection raised OUTSIDE this controller (e.g. the
        ingest layer's in-flight duplicate) so /healthz
        `admission.rejected` stays in lockstep with
        theia_admission_rejected_total."""
        with self._lock:
            self.rejected += 1

    def reject(self, reason: str, retry_after: float,
               detail: str = "") -> None:
        """Count and raise one rejection."""
        self.note_rejected()
        _M_REJECTED.labels(reason=reason).inc()
        raise AdmissionRejected(reason, max(retry_after, 0.05), detail)

    def charge_rows(self, stream: str, rows: int) -> None:
        """Post-decode accounting: debit the row bucket by the actual
        row count (possibly into debt) and feed the stream's decayed
        rate estimate."""
        if rows <= 0:
            return
        if self.rows is not None:
            self.rows.charge(rows)
        now = self._clock()
        with self._lock:
            acc, last = self._stream_acc.get(stream, (0.0, now))
            acc *= math.exp(-(now - last) / self.STREAM_TAU)
            self._stream_acc[stream] = (acc + rows, now)
            # bound the table: drop streams idle long enough that
            # their estimate decayed to nothing
            if len(self._stream_acc) > 4096:
                cutoff = now - 4 * self.STREAM_TAU
                self._stream_acc = {
                    s: v for s, v in self._stream_acc.items()
                    if v[1] >= cutoff}

    def _stream_rate(self, stream: str, now: float) -> Tuple[float, int]:
        """(decayed rows/sec estimate for `stream`, active streams).
        Caller must NOT hold self._lock."""
        with self._lock:
            horizon = now - 2 * self.STREAM_TAU
            active = sum(1 for _, t in self._stream_acc.values()
                         if t >= horizon)
            acc, last = self._stream_acc.get(stream, (0.0, now))
        est = (acc * math.exp(-(now - last) / self.STREAM_TAU)
               / self.STREAM_TAU)
        return est, active

    def _under_fair_share(self, stream: str) -> bool:
        """True when `stream` consumes no more than its fair share of
        the configured rate (and there IS sharing going on)."""
        bucket = self.rows
        if bucket is None:
            return False
        est, active = self._stream_rate(stream, self._clock())
        return active > 1 and est <= bucket.rate / active

    def _check_fair_share(self, stream: str) -> None:
        """Under bucket contention (< half the burst left), reject the
        streams consuming more than FAIR_SHARE_SLACK × their fair
        share of the configured rate — the polite majority keeps
        landing while the hot producer backs off."""
        bucket = self.rows
        if bucket is None or bucket.tokens() >= bucket.burst / 2:
            return
        est, active = self._stream_rate(stream, self._clock())
        if active <= 1:
            return
        fair = bucket.rate / active
        if est > self.FAIR_SHARE_SLACK * fair:
            wait = min(5.0, max(0.1, (est - fair) / bucket.rate))
            self.reject(
                "fair_share", wait,
                f"stream {stream!r} at {est:.0f} rows/s vs fair share "
                f"{fair:.0f} ({active} active streams)")

    # -- operator surface --------------------------------------------------

    def snapshot(self) -> Dict[str, object]:
        """Health-surface doc (served under /healthz `admission`)."""
        with self._lock:
            level = self._level
            since = self._level_since
            admitted, rejected = self.admitted, self.rejected
        doc: Dict[str, object] = {
            "level": level,
            "levelName": LEVEL_NAMES[level],
            "levelAgeSeconds": round(self._clock() - since, 3),
            "pressure": round(self.pressure(), 4),
            "signals": {k: round(v, 4)
                        for k, v in self.signal_ratios().items()},
            "admitted": admitted,
            "rejected": rejected,
        }
        if self.rows is not None:
            doc["rowsPerSec"] = self.rows.rate
            doc["rowTokens"] = round(self.rows.tokens(), 1)
        if self.bytes is not None:
            doc["bytesPerSec"] = self.bytes.rate
            doc["byteTokens"] = round(self.bytes.tokens(), 1)
        return doc
