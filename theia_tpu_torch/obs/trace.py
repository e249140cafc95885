"""Tracing: trace-aware spans with cross-node context propagation, a
bounded ring of recent spans, and slowest-span exemplars per operation.

Two layers share one ring:

  * **Flight recorder**: any code wraps itself in `span("op")`
    (context manager); finished spans land in a fixed-size ring
    (newest first on read) and the slowest span per operation is kept
    as an exemplar. Per-thread nesting links a span to the operation
    that enclosed it (`parent`).
  * **Distributed traces**: each ingress — a producer
    `POST /ingest`, a coordinator `/query`, a job run, a replication
    ship — mints a W3C-traceparent-style context (128-bit trace id,
    64-bit span id, sampled flag) with `ingress_span(...)`, or adopts
    the one a remote caller stamped on the request
    (`traceparent: 00-<trace>-<span>-<flags>`). Every span that runs
    inside a traced ingress inherits the trace id and records its own
    span id plus its parent's, so the rings of every node in a cluster
    hold the pieces of one cross-node tree — `GET
    /debug/traces?trace=<id>` stitches them (manager/api.py).

Sampling is **head-based and deterministic**: the mint-time decision
is a pure function of the trace id and `THEIA_TRACE_SAMPLE` (default
1.0 — sample everything), so the same trace id decides identically on
every node and every retry. An UNSAMPLED trace still times its spans
but retains nothing and stamps nothing on the wire — with
`THEIA_TRACE_SAMPLE=0` cluster traffic is byte-identical to a build
without tracing.

Span records are plain dicts (JSON-ready for GET /debug/traces):

    {"op", "startTime", "durationMs", "parent", "thread", "tid",
     # present under a sampled trace context:
     "traceId", "spanId", "parentSpanId", "node", ...attrs}

`startTime` is `time.time()`; `tid` is the recording thread's native
id (`threading.get_native_id()`), the id a torch.profiler trace gives
that thread's host operations. Its CUDA runtime calls may carry
CUPTI's thread id instead, the thread's `threading.get_ident()` cut to
32 bits, written as the absolute value of that signed 32-bit number;
`thread_rows` finds the row for the capture's export.

**Captures.** While a profile capture runs (manager/profiling.py), every
record the ring takes is also kept for the capture (`start_capture`,
at most CAPTURE_CAP records, the rest counted as dropped), and
`chrome_events` turns the records that lie wholly inside the capture
into Chrome trace events on the trace's clock. With no capture
running, publishing costs one check more.

Env knobs:

    THEIA_TRACE_RING     ring capacity (default 256; 0 disables
                         recording — span() still times, nothing is
                         kept, cluster-wide)
    THEIA_TRACE_SAMPLE   head-based sampling rate for ingress-minted
                         traces (default 1.0; 0 disables tracing —
                         no contexts, no wire headers)

Recording honors metrics.disable() (one kill switch for the whole obs
plane). Mutating an attr on the yielded span inside the `with` body
(`sp.attrs["rows"] = n`) annotates the record before it is published.
"""

from __future__ import annotations

import collections
import os
import random
import threading
import time
from typing import Deque, Dict, List, Optional

from . import metrics as _metrics
from ..analysis.lockdep import named_lock


def _ring_capacity() -> int:
    return max(0, _metrics._env_int("THEIA_TRACE_RING", 256))


def _sample_rate(env: Optional[str] = None) -> float:
    """THEIA_TRACE_SAMPLE, optionally overridden by a per-ingress env
    knob (e.g. THEIA_TRACE_SAMPLE_INGEST: high-rate ingresses get
    their own dial so turning them down does not blind the rest)."""
    raw = ""
    if env:
        raw = os.environ.get(env, "")
    if not raw:
        raw = os.environ.get("THEIA_TRACE_SAMPLE", "")
    try:
        return float(raw) if raw else 1.0
    except ValueError:
        return 1.0


#: distinct operations tracked for exemplars (bounds the dict; beyond
#: this, new op names are recorded in the ring but not as exemplars)
MAX_EXEMPLAR_OPS = 128

#: the most span records one capture keeps
CAPTURE_CAP = 1_000_000

#: the Chrome trace category of exported spans (none of the profiler's
#: own categories)
SPAN_CATEGORY = "theia_span"

_lock = named_lock("trace.ring")
_ring: Deque[Dict[str, object]] = collections.deque(
    maxlen=_ring_capacity())
_slowest: Dict[str, Dict[str, object]] = {}
_local = threading.local()


class Capture:
    """The span records finished while one profile capture runs: the
    first `cap` of them, and a count of the rest."""

    __slots__ = ("records", "dropped", "cap")

    def __init__(self, cap: int = CAPTURE_CAP) -> None:
        self.records: List[Dict[str, object]] = []
        self.dropped = 0
        self.cap = int(cap)


#: the running capture, or None
_capture: Optional[Capture] = None


def thread_rows(runtime_tids) -> Dict[int, int]:
    """native id → the id under which a trace whose CUDA runtime calls
    carry `runtime_tids` shows that thread's calls, for every live
    thread: the native id where the trace uses it, else CUPTI's id of
    the thread (its ident cut to 32 bits, as is or as the absolute
    value of that signed number) where the trace uses that, else the
    native id."""
    rows: Dict[int, int] = {}
    for th in threading.enumerate():
        tid, ident = th.native_id, th.ident
        if tid is None or ident is None:
            continue
        cut = ident & 0xFFFFFFFF
        signed = cut - (1 << 32) if cut >> 31 else cut
        rows[tid] = next((row for row in (tid, cut, abs(signed))
                          if row in runtime_tids), tid)
    return rows


#: this process's node id, stamped on every trace-context span (set by
#: the manager when a cluster is configured; "" on standalone nodes)
_node_id = ""


def set_node_id(node_id: str) -> None:
    global _node_id
    _node_id = str(node_id or "")


def node_id() -> str:
    return _node_id


# -- trace context (W3C traceparent style) ---------------------------------

class TraceContext:
    """One position in a distributed trace: the 128-bit trace id, the
    current span's 64-bit id (what a child or remote callee records as
    its parent), and the head-based sampling decision."""

    __slots__ = ("trace_id", "span_id", "sampled")

    def __init__(self, trace_id: str, span_id: str,
                 sampled: bool) -> None:
        self.trace_id = trace_id
        self.span_id = span_id
        self.sampled = bool(sampled)


# ids need uniqueness and sampling spread, not crypto strength — and
# os.urandom is a syscall (~19us in sandboxed containers) paid per
# ingress on the query/ingest hot paths. One urandom-seeded PRNG
# (pid-mixed so forked workers diverge) mints ids at ~1us. CPython's
# getrandbits is C-level and GIL-atomic, so concurrent ingresses
# can't corrupt the generator state.
_id_rng = random.Random(int.from_bytes(os.urandom(16), "big")
                        ^ os.getpid())


def new_trace_id() -> str:
    return f"{_id_rng.getrandbits(128):032x}"


def new_span_id() -> str:
    return f"{_id_rng.getrandbits(64):016x}"


def sampled_for(trace_id: str, rate: Optional[float] = None) -> bool:
    """Deterministic head-based decision: a pure function of the trace
    id and the sampling rate, so every node (and every retry carrying
    the same id) decides identically."""
    if rate is None:
        rate = _sample_rate()
    if rate >= 1.0:
        return True
    if rate <= 0.0:
        return False
    try:
        bits = int(trace_id[:8], 16)
    except ValueError:
        return False
    return bits / float(1 << 32) < rate


def format_traceparent(ctx: TraceContext) -> str:
    return (f"00-{ctx.trace_id}-{ctx.span_id}-"
            f"{'01' if ctx.sampled else '00'}")


def parse_traceparent(header: Optional[str]) -> Optional[TraceContext]:
    """`00-<32 hex>-<16 hex>-<2 hex>` → TraceContext, or None for
    anything malformed (a bad header from an old peer must degrade to
    a fresh trace, never to a 500)."""
    if not header:
        return None
    parts = str(header).strip().lower().split("-")
    if len(parts) != 4:
        return None
    version, trace_id, span_id, flags = parts
    if (len(version) != 2 or len(trace_id) != 32
            or len(span_id) != 16 or len(flags) != 2):
        return None
    try:
        int(trace_id, 16), int(span_id, 16), int(flags, 16)
    except ValueError:
        return None
    if trace_id == "0" * 32 or span_id == "0" * 16:
        return None
    return TraceContext(trace_id, span_id,
                        sampled=bool(int(flags, 16) & 1))


def current_context() -> Optional[TraceContext]:
    """The innermost SAMPLED trace context on this thread (None outside
    any traced ingress, or when the trace is unsampled — callers use
    this to stamp outbound RPCs, and unsampled traces stamp nothing)."""
    stack = getattr(_local, "stack", None)
    if stack:
        ctx = stack[-1].context
        if ctx is not None and ctx.sampled:
            return ctx
    return None


def traceparent() -> Optional[str]:
    """The header value for the current sampled context, or None — the
    one call every outbound transport makes. No sampled context means
    NO header: with sampling off the wire is byte-identical to an
    untraced build."""
    ctx = current_context()
    return format_traceparent(ctx) if ctx is not None else None


class Span:
    """One in-flight operation; finished spans publish as dicts.

    Three flavors share this class:
      * `span(op)` — inherits the thread's context (legacy flight
        recorder when there is none: always published).
      * `ingress_span(op, traceparent=...)` — adopts the remote
        context or mints a fresh one (the trace root).
      * `child_span(op, ctx)` — continues an explicit context on
        another thread (pool workers running one request's fan-out).
    """

    __slots__ = ("op", "attrs", "_t0", "_start", "parent", "context",
                 "_parent_span_id", "_ingress", "_traceparent",
                 "_explicit_ctx", "_sample_env")

    def __init__(self, op: str, attrs: Dict[str, object],
                 ingress: bool = False,
                 traceparent: Optional[str] = None,
                 ctx: Optional[TraceContext] = None,
                 sample_env: Optional[str] = None) -> None:
        self.op = op
        self.attrs = attrs
        self.parent: Optional[str] = None
        self.context: Optional[TraceContext] = None
        self._parent_span_id: Optional[str] = None
        self._ingress = ingress
        self._traceparent = traceparent
        self._explicit_ctx = ctx
        self._sample_env = sample_env
        self._t0 = 0.0
        self._start = 0.0

    def _bind_context(self, enclosing: Optional["Span"]) -> None:
        if self._ingress:
            if _sample_rate(self._sample_env) <= 0.0:
                # tracing off is a LOCAL kill switch: no context
                # minted, nothing retained, no bytes on the wire —
                # even when a peer's sampled traceparent arrives
                self.context = TraceContext("", "", False)
                return
            remote = parse_traceparent(self._traceparent)
            if remote is not None:
                trace_id = remote.trace_id
                self._parent_span_id = remote.span_id
                sampled = remote.sampled
            else:
                trace_id = new_trace_id()
                sampled = sampled_for(trace_id,
                                      _sample_rate(self._sample_env))
            self.context = TraceContext(trace_id, new_span_id(),
                                        sampled)
            return
        parent_ctx = self._explicit_ctx
        if parent_ctx is None and enclosing is not None:
            parent_ctx = enclosing.context
        if parent_ctx is None:
            return                      # legacy span: no trace context
        if not parent_ctx.sampled:
            self.context = TraceContext(parent_ctx.trace_id, "", False)
            return
        self._parent_span_id = parent_ctx.span_id
        self.context = TraceContext(parent_ctx.trace_id, new_span_id(),
                                    True)

    def __enter__(self) -> "Span":
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
        enclosing = stack[-1] if stack else None
        self.parent = enclosing.op if enclosing is not None else None
        self._bind_context(enclosing)
        stack.append(self)
        self._start = time.time()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        duration = time.perf_counter() - self._t0
        stack = getattr(_local, "stack", None)
        if stack:
            stack.pop()
        if not _metrics.enabled():
            return
        if self.context is not None and not self.context.sampled:
            return   # unsampled trace: timed, never retained
        record: Dict[str, object] = {
            "op": self.op,
            "startTime": self._start,
            "durationMs": round(duration * 1e3, 4),
            "parent": self.parent,
            "thread": threading.current_thread().name,
            "tid": threading.get_native_id(),
        }
        if self.context is not None:
            record["traceId"] = self.context.trace_id
            record["spanId"] = self.context.span_id
            if self._parent_span_id:
                record["parentSpanId"] = self._parent_span_id
            record["node"] = _node_id
        if exc_type is not None:
            record["error"] = exc_type.__name__
        record.update(self.attrs)
        _publish(record)


def _publish(record: Dict[str, object]) -> None:
    # THEIA_TRACE_RING=0 promises NO span retention — exemplars are
    # retained state too (attrs carry stream ids and job names), so
    # the knob turns them off with the ring.
    if not _ring.maxlen:
        return
    op = str(record["op"])
    with _lock:
        _ring.append(record)
        best = _slowest.get(op)
        if best is None:
            if len(_slowest) < MAX_EXEMPLAR_OPS:
                _slowest[op] = record
        elif record["durationMs"] > best["durationMs"]:
            _slowest[op] = record
        cap = _capture
        if cap is not None:
            if len(cap.records) < cap.cap:
                cap.records.append(record)
            else:
                cap.dropped += 1


def start_capture(cap: int = CAPTURE_CAP) -> Capture:
    """Keep every record published from now on (up to `cap`) for a
    profile capture, until stop_capture(); one capture at a time."""
    global _capture
    capture = Capture(cap)
    with _lock:
        _capture = capture
    return capture


def stop_capture(capture: Capture) -> None:
    global _capture
    with _lock:
        if _capture is capture:
            _capture = None


def record(op: str, start_time: float, duration_s: float,
           **attrs: object) -> None:
    """Publish an already-timed span (hot paths that keep their own
    stopwatches and only record the interesting tail). Under a sampled
    trace context the record joins the trace; under an unsampled one
    it is dropped with the rest of the trace."""
    record_in(current_span(), op, start_time, duration_s, **attrs)


def record_in(parent: Optional["Span"], op: str, start_time: float,
              duration_s: float, **attrs: object) -> None:
    """record() as a child of `parent`, a span of this thread that may
    have closed since (a job stage timed from one call to the next);
    with no parent, a record of no trace."""
    if not _metrics.enabled():
        return
    rec: Dict[str, object] = {
        "op": op,
        "startTime": start_time,
        "durationMs": round(duration_s * 1e3, 4),
        "parent": parent.op if parent is not None else None,
        "thread": threading.current_thread().name,
        "tid": threading.get_native_id(),
    }
    ctx = parent.context if parent is not None else None
    if ctx is not None:
        if not ctx.sampled:
            return
        rec["traceId"] = ctx.trace_id
        rec["spanId"] = new_span_id()
        rec["parentSpanId"] = ctx.span_id
        rec["node"] = _node_id
    rec.update(attrs)
    _publish(rec)


def chrome_events(records, offset_us: float, lo: float, hi: float,
                  pid: int, rows: Optional[Dict[int, int]] = None
                  ) -> List[Dict[str, object]]:
    """Chrome trace `"ph": "X"` events of the span records that lie
    wholly inside [lo, hi] (`time.time()` seconds): `ts` is a record's
    startTime in µs plus `offset_us`, the trace's clock less the wall
    clock; `tid` is the record's, or its row in `rows` (thread_rows);
    `args` holds every field but the op, the times and the tid."""
    rows = rows or {}
    out: List[Dict[str, object]] = []
    for rec in records:
        start = float(rec["startTime"])
        dur_s = float(rec["durationMs"]) / 1e3
        if start < lo or start + dur_s > hi:
            continue
        out.append({
            "ph": "X", "cat": SPAN_CATEGORY, "name": str(rec["op"]),
            "pid": pid, "tid": rows.get(rec.get("tid", 0),
                                        rec.get("tid", 0)),
            "ts": start * 1e6 + offset_us, "dur": dur_s * 1e6,
            "args": {k: v for k, v in rec.items() if k not in (
                "op", "startTime", "durationMs", "tid")}})
    return out


def span(op: str, **attrs: object) -> Span:
    """Context manager timing one operation:

        with span("ingest.request", stream=sid) as sp:
            ...
            sp.attrs["rows"] = n
    """
    return Span(op, dict(attrs))


def ingress_span(op: str, traceparent: Optional[str] = None,
                 sample_env: Optional[str] = None,
                 **attrs: object) -> Span:
    """A request-boundary span: adopts the remote trace context from a
    `traceparent` header, or mints a fresh (deterministically sampled)
    one. Everything nested under it — including on other threads via
    child_span — shares the trace id. `sample_env` names an env knob
    that overrides THEIA_TRACE_SAMPLE for THIS ingress (high-rate
    paths get their own dial)."""
    return Span(op, dict(attrs), ingress=True, traceparent=traceparent,
                sample_env=sample_env)


def child_span(op: str, ctx: Optional[TraceContext],
               **attrs: object) -> Span:
    """Continue an explicit context on ANOTHER thread (a pool worker
    running one slice of a request captured with current_context()).
    ctx=None means the originating request was untraced/unsampled —
    the child span times but retains nothing."""
    if ctx is None:
        ctx = TraceContext("", "", False)
    return Span(op, dict(attrs), ctx=ctx)


def current_op() -> Optional[str]:
    """The innermost span op on this thread (None outside any span)."""
    stack = getattr(_local, "stack", None)
    return stack[-1].op if stack else None


def current_span() -> Optional[Span]:
    """The innermost open span on this thread (None outside any)."""
    stack = getattr(_local, "stack", None)
    return stack[-1] if stack else None


def recent(limit: int = 100) -> List[Dict[str, object]]:
    """Most recent finished spans, newest first."""
    with _lock:
        out = list(_ring)
    out.reverse()
    return out[:max(0, limit)]


def spans_for_trace(trace_id: str) -> List[Dict[str, object]]:
    """Every retained span of one trace, or linked to it (`links`: a
    step that served several traces), oldest first — the local half
    of the cluster-stitched GET /debug/traces?trace=<id>."""
    tid = str(trace_id).strip().lower()
    with _lock:
        return [dict(rec) for rec in _ring
                if rec.get("traceId") == tid
                or tid in rec.get("links", ())]


def slowest() -> Dict[str, Dict[str, object]]:
    """op → its slowest recorded span (the exemplar)."""
    with _lock:
        return {op: dict(rec) for op, rec in sorted(_slowest.items())}


def reset() -> None:
    """Drop the ring and exemplars (tests)."""
    with _lock:
        _ring.clear()
        _slowest.clear()
