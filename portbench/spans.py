"""Span arithmetic over a traced run's device trace: the manager's spans
(`theia_span` events, which its profile endpoint adds to the capture's
Chrome trace, each on its thread's row) against the card's operations
in the same trace.

A device operation was launched inside a span when the CUDA runtime
call that launched it (the two share the `correlation` arg) was made
on the span's thread (`tid`) while the span was open. A trace without
spans (a program that exports none) gives no reading: every function
here returns None or an empty list for it, and raises nothing.
"""

from __future__ import annotations

import bisect
from typing import Dict, Iterable, List, Optional, Tuple

from portbench import harness

SPAN_CAT = "theia_span"
RUNTIME_CATS = ("cuda_runtime", "cuda_driver")


def spans(trace: dict, op: str, lo: float = float("-inf"),
          hi: float = float("inf")) -> List[dict]:
    """The `op` spans that lie wholly inside [lo, hi] (µs), by start."""
    out = [e for e in trace.get("traceEvents", [])
           if e.get("cat") == SPAN_CAT and e.get("name") == op
           and lo <= float(e["ts"])
           and float(e["ts"]) + float(e["dur"]) <= hi]
    return sorted(out, key=lambda e: float(e["ts"]))


def job_kind(ctx) -> str:
    """The manager's job kind of the cell's API resource, as job.run_s
    filters by it."""
    return harness.metric_reader("job.run_s").KIND[ctx.traffic["resource"]]


def job_runs(ctx) -> List[dict]:
    """The `job.run` spans of the cell's job kind wholly inside the
    capture."""
    if ctx.trace_doc is None:
        return []
    lo, hi = ctx.trace_span
    kind = job_kind(ctx)
    return [e for e in spans(ctx.trace_doc, "job.run", lo, hi)
            if e.get("args", {}).get("kind") == kind]


def stage_ms(ctx, stage: str) -> Optional[float]:
    """Mean length of the whole `job.stage` spans of `stage` and the
    cell's job kind in the capture, ms."""
    if ctx.trace_doc is None:
        return None
    lo, hi = ctx.trace_span
    kind = job_kind(ctx)
    durs = [float(e["dur"]) for e in spans(ctx.trace_doc, "job.stage", lo, hi)
            if e.get("args", {}).get("stage") == stage
            and e.get("args", {}).get("kind") == kind]
    return sum(durs) / len(durs) / 1e3 if durs else None


def _inside(by_tid: Dict[object, Tuple[List[float], List[float]]],
            tid, ts: float) -> bool:
    got = by_tid.get(tid)
    if got is None:
        return False
    starts, ends = got
    i = bisect.bisect_right(starts, ts) - 1
    return i >= 0 and ts <= ends[i]


def launched(trace: dict, inside: Iterable[dict]
             ) -> List[Tuple[float, float, str]]:
    """(start µs, end µs, name) of the device operations launched inside
    any of the spans `inside` (spans of one thread must not overlap)."""
    by_tid: Dict[object, Tuple[List[float], List[float]]] = {}
    for e in sorted(inside, key=lambda e: float(e["ts"])):
        starts, ends = by_tid.setdefault(e["tid"], ([], []))
        starts.append(float(e["ts"]))
        ends.append(float(e["ts"]) + float(e["dur"]))
    if not by_tid:
        return []
    events = trace.get("traceEvents", [])
    corr = {e["args"]["correlation"] for e in events
            if e.get("cat") in RUNTIME_CATS and e.get("ph") == "X"
            and "correlation" in e.get("args", {})
            and _inside(by_tid, e.get("tid"), float(e["ts"]))}
    return sorted((float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)),
                   str(e.get("name", "")))
                  for e in events
                  if e.get("ph") == "X" and e.get("cat") in harness.DEVICE_CATS
                  and e.get("args", {}).get("correlation") in corr)


def pass_ms(ctx, op: str) -> Optional[float]:
    """Device time a job of the operations launched inside the `op`
    spans of the capture's whole jobs of the cell's kind, ms."""
    runs = job_runs(ctx)
    if not runs:
        return None
    ids = {r["args"].get("traceId") for r in runs}
    inside = [e for e in spans(ctx.trace_doc, op)
              if e.get("args", {}).get("traceId") in ids]
    if not inside:
        return None
    return harness.busy_us(launched(ctx.trace_doc, inside)) / len(runs) / 1e3


def idle_gaps(merged: List[Tuple[float, float]], lo: float,
              hi: float) -> List[Tuple[float, float]]:
    """The stretches of [lo, hi] that no interval of `merged` (a union,
    sorted and disjoint) covers."""
    i = bisect.bisect_right([e for _, e in merged], lo)
    gaps, prev = [], lo
    for s, e in merged[i:]:
        if s >= hi:
            break
        if s > prev:
            gaps.append((prev, s))
        prev = max(prev, e)
    if hi > prev:
        gaps.append((prev, hi))
    return gaps


def device_idle_ms(ctx) -> Optional[float]:
    """Mean time a job, inside each whole `job.run` span of the cell's
    kind in the capture, when no operation ran on the card, ms."""
    runs = job_runs(ctx)
    if not runs:
        return None
    merged = harness.union(harness.trace_device_events(ctx.trace_doc))
    idle = [sum(e - s for s, e in idle_gaps(
        merged, float(r["ts"]), float(r["ts"]) + float(r["dur"])))
        for r in runs]
    return sum(idle) / len(idle) / 1e3


def idle_cover(trace: dict, run: dict, names: Iterable[str]
               ) -> Tuple[float, Dict[str, float]]:
    """(µs of the card's idle time inside the span `run`, {name: µs of
    it under that name's spans of run's trace}, and under "all" the
    union of them). A name is an op, or `job.stage:<stage>` for one
    stage's spans."""
    lo, hi = float(run["ts"]), float(run["ts"]) + float(run["dur"])
    merged = harness.union(harness.trace_device_events(trace), lo, hi)
    gaps = idle_gaps(merged, lo, hi)
    tid = run["args"].get("traceId")
    cover: Dict[str, float] = {}
    every: List[Tuple[float, float]] = []
    for name in names:
        op, _, stage = name.partition(":")
        own = [(float(e["ts"]), float(e["ts"]) + float(e["dur"]))
               for e in spans(trace, op, lo, hi)
               if e.get("args", {}).get("traceId") == tid
               and (not stage or e["args"].get("stage") == stage)]
        every += own
        cover[name] = sum(harness.busy_us(own, s, e) for s, e in gaps)
    cover["all"] = sum(harness.busy_us(every, s, e) for s, e in gaps)
    return sum(e - s for s, e in gaps), cover
