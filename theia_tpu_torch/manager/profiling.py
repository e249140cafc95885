"""On-demand profiler capture over the system API.

Ports theia_tpu/manager/profiling.py: a capture is a `torch.profiler`
trace of the given duration (CPU activity, plus CUDA activity when the
manager runs on a card), written as a Chrome trace (`trace.json`, which
Perfetto and chrome://tracing load) into the same tar.gz bundle.

The profiler records host operations only on the thread that started
it, but CUDA runtime calls and kernels of every thread. So the spans
(obs/trace.py) that finish in the capture, on any thread, are added to
`trace.json` as `theia_span` events on the trace's clock, each on the
row of its thread's CUDA runtime calls (`obs.trace.thread_rows`): the
offset from the wall clock comes from a marker the collector opens at
the capture's start, checked against the trace's `baseTimeNanoseconds`
and then taken out again (`add_spans`).

SURVEY §5/§7.7: the reference's only runtime introspection is
scraping the Spark UI REST and ClickHouse system tables
(pkg/apiserver/utils/stats/clickhouse_stats.go:92-117 dumps
system.stack_trace); it has no accelerator profiler at all. Here the
manager can capture a real XLA profile of whatever the engine is
doing — device kernels, host callbacks, transfers — and hand back the
trace directory as a tar.gz that loads straight into TensorBoard /
Perfetto / xprof.

    POST /apis/system.theia.antrea.io/v1alpha1/profiles
        body: {"durationSeconds": N}   (default 3, capped)
    GET  .../profiles                  → {"status": ..., "size": ...}
    GET  .../profiles/theia-manager/download → tar.gz

One capture at a time (the profiler cannot nest); bearer-token
protected with the rest of the system group.
"""

from __future__ import annotations

import io
import json
import os
import shutil
import tarfile
import tempfile
import time
from typing import Dict

import torch

from ..obs import trace as _trace
from ..utils import get_logger
from .collect import AsyncCollector

logger = get_logger("profiling")

MAX_DURATION_SECONDS = 60.0

#: the marker the collector opens at a capture's start (twice: the
#: first call pays the profiler's set-up), taken out of trace.json
CAPTURE_MARK = "theia.capture_start"
#: the marker's offset may differ from the one the trace's
#: baseTimeNanoseconds gives by this much, µs, before it is logged
MARK_TOLERANCE_US = 1000.0


def _mark() -> float:
    """Open the marker once; the wall clock (s) at its start, the
    midpoint of a reading before it and one inside it."""
    t0 = time.time()
    with torch.profiler.record_function(CAPTURE_MARK):
        t1 = time.time()
    return (t0 + t1) / 2


def add_spans(path: str, capture: _trace.Capture, mark_wall: float,
              end_wall: float) -> Dict[str, object]:
    """Rewrite the Chrome trace at `path`: the capture's markers out,
    and the span records of `capture` that lie wholly inside
    [mark_wall, end_wall] in, as `theia_span` events whose clock is
    the trace's (offset: the last marker's ts less `mark_wall`), each
    on its thread's row of CUDA runtime calls. Its
    `theiaSpans` key, returned too, counts the events added and the
    records the capture dropped, and gives the offset and its
    difference from the one baseTimeNanoseconds gives, µs."""
    with open(path) as f:
        doc = json.load(f)
    events = doc.get("traceEvents", [])
    marks = [float(e["ts"]) for e in events
             if e.get("name") == CAPTURE_MARK
             and e.get("cat") == "user_annotation"]
    doc["traceEvents"] = [e for e in events
                          if e.get("name") != CAPTURE_MARK]
    info: Dict[str, object] = {"exported": 0, "dropped": capture.dropped,
                               "offsetUs": None, "baseOffsetErrorUs": None}
    if marks:
        offset = max(marks) - mark_wall * 1e6
        info["offsetUs"] = offset
        base = doc.get("baseTimeNanoseconds")
        if base is not None:
            err = offset + float(base) / 1e3
            info["baseOffsetErrorUs"] = err
            if abs(err) > MARK_TOLERANCE_US:
                logger.error("profile: the capture marker's clock offset "
                             "differs from baseTimeNanoseconds' by "
                             "%.1f us", err)
        runtime = {e.get("tid") for e in events
                   if e.get("cat") in ("cuda_runtime", "cuda_driver")}
        spans = _trace.chrome_events(capture.records, offset, mark_wall,
                                     end_wall, os.getpid(),
                                     _trace.thread_rows(runtime))
        doc["traceEvents"].extend(spans)
        info["exported"] = len(spans)
    else:
        logger.error("profile: no capture marker in the trace; its "
                     "spans are left out")
    doc["theiaSpans"] = info
    with open(path, "w") as f:
        json.dump(doc, f, default=str)
    return info


class ProfileManager(AsyncCollector):
    """Async single-flight XLA trace collection."""

    kind = "Profile"

    def __init__(self, device="cuda") -> None:
        super().__init__()
        self.device = torch.device(device)
        self.duration: float = 0.0

    def create(self, duration_seconds: float = 3.0) -> Dict[str, object]:
        self.duration = min(max(float(duration_seconds), 0.1),
                            MAX_DURATION_SECONDS)
        return super().create(self.duration)

    def _extra_status(self) -> Dict[str, object]:
        return {"durationSeconds": self.duration}

    def _collect(self, duration: float) -> bytes:
        acts = [torch.profiler.ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        tmpdir = tempfile.mkdtemp(prefix="theia-torchprof-")
        capture = _trace.start_capture()
        try:
            try:
                with torch.profiler.profile(activities=acts) as prof:
                    _mark()
                    mark_wall = _mark()
                    time.sleep(duration)
                    end_wall = time.time()
            finally:
                _trace.stop_capture(capture)
            path = os.path.join(tmpdir, "trace.json")
            prof.export_chrome_trace(path)
            add_spans(path, capture, mark_wall, end_wall)
            buf = io.BytesIO()
            with tarfile.open(fileobj=buf, mode="w:gz") as tar:
                for root, _dirs, files in os.walk(tmpdir):
                    for f in files:
                        full = os.path.join(root, f)
                        tar.add(full,
                                arcname=os.path.relpath(full, tmpdir))
            logger.v(1).info("profile captured: %.1fs", duration)
            return buf.getvalue()
        finally:
            shutil.rmtree(tmpdir, ignore_errors=True)
