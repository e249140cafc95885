"""Job progress reporting, shaped like the Spark UI REST the reference
controllers scrape (pkg/controller/util.go:129-159 reads
/api/v1/applications/<id>/stages and surfaces completedStages/
totalStages into CRD status).

The runner updates a JSON document after every stage; it is written
atomically to a file (for the file-based manager/controller seam) and
kept in memory for in-process callers.

Each stage is also timed as a `job.stage` span (obs/trace.py, attrs
`stage`, `kind`, `job`): stage() starts the clock, and the next
stage(), done() or fail() publishes the record, as a child of the span
that was open when the stage began (a job's `job.run`, so it joins the
job's trace). No span is left open on the thread between the calls; the
stage an attempt that is retried failed in is not published.
"""

from __future__ import annotations

import json
import threading
import time
from typing import List, Optional

from ..obs import trace as _trace
from ..utils import atomic_write
from ..analysis.lockdep import named_lock


class JobProgress:
    """Tracks named stages of one job run.

    States mirror the Spark application lifecycle the controllers map
    into CRD status (controller.go:458-500): RUNNING → COMPLETED/FAILED.
    """

    def __init__(self, job_id: str, stages: List[str],
                 path: Optional[str] = None, kind: str = "",
                 job: Optional[str] = None) -> None:
        self.job_id = job_id
        self.stages = list(stages)
        self.path = path
        #: the job's kind and name, as attrs of its stage spans
        self.kind = kind
        self.job = job or job_id
        #: the open stage: (name, wall start, perf_counter start, the
        #: span it is a child of)
        self._open: Optional[tuple] = None
        self._completed = 0
        self._state = "RUNNING"
        self._error = ""
        self._current = ""
        self._started = time.time()
        self._lock = named_lock("runner.progress")
        self._flush()

    def stage(self, name: str) -> None:
        with self._lock:
            if self._current:
                self._completed += 1
            self._current = name
        self._end_stage()
        self._open = (name, time.time(), time.perf_counter(),
                      _trace.current_span())
        self._flush()

    def done(self) -> None:
        with self._lock:
            self._completed = len(self.stages)
            self._current = ""
            self._state = "COMPLETED"
        self._end_stage()
        self._flush()

    def fail(self, error: str) -> None:
        with self._lock:
            self._state = "FAILED"
            self._error = error
        self._end_stage(error=error)
        self._flush()

    def _end_stage(self, **attrs: object) -> None:
        opened, self._open = self._open, None
        if opened is not None:
            name, start, t0, parent = opened
            _trace.record_in(parent, "job.stage", start,
                             time.perf_counter() - t0, stage=name,
                             kind=self.kind, job=self.job, **attrs)

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "id": self.job_id,
                "state": self._state,
                "currentStage": self._current,
                "completedStages": self._completed,
                "totalStages": len(self.stages),
                "errorMsg": self._error,
                "startedAt": self._started,
            }

    def _flush(self) -> None:
        if not self.path:
            return
        snap = self.snapshot()

        def write(tmp: str) -> None:
            with open(tmp, "w") as f:
                json.dump(snap, f)

        atomic_write(self.path, write)


class FileProgress:
    """Read side of a runner's --progress-file: the manager's
    equivalent of the reference scraping the Spark UI REST into CRD
    status (pkg/controller/util.go:129-159). snapshot() re-reads the
    file and caches the last good document, so status stays correct
    after the job's scratch directory is cleaned up."""

    def __init__(self, job_id: str, stages: List[str],
                 path: str) -> None:
        self.job_id = job_id
        self.stages = list(stages)
        self.path = path
        self._last = {
            "id": job_id,
            "state": "RUNNING",
            "currentStage": "",
            "completedStages": 0,
            "totalStages": len(stages),
            "errorMsg": "",
            "startedAt": time.time(),
        }

    def snapshot(self) -> dict:
        try:
            with open(self.path) as f:
                doc = json.load(f)
            if isinstance(doc, dict) and "completedStages" in doc:
                self._last = doc
        except (OSError, ValueError):
            pass   # mid-write/retired file: serve the cached snapshot
        return dict(self._last)

    def fail(self, error: str) -> None:
        """The runner process owns the file; just reflect the failure
        in the cached snapshot for status readers."""
        self._last = {**self._last, "state": "FAILED",
                      "errorMsg": error}


TAD_STAGES = ["read", "tensorize", "score", "write"]
NPR_STAGES = ["read", "recommend", "write"]
DD_STAGES = ["read", "tensorize", "score", "write"]
FPM_STAGES = ["read", "mine", "write"]
SPATIAL_STAGES = ["read", "embed", "score", "write"]
