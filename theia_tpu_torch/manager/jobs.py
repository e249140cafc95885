"""Job records + controller state machine for NPR/TAD jobs.

Re-provides the reference's CRD controllers
(pkg/controller/networkpolicyrecommendation/controller.go and
pkg/controller/anomalydetector/controller.go): a job CR moves through
NEW → SCHEDULED → RUNNING → COMPLETED/FAILED (state machine
controller.go:375-427), with progress scraped into status while RUNNING
(:429-456), results garbage-collected when the CR is deleted
(cleanupNPRecommendation :390-403), and stale result rows reconciled
against live CRs at startup (HandleStaleDbEntries util.go:239-270).

Two dispatch modes mirror the reference's two execution tiers:

  dispatch="thread"      — jobs run on in-process worker threads
                           against the shared FlowDatabase (the quick
                           path; no isolation).
  dispatch="subprocess"  — each job runs as a `python -m
                           theia_tpu_torch.runner` child process against a
                           snapshot of the database, with progress
                           scraped from --progress-file and result
                           rows merged back on success. This is the
                           reference's Spark driver/executor process
                           boundary (pkg/controller/util.go:129-159,
                           223-293): a crashing or OOMing kernel kills
                           the RUNNER, not the manager — the record
                           goes FAILED with the child's stderr tail.
                           Device access is serialized across jobs
                           (one child owns the accelerator at a time).

Ports theia_tpu/manager/jobs.py. Both modes run a job's device work on
the controller's torch device (`device=`, default "cuda"): thread
dispatch passes it to the analytics entry points, subprocess dispatch
hands it to a `python -m theia_tpu_torch.runner` child as `--device`
(for example `cuda:0`). The child builds its own CUDA context, so a
device-side assert or an out-of-memory in a job cannot break the one
the manager's live scoring uses.
"""

from __future__ import annotations

import dataclasses
import datetime
import json
import os
import queue
import shutil
import subprocess
import sys
import tempfile
import threading
import time
import traceback
import uuid
import zlib
from typing import Dict, List, Optional

import numpy as np

from ..analytics import (TadQuerySpec, run_drop_detection, run_npr,
                         run_pattern_mining, run_spatial, run_tad)
from ..obs import metrics as _obs_metrics
from ..obs import trace as _obs_trace
from ..runner.__main__ import TIME_FORMAT as RUNNER_TIME_FORMAT
from ..runner.__main__ import TRANSIENT_EXIT_CODE
from ..runner.progress import (DD_STAGES, FPM_STAGES, NPR_STAGES,
                               SPATIAL_STAGES, TAD_STAGES,
                               FileProgress, JobProgress)
from ..store import FlowDatabase
from ..utils import get_logger, parse_job_name, validate_policy_type
from ..utils.backoff import capped_backoff
from ..utils.device import resolve_device
from ..utils.env import env_float, env_int
from ..utils.faults import FaultError
from ..utils.faults import fire as _fire_fault
from ..analysis.lockdep import named_lock

logger = get_logger("jobs")

_M_QUEUE_WAIT = _obs_metrics.histogram(
    "theia_job_queue_wait_seconds",
    "Time from job creation to its first execution attempt")
_M_RUN = _obs_metrics.histogram(
    "theia_job_run_seconds",
    "Wall time of one job execution attempt", labelnames=("kind",))
_M_JOBS = _obs_metrics.counter(
    "theia_jobs_total", "Jobs reaching a terminal state",
    labelnames=("kind", "state"))
_M_RETRIES = _obs_metrics.counter(
    "theia_job_retries_total",
    "Transient job failures re-queued with backoff")
_M_DEADLINE_KILLS = _obs_metrics.counter(
    "theia_job_deadline_kills_total",
    "Runner children killed at deadlineSeconds")

STATE_NEW = "NEW"
STATE_SCHEDULED = "SCHEDULED"
STATE_RUNNING = "RUNNING"
STATE_COMPLETED = "COMPLETED"
STATE_FAILED = "FAILED"

KIND_NPR = "npr"
KIND_TAD = "tad"
KIND_DD = "dd"
KIND_FPM = "fpm"        # frequent flow-pattern mining
KIND_SPATIAL = "sad"    # spatial anomaly detection

_NAME_PREFIX = {KIND_NPR: "pr-", KIND_TAD: "tad-", KIND_DD: "dd-",
                KIND_FPM: "fpm-", KIND_SPATIAL: "sad-"}

#: job kind → its result table in FlowDatabase.result_tables
_RESULT_TABLE = {KIND_NPR: "recommendations", KIND_TAD: "tadetector",
                 KIND_DD: "dropdetection", KIND_FPM: "flowpatterns",
                 KIND_SPATIAL: "spatialnoise"}

_STAGES = {KIND_NPR: NPR_STAGES, KIND_TAD: TAD_STAGES,
           KIND_DD: DD_STAGES, KIND_FPM: FPM_STAGES,
           KIND_SPATIAL: SPATIAL_STAGES}

#: policy mode → job --option (reference recommend_policies_for_
#: unprotected_flows, policy_recommendation_job.py:714); shared by
#: both dispatch paths so they cannot diverge.
POLICY_TYPE_OPTION = {"anp-deny-applied": 1, "anp-deny-all": 2,
                      "k8s-np": 3}


class DuplicateJobError(Exception):
    """A job with this name already exists (→ HTTP 409)."""


class DeadlineExceeded(Exception):
    """The runner child outlived its deadlineSeconds and was killed
    (the Spark Operator's activeDeadlineSeconds role). Terminal: the
    next attempt would hang the same way."""


class TransientJobError(Exception):
    """A failure classification worth retrying — the runner died to a
    signal or fault-injected I/O, never a spec error (those fail
    fast)."""


def _validate_max_len(spec) -> int:
    """Pattern-mining maxLen ∈ {1,2,3}, enforced identically in both
    dispatch modes (the runner's argparse would reject 4+ anyway —
    thread mode must not silently accept what subprocess mode fails).
    Absent → 3; 0 is rejected, not coerced."""
    raw = spec.get("maxLen")
    max_len = 3 if raw is None else int(raw)
    if not 1 <= max_len <= 3:
        raise ValueError(f"maxLen must be 1, 2, or 3, got {max_len}")
    return max_len


def job_id_from_name(kind: str, name: str) -> str:
    """pr-<uuid> / tad-<uuid> → <uuid> (reference ParseRecommendationName
    / ParseADAlgorithmName, pkg/util/utils.go)."""
    return parse_job_name(name, _NAME_PREFIX[kind])


@dataclasses.dataclass
class JobRecord:
    name: str
    kind: str                      # KIND_NPR | KIND_TAD | KIND_DD
    spec: Dict[str, object]
    state: str = STATE_NEW
    error_msg: str = ""
    start_time: float = 0.0
    end_time: float = 0.0
    progress: Optional[object] = None   # JobProgress | FileProgress
    runner_pid: int = 0                 # subprocess dispatch only
    runner_log_tail: str = ""           # child stderr tail (bundle)
    max_retries: int = 0                # spec `retries` / controller dflt
    deadline_seconds: float = 0.0       # spec `deadlineSeconds`; 0 = off
    attempts: int = 0                   # completed execution attempts
    last_failure: str = ""              # most recent attempt's failure
    created_time: float = 0.0           # queue-wait measurement anchor

    @property
    def job_id(self) -> str:
        return job_id_from_name(self.kind, self.name)

    def status_dict(self) -> Dict[str, object]:
        completed, total = 0, 0
        if self.progress is not None:
            snap = self.progress.snapshot()
            completed = snap["completedStages"]
            total = snap["totalStages"]
        return {
            "state": self.state,
            "sparkApplication": self.job_id,
            "completedStages": completed,
            "totalStages": total,
            "errorMsg": self.error_msg,
            "startTime": self.start_time,
            "endTime": self.end_time,
            "attempts": self.attempts,
            "retries": self.max_retries,
            "lastFailureReason": self.last_failure,
        }


class JobController:
    """Reconciles job records into analytics runs over a worker pool."""

    def __init__(self, db: FlowDatabase, workers: int = 2,
                 dispatch: str = "thread",
                 alert_sink=None,
                 retries: Optional[int] = None,
                 deadline_seconds: Optional[float] = None,
                 retry_backoff_base: float = 0.5,
                 retry_backoff_cap: float = 30.0,
                 device="cuda") -> None:
        if dispatch not in ("thread", "subprocess"):
            raise ValueError(f"unknown dispatch mode {dispatch!r}")
        self.device = resolve_device(device)
        self.db = db
        self.dispatch = dispatch
        # Supervision defaults (per-job spec keys override): retry
        # budget for TRANSIENT failures and the runner-child deadline —
        # the Spark Operator's restartPolicy / activeDeadlineSeconds.
        self.default_retries = (env_int("THEIA_JOB_RETRIES", 0)
                                if retries is None else int(retries))
        self.default_deadline = (
            env_float("THEIA_JOB_DEADLINE", 0.0)
            if deadline_seconds is None else float(deadline_seconds))
        self.retry_backoff_base = retry_backoff_base
        self.retry_backoff_cap = retry_backoff_cap
        #: optional callable(dict) — completed spatial jobs push their
        #: noise flows here (the manager wires the ingest alert ring)
        self.alert_sink = alert_sink
        # One job owns the accelerator at a time in subprocess mode:
        # two children would interleave compilations and thrash HBM.
        self._device_lock = named_lock("jobs.device")
        self._records: Dict[str, JobRecord] = {}
        self._lock = named_lock("jobs.controller")
        #: job name → (Timer, record) for retries waiting out their
        #: backoff; cancelled (and the records failed) on shutdown
        self._retry_timers: Dict[str, tuple] = {}
        self._queue: "queue.Queue[str]" = queue.Queue()
        self._stop = threading.Event()
        self._threads = [
            threading.Thread(target=self._worker, daemon=True,
                             name=f"job-worker-{i}")
            for i in range(workers)]
        for t in self._threads:
            t.start()
        self.gc_stale_results()

    # -- CRUD ------------------------------------------------------------

    def _spec_retries(self, spec: Dict[str, object]) -> int:
        raw = spec.get("retries")
        n = self.default_retries if raw is None else int(raw)
        if n < 0:
            raise ValueError(f"retries must be >= 0, got {n}")
        return n

    def _spec_deadline(self, spec: Dict[str, object]) -> float:
        raw = spec.get("deadlineSeconds")
        d = self.default_deadline if raw is None else float(raw)
        if d < 0:
            raise ValueError(f"deadlineSeconds must be >= 0, got {d}")
        return d

    def create(self, kind: str, spec: Dict[str, object],
               name: Optional[str] = None) -> JobRecord:
        if name is None:
            name = _NAME_PREFIX[kind] + str(uuid.uuid4())
        job_id_from_name(kind, name)  # validate
        record = JobRecord(name=name, kind=kind, spec=dict(spec),
                           state=STATE_SCHEDULED,
                           max_retries=self._spec_retries(spec),
                           deadline_seconds=self._spec_deadline(spec),
                           created_time=time.time())
        if record.deadline_seconds and self.dispatch == "thread":
            # an in-process job shares our interpreter; Python offers
            # no safe thread kill, so only subprocess dispatch can
            # enforce the deadline — say so instead of silently not
            logger.error("job %s: deadlineSeconds=%g is not "
                         "enforceable under thread dispatch (a hung "
                         "in-process job cannot be killed); use "
                         "--dispatch subprocess for deadline "
                         "supervision", name, record.deadline_seconds)
        with self._lock:
            if name in self._records:
                raise DuplicateJobError(f"job {name} already exists")
            self._records[name] = record
        self._queue.put(name)
        return record

    def get(self, name: str) -> JobRecord:
        with self._lock:
            return self._records[name]

    def list(self, kind: Optional[str] = None) -> List[JobRecord]:
        with self._lock:
            records = list(self._records.values())
        if kind:
            records = [r for r in records if r.kind == kind]
        return records

    def delete(self, name: str) -> None:
        """Remove the CR and GC its result rows (reference
        cleanupNPRecommendation deletes recommendations by id)."""
        with self._lock:
            record = self._records.pop(name)
        self._delete_results(record.kind, record.job_id)

    # -- GC --------------------------------------------------------------

    def gc_stale_results(self) -> int:
        """Drop result rows whose job CR no longer exists (reference
        HandleStaleDbEntries, run from the controller gcQueue at
        startup)."""
        with self._lock:
            live = {r.job_id for r in self._records.values()}
        removed = 0
        for table in self.db.result_tables.values():
            if not any(c.name == "id" for c in table.schema):
                # not a job-results table (the `__metrics__` history
                # table rides result_tables for WAL/replication but
                # has no job id — its own retention owns deletion)
                continue
            # value-based delete: identical logical rows can sit in
            # different physical orders across shards/replicas, so a
            # positional mask would be wrong there
            removed += table.delete_ids(live, invert=True)
        return removed

    def _delete_results(self, kind: str, job_id: str) -> None:
        self.db.result_tables[_RESULT_TABLE[kind]].delete_ids([job_id])

    # -- result retrieval ------------------------------------------------

    def recommendation_outcome(self, name: str) -> str:
        """Joined policy YAML for a COMPLETED NPR job (reference
        getRecommendationResult joins rows with '---\\n', rest.go:213)."""
        job_id = job_id_from_name(KIND_NPR, name)
        data = self.db.recommendations.scan()
        if not len(data):
            return ""
        rows = data.filter(data.strings("id") == job_id)
        return "---\n".join(rows.strings("policy"))

    def _result_stats(self, kind: str, table,
                      name: str) -> List[Dict[str, str]]:
        """Result rows for a job as string-typed stat entries
        (reference getTADetectorResult, rest.go:249-310)."""
        job_id = job_id_from_name(kind, name)
        data = table.scan()
        if not len(data):
            return []
        rows = data.filter(data.strings("id") == job_id)
        return [{k: str(v) for k, v in row.items()}
                for row in rows.to_rows()]

    def tad_stats(self, name: str) -> List[Dict[str, str]]:
        return self._result_stats(KIND_TAD, self.db.tadetector, name)

    def drop_detection_stats(self, name: str) -> List[Dict[str, str]]:
        return self._result_stats(KIND_DD, self.db.dropdetection, name)

    def result_stats(self, kind: str, name: str) -> List[Dict[str, str]]:
        """Generic result rows for any job kind (the per-kind helpers
        above remain for the established call sites)."""
        return self._result_stats(
            kind, self.db.result_tables[_RESULT_TABLE[kind]], name)

    # -- workers ---------------------------------------------------------

    def _worker(self) -> None:
        while not self._stop.is_set():
            try:
                name = self._queue.get(timeout=0.2)
            except queue.Empty:
                continue
            try:
                with self._lock:
                    record = self._records.get(name)
                if record is None:    # deleted before it ran
                    continue
                self._run(record)
            finally:
                self._queue.task_done()

    @staticmethod
    def _is_transient(e: BaseException) -> bool:
        """Retry-worthy failure classes: the runner died to a signal or
        injected I/O fault. Spec/validation errors and deadline kills
        stay terminal (they would fail identically on every retry)."""
        return isinstance(e, (TransientJobError, FaultError))

    def _retry_delay(self, record: JobRecord) -> float:
        """Exponential backoff with DETERMINISTIC jitter (crc32 of
        name+attempt → a [1.0, 1.5) factor): a retry herd spreads out,
        and a test replaying the same job sees the same schedule. The
        cap bounds the base schedule and the jitter rides on top —
        clamping after jitter would re-synchronize every capped-out
        retry to exactly the cap, recreating the herd."""
        frac = (zlib.crc32(
            f"{record.name}:{record.attempts}".encode()) % 1000) / 1000.0
        return capped_backoff(self.retry_backoff_base,
                              self.retry_backoff_cap,
                              record.attempts) * (1.0 + 0.5 * frac)

    def _on_failure(self, record: JobRecord, e: BaseException) -> None:
        """FAILED — or, for a transient failure with retry budget left,
        re-queue after a backoff. The backoff runs on a timer, not in
        the worker (a worker parked in sleep would starve healthy
        SCHEDULED jobs); the record stays SCHEDULED through the delay,
        so wait_all() keeps waiting on it."""
        msg = f"{type(e).__name__}: {e}"
        record.last_failure = msg
        retryable = (self._is_transient(e)
                     and record.attempts <= record.max_retries
                     and not self._deleted(record)
                     and not self._stop.is_set())
        if retryable:
            _M_RETRIES.inc()
            delay = self._retry_delay(record)
            record.state = STATE_SCHEDULED
            logger.error("job %s attempt %d/%d failed (%s); retrying "
                         "in %.2fs", record.name, record.attempts,
                         record.max_retries + 1, msg, delay)

            def _requeue() -> None:
                with self._lock:
                    self._retry_timers.pop(record.name, None)
                if self._stop.is_set() or self._deleted(record):
                    record.state = STATE_FAILED
                    record.error_msg = msg
                else:
                    self._queue.put(record.name)

            timer = threading.Timer(delay, _requeue)
            timer.daemon = True
            with self._lock:
                self._retry_timers[record.name] = (timer, record)
            timer.start()
            return
        record.state = STATE_FAILED
        record.error_msg = msg
        _M_JOBS.labels(kind=record.kind, state="failed").inc()
        if record.progress:
            record.progress.fail(msg)
        logger.error("job %s failed: %s\n%s", record.name, msg,
                     traceback.format_exc())

    def _run(self, record: JobRecord) -> None:
        record.state = STATE_RUNNING
        record.attempts += 1
        record.start_time = time.time()
        if record.attempts == 1 and record.created_time:
            _M_QUEUE_WAIT.observe(
                max(0.0, record.start_time - record.created_time))
        logger.v(1).info("job %s started (%s, attempt %d)", record.name,
                         self.dispatch, record.attempts)
        try:
            # a trace ingress: each run is its own trace root, so the
            # spans of whatever the job touches stitch under one id
            with _obs_trace.ingress_span("job.run", job=record.name,
                                         kind=record.kind,
                                         attempt=record.attempts):
                if self.dispatch == "subprocess":
                    self._run_subprocess(record)
                else:
                    self._run_inprocess(record)
            record.state = STATE_COMPLETED
            _M_JOBS.labels(kind=record.kind, state="completed").inc()
            logger.v(1).info("job %s completed in %.2fs", record.name,
                             time.time() - record.start_time)
            if record.kind == KIND_SPATIAL and self.alert_sink:
                try:
                    # best-effort side effect: a sink failure must not
                    # flip a COMPLETED job to FAILED; it runs on the
                    # worker after job.run, so its span is its own
                    with _obs_trace.span("job.alert_push",
                                         job=record.name):
                        self._push_spatial_alerts(record)
                except Exception:
                    logger.error("job %s: alert push failed\n%s",
                                 record.name, traceback.format_exc())
        except Exception as e:   # job failure → FAILED CR or retry
            self._on_failure(record, e)
        finally:
            record.end_time = time.time()
            _M_RUN.labels(kind=record.kind).observe(
                max(0.0, record.end_time - record.start_time))
            # If the CR was deleted while the job ran, its result rows
            # were written after delete()'s GC — clean them up now so
            # in-flight deletes keep the reference's cleanup semantics.
            # (Identity check: a same-named recreation owns the name
            # and its results now.)
            if self._deleted(record):
                self._delete_results(record.kind, record.job_id)

    def _push_spatial_alerts(self, record: JobRecord) -> None:
        """Surface a completed spatial job's noise flows on the live
        alert surface (GET /alerts) — batch results feed the streaming
        ring the way the reference's batch TAD never could. Reads the
        result table directly (result_stats stringifies every value;
        alerts carry native types like the other alert kinds)."""
        table = self.db.result_tables[_RESULT_TABLE[KIND_SPATIAL]]
        data = table.scan()
        if not len(data):
            return
        rows = data.filter(data.strings("id") == record.job_id)
        # Cap the push: the alert ring is a bounded shared surface
        # (ingest.MAX_ALERTS slots) — one large batch result must not
        # evict every live streaming/heavy-hitter alert. Keep the
        # highest-volume noise flows; the full set stays queryable via
        # the job's results.
        cap = 100
        if len(rows) > cap:
            logger.info(
                "job %s: %d noise flows; publishing top %d by bytes",
                record.name, len(rows), cap)
            top = np.argsort(
                np.asarray(rows["octetDeltaCount"]))[-cap:][::-1]
            rows = rows.take(top)
        src = rows.strings("sourceIP")
        dst = rows.strings("destinationIP")
        ports = np.asarray(rows["destinationTransportPort"])
        octets = np.asarray(rows["octetDeltaCount"])
        for i in range(len(rows)):
            self.alert_sink({
                "kind": "spatial_noise",
                "job": record.name,
                "sourceIP": str(src[i]),
                "destinationIP": str(dst[i]),
                "destinationTransportPort": int(ports[i]),
                "octetDeltaCount": int(octets[i]),
            })

    def _run_inprocess(self, record: JobRecord) -> None:
        # same site the runner child fires in subprocess dispatch, so
        # a transient execution fault is injectable in both modes
        _fire_fault("runner.exec", job=record.name)
        spec = record.spec
        if record.kind == KIND_FPM:
            from ..analytics.itemsets import DEFAULT_COLUMNS
            record.progress = JobProgress(record.job_id, FPM_STAGES,
                                          kind=record.kind,
                                          job=record.name)
            run_pattern_mining(
                self.db,
                min_support=int(spec.get("minSupport", 0) or 0),
                columns=tuple(spec.get("columns") or DEFAULT_COLUMNS),
                max_len=_validate_max_len(spec),
                start_time=spec.get("startInterval") or None,
                end_time=spec.get("endInterval") or None,
                mining_id=record.job_id,
                progress=record.progress,
                device=self.device)
            return
        if record.kind == KIND_SPATIAL:
            from ..analytics.spatial import (DEFAULT_EPS,
                                             DEFAULT_MIN_SAMPLES)
            record.progress = JobProgress(record.job_id,
                                          SPATIAL_STAGES,
                                          kind=record.kind,
                                          job=record.name)
            run_spatial(
                self.db,
                eps=float(spec.get("eps") or DEFAULT_EPS),
                min_samples=int(spec.get("minSamples")
                                or DEFAULT_MIN_SAMPLES),
                start_time=spec.get("startInterval") or None,
                end_time=spec.get("endInterval") or None,
                spatial_id=record.job_id,
                progress=record.progress,
                device=self.device)
            return
        if record.kind == KIND_TAD:
            record.progress = JobProgress(record.job_id, TAD_STAGES,
                                          kind=record.kind,
                                          job=record.name)
            run_tad(
                self.db, str(spec.get("jobType", "EWMA")),
                TadQuerySpec(
                    start_time=spec.get("startInterval") or None,
                    end_time=spec.get("endInterval") or None,
                    ns_ignore_list=spec.get("nsIgnoreList") or (),
                    agg_flow=str(spec.get("aggFlow", "") or ""),
                    pod_label=str(spec.get("podLabel", "") or ""),
                    pod_name=str(spec.get("podName", "") or ""),
                    pod_namespace=str(
                        spec.get("podNameSpace", "") or ""),
                    external_ip=str(spec.get("externalIp", "") or ""),
                    svc_port_name=str(
                        spec.get("servicePortName", "") or ""),
                    cluster_uuid=str(
                        spec.get("clusterUUID", "") or ""),
                    # 0 = auto cadence; absent = reference-exact.
                    refit_every=int(spec["refitEvery"])
                    if spec.get("refitEvery") is not None else 1),
                tad_id=record.job_id,
                progress=record.progress,
                device=self.device)
        elif record.kind == KIND_DD:
            record.progress = JobProgress(record.job_id, DD_STAGES,
                                          kind=record.kind,
                                          job=record.name)
            run_drop_detection(
                self.db,
                job_type=str(spec.get("jobType", "initial")),
                detection_id=record.job_id,
                start_time=spec.get("startInterval") or None,
                end_time=spec.get("endInterval") or None,
                cluster_uuid=str(spec.get("clusterUUID", "") or ""),
                progress=record.progress,
                device=self.device)
        else:
            record.progress = JobProgress(record.job_id, NPR_STAGES,
                                          kind=record.kind,
                                          job=record.name)
            policy_type = validate_policy_type(
                str(spec.get("policyType", "anp-deny-applied")))
            option = POLICY_TYPE_OPTION[policy_type]
            run_npr(
                self.db,
                recommendation_type=str(spec.get("jobType",
                                                 "initial")),
                limit=int(spec.get("limit", 0) or 0),
                option=option,
                start_time=spec.get("startInterval") or None,
                end_time=spec.get("endInterval") or None,
                ns_allow_list=spec.get("nsAllowList") or None,
                rm_labels=bool(spec.get("excludeLabels", True)),
                to_services=bool(spec.get("toServices", True)),
                recommendation_id=record.job_id,
                progress=record.progress,
                device=self.device)

    # -- subprocess dispatch ---------------------------------------------

    def _fmt_time(self, value) -> str:
        # RUNNER_TIME_FORMAT: the runner CLI's own constant, so the
        # controller's formatting can't drift from its parsing.
        return datetime.datetime.fromtimestamp(
            int(value), tz=datetime.timezone.utc
        ).strftime(RUNNER_TIME_FORMAT)

    def _runner_args(self, record: JobRecord) -> List[str]:
        """record.spec → the runner's Spark-job-shaped CLI argv
        (reverse of the controllers' arg-build,
        pkg/controller/anomalydetector/controller.go:525-620).
        Validation errors raise here, before a process is spawned."""
        spec = record.spec
        args: List[str] = []
        if record.kind == KIND_TAD:
            args += ["tad", "--algo", str(spec.get("jobType", "EWMA"))]
            if spec.get("nsIgnoreList"):
                args += ["-n", json.dumps(spec["nsIgnoreList"])]
            for flag, key in (
                    ("--agg-flow", "aggFlow"),
                    ("--pod-label", "podLabel"),
                    ("--pod-name", "podName"),
                    ("--pod-namespace", "podNameSpace"),
                    ("--external-ip", "externalIp"),
                    ("--svc-port-name", "servicePortName"),
                    ("--cluster-uuid", "clusterUUID")):
                if spec.get(key):
                    args += [flag, str(spec[key])]
            if spec.get("refitEvery") is not None:
                args += ["--refit-every", str(int(spec["refitEvery"]))]
        elif record.kind == KIND_DD:
            args += ["dropdetection",
                     "-t", str(spec.get("jobType", "initial"))]
            if spec.get("clusterUUID"):
                args += ["--cluster-uuid", str(spec["clusterUUID"])]
        elif record.kind == KIND_FPM:
            args += ["patterns",
                     "-m", str(int(spec.get("minSupport", 0) or 0)),
                     "--max-len", str(_validate_max_len(spec))]
            if spec.get("columns"):
                args += ["-c", ",".join(spec["columns"])]
        elif record.kind == KIND_SPATIAL:
            args += ["spatial"]
            if spec.get("eps"):
                args += ["--eps", str(float(spec["eps"]))]
            if spec.get("minSamples"):
                args += ["--min-samples", str(int(spec["minSamples"]))]
        else:
            policy_type = validate_policy_type(
                str(spec.get("policyType", "anp-deny-applied")))
            option = POLICY_TYPE_OPTION[policy_type]
            args += ["npr",
                     "-t", str(spec.get("jobType", "initial")),
                     "-l", str(int(spec.get("limit", 0) or 0)),
                     "-o", str(option),
                     "--rm_labels",
                     "true" if spec.get("excludeLabels", True)
                     else "false",
                     "--to_services",
                     "true" if spec.get("toServices", True)
                     else "false"]
            if spec.get("nsAllowList"):
                args += ["-n", json.dumps(spec["nsAllowList"])]
        if spec.get("startInterval"):
            args += ["-s", self._fmt_time(spec["startInterval"])]
        if spec.get("endInterval"):
            args += ["-e", self._fmt_time(spec["endInterval"])]
        args += ["-i", record.job_id]
        return args

    def _runner_cmd(self, record: JobRecord, snap: str,
                    progress_file: str) -> List[str]:
        """Full child argv. Split out so tests can substitute a
        controllable child process. The child runs on the controller's
        device, named on its command line."""
        return ([sys.executable, "-m", "theia_tpu_torch.runner"]
                + self._runner_args(record)
                + ["--db", snap, "--progress-file", progress_file,
                   "--out", snap + ".results.npz",
                   "--device", str(self.device)])

    def _deleted(self, record: JobRecord) -> bool:
        """True when THIS record left the table — identity, not name:
        a same-named recreation must not keep a doomed child alive
        (or let a deleted one's results land)."""
        with self._lock:
            return self._records.get(record.name) is not record

    def _run_subprocess(self, record: JobRecord) -> None:
        """One job = one runner child over a database snapshot; the
        process boundary is the failure domain (reference Spark
        driver/executor isolation)."""
        stages = _STAGES[record.kind]
        workdir = tempfile.mkdtemp(
            prefix=f"theia-job-{record.job_id[:8]}-")
        try:
            snap = os.path.join(workdir, "db.npz")
            progress_file = os.path.join(workdir, "progress.json")
            # argv build doubles as spec validation — errors raise here,
            # before the snapshot/spawn costs.
            cmd = self._runner_cmd(record, snap, progress_file)
            record.progress = FileProgress(record.job_id, stages,
                                           progress_file)
            pkg_root = os.path.dirname(os.path.dirname(
                os.path.dirname(os.path.abspath(__file__))))
            env = {**os.environ,
                   "PYTHONPATH": pkg_root + os.pathsep +
                   os.environ.get("PYTHONPATH", "")}
            # Snapshot outside the device lock (table scans are
            # thread-safe): only the child's device tenure serializes.
            # Uncompressed — a short-lived handoff file, not a durable
            # checkpoint.
            self.db.save(snap, compress=False)
            # Child output goes to files, not PIPEs: an undrained pipe
            # fills at ~64 KiB and deadlocks a chatty child against
            # our wait() loop.
            err_path = os.path.join(workdir, "stderr.log")
            _fire_fault("runner.spawn", job=record.name)
            deadline_s = record.deadline_seconds
            deadline_hit = False
            with open(os.path.join(workdir, "stdout.log"), "wb") as out_f, \
                    open(err_path, "wb") as err_f, \
                    self._device_lock:
                t_spawn = time.monotonic()
                proc = subprocess.Popen(
                    cmd, stdout=out_f, stderr=err_f, env=env,
                    cwd=workdir)
                record.runner_pid = proc.pid
                try:
                    while True:
                        try:
                            proc.wait(timeout=0.2)
                            break
                        except subprocess.TimeoutExpired:
                            if self._deleted(record):  # delete cancels
                                proc.kill()
                            elif self._stop.is_set():
                                # controller shutdown must not orphan
                                # a running child (it would keep the
                                # accelerator claimed past the
                                # manager's death)
                                proc.kill()
                            elif (deadline_s and not deadline_hit
                                  and time.monotonic() - t_spawn
                                  > deadline_s):
                                # a hung child would otherwise hold
                                # this worker AND the device lock
                                # forever (the Spark Operator's
                                # activeDeadlineSeconds kill)
                                deadline_hit = True
                                proc.kill()
                except BaseException:
                    proc.kill()
                    proc.wait()
                    raise
            # final scrape before the scratch dir goes away
            record.progress.snapshot()
            try:
                # keep the child's stderr tail on the record — the
                # support bundle's runner-log source (the reference
                # dumper copies Spark driver/executor pod logs,
                # pkg/support/dump.go:55-66)
                with open(err_path, "rb") as f:
                    record.runner_log_tail = f.read()[-8192:].decode(
                        errors="replace")
            except OSError:
                pass
            if deadline_hit:
                _M_DEADLINE_KILLS.inc()
                raise DeadlineExceeded(
                    f"runner exceeded deadlineSeconds={deadline_s:g} "
                    f"and was killed")
            if proc.returncode != 0:
                tail = " | ".join(record.runner_log_tail
                                  .strip().splitlines()[-5:])
                suffix = f": {tail}" if tail else ""
                if proc.returncode < 0:
                    # signal deaths (OOM kill, node reaper) are the
                    # transient class the reference's Spark Operator
                    # restartPolicy retries
                    raise TransientJobError(
                        f"runner killed by signal {-proc.returncode}"
                        + suffix)
                if proc.returncode == TRANSIENT_EXIT_CODE:
                    raise TransientJobError(
                        f"runner transient failure (exit "
                        f"{TRANSIENT_EXIT_CODE})" + suffix)
                raise RuntimeError(
                    f"runner exited {proc.returncode}" + suffix)
            self._merge_results(record, snap + ".results.npz")
        finally:
            shutil.rmtree(workdir, ignore_errors=True)

    def _merge_results(self, record: JobRecord, results: str) -> None:
        """Copy the job's result rows from the runner's results-only
        snapshot into the live database (dictionary re-encode happens
        in Table insert adoption)."""
        try:
            out = FlowDatabase.load(results, build_views=False)
        except FileNotFoundError:
            # Contract violation (rc=0 but no results file) — only
            # reachable with a substituted child; don't fail the job,
            # just record it.
            logger.error("job %s: runner wrote no results file %s",
                         record.name, results)
            return
        table_name = _RESULT_TABLE[record.kind]
        src = out.result_tables[table_name]
        dst = self.db.result_tables[table_name]
        data = src.scan()
        if len(data):
            rows = data.filter(data.strings("id") == record.job_id)
            if len(rows):
                dst.insert(rows)

    def health(self) -> Dict[str, object]:
        """Operator health view (served by GET /healthz): queue depth
        plus record counts by state, with in-backoff retries broken
        out (they are SCHEDULED records that already failed once)."""
        with self._lock:
            records = list(self._records.values())
        states = {STATE_SCHEDULED: 0, STATE_RUNNING: 0,
                  STATE_COMPLETED: 0, STATE_FAILED: 0}
        retrying = 0
        for r in records:
            states[r.state] = states.get(r.state, 0) + 1
            if r.state == STATE_SCHEDULED and r.attempts:
                retrying += 1
        return {
            "queueDepth": self._queue.qsize(),
            "records": len(records),
            "scheduled": states[STATE_SCHEDULED],
            "running": states[STATE_RUNNING],
            "completed": states[STATE_COMPLETED],
            "failed": states[STATE_FAILED],
            "retrying": retrying,
            "workers": len(self._threads),
            "dispatch": self.dispatch,
        }

    def wait_all(self, timeout: float = 60.0) -> bool:
        """Test/CLI helper: block until the queue drains and no job is
        RUNNING."""
        deadline = time.time() + timeout
        while time.time() < deadline:
            with self._lock:
                busy = any(r.state in (STATE_SCHEDULED, STATE_RUNNING)
                           for r in self._records.values())
            if not busy and self._queue.empty():
                return True
            time.sleep(0.05)
        return False

    def shutdown(self) -> None:
        self._stop.set()
        # Retries parked on a backoff timer will never run now: cancel
        # the timers and fail their records with the last failure (the
        # same terminal state the retry would reach under stop).
        with self._lock:
            pending = list(self._retry_timers.values())
            self._retry_timers.clear()
        for timer, record in pending:
            timer.cancel()
            record.state = STATE_FAILED
            record.error_msg = record.last_failure
        # Generous join: a subprocess worker needs time to kill its
        # child (stop flag is polled every 0.2s in the wait loop) and
        # run its cleanup (workdir rmtree) — a 2s give-up would orphan
        # both.
        for t in self._threads:
            t.join(timeout=15)
        for t in self._threads:
            if t.is_alive():
                logger.error("job worker %s did not stop", t.name)
