"""Declarative CR reconciler: desired-state YAML → job records.

The reference's control plane is CRD-driven: operators `kubectl apply`
NetworkPolicyRecommendation / ThroughputAnomalyDetector CRs and the
controllers reconcile them into running jobs via informers + workqueues
(pkg/controller/networkpolicyrecommendation/controller.go:118-130,
336-388). This module provides the same declarative semantics against
a DIRECTORY of CR YAML documents — the GitOps-shaped seam a kube
informer plugs into unchanged:

  * a CR file appearing  → job created (same kinds, same spec keys as
    the REST API)
  * the CR file removed  → job deleted, result rows GC'd
    (cleanupNPRecommendation semantics)
  * status written back as `<name>.status.yaml` beside the CR, carrying
    the NEW→SCHEDULED→RUNNING→COMPLETED/FAILED state machine

Reconciliation is level-triggered and idempotent: every pass compares
the full desired set against the controller's records, exactly like a
resync (controller.go:324-334); only resources this reconciler created
are subject to its deletion logic, so REST-created jobs are never
collected. CR specs are treated as immutable once admitted (the
reference controllers never re-run a mutated CR either).

Enable with `python -m theia_tpu_torch.manager --reconcile-dir <dir>`.
The matching CustomResourceDefinition manifests come from
`deploy/generate_manifest.py --crds`.
"""

from __future__ import annotations

import os
import threading
from typing import Dict, Optional, Tuple

from ..obs import metrics as _metrics
from ..utils import get_logger
from ..utils.backoff import capped_backoff
from ..utils.faults import fire as _fire_fault
from .jobs import (KIND_DD, KIND_FPM, KIND_NPR, KIND_SPATIAL,
                   KIND_TAD, STATE_COMPLETED, STATE_FAILED,
                   DuplicateJobError)

logger = get_logger("reconciler")

_M_PASSES = _metrics.counter(
    "theia_reconciler_passes_total",
    "Reconcile passes over the CR directory, by outcome",
    labelnames=("result",))
_M_OBJECTS = _metrics.counter(
    "theia_reconciler_objects_total",
    "CRs admitted into / deleted from the controller by the "
    "reconciler", labelnames=("action",))

CRD_GROUP = "crd.theia.antrea.io"
API_VERSION = f"{CRD_GROUP}/v1alpha1"

#: CR kind → controller job kind (reference pkg/apis/crd/v1alpha1)
KIND_BY_CR = {
    "NetworkPolicyRecommendation": KIND_NPR,
    "ThroughputAnomalyDetector": KIND_TAD,
    "TrafficDropDetection": KIND_DD,
    "FlowPatternMining": KIND_FPM,
    "SpatialAnomalyDetection": KIND_SPATIAL,
}

_STATUS_SUFFIX = ".status.yaml"


class DeclarativeReconciler:
    """Level-triggered reconcile loop over a CR directory."""

    def __init__(self, controller, directory: str,
                 interval: float = 2.0) -> None:
        self.controller = controller
        self.directory = directory
        self.interval = interval
        #: names this reconciler admitted — the only ones it may delete
        self._owned: set = set()
        #: terminally rejected specs (name → spec) so a bad CR is
        #: logged once, not every pass; retried if the spec changes
        self._rejected: Dict[str, tuple] = {}
        #: last status written per name — unchanged statuses skip the
        #: disk write (and the watcher events it would trigger)
        self._last_status: Dict[str, dict] = {}
        #: CRs whose status file already records a terminal state —
        #: skipped (and logged) once, not re-read every pass
        self._terminal: Dict[str, str] = {}
        #: cap for the consecutive-failure backoff (injectable so
        #: tests exercise the schedule without long sleeps)
        self.backoff_cap = 60.0
        self.consecutive_failures = 0
        self.current_delay = interval
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        os.makedirs(directory, exist_ok=True)

    # -- lifecycle --------------------------------------------------------

    def start(self) -> None:
        self._thread = threading.Thread(
            target=self._loop, daemon=True, name="theia-reconciler")
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=15)

    def _loop(self) -> None:
        # Capped exponential backoff on CONSECUTIVE pass failures: a
        # broken directory (unmountable volume, permission flip) is
        # probed, not hammered every 2s; the first clean pass resets
        # to the level-triggered cadence.
        while not self._stop.wait(self.current_delay):
            try:
                self.reconcile_once()
            except Exception as e:   # keep reconciling after bad input
                _M_PASSES.labels(result="error").inc()
                self.consecutive_failures += 1
                self.current_delay = capped_backoff(
                    self.interval * 2, self.backoff_cap,
                    self.consecutive_failures)
                logger.error("reconcile pass failed (%d consecutive): "
                             "%s; backing off %.1fs",
                             self.consecutive_failures, e,
                             self.current_delay)
            else:
                if self.consecutive_failures:
                    logger.info("reconcile recovered after %d failed "
                                "passes", self.consecutive_failures)
                self.consecutive_failures = 0
                self.current_delay = self.interval

    # -- one pass ---------------------------------------------------------

    def _desired(self) -> Dict[str, Tuple[str, dict]]:
        """name → (job kind, spec) from every CR document on disk.
        Malformed files are skipped with a log line (a bad apply must
        not stall the rest of the directory — workqueue semantics)."""
        import yaml

        out: Dict[str, Tuple[str, dict]] = {}
        try:
            names = sorted(os.listdir(self.directory))
        except OSError:
            return out
        for fname in names:
            if not fname.endswith((".yaml", ".yml")) or \
                    fname.endswith(_STATUS_SUFFIX):
                continue
            path = os.path.join(self.directory, fname)
            try:
                with open(path) as f:
                    docs = list(yaml.safe_load_all(f))
            except Exception as e:
                logger.error("skipping unreadable CR file %s: %s",
                             fname, e)
                continue
            for doc in docs:
                if not isinstance(doc, dict):
                    continue
                kind = KIND_BY_CR.get(str(doc.get("kind", "")))
                api = str(doc.get("apiVersion", ""))
                name = (doc.get("metadata") or {}).get("name")
                # exact group/version match: a foreign group or a
                # future v2 must not be silently run under v1alpha1
                # spec semantics
                if kind is None or api != API_VERSION or not name:
                    continue
                spec = doc.get("spec") or {}
                if not isinstance(spec, dict):
                    logger.error("CR %s in %s: spec must be a mapping",
                                 name, fname)
                    continue
                name = str(name)
                if name in out:
                    logger.error(
                        "duplicate CR name %s (also in %s): keeping "
                        "the lexicographically-last file's spec",
                        name, fname)
                out[name] = (kind, spec)
        return out

    def reconcile_once(self) -> Dict[str, int]:
        _fire_fault("reconciler.pass", directory=self.directory)
        desired = self._desired()
        current = {r.name: r for r in self.controller.list()}
        created = deleted = 0

        for name, (kind, spec) in desired.items():
            if name in current:
                continue
            fingerprint = (kind, repr(sorted(spec.items())))
            if self._rejected.get(name) == fingerprint:
                continue   # logged once; retried only if spec changes
            if name not in self._terminal:
                state = self._terminal_state_on_disk(name)
                if state is not None:
                    # The CR already ran to a terminal state in a
                    # previous manager life (the status file beside it
                    # is the durable record — the reference controllers
                    # never re-execute a completed CR either). Claim
                    # ownership so the status file is GC'd with the CR.
                    self._terminal[name] = state
                    self._owned.add(name)
                    logger.v(1).info(
                        "CR %s already %s (status file); not "
                        "re-admitting after restart", name, state)
            if name in self._terminal:
                continue
            try:
                self.controller.create(kind, spec, name=name)
                self._owned.add(name)
                self._rejected.pop(name, None)
                created += 1
                logger.v(1).info("admitted CR %s", name)
            except (DuplicateJobError, ValueError) as e:
                self._rejected[name] = fingerprint
                logger.error("CR %s rejected: %s", name, e)

        # deletion: only resources this reconciler admitted, and only
        # once their CR file is gone
        for name in list(self._owned):
            if name in desired:
                continue
            if name in current:
                try:
                    self.controller.delete(name)
                    deleted += 1
                    logger.v(1).info("deleted CR %s (file removed)",
                                     name)
                except KeyError:
                    pass   # raced a REST delete — already gone
            # drop ownership only after the delete attempt, so a
            # failure here retries next pass instead of orphaning
            # the record and its status file
            self._owned.discard(name)
            self._remove_status(name)
            self._last_status.pop(name, None)
            self._terminal.pop(name, None)

        self._write_statuses(desired)
        _M_PASSES.labels(result="ok").inc()
        if created:
            _M_OBJECTS.labels(action="created").inc(created)
        if deleted:
            _M_OBJECTS.labels(action="deleted").inc(deleted)
        return {"desired": len(desired), "created": created,
                "deleted": deleted}

    # -- status write-back --------------------------------------------------

    def _status_path(self, name: str) -> str:
        return os.path.join(self.directory, name + _STATUS_SUFFIX)

    def _terminal_state_on_disk(self, name: str) -> Optional[str]:
        """COMPLETED/FAILED from `<name>.status.yaml` if the CR already
        ran to completion (written atomically by _write_statuses), else
        None. Unreadable/missing/non-terminal statuses mean the CR is
        still due to run — a crash mid-run re-runs, a finished run
        never does."""
        import yaml

        try:
            with open(self._status_path(name)) as f:
                doc = yaml.safe_load(f)
        except OSError:
            return None
        except Exception:
            return None   # torn/foreign file: treat as no status
        if not isinstance(doc, dict):
            return None
        state = ((doc.get("status") or {}).get("state")
                 if isinstance(doc.get("status"), dict) else None)
        return state if state in (STATE_COMPLETED, STATE_FAILED) \
            else None

    def _remove_status(self, name: str) -> None:
        try:
            os.unlink(self._status_path(name))
        except OSError:
            pass

    def _write_statuses(self, desired) -> None:
        import yaml

        from ..utils import atomic_write
        for name in desired:
            try:
                record = self.controller.get(name)
            except KeyError:
                continue
            doc = {"name": name, "status": record.status_dict()}
            if self._last_status.get(name) == doc:
                continue   # terminal statuses stop churning the disk

            def write(tmp: str, doc=doc) -> None:
                with open(tmp, "w") as f:
                    yaml.safe_dump(doc, f)

            atomic_write(self._status_path(name), write)
            self._last_status[name] = doc
