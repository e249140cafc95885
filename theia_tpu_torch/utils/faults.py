"""Deterministic fault injection — the failure-domain test harness.

The reference platform is only trustworthy because its failure paths
run constantly in production (ClickHouse replicas replay from peers,
the Spark Operator retries and deadline-kills jobs); a reproduction
whose failure paths never execute has no failure paths. This module
arms named *fault points* compiled into the hot paths so tests, CI,
and operators can drive real faults deterministically:

    THEIA_FAULTS="store.insert:error:0.5,runner.exec:hang,replica.write:error@2"

Grammar (comma-separated entries):

    entry       := site ["#" target] ":" mode [":" probability] ["@" nth]
    mode        := "error" | "hang"
    target      := per-instance scoping: the rule fires only for hits
                   whose ctx `peer` (or `target`) equals this value —
                   `peer.partition#node2:error` severs only the node2
                   link, the deterministic per-peer partition drill; a
                   bare site matches every hit of that site
    probability := float in (0, 1]      (default 1.0; seeded RNG, so a
                                         given seed replays one firing
                                         pattern exactly)
    nth         := 1-based hit index    (one-shot: fire on exactly the
                                         nth invocation of that site,
                                         never again; overrides
                                         probability)

Instrumented sites:

    store.insert      FlowDatabase.insert_flows (fires once per
                      physical store — once per replica in a fan-out,
                      once per resync re-insert)
    replica.write     ReplicatedFlowDatabase per-replica fan-out write
                      (ctx: replica index, op)
    checkpoint.save   Checkpointer.checkpoint, before the snapshot
    wal.append        WriteAheadLog.append, before any bytes are
                      written (an injected error fails the insert —
                      no acknowledgement without durability)
    wal.fsync         WriteAheadLog.sync, before flush+fsync (the
                      sync-policy durability point)
    wal.rotate        WAL segment rotation, before the old segment is
                      sealed
    runner.spawn      JobController subprocess dispatch, before Popen
    runner.exec       job execution: thread dispatch fires in-process;
                      the runner child fires after argv parse (exits
                      TRANSIENT_EXIT_CODE on an injected error so the
                      controller classifies it transient)
    reconciler.pass   DeclarativeReconciler.reconcile_once
    net.send          cluster transport, before any bytes leave for a
                      peer (replication shipping, ingest forwarding,
                      heartbeats; ctx: peer, path)
    net.recv          cluster API handler, on receipt of a peer's
                      request before it is processed (ctx: peer, path)
    peer.partition    both directions of one peer link: fired inside
                      net.send AND net.recv, so arming it severs the
                      link symmetrically — the network-partition drill
    admission.pressure  AdmissionController.admit, before any check:
                      "error" forces the admission plane to reject the
                      request (429 + Retry-After, reason "fault") —
                      the deterministic overload drill; "hang" stalls
                      the request inside admission. Combine with
                      THEIA_ADMISSION_FORCE_LEVEL=<rung> to pin any
                      brownout rung instead of just the reject rung.
    state.spill       working-set tier eviction (ingest/state_tier.py),
                      before any gather/encode/insert — an injected
                      error fails the micro-batch with hot state fully
                      intact, so the retry re-runs the identical spill
    state.promote     working-set tier promotion of re-arriving spilled
                      series, before any warm/cold state is consumed
    state.age_out     warm-block aging to the cold (store-only) tier;
                      an injected error defers the maintenance round —
                      never fails the batch

Modes: "error" raises FaultError (callers treat it like any I/O
error); "hang" sleeps THEIA_FAULT_HANG_SECONDS (default 3600 — long
enough that only a supervisor kill ends it) and then proceeds.

Arming: the module arms itself from THEIA_FAULTS at import (so a
spawned runner child inherits the operator's faults through its
environment), or programmatically via arm()/disarm() for tests. The
disarmed fast path is one global read — free on hot paths.
"""

from __future__ import annotations

import dataclasses
import os
import random
import threading
import time
from typing import Dict, List, Optional

from ..obs import metrics as _metrics
from ..analysis.lockdep import named_lock

MODES = ("error", "hang")

#: The fault-site registry: every `fire("<site>")` literal in the
#: package must name a member, and every member must be fired
#: somewhere — both directions enforced by the static lint pass
#: (theia_tpu/analysis/lint.py), so a renamed or removed site cannot
#: silently strand the operator docs above or a drill script.
KNOWN_SITES = (
    "store.insert",
    "replica.write",
    "checkpoint.save",
    "wal.append",
    "wal.fsync",
    "wal.rotate",
    "runner.spawn",
    "runner.exec",
    "reconciler.pass",
    "net.send",
    "net.recv",
    "peer.partition",
    "admission.pressure",
    "wire.decode",
    "wire.gather",
    "state.spill",
    "state.promote",
    "state.age_out",
)

_M_FIRINGS = _metrics.counter(
    "theia_fault_firings_total",
    "Armed fault points that actually injected (raised or hung)",
    labelnames=("site", "mode"))


class FaultError(Exception):
    """An injected fault (carries the site that fired)."""

    def __init__(self, site: str, detail: str = "") -> None:
        super().__init__(f"injected fault at {site}"
                         + (f" ({detail})" if detail else ""))
        self.site = site


@dataclasses.dataclass(frozen=True)
class FaultRule:
    site: str
    mode: str
    probability: float = 1.0
    nth: Optional[int] = None   # 1-based one-shot hit index


def parse_spec(spec: str) -> Dict[str, FaultRule]:
    """THEIA_FAULTS grammar → site-keyed rules (last entry per site
    wins). Raises ValueError on malformed entries — fail fast at arm
    time, not silently at fire time."""
    rules: Dict[str, FaultRule] = {}
    for entry in spec.split(","):
        entry = entry.strip()
        if not entry:
            continue
        site, sep, rest = entry.partition(":")
        if not sep or not site or not rest:
            raise ValueError(
                f"fault entry {entry!r} is not site:mode[:prob][@nth]")
        nth: Optional[int] = None
        if "@" in rest:
            rest, _, nth_s = rest.rpartition("@")
            try:
                nth = int(nth_s)
            except ValueError:
                raise ValueError(
                    f"fault entry {entry!r}: @nth must be an integer")
            if nth < 1:
                raise ValueError(
                    f"fault entry {entry!r}: @nth is 1-based")
        tokens = rest.split(":")
        mode = tokens[0]
        if mode not in MODES:
            raise ValueError(
                f"fault entry {entry!r}: mode must be one of {MODES}")
        probability = 1.0
        if len(tokens) > 1 and tokens[1]:
            try:
                probability = float(tokens[1])
            except ValueError:
                raise ValueError(
                    f"fault entry {entry!r}: probability must be a "
                    f"number")
            if not 0.0 < probability <= 1.0:
                raise ValueError(
                    f"fault entry {entry!r}: probability must be in "
                    f"(0, 1]")
        if len(tokens) > 2:
            raise ValueError(f"fault entry {entry!r}: too many fields")
        rules[site] = FaultRule(site=site, mode=mode,
                                probability=probability, nth=nth)
    return rules


class FaultInjector:
    """Armed rule set + per-site hit counters + seeded RNG. All state
    is behind one lock; fire() is the only hot-path entry."""

    def __init__(self, rules: Dict[str, FaultRule], seed: int = 0,
                 hang_seconds: Optional[float] = None) -> None:
        self.rules = dict(rules)
        self.seed = seed
        self.hang_seconds = (
            float(os.environ.get("THEIA_FAULT_HANG_SECONDS", "3600"))
            if hang_seconds is None else float(hang_seconds))
        self._rng = random.Random(seed)
        self._counts: Dict[str, int] = {}
        self._lock = named_lock("faults.injector")
        self._release = threading.Event()

    def counts(self) -> Dict[str, int]:
        with self._lock:
            return dict(self._counts)

    def armed_sites(self) -> List[str]:
        return sorted(self.rules)

    def release_hangs(self) -> None:
        """Unblock every in-progress (and future) hang — the test-side
        escape hatch when no supervisor kill is in play."""
        self._release.set()

    def fire(self, site: str, **ctx: object) -> None:
        """One instrumented hit of `site`: count it, then inject per
        the armed rule (no rule → free no-op). A rule armed with a
        `site#target` key fires only when the hit's ctx `peer` (or
        `target`) equals that target — hits and counters are tracked
        under the targeted key, so `@nth` indexes per peer link."""
        key = site
        rule = self.rules.get(site)
        target = ctx.get("peer", ctx.get("target"))
        if target is not None:
            targeted = self.rules.get(f"{site}#{target}")
            if targeted is not None:
                key, rule = f"{site}#{target}", targeted
        if rule is None:
            return
        with self._lock:
            n = self._counts[key] = self._counts.get(key, 0) + 1
            if rule.nth is not None:
                if n != rule.nth:
                    return
            elif rule.probability < 1.0 and \
                    self._rng.random() >= rule.probability:
                return
        _M_FIRINGS.labels(site=key, mode=rule.mode).inc()
        if rule.mode == "hang":
            self._hang()
            return
        detail = ", ".join(f"{k}={v}" for k, v in sorted(ctx.items()))
        raise FaultError(site, detail)

    def _hang(self) -> None:
        deadline = time.monotonic() + self.hang_seconds
        while not self._release.is_set():
            left = deadline - time.monotonic()
            if left <= 0:
                return
            time.sleep(min(0.05, left))


#: the process-wide injector; None = disarmed (the hot-path fast path)
_injector: Optional[FaultInjector] = None


def arm(spec: str, seed: Optional[int] = None,
        hang_seconds: Optional[float] = None) -> FaultInjector:
    """Arm (replacing any previous injector — counters reset)."""
    global _injector
    if seed is None:
        seed = int(os.environ.get("THEIA_FAULT_SEED", "0"))
    _injector = FaultInjector(parse_spec(spec), seed=seed,
                              hang_seconds=hang_seconds)
    return _injector


def arm_from_env() -> Optional[FaultInjector]:
    """(Re-)arm from THEIA_FAULTS; disarms when the env var is unset."""
    global _injector
    spec = os.environ.get("THEIA_FAULTS", "")
    if not spec.strip():
        _injector = None
        return None
    return arm(spec)


def disarm() -> None:
    global _injector
    if _injector is not None:
        _injector.release_hangs()
    _injector = None


def injector() -> Optional[FaultInjector]:
    return _injector


def armed_sites() -> List[str]:
    inj = _injector
    return inj.armed_sites() if inj is not None else []


def fire(site: str, **ctx: object) -> None:
    """Hot-path entry: a single global read when disarmed."""
    inj = _injector
    if inj is not None:
        inj.fire(site, **ctx)


# A spawned child (runner, manager) inherits the operator's armed
# faults through its environment.
if os.environ.get("THEIA_FAULTS", "").strip():
    arm_from_env()
