"""Runtime lockdep witness — named locks that prove ordering, not luck.

Every lock in the package is created through the factories here
(``named_lock`` / ``named_rlock`` / ``named_condition``), giving each
lock a stable *class name* ("store.table", "wal.io", ...). With
``THEIA_LOCKDEP`` unset the factories return the bare ``threading``
primitives — strictly zero cost, byte-for-byte the objects the code
always used. With ``THEIA_LOCKDEP=1`` they return witness wrappers
that:

  * record the per-thread held-set on every acquire/release;
  * accumulate a global acquisition-order graph (held-name ->
    acquired-name edges, recorded only for UNBOUNDED blocking
    acquires — a trylock or timed acquire cannot complete a deadlock
    cycle, and the opportunistic-acquire pattern the ingest shards use
    would otherwise read as an inversion);
  * flag an inversion the moment the graph gains a cycle — i.e. as
    soon as both orders have EVER been observed, no actual deadlock
    needed.  The whole tier-1 suite runs with the witness armed, so
    every test run doubles as a deadlock hunt;
  * keep per-lock contention and hold-time statistics (power-of-two
    bucket histograms, the obs/metrics bucket scheme) served on
    ``GET /debug/locks`` and as scrape-time gauges on ``/metrics``.

Cost discipline (the witness must stay armable in production):
inversion/edge detection is EXACT — that is the correctness core —
but the statistics are deliberately best-effort: counters are
maintained lock-free under the GIL (mutations on the acquire side are
additionally serialized by the user's own lock per instance; two
instances of the same class can race and very occasionally lose an
increment), and hold-time histograms are sampled 1-in-16 acquisitions
per lock instance (contended waits are always recorded — they are the
signal). p95s from sampled buckets converge for any lock hot enough
to matter.

Nested acquisition of two *instances* of the same lock class (a
sharded store walking its shard tables) is recorded as a self-edge
and reported in the stats doc, but is not an inversion: name-level
ordering cannot see instance order, the same reason Linux lockdep
requires nesting annotations for it.

This module imports ONLY the stdlib: every module in the package
imports it (that is the point), so it must sit below everything —
including obs/metrics, whose own locks are witnessed too.
"""

from __future__ import annotations

import contextlib
import math
import os
import sys
import threading
from time import monotonic as _mono
from typing import Dict, List, Optional, Set, Tuple

__all__ = [
    "enabled", "named_lock", "named_rlock", "named_condition",
    "note_acquire", "note_release", "inversions", "order_edges",
    "stats", "stats_doc", "reset", "lock_names", "scoped",
    "register_name", "held_names",
]

#: power-of-two bucket bounds for wait/hold seconds: 2^k for k in
#: [_EXP_MIN, _EXP_MIN + _N_BUCKETS), ~1us .. ~16s, +Inf last — the
#: obs/metrics scheme, reimplemented locally because this module must
#: not import anything above the stdlib.
_EXP_MIN = -20
_N_BUCKETS = 25

#: hold-time sampling mask: record timing on acquisitions where
#: (per-name counter & MASK) == 1 — the first acquisition of a fresh
#: stats object is always sampled, so rarely-taken locks still get a
#: hold number
_SAMPLE_MASK = 15


def _bucket_index(value: float) -> int:
    if value <= 2.0 ** _EXP_MIN:
        return 0
    m, e = math.frexp(value)
    k = e - 1 if m == 0.5 else e
    idx = k - _EXP_MIN
    return idx if idx < _N_BUCKETS else _N_BUCKETS


def _bucket_quantile(counts: List[int], q: float) -> float:
    """Upper bucket bound at quantile ``q`` (0 when empty)."""
    n = sum(counts)
    if n == 0:
        return 0.0
    target = q * n
    acc = 0
    for i, c in enumerate(counts):
        acc += c
        if acc >= target:
            return 2.0 ** (_EXP_MIN + min(i, _N_BUCKETS - 1))
    return 2.0 ** (_EXP_MIN + _N_BUCKETS - 1)


def enabled() -> bool:
    """Whether the witness is armed (checked at lock CREATION: already
    constructed locks keep whatever they were born as)."""
    return os.environ.get(
        "THEIA_LOCKDEP", "").strip().lower() in ("1", "true", "yes")


# -- global witness state ------------------------------------------------

class _LockStats:
    """Per-lock-class accounting. All fields mutated LOCK-FREE under
    the GIL (see the module docstring's cost discipline)."""

    __slots__ = ("n", "acquires", "contended", "wait_total",
                 "wait_max", "hold_total", "hold_max", "wait_buckets",
                 "hold_buckets")

    def __init__(self) -> None:
        self.n = 0                  # sampling counter
        self.acquires = 0
        self.contended = 0
        self.wait_total = 0.0
        self.wait_max = 0.0
        self.hold_total = 0.0
        self.hold_max = 0.0
        self.wait_buckets = [0] * (_N_BUCKETS + 1)
        self.hold_buckets = [0] * (_N_BUCKETS + 1)

    def note_wait(self, wait: float) -> None:
        self.contended += 1
        self.wait_total += wait
        if wait > self.wait_max:
            self.wait_max = wait
        self.wait_buckets[_bucket_index(wait)] += 1

    def note_hold(self, hold: float) -> None:
        self.hold_total += hold
        if hold > self.hold_max:
            self.hold_max = hold
        self.hold_buckets[_bucket_index(hold)] += 1

    def doc(self) -> Dict[str, object]:
        return {
            "acquires": self.acquires,
            "contended": self.contended,
            "waitTotalSeconds": self.wait_total,
            "waitMaxSeconds": self.wait_max,
            "waitP95Seconds": _bucket_quantile(
                self.wait_buckets, 0.95),
            "holdTotalSeconds": self.hold_total,
            "holdMaxSeconds": self.hold_max,
            "holdP95Seconds": _bucket_quantile(
                self.hold_buckets, 0.95),
            "holdSampled": True,
        }


#: held-name -> {acquired-name}: blocking acquisition-order edges.
#: Readers probe without the graph lock (GIL-atomic dict/set reads);
#: mutations (rare — first observation of an edge) serialize below.
_edges: Dict[str, Set[str]] = {}
#: (held, acquired) -> "file:line" of the acquire that minted the edge
_edge_sites: Dict[Tuple[str, str], str] = {}
#: inversion reports (cycle closed in the order graph)
_inversions: List[Dict[str, object]] = []
#: same-name nesting observations: name -> count
_self_edges: Dict[str, int] = {}
_stats: Dict[str, _LockStats] = {}
_graph_lock = threading.Lock()
#: every name the factories have minted (even before first acquire)
_known_names: Set[str] = set()
_tls = threading.local()


def _held() -> List[list]:
    """This thread's held stack: [owner_token, name, t_acquire, count]
    entries, outermost first (t_acquire 0.0 = hold timing unsampled
    for this acquisition)."""
    try:
        return _tls.held
    except AttributeError:
        _tls.held = []
        return _tls.held


def _caller_site() -> str:
    """file:line of the nearest frame outside the witness machinery —
    this module, contextlib (the latch's @contextmanager plumbing),
    and the ``_Latch`` read/write generators themselves, so a
    latch-closed edge names the CALLER that took the latch, not the
    latch implementation."""
    f = sys._getframe(1)
    while f is not None:
        mod = f.f_globals.get("__name__", "")
        if mod == __name__ or mod == "contextlib":
            f = f.f_back
            continue
        code = f.f_code
        if getattr(code, "co_qualname",
                   "").startswith("_Latch.") or (
                code.co_name in ("read", "write")
                and type(f.f_locals.get("self")).__name__
                == "_Latch"):
            f = f.f_back
            continue
        break
    if f is None:
        return "?"
    fn = f.f_code.co_filename
    for marker in ("theia_tpu", "tests"):
        i = fn.rfind(marker)
        if i >= 0:
            fn = fn[i:]
            break
    return f"{fn}:{f.f_lineno}"


def _find_path(src: str, dst: str) -> Optional[List[str]]:
    """DFS path src -> dst over the order graph (graph lock held)."""
    stack = [(src, [src])]
    seen = {src}
    while stack:
        node, path = stack.pop()
        for nxt in _edges.get(node, ()):
            if nxt == dst:
                return path + [dst]
            if nxt not in seen:
                seen.add(nxt)
                stack.append((nxt, path + [nxt]))
    return None


def _add_edges(held: List[list], name: str) -> None:
    """Record held->name for every distinct held lock class. Called
    only for unbounded blocking acquires — the only kind that can
    complete a deadlock cycle. Fast path (edge already known) is one
    dict.get + set membership per held entry, no locks."""
    for entry in held:
        held_name = entry[1]
        if held_name == name:
            # same-class nesting: tracked, but name-level ordering
            # cannot adjudicate instance order (see module docstring)
            with _graph_lock:
                _self_edges[name] = _self_edges.get(name, 0) + 1
            continue
        peers = _edges.get(held_name)
        if peers is not None and name in peers:
            continue
        with _graph_lock:
            peers = _edges.setdefault(held_name, set())
            if name in peers:
                continue
            site = _caller_site()
            # Does acquiring `name` while holding `held_name` close a
            # cycle? Look for an existing path name -> ... -> held_name
            # BEFORE inserting, so the report names the exact inversion.
            path = _find_path(name, held_name)
            peers.add(name)
            _edge_sites[(held_name, name)] = site
            if path is not None:
                cycle = path + [name]
                _inversions.append({
                    "cycle": cycle,
                    "edge": [held_name, name],
                    "site": site,
                    "priorSites": {
                        f"{a}->{b}": _edge_sites.get((a, b), "?")
                        for a, b in zip(path, path[1:])},
                    "thread": threading.current_thread().name,
                })
                msg = (f"lockdep: lock-order inversion: "
                       f"{' -> '.join(cycle)} (new edge "
                       f"{held_name} -> {name} at {site})")
                print(msg, file=sys.stderr)
                if os.environ.get("THEIA_LOCKDEP_RAISE", "") == "1":
                    raise RuntimeError(msg)


def _stats_for(name: str) -> _LockStats:
    s = _stats.get(name)
    if s is None:
        with _graph_lock:
            s = _stats.get(name)
            if s is None:
                s = _stats[name] = _LockStats()
    return s


def check_before_acquire(token: object, name: str) -> None:
    """Order validation for a blocking acquire, run BEFORE the
    underlying primitive is taken: the held->name edges exist the
    moment the attempt blocks, and — critically — a
    ``THEIA_LOCKDEP_RAISE=1`` inversion raises here with NOTHING
    acquired, so the error propagates cleanly instead of wedging the
    half-taken lock/latch for every later acquirer. The post-acquire
    bookkeeping finds the edges already present (one dict probe) and
    never re-raises."""
    held = _held()
    for entry in held:
        if entry[0] is token:             # reentrant: no new edges
            return
    if held:
        _add_edges(held, name)


def note_acquire(token: object, name: str, *, blocking: bool = True,
                 wait: float = 0.0, contended: bool = False) -> None:
    """Record that this thread now holds the lock/region ``name``
    (identified by ``token`` — the same object must be passed to
    ``note_release``). Non-lock blocking regions (the ingest latch)
    and the RLock wrapper integrate through this pair; the plain-Lock
    wrapper inlines an equivalent fast path."""
    held = _held()
    for entry in held:
        if entry[0] is token:             # reentrant (RLock) acquire
            entry[3] += 1
            return
    if blocking and held:
        _add_edges(held, name)
    st = _stats.get(name)
    if st is None:
        st = _stats_for(name)
    st.acquires += 1
    st.n += 1
    if contended:
        st.note_wait(wait)
    t0 = _mono() if (st.n & _SAMPLE_MASK) == 1 or contended else 0.0
    held.append([token, name, t0, 1])


def note_release(token: object, name: str) -> None:
    held = _held()
    for i in range(len(held) - 1, -1, -1):
        entry = held[i]
        if entry[0] is token:
            entry[3] -= 1
            if entry[3] == 0:
                del held[i]
                if entry[2]:
                    st = _stats.get(name)
                    if st is not None:
                        st.note_hold(_mono() - entry[2])
            return
    # release of a never-noted token (e.g. lockdep armed between
    # acquire and release in a test): ignore rather than corrupt state


# -- witness wrappers ----------------------------------------------------

class _WitnessLock:
    """threading.Lock wrapper feeding the witness. Context-manager and
    acquire/release compatible; not reentrant (matching Lock — a
    same-thread re-acquire blocks exactly like the bare primitive, so
    the held-stack never needs a reentrancy scan here)."""

    __slots__ = ("_lock", "name", "_st")

    def __init__(self, name: str) -> None:
        self._lock = threading.Lock()
        self.name = name
        self._st = _stats_for(name)

    def acquire(self, blocking: bool = True, timeout: float = -1):
        if blocking and timeout < 0:
            st = self._st
            held = _held()
            if held:
                # order validation BEFORE taking the lock: a raise
                # (THEIA_LOCKDEP_RAISE) must leave nothing acquired
                _add_edges(held, self.name)
            # uncontended fast path: a trylock that succeeds costs no
            # clock read; only a contended acquire times its wait
            if not self._lock.acquire(False):
                t0 = _mono()
                self._lock.acquire()
                st.note_wait(_mono() - t0)
                sampled = True
            else:
                sampled = False
            st.acquires += 1
            n = st.n = st.n + 1
            held.append([
                self, self.name,
                _mono() if sampled or (n & _SAMPLE_MASK) == 1
                else 0.0, 1])
            return True
        got = self._lock.acquire(blocking, timeout)
        if got:
            # try/timed acquires cannot complete a deadlock cycle:
            # held, but no order edge
            st = self._st
            st.acquires += 1
            st.n += 1
            _held().append([self, self.name, 0.0, 1])
        return got

    def release(self) -> None:
        held = _held()
        i = len(held) - 1                 # common case: innermost
        while i >= 0 and held[i][0] is not self:
            i -= 1
        if i >= 0:
            t0 = held[i][2]
            del held[i]
            if t0:
                # stats update BEFORE the inner release: serialized
                # by the lock we still hold
                self._st.note_hold(_mono() - t0)
        self._lock.release()

    def locked(self) -> bool:
        return self._lock.locked()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc) -> None:
        self.release()

    def __repr__(self) -> str:
        return f"<WitnessLock {self.name} {self._lock!r}>"


class _WitnessRLock:
    """threading.RLock wrapper. Implements the private Condition
    protocol (_release_save/_acquire_restore/_is_owned) so
    ``named_condition`` can wrap it: a ``cond.wait()`` fully releases
    the held entry and restores it on wakeup, keeping the per-thread
    held-set truthful across waits."""

    __slots__ = ("_lock", "name")

    def __init__(self, name: str) -> None:
        self._lock = threading.RLock()
        self.name = name
        _stats_for(name)

    def acquire(self, blocking: bool = True, timeout: float = -1):
        if blocking and timeout < 0:
            check_before_acquire(self, self.name)
            if self._lock.acquire(False):
                note_acquire(self, self.name, blocking=True)
                return True
            t0 = _mono()
            self._lock.acquire()
            note_acquire(self, self.name, blocking=True,
                         wait=_mono() - t0, contended=True)
            return True
        got = self._lock.acquire(blocking, timeout)
        if got:
            note_acquire(self, self.name, blocking=False)
        return got

    def release(self) -> None:
        self._lock.release()
        note_release(self, self.name)

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc) -> None:
        self.release()

    # -- Condition protocol ---------------------------------------------

    def _release_save(self):
        held = _held()
        count = 1
        for i in range(len(held) - 1, -1, -1):
            if held[i][0] is self:
                count = held[i][3]
                t0 = held[i][2]
                del held[i]
                if t0:
                    st = _stats.get(self.name)
                    if st is not None:
                        st.note_hold(_mono() - t0)
                break
        return (self._lock._release_save(), count)

    def _acquire_restore(self, state) -> None:
        inner, count = state
        # re-acquire after wait IS a blocking acquire: record edges
        # from whatever else this thread still holds — validated
        # BEFORE the restore so a raise-mode inversion leaves the
        # condition's lock untaken
        held = _held()
        if held:
            _add_edges(held, self.name)
        t0 = _mono()
        self._lock._acquire_restore(inner)
        wait = _mono() - t0
        st = _stats.get(self.name)
        if st is None:
            st = _stats_for(self.name)
        st.acquires += 1
        st.n += 1
        if wait > 0.0001:
            st.note_wait(wait)
        held.append([self, self.name, 0.0, count])

    def _is_owned(self) -> bool:
        return self._lock._is_owned()

    def __repr__(self) -> str:
        return f"<WitnessRLock {self.name} {self._lock!r}>"


# -- factories -----------------------------------------------------------

def named_lock(name: str):
    """A mutex with a lockdep class name. Disabled -> a bare
    ``threading.Lock()`` (zero cost, identical semantics)."""
    if not enabled():
        return threading.Lock()
    with _graph_lock:
        _known_names.add(name)
    return _WitnessLock(name)


def named_rlock(name: str):
    if not enabled():
        return threading.RLock()
    with _graph_lock:
        _known_names.add(name)
    return _WitnessRLock(name)


def named_condition(name: str):
    """A Condition whose underlying (reentrant) lock is witnessed:
    waiters drop their held entry for the duration of the wait."""
    if not enabled():
        return threading.Condition()
    with _graph_lock:
        _known_names.add(name)
    return threading.Condition(_WitnessRLock(name))


def register_name(name: str) -> None:
    """Register a non-factory witnessed region (the ingest latch) so
    it shows up in the stats doc before its first acquisition."""
    if enabled():
        with _graph_lock:
            _known_names.add(name)


# -- reporting -----------------------------------------------------------

def inversions() -> List[Dict[str, object]]:
    with _graph_lock:
        return [dict(i) for i in _inversions]


def order_edges() -> List[Tuple[str, str]]:
    with _graph_lock:
        return sorted((a, b) for a, peers in _edges.items()
                      for b in peers)


def lock_names() -> List[str]:
    with _graph_lock:
        return sorted(_known_names | set(_stats))


def stats() -> Dict[str, Dict[str, object]]:
    with _graph_lock:
        items = list(_stats.items())
    return {name: s.doc() for name, s in sorted(items)}


def held_names() -> List[str]:
    """This thread's currently-held lock classes, outermost first
    (test/debug introspection)."""
    return [e[1] for e in _held()]


def stats_doc() -> Dict[str, object]:
    """The GET /debug/locks document."""
    if not enabled():
        return {"enabled": False}
    with _graph_lock:
        edges = sorted((a, b) for a, peers in _edges.items()
                       for b in peers)
        doc = {
            "enabled": True,
            "locks": sorted(_known_names | set(_stats)),
            "orderEdges": [
                {"held": a, "acquired": b,
                 "site": _edge_sites.get((a, b), "?")}
                for a, b in edges],
            "selfNesting": dict(sorted(_self_edges.items())),
            "inversions": [dict(i) for i in _inversions],
        }
    doc["stats"] = stats()
    return doc


def reset() -> None:
    """Clear the order graph, inversion log, and stats (tests).
    Held-sets of live threads are preserved. Live wrapper instances
    keep feeding their original stats objects (which are no longer
    reported) — acceptable for test isolation."""
    with _graph_lock:
        _edges.clear()
        _edge_sites.clear()
        _inversions.clear()
        _self_edges.clear()
        _stats.clear()


@contextlib.contextmanager
def scoped():
    """Swap in FRESH witness state for the duration (restoring the
    real graph after): tests that build deliberate inversions must
    not trip the suite-wide zero-inversion gate, and the suite's real
    graph must not mask a fixture's cycle. Locks created inside the
    scope register their stats in the scoped tables.

    Background threads (maintenance loops, servers from earlier
    tests) keep running while a scope is active; their REAL ordering
    observations must not be discarded with the fixture state. On
    exit, any scoped edge whose both endpoints were already known to
    the real graph (i.e. not fixture-created — fixture lock names
    never pre-exist in the real stats) is merged back through the
    same cycle check, so an inversion first witnessed during a scope
    still fails the suite-wide gate."""
    global _edges, _edge_sites, _inversions, _self_edges, _stats, \
        _known_names
    with _graph_lock:
        saved = (_edges, _edge_sites, _inversions, _self_edges,
                 _stats, _known_names)
        # names that pre-exist the scope: only THEIR edges merge back
        # (fixture locks are minted inside the scope — including into
        # the swapped name set, so a reused fixture name from an
        # earlier scope can never qualify)
        real_names = set(_stats) | set(_known_names)
        (_edges, _edge_sites, _inversions, _self_edges, _stats,
         _known_names) = ({}, {}, [], {}, {}, set(_known_names))
    try:
        yield
    finally:
        with _graph_lock:
            scoped_edges = _edges
            scoped_sites = _edge_sites
            (_edges, _edge_sites, _inversions, _self_edges,
             _stats, _known_names) = saved
            # merge-back: real-lock observations made during the scope
            for a, peers in scoped_edges.items():
                if a not in real_names:
                    continue
                for b in peers:
                    if b not in real_names:
                        continue
                    dst = _edges.setdefault(a, set())
                    if b in dst:
                        continue
                    site = scoped_sites.get((a, b), "?")
                    path = _find_path(b, a)
                    dst.add(b)
                    _edge_sites[(a, b)] = site
                    if path is not None:
                        cycle = path + [b]
                        _inversions.append({
                            "cycle": cycle,
                            "edge": [a, b],
                            "site": site,
                            "priorSites": {
                                f"{x}->{y}":
                                    _edge_sites.get((x, y), "?")
                                for x, y in zip(path, path[1:])},
                            "thread": "(merged from scoped window)",
                        })
                        print(f"lockdep: lock-order inversion "
                              f"(observed during a scoped window): "
                              f"{' -> '.join(cycle)}",
                              file=sys.stderr)
