"""Static lock-order analysis — the AST half of the lockdep story.

Walks every module in the package and builds the same acquisition-order
graph the runtime witness accumulates, but from SOURCE, so orderings
that no test exercises are still seen:

  1. **Lock identification.** Any attribute or module global assigned
     from ``named_lock/named_rlock/named_condition`` (the name literal
     is the lock class), a bare ``threading.Lock/RLock/Condition``
     call, or a ``_Latch(...)`` construction. Attribute locks are keyed
     per (class, attr); non-``self`` receivers resolve through an
     attr-name table with a receiver-name hint when two classes share
     the attr name.

  2. **Acquisition contexts.** ``with``-items (including conditional
     expressions and ``ExitStack.enter_context``), ``.acquire()``
     calls (non-blocking try-acquires are held but add NO order edge —
     a trylock cannot complete a deadlock cycle, and the ingest
     shards' opportunistic pattern would otherwise read as an
     inversion), latch ``.read()/.write()`` context calls, and
     context-returning methods (``quiesce``). One level
     interprocedural: a call made while holding L pulls the callee's
     own acquisitions in as L -> M edges (same-package resolution:
     ``self`` methods, module functions, package-unique method names).

  3. **Reports.** Cycles in the merged edge graph (the PR-14
     latch-inside-lock class), blocking calls under a lock (fsync,
     sleep, socket/HTTP, queue waits, future results, subprocess —
     the convoy makers), and torn multi-field transitions (the PR-12
     class: two attributes assigned in one locked block while another
     method of the class reads both without the lock).

Every report is checked against analysis/waivers.py; a waiver must
cite the invariant that makes the flagged code safe.
"""

from __future__ import annotations

import ast
import dataclasses
import os
from typing import Dict, List, Optional, Sequence, Set, Tuple

from .base import Finding

#: constructors that make a lock; named_* carry the class name literal
_FACTORIES = ("named_lock", "named_rlock", "named_condition")
_BARE_LOCKS = ("Lock", "RLock", "Condition")

#: methods that RETURN a lock acquisition context (hand-curated repo
#: idioms; the latch read/write pair is handled structurally)
_CONTEXT_METHODS = {
    "quiesce": "wal.latch",          # WriteAheadLog.quiesce -> latch.write()
}

#: method names stdlib containers also carry: package-unique-name
#: call resolution must never claim these (a deque has .clear() too)
_STDLIB_METHODS = frozenset({
    "clear", "get", "put", "pop", "append", "appendleft", "extend",
    "update", "items", "keys", "values", "add", "remove", "discard",
    "close", "copy", "read", "write", "flush", "send", "recv",
    "sort", "join", "split", "strip", "index", "count", "insert",
    "reverse", "setdefault", "popitem", "encode", "decode", "format",
    "start", "stop", "run", "submit", "shutdown", "result", "done",
    "wait", "notify", "set", "reset", "acquire", "release", "open",
    "seek", "tell", "save", "load", "name", "match", "search",
})

#: blocking-call table: (dotted call, attr-call name, receiver hint)
#: — a curated list, not a taxonomy: these are the calls the repo's
#: review history caught sleeping/fsyncing/waiting under a lock
_BLOCKING_DOTTED = {
    "os.fsync", "os.fdatasync", "time.sleep",
    "urllib.request.urlopen", "socket.create_connection",
    "subprocess.run", "subprocess.check_output",
    "subprocess.check_call", "subprocess.call",
}
#: attr-call names blocking on ANY receiver
_BLOCKING_ATTRS = {"fsync", "fdatasync", "communicate", "getresponse",
                   "urlopen"}
#: attr-call names blocking only when the receiver source hints at the
#: right kind of object (queue waits, future results, thread joins)
_BLOCKING_HINTED = {
    "get": ("queue", "_q"),
    "put": ("queue", "_q"),
    "result": ("fut", "future"),
    "join": ("thread", "proc", "loop", "timer", "worker", "shipper"),
    "wait": ("event", "stop", "done", "ready"),
}


@dataclasses.dataclass
class _Acq:
    name: str            # lock class name
    site: str            # file:line
    blocking: bool       # False for try/timed acquires


@dataclasses.dataclass
class _FuncInfo:
    qual: str                                    # module:Class.func
    acquisitions: List[_Acq] = dataclasses.field(default_factory=list)
    #: (held lock, acquired lock, site) direct edges inside this func
    edges: List[Tuple[str, str, str]] = dataclasses.field(
        default_factory=list)
    #: (held lock, callee display, call key candidates, site)
    held_calls: List[Tuple[str, str, List[str], str]] = \
        dataclasses.field(default_factory=list)
    #: (held lock, blocking call name, site)
    blocking: List[Tuple[str, str, str]] = dataclasses.field(
        default_factory=list)


def _expr_src(node: ast.AST) -> str:
    try:
        return ast.unparse(node)
    except Exception:
        return "?"


class _Module:
    def __init__(self, path: str, rel: str, modname: str) -> None:
        self.path = path
        self.rel = rel                   # repo-relative, for sites
        self.modname = modname           # theia_tpu.store.wal
        with open(path, "r", encoding="utf-8") as f:
            self.tree = ast.parse(f.read(), filename=path)
        self.imports: Dict[str, str] = {}    # alias -> module name
        for node in ast.walk(self.tree):
            if isinstance(node, ast.Import):
                for a in node.names:
                    self.imports[a.asname or a.name.split(".")[0]] = \
                        a.name
            elif isinstance(node, ast.ImportFrom):
                # `from .x import y`, `from ..pkg import z as w`, and
                # the bare-relative form `from . import wal as _wal`
                # (module=None) — the package's most common aliasing
                if node.level:
                    parts = modname.split(".")
                    base = ".".join(
                        parts[:len(parts) - node.level]
                        + ([node.module] if node.module else []))
                elif node.module:
                    base = node.module
                else:
                    continue
                for a in node.names:
                    self.imports[a.asname or a.name] = \
                        f"{base}.{a.name}"


class LockGraph:
    """The whole-package analysis: construct with the package root,
    then ``run()`` for findings."""

    def __init__(self, package_dir: str,
                 modules: Optional[Sequence[_Module]] = None) -> None:
        self.package_dir = package_dir
        if modules is not None:
            self.modules = list(modules)
        else:
            self.modules = []
            root = os.path.dirname(os.path.abspath(package_dir))
            for dirpath, _dirnames, filenames in sorted(
                    os.walk(package_dir)):
                for fn in sorted(filenames):
                    if not fn.endswith(".py"):
                        continue
                    path = os.path.join(dirpath, fn)
                    rel = os.path.relpath(path, root)
                    mod = rel[:-3].replace(os.sep, ".")
                    if mod.endswith(".__init__"):
                        mod = mod[:-len(".__init__")]
                    self.modules.append(_Module(path, rel, mod))
        #: (module, class-or-None, attr) -> lock name
        self.locks: Dict[Tuple[str, Optional[str], str], str] = {}
        #: class name -> base class names (package classes only;
        #: single-level name resolution is enough for this codebase)
        self.bases: Dict[Tuple[str, str], List[str]] = {}
        #: attr -> {(class, lockname)} for non-self resolution
        self.attr_index: Dict[str, Set[Tuple[str, str]]] = {}
        #: function table + resolution indexes
        self.funcs: Dict[str, _FuncInfo] = {}
        self.module_funcs: Dict[Tuple[str, str], str] = {}
        self.class_methods: Dict[Tuple[str, str, str], str] = {}
        self.method_index: Dict[str, Set[str]] = {}
        #: merged order graph: (held, acquired) -> site
        self.graph: Dict[Tuple[str, str], str] = {}
        self.unresolved: List[str] = []

    # -- pass 1: lock identification ------------------------------------

    def _lock_name_from_call(self, call: ast.Call,
                             mod: _Module,
                             owner: Optional[str],
                             attr: str) -> Optional[str]:
        fn = call.func
        fname = None
        if isinstance(fn, ast.Name):
            fname = fn.id
        elif isinstance(fn, ast.Attribute):
            fname = fn.attr
        if fname in _FACTORIES:
            if call.args and isinstance(call.args[0], ast.Constant) \
                    and isinstance(call.args[0].value, str):
                return call.args[0].value
            return f"{mod.modname}.{owner or ''}.{attr}".replace(
                "..", ".")
        if fname in _BARE_LOCKS and isinstance(fn, ast.Attribute) \
                and isinstance(fn.value, ast.Name) \
                and fn.value.id == "threading":
            return f"{mod.modname}.{owner or ''}.{attr}".replace(
                "..", ".")
        if fname == "_Latch":
            if call.args and isinstance(call.args[0], ast.Constant) \
                    and isinstance(call.args[0].value, str):
                return call.args[0].value
            return "wal.latch"
        return None

    def _collect_locks(self) -> None:
        for mod in self.modules:
            for node in ast.walk(mod.tree):
                if isinstance(node, ast.ClassDef):
                    self.bases[(mod.modname, node.name)] = [
                        b.id if isinstance(b, ast.Name) else b.attr
                        for b in node.bases
                        if isinstance(b, (ast.Name, ast.Attribute))]
                    for sub in ast.walk(node):
                        if isinstance(sub, ast.Assign):
                            targets = sub.targets
                            value = sub.value
                        elif isinstance(sub, ast.AnnAssign):
                            targets = [sub.target]
                            value = sub.value
                        else:
                            continue
                        if not isinstance(value, ast.Call):
                            continue
                        for tgt in targets:
                            if isinstance(tgt, ast.Attribute) and \
                                    isinstance(tgt.value, ast.Name) \
                                    and tgt.value.id == "self":
                                name = self._lock_name_from_call(
                                    value, mod, node.name,
                                    tgt.attr)
                                if name:
                                    self.locks[(mod.modname,
                                                node.name,
                                                tgt.attr)] = name
                                    self.attr_index.setdefault(
                                        tgt.attr, set()).add(
                                        (node.name, name))
            for node in mod.tree.body:       # module-level globals
                if isinstance(node, ast.Assign) and \
                        isinstance(node.value, ast.Call):
                    for tgt in node.targets:
                        if isinstance(tgt, ast.Name):
                            name = self._lock_name_from_call(
                                node.value, mod, None, tgt.id)
                            if name:
                                self.locks[(mod.modname, None,
                                            tgt.id)] = name
                                self.attr_index.setdefault(
                                    tgt.id, set()).add(("", name))

    # -- pass 2: per-function acquisition extraction --------------------

    def _resolve_lock_expr(self, expr: ast.AST, mod: _Module,
                           cls: Optional[str],
                           local_hints: Dict[str, str]
                           ) -> Optional[Tuple[str, bool]]:
        """Resolve an expression that *denotes a lock object* to its
        lock name. Returns (name, certain)."""
        if isinstance(expr, ast.Name):
            hit = self.locks.get((mod.modname, None, expr.id))
            if hit:
                return hit, True
            hint = local_hints.get(expr.id)
            if hint:
                return hint, True
            return self._resolve_attr_name(expr.id, expr.id)
        if isinstance(expr, ast.Attribute):
            if isinstance(expr.value, ast.Name) and \
                    expr.value.id == "self" and cls is not None:
                hit = self._class_lock(mod.modname, cls, expr.attr)
                if hit:
                    return hit, True
                # self attr never seen assigned a lock in this class
                # OR its bases: fall through to the attr index
            recv = _expr_src(expr.value)
            return self._resolve_attr_name(expr.attr, recv)
        return None

    def _class_lock(self, modname: str, cls: str,
                    attr: str) -> Optional[str]:
        """(class, attr) lock lookup walking the base-class chain by
        name (PartTable inherits Table._lock)."""
        seen = set()
        queue = [(modname, cls)]
        while queue:
            m, c = queue.pop(0)
            if (m, c) in seen:
                continue
            seen.add((m, c))
            hit = self.locks.get((m, c, attr))
            if hit:
                return hit
            for base in self.bases.get((m, c), ()):
                # resolve the base by NAME across every module (class
                # names are unique in this package)
                for (bm, bc) in self.bases:
                    if bc == base:
                        queue.append((bm, bc))
                # a base with no own bases entry (no ClassDef found —
                # e.g. imported) still gets a direct lock probe
                for (lm, lc, la), _n in list(self.locks.items()):
                    if lc == base and la == attr:
                        return self.locks[(lm, lc, la)]
        return None

    def _resolve_attr_name(self, attr: str, receiver: str
                           ) -> Optional[Tuple[str, bool]]:
        """Non-self receiver: all classes owning ``attr`` as a lock;
        disambiguate by receiver-name hint."""
        cands = self.attr_index.get(attr)
        if not cands:
            return None
        if len(cands) == 1:
            return next(iter(cands))[1], True
        rl = receiver.lower().lstrip("_")
        # receiver named exactly like one candidate class wins outright
        # (`table._lock` -> Table, not DistributedTable)
        exact = [(c, n) for c, n in cands
                 if c and c.lower().lstrip("_") == rl]
        if len({n for _, n in exact}) == 1:
            return exact[0][1], True
        if len(rl) >= 3:        # 1-2 char receivers match everything
            hinted = [(c, n) for c, n in cands
                      if c and (rl in c.lower()
                                or c.lower().lstrip("_") in rl)]
            if len({n for _, n in hinted}) == 1:
                return hinted[0][1], True
        self.unresolved.append(f"{receiver}.{attr}")
        return None

    def _acquisitions_in_expr(self, expr: ast.AST, mod: _Module,
                              cls: Optional[str],
                              local_hints: Dict[str, str]
                              ) -> List[Tuple[str, bool]]:
        """Every lock acquisition denoted anywhere inside a with-item
        expression (handles IfExp, enter_context, read()/write(),
        bare lock references). Returns [(lock name, blocking)]."""
        out: List[Tuple[str, bool]] = []
        for node in ast.walk(expr):
            if isinstance(node, ast.Call):
                fn = node.func
                if isinstance(fn, ast.Attribute):
                    if fn.attr in ("read", "write"):
                        r = self._resolve_lock_expr(
                            fn.value, mod, cls, local_hints)
                        if r is None:
                            src = _expr_src(fn.value)
                            if "latch" in src.lower():
                                r = ("wal.latch", False)
                        if r:
                            out.append((r[0], True))
                    elif fn.attr in _CONTEXT_METHODS:
                        out.append(
                            (_CONTEXT_METHODS[fn.attr], True))
                    elif fn.attr == "acquire":
                        r = self._resolve_lock_expr(
                            fn.value, mod, cls, local_hints)
                        if r:
                            out.append(
                                (r[0], _call_is_blocking(node)))
            elif isinstance(node, (ast.Name, ast.Attribute)):
                # bare lock reference as a context manager: any
                # reference that resolves through the lock tables IS a
                # lock (the tables hold nothing else)
                r = self._resolve_lock_expr(node, mod, cls,
                                            local_hints)
                if r is not None:
                    out.append((r[0], True))
        # dedup, keep first
        seen = set()
        uniq = []
        for name, blocking in out:
            if name not in seen:
                seen.add(name)
                uniq.append((name, blocking))
        return uniq

    def _collect_functions(self) -> None:
        for mod in self.modules:
            for node in ast.walk(mod.tree):
                if isinstance(node, ast.ClassDef):
                    for item in node.body:
                        if isinstance(item, (ast.FunctionDef,
                                             ast.AsyncFunctionDef)):
                            self._analyze_function(
                                mod, node.name, item)
            for item in mod.tree.body:
                if isinstance(item, (ast.FunctionDef,
                                     ast.AsyncFunctionDef)):
                    self._analyze_function(mod, None, item)

    def _analyze_function(self, mod: _Module, cls: Optional[str],
                          fn: ast.FunctionDef) -> None:
        qual = f"{mod.modname}:{cls + '.' if cls else ''}{fn.name}"
        info = _FuncInfo(qual=qual)
        self.funcs[qual] = info
        if cls is None:
            self.module_funcs[(mod.modname, fn.name)] = qual
        else:
            self.class_methods[(mod.modname, cls, fn.name)] = qual
            self.method_index.setdefault(fn.name, set()).add(qual)

        local_hints: Dict[str, str] = {}

        def site(node: ast.AST) -> str:
            return f"{mod.rel}:{getattr(node, 'lineno', 0)}"

        def note_hints(stmt: ast.stmt) -> None:
            # `latch = getattr(self.db, "_ingest_latch", None)` etc.:
            # remember which lock a local variable denotes
            if isinstance(stmt, ast.Assign) and len(stmt.targets) == 1 \
                    and isinstance(stmt.targets[0], ast.Name):
                tgt = stmt.targets[0].id
                for sub in ast.walk(stmt.value):
                    attr = None
                    if isinstance(sub, ast.Attribute):
                        attr = sub.attr
                    elif isinstance(sub, ast.Constant) and \
                            isinstance(sub.value, str):
                        attr = sub.value
                    if attr:
                        cands = self.attr_index.get(attr)
                        if cands and len({n for _, n in cands}) == 1:
                            local_hints[tgt] = \
                                next(iter(cands))[1]
                            return

        def walk_block(stmts: Sequence[ast.stmt],
                       held: List[Tuple[str, bool]]) -> None:
            for stmt in stmts:
                note_hints(stmt)
                if isinstance(stmt, (ast.With, ast.AsyncWith)):
                    acquired: List[Tuple[str, bool]] = []
                    for item in stmt.items:
                        acqs = self._acquisitions_in_expr(
                            item.context_expr, mod, cls, local_hints)
                        for name, blocking in acqs:
                            # `with a, b:` acquires left-to-right:
                            # b is taken while a is held, so earlier
                            # items of the SAME statement are part of
                            # the held set for later ones
                            self._note_acquire(
                                info, held + acquired, name,
                                blocking, site(stmt))
                            acquired.append((name, blocking))
                    held_inner = held + acquired
                    # the with-expression itself may contain calls
                    # (enter_context targets resolved above); body:
                    walk_block(stmt.body, held_inner)
                    continue
                if isinstance(stmt, (ast.FunctionDef,
                                     ast.AsyncFunctionDef)):
                    # nested defs analyzed separately (closures get
                    # conservative self-context)
                    self._analyze_function(mod, cls, stmt)
                    continue
                # statement-level acquire()/enter_context() that
                # holds for the REST of the block
                stmt_acqs = self._statement_acquisitions(
                    stmt, mod, cls, local_hints)
                if stmt_acqs:
                    for name, blocking in stmt_acqs:
                        self._note_acquire(info, held, name,
                                           blocking, site(stmt))
                    held = held + stmt_acqs
                # blocking calls + held-context calls
                for sub in ast.walk(stmt):
                    if isinstance(sub, ast.Call):
                        self._note_call(info, mod, cls, held, sub,
                                        site(sub))
                # recurse into compound statements
                for attr in ("body", "orelse", "finalbody",
                             "handlers"):
                    sub = getattr(stmt, attr, None)
                    if sub:
                        if attr == "handlers":
                            for h in sub:
                                walk_block(h.body, held)
                        else:
                            walk_block(sub, held)

        walk_block(fn.body, [])

    def _statement_acquisitions(self, stmt: ast.stmt, mod: _Module,
                                cls: Optional[str],
                                local_hints: Dict[str, str]
                                ) -> List[Tuple[str, bool]]:
        """`x.acquire(...)` / `stack.enter_context(lockish)` as a bare
        statement or in an if/assign: the lock stays held for the rest
        of the block (releases are not modeled — conservative)."""
        out: List[Tuple[str, bool]] = []
        for node in ast.walk(stmt):
            if not isinstance(node, ast.Call):
                continue
            fn = node.func
            if not isinstance(fn, ast.Attribute):
                continue
            if fn.attr == "acquire":
                r = self._resolve_lock_expr(fn.value, mod, cls,
                                            local_hints)
                if r:
                    out.append((r[0], _call_is_blocking(node)))
            elif fn.attr == "enter_context" and node.args:
                out.extend(self._acquisitions_in_expr(
                    node.args[0], mod, cls, local_hints))
        return out

    def _note_acquire(self, info: _FuncInfo,
                      held: List[Tuple[str, bool]], name: str,
                      blocking: bool, site: str) -> None:
        info.acquisitions.append(_Acq(name, site, blocking))
        if blocking:
            for held_name, _b in held:
                if held_name != name:
                    info.edges.append((held_name, name, site))

    def _note_call(self, info: _FuncInfo, mod: _Module,
                   cls: Optional[str],
                   held: List[Tuple[str, bool]], call: ast.Call,
                   site: str) -> None:
        if not held:
            return
        fn = call.func
        display = _expr_src(fn)
        # blocking-call check
        blocked = None
        if isinstance(fn, ast.Attribute):
            dotted = display
            if dotted in _BLOCKING_DOTTED:
                blocked = dotted
            elif fn.attr in _BLOCKING_ATTRS:
                blocked = display
            elif fn.attr in _BLOCKING_HINTED:
                hints = _BLOCKING_HINTED[fn.attr]
                recv = _expr_src(fn.value).lower()
                if any(h in recv for h in hints):
                    blocked = display
        elif isinstance(fn, ast.Name) and fn.id in ("sleep",):
            blocked = fn.id
        if blocked:
            for held_name, _b in held:
                info.blocking.append((held_name, blocked, site))
            return
        # candidate callee keys for one-level expansion
        cands: List[str] = []
        if isinstance(fn, ast.Name):
            q = self.module_funcs.get((mod.modname, fn.id))
            if q:
                cands.append(q)
            else:
                target = mod.imports.get(fn.id)
                if target and target.startswith("theia_tpu"):
                    tmod, _, tfn = target.rpartition(".")
                    q = self.module_funcs.get((tmod, tfn))
                    if q:
                        cands.append(q)
        elif isinstance(fn, ast.Attribute):
            if isinstance(fn.value, ast.Name) and \
                    fn.value.id == "self" and cls is not None:
                q = self.class_methods.get(
                    (mod.modname, cls, fn.attr))
                if q:
                    cands.append(q)
            elif isinstance(fn.value, ast.Name) and \
                    fn.value.id in mod.imports:
                target = mod.imports[fn.value.id]
                if target.startswith("theia_tpu"):
                    q = self.module_funcs.get((target, fn.attr))
                    if q:
                        cands.append(q)
            if not cands:
                # package-unique method name: one definition anywhere.
                # Container/stdlib method names are excluded — a deque
                # also has .clear(), so uniqueness proves nothing.
                owners = self.method_index.get(fn.attr, set())
                if len(owners) == 1 and \
                        not fn.attr.startswith("__") and \
                        fn.attr not in _STDLIB_METHODS:
                    cands.append(next(iter(owners)))
        if cands:
            for held_name, _b in held:
                info.held_calls.append(
                    (held_name, display, cands, site))

    # -- pass 3: merge + report -----------------------------------------

    def _merge_graph(self) -> None:
        for info in self.funcs.values():
            for held, acq, site in info.edges:
                self.graph.setdefault((held, acq), site)
            for held, display, cands, site in info.held_calls:
                for q in cands:
                    callee = self.funcs.get(q)
                    if callee is None:
                        continue
                    for acq in callee.acquisitions:
                        if acq.blocking and acq.name != held:
                            self.graph.setdefault(
                                (held, acq.name),
                                f"{site} via {display}() "
                                f"[{acq.site}]")

    def _cycles(self) -> List[List[str]]:
        """One representative cycle per SCC of the order graph."""
        adj: Dict[str, Set[str]] = {}
        for (a, b) in self.graph:
            adj.setdefault(a, set()).add(b)
            adj.setdefault(b, set())
        # Tarjan SCC
        index: Dict[str, int] = {}
        low: Dict[str, int] = {}
        on: Set[str] = set()
        stack: List[str] = []
        sccs: List[List[str]] = []
        counter = [0]

        def strongconnect(v: str) -> None:
            work = [(v, iter(sorted(adj[v])))]
            index[v] = low[v] = counter[0]
            counter[0] += 1
            stack.append(v)
            on.add(v)
            while work:
                node, it = work[-1]
                advanced = False
                for w in it:
                    if w not in index:
                        index[w] = low[w] = counter[0]
                        counter[0] += 1
                        stack.append(w)
                        on.add(w)
                        work.append((w, iter(sorted(adj[w]))))
                        advanced = True
                        break
                    elif w in on:
                        low[node] = min(low[node], index[w])
                if advanced:
                    continue
                work.pop()
                if work:
                    parent = work[-1][0]
                    low[parent] = min(low[parent], low[node])
                if low[node] == index[node]:
                    scc = []
                    while True:
                        w = stack.pop()
                        on.discard(w)
                        scc.append(w)
                        if w == node:
                            break
                    if len(scc) > 1:
                        sccs.append(sorted(scc))

        for v in sorted(adj):
            if v not in index:
                strongconnect(v)

        cycles = []
        for scc in sccs:
            # walk one concrete cycle inside the SCC for the report
            start = scc[0]
            path = [start]
            seen = {start}
            node = start
            while True:
                nxts = [w for w in sorted(adj[node])
                        if w in scc and (w == start or w not in seen)]
                if not nxts:
                    break
                nxt = nxts[0]
                if nxt == start:
                    path.append(start)
                    break
                seen.add(nxt)
                path.append(nxt)
                node = nxt
            if len(path) > 1 and path[-1] == start:
                cycles.append(path)
            else:
                cycles.append(scc + [scc[0]])
        return cycles

    # -- torn-read check -------------------------------------------------

    def _torn_reads(self) -> List[Finding]:
        findings = []
        for mod in self.modules:
            for node in ast.walk(mod.tree):
                if isinstance(node, ast.ClassDef):
                    findings.extend(
                        self._torn_reads_in_class(mod, node))
        return findings

    def _torn_reads_in_class(self, mod: _Module,
                             cls: ast.ClassDef) -> List[Finding]:
        has_lock = any((mod.modname, cls.name, a) in self.locks
                       for a in {attr for (m, c, attr) in self.locks
                                 if m == mod.modname
                                 and c == cls.name})
        if not has_lock:
            return []
        # writer side: >=2 distinct self attrs assigned in ONE locked
        # block of a non-__init__ method
        transitions: List[Tuple[str, Tuple[str, ...], str]] = []
        for item in cls.body:
            if not isinstance(item, ast.FunctionDef) or \
                    item.name == "__init__":
                continue
            for sub in ast.walk(item):
                if not isinstance(sub, (ast.With, ast.AsyncWith)):
                    continue
                if not _with_uses_lock(sub, mod, cls.name, self):
                    continue
                attrs = set()
                for s2 in ast.walk(sub):
                    if isinstance(s2, ast.Assign):
                        for tgt in s2.targets:
                            if isinstance(tgt, ast.Attribute) and \
                                    isinstance(tgt.value, ast.Name) \
                                    and tgt.value.id == "self":
                                attrs.add(tgt.attr)
                attrs = {a for a in attrs
                         if (mod.modname, cls.name, a)
                         not in self.locks}
                if len(attrs) >= 2:
                    transitions.append(
                        (item.name, tuple(sorted(attrs)),
                         f"{mod.rel}:{sub.lineno}"))
        if not transitions:
            return []
        findings = []
        reported = set()
        for item in cls.body:
            if not isinstance(item, ast.FunctionDef) or \
                    item.name == "__init__":
                continue
            if item.name.endswith("_locked"):
                # repo convention: a *_locked method is CALLED with
                # the class lock held — its reads are not lock-free
                continue
            reads = _unlocked_attr_reads(item, mod, cls.name, self)
            for writer, attrs, wsite in transitions:
                if item.name == writer:
                    continue
                both = [a for a in attrs if a in reads]
                if len(both) >= 2:
                    pair = ",".join(sorted(both)[:3])
                    key = (f"torn-read:{mod.rel}:{cls.name}:"
                           f"{pair}")
                    if key in reported:
                        continue
                    reported.add(key)
                    findings.append(Finding(
                        check="torn-read",
                        key=key,
                        message=(
                            f"{cls.name}.{writer} transitions "
                            f"({pair}) under the lock but "
                            f"{cls.name}.{item.name} reads them "
                            f"with no lock held — a reader between "
                            f"the two writes sees a torn state"),
                        site=f"{mod.rel}:{item.lineno}",
                        detail=f"locked transition at {wsite}"))
        return findings

    # -- driver -----------------------------------------------------------

    def run(self) -> List[Finding]:
        self._collect_locks()
        self._collect_functions()
        self._merge_graph()
        findings: List[Finding] = []
        for cycle in self._cycles():
            canon = _canonical_cycle(cycle)
            sites = []
            for a, b in zip(cycle, cycle[1:]):
                sites.append(f"{a}->{b} @ "
                             f"{self.graph.get((a, b), '?')}")
            findings.append(Finding(
                check="lock-order-cycle",
                key=f"lock-order-cycle:{'->'.join(canon)}",
                message=(f"lock-order cycle "
                         f"{' -> '.join(cycle)} (deadlock the "
                         f"moment two threads interleave)"),
                site=self.graph.get((cycle[0], cycle[1]), "?")
                .split(" ")[0],
                detail="; ".join(sites)))
        seen_block = set()
        for info in self.funcs.values():
            for held, callname, site in info.blocking:
                relfile = site.split(":")[0]
                key = (f"blocking-under-lock:{relfile}:{held}:"
                       f"{callname}")
                if key in seen_block:
                    continue
                seen_block.add(key)
                findings.append(Finding(
                    check="blocking-under-lock",
                    key=key,
                    message=(f"{callname}() called while holding "
                             f"{held} — every waiter convoys behind "
                             f"this block"),
                    site=site,
                    detail=info.qual))
        findings.extend(self._torn_reads())
        return findings

    def edges_doc(self) -> List[Dict[str, str]]:
        return [{"held": a, "acquired": b, "site": s}
                for (a, b), s in sorted(self.graph.items())]


def _canonical_cycle(cycle: List[str]) -> List[str]:
    """Rotate so the lexicographically-smallest node leads (stable
    waiver keys no matter where the DFS entered the cycle)."""
    body = cycle[:-1] if len(cycle) > 1 and cycle[0] == cycle[-1] \
        else list(cycle)
    i = body.index(min(body))
    rot = body[i:] + body[:i]
    return rot + [rot[0]]


def _call_is_blocking(call: ast.Call) -> bool:
    """acquire(...) blocking-ness: False/0 first arg or blocking=False
    or a timeout kwarg → cannot complete a deadlock cycle."""
    if call.args:
        a0 = call.args[0]
        if isinstance(a0, ast.Constant) and not a0.value:
            return False
    for kw in call.keywords:
        if kw.arg == "blocking" and \
                isinstance(kw.value, ast.Constant) and \
                not kw.value.value:
            return False
        if kw.arg == "timeout":
            return False
    return True


def _with_uses_lock(w: ast.With, mod: _Module, cls: str,
                    lg: LockGraph) -> bool:
    for item in w.items:
        for node in ast.walk(item.context_expr):
            if isinstance(node, ast.Attribute) and \
                    isinstance(node.value, ast.Name) and \
                    node.value.id == "self" and \
                    (mod.modname, cls, node.attr) in lg.locks:
                return True
    return False


def _unlocked_attr_reads(fn: ast.FunctionDef, mod: _Module, cls: str,
                         lg: LockGraph) -> Set[str]:
    """self attrs READ in ``fn`` outside every with-lock block."""
    locked_spans: List[Tuple[int, int]] = []
    for sub in ast.walk(fn):
        if isinstance(sub, (ast.With, ast.AsyncWith)) and \
                _with_uses_lock(sub, mod, cls, lg):
            locked_spans.append(
                (sub.lineno, getattr(sub, "end_lineno", sub.lineno)))

    def outside(lineno: int) -> bool:
        return not any(a <= lineno <= b for a, b in locked_spans)

    reads = set()
    for sub in ast.walk(fn):
        if isinstance(sub, ast.Attribute) and \
                isinstance(sub.ctx, ast.Load) and \
                isinstance(sub.value, ast.Name) and \
                sub.value.id == "self" and outside(sub.lineno):
            reads.add(sub.attr)
    return reads


def analyze_source(source: str, modname: str = "fixture",
                   rel: str = "fixture.py") -> List[Finding]:
    """Run the full pass over ONE in-memory module (test fixtures)."""
    import tempfile
    with tempfile.NamedTemporaryFile(
            "w", suffix=".py", delete=False) as f:
        f.write(source)
        path = f.name
    try:
        mod = _Module(path, rel, modname)
    finally:
        os.unlink(path)
    lg = LockGraph(package_dir=".", modules=[mod])
    return lg.run()
