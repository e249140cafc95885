"""Repo lint — the recurring review-hardening bug classes, mechanized.

Ten PRs of review logs name the same four defect families over and
over; each is a pattern a machine can hold better than a reviewer:

  * ``undeclared-env``: a ``THEIA_*`` environment variable read in
    code (``os.environ.get/[]``, ``os.getenv``, ``env_int``,
    ``env_float``, local ``_env_int`` helpers) with no row in any
    docs/*.md knob table — an operator knob nobody can discover.
    This generalizes the PR-11 docdrift env gate (which covered four
    prefixes) to EVERY env access; tests/test_docdrift.py drives both
    directions from this pass's extraction.
  * ``unregistered-fault-site`` / ``stale-fault-site``: ``fire()``
    literals vs ``utils/faults.KNOWN_SITES``, both directions — a
    drill script must never arm a site that no longer fires.
  * ``bare-except`` / ``swallowed-except``: ``except:`` and broad
    ``except Exception: pass`` — the error-eating class every
    "review hardening" list has had an instance of.
  * ``raw-clock``: a direct ``time.time()``/``time.monotonic()`` call
    in a module that follows the injectable-clock convention (some
    function takes a ``clock`` parameter) — untestable time is how
    the PR-5 load-flake got in.

Run with the rest of the suite via ``python -m theia_tpu_torch.analysis``.
"""

from __future__ import annotations

import ast
import os
import re
from typing import Dict, List, Optional, Sequence, Set, Tuple

from .base import Finding

#: docs knob-table rows: `| `THEIA_FOO` | default | meaning |`
_ENV_ROW = re.compile(r"^\|\s*`(THEIA_[A-Z0-9_]+)`", re.MULTILINE)

def _iter_py(package_dir: str, extra: Sequence[str] = ()
             ) -> List[Tuple[str, str]]:
    """(path, repo-relative) for every module in the package plus any
    ``extra`` files (bench.py reads knobs too)."""
    root = os.path.dirname(os.path.abspath(package_dir))
    out = []
    for dirpath, _d, filenames in sorted(os.walk(package_dir)):
        for fn in sorted(filenames):
            if fn.endswith(".py"):
                path = os.path.join(dirpath, fn)
                out.append((path, os.path.relpath(path, root)))
    for path in extra:
        if os.path.exists(path):
            out.append((path, os.path.relpath(
                path, root)))
    return out


# -- env knob extraction (shared with tests/test_docdrift.py) ------------

_ENV_NAME = re.compile(r"THEIA_[A-Z0-9_]+")


def _docstring_linenos(tree: ast.AST) -> Set[int]:
    """Line spans of module/class/function docstrings (mentioning a
    knob in prose is not a read)."""
    out: Set[int] = set()
    for node in ast.walk(tree):
        if isinstance(node, (ast.Module, ast.ClassDef,
                             ast.FunctionDef, ast.AsyncFunctionDef)):
            body = getattr(node, "body", [])
            if body and isinstance(body[0], ast.Expr) and \
                    isinstance(body[0].value, ast.Constant) and \
                    isinstance(body[0].value.value, str):
                d = body[0].value
                out.update(range(d.lineno,
                                 getattr(d, "end_lineno",
                                         d.lineno) + 1))
    return out


def extract_env_reads(package_dir: str, extra: Sequence[str] = ()
                      ) -> Dict[str, List[str]]:
    """Every ``THEIA_*`` name the code READS from the environment ->
    [file:line sites]. Two tiers, merged: direct reads (env access
    calls with a literal name) and indirect references (a THEIA_*
    name in any non-docstring string literal — knob names are also
    passed as DATA, e.g. ``sample_env="THEIA_TRACE_SAMPLE_INGEST"``
    or rollup tier tuples, and read through a variable later).
    Docstrings and comments never count."""
    reads: Dict[str, List[str]] = {}

    def note(name: str, rel: str, lineno: int) -> None:
        if name.startswith("THEIA_"):
            reads.setdefault(name, []).append(f"{rel}:{lineno}")

    for path, rel in _iter_py(package_dir, extra):
        with open(path, "r", encoding="utf-8") as f:
            try:
                tree = ast.parse(f.read(), filename=path)
            except SyntaxError:
                continue
        doc_lines = _docstring_linenos(tree)
        for node in ast.walk(tree):
            # one tier suffices: the name literal inside ANY env
            # access call (`os.environ.get("X")`, `env_int("X", d)`,
            # `os.environ["X"]`) is itself an ast.Constant, so the
            # string sweep covers direct reads and names-as-data
            # identically
            if isinstance(node, ast.Constant) and \
                    isinstance(node.value, str) and \
                    node.lineno not in doc_lines:
                for name in _ENV_NAME.findall(node.value):
                    note(name, rel, node.lineno)
    return reads


def documented_env_knobs(docs_dir: str) -> Dict[str, List[str]]:
    """THEIA_* names with a knob-table row in any docs/*.md ->
    [doc files]."""
    out: Dict[str, List[str]] = {}
    if not os.path.isdir(docs_dir):
        return out
    for fn in sorted(os.listdir(docs_dir)):
        if not fn.endswith(".md"):
            continue
        text = open(os.path.join(docs_dir, fn),
                    encoding="utf-8").read()
        for name in _ENV_ROW.findall(text):
            out.setdefault(name, []).append(fn)
    return out


# -- fault-site extraction -----------------------------------------------

def extract_fired_sites(package_dir: str
                        ) -> Dict[str, List[str]]:
    """Literal first args of ``fire(...)`` / ``_fire_fault(...)``
    calls -> sites. ``site#target`` entries normalize to the site."""
    fired: Dict[str, List[str]] = {}
    for path, rel in _iter_py(package_dir):
        with open(path, "r", encoding="utf-8") as f:
            try:
                tree = ast.parse(f.read(), filename=path)
            except SyntaxError:
                continue
        if rel.endswith("utils/faults.py"):
            continue                      # the registry itself
        for node in ast.walk(tree):
            if not isinstance(node, ast.Call):
                continue
            fn = node.func
            fname = fn.attr if isinstance(fn, ast.Attribute) else (
                fn.id if isinstance(fn, ast.Name) else None)
            if fname not in ("fire", "_fire_fault"):
                continue
            if node.args and isinstance(node.args[0], ast.Constant) \
                    and isinstance(node.args[0].value, str):
                site = node.args[0].value.partition("#")[0]
                fired.setdefault(site, []).append(
                    f"{rel}:{node.lineno}")
    return fired


# -- the pass ------------------------------------------------------------

class Lint:
    def __init__(self, package_dir: str, docs_dir: str,
                 extra: Sequence[str] = ()) -> None:
        self.package_dir = package_dir
        self.docs_dir = docs_dir
        self.extra = list(extra)

    def run(self) -> List[Finding]:
        findings: List[Finding] = []
        findings.extend(self._check_env())
        findings.extend(self._check_fault_sites())
        findings.extend(self._check_excepts_and_clocks())
        return findings

    def _check_env(self) -> List[Finding]:
        reads = extract_env_reads(self.package_dir, self.extra)
        documented = documented_env_knobs(self.docs_dir)
        findings = []
        for name in sorted(reads):
            if name not in documented:
                findings.append(Finding(
                    check="undeclared-env",
                    key=f"undeclared-env:{name}",
                    message=(f"{name} is read from the environment "
                             f"but has no knob-table row in any "
                             f"docs/*.md"),
                    site=reads[name][0],
                    detail=", ".join(reads[name][:5])))
        return findings

    def _check_fault_sites(self) -> List[Finding]:
        from ..utils.faults import KNOWN_SITES
        fired = extract_fired_sites(self.package_dir)
        findings = []
        for site in sorted(fired):
            if site not in KNOWN_SITES:
                findings.append(Finding(
                    check="unregistered-fault-site",
                    key=f"unregistered-fault-site:{site}",
                    message=(f"fault site {site!r} is fired but not "
                             f"registered in utils/faults.py "
                             f"KNOWN_SITES"),
                    site=fired[site][0]))
        for site in KNOWN_SITES:
            if site not in fired:
                findings.append(Finding(
                    check="stale-fault-site",
                    key=f"stale-fault-site:{site}",
                    message=(f"KNOWN_SITES entry {site!r} is never "
                             f"fired — a drill arming it would "
                             f"silently do nothing"),
                    site="theia_tpu/utils/faults.py"))
        return findings

    def _check_excepts_and_clocks(self) -> List[Finding]:
        findings = []
        for path, rel in _iter_py(self.package_dir):
            with open(path, "r", encoding="utf-8") as f:
                try:
                    tree = ast.parse(f.read(), filename=path)
                except SyntaxError:
                    continue
            has_clock_param = False
            for node in ast.walk(tree):
                if isinstance(node, (ast.FunctionDef,
                                     ast.AsyncFunctionDef)):
                    args = node.args
                    names = [a.arg for a in
                             args.posonlyargs + args.args
                             + args.kwonlyargs]
                    if "clock" in names:
                        has_clock_param = True
                        break
            func_of: Dict[int, str] = {}
            for node in ast.walk(tree):
                if isinstance(node, (ast.FunctionDef,
                                     ast.AsyncFunctionDef)):
                    for sub in ast.walk(node):
                        ln = getattr(sub, "lineno", None)
                        if ln is not None and ln not in func_of:
                            func_of[ln] = node.name

            def qual(node: ast.AST) -> str:
                return func_of.get(getattr(node, "lineno", 0),
                                   "<module>")

            for node in ast.walk(tree):
                if isinstance(node, ast.ExceptHandler):
                    if node.type is None:
                        findings.append(Finding(
                            check="bare-except",
                            key=f"bare-except:{rel}:{qual(node)}",
                            message=(f"bare `except:` in "
                                     f"{qual(node)} catches "
                                     f"KeyboardInterrupt/SystemExit "
                                     f"too"),
                            site=f"{rel}:{node.lineno}"))
                    elif _is_broad(node.type) and \
                            all(isinstance(s, (ast.Pass,
                                               ast.Continue))
                                for s in node.body):
                        findings.append(Finding(
                            check="swallowed-except",
                            key=(f"swallowed-except:{rel}:"
                                 f"{qual(node)}"),
                            message=(f"broad exception silently "
                                     f"swallowed in {qual(node)} — "
                                     f"a real bug here leaves no "
                                     f"trace"),
                            site=f"{rel}:{node.lineno}"))
                elif has_clock_param and isinstance(node, ast.Call):
                    fn = node.func
                    if isinstance(fn, ast.Attribute) and \
                            isinstance(fn.value, ast.Name) and \
                            fn.value.id == "time" and \
                            fn.attr in ("time", "monotonic"):
                        findings.append(Finding(
                            check="raw-clock",
                            key=(f"raw-clock:{rel}:{qual(node)}:"
                                 f"time.{fn.attr}"),
                            message=(
                                f"direct time.{fn.attr}() in "
                                f"{qual(node)} — this module "
                                f"follows the injectable-clock "
                                f"convention; wall-clock reads here "
                                f"are untestable"),
                            site=f"{rel}:{node.lineno}"))
        # dedup raw-clock repeats per (file, func, call)
        seen: Set[str] = set()
        uniq = []
        for f in findings:
            if f.key in seen:
                continue
            seen.add(f.key)
            uniq.append(f)
        return uniq


def _is_broad(type_node: Optional[ast.expr]) -> bool:
    names = []
    if isinstance(type_node, ast.Name):
        names = [type_node.id]
    elif isinstance(type_node, ast.Tuple):
        names = [e.id for e in type_node.elts
                 if isinstance(e, ast.Name)]
    return any(n in ("Exception", "BaseException") for n in names)
