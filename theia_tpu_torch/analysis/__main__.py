"""``python -m theia_tpu_torch.analysis`` — run the static passes over
the port.

Exit status 0 = every finding waived (with a cited invariant) and no
stale waivers; 1 = unwaived findings or waiver-file problems. Tier-1
asserts the clean run (tests/test_torch_analysis.py), so the gate
rides every CI pass.

Ports theia_tpu/analysis/__main__.py: the passes scan
``theia_tpu_torch/`` and the port's ``chip_smoke.py`` (which sets the
knobs of the managers it starts), against the repo's ``docs/`` knob
tables.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

from .base import apply_waivers, validate_waivers
from .lint import Lint
from .lockgraph import LockGraph
from .waivers import WAIVERS


def repo_root() -> str:
    return os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__))))


def run_all(root: str):
    """(findings, lockgraph) over the port at ``root``."""
    pkg = os.path.join(root, "theia_tpu_torch")
    lg = LockGraph(pkg)
    findings = lg.run()
    findings.extend(Lint(pkg, os.path.join(root, "docs"),
                         extra=[os.path.join(root,
                                             "chip_smoke.py")]).run())
    return findings, lg


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m theia_tpu_torch.analysis",
        description="static concurrency/lint analysis for "
                    "theia_tpu_torch")
    ap.add_argument("--json", action="store_true",
                    help="machine-readable report")
    ap.add_argument("--all", action="store_true",
                    help="show waived findings too")
    ap.add_argument("--edges", action="store_true",
                    help="print the static lock-order edge graph")
    ap.add_argument("--root", default=None,
                    help="repo root (default: autodetect)")
    args = ap.parse_args(argv)

    root = args.root or repo_root()
    findings, lg = run_all(root)
    problems = validate_waivers(WAIVERS)
    unwaived, waived, stale = apply_waivers(findings, WAIVERS)

    if args.json:
        print(json.dumps({
            "findings": [f.doc() for f in unwaived],
            "waived": [{"finding": f.doc(),
                        "invariant": w["invariant"]}
                       for f, w in waived],
            "staleWaivers": stale,
            "waiverProblems": problems,
            "edges": lg.edges_doc(),
            "locks": sorted(set(lg.locks.values())),
            "unresolvedRefs": sorted(set(lg.unresolved)),
        }, indent=2))
        return 1 if (unwaived or stale or problems) else 0

    print(f"theia_tpu_torch analysis: {len(lg.locks)} lock attrs "
          f"({len(set(lg.locks.values()))} classes), "
          f"{len(lg.graph)} static order edges, "
          f"{len(findings)} findings "
          f"({len(waived)} waived)")
    if args.edges:
        for e in lg.edges_doc():
            print(f"  edge {e['held']} -> {e['acquired']}  "
                  f"[{e['site']}]")
    if lg.unresolved:
        print(f"  note: {len(set(lg.unresolved))} unresolved lock "
              f"refs (receiver ambiguous): "
              f"{', '.join(sorted(set(lg.unresolved))[:8])}")
    for f in unwaived:
        print(f"FINDING {f.check}: {f.message}")
        print(f"    key:  {f.key}")
        print(f"    site: {f.site}")
        if f.detail:
            print(f"    detail: {f.detail}")
    if args.all:
        for f, w in waived:
            print(f"waived {f.check}: {f.key}")
            print(f"    invariant: {w['invariant']}")
    for p in problems:
        print(f"WAIVER PROBLEM: {p}")
    for w in stale:
        print(f"STALE WAIVER (matches nothing — code changed?): "
              f"{w.get('check')}:{w.get('match')}")
    if unwaived or stale or problems:
        print(f"\nFAIL: {len(unwaived)} unwaived finding(s), "
              f"{len(stale)} stale waiver(s), "
              f"{len(problems)} waiver problem(s)")
        return 1
    print("clean: every finding waived with a cited invariant")
    return 0


if __name__ == "__main__":
    sys.exit(main())
