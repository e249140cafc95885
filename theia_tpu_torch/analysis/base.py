"""Shared finding/waiver machinery for the static analysis passes.

A *finding* is one defect report with a stable ``key`` (no line
numbers — keys survive unrelated edits) plus a human site reference.
A *waiver* (analysis/waivers.py) matches finding keys by ``fnmatch``
glob and MUST cite the invariant that makes the waived code safe —
an empty or hand-wavy invariant fails validation, because a waiver
without a written invariant is just a silenced bug.

Waiver semantics are strict in both directions: an unwaived finding
fails the gate, and a waiver that matches nothing is STALE and fails
too (the code it described changed; the file must be updated with it).
"""

from __future__ import annotations

import dataclasses
import fnmatch
from typing import Dict, List, Sequence, Tuple

#: a waiver invariant shorter than this cannot plausibly state WHY the
#: flagged code is safe
MIN_INVARIANT_CHARS = 40


@dataclasses.dataclass
class Finding:
    check: str           # e.g. "lock-order-cycle", "undeclared-env"
    key: str             # stable id the waiver file matches against
    message: str         # human one-liner
    site: str = ""       # file:line of the primary evidence
    detail: str = ""     # optional expansion (cycle path, call chain)

    def doc(self) -> Dict[str, str]:
        return dataclasses.asdict(self)


class WaiverError(Exception):
    """The waiver file itself is malformed (missing invariant, stale
    entry, unknown check)."""


KNOWN_CHECKS = (
    "lock-order-cycle",
    "blocking-under-lock",
    "torn-read",
    "undeclared-env",
    "unregistered-fault-site",
    "stale-fault-site",
    "bare-except",
    "swallowed-except",
    "raw-clock",
)


def validate_waivers(waivers: Sequence[Dict[str, str]]) -> List[str]:
    """Structural validation; returns a list of problems (empty =
    valid)."""
    problems = []
    seen = set()
    for i, w in enumerate(waivers):
        where = f"waiver #{i + 1}"
        check = w.get("check", "")
        match = w.get("match", "")
        invariant = w.get("invariant", "")
        if check not in KNOWN_CHECKS:
            problems.append(f"{where}: unknown check {check!r} "
                            f"(known: {', '.join(KNOWN_CHECKS)})")
        if not match:
            problems.append(f"{where}: empty match pattern")
        if len(invariant.strip()) < MIN_INVARIANT_CHARS:
            problems.append(
                f"{where} ({check}:{match}): invariant must spell out "
                f"WHY the flagged code is safe "
                f"(≥{MIN_INVARIANT_CHARS} chars)")
        if (check, match) in seen:
            problems.append(f"{where}: duplicate of ({check}, {match})")
        seen.add((check, match))
    return problems


def apply_waivers(
    findings: Sequence[Finding],
    waivers: Sequence[Dict[str, str]],
) -> Tuple[List[Finding], List[Tuple[Finding, Dict[str, str]]],
           List[Dict[str, str]]]:
    """Partition into (unwaived findings, waived (finding, waiver)
    pairs, stale waivers that matched nothing)."""
    used = [False] * len(waivers)
    unwaived: List[Finding] = []
    waived: List[Tuple[Finding, Dict[str, str]]] = []
    for f in findings:
        hit = None
        for i, w in enumerate(waivers):
            if w.get("check") == f.check and \
                    fnmatch.fnmatchcase(f.key, w.get("match", "")):
                used[i] = True
                if hit is None:
                    hit = w
        if hit is None:
            unwaived.append(f)
        else:
            waived.append((f, hit))
    stale = [w for i, w in enumerate(waivers) if not used[i]]
    return unwaived, waived, stale
