"""Capped exponential backoff — the one schedule every supervisor
shares.

Reference: wait.Backoff in k8s.io/apimachinery (the Step() schedule
the reference's controllers lean on). Four supervisors here — job
retries, replica repair, reconciler passes, CLI polling — back off
the same way; the arithmetic lives once so a semantics fix (jitter,
overflow) lands everywhere.
"""

from __future__ import annotations

import random
from typing import Optional


def capped_backoff(base: float, cap: float, attempt: int) -> float:
    """Delay before retry number `attempt` (1-based):
    min(cap, base * 2**(attempt-1)). Exponent is clamped so a
    long-failing supervisor never computes a bignum just to throw it
    away against the cap."""
    if attempt < 1:
        raise ValueError(f"attempt is 1-based, got {attempt}")
    if attempt > 64:
        return cap
    return min(cap, base * (2 ** (attempt - 1)))


def jittered_backoff(base: float, cap: float, attempt: int,
                     rng: Optional[random.Random] = None) -> float:
    """`capped_backoff` with equal jitter — uniform in [0.5x, 1x] of
    the capped delay, so a fleet of producers rejected by the same
    429 does not retry in lockstep (the thundering-herd retry is
    exactly what an overloaded manager cannot absorb). Pass a seeded
    `rng` for reproducible schedules in tests."""
    d = capped_backoff(base, cap, attempt)
    r = rng if rng is not None else random
    return d * (0.5 + 0.5 * r.random())
