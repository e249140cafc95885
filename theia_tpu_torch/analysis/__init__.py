"""Concurrency correctness tooling.

Three cooperating passes keep the homegrown concurrent core honest the
way the reference's battle-tested engines (ClickHouse, Spark) are kept
honest by their own CI:

  * ``lockgraph`` — static AST lock-order analysis over the whole
    package: lock identification, held->acquired edge extraction (one
    level interprocedural), cycle + blocking-call-under-lock reports.
  * ``lockdep``  — the runtime witness: a named-lock factory adopted
    by every lock in the package which, under ``THEIA_LOCKDEP=1``,
    records per-thread held-sets and flags an order inversion the
    moment both orders have EVER been observed — no deadlock needed.
  * ``lint``     — the recurring review-hardening bug classes as
    mechanical checks (undeclared THEIA_* env reads, unregistered
    fault sites, bare/swallowed exceptions, raw clocks in
    injectable-clock modules).

Run the static passes over the port with ``python -m
theia_tpu_torch.analysis``; tier-1 asserts a clean (zero unwaived
findings) run via tests/test_torch_analysis.py.

This ``__init__`` deliberately imports nothing: ``lockdep`` is imported
by every module in the package, so the package root must stay free of
heavyweight (or cyclic) imports.
"""
