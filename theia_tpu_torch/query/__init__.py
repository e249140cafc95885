"""Vectorized query engine over the part-based column store.

`plan.py` parses/normalizes queries, `engine.py` executes them
part-natively (pruned, encoded-space filters, late-materializing
group-by, bounded-pool parallelism, cold streaming, result cache),
`kernels.py` holds the aggregation kernels (numpy reduceat / int64
torch segment reductions on the engine's device), `reference.py` is the slow-but-correct
oracle the whole path is gated against, `distributed.py` is the
cluster scatter-gather tier (coordinator fan-out over
`/query/partial`, mergeable TQPF partial frames, peer pruning,
cluster-fingerprint caching), and `rollup.py` is the streaming
materialized rollup-view subsystem (declarative aggregate views
maintained incrementally as first-class parts, cascaded tier
downsampling, and the transparent planner rewrite that answers
subsumed windowed plans from the coarsest covering tier with
raw-scan edges stitched bit-identically).
"""

from .distributed import ClusterQueryCoordinator, IncompleteResultError
from .engine import (QueryCache, QueryEngine, QueryError,
                     merge_materialized)
from .kernels import kernel_mode
from .plan import (AGG_OPS, Aggregate, Filter, PlanError, QueryPlan,
                   parse_plan, plan_from_params)
from .reference import reference_execute

__all__ = [
    "AGG_OPS", "Aggregate", "ClusterQueryCoordinator", "Filter",
    "IncompleteResultError", "PlanError", "QueryCache", "QueryEngine",
    "QueryError", "QueryPlan", "kernel_mode", "merge_materialized",
    "parse_plan", "plan_from_params", "reference_execute",
]
