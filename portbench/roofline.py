"""Peaks of one NVIDIA H100 SXM and the least time of the work the
benchmark's kernels need, counted from their inputs.

Peaks (NVIDIA's data sheet, dense, at the 700 W power limit): 67 TFLOP/s
in float32 outside the tensor cores (TF32 is off where the job keeps
float32 rounding), 3.35 TB/s of HBM.
"""

from __future__ import annotations

from typing import Tuple

F32_FLOPS = 67e12
HBM_BYTES_PER_S = 3.35e12


def sad_pairs_ops(n: int, f: int, core: int) -> float:
    """Float32 operations of the SAD job's pairwise DBSCAN noise test
    over n points of width f with `core` core points: a first pass over
    every ordered pair (the neighbour count), a second over each
    non-core point against the core points (reachability); a pair's
    squared distance from the expansion |x|² + |y|² − 2x·y is f
    multiplies, f − 1 adds, 3 operations to combine and 1 compare."""
    per_pair = 2 * f + 3
    return float(n) * n * per_pair + float(n - core) * core * per_pair


def sad_pairs_bytes(n: int, f: int) -> float:
    """Each point's float32 coordinates read once, a flag written."""
    return float(n) * f * 4 + n


def sad_pairs_bound_s(n: int, f: int, core: int) -> Tuple[float, str]:
    """(least seconds, the bound that binds: "operations" or "bytes")."""
    ops_s = sad_pairs_ops(n, f, core) / F32_FLOPS
    bytes_s = sad_pairs_bytes(n, f) / HBM_BYTES_PER_S
    return (ops_s, "operations") if ops_s >= bytes_s else (bytes_s, "bytes")
