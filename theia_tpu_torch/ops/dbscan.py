"""DBSCAN outlier scoring of 1-D throughput series.

Ports the per-series part of theia_tpu/ops/dbscan.py. Reference
semantics (the TAD job's DBSCAN, anomaly_detection.py:325-349):
sklearn DBSCAN(min_samples=4, eps=2.5e8) over the 1-D throughput
values of one connection; points labelled -1 (noise) are anomalies.
The algoCalc column is a 0.0 placeholder (:312-322).

Noise detection — all the job needs — is closed-form:

    core_i   = |{j : |x_i − x_j| ≤ eps}| ≥ min_samples   (self included)
    noise_i  = ¬core_i ∧ ¬∃j (core_j ∧ |x_i − x_j| ≤ eps)

`dbscan_noise` computes it as an [S, T, T] masked distance tensor in
the dtype of x (the plain version). `dbscan_noise_cuda` is the wrapper
of B2, the hand-written CUDA kernel csrc/dbscan_noise.cu, which never
builds the cube: one launch for short or many series, two passes for
a few long ones (`_plan`). `dbscan_scores` sends a CUDA tensor to B2
(in float32, as the reference sends TPU work to its Pallas kernel; B2
rounds float64 x itself) and a CPU tensor to `dbscan_noise` (in x's
dtype, as the reference's XLA path on the CPU).

`dbscan_points_noise` is the spatial variant over [N, F] point
embeddings (theia_tpu/ops/dbscan.py:126): the same closed-form noise
test over euclidean distance, in [block, N] tiles of torch ops with a
full-float32 matmul, as the reference leaves it to XLA.
"""

from __future__ import annotations

import ctypes
import functools
import threading
from typing import NamedTuple

import torch

from .masked import masked_stddev_samp

DEFAULT_EPS = 2.5e8
DEFAULT_MIN_SAMPLES = 4


def dbscan_noise(x: torch.Tensor, mask: torch.Tensor,
                 eps: float = DEFAULT_EPS,
                 min_samples: int = DEFAULT_MIN_SAMPLES) -> torch.Tensor:
    """Noise (= anomaly) flags for a padded [S, T] series batch."""
    within = (x[..., :, None] - x[..., None, :]).abs() <= eps
    within &= mask[..., :, None] & mask[..., None, :]
    neighbor_counts = within.sum(dim=-1)
    core = (neighbor_counts >= min_samples) & mask
    reachable = (within & core[..., None, :]).any(dim=-1)
    return mask & ~core & ~reachable


# -- B2: the kernel wrapper ---------------------------------------------

_launch_lock = threading.Lock()
#: B2 kernel calls since import (one per call that reached the card,
#: whichever route; the two-pass route is two kernel launches); a call
#: on CPU tensors runs the plain version and does not count
launches = 0

#: the kernel's constants (checked against the library when it loads):
#: j's between two early-exit votes, to which a staged series is
#: padded; the two-pass route's i-tile
_CHECK = 16
_PASS_I = 256
#: one-launch blocks hold at least this many threads, at most 1,024
_ONE_MIN_THREADS = 128
_ONE_MAX_THREADS = 1024
#: the longest series one block holds (1,024 threads of 4 points); up
#: to half of it a thread holds 2
_ONE_MAX_T = 4096
#: series up to this long take one launch whatever the grid
_SHORT_T = 512
#: SMs of an H100 SXM
_SMS = 132
_MAX_GRID_Y = 65535


class _Plan(NamedTuple):
    route: str                # "one_launch" or "two_pass"
    padded_t: int             # T rounded up to _CHECK
    points_per_thread: int    # R (one-launch route)
    threads_per_series: int   # P (one-launch route)
    series_per_block: int     # B (one-launch route)
    blocks: int               # one-launch grid: ceil(S / B)


@functools.lru_cache(maxsize=64)
def _plan(s: int, t: int) -> _Plan:
    """B2's launch plan for an [S, T] batch.

    One-launch geometry: a series is P threads of R points, R = 2 (4
    when the padded series is longer than 2,048), P the power of two
    ≥ padded T / R up to a warp and a multiple of 32 above it;
    B = max(1, 128 // P) series share a block.

    Route rule: one launch when a block holds a whole series
    (T ≤ 4,096) and either the series are short (T ≤ 512: a block's
    work is small whatever the grid) or there are enough of them to
    give each of the card's 132 SMs a block; otherwise two passes,
    whose (series, 256-point i-tile) grid spreads a few long series
    over the SMs."""
    tp = -(-max(t, 1) // _CHECK) * _CHECK
    r = 2 if tp <= 2 * _ONE_MAX_THREADS else 4
    need = tp // r
    p = 1 << (need - 1).bit_length() if need <= 32 else -(-need // 32) * 32
    b = max(1, _ONE_MIN_THREADS // p)
    blocks = -(-s // b)
    one = t <= _ONE_MAX_T and (t <= _SHORT_T or blocks >= _SMS)
    return _Plan("one_launch" if one else "two_pass", tp, r, p, b, blocks)


def _library():
    from ._build import library
    lib = library("dbscan_noise")
    one, two = lib.dbscan_noise_one_launch, lib.dbscan_noise_two_pass
    if one.argtypes is None:
        got = (lib.dbscan_check(), lib.dbscan_pass_i_tile())
        if got != (_CHECK, _PASS_I):
            raise RuntimeError(f"dbscan_noise: the library's constants "
                               f"{got} differ from the wrapper's")
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        one.argtypes = [ptr, i32, ptr, ptr, i32, i32, i32, i32, i32,
                        ctypes.c_float, i32, ptr]
        two.argtypes = [ptr, i32, ptr, ptr, ptr, i32, i32,
                        ctypes.c_float, i32, ptr]
        one.restype = two.restype = ctypes.c_int
    return one, two


def _check(x: torch.Tensor, mask: torch.Tensor) -> None:
    if x.dim() != 2 or mask.shape != x.shape:
        raise ValueError(f"dbscan_noise_cuda: x {tuple(x.shape)} and mask "
                         f"{tuple(mask.shape)}: expected two [S, T]")
    if x.device != mask.device:
        raise ValueError("dbscan_noise_cuda: x and mask must lie on one "
                         f"device, got {x.device} and {mask.device}")


def _launch(route: str, x: torch.Tensor, mask: torch.Tensor,
            eps: float, min_samples: int) -> torch.Tensor:
    """B2 on `route` for CUDA tensors, S, T > 0. x is read as float32
    or float64 (other dtypes are cast to float32 first), the mask as
    its bytes."""
    if x.device.type != "cuda":
        raise ValueError(f"dbscan_noise_cuda: no kernel for {x.device}")
    s, t = x.shape
    plan = _plan(s, t)
    if s * t >= 2 ** 31 or -(-t // _PASS_I) > _MAX_GRID_Y:
        raise ValueError(f"dbscan_noise_cuda: [{s}, {t}] is beyond the "
                         "kernel's int32 indexing")
    if route == "one_launch" and t > _ONE_MAX_T:
        raise ValueError(f"dbscan_noise_cuda: T={t} is longer than one "
                         f"block holds ({_ONE_MAX_T})")
    if x.dtype not in (torch.float32, torch.float64):
        x = x.to(torch.float32)
    x = x.contiguous()
    m8 = (mask if mask.dtype == torch.bool else mask != 0) \
        .contiguous().view(torch.uint8)
    noise = torch.empty((s, t), dtype=torch.bool, device=x.device)
    one, two = _library()
    is_double = int(x.dtype == torch.float64)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        if route == "one_launch":
            err = one(x.data_ptr(), is_double, m8.data_ptr(),
                      noise.data_ptr(), s, t, plan.threads_per_series,
                      plan.series_per_block, plan.points_per_thread,
                      float(eps), int(min_samples), stream)
        elif route == "two_pass":
            core = torch.empty((s, t), dtype=torch.uint8, device=x.device)
            err = two(x.data_ptr(), is_double, m8.data_ptr(),
                      core.data_ptr(), noise.data_ptr(), s, t, float(eps),
                      int(min_samples), stream)
        else:
            raise ValueError(f"dbscan_noise_cuda: no route {route!r}")
    if err != 0:
        raise RuntimeError(f"dbscan_noise kernel launch failed: CUDA "
                           f"error {err}")
    global launches
    with _launch_lock:
        launches += 1
    return noise


def dbscan_noise_cuda(x: torch.Tensor, mask: torch.Tensor,
                      eps: float = DEFAULT_EPS,
                      min_samples: int = DEFAULT_MIN_SAMPLES
                      ) -> torch.Tensor:
    """B2: noise flags [S, T] bool for a padded [S, T] batch, computed
    in float32.

    The counterpart of theia_tpu/ops/dbscan_pallas.py:57
    (`dbscan_noise_pallas`). CUDA tensors launch the kernel on the
    current stream, on the route `_plan` picks (or raise); float64 x is
    rounded to float32 in the kernel. CPU tensors run the plain
    version, `dbscan_noise`, on x cast to float32. The module's
    `launches` counts kernel calls."""
    _check(x, mask)
    if x.device.type == "cpu":
        return dbscan_noise(x.float(), mask.bool(), eps, min_samples)
    s, t = x.shape
    if s == 0 or t == 0:
        return torch.zeros((s, t), dtype=torch.bool, device=x.device)
    return _launch(_plan(s, t).route, x, mask, eps, min_samples)


def _noise_one_launch(x: torch.Tensor, mask: torch.Tensor,
                      eps: float = DEFAULT_EPS,
                      min_samples: int = DEFAULT_MIN_SAMPLES
                      ) -> torch.Tensor:
    """B2's one-launch route whatever `_plan` picks (CUDA tensors, S,
    T > 0, T ≤ 4,096): for holding each route against the plain
    version."""
    _check(x, mask)
    return _launch("one_launch", x, mask, eps, min_samples)


def _noise_two_pass(x: torch.Tensor, mask: torch.Tensor,
                    eps: float = DEFAULT_EPS,
                    min_samples: int = DEFAULT_MIN_SAMPLES
                    ) -> torch.Tensor:
    """B2's two-pass route whatever `_plan` picks (CUDA tensors, S,
    T > 0)."""
    _check(x, mask)
    return _launch("two_pass", x, mask, eps, min_samples)


def dbscan_scores(x: torch.Tensor, mask: torch.Tensor,
                  eps: float = DEFAULT_EPS,
                  min_samples: int = DEFAULT_MIN_SAMPLES):
    """(algoCalc placeholder zeros, stddev, anomaly) for DBSCAN.

    stddev is still emitted to fill the tadetector row shape (the
    reference computes it in the groupby regardless of algorithm).
    A CUDA tensor runs B2 (float32); a CPU tensor runs the plain
    version in x's dtype.
    """
    if x.device.type == "cuda":
        anomaly = dbscan_noise_cuda(x, mask, eps=eps,
                                    min_samples=min_samples)
    else:
        anomaly = dbscan_noise(x, mask, eps=eps, min_samples=min_samples)
    calc = torch.zeros_like(x)
    std = masked_stddev_samp(x, mask)
    return calc, std, anomaly


# -- spatial DBSCAN over [N, F] point embeddings ------------------------
#
# The BASELINE north-star config 3 generalization: "DBSCAN spatial
# anomaly on (srcIP, dstIP, dstPort, bytes) embeddings". Same
# closed-form noise test as the per-series kernel, over euclidean
# distance in feature space, computed in [block, N] tiles so the full
# [N, N] distance matrix never materializes: two passes (neighbour
# counts, then core-reachability), each tile one matmul-shaped
# distance evaluation.

def _within(tile: torch.Tensor, points: torch.Tensor, x2: torch.Tensor,
            eps2: float) -> torch.Tensor:
    """[block, F] tile against [N, F] points → [block, N] bool,
    d2 = (|t|² + |x|²) − 2·t·xᵀ ≤ eps², rounded as the reference
    rounds it: 2·t·xᵀ is exact, so the subtraction rounds once, into
    the sum's buffer."""
    t2 = (tile * tile).sum(-1)
    prod = tile @ points.T
    d2 = t2[:, None] + x2[None, :]
    d2.sub_(prod, alpha=2.0)
    del prod
    return d2 <= eps2


def dbscan_points_noise(points: torch.Tensor, valid: torch.Tensor,
                        eps: float, min_samples: int = DEFAULT_MIN_SAMPLES,
                        block: int = 1024) -> torch.Tensor:
    """Noise flags [N] bool for [N, F] float points (`valid` masks
    padding), on the points' device. Exact O(N^2) pairwise
    computation, O(N*block) memory.

    The distance product runs in full float32: the reference asks XLA
    for `Precision.HIGHEST`, and TF32 would keep ~10 mantissa bits of
    products of ~scale² and swamp eps². So this switches TF32 off for
    CUDA matmuls (process-wide, as ops/sketch.py does at import)
    before its first product, whoever turned it on."""
    torch.backends.cuda.matmul.allow_tf32 = False
    points = points.to(torch.float32)
    valid = valid.to(torch.bool)
    n = points.shape[0]
    pad = (-n) % block
    if pad:
        points = torch.cat([points, points.new_zeros((pad, points.shape[1]))])
        valid = torch.cat([valid, valid.new_zeros(pad)])
    eps2 = eps * eps
    x2 = (points * points).sum(-1)

    counts = torch.empty(points.shape[0], dtype=torch.int64,
                         device=points.device)
    for i in range(0, points.shape[0], block):
        w = _within(points[i:i + block], points, x2, eps2)
        w &= valid[None, :]
        counts[i:i + block] = w.sum(-1)
    core = (counts >= min_samples) & valid

    reachable = torch.empty_like(valid)
    for i in range(0, points.shape[0], block):
        w = _within(points[i:i + block], points, x2, eps2)
        w &= core[None, :]
        reachable[i:i + block] = w.any(-1)
    noise = valid & ~core & ~reachable
    return noise[:n]
