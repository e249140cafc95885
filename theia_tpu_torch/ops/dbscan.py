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
embeddings (theia_tpu/ops/dbscan.py:126, which leaves it to XLA): the
same closed-form noise test over euclidean distance, in two passes. A
CUDA tensor takes the hand-written kernel csrc/points_pairs.cu, one
launch a pass; a CPU tensor takes the plain version, [block, N] tiles
of torch ops with a full-float32 matmul. Both kernels are bound and
launched through `_build`, which counts their launches by library
name (`_build.launches()`). Each pass is one span (`dbscan.count_pass`,
`dbscan.reach_pass`, obs/trace.py, attrs `rows`, `points`, `block`,
`route`) around its launches, whether the one-device job or a shard
(parallel/) calls it.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from ..obs import trace as _trace
from . import _build
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


_PTR, _I32, _F32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
#: each B2 route's entry point and its arguments before the stream
_ENTRIES = {
    "one_launch": ("dbscan_noise_one_launch",
                   [_PTR, _I32, _PTR, _PTR, _I32, _I32, _I32, _I32, _I32,
                    _F32, _I32]),
    "two_pass": ("dbscan_noise_two_pass",
                 [_PTR, _I32, _PTR, _PTR, _PTR, _I32, _I32, _F32, _I32]),
}
_CONSTANTS = {("dbscan_check",): _CHECK, ("dbscan_pass_i_tile",): _PASS_I}


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
    if route not in _ENTRIES:
        raise ValueError(f"dbscan_noise_cuda: no route {route!r}")
    if route == "one_launch" and t > _ONE_MAX_T:
        raise ValueError(f"dbscan_noise_cuda: T={t} is longer than one "
                         f"block holds ({_ONE_MAX_T})")
    if x.dtype not in (torch.float32, torch.float64):
        x = x.to(torch.float32)
    x = x.contiguous()
    m8 = (mask if mask.dtype == torch.bool else mask != 0) \
        .contiguous().view(torch.uint8)
    noise = torch.empty((s, t), dtype=torch.bool, device=x.device)
    fn = _build.bind("dbscan_noise", *_ENTRIES[route], _CONSTANTS)
    is_double = int(x.dtype == torch.float64)
    if route == "one_launch":
        args = (x.data_ptr(), is_double, m8.data_ptr(), noise.data_ptr(),
                s, t, plan.threads_per_series, plan.series_per_block,
                plan.points_per_thread, float(eps), int(min_samples))
    else:
        core = torch.empty((s, t), dtype=torch.uint8, device=x.device)
        args = (x.data_ptr(), is_double, m8.data_ptr(), core.data_ptr(),
                noise.data_ptr(), s, t, float(eps), int(min_samples))
    _build.launch("dbscan_noise", fn, x.device, *args)
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
    version, `dbscan_noise`, on x cast to float32."""
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
# distance in feature space, in two passes (neighbour counts, then
# core-reachability). CUDA tensors take the hand-written kernel
# csrc/points_pairs.cu, one launch a pass, which keeps each pair's d²
# in registers; CPU tensors take the plain version, [block, N] tiles of
# torch ops, each tile one matmul-shaped distance evaluation, so the
# full [N, N] distance matrix never materializes.

#: the kernel's constants (checked against the library when it loads):
#: floats a packed point, the widest points, columns a shared-memory
#: tile (the packed columns' padding), rows a block in count and reach
#: mode (the packed rows' padding)
_PTS_WIDTH = 8
_PTS_MAX_F = 7
_PTS_TILE = 256
_PTS_BLOCK_ROWS = {False: 2048, True: 512}
_PTS_ARGTYPES = [_PTR, _I32, _I32, _PTR, _I32, _I32, _PTR]
_PTS_CONSTANTS = {("points_width",): _PTS_WIDTH,
                  ("points_max_f",): _PTS_MAX_F,
                  ("points_tile",): _PTS_TILE,
                  ("points_block_rows", 0): _PTS_BLOCK_ROWS[False],
                  ("points_block_rows", 1): _PTS_BLOCK_ROWS[True]}
_F32_MAX = torch.finfo(torch.float32).max


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


def _pad_rows(a: torch.Tensor, multiple: int) -> torch.Tensor:
    """`a` with zero rows appended up to a multiple of `multiple`."""
    pad = (-a.shape[0]) % multiple
    if pad:
        a = torch.cat([a, a.new_zeros((pad, *a.shape[1:]))])
    return a


def _check_points(rows: torch.Tensor, points: torch.Tensor,
                  flags: torch.Tensor) -> None:
    """Raise ValueError for a pass the kernel does not take: rows [M, F]
    and points [N, F] contiguous float32 with 1 ≤ F ≤ 7, flags bool [N],
    all on one device, the padded sizes within int32."""
    for name, a in (("rows", rows), ("points", points)):
        if a.dtype != torch.float32:
            raise ValueError(f"points_pairs: {name} must be float32, got "
                             f"{a.dtype}")
        if a.dim() != 2:
            raise ValueError(f"points_pairs: {name} must be [*, F], got "
                             f"{tuple(a.shape)}")
        if not a.is_contiguous():
            raise ValueError(f"points_pairs: {name} must be contiguous")
        if a.shape[0] + _PTS_BLOCK_ROWS[False] >= 2 ** 31:
            raise ValueError(f"points_pairs: {a.shape[0]} {name} are "
                             "beyond the kernel's int32 sizes")
    f = points.shape[1]
    if rows.shape[1] != f or not 1 <= f <= _PTS_MAX_F:
        raise ValueError(f"points_pairs: rows {tuple(rows.shape)} and "
                         f"points {tuple(points.shape)}: the kernel takes "
                         f"one width F, 1 ≤ F ≤ {_PTS_MAX_F}")
    if flags.dtype != torch.bool or tuple(flags.shape) != (points.shape[0],):
        raise ValueError(f"points_pairs: flags must be bool "
                         f"[{points.shape[0]}], got {flags.dtype} "
                         f"{tuple(flags.shape)}")
    if not rows.device == points.device == flags.device:
        raise ValueError("points_pairs: rows, points and flags must lie on "
                         f"one device, got {rows.device}, {points.device} "
                         f"and {flags.device}")


def _route(rows: torch.Tensor, points: torch.Tensor,
           flags: torch.Tensor) -> str:
    """"kernel" for CUDA tensors the kernel takes (else raise), "torch"
    (the plain version) for CPU tensors."""
    if rows.device.type == "cuda":
        _check_points(rows, points, flags)
        return "kernel"
    if rows.device.type == "cpu":
        return "torch"
    raise ValueError(f"points_pairs: no route for {rows.device}")


def _sq_norms(a: torch.Tensor) -> torch.Tensor:
    """|a_i|² in float64, summed over the columns in order: the same
    value for a point whichever rows a tensor holds."""
    p = a.double()
    sq = p[:, 0] * p[:, 0]
    for k in range(1, a.shape[1]):
        sq = torch.addcmul(sq, p[:, k], p[:, k])
    return sq


def _packed(a: torch.Tensor, last: torch.Tensor, multiple: int,
            negate: bool) -> torch.Tensor:
    """The kernel's [K', 8] float32 layout of [K, F] points: the
    coordinates (negated for columns), zeros up to 7 (the kernel always
    takes 7 terms; a zero term adds an exact 0), `last` (float64,
    rounded once); NaN rows up to a multiple of `multiple`."""
    k, f = a.shape
    out = torch.full((-(-k // multiple) * multiple, _PTS_WIDTH),
                     float("nan"), dtype=torch.float32, device=a.device)
    body = out[:k]
    body[:, :f] = a
    if negate:
        body[:, :f].neg_()
    body[:, f:_PTS_WIDTH - 1] = 0.0
    body[:, _PTS_WIDTH - 1] = last
    return out


def _pack_pass(rows: torch.Tensor, points: torch.Tensor,
               flags: torch.Tensor, eps: float, row_multiple: int,
               col_multiple: int):
    """(packed rows, packed columns) of one pass. A row packs
    lim = (eps² − |t|²)/2, a column h = |x|²/2 (NaN where the flag is
    off or the norm is not finite), so the kernel's test is
    h − t·x ≤ lim (see the source's note on rounding)."""
    nan = torch.tensor(float("nan"), dtype=torch.float64,
                       device=rows.device)
    sq_rows = _sq_norms(rows)
    sq_pts = sq_rows if points is rows else _sq_norms(points)
    lim = torch.where(sq_rows <= _F32_MAX, (eps * eps - sq_rows) * 0.5, nan)
    half = torch.where((sq_pts <= _F32_MAX) & flags, sq_pts * 0.5, nan)
    return (_packed(rows, lim, row_multiple, negate=False),
            _packed(points, half, col_multiple, negate=True))


def _pairs_kernel(rows: torch.Tensor, points: torch.Tensor,
                  flags: torch.Tensor, eps: float, block: int,
                  reach: bool) -> torch.Tensor:
    """One launch of csrc/points_pairs.cu: int64 neighbour counts of
    `rows` among the `flags` points (count mode), or whether each row
    has a `flags` point within eps (reach mode, bool). `block` is the
    plain version's and goes unused: the kernel's blocks are its
    own."""
    m = rows.shape[0]
    if m == 0 or points.shape[0] == 0:
        return torch.zeros(m, dtype=torch.bool if reach else torch.int64,
                           device=rows.device)
    fn = _build.bind("points_pairs", "points_pairs", _PTS_ARGTYPES,
                     _PTS_CONSTANTS)
    row_pack, col_pack = _pack_pass(rows, points, flags, eps,
                                    _PTS_BLOCK_ROWS[reach], _PTS_TILE)
    out = torch.empty(m, dtype=torch.uint8 if reach else torch.int64,
                      device=rows.device)
    _build.launch("points_pairs", fn, rows.device, row_pack.data_ptr(),
                  row_pack.shape[0], m, col_pack.data_ptr(),
                  col_pack.shape[0], int(reach), out.data_ptr())
    return out.view(torch.bool) if reach else out


def _pairs_tiles(rows: torch.Tensor, points: torch.Tensor,
                 flags: torch.Tensor, eps: float, block: int,
                 reach: bool) -> torch.Tensor:
    """The plain version of either pass, on any device: int64 counts of
    the `flags` points within eps of each row, or (`reach`) bool
    whether there is one, over [block, N] tiles (the rows padded to a
    multiple of block)."""
    m = rows.shape[0]
    rows = _pad_rows(rows, block)
    x2 = (points * points).sum(-1)
    eps2 = eps * eps
    out = torch.empty(rows.shape[0],
                      dtype=torch.bool if reach else torch.int64,
                      device=rows.device)
    for i in range(0, rows.shape[0], block):
        w = _within(rows[i:i + block], points, x2, eps2)
        w &= flags[None, :]
        out[i:i + block] = w.any(-1) if reach else w.sum(-1)
    return out[:m]


#: a pass's function by `_route`: both take (rows, points, flags, eps,
#: block, reach)
_PASSES = {"kernel": _pairs_kernel, "torch": _pairs_tiles}


def points_neighbour_counts(rows: torch.Tensor, points: torch.Tensor,
                            valid: torch.Tensor, eps: float,
                            block: int = 1024) -> torch.Tensor:
    """The count pass: for each of `rows` ([M, F] float32), how many
    valid points of `points` ([N, F] float32, `valid` [N] bool) lie
    within eps — itself included when it is one of them. int64 [M].

    CUDA tensors: one launch of the kernel (`_check_points` says what
    it takes; anything else raises). CPU tensors: the plain version,
    rows in [block, N] tiles (M padded to a multiple of block), so
    every distance product has the same shape whichever rows a caller
    passes. Either way the one-device pass (rows = points) and a
    shard's pass over its row block (parallel.tad_sharded) compute each
    pair the same way. TF32 is switched off first (see
    dbscan_points_noise). The span `dbscan.count_pass` carries the
    `route`, "kernel" or "torch"."""
    torch.backends.cuda.matmul.allow_tf32 = False
    route = _route(rows, points, valid)
    with _trace.span("dbscan.count_pass", rows=rows.shape[0],
                     points=points.shape[0], block=block, route=route):
        return _PASSES[route](rows, points, valid, eps, block, reach=False)


def points_reachable(rows: torch.Tensor, points: torch.Tensor,
                     core: torch.Tensor, eps: float, block: int = 1024,
                     *, row_core: torch.Tensor) -> torch.Tensor:
    """The reach pass: for each of `rows`, whether a core point of
    `points` (`core` [N] bool) lies within eps. bool [M]; routed and
    tiled as `points_neighbour_counts`.

    `row_core` ([M] bool) gives the rows' own core flags: a core row is
    True without being evaluated (it is within eps of itself, and noise
    is false for it whatever this pass says), and only the others are
    compacted and evaluated. The span's `rows` is the number
    evaluated."""
    torch.backends.cuda.matmul.allow_tf32 = False
    route = _route(rows, points, core)
    with _trace.span("dbscan.reach_pass", rows=rows.shape[0],
                     points=points.shape[0], block=block,
                     route=route) as sp:
        open_rows = torch.nonzero(~row_core)[:, 0]
        sp.attrs["rows"] = len(open_rows)
        reachable = row_core.clone()
        reachable[open_rows] = _PASSES[route](rows[open_rows], points, core,
                                              eps, block, reach=True)
    return reachable


def dbscan_points_noise(points: torch.Tensor, valid: torch.Tensor,
                        eps: float, min_samples: int = DEFAULT_MIN_SAMPLES,
                        block: int = 1024) -> torch.Tensor:
    """Noise flags [N] bool for [N, F] float points (`valid` masks
    padding), on the points' device. Exact O(N^2) pairwise
    computation: the count pass, core flags, the reach pass over the
    non-core points. On CUDA tensors each pass is one kernel launch
    with O(N) memory; on CPU tensors, [block, N] tiles (the points
    padded to a multiple of block), O(N*block) memory.

    Full float32 throughout: the reference asks XLA for
    `Precision.HIGHEST`, and TF32 would keep ~10 mantissa bits of
    products of ~scale² and swamp eps². The kernel uses no tensor
    cores; each pass still switches TF32 off for CUDA matmuls
    (process-wide, as ops/sketch.py does at import), whoever turned it
    on."""
    points = points.to(torch.float32).contiguous()
    valid = valid.to(torch.bool)
    n = points.shape[0]
    if points.device.type == "cpu":
        points = _pad_rows(points, block)
        valid = _pad_rows(valid, block)
    counts = points_neighbour_counts(points, points, valid, eps, block)
    core = (counts >= min_samples) & valid
    reachable = points_reachable(points, points, core, eps, block,
                                 row_core=core)
    noise = valid & ~core & ~reachable
    return noise[:n]
