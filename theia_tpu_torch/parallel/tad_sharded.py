"""Sharded TAD scoring over the (series × time) mesh, and the sharded
spatial DBSCAN over a rows mesh.

Ports theia_tpu/parallel/tad_sharded.py. There each step is one
jitted `shard_map`; here each is written out as its phases over the
shards (per shard, collective, per shard), on one controller thread
(parallel/mesh.py). One EWMA step computes, sharded:

  * EWMA via a local scan per block (the reference's
    `associative_scan` recursion, ops/ewma.py) + composition of the
    earlier time shards' affine summaries in shard order (all_gather
    over the "time" axis — the classic parallel-scan block
    decomposition),
  * masked sample stddev via psum over the "time" axis,
  * the anomaly mask, and a global anomaly count via psum over every
    shard (the collective the reference's driver-side `count()`
    implies).

Inputs are the blocks `shard_arrays` places on the mesh's devices;
outputs come back assembled on the mesh's first device.
"""

from __future__ import annotations

import math
from typing import List, Tuple

import numpy as np
import torch

from ..ops.ewma import DEFAULT_ALPHA, _affine_scan
from .mesh import (ROWS_AXIS, SERIES_AXIS, TIME_AXIS, Mesh, all_gather,
                   make_rows_mesh, psum)

#: a sharded array: blocks[i][j] is series shard i, time shard j, on
#: mesh.devices[i, j]
Blocks = List[List[torch.Tensor]]


def _tensor(a) -> torch.Tensor:
    if isinstance(a, torch.Tensor):
        return a
    return torch.from_numpy(np.ascontiguousarray(a))


def _assemble(blocks: Blocks) -> torch.Tensor:
    """The full [S, T] array on the first shard's device."""
    dev = blocks[0][0].device
    return torch.cat([torch.cat([b.to(dev) for b in row], dim=1)
                      for row in blocks], dim=0)


def _assemble_rows(parts: List[torch.Tensor]) -> torch.Tensor:
    dev = parts[0].device
    return torch.cat([p.to(dev) for p in parts], dim=0)


def _ewma_timeshard(xz: List[torch.Tensor], alpha: float
                    ) -> List[torch.Tensor]:
    """EWMA along a time-sharded row of blocks: local scan + shard
    composition (theia_tpu/parallel/tad_sharded.py:40-66).

    Each time shard holds a contiguous [S_loc, T_loc] block. The affine
    summary (A_tot, B_tot) of every earlier shard is composed (in shard
    order) into an incoming state, then applied to the local cumulative
    scan: e = A_cum · e_in + B_cum.
    """
    scans = [_affine_scan(torch.full_like(x, 1.0 - alpha), alpha * x)
             for x in xz]
    if len(xz) == 1:
        return [scans[0][1]]  # e_in = 0

    a_all = all_gather([a_cum[:, -1][None] for a_cum, _ in scans])
    b_all = all_gather([b_cum[:, -1][None] for _, b_cum in scans])
    out = []
    for my, (a_cum, b_cum) in enumerate(scans):
        e_in = torch.zeros_like(a_cum[:, -1])
        for j in range(my):
            e_in = a_all[my][j] * e_in + b_all[my][j]
        out.append(a_cum * e_in[:, None] + b_cum)
    return out


def _sharded_step(xs: Blocks, ms: Blocks, alpha: float):
    e, std, anomaly = [], [], []
    for x_row, m_row in zip(xs, ms):
        xz = [torch.where(m, x, 0.0) for x, m in zip(x_row, m_row)]
        e_row = _ewma_timeshard(xz, alpha)

        # Masked stddev_samp with cross-time-shard reductions.
        cnt = psum([m.to(x.dtype).sum(-1) for x, m in zip(x_row, m_row)])
        total = psum([z.sum(-1) for z in xz])
        mean = [t / c.clamp_min(1.0) for t, c in zip(total, cnt)]
        ss = psum([torch.where(m, (x - mu[:, None]) ** 2, 0.0).sum(-1)
                   for x, m, mu in zip(x_row, m_row, mean)])
        var = [s / (c - 1.0).clamp_min(1.0) for s, c in zip(ss, cnt)]
        std.append([torch.where(c >= 2, torch.sqrt(v), math.nan)
                    for v, c in zip(var, cnt)])

        anomaly.append([((z - ee).abs() > sd[:, None]) & m
                        for z, ee, sd, m in zip(xz, e_row, std[-1],
                                                m_row)])
        e.append(e_row)
    count = psum([a.to(torch.int32).sum() for row in anomaly
                  for a in row])
    return e, std, anomaly, count[0]


def make_sharded_ewma(mesh: Mesh, alpha: float = DEFAULT_ALPHA):
    """Build the sharded scoring step for a mesh.

    Returns fn(xs, ms) → (ewma [S,T], stddev [S], anomaly, count) for
    the blocks of `shard_arrays` (S divisible by the series-axis size
    and T by the time-axis size), assembled on the mesh's first
    device.
    """
    def fn(xs: Blocks, ms: Blocks):
        e, std, anomaly, count = _sharded_step(xs, ms, alpha)
        return (_assemble(e), _assemble_rows([row[0] for row in std]),
                _assemble(anomaly), count)
    return fn


def shard_arrays(mesh: Mesh, x, mask) -> Tuple[Blocks, Blocks]:
    """Host arrays (or tensors) cut into the step's input blocks, each
    on its device."""
    n_series, n_time = mesh.shape[SERIES_AXIS], mesh.shape[TIME_AXIS]

    def cut(a):
        a = _tensor(a)
        s, t = a.shape
        if s % n_series or t % n_time:
            raise ValueError(f"[{s}, {t}] does not divide over the "
                             f"{n_series} x {n_time} mesh")
        sl, tl = s // n_series, t // n_time
        return [[a[i * sl:(i + 1) * sl, j * tl:(j + 1) * tl]
                 .to(mesh.devices[i, j]).contiguous()
                 for j in range(n_time)] for i in range(n_series)]

    return cut(x), cut(mask)


def make_series_sharded(mesh: Mesh, kernel):
    """Data parallelism over the series axis for any scoring kernel
    with the (x [S,T], mask [S,T]) → (calc, std [S], anomaly) shape.

    Per-series work is independent (SURVEY §2.7 row 2: Spark's
    per-series task parallelism → series sharding), so the sharded
    step is the single-device kernel applied to each series slab — no
    collectives, and per-series outputs are BIT-IDENTICAL to the
    single-device kernel (same computation per series). The time axis
    of the mesh (if >1) replicates in the reference; here each series
    slab is joined onto its row's first device and scored once.
    """
    def fn(xs: Blocks, ms: Blocks):
        outs = []
        for x_row, m_row in zip(xs, ms):
            dev = x_row[0].device
            x = torch.cat([b.to(dev) for b in x_row], dim=1)
            m = torch.cat([b.to(dev) for b in m_row], dim=1)
            outs.append(kernel(x, m))
        calc, std, anom = zip(*outs)
        return (_assemble_rows(list(calc)), _assemble_rows(list(std)),
                _assemble_rows(list(anom)))
    return fn


def make_sharded_arima(mesh: Mesh, refit_every: int = 1):
    """Sharded ARIMA scoring (series data parallelism; every
    (series, prefix) fit is independent — the walk-forward scan stays
    local to each shard)."""
    from ..ops.arima import arima_scores

    def step(x, mask):
        return arima_scores(x, mask, refit_every=refit_every)

    return make_series_sharded(mesh, step)


def make_sharded_dbscan(mesh: Mesh, eps: float, min_samples: int):
    """Sharded per-series DBSCAN noise scoring over the series axis.

    Each series' [T, T] distance test is independent, so series shards
    run the single-device formulation locally (`ops.dbscan.
    dbscan_scores`: B2 on a CUDA shard, one launch a shard; the plain
    version on a CPU shard).
    """
    from ..ops.dbscan import dbscan_scores

    def step(x, mask):
        return dbscan_scores(x, mask, eps=eps, min_samples=min_samples)

    return make_series_sharded(mesh, step)


def make_sharded_points_dbscan(mesh: Mesh, eps: float,
                               min_samples: int = 4, block: int = 1024):
    """Sharded spatial DBSCAN over [N, F] point embeddings.

    The two passes of `ops.dbscan.dbscan_points_noise` shard over row
    blocks (mesh axis `rows`; any other mesh is flattened onto one):
    each shard evaluates its row block against the full point set (one
    all_gather of the points), derives complete neighbour counts →
    local core flags, then a second all_gather shares the core flags
    for the reachability pass — the collective structure SURVEY §2.7
    maps DBSCAN's region query onto.

    The reference's body builds an untiled [N/k, N] distance block
    (theia_tpu/parallel/tad_sharded.py:183-186), 512 GiB at N = 2^20
    and k = 8; each shard here runs the one-device path's tiled passes
    (`points_neighbour_counts`, `points_reachable`) over its row
    block, with the same per-pair arithmetic (on a card, one launch of
    the same kernel a pass; the reach pass evaluates only the shard's
    non-core rows, `row_core`), so the flags agree with
    `dbscan_points_noise` by construction.

    Returns fn(points [N, F], valid [N] bool) → noise [N] bool on the
    mesh's first device, N divisible by the shard count.
    """
    from ..ops.dbscan import points_neighbour_counts, points_reachable

    if ROWS_AXIS not in mesh.axis_names:
        mesh = make_rows_mesh(devices=mesh.devices.flatten())
    devs = list(mesh.devices.flat)

    def fn(points, valid):
        points = _tensor(points).to(torch.float32).contiguous()
        valid = _tensor(valid).to(torch.bool)
        if points.shape[0] % len(devs):
            raise ValueError(f"{points.shape[0]} points do not divide "
                             f"over {len(devs)} shards")
        n_loc = points.shape[0] // len(devs)
        pts_loc = [points[s * n_loc:(s + 1) * n_loc].to(d)
                   for s, d in enumerate(devs)]
        valid_loc = [valid[s * n_loc:(s + 1) * n_loc].to(d)
                     for s, d in enumerate(devs)]
        pts_all = all_gather(pts_loc)
        valid_all = all_gather(valid_loc)
        core_loc = [
            (points_neighbour_counts(p, pa, va, eps, block)
             >= min_samples) & v
            for p, pa, va, v in zip(pts_loc, pts_all, valid_all,
                                    valid_loc)]
        core_all = all_gather(core_loc)
        noise = [v & ~c & ~points_reachable(p, pa, ca, eps, block,
                                            row_core=c)
                 for p, pa, ca, v, c in zip(pts_loc, pts_all, core_all,
                                            valid_loc, core_loc)]
        return _assemble_rows(noise)

    return fn
