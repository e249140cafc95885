#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (theia_tpu_torch).

    python3 chip_smoke.py

Needs one CUDA card and the CUDA toolkit (nvcc). Drives the port's
paths and holds every kernel of them against its plain PyTorch version
on the card:

  * the live ingest-and-score path — TBLK blocks → wire.decode_block →
    IngestManager.score_batch (fused engine, 8 shards, the reference's
    default detector sizes) → push_alert; its kernel is B1
    (csrc/stream_scan.cu);
  * the TAD batch job — generate_flows → build_series →
    detect_anomalies for EWMA, DBSCAN and ARIMA at 8,192 series × 128
    points; its kernel is B2 (csrc/dbscan_noise.cu, DBSCAN);
  * the manager: both paths again as users reach them, POST /ingest
    (B1) and TAD jobs through the intelligence API (B2), served by
    `python -m theia_tpu_torch.manager`;
  * the jobs slice through the same manager's API: NPR (the device
    DISTINCT over 1,048,576 rows), pattern mining, spatial DBSCAN over
    all 1,048,576 flows, and drop detection over a month of dropped
    flows. No Pallas kernel stands behind them: their device work is
    torch ops (sorts, scatter-adds, a blocked float32 matmul, masked
    means).

Each phase prints one JSON line; any failure raises and the script
exits non-zero. The last line of standard output is

    {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}

Phases: device; build (both libraries in parallel); B1 against its
plain version; the ingest path (one grouped B1 launch per fused step);
ingest card vs CPU parity; B1's grouped launch against its plain
version and against one-tile launches; B2 against its plain version,
through the wrapper and each of its two routes; B2 on special values;
the TAD path; TAD card vs CPU parity; then the manager slice: the
port's manager started through its entry point's main() (POST /ingest
from four producer streams through admission, dedup, the WAL, the
parts store and the fused engine), its one-stream parity against the
CPU, the TAD jobs through the intelligence API, then on the same
manager the NPR, FPM, SAD and DD jobs (manager_jobs) each held against
the port on the CPU (jobs_parity), a SIGKILL and restart of `python
-m theia_tpu_torch.manager` on its WAL, and the working-set state tier
against an unbounded run; then the kernels line, the card's name and
power limit, and the result line.
Imports nothing of JAX and nothing of the JAX package. Writes under
the package's _build/ directories and, for the managers' WALs and
parts, in temporary directories it removes.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import signal
import statistics
import subprocess
import sys
import threading
import time

#: H100 SXM peak memory rate (NVIDIA data sheet), bytes/s
HBM_BYTES_PER_S = 3.35e12
#: 32-bit float rate outside the tensor cores, operations/s
F32_OPS_PER_S = 67e12

CAPACITY = 65536
SHAPES_T = (1, 2, 4, 8)
SHAPES_U = (64, 4096, 65536)
BLOCK_ROWS = 16384
PRODUCERS = 4
N_SHARDS = 8
TIMED_LAUNCHES = 25
#: Card vs CPU, relative tolerance on the CMS counters and totals and
#: on the heavy_hitter and ddos_shape alert floats. CMS counters are
#: float32 sums of up to a step's rows in another order (CUDA atomics
#: in index_add_, another reduction tree in sum): the difference grows
#: like sqrt(n)·2^-24, about 2e-5 at 131,072 terms. ddos_shape floats
#: are k-means distances, moved by the centroid differences below.
RTOL = 1e-4
#: k-means, card vs CPU. cuBLAS and the CPU sum the distance product
#: and `one_hot.T @ points` in other orders, and d2 = |x|²+|c|²−2x·c
#: cancels most of float32's bits, so a point within a few ulp of
#: |x|² of a tie between two centroids can take either (the JAX
#: reference and the port disagree the same way on the CPU). Each such
#: point moves its two centroids by |x−c|/n. Held: every shard assigns
#: the same number of points, at most KMEANS_MOVED of them sit on
#: another centroid, and centroids agree within KMEANS_RTOL.
KMEANS_MOVED = 1e-3
KMEANS_RTOL = 1e-3

#: B2's shapes [S, T]: the reference test's (tests/test_kernels.py),
#: the TAD path's, a day at one point a minute, and a long series
B2_SHAPES = ((5, 7), (16, 128), (33, 40), (1, 1), (8192, 128),
             (256, 1440), (4, 4096))
DBSCAN_EPS = 2.5e8
DBSCAN_MIN_SAMPLES = 4
#: a core point with three neighbours below it, a border point 0.9 eps
#: above it (two neighbours: itself and the core) and an isolated noise
#: point far above the rest of the data
DBSCAN_KINDS = tuple(8.6e9 + DBSCAN_EPS * k
                     for k in (0.0, -0.5, -0.6, -0.7, 0.9, 100.0))
#: B2 per pair test: subtract, absolute value, compare, two ands or an
#: add — about five 32-bit operations
B2_OPS_PER_PAIR = 5
TAD_SERIES = 8192
TAD_POINTS = 128
TAD_ALGOS = ("EWMA", "DBSCAN", "ARIMA")
TAD_PARITY_SERIES = 512
#: TAD rows card vs CPU: identity, anomaly, flowEndSeconds and
#: throughput exact; the floats within the CPU tests' limits against
#: the reference (tests/test_torch_masked_ewma.py, test_torch_tad.py):
#: stddev is a sum over T in another order (float64 for EWMA and
#: ARIMA, float32 for the DBSCAN batch), ARIMA's algoCalc goes through
#: log, exp and pow of another libm; EWMA's algoCalc is the same scan
#: op for op and DBSCAN's is zero.
TAD_STD_RTOL = {"float64": 2e-15, "float32": 1e-6}
TAD_CALC_RTOL = {"EWMA": 0.0, "DBSCAN": 0.0, "ARIMA": 1e-9}


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def card_name_and_limit() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def graph_ms(fn, n: int = TIMED_LAUNCHES, replays: int = 5) -> float:
    """Device time of one call of `fn`: n calls captured in a CUDA
    graph, replayed back to back and timed with CUDA events (median
    over replays, divided by n). No host time between the launches."""
    import torch
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(n):
            fn()
    graph.replay()
    times = []
    for _ in range(replays):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / n)
    return statistics.median(times)


def cuda_median_ms(fn, n: int = TIMED_LAUNCHES, warmup: int = 3) -> float:
    """Median time of one call of `fn`, CUDA events around each call:
    the device timeline from the call's start to its end, host gaps
    between its launches included."""
    import torch
    for _ in range(warmup):
        fn()
    pairs = []
    for _ in range(n):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        pairs.append((a, b))
    torch.cuda.synchronize()
    return statistics.median(a.elapsed_time(b) for a, b in pairs)


# -- phase 3: B1 against its plain version ------------------------------

def scan_inputs(rng, t: int, u: int, live: int, device):
    """Non-zero state of CAPACITY rows and one [t, u] tile: `live`
    distinct slots, the rest padding (= CAPACITY, inactive); ~80% of
    live cells active, tick 0 of every live column active."""
    import numpy as np
    import torch
    from theia_tpu_torch.analytics.streaming import StreamState
    state = StreamState(
        torch.tensor(rng.normal(5, 2, CAPACITY).astype(np.float32)),
        torch.tensor(rng.integers(0, 12, CAPACITY).astype(np.int32)),
        torch.tensor(rng.normal(5, 2, CAPACITY).astype(np.float32)),
        torch.tensor(rng.uniform(0, 40, CAPACITY).astype(np.float32)))
    slots = np.full(u, CAPACITY, np.int32)
    slots[:live] = np.sort(rng.choice(CAPACITY, live, replace=False))
    x = rng.normal(5, 2, (t, u)).astype(np.float32)
    spikes = rng.random((t, u)) < 0.05
    x[spikes] *= 20
    active = rng.random((t, u)) < 0.8
    active[0] = True
    active[:, live:] = False
    return (StreamState(*(a.to(device) for a in state)),
            torch.tensor(slots, device=device),
            torch.tensor(x, device=device),
            torch.tensor(active, device=device))


def tile_bytes(t: int, u: int, live: int) -> int:
    """Bytes B1 must move: slots, x, active and state rows in, state
    rows and anom out, each once."""
    return 4 * u + (4 + 1) * t * u + 16 * live + 16 * live + t * u


def tile_ops(t: int, u: int) -> int:
    """Float operations B1 does: ~14 per tick cell (Welford, EWMA,
    band, compare)."""
    return 14 * t * u


def bound_ms(t: int, u: int, live: int) -> tuple:
    by_bytes = tile_bytes(t, u, live) / HBM_BYTES_PER_S * 1e3
    by_ops = tile_ops(t, u) / F32_OPS_PER_S * 1e3
    return ((by_bytes, "bytes") if by_bytes >= by_ops
            else (by_ops, "operations"))


def compare_scan(rng, t: int, u: int, live: int, device) -> dict:
    """One shape: kernel and plain on clones of the same inputs; state,
    untouched rows and anom must be bit-exact. Returns the shape's
    numbers (times on the card)."""
    import torch
    from theia_tpu_torch.analytics.streaming import StreamState
    from theia_tpu_torch.ops import fused_detector as fd
    state, slots, x, active = scan_inputs(rng, t, u, live, device)
    before = StreamState(*(a.clone() for a in state))
    s_k = StreamState(*(a.clone() for a in state))
    s_p = StreamState(*(a.clone() for a in state))
    launches, tiles = fd.launches, fd.tiles
    anom_k = fd.stream_scan(s_k, slots, x, active)
    anom_p = fd._stream_half_plain(s_p, slots, x, active, 0.5)
    fd.launches, fd.tiles = launches, tiles   # comparison launches don't count
    if device.type == "cuda":
        torch.cuda.synchronize()
    max_err = 0.0
    for name, a, b in zip(StreamState._fields, s_k, s_p):
        if not torch.equal(a, b):
            diff = (a.double() - b.double()).abs().max().item()
            raise AssertionError(
                f"B1 state {name} differs from plain at T={t} U={u}: "
                f"max |diff| {diff}")
    if not torch.equal(anom_k, anom_p):
        raise AssertionError(f"B1 anom differs from plain at T={t} U={u}")
    untouched = torch.ones(CAPACITY, dtype=torch.bool, device=device)
    untouched[slots[:live].long()] = False
    for name, a, b in zip(StreamState._fields, s_k, before):
        if not torch.equal(a[untouched], b[untouched]):
            raise AssertionError(
                f"B1 wrote state {name} rows outside slots at T={t} U={u}")
    row = {"T": t, "U": u, "live": live, "bit_exact": True,
           "anomalies": int(anom_k.sum().item()), "max_abs_err": max_err}
    if device.type == "cuda":
        s_t = StreamState(*(a.clone() for a in state))
        row["ms"] = graph_ms(
            lambda: fd.stream_scan(s_t, slots, x, active))
        row["call_ms"] = cuda_median_ms(
            lambda: fd.stream_scan(s_t, slots, x, active))
        # the plain version's masked indexing synchronises with the
        # host, so it cannot be captured: per-call event time
        row["plain_ms"] = cuda_median_ms(
            lambda: fd._stream_half_plain(s_t, slots, x, active, 0.5))
        fd.launches, fd.tiles = launches, tiles
    row["bound_ms"], row["bound_by"] = bound_ms(t, u, live)
    return row


def phase_kernel_vs_plain(device) -> list:
    import numpy as np
    rng = np.random.default_rng(2024)
    rows = []
    for u in SHAPES_U:
        for t in SHAPES_T:
            live = u - max(1, u // 16) if u < CAPACITY else u
            rows.append(compare_scan(rng, t, u, live, device))
    return rows


def host_us(fn, n: int = 200) -> float:
    """Host time of one call of `fn` from Python (the scorer thread's
    cost): perf_counter over n calls, the device left to catch up after
    the window."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    host = (time.perf_counter() - t0) / n * 1e6
    torch.cuda.synchronize()
    return host


def phase_b1_grouped(modal: dict, device) -> dict:
    """B1's grouped launch: eight tiles of the main path's modal shape
    and the twelve kernel_vs_plain shapes as one group (two launches of
    at most fd.MAX_TILES tiles), bit-exact against the plain version
    tile by tile; then one grouped launch of the eight modal tiles
    against eight one-tile launches, in turns (grouped, one-tile,
    one-tile, grouped), device time from CUDA graphs and host time per
    call from Python."""
    import numpy as np
    import torch
    from theia_tpu_torch.analytics.streaming import StreamState
    from theia_tpu_torch.ops import fused_detector as fd
    rng = np.random.default_rng(31)
    shapes = [(modal["T"], modal["U"], modal["live"])] * N_SHARDS + [
        (t, u, u - max(1, u // 16) if u < CAPACITY else u)
        for u in SHAPES_U for t in SHAPES_T]
    group = [scan_inputs(rng, *shape, device) for shape in shapes]

    def copies(g):
        return [(StreamState(*(a.clone() for a in st)), *rest)
                for st, *rest in g]

    k_group, p_group = copies(group), copies(group)
    launches, tiles = fd.launches, fd.tiles
    anom_k = fd.stream_scan_grouped(k_group)
    group_launches = fd.launches - launches
    anom_p = [fd._stream_half_plain(*tile, 0.5) for tile in p_group]
    torch.cuda.synchronize()
    for n, (shape, kt, pt, ak, ap) in enumerate(
            zip(shapes, k_group, p_group, anom_k, anom_p)):
        if not torch.equal(ak, ap) or not all(
                torch.equal(a, b) for a, b in zip(kt[0], pt[0])):
            raise AssertionError(f"B1 grouped differs from plain at tile "
                                 f"{n} (T, U, live) = {shape}")
    want = -(-len(shapes) // fd.MAX_TILES)
    if device.type == "cuda" and group_launches != want:
        raise AssertionError(f"B1 grouped: {group_launches} launches for "
                             f"{len(shapes)} tiles, expected {want}")

    eight = copies(group[:N_SHARDS])
    grouped = lambda: fd.stream_scan_grouped(eight)          # noqa: E731
    singles = lambda: [fd.stream_scan(*tile) for tile in eight]  # noqa: E731
    turns = {"grouped": [], "one_tile": []}
    for name in ("grouped", "one_tile", "one_tile", "grouped"):
        turns[name].append(graph_ms(grouped if name == "grouped"
                                    else singles))
    host = {"grouped": host_us(grouped), "one_tile": host_us(singles)}
    plain_ms = cuda_median_ms(
        lambda: [fd._stream_half_plain(*tile, 0.5) for tile in eight])
    fd.launches, fd.tiles = launches, tiles
    one_bound, by = bound_ms(*shapes[0])
    return {"tiles": len(shapes), "launches": group_launches,
            "bit_exact": True, "max_abs_err": 0.0,
            "modal": {"T": modal["T"], "U": modal["U"],
                      "live": modal["live"], "tiles": N_SHARDS},
            "grouped_ms": turns["grouped"],
            "one_tile_x8_ms": turns["one_tile"],
            "ms": statistics.median(turns["grouped"]),
            "one_tile_x8_median_ms": statistics.median(turns["one_tile"]),
            "host_us": host, "plain_ms": plain_ms,
            "bound_ms": N_SHARDS * one_bound, "bound_by": by}


# -- traffic ------------------------------------------------------------

def cluster_config(n_series: int, points: int, seed: int):
    from theia_tpu_torch.data.synth import SynthConfig
    return SynthConfig(n_series=n_series, points_per_series=points,
                       n_namespaces=64, pods_per_namespace=64,
                       n_nodes=16, anomaly_fraction=0.1, seed=seed)


def tblk_blocks(cfg, block_rows: int = BLOCK_ROWS) -> list:
    from theia_tpu_torch.data.synth import generate_flows
    return encode_blocks(generate_flows(cfg), block_rows)


def encode_blocks(batch, block_rows: int = BLOCK_ROWS) -> list:
    """Flows ordered by flowEndSeconds, as an exporter sends them, cut
    into TBLK blocks."""
    import numpy as np
    from theia_tpu_torch.store import wire
    order = np.argsort(batch["flowEndSeconds"], kind="stable")
    batch = batch.take(order)
    return [wire.encode_block(batch.take(np.arange(
        i, min(i + block_rows, len(batch)))))
        for i in range(0, len(batch), block_rows)]


# -- phase 4: the main path ---------------------------------------------

def percentiles(values) -> dict:
    values = sorted(values)
    if not values:
        return {"n": 0, "p50": None, "max": None}
    return {"n": len(values), "p50": values[len(values) // 2],
            "max": values[-1]}


def drive(im, blocks, producers: int = PRODUCERS) -> dict:
    """Producers decode → score → publish every block; returns counts
    and the wall time of the window."""
    from theia_tpu_torch.store import wire
    lock = threading.Lock()
    nxt = [0]
    kinds: dict = {}
    errors: list = []
    rows = [0]
    latencies: list = []

    def producer():
        try:
            while True:
                with lock:
                    i = nxt[0]
                    nxt[0] += 1
                if i >= len(blocks):
                    return
                batch = wire.decode_block(blocks[i])
                hh, conn, n_conn = im.score_batch(batch)
                for a in hh:
                    im.push_alert(dataclasses.asdict(a))
                for d in conn:
                    im.push_alert(d)
                with lock:
                    rows[0] += len(batch)
                    for a in hh:
                        kinds[a.kind] = kinds.get(a.kind, 0) + 1
                    kinds["connection_anomaly"] = \
                        kinds.get("connection_anomaly", 0) + n_conn
                    if conn:
                        latencies.append(conn[0]["latency_s"])
        except BaseException as e:   # noqa: BLE001 — re-raised by drive()
            errors.append(e)

    threads = [threading.Thread(target=producer, name=f"producer-{i}")
               for i in range(producers)]
    t0 = time.perf_counter()
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    wall = time.perf_counter() - t0
    if errors:
        raise errors[0]
    return {"rows": rows[0], "seconds": wall, "alerts": kinds,
            "alert_latency_s": percentiles(latencies)}


def device_activity(prof, window_us: float):
    """From a profile: the share of the window with a kernel or copy
    running on the card (union of the device intervals), and device
    time by kernel name. (None, {}) when the profiler recorded no
    device activity."""
    from torch.autograd import DeviceType
    events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    by_name: dict = {}
    for e in events:
        tot = by_name.setdefault(e.name, [0.0, 0])
        tot[0] += e.time_range.end - e.time_range.start
        tot[1] += 1
    spans = sorted((e.time_range.start, e.time_range.end) for e in events)
    if not spans:
        return None, {}
    busy, cur_s, cur_e = 0.0, spans[0][0], spans[0][1]
    for s, e in spans[1:]:
        if s > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy += cur_e - cur_s
    return min(1.0, busy / window_us), {
        name: {"ms": us / 1e3, "count": n}
        for name, (us, n) in sorted(by_name.items(),
                                    key=lambda kv: -kv[1][0])}


def phase_main_path(blocks, device) -> dict:
    import torch
    from theia_tpu_torch.manager.ingest import IngestManager
    from theia_tpu_torch.ops import fused_detector as fd

    # Warm the allocator, cuBLAS and the kernel on a throwaway manager.
    warm = IngestManager(None, n_shards=N_SHARDS, engine="fused",
                         device=device)
    try:
        drive(warm, blocks[:2], producers=1)
    finally:
        warm.close()

    im = IngestManager(None, n_shards=N_SHARDS, engine="fused",
                       device=device)
    try:
        fd.launches = fd.tiles = 0
        run = drive(im, blocks)
        launches, b1_tiles = fd.launches, fd.tiles
        eng = im._fused
        steps, coalesced = eng.steps, eng.coalesced_blocks
        device_ms = list(eng.device_ms)
        tiles_handed = eng.tiles
        dropped = sum(s.streaming.dropped_series for s in im.shards)
        series = sum(s.streaming.n_series for s in im.shards)
        ring = len(im.recent_alerts(10_000))
    finally:
        im.close()
    n_tiles = sum(tiles_handed.values())
    # one grouped launch per fused step scores every shard's tile
    want_launches = (steps if N_SHARDS <= fd.MAX_TILES
                     else -(-n_tiles // fd.MAX_TILES))
    if device.type == "cuda" and (launches != want_launches
                                  or b1_tiles != n_tiles):
        raise AssertionError(
            f"B1 launched {launches} times for {b1_tiles} tiles over "
            f"{steps} fused steps ({n_tiles} shard tiles): the main path "
            "did not go through the grouped kernel once a step")

    # A second, profiled pass over the same blocks for the device's
    # idle share (the profiler slows the host, so rows/s come from the
    # unprofiled pass above).
    idle, by_kernel, b1_profiled, device_ms_total = None, {}, None, None
    if device.type == "cuda":
        im2 = IngestManager(None, n_shards=N_SHARDS, engine="fused",
                            device=device)
        try:
            acts = [torch.profiler.ProfilerActivity.CPU,
                    torch.profiler.ProfilerActivity.CUDA]
            with torch.profiler.profile(activities=acts) as prof:
                t0 = time.perf_counter()
                drive(im2, blocks)
                torch.cuda.synchronize()
                window_us = (time.perf_counter() - t0) * 1e6
        finally:
            im2.close()
        busy, by_kernel = device_activity(prof, window_us)
        idle = None if busy is None else 1.0 - busy
        b1 = [v for k, v in by_kernel.items() if "stream_scan_kernel" in k]
        b1_profiled = ({"count": sum(v["count"] for v in b1),
                        "ms": sum(v["ms"] for v in b1)} if b1 else None)
        device_ms_total = sum(v["ms"] for v in by_kernel.values())
        by_kernel = dict(list(by_kernel.items())[:12])

    tiles: dict = {}
    for (t, u, live), n in tiles_handed.items():
        tiles.setdefault((t, u), []).extend([live] * n)
    modal = max(tiles, key=lambda k: len(tiles[k]))
    return {
        "rows": run["rows"], "seconds": run["seconds"],
        "rows_per_s": run["rows"] / run["seconds"],
        "fused_steps": steps, "coalesced_blocks": coalesced,
        "b1_launches": launches, "b1_tiles": b1_tiles,
        "step_device_ms_median": (statistics.median(device_ms)
                                  if device_ms else None),
        "step_device_ms_sum": sum(device_ms),
        "device_idle_share": idle,
        "profiled": {"rows_per_s": None if idle is None
                     else run["rows"] / (window_us / 1e6),
                     "device_ms_total": device_ms_total,
                     "b1": b1_profiled, "top_kernels": by_kernel},
        "series_tracked": series, "dropped_series": dropped,
        "alerts": run["alerts"], "alert_ring": ring,
        "alert_latency_s": run["alert_latency_s"],
        "tiles": {f"T{t}xU{u}": len(v) for (t, u), v in
                  sorted(tiles.items())},
        "modal_tile": {"T": modal[0], "U": modal[1],
                       "live": int(statistics.median(tiles[modal]))},
    }


# -- phase 5: card against CPU ------------------------------------------

def _strip(conn):
    return [{k: v for k, v in d.items() if k != "latency_s"}
            for d in conn]


def max_rel(a, b) -> float:
    """Largest |a − b| / |b| over the elements (0 where they are equal;
    b is the CPU's)."""
    import numpy as np
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    d = np.abs(a - b)
    if not d.size:
        return 0.0
    return float(np.max(np.where(d == 0, 0.0,
                                 d / np.maximum(np.abs(b), 1e-30))))


def score_stream(blocks, device) -> tuple:
    """Score the blocks one per fused step on `device`; returns each
    block's (hh, conn, n_conn) and every shard's final state as numpy
    ((ewma, count, mean, m2), (cms counts, total), (centroids,
    counts))."""
    from theia_tpu_torch.manager.ingest import IngestManager
    from theia_tpu_torch.ops import fused_detector as fd
    from theia_tpu_torch.store import wire
    im = IngestManager(None, n_shards=N_SHARDS, engine="fused",
                       device=device)
    try:
        outs = [im.score_batch(wire.decode_block(b)) for b in blocks]
        states = [fd.shard_state_to_numpy(fd.ShardStepState(
            s.streaming.state, s.heavy.cms, s.heavy.kmeans))
            for s in im.shards]
    finally:
        im.close()
    return outs, states


def compare_streams(card, cpu) -> dict:
    """Card against CPU: connection alerts identical apart from
    latency_s, heavy-hitter alerts equal in kind and destination, and
    the largest relative differences of every float the CMS and
    k-means halves produce."""
    import numpy as np
    (c_outs, c_states), (p_outs, p_states) = card, cpu
    got = {"conn_blocks_differ": 0, "hh_blocks_differ": 0,
           "connection_alerts": 0, "hh_alerts": {},
           "max_rel": {"heavy_hitter": 0.0, "ddos_shape": 0.0,
                       "cms_counts": 0.0, "cms_total": 0.0,
                       "centroids": 0.0},
           "kmeans_points_equal": True, "kmeans_moved": [],
           "kmeans_moved_share": 0.0, "stream_state_bit_exact": True}
    rel = got["max_rel"]
    for (hc, cc, nc), (hp, cp, np_) in zip(c_outs, p_outs):
        got["connection_alerts"] += np_
        if nc != np_ or _strip(cc) != _strip(cp):
            got["conn_blocks_differ"] += 1
        if [(a.kind, a.destination) for a in hc] != \
                [(a.kind, a.destination) for a in hp]:
            got["hh_blocks_differ"] += 1
            continue
        for a, b in zip(hc, hp):
            rel[a.kind] = max(rel[a.kind],
                              max_rel([a.estimate, a.share],
                                      [b.estimate, b.share]))
            got["hh_alerts"][a.kind] = got["hh_alerts"].get(a.kind, 0) + 1
    compare_states(c_states, p_states, got)
    return got


def compare_states(c_states, p_states, got: dict) -> None:
    """Every shard's final state, card against CPU, into `got`: the
    stream state bit for bit, the largest relative differences of the
    CMS counters, totals and centroids, and the k-means points moved."""
    import numpy as np
    rel = got["max_rel"]
    for (sc, cmc, kmc), (sp, cmp_, kmp) in zip(c_states, p_states):
        if not all(np.array_equal(a, b) for a, b in zip(sc, sp)):
            got["stream_state_bit_exact"] = False
        rel["cms_counts"] = max(rel["cms_counts"], max_rel(cmc[0], cmp_[0]))
        rel["cms_total"] = max(rel["cms_total"], max_rel(cmc[1], cmp_[1]))
        rel["centroids"] = max(rel["centroids"], max_rel(kmc[0], kmp[0]))
        n_points = float(kmp[1].sum())
        if float(kmc[1].sum()) != n_points:
            got["kmeans_points_equal"] = False
        moved = float(np.abs(kmc[1] - kmp[1]).sum()) / 2
        got["kmeans_moved"].append(moved)
        got["kmeans_moved_share"] = max(got["kmeans_moved_share"],
                                        moved / max(n_points, 1.0))


def phase_parity(blocks, cpu, device) -> dict:
    """The parity stream on the card against `cpu` (the same blocks
    scored on the CPU), one block per step; then once more on the card
    with TF32 matmuls allowed, as a control that the tolerance sees
    the precision it guards against (reported, not asserted)."""
    import torch
    got = compare_streams(score_stream(blocks, device), cpu)
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        control = compare_streams(score_stream(blocks, device), cpu)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    got.update(blocks=len(blocks), rtol=RTOL,
               kmeans_moved_limit=KMEANS_MOVED, kmeans_rtol=KMEANS_RTOL,
               tf32_control={k: control[k] for k in (
                   "max_rel", "hh_blocks_differ", "kmeans_moved_share")})
    return got


def check_parity(got: dict) -> None:
    if got["connection_alerts"] == 0:
        raise AssertionError("no connection alert fired: the parity "
                             "stream proves nothing")
    if got["conn_blocks_differ"] or got["hh_blocks_differ"]:
        raise AssertionError("alerts differ card vs CPU")
    check_states(got)


def check_states(got: dict) -> None:
    """The final-state and float limits of a card-vs-CPU comparison."""
    if not got["stream_state_bit_exact"]:
        raise AssertionError("final StreamState differs card vs CPU")
    if not got["kmeans_points_equal"]:
        raise AssertionError("k-means assigned another number of points "
                             "card vs CPU")
    if got["kmeans_moved_share"] > KMEANS_MOVED:
        raise AssertionError(
            f"{got['kmeans_moved_share']:.2e} of the points sit on another "
            f"centroid card vs CPU (limit {KMEANS_MOVED})")
    limits = dict.fromkeys(got["max_rel"], RTOL)
    limits["centroids"] = KMEANS_RTOL
    over = {k: v for k, v in got["max_rel"].items() if v > limits[k]}
    if over:
        raise AssertionError(f"card vs CPU beyond {limits}: {over}")


# -- phase: B2 against its plain version --------------------------------

def dbscan_inputs(seed: int, s: int, t: int):
    """The reference test's data (tests/test_kernels.py): half the
    points ~N(2e8, 1e7), the rest U(1e5, 1e9), ~80% valid; plus a chain
    of points exactly eps apart in row 0 and, in row 1, a core, a border
    and a noise point (DBSCAN_KINDS). float32, as B2 computes."""
    import numpy as np
    rng = np.random.default_rng(seed)
    x = rng.uniform(1e5, 1e9, size=(s, t))
    half = max(t // 2, 1)
    x[:, :half] = rng.normal(2e8, 1e7, size=(s, half))
    mask = rng.random(size=(s, t)) > 0.2
    if t >= 4:
        x[0, -4:] = 5e8 + DBSCAN_EPS * np.arange(4)
        mask[0, -4:] = True
    if t >= 6 and (s > 1 or t >= 10):
        row = min(1, s - 1)
        x[row, :6] = DBSCAN_KINDS
        mask[row, :6] = True
    return x.astype(np.float32), mask


def dbscan_kinds(x, mask) -> dict:
    """Core, border and noise counts from the closed form on the card,
    and the pair tests the two passes need: every valid pair for the
    counts, then every (valid non-core i, core j) pair for reach."""
    within = ((x[:, :, None] - x[:, None, :]).abs() <= DBSCAN_EPS) \
        & mask[:, :, None] & mask[:, None, :]
    n = mask.sum(-1)
    core = (within.sum(-1) >= DBSCAN_MIN_SAMPLES) & mask
    reach = (within & core[:, None, :]).any(-1)
    non_core = (mask & ~core).sum(-1)
    return {"core": int(core.sum()), "border": int((mask & ~core & reach).sum()),
            "noise": int((mask & ~core & ~reach).sum()),
            "pairs": int((n.long() ** 2).sum()
                         + (non_core.long() * core.sum(-1).long()).sum())}


def dbscan_pair_tests(x, mask, eps: float = DBSCAN_EPS,
                      min_samples: int = DBSCAN_MIN_SAMPLES) -> dict:
    """Pair tests of B2's two passes on these inputs, counted two ways.

    `pairs_full`: every valid pair for the counts, then every (valid
    non-core i, core j) pair for reach — what a kernel without an early
    exit tests. `pairs_needed`: what the inputs need — per valid i, the
    valid j's in j order up to its min_samples-th neighbour (all of
    them when it has fewer); per valid non-core i, the core j's in j
    order up to its first core neighbour (all of them when it has
    none). Computed in chunks of series on x's device."""
    import torch
    s, t = x.shape
    rows = max(1, 2 ** 24 // max(1, t * t))
    full = needed = 0
    for a in range(0, s, rows):
        xs, ms = x[a:a + rows], mask[a:a + rows]
        within = ((xs[:, :, None] - xs[:, None, :]).abs() <= eps) \
            & ms[:, :, None] & ms[:, None, :]
        n = ms.sum(-1)
        core = (within.sum(-1) >= min_samples) & ms
        open_ = ms & ~core
        n_core = core.sum(-1)
        full += int((n.long() ** 2).sum()
                   + (open_.sum(-1).long() * n_core.long()).sum())
        for hit, seen, total, who in (
                (within.cumsum(-1, dtype=torch.int32) >= min_samples,
                 ms.cumsum(-1, dtype=torch.int32), n, ms),
                (within & core[:, None, :],
                 core.cumsum(-1, dtype=torch.int32), n_core, open_)):
            # tests of point i: the j's of the pass up to its first hit
            first = hit.to(torch.uint8).argmax(-1)
            tests = torch.where(hit.any(-1), seen.gather(-1, first),
                                total[:, None].to(seen.dtype))
            needed += int((tests.long() * who).sum())
    return {"pairs_full": full, "pairs_needed": needed}


def b2_bound_ms(s: int, t: int, pairs: int, x_bytes: int = 4) -> tuple:
    """B2's bound: pair tests at B2_OPS_PER_PAIR operations against x
    (x_bytes a point), the mask and the flag."""
    by_bytes = (x_bytes + 2) * s * t / HBM_BYTES_PER_S * 1e3
    by_ops = B2_OPS_PER_PAIR * pairs / F32_OPS_PER_S * 1e3
    return ((by_bytes, "bytes") if by_bytes >= by_ops
            else (by_ops, "operations"))


def b2_routes(t: int) -> dict:
    """B2's routes that take series of length t: route name → its
    private entry in ops/dbscan.py."""
    from theia_tpu_torch.ops import dbscan
    routes = {"one_launch": dbscan._noise_one_launch,
              "two_pass": dbscan._noise_two_pass}
    if t > dbscan._ONE_MAX_T:
        del routes["one_launch"]
    return routes


def compare_dbscan(s: int, t: int, device) -> dict:
    """One shape: B2 (the wrapper, then each route that applies) and the
    plain version on the same card inputs, bit-exact, in float32 and
    from float64 (B2 rounds it; the plain version gets x cast to
    float32); the inputs must hold core, border and noise points
    (S·T ≥ 6 and room for DBSCAN_KINDS). Times on the card; bounds by
    the pair tests a kernel without an early exit makes and by those
    the inputs need."""
    import torch
    from theia_tpu_torch.ops import dbscan
    x, m = dbscan_inputs(s * 7919 + t, s, t)
    xt = torch.tensor(x, device=device)
    x64 = xt.double()
    mt = torch.tensor(m, device=device)
    launches = dbscan.launches
    got = dbscan.dbscan_noise_cuda(xt, mt)
    got64 = dbscan.dbscan_noise_cuda(x64, mt)
    want = dbscan.dbscan_noise(xt, mt)
    dbscan.launches = launches      # comparison launches don't count
    torch.cuda.synchronize()
    for name, flags in (("float32", got), ("float64", got64)):
        if not torch.equal(flags, want):
            raise AssertionError(
                f"B2 ({name} x) differs from plain at [{s}, {t}]: "
                f"{int((flags != want).sum())} flags")
    kinds = dbscan_kinds(xt, mt)
    if t >= 6 and (s > 1 or t >= 10) and not (
            kinds["core"] and kinds["border"] and kinds["noise"]):
        raise AssertionError(f"B2 inputs at [{s}, {t}] lack a kind of "
                             f"point: {kinds}")
    pairs = dbscan_pair_tests(xt, mt)
    row = {"S": s, "T": t, "bit_exact": True, "max_abs_err": 0.0,
           "route": dbscan._plan(s, t).route,
           "flags": int(got.sum()), **kinds, **pairs,
           "ms": graph_ms(lambda: dbscan.dbscan_noise_cuda(xt, mt)),
           "ms_f64": graph_ms(lambda: dbscan.dbscan_noise_cuda(x64, mt)),
           "call_ms": cuda_median_ms(
               lambda: dbscan.dbscan_noise_cuda(xt, mt)),
           "call_ms_f64": cuda_median_ms(
               lambda: dbscan.dbscan_noise_cuda(x64, mt)),
           "host_us_f64": host_us(
               lambda: dbscan.dbscan_noise_cuda(x64, mt)),
           "plain_ms": cuda_median_ms(lambda: dbscan.dbscan_noise(xt, mt)),
           "routes": {}}
    for route, fn in b2_routes(t).items():
        for name, xin in (("float32", xt), ("float64", x64)):
            flags = fn(xin, mt)
            torch.cuda.synchronize()
            if not torch.equal(flags, want):
                raise AssertionError(
                    f"B2 route {route} ({name} x) differs from plain at "
                    f"[{s}, {t}]: {int((flags != want).sum())} flags")
        row["routes"][route] = {"bit_exact": True,
                                "ms": graph_ms(lambda: fn(xt, mt))}
    # launches the wrapper counted for this shape's checks and timing
    # (graph replays re-run the captured ones uncounted). They are not
    # the TAD path's and are taken back out.
    row["counted_launches"] = dbscan.launches - launches
    dbscan.launches = launches
    row["bound_ms"], row["bound_by"] = b2_bound_ms(
        s, t, pairs["pairs_needed"])
    row["bound_full_ms"], row["bound_full_by"] = b2_bound_ms(
        s, t, pairs["pairs_full"])
    return row


def dbscan_special_inputs(seed: int, s: int, t: int):
    """dbscan_inputs plus, in row 2, valid NaN and ±inf points, a chain
    of points exactly eps apart and an invalid NaN: what folding the
    mask into x as NaN on the j side must get right."""
    import numpy as np
    x, m = dbscan_inputs(seed, s, t)
    special = np.array([np.nan, np.inf, -np.inf, 1e9, 1e9 + DBSCAN_EPS,
                        1e9 + 2 * DBSCAN_EPS, 1e9 + 3 * DBSCAN_EPS,
                        np.nan, 9e9], np.float32)
    x[2, :len(special)] = special
    m[2, :len(special)] = True
    m[2, 7] = False
    return x, m


def phase_dbscan_special(device) -> dict:
    """The wrapper and both routes against the plain version on
    dbscan_special_inputs, float32 and float64 x."""
    import torch
    from theia_tpu_torch.ops import dbscan
    out = {}
    for s, t in ((4, 16), (64, 1440), (3, 4096)):
        x, m = dbscan_special_inputs(s + t, s, t)
        xt, mt = torch.tensor(x, device=device), torch.tensor(m, device=device)
        want = dbscan.dbscan_noise(xt, mt)
        launches = dbscan.launches
        routes = {"wrapper": dbscan.dbscan_noise_cuda, **b2_routes(t)}
        for route, fn in routes.items():
            for xin in (xt, xt.double()):
                got = fn(xin, mt)
                torch.cuda.synchronize()
                if not torch.equal(got, want):
                    raise AssertionError(
                        f"B2 {route} differs from plain on special values "
                        f"at [{s}, {t}] ({xin.dtype}): "
                        f"{int((got != want).sum())} flags")
        dbscan.launches = launches
        out[f"{s}x{t}"] = {"bit_exact": True, "flags": int(want.sum()),
                           "row2_flags": want[2, :9].tolist()}
    return out


# -- phase: the TAD path ------------------------------------------------

def tad_flows(n_series: int, points: int, seed: int):
    """The reference's end-to-end TAD traffic (tests/test_tad.py): a
    1e7 base with 100× spikes on a tenth of the series, so that DBSCAN's
    fixed eps sees the spikes leave the cluster."""
    from theia_tpu_torch.data.synth import SynthConfig, generate_flows
    return generate_flows(SynthConfig(
        n_series=n_series, points_per_series=points, anomaly_fraction=0.1,
        anomaly_magnitude=100.0, base_throughput=1e7, seed=seed))


class ScoreTimer:
    """Times every call of analytics.tad.score_series while active:
    host seconds, and the device span from CUDA events recorded around
    the call (score_series ends by copying its results to the host)."""

    def __init__(self):
        self.seconds = 0.0
        self.device_ms = 0.0

    def __enter__(self):
        from theia_tpu_torch.analytics import tad
        self._orig = tad.score_series

        def timed(*args, **kw):
            import torch
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            t0 = time.perf_counter()
            a.record()
            out = self._orig(*args, **kw)
            b.record()
            b.synchronize()
            self.seconds += time.perf_counter() - t0
            self.device_ms += a.elapsed_time(b)
            return out

        tad.score_series = timed
        return self

    def __exit__(self, *exc):
        from theia_tpu_torch.analytics import tad
        tad.score_series = self._orig
        return False


def missed_spikes(flows, n_series: int, rows) -> int:
    """Ground-truth spikes with no result row, matched as
    tests/test_tad.py does: (sourceIP, sourceTransportPort, spike
    throughput)."""
    import numpy as np
    sip = flows.strings("sourceIP").reshape(n_series, -1)[:, 0]
    sport = flows["sourceTransportPort"].reshape(n_series, -1)[:, 0]
    thr = flows["throughput"].reshape(n_series, -1)
    flagged = {(r["sourceIP"], r["sourceTransportPort"],
                int(r["throughput"])) for r in rows}
    return sum((sip[i], int(sport[i]), int(thr[i].max())) not in flagged
               for i in np.nonzero(flows.ground_truth_anomalous)[0])


def phase_tad(flows, device) -> dict:
    """build_series → detect_anomalies for each algorithm on the card,
    B2's count set to 0 just before each run and read just after; then
    one profiled pass per algorithm for the device's idle share."""
    import numpy as np
    import torch
    from theia_tpu_torch.analytics.series import TadQuerySpec, build_series
    from theia_tpu_torch.analytics.tad import detect_anomalies
    from theia_tpu_torch.ops import dbscan

    # The first build_series builds the native series builder (g++):
    # set-up, timed apart from tensorize.
    t0 = time.perf_counter()
    build_series(flows.take(np.arange(min(len(flows), 1024))),
                 TadQuerySpec())
    native_build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    batch = build_series(flows, TadQuerySpec())
    tensorize_s = time.perf_counter() - t0
    records = int(batch.mask.sum())
    # Warm CUDA's lazy set-up and the kernel on a slice of the batch.
    small = dataclasses.replace(
        batch, values=batch.values[:64], times=batch.times[:64],
        mask=batch.mask[:64],
        keys={k: v[:64] for k, v in batch.keys.items()})
    for algo in TAD_ALGOS:
        detect_anomalies(small, algo, "warm", now=0, device=device)

    out = {"series": batch.n_series, "T": batch.values.shape[1],
           "records": records, "dtype": str(batch.values.dtype),
           "native_build_s": native_build_s, "tensorize_s": tensorize_s,
           "algos": {}}
    for algo in TAD_ALGOS:
        with ScoreTimer() as timer:
            dbscan.launches = 0
            t0 = time.perf_counter()
            rows = detect_anomalies(batch, algo, f"smoke-{algo}", now=0,
                                    refit_every=1, device=device)
            total = time.perf_counter() - t0
            launches = dbscan.launches
        missed = missed_spikes(flows, TAD_SERIES, rows)
        out["algos"][algo] = {
            "score_s": timer.seconds, "score_device_ms": timer.device_ms,
            "rows_s": total - timer.seconds, "detect_s": total,
            "records_per_s": records / timer.seconds,
            "result_rows": len(rows), "b2_launches": launches,
            "missed_spikes": missed,
            "spikes": int(flows.ground_truth_anomalous.sum())}
        if missed:
            raise AssertionError(f"TAD {algo} missed {missed} ground-truth "
                                 "spikes on the card")
    if out["algos"]["DBSCAN"]["b2_launches"] < 1:
        raise AssertionError("TAD DBSCAN did not go through B2")

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    for algo in TAD_ALGOS:
        with torch.profiler.profile(activities=acts) as prof:
            t0 = time.perf_counter()
            detect_anomalies(batch, algo, "profiled", now=0, device=device)
            torch.cuda.synchronize()
            window_us = (time.perf_counter() - t0) * 1e6
        busy, by_kernel = device_activity(prof, window_us)
        out["algos"][algo]["profiled"] = {
            "window_s": window_us / 1e6,
            "device_idle_share": None if busy is None else 1.0 - busy,
            "device_ms_total": sum(v["ms"] for v in by_kernel.values()),
            "device_launches": sum(v["count"] for v in by_kernel.values()),
            "top_kernels": {name[:100]: v for name, v in
                            list(by_kernel.items())[:6]}}
    return out


FLOAT_COLUMNS = ("throughputStandardDeviation", "algoCalc")


def rows_differ(got, want) -> dict:
    """TAD result rows card (got) against CPU (want): counts of rows
    whose exact columns differ, and the largest relative float
    differences."""
    diff = {"rows": len(want), "count_equal": len(got) == len(want),
            "exact_differ": 0, "std_max_rel": 0.0, "calc_max_rel": 0.0}
    if len(got) != len(want):
        return diff
    for g, w in zip(got, want):
        if {k: v for k, v in g.items() if k not in FLOAT_COLUMNS} != \
                {k: v for k, v in w.items() if k not in FLOAT_COLUMNS}:
            diff["exact_differ"] += 1
        diff["std_max_rel"] = max(diff["std_max_rel"], max_rel(
            [g["throughputStandardDeviation"]],
            [w["throughputStandardDeviation"]]))
        diff["calc_max_rel"] = max(diff["calc_max_rel"], max_rel(
            [g["algoCalc"]], [w["algoCalc"]]))
    return diff


def phase_tad_parity(device) -> dict:
    """The TAD job on the card and on the CPU over a smaller batch:
    float64 for EWMA and ARIMA (as run_tad builds it), float32 for
    DBSCAN so that both sides compute in B2's type."""
    import numpy as np
    from theia_tpu_torch.analytics.series import TadQuerySpec, build_series
    from theia_tpu_torch.analytics.tad import detect_anomalies
    flows = tad_flows(TAD_PARITY_SERIES, TAD_POINTS, seed=23)
    out = {"series": TAD_PARITY_SERIES, "T": TAD_POINTS}
    for algo in TAD_ALGOS:
        dtype = np.float32 if algo == "DBSCAN" else np.float64
        batch = build_series(flows, TadQuerySpec(), dtype=dtype)
        card = detect_anomalies(batch, algo, "parity", now=0,
                                device=device)
        cpu = detect_anomalies(batch, algo, "parity", now=0, device="cpu")
        got = rows_differ(card, cpu)
        got["anomalies"] = sum(r["anomaly"] == "true" for r in cpu)
        got["dtype"] = np.dtype(dtype).name
        out[algo] = got
    return out


def check_tad_parity(got: dict) -> None:
    for algo in TAD_ALGOS:
        d = got[algo]
        if not d["anomalies"]:
            raise AssertionError(f"TAD parity {algo}: nothing fired")
        if not d["count_equal"] or d["exact_differ"]:
            raise AssertionError(f"TAD {algo} rows differ card vs CPU: {d}")
        std_rtol = TAD_STD_RTOL[d["dtype"]]
        if d["std_max_rel"] > std_rtol \
                or d["calc_max_rel"] > TAD_CALC_RTOL[algo]:
            raise AssertionError(
                f"TAD {algo} floats card vs CPU beyond stddev {std_rtol} "
                f"/ algoCalc {TAD_CALC_RTOL[algo]}: {d}")


def build_kernels() -> dict:
    """Both kernel libraries, one nvcc each, started together; seconds
    per library."""
    from theia_tpu_torch.ops import _build
    seconds: dict = {}
    errors: list = []

    def build(name):
        t0 = time.perf_counter()
        try:
            _build.library(name)
        except BaseException as e:   # noqa: BLE001 — re-raised below
            errors.append(e)
        seconds[name] = time.perf_counter() - t0

    threads = [threading.Thread(target=build, args=(n,))
               for n in ("stream_scan", "dbscan_noise")]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    if errors:
        raise errors[0]
    return seconds


# -- the manager slice --------------------------------------------------

GROUP = "/apis/intelligence.theia.antrea.io/v1alpha1"
INTELLIGENCE = f"{GROUP}/throughputanomalydetectors"
TABLE_INFO = "/apis/stats.theia.antrea.io/v1alpha1/clickhouse/tableInfo"
#: connection alerts the manager's ring keeps (manager/ingest.py)
RING = 1000
#: blocks of the profiled /ingest pass (the device's idle share)
PROFILED_BLOCKS = 16
#: the restart drill's blocks, and its child's time to serve
RESTART_BLOCKS = 8
CHILD_READY_S = 300.0
TAD_JOB_TIMEOUT_S = 600.0
#: the working-set drill: bench.py's working-set mix (every key once
#: in random order, then half as many Zipf(1.3) re-arrivals, values
#: uniform in [0, 1e3)) at four times the hot slots of every shard
TIER_KEYS = 4 * N_SHARDS * CAPACITY
TIER_ZIPF = 1.3
#: the mix's one addition: this share of points 50x, so that the
#: alert multisets compared are not empty
TIER_SPIKES = 0.02
#: rows a step: small enough that a step's connection alerts stay
#: under the per-step decode cap (MAX_ALERTS), so every alert is
#: described and the multisets are whole
TIER_BATCH = 4096


def free_port() -> int:
    import socket
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def http_json(port: int, path: str, method: str = "GET", body=None,
              timeout: float = 120.0):
    import urllib.request
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", method=method,
        data=None if body is None else json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return json.loads(r.read())


def wait_ready(port: int, gave_up, timeout: float) -> dict:
    """Poll /healthz until the manager on `port` answers; fails once
    `gave_up()` says the manager stopped, or after `timeout` s."""
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if gave_up():
            raise RuntimeError(f"the manager on port {port} stopped "
                               "before it served")
        try:
            return http_json(port, "/healthz", timeout=5)
        except OSError:
            time.sleep(0.2)
    raise TimeoutError(f"the manager on port {port} did not serve "
                       f"within {timeout:.0f}s")


@contextlib.contextmanager
def environ(**env):
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def run_manager(args: list, env: dict, drive):
    """`python -m theia_tpu_torch.manager` in this process: its main()
    runs in this (the main) thread, which its signal handlers need,
    and `drive(port)` on another thread; once the driver is done it
    ends the manager as an operator does, with SIGTERM (main() drains
    and returns). Returns what `drive` returned."""
    from theia_tpu_torch.manager.__main__ import main as manager_main
    port = free_port()
    stopped = threading.Event()
    result: dict = {}

    def driver():
        try:
            wait_ready(port, stopped.is_set, CHILD_READY_S)
            result["out"] = drive(port)
        except BaseException as e:   # noqa: BLE001 — re-raised below
            result["error"] = e
        finally:
            if not stopped.is_set():
                os.kill(os.getpid(), signal.SIGTERM)

    saved = {sig: signal.getsignal(sig)
             for sig in (signal.SIGINT, signal.SIGTERM)}
    th = threading.Thread(target=driver, name="manager-driver")
    th.start()
    try:
        with environ(**env):
            manager_main([*args, "--port", str(port)])
    finally:
        stopped.set()
        th.join()
        for sig, handler in saved.items():
            signal.signal(sig, handler)
    if "error" in result:
        raise result["error"]
    return result["out"]


def send_blocks(port: int, blocks, producers: int, prefix: str) -> dict:
    """`producers` threads, each an IngestClient on its own stream
    with seq stamps, producer i sending blocks i, i + producers, ...;
    returns the acked rows and alerts, the window and every ack's
    latency."""
    from theia_tpu_torch.ingest.client import IngestClient
    lock = threading.Lock()
    acks: list = []
    errors: list = []

    def producer(i):
        try:
            client = IngestClient(f"http://127.0.0.1:{port}",
                                  stream=f"{prefix}-{i}", timeout=120.0)
            for seq, blk in enumerate(blocks[i::producers]):
                t0 = time.perf_counter()
                ack = client.send(blk, seq=seq)
                dt = time.perf_counter() - t0
                with lock:
                    acks.append((ack, dt))
        except BaseException as e:   # noqa: BLE001 — re-raised below
            errors.append(e)

    threads = [threading.Thread(target=producer, args=(i,),
                                name=f"producer-{prefix}-{i}")
               for i in range(producers)]
    t0 = time.perf_counter()
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    wall = time.perf_counter() - t0
    if errors:
        raise errors[0]
    if any(a.get("duplicate") or a.get("degraded") for a, _ in acks):
        raise AssertionError("a fresh block was acked as a duplicate or "
                             "degraded")
    return {"rows": sum(a["rows"] for a, _ in acks), "seconds": wall,
            "alerts": sum(a["alerts"] for a, _ in acks),
            "ack_latency_s": percentiles([dt for _, dt in acks])}


def total_rows(port: int) -> int:
    doc = http_json(port, TABLE_INFO)
    return next(int(t["totalRows"]) for t in doc["tableInfos"]
                if t["tableName"] == "flows")


def manager_env(tmp: str) -> dict:
    """The manager's store and engine: the parts engine with its part
    directory in `tmp`, and `auto`, which picks the fused engine on a
    card."""
    return {"THEIA_STORE_ENGINE": "parts",
            "THEIA_STORE_COLD_DIR": os.path.join(tmp, "parts"),
            "THEIA_DETECTOR_ENGINE": "auto"}


def manager_args(tmp: str, device) -> list:
    return ["--device", str(device), "--wal-dir", os.path.join(tmp, "wal"),
            "--ingest-shards", str(N_SHARDS)]


def phase_manager_path(blocks, device) -> dict:
    """The main path of the manager slice: the port's manager, started
    through its entry point, answers POST /ingest from four producer
    streams at full width; B1's counts are set to 0 just before the
    timed window and read just after. Then a profiled pass over a few
    blocks on new streams gives the device's idle share."""
    import tempfile
    import torch
    from theia_tpu_torch.ops import fused_detector as fd
    from theia_tpu_torch.store.wal import default_sync_policy

    def drive(port):
        health = http_json(port, "/healthz")
        engine = health["ingest"]["engine"]
        if engine["name"] != "fused":
            raise AssertionError(f"auto picked {engine} on {device}")
        # one block per shard on a stream of its own: the kernels'
        # first use, the store's native build and pinned staging
        warm = send_blocks(port, blocks[:N_SHARDS], 1, "warm")
        eng = live_fused_engine()
        before = http_json(port, "/healthz")
        tiles0 = sum(eng.tiles.values())
        eng.alert_latency_s.clear()
        fd.launches = fd.tiles = 0
        run = send_blocks(port, blocks, PRODUCERS, "p")
        launches, b1_tiles = fd.launches, fd.tiles
        after = http_json(port, "/healthz")
        n_tiles = sum(eng.tiles.values()) - tiles0
        # every block of the window that raised connection alerts (the
        # /alerts ring keeps only the newest RING alerts, one block's)
        latency = percentiles(list(eng.alert_latency_s))
        idle, profiled = None, None
        if device.type == "cuda":
            acts = [torch.profiler.ProfilerActivity.CPU,
                    torch.profiler.ProfilerActivity.CUDA]
            with torch.profiler.profile(activities=acts) as prof:
                t0 = time.perf_counter()
                profiled = send_blocks(port, blocks[:PROFILED_BLOCKS],
                                       PRODUCERS, "profiled")
                torch.cuda.synchronize()
                window_us = (time.perf_counter() - t0) * 1e6
            busy, by_kernel = device_activity(prof, window_us)
            idle = None if busy is None else 1.0 - busy
            profiled.update(device_ms_total=sum(
                v["ms"] for v in by_kernel.values()),
                top_kernels=dict(list(by_kernel.items())[:8]))
        stored = total_rows(port)
        eng0, eng1 = before["ingest"]["engine"], after["ingest"]["engine"]
        return {
            "rows": run["rows"], "seconds": run["seconds"],
            "rows_per_s": run["rows"] / run["seconds"],
            "producers": PRODUCERS, "blocks": len(blocks),
            "ack_latency_s": run["ack_latency_s"],
            "alerts_acked": run["alerts"],
            "alert_latency_s": latency,
            "fused_steps": eng1["steps"] - eng0["steps"],
            "coalesced_blocks": (eng1["coalescedBlocks"]
                                 - eng0["coalescedBlocks"]),
            "engine": {k: eng1.get(k) for k in ("name", "requested",
                                                "device")},
            "b1_launches": launches, "b1_tiles": b1_tiles,
            "shard_tiles": n_tiles,
            "b1_launches_per_s": launches / run["seconds"],
            "device_idle_share": idle, "profiled": profiled,
            "wal_policy": after["wal"]["policy"],
            "wal_bytes_written": (after["wal"]["bytes"]
                                  - before["wal"]["bytes"]),
            "store_total_rows": stored,
            "rows_acked": (warm["rows"] + run["rows"]
                           + (profiled["rows"] if profiled else 0)),
            "admission": after["admission"]["levelName"],
        }

    with tempfile.TemporaryDirectory(prefix="theia-manager-") as tmp:
        out = run_manager(manager_args(tmp, device), manager_env(tmp),
                          drive)
    out["wal_sync_env"] = str(default_sync_policy())
    if out["store_total_rows"] != out["rows_acked"]:
        raise AssertionError(
            f"the store holds {out['store_total_rows']} rows, "
            f"{out['rows_acked']} were acked")
    # held as the library path is: one grouped launch per fused step,
    # over every shard tile the steps handed to B1
    want = (out["fused_steps"] if N_SHARDS <= fd.MAX_TILES
            else -(-out["shard_tiles"] // fd.MAX_TILES))
    if device.type == "cuda" and (out["b1_launches"] != want
                                  or out["b1_tiles"]
                                  != out["shard_tiles"]):
        raise AssertionError(
            f"B1 launched {out['b1_launches']} times for "
            f"{out['b1_tiles']} tiles over {out['fused_steps']} fused "
            f"steps ({out['shard_tiles']} shard tiles) of /ingest "
            "traffic")
    return out


def live_fused_engine():
    """The fused engine of the manager that run_manager serves in this
    process: the one FusedDetectorEngine still open."""
    import gc
    from theia_tpu_torch.ingest.device_path import FusedDetectorEngine
    engines = [o for o in gc.get_objects()
               if type(o) is FusedDetectorEngine
               and not o._closed.is_set()]
    if len(engines) != 1:
        raise AssertionError(f"{len(engines)} open fused engines, "
                             "want the manager's one")
    return engines[0]


def ring_of(outs, limit: int = RING) -> list:
    """The alert ring a manager publishes for these per-block
    (hh, conn, n_conn) results: each block's heavy-hitter alerts, then
    its connection alerts, newest first (manager/ingest.py)."""
    import collections
    ring = collections.deque(maxlen=limit)
    for hh, conn, _ in outs:
        for a in hh:
            ring.appendleft(dataclasses.asdict(a))
        for d in conn:
            ring.appendleft(d)
    return list(ring)


def phase_manager_parity(blocks, cpu, device) -> dict:
    """One producer stream, in order, through /ingest of a port
    manager on the card, against the same blocks through the port's
    score_batch on the CPU (`cpu`, one block per step as here): the
    acks' alert counts per block, the alert ring (connection alerts
    identical apart from the clock stamps, heavy-hitter floats within
    RTOL) and every shard's final state, held as the parity phase
    holds them."""
    import numpy as np
    from theia_tpu_torch.ingest.client import IngestClient
    from theia_tpu_torch.manager import TheiaManagerServer
    from theia_tpu_torch.ops import fused_detector as fd
    from theia_tpu_torch.store import FlowDatabase

    with environ(THEIA_STORE_ENGINE="parts",
                 THEIA_DETECTOR_ENGINE="auto"):
        srv = TheiaManagerServer(FlowDatabase(), port=0,
                                 ingest_shards=N_SHARDS, device=device)
    srv.start_background()
    try:
        client = IngestClient(f"http://127.0.0.1:{srv.port}",
                              stream="parity", timeout=120.0)
        acks = [client.send(b, seq=i) for i, b in enumerate(blocks)]
        ring = srv.ingest.recent_alerts(RING)
        states = [fd.shard_state_to_numpy(fd.ShardStepState(
            s.streaming.state, s.heavy.cms, s.heavy.kmeans))
            for s in srv.ingest.shards]
        engine = srv.ingest.engine_name
    finally:
        srv.shutdown()
    outs, cpu_states = cpu
    want = ring_of(outs)
    got = {"engine": engine, "blocks": len(blocks),
           "ack_alerts_differ": sum(
               a["alerts"] != len(hh) + n
               for a, (hh, _, n) in zip(acks, outs)),
           "ring": len(ring), "ring_differ": 0,
           "connection_alerts_on_ring": 0,
           "max_rel": {"heavy_hitter": 0.0, "ddos_shape": 0.0,
                       "cms_counts": 0.0, "cms_total": 0.0,
                       "centroids": 0.0},
           "kmeans_points_equal": True, "kmeans_moved": [],
           "kmeans_moved_share": 0.0, "stream_state_bit_exact": True}
    floats = ("estimate", "share")
    for a, b in zip(ring, want):
        hh = a.get("kind") != "connection_anomaly"
        drop = ("time", "latency_s") + (floats if hh else ())
        if {k: v for k, v in a.items() if k not in drop} != \
                {k: v for k, v in b.items() if k not in drop}:
            got["ring_differ"] += 1
        elif hh:
            kind = a["kind"]
            got["max_rel"][kind] = max(got["max_rel"][kind], max_rel(
                [a[k] for k in floats], [b[k] for k in floats]))
        else:
            got["connection_alerts_on_ring"] += 1
    got["ring_differ"] += abs(len(ring) - len(want))
    compare_states(states, cpu_states, got)
    got["acked_alerts"] = int(np.sum([a["alerts"] for a in acks]))
    return got


def check_manager_parity(got: dict) -> None:
    if got["connection_alerts_on_ring"] == 0:
        raise AssertionError("no connection alert on the ring: the "
                             "manager parity pass proves nothing")
    if got["ack_alerts_differ"] or got["ring_differ"]:
        raise AssertionError("alerts through /ingest differ card vs CPU")
    check_states(got)


def api_rows(rows) -> list:
    """The intelligence API's string-typed TAD rows in the types
    missed_spikes reads."""
    return [{"sourceIP": r["sourceIP"],
             "sourceTransportPort": int(r["sourceTransportPort"]),
             "throughput": float(r["throughput"])} for r in rows]


def run_job(port: int, algo: str) -> dict:
    """Create one TAD job through the intelligence API, poll it, and
    retrieve it with its rows."""
    import uuid
    name = f"tad-{uuid.uuid4()}"
    http_json(port, INTELLIGENCE, "POST",
              {"metadata": {"name": name}, "jobType": algo})
    deadline = time.monotonic() + TAD_JOB_TIMEOUT_S
    while time.monotonic() < deadline:
        doc = http_json(port, f"{INTELLIGENCE}/{name}")
        state = doc["status"]["state"]
        if state == "FAILED":
            raise AssertionError(f"TAD {algo} job failed: "
                                 f"{doc['status']['errorMsg']}")
        if state == "COMPLETED":
            return doc
        time.sleep(0.2)
    raise TimeoutError(f"TAD {algo} job did not finish in "
                       f"{TAD_JOB_TIMEOUT_S:.0f}s")


def phase_manager_tad(blocks, flows, device) -> dict:
    """The TAD configuration's flows through /ingest of the port's
    manager, then one EWMA and one DBSCAN job created, polled and
    retrieved through the intelligence API; B2's count set to 0 just
    before the DBSCAN job and read just after. Then the jobs slice on
    the same manager and store (drive_jobs)."""
    import tempfile
    from theia_tpu_torch.ops import dbscan

    def drive(port):
        ingest = send_blocks(port, blocks, PRODUCERS, "tad")
        out = {"rows": ingest["rows"], "ingest_s": ingest["seconds"],
               "store_total_rows": total_rows(port), "jobs": {}}
        for algo in ("EWMA", "DBSCAN"):
            dbscan.launches = 0
            t0 = time.perf_counter()
            doc = run_job(port, algo)
            polled_s = time.perf_counter() - t0
            launches = dbscan.launches
            st = doc["status"]
            rows = doc.get("stats", [])
            out["jobs"][algo] = {
                "job_s": st["endTime"] - st["startTime"],
                "create_to_rows_s": polled_s,
                "result_rows": len(rows), "b2_launches": launches,
                "missed_spikes": missed_spikes(flows, TAD_SERIES,
                                               api_rows(rows))}
        # the jobs slice on the same manager and store
        out["manager_jobs"], out["jobs_parity"] = drive_jobs(port, device)
        return out

    with tempfile.TemporaryDirectory(prefix="theia-manager-tad-") as tmp:
        out = run_manager(manager_args(tmp, device), manager_env(tmp),
                          drive)
    out["spikes"] = int(flows.ground_truth_anomalous.sum())
    if out["store_total_rows"] != out["rows"] or out["rows"] != len(flows):
        raise AssertionError(f"{len(flows)} TAD flows sent, {out['rows']} "
                             f"acked, {out['store_total_rows']} stored")
    for algo, job in out["jobs"].items():
        if job["missed_spikes"]:
            raise AssertionError(f"TAD {algo} through the API missed "
                                 f"{job['missed_spikes']} spikes")
    if device.type == "cuda" and out["jobs"]["DBSCAN"]["b2_launches"] < 1:
        raise AssertionError("the API's DBSCAN job did not go through B2")
    return out


def start_child(tmp: str, device, log) -> subprocess.Popen:
    port = free_port()
    env = {**os.environ, **manager_env(tmp), "THEIA_WAL_SYNC": "always"}
    proc = subprocess.Popen(
        [sys.executable, "-m", "theia_tpu_torch.manager",
         *manager_args(tmp, device), "--port", str(port)],
        env=env, stdout=log, stderr=subprocess.STDOUT,
        cwd=os.path.dirname(os.path.abspath(__file__)))
    proc.port = port
    return proc


def phase_manager_restart(blocks, device) -> dict:
    """`python -m theia_tpu_torch.manager` as a child process (WAL sync
    `always`, no snapshot): seq-stamped blocks, SIGKILL, a restart on
    the same WAL directory; every acked row comes back, and a re-sent
    seq answers duplicate."""
    import tempfile
    from theia_tpu_torch.ingest.client import IngestClient
    out: dict = {}
    with tempfile.TemporaryDirectory(prefix="theia-restart-") as tmp:
        log_path = os.path.join(tmp, "manager.log")
        with open(log_path, "wb") as log:
            procs = []
            try:
                child = start_child(tmp, device, log)
                procs.append(child)
                t0 = time.perf_counter()
                wait_ready(child.port, lambda: child.poll() is not None,
                           CHILD_READY_S)
                out["first_ready_s"] = time.perf_counter() - t0
                client = IngestClient(f"http://127.0.0.1:{child.port}",
                                      stream="restart", timeout=120.0)
                acks = [client.send(b, seq=i) for i, b in enumerate(blocks)]
                out["rows_acked"] = sum(a["rows"] for a in acks)
                child.send_signal(signal.SIGKILL)
                out["killed_rc"] = child.wait(timeout=60)
                child = start_child(tmp, device, log)
                procs.append(child)
                t0 = time.perf_counter()
                wait_ready(child.port, lambda: child.poll() is not None,
                           CHILD_READY_S)
                out["restart_ready_s"] = time.perf_counter() - t0
                out["rows_recovered"] = total_rows(child.port)
                client = IngestClient(f"http://127.0.0.1:{child.port}",
                                      stream="restart", timeout=120.0)
                again = client.send(blocks[-1], seq=len(blocks) - 1)
                out["resent"] = {k: again.get(k)
                                 for k in ("rows", "duplicate")}
                child.send_signal(signal.SIGTERM)
                out["stopped_rc"] = child.wait(timeout=120)
            finally:
                for proc in procs:
                    if proc.poll() is None:
                        proc.kill()
                        proc.wait(timeout=60)
        with open(log_path, "rb") as log:
            tail = log.read()[-3000:].decode(errors="replace")
    if out.get("stopped_rc") != 0 \
            or out["rows_recovered"] != out["rows_acked"] \
            or out["resent"] != {"rows": acks[-1]["rows"],
                                 "duplicate": True}:
        raise AssertionError(f"restart drill failed: {out}\n{tail}")
    return out


def tier_stream(seed: int):
    """The working-set drill's traffic, as (key index, throughput)
    arrays: bench.py's working-set mix at TIER_KEYS keys, drawn in
    bench.py's order from `seed`, with TIER_SPIKES of the points
    spiked 50x by a generator of their own."""
    import numpy as np
    rng = np.random.default_rng(seed)
    keys = np.concatenate([
        rng.permutation(TIER_KEYS),
        rng.zipf(TIER_ZIPF, size=TIER_KEYS // 2).astype(np.int64)
        % TIER_KEYS])
    vals = rng.random(len(keys)) * 1e3
    spikes = np.random.default_rng(seed + 1).random(len(keys))
    vals[spikes < TIER_SPIKES] *= 50.0
    return keys, vals


def tier_batches(keys, vals):
    """Connection k = (10.0.(k mod 256).1, port 1024 + k div 65,536,
    10.1.((k div 256) mod 256).1, 80, TCP): TIER_BATCH rows a batch,
    one pair of dictionaries for the whole stream."""
    import numpy as np
    from theia_tpu_torch.schema import ColumnarBatch, StringDictionary
    src_d, dst_d = StringDictionary(), StringDictionary()
    src_c = np.array([src_d.encode_one(f"10.0.{i}.1") for i in range(256)],
                     np.int32)
    dst_c = np.array([dst_d.encode_one(f"10.1.{i}.1") for i in range(256)],
                     np.int32)
    dicts = {"sourceIP": src_d, "destinationIP": dst_d}
    for i in range(0, len(keys), TIER_BATCH):
        k = keys[i:i + TIER_BATCH]
        n = len(k)
        yield ColumnarBatch({
            "sourceIP": src_c[k % 256],
            "destinationIP": dst_c[(k >> 8) % 256],
            "sourceTransportPort": (1024 + (k >> 16)).astype(np.int32),
            "destinationTransportPort": np.full(n, 80, np.int32),
            "protocolIdentifier": np.full(n, 6, np.int32),
            "flowStartSeconds": np.full(n, 1, np.int64),
            "flowEndSeconds": np.full(n, 100, np.int64),
            "throughput": vals[i:i + n],
            "octetDeltaCount": np.full(n, 1000, np.int64),
            "packetDeltaCount": np.full(n, 10, np.int64),
            "reverseOctetDeltaCount": np.zeros(n, np.int64),
        }, dicts)


def tier_run(keys, vals, device, capacity=None) -> dict:
    """The drill through IngestManager.score_batch, in order, on the
    fused engine (`auto` on a card); with THEIA_STATE_TIER set by the
    caller, the tiers' stats come back too."""
    from theia_tpu_torch.manager.ingest import IngestManager
    from theia_tpu_torch.ops import fused_detector as fd
    from theia_tpu_torch.store import FlowDatabase
    with environ(THEIA_DETECTOR_ENGINE="auto"):
        im = IngestManager(FlowDatabase(), n_shards=N_SHARDS,
                           streaming_capacity=capacity, device=device)
    alerts: list = []
    n_conn = truncated = 0
    try:
        fd.launches = 0
        t0 = time.perf_counter()
        for batch in tier_batches(keys, vals):
            _, conn, n = im.score_batch(batch)
            n_conn += n
            truncated += n - len(conn)
            alerts.extend(tuple(sorted(
                (k, v) for k, v in d.items()
                if k not in ("latency_s", "slot"))) for d in conn)
        seconds = time.perf_counter() - t0
        out = {"engine": im.engine_name, "rows": len(keys),
               "seconds": seconds, "rows_per_s": len(keys) / seconds,
               "connection_alerts": n_conn, "undescribed": truncated,
               "b1_launches": fd.launches,
               "capacity": im.shards[0].streaming.capacity,
               "dropped_series": sum(s.streaming.dropped_series
                                     for s in im.shards),
               "tiers": [t.stats() for t in im._tiers]}
    finally:
        im.close()
    alerts.sort()
    return out, alerts


def phase_state_tier(device) -> dict:
    """THEIA_STATE_TIER on, at full width (8 shards of 65,536 slots)
    with four times as many connections as slots; against an unbounded
    run (every connection its own slot) on the same card."""
    keys, vals = tier_stream(seed=7)
    with environ(THEIA_STATE_TIER="1"):
        tiered, got = tier_run(keys, vals, device, capacity=CAPACITY)
    unbounded, want = tier_run(keys, vals, device, capacity=TIER_KEYS)
    tiers = tiered.pop("tiers")
    totals = {k: sum(t[k] for t in tiers)
              for k in ("evictions", "promotions", "overflow")}
    out = {"keys": TIER_KEYS, "slots": N_SHARDS * CAPACITY,
           "keys_per_slot": TIER_KEYS / (N_SHARDS * CAPACITY),
           "tiered": {**tiered, **totals},
           "unbounded": {k: v for k, v in unbounded.items()
                         if k != "tiers"},
           "alert_multisets_equal": got == want}
    if not got or tiered["undescribed"] or unbounded["undescribed"]:
        raise AssertionError(f"the drill's alert multisets are empty or "
                             f"cut by the per-step decode cap: {out}")
    if tiered["dropped_series"] or totals["overflow"] \
            or not totals["evictions"] or not totals["promotions"]:
        raise AssertionError(f"working-set tier: {out}")
    if not out["alert_multisets_equal"]:
        raise AssertionError("the tiered run's alerts differ from the "
                             "unbounded run's")
    return out


# -- the jobs slice: NPR, pattern mining, spatial, drop detection --------

#: spatial DBSCAN's float32 band: a pair whose float64 d² lies within
#: this share of |x|²+|y|² of eps² can fall either way between two
#: float32 evaluations of |x|²+|y|²−2x·y (eight ulps of the operands)
EPS_BAND = 2.0 ** -20


def _recount_rows(p64, sq, rows, eps2: float, min_samples: int,
                  chunk: int):
    """For each of `rows`: its exact neighbour count (self included),
    whether any of its pairs lies in the band, and its neighbours (row
    indices, kept only for non-core rows: fewer than min_samples)."""
    import torch
    counts = [torch.zeros(0, dtype=torch.int64, device=p64.device)]
    band = [torch.zeros(0, dtype=torch.bool, device=p64.device)]
    nbrs = []
    for i in range(0, len(rows), chunk):
        r = rows[i:i + chunk]
        d2 = torch.zeros((len(r), p64.shape[0]), dtype=torch.float64,
                         device=p64.device)
        for f in range(p64.shape[1]):
            diff = p64[r, f][:, None] - p64[None, :, f]
            d2 += diff * diff
        within = d2 <= eps2
        slack = EPS_BAND * (sq[r][:, None] + sq[None, :])
        counts.append(within.sum(1))
        band.append(((d2 - eps2).abs() <= slack).any(1))
        few = (within.sum(1) < min_samples).tolist()
        nbrs.extend(within[k].nonzero()[:, 0] if few[k] else None
                    for k in range(len(r)))
    return torch.cat(counts), torch.cat(band), nbrs


def points_recount(points, rows, eps: float, min_samples: int,
                   chunk: int = 64):
    """Exact noise flags, in float64, of points[rows] among all [N, F]
    `points` (on any device), and which of them are ambiguous for a
    float32 evaluation: a point with a pair in the EPS_BAND of eps², or
    a non-core point with a neighbour that has one (its flag reads that
    neighbour's core flag). Returns two bool tensors over `rows`, on
    the CPU."""
    import torch
    p64 = points.to(torch.float64)
    sq = (p64 * p64).sum(1)
    eps2 = float(eps) * float(eps)
    rows = torch.as_tensor(rows, device=points.device)
    count, band, nbrs = _recount_rows(p64, sq, rows, eps2, min_samples,
                                      chunk)
    core = (count >= min_samples).cpu()
    band = band.cpu()
    # a non-core point has fewer than min_samples neighbours: its
    # flag reads their core flags, recounted the same way
    need = sorted({int(j) for k in range(len(rows)) if not core[k]
                   for j in nbrs[k].tolist()})
    j_count, j_band, _ = _recount_rows(
        p64, sq, torch.tensor(need, dtype=torch.long, device=p64.device),
        eps2, min_samples, chunk)
    j_core = dict(zip(need, (j_count >= min_samples).cpu().tolist()))
    j_amb = dict(zip(need, j_band.cpu().tolist()))
    noise = torch.zeros(len(rows), dtype=torch.bool)
    ambiguous = band.clone()
    for k in range(len(rows)):
        if core[k]:
            continue
        js = nbrs[k].tolist()
        noise[k] = not any(j_core[j] for j in js)
        ambiguous[k] |= any(j_amb[j] for j in js)
    return noise, ambiguous


#: the four job kinds: (intelligence resource, name prefix, spec, the
#: job's device entry as (module, attribute), the progress stage that
#: runs it)
JOB_KINDS = {
    "npr": ("networkpolicyrecommendations", "pr", {"jobType": "initial"},
            ("theia_tpu_torch.analytics.npr", "device_distinct"), "read"),
    "fpm": ("flowpatternminings", "fpm", {"minSupport": 1048},
            ("theia_tpu_torch.analytics.itemsets", "_counts_over"), "mine"),
    "sad": ("spatialanomalydetections", "sad", {},
            ("theia_tpu_torch.analytics.spatial", "dbscan_points_noise"),
            "score"),
    "dd": ("trafficdropdetections", "dd", {"jobType": "initial"},
           ("theia_tpu_torch.analytics.drop_detection", "drop_scores"),
           "score"),
}
JOB_TIMEOUT_S = 900.0
#: SAD card vs CPU on the first flows by flowEndSeconds (an O(N²) CPU
#: pass at full size takes hours); the full-size recount's sample
SAD_PARITY_FLOWS = 16384
SAD_SAMPLE = 256
#: drop detection's traffic: a month of NetworkPolicy drops at 4,096
#: endpoints, Poisson(8) drops a day, 1% of endpoint-days at 20x the
#: rate. At most one such day per endpoint: mean ± 3·stddev_samp counts
#: the spikes themselves, so an endpoint with three 20x days cannot
#: flag them all (its stddev grows with them), whatever the code.
DD_ENDPOINTS = 4096
DD_DAYS = 30
DD_RATE = 8.0
DD_SPIKE_SHARE = 0.01
DD_SPIKE_FACTOR = 20.0
#: 2026-09-01, days since the epoch
DD_DAY0 = 20697
DD_RTOL = 1e-6
#: the drop pass's kinds of CUDA events that are not kernels
COPY_EVENTS = ("Memcpy", "Memset")


class StageClock:
    """While active, notes when each job's progress enters a stage and
    when it is done (JobProgress.stage and .done): seconds per stage,
    by job id."""

    def __enter__(self):
        from theia_tpu_torch.runner.progress import JobProgress
        self._orig = (JobProgress.stage, JobProgress.done)
        marks = self.marks = {}
        stage, done = self._orig

        def timed_stage(prog, name):
            marks.setdefault(prog.job_id, []).append(
                (name, time.perf_counter()))
            return stage(prog, name)

        def timed_done(prog):
            marks.setdefault(prog.job_id, []).append(
                ("", time.perf_counter()))
            return done(prog)

        JobProgress.stage, JobProgress.done = timed_stage, timed_done
        return self

    def __exit__(self, *exc):
        from theia_tpu_torch.runner.progress import JobProgress
        JobProgress.stage, JobProgress.done = self._orig
        return False

    def seconds(self, job_id: str) -> dict:
        marks = self.marks.get(job_id, [])
        return {name: t1 - t0 for (name, t0), (_, t1)
                in zip(marks, marks[1:])}


class DeviceCall:
    """While active, wraps `module.attr`, a job's device entry: each
    call runs between two CUDA events (the device span, synchronised
    after the call) and, with `profile`, under torch.profiler (the
    card's kernels and copies; reading the profile back takes seconds
    at tens of thousands of kernels, inside the job's time). With
    `keep`, each call's first argument and result stay for the
    caller."""

    def __init__(self, module: str, attr: str, profile: bool,
                 keep: bool = False):
        import importlib
        self.module = importlib.import_module(module)
        self.attr, self.profile, self.keep = attr, profile, keep
        self.calls: list = []
        self.kept: list = []

    def __enter__(self):
        import torch
        orig = self._orig = getattr(self.module, self.attr)
        acts = [torch.profiler.ProfilerActivity.CUDA]

        def wrapped(*args, **kw):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            with (torch.profiler.profile(activities=acts) if self.profile
                  else contextlib.nullcontext()) as prof:
                t0 = time.perf_counter()
                a.record()
                out = orig(*args, **kw)
                b.record()
                b.synchronize()
                window_us = (time.perf_counter() - t0) * 1e6
            call = {"host_s": window_us / 1e6,
                    "span_ms": a.elapsed_time(b)}
            if self.profile:
                busy, by_name = device_activity(prof, window_us)
                kernels = {k: v for k, v in by_name.items()
                           if not k.startswith(COPY_EVENTS)}
                call.update(
                    kernels=sum(v["count"] for v in kernels.values()),
                    kernel_ms=sum(v["ms"] for v in kernels.values()),
                    copies=sum(v["count"] for k, v in by_name.items()
                               if k.startswith(COPY_EVENTS)),
                    busy_share=busy,
                    top_kernels={k[:80]: v for k, v in
                                 list(kernels.items())[:6]})
            self.calls.append(call)
            if self.keep:
                self.kept.append((args[0], out))
            return out

        setattr(self.module, self.attr, wrapped)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.attr, self._orig)
        return False

    def summary(self) -> dict:
        out = {"calls": len(self.calls)}
        for key in ("host_s", "span_ms", "kernels", "kernel_ms", "copies"):
            if self.calls and key in self.calls[0]:
                out[key] = sum(c[key] for c in self.calls)
        if self.profile:
            out["per_call"] = self.calls
        return out


def run_api_job(port: int, resource: str, body: dict) -> dict:
    """Create a job through the intelligence API, poll it, retrieve
    it with its results."""
    path = f"{GROUP}/{resource}"
    name = body["metadata"]["name"]
    http_json(port, path, "POST", body)
    deadline = time.monotonic() + JOB_TIMEOUT_S
    while time.monotonic() < deadline:
        doc = http_json(port, f"{path}/{name}")
        state = doc["status"]["state"]
        if state == "FAILED":
            raise AssertionError(f"job {name} failed: "
                                 f"{doc['status']['errorMsg']}")
        if state == "COMPLETED":
            return doc
        time.sleep(0.2)
    raise TimeoutError(f"job {name} did not finish in {JOB_TIMEOUT_S:.0f}s")


def live_controller():
    """The job controller of the manager that run_manager serves in
    this process: the one JobController still running."""
    import gc
    from theia_tpu_torch.manager.jobs import JobController
    ctls = [o for o in gc.get_objects()
            if type(o) is JobController and not o._stop.is_set()]
    if len(ctls) != 1:
        raise AssertionError(f"{len(ctls)} running job controllers, want "
                             "the manager's one")
    return ctls[0]


def table_rows(db, table: str, job_id: str) -> list:
    data = db.result_tables[table].scan()
    if not len(data):
        return []
    return data.filter(data.strings("id") == job_id).to_rows()


def drop_flows(seed: int):
    """The drop-detection traffic as one flow batch with every schema
    column, and the injected (endpoint, direction, day) spikes. Even
    endpoints are dropped on ingress (action 2, Drop: the victim is the
    destination), odd ones on egress (action 3, Reject: the victim is
    the source), each by a NetworkPolicy of its namespace."""
    import numpy as np
    from theia_tpu_torch.schema import FLOW_SCHEMA, ColumnarBatch
    rng = np.random.default_rng(seed)
    n_e, n_d = DD_ENDPOINTS, DD_DAYS
    rate = np.full((n_e, n_d), DD_RATE)
    spiked = rng.choice(n_e, size=round(DD_SPIKE_SHARE * n_e * n_d),
                        replace=False)
    spike_day = rng.integers(0, n_d, size=len(spiked))
    rate[spiked, spike_day] *= DD_SPIKE_FACTOR
    counts = rng.poisson(rate)
    cell = np.repeat(np.arange(n_e * n_d), counts.ravel())
    e, d = cell // n_d, cell % n_d
    n = len(cell)
    ingress = e % 2 == 0
    ep = np.arange(n_e)
    victim = {"PodName": [f"api-{i}" for i in ep],
              "PodNamespace": [f"team-{i % 64}" for i in ep],
              "IP": [f"10.{128 + i // 256}.{i % 256}.7" for i in ep]}
    peer = {"PodName": [f"client-{i}" for i in ep],
            "PodNamespace": ["clients"] * n_e,
            "IP": [f"10.{160 + i // 256}.{i % 256}.9" for i in ep]}
    batch = ColumnarBatch.from_rows([], FLOW_SCHEMA)
    cols = {c.name: (np.zeros(n, np.int32) if c.is_string
                     else np.zeros(n, c.host_dtype)) for c in FLOW_SCHEMA}

    def put(col, per_endpoint, where):
        codes = batch.dicts[col].encode(per_endpoint)
        cols[col] = np.where(where, codes[e], cols[col]).astype(np.int32)

    for side, dst_side in (("source", False), ("destination", True)):
        for field in ("PodName", "PodNamespace", "IP"):
            v = victim[field] if dst_side else peer[field]
            p = peer[field] if dst_side else victim[field]
            put(side + field, v, ingress)
            put(side + field, p, ~ingress)
    put("ingressNetworkPolicyName", [f"deny-{i % 64}" for i in ep], ingress)
    put("egressNetworkPolicyName", [f"deny-{i % 64}" for i in ep], ~ingress)
    cols["ingressNetworkPolicyRuleAction"][:] = np.where(ingress, 2, 0)
    cols["egressNetworkPolicyRuleAction"][:] = np.where(ingress, 0, 3)
    start = (DD_DAY0 + d) * 86400 + rng.integers(0, 86000, n)
    cols["flowStartSeconds"][:] = start
    cols["flowEndSeconds"][:] = start + 10
    cols["timeInserted"][:] = start + 15
    cols["protocolIdentifier"][:] = 6
    cols["destinationTransportPort"][:] = 8443
    cols["packetDeltaCount"][:] = 3
    cols["octetDeltaCount"][:] = 180
    injected = {(f"team-{i % 64}/api-{i}", "ingress" if i % 2 == 0
                 else "egress", (DD_DAY0 + int(day)) * 86400)
                for i, day in zip(spiked, spike_day)}
    return ColumnarBatch(cols, batch.dicts), injected


def policy_kinds(rows) -> dict:
    out: dict = {}
    for r in rows:
        out[r["kind"]] = out.get(r["kind"], 0) + 1
    return out


def drive_jobs(port: int, device) -> tuple:
    """The jobs slice through the API of the manager on `port`, over
    the flows it holds: NPR, FPM and SAD, then a month of dropped flows
    through POST /ingest and a DD job. After each job, its card vs CPU
    parity on the store as the job found it (the manager's own
    database, so the same dictionary codes: NPR's distinct order and
    SAD's hashed axes read them). Returns (the manager_jobs phase, the
    jobs_parity phase)."""
    import uuid
    import torch
    db = live_controller().db
    out: dict = {"store_rows": total_rows(port)}
    parity: dict = {}
    with StageClock() as clock:
        for kind in ("npr", "fpm", "sad", "dd"):
            resource, prefix, spec, (mod, attr), stage = JOB_KINDS[kind]
            if kind == "dd":
                t0 = time.perf_counter()
                drops, injected = drop_flows(seed=31)
                blocks = encode_blocks(drops)
                built_s = time.perf_counter() - t0
                sent = send_blocks(port, blocks, PRODUCERS, "drops")
                out["drop_traffic"] = {
                    "rows": len(drops), "built_s": built_s,
                    "ingest_s": sent["seconds"], "acked": sent["rows"],
                    "endpoints": DD_ENDPOINTS, "days": DD_DAYS,
                    "injected": len(injected)}
            # once timed (CUDA events around the device entry), once
            # profiled (its kernels), each a job of its own
            runs = {}
            for mode in ("timed", "profiled"):
                name = f"{prefix}-{uuid.uuid4()}"
                torch.cuda.reset_peak_memory_stats()
                t0 = time.perf_counter()
                with DeviceCall(mod, attr, profile=mode == "profiled",
                                keep=mode == "timed") as call:
                    doc = run_api_job(port, resource,
                                      {"metadata": {"name": name}, **spec})
                st = doc["status"]
                runs[mode] = (name, doc, call, {
                    "job_s": st["endTime"] - st["startTime"],
                    "create_to_rows_s": time.perf_counter() - t0,
                    "stages_s": clock.seconds(st["sparkApplication"]),
                    "device": call.summary(),
                    "max_memory_allocated":
                        torch.cuda.max_memory_allocated(),
                    "job_id": st["sparkApplication"]})
            name, doc, call, job = runs["timed"]
            prof = runs["profiled"][3]
            job.update(name=name, device_stage=stage, profiled={
                k: prof[k] for k in ("job_s", "stages_s", "device")})
            # the profiled run's kernel time over the timed run's job
            dev = prof["device"]
            job["device_idle_share_of_job"] = \
                1.0 - dev["kernel_ms"] / 1e3 / job["job_s"]
            if dev["kernels"] < 1:
                raise AssertionError(f"the {kind} job launched no CUDA "
                                     f"kernel in its {stage} stage")
            if kind == "npr":
                keys, (uniq, _) = call.kept[0]
                rows = table_rows(db, "recommendations", job["job_id"])
                outcome = doc["status"]["recommendationOutcome"]
                job.update(distinct_input_rows=len(keys),
                           distinct_rows=len(uniq), result_rows=len(rows),
                           policies_by_kind=policy_kinds(rows),
                           outcome_matches_table=sorted(
                               outcome.split("---\n")) == sorted(
                               r["policy"] for r in rows))
                if len(keys) != len(db.flows.scan()) \
                        or not job["outcome_matches_table"]:
                    raise AssertionError(f"NPR through the API: {job}")
            else:
                job["result_rows"] = len(doc.get("stats", []))
            if kind == "fpm":
                by_len: dict = {}
                for r in doc["stats"]:
                    n_len = int(r["itemsetLength"])
                    by_len[n_len] = by_len.get(n_len, 0) + 1
                job.update(itemsets_by_length=by_len, f=by_len.get(1, 0),
                           p=by_len.get(2, 0))
            if kind == "sad":
                alerts = http_json(port, f"/alerts?limit={RING}")["alerts"]
                job.update(noise=job["result_rows"],
                           score_s=job["stages_s"].get("score"),
                           spatial_alerts=sum(
                               a.get("kind") == "spatial_noise"
                               and a.get("job") == name for a in alerts))
                if not job["spatial_alerts"]:
                    raise AssertionError("no spatial alert reached /alerts")
            if kind == "dd":
                found = {(r["endpoint"], r["direction"],
                          int(r["anomalyDropDate"])) for r in doc["stats"]}
                job.update(injected=len(injected),
                           injected_found=len(injected & found),
                           not_injected=len(found - injected))
                if not injected <= found:
                    raise AssertionError(
                        f"DD missed {len(injected - found)} of "
                        f"{len(injected)} injected endpoint-days")
            out[kind] = job
            parity[kind] = cpu_parity(
                kind, db, job, call.kept[0] if call.kept else None, device)
    return out, parity


def cpu_parity(kind: str, db, job: dict, kept, device) -> dict:
    """The port on device="cpu" over the store as the card's `kind`
    job found it, against that job: NPR (kind, policy) pairs and FPM
    itemsets exact; DD rows exact, mean and stddev within DD_RTOL; SAD
    card vs CPU flags on the first SAD_PARITY_FLOWS flows by
    flowEndSeconds, and the card job's full-size flags against an
    exact float64 recount of a seeded sample, each outside the
    EPS_BAND exception."""
    import numpy as np
    import torch
    from theia_tpu_torch.analytics import (flow_embeddings,
                                           run_drop_detection, run_npr,
                                           run_pattern_mining)
    from theia_tpu_torch.ops.dbscan import dbscan_points_noise
    t0 = time.perf_counter()
    cpu_id = f"cpu-{kind}"
    if kind == "npr":
        run_npr(db, recommendation_id=cpu_id, device="cpu")
        got = {side: sorted((r["kind"], r["policy"]) for r in table_rows(
            db, "recommendations", job_id))
            for side, job_id in (("card", job["job_id"]), ("cpu", cpu_id))}
        return {"cpu_s": time.perf_counter() - t0,
                "policies": len(got["card"]),
                "equal": got["card"] == got["cpu"]}
    if kind == "fpm":
        run_pattern_mining(db, min_support=JOB_KINDS["fpm"][2]["minSupport"],
                           mining_id=cpu_id, device="cpu")
        got = {side: sorted((r["items"], int(r["itemsetLength"]),
                             int(r["support"])) for r in table_rows(
            db, "flowpatterns", job_id))
            for side, job_id in (("card", job["job_id"]), ("cpu", cpu_id))}
        return {"cpu_s": time.perf_counter() - t0,
                "itemsets": len(got["card"]),
                "equal": got["card"] == got["cpu"]}
    if kind == "dd":
        run_drop_detection(db, detection_id=cpu_id, device="cpu")
        key = ("endpoint", "direction", "anomalyDropDate",
               "anomalyDropNumber")
        got = {side: sorted((tuple(r[k] for k in key), r["avgDrop"],
                             r["stdevDrop"]) for r in table_rows(
            db, "dropdetection", job_id))
            for side, job_id in (("card", job["job_id"]), ("cpu", cpu_id))}
        card, cpu = got["card"], got["cpu"]
        n_equal = len(card) == len(cpu)
        out = {"cpu_s": time.perf_counter() - t0, "rows": len(card),
               "flags_equal": n_equal and all(
                   a[0] == b[0] for a, b in zip(card, cpu))}
        for i, col in ((1, "mean_max_rel"), (2, "std_max_rel")):
            out[col] = max_rel([a[i] for a in card],
                               [b[i] for b in cpu]) if n_equal else None
        return out

    # SAD, card vs CPU, on the first flows by flowEndSeconds
    flows = db.flows.scan()
    order = np.argsort(flows["flowEndSeconds"], kind="stable")
    emb = torch.from_numpy(flow_embeddings(
        flows.take(order[:SAD_PARITY_FLOWS])))
    valid = torch.ones(len(emb), dtype=torch.bool)
    t0 = time.perf_counter()
    on_card = dbscan_points_noise(emb.to(device), valid.to(device),
                                  eps=1.0).cpu()
    card_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    on_cpu = dbscan_points_noise(emb, valid, eps=1.0)
    cpu_s = time.perf_counter() - t0
    exact, amb = points_recount(emb.to(device),
                                torch.arange(len(emb)), 1.0, 4)
    differ = (on_card != on_cpu) | (on_card != exact)
    out = {"subset": {
        "flows": len(emb), "card_s": card_s, "cpu_s": cpu_s,
        "noise_card": int(on_card.sum()), "noise_cpu": int(on_cpu.sum()),
        "noise_exact": int(exact.sum()), "ambiguous": int(amb.sum()),
        "ambiguous_points": amb.nonzero()[:, 0].tolist()[:20],
        "differ": int(differ.sum()),
        "differ_outside_band": int((differ & ~amb).sum())}}

    # SAD at full size: the API job's own points and flags, recounted
    points, noise = kept
    noise = noise.cpu()
    gen = torch.Generator().manual_seed(41)
    flagged = noise.nonzero()[:, 0]
    clear = (~noise).nonzero()[:, 0]
    pick = torch.cat([
        flagged[torch.randperm(len(flagged), generator=gen)[:SAD_SAMPLE]],
        clear[torch.randperm(len(clear), generator=gen)[:SAD_SAMPLE]]])
    t0 = time.perf_counter()
    exact, amb = points_recount(points, pick.to(points.device), 1.0, 4)
    bad = (exact != noise[pick]) & ~amb
    out["full"] = {
        "flows": len(noise), "noise": int(noise.sum()),
        "sampled_flagged": int(noise[pick].sum()),
        "sampled_clear": int((~noise[pick]).sum()),
        "recount_s": time.perf_counter() - t0,
        "ambiguous": int(amb.sum()), "disagree": int(bad.sum()),
        "disagree_points": pick[bad].tolist()[:20]}
    return out


def check_jobs_parity(got: dict) -> None:
    if not (got["npr"]["equal"] and got["npr"]["policies"]):
        raise AssertionError(f"NPR card vs CPU: {got['npr']}")
    if not (got["fpm"]["equal"] and got["fpm"]["itemsets"]):
        raise AssertionError(f"FPM card vs CPU: {got['fpm']}")
    dd = got["dd"]
    if not (dd["flags_equal"] and dd["rows"]) \
            or dd["mean_max_rel"] > DD_RTOL or dd["std_max_rel"] > DD_RTOL:
        raise AssertionError(f"DD card vs CPU: {dd}")
    if got["sad"]["subset"]["differ_outside_band"]:
        raise AssertionError(f"SAD card vs CPU: {got['sad']['subset']}")
    if got["sad"]["full"]["disagree"] or not got["sad"]["full"]["noise"]:
        raise AssertionError(f"SAD recount: {got['sad']['full']}")


# -- main ---------------------------------------------------------------

def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs a "
              "card", file=sys.stderr)
        return 2
    import theia_tpu_torch  # noqa: F401 — fail before any output without the port
    t_start = time.perf_counter()
    card = card_name_and_limit()
    device = torch.device("cuda", 0)
    emit("device", nvidia_smi=card, kind=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), torch=torch.__version__,
         cuda=torch.version.cuda)

    t0 = time.perf_counter()
    emit("build", seconds=build_kernels(),
         wall_seconds=time.perf_counter() - t0)

    scan_rows = phase_kernel_vs_plain(device)
    emit("kernel_vs_plain", kernel="B1 stream_scan", capacity=CAPACITY,
         shapes=scan_rows)

    t0 = time.perf_counter()
    main_blocks = tblk_blocks(cluster_config(300_000, 4, seed=7))
    parity_blocks = tblk_blocks(cluster_config(20_000, 8, seed=11))
    emit("traffic", seconds=time.perf_counter() - t0,
         main_blocks=len(main_blocks), parity_blocks=len(parity_blocks))

    main = phase_main_path(main_blocks, device)
    emit("main_path", **main)

    cpu_parity = score_stream(parity_blocks, "cpu")
    parity = phase_parity(parity_blocks, cpu_parity, device)
    emit("parity", **parity)
    check_parity(parity)

    # B1's numbers at the main path's shape: one modal tile, and the
    # grouped launch of eight, which is what a fused step makes.
    import numpy as np
    modal = main["modal_tile"]
    at_main = compare_scan(np.random.default_rng(99), modal["T"],
                           modal["U"], modal["live"], device)
    grouped = phase_b1_grouped(modal, device)
    emit("b1_grouped", kernel="B1 stream_scan", one_tile=at_main, **grouped)
    kernels = [{
        "name": "B1 stream_scan", "route": "cuda",
        "source": "theia_tpu_torch/csrc/stream_scan.cu",
        "replaces": "theia_tpu/ops/fused_detector.py:93",
        "tpu": "theia_tpu/ops/fused_detector.py::_scan_tile_pallas",
        "launches": main["b1_launches"], "tiles": main["b1_tiles"],
        "matches_plain": all(r["bit_exact"] for r in scan_rows)
        and at_main["bit_exact"] and grouped["bit_exact"],
        "max_abs_err": max(r["max_abs_err"]
                           for r in scan_rows + [at_main, grouped]),
        "shape": {"tiles": N_SHARDS, "T": modal["T"], "U": modal["U"],
                  "live": modal["live"], "capacity": CAPACITY},
        "ms": grouped["ms"], "plain_ms": grouped["plain_ms"],
        "bound_ms": grouped["bound_ms"], "bound_by": grouped["bound_by"],
        "library_ms": None,
        "one_tile_x8_ms": grouped["one_tile_x8_median_ms"],
        "one_tile_ms": at_main["ms"],
    }]

    b2_rows = [compare_dbscan(s, t, device) for s, t in B2_SHAPES]
    emit("kernel_vs_plain", kernel="B2 dbscan_noise", eps=DBSCAN_EPS,
         min_samples=DBSCAN_MIN_SAMPLES, shapes=b2_rows)
    emit("b2_special_values", **phase_dbscan_special(device))

    t0 = time.perf_counter()
    flows = tad_flows(TAD_SERIES, TAD_POINTS, seed=17)
    emit("tad_traffic", seconds=time.perf_counter() - t0, rows=len(flows))
    tad = phase_tad(flows, device)
    emit("tad_path", **tad)

    tad_parity = phase_tad_parity(device)
    emit("tad_parity", std_rtol=TAD_STD_RTOL, calc_rtol=TAD_CALC_RTOL,
         **tad_parity)
    check_tad_parity(tad_parity)

    # B2's numbers at the TAD path's shape.
    at_tad = next(r for r in b2_rows if (r["S"], r["T"]) == (TAD_SERIES,
                                                             TAD_POINTS))
    kernels.append({
        "name": "B2 dbscan_noise", "route": "cuda",
        "source": "theia_tpu_torch/csrc/dbscan_noise.cu",
        "replaces": "theia_tpu/ops/dbscan_pallas.py:57",
        "tpu": "theia_tpu/ops/dbscan_pallas.py::dbscan_noise_pallas",
        "launches": tad["algos"]["DBSCAN"]["b2_launches"],
        "matches_plain": all(r["bit_exact"] for r in b2_rows),
        "max_abs_err": max(r["max_abs_err"] for r in b2_rows),
        "shape": {"S": TAD_SERIES, "T": TAD_POINTS},
        "b2_route": at_tad["route"],
        "ms": at_tad["ms"], "plain_ms": at_tad["plain_ms"],
        "bound_ms": at_tad["bound_ms"], "bound_by": at_tad["bound_by"],
        "library_ms": None,
        "ms_f64": at_tad["ms_f64"],
        "bound_full_ms": at_tad["bound_full_ms"],
    })

    # The manager slice: the same paths through the port's manager.
    manager = phase_manager_path(main_blocks, device)
    emit("manager_path", **manager)
    manager_parity = phase_manager_parity(parity_blocks, cpu_parity,
                                          device)
    emit("manager_parity", rtol=RTOL, kmeans_moved_limit=KMEANS_MOVED,
         kmeans_rtol=KMEANS_RTOL, **manager_parity)
    check_manager_parity(manager_parity)
    t0 = time.perf_counter()
    tad_blocks = encode_blocks(flows)
    emit("manager_tad_traffic", seconds=time.perf_counter() - t0,
         blocks=len(tad_blocks))
    manager_tad = phase_manager_tad(tad_blocks, flows, device)
    jobs = manager_tad.pop("manager_jobs")
    jobs_parity = manager_tad.pop("jobs_parity")
    emit("manager_tad", **manager_tad)
    emit("manager_jobs", **jobs)
    emit("jobs_parity", dd_rtol=DD_RTOL, eps_band=EPS_BAND, **jobs_parity)
    check_jobs_parity(jobs_parity)
    del flows, tad_blocks
    emit("manager_restart",
         **phase_manager_restart(main_blocks[:RESTART_BLOCKS], device))
    tier = phase_state_tier(device)
    emit("state_tier", **tier)

    # The manager slice's paths are this slice's main paths: B1's
    # launches from /ingest traffic, B2's from the API's DBSCAN job.
    kernels[0].update(
        launches=manager["b1_launches"],
        launches_by_path={"main_path": main["b1_launches"],
                          "manager_path": manager["b1_launches"],
                          "state_tier": tier["tiered"]["b1_launches"]},
        launches_per_ingest_s=manager["b1_launches_per_s"])
    kernels[1].update(
        launches=manager_tad["jobs"]["DBSCAN"]["b2_launches"],
        launches_by_path={
            "tad_path": tad["algos"]["DBSCAN"]["b2_launches"],
            "manager_tad": manager_tad["jobs"]["DBSCAN"]["b2_launches"]})
    emit("done", seconds=time.perf_counter() - t_start)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
