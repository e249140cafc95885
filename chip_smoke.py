#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (theia_tpu_torch).

    python3 chip_smoke.py

Needs one CUDA card and the CUDA toolkit (nvcc). Drives the port's two
paths and holds every kernel of them against its plain PyTorch version
on the card:

  * the live ingest-and-score path — TBLK blocks → wire.decode_block →
    IngestManager.score_batch (fused engine, 8 shards, the reference's
    default detector sizes) → push_alert; its kernel is B1
    (csrc/stream_scan.cu);
  * the TAD batch job — generate_flows → build_series →
    detect_anomalies for EWMA, DBSCAN and ARIMA at 8,192 series × 128
    points; its kernel is B2 (csrc/dbscan_noise.cu, DBSCAN).

Each phase prints one JSON line; any failure raises and the script
exits non-zero. The last line of standard output is

    {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}

Phases: device; build (both libraries in parallel); B1 against its
plain version; the ingest path (one grouped B1 launch per fused step);
ingest card vs CPU parity; B1's grouped launch against its plain
version and against one-tile launches; B2 against its plain version,
through the wrapper and each of its two routes; B2 on special values;
the TAD path; TAD card vs CPU parity; then the kernels line, the
card's name and power limit, and the result line.
Imports nothing of JAX and nothing of the JAX package. Writes only
under the package's _build/ directories.
"""

from __future__ import annotations

import dataclasses
import json
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
    """Flows ordered by flowEndSeconds, as an exporter sends them, cut
    into TBLK blocks."""
    import numpy as np
    from theia_tpu_torch.data.synth import generate_flows
    from theia_tpu_torch.store import wire
    batch = generate_flows(cfg)
    order = np.argsort(batch["flowEndSeconds"], kind="stable")
    batch = batch.take(order)
    return [wire.encode_block(batch.take(np.arange(
        i, min(i + block_rows, len(batch)))))
        for i in range(0, len(batch), block_rows)]


# -- phase 4: the main path ---------------------------------------------

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
    latencies.sort()
    return {"rows": rows[0], "seconds": wall, "alerts": kinds,
            "alert_latency_s": {
                "n": len(latencies),
                "p50": latencies[len(latencies) // 2] if latencies
                else None,
                "max": latencies[-1] if latencies else None}}


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
    return got


def phase_parity(blocks, device) -> dict:
    """The parity stream on the card and on the CPU, one block per
    step; then once more on the card with TF32 matmuls allowed, as a
    control that the tolerance sees the precision it guards against
    (reported, not asserted)."""
    import torch
    cpu = score_stream(blocks, "cpu")
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

    parity = phase_parity(parity_blocks, device)
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
    del flows

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
    emit("done", seconds=time.perf_counter() - t_start)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
