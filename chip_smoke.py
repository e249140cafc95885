#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (theia_tpu_torch).

    python3 chip_smoke.py

Needs one CUDA card and the CUDA toolkit (nvcc). Drives the port's
live ingest-and-score path — TBLK blocks → wire.decode_block →
IngestManager.score_batch (fused engine, 8 shards, the reference's
default detector sizes) → push_alert — and holds every kernel of that
path against its plain PyTorch version on the card. Each phase prints
one JSON line; any failure raises and the script exits non-zero. The
last line of standard output is

    {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}

Phases: 1 device, 2 build, 3 kernel vs plain, 4 main path, 5 card vs
CPU parity, 6 the kernels line, 7 the result line. Imports nothing
of JAX and nothing of the JAX package. Writes only under the
package's _build/ directory.
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
    launches = fd.launches
    anom_k = fd.stream_scan(s_k, slots, x, active)
    anom_p = fd._stream_half_plain(s_p, slots, x, active, 0.5)
    fd.launches = launches   # comparison launches don't count
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
        fd.launches = launches
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
        fd.launches = 0
        run = drive(im, blocks)
        launches = fd.launches
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
    if device.type == "cuda" and (launches < steps or launches != n_tiles):
        raise AssertionError(
            f"B1 launched {launches} times over {steps} fused steps "
            f"({n_tiles} shard tiles): the main path did not go "
            "through the kernel")

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
        "b1_launches": launches,
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

    from theia_tpu_torch.ops import _build
    t0 = time.perf_counter()
    _build.library("stream_scan")
    emit("build", kernel="stream_scan", seconds=time.perf_counter() - t0)

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

    # B1's numbers at the main path's modal tile shape.
    import numpy as np
    modal = main["modal_tile"]
    at_main = compare_scan(np.random.default_rng(99), modal["T"],
                           modal["U"], modal["live"], device)
    kernels = [{
        "name": "B1 stream_scan", "route": "cuda",
        "source": "theia_tpu_torch/csrc/stream_scan.cu",
        "replaces": "theia_tpu/ops/fused_detector.py:93",
        "tpu": "theia_tpu/ops/fused_detector.py::_scan_tile_pallas",
        "launches": main["b1_launches"],
        "matches_plain": all(r["bit_exact"] for r in scan_rows)
        and at_main["bit_exact"],
        "max_abs_err": max(r["max_abs_err"]
                           for r in scan_rows + [at_main]),
        "shape": {"T": modal["T"], "U": modal["U"],
                  "live": modal["live"], "capacity": CAPACITY},
        "ms": at_main["ms"], "plain_ms": at_main["plain_ms"],
        "bound_ms": at_main["bound_ms"], "bound_by": at_main["bound_by"],
        "library_ms": None,
    }]
    emit("done", seconds=time.perf_counter() - t_start)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
