"""One fused scoring step for the device-resident hot path.

Ports theia_tpu/ops/fused_detector.py. One step scores every shard's
coalesced slice of a micro-batch: EWMA update + Welford band (the
stream half), CMS heavy-hitter update and query, and a k-means step,
with per-shard state kept on the device between steps.

The stream half is kernel B1 (`stream_scan_grouped`,
csrc/stream_scan.cu): the gather of each tile's state rows, the T-tick
scan and the scatter back, fused into one CUDA kernel that takes every
shard's tile of a step in one launch. It replaces the TPU kernel
`theia_tpu/ops/fused_detector.py::_scan_tile_pallas` and the gather and
scatter around it. On a CUDA tensor the wrapper launches the kernel or
raises; on a CPU tensor it runs the plain version beside it
(`_stream_half_plain`). There is no fallback from one to the other.
The CMS and k-means halves are plain torch ops, as they are XLA ops in
the reference.

State: the per-connection StreamState is updated IN PLACE (the kernel
writes the rows back through `slots`), so a ShardStepState's `stream`
tensors are the same objects before and after a step. CMS and k-means
state are returned new, as in the reference. Each step's ShardOutputs
are freshly allocated (the anomaly flags of all shards as views of one
allocation): the fused engine reads them one step later.

Padding slots hold `capacity`. The reference's XLA gather clamps them
and its scatter drops them; here they are masked explicitly (torch
raises on an out-of-range index): a padding column starts from a zero
state and writes nothing back. Its anomaly flags are never read
(row_idx is -1 there) and are false whenever its ticks are inactive,
which build_plan guarantees.
"""

from __future__ import annotations

import ctypes
import threading
from typing import List, NamedTuple, Sequence, Tuple

import numpy as np
import torch

from ..analytics.streaming import StreamState, _update as _stream_tick
from .ewma import DEFAULT_ALPHA
from .sketch import (
    CmsState,
    KMeansState,
    cms_query,
    cms_update,
    kmeans_step,
)


class ShardInputs(NamedTuple):
    """One shard's coalesced micro-batch slice on the device (streaming
    tile from StreamingDetector.build_plan, heavy-hitter arrays from
    heavy_hitters.build_hh_plan)."""
    slots: torch.Tensor   # [U_pad] int32 state slots (capacity = pad)
    x: torch.Tensor       # [T_pad, U_pad] float32 values
    active: torch.Tensor  # [T_pad, U_pad] bool
    keys: torch.Tensor    # [size] int32 (uint32 bits) CMS keys
    vols: torch.Tensor    # [size] float32 volumes
    q: torch.Tensor       # [q_size] int32 (uint32 bits) query keys
    feats: torch.Tensor   # [size, F] float32 k-means features
    valid: torch.Tensor   # [size] bool


class ShardStepState(NamedTuple):
    """One shard's device-resident detector state between micro-batches."""
    stream: StreamState
    cms: CmsState
    km: KMeansState


class ShardOutputs(NamedTuple):
    anomaly: torch.Tensor  # [T_pad, U_pad] bool streaming anomalies
    est: torch.Tensor      # [q_size] float32 sketched volume per query
    total: torch.Tensor    # scalar float32 post-update sketch total
    dist: torch.Tensor     # [size] float32 distance to assigned centroid


# -- B1: the plain version ----------------------------------------------

def _scan_tile(sub: StreamState, x: torch.Tensor, active: torch.Tensor,
               alpha) -> Tuple[StreamState, torch.Tensor]:
    """Tick scan over an already-gathered slot subset: the torch
    `_update` applied tick by tick (the reference's lax.scan)."""
    anomalies = []
    for t in range(x.shape[0]):
        sub, anom = _stream_tick(sub, x[t], active[t], alpha)
        anomalies.append(anom)
    return sub, torch.stack(anomalies)


def _stream_half_plain(stream: StreamState, slots: torch.Tensor,
                       x: torch.Tensor, active: torch.Tensor,
                       alpha) -> torch.Tensor:
    """Masked gather, tick scan, masked scatter — what B1 computes, in
    plain torch ops. Updates `stream` in place; returns anomaly
    [T, U]."""
    cap = stream.count.shape[0]
    live = (slots >= 0) & (slots < cap)
    idx = torch.where(live, slots, torch.zeros_like(slots)).long()
    sub = StreamState(*(torch.where(live, a[idx], torch.zeros_like(a[idx]))
                        for a in stream))
    sub, anomalies = _scan_tile(sub, x, active, alpha)
    rows = idx[live]
    for full, part in zip(stream, sub):
        full[rows] = part[live]
    return anomalies


# -- B1: the kernel wrapper ---------------------------------------------

#: One stream-half tile: (state, slots [U], x [T, U], active [T, U]).
ScanTile = Tuple[StreamState, torch.Tensor, torch.Tensor, torch.Tensor]

#: tiles one launch takes (the kernel's parameter struct holds this
#: many); more are launched in chunks
MAX_TILES = 16
#: threads per block: each tile takes ceil(U / THREADS) blocks
THREADS = 256

_launch_lock = threading.Lock()
#: B1 kernel launches since import; only a launch counts (a call on
#: CPU tensors runs the plain version)
launches = 0
#: tiles scored by the kernel since import (a launch scores up to
#: MAX_TILES)
tiles = 0


def _kernel_fn():
    from ._build import library
    lib = library("stream_scan")
    fn = lib.stream_scan_grouped_launch
    if fn.argtypes is None:
        if (lib.stream_scan_max_tiles(), lib.stream_scan_threads()) != \
                (MAX_TILES, THREADS):
            raise RuntimeError("stream_scan: the library's tile limit or "
                               "block size differs from the wrapper's")
        i32 = ctypes.POINTER(ctypes.c_int32)
        fn.argtypes = ([ctypes.POINTER(ctypes.c_int64)] + [i32] * 4
                       + [ctypes.c_int, ctypes.c_float, ctypes.c_float,
                          ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


#: dtypes of a tile's ewma, count, mean, m2, slots, x, active
_DTYPES = (torch.float32, torch.int32, torch.float32, torch.float32,
           torch.int32, torch.float32, torch.bool)


def _check_tile(stream: StreamState, slots: torch.Tensor,
                x: torch.Tensor, active: torch.Tensor,
                dev: torch.device) -> Tuple[int, int, int]:
    """Raise on what the kernel does not take; returns (T, U,
    capacity). Every tensor lies on `dev`."""
    tensors = (*stream, slots, x, active)
    for t, want in zip(tensors, _DTYPES):
        if t.dtype != want:
            raise TypeError(f"stream_scan: dtypes "
                            f"{tuple(a.dtype for a in tensors)}, "
                            f"expected {_DTYPES}")
        if t.device != dev:
            raise ValueError(
                "stream_scan: state and tiles must lie on one device, got "
                f"{[str(a.device) for a in tensors]} and {dev}")
        if not t.is_contiguous():
            raise ValueError("stream_scan: tensors must be contiguous")
    cap = stream.count.shape[0]
    if any(a.shape != (cap,) for a in stream):
        raise ValueError("stream_scan: state vectors must all be "
                         f"[{cap}], got {[tuple(a.shape) for a in stream]}")
    shape = x.shape
    if len(shape) != 2 or active.shape != shape \
            or slots.shape != (shape[1],):
        raise ValueError(
            f"stream_scan: x {tuple(shape)}, active "
            f"{tuple(active.shape)}, slots {tuple(slots.shape)}: "
            "expected [T, U], [T, U], [U]")
    return shape[0], shape[1], cap


def _check_disjoint(spans: Sequence[Tuple[int, int, int]]) -> None:
    """Raise if two tiles' state arrays overlap in memory: one launch
    scores every tile at once, so two tiles writing one row would race.
    `spans` are (first byte, end byte, tile) of every state array."""
    # sweep by start: the largest end so far, its tile, and the largest
    # end of any other tile
    top, top_k, other = -1, -1, -1
    for begin, end, k in sorted(spans):
        if begin < (top if k != top_k else other):
            raise ValueError(f"stream_scan: tile {k} shares state memory "
                             "with another tile")
        if end > top:
            if k != top_k:
                other = top
            top, top_k = end, k
        elif k != top_k:
            other = max(other, end)


def _group_plan(shapes: Sequence[Tuple[int, int]]
                ) -> List[Tuple[List[int], List[int]]]:
    """The launches for tiles of shapes [(T, U), ...]: chunks of at most
    MAX_TILES tiles with work (T, U > 0), each as (tile indices, first
    blocks), where a tile's first block is the sum of ceil(U / THREADS)
    over the chunk's tiles before it and the last entry is the grid
    size."""
    work = [k for k, (t, u) in enumerate(shapes) if t > 0 and u > 0]
    plan = []
    for c in range(0, len(work), MAX_TILES):
        idx = work[c:c + MAX_TILES]
        first = [0]
        for k in idx:
            first.append(first[-1] - (-shapes[k][1] // THREADS))
        plan.append((idx, first))
    return plan


def stream_scan_grouped(group: Sequence[ScanTile],
                        alpha: float = DEFAULT_ALPHA) -> List[torch.Tensor]:
    """B1 over several tiles at once: advance each tile's rows `slots`
    of its state (in place) through the ticks of its [T, U] tile;
    returns each tile's anomaly flags [T, U] bool.

    CUDA tensors launch the kernel on the current stream, one launch
    per MAX_TILES tiles (or raise); CPU tensors run `_stream_half_plain`
    tile by tile. The flags of every tile are views of one fresh
    allocation. Tiles whose state arrays overlap are refused. The
    module's `launches` counts kernel launches and `tiles` the tiles
    they scored."""
    if not group:
        return []
    dev = group[0][1].device
    dims = [_check_tile(*tile, dev) for tile in group]
    # every state array is [capacity] of a 4-byte dtype
    ptrs = [[a.data_ptr() for a in (*state, slots, x, active)]
            for state, slots, x, active in group]
    _check_disjoint([(p, p + 4 * dims[k][2], k)
                     for k, tile_ptrs in enumerate(ptrs)
                     for p in tile_ptrs[:4]])
    if dev.type == "cpu":
        return [_stream_half_plain(*tile, alpha) for tile in group]
    if dev.type != "cuda":
        raise ValueError(f"stream_scan: no kernel for {dev}")
    flat = torch.empty(sum(t * u for t, u, _ in dims), dtype=torch.bool,
                       device=dev)
    anoms, offset, base = [], 0, flat.data_ptr()
    for (t, u, _), tile_ptrs in zip(dims, ptrs):
        anoms.append(torch.as_strided(flat, (t, u), (u, 1), offset))
        tile_ptrs.append(base + offset)
        offset += t * u
    fn = _kernel_fn()
    n_launches = n_tiles = 0
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        for idx, first in _group_plan([d[:2] for d in dims]):
            n = len(idx)
            err = fn((ctypes.c_int64 * (8 * n))(
                         *(p for k in idx for p in ptrs[k])),
                     *((ctypes.c_int32 * n)(*(dims[k][j] for k in idx))
                       for j in range(3)),
                     (ctypes.c_int32 * (n + 1))(*first), n,
                     float(alpha), 1.0 - float(alpha), stream)
            if err != 0:
                raise RuntimeError(f"stream_scan kernel launch failed: "
                                   f"CUDA error {err}")
            n_launches += 1
            n_tiles += n
    global launches, tiles
    with _launch_lock:
        launches += n_launches
        tiles += n_tiles
    return anoms


def stream_scan(stream: StreamState, slots: torch.Tensor,
                x: torch.Tensor, active: torch.Tensor,
                alpha: float = DEFAULT_ALPHA) -> torch.Tensor:
    """B1 on one tile: advance the rows `slots` of `stream` (in place)
    through the ticks of the [T, U] tile; returns the anomaly flags
    [T, U] bool. A one-tile `stream_scan_grouped`."""
    return stream_scan_grouped([(stream, slots, x, active)], alpha)[0]


# -- the fused step -----------------------------------------------------

def fused_step(states: Tuple[ShardStepState, ...],
               inputs: Tuple[ShardInputs, ...],
               alpha: float = DEFAULT_ALPHA
               ) -> Tuple[Tuple[ShardStepState, ...],
                          Tuple[ShardOutputs, ...]]:
    """Score every shard's coalesced slice: per-shard state in,
    per-shard (state', outputs) out. Every shard's stream half goes to
    B1 in one grouped launch; then each shard's CMS and k-means halves
    (they touch other state, so the order changes no result). Launches
    are enqueued on the current stream and nothing waits for them
    here."""
    anomalies = stream_scan_grouped(
        [(s.stream, i.slots, i.x, i.active)
         for s, i in zip(states, inputs)], alpha)
    new_states, outputs = [], []
    for state, inp, anomaly in zip(states, inputs, anomalies):
        cms = cms_update(state.cms, inp.keys, inp.vols)
        est = cms_query(cms, inp.q)
        km, _, dist = kmeans_step(state.km, inp.feats, inp.valid)
        new_states.append(ShardStepState(state.stream, cms, km))
        outputs.append(ShardOutputs(anomaly, est, cms.total, dist))
    return tuple(new_states), tuple(outputs)


def gather_state(state: StreamState, slots: torch.Tensor) -> StreamState:
    """Pull `slots` rows of per-connection state. Padding slots carry
    `capacity`; like the reference's XLA gather they read the clamped
    last row, and the caller slices them away."""
    idx = torch.clamp(slots.long(), max=state.count.shape[0] - 1)
    return StreamState(*(a[idx] for a in state))


def restore_state(state: StreamState, slots: torch.Tensor,
                  ewma: torch.Tensor, count: torch.Tensor,
                  mean: torch.Tensor, m2: torch.Tensor) -> StreamState:
    """Write state rows into `slots`, in place, and return `state`.
    Padding slots carry `capacity` and are dropped, as the reference's
    scatter drops them. Zero rows double as slot re-initialization."""
    live = slots < state.count.shape[0]
    rows = slots[live].long()
    for full, part in zip(state, (ewma, count, mean, m2)):
        full[rows] = part[live].to(full.dtype)
    return state


# -- state carried across from the reference ----------------------------

def shard_state_from_numpy(stream: Sequence, cms: Sequence,
                           km: Sequence, device) -> ShardStepState:
    """The reference's StreamState / CmsState / KMeansState, given as
    numpy arrays in field order, as the port's tensors on `device`
    (no default: the caller names the card or the CPU)."""
    ewma, count, mean, m2 = (np.asarray(a) for a in stream)
    counts, total = (np.asarray(a) for a in cms)
    centroids, km_counts = (np.asarray(a) for a in km)

    def t(a, dtype):
        return torch.as_tensor(np.array(a, dtype=dtype), device=device)

    return ShardStepState(
        StreamState(t(ewma, np.float32), t(count, np.int32),
                    t(mean, np.float32), t(m2, np.float32)),
        CmsState(t(counts, np.float32), t(total, np.float32)),
        KMeansState(t(centroids, np.float32), t(km_counts, np.float32)))


def shard_state_to_numpy(state: ShardStepState
                         ) -> Tuple[Tuple[np.ndarray, ...], ...]:
    """Inverse of `shard_state_from_numpy`: ((ewma, count, mean, m2),
    (counts, total), (centroids, counts)) as numpy arrays."""
    return tuple(tuple(a.detach().cpu().numpy() for a in part)
                 for part in state)
