"""One fused scoring step for the device-resident hot path.

Ports theia_tpu/ops/fused_detector.py. One step scores every shard's
coalesced slice of a micro-batch: EWMA update + Welford band (the
stream half), CMS heavy-hitter update and query, and a k-means step,
shard after shard, with per-shard state kept on the device between
steps.

The stream half is kernel B1 (`stream_scan`, csrc/stream_scan.cu): the
gather of the tile's state rows, the T-tick scan and the scatter back,
fused into one CUDA kernel. It replaces the TPU kernel
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
are freshly allocated: the fused engine reads them one step later.

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
from typing import NamedTuple, Sequence, Tuple

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

_launch_lock = threading.Lock()
#: B1 kernel launches since import; only a launch counts (a call on
#: CPU tensors runs the plain version)
launches = 0


def _kernel_fn():
    from ._build import library
    fn = library("stream_scan").stream_scan_launch
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 8
                       + [ctypes.c_int] * 3
                       + [ctypes.c_float] * 2
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def _check_tile(stream: StreamState, slots: torch.Tensor,
                x: torch.Tensor, active: torch.Tensor) -> None:
    dev = slots.device
    tensors = (*stream, slots, x, active)
    if any(t.device != dev for t in tensors):
        raise ValueError("stream_scan: state and tile must lie on one "
                         f"device, got {[str(t.device) for t in tensors]}")
    want = (torch.float32, torch.int32, torch.float32, torch.float32,
            torch.int32, torch.float32, torch.bool)
    got = tuple(t.dtype for t in tensors)
    if got != want:
        raise TypeError(f"stream_scan: dtypes {got}, expected {want}")
    cap = stream.count.shape[0]
    if any(a.shape != (cap,) for a in stream):
        raise ValueError("stream_scan: state vectors must all be "
                         f"[{cap}], got {[tuple(a.shape) for a in stream]}")
    if x.dim() != 2 or x.shape != active.shape \
            or slots.shape != (x.shape[1],):
        raise ValueError(
            f"stream_scan: x {tuple(x.shape)}, active "
            f"{tuple(active.shape)}, slots {tuple(slots.shape)}: "
            "expected [T, U], [T, U], [U]")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("stream_scan: tensors must be contiguous")


def stream_scan(stream: StreamState, slots: torch.Tensor,
                x: torch.Tensor, active: torch.Tensor,
                alpha: float = DEFAULT_ALPHA) -> torch.Tensor:
    """B1: advance the rows `slots` of `stream` (in place) through the
    ticks of the [T, U] tile; returns the anomaly flags [T, U] bool.

    CUDA tensors launch the kernel on the current stream (or raise);
    CPU tensors run `_stream_half_plain`. The module's `launches`
    counts kernel launches."""
    _check_tile(stream, slots, x, active)
    if slots.device.type == "cpu":
        return _stream_half_plain(stream, slots, x, active, alpha)
    if slots.device.type != "cuda":
        raise ValueError(f"stream_scan: no kernel for {slots.device}")
    t, u = x.shape
    anom = torch.empty((t, u), dtype=torch.bool, device=slots.device)
    fn = _kernel_fn()
    with torch.cuda.device(slots.device):
        err = fn(stream.ewma.data_ptr(), stream.count.data_ptr(),
                 stream.mean.data_ptr(), stream.m2.data_ptr(),
                 slots.data_ptr(), x.data_ptr(), active.data_ptr(),
                 anom.data_ptr(), t, u, stream.count.shape[0],
                 float(alpha), 1.0 - float(alpha),
                 torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"stream_scan kernel launch failed: CUDA "
                           f"error {err}")
    global launches
    with _launch_lock:
        launches += 1
    return anom


# -- the fused step -----------------------------------------------------

def _shard_step(state: ShardStepState, inp: ShardInputs, alpha
                ) -> Tuple[ShardStepState, ShardOutputs]:
    anomaly = stream_scan(state.stream, inp.slots, inp.x, inp.active,
                          alpha)
    cms = cms_update(state.cms, inp.keys, inp.vols)
    est = cms_query(cms, inp.q)
    km, _, dist = kmeans_step(state.km, inp.feats, inp.valid)
    return (ShardStepState(state.stream, cms, km),
            ShardOutputs(anomaly, est, cms.total, dist))


def fused_step(states: Tuple[ShardStepState, ...],
               inputs: Tuple[ShardInputs, ...],
               alpha: float = DEFAULT_ALPHA
               ) -> Tuple[Tuple[ShardStepState, ...],
                          Tuple[ShardOutputs, ...]]:
    """Score every shard's coalesced slice: per-shard state in,
    per-shard (state', outputs) out. Launches are enqueued on the
    current stream and nothing waits for them here."""
    pairs = tuple(_shard_step(s, i, alpha)
                  for s, i in zip(states, inputs))
    return tuple(p[0] for p in pairs), tuple(p[1] for p in pairs)


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
