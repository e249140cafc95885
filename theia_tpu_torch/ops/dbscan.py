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
builds the cube. `dbscan_scores` sends a CUDA tensor to B2 (in
float32, as the reference sends TPU work to its Pallas kernel) and a
CPU tensor to `dbscan_noise` (in x's dtype, as the reference's XLA
path on the CPU).
"""

from __future__ import annotations

import ctypes
import threading

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
#: B2 kernel launches since import (one per call that reached the
#: card); a call on CPU tensors runs the plain version and does not
#: count
launches = 0
_MAX_TILES = 65535      # the kernel's i-tiles ride gridDim.y
_TILE = 128


def _kernel_fn():
    from ._build import library
    fn = library("dbscan_noise").dbscan_noise_launch
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 2
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def dbscan_noise_cuda(x: torch.Tensor, mask: torch.Tensor,
                      eps: float = DEFAULT_EPS,
                      min_samples: int = DEFAULT_MIN_SAMPLES
                      ) -> torch.Tensor:
    """B2: noise flags [S, T] bool for a padded [S, T] batch, computed
    in float32.

    The counterpart of theia_tpu/ops/dbscan_pallas.py:57
    (`dbscan_noise_pallas`). CUDA tensors launch the kernel on the
    current stream (or raise); CPU tensors run the plain version,
    `dbscan_noise`, on x cast to float32. The module's `launches`
    counts kernel launches."""
    if x.dim() != 2 or mask.shape != x.shape:
        raise ValueError(f"dbscan_noise_cuda: x {tuple(x.shape)} and mask "
                         f"{tuple(mask.shape)}: expected two [S, T]")
    if x.device != mask.device:
        raise ValueError("dbscan_noise_cuda: x and mask must lie on one "
                         f"device, got {x.device} and {mask.device}")
    if x.device.type == "cpu":
        return dbscan_noise(x.float(), mask.bool(), eps, min_samples)
    if x.device.type != "cuda":
        raise ValueError(f"dbscan_noise_cuda: no kernel for {x.device}")
    s, t = x.shape
    if s == 0 or t == 0:
        return torch.zeros((s, t), dtype=torch.bool, device=x.device)
    if s * t >= 2 ** 31 or -(-t // _TILE) > _MAX_TILES:
        raise ValueError(f"dbscan_noise_cuda: [{s}, {t}] is beyond the "
                         "kernel's int32 indexing")
    xf = x.to(torch.float32).contiguous()
    m8 = mask.to(torch.uint8).contiguous()
    core = torch.empty((s, t), dtype=torch.uint8, device=x.device)
    noise = torch.empty((s, t), dtype=torch.bool, device=x.device)
    fn = _kernel_fn()
    with torch.cuda.device(x.device):
        err = fn(xf.data_ptr(), m8.data_ptr(), core.data_ptr(),
                 noise.data_ptr(), s, t, float(eps), int(min_samples),
                 torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"dbscan_noise kernel launch failed: CUDA "
                           f"error {err}")
    global launches
    with _launch_lock:
        launches += 1
    return noise


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
