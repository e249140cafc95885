"""Job-level mesh selection: route production jobs onto every visible
card.

Ports theia_tpu/parallel/engine.py: `job_mesh()` counts the visible
CUDA cards (`torch.cuda.device_count()`) where the reference counts
`jax.devices()`, so on one card, or on the CPU, it answers None and
the jobs keep the plain one-device path. `cached_kernel` memoizes the
sharded step closures (there is nothing to trace in eager PyTorch; the
memo keeps the callers as the reference's read).

The reference scales its production jobs by raising
`executorInstances` on the SparkApplication spec
(pkg/controller/networkpolicyrecommendation/controller.go:573-675);
nothing in the job itself changes. Here `job_mesh()` inspects the
visible cards once and hands the analytics jobs a `parallel.mesh.Mesh`
to score over — `run_tad` / `run_npr` call it by default, so the same
manager-API job that runs on one device on a one-card host runs
sharded on a multi-card host with no spec change.

Env switches:
  THEIA_MESH=off    — force single-device even on a multi-chip host
  THEIA_MESH=auto   — (default) all visible devices when >1
  THEIA_MESH=<N>    — first N visible devices
"""

from __future__ import annotations

import os
import threading
from typing import Callable, Dict, Optional, Tuple

import torch

from .mesh import Mesh, make_mesh
from ..analysis.lockdep import named_lock

_lock = named_lock("parallel.engine")
_cache: Dict[str, Optional[Mesh]] = {}
# Sharded step closures are cached per (mesh, kernel, params), as the
# reference caches its jitted shard_map builders.
_fn_cache: Dict[Tuple, Callable] = {}


def job_mesh() -> Optional[Mesh]:
    """The mesh production jobs should score over, or None for the
    plain single-device path. Resolved once per THEIA_MESH value."""
    setting = os.environ.get("THEIA_MESH", "auto").strip().lower()
    with _lock:
        if setting in _cache:
            return _cache[setting]
    if setting in ("off", "0", "none", "false"):
        mesh = None
    else:
        n = torch.cuda.device_count()
        if setting not in ("auto", ""):
            try:
                n = min(n, max(1, int(setting)))
            except ValueError:
                raise ValueError(
                    f"invalid THEIA_MESH={setting!r}: expected 'off', "
                    f"'auto', or a device count N") from None
        mesh = make_mesh(n) if n > 1 else None
    with _lock:
        _cache[setting] = mesh
    return mesh


def cached_kernel(key: Tuple, build: Callable[[], Callable]) -> Callable:
    """Memoize a jitted shard_map kernel under a hashable key."""
    with _lock:
        fn = _fn_cache.get(key)
    if fn is None:
        fn = build()
        with _lock:
            _fn_cache[key] = fn
    return fn


def reset_cache() -> None:
    """Test hook: drop memoized meshes/kernels (e.g. after changing
    THEIA_MESH or the visible device set)."""
    with _lock:
        _cache.clear()
        _fn_cache.clear()
