"""Device meshes for the analytics jobs, and their collectives.

Ports theia_tpu/parallel/mesh.py. The reference scales its jobs by
adding Spark executor pods (SURVEY §2.7;
pkg/controller/networkpolicyrecommendation/controller.go:573-675
copies executorInstances into the SparkApplication spec); theia_tpu
runs them over a `jax.sharding.Mesh` of a slice's chips:

  * axis "series" — data parallelism over connections (the Spark
    executor axis): each device scores an independent slab of series.
  * axis "time"   — sequence parallelism over long series: the EWMA
    recurrence is associative, so it scans locally per shard and
    composes the shards' summaries in shard order.
  * axis "rows"   — data parallelism over flow-record blocks (the NPR
    DISTINCT, the spatial DBSCAN's row tiles).

The port drives the mesh from one controller: one process, one
thread, a grid of `torch.device`s. JAX's `shard_map` (the reference's
shim at theia_tpu/parallel/mesh.py:33) has no counterpart here: each
sharded step is written out as its phases — a loop over the shards,
then a collective, then a loop again. The collectives are plain
functions over the shards' tensors in shard order (`all_gather`,
`psum`): cross-device `.to()` copies, so the reduction order is fixed
and the result does not depend on which device finishes first. Kernel
launches on different cards from one host thread run asynchronously,
so the shards' work overlaps all the same.

A mesh may list one device several times: each entry is a logical
shard. The CPU tests build an 8-shard mesh on the CPU that way, and
the chip script a 4-shard mesh on one card. `engine.job_mesh()` never
builds such a mesh.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

SERIES_AXIS = "series"
TIME_AXIS = "time"
ROWS_AXIS = "rows"


class Mesh:
    """A grid of torch devices with named axes, read as the reference
    reads a `jax.sharding.Mesh`: `shape` maps each axis name to its
    size (in axis order), `devices` is the numpy grid (`.flatten()`,
    `.size`), `size` the shard count."""

    def __init__(self, devices: np.ndarray, axis_names: Sequence[str]):
        if devices.ndim != len(axis_names):
            raise ValueError(f"{devices.ndim}-d device grid for axes "
                             f"{tuple(axis_names)}")
        self.devices = devices
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, devices.shape))
        self.size = int(devices.size)
        self.key = (self.axis_names, devices.shape,
                    tuple(str(d) for d in devices.flat))

    def __eq__(self, other):
        return isinstance(other, Mesh) and self.key == other.key

    def __hash__(self):
        return hash(self.key)


def _grid(devs: Sequence, shape: Tuple[int, ...]) -> np.ndarray:
    grid = np.empty(len(devs), dtype=object)
    for i, d in enumerate(devs):
        grid[i] = torch.device(d)
    return grid.reshape(shape)


def _devices(n_devices: Optional[int], devices: Optional[Sequence]):
    """The mesh's devices: `devices` (any torch device specs, repeats
    allowed), default every visible card, cut to `n_devices`."""
    devs = list(devices) if devices is not None else [
        torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    if n_devices is not None:
        devs = devs[:n_devices]
    if not devs:
        raise ValueError("a mesh needs at least one device (no CUDA card "
                         "is visible; pass devices=)")
    return devs


def make_mesh(n_devices: Optional[int] = None,
              time_shards: int = 1,
              devices: Optional[Sequence] = None) -> Mesh:
    """A (series × time) mesh over `n_devices` (default: all visible
    cards, or `devices`).

    time_shards must divide the device count; time_shards=1 degenerates
    to pure series data parallelism.
    """
    devs = _devices(n_devices, devices)
    n = len(devs)
    if n % time_shards != 0:
        raise ValueError(
            f"time_shards {time_shards} must divide device count {n}")
    return Mesh(_grid(devs, (n // time_shards, time_shards)),
                (SERIES_AXIS, TIME_AXIS))


def make_rows_mesh(n_devices: Optional[int] = None,
                   devices: Optional[Sequence] = None) -> Mesh:
    """A 1-D `rows` mesh — data parallelism over flow-record blocks
    (the NPR job's distinct/support-count shuffle axis)."""
    devs = _devices(n_devices, devices)
    return Mesh(_grid(devs, (len(devs),)), (ROWS_AXIS,))


def pad_to_multiple(arr: np.ndarray, multiple: int, axis: int,
                    fill=0) -> Tuple[np.ndarray, int]:
    """Pad `axis` up to a multiple; returns (padded, original size)."""
    size = arr.shape[axis]
    target = -(-size // multiple) * multiple if size else multiple
    if target == size:
        return arr, size
    pad = [(0, 0)] * arr.ndim
    pad[axis] = (0, target - size)
    return np.pad(arr, pad, constant_values=fill), size


# -- collectives over the shards of one axis, in shard order ------------

def all_gather(parts: List[torch.Tensor], dim: int = 0
               ) -> List[torch.Tensor]:
    """jax.lax.all_gather (tiled): every shard gets the shards' blocks
    concatenated along `dim` in shard order, on its own device. Shards
    on one device share one copy."""
    by_device = {}
    out = []
    for p in parts:
        if p.device not in by_device:
            by_device[p.device] = torch.cat(
                [q.to(p.device) for q in parts], dim=dim)
        out.append(by_device[p.device])
    return out


def psum(parts: List[torch.Tensor]) -> List[torch.Tensor]:
    """jax.lax.psum: the shards' partials summed in shard order (on the
    first shard's device), then copied onto each shard's device."""
    total = parts[0]
    for p in parts[1:]:
        total = total + p.to(total.device)
    return [total.to(p.device) for p in parts]
