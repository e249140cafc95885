"""Device meshes and sharded scoring (ports theia_tpu/parallel/, one
controller driving a grid of torch devices: see mesh.py)."""

from .engine import cached_kernel, job_mesh, reset_cache
from .mesh import (
    ROWS_AXIS,
    SERIES_AXIS,
    TIME_AXIS,
    make_mesh,
    make_rows_mesh,
    pad_to_multiple,
)
from .tad_sharded import (
    make_sharded_arima,
    make_sharded_dbscan,
    make_sharded_ewma,
    make_sharded_points_dbscan,
    shard_arrays,
)

__all__ = [
    "ROWS_AXIS", "SERIES_AXIS", "TIME_AXIS", "make_mesh",
    "make_rows_mesh", "pad_to_multiple", "cached_kernel", "job_mesh",
    "reset_cache", "make_sharded_arima", "make_sharded_dbscan",
    "make_sharded_ewma", "make_sharded_points_dbscan", "shard_arrays",
]
