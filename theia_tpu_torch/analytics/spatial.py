"""Spatial anomaly detection over flow embeddings.

The BASELINE north-star config 3: "DBSCAN spatial anomaly on
(srcIP, dstIP, dstPort, bytes) embeddings". Flows embed into a 4-D
feature space — categorical identities (source, destination, port)
hash to pseudo-random coordinates so distance means same/different,
volume contributes a log-scaled continuous axis — and the blocked
spatial DBSCAN kernel (ops/dbscan.py dbscan_points_noise) marks the
flows that belong to no recurring traffic pattern as noise.

A clustered flow = a pattern seen many times (same endpoints/port,
similar volume); noise = one-off combinations — exfiltration probes,
scans, misconfigurations. The reference has DBSCAN only over per-
connection 1-D throughput series; this is the cross-flow spatial
variant its benchmark config names.

Ports theia_tpu/analytics/spatial.py: the embedding is the reference's
numpy code, verbatim; the pairwise pass runs on `device=` (default
"cuda") through the port's `ops.dbscan.dbscan_points_noise`, or over
a mesh (parallel.make_sharded_points_dbscan). Only `spatial_outliers`
and `run_spatial` differ: they take `device=` for the one-device pass,
and `spatial_outliers` times its copy to the device, the result's fetch
and the noise flows' decode as spans (`sad.to_device`, `sad.fetch`,
`sad.decode`, obs/trace.py). `run_spatial` reads only SPATIAL_COLUMNS
from the store, in a `sad.read` span.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from ..obs import trace as _trace
from ..ops.dbscan import dbscan_points_noise
from ..schema import ColumnarBatch
from ..utils.device import auto_mesh, resolve_device

# Categorical axes are scaled so ANY identity mismatch dominates a
# volume difference: hash coordinates in [0, SCALE) with SCALE >> eps.
# Each identity gets TWO independent hash coordinates: a single axis
# collides two distinct identities with probability ~2·eps/SCALE (~2%),
# which would silently merge clusters; two axes square that to ~1e-4.
# (f32 d² cancellation caps SCALE itself at ~1e2 for eps=1.)
CATEGORICAL_SCALE = 100.0
DEFAULT_EPS = 1.0
DEFAULT_MIN_SAMPLES = 4

EMBED_DIM = 7   # 2 src + 2 dst + 2 port + volume

#: the flow columns the embedding and the noise rows read: the job
#: asks the store for these alone (4 of the schema's 52)
SPATIAL_COLUMNS = ("sourceIP", "destinationIP",
                   "destinationTransportPort", "octetDeltaCount")


def _hash01(codes: np.ndarray, seed: int) -> np.ndarray:
    """Integer codes → deterministic pseudo-random floats in [0, 1)."""
    h = codes.astype(np.uint32) ^ np.uint32(seed)
    h ^= h >> 16
    h = (h * np.uint32(0x85EBCA6B)) & np.uint32(0xFFFFFFFF)
    h ^= h >> 13
    h = (h * np.uint32(0xC2B2AE35)) & np.uint32(0xFFFFFFFF)
    h ^= h >> 16
    return h.astype(np.float64) / 4294967296.0


def flow_embeddings(flows: ColumnarBatch) -> np.ndarray:
    """[n, 7] float32 (src×2, dst×2, port×2, log-bytes) embedding."""
    axes = []
    for col in ("sourceIP", "destinationIP",
                "destinationTransportPort"):
        codes = np.asarray(flows[col], np.int64)
        for seed in (0x1234ABCD, 0x9E3779B9):
            axes.append(_hash01(codes, seed) * CATEGORICAL_SCALE)
    axes.append(np.log1p(
        np.asarray(flows["octetDeltaCount"], np.float64)))
    return np.stack(axes, axis=1).astype(np.float32)


def spatial_outliers(flows: ColumnarBatch,
                     eps: float = DEFAULT_EPS,
                     min_samples: int = DEFAULT_MIN_SAMPLES,
                     block: int = 1024,
                     mesh=None,
                     embeddings: Optional[np.ndarray] = None,
                     device="cuda"
                     ) -> List[Dict[str, object]]:
    """Flows outside every recurring traffic pattern. Returns one dict
    per noise flow: decoded source/destination/port/bytes. The
    pairwise pass runs on `device`; with `mesh`, it shards rows over
    the mesh with all_gathered points/core-flags
    (parallel.make_sharded_points_dbscan). `embeddings` lets a caller
    that already embedded the flows (run_spatial's staged progress)
    skip recomputation."""
    n = len(flows)
    if n == 0:
        return []
    emb = embeddings if embeddings is not None \
        else flow_embeddings(flows)
    if mesh is not None:
        from ..parallel import make_sharded_points_dbscan, \
            pad_to_multiple
        from ..parallel.mesh import ROWS_AXIS, make_rows_mesh
        if ROWS_AXIS not in mesh.axis_names:
            # job_mesh() hands out the (series x time) job mesh; the
            # points kernel shards tile ROWS — rebuild over the same
            # devices with the rows axis.
            mesh = make_rows_mesh(devices=mesh.devices.flatten())
        n_dev = mesh.devices.size
        padded, _ = pad_to_multiple(emb, n_dev, axis=0)
        valid = np.zeros(len(padded), bool)
        valid[:n] = True
        flags = make_sharded_points_dbscan(
            mesh, eps=eps, min_samples=min_samples, block=block)(
            padded, valid)
        with _trace.span("sad.fetch", rows=n):
            noise = flags.cpu().numpy()[:n]
    else:
        dev = resolve_device(device)
        with _trace.span("sad.to_device", rows=n):
            points = torch.from_numpy(np.ascontiguousarray(emb)).to(dev)
            valid = torch.ones(n, dtype=torch.bool, device=dev)
        flags = dbscan_points_noise(points, valid, eps=eps,
                                    min_samples=min_samples, block=block)
        with _trace.span("sad.fetch", rows=n):
            noise = flags.cpu().numpy()
    with _trace.span("sad.decode") as sp:
        idx = np.nonzero(noise)[0]
        sp.attrs["flows"] = len(idx)
        src = flows.strings("sourceIP")
        dst = flows.strings("destinationIP")
        port = np.asarray(flows["destinationTransportPort"])
        octets = np.asarray(flows["octetDeltaCount"])
        return [{"sourceIP": str(src[i]), "destinationIP": str(dst[i]),
                 "destinationTransportPort": int(port[i]),
                 "octetDeltaCount": int(octets[i])} for i in idx]


def run_spatial(db,
                eps: float = DEFAULT_EPS,
                min_samples: int = DEFAULT_MIN_SAMPLES,
                start_time=None,
                end_time=None,
                spatial_id=None,
                mesh="auto",
                now=None,
                progress=None,
                device="cuda") -> str:
    """Execute a spatial anomaly-detection job over the flow store;
    writes one row per noise flow to the `spatialnoise` table and
    returns the detection id.

    The user-facing form of the north-star spatial-DBSCAN config — a
    job kind beside TAD/NPR (the reference's DBSCAN is per-connection
    1-D throughput only, plugins/anomaly-detection/
    anomaly_detection.py:325-349). mesh="auto" shards the pairwise
    pass over every visible card when `device` is a card
    (utils.device.auto_mesh); without a mesh it runs on `device`.
    """
    import time as _time
    import uuid as _uuid

    spatial_id = spatial_id or str(_uuid.uuid4())
    if mesh == "auto":
        mesh = auto_mesh(device)
    if mesh is None:
        resolve_device(device)

    if progress:
        progress.stage("read")
    with _trace.span("sad.read", columns=len(SPATIAL_COLUMNS)) as sp:
        flows = db.flows.select(start_time, end_time,
                                columns=SPATIAL_COLUMNS)
        sp.attrs["rows"] = len(flows)
    if len(flows) == 0:
        if progress:
            progress.done()
        return spatial_id

    if progress:
        progress.stage("embed")
    emb = flow_embeddings(flows)

    if progress:
        progress.stage("score")
    outliers = spatial_outliers(flows, eps=eps,
                                min_samples=min_samples, mesh=mesh,
                                embeddings=emb, device=device)

    if progress:
        progress.stage("write")
    created = int(now if now is not None else _time.time())
    rows = [{**o, "id": spatial_id, "timeCreated": created}
            for o in outliers]
    if rows:
        db.spatialnoise.insert_rows(rows)
    if progress:
        progress.done()
    return spatial_id
