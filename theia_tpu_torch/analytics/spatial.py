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

Ports theia_tpu/analytics/spatial.py: `flow_embeddings` is the
reference's numpy code, verbatim, and stays as the plain reference of
the embedding; the job embeds on its device instead
(`device_embeddings`: the four columns copied as they are, then
ops/embed.py's kernel on a card or its plain version on the CPU), on
the mesh's first device when a mesh runs. The pairwise pass runs on
`device=` (default "cuda") through the port's
`ops.dbscan.dbscan_points_noise`, or over a mesh
(parallel.make_sharded_points_dbscan). Only `spatial_outliers` and
`run_spatial` differ: they take `device=` for the one-device pass, and
time the columns' copy to the device, the result's fetch and the noise
flows' decode as spans (`sad.to_device`, `sad.fetch`, `sad.decode`,
obs/trace.py). `run_spatial` reads only SPATIAL_COLUMNS from the
store, in a `sad.read` span.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from ..obs import trace as _trace
from ..ops.dbscan import dbscan_points_noise
from ..ops import embed as _embed
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


def device_embeddings(flows: ColumnarBatch, device) -> torch.Tensor:
    """`flow_embeddings` of `flows` as a [n, 7] float32 tensor on
    `device`, computed there from SPATIAL_COLUMNS: the columns copied
    as the store holds them (`sad.to_device`), then ops/embed.py's
    flow_embedding, all in a `sad.embed` span (`rows`, `route`)."""
    dev = resolve_device(device)
    n = len(flows)
    with _trace.span("sad.embed", rows=n, route=_embed.route(dev)):
        with _trace.span("sad.to_device", rows=n):
            cols = [torch.from_numpy(np.ascontiguousarray(flows[c])).to(dev)
                    for c in SPATIAL_COLUMNS]
        return _embed.flow_embedding(*cols)


def embedding_device(mesh, device) -> torch.device:
    """Where a job embeds its flows: the mesh's first device when a
    mesh runs (make_sharded_points_dbscan shards from there), else
    `device`."""
    if mesh is None:
        return resolve_device(device)
    return torch.device(mesh.devices.flat[0])


def spatial_outliers(flows: ColumnarBatch,
                     eps: float = DEFAULT_EPS,
                     min_samples: int = DEFAULT_MIN_SAMPLES,
                     block: int = 1024,
                     mesh=None,
                     embeddings: Optional[torch.Tensor] = None,
                     device="cuda"
                     ) -> List[Dict[str, object]]:
    """Flows outside every recurring traffic pattern. Returns one dict
    per noise flow: decoded source/destination/port/bytes. The
    pairwise pass runs on `device`; with `mesh`, it shards rows over
    the mesh with all_gathered points/core-flags
    (parallel.make_sharded_points_dbscan). The flows are embedded on
    `device`, or on the mesh's first device (device_embeddings);
    `embeddings` lets a caller that already did that (run_spatial's
    staged progress) skip recomputation."""
    n = len(flows)
    if n == 0:
        return []
    dev = embedding_device(mesh, device)
    emb = embeddings if embeddings is not None \
        else device_embeddings(flows, dev)
    if mesh is not None:
        from ..parallel import make_sharded_points_dbscan
        pad = -n % mesh.devices.size
        padded = torch.nn.functional.pad(emb, (0, 0, 0, pad))
        valid = torch.arange(n + pad, device=dev) < n
        flags = make_sharded_points_dbscan(
            mesh, eps=eps, min_samples=min_samples, block=block)(
            padded, valid)
        with _trace.span("sad.fetch", rows=n):
            noise = flags.cpu().numpy()[:n]
    else:
        valid = torch.ones(n, dtype=torch.bool, device=dev)
        flags = dbscan_points_noise(emb, valid, eps=eps,
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
    (utils.device.auto_mesh), embedding on the mesh's first device;
    without a mesh the embedding and the pass run on `device`
    (device_embeddings).
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
    emb = device_embeddings(flows, embedding_device(mesh, device))

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
