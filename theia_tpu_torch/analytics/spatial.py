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
"cuda") through the port's `ops.dbscan.dbscan_points_noise`. Only
`spatial_outliers` and `run_spatial` differ: they take `device=`, and
`mesh` accepts "auto" or None, both one device (the sharded pass is
ROADMAP A16).
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from ..ops.dbscan import dbscan_points_noise
from ..schema import ColumnarBatch
from ..utils.device import resolve_device, single_device

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
    pairwise pass runs on `device`; `mesh` is "auto" or None (one
    device). `embeddings` lets a caller that already embedded the
    flows (run_spatial's staged progress) skip recomputation."""
    single_device(mesh)
    dev = resolve_device(device)
    n = len(flows)
    if n == 0:
        return []
    emb = embeddings if embeddings is not None \
        else flow_embeddings(flows)
    noise = dbscan_points_noise(
        torch.from_numpy(np.ascontiguousarray(emb)).to(dev),
        torch.ones(n, dtype=torch.bool, device=dev), eps=eps,
        min_samples=min_samples, block=block).cpu().numpy()
    idx = np.nonzero(noise)[0]
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
    anomaly_detection.py:325-349). The pairwise pass runs on `device`;
    `mesh` is "auto" or None, both one device (ROADMAP A16).
    """
    import time as _time
    import uuid as _uuid

    single_device(mesh)
    resolve_device(device)
    spatial_id = spatial_id or str(_uuid.uuid4())

    if progress:
        progress.stage("read")
    flows = db.flows.select(start_time, end_time)
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
                                min_samples=min_samples,
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
