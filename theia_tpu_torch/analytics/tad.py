"""Throughput Anomaly Detection job — the framework's flagship compute path.

Ports theia_tpu/analytics/tad.py. Re-provides the TAD job
(plugins/anomaly-detection/anomaly_detection.py) end to end: read a
flow window from the store, build per-connection (or aggregated)
throughput series, score them with EWMA / ARIMA / DBSCAN, and write
anomalous points to the `tadetector` table, including the reference's
"NO ANOMALY DETECTED" filler row when nothing fires (:395-420).

The scoring step runs over the padded [S, T] batch (ops.ewma,
ops.arima, and ops.dbscan, whose CUDA path is the hand-written kernel
B2), on one device — `device=` (default "cuda", resolved by
utils.device.resolve_device) — or sharded over a mesh of torch devices
(parallel/, one controller; each CUDA shard of a DBSCAN batch is one
B2 launch).
"""

from __future__ import annotations

import time
import uuid
from typing import Dict, Optional

import numpy as np
import torch

from ..ops.arima import arima_scores
from ..ops.dbscan import dbscan_scores
from ..ops.ewma import ewma_scores
from ..utils.device import auto_mesh, resolve_device
from ..utils.logging import get_logger
from .series import SeriesBatch, TadQuerySpec, build_series

logger = get_logger("tad")

#: series length at which an under-populated mesh (fewer series than
#: devices) re-shards EWMA over TIME instead of running local — below
#: this the blockwise scan's collective overhead beats its win
LONG_SERIES_T = 4096

ALGORITHMS = ("EWMA", "ARIMA", "DBSCAN")


def effective_refit(algo: str, refit_every: int, n_steps: int) -> int:
    """Resolve the ARIMA refit cadence a job will actually run with.

    refit_every=1 is the reference's exact refit-per-step
    (anomaly_detection.py:246-253); 0 selects the auto heuristic
    max(1, T // 2048) that keeps 24h@1s series feasible. Non-ARIMA
    algorithms have no refit concept → 0."""
    if algo != "ARIMA":
        return 0
    if refit_every < 0:
        raise ValueError(f"refitEvery must be >= 0, got {refit_every}")
    return refit_every if refit_every else max(1, n_steps // 2048)


def _score_series_sharded(values, mask, algo, refit_every, mesh):
    """Score over a device mesh: data-parallel over series (plus
    sequence-parallel over time for EWMA). The sharded kernels run the
    same per-series computation as the single-device path, so result
    rows are identical — this is the reference's `executorInstances`
    scale-out applied to the production job (SURVEY §2.7 row 1).
    Follows theia_tpu/analytics/tad.py:52-101; the outputs come back
    from the mesh's first device as numpy."""
    from ..parallel import (cached_kernel, make_sharded_arima,
                            make_sharded_dbscan, make_sharded_ewma,
                            pad_to_multiple, shard_arrays)
    from ..parallel.mesh import SERIES_AXIS, TIME_AXIS
    from ..parallel.tad_sharded import make_series_sharded

    S, T = values.shape
    values, _ = pad_to_multiple(values, mesh.shape[SERIES_AXIS], axis=0)
    mask, _ = pad_to_multiple(mask, mesh.shape[SERIES_AXIS], axis=0)
    if algo == "EWMA" and mesh.shape.get(TIME_AXIS, 1) > 1:
        # Sequence-parallel scan over the mesh's time axis (its stddev
        # psum may differ from the local kernel in the last float bit;
        # the job path uses time_shards=1 meshes, which are exact).
        values, _ = pad_to_multiple(values, mesh.shape[TIME_AXIS],
                                    axis=1)
        mask, _ = pad_to_multiple(mask, mesh.shape[TIME_AXIS], axis=1)
        fn = cached_kernel(("ewma_time", mesh),
                           lambda: make_sharded_ewma(mesh))
        calc, std, anom, _count = fn(*shard_arrays(mesh, values, mask))
    elif algo == "EWMA":
        fn = cached_kernel(
            ("ewma", mesh),
            lambda: make_series_sharded(mesh, ewma_scores))
        calc, std, anom = fn(*shard_arrays(mesh, values, mask))
    elif algo == "ARIMA":
        refit = effective_refit(algo, refit_every, T)
        fn = cached_kernel(
            ("arima", mesh, refit),
            lambda: make_sharded_arima(mesh, refit_every=refit))
        calc, std, anom = fn(*shard_arrays(mesh, values, mask))
    else:
        from ..ops.dbscan import DEFAULT_EPS, DEFAULT_MIN_SAMPLES
        fn = cached_kernel(
            ("dbscan", mesh),
            lambda: make_sharded_dbscan(
                mesh, eps=DEFAULT_EPS,
                min_samples=DEFAULT_MIN_SAMPLES))
        calc, std, anom = fn(*shard_arrays(mesh, values, mask))
    return (calc.cpu().numpy()[:S, :T], std.cpu().numpy()[:S],
            anom.cpu().numpy()[:S, :T])


def score_series(values: np.ndarray, mask: np.ndarray, algo: str,
                 refit_every: int = 1, mesh=None, device="cuda"):
    """Run one algorithm over a padded [S, T] batch.

    Returns (algo_calc [S,T], stddev [S], anomaly [S,T]) as numpy.
    `refit_every` applies to ARIMA only (see `effective_refit`).
    Without a mesh the batch runs on `device`. With `mesh` (a
    parallel.mesh.Mesh with >1 shard), scoring shards over the mesh's
    devices (a batch it cannot shard runs on its first device);
    results are identical to the local path for
    series-sharded meshes (time_shards=1 — the job_mesh() default).
    Time sharding engages in two cases, both bit-approximate in the
    psum-reduced stddev (anomaly flags exactly ON the threshold can
    differ): an explicitly time-sharded mesh, or automatically for
    EWMA when the batch has fewer series than shards and T ≥
    LONG_SERIES_T (sequence parallelism instead of idle devices).
    """
    if algo not in ALGORITHMS:
        raise ValueError(
            f"algo must be one of {ALGORITHMS}, got {algo!r}")
    if mesh is not None and mesh.size > 1:
        if values.shape[0] >= mesh.size:
            return _score_series_sharded(values, mask, algo,
                                         refit_every, mesh)
        if algo == "EWMA" and values.shape[1] >= LONG_SERIES_T:
            # Few series, long T: series-DP would idle most devices,
            # so re-mesh the same devices sequence-parallel and scan
            # the TIME axis cooperatively (the long-time-series role
            # SURVEY §5 assigns to sequence sharding). The psum'd
            # stddev is bit-approximate vs the local kernel — anomaly
            # flags exactly ON the threshold can flip; worth it only
            # when T is long enough for the blockwise scan to pay.
            from ..parallel.mesh import make_mesh
            tmesh = make_mesh(devices=mesh.devices.flatten(),
                              time_shards=mesh.devices.size)
            logger.info(
                "EWMA over %d series x %d steps: sequence-parallel "
                "time sharding over %d devices (series-DP would idle "
                "%d of them)", values.shape[0], values.shape[1],
                tmesh.devices.size,
                mesh.devices.size - values.shape[0])
            return _score_series_sharded(values, mask, algo,
                                         refit_every, tmesh)
    # one device: `device`, or the first of a mesh too big for the batch
    dev = (mesh.devices.flat[0] if mesh is not None
           else resolve_device(device))
    x = torch.from_numpy(np.ascontiguousarray(values)).to(dev)
    m = torch.from_numpy(np.ascontiguousarray(mask, dtype=bool)).to(dev)
    if algo == "EWMA":
        calc, std, anom = ewma_scores(x, m)
    elif algo == "ARIMA":
        refit = effective_refit(algo, refit_every, values.shape[1])
        if refit > 1:
            logger.info(
                "ARIMA grouped-refit approximation active: refitting "
                "every %d steps over T=%d (reference-exact is "
                "refitEvery=1)", refit, values.shape[1])
        elif values.shape[1] > 8192:
            logger.warning(
                "ARIMA exact refit-per-step over T=%d steps is "
                "O(T^2) — expect a long job; pass refitEvery=0 "
                "(auto) or k>1 for grouped refits", values.shape[1])
        calc, std, anom = arima_scores(x, m, refit_every=refit)
    else:
        calc, std, anom = dbscan_scores(x, m)
    return calc.cpu().numpy(), std.cpu().numpy(), anom.cpu().numpy()


def run_tad(db, algo: str, spec: TadQuerySpec,
            tad_id: Optional[str] = None,
            now: Optional[int] = None,
            progress=None, mesh="auto", device="cuda") -> str:
    """Execute a full TAD job against the database; returns the job id.

    `db` needs `flows.scan()` (a ColumnarBatch) and
    `tadetector.insert_rows(rows)`. `mesh`: "auto" scores over every
    visible card when `device` is a card (utils.device.auto_mesh;
    one-card hosts and THEIA_MESH=off keep the one-device path), None
    forces one device, or pass an explicit parallel.mesh.Mesh.
    """
    if algo not in ALGORITHMS:
        raise ValueError(f"algo must be one of {ALGORITHMS}, got {algo!r}")
    if isinstance(mesh, str):
        if mesh != "auto":
            raise ValueError(
                f"mesh must be 'auto', None or a Mesh, got {mesh!r} "
                f"(use THEIA_MESH=off to disable sharding)")
        mesh = auto_mesh(device)
    tad_id = tad_id or str(uuid.uuid4())

    if progress:
        progress.stage("read")
    flows = db.flows.scan()

    if progress:
        progress.stage("tensorize")
    batch = build_series(flows, spec)

    if progress:
        progress.stage("score")
    rows = detect_anomalies(batch, algo, tad_id, now=now,
                            refit_every=spec.refit_every, mesh=mesh,
                            device=device)

    if progress:
        progress.stage("write")
    db.tadetector.insert_rows(rows)
    if progress:
        progress.done()
    return tad_id


def detect_anomalies(batch: SeriesBatch, algo: str, tad_id: str,
                     now: Optional[int] = None, refit_every: int = 1,
                     mesh=None, device="cuda"):
    """Score a series batch and materialize tadetector result rows."""
    refit = effective_refit(
        algo, refit_every,
        batch.values.shape[1] if batch.n_series else 0)
    if batch.n_series == 0:
        return [_no_anomaly_row(batch.agg_type, algo, tad_id, now,
                                refit)]

    # Pass the resolved cadence so the emitted refitEvery and the one
    # actually executed cannot drift (effective_refit is idempotent).
    calc, std, anom = score_series(batch.values, batch.mask, algo,
                                   refit_every=refit if refit else 1,
                                   mesh=mesh, device=device)
    sidx, tidx = np.nonzero(anom)
    if sidx.size == 0:
        return [_no_anomaly_row(batch.agg_type, algo, tad_id, now,
                                refit)]

    # stddev_samp is NULL (NaN) for 1-point series; those can't be
    # anomalous, but guard the cast anyway.
    std = np.nan_to_num(std, nan=0.0)
    rows = []
    for s, t in zip(sidx, tidx):
        row: Dict[str, object] = {
            "aggType": batch.agg_type,
            "algoType": algo,
            "flowEndSeconds": int(batch.times[s, t]),
            "throughputStandardDeviation": float(std[s]),
            "algoCalc": float(calc[s, t]),
            "throughput": float(batch.values[s, t]),
            "anomaly": "true",
            "refitEvery": refit,
            "id": tad_id,
        }
        # Series key names coincide with tadetector column names; keys
        # not present for this agg mode default to ''/0 in the schema
        # (the reference emits a mode-specific column subset,
        # filter_df_with_true_anomalies :352-394).
        for key_name in batch.key_names:
            v = batch.keys[key_name][s]
            row[key_name] = v.item() if isinstance(v, np.generic) else v
        rows.append(row)
    return rows


def _no_anomaly_row(agg_type: str, algo: str, tad_id: str,
                    now: Optional[int],
                    refit: int = 0) -> Dict[str, object]:
    """The reference's filler row (:401-419): string identity columns get
    'None', flowStartSeconds gets the wall clock, anomaly gets the
    sentinel text."""
    return {
        "sourceIP": "None",
        "sourceTransportPort": 0,
        "destinationIP": "None",
        "destinationTransportPort": 0,
        "protocolIdentifier": 0,
        "flowStartSeconds": int(now if now is not None else time.time()),
        "podNamespace": "None",
        "podLabels": "None",
        "podName": "None",
        "destinationServicePortName": "None",
        "direction": "None",
        "flowEndSeconds": 0,
        "throughputStandardDeviation": 0.0,
        "aggType": agg_type,
        "algoType": algo,
        "algoCalc": 0.0,
        "throughput": 0.0,
        "anomaly": "NO ANOMALY DETECTED",
        "refitEvery": refit,
        "id": tad_id,
    }
