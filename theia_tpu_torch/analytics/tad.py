"""Throughput Anomaly Detection job — the framework's flagship compute path.

Ports theia_tpu/analytics/tad.py. Re-provides the TAD job
(plugins/anomaly-detection/anomaly_detection.py) end to end: read a
flow window from the store, build per-connection (or aggregated)
throughput series, score them with EWMA / ARIMA / DBSCAN, and write
anomalous points to the `tadetector` table, including the reference's
"NO ANOMALY DETECTED" filler row when nothing fires (:395-420).

The scoring step runs on one device over the padded [S, T] batch
(ops.ewma, ops.arima, and ops.dbscan, whose CUDA path is the
hand-written kernel B2). Entry points take `device=` (default "cuda",
resolved by utils.device.resolve_device). Scoring over several cards
is not ported yet: `mesh` accepts only "auto" and None, both meaning
one device.
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
from ..utils.device import resolve_device, single_device
from ..utils.logging import get_logger
from .series import SeriesBatch, TadQuerySpec, build_series

logger = get_logger("tad")

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


def score_series(values: np.ndarray, mask: np.ndarray, algo: str,
                 refit_every: int = 1, mesh=None, device="cuda"):
    """Run one algorithm over a padded [S, T] batch on `device`.

    Returns (algo_calc [S,T], stddev [S], anomaly [S,T]) as numpy.
    `refit_every` applies to ARIMA only (see `effective_refit`).
    """
    if algo not in ALGORITHMS:
        raise ValueError(
            f"algo must be one of {ALGORITHMS}, got {algo!r}")
    single_device(mesh)
    dev = resolve_device(device)
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
    `tadetector.insert_rows(rows)`. `mesh`: "auto" or None, both one
    device (see `score_series`).
    """
    if algo not in ALGORITHMS:
        raise ValueError(f"algo must be one of {ALGORITHMS}, got {algo!r}")
    single_device(mesh)
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
                            refit_every=spec.refit_every, device=device)

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
