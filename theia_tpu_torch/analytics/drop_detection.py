"""Abnormal traffic-drop detection job.

Re-provides the capability the reference ships only on its deprecated
Snowflake backend (`theia-sf drop-detection`): find endpoints whose
daily count of NetworkPolicy-dropped flows is anomalous.

Reference semantics (snowflake/cmd/dropDetection.go:36-175 builds the
query; snowflake/udfs/udfs/drop_detection/drop_detection_udf.py scores):

  1. Keep flows whose ingress OR egress NetworkPolicy rule action is
     Drop (2) or Reject (3), optionally time-windowed and filtered by
     clusterUUID.
  2. Attribute each flow to a victim endpoint: ingress-dropped traffic
     belongs to the destination (`ns/pod`, falling back to the IP),
     otherwise to the source; direction is "ingress"/"egress".
  3. Count dropped flows per (endpoint, direction, day).
  4. Per (endpoint, direction) partition with >= 3 observed days:
     anomaly iff the daily count is outside mean +/- 3*stddev_samp.

Ports theia_tpu/analytics/drop_detection.py: steps 1-3 are one
vectorized pass over dictionary codes on the host (no string
materialization until result rows), verbatim; step 4 scores the whole
[S, D] matrix at once on `device=` (default "cuda") with
`ops.drops.drop_scores` instead of a per-partition pandas loop. Only
`run_drop_detection` differs from the reference.
"""

from __future__ import annotations

import time
import uuid
from typing import Dict, List, Optional

import numpy as np
import torch

from ..ops.drops import drop_scores
from ..store import FlowDatabase
from ..utils.device import resolve_device

SECONDS_PER_DAY = 86400

ACTION_DROP = 2
ACTION_REJECT = 3


def _dropped_partitions(flows, start_time, end_time, cluster_uuid):
    """Steps 1-2: masks + integer partition keys.

    Returns (endpoint_key [N,3], direction [N] uint8 0=ingress/1=egress,
    date [N]) for the dropped rows, all as integer codes."""
    ingress = np.asarray(flows["ingressNetworkPolicyRuleAction"])
    egress = np.asarray(flows["egressNetworkPolicyRuleAction"])
    ing_drop = (ingress == ACTION_DROP) | (ingress == ACTION_REJECT)
    egr_drop = (egress == ACTION_DROP) | (egress == ACTION_REJECT)
    mask = ing_drop | egr_drop
    starts = np.asarray(flows["flowStartSeconds"])
    if start_time is not None:
        mask &= starts >= start_time
    if end_time is not None:
        mask &= np.asarray(flows["flowEndSeconds"]) < end_time
    if cluster_uuid:
        code = flows.dicts["clusterUUID"].lookup(cluster_uuid)
        mask &= np.asarray(flows["clusterUUID"]) == (
            -1 if code is None else code)

    col = flows.column_selector(mask)
    ing_drop = ing_drop[mask]
    # Victim endpoint: destination for ingress-dropped flows (the CASE
    # in dropDetection.go:131-143 prefers ingress when both dropped),
    # else source. Key = (pod_name_code, ns_code, ip_code); decode
    # happens only for anomalous rows.
    dst_name, dst_ns = col("destinationPodName"), \
        col("destinationPodNamespace")
    src_name, src_ns = col("sourcePodName"), col("sourcePodNamespace")
    dst_ip, src_ip = col("destinationIP"), col("sourceIP")
    name = np.where(ing_drop, dst_name, src_name)
    ns = np.where(ing_drop, dst_ns, src_ns)
    ip = np.where(ing_drop, dst_ip, src_ip)
    # Partition on the derived endpoint exactly as the reference derives
    # it (dropDetection.go:131-143): when the pod name is set the
    # endpoint is "ns/pod" (IP ignored — a pod restart that changes the
    # IP must not split the partition); otherwise it is the bare IP
    # (namespace ignored). Code 0 is the empty string.
    has_pod = name != 0
    ns = np.where(has_pod, ns, 0)
    ip = np.where(has_pod, 0, ip)
    direction = np.where(ing_drop, 0, 1).astype(np.int64)
    date = col("flowStartSeconds") // SECONDS_PER_DAY
    key = np.stack([name, ns, ip, direction], axis=1)
    return key, date


def _count_matrix(key: np.ndarray, date: np.ndarray):
    """Step 3: dropped-flow count per (partition, day), packed into a
    padded [S, D] matrix + mask (dates are dense-ranked per partition,
    real calendar value kept alongside)."""
    # Group identical (key, date) pairs → counts.
    full = np.concatenate([key, date[:, None]], axis=1)
    uniq, counts = np.unique(full, axis=0, return_counts=True)
    part_keys, part_idx = np.unique(uniq[:, :-1], axis=0,
                                    return_inverse=True)
    days = uniq[:, -1]
    n_parts = len(part_keys)
    # Rank each partition's dates (uniq rows are lex-sorted, so dates
    # ascend within a partition).
    order = np.argsort(part_idx, kind="stable")
    pos_in_part = np.arange(len(uniq)) - np.searchsorted(
        part_idx[order], part_idx[order])
    width = int(pos_in_part.max()) + 1 if len(uniq) else 0
    mat = np.zeros((n_parts, width), np.float64)
    dates = np.zeros((n_parts, width), np.int64)
    mask = np.zeros((n_parts, width), bool)
    rows = part_idx[order]
    mat[rows, pos_in_part] = counts[order]
    dates[rows, pos_in_part] = days[order]
    mask[rows, pos_in_part] = True
    return part_keys, mat, dates, mask


def run_drop_detection(db: FlowDatabase,
                       job_type: str = "initial",
                       detection_id: Optional[str] = None,
                       start_time: Optional[int] = None,
                       end_time: Optional[int] = None,
                       cluster_uuid: str = "",
                       now: Optional[int] = None,
                       progress=None, device="cuda") -> str:
    """Execute a drop-detection job; writes anomalies to the
    `dropdetection` table and returns the detection id. The count
    matrix is scored on `device`."""
    dev = resolve_device(device)
    if job_type != "initial":
        # Reference: "we only support initial jobType for now"
        # (dropDetection.go:282).
        raise ValueError(f"unsupported drop-detection jobType "
                         f"{job_type!r} (only 'initial')")
    detection_id = detection_id or str(uuid.uuid4())

    if progress:
        progress.stage("read")
    flows = db.flows.scan()
    if len(flows) == 0:
        if progress:
            progress.done()
        return detection_id
    key, date = _dropped_partitions(flows, start_time, end_time,
                                    cluster_uuid)

    if progress:
        progress.stage("tensorize")
    part_keys, mat, dates, mask = _count_matrix(key, date)
    if len(part_keys) == 0:
        if progress:
            progress.done()
        return detection_id

    if progress:
        progress.stage("score")
    anomaly, mean, std = (a.cpu().numpy() for a in drop_scores(
        torch.from_numpy(mat).to(dev), torch.from_numpy(mask).to(dev)))

    if progress:
        progress.stage("write")
    rows = _result_rows(flows, part_keys, mat, dates, anomaly, mean,
                        std, job_type, detection_id, now)
    if rows:
        db.dropdetection.insert_rows(rows)
    if progress:
        progress.done()
    return detection_id


def _result_rows(flows, part_keys, mat, dates, anomaly, mean, std,
                 job_type, detection_id, now) -> List[Dict[str, object]]:
    """`flows` is the scanned batch the partition keys were built from —
    its dicts are the ONLY tables the codes are valid against (a sharded
    scan re-encodes into merged dictionaries distinct from any shard's)."""
    created = int(now if now is not None else time.time())
    name_dict = flows.dicts["sourcePodName"]
    ns_dict = flows.dicts["sourcePodNamespace"]
    ip_dict = flows.dicts["sourceIP"]
    # All pod-name/ns/IP columns have per-column dicts; endpoint codes
    # were taken from whichever side was the victim, so decode against
    # the matching dict per column pair.
    dst_name_dict = flows.dicts["destinationPodName"]
    dst_ns_dict = flows.dicts["destinationPodNamespace"]
    dst_ip_dict = flows.dicts["destinationIP"]

    rows: List[Dict[str, object]] = []
    sidx, didx = np.nonzero(anomaly)
    for s, d in zip(sidx, didx):
        name_c, ns_c, ip_c, direction = part_keys[s]
        if direction == 0:  # ingress → destination-side codes
            pod = dst_name_dict.decode_one(int(name_c))
            ns = dst_ns_dict.decode_one(int(ns_c))
            ip = dst_ip_dict.decode_one(int(ip_c))
        else:
            pod = name_dict.decode_one(int(name_c))
            ns = ns_dict.decode_one(int(ns_c))
            ip = ip_dict.decode_one(int(ip_c))
        endpoint = f"{ns}/{pod}" if pod else ip
        rows.append({
            "jobType": job_type,
            "id": detection_id,
            "timeCreated": created,
            "endpoint": endpoint,
            "direction": "ingress" if direction == 0 else "egress",
            "avgDrop": float(mean[s]),
            "stdevDrop": float(std[s]),
            "anomalyDropDate": int(dates[s, d]) * SECONDS_PER_DAY,
            "anomalyDropNumber": int(mat[s, d]),
        })
    return rows
