"""Synthetic Antrea flow-record generator.

Produces `ColumnarBatch`es against the full flow schema, shaped like the data
the reference's e2e suite inserts directly via SQL for job tests (reference:
test/e2e/framework.go:112 `insertQueryflowtable`, and the iperf-driven rows
documented at test/e2e/flowvisibility_test.go:46-90): pod-to-pod /
pod-to-service / pod-to-external connections with per-connection throughput
time series, plus injected anomaly spikes so the detectors have ground truth.

Every benchmark and most tests sit on top of this module.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Dict, Optional

import numpy as np

from ..schema import FLOW_SCHEMA, ColumnarBatch, StringDictionary

# 2021-01-01 00:00:00 UTC — arbitrary fixed epoch so tests are deterministic.
DEFAULT_START = 1609459200

FLOW_TYPE_INTRA_NODE = 1
FLOW_TYPE_INTER_NODE = 2
FLOW_TYPE_TO_EXTERNAL = 3


@dataclasses.dataclass
class SynthConfig:
    n_series: int = 64           # number of distinct connections (pod pairs)
    points_per_series: int = 60  # flow records per connection
    interval_seconds: int = 1    # spacing of flowEndSeconds within a series
    start_time: int = DEFAULT_START
    n_namespaces: int = 4
    n_nodes: int = 3
    pods_per_namespace: int = 8
    n_services: int = 4
    external_fraction: float = 0.1   # fraction of series going to external IPs
    service_fraction: float = 0.3    # fraction of series going via a Service
    base_throughput: float = 1.0e6   # bytes/s scale
    anomaly_fraction: float = 0.1    # fraction of series given a spike
    anomaly_magnitude: float = 20.0  # spike = magnitude * base
    protected_fraction: float = 0.0  # fraction with NP verdicts already set
    # every record carries the emitting cluster's UUID (multicluster
    # deployments stamp distinct values, test/e2e_mc/multicluster_test.go)
    cluster_uuid: str = "8a6a2e0e-0000-4000-8000-000000000001"
    seed: int = 0


def _pod_labels(ns_idx: int, app_idx: int) -> str:
    # Sorted-key JSON to match the reference's canonical label strings
    # (anomaly_detection.py:644 json.dumps(..., sort_keys=True)).
    return json.dumps({"app": f"app-{ns_idx}-{app_idx}"}, sort_keys=True)


def generate_flows(cfg: SynthConfig,
                   dicts: Optional[Dict[str, StringDictionary]] = None
                   ) -> ColumnarBatch:
    rng = np.random.default_rng(cfg.seed)
    S, T = cfg.n_series, cfg.points_per_series
    n = S * T

    ns_idx = rng.integers(0, cfg.n_namespaces, size=S)
    src_pod_idx = rng.integers(0, cfg.pods_per_namespace, size=S)
    dst_ns_idx = rng.integers(0, cfg.n_namespaces, size=S)
    dst_pod_idx = rng.integers(0, cfg.pods_per_namespace, size=S)
    src_node_idx = rng.integers(0, cfg.n_nodes, size=S)
    dst_node_idx = rng.integers(0, cfg.n_nodes, size=S)

    u = rng.random(size=S)
    is_external = u < cfg.external_fraction
    is_service = (~is_external) & (u < cfg.external_fraction
                                   + cfg.service_fraction)

    src_port = rng.integers(32768, 61000, size=S)
    dst_port = np.where(is_external, 443,
                        np.where(is_service, 80,
                                 rng.integers(5201, 5210, size=S)))
    proto = np.full(S, 6)  # TCP

    # Throughput series: noisy base + optional anomaly spike at a random step.
    base = cfg.base_throughput * (0.5 + rng.random(size=(S, 1)))
    noise = rng.normal(1.0, 0.05, size=(S, T))
    series = base * np.clip(noise, 0.1, None)
    anomalous = rng.random(size=S) < cfg.anomaly_fraction
    spike_t = rng.integers(T // 2, T, size=S)
    spike = (np.arange(T)[None, :] == spike_t[:, None]) & anomalous[:, None]
    series = np.where(spike, base * cfg.anomaly_magnitude, series)
    series = series.astype(np.int64)

    flow_end = (cfg.start_time
                + np.arange(T, dtype=np.int64)[None, :] * cfg.interval_seconds
                + np.zeros((S, 1), dtype=np.int64))
    flow_start = np.full((S, T), cfg.start_time - 10, dtype=np.int64)

    protected = rng.random(size=S) < cfg.protected_fraction

    def rep(per_series: np.ndarray) -> np.ndarray:
        return np.repeat(per_series, T)

    src_ns = np.array([f"ns-{i}" for i in ns_idx], dtype=object)
    dst_ns = np.array([f"ns-{i}" for i in dst_ns_idx], dtype=object)
    src_pod = np.array(
        [f"pod-{a}-{b}" for a, b in zip(ns_idx, src_pod_idx)], dtype=object)
    dst_pod = np.array(
        [f"pod-{a}-{b}" for a, b in zip(dst_ns_idx, dst_pod_idx)],
        dtype=object)
    src_labels = np.array(
        [_pod_labels(a, b) for a, b in zip(ns_idx, src_pod_idx)],
        dtype=object)
    dst_labels = np.array(
        [_pod_labels(a, b) for a, b in zip(dst_ns_idx, dst_pod_idx)],
        dtype=object)
    src_ip = np.array([f"10.0.{a}.{b}" for a, b in
                       zip(ns_idx, src_pod_idx)], dtype=object)
    dst_ip = np.where(
        is_external,
        np.array([f"203.0.113.{i % 250}" for i in range(S)], dtype=object),
        np.array([f"10.0.{a}.{b}" for a, b in
                  zip(dst_ns_idx, dst_pod_idx)], dtype=object))
    svc_name = np.where(
        is_service,
        np.array([f"ns-{a}/svc-{i % cfg.n_services}:http" for i, a in
                  enumerate(dst_ns_idx)], dtype=object),
        np.array([""] * S, dtype=object))
    cluster_ip = np.where(is_service,
                          np.array([f"10.96.0.{i % cfg.n_services + 1}"
                                    for i in range(S)], dtype=object),
                          np.array([""] * S, dtype=object))

    # External destinations have no dst pod context.
    dst_pod = np.where(is_external, "", dst_pod)
    dst_ns_out = np.where(is_external, "", dst_ns)
    dst_labels = np.where(is_external, "", dst_labels)
    dst_node = np.array([f"node-{i}" for i in dst_node_idx], dtype=object)
    dst_node = np.where(is_external, "", dst_node)

    flow_type = np.where(
        is_external, FLOW_TYPE_TO_EXTERNAL,
        np.where(src_node_idx == dst_node_idx, FLOW_TYPE_INTRA_NODE,
                 FLOW_TYPE_INTER_NODE))

    ing_np = np.where(protected & ~is_external,
                      np.array([f"allow-ingress-{i % 5}" for i in range(S)],
                               dtype=object), "")
    eg_np = np.where(protected,
                     np.array([f"allow-egress-{i % 5}" for i in range(S)],
                              dtype=object), "")

    octet_delta = (series * cfg.interval_seconds).astype(np.int64)

    str_cols = {
        "sourceIP": rep(src_ip),
        "destinationIP": rep(dst_ip),
        "sourcePodName": rep(src_pod),
        "sourcePodNamespace": rep(src_ns),
        "sourceNodeName": rep(np.array(
            [f"node-{i}" for i in src_node_idx], dtype=object)),
        "destinationPodName": rep(dst_pod),
        "destinationPodNamespace": rep(dst_ns_out),
        "destinationNodeName": rep(dst_node),
        "destinationClusterIP": rep(cluster_ip),
        "destinationServicePortName": rep(svc_name),
        "ingressNetworkPolicyName": rep(ing_np),
        "ingressNetworkPolicyNamespace": rep(
            np.where(ing_np != "", dst_ns, "")),
        "ingressNetworkPolicyRuleName": rep(
            np.where(ing_np != "", "rule-0", "")),
        "egressNetworkPolicyName": rep(eg_np),
        "egressNetworkPolicyNamespace": rep(
            np.where(eg_np != "", src_ns, "")),
        "egressNetworkPolicyRuleName": rep(
            np.where(eg_np != "", "rule-0", "")),
        "tcpState": rep(np.array(["ESTABLISHED"] * S, dtype=object)),
        "sourcePodLabels": rep(src_labels),
        "destinationPodLabels": rep(dst_labels),
        "clusterUUID": rep(np.array(
            [cfg.cluster_uuid] * S, dtype=object)),
        "egressName": rep(np.array([""] * S, dtype=object)),
        "egressIP": rep(np.array([""] * S, dtype=object)),
    }

    num_cols = {
        "timeInserted": flow_end.ravel(),
        "flowStartSeconds": flow_start.ravel(),
        "flowEndSeconds": flow_end.ravel(),
        "flowEndSecondsFromSourceNode": flow_end.ravel(),
        "flowEndSecondsFromDestinationNode": flow_end.ravel(),
        "flowEndReason": np.full(n, 3),
        "sourceTransportPort": rep(src_port),
        "destinationTransportPort": rep(dst_port),
        "protocolIdentifier": rep(proto),
        "packetTotalCount": np.cumsum(
            np.maximum(octet_delta // 1400, 1), axis=1).ravel(),
        "octetTotalCount": np.cumsum(octet_delta, axis=1).ravel(),
        "packetDeltaCount": np.maximum(octet_delta.ravel() // 1400, 1),
        "octetDeltaCount": octet_delta.ravel(),
        "reversePacketTotalCount": np.cumsum(
            np.maximum(octet_delta // 28000, 1), axis=1).ravel(),
        "reverseOctetTotalCount": np.cumsum(
            octet_delta // 20, axis=1).ravel(),
        "reversePacketDeltaCount": np.maximum(
            octet_delta.ravel() // 28000, 1),
        "reverseOctetDeltaCount": octet_delta.ravel() // 20,
        "destinationServicePort": rep(np.where(is_service, 80, 0)),
        "ingressNetworkPolicyRuleAction": rep(
            np.where(protected & ~is_external, 1, 0)),
        "ingressNetworkPolicyType": rep(
            np.where(protected & ~is_external, 1, 0)),
        "egressNetworkPolicyRuleAction": rep(np.where(protected, 1, 0)),
        "egressNetworkPolicyType": rep(np.where(protected, 1, 0)),
        "flowType": rep(flow_type),
        "throughput": series.ravel(),
        "reverseThroughput": series.ravel() // 20,
        "throughputFromSourceNode": series.ravel(),
        "throughputFromDestinationNode": series.ravel(),
        "reverseThroughputFromSourceNode": series.ravel() // 20,
        "reverseThroughputFromDestinationNode": series.ravel() // 20,
        "trusted": np.zeros(n),
    }

    dicts = dict(dicts or {})
    cols: Dict[str, np.ndarray] = {}
    for col in FLOW_SCHEMA:
        if col.is_string:
            d = dicts.setdefault(col.name, StringDictionary())
            cols[col.name] = d.encode(str_cols[col.name])
        else:
            cols[col.name] = np.asarray(num_cols[col.name],
                                        dtype=col.host_dtype)
    batch = ColumnarBatch(cols, dicts)
    batch.ground_truth_anomalous = anomalous  # type: ignore[attr-defined]
    return batch
