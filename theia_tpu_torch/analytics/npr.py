"""NetworkPolicy Recommendation (NPR) job.

Re-provides plugins/policy-recommendation/policy_recommendation_job.py:
read distinct unprotected (or trusted-denied) flow 9-tuples from the
store, classify them (pod_to_pod / pod_to_svc / pod_to_external,
get_flow_type :83-91), aggregate ingress/egress network peers per
appliedTo group (the reference's RDD map/reduceByKey pipeline :621-712),
and emit policy YAML for the three isolation options
(recommend_policies_for_unprotected_flows :714-726):

  1 — allow ANP/ACNP + per-group baseline reject ACNPs
  2 — allow ANP/ACNP + one cluster-wide reject ACNP
  3 — K8s NetworkPolicies, no deny rules

Ports theia_tpu/analytics/npr.py. The numeric step is the DISTINCT
over the 9-tuple, run on `device=` (default "cuda") for large windows
by the port's `npr_device.device_distinct` (a lexicographic sort and
a segment sum); everything after operates on the (small) deduplicated
set and is host-side string/YAML work, as in the reference, verbatim.
Only `read_distinct_flows` and `run_npr` differ from the reference:
they take `device=` for the one-device DISTINCT; a mesh shards it
over the mesh's devices (npr_device.make_sharded_distinct).
"""

from __future__ import annotations

import datetime
import uuid
from typing import Dict, List, Optional, Sequence

import numpy as np

from ..schema import ColumnarBatch
from ..store import FlowDatabase
from ..utils.device import auto_mesh, resolve_device
from . import policy_gen
from .npr_device import device_distinct
from .policy_gen import (
    KIND_ACG,
    KIND_ACNP,
    KIND_ANP,
    KIND_KNP,
    ROW_DELIMITER,
)
from .series import remove_meaningless_labels

NAMESPACE_ALLOW_LIST = ["kube-system", "flow-aggregator", "flow-visibility"]

FLOW_TABLE_COLUMNS = (
    "sourcePodNamespace", "sourcePodLabels", "destinationIP",
    "destinationPodNamespace", "destinationPodLabels",
    "destinationServicePortName", "destinationTransportPort",
    "protocolIdentifier", "flowType",
)


def get_protocol_string(protocol: int) -> str:
    return {6: "TCP", 17: "UDP"}.get(int(protocol), "UNKNOWN")


def get_flow_type(flow_type: int, svc_port_name: str,
                  dst_pod_labels: str) -> str:
    if flow_type == 3:
        return "pod_to_external"
    if svc_port_name != "":
        return "pod_to_svc"
    if dst_pod_labels != "":
        return "pod_to_pod"
    return "pod_to_external"


def read_distinct_flows(flows: ColumnarBatch,
                        limit: int = 0,
                        start_time: Optional[int] = None,
                        end_time: Optional[int] = None,
                        unprotected: bool = True,
                        rm_labels: bool = True,
                        mesh=None,
                        use_device=None,
                        device="cuda") -> List[Dict[str, object]]:
    """SELECT DISTINCT 9 columns with the job's WHERE clause
    (generate_sql_query :785-802). The distinct runs vectorized over
    dictionary codes; decode happens only for the surviving rows."""
    mask = np.ones(len(flows), dtype=bool)
    if unprotected:
        # '' is always dictionary code 0.
        mask &= np.asarray(flows["ingressNetworkPolicyName"]) == 0
        mask &= np.asarray(flows["egressNetworkPolicyName"]) == 0
    else:
        mask &= np.asarray(flows["trusted"]) == 1
    if start_time is not None:
        mask &= np.asarray(flows["flowStartSeconds"]) >= start_time
    if end_time is not None:
        mask &= np.asarray(flows["flowEndSeconds"]) < end_time
    # Materialize only the 9 queried columns (same narrow-column rule
    # as the series tensorize: filtering all 52 costs more than the
    # distinct kernel it feeds).
    col = flows.column_selector(mask)
    keys = np.stack([col(c) for c in FLOW_TABLE_COLUMNS], axis=1)
    uniq, _counts = device_distinct(keys, use_device=use_device,
                                    mesh=mesh, device=device)

    rows: List[Dict[str, object]] = []
    for r in uniq:
        row: Dict[str, object] = {}
        for i, c in enumerate(FLOW_TABLE_COLUMNS):
            if c in flows.dicts:
                row[c] = flows.dicts[c].decode_one(int(r[i]))
            else:
                row[c] = int(r[i])
        rows.append(row)

    if rm_labels:
        # The reference rewrites labels then dropDuplicates on the two
        # label columns ONLY (read_flow_df :815-830) — a quirk we keep.
        seen = set()
        deduped = []
        for row in rows:
            row["sourcePodLabels"] = remove_meaningless_labels(
                str(row["sourcePodLabels"]))
            row["destinationPodLabels"] = remove_meaningless_labels(
                str(row["destinationPodLabels"]))
            key = (row["sourcePodLabels"], row["destinationPodLabels"])
            if key not in seen:
                seen.add(key)
                deduped.append(row)
        rows = deduped

    for row in rows:
        row["flowType"] = get_flow_type(
            int(row["flowType"]), str(row["destinationServicePortName"]),
            str(row["destinationPodLabels"]))
    if limit:
        rows = rows[:limit]
    return rows


# -- peer mapping (reference map_flow_to_* :119-171) ---------------------

def map_flow_to_egress(flow: Dict[str, object], k8s: bool = False) -> tuple:
    src = ROW_DELIMITER.join([str(flow["sourcePodNamespace"]),
                              str(flow["sourcePodLabels"])])
    if flow["flowType"] == "pod_to_external":
        dst = ROW_DELIMITER.join([
            str(flow["destinationIP"]),
            str(flow["destinationTransportPort"]),
            get_protocol_string(int(flow["protocolIdentifier"]))])
    elif flow["flowType"] == "pod_to_svc" and not k8s:
        svc_ns, svc_name = str(
            flow["destinationServicePortName"]).partition(":")[0].split("/")
        dst = ROW_DELIMITER.join([svc_ns, svc_name])
    else:
        dst = ROW_DELIMITER.join([
            str(flow["destinationPodNamespace"]),
            str(flow["destinationPodLabels"]),
            str(flow["destinationTransportPort"]),
            get_protocol_string(int(flow["protocolIdentifier"]))])
    return src, dst


def map_flow_to_egress_svc(flow: Dict[str, object]) -> tuple:
    src = ROW_DELIMITER.join([str(flow["sourcePodNamespace"]),
                              str(flow["sourcePodLabels"])])
    dst = ROW_DELIMITER.join([
        str(flow["destinationServicePortName"]),
        str(flow["destinationTransportPort"]),
        get_protocol_string(int(flow["protocolIdentifier"]))])
    return src, dst


def map_flow_to_ingress(flow: Dict[str, object]) -> tuple:
    src = ROW_DELIMITER.join([
        str(flow["sourcePodNamespace"]), str(flow["sourcePodLabels"]),
        str(flow["destinationTransportPort"]),
        get_protocol_string(int(flow["protocolIdentifier"]))])
    dst = ROW_DELIMITER.join([str(flow["destinationPodNamespace"]),
                              str(flow["destinationPodLabels"])])
    return dst, src


def aggregate_peers(flows: Sequence[Dict[str, object]], k8s: bool,
                    to_services: bool):
    """The reduceByKey stage: appliedTo group → (ingress set, egress set).

    Returns (network_peers, svc_egress) where network_peers maps
    applied_to → {"ingress": [...], "egress": [...]}, and svc_egress maps
    applied_to → [svc egress tuples] (populated only when to_services is
    False and k8s is False, reference :662-679)."""
    peers: Dict[str, Dict[str, List[str]]] = {}
    svc_egress: Dict[str, List[str]] = {}

    def entry(key: str) -> Dict[str, List[str]]:
        return peers.setdefault(key, {"ingress": [], "egress": []})

    for flow in flows:
        if flow["flowType"] != "pod_to_external":
            dst, src = map_flow_to_ingress(flow)
            entry(dst)["ingress"].append(src)
        if not k8s and not to_services and flow["flowType"] == "pod_to_svc":
            src, dst = map_flow_to_egress_svc(flow)
            svc_egress.setdefault(src, []).append(dst)
        else:
            src, dst = map_flow_to_egress(flow, k8s=k8s)
            entry(src)["egress"].append(dst)
    return peers, svc_egress


# -- recommendation passes (reference :621-734) --------------------------

def _allowed(applied_to: str, ns_allow_list: Sequence[str]) -> bool:
    ns = applied_to.split(ROW_DELIMITER)[0]
    return ns in ns_allow_list


def recommend_k8s_policies(flows, ns_allow_list) -> Dict[str, List[str]]:
    peers, _ = aggregate_peers(flows, k8s=True, to_services=True)
    knps = []
    for applied_to, io in sorted(peers.items()):
        if _allowed(applied_to, ns_allow_list):
            continue
        p = policy_gen.generate_k8s_np(
            applied_to, io["ingress"], io["egress"])
        if p:
            knps.append(p)
    return {KIND_KNP: knps}


def recommend_antrea_policies(flows, ns_allow_list, option: int = 1,
                              deny_rules: bool = True,
                              to_services: bool = True
                              ) -> Dict[str, List[str]]:
    peers, svc_egress = aggregate_peers(flows, k8s=False,
                                        to_services=to_services)
    anps, cgs, acnps = [], [], []
    for applied_to, io in sorted(peers.items()):
        if _allowed(applied_to, ns_allow_list):
            continue
        p = policy_gen.generate_anp(
            applied_to, io["ingress"], io["egress"])
        if p:
            anps.append(p)

    if not to_services:
        svc_names = sorted({
            str(f["destinationServicePortName"]) for f in flows
            if f["flowType"] == "pod_to_svc"})
        for svc in svc_names:
            svc_ns = svc.partition(":")[0].split("/")[0]
            if svc_ns in ns_allow_list:
                continue
            cgs.append(policy_gen.generate_svc_cg(svc))
        for applied_to, egresses in sorted(svc_egress.items()):
            if _allowed(applied_to, ns_allow_list):
                continue
            p = policy_gen.generate_svc_acnp(applied_to, egresses)
            if p:
                acnps.append(p)

    if deny_rules:
        if option == 1:
            groups = sorted(set(peers) | set(svc_egress))
            for applied_to in groups:
                if _allowed(applied_to, ns_allow_list):
                    continue
                p = policy_gen.generate_reject_acnp(applied_to)
                if p:
                    acnps.append(p)
        else:
            acnps.append(policy_gen.generate_reject_acnp(""))
    return {KIND_ANP: anps, KIND_ACG: cgs, KIND_ACNP: acnps}


def recommend_policies_for_unprotected_flows(
        flows, ns_allow_list, option: int = 1,
        to_services: bool = True) -> Dict[str, List[str]]:
    if option not in (1, 2, 3):
        raise ValueError(f"option must be 1, 2 or 3, got {option}")
    if option == 3:
        return recommend_k8s_policies(flows, ns_allow_list)
    return recommend_antrea_policies(
        flows, ns_allow_list, option, deny_rules=True,
        to_services=to_services)


def recommend_policies_for_ns_allow_list(ns_allow_list
                                         ) -> Dict[str, List[str]]:
    return {KIND_ACNP: [policy_gen.generate_ns_allow_acnp(ns)
                        for ns in ns_allow_list]}


def merge_policy_dict(a: Dict[str, List[str]],
                      b: Dict[str, List[str]]) -> Dict[str, List[str]]:
    for k, v in b.items():
        a[k] = a.get(k, []) + v
    return a


# -- job entry points (reference :880-1017) ------------------------------

def run_npr(db: FlowDatabase,
            recommendation_type: str = "initial",
            limit: int = 0,
            option: int = 1,
            start_time: Optional[int] = None,
            end_time: Optional[int] = None,
            ns_allow_list: Optional[Sequence[str]] = None,
            rm_labels: bool = True,
            to_services: bool = True,
            recommendation_id: Optional[str] = None,
            now: Optional[datetime.datetime] = None,
            progress=None, mesh="auto", device="cuda") -> str:
    """Run a full NPR job against the database; returns the job id.

    `mesh`: "auto" shards the DISTINCT kernel over every visible card
    when `device` is a card (utils.device.auto_mesh; one-card hosts
    keep the one-device path on `device`), None forces one device, or
    pass an explicit mesh. Any mesh is flattened onto a rows axis for
    the distinct shuffle. Without a mesh the DISTINCT runs on `device`
    once the window is large enough (THEIA_NPR_DEVICE, see
    npr_device.device_distinct).
    """
    if recommendation_type not in ("initial", "subsequent"):
        raise ValueError(
            f"type must be initial|subsequent, got {recommendation_type}")
    use_device = None
    if isinstance(mesh, str):
        if mesh != "auto":
            raise ValueError(
                f"mesh must be 'auto', None or a Mesh, got {mesh!r} "
                f"(use THEIA_MESH=off to disable sharding)")
        mesh = auto_mesh(device)
    elif mesh is not None:
        # An explicitly passed mesh is an opt-in to the device
        # distinct — don't gate it behind the auto size threshold.
        use_device = True
    if mesh is not None:
        from ..parallel import make_rows_mesh
        mesh = make_rows_mesh(devices=mesh.devices.flatten())
    else:
        resolve_device(device)
    ns_allow_list = list(ns_allow_list if ns_allow_list is not None
                         else NAMESPACE_ALLOW_LIST)
    recommendation_id = recommendation_id or str(uuid.uuid4())

    if progress:
        progress.stage("read")
    flows = db.flows.scan()
    unprotected = read_distinct_flows(
        flows, limit, start_time, end_time, unprotected=True,
        rm_labels=rm_labels, mesh=mesh, use_device=use_device,
        device=device)

    if progress:
        progress.stage("recommend")
    if recommendation_type == "initial":
        result = merge_policy_dict(
            recommend_policies_for_ns_allow_list(ns_allow_list),
            recommend_policies_for_unprotected_flows(
                unprotected, ns_allow_list, option, to_services))
    else:
        result = recommend_policies_for_unprotected_flows(
            unprotected, ns_allow_list, option, to_services)
        if option in (1, 2):
            trusted = read_distinct_flows(
                flows, limit, start_time, end_time, unprotected=False,
                rm_labels=rm_labels, mesh=mesh, use_device=use_device,
                device=device)
            result = merge_policy_dict(
                result,
                recommend_antrea_policies(
                    trusted, ns_allow_list, option, deny_rules=False,
                    to_services=to_services))

    if progress:
        progress.stage("write")
    time_created = (now or datetime.datetime.now(datetime.timezone.utc))
    rows = [{
        "id": recommendation_id,
        "type": recommendation_type,
        "timeCreated": int(time_created.timestamp()),
        "policy": policy,
        "kind": kind,
    } for kind, policies in result.items() for policy in policies if policy]
    db.recommendations.insert_rows(rows)
    if progress:
        progress.done()
    return recommendation_id
