"""Dashboard read-path queries over the flow store.

Re-provides the data behind the reference's eight Grafana dashboards
(build/charts/theia/provisioning/dashboards/*.json, inventory at SURVEY
§2.5): homepage summary stats, raw flow records, pod-to-pod /
pod-to-service / pod-to-external / node-to-node sankey+timeseries,
networkpolicy chord, and the network-topology dependency graph. The
reference's panels run rawSql against the flows*_view ClickHouse tables
with $__timeFilter macros; here each function reads the equivalent
materialized view (store/views.py) and reduces over dictionary codes —
same data contract, no SQL engine in the path.

Every function returns plain-JSON data (lists/dicts), consumed by both
the HTML renderer (web.py) and the /dashboards/api endpoints.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..store import FlowDatabase
from ..store.views import group_reduce

FLOW_TYPE_TO_EXTERNAL = 3


def _view_scan(db, name: str):
    """One materialized view in the ViewTable.scan() shape, routed by
    THEIA_DASHBOARD_ROLLUP: unset/0 reads the legacy in-memory view
    table; `1` reads the rollup-backed `__rollup__:<view>` aggregate
    parts (query/rollup.py — the view must be declared, e.g. via
    THEIA_ROLLUP_DEFAULTS=1, else legacy serves); `assert` reads the
    rollup path AND verifies it group-for-group against the legacy
    table (the migration parity gate — raises on divergence)."""
    mode = os.environ.get("THEIA_DASHBOARD_ROLLUP",
                          "").strip().lower()
    if mode in ("", "0", "off", "false", "no"):
        return db.views[name].scan()
    from ..query import rollup as _rollup
    batch = _rollup.view_scan_batch(db, name)
    if batch is None:
        return db.views[name].scan()
    if mode == "assert":
        _rollup.assert_view_parity(batch, db.views[name].scan(), name)
    return batch

# NetworkPolicy rule-action codes (reference schema: 0 none, 1 allow,
# 2 drop, 3 reject) — single source for every dashboard consumer.
RULE_ACTION_LABELS = {0: "none", 1: "allow", 2: "drop", 3: "reject"}
DENY_RULE_ACTIONS = (2, 3)


def _top_links(keys: np.ndarray, values: np.ndarray, names_a, names_b,
               k: int) -> List[Dict[str, object]]:
    """Aggregate (a, b) → sum(value), return the top-k as sankey links."""
    gk, gv = group_reduce(keys, values[:, None])
    order = np.argsort(-gv[:, 0])[:k]
    return [{"source": str(names_a[gk[i, 0]]),
             "target": str(names_b[gk[i, 1]]),
             "value": int(gv[i, 0])} for i in order]


def _decode_table(dicts, name):
    return np.asarray(dicts[name]._strings, dtype=object)


def _time_window(col: np.ndarray, start: Optional[int],
                 end: Optional[int]) -> np.ndarray:
    mask = np.ones(len(col), bool)
    if start is not None:
        mask &= col >= start
    if end is not None:
        mask &= col < end
    return mask


def _throughput_series(times: np.ndarray, groups: np.ndarray,
                       values: np.ndarray, names, k: int
                       ) -> Dict[str, object]:
    """Per-group throughput over time for the top-k groups by volume.
    Fully vectorized (unique + bincount) — this runs on every dashboard
    render over the whole selected window."""
    if len(times) == 0:
        return {"times": [], "series": {}}
    values = np.asarray(values, np.float64)
    uniq_g, g_inv = np.unique(groups, return_inverse=True)
    totals = np.bincount(g_inv, weights=values)
    top = np.argsort(-totals)[:k]
    t_axis, t_inv = np.unique(times, return_inverse=True)
    series = {}
    for gi in top:
        sel = g_inv == gi
        ys = np.bincount(t_inv[sel], weights=values[sel],
                         minlength=len(t_axis))
        series[str(names[uniq_g[gi]])] = ys.astype(np.int64).tolist()
    return {"times": t_axis.tolist(), "series": series}


def homepage(db: FlowDatabase) -> Dict[str, object]:
    """Cluster summary (reference homepage.json: 12 stat panels +
    bargauge of top namespaces + cluster-throughput timeseries +
    dashlist — the dashlist is the nav bar on every page)."""
    flows = db.flows.scan()
    out: Dict[str, object] = {
        "flowCount": len(flows),
        "tadAnomalies": 0,
        "recommendations": 0,
        "droppedFlowCount": 0,
        "topNamespaces": [],
        "throughput": {"times": [], "series": {}},
    }
    if len(flows):
        for stat, col in (("podCount", "sourcePodName"),
                          ("namespaceCount", "sourcePodNamespace"),
                          ("nodeCount", "sourceNodeName"),
                          ("serviceCount", "destinationServicePortName"),
                          ("clusterCount", "clusterUUID")):
            codes = np.unique(np.asarray(flows[col]))
            out[stat] = int((codes != 0).sum())
        out["totalBytes"] = int(flows["octetDeltaCount"].sum())
        out["currentThroughput"] = int(
            flows["throughput"][flows["timeInserted"]
                                == flows["timeInserted"].max()].sum())
        ingress = np.asarray(flows["ingressNetworkPolicyRuleAction"])
        egress = np.asarray(flows["egressNetworkPolicyRuleAction"])
        out["droppedFlowCount"] = int(
            (np.isin(ingress, DENY_RULE_ACTIONS)
             | np.isin(egress, DENY_RULE_ACTIONS)).sum())
        # bargauge: top namespaces by traffic volume
        ns = np.asarray(flows["sourcePodNamespace"], np.int64)
        octets = np.asarray(flows["octetDeltaCount"], np.float64)
        names = flows.dicts["sourcePodNamespace"]
        totals = np.bincount(ns, weights=octets)
        if len(totals):
            totals[0] = 0              # code 0 == '' (no namespace)
        top = np.argsort(-totals)[:8]
        out["topNamespaces"] = [
            {"name": names.decode_one(int(g)), "value": int(totals[g])}
            for g in top if totals[g] > 0]
        # timeseries: cluster-wide throughput (one constant group)
        out["throughput"] = _throughput_series(
            np.asarray(flows["flowEndSeconds"], np.int64),
            np.zeros(len(flows), np.int64),
            np.asarray(flows["throughput"], np.int64),
            {0: "cluster"}, 1)
    tad = db.tadetector.scan()
    if len(tad):
        out["tadAnomalies"] = int(
            (tad.strings("anomaly") == "true").sum())
    out["dropAnomalies"] = len(db.dropdetection)
    out["recommendations"] = len(db.recommendations)
    return out


def flow_records(db: FlowDatabase, limit: int = 100,
                 start: Optional[int] = None,
                 end: Optional[int] = None) -> List[Dict[str, object]]:
    """Raw recent records (reference flow_records_dashboard.json:90)."""
    flows = db.flows.scan()
    mask = _time_window(np.asarray(flows["flowEndSeconds"]), start, end)
    sub = flows.filter(mask)
    order = np.argsort(-np.asarray(sub["flowEndSeconds"]))[:limit]
    cols = ("flowEndSeconds", "sourcePodNamespace", "sourcePodName",
            "destinationPodNamespace", "destinationPodName",
            "destinationIP", "destinationTransportPort",
            "destinationServicePortName", "protocolIdentifier",
            "throughput", "octetDeltaCount",
            "ingressNetworkPolicyName", "egressNetworkPolicyName")
    picked = sub.take(order).select(list(cols))
    return picked.to_rows()


def _pair_view(db: FlowDatabase, a_col: str, b_col: str,
               row_filter, k: int, start, end) -> Dict[str, object]:
    view = _view_scan(db, "flows_pod_view")
    mask = _time_window(np.asarray(view["flowEndSeconds"]), start, end)
    mask &= row_filter(view)
    a = np.asarray(view[a_col], np.int64)[mask]
    b = np.asarray(view[b_col], np.int64)[mask]
    thr = np.asarray(view["throughput"], np.int64)[mask]
    octets = np.asarray(view["octetDeltaCount"], np.int64)[mask]
    t = np.asarray(view["flowEndSeconds"], np.int64)[mask]
    names_a = _decode_table(view.dicts, a_col)
    names_b = _decode_table(view.dicts, b_col)

    links = _top_links(np.stack([a, b], axis=1), octets,
                       names_a, names_b, k)
    ts = _throughput_series(t, a, thr, names_a, k)
    totals_a: Dict[str, int] = {}
    for code, v in zip(a.tolist(), octets.tolist()):
        key = str(names_a[code])
        totals_a[key] = totals_a.get(key, 0) + v
    pie = sorted(totals_a.items(), key=lambda kv: -kv[1])[:k]
    return {"links": links, "throughput": ts,
            "topSources": [{"name": n, "value": v} for n, v in pie]}


def pod_to_pod(db: FlowDatabase, k: int = 10, start=None, end=None):
    return _pair_view(
        db, "sourcePodName", "destinationPodName",
        lambda v: (np.asarray(v["sourcePodName"]) != 0)
        & (np.asarray(v["destinationPodName"]) != 0), k, start, end)


def pod_to_service(db: FlowDatabase, k: int = 10, start=None, end=None):
    return _pair_view(
        db, "sourcePodName", "destinationServicePortName",
        lambda v: np.asarray(v["destinationServicePortName"]) != 0,
        k, start, end)


def pod_to_external(db: FlowDatabase, k: int = 10, start=None,
                    end=None):
    return _pair_view(
        db, "sourcePodName", "destinationIP",
        lambda v: np.asarray(v["flowType"]) == FLOW_TYPE_TO_EXTERNAL,
        k, start, end)


def node_to_node(db: FlowDatabase, k: int = 10, start=None, end=None):
    view = _view_scan(db, "flows_node_view")
    mask = _time_window(np.asarray(view["flowEndSeconds"]), start, end)
    mask &= (np.asarray(view["sourceNodeName"]) != 0) \
        & (np.asarray(view["destinationNodeName"]) != 0)
    a = np.asarray(view["sourceNodeName"], np.int64)[mask]
    b = np.asarray(view["destinationNodeName"], np.int64)[mask]
    octets = np.asarray(view["octetDeltaCount"], np.int64)[mask]
    thr = np.asarray(view["throughput"], np.int64)[mask]
    t = np.asarray(view["flowEndSeconds"], np.int64)[mask]
    names_a = _decode_table(view.dicts, "sourceNodeName")
    names_b = _decode_table(view.dicts, "destinationNodeName")
    return {"links": _top_links(np.stack([a, b], axis=1), octets,
                                names_a, names_b, k),
            "throughput": _throughput_series(t, a, thr, names_a, k)}


def networkpolicy(db: FlowDatabase, k: int = 10, start=None, end=None):
    """Policy traffic chord (reference networkpolicy_dashboard.json):
    bytes per (egress policy, ingress policy) pair + allow/deny split."""
    view = _view_scan(db, "flows_policy_view")
    mask = _time_window(np.asarray(view["flowEndSeconds"]), start, end)
    eg = np.asarray(view["egressNetworkPolicyName"], np.int64)[mask]
    ing = np.asarray(view["ingressNetworkPolicyName"], np.int64)[mask]
    octets = np.asarray(view["octetDeltaCount"], np.int64)[mask]
    eg_act = np.asarray(view["egressNetworkPolicyRuleAction"],
                        np.int64)[mask]
    names_e = _decode_table(view.dicts, "egressNetworkPolicyName")
    names_i = _decode_table(view.dicts, "ingressNetworkPolicyName")
    has_policy = (eg != 0) | (ing != 0)
    links = _top_links(np.stack([eg[has_policy], ing[has_policy]], axis=1), octets[has_policy],
                       names_e, names_i, k)
    by_action: Dict[str, int] = {}
    for act, v in zip(eg_act.tolist(), octets.tolist()):
        label = RULE_ACTION_LABELS.get(act, str(act))
        by_action[label] = by_action.get(label, 0) + v
    return {"chord": links,
            "byAction": [{"name": n, "value": v}
                         for n, v in sorted(by_action.items())]}


def network_topology(db: FlowDatabase, start=None, end=None):
    """Namespace-level dependency edges (reference
    network_topology_dashboard's mermaid graph, DependencyPanel.tsx)."""
    flows = db.flows.scan()
    mask = _time_window(np.asarray(flows["flowEndSeconds"]), start, end)
    src = np.asarray(flows["sourcePodNamespace"], np.int64)[mask]
    dst_ns = np.asarray(flows["destinationPodNamespace"],
                        np.int64)[mask]
    ftype = np.asarray(flows["flowType"])[mask]
    octets = np.asarray(flows["octetDeltaCount"], np.int64)[mask]
    names = _decode_table(flows.dicts, "sourcePodNamespace")
    dst_names = _decode_table(flows.dicts, "destinationPodNamespace")

    edges: Dict[Tuple[str, str], int] = {}
    for s, d, ft, v in zip(src.tolist(), dst_ns.tolist(),
                           ftype.tolist(), octets.tolist()):
        a = str(names[s]) or "(unknown)"
        b = ("external" if ft == FLOW_TYPE_TO_EXTERNAL
             else str(dst_names[d]) or "(unknown)")
        edges[(a, b)] = edges.get((a, b), 0) + v
    return {"edges": [{"source": a, "target": b, "value": v}
                      for (a, b), v in sorted(edges.items())]}


DASHBOARDS = {
    "homepage": homepage,
    "flow_records": flow_records,
    "pod_to_pod": pod_to_pod,
    "pod_to_service": pod_to_service,
    "pod_to_external": pod_to_external,
    "node_to_node": node_to_node,
    "networkpolicy": networkpolicy,
    "network_topology": network_topology,
}
