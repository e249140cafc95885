"""Grafana dashboard JSON export.

The reference provisions eight Grafana dashboards as JSON
(build/charts/theia/provisioning/dashboards/*.json) with three custom
panel plugins (ids theia-grafana-{sankey,chord,dependency}-plugin).
This module emits dashboards in the same document shape — title, uid,
panels with gridPos and the reference's panel-type ids — so an
operator running a real Grafana (with the reference's panel plugins
and a JSON API datasource) can import the export and point it at this
manager's `/dashboards/api/<name>` endpoints, which serve the
underlying data.

Served as `GET /dashboards/api/<name>?format=grafana`.
"""

from __future__ import annotations

import hashlib
from typing import Dict, List

from . import queries

#: dashboard name → list of (panel title, panel type, data field)
#: panel types: the reference's custom plugin ids + core Grafana types
_PANELS: Dict[str, List] = {
    "homepage": [
        ("Cluster summary", "stat", ""),
        ("Top namespaces by traffic", "bargauge", "topNamespaces"),
        ("Cluster throughput", "timeseries", "throughput"),
    ],
    "flow_records": [
        ("Flow records", "table", ""),
    ],
    "pod_to_pod": [
        ("Pod-to-pod traffic", "theia-grafana-sankey-plugin", "links"),
        ("Throughput", "timeseries", "throughput"),
        ("Top sources", "piechart", "topSources"),
    ],
    "pod_to_service": [
        ("Pod-to-service traffic", "theia-grafana-sankey-plugin",
         "links"),
        ("Throughput", "timeseries", "throughput"),
        ("Top sources", "piechart", "topSources"),
    ],
    "pod_to_external": [
        ("Pod-to-external traffic", "theia-grafana-sankey-plugin",
         "links"),
        ("Throughput", "timeseries", "throughput"),
        ("Top sources", "piechart", "topSources"),
    ],
    "node_to_node": [
        ("Node-to-node traffic", "theia-grafana-sankey-plugin",
         "links"),
        ("Throughput", "timeseries", "throughput"),
    ],
    "networkpolicy": [
        ("Cumulative bytes of flows with NetworkPolicy information",
         "theia-grafana-chord-plugin", "chord"),
        ("Bytes by rule action", "piechart", "byAction"),
    ],
    "network_topology": [
        ("Network topology", "theia-grafana-dependency-plugin",
         "edges"),
    ],
}


def _uid(name: str) -> str:
    return "theia-" + hashlib.sha1(name.encode()).hexdigest()[:8]


def grafana_dashboard(name: str) -> Dict[str, object]:
    """One dashboard as a Grafana-importable JSON document. A
    dashboard present in queries.DASHBOARDS but without a curated
    panel layout exports as a generic table panel over its data —
    new dashboards never 404 here just because this map lagged."""
    if name not in queries.DASHBOARDS:
        raise KeyError(name)
    layout = _PANELS.get(
        name, [(name.replace("_", " "), "table", "")])
    panels = []
    y = 0
    for i, (title, ptype, field) in enumerate(layout):
        h, w = (10, 12) if ptype != "table" else (16, 24)
        panels.append({
            "id": i + 1,
            "title": title,
            "type": ptype,
            "gridPos": {"h": h, "w": w,
                        "x": (i % 2) * 12, "y": y},
            "datasource": {"type": "marcusolsson-json-datasource",
                           "uid": "theia-manager"},
            "targets": [{
                "refId": "A",
                # the JSON API datasource fetches this path relative
                # to its configured base URL (the manager address)
                "urlPath": f"/dashboards/api/{name}",
                "fields": [{"jsonPath": f"$.data.{field}" if field
                            else "$.data"}],
            }],
        })
        if i % 2 == 1:
            y += h
    return {
        "title": f"theia-tpu {name.replace('_', ' ')}",
        "uid": _uid(name),
        "tags": ["theia", "flow-visibility"],
        "timezone": "browser",
        "schemaVersion": 39,
        "version": 1,
        "editable": True,
        "time": {"from": "now-12h", "to": "now"},
        "panels": panels,
    }


def grafana_dashboards() -> Dict[str, Dict[str, object]]:
    """Every dashboard (the provisioning-directory equivalent) —
    driven by queries.DASHBOARDS so additions export automatically."""
    return {name: grafana_dashboard(name)
            for name in queries.DASHBOARDS}
