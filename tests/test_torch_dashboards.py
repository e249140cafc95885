"""Port parity: the dashboards (queries, SVG pages, Grafana export and
the manager's /dashboards routes), theia_tpu_torch against theia_tpu,
on the CPU.

The cases of tests/test_dashboards.py run against the port's copy of
the dashboards package over the port's FlowDatabase and against a port
`TheiaManagerServer(device="cpu")`; `GET /dashboards/*` answers 200 on
the port. Each query and each page is also held equal to the
reference's over the same flows: the dashboards are host code, and the
two packages' stores hold the same rows with the same dictionary
codes, so every number and every byte of a page is equal.
"""

from __future__ import annotations

import json
import urllib.request

import pytest

from theia_tpu import dashboards as ref_dashboards
from theia_tpu.dashboards import queries as ref_queries
from theia_tpu.data.synth import SynthConfig as RefSynth
from theia_tpu.data.synth import generate_flows as ref_generate
from theia_tpu.manager import TheiaManagerServer as RefServer
from theia_tpu.store import FlowDatabase as RefDatabase
from theia_tpu_torch.dashboards import DASHBOARDS, queries, render
from theia_tpu_torch.data.synth import SynthConfig, generate_flows
from theia_tpu_torch.manager import TheiaManagerServer
from theia_tpu_torch.store import FlowDatabase
from test_torch_analysis import port_lockdep_clean  # noqa: F401

SYNTH = dict(n_series=32, points_per_series=12, service_fraction=0.3,
             external_fraction=0.2, protected_fraction=0.4, seed=17)


def _port_db():
    db = FlowDatabase()
    db.insert_flows(generate_flows(SynthConfig(**SYNTH)))
    return _fill(db)


def _ref_db():
    db = RefDatabase()
    db.insert_flows(ref_generate(RefSynth(**SYNTH)))
    return _fill(db)


def _fill(db):
    db.tadetector.insert_rows([{"id": "x", "anomaly": "true"}])
    db.recommendations.insert_rows([{"id": "r", "kind": "anp",
                                     "policy": "kind: NetworkPolicy"}])
    return db


@pytest.fixture(scope="module")
def db():
    return _port_db()


@pytest.fixture(scope="module")
def ref_db():
    return _ref_db()


@pytest.fixture(scope="module")
def server():
    """A port manager over a store of its own: its job controller
    collects the result rows no job of its own wrote."""
    srv = TheiaManagerServer(_port_db(), port=0, ingest_shards=1,
                             device="cpu")
    srv.start_background()
    yield srv
    srv.shutdown()


def _open(srv, path):
    return urllib.request.urlopen(
        f"http://127.0.0.1:{srv.port}{path}", timeout=10)


# -- the cases of tests/test_dashboards.py --------------------------------

def test_homepage_stats(db):
    stats = queries.homepage(db)
    assert stats["flowCount"] == 32 * 12
    assert stats["podCount"] > 0 and stats["namespaceCount"] > 0
    assert stats["serviceCount"] > 0 and stats["clusterCount"] == 1
    assert stats["tadAnomalies"] == 1
    assert stats["recommendations"] == 1
    assert stats["totalBytes"] > 0


def test_flow_records_sorted_and_limited(db):
    rows = queries.flow_records(db, limit=10)
    assert len(rows) == 10
    ends = [r["flowEndSeconds"] for r in rows]
    assert ends == sorted(ends, reverse=True)
    assert "sourcePodName" in rows[0]


def test_pod_to_pod_links_and_series(db):
    data = queries.pod_to_pod(db, k=5)
    assert 0 < len(data["links"]) <= 5
    for link in data["links"]:
        assert link["source"].startswith("pod-")
        assert link["target"].startswith("pod-")
        assert link["value"] > 0
    ts = data["throughput"]
    assert ts["times"] and ts["series"]


def test_pod_to_service_and_external(db):
    svc = queries.pod_to_service(db, k=5)
    assert all("/svc-" in l["target"] for l in svc["links"])
    ext = queries.pod_to_external(db, k=5)
    assert all(l["target"].startswith("203.0.113.")
               for l in ext["links"])


def test_node_to_node(db):
    data = queries.node_to_node(db, k=5)
    assert all(l["source"].startswith("node-") for l in data["links"])


def test_networkpolicy_chord(db):
    data = queries.networkpolicy(db, k=5)
    assert data["chord"], "protected flows should produce policy links"
    actions = {d["name"] for d in data["byAction"]}
    assert "allow" in actions or "none" in actions


def test_network_topology_edges(db):
    data = queries.network_topology(db)
    targets = {e["target"] for e in data["edges"]}
    assert "external" in targets
    assert any(t.startswith("ns-") for t in targets)


@pytest.mark.parametrize("name", list(DASHBOARDS))
def test_render_all_dashboards(db, name):
    page = render(name, db)
    assert page.startswith("<!doctype html>")
    assert "theia-tpu" in page
    if name not in ("homepage", "flow_records"):
        assert "<svg" in page


def test_manager_serves_dashboards(server):
    """C3: the port manager's /dashboards routes answer 200."""
    with _open(server, "/dashboards/pod_to_pod") as r:
        body = r.read().decode()
        assert r.status == 200
        assert "<svg" in body and r.headers["Content-Type"].startswith(
            "text/html")
    with _open(server, "/dashboards/api/homepage") as r:
        doc = json.loads(r.read())
    assert doc["data"]["flowCount"] == 32 * 12


def test_chord_renderer_is_a_real_chord(db):
    from theia_tpu_torch.dashboards.web import svg_chord
    links = [{"source": "a", "target": "b", "value": 100},
             {"source": "b", "target": "c", "value": 50},
             {"source": "c", "target": "a", "value": 25}]
    svg = svg_chord(links)
    assert svg.startswith("<svg") and "class='chord'" in svg
    assert svg.count("Q") >= 2 * len(links)
    assert svg.count("<path") == len(links) + 3
    for n in ("a", "b", "c"):
        assert f">{n}</text>" in svg
    page = render("networkpolicy", db)
    assert "class='chord'" in page
    assert "no data" in svg_chord([])


def test_grafana_dashboard_export(server):
    from theia_tpu_torch.dashboards import grafana_dashboards
    docs = grafana_dashboards()
    assert set(docs) == set(DASHBOARDS)
    np_doc = docs["networkpolicy"]
    types = {p["type"] for p in np_doc["panels"]}
    assert "theia-grafana-chord-plugin" in types
    assert all("gridPos" in p and "targets" in p
               for p in np_doc["panels"])
    sankey_types = {p["type"] for p in docs["pod_to_pod"]["panels"]}
    assert "theia-grafana-sankey-plugin" in sankey_types
    assert "theia-grafana-dependency-plugin" in {
        p["type"] for p in docs["network_topology"]["panels"]}
    uids = [d["uid"] for d in docs.values()]
    assert len(set(uids)) == len(uids)
    with _open(server, "/dashboards/api/networkpolicy?format=grafana") as r:
        doc = json.loads(r.read())
    assert doc["uid"] == np_doc["uid"]
    assert doc["panels"][0]["targets"][0]["urlPath"] == \
        "/dashboards/api/networkpolicy"


def test_dashboard_api_time_window_params(server):
    flows = server.controller.db.flows.scan()
    t0 = int(flows["flowEndSeconds"].min())
    with _open(server, f"/dashboards/api/flow_records?limit=3&"
                       f"end={t0 + 5}") as r:
        rows = json.loads(r.read())["data"]
    assert len(rows) == 3
    assert all(r["flowEndSeconds"] < t0 + 5 for r in rows)


def test_homepage_bargauge_and_timeseries(db):
    data = queries.homepage(db)
    assert data["topNamespaces"], "bargauge data expected"
    assert all(t["value"] > 0 for t in data["topNamespaces"])
    values = [t["value"] for t in data["topNamespaces"]]
    assert values == sorted(values, reverse=True)
    assert data["throughput"]["times"]
    assert "cluster" in data["throughput"]["series"]
    assert data["droppedFlowCount"] >= 0
    html = render("homepage", db)
    assert "top namespaces" in html and "cluster throughput" in html


# -- against the reference -----------------------------------------------

@pytest.mark.parametrize("name", list(DASHBOARDS))
def test_query_and_page_equal_reference(db, ref_db, name):
    """The same flows in both packages' stores: each dashboard's data
    and its rendered page are equal to the reference's."""
    assert list(DASHBOARDS) == list(ref_dashboards.DASHBOARDS)
    got = json.dumps(queries.DASHBOARDS[name](db), sort_keys=True,
                     default=str)
    want = json.dumps(ref_queries.DASHBOARDS[name](ref_db),
                      sort_keys=True, default=str)
    assert got == want
    assert render(name, db) == ref_dashboards.render(name, ref_db)


@pytest.mark.parametrize("path", [
    "/dashboards/network_topology",
    "/dashboards/api/pod_to_service?k=3",
    "/dashboards/api/homepage?format=grafana"])
def test_routes_answer_as_the_reference(server, path):
    ref = RefServer(_ref_db(), port=0)
    ref.start_background()
    try:
        with _open(server, path) as r, _open(ref, path) as w:
            assert r.status == w.status == 200
            assert r.headers["Content-Type"] == w.headers["Content-Type"]
            assert r.read() == w.read()
    finally:
        ref.shutdown()
