"""Port parity: the cluster halves of tests/test_tracing.py against
a routing mesh of port managers on the CPU (device="cpu").

Trace contexts must cross real sockets as `traceparent` headers, and
`/debug/traces?trace=` must fan the lookup out over the real cluster
transport; EXPLAIN over the distributed query and the heartbeat RTT
surface. As in the reference's matrix, the trace ring (and the node-id
stamp) is process-global in the in-process mesh, so these tests
assert trace-id propagation and span LINKAGE (remote parent span
ids). The reference's CLI cases (`theia top --cluster`, `theia trace`)
wait for the port's CLI.
"""

import json
import urllib.error
import urllib.request

import pytest

from theia_tpu_torch.data.synth import SynthConfig, generate_flows
from theia_tpu_torch.ingest import BlockEncoder
from theia_tpu_torch.ingest.client import IngestClient
from theia_tpu_torch.obs import metrics, trace
from theia_tpu_torch.query.explain import SLOW_QUERIES
from theia_tpu_torch.store import FlowDatabase
from test_torch_analysis import port_lockdep_clean  # noqa: F401
from test_torch_cluster import free_port, wait_until

pytestmark = pytest.mark.obs

TOKEN = "tracing-test-token"


@pytest.fixture(autouse=True)
def _clean_obs():
    metrics.enable()
    metrics.REGISTRY.zero()
    trace.reset()
    SLOW_QUERIES.reset()
    trace.set_node_id("")
    yield
    metrics.enable()
    trace.set_node_id("")


def make_mesh(n, monkeypatch, token=None):
    """n in-process role=peer managers on ephemeral ports."""
    from theia_tpu_torch.manager.api import TheiaManagerServer
    monkeypatch.setenv("THEIA_RETENTION_INTERVAL", "0")
    monkeypatch.setenv("THEIA_CLUSTER_HEARTBEAT", "0.05")
    monkeypatch.setenv("THEIA_CLUSTER_BOUNDS_INTERVAL", "0.02")
    ports = [free_port() for _ in range(n)]
    peers = ",".join(
        f"n{i}=http://127.0.0.1:{p}" for i, p in enumerate(ports))
    dbs, servers = [], []
    for i in range(n):
        db = FlowDatabase()
        dbs.append(db)
        srv = TheiaManagerServer(db, port=ports[i],
                                 cluster_peers=peers,
                                 cluster_self=f"n{i}",
                                 cluster_role="peer",
                                 auth_token=token, device="cpu")
        srv.start_background()
        servers.append(srv)
    return ports, dbs, servers


def shutdown_all(servers):
    for s in servers:
        try:
            s.shutdown()
        except Exception:
            pass


def _get_json(port, path, token=None):
    headers = {}
    if token is not None:
        headers["Authorization"] = f"Bearer {token}"
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}",
                                 headers=headers)
    with urllib.request.urlopen(req, timeout=30) as r:
        return json.load(r)


def post_query(port, doc, timeout=30):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/query",
        data=json.dumps(doc).encode(), method="POST")
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return json.load(r)


def wait_heartbeats(servers):
    def _synced():
        for srv in servers:
            cmap = srv.cluster.cmap
            for other in servers:
                oid = other.cluster.cmap.self_id
                if oid == cmap.self_id:
                    continue
                info = cmap.peer_info(oid).get("store") or {}
                if info.get("fingerprint") != \
                        other.queries.fingerprint_hash():
                    return False
        return True
    wait_until(_synced, what="heartbeat store-state sync")


# -- cross-node propagation over a real 3-node HTTP cluster ----------------

def test_routed_ingest_yields_one_stitched_trace(monkeypatch):
    """One producer batch through the router spreads rows to owner
    nodes over real HTTP; every hop's spans must share the producer
    request's trace id, and the stitched /debug/traces?trace= view —
    queried from ANY node — must contain exactly one root."""
    ports, dbs, servers = make_mesh(3, monkeypatch)
    try:
        enc = BlockEncoder()
        batch = generate_flows(SynthConfig(
            n_series=48, points_per_series=6, anomaly_fraction=0.0,
            seed=7), dicts=enc.dicts)
        client = IngestClient(f"http://127.0.0.1:{ports[0]}",
                              stream="traced")
        out = client.send(enc.encode(batch))
        assert min(len(db.flows) for db in dbs) > 0   # truly routed
        trace_id = out.get("traceId")
        assert trace_id and len(trace_id) == 32
        for port in ports:       # any node answers the stitched view
            doc = _get_json(port, f"/debug/traces?trace={trace_id}")
            spans = doc["spans"]
            assert spans and all(
                s["traceId"] == trace_id for s in spans)
            ingests = [s for s in spans
                       if s["op"] == "ingest.request"]
            # origin + one per remote owner that received a slice
            assert len(ingests) >= 2
            by_id = {s["spanId"] for s in spans}
            roots = [s for s in spans
                     if s.get("parentSpanId") not in by_id]
            assert len(roots) == 1           # ONE stitched tree
            assert roots[0]["op"] == "ingest.request"
            forwards = [s for s in spans
                        if s["op"] == "router.forward"]
            assert forwards                  # the hop spans exist
            # every forwarded ingest hangs off a router.forward
            fwd_ids = {s["spanId"] for s in forwards}
            remote_ingests = [s for s in ingests
                              if s is not roots[0]]
            assert all(s["parentSpanId"] in fwd_ids
                       for s in remote_ingests)
    finally:
        shutdown_all(servers)


def test_distributed_query_yields_one_stitched_trace(monkeypatch):
    ports, dbs, servers = make_mesh(3, monkeypatch)
    try:
        enc = BlockEncoder()
        client = IngestClient(f"http://127.0.0.1:{ports[0]}",
                              stream="qtrace")
        batch = generate_flows(SynthConfig(
            n_series=48, points_per_series=6, anomaly_fraction=0.0,
            seed=8), dicts=enc.dicts)
        client.send(enc.encode(batch))
        wait_heartbeats(servers)
        trace.reset()            # isolate the query's trace
        got = post_query(ports[1], {"groupBy": "destinationIP",
                                    "aggregates": ["count"],
                                    "cache": False})
        assert got["partial"] is False
        trace_id = got.get("traceId")
        assert trace_id
        doc = _get_json(ports[2], f"/debug/traces?trace={trace_id}")
        spans = doc["spans"]
        ops = [s["op"] for s in spans]
        assert ops.count("query.request") == 1      # ONE coordinator
        assert ops.count("query.partial") == 2      # both peers served
        by_id = {s["spanId"] for s in spans}
        roots = [s for s in spans
                 if s.get("parentSpanId") not in by_id]
        assert len(roots) == 1 and roots[0]["op"] == "query.request"
        fanouts = {s["spanId"] for s in spans
                   if s["op"] == "query.fanout"}
        partials = [s for s in spans if s["op"] == "query.partial"]
        assert all(s["parentSpanId"] in fanouts for s in partials)
    finally:
        shutdown_all(servers)


def test_trace_ring_zero_retains_nothing_cluster_wide(monkeypatch):
    """THEIA_TRACE_RING=0 keeps the promise under tracing: requests
    still ack (with a trace id — the context exists, propagation
    works), but no node retains a single span."""
    import collections
    monkeypatch.setattr(trace, "_ring", collections.deque(maxlen=0))
    ports, dbs, servers = make_mesh(2, monkeypatch)
    try:
        enc = BlockEncoder()
        out = IngestClient(f"http://127.0.0.1:{ports[0]}",
                           stream="noring").send(
            enc.encode(generate_flows(SynthConfig(
                n_series=24, points_per_series=5,
                anomaly_fraction=0.0, seed=9), dicts=enc.dicts)))
        trace_id = out.get("traceId")
        assert trace_id
        for port in ports:
            doc = _get_json(port, f"/debug/traces?trace={trace_id}")
            assert doc["spans"] == []
    finally:
        shutdown_all(servers)


def test_debug_traces_trace_param_token_gated(monkeypatch):
    ports, dbs, servers = make_mesh(2, monkeypatch, token=TOKEN)
    try:
        def code_of(path, token=None):
            try:
                _get_json(ports[0], path, token=token)
                return 200
            except urllib.error.HTTPError as e:
                return e.code
        assert code_of("/debug/traces?trace=" + "a" * 32) == 401
        assert code_of("/debug/traces?trace=" + "a" * 32,
                       token="wrong") == 403
        assert code_of("/debug/traces?trace=" + "a" * 32,
                       token=TOKEN) == 200
        assert code_of("/debug/slow_queries") == 401
        assert code_of("/debug/slow_queries", token=TOKEN) == 200
    finally:
        shutdown_all(servers)


def test_explain_over_http_and_distributed(monkeypatch):
    ports, dbs, servers = make_mesh(2, monkeypatch)
    try:
        enc = BlockEncoder()
        IngestClient(f"http://127.0.0.1:{ports[0]}",
                     stream="exp").send(enc.encode(generate_flows(
                         SynthConfig(n_series=32, points_per_series=6,
                                     anomaly_fraction=0.0, seed=21),
                         dicts=enc.dicts)))
        wait_heartbeats(servers)
        doc = {"groupBy": "destinationIP", "aggregates": ["count"],
               "cache": False}
        plain = post_query(ports[0], doc)
        explained = post_query(ports[0], {**doc, "explain": True})
        assert explained["rows"] == plain["rows"]
        assert "profile" not in plain
        prof = explained["profile"]
        assert prof["engine"] == "cluster"
        peer_entries = {p["peer"]: p for p in prof["peers"]}
        assert peer_entries["n1"]["status"] == "queried"
        assert peer_entries["n1"]["bytes"] > 0
        assert "merge" in prof["phases"]
        # GET explain=1 works too
        got = _get_json(
            ports[0],
            "/query?group_by=destinationIP&agg=count&cache=0"
            "&explain=1")
        assert got["rows"] == plain["rows"]
        assert got["profile"]["engine"] == "cluster"
    finally:
        shutdown_all(servers)


def test_heartbeat_rtt_recorded_and_surfaced(monkeypatch):
    ports, dbs, servers = make_mesh(2, monkeypatch)
    try:
        wait_until(lambda: servers[0].cluster.heartbeat.last_rtt,
                   what="first heartbeat rtt")
        health = _get_json(ports[0], "/healthz")
        rtts = health["cluster"]["heartbeatRttSeconds"]
        assert "n1" in rtts and rtts["n1"] > 0
        h = metrics.REGISTRY.get("theia_cluster_heartbeat_rtt_seconds")
        assert h.labels(peer="n1").count() >= 1
    finally:
        shutdown_all(servers)
