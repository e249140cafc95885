"""Port parity: distributed scatter-gather query execution
(query/distributed.py) on a routing mesh of port managers on the CPU
(device="cpu").

The cases of tests/test_distquery.py, run against the port: coordinator
answers are held bit-identical to a single-node oracle over the SAME
rows, degraded modes (peer down, partition drill, strict mode) are
exercised with real transport failures, and cache invalidation is
driven by actual remote inserts and shipped WAL frames. Heartbeats run
fast (THEIA_CLUSTER_HEARTBEAT=0.05) and waits poll real conditions — no
fixed sleeps on the happy path."""

import json
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

from theia_tpu_torch.data.synth import SynthConfig, generate_flows
from theia_tpu_torch.ingest import BlockEncoder
from theia_tpu_torch.ingest.client import IngestClient, IngestError
from theia_tpu_torch.query import QueryEngine, parse_plan
from theia_tpu_torch.query.distributed import (
    pack_partial,
    partial_from_batch,
    peer_excluded,
    unpack_partial,
)
from theia_tpu_torch.store import FlowDatabase
from theia_tpu_torch.store.wal import RECORD_MAGIC, encode_record_body
from theia_tpu_torch.utils import faults

from test_torch_analysis import port_lockdep_clean  # noqa: F401,E402
from test_torch_cluster import free_port  # noqa: E402

pytestmark = pytest.mark.distquery




def wait_until(cond, timeout=20.0, interval=0.02, what="condition"):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return
        time.sleep(interval)
    raise AssertionError(f"timed out waiting for {what}")


@pytest.fixture(autouse=True)
def _fast_cluster(monkeypatch):
    monkeypatch.setenv("THEIA_RETENTION_INTERVAL", "0")
    monkeypatch.setenv("THEIA_CLUSTER_HEARTBEAT", "0.05")
    monkeypatch.setenv("THEIA_CLUSTER_BOUNDS_INTERVAL", "0.02")
    yield
    faults.disarm()


def make_mesh(n, tmp_path=None, wal=False):
    """n in-process role=peer managers on ephemeral ports."""
    from theia_tpu_torch.manager.api import TheiaManagerServer
    ports = [free_port() for _ in range(n)]
    peers = ",".join(
        f"n{i}=http://127.0.0.1:{p}" for i, p in enumerate(ports))
    dbs, servers = [], []
    for i in range(n):
        db = FlowDatabase()
        if wal:
            db.attach_wal(str(tmp_path / f"w{i}"))
        dbs.append(db)
        srv = TheiaManagerServer(db, port=ports[i],
                                 cluster_peers=peers,
                                 cluster_self=f"n{i}",
                                 cluster_role="peer", device="cpu")
        srv.start_background()
        servers.append(srv)
    return ports, dbs, servers


def shutdown_all(servers):
    for s in servers:
        try:
            s.shutdown()
        except Exception:
            pass


def hard_kill(srv) -> None:
    srv.httpd.shutdown()
    srv.httpd.server_close()
    if srv.cluster is not None:
        srv.cluster.stop()


def post_query(port, doc, timeout=30):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/query",
        data=json.dumps(doc).encode(), method="POST")
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return json.load(r)


def wait_heartbeats(servers):
    """Every node has CURRENT store state for every peer: fingerprint
    matches the peer's live engine digest (bounds ship with it)."""
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
                if "bounds" not in info:
                    return False
        return True
    wait_until(_synced, what="heartbeat store-state sync")


PLAN_DOC = {
    "groupBy": "destinationIP",
    "aggregates": ["sum:octetDeltaCount", "mean:throughput",
                   "min:flowEndSeconds", "max:octetDeltaCount",
                   "count"],
    "k": 100,
}


# -- TQPF partial frames ---------------------------------------------------

def test_partial_frame_roundtrip():
    plan = parse_plan({"groupBy": "destinationIP,destinationTransportPort",
                       "aggregates": ["sum:octetDeltaCount", "count"]})
    keys = [np.asarray(["10.0.0.1", "10.0.0.2", ""], object),
            np.asarray([443, 80, 9], np.int64)]
    aggs = {"sum(octetDeltaCount)": np.asarray([7, 11, 1 << 60],
                                               np.int64),
            "count": np.asarray([2, 3, 4], np.int64)}
    raw = pack_partial({"node": "n1", "rowsScanned": 9}, plan, keys,
                       aggs)
    meta, batch = unpack_partial(raw)
    assert meta["node"] == "n1" and meta["rowsScanned"] == 9
    k2, a2 = partial_from_batch(plan, batch)
    assert list(k2[0]) == ["10.0.0.1", "10.0.0.2", ""]
    assert list(k2[1]) == [443, 80, 9]
    # int64 aggregates survive exactly (no float round-trip)
    assert list(a2["sum(octetDeltaCount)"]) == [7, 11, 1 << 60]
    assert list(a2["count"]) == [2, 3, 4]


def test_partial_frame_empty_and_global():
    plan = parse_plan({"aggregates": ["sum:octetDeltaCount"]})
    raw = pack_partial({"node": "x"}, plan, None, None)
    meta, batch = unpack_partial(raw)
    assert partial_from_batch(plan, batch) == (None, None)
    # global aggregate: one group, empty key tuple
    raw = pack_partial(
        {}, plan, [], {"sum(octetDeltaCount)": np.asarray([5],
                                                          np.int64)})
    _, batch = unpack_partial(raw)
    keys, aggs = partial_from_batch(plan, batch)
    assert keys == [] and list(aggs["sum(octetDeltaCount)"]) == [5]


def test_partial_frame_rejects_garbage():
    from theia_tpu_torch.query import QueryError
    with pytest.raises(QueryError):
        unpack_partial(b"nope")
    with pytest.raises(QueryError):
        unpack_partial(b"TQPF" + b"\x00" * 32)


# -- peer pruning predicate ------------------------------------------------

def test_peer_excluded_predicate():
    plan = parse_plan({"start": 1000, "end": 2000})
    # empty peer always prunes; unknown state never does
    assert peer_excluded(plan, {"rows": 0, "fingerprint": "x"})
    assert not peer_excluded(plan, None)
    assert not peer_excluded(plan, {"fingerprint": "x"})
    bounds = {"flowStartSeconds": [0, 900],
              "flowEndSeconds": [0, 910]}
    assert peer_excluded(plan, {"rows": 5, "bounds": bounds})
    # overlap on the window edge: NOT excluded (half-open window)
    bounds = {"flowStartSeconds": [900, 1000],
              "flowEndSeconds": [990, 1500]}
    assert not peer_excluded(plan, {"rows": 5, "bounds": bounds})
    # end-side exclusion: every flowEnd at/after the window end
    bounds = {"flowStartSeconds": [2100, 2500],
              "flowEndSeconds": [2000, 2600]}
    assert peer_excluded(plan, {"rows": 5, "bounds": bounds})
    # no window -> nothing to prove
    assert not peer_excluded(parse_plan({}), {"rows": 5,
                                              "bounds": bounds})


# -- coordinator vs single-node oracle -------------------------------------

def test_coordinator_parity_with_single_node_oracle():
    """Randomized multi-node ingest through the router; the
    cluster-wide answer from EVERY node must be bit-identical to one
    single-node engine over the same rows — groups, sums, means,
    min/max, top-K order, group counts."""
    ports, dbs, servers = make_mesh(3)
    oracle = FlowDatabase()
    try:
        enc = BlockEncoder()
        client = IngestClient(f"http://127.0.0.1:{ports[0]}",
                              stream="parity")
        rng = np.random.default_rng(7)
        total = 0
        for seed in range(4):
            cfg = SynthConfig(n_series=int(rng.integers(20, 40)),
                              points_per_series=10,
                              anomaly_fraction=0.0, seed=seed + 1)
            batch = generate_flows(cfg, dicts=enc.dicts)
            client.send(enc.encode(batch))
            oracle.insert_flows(batch)
            total += len(batch)
        assert sum(len(db.flows) for db in dbs) == total
        assert min(len(db.flows) for db in dbs) > 0   # truly spread
        wait_heartbeats(servers)
        oracle_engine = QueryEngine(oracle)
        plans = [
            PLAN_DOC,
            {"aggregates": ["count", "sum:octetDeltaCount"]},  # global
            {"groupBy": "sourceIP,destinationTransportPort",
             "aggregates": ["mean:octetDeltaCount", "count"], "k": 7},
            {"groupBy": "destinationIP", "aggregates": ["count"],
             "filters": [{"column": "destinationTransportPort", "op": ">=",
                          "value": 1}]},
        ]
        for doc in plans:
            expect = oracle_engine.execute(parse_plan(doc),
                                           use_cache=False)
            for port in ports:
                got = post_query(port, {**doc, "cache": False})
                assert got["engine"] == "cluster"
                assert got["partial"] is False
                assert got["rows"] == expect["rows"], doc
                assert got["groupCount"] == expect["groupCount"]
        # bytes on the wire are per-GROUP, not per-row: far below the
        # shipped rows' resident footprint
        got = post_query(ports[1], {**PLAN_DOC, "cache": False})
        assert 0 < got["bytesShipped"] < 88 * total
    finally:
        shutdown_all(servers)


def test_windowed_parity_and_peer_pruning():
    """Disjoint per-node time ranges (TREC placement pins rows to a
    node): a windowed query prunes the peers that cannot overlap,
    counts them, and still answers exactly."""
    ports, dbs, servers = make_mesh(3)
    oracle = FlowDatabase()
    try:
        bases = [100_000, 200_000, 300_000]
        for i, port in enumerate(ports):
            enc = BlockEncoder()
            batch = generate_flows(
                SynthConfig(n_series=12, points_per_series=8,
                            anomaly_fraction=0.0, seed=50 + i,
                            start_time=bases[i]), dicts=enc.dicts)
            payload = RECORD_MAGIC + encode_record_body("flows", batch)
            req = urllib.request.Request(
                f"http://127.0.0.1:{port}/ingest?stream=place%40n{i}"
                f"&seq=1", data=payload, method="POST")
            with urllib.request.urlopen(req, timeout=30) as r:
                assert json.load(r)["rows"] == len(batch)
            oracle.insert_flows(batch)
        wait_heartbeats(servers)
        window = {"start": bases[2] - 1000, "end": bases[2] + 10_000}
        doc = {"groupBy": "destinationIP", "aggregates": ["count"],
               **window}
        expect = QueryEngine(oracle).execute(parse_plan(doc),
                                             use_cache=False)
        got = post_query(ports[2], {**doc, "cache": False})
        assert got["rows"] == expect["rows"]
        assert got["peers"]["pruned"] == 2      # n0 and n1 skipped
        assert got["peers"]["queried"] == 0
        assert got["partial"] is False          # pruned != missing
        # the same query from a PRUNED node still answers fully
        # (local partial contributes nothing, n2 ships its groups)
        got0 = post_query(ports[0], {**doc, "cache": False})
        assert got0["rows"] == expect["rows"]
        assert got0["peers"]["pruned"] == 1      # n1; n2 is queried
    finally:
        shutdown_all(servers)


# -- degraded modes --------------------------------------------------------

def test_peer_down_partial_response_and_strict_503(monkeypatch):
    ports, dbs, servers = make_mesh(3)
    try:
        enc = BlockEncoder()
        client = IngestClient(f"http://127.0.0.1:{ports[0]}",
                              stream="down")
        batch = generate_flows(
            SynthConfig(n_series=24, points_per_series=6,
                        anomaly_fraction=0.0, seed=3),
            dicts=enc.dicts)
        client.send(enc.encode(batch))
        wait_heartbeats(servers)
        hard_kill(servers[2])
        doc = {"groupBy": "destinationIP", "aggregates": ["count"],
               "cache": False}
        got = post_query(ports[0], doc)
        assert got["partial"] is True
        assert got["missingPeers"] == ["n2"]
        assert got["peers"]["failed"] == 1
        # the reachable slice still answers: n0 + n1 rows covered
        covered = sum(r["count"] for r in got["rows"])
        assert covered == len(dbs[0].flows) + len(dbs[1].flows)
        # strict mode refuses instead
        monkeypatch.setenv("THEIA_QUERY_STRICT", "1")
        req = urllib.request.Request(
            f"http://127.0.0.1:{ports[0]}/query",
            data=json.dumps(doc).encode(), method="POST")
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(req, timeout=30)
        assert ei.value.code == 503
        assert "n2" in ei.value.read().decode()
    finally:
        shutdown_all(servers[:2])


def test_partition_drill_severs_read_path():
    """`net.send#peer` drops the fan-out exactly like replication and
    heartbeats — the PR-2/PR-9 drill grammar covers reads now."""
    ports, dbs, servers = make_mesh(2)
    try:
        enc = BlockEncoder()
        IngestClient(f"http://127.0.0.1:{ports[0]}",
                     stream="drill").send(enc.encode(generate_flows(
                         SynthConfig(n_series=16, points_per_series=6,
                                     anomaly_fraction=0.0, seed=4),
                         dicts=enc.dicts)))
        wait_heartbeats(servers)
        faults.arm("net.send#n1:error")
        got = post_query(ports[0], {"groupBy": "destinationIP",
                                    "aggregates": ["count"],
                                    "cache": False})
        assert got["partial"] is True and got["missingPeers"] == ["n1"]
        faults.disarm()
        got = post_query(ports[0], {"groupBy": "destinationIP",
                                    "aggregates": ["count"],
                                    "cache": False})
        assert got["partial"] is False
        covered = sum(r["count"] for r in got["rows"])
        assert covered == len(dbs[0].flows) + len(dbs[1].flows)
    finally:
        shutdown_all(servers)


def test_peer_admission_shed_degrades_to_partial():
    """/query/partial admits one rung ahead of ingest on the PEER
    side too: a shed peer answers 429 and the coordinator degrades to
    partial:true (naming the peer) — it does not 500 or hang."""
    from theia_tpu_torch.manager.admission import AdmissionRejected
    ports, dbs, servers = make_mesh(2)
    try:
        enc = BlockEncoder()
        IngestClient(f"http://127.0.0.1:{ports[0]}",
                     stream="shed").send(enc.encode(generate_flows(
                         SynthConfig(n_series=10, points_per_series=5,
                                     anomaly_fraction=0.0, seed=12),
                         dicts=enc.dicts)))
        wait_heartbeats(servers)
        # shed ONLY the peer's ladder: pin the n1 controller instance
        # (the env knob would pin the coordinator too — one process)
        adm = servers[1].ingest.admission
        assert adm is not None

        def _shed():
            raise AdmissionRejected("query_shed", 1.0,
                                    "forced for the drill")
        adm.admit_query = _shed
        got = post_query(ports[0], {"aggregates": ["count"],
                                    "cache": False})
        assert got["partial"] is True
        assert got["missingPeers"] == ["n1"]
        del adm.admit_query
        got = post_query(ports[0], {"aggregates": ["count"],
                                    "cache": False})
        assert got["partial"] is False
    finally:
        shutdown_all(servers)


# -- cluster cache ---------------------------------------------------------

def test_cache_invalidation_on_remote_insert():
    ports, dbs, servers = make_mesh(2)
    try:
        enc = BlockEncoder()
        client = IngestClient(f"http://127.0.0.1:{ports[0]}",
                              stream="cache")
        b1 = generate_flows(
            SynthConfig(n_series=20, points_per_series=6,
                        anomaly_fraction=0.0, seed=5),
            dicts=enc.dicts)
        client.send(enc.encode(b1))
        wait_heartbeats(servers)
        doc = {"groupBy": "destinationIP", "aggregates": ["count"]}
        first = post_query(ports[0], doc)
        assert first["cache"] == "miss" and first["partial"] is False
        second = post_query(ports[0], doc)
        assert second["cache"] == "hit"
        assert second["rows"] == first["rows"]
        total1 = sum(r["count"] for r in first["rows"])
        # remote insert DIRECTLY on n1 (bypassing n0 entirely): the
        # n1 fingerprint moves, the next heartbeat invalidates n0's
        # cached cluster result structurally
        b2 = generate_flows(
            SynthConfig(n_series=20, points_per_series=6,
                        anomaly_fraction=0.0, seed=6),
            dicts=enc.dicts)
        dbs[1].insert_flows(b2)
        wait_heartbeats(servers)
        third = post_query(ports[0], doc)
        assert third["cache"] == "miss"
        assert sum(r["count"] for r in third["rows"]) == \
            total1 + len(b2)
    finally:
        shutdown_all(servers)


def test_follower_applied_frames_invalidate_query_cache(tmp_path):
    """Regression (stale-cache-after-replication): a follower applying
    shipped WAL frames bumps its store fingerprint, so its local query
    result cache invalidates — a follower read after replication sees
    the new rows, never the cached pre-replication answer."""
    leader = FlowDatabase()
    leader.attach_wal(str(tmp_path / "leader"))
    follower = FlowDatabase()
    follower.attach_wal(str(tmp_path / "follower"))
    enc = BlockEncoder()
    b1 = generate_flows(
        SynthConfig(n_series=10, points_per_series=6,
                    anomaly_fraction=0.0, seed=8), dicts=enc.dicts)
    leader.insert_flows(b1)
    frames, last, algo = leader.wal_read_frames(0)
    follower.apply_replicated_frames(frames, algo)
    engine = QueryEngine(follower)
    plan = parse_plan({"groupBy": "destinationIP",
                       "aggregates": ["count"]})
    fp1 = engine.fingerprint_hash()
    first = engine.execute(plan)
    assert first["cache"] == "miss"
    assert engine.execute(plan)["cache"] == "hit"
    # second shipped batch: fingerprint MUST move and the cache miss
    b2 = generate_flows(
        SynthConfig(n_series=10, points_per_series=6,
                    anomaly_fraction=0.0, seed=9), dicts=enc.dicts)
    leader.insert_flows(b2)
    frames, _, algo = leader.wal_read_frames(last)
    follower.apply_replicated_frames(frames, algo)
    assert engine.fingerprint_hash() != fp1
    third = engine.execute(plan)
    assert third["cache"] == "miss"
    assert sum(r["count"] for r in third["rows"]) == len(b1) + len(b2)


# -- transport reuse -------------------------------------------------------

def test_transport_connection_reuse_and_reconnect():
    """Persistent per-peer connections: consecutive requests ride ONE
    socket; a peer restart (stale keep-alive) reconnects instead of
    failing; close() drops the pool."""
    from theia_tpu_torch.manager.api import TheiaManagerServer
    from theia_tpu_torch.cluster import ClusterMap, parse_peers
    from theia_tpu_torch.cluster.transport import ClusterTransport
    port = free_port()
    db = FlowDatabase()
    srv = TheiaManagerServer(db, port=port, device="cpu")
    srv.start_background()
    cmap = ClusterMap(
        parse_peers(f"a=http://127.0.0.1:{free_port()},"
                    f"b=http://127.0.0.1:{port}"), "a")
    tr = ClusterTransport(cmap)
    try:
        assert tr.request("b", "/healthz")["status"] in ("ok",
                                                         "degraded")
        assert tr.pool_stats().get("b") == 1
        conn_before = tr._idle["b"][0]
        tr.request("b", "/version")
        assert tr._idle["b"][0] is conn_before    # same socket reused
        # peer restart: the pooled socket goes stale; the next request
        # silently reconnects (one retry on a fresh connection)
        srv.shutdown()
        srv2 = TheiaManagerServer(db, port=port, device="cpu")
        srv2.start_background()
        assert tr.request("b", "/version")["version"]
        srv2.shutdown()
        tr.close()
        assert tr.pool_stats() == {}
    finally:
        try:
            srv.shutdown()
        except Exception:
            pass


# -- CLI / client failover over the read path ------------------------------

def test_request_json_failover_and_permanent_errors():
    from theia_tpu_torch.manager.api import TheiaManagerServer
    p_dead, p_live = free_port(), free_port()
    db = FlowDatabase()
    enc = BlockEncoder()
    db.insert_flows(generate_flows(
        SynthConfig(n_series=8, points_per_series=5,
                    anomaly_fraction=0.0, seed=11), dicts=enc.dicts))
    srv = TheiaManagerServer(db, port=p_live, device="cpu")
    srv.start_background()
    try:
        sleeps = []
        client = IngestClient(
            [f"http://127.0.0.1:{p_dead}",
             f"http://127.0.0.1:{p_live}"],
            stream="q", sleep=sleeps.append)
        out = client.request_json(
            "POST", "/query",
            {"groupBy": "destinationIP", "aggregates": ["count"]})
        assert out["groupCount"] > 0
        assert client.failovers >= 1
        # a 400 (malformed plan) is permanent: no retry burn
        with pytest.raises(IngestError) as ei:
            client.request_json("POST", "/query",
                                {"groupBy": "noSuchColumn"})
        assert "400" in str(ei.value)
    finally:
        srv.shutdown()


def test_membership_epoch_counts_transitions():
    from theia_tpu_torch.cluster import ClusterMap, parse_peers
    clk = {"t": 0.0}
    cmap = ClusterMap(
        parse_peers("n0=http://h:1,n1=http://h:2"), "n0",
        peer_timeout=5.0, clock=lambda: clk["t"])
    e0 = cmap.membership_epoch()
    assert cmap.membership_epoch() == e0        # stable while static
    cmap.mark_alive("n1")
    e1 = cmap.membership_epoch()
    assert e1 == e0 + 1                          # n1 came up
    clk["t"] = 10.0                              # n1 times out
    e2 = cmap.membership_epoch()
    assert e2 == e1 + 1
    assert cmap.membership_epoch() == e2
