"""Port parity: the multi-node cluster tier of theia_tpu_torch
(cluster/{membership,node,replication,router}.py, copies of
theia_tpu's under the drift guard) served by port managers on the CPU
(device="cpu").

The cases of tests/test_cluster.py, run against the port's managers:
membership, WAL log-shipping replication, ingest routing,
partition-tolerant failover. The crash matrix runs IN-PROCESS with
real HTTP between nodes (the test_admission discipline): "kill -9" of
a node = stop its HTTP server and abandon its objects WITHOUT any
graceful close — the WAL files on disk are exactly what a SIGKILL
would leave (every frame is flushed at append) — then recover by
building a fresh store over the same directories. Liveness
transitions use injectable clocks; waits poll short deadlines on real
conditions, never fixed sleeps."""

import json
import random
import socket
import time
import urllib.error
import urllib.request

import pytest

from theia_tpu_torch.cluster import (
    ClusterConfigError,
    ClusterMap,
    HeartbeatLoop,
    parse_peers,
)
from theia_tpu_torch.data.synth import SynthConfig, generate_flows
from theia_tpu_torch.ingest import BlockEncoder
from theia_tpu_torch.ingest.client import IngestClient, IngestError
from theia_tpu_torch.store import FlowDatabase
from theia_tpu_torch.store.wal import (
    RECORD_MAGIC,
    WalShipGap,
    encode_record_body,
)
from theia_tpu_torch.utils import faults

from test_torch_analysis import port_lockdep_clean  # noqa: F401,E402

pytestmark = pytest.mark.cluster


_PORTS = random.SystemRandom()


def free_port() -> int:
    """A free port below the kernel's ephemeral range (32768 up): the
    nodes' own outgoing connections cannot take it between this probe
    and the server's bind, as they can take a port the kernel handed
    out, when the suite runs many in-process clusters at once."""
    while True:
        port = _PORTS.randrange(20000, 32000)
        s = socket.socket()
        try:
            s.bind(("127.0.0.1", port))
        except OSError:
            continue
        finally:
            s.close()
        return port


def wait_until(cond, timeout=20.0, interval=0.02, what="condition"):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return
        time.sleep(interval)
    raise AssertionError(f"timed out waiting for {what}")


def _producer(n_series=6, points=10, seed=1):
    enc = BlockEncoder()
    batch = generate_flows(
        SynthConfig(n_series=n_series, points_per_series=points,
                    anomaly_fraction=0.0, seed=seed), dicts=enc.dicts)
    return enc, batch


def make_server(db, port, peers, self_id, role, acks=None, **kw):
    from theia_tpu_torch.manager.api import TheiaManagerServer
    srv = TheiaManagerServer(
        db, port=port, cluster_peers=peers, cluster_self=self_id,
        cluster_role=role, cluster_acks=acks, device="cpu",
        **kw)
    srv.start_background()
    return srv


def hard_kill(srv) -> None:
    """SIGKILL equivalence: the HTTP socket dies and every background
    loop is torn down, but NOTHING flushes/saves/closes gracefully —
    the WAL directory holds exactly the appended frames."""
    srv.httpd.shutdown()
    srv.httpd.server_close()
    if srv.cluster is not None:
        srv.cluster.stop()


@pytest.fixture(autouse=True)
def _no_background_retention(monkeypatch):
    monkeypatch.setenv("THEIA_RETENTION_INTERVAL", "0")
    yield
    faults.disarm()


# -- membership -----------------------------------------------------------

def test_parse_peers_grammar():
    peers = parse_peers(
        "a=http://h1:1, b=https://h2:2 ,http://h3:3")
    assert peers == [("a", "http://h1:1"), ("b", "https://h2:2"),
                     ("node2", "http://h3:3")]
    with pytest.raises(ClusterConfigError):
        parse_peers("a=h1:1")               # no scheme
    with pytest.raises(ClusterConfigError):
        parse_peers("a=http://h:1,a=http://h:2")   # dup id
    with pytest.raises(ClusterConfigError):
        ClusterMap(parse_peers("a=http://h:1"), "zz")  # unknown self


def test_owner_placement_stable_and_spread():
    peers = parse_peers(
        "n0=http://h:1,n1=http://h:2,n2=http://h:3")
    m1 = ClusterMap(peers, "n0")
    m2 = ClusterMap(peers, "n2")
    dests = [f"10.0.{i}.{j}" for i in range(16) for j in range(16)]
    owners = [m1.owner_of(d) for d in dests]
    # identical on every node, regardless of which node computes it
    assert owners == [m2.owner_of(d) for d in dests]
    # and actually spread across the peer list
    assert len(set(owners)) == 3


def test_heartbeat_liveness_injectable_clock():
    clk = {"t": 0.0}
    peers = parse_peers("n0=http://h:1,n1=http://h:2,n2=http://h:3")
    cmap = ClusterMap(peers, "n0", peer_timeout=5.0,
                      clock=lambda: clk["t"])
    up = {"n1": True, "n2": True}

    def probe(peer):
        if not up[peer]:
            raise OSError("connection refused")
        return {"role": "peer", "term": 1}

    hb = HeartbeatLoop(cmap, probe, interval=1.0)
    hb.beat_once()
    assert cmap.alive() == ["n0", "n1", "n2"]
    up["n2"] = False
    clk["t"] = 3.0
    hb.beat_once()
    assert cmap.is_alive("n1") and cmap.is_alive("n2")  # inside timeout
    clk["t"] = 9.0                      # n2 last seen at t=0 (> 5s)
    hb.beat_once()
    assert cmap.is_alive("n1")
    assert not cmap.is_alive("n2")
    snap = cmap.snapshot()
    n2 = next(p for p in snap["peers"] if p["id"] == "n2")
    assert n2["up"] is False and "lastError" in n2


# -- fault sites ----------------------------------------------------------

def test_per_peer_fault_targeting():
    faults.arm("peer.partition#n1:error")
    with pytest.raises(faults.FaultError):
        faults.fire("peer.partition", peer="n1")
    faults.fire("peer.partition", peer="n2")     # other links untouched
    faults.fire("net.send", peer="n1")           # other sites untouched
    counts = faults.injector().counts()
    assert counts["peer.partition#n1"] == 1
    faults.disarm()
    faults.arm("net.send:error@2")
    faults.fire("net.send", peer="x")            # 1st hit passes
    with pytest.raises(faults.FaultError):
        faults.fire("net.send", peer="y")        # 2nd fires
    faults.fire("net.send", peer="z")            # one-shot


# -- WAL shipping primitives ---------------------------------------------

def _filled_wal(tmp, n=5, segment_bytes=4096):
    db = FlowDatabase()
    db.attach_wal(tmp, segment_bytes=segment_bytes)
    enc = BlockEncoder()
    for i in range(n):
        batch = generate_flows(
            SynthConfig(n_series=3, points_per_series=6, seed=i + 1),
            dicts=enc.dicts)
        db.insert_flows(batch)
    return db


def test_frame_shipping_roundtrip_and_duplicates(tmp_path):
    leader = _filled_wal(str(tmp_path / "leader"), n=4)
    follower = FlowDatabase()
    follower.attach_wal(str(tmp_path / "follower"))
    shipped = 0
    acked = 0
    while True:
        frames, last, algo = leader.wal_read_frames(acked,
                                                    max_bytes=2048)
        if not frames:
            break
        out = follower.apply_replicated_frames(frames, algo)
        # duplicate ship of the same frames is skipped entirely
        again = follower.apply_replicated_frames(frames, algo)
        assert again["applied"] == 0 and again["rows"] == 0
        shipped += out["applied"]
        acked = last
    assert len(follower.flows) == len(leader.flows)
    assert shipped == leader.wal_position()
    # byte-identical continuation: handshake tokens agree
    assert follower.wal_handshake() == leader.wal_handshake()
    # and the follower recovers to the same position from ITS OWN log
    recovered = FlowDatabase()
    stats = recovered.attach_wal(str(tmp_path / "follower"))
    assert stats["recoveredRows"] == len(leader.flows)


def test_read_frames_gap_after_gc_requires_resync(tmp_path):
    db = _filled_wal(str(tmp_path / "w"), n=6, segment_bytes=2048)
    wal = db._wal
    assert len(wal._list_segments()) > 1
    wal.gc_below(wal.last_lsn - 1)
    with pytest.raises(WalShipGap):
        db.wal_read_frames(0)


def test_resync_export_apply_roundtrip(tmp_path):
    leader = _filled_wal(str(tmp_path / "leader"), n=3)
    position, crc, records = leader.resync_export(chunk_rows=17)
    follower = FlowDatabase()
    follower.attach_wal(str(tmp_path / "follower"))
    rows = follower.resync_apply(records, position, crc)
    assert rows == len(leader.flows)
    assert len(follower.flows) == len(leader.flows)
    hs = follower.wal_handshake()
    assert hs["lsn"] == position and hs["crc"] == crc
    # frames ship onward from the resync position
    frames, last, algo = leader.wal_read_frames(position)
    assert frames == b"" and last == position


def test_trec_payload_ingests_statelessly():
    from theia_tpu_torch.manager.ingest import IngestManager
    db = FlowDatabase()
    mgr = IngestManager(db, n_shards=1, device="cpu")
    enc, batch = _producer(seed=9)
    payload = RECORD_MAGIC + encode_record_body("flows", batch)
    out = mgr.ingest(payload, stream="trec", seq=1)
    assert out["rows"] == len(batch)
    # identical TREC retry resolves via dedup, not re-decode
    out2 = mgr.ingest(payload, stream="trec", seq=1)
    assert out2.get("duplicate") is True
    assert len(db.flows) == len(batch)
    with pytest.raises(ValueError):
        mgr.ingest(RECORD_MAGIC + b"garbage", stream="trec", seq=2)
    mgr.close()


# -- two-node replication over real HTTP ----------------------------------

def test_replication_quorum_redirect_and_dedup_transfer(tmp_path):
    p0, p1 = free_port(), free_port()
    peers = f"n0=http://127.0.0.1:{p0},n1=http://127.0.0.1:{p1}"
    db0 = FlowDatabase()
    db0.attach_wal(str(tmp_path / "w0"))
    db1 = FlowDatabase()
    db1.attach_wal(str(tmp_path / "w1"))
    leader = make_server(db0, p0, peers, "n0", "leader", acks="quorum")
    follower = make_server(db1, p1, peers, "n1", "follower")
    try:
        enc, batch = _producer(seed=3)
        # follower FIRST: the client must honor the 307 redirect
        client = IngestClient(
            [f"http://127.0.0.1:{p1}", f"http://127.0.0.1:{p0}"],
            stream="repl")
        out = client.send(enc.encode(batch))
        assert out["rows"] == len(batch)
        assert client.redirects >= 1
        # quorum ack means the follower holds the rows (not eventually)
        assert len(db1.flows) == len(batch)
        # the dedup tag crossed the wire with the frames: a retry
        # against the FOLLOWER-side window is answerable after promote
        assert follower.ingest.dedup.stats()["entries"] >= 1
        # staleness surface
        with urllib.request.urlopen(
                f"http://127.0.0.1:{p1}/healthz", timeout=10) as r:
            doc = json.load(r)
        repl = doc["cluster"]["replication"]
        assert repl["role"] == "follower"
        assert repl["lagRecords"] == 0
    finally:
        leader.shutdown()
        follower.shutdown()


def test_follower_kill9_mid_replication_then_catchup(tmp_path):
    p0, p1 = free_port(), free_port()
    peers = f"n0=http://127.0.0.1:{p0},n1=http://127.0.0.1:{p1}"
    db0 = FlowDatabase()
    db0.attach_wal(str(tmp_path / "w0"))
    db1 = FlowDatabase()
    db1.attach_wal(str(tmp_path / "w1"))
    # leader-only acks: the leader must keep serving with the follower
    # dead (degraded, not failed)
    leader = make_server(db0, p0, peers, "n0", "leader", acks="leader")
    follower = make_server(db1, p1, peers, "n1", "follower")
    client = IngestClient(f"http://127.0.0.1:{p0}", stream="k9")
    try:
        enc, batch = _producer(seed=5)
        client.send(enc.encode(batch))
        wait_until(lambda: len(db1.flows) == len(batch), what="ship")
        # kill -9 the follower mid-stream: no close, no flush
        hard_kill(follower)
        batch2 = generate_flows(
            SynthConfig(n_series=6, points_per_series=10, seed=6),
            dicts=enc.dicts)
        out = client.send(enc.encode(batch2))     # leader still acks
        assert out["rows"] == len(batch2)
        # recover the follower from ITS OWN surviving log (the WAL
        # files are exactly what SIGKILL left) on the same port
        db1b = FlowDatabase()
        stats = db1b.attach_wal(str(tmp_path / "w1"))
        assert stats["recoveredRows"] == len(batch)
        follower_b = make_server(db1b, p1, peers, "n1", "follower")
        try:
            wait_until(
                lambda: len(db1b.flows) == len(batch) + len(batch2),
                what="catch-up after follower restart")
            # caught up by FRAME shipping (log matching), not resync
            assert follower_b.cluster.follower.resyncs == 0
        finally:
            follower_b.shutdown()
    finally:
        leader.shutdown()   # follower was already hard-killed


def test_leader_failover_declared_lsn_zero_acked_loss(tmp_path):
    ports = [free_port() for _ in range(3)]
    peers = ",".join(
        f"n{i}=http://127.0.0.1:{p}" for i, p in enumerate(ports))
    dbs = []
    for i in range(3):
        db = FlowDatabase()
        db.attach_wal(str(tmp_path / f"w{i}"))
        dbs.append(db)
    leader = make_server(dbs[0], ports[0], peers, "n0", "leader",
                         acks="quorum")
    f1 = make_server(dbs[1], ports[1], peers, "n1", "follower")
    f2 = make_server(dbs[2], ports[2], peers, "n2", "follower")
    client = IngestClient([f"http://127.0.0.1:{p}" for p in ports],
                          stream="fo", max_attempts=20,
                          backoff_base=0.05, backoff_cap=0.2)
    try:
        enc, batch = _producer(seed=7)
        acked_rows = 0
        for i in range(3):
            b = generate_flows(
                SynthConfig(n_series=6, points_per_series=10,
                            seed=10 + i), dicts=enc.dicts)
            out = client.send(enc.encode(b))
            assert not out.get("duplicate")
            acked_rows += out["rows"]
        # every acked row reaches both followers (quorum guarantees ≥1
        # synchronously; shipping delivers the rest promptly)
        wait_until(lambda: len(dbs[1].flows) == acked_rows
                   and len(dbs[2].flows) == acked_rows,
                   what="followers hold all acked rows")
        hard_kill(leader)                      # kill -9 the leader
        # WAL-delimited cutover: the failover runbook promotes the
        # most-advanced follower at its applied LSN (quorum writes
        # only intersect with the max-LSN copy)
        best = max((1, 2), key=lambda i: dbs[i].wal_position() or 0)
        other = 3 - best
        at = dbs[best].wal_position()
        req = urllib.request.Request(
            f"http://127.0.0.1:{ports[best]}/cluster/promote",
            data=json.dumps({"atLsn": at}).encode(), method="POST")
        with urllib.request.urlopen(req, timeout=10) as r:
            doc = json.load(r)
        assert doc["role"] == "leader" and doc["term"] == 2
        # promoting a copy that has NOT applied the declared LSN is
        # refused with 409 — an earlier copy would drop acked records
        req = urllib.request.Request(
            f"http://127.0.0.1:{ports[other]}/cluster/promote",
            data=json.dumps({"atLsn": at + 1000}).encode(),
            method="POST")
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(req, timeout=10)
        assert ei.value.code == 409
        # the producer's RETRY of its last acked batch resolves
        # duplicate:true on the new leader — the dedup window crossed
        # nodes with the WAL tags; zero double-insert
        retry = client.send(b"\x00", seq=client.seq)
        assert retry.get("duplicate") is True
        # and new ingest lands on the promoted leader — with a FRESH
        # encoder chain: TFB2 deltas were relative to the dead
        # leader's decoder, so the failover contract (docs/cluster.md)
        # is "reset the encoder; its first block is self-contained"
        enc2 = BlockEncoder()
        b4 = generate_flows(
            SynthConfig(n_series=6, points_per_series=10, seed=44),
            dicts=enc2.dicts)
        out = client.send(enc2.encode(b4))
        assert out["rows"] == len(b4)
        assert len(dbs[best].flows) == acked_rows + len(b4)
        wait_until(
            lambda: len(dbs[other].flows) == acked_rows + len(b4),
            what="remaining follower catch-up under the new leader")
    finally:
        f1.shutdown()
        f2.shutdown()


def test_partition_heal_resync_via_part_manifest(tmp_path):
    ports = [free_port() for _ in range(3)]
    peers = ",".join(
        f"n{i}=http://127.0.0.1:{p}" for i, p in enumerate(ports))
    dbs = []
    for i in range(3):
        db = FlowDatabase()
        # small segments so checkpoint GC can strand the partitioned
        # follower beyond frame catch-up
        db.attach_wal(str(tmp_path / f"w{i}"), segment_bytes=2048)
        dbs.append(db)
    leader = make_server(dbs[0], ports[0], peers, "n0", "leader",
                         acks="quorum")
    f1 = make_server(dbs[1], ports[1], peers, "n1", "follower")
    f2 = make_server(dbs[2], ports[2], peers, "n2", "follower")
    client = IngestClient(f"http://127.0.0.1:{ports[0]}",
                          stream="part")
    try:
        enc, batch = _producer(seed=8)
        client.send(enc.encode(batch))
        wait_until(lambda: len(dbs[2].flows) == len(batch),
                   what="initial ship to n2")
        # partition n2: every link to it drops, deterministically
        faults.arm("peer.partition#n2:error")
        total = len(batch)
        for i in range(4):
            b = generate_flows(
                SynthConfig(n_series=5, points_per_series=12,
                            seed=20 + i), dicts=enc.dicts)
            # majority side (leader + n1) still acks — DEGRADED, not
            # failed: quorum is 1 follower and n1 is reachable
            out = client.send(enc.encode(b))
            assert out["rows"] == len(b)
            total += len(b)
        assert len(dbs[1].flows) == total
        assert len(dbs[2].flows) == len(batch)   # stranded

        def _leader_degraded():
            with urllib.request.urlopen(
                    f"http://127.0.0.1:{ports[0]}/healthz",
                    timeout=10) as r:
                return json.load(r)["status"] == "degraded"

        wait_until(_leader_degraded,
                   what="leader reports degraded during partition")
        # checkpoint GC collects the shipped segments: frame catch-up
        # for n2 becomes impossible (WalShipGap territory — the 2048B
        # segments put each record in its own file)
        dbs[0].wal_sync()
        dbs[0]._wal.gc_below(dbs[0].wal_position() - 1)
        with pytest.raises(WalShipGap):
            dbs[0].wal_read_frames(1)
        # heal: the shipper reconnects, log-matching fails OR the gap
        # forces the wholesale part-manifest resync, then frames resume
        faults.disarm()
        wait_until(lambda: len(dbs[2].flows) == total,
                   timeout=30.0, what="resync after heal")

        def _n2_streaming():
            followers = leader.cluster.leader.stats()["followers"]
            doc = next(f for f in followers if f["peer"] == "n2")
            return doc["status"] == "streaming"

        wait_until(_n2_streaming, what="n2 back to frame streaming")
        assert f2.cluster.follower.resyncs >= 1
        # post-heal ingest reaches everyone again
        b = generate_flows(
            SynthConfig(n_series=5, points_per_series=12, seed=77),
            dicts=enc.dicts)
        client.send(enc.encode(b))
        total += len(b)
        wait_until(lambda: len(dbs[2].flows) == total,
                   what="post-heal ship")
    finally:
        leader.shutdown()
        f1.shutdown()
        f2.shutdown()


def test_demoted_leader_steps_down_resyncs_and_reingests_tail(tmp_path):
    """The full rejoin story: a leader that kept acknowledging while
    its follower saw nothing (shipper stopped — the partitioned-leader
    shape) is demoted by the promoted follower's higher term, loses
    its divergent state to a wholesale resync, and its unacked tagged
    tail re-ingests through the new leader's dedup window — batch 1
    (already replicated) resolves duplicate:true, the tail batches
    land exactly once, and BOTH nodes converge on every acknowledged
    row."""
    p0, p1 = free_port(), free_port()
    peers = f"n0=http://127.0.0.1:{p0},n1=http://127.0.0.1:{p1}"
    db0 = FlowDatabase()
    db0.attach_wal(str(tmp_path / "w0"))
    db1 = FlowDatabase()
    db1.attach_wal(str(tmp_path / "w1"))
    s0 = make_server(db0, p0, peers, "n0", "leader", acks="leader")
    s1 = make_server(db1, p1, peers, "n1", "follower")
    client = IngestClient(
        [f"http://127.0.0.1:{p0}", f"http://127.0.0.1:{p1}"],
        stream="tail", max_attempts=20, backoff_base=0.05,
        backoff_cap=0.2)
    try:
        enc, b1 = _producer(seed=30)
        client.send(enc.encode(b1))
        wait_until(lambda: len(db1.flows) == len(b1),
                   what="batch 1 replicated")
        # sever replication only (the old leader keeps ACKING): the
        # next two batches are its unacked-to-the-cluster tail
        s0.cluster.leader.stop()
        rows = [len(b1)]
        for i in (31, 32):
            b = generate_flows(
                SynthConfig(n_series=6, points_per_series=10, seed=i),
                dicts=enc.dicts)
            out = client.send(enc.encode(b))
            assert out["rows"] == len(b)
            rows.append(len(b))
        total = sum(rows)
        assert len(db0.flows) == total
        assert len(db1.flows) == rows[0]
        # failover: promote n1; its shipper contacts n0, whose higher
        # term demotes it; n0's divergent log forces a resync, and the
        # extracted tail re-posts through n1's /ingest
        req = urllib.request.Request(
            f"http://127.0.0.1:{p1}/cluster/promote", data=b"{}",
            method="POST")
        with urllib.request.urlopen(req, timeout=10) as r:
            assert json.load(r)["term"] == 2
        wait_until(lambda: s0.cluster.role == "follower",
                   what="old leader steps down")
        wait_until(lambda: len(db1.flows) == total, timeout=30.0,
                   what="tail re-ingested on the new leader")
        wait_until(lambda: len(db0.flows) == total, timeout=30.0,
                   what="demoted leader converges via replication")
        # every producer-acked seq answers duplicate:true on the new
        # leader — zero acked-row loss, zero duplication
        for seq in (1, 2, 3):
            assert client.send(b"\x00", seq=seq).get("duplicate") \
                is True
        assert len(db1.flows) == total
    finally:
        s0.shutdown()
        s1.shutdown()


# -- ingest routing mesh --------------------------------------------------

def test_router_exactly_once_under_retry_storm(tmp_path, monkeypatch):
    monkeypatch.setenv("THEIA_ROUTER_ATTEMPTS", "2")
    ports = [free_port() for _ in range(3)]
    peers = ",".join(
        f"n{i}=http://127.0.0.1:{p}" for i, p in enumerate(ports))
    dbs = []
    servers = []
    for i in range(3):
        db = FlowDatabase()
        db.attach_wal(str(tmp_path / f"w{i}"))
        dbs.append(db)
        servers.append(make_server(db, ports[i], peers, f"n{i}",
                                   "peer"))
    client = IngestClient(f"http://127.0.0.1:{ports[0]}",
                          stream="mesh", max_attempts=25,
                          backoff_base=0.05, backoff_cap=0.2)
    try:
        enc, batch = _producer(n_series=12, seed=15)
        out = client.send(enc.encode(batch))
        assert out["rows"] == len(batch)
        per_node = [len(db.flows) for db in dbs]
        assert sum(per_node) == len(batch)
        assert min(per_node) > 0           # genuinely spread
        # RETRY STORM: the same acked seq hammered repeatedly — every
        # attempt resolves duplicate:true, row conservation holds
        for _ in range(5):
            retry = client.send(b"\x00", seq=client.seq)
            assert retry.get("duplicate") is True
        assert sum(len(db.flows) for db in dbs) == len(batch)

        # partial-failure storm: kill the n2 owner, send a NEW batch —
        # forwards to n2 exhaust their budget → 503 to the producer —
        # then revive n2 (recovered from its own WAL, dedup seeded)
        # and let the producer's retries settle every slice
        hard_kill(servers[2])
        b2 = generate_flows(
            SynthConfig(n_series=12, points_per_series=10, seed=16),
            dicts=enc.dicts)
        payload = enc.encode(b2)
        seq = client.seq + 1
        with pytest.raises(IngestError):
            IngestClient(f"http://127.0.0.1:{ports[0]}",
                         stream="mesh", max_attempts=2,
                         backoff_base=0.01, backoff_cap=0.02
                         ).send(payload, seq=seq)
        db2b = FlowDatabase()
        db2b.attach_wal(str(tmp_path / "w2"))   # rows + acks recover
        servers[2] = make_server(db2b, ports[2], peers, "n2", "peer")
        dbs[2] = db2b
        out = client.send(payload, seq=seq)
        assert out["rows"] == len(b2)
        # conservation: every row exactly once, across the crash and
        # all the retries (n0/n1 slices deduped, n2 slice landed once)
        assert sum(len(db.flows) for db in dbs) == len(batch) + len(b2)
    finally:
        for s in servers:
            try:
                s.shutdown()
            except Exception:
                pass


def test_router_unstamped_ingest_stays_at_least_once(tmp_path):
    """A producer that never stamps seq still works on the mesh: its
    remote slices forward UNSTAMPED (at-least-once, the pre-seq
    contract) instead of failing — regression for the seq=None
    forward path."""
    ports = [free_port(), free_port()]
    peers = ",".join(
        f"n{i}=http://127.0.0.1:{p}" for i, p in enumerate(ports))
    dbs = [FlowDatabase(), FlowDatabase()]
    servers = [make_server(dbs[i], ports[i], peers, f"n{i}", "peer")
               for i in range(2)]
    try:
        enc, batch = _producer(n_series=10, seed=23)
        req = urllib.request.Request(
            f"http://127.0.0.1:{ports[0]}/ingest?stream=unstamped",
            data=enc.encode(batch), method="POST")
        with urllib.request.urlopen(req, timeout=30) as r:
            out = json.load(r)
        assert out["rows"] == len(batch)
        assert out.get("forwardedRows", 0) > 0
        assert len(dbs[0].flows) + len(dbs[1].flows) == len(batch)
    finally:
        for s in servers:
            s.shutdown()


def test_router_forward_is_never_rerouted(tmp_path):
    """A TREC forward landing on a non-owner (peer lists disagree mid
    roll-out) must insert locally, not bounce around the mesh."""
    from theia_tpu_torch.manager.ingest import IngestManager
    from theia_tpu_torch.cluster import ClusterMap, IngestRouter, parse_peers
    db = FlowDatabase()
    mgr = IngestManager(db, n_shards=1, device="cpu")
    cmap = ClusterMap(
        parse_peers("a=http://h:1,b=http://h:2"), "a")
    mgr.router = IngestRouter(cmap)
    enc, batch = _producer(seed=21)
    payload = RECORD_MAGIC + encode_record_body("flows", batch)
    out = mgr.ingest(payload, stream="x@b", seq=4)
    assert out["rows"] == len(batch)
    assert "forwardedRows" not in out
    assert len(db.flows) == len(batch)
    mgr.close()
    mgr.router.close()


# -- client failover ------------------------------------------------------

def test_client_multi_endpoint_failover(tmp_path):
    p_dead, p_live = free_port(), free_port()
    db = FlowDatabase()
    from theia_tpu_torch.manager.api import TheiaManagerServer
    srv = TheiaManagerServer(db, port=p_live, device="cpu")
    srv.start_background()
    try:
        sleeps = []
        client = IngestClient(
            [f"http://127.0.0.1:{p_dead}",
             f"http://127.0.0.1:{p_live}"],
            stream="fx", sleep=sleeps.append)
        enc, batch = _producer(seed=2)
        out = client.send(enc.encode(batch))
        assert out["rows"] == len(batch)
        assert client.failovers >= 1
        assert client.summary()["failovers"] == client.failovers
    finally:
        srv.shutdown()
