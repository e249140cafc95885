"""The scale-out slice as a whole, on the CPU: a three-node quorum
cluster of port managers, then sharded jobs over what it holds, against
the reference doing the same; and chip_smoke.py's two phases of this
slice (multi_device, cluster) at a small size with device="cpu".

The whole-slice case sends the same seq-stamped TBLK blocks through a
leader/follower cluster of each package (`--repl-acks quorum`), kills
the leader as SIGKILL would leave it, promotes the most advanced
follower at its applied LSN, re-sends the last seq and one block more.
The acks, the promoted leader's rows and the rows of a TAD DBSCAN job
and an NPR job over those rows — the port's on an explicit 8-shard CPU
mesh, the reference's on its 8 virtual devices — must be equal
(TAD stddev within rtol 2e-15, the one-device port's own limit).
"""

from __future__ import annotations

import datetime
import importlib.util
import json
import urllib.request
from pathlib import Path

import numpy as np
import pytest
import torch

from test_torch_analysis import port_lockdep_clean  # noqa: F401
from test_torch_cluster import free_port, wait_until

pytestmark = pytest.mark.cluster

REPO = Path(__file__).resolve().parent.parent
STD_RTOL = 2e-15
BLOCKS = 4
BLOCK_ROWS = 384
NOW = datetime.datetime(2021, 1, 2, tzinfo=datetime.timezone.utc)


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", REPO / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(autouse=True)
def _quiet(monkeypatch):
    monkeypatch.setenv("THEIA_RETENTION_INTERVAL", "0")
    monkeypatch.setenv("THEIA_CLUSTER_HEARTBEAT", "0.05")


def _blocks():
    """TBLK blocks of TAD-shaped flows (spikes DBSCAN flags), made by
    the port; both packages decode the same bytes."""
    from theia_tpu_torch.data.synth import SynthConfig, generate_flows
    from theia_tpu_torch.store import wire
    flows = generate_flows(SynthConfig(
        n_series=64, points_per_series=24, anomaly_fraction=0.3,
        anomaly_magnitude=100.0, base_throughput=1e7, seed=5))
    assert len(flows) == BLOCKS * BLOCK_ROWS
    return [wire.encode_block(flows.take(np.arange(i, i + BLOCK_ROWS)))
            for i in range(0, len(flows), BLOCK_ROWS)]


def _failover(pkg: str, tmp_path, blocks, device_kw):
    """A quorum cluster of `pkg`'s managers through a leader failover;
    returns (acks, the promoted leader's database)."""
    import importlib
    api = importlib.import_module(f"{pkg}.manager.api")
    store = importlib.import_module(f"{pkg}.store")
    client_mod = importlib.import_module(f"{pkg}.ingest.client")
    ports = [free_port() for _ in range(3)]
    peers = ",".join(f"n{i}=http://127.0.0.1:{p}"
                     for i, p in enumerate(ports))
    dbs, servers = [], []
    for i, role in enumerate(("leader", "follower", "follower")):
        db = store.FlowDatabase()
        db.attach_wal(str(tmp_path / f"{pkg}-w{i}"))
        srv = api.TheiaManagerServer(
            db, port=ports[i], cluster_peers=peers, cluster_self=f"n{i}",
            cluster_role=role, cluster_acks="quorum", **device_kw)
        srv.start_background()
        dbs.append(db)
        servers.append(srv)
    client = client_mod.IngestClient(
        [f"http://127.0.0.1:{p}" for p in ports], stream="slice",
        max_attempts=20, backoff_base=0.05, backoff_cap=0.2)
    try:
        acks = [client.send(b, seq=s + 1)
                for s, b in enumerate(blocks[:-1])]
        acked = sum(a["rows"] for a in acks)
        # quorum: one follower synchronously; shipping delivers the rest
        wait_until(lambda: len(dbs[1].flows) == len(dbs[2].flows)
                   == acked, what="followers hold every acked row")
        leader = servers.pop(0)
        leader.httpd.shutdown()
        leader.httpd.server_close()
        leader.cluster.stop()
        best = max((1, 2), key=lambda i: dbs[i].wal_position() or 0)
        req = urllib.request.Request(
            f"http://127.0.0.1:{ports[best]}/cluster/promote",
            data=json.dumps({"atLsn": dbs[best].wal_position()}).encode(),
            method="POST")
        with urllib.request.urlopen(req, timeout=10) as r:
            promoted = json.load(r)
        assert promoted["role"] == "leader" and promoted["term"] == 2
        retry = client.send(b"\x00", seq=len(blocks) - 1)
        assert retry.get("duplicate") is True
        assert len(dbs[best].flows) == acked       # zero acked loss
        acks.append(client.send(blocks[-1], seq=len(blocks)))
        wait_until(lambda: len(dbs[3 - best].flows)
                   == len(dbs[best].flows), what="the other follower")
    finally:
        for srv in servers:
            srv.shutdown()
    return [{k: a[k] for k in ("rows", "alerts")} for a in acks], \
        dbs[best]


def _rows(db, table, job_id):
    data = db.result_tables[table].scan()
    mine = data.filter(data.strings("id") == job_id).to_rows()
    return sorted(tuple(sorted((k, v) for k, v in r.items() if k != "id"))
                  for r in mine)


def test_quorum_cluster_then_sharded_jobs_match_the_reference(
        tmp_path, eight_devices):
    from theia_tpu import parallel as ref_par
    from theia_tpu.analytics import TadQuerySpec as RefSpec
    from theia_tpu.analytics import run_npr as ref_npr
    from theia_tpu.analytics import run_tad as ref_tad
    from theia_tpu_torch import parallel
    from theia_tpu_torch.analytics import TadQuerySpec, run_npr, run_tad

    blocks = _blocks()
    port_acks, port_db = _failover("theia_tpu_torch", tmp_path, blocks,
                                   {"device": "cpu"})
    ref_acks, ref_db = _failover("theia_tpu", tmp_path, blocks, {})
    assert port_acks == ref_acks
    assert sum(a["rows"] for a in port_acks) == len(port_db.flows) \
        == BLOCKS * BLOCK_ROWS

    def flow_rows(db):
        return sorted(tuple(sorted(r.items()))
                      for r in db.flows.scan().to_rows())

    assert flow_rows(port_db) == flow_rows(ref_db)

    mesh = parallel.make_mesh(devices=[torch.device("cpu")] * 8)
    ref_mesh = ref_par.make_mesh(8, time_shards=1)
    run_tad(port_db, "DBSCAN", TadQuerySpec(), tad_id="tad", now=0,
            mesh=mesh, device="cpu")
    ref_tad(ref_db, "DBSCAN", RefSpec(), tad_id="tad", now=0,
            mesh=ref_mesh)
    got, want = (_rows(d, "tadetector", "tad") for d in (port_db, ref_db))
    assert any(("anomaly", "true") in r for r in want)
    std = "throughputStandardDeviation"
    assert [tuple(kv for kv in r if kv[0] != std) for r in got] == \
        [tuple(kv for kv in r if kv[0] != std) for r in want]
    np.testing.assert_allclose([dict(r)[std] for r in got],
                               [dict(r)[std] for r in want],
                               rtol=STD_RTOL)

    run_npr(port_db, recommendation_id="npr", now=NOW, mesh=mesh)
    ref_npr(ref_db, recommendation_id="npr", now=NOW, mesh=ref_mesh)
    got, want = (_rows(d, "recommendations", "npr")
                 for d in (port_db, ref_db))
    assert got and got == want


def test_chip_smoke_multi_device_phase_on_the_cpu():
    """chip_smoke.py's multi_device phase with device="cpu" at a small
    size: every check of the chip run, B2's launch count aside (the CPU
    shards run B2's plain version)."""
    from theia_tpu_torch.analytics import flow_embeddings
    from theia_tpu_torch.ops.dbscan import dbscan_points_noise
    cs = _chip_smoke()
    cpu = torch.device("cpu")
    flows = cs.tad_flows(64, 32, seed=17)
    pts = torch.from_numpy(flow_embeddings(flows))
    noise = dbscan_points_noise(pts, torch.ones(len(pts), dtype=torch.bool),
                                eps=1.0)
    got = cs.phase_multi_device(flows, pts, noise, cpu, shards=4,
                                long_shape=(8, 4096), fpm_support=20)
    cs.check_multi_device(got, cpu)
    assert got["job_mesh"] is None and got["mesh"] == ["cpu"] * 4
    assert got["tad"]["DBSCAN"]["anomalies"] > 0
    assert got["sad"]["noise"] == int(noise.sum()) > 0


def test_chip_smoke_cluster_phase_on_the_cpu():
    """chip_smoke.py's cluster phase with `python -m
    theia_tpu_torch.manager --device cpu` children: the quorum failover
    drill and the routing mesh, every check of the chip run."""
    cs = _chip_smoke()
    cpu = torch.device("cpu")
    blocks = cs.tblk_blocks(cs.cluster_config(640, 4, seed=7),
                            block_rows=512)
    got = cs.phase_cluster(blocks, cpu, n_blocks=2)
    cs.check_cluster(got, cpu)
    q, m = got["quorum"], got["mesh"]
    assert q["retry"] == {"rows": 512, "duplicate": True}
    assert q["rows_after_failover"] == q["acked"] == 1024
    assert m["query"]["groups"] > 1 and m["query"]["count"] == 1024
