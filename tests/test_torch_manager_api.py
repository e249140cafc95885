"""Port parity for the manager slice over HTTP: a port
`TheiaManagerServer(device="cpu")` and a reference `TheiaManagerServer`
on port 0, both on the fused engine over a parts store, get the same
requests.

- `POST /ingest` with the same seq-stamped TBLK blocks: equal acks,
  then `/alerts` equal (connection alerts identical apart from the
  wall-clock stamps; heavy-hitter floats within rtol 1e-5, as in
  tests/test_torch_manager_ingest.py), `/healthz` (engine block),
  `/metrics` and the `deviceInfo` stats component.
- `python -m theia_tpu.cli tad run --wait` (the reference's CLI,
  JAX-free, over HTTP) for EWMA and DBSCAN against both servers: the
  result rows are equal apart from the job id, with
  throughputStandardDeviation within rtol 2e-15 (a float64 sum over T
  in another order, tests/test_torch_tad.py).
- NPR, pattern-mining, spatial and drop-detection jobs created with
  one name on both servers through the intelligence API, over the same
  posted flows (and a block of dropped flows): the rows retrieved are
  equal, and a spatial job's noise alerts reach `/alerts` on both.
- Restart from the WAL with no snapshot, and restarts across the two
  packages on one WAL directory: totalRows and the flows scan match,
  and a re-sent seq answers `duplicate: true`.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import threading
import time
import urllib.request
import uuid
from pathlib import Path

import numpy as np
import pytest

from theia_tpu.data.synth import SynthConfig, generate_flows
from theia_tpu.manager import TheiaManagerServer as RefServer
from theia_tpu.schema import FLOW_SCHEMA as REF_SCHEMA
from theia_tpu.schema import ColumnarBatch as RefBatch
from theia_tpu.store import FlowDatabase as RefDatabase
from theia_tpu.store import wire as ref_wire
from theia_tpu_torch.manager import TheiaManagerServer
from theia_tpu_torch.store import FlowDatabase

REPO = Path(__file__).resolve().parent.parent
HH_RTOL = 1e-5
STD_RTOL = 2e-15
N_SHARDS = 2
CLOCK_KEYS = ("time", "latency_s")
HH_FLOATS = ("estimate", "share")
TABLE_INFO = "/apis/stats.theia.antrea.io/v1alpha1/clickhouse/tableInfo"
DEVICE_INFO = "/apis/stats.theia.antrea.io/v1alpha1/clickhouse/deviceInfo"


@pytest.fixture(autouse=True)
def _engines(monkeypatch):
    monkeypatch.setenv("THEIA_DETECTOR_ENGINE", "fused")
    monkeypatch.setenv("THEIA_STORE_ENGINE", "parts")


def _blocks(n=3, n_series=64, points=12):
    """TAD-shaped traffic (the reference's DBSCAN-visible spikes:
    tests/test_tad.py's base and magnitude) as TBLK blocks."""
    flows = generate_flows(SynthConfig(
        n_series=n_series, points_per_series=points, anomaly_fraction=0.2,
        anomaly_magnitude=100.0, base_throughput=1e7, seed=5))
    cut = np.array_split(np.arange(len(flows)), n)
    return [ref_wire.encode_block(flows.take(idx)) for idx in cut]


def _db(cls, root: Path):
    db = cls(engine="parts", parts_dir=str(root / "parts"))
    db.attach_wal(str(root / "wal"), sync="always")
    return db


def _serve(server_cls, db):
    kw = {} if server_cls is RefServer else {"device": "cpu"}
    srv = server_cls(db, port=0, ingest_shards=N_SHARDS, **kw)
    srv.start_background()
    return srv


def _stop(srv, db):
    srv.shutdown()
    db.close_wal()


def _url(srv, path):
    return f"http://127.0.0.1:{srv.port}{path}"


def _get(srv, path):
    with urllib.request.urlopen(_url(srv, path), timeout=30) as r:
        return r.read()


def _post_ingest(srv, payload, stream, seq) -> dict:
    req = urllib.request.Request(
        _url(srv, f"/ingest?stream={stream}&seq={seq}"), data=payload,
        method="POST",
        headers={"Content-Type": "application/octet-stream"})
    with urllib.request.urlopen(req, timeout=60) as r:
        doc = json.loads(r.read())
    return {k: doc[k] for k in ("rows", "alerts", "duplicate") if k in doc}


def _total_rows(srv) -> int:
    doc = json.loads(_get(srv, TABLE_INFO))
    return next(int(t["totalRows"]) for t in doc["tableInfos"]
                if t["tableName"] == "flows")


def _flow_rows(db) -> list:
    data = db.flows.scan()
    cols = sorted(data.columns)
    decoded = {c: (data.strings(c) if c in data.dicts
                   else np.asarray(data[c])) for c in cols}
    return sorted(tuple(str(decoded[c][i]) for c in cols)
                  for i in range(len(data)))


def _assert_same_alerts(ref_ring, port_ring):
    assert len(port_ring) == len(ref_ring)
    for a, b in zip(port_ring, ref_ring):
        floats = HH_FLOATS if a["kind"] != "connection_anomaly" else ()
        strip = CLOCK_KEYS + floats
        assert {k: v for k, v in a.items() if k not in strip} == \
            {k: v for k, v in b.items() if k not in strip}
        if floats:
            np.testing.assert_allclose([a[k] for k in floats],
                                       [b[k] for k in floats],
                                       rtol=HH_RTOL)


def _cli(srv, *args) -> subprocess.Popen:
    """The reference's `theia` CLI against `srv`, started."""
    env = {**os.environ, "PYTHONPATH": str(REPO)}
    return subprocess.Popen(
        [sys.executable, "-m", "theia_tpu.cli", "--manager-addr",
         f"http://127.0.0.1:{srv.port}", *args],
        cwd=REPO, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)


def _finish(proc) -> str:
    out, _ = proc.communicate(timeout=240)
    assert proc.returncode == 0, out
    return out


def _tad_rows(path: Path) -> list:
    """Result rows without the job id, each as (the other columns,
    throughputStandardDeviation as a float)."""
    std = "throughputStandardDeviation"
    rows = json.loads(path.read_text())
    return sorted((tuple(sorted((k, v) for k, v in r.items()
                                if k not in ("id", std))),
                   float(r[std])) for r in rows)


@pytest.fixture
def pair(tmp_path):
    ref_db = _db(RefDatabase, tmp_path / "ref")
    port_db = _db(FlowDatabase, tmp_path / "port")
    ref = _serve(RefServer, ref_db)
    try:
        port = _serve(TheiaManagerServer, port_db)
    except BaseException:
        _stop(ref, ref_db)
        raise
    yield ref, port
    _stop(port, port_db)
    _stop(ref, ref_db)


def test_http_surface_and_tad_jobs_match_reference(pair, tmp_path):
    ref, port = pair
    blocks = _blocks()
    for seq, blk in enumerate(blocks):
        assert _post_ingest(port, blk, "p", seq) == \
            _post_ingest(ref, blk, "p", seq)
    assert _post_ingest(port, blocks[0], "p", 0)["duplicate"] is True

    ring_r = json.loads(_get(ref, "/alerts?limit=10000"))
    ring_p = json.loads(_get(port, "/alerts?limit=10000"))
    assert ring_p["rowsIngested"] == ring_r["rowsIngested"] > 0
    assert any(a["kind"] == "connection_anomaly" for a in ring_p["alerts"])
    _assert_same_alerts(ring_r["alerts"], ring_p["alerts"])

    health_r = json.loads(_get(ref, "/healthz"))
    health_p = json.loads(_get(port, "/healthz"))
    assert health_p["status"] == "ok"
    eng_r, eng_p = health_r["ingest"]["engine"], health_p["ingest"]["engine"]
    assert eng_p["name"] == eng_r["name"] == "fused"
    assert eng_p["steps"] == eng_r["steps"] > 0
    assert eng_p["device"] == "cpu"
    assert [s["series"] for s in health_p["ingest"]["perShard"]] == \
        [s["series"] for s in health_r["ingest"]["perShard"]]
    assert health_p["store"]["engine"] == "parts"
    assert health_p["wal"]["lastLsn"] == health_r["wal"]["lastLsn"]

    metrics = _get(port, "/metrics").decode()
    for name in ("theia_ingest_rows_total", "theia_fused_steps_total",
                 "theia_admission_level", "theia_wal_"):
        assert name in metrics
    dev = json.loads(_get(port, DEVICE_INFO))["deviceInfos"]
    assert dev == [{"shard": "0",
                    "error": "no accelerator: the manager runs on cpu"}]
    assert _total_rows(port) == _total_rows(ref) == \
        health_p["ingest"]["rowsIngested"]

    # `tad run --wait` polls every 5 s: the four jobs go in parallel
    runs = {(algo, name): _cli(srv, "tad", "run", "--algo", algo, "--wait")
            for algo in ("EWMA", "DBSCAN")
            for name, srv in (("ref", ref), ("port", port))}
    for (algo, name), proc in runs.items():
        out = _finish(proc)
        assert "No anomalies found" not in out, (algo, name)
        job = out.split("name: ", 1)[1].split()[0]
        srv = port if name == "port" else ref
        _finish(_cli(srv, "tad", "retrieve", job, "-f",
                     str(tmp_path / f"{name}-{algo}.json")))
    for algo in ("EWMA", "DBSCAN"):
        got = _tad_rows(tmp_path / f"port-{algo}.json")
        want = _tad_rows(tmp_path / f"ref-{algo}.json")
        assert got, algo
        assert [g[0] for g in got] == [w[0] for w in want], algo
        np.testing.assert_allclose([g[1] for g in got],
                                   [w[1] for w in want], rtol=STD_RTOL)


def _drop_block(seed=9, endpoints=12, days=16):
    """Dropped flows (Drop on ingress for even endpoints, Reject on
    egress for odd), Poisson(3) a day with one x20 endpoint-day each,
    as one TBLK block: drop detection's input."""
    rng = np.random.default_rng(seed)
    rows = []
    for e in range(endpoints):
        ingress = e % 2 == 0
        for day in range(days):
            n = int(rng.poisson(3.0)) * (20 if day == e % days else 1)
            rows.extend({
                "flowStartSeconds": day * 86400 + 30 * i,
                "flowEndSeconds": day * 86400 + 30 * i + 5,
                "sourcePodNamespace": "ns-c", "sourcePodName": f"c-{e}",
                "sourceIP": f"10.3.0.{e}",
                "destinationPodNamespace": "ns-s",
                "destinationPodName": f"s-{e}",
                "destinationIP": f"10.4.0.{e}",
                "ingressNetworkPolicyRuleAction": 2 if ingress else 0,
                "egressNetworkPolicyRuleAction": 0 if ingress else 3,
                "timeInserted": day * 86400 + 30 * i + 9,
            } for i in range(n))
    return ref_wire.encode_block(
        RefBatch.from_rows(rows, REF_SCHEMA))


#: job kind → (intelligence resource, spec)
JOBS = {
    "npr": ("networkpolicyrecommendations", {"jobType": "initial"}),
    "fpm": ("flowpatternminings", {"minSupport": 4}),
    "sad": ("spatialanomalydetections", {}),
    "dd": ("trafficdropdetections", {"jobType": "initial"}),
}
GROUP = "/apis/intelligence.theia.antrea.io/v1alpha1"


def _post_json(srv, path, body) -> dict:
    req = urllib.request.Request(
        _url(srv, path), data=json.dumps(body).encode(), method="POST",
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=30) as r:
        return json.loads(r.read())


def _job_result(srv, resource, name) -> dict:
    """Poll the job through the API until it ends; its retrieved
    document."""
    deadline = time.monotonic() + 120
    while time.monotonic() < deadline:
        doc = json.loads(_get(srv, f"{GROUP}/{resource}/{name}"))
        if doc["status"]["state"] in ("COMPLETED", "FAILED"):
            return doc
        time.sleep(0.1)
    raise TimeoutError(f"{name} did not finish")


def _job_rows(kind, doc) -> list:
    """The rows a user retrieves, wall-clock stamps aside: NPR's
    policies from its outcome, the other kinds' result rows."""
    if kind == "npr":
        return sorted(doc["status"]["recommendationOutcome"]
                      .split("---\n"))
    return sorted(tuple(sorted((k, v) for k, v in r.items()
                               if k != "timeCreated"))
                  for r in doc["stats"])


@pytest.mark.parametrize("kind", sorted(JOBS))
def test_job_kinds_through_the_api_match_reference(pair, kind):
    """The same flows posted to both managers, then the same job (one
    name) created on each through the intelligence API: both reach
    COMPLETED and the rows retrieved are equal; a spatial job pushes
    the same noise alerts to /alerts on both."""
    ref, port = pair
    for seq, blk in enumerate(_blocks() + [_drop_block()]):
        assert _post_ingest(port, blk, "p", seq) == \
            _post_ingest(ref, blk, "p", seq)
    resource, spec = JOBS[kind]
    name = f"{kind if kind != 'npr' else 'pr'}-{uuid.uuid4()}"
    docs = {}
    for label, srv in (("ref", ref), ("port", port)):
        _post_json(srv, f"{GROUP}/{resource}",
                   {"metadata": {"name": name}, **spec})
        docs[label] = _job_result(srv, resource, name)
    for doc in docs.values():
        assert doc["status"]["state"] == "COMPLETED", doc["status"]
    want = _job_rows(kind, docs["ref"])
    assert want and _job_rows(kind, docs["port"]) == want
    if kind == "sad":
        rings = [[{k: v for k, v in a.items() if k not in CLOCK_KEYS}
                  for a in json.loads(_get(srv, "/alerts?limit=10000"))
                  ["alerts"] if a["kind"] == "spatial_noise"]
                 for srv in (ref, port)]
        assert rings[0] and rings[1] == rings[0]
        assert all(a["job"] == name for a in rings[1])


def test_restart_from_wal_without_snapshot(tmp_path):
    root = tmp_path / "port"
    blocks = _blocks(n=2)
    db = _db(FlowDatabase, root)
    srv = _serve(TheiaManagerServer, db)
    try:
        acks = [_post_ingest(srv, b, "p", i) for i, b in enumerate(blocks)]
        rows = _flow_rows(db)
    finally:
        _stop(srv, db)
    db = _db(FlowDatabase, root)
    srv = _serve(TheiaManagerServer, db)
    try:
        assert _total_rows(srv) == sum(a["rows"] for a in acks)
        assert _flow_rows(db) == rows
        assert _post_ingest(srv, blocks[1], "p", 1) == {
            "rows": acks[1]["rows"], "alerts": 0, "duplicate": True}
    finally:
        _stop(srv, db)


@pytest.mark.parametrize("first,second", [
    ("reference", "port"), ("port", "reference")])
def test_restart_across_packages_on_one_wal(tmp_path, first, second):
    """A WAL directory written by one package's manager is recovered
    by the other's: every row, and the dedup window."""
    kinds = {"reference": (RefDatabase, RefServer),
             "port": (FlowDatabase, TheiaManagerServer)}
    blocks = _blocks(n=2)
    db_cls, srv_cls = kinds[first]
    db = _db(db_cls, tmp_path)
    srv = _serve(srv_cls, db)
    try:
        acks = [_post_ingest(srv, b, "p", i) for i, b in enumerate(blocks)]
        rows = _flow_rows(db)
    finally:
        _stop(srv, db)
    db_cls, srv_cls = kinds[second]
    db = _db(db_cls, tmp_path)
    srv = _serve(srv_cls, db)
    try:
        assert _total_rows(srv) == sum(a["rows"] for a in acks) > 0
        assert _flow_rows(db) == rows
        assert _post_ingest(srv, blocks[0], "p", 0)["duplicate"] is True
    finally:
        _stop(srv, db)


def test_server_refuses_subprocess_dispatch_and_stops_its_engine():
    """The job runner is not ported (ROADMAP A17): the server refuses
    the dispatch mode, and closes the fused engine it had started."""
    before = {t.name for t in threading.enumerate()}
    with pytest.raises(ValueError, match="ROADMAP A17"):
        TheiaManagerServer(FlowDatabase(), port=0, dispatch="subprocess",
                           ingest_shards=1, device="cpu")
    after = {t.name for t in threading.enumerate()}
    assert not {n for n in after - before if "fused" in n}


@pytest.mark.parametrize("how", ["argument", "environment"])
def test_server_refuses_the_cluster_tier(how, monkeypatch):
    """The cluster tier is not ported (ROADMAP A19): a library caller
    that asks for it, by argument or through THEIA_CLUSTER_PEERS, is
    refused before the server starts a thread."""
    peers = "n0=http://127.0.0.1:1,n1=http://127.0.0.1:2"
    kwargs = {}
    if how == "argument":
        kwargs["cluster_peers"] = peers
    else:
        monkeypatch.setenv("THEIA_CLUSTER_PEERS", peers)
    before = {t.name for t in threading.enumerate()}
    with pytest.raises(ValueError, match="ROADMAP A19"):
        TheiaManagerServer(FlowDatabase(), port=0, ingest_shards=1,
                           device="cpu", **kwargs)
    assert {t.name for t in threading.enumerate()} <= before


@pytest.mark.parametrize("argv,item", [
    (["--peers", "n0=http://127.0.0.1:1"], "ROADMAP A19"),
    (["--role", "peer"], "ROADMAP A19"),
    (["--reconcile-dir", "crs"], "ROADMAP A19"),
    (["--dispatch", "subprocess"], "ROADMAP A17"),
])
def test_entry_point_refuses_what_is_not_ported(argv, item, capsys):
    from theia_tpu_torch.manager.__main__ import main
    with pytest.raises(SystemExit) as err:
        main(["--device", "cpu", "--port", "0", *argv])
    assert err.value.code == 2
    assert item in capsys.readouterr().err


def test_entry_point_needs_a_card_unless_told_cpu(monkeypatch):
    """`python -m theia_tpu_torch.manager` defaults to --device cuda:
    without a card it raises instead of serving on the CPU."""
    import torch
    from theia_tpu_torch.manager.__main__ import main
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        main(["--port", "0"])
