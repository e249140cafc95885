"""The port's `theia` CLI (theia_tpu_torch.cli) against port managers
on the CPU (device="cpu").

- The reference's CLI cases (tests/test_manager_cli.py,
  test_portforward.py, test_auth.py, test_faults.py, test_obs.py,
  test_profiling.py, test_rollup.py, test_tracing.py,
  test_metrics_history.py, test_pattern_spatial_jobs.py), run with
  `theia_tpu_torch.cli.__main__.main` against port managers. The
  profile case reads the port's message: the capture is a
  torch.profiler trace.json.
- Side by side: one argv through both CLIs, the reference's against a
  reference manager (JAX on the CPU) and the port's against a port
  manager over the same seeded flows, prints the same stdout once job
  names, ids, timings and rates are masked.
- A fresh `python -m theia_tpu_torch.cli` loads neither torch nor jax,
  for --help and for commands that reach a manager.
- chip_smoke.py's `cli` phase at a small size on the CPU.

`run --wait` polls every POLL_INTERVAL (5 s); the fixture below
shortens it so that a job's wait is not the test's time.
"""

from __future__ import annotations

import contextlib
import io
import json
import re
import stat
import subprocess
import tarfile
import threading
import time
import urllib.request
from pathlib import Path

import numpy as np
import pytest
import torch

from theia_tpu.cli import __main__ as ref_cli
from theia_tpu.data.synth import SynthConfig as RefSynth
from theia_tpu.data.synth import generate_flows as ref_flows
from theia_tpu.manager import TheiaManagerServer as RefServer
from theia_tpu.store import FlowDatabase as RefDatabase
from theia_tpu_torch.cli import __main__ as cli
from theia_tpu_torch.cli.portforward import PortForwarder, PortForwardError
from theia_tpu_torch.data.synth import SynthConfig, generate_flows
from theia_tpu_torch.ingest import BlockEncoder
from theia_tpu_torch.ingest.client import IngestClient
from theia_tpu_torch.manager import TheiaManagerServer
from theia_tpu_torch.obs import metrics, trace
from theia_tpu_torch.query.explain import SLOW_QUERIES
from theia_tpu_torch.schema import FLOW_SCHEMA, ColumnarBatch
from theia_tpu_torch.store import FlowDatabase
from test_torch_analysis import port_lockdep_clean  # noqa: F401
from test_torch_cluster import free_port
from test_torch_scale_out import _chip_smoke
from test_torch_tracing import make_mesh, shutdown_all

REPO = Path(__file__).resolve().parent.parent
cli_main = cli.main
TOKEN = "test-token-123"


@pytest.fixture(autouse=True)
def _short_polls(monkeypatch):
    monkeypatch.setattr(cli, "POLL_INTERVAL", 0.1)
    monkeypatch.setattr(ref_cli, "POLL_INTERVAL", 0.1)


def _serve(db, **kw):
    srv = TheiaManagerServer(db, port=0, device="cpu", **kw)
    srv.start_background()
    return srv


@pytest.fixture()
def server():
    """tests/test_manager_cli.py's manager, on the port."""
    db = FlowDatabase()
    db.insert_flows(generate_flows(SynthConfig(
        n_series=12, points_per_series=20, anomaly_fraction=0.3,
        anomaly_magnitude=60.0, seed=6)))
    srv = _serve(db)
    yield srv
    srv.shutdown()


# -- tests/test_manager_cli.py ---------------------------------------------

def test_cli_end_to_end(server, capsys):
    addr = ["--manager-addr", f"http://127.0.0.1:{server.port}"]
    cli_main(addr + ["tad", "run", "--algo", "EWMA", "--wait"])
    out = capsys.readouterr().out
    assert "Successfully started" in out
    assert "EWMA" in out  # stats table printed

    cli_main(addr + ["tad", "list"])
    out = capsys.readouterr().out
    assert "COMPLETED" in out

    cli_main(addr + ["policy-recommendation", "run", "--wait"])
    out = capsys.readouterr().out
    assert "kind: NetworkPolicy" in out

    cli_main(addr + ["clickhouse", "status", "--tableInfo"])
    out = capsys.readouterr().out
    assert "flows" in out

    cli_main(addr + ["version"])
    out = capsys.readouterr().out
    assert "theia version" in out


def test_cli_retrieve_and_delete(server, capsys):
    addr = ["--manager-addr", f"http://127.0.0.1:{server.port}"]
    cli_main(addr + ["tad", "run", "--algo", "DBSCAN"])
    name = capsys.readouterr().out.strip().split()[-1]
    assert server.controller.wait_all()
    cli_main(addr + ["tad", "retrieve", name])
    out = capsys.readouterr().out
    assert "DBSCAN" in out or "No anomalies found" in out
    cli_main(addr + ["tad", "delete", name])
    assert "deleted" in capsys.readouterr().out
    with pytest.raises(SystemExit):
        cli_main(addr + ["tad", "status", name])


# -- tests/test_portforward.py ---------------------------------------------

def _fake_kubectl(tmp_path, port: int, lines=None, rc=0):
    """A kubectl stand-in: prints the port-forward banner for `port`
    then stays alive (like the real forwarder does)."""
    script = tmp_path / "kubectl"
    body = lines if lines is not None else [
        f"Forwarding from 127.0.0.1:{port} -> 11347",
        f"Forwarding from [::1]:{port} -> 11347",
    ]
    script.write_text(
        "#!/bin/sh\n"
        + "".join(f"echo '{line}'\n" for line in body)
        + (f"exit {rc}\n" if rc else "sleep 600\n"))
    script.chmod(script.stat().st_mode | stat.S_IEXEC)
    return str(script)


@pytest.fixture()
def small_server():
    db = FlowDatabase()
    db.insert_flows(generate_flows(SynthConfig(
        n_series=6, points_per_series=10, seed=5)))
    srv = _serve(db)
    yield srv
    srv.shutdown()


def test_port_forwarder_parses_port_and_stops(small_server, tmp_path):
    kc = _fake_kubectl(tmp_path, small_server.port)
    fw = PortForwarder("flow-visibility", kubectl=kc)
    try:
        assert fw.start() == small_server.port
        assert fw._proc.poll() is None   # forwarder held open
    finally:
        fw.stop()
    assert fw._proc is None


def test_cli_use_port_forward_end_to_end(small_server, tmp_path, capsys):
    kc = _fake_kubectl(tmp_path, small_server.port)
    cli_main(["--use-port-forward", "--kubectl", kc,
              "tad", "run", "--algo", "EWMA", "--wait"])
    out = capsys.readouterr().out
    assert "Successfully started" in out
    # the forwarder child was torn down with the command
    time.sleep(0.2)
    left = subprocess.run(["pgrep", "-f", kc], capture_output=True,
                          text=True).stdout.strip()
    assert not left


def test_missing_kubectl_is_a_clean_error():
    fw = PortForwarder("ns", kubectl="/nonexistent/kubectl")
    with pytest.raises(PortForwardError, match="PATH"):
        fw.start()


def test_kubectl_failure_reports_output(tmp_path):
    kc = _fake_kubectl(tmp_path, 0,
                       lines=["error: unable to forward"], rc=1)
    fw = PortForwarder("ns", kubectl=kc)
    # the operator sees kubectl's own words, not just "did not come up"
    with pytest.raises(PortForwardError, match="unable to forward"):
        fw.start()


# -- tests/test_auth.py ----------------------------------------------------

def test_cli_token_flag_and_file(tmp_path, capsys):
    db = FlowDatabase()
    db.insert_flows(generate_flows(SynthConfig(
        n_series=4, points_per_series=10, seed=2)))
    srv = _serve(db, auth_token=TOKEN)
    try:
        addr = ["--manager-addr", f"http://127.0.0.1:{srv.port}"]
        # without a token the mutating CLI call fails with the 401 message
        with pytest.raises(SystemExit, match="401"):
            cli_main(addr + ["tad", "run", "--algo", "EWMA"])
        capsys.readouterr()
        cli_main(addr + ["--token", TOKEN,
                         "tad", "run", "--algo", "EWMA", "--wait"])
        assert "Successfully started" in capsys.readouterr().out

        tf = tmp_path / "token"
        tf.write_text(TOKEN + "\n")
        cli_main(addr + ["--token-file", str(tf), "pr", "run", "--wait"])
        assert "kind: NetworkPolicy" in capsys.readouterr().out
    finally:
        srv.shutdown()


# -- tests/test_faults.py --------------------------------------------------

def test_cli_poll_retries_transient_errors(monkeypatch):
    calls = {"n": 0}

    def fake_request(addr, method, path, body=None):
        calls["n"] += 1
        if calls["n"] < 3:
            raise cli.APIConnectionError(
                "error: cannot reach theia-manager at x: refused")
        return {"status": {"state": "COMPLETED"}}

    sleeps = []
    monkeypatch.setattr(cli, "_request", fake_request)
    monkeypatch.setattr(cli.time, "sleep", lambda s: sleeps.append(s))
    doc = cli._wait_for_job("http://x", cli.TAD_RESOURCE, "tad-x")
    assert doc["status"]["state"] == "COMPLETED"
    assert calls["n"] == 3
    assert sleeps == [1.0, 2.0]   # capped exponential backoff


def test_cli_poll_gives_up_at_deadline(monkeypatch):
    def always_down(addr, method, path, body=None):
        raise cli.APIConnectionError("error: cannot reach manager")

    monkeypatch.setattr(cli, "_request", always_down)
    monkeypatch.setattr(cli.time, "sleep", lambda s: None)
    with pytest.raises(cli.APIConnectionError):
        cli._poll_request("http://x", "/p", deadline=time.time() - 1)


def test_cli_tls_failure_is_not_retried(monkeypatch):
    """A TLS verification failure is permanent: it must classify as a
    plain APIError (fail fast), not the retryable connection class."""
    import ssl
    import urllib.error

    def boom(*a, **kw):
        raise urllib.error.URLError(
            ssl.SSLCertVerificationError("certificate verify failed"))

    monkeypatch.setattr(urllib.request, "urlopen", boom)
    with pytest.raises(cli.APIError) as ei:
        cli._request("https://x", "GET", "/p")
    assert not isinstance(ei.value, cli.APIConnectionError)


def test_cli_non_transient_http_error_fails_fast(monkeypatch):
    def bad_request(addr, method, path, body=None):
        raise cli.APIError("error: 400 from manager: nope")

    monkeypatch.setattr(cli, "_request", bad_request)
    with pytest.raises(cli.APIError):
        cli._poll_request("http://x", "/p", deadline=time.time() + 3600)


# -- tests/test_obs.py, test_profiling.py, test_rollup.py ------------------

def test_theia_top_renders_rates_table(capsys):
    srv = _serve(FlowDatabase())
    try:
        batch = generate_flows(SynthConfig(n_series=8,
                                           points_per_series=10))
        enc = BlockEncoder(dicts=batch.dicts)
        req = urllib.request.Request(
            f"http://127.0.0.1:{srv.port}/ingest",
            data=enc.encode(batch), method="POST")
        urllib.request.urlopen(req, timeout=10).read()
        cli_main(["--manager-addr", f"http://127.0.0.1:{srv.port}",
                  "top", "-n", "2", "-i", "0.05", "--no-clear"])
        out = capsys.readouterr().out
        assert "theia top —" in out
        assert "theia_ingest_rows_total" in out
        assert "RATE/s" in out
        # second render carries rates (first has no previous sample)
        assert out.count("METRIC") == 2
    finally:
        srv.shutdown()


def _busy_device(stop):
    x = torch.ones((256, 256))
    while not stop.is_set():
        x @ x


def test_profile_cli_end_to_end(tmp_path, capsys):
    db = FlowDatabase()
    db.insert_flows(generate_flows(SynthConfig(
        n_series=4, points_per_series=10, seed=4)))
    srv = _serve(db)
    stop = threading.Event()
    t = threading.Thread(target=_busy_device, args=(stop,), daemon=True)
    t.start()
    try:
        out = tmp_path / "prof.tar.gz"
        cli_main(["--manager-addr", f"http://127.0.0.1:{srv.port}",
                  "profile", "-d", "0.5", "-f", str(out)])
        text = capsys.readouterr().out
        assert "torch.profiler trace written" in text
        assert "Perfetto" in text
        assert out.stat().st_size > 0
        with tarfile.open(out, mode="r:gz") as tar:
            assert tar.getnames() == ["trace.json"]
            assert "traceEvents" in json.load(tar.extractfile("trace.json"))
    finally:
        stop.set()
        t.join(timeout=10)
        srv.shutdown()
    assert not t.is_alive()


def test_views_cli_renders(monkeypatch, tmp_path, capsys):
    """tests/test_rollup.py's case: one view over flows spread across
    ten minutes."""
    view = {"name": "per_pair",
            "groupBy": ["sourceIP", "destinationIP"],
            "aggregates": ["count", "sum:octetDeltaCount", "max:throughput",
                           "min:throughput", "mean:throughput"],
            "bucketSeconds": 60,
            "tiers": [{"resolutionSeconds": 600, "afterSeconds": 1200},
                      {"resolutionSeconds": 3600, "afterSeconds": 7200}]}
    views = tmp_path / "v.json"
    views.write_text(json.dumps({"views": [view]}))
    monkeypatch.setenv("THEIA_ROLLUP_VIEWS", str(views))
    monkeypatch.setenv("THEIA_METRICS_SCRAPE_INTERVAL", "0")
    monkeypatch.setenv("THEIA_RETENTION_INTERVAL", "0")
    t0 = 1_000_000
    b = generate_flows(SynthConfig(n_series=32, points_per_series=16,
                                   anomaly_fraction=0.05, seed=0))
    cols = dict(b.columns)
    cols["timeInserted"] = np.sort(np.random.default_rng(1).integers(
        t0, t0 + 600, len(b))).astype(np.int64)
    db = FlowDatabase()
    db.insert_flows(ColumnarBatch(cols, b.dicts))
    srv = _serve(db)
    try:
        cli_main(["--manager-addr", f"http://127.0.0.1:{srv.port}",
                  "views"])
        out = capsys.readouterr().out
        assert "per_pair" in out
        assert "rows applied" in out
    finally:
        srv.shutdown()


# -- tests/test_tracing.py, test_metrics_history.py ------------------------

@pytest.fixture()
def clean_obs():
    metrics.enable()
    metrics.REGISTRY.zero()
    trace.reset()
    SLOW_QUERIES.reset()
    trace.set_node_id("")
    yield
    metrics.enable()
    trace.set_node_id("")


def test_theia_trace_cli_renders_tree(clean_obs, monkeypatch, capsys):
    ports, dbs, servers = make_mesh(2, monkeypatch)
    try:
        enc = BlockEncoder()
        out = IngestClient(f"http://127.0.0.1:{ports[0]}",
                           stream="clitrace").send(
            enc.encode(generate_flows(SynthConfig(
                n_series=32, points_per_series=5,
                anomaly_fraction=0.0, seed=51), dicts=enc.dicts)))
        trace_id = out["traceId"]
        cli_main(["--manager-addr", f"http://127.0.0.1:{ports[0]}",
                  "trace", trace_id])
        text = capsys.readouterr().out
        assert f"trace {trace_id}" in text
        assert "ingest.request" in text
        # unknown trace id: a clear message, not a crash
        cli_main(["--manager-addr", f"http://127.0.0.1:{ports[0]}",
                  "trace", "f" * 32])
        assert "no spans retained" in capsys.readouterr().out
    finally:
        shutdown_all(servers)


def test_top_cluster_renders_per_node_columns(clean_obs, monkeypatch,
                                              capsys):
    ports, dbs, servers = make_mesh(2, monkeypatch)
    try:
        enc = BlockEncoder()
        IngestClient(f"http://127.0.0.1:{ports[0]}",
                     stream="topc").send(enc.encode(generate_flows(
                         SynthConfig(n_series=16, points_per_series=5,
                                     anomaly_fraction=0.0, seed=41),
                         dicts=enc.dicts)))
        addr_list = ",".join(f"http://127.0.0.1:{p}" for p in ports)
        cli_main(["--manager-addr", addr_list, "top", "--cluster",
                  "-n", "2", "-i", "0.05", "--no-clear"])
        out = capsys.readouterr().out
        assert "theia top --cluster — 2/2 nodes up" in out
        assert "TOTAL" in out
        for p in ports:
            assert f"127.0.0.1:{p}" in out
        # a dead endpoint renders DOWN instead of crashing the loop
        dead = free_port()
        cli_main(["--manager-addr",
                  f"http://127.0.0.1:{ports[0]},"
                  f"http://127.0.0.1:{dead}",
                  "top", "--cluster", "-n", "1", "-i", "0.05",
                  "--no-clear"])
        out = capsys.readouterr().out
        assert "1/2 nodes up" in out
        assert "DOWN" in out
    finally:
        shutdown_all(servers)


def test_history_series_keeps_trailing_samples():
    """The sparkline fold's trailing remainder lands in the final
    bucket (tests/test_metrics_history.py's case)."""
    scale = 1_000_000
    # window=100 → bucket=15, n_buckets=6, covered span [0, 90)
    start, bucket, n_buckets = 0, 15, 6

    def gauge_row(t, v):
        return {"timeInserted": t, "metric": "g", "kind": "gauge",
                "labels": "", "node": "n1",
                "sum(valueSum)": int(v * scale), "sum(valueCount)": 1,
                "min(valueMin)": int(v * scale),
                "max(valueMax)": int(v * scale)}

    rows = [gauge_row(0, 1.0), gauge_row(95, 7.0),
            gauge_row(100, 9.0)]          # t=now lands past 6*15
    series = cli._history_series(rows, start, bucket, n_buckets)
    vals = series[("g", "gauge")]
    assert len(vals) == n_buckets
    assert vals[0] == 1.0
    # both trailing samples pool into the final bucket's mean
    assert vals[-1] == 8.0
    # pre-window samples still drop
    assert cli._history_series([gauge_row(-5, 3.0)], start, bucket,
                               n_buckets) == {}


# -- tests/test_pattern_spatial_jobs.py ------------------------------------

def test_fpm_sad_cli_end_to_end(capsys):
    db = FlowDatabase()
    db.insert_flows(generate_flows(SynthConfig(
        n_series=6, points_per_series=20, seed=17)))
    # one-off flow: unique endpoints seen exactly once -> spatial noise
    db.insert_flows(ColumnarBatch.from_rows([{
        "sourceIP": "203.0.113.99", "destinationIP": "198.51.100.7",
        "destinationTransportPort": 4444, "octetDeltaCount": 1234,
        "packetDeltaCount": 3, "timeInserted": 1_700_000_000,
    }], FLOW_SCHEMA, db.flows.dicts))
    server = _serve(db)
    try:
        addr = ["--manager-addr", f"http://127.0.0.1:{server.port}"]
        cli_main(addr + ["fpm", "run", "--max-len", "2", "--wait"])
        out = capsys.readouterr().out
        assert "Successfully started flow pattern mining" in out
        assert "support" in out   # stats table header

        cli_main(addr + ["fpm", "list"])
        assert "COMPLETED" in capsys.readouterr().out

        cli_main(addr + ["sad", "run", "--wait"])
        out = capsys.readouterr().out
        assert "203.0.113.99" in out

        cli_main(addr + ["sad", "list"])
        name = None
        for line in capsys.readouterr().out.splitlines():
            if line.startswith("sad-"):
                name = line.split()[0]
        assert name
        cli_main(addr + ["sad", "delete", name])
        assert "deleted" in capsys.readouterr().out
        assert len(server.controller.db.spatialnoise) == 0
    finally:
        server.shutdown()


# -- side by side ----------------------------------------------------------

#: what may differ between two runs of one command: job names and row
#: ids (uuids), NPR policy-name suffixes, trace ids, timings, rates
MASKS = (
    (r"[0-9a-f]{8}-[0-9a-f]{4}-[0-9a-f]{4}-[0-9a-f]{4}-[0-9a-f]{12}",
     "<uuid>"),
    (r"(recommend-[a-z-]+-)[0-9a-z]{5}\b", r"\1<id>"),
    (r"trace [0-9a-f]{32}", "trace <id>"),
    (r"[0-9.]+ ms\b", "<t> ms"),
    (r"\([0-9,]+ rows/s\)", "(<r> rows/s)"),
    (r"(== insertRate ==\n.*\n)(.*\n)*", r"\1"),
)

SIDE_BY_SIDE = (
    ["tad", "run", "--algo", "EWMA", "--wait"],
    ["tad", "run", "--algo", "DBSCAN", "--wait"],
    ["tad", "retrieve", "{tad}"],
    ["pr", "run", "--wait"],
    ["query", "--group-by", "sourcePodNamespace,destinationPodNamespace",
     "--agg", "count", "--agg", "sum:octetDeltaCount",
     "--agg", "min:octetDeltaCount", "--agg", "max:octetDeltaCount",
     "-k", "0"],
    ["ingest", "--stream", "cli", "--series", "16", "--points", "4",
     "--batches", "2"],
    ["clickhouse", "status"],
    ["clickhouse", "status", "--tableInfo"],
)


def _mask(text: str) -> str:
    for pattern, repl in MASKS:
        text = re.sub(pattern, repl, text)
    return text


def _stdout(main, port: int, argv) -> str:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        main(["--manager-addr", f"http://127.0.0.1:{port}", *argv])
    return buf.getvalue()


def test_both_clis_print_the_same(monkeypatch):
    """Reference CLI → reference manager and port CLI → port manager,
    over the same seeded flows: the same stdout, masked."""
    shape = dict(n_series=12, points_per_series=20, anomaly_fraction=0.3,
                 anomaly_magnitude=60.0, seed=6)
    ref_db = RefDatabase()
    ref_db.insert_flows(ref_flows(RefSynth(**shape)))
    port_db = FlowDatabase()
    port_db.insert_flows(generate_flows(SynthConfig(**shape)))
    ref = RefServer(ref_db, port=0)
    ref.start_background()
    try:
        port = _serve(port_db)
    except BaseException:
        ref.shutdown()
        raise
    try:
        names = {}
        for argv in SIDE_BY_SIDE:
            outs = {}
            for label, main, srv in (("ref", ref_cli.main, ref),
                                     ("port", cli_main, port)):
                args = [a.format(tad=names.get((label, "tad"), ""))
                        for a in argv]
                outs[label] = _stdout(main, srv.port, args)
                found = re.search(r"name: (tad-\S+)", outs[label])
                if found and "DBSCAN" in argv:
                    names[(label, "tad")] = found.group(1)
            assert outs["port"].strip(), argv
            assert _mask(outs["port"]) == _mask(outs["ref"]), argv
        assert set(names) == {("ref", "tad"), ("port", "tad")}
    finally:
        port.shutdown()
        ref.shutdown()


# -- the CLI stays off the card --------------------------------------------

def test_cli_loads_neither_torch_nor_jax(small_server):
    """`python -m theia_tpu_torch.cli` in a fresh interpreter
    (chip_smoke.py's probe child): --help, and commands that reach a
    manager (ingest, query, version), load no torch and no jax, so a
    CLI call never opens a CUDA context."""
    cs = _chip_smoke()
    for argv in (["--help"], ["ingest", "--series", "8", "--points", "2"],
                 ["query", "--group-by", "sourceIP", "--agg", "count"],
                 ["version"]):
        got = cs.cli_probe(small_server.port, *argv)
        assert (got["exit"], got["loaded"]) == (0, []), argv


# -- chip_smoke.py's cli phase ---------------------------------------------

def test_chip_smoke_cli_phase_on_the_cpu(monkeypatch, tmp_path):
    """chip_smoke.phase_cli at a small size with device="cpu", against
    an in-process port manager on the fused engine that holds TAD
    flows: every command exits 0, the acked rows are stored, the CLI's
    DBSCAN rows are the API's, the query is equal in both modes and
    to GET /query (torch on the CPU), and no child loaded torch."""
    cs = _chip_smoke()
    for name, value in (("CLI_SERIES", 64), ("CLI_BATCHES", 2),
                        ("CLI_PROFILE_S", 0.3), ("CLI_QUERY_REPEATS", 1)):
        monkeypatch.setattr(cs, name, value)
    monkeypatch.setenv("THEIA_DETECTOR_ENGINE", "fused")
    monkeypatch.setenv("THEIA_STORE_ENGINE", "parts")
    monkeypatch.setenv("THEIA_RETENTION_INTERVAL", "0")
    db = FlowDatabase(engine="parts", parts_dir=str(tmp_path / "parts"))
    srv = _serve(db, ingest_shards=2)
    try:
        client = IngestClient(f"http://127.0.0.1:{srv.port}", stream="tad")
        for blk in cs.encode_blocks(cs.tad_flows(64, 24, seed=5),
                                    block_rows=512):
            client.send(blk)
        got = cs.phase_cli(srv.port, torch.device("cpu"))
    finally:
        srv.shutdown()
    cs.check_cli(got)
    assert got["ingest"]["acked"] == 2 * 64 * 4
    assert got["tad"]["rows_equal_api"] and got["tad"]["rows"] > 0
    query = got["query"]
    assert query["rows_equal"] and query["equal_get_query"]
    assert query["torch"]["kernel"] == "torch"
    assert query["torch_reduction_devices"] == ["cpu"]
    assert all(got["views"].values())
    assert got["profile"]["members"] == ["trace.json"]
    assert len(got["probes"]) == 3
