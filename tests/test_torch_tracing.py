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


# -- spans in a profile capture, and the job path's spans -------------------

def _capture_case(case, monkeypatch):
    """Publish a few spans under one of the switches; the records the
    capture kept and the capture."""
    import collections
    cap = {"cap": 3}.get(case, trace.CAPTURE_CAP)
    if case == "ring_zero":
        monkeypatch.setattr(trace, "_ring", collections.deque(maxlen=0))
    if case == "disabled":
        metrics.disable()
    capture = trace.start_capture(cap)
    if case == "off":
        trace.stop_capture(capture)
    try:
        if case == "unsampled":
            monkeypatch.setenv("THEIA_TRACE_SAMPLE", "0")
            with trace.ingress_span("job.run"):
                for i in range(5):
                    with trace.span("inner", i=i):
                        pass
        else:
            for i in range(5):
                with trace.span("inner", i=i):
                    pass
    finally:
        trace.stop_capture(capture)
    return capture


@pytest.mark.parametrize("case, kept, dropped", [
    ("on", 5, 0), ("off", 0, 0), ("cap", 3, 2), ("ring_zero", 0, 0),
    ("unsampled", 0, 0), ("disabled", 0, 0)])
def test_capture_sink_keeps_what_the_ring_keeps(case, kept, dropped,
                                                monkeypatch):
    """A running capture keeps each record the ring takes, up to its
    cap, counting the rest; with no capture, THEIA_TRACE_RING=0, an
    unsampled trace or metrics disabled it keeps nothing."""
    capture = _capture_case(case, monkeypatch)
    assert [r["i"] for r in capture.records] == list(range(kept))
    assert capture.dropped == dropped
    with trace.span("after"):
        pass
    assert all(r["op"] == "inner" for r in capture.records)


def test_records_carry_the_native_thread_id():
    import threading
    got = {}

    def work():
        with trace.span("in.thread"):
            pass
        trace.record("recorded", 0.0, 0.001)
        got["tid"] = threading.get_native_id()

    th = threading.Thread(target=work)
    th.start()
    th.join()
    recs = {r["op"]: r for r in trace.recent()}
    assert recs["in.thread"]["tid"] == got["tid"]
    assert recs["recorded"]["tid"] == got["tid"]
    assert got["tid"] != threading.get_native_id()


@pytest.mark.parametrize("scheme", ["native", "ident", "abs", "neither"])
def test_thread_rows_follow_the_runtime_events_ids(scheme):
    """An exported span goes on the row of its thread's CUDA runtime
    calls, whichever of the thread's ids the trace gives them: the
    native id, or CUPTI's (the ident cut to 32 bits, as is or as the
    absolute value of that signed number)."""
    import threading
    native = threading.get_native_id()
    cut = threading.get_ident() & 0xFFFFFFFF
    row = {"native": native, "ident": cut,
           "abs": abs(cut - (1 << 32) if cut >> 31 else cut),
           "neither": native}[scheme]
    runtime = {3} if scheme == "neither" else {row, 3}
    rows = trace.thread_rows(runtime)
    assert rows[native] == row
    recs = [{"op": "x", "startTime": 1.0, "durationMs": 1.0,
             "tid": native}]
    (ev,) = trace.chrome_events(recs, 0.0, 0.0, 2.0, pid=1, rows=rows)
    assert ev["tid"] == rows[native]


@pytest.mark.parametrize("case", ["sampled", "unsampled", "none"])
def test_record_in_joins_the_trace_of_a_closed_parent(case, monkeypatch):
    """record_in publishes a child of a span that has closed since, in
    that span's trace; under an unsampled parent nothing, and with no
    parent a record of no trace."""
    if case == "unsampled":
        monkeypatch.setenv("THEIA_TRACE_SAMPLE", "0")
    parent = None
    if case != "none":
        with trace.ingress_span("parent") as parent:
            pass
    trace.record_in(parent, "child", 12.5, 0.002, rows=3)
    got = [r for r in trace.recent() if r["op"] == "child"]
    if case == "unsampled":
        assert got == []
        return
    (rec,) = got
    assert (rec["startTime"], rec["durationMs"], rec["rows"]) == \
        (12.5, 2.0, 3)
    if case == "none":
        assert rec["parent"] is None and "traceId" not in rec
    else:
        assert rec["parent"] == "parent"
        assert rec["traceId"] == parent.context.trace_id
        assert rec["parentSpanId"] == parent.context.span_id
        assert rec["spanId"] != parent.context.span_id


def _profile_with_spans(records):
    """A CPU capture of 0.6 s (manager/profiling.py) while `records`
    (op, seconds from now, duration s) are published from this thread;
    its trace.json as a dict."""
    import io
    import tarfile
    import threading
    import time
    from theia_tpu_torch.manager.profiling import ProfileManager
    pm = ProfileManager(device="cpu")
    out = {}
    th = threading.Thread(target=lambda: out.setdefault(
        "tar", pm._collect(0.6)))
    th.start()
    import torch
    deadline = time.time() + 30
    while not torch.autograd.profiler._is_profiler_enabled \
            and time.time() < deadline:
        time.sleep(0.005)
    time.sleep(0.05)           # past the capture's marker
    now = time.time()
    for op, at, dur in records:
        trace.record(op, now + at, dur)
    th.join(60)
    with tarfile.open(fileobj=io.BytesIO(out["tar"]), mode="r:gz") as tar:
        return json.load(tar.extractfile("trace.json"))


def test_capture_puts_spans_on_the_traces_clock():
    """Two spans 0.2 s apart land 200,000 µs apart as theia_span
    events; spans that start before the capture or end after it are
    left out; the marker that tied the clocks is gone from the trace."""
    import threading
    from theia_tpu_torch.manager.profiling import CAPTURE_MARK
    doc = _profile_with_spans([("a", 0.0, 0.01), ("b", 0.2, 0.03),
                               ("before", -30.0, 0.01),
                               ("after", 0.1, 5.0)])
    spans = {e["name"]: e for e in doc["traceEvents"]
             if e.get("cat") == trace.SPAN_CATEGORY}
    assert set(spans) == {"a", "b"}
    assert spans["b"]["ts"] - spans["a"]["ts"] == pytest.approx(2e5,
                                                               abs=1.0)
    assert spans["b"]["dur"] == pytest.approx(3e4, abs=0.5)
    assert spans["a"]["ph"] == "X"
    assert spans["a"]["tid"] == threading.get_native_id()
    assert not any(e.get("name") == CAPTURE_MARK
                   for e in doc["traceEvents"])
    info = doc["theiaSpans"]
    assert info["exported"] == 2 and info["dropped"] == 0
    # the marker's offset agrees with the trace's own epoch
    assert abs(info["baseOffsetErrorUs"]) < 20_000
    # the spans lie among the profiler's own events
    host = [e["ts"] for e in doc["traceEvents"]
            if e.get("ph") == "X" and e.get("cat") != trace.SPAN_CATEGORY]
    assert min(host) <= spans["a"]["ts"]
    assert trace._capture is None


def test_chrome_events_of_records():
    recs = [{"op": "x", "startTime": 100.0, "durationMs": 500.0,
             "tid": 7, "traceId": "t", "spanId": "s", "rows": 2},
            {"op": "y", "startTime": 99.9, "durationMs": 1.0, "tid": 7},
            {"op": "z", "startTime": 100.6, "durationMs": 500.0,
             "tid": 7}]
    got = trace.chrome_events(recs, -100e6, 100.0, 101.0, pid=5)
    assert got == [{"ph": "X", "cat": "theia_span", "name": "x",
                    "pid": 5, "tid": 7, "ts": 0.0, "dur": 500000.0,
                    "args": {"traceId": "t", "spanId": "s", "rows": 2}}]


def _job_db():
    from test_torch_subprocess_dispatch import _drop_rows, _flows
    db = FlowDatabase()
    db.insert_flows(_flows(seed=3))
    db.insert_flow_rows(_drop_rows())
    return db


def _run_jobs(jobs, alert_sink=None):
    """Run (kind, spec) jobs one after another in process on the CPU;
    the records and every span finished meanwhile, oldest first."""
    from theia_tpu_torch.manager.jobs import JobController
    ctl = JobController(_job_db(), workers=1, device="cpu",
                        alert_sink=alert_sink)
    capture = trace.start_capture()
    try:
        records = []
        for kind, spec in jobs:
            records.append(ctl.create(kind, spec))
            assert ctl.wait_all(timeout=120)
    finally:
        trace.stop_capture(capture)
        ctl.shutdown()
    return records, capture.records


def _job_kinds():
    from theia_tpu_torch.runner import progress
    from theia_tpu_torch.manager import jobs
    return {"tad": (jobs.KIND_TAD, {"jobType": "EWMA"},
                    progress.TAD_STAGES),
            "npr": (jobs.KIND_NPR, {"jobType": "initial"},
                    progress.NPR_STAGES),
            "fpm": (jobs.KIND_FPM, {"minSupport": 3},
                    progress.FPM_STAGES),
            "sad": (jobs.KIND_SPATIAL, {}, progress.SPATIAL_STAGES),
            "dd": (jobs.KIND_DD, {"jobType": "initial"},
                   progress.DD_STAGES)}


@pytest.mark.parametrize("label", ["tad", "npr", "fpm", "sad", "dd"])
def test_job_stages_are_spans_under_job_run(label):
    """An in-process job of each kind: one `job.stage` span a stage, in
    the kind's order, back to back, each a child of the job's
    `job.run` span, with the job's kind and name."""
    kind, spec, stages = _job_kinds()[label]
    (record,), spans = _run_jobs([(kind, spec)])
    assert record.state == "COMPLETED", record.error_msg
    (run,) = [s for s in spans if s["op"] == "job.run"]
    got = [s for s in spans if s["op"] == "job.stage"]
    assert [s["stage"] for s in got] == stages
    for s in got:
        assert s["traceId"] == run["traceId"]
        assert s["parentSpanId"] == run["spanId"]
        assert s["parent"] == "job.run"
        assert (s["kind"], s["job"]) == (kind, record.name)
        assert s["tid"] == run["tid"]
        assert run["startTime"] <= s["startTime"]
        assert s["startTime"] + s["durationMs"] / 1e3 <= \
            run["startTime"] + run["durationMs"] / 1e3 + 1e-3
    for a, b in zip(got, got[1:]):
        assert a["startTime"] <= b["startTime"]


def test_sad_job_spans_its_passes_copies_and_alert_push():
    from theia_tpu_torch.manager.jobs import KIND_SPATIAL
    alerts = []
    (record,), spans = _run_jobs([(KIND_SPATIAL, {})],
                                 alert_sink=alerts.append)
    assert record.state == "COMPLETED", record.error_msg
    assert alerts
    by_op = {}
    for s in spans:
        by_op.setdefault(s["op"], []).append(s)
    (run,) = by_op["job.run"]
    score = next(s for s in by_op["job.stage"] if s["stage"] == "score")
    lo = score["startTime"]
    hi = lo + score["durationMs"] / 1e3 + 1e-3
    flows = _job_db().flows.select(None, None)
    n = len(flows)
    for op in ("dbscan.count_pass", "dbscan.reach_pass"):
        (sp,) = by_op[op]
        assert sp["parentSpanId"] == run["spanId"]
        assert (sp["points"], sp["block"]) == (-(-n // 1024) * 1024, 1024)
        assert sp["route"] == "torch"
    # the count pass evaluates every point, the reach pass the non-core
    # ones (the padding among them)
    import torch
    from theia_tpu_torch.analytics.spatial import flow_embeddings
    from theia_tpu_torch.ops import dbscan
    pts = dbscan._pad_rows(torch.from_numpy(flow_embeddings(flows)), 1024)
    valid = torch.arange(len(pts)) < n
    core = (dbscan.points_neighbour_counts(pts, pts, valid, 1.0) >= 4) \
        & valid
    assert by_op["dbscan.count_pass"][0]["rows"] == len(pts)
    assert by_op["dbscan.reach_pass"][0]["rows"] == int((~core).sum())
    for op in ("dbscan.count_pass", "dbscan.reach_pass", "sad.fetch",
               "sad.decode"):
        (sp,) = by_op[op]
        assert sp["traceId"] == run["traceId"]
        assert sp["parentSpanId"] == run["spanId"]
        # inside the score stage
        assert lo <= sp["startTime"]
        assert sp["startTime"] + sp["durationMs"] / 1e3 <= hi
    # the columns' copy lies in the embed stage, inside sad.embed
    embed = next(s for s in by_op["job.stage"] if s["stage"] == "embed")
    (emb,), (copy,) = by_op["sad.embed"], by_op["sad.to_device"]
    assert (emb["rows"], emb["route"], copy["rows"]) == (n, "torch", n)
    assert emb["parentSpanId"] == run["spanId"]
    assert copy["parentSpanId"] == emb["spanId"]
    assert copy["traceId"] == emb["traceId"] == run["traceId"]
    for sp in (emb, copy):
        assert embed["startTime"] <= sp["startTime"]
        assert sp["startTime"] + sp["durationMs"] / 1e3 <= \
            embed["startTime"] + embed["durationMs"] / 1e3 + 1e-3
    # the push publishes at most 100 of the job's noise flows
    assert min(by_op["sad.decode"][0]["flows"], 100) == len(alerts)
    (push,) = by_op["job.alert_push"]
    assert push["job"] == record.name and "traceId" not in push
    assert push["startTime"] >= run["startTime"] + run["durationMs"] / 1e3


def test_raising_job_closes_its_stage_span_inside_job_run(monkeypatch):
    """A job that raises in a stage publishes that stage's span, with
    the error, under its job.run; no span is left open on the worker,
    so the next job's job.run is again a trace root."""
    from theia_tpu_torch.analytics import spatial
    from theia_tpu_torch.manager.jobs import KIND_SPATIAL

    def broken(flows, device):
        raise RuntimeError("embedding failed")

    monkeypatch.setattr(spatial, "device_embeddings", broken)
    (bad, good), spans = _run_jobs([(KIND_SPATIAL, {}),
                                    (KIND_SPATIAL, {"eps": 2.0})])
    assert bad.state == "FAILED" and "embedding failed" in bad.error_msg
    assert good.state == "FAILED"
    runs = [s for s in spans if s["op"] == "job.run"]
    assert [r["job"] for r in runs] == [bad.name, good.name]
    for run in runs:
        assert run["parent"] is None and run["error"] == "RuntimeError"
        stages = [s for s in spans if s["op"] == "job.stage"
                  and s["traceId"] == run["traceId"]]
        assert sorted(stages, key=lambda s: s["startTime"]) == stages
        assert [s["stage"] for s in stages] == ["read", "embed"]
        assert "embedding failed" in stages[-1]["error"]
        assert "error" not in stages[0]
        assert all(s["parentSpanId"] == run["spanId"] for s in stages)


@pytest.mark.parametrize("sampled", [True, False])
def test_fused_step_span_names_its_tiles_and_links(sampled, monkeypatch):
    """A POST /ingest body through the fused engine on the CPU: one
    fused.step span naming B1's tiles and linking the request's trace;
    with the ingest ingress sampled at 0, no fused.step at all."""
    import threading
    from theia_tpu_torch.manager.ingest import IngestManager
    if not sampled:
        monkeypatch.setenv("THEIA_TRACE_SAMPLE_INGEST", "0")
    enc = BlockEncoder()
    flows = generate_flows(SynthConfig(n_series=40, points_per_series=4,
                                       anomaly_fraction=0.0, seed=5),
                           dicts=enc.dicts)
    payload = enc.encode(flows)
    im = IngestManager(FlowDatabase(), n_shards=2, engine="fused",
                       device="cpu")
    try:
        out = im.ingest(payload, stream="s")
    finally:
        im.close()
    steps = [s for s in trace.recent() if s["op"] == "fused.step"]
    if not sampled:
        assert "traceId" not in out and steps == []
        return
    (step,) = steps
    assert step in trace.spans_for_trace(out["traceId"])
    assert step["links"] == [out["traceId"]]
    assert step["blocks"] == 1 and step["rows"] == len(flows)
    assert step["device_ms"] is None
    assert step["tiles"] and all(len(t) == 3 for t in step["tiles"])
    assert step["tid"] != threading.get_native_id()
