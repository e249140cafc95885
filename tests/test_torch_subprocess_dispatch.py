"""Port parity: out-of-process job dispatch, a port
`JobController(dispatch="subprocess", device="cpu")` whose jobs run as
`python -m theia_tpu_torch.runner` children on the controller's device.

The cases of tests/test_subprocess_dispatch.py (results merged back,
progress scraped, a SIGKILLed child fails the job and not the manager,
delete and shutdown kill the child, one child on the device at a time),
the subprocess cases of tests/test_faults.py (a transient exit retried,
a fault-hung real child killed at its deadline) and of
tests/test_pattern_spatial_jobs.py, plus the `runner.spawn` fault
site. Then the port's own: subprocess and thread dispatch give equal
rows for every job kind; the child's argv names the controller's
device; and `theia tad|pr|fpm|sad|dd` through the port's CLI (and
the reference's JAX-free CLI, as the wire-compatibility case) returns
the same rows from a port manager under `--dispatch subprocess` as
from a reference manager. Stores stay at
the reference tests' sizes (8 series x 20 points): each child imports
torch.
"""

from __future__ import annotations

import json
import os
import re
import signal
import subprocess
import sys
import time
import urllib.request
from pathlib import Path

import numpy as np
import pytest

from theia_tpu.data.synth import SynthConfig as RefSynth
from theia_tpu.data.synth import generate_flows as ref_generate
from theia_tpu.manager import TheiaManagerServer as RefServer
from theia_tpu.store import FlowDatabase as RefDatabase
from theia_tpu_torch.data.synth import SynthConfig, generate_flows
from theia_tpu_torch.manager import TheiaManagerServer
from theia_tpu_torch.manager.jobs import (
    KIND_DD,
    KIND_FPM,
    KIND_NPR,
    KIND_SPATIAL,
    KIND_TAD,
    STATE_COMPLETED,
    STATE_FAILED,
    STATE_RUNNING,
    JobController,
)
from theia_tpu_torch.schema import FLOW_SCHEMA, ColumnarBatch
from theia_tpu_torch.store import FlowDatabase
from theia_tpu_torch.utils import faults
from test_torch_analysis import port_lockdep_clean  # noqa: F401

REPO = Path(__file__).resolve().parent.parent
DAY = 86400


@pytest.fixture(autouse=True)
def _disarmed():
    """No fault armed before or after a test (the injector is
    process-global)."""
    faults.disarm()
    yield
    faults.disarm()


def _flows(seed=11):
    return generate_flows(SynthConfig(
        n_series=8, points_per_series=20, anomaly_fraction=0.4,
        anomaly_magnitude=60.0, seed=seed))


@pytest.fixture()
def db():
    d = FlowDatabase()
    d.insert_flows(_flows())
    return d


def _controller(db, workers=1, **kw):
    return JobController(db, workers=workers, dispatch="subprocess",
                         device="cpu", **kw)


def _sleeper(record, snap, prog):
    return [sys.executable, "-c", "import time; time.sleep(120)"]


def _wait_pid(record, timeout=30):
    deadline = time.time() + timeout
    while record.runner_pid == 0 and time.time() < deadline:
        time.sleep(0.05)
    return record.runner_pid


# -- the cases of tests/test_subprocess_dispatch.py -----------------------

def test_subprocess_tad_job_completes_and_merges(db):
    ctl = _controller(db)
    try:
        record = ctl.create(KIND_TAD, {"jobType": "EWMA"})
        assert ctl.wait_all(timeout=120)
        assert record.state == STATE_COMPLETED, record.error_msg
        assert record.runner_pid > 0
        # results merged back into the LIVE db from the snapshot
        stats = ctl.tad_stats(record.name)
        assert stats and all(s["algoType"] == "EWMA" for s in stats)
        # progress was scraped from the child's --progress-file
        snap = record.progress.snapshot()
        assert snap["completedStages"] == snap["totalStages"] == 4
        # the child said which device it ran on
        assert record.runner_log_tail.strip().splitlines()[-1] == \
            "device cpu"
    finally:
        ctl.shutdown()


def test_subprocess_npr_job_completes(db):
    ctl = _controller(db)
    try:
        record = ctl.create(KIND_NPR, {"jobType": "initial",
                                       "policyType": "anp-deny-applied"})
        assert ctl.wait_all(timeout=120)
        assert record.state == STATE_COMPLETED, record.error_msg
        outcome = ctl.recommendation_outcome(record.name)
        assert "kind: NetworkPolicy" in outcome
    finally:
        ctl.shutdown()


def test_invalid_spec_fails_before_spawn(db):
    ctl = _controller(db)
    try:
        record = ctl.create(KIND_NPR, {"policyType": "bogus"})
        assert ctl.wait_all(timeout=30)
        assert record.state == STATE_FAILED
        assert "policyType" in record.error_msg
        assert record.runner_pid == 0   # no child was ever spawned
    finally:
        ctl.shutdown()


def test_sigkilled_runner_fails_job_not_manager(db, monkeypatch):
    """kill -9 on the running child: the record goes FAILED with a
    signal message, and the controller runs the NEXT job fine."""
    ctl = _controller(db)
    monkeypatch.setattr(ctl, "_runner_cmd", _sleeper)
    try:
        record = ctl.create(KIND_TAD, {"jobType": "EWMA"})
        assert _wait_pid(record) > 0
        assert record.state == STATE_RUNNING
        os.kill(record.runner_pid, signal.SIGKILL)
        assert ctl.wait_all(timeout=30)
        assert record.state == STATE_FAILED
        assert "signal 9" in record.error_msg

        monkeypatch.undo()
        record2 = ctl.create(KIND_TAD, {"jobType": "EWMA"})
        assert ctl.wait_all(timeout=120)
        assert record2.state == STATE_COMPLETED, record2.error_msg
    finally:
        ctl.shutdown()


def test_delete_cancels_running_subprocess(db, monkeypatch):
    ctl = _controller(db)
    monkeypatch.setattr(ctl, "_runner_cmd", _sleeper)
    try:
        record = ctl.create(KIND_TAD, {"jobType": "EWMA"})
        _wait_pid(record)
        ctl.delete(record.name)
        deadline = time.time() + 30
        while record.state == STATE_RUNNING and time.time() < deadline:
            time.sleep(0.05)
        assert record.state in (STATE_FAILED, STATE_COMPLETED)
        with pytest.raises(OSError):
            os.kill(record.runner_pid, 0)
    finally:
        ctl.shutdown()


def test_delete_then_recreate_same_name_kills_old_child(db,
                                                        monkeypatch):
    ctl = _controller(db)
    monkeypatch.setattr(ctl, "_runner_cmd", _sleeper)
    try:
        name = "tad-aaaaaaaa-bbbb-cccc-dddd-eeeeeeeeeeee"
        record = ctl.create(KIND_TAD, {"jobType": "EWMA"}, name=name)
        old_pid = _wait_pid(record)
        ctl.delete(name)
        record2 = ctl.create(KIND_TAD, {"jobType": "EWMA"}, name=name)
        deadline = time.time() + 30
        while record.state == STATE_RUNNING and time.time() < deadline:
            time.sleep(0.05)
        assert record.state == STATE_FAILED
        with pytest.raises(OSError):
            os.kill(old_pid, 0)
        assert record2 is not record
    finally:
        ctl.shutdown()


def test_shutdown_kills_running_child(db, monkeypatch):
    """Shutdown must not orphan a runner child (it would keep the card
    claimed past the manager's death)."""
    ctl = _controller(db)
    monkeypatch.setattr(ctl, "_runner_cmd", _sleeper)
    record = ctl.create(KIND_TAD, {"jobType": "EWMA"})
    assert _wait_pid(record) > 0
    ctl.shutdown()
    with pytest.raises(OSError):
        os.kill(record.runner_pid, 0)


def test_device_serialization_one_child_at_a_time(db, monkeypatch,
                                                  tmp_path):
    """Two queued jobs with two workers never run children at once:
    the device lock serializes the card."""
    ctl = _controller(db, workers=2)
    stamps = tmp_path / "stamps"
    stamps.mkdir()
    code = ("import time, sys; "
            "open(sys.argv[1], 'w').write(str(time.time())); "
            "time.sleep(1.0)")
    calls = []

    def fake_cmd(record, snap, prog):
        calls.append(record.name)
        return [sys.executable, "-c", code,
                str(stamps / f"start-{len(calls)}")]

    monkeypatch.setattr(ctl, "_runner_cmd", fake_cmd)
    try:
        ctl.create(KIND_TAD, {"jobType": "EWMA"})
        ctl.create(KIND_TAD, {"jobType": "EWMA"})
        assert ctl.wait_all(timeout=60)
        starts = sorted(float(p.read_text()) for p in stamps.iterdir())
        assert len(starts) == 2
        assert starts[1] - starts[0] >= 0.9
    finally:
        ctl.shutdown()


# -- the subprocess cases of tests/test_faults.py -------------------------

def test_subprocess_dispatch_transient_retry_then_succeed(
        db, monkeypatch, tmp_path):
    """The first child exits 75 (the runner's transient marker), the
    retry exits 0: the record completes with its attempts and last
    failure in status."""
    ctl = _controller(db, retry_backoff_base=0.01)
    flag = tmp_path / "ran-once"
    code = ("import os, sys\n"
            "p = sys.argv[1]\n"
            "if os.path.exists(p):\n"
            "    sys.exit(0)\n"
            "open(p, 'w').close()\n"
            "sys.exit(75)\n")
    monkeypatch.setattr(
        ctl, "_runner_cmd",
        lambda record, snap, prog: [sys.executable, "-c", code,
                                    str(flag)])
    try:
        rec = ctl.create(KIND_TAD, {"jobType": "EWMA", "retries": 1})
        assert ctl.wait_all(timeout=60)
        assert rec.state == STATE_COMPLETED, rec.error_msg
        assert rec.attempts == 2
        assert "exit 75" in rec.status_dict()["lastFailureReason"]
    finally:
        ctl.shutdown()


def test_fault_hung_runner_killed_at_deadline(db, monkeypatch):
    """A real port runner child, fault-hung through the environment it
    inherits, is killed at deadlineSeconds; the record fails with
    DeadlineExceeded and is not retried."""
    monkeypatch.setenv("THEIA_FAULTS", "runner.exec:hang")
    monkeypatch.setenv("THEIA_FAULT_HANG_SECONDS", "120")
    ctl = _controller(db)
    try:
        rec = ctl.create(KIND_TAD, {"jobType": "EWMA",
                                    "deadlineSeconds": 1.0,
                                    "retries": 3})
        assert ctl.wait_all(timeout=60)
        assert rec.state == STATE_FAILED
        assert "DeadlineExceeded" in rec.error_msg
        assert rec.attempts == 1
        assert rec.runner_pid > 0
        with pytest.raises(OSError):
            os.kill(rec.runner_pid, 0)
    finally:
        ctl.shutdown()


@pytest.mark.parametrize("retries,state,attempts", [
    (0, STATE_FAILED, 1), (1, STATE_COMPLETED, 2)])
def test_runner_spawn_fault(db, retries, state, attempts):
    """A fault at `runner.spawn` (after the snapshot, before Popen)
    fails the attempt with no child started; it is transient, so a
    retry budget spawns the runner on the next attempt."""
    faults.arm("runner.spawn:error@1")
    ctl = _controller(db, retry_backoff_base=0.01)
    try:
        rec = ctl.create(KIND_TAD, {"jobType": "EWMA",
                                    "retries": retries})
        assert ctl.wait_all(timeout=120)
        assert rec.state == state, rec.error_msg
        assert rec.attempts == attempts
        assert "runner.spawn" in rec.last_failure
        assert (rec.runner_pid > 0) == (state == STATE_COMPLETED)
    finally:
        ctl.shutdown()


# -- tests/test_pattern_spatial_jobs.py's subprocess case -----------------

def _db_with_outlier():
    d = FlowDatabase()
    d.insert_flows(generate_flows(SynthConfig(
        n_series=6, points_per_series=20, seed=17)))
    # one-off flow: unique endpoints seen exactly once -> spatial noise
    d.insert_flows(ColumnarBatch.from_rows([{
        "sourceIP": "203.0.113.99", "destinationIP": "198.51.100.7",
        "destinationTransportPort": 4444, "octetDeltaCount": 1234,
        "packetDeltaCount": 3, "timeInserted": 1_700_000_000,
    }], FLOW_SCHEMA, d.flows.dicts))
    return d


def test_subprocess_dispatch_covers_new_kinds():
    ctl = _controller(_db_with_outlier())
    try:
        r1 = ctl.create(KIND_FPM, {"maxLen": 2})
        r2 = ctl.create(KIND_SPATIAL, {})
        assert ctl.wait_all(timeout=240)
        assert r1.state == "COMPLETED", r1.error_msg
        assert r2.state == "COMPLETED", r2.error_msg
        assert ctl.result_stats(KIND_FPM, r1.name)
        assert ctl.result_stats(KIND_SPATIAL, r2.name)
    finally:
        ctl.shutdown()


# -- the port's own ------------------------------------------------------

def _drop_rows(endpoints=8, days=12):
    """Dropped flows, Poisson(3) a day with one x20 endpoint-day each
    (Drop on ingress for even endpoints, Reject on egress for odd)."""
    rng = np.random.default_rng(9)
    rows = []
    for e in range(endpoints):
        ingress = e % 2 == 0
        for day in range(days):
            n = int(rng.poisson(3.0)) * (20 if day == e % days else 1)
            rows.extend({
                "flowStartSeconds": day * DAY + 30 * i,
                "flowEndSeconds": day * DAY + 30 * i + 5,
                "sourcePodNamespace": "ns-c", "sourcePodName": f"c-{e}",
                "sourceIP": f"10.3.0.{e}",
                "destinationPodNamespace": "ns-s",
                "destinationPodName": f"s-{e}",
                "destinationIP": f"10.4.0.{e}",
                "ingressNetworkPolicyRuleAction": 2 if ingress else 0,
                "egressNetworkPolicyRuleAction": 0 if ingress else 3,
                "timeInserted": day * DAY + 30 * i + 9,
            } for i in range(n))
    return rows


#: kind → (spec, float columns of its rows and their rtol across the
#: two dispatch modes: the same code on the same device, so none)
EVERY_KIND = {
    "tad-EWMA": (KIND_TAD, {"jobType": "EWMA"}),
    "tad-DBSCAN": (KIND_TAD, {"jobType": "DBSCAN"}),
    "tad-ARIMA": (KIND_TAD, {"jobType": "ARIMA"}),
    "npr": (KIND_NPR, {"jobType": "initial"}),
    "fpm": (KIND_FPM, {"minSupport": 3}),
    "sad": (KIND_SPATIAL, {}),
    "dd": (KIND_DD, {"jobType": "initial"}),
}


def _rows(ctl, kind, name):
    if kind == KIND_NPR:
        return sorted(ctl.recommendation_outcome(name).split("---\n"))
    return sorted(tuple(sorted((k, v) for k, v in r.items()
                               if k not in ("id", "timeCreated")))
                  for r in ctl.result_stats(kind, name))


@pytest.mark.parametrize("label", sorted(EVERY_KIND))
def test_subprocess_rows_equal_thread_rows(label):
    """The same job over the same store, once in a runner child and
    once on a worker thread: equal rows, bit for bit."""
    kind, spec = EVERY_KIND[label]
    got = {}
    for dispatch in ("subprocess", "thread"):
        d = FlowDatabase()
        d.insert_flows(_flows(seed=3))
        d.insert_flow_rows(_drop_rows())
        ctl = JobController(d, workers=1, dispatch=dispatch,
                            device="cpu")
        try:
            rec = ctl.create(kind, spec)
            assert ctl.wait_all(timeout=120)
            assert rec.state == STATE_COMPLETED, rec.error_msg
            got[dispatch] = _rows(ctl, kind, rec.name)
        finally:
            ctl.shutdown()
    assert got["thread"], label
    assert got["subprocess"] == got["thread"]


def test_runner_cmd_carries_the_controllers_device(db, tmp_path):
    ctl = JobController(db, workers=0, dispatch="subprocess",
                        device="cpu")
    try:
        rec = ctl.create(KIND_SPATIAL, {"eps": 2.0})
        cmd = ctl._runner_cmd(rec, str(tmp_path / "db.npz"),
                              str(tmp_path / "p.json"))
        assert cmd[1:3] == ["-m", "theia_tpu_torch.runner"]
        assert cmd[3:6] == ["spatial", "--eps", "2.0"]
        assert cmd[-2:] == ["--device", "cpu"]
    finally:
        ctl.shutdown()


def test_subprocess_controller_needs_a_card_unless_told_cpu(db,
                                                            monkeypatch):
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        JobController(db, workers=0, dispatch="subprocess")


# -- the CLI against both managers ---------------------------------------

#: CLI verb → its job-run arguments (`pr` is NPR)
CLI_JOBS = {
    "tad": ["--algo", "DBSCAN"],
    "pr": [],
    "fpm": ["--min-support", "3"],
    "sad": [],
    "dd": [],
}
RESOURCES = {"tad": "throughputanomalydetectors",
             "pr": "networkpolicyrecommendations",
             "fpm": "flowpatternminings",
             "sad": "spatialanomalydetections",
             "dd": "trafficdropdetections"}
GROUP = "/apis/intelligence.theia.antrea.io/v1alpha1"


#: the port's `theia` CLI, and the reference's (JAX-free) as the
#: wire-compatibility case
CLIS = ("theia_tpu_torch.cli", "theia_tpu.cli")


def _cli(cli: str, port: int, *args) -> str:
    """The `theia` CLI of package `cli` against the manager on
    `port`."""
    env = {**os.environ, "PYTHONPATH": str(REPO)}
    proc = subprocess.run(
        [sys.executable, "-m", cli, "--manager-addr",
         f"http://127.0.0.1:{port}", *args],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    return proc.stdout


def _wait_done(port: int, verb: str, name: str) -> None:
    deadline = time.monotonic() + 120
    url = f"http://127.0.0.1:{port}{GROUP}/{RESOURCES[verb]}/{name}"
    while time.monotonic() < deadline:
        with urllib.request.urlopen(url, timeout=30) as r:
            state = json.loads(r.read())["status"]["state"]
        if state in (STATE_COMPLETED, STATE_FAILED):
            assert state == STATE_COMPLETED, name
            return
        time.sleep(0.1)
    raise TimeoutError(name)


#: float columns of the CLI's rows, held to the port's tolerances
#: against the reference: TAD's float64 stddev sums in another order,
#: DD's float32 stddev (tests/test_torch_drops.py)
CLI_FLOATS = {"tad": {"throughputStandardDeviation": 2e-15},
              "dd": {"avgDrop": 1e-6, "stdevDrop": 1e-6}}


def _cli_rows(path: Path, verb: str) -> list:
    """What `retrieve -f` wrote: NPR's policies, the other kinds' rows
    without their job id and creation time, each as (its exact
    columns, its float columns)."""
    if verb == "pr":
        return sorted((p, ()) for p in path.read_text().split("---\n"))
    floats = tuple(CLI_FLOATS.get(verb, {}))
    skip = ("id", "timeCreated", *floats)
    return sorted((json.dumps({k: v for k, v in r.items()
                               if k not in skip}, sort_keys=True),
                   tuple(float(r[c]) for c in floats))
                  for r in json.loads(path.read_text()))


@pytest.fixture(scope="module")
def managers():
    """A reference manager and a port manager with subprocess dispatch
    on the CPU, over the same flows."""
    ref_db = RefDatabase()
    ref_db.insert_flows(ref_generate(RefSynth(
        n_series=8, points_per_series=20, anomaly_fraction=0.4,
        anomaly_magnitude=60.0, seed=3)))
    ref_db.insert_flow_rows(_drop_rows())
    port_db = FlowDatabase()
    port_db.insert_flows(_flows(seed=3))
    port_db.insert_flow_rows(_drop_rows())
    ref = RefServer(ref_db, port=0, ingest_shards=1)
    ref.start_background()
    try:
        port = TheiaManagerServer(port_db, port=0, ingest_shards=1,
                                  dispatch="subprocess", device="cpu")
    except BaseException:
        ref.shutdown()
        raise
    port.start_background()
    yield ref, port
    port.shutdown()
    ref.shutdown()


@pytest.mark.parametrize("cli", CLIS)
@pytest.mark.parametrize("verb", sorted(CLI_JOBS))
def test_cli_rows_from_subprocess_port_equal_reference(verb, cli, managers,
                                                       tmp_path):
    """`theia <verb> run`, then `retrieve -f` once the job completed,
    through the CLI of package `cli`: the port manager, each job in a
    runner child, returns the reference manager's rows."""
    ref, port = managers
    rows = {}
    for label, srv in (("ref", ref), ("port", port)):
        out = _cli(cli, srv.port, verb, "run", *CLI_JOBS[verb])
        name = re.search(rf"{verb}-[0-9a-f-]{{36}}", out).group(0)
        _wait_done(srv.port, verb, name)
        path = tmp_path / f"{label}.out"
        _cli(cli, srv.port, verb, "retrieve", name, "-f", str(path))
        rows[label] = _cli_rows(path, verb)
    got, want = rows["port"], rows["ref"]
    assert want and want != [("", ())], verb
    assert [g[0] for g in got] == [w[0] for w in want]
    for i, (col, rtol) in enumerate(CLI_FLOATS.get(verb, {}).items()):
        np.testing.assert_allclose([g[1][i] for g in got],
                                   [w[1][i] for w in want], rtol=rtol,
                                   err_msg=col)
    assert port.controller.dispatch == "subprocess"
    assert all(r.runner_pid > 0 for r in port.controller.list())
