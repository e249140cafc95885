"""Port parity: the declarative CR reconciler (a verbatim copy in
theia_tpu_torch/manager/reconciler.py) over port job controllers on
the CPU, and `python -m theia_tpu_torch.manager --reconcile-dir`.

The cases of tests/test_reconciler.py and the reconciler case of
tests/test_faults.py run against a port `JobController(device="cpu")`.
Then one CR directory of every job kind, reconciled by the reference
over a reference controller and by the port over a port controller
(thread and subprocess dispatch): the status files agree apart from
wall-clock stamps, and the result rows are equal (TAD's stddev within
rtol 2e-15, DD's floats within 1e-6). And the entry point: a manager
started with --reconcile-dir runs a CR written into its directory,
writes the status back, and drains the reconciler on SIGTERM.
"""

from __future__ import annotations

import signal
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import yaml

from theia_tpu.data.synth import SynthConfig as RefSynth
from theia_tpu.data.synth import generate_flows as ref_generate
from theia_tpu.manager.jobs import JobController as RefController
from theia_tpu.manager.reconciler import \
    DeclarativeReconciler as RefReconciler
from theia_tpu.store import FlowDatabase as RefDatabase
from theia_tpu_torch.data.synth import SynthConfig, generate_flows
from theia_tpu_torch.manager.jobs import KIND_TAD, JobController
from theia_tpu_torch.manager.reconciler import DeclarativeReconciler
from theia_tpu_torch.store import FlowDatabase
from theia_tpu_torch.utils import faults
from test_torch_analysis import port_lockdep_clean  # noqa: F401

REPO = Path(__file__).resolve().parent.parent
DAY = 86400


@pytest.fixture()
def ctl():
    db = FlowDatabase()
    db.insert_flows(generate_flows(SynthConfig(
        n_series=6, points_per_series=12, anomaly_fraction=0.5,
        anomaly_magnitude=50.0, seed=6)))
    c = JobController(db, workers=1, device="cpu")
    yield c
    c.shutdown()


def _write_cr(d, name, kind="ThroughputAnomalyDetector", spec=None):
    doc = {"apiVersion": "crd.theia.antrea.io/v1alpha1",
           "kind": kind,
           "metadata": {"name": name},
           "spec": spec or {"jobType": "EWMA"}}
    (d / f"{name}.yaml").write_text(yaml.safe_dump(doc))


# -- the cases of tests/test_reconciler.py --------------------------------

def test_apply_run_status_delete_cycle(ctl, tmp_path):
    rec = DeclarativeReconciler(ctl, str(tmp_path))
    name = "tad-aaaaaaaa-bbbb-cccc-dddd-000000000001"
    _write_cr(tmp_path, name)

    out = rec.reconcile_once()
    assert out["created"] == 1
    assert ctl.wait_all()
    rec.reconcile_once()   # status write-back after completion

    status = yaml.safe_load(
        (tmp_path / f"{name}.status.yaml").read_text())
    assert status["name"] == name
    assert status["status"]["state"] == "COMPLETED"
    assert status["status"]["completedStages"] == 4
    assert len(ctl.db.tadetector) > 0

    (tmp_path / f"{name}.yaml").unlink()
    out = rec.reconcile_once()
    assert out["deleted"] == 1
    with pytest.raises(KeyError):
        ctl.get(name)
    assert len(ctl.db.tadetector) == 0
    assert not (tmp_path / f"{name}.status.yaml").exists()


def test_reconcile_is_level_triggered_and_idempotent(ctl, tmp_path):
    rec = DeclarativeReconciler(ctl, str(tmp_path))
    name = "tad-aaaaaaaa-bbbb-cccc-dddd-000000000002"
    _write_cr(tmp_path, name)
    rec.reconcile_once()
    for _ in range(3):
        out = rec.reconcile_once()
        assert out["created"] == 0
    assert len(ctl.list()) == 1


def test_restart_does_not_rerun_completed_cr(ctl, tmp_path):
    name = "tad-aaaaaaaa-bbbb-cccc-dddd-000000000010"
    rec = DeclarativeReconciler(ctl, str(tmp_path))
    _write_cr(tmp_path, name)
    assert rec.reconcile_once()["created"] == 1
    assert ctl.wait_all()
    rec.reconcile_once()   # write COMPLETED status back

    db2 = FlowDatabase()
    db2.insert_flows(generate_flows(SynthConfig(
        n_series=6, points_per_series=12, seed=7)))
    ctl2 = JobController(db2, workers=1, device="cpu")
    try:
        rec2 = DeclarativeReconciler(ctl2, str(tmp_path))
        for _ in range(3):
            assert rec2.reconcile_once()["created"] == 0
        with pytest.raises(KeyError):
            ctl2.get(name)

        running = "tad-aaaaaaaa-bbbb-cccc-dddd-000000000011"
        _write_cr(tmp_path, running)
        (tmp_path / f"{running}.status.yaml").write_text(yaml.safe_dump(
            {"name": running, "status": {"state": "RUNNING"}}))
        assert rec2.reconcile_once()["created"] == 1
        assert ctl2.wait_all()

        (tmp_path / f"{name}.yaml").unlink()
        rec2.reconcile_once()
        assert not (tmp_path / f"{name}.status.yaml").exists()
    finally:
        ctl2.shutdown()


def test_rest_created_jobs_are_never_collected(ctl, tmp_path):
    rec = DeclarativeReconciler(ctl, str(tmp_path))
    rest_job = ctl.create(KIND_TAD, {"jobType": "EWMA"})
    out = rec.reconcile_once()
    assert out["deleted"] == 0
    assert ctl.get(rest_job.name)


def test_malformed_cr_does_not_stall_others(ctl, tmp_path):
    (tmp_path / "broken.yaml").write_text("{not yaml: [")
    name = "tad-aaaaaaaa-bbbb-cccc-dddd-000000000003"
    _write_cr(tmp_path, name)
    (tmp_path / "bad-spec.yaml").write_text(yaml.safe_dump({
        "apiVersion": "crd.theia.antrea.io/v1alpha1",
        "kind": "ThroughputAnomalyDetector",
        "metadata": {"name": "tad-aaaaaaaa-bbbb-cccc-dddd-0000000000ff"},
        "spec": "not-a-mapping"}))
    rec = DeclarativeReconciler(ctl, str(tmp_path))
    out = rec.reconcile_once()
    assert out["created"] == 1


def test_background_loop_and_invalid_name_rejected(ctl, tmp_path):
    rec = DeclarativeReconciler(ctl, str(tmp_path), interval=0.1)
    _write_cr(tmp_path, "not-a-valid-name")
    name = "tad-aaaaaaaa-bbbb-cccc-dddd-000000000004"
    _write_cr(tmp_path, name)
    rec.start()
    try:
        deadline = time.time() + 30
        while time.time() < deadline:
            try:
                if ctl.get(name).state == "COMPLETED":
                    break
            except KeyError:
                pass
            time.sleep(0.05)
        assert ctl.get(name).state == "COMPLETED"
        with pytest.raises(KeyError):
            ctl.get("not-a-valid-name")
    finally:
        rec.stop()


def test_reconciler_backoff_on_consecutive_failures(tmp_path):
    """tests/test_faults.py's case: a fault at `reconciler.pass` backs
    the loop off, and recovery resets it."""
    ctl = JobController(FlowDatabase(), workers=0, device="cpu")
    rec = DeclarativeReconciler(ctl, str(tmp_path), interval=0.01)
    rec.backoff_cap = 0.05
    faults.arm("reconciler.pass:error")
    rec.start()
    try:
        deadline = time.time() + 10
        while rec.consecutive_failures < 3 and time.time() < deadline:
            time.sleep(0.01)
        assert rec.consecutive_failures >= 3
        assert rec.interval < rec.current_delay <= rec.backoff_cap

        faults.disarm()
        deadline = time.time() + 10
        while rec.consecutive_failures and time.time() < deadline:
            time.sleep(0.01)
        assert rec.consecutive_failures == 0
        assert rec.current_delay == rec.interval
    finally:
        faults.disarm()
        rec.stop()
        ctl.shutdown()


# -- against the reference -----------------------------------------------

def _drop_rows(endpoints=8, days=12):
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


#: one CR of each kind: (CR kind, name, spec, result table, float
#: columns and their rtol)
CRS = (
    ("ThroughputAnomalyDetector",
     "tad-aaaaaaaa-bbbb-cccc-dddd-000000000021", {"jobType": "DBSCAN"},
     "tadetector", {"throughputStandardDeviation": 2e-15}),
    ("NetworkPolicyRecommendation",
     "pr-aaaaaaaa-bbbb-cccc-dddd-000000000022", {"jobType": "initial"},
     "recommendations", {}),
    ("FlowPatternMining",
     "fpm-aaaaaaaa-bbbb-cccc-dddd-000000000023", {"minSupport": 3},
     "flowpatterns", {}),
    ("SpatialAnomalyDetection",
     "sad-aaaaaaaa-bbbb-cccc-dddd-000000000024", {},
     "spatialnoise", {}),
    ("TrafficDropDetection",
     "dd-aaaaaaaa-bbbb-cccc-dddd-000000000025", {"jobType": "initial"},
     "dropdetection", {"avgDrop": 1e-6, "stdevDrop": 1e-6}),
)
#: status keys that carry wall-clock stamps or process ids
CLOCK_STATUS = ("startTime", "endTime")


def _reconcile_all(reconciler_cls, ctl, d):
    for kind, name, spec, _t, _f in CRS:
        _write_cr(d, name, kind=kind, spec=spec)
    rec = reconciler_cls(ctl, str(d))
    assert rec.reconcile_once()["created"] == len(CRS)
    assert ctl.wait_all(timeout=120)
    rec.reconcile_once()
    return {name: yaml.safe_load((d / f"{name}.status.yaml").read_text())
            for _k, name, _s, _t, _f in CRS}


def _rows(db, table, floats):
    data = db.result_tables[table].scan()
    rows = data.to_rows() if len(data) else []
    skip = ("timeCreated", *floats)
    return sorted((tuple(sorted((k, str(v)) for k, v in r.items()
                                if k not in skip)),
                   tuple(float(r[c]) for c in floats)) for r in rows)


@pytest.mark.parametrize("dispatch", ["thread", "subprocess"])
def test_every_kind_reconciled_as_the_reference(dispatch, tmp_path):
    ref_db = RefDatabase()
    ref_db.insert_flows(ref_generate(RefSynth(
        n_series=8, points_per_series=20, anomaly_fraction=0.4,
        anomaly_magnitude=60.0, seed=3)))
    ref_db.insert_flow_rows(_drop_rows())
    port_db = FlowDatabase()
    port_db.insert_flows(generate_flows(SynthConfig(
        n_series=8, points_per_series=20, anomaly_fraction=0.4,
        anomaly_magnitude=60.0, seed=3)))
    port_db.insert_flow_rows(_drop_rows())
    ref_ctl = RefController(ref_db, workers=1)
    port_ctl = JobController(port_db, workers=1, dispatch=dispatch,
                             device="cpu")
    try:
        (tmp_path / "ref").mkdir()
        (tmp_path / "port").mkdir()
        want = _reconcile_all(RefReconciler, ref_ctl, tmp_path / "ref")
        got = _reconcile_all(DeclarativeReconciler, port_ctl,
                             tmp_path / "port")
    finally:
        ref_ctl.shutdown()
        port_ctl.shutdown()
    for _kind, name, _s, table, floats in CRS:
        for doc in (got[name], want[name]):
            assert doc["status"]["state"] == "COMPLETED", doc
            for key in CLOCK_STATUS:
                doc["status"].pop(key, None)
        assert got[name] == want[name]
        g = _rows(port_db, table, floats)
        w = _rows(ref_db, table, floats)
        assert w, table
        assert [r[0] for r in g] == [r[0] for r in w]
        for i, (col, rtol) in enumerate(floats.items()):
            np.testing.assert_allclose([r[1][i] for r in g],
                                       [r[1][i] for r in w], rtol=rtol,
                                       err_msg=col)


def test_manager_entry_point_reconciles_its_directory(tmp_path):
    """`python -m theia_tpu_torch.manager --device cpu --reconcile-dir
    DIR --dispatch subprocess`: a CR written into DIR runs in a runner
    child, its status comes back COMPLETED, and SIGTERM stops the
    reconciler and the manager cleanly."""
    crs = tmp_path / "crs"
    crs.mkdir()
    name = "tad-aaaaaaaa-bbbb-cccc-dddd-000000000031"
    log = open(tmp_path / "manager.log", "wb")
    proc = subprocess.Popen(
        [sys.executable, "-m", "theia_tpu_torch.manager", "--device",
         "cpu", "--port", "0", "--synth", "8", "--dispatch",
         "subprocess", "--reconcile-dir", str(crs)],
        cwd=REPO, stdout=log, stderr=subprocess.STDOUT)
    try:
        status = crs / f"{name}.status.yaml"
        _write_cr(crs, name)
        deadline = time.time() + 120
        state = None
        while time.time() < deadline and state != "COMPLETED":
            assert proc.poll() is None, (tmp_path / "manager.log") \
                .read_text()
            if status.exists():
                doc = yaml.safe_load(status.read_text()) or {}
                state = (doc.get("status") or {}).get("state")
            time.sleep(0.2)
        assert state == "COMPLETED", (tmp_path / "manager.log").read_text()
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=120) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=60)
        log.close()
    text = (tmp_path / "manager.log").read_text()
    assert f"reconciling CRs in {crs}" in text
