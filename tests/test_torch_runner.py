"""Port parity: the job runner, `python -m theia_tpu_torch.runner`,
against the reference's `python -m theia_tpu.runner`, on the CPU.

The cases of tests/test_runner.py run against the port's runner with
`--device cpu`. Then the same seeded `.npz` goes through the
reference's runner (JAX on the CPU) and the port's for each of the
five subcommands: the result tables are equal, apart from the job's
creation time, with TAD's stddev within rtol 2e-15 (float64 sums in
another order) and DD's mean and stddev within rtol 1e-6 (float32).
And the port's own rules: `--device cuda` on a machine without a card
exits non-zero with resolve_device's message and writes nothing; a
child on `--device cpu` never asks for a kernel build; the SAD pass
turns TF32 off itself in a fresh process; the stderr device line.
"""

from __future__ import annotations

import hashlib
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from theia_tpu.runner.__main__ import main as ref_main
from theia_tpu.store import FlowDatabase as RefDatabase
from theia_tpu_torch.data.synth import SynthConfig, generate_flows
from theia_tpu_torch.runner.__main__ import build_parser, main, parse_time
from theia_tpu_torch.store import FlowDatabase
from test_torch_analysis import port_lockdep_clean  # noqa: F401
from test_torch_build import fake_cuda  # noqa: F401

REPO = Path(__file__).resolve().parent.parent
CPU = ["--device", "cpu"]
TAD_STD_RTOL = 2e-15
DD_RTOL = 1e-6
DAY = 86400


@pytest.fixture()
def db_path(tmp_path):
    db = FlowDatabase()
    db.insert_flows(generate_flows(SynthConfig(
        n_series=12, points_per_series=20, anomaly_fraction=0.3,
        anomaly_magnitude=60.0, seed=4)))
    path = str(tmp_path / "flows.npz")
    db.save(path)
    return path


# -- the cases of tests/test_runner.py -----------------------------------

def test_parse_time_utc():
    assert parse_time("2021-01-01 00:00:00") == 1609459200
    assert parse_time("") is None


def test_tad_job_writes_results_and_progress(db_path, tmp_path, capsys):
    progress_path = str(tmp_path / "progress.json")
    main(["tad", "--db", db_path, "--algo", "EWMA", "--id", "job-1",
          "--progress-file", progress_path, *CPU])
    out = capsys.readouterr().out.strip().splitlines()[-1]
    assert json.loads(out) == {"id": "job-1", "state": "COMPLETED"}
    progress = json.load(open(progress_path))
    assert progress["state"] == "COMPLETED"
    assert progress["completedStages"] == progress["totalStages"] == 4

    db = FlowDatabase.load(db_path)
    rows = db.tadetector.scan().to_rows()
    assert any(r["id"] == "job-1" and r["anomaly"] == "true" for r in rows)


def test_tad_agg_flow_args(db_path, capsys):
    main(["tad", "--db", db_path, "--algo", "EWMA", "--agg-flow", "pod",
          "--id", "job-pod",
          "--ns-ignore-list", '["kube-system"]', *CPU])
    db = FlowDatabase.load(db_path)
    rows = [r for r in db.tadetector.scan().to_rows()
            if r["id"] == "job-pod"]
    assert rows and all(r["aggType"] == "pod" for r in rows)


def test_tad_pod_namespace_alone_rejected(db_path):
    with pytest.raises(SystemExit):
        main(["tad", "--db", db_path, "--algo", "EWMA",
              "--agg-flow", "pod", "--pod-namespace", "ns-1", *CPU])


def test_tad_time_window_args(db_path, capsys):
    main(["tad", "--db", db_path, "--algo", "EWMA", "--id", "job-t",
          "--start_time", "2020-01-01 00:00:00",
          "--end_time", "2020-01-02 00:00:00", *CPU])
    # window before all synth data → no anomalies → filler row
    db = FlowDatabase.load(db_path)
    rows = [r for r in db.tadetector.scan().to_rows()
            if r["id"] == "job-t"]
    assert len(rows) == 1 and rows[0]["anomaly"] == "NO ANOMALY DETECTED"


def test_npr_job(db_path, tmp_path, capsys):
    progress_path = str(tmp_path / "p.json")
    main(["npr", "--db", db_path, "--type", "initial", "-o", "1",
          "--id", "rec-1", "--progress-file", progress_path, *CPU])
    out = capsys.readouterr().out.strip().splitlines()[-1]
    assert json.loads(out)["id"] == "rec-1"
    db = FlowDatabase.load(db_path)
    rows = db.recommendations.scan().to_rows()
    assert any(r["id"] == "rec-1" and r["kind"] == "anp" for r in rows)
    assert json.load(open(progress_path))["state"] == "COMPLETED"


def test_npr_failure_marks_progress(tmp_path):
    progress_path = str(tmp_path / "p.json")
    with pytest.raises(BaseException):
        main(["npr", "--db", str(tmp_path / "missing.npz"),
              "--id", "rec-x", "--progress-file", progress_path, *CPU])
    assert json.load(open(progress_path))["state"] == "FAILED"


def test_parser_rejects_bad_algo(db_path):
    with pytest.raises(SystemExit):
        build_parser().parse_args(["tad", "--db", db_path,
                                   "--algo", "LSTM"])


def test_parser_device_defaults_to_the_card(db_path):
    for job in (["tad", "--algo", "EWMA"], ["npr"], ["dropdetection"],
                ["patterns"], ["spatial"]):
        args = build_parser().parse_args([job[0], "--db", db_path,
                                          *job[1:]])
        assert args.device == "cuda"


# -- the same .npz through both runners ----------------------------------

def _drop_rows(seed, endpoints=16, days=20):
    """Dropped flows (half Drop on ingress, half Reject on egress),
    Poisson(4) a day, one endpoint-day x20 and 2% more at random."""
    rng = np.random.default_rng(seed)
    rows = []
    for e in range(endpoints):
        ingress = e % 2 == 0
        victim = (f"ns-{e % 3}", f"pod-{e}", f"10.1.0.{e}")
        other = ("ns-x", "client", f"10.2.0.{e}")
        src, dst = (other, victim) if ingress else (victim, other)
        for day in range(days):
            n = int(rng.poisson(4.0))
            if rng.random() < 0.02 or (e, day) == (3, 7):
                n *= 20
            rows.extend({
                "flowStartSeconds": day * DAY + 60 * i,
                "flowEndSeconds": day * DAY + 60 * i + 5,
                "sourcePodNamespace": src[0], "sourcePodName": src[1],
                "sourceIP": src[2],
                "destinationPodNamespace": dst[0],
                "destinationPodName": dst[1], "destinationIP": dst[2],
                "destinationTransportPort": 8443,
                "octetDeltaCount": 180,
                "ingressNetworkPolicyRuleAction": 2 if ingress else 0,
                "egressNetworkPolicyRuleAction": 0 if ingress else 3,
                "timeInserted": day * DAY + 60 * i + 10,
            } for i in range(n))
    return rows


@pytest.fixture(scope="module")
def shared_npz(tmp_path_factory):
    """One seeded store for both runners: TAD flows with spikes plus a
    month of dropped flows, saved by the reference's FlowDatabase (the
    same file format as the port's)."""
    db = RefDatabase()
    db.insert_flows(generate_flows(SynthConfig(
        n_series=10, points_per_series=20, anomaly_fraction=0.3,
        anomaly_magnitude=60.0, seed=21)))
    db.insert_flow_rows(_drop_rows(seed=5))
    path = tmp_path_factory.mktemp("shared") / "flows.npz"
    db.save(str(path))
    return path


#: subcommand → (extra argv, result table, float columns and limits)
JOBS = {
    "tad-EWMA": (["tad", "--algo", "EWMA"], "tadetector",
                 {"throughputStandardDeviation": TAD_STD_RTOL}),
    "tad-DBSCAN": (["tad", "--algo", "DBSCAN"], "tadetector",
                   {"throughputStandardDeviation": TAD_STD_RTOL}),
    "tad-ARIMA": (["tad", "--algo", "ARIMA"], "tadetector",
                  {"throughputStandardDeviation": TAD_STD_RTOL,
                   "algoCalc": 1e-9}),
    "npr": (["npr", "--type", "initial", "-o", "1"], "recommendations",
            {}),
    "dropdetection": (["dropdetection"], "dropdetection",
                      {"avgDrop": DD_RTOL, "stdevDrop": DD_RTOL}),
    "patterns": (["patterns", "-m", "3"], "flowpatterns", {}),
    "spatial": (["spatial"], "spatialnoise", {}),
}


def _result_rows(path, table, floats):
    rows = RefDatabase.load(str(path)).result_tables[table].scan()
    rows = rows.to_rows() if len(rows) else []
    skip = ("timeCreated", *floats)
    return sorted(
        (tuple(sorted((k, str(v)) for k, v in r.items() if k not in skip)),
         tuple(float(r[c]) for c in floats)) for r in rows)


@pytest.mark.parametrize("job", sorted(JOBS))
def test_same_npz_through_both_runners(job, shared_npz, tmp_path,
                                       capsys):
    argv, table, floats = JOBS[job]
    outs = {}
    for side, run, extra in (("ref", ref_main, []),
                             ("port", main, CPU)):
        out = tmp_path / f"{side}.results.npz"
        run([*argv, "--db", str(shared_npz), "--id", "job-0",
             "--out", str(out), *extra])
        outs[side] = _result_rows(out, table, floats)
    capsys.readouterr()
    got, want = outs["port"], outs["ref"]
    assert want, f"{job}: the reference wrote no rows"
    assert [g[0] for g in got] == [w[0] for w in want]
    for i, (col, rtol) in enumerate(floats.items()):
        np.testing.assert_allclose([g[1][i] for g in got],
                                   [w[1][i] for w in want], rtol=rtol,
                                   err_msg=col)


# -- the port's own rules ------------------------------------------------

def _digest(path) -> str:
    return hashlib.sha256(Path(path).read_bytes()).hexdigest()


def test_cuda_without_a_card_exits_with_the_message(db_path, tmp_path):
    """The default device on a machine without a card: a non-zero exit
    with resolve_device's message, no results file, the database file
    untouched, and no progress past the start."""
    out = tmp_path / "res.npz"
    before = _digest(db_path)
    proc = subprocess.run(
        [sys.executable, "-m", "theia_tpu_torch.runner", "spatial",
         "--db", db_path, "--out", str(out), "--device", "cuda"],
        cwd=REPO, capture_output=True, text=True, timeout=120)
    if "CUDA is not available" not in proc.stderr:
        pytest.skip("this machine has a card")
    assert proc.returncode != 0
    assert "--device cuda" in proc.stderr
    assert not out.exists()
    assert _digest(db_path) == before
    assert '"state": "COMPLETED"' not in proc.stdout


def test_cpu_child_never_builds_a_kernel(db_path, tmp_path):
    """A fresh runner on --device cpu (nothing built yet, as in the CPU
    tests) runs DBSCAN and SAD without asking for a kernel library."""
    code = (
        "import sys\n"
        "from theia_tpu_torch.ops import _build\n"
        "def refuse(*a, **k):\n"
        "    raise AssertionError('a kernel build on --device cpu')\n"
        "_build.library = refuse\n"
        "from theia_tpu_torch.runner.__main__ import main\n"
        "for job in (['tad', '--algo', 'DBSCAN'], ['spatial']):\n"
        "    main([*job, '--db', sys.argv[1], '--out', sys.argv[2],\n"
        "          '--device', 'cpu'])\n")
    proc = subprocess.run(
        [sys.executable, "-c", code, db_path, str(tmp_path / "r.npz")],
        cwd=REPO, capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.count('"state": "COMPLETED"') == 2


def test_sad_switches_tf32_off_in_a_fresh_process(db_path, tmp_path):
    """SAD's rows match thread dispatch only if its float32 product is
    full float32 in the child too: with TF32 switched on after every
    import, the job itself switches it off again."""
    code = (
        "import sys, torch\n"
        "from theia_tpu_torch.runner.__main__ import main\n"
        "torch.backends.cuda.matmul.allow_tf32 = True\n"
        "main(['spatial', '--db', sys.argv[1], '--out', sys.argv[2],\n"
        "      '--device', 'cpu'])\n"
        "print('tf32', torch.backends.cuda.matmul.allow_tf32)\n")
    proc = subprocess.run(
        [sys.executable, "-c", code, db_path, str(tmp_path / "r.npz")],
        cwd=REPO, capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().splitlines()[-1] == "tf32 False"


def test_stderr_ends_with_the_device_line(db_path, capsys):
    """After the timing lines: the device, and no kernel launch on the
    CPU (a CPU tensor runs the plain versions, which do not count). The
    timing lines are the process's span exemplars by name, so another
    test's spans (`sad.*` sort after `runner.job`) are cleared first,
    as a runner child starts without them."""
    from theia_tpu_torch.obs import trace
    trace.reset()
    main(["tad", "--db", db_path, "--algo", "DBSCAN", "--id", "job-d",
          *CPU])
    err = capsys.readouterr().err.strip().splitlines()
    assert err[-1] == "device cpu"
    assert err[-2].startswith("timing runner.job: ")


def test_device_line_names_the_kernels_that_launched(db_path, capsys,
                                                     monkeypatch,
                                                     fake_cuda):
    """Each kernel whose count moved during the job is named with its
    launches (here B2, as a card run's DBSCAN would move it: one
    launch of a fake entry point through the launch seam)."""
    from theia_tpu_torch.analytics import tad
    from theia_tpu_torch.ops import _build
    real = tad.dbscan_scores

    def counted(*args, **kw):
        _build.launch("dbscan_noise", lambda stream: 0, "cuda:0")
        return real(*args, **kw)

    monkeypatch.setattr(tad, "dbscan_scores", counted)
    main(["tad", "--db", db_path, "--algo", "DBSCAN", *CPU])
    assert capsys.readouterr().err.strip().splitlines()[-1] == \
        "device cpu, B2 launches 1"


def test_child_exit_codes(db_path, tmp_path, monkeypatch):
    """A fault at runner.exec exits TRANSIENT_EXIT_CODE (75), the
    controller's retry class; a bad device name exits non-zero."""
    env = {**os.environ, "THEIA_FAULTS": "runner.exec:error"}
    proc = subprocess.run(
        [sys.executable, "-m", "theia_tpu_torch.runner", "tad", "--db",
         db_path, "--algo", "EWMA", *CPU],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 75, proc.stderr
    with pytest.raises(SystemExit) as e:
        main(["tad", "--db", db_path, "--algo", "EWMA", "--device",
              "tpu"])
    assert e.value.code != 0
