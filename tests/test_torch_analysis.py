"""The static analysis gate over the PyTorch port, and the port's
runtime lockdep gate.

`python -m theia_tpu_torch.analysis` must exit clean on the port
(zero unwaived findings, zero stale waivers), as tests/test_analysis.py
holds `python -m theia_tpu.analysis` over the reference. The port's
locks record into its own witness (theia_tpu_torch/analysis/lockdep.py,
armed for the suite by tests/conftest.py), which the suite-wide
teardown gate does not read: `port_lockdep_clean` below is that gate
for the port. Each port test module that runs locked port code imports
it, and it fails the module at teardown if the port's witness saw a
lock-order inversion.
"""

from __future__ import annotations

import threading

import pytest

from theia_tpu_torch.analysis import lockdep
from theia_tpu_torch.analysis.base import apply_waivers, validate_waivers

pytestmark = pytest.mark.analysis

REPO = __file__.rsplit("/tests/", 1)[0]


def inversion_report(inv) -> str:
    return ("the port's lockdep witnessed lock-order inversion(s) (a "
            "deadlock waiting for the right interleaving):\n"
            + "\n".join(
                f"  cycle {' -> '.join(i['cycle'])} — new edge "
                f"{i['edge'][0]} -> {i['edge'][1]} at {i['site']} "
                f"(thread {i['thread']}); prior sites: {i['priorSites']}"
                for i in inv))


@pytest.fixture(scope="module", autouse=True)
def port_lockdep_clean():
    """At the end of the module: no lock-order inversion in the port's
    witness. Tests that build deliberate inversions use
    lockdep.scoped()."""
    yield
    if not lockdep.enabled():
        return
    inv = lockdep.inversions()
    assert not inv, inversion_report(inv)


# -- the static gate -----------------------------------------------------

@pytest.fixture(scope="module")
def analysis():
    """(findings, lockgraph) of the port's static passes at head."""
    from theia_tpu_torch.analysis.__main__ import run_all
    return run_all(REPO)


def test_port_analysis_clean_at_head(analysis):
    """The port's static passes and waivers: zero unwaived findings
    and zero stale waivers on the port as committed."""
    from theia_tpu_torch.analysis.waivers import WAIVERS
    findings, _lg = analysis
    problems = validate_waivers(WAIVERS)
    assert not problems, problems
    unwaived, _waived, stale = apply_waivers(findings, WAIVERS)
    assert not unwaived, (
        "unwaived analysis findings in theia_tpu_torch (fix, or waive "
        "with the invariant spelled out in analysis/waivers.py):\n"
        + "\n".join(f"  {f.check}: {f.key} @ {f.site}"
                    for f in unwaived))
    assert not stale, (
        "stale waivers (match nothing — the code they described "
        "changed):\n"
        + "\n".join(f"  {w['check']}:{w['match']}" for w in stale))


def test_port_analysis_main_exit_code(capsys):
    from theia_tpu_torch.analysis.__main__ import main
    assert main(["--root", REPO]) == 0
    assert "theia_tpu_torch analysis:" in capsys.readouterr().out


def test_port_analysis_scans_the_port_only(analysis):
    """Every finding sits in the port or in chip_smoke.py, and every
    waiver matches a port path: the gate cannot pass on the
    reference's code."""
    from theia_tpu_torch.analysis.waivers import WAIVERS
    findings, lg = analysis
    assert findings
    for f in findings:
        if ":" in f.key.split(":", 1)[1]:
            assert f.key.split(":", 2)[1].startswith(
                ("theia_tpu_torch/", "chip_smoke.py")), f.key
    assert all(":theia_tpu_torch/" in w["match"] for w in WAIVERS)
    assert all(m.startswith("theia_tpu_torch.")
               for m, _cls, _attr in lg.locks)


def test_port_lockgraph_finds_the_ports_locks(analysis):
    """The port's lock population, from the request half down to the
    job controller."""
    names = set(analysis[1].locks.values())
    for expected in ("store.table", "wal.io", "ingest.shard",
                     "store.ingest_latch", "metrics.registry",
                     "jobs.device", "jobs.controller"):
        assert expected in names, f"{expected} not identified"
    assert len(names) >= 40


def test_port_waivers_are_the_references_at_port_paths():
    """Each port waiver is a reference waiver with its path moved into
    the port and its invariant unchanged."""
    from theia_tpu.analysis.waivers import WAIVERS as REF
    from theia_tpu_torch.analysis.waivers import WAIVERS
    ref = {(w["check"], w["match"].replace(":theia_tpu/",
                                           ":theia_tpu_torch/")):
           w["invariant"] for w in REF}
    for w in WAIVERS:
        assert ref[(w["check"], w["match"])] == w["invariant"]


@pytest.mark.parametrize("site", ["runner.spawn", "reconciler.pass",
                                  "runner.exec"])
def test_port_fires_every_job_fault_site(site):
    """The job-control fault sites fire in the port's code (the lint's
    stale-fault-site check, one site at a time)."""
    from theia_tpu_torch.analysis.lint import extract_fired_sites
    assert site in extract_fired_sites(f"{REPO}/theia_tpu_torch")


# -- the runtime gate ----------------------------------------------------

def test_port_witness_is_armed_for_the_suite():
    """tests/conftest.py arms THEIA_LOCKDEP before any import, so the
    port's locks are witnessed too (their wrapping is decided when
    they are created)."""
    if not lockdep.enabled():
        pytest.skip("witness disarmed (THEIA_LOCKDEP=0 run)")
    from theia_tpu_torch.manager.jobs import JobController
    from theia_tpu_torch.store import FlowDatabase
    ctl = JobController(FlowDatabase(), workers=0, device="cpu")
    try:
        ctl.create("tad", {"jobType": "EWMA"})
        assert "jobs.controller" in lockdep.lock_names()
    finally:
        ctl.shutdown()


def test_port_witness_catches_an_inversion_in_scope():
    """Both orders of two port locks, taken one after the other on two
    threads (no deadlock ever happens), are an inversion the gate
    reads; inside lockdep.scoped() it stays out of the module's
    gate."""
    if not lockdep.enabled():
        pytest.skip("witness disarmed (THEIA_LOCKDEP=0 run)")
    with lockdep.scoped():
        a = lockdep.named_lock("fixture.port.a")
        b = lockdep.named_lock("fixture.port.b")

        def ab():
            with a:
                with b:
                    pass

        def ba():
            with b:
                with a:
                    pass

        for fn in (ab, ba):
            t = threading.Thread(target=fn)
            t.start()
            t.join()
        inv = lockdep.inversions()
        assert inv and set(inv[0]["cycle"]) >= {"fixture.port.a",
                                                 "fixture.port.b"}
        assert "fixture.port.a" in inversion_report(inv)
    assert not [i for i in lockdep.inversions()
                if "fixture.port.a" in i["cycle"]]
