"""Tests of the benchmark itself, on the CPU (a test that needs the card
carries the `cuda` marker and skips without one):

    python -m pytest portbench/tests -q

They cover finding each part of a cell by name, the statistics and
trace readers, the operation counts, the plain references on cases
worked by hand, the result line, what the benchmark imports, and runs
against a manager with a fault or a control planted under the timed
path, which must come out not correct.
"""

import ast
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest

from portbench import flowgen, harness, roofline
from portbench.reference import ingest as ref_ingest
from portbench.reference import sad as ref_sad
from portbench.traffic import ingest_closed, job_loop

PB = harness.PB
BENCH = harness.load_benchmark()
#: BENCHMARK.json with the cells held out of it, whose parts stay tested
ALL = harness.with_held(BENCH)
WORKLOADS = [w["name"] for w in ALL["workloads"]]
SMALL_CLUSTER = {"n_series": 3000, "n_namespaces": 8,
                 "pods_per_namespace": 8, "n_nodes": 3}
SMALL_STORE = {"n_series": 256, "n_namespaces": 8,
               "pods_per_namespace": 8, "n_nodes": 3}


# -- finding the parts by name ------------------------------------------

@pytest.mark.parametrize("name", WORKLOADS)
def test_cell_parts_found_by_name(name):
    cell = harness.Cell(ALL, name)
    kind = cell.kind()
    for fn in ("prepare", "setup", "window", "collect", "check",
               "cleanup"):
        assert callable(getattr(kind, fn))
    assert cell.config["name"] == cell.workload["config"]
    assert "limits" in cell.traffic
    e2e = {m["name"] for m in cell.end_to_end()}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert cell.per_layer()


@pytest.mark.parametrize("metric", [m["name"] for m in ALL["per_layer"]])
def test_metric_reader_found_by_name(metric):
    assert callable(harness.metric_reader(metric).read)


def test_config_files_are_the_benchmarks():
    files = [c["file"] for c in BENCH["configs"]]
    assert len(set(files)) == len(files)
    for c in BENCH["configs"]:
        doc = json.loads((harness.ROOT / c["file"]).read_text())
        assert doc["name"] == c["name"]
        assert doc["reduced"] == c["reduced"]
        assert any(w["config"] == c["name"] for w in BENCH["workloads"])


def test_held_cells_are_not_run_from_the_benchmark():
    held = {w["name"] for w in ALL["workloads"]} - set(
        w["name"] for w in BENCH["workloads"])
    assert held == {"default.ingest-saturate"}
    with pytest.raises(KeyError):
        harness.Cell(BENCH, "default.ingest-saturate")


# -- statistics and readers ---------------------------------------------

def test_percentile_is_over_all_acks():
    acks = list(range(1, 101))
    assert harness.percentile(acks, 90) == 90.0
    assert harness.percentile(acks[::-1], 90) == 90.0
    assert harness.percentile([5.0], 90) == 5.0
    # one slow ack among 100 does not reach the 90th percentile; eleven do
    assert harness.percentile([1.0] * 99 + [50.0], 90) == 1.0
    assert harness.percentile([1.0] * 89 + [50.0] * 11, 90) == 50.0


PROM = """# HELP theia_ingest_stage_seconds stage latency
# TYPE theia_ingest_stage_seconds histogram
theia_ingest_stage_seconds_bucket{stage="detector",le="0.5"} 3
theia_ingest_stage_seconds_sum{stage="detector"} %s
theia_ingest_stage_seconds_count{stage="detector"} %s
theia_ingest_stage_seconds_sum{stage="store_insert"} 1.0
theia_ingest_stage_seconds_count{stage="store_insert"} 4
theia_fused_step_seconds_sum 2.5
theia_fused_step_seconds_count 10
theia_ingest_alerts_total{kind="connection_anomaly"} 7
"""


def test_prom_mean_delta():
    before = harness.prom_parse(PROM % ("1.5", "3"))
    after = harness.prom_parse(PROM % ("4.5", "9"))
    assert harness.prom_mean_delta(before, after,
                                   "theia_ingest_stage_seconds",
                                   stage="detector") == pytest.approx(0.5)
    # nothing observed between the scrapes: no reading, not 0
    assert harness.prom_mean_delta(before, after,
                                   "theia_ingest_stage_seconds",
                                   stage="store_insert") is None
    assert after[("theia_ingest_alerts_total",
                  (("kind", "connection_anomaly"),))] == 7.0
    assert after[("theia_fused_step_seconds_count", ())] == 10.0


TRACE = {"traceEvents": [
    {"ph": "X", "cat": "kernel", "name": "a", "ts": 0, "dur": 10},
    {"ph": "X", "cat": "kernel", "name": "b", "ts": 5, "dur": 10},
    {"ph": "X", "cat": "gpu_memcpy", "name": "copy", "ts": 30, "dur": 5},
    {"ph": "X", "cat": "kernel", "name": "a", "ts": 60, "dur": 20},
    {"ph": "X", "cat": "cuda_runtime", "name": "cudaMemcpyAsync",
     "ts": 36, "dur": 20},
    {"ph": "X", "cat": "cpu_op", "name": "aten::add", "ts": 0, "dur": 40},
]}


def test_interval_union_of_a_trace(tmp_path):
    path = tmp_path / "trace.json"
    path.write_text(json.dumps(TRACE))
    dev = harness.trace_device_events(json.loads(path.read_text()))
    assert len(dev) == 4
    assert harness.busy_us(dev) == 15 + 5 + 20
    assert harness.busy_us(dev, 0, 70) == 15 + 5 + 10
    bd = harness.breakdown(TRACE, 0, 100)
    assert bd["device_ops"][0] == ["a", 30e-6]
    # the longest gap (35–60 µs) overlaps the memcpy call most
    assert bd["idle_gaps"][0] == ["cudaMemcpyAsync", 25e-6]
    assert len(bd["device_ops"]) <= 10 and len(bd["idle_gaps"]) <= 10


def test_sad_operation_and_byte_counts():
    n, f, core = 1000, 7, 900
    assert roofline.sad_pairs_ops(n, f, core) == (
        1000 * 1000 * 17 + 100 * 900 * 17)
    assert roofline.sad_pairs_bytes(n, f) == 1000 * 7 * 4 + 1000
    s, bound = roofline.sad_pairs_bound_s(262144, 7, 262144)
    assert bound == "operations"
    assert s == pytest.approx(262144.0 ** 2 * 17 / 67e12)


# -- the plain references on hand-made cases ------------------------------

def test_detector_reference_by_hand():
    # one connection: 10, 10, 10, 40 → ewma 5, 7.5, 8.75, 24.375;
    # Welford std after 2, 3, 4 points: 0, 0, 15; the last point is
    # |40 − 24.375| = 15.625 > 15 away: anomalous; a second connection
    # interleaved with it keeps its own state
    key = np.array([0, 1, 0, 1, 0, 0])
    x = np.array([10, 3, 10, 3, 10, 40])
    flags = ref_ingest.detector_flags(key, x, 2)
    # a connection's second point: |10 − 7.5| = 2.5 > std 0, and for
    # the other |3 − 2.25| = 0.75 > 0: anomalous; the first points are
    # never (one point seen)
    assert flags.tolist() == [False, False, True, True, True, True]
    assert not ref_ingest.detector_flags(np.array([0]),
                                         np.array([10]), 1)[0]


def test_sad_reference_by_hand():
    # four points within eps of each other (a core group), one point
    # 0.9 eps from the group's edge (border), one far away (noise)
    emb = np.zeros((6, 7), np.float32)
    emb[:4, 6] = [0.0, 0.1, 0.2, 0.3]
    emb[4, 6] = 1.2
    emb[5, 6] = 10.0
    sure, possible, core = ref_sad.noise_bounds(emb, 1.0, 4, "cpu")
    assert sure.tolist() == [False] * 5 + [True]
    assert possible.tolist() == sure.tolist()
    assert core == 4
    # a pair exactly at eps is decided by rounding: not sure, possible
    emb2 = np.zeros((2, 7), np.float32)
    emb2[1, 6] = 1.0
    sure2, possible2, _ = ref_sad.noise_bounds(emb2, 1.0, 2, "cpu")
    assert not sure2.any() and possible2.all()


def test_store_codes_follow_first_appearance():
    codes = ref_sad.store_codes([np.array([0, 4, 9]), np.array([2, 4])])
    assert codes == {0: 0, 4: 1, 9: 2, 2: 3}


def test_generator_is_fixed_by_the_seed():
    def blocks(seed):
        c = flowgen.Connections(SMALL_CLUSTER, seed, 3, (1, 3))
        return [(s, b.payload) for s, b in flowgen.stream_blocks(c, 4, 700)]
    a, b = blocks(2**31 + 99), blocks(2**31 + 99)
    assert a == b and a != blocks(2**31 + 98)
    # each connection belongs to one stream, in round order there
    c = flowgen.Connections(SMALL_CLUSTER, 1, 3, (1, 3))
    owner = {}
    for s, blk in flowgen.stream_blocks(c, 4, 700):
        for conn in blk.conns.tolist():
            assert owner.setdefault(conn, s) == s


def test_supply_rests_once_its_blocks_are_encoded():
    c = flowgen.Connections(SMALL_CLUSTER, 2**31 + 7, 6, (1, 6))
    supply = ingest_closed.Supply(c, 2, 500, budget=5)
    try:
        supply.fill(5, timeout=60)
        time.sleep(0.3)
        assert supply.encoded == 5
        # a stream that finds its queue empty gets blocks encoded anew
        st = supply.streams[0]
        got = [supply.next(st) for _ in range(5)]
        assert all(b is not None for b in got)
        assert supply.encoded > 5
    finally:
        supply.close()


# -- the deployment sets the traffic -------------------------------------

def test_ingest_shape_is_the_deployments():
    cfg = harness.Cell(ALL, "default.ingest-saturate").config
    # one Flow Aggregator; 150,000 connections × 8 s ÷ 60 s a commit
    assert ingest_closed.shape(cfg, {}) == (1, 20000)
    assert ingest_closed.shape(cfg, {"streams": 4, "block_rows": 99}) == (
        4, 99)


def test_job_store_is_the_configurations_cut():
    cell = harness.Cell(BENCH, "default.sad-job")
    params, points = job_loop.store_params(cell.config, cell.traffic)
    assert (params["n_series"], points) == (8192, 32)
    assert "job_store" in cell.config["reduced"]
    assert params["anomaly_magnitude"] == cell.traffic["store"][
        "anomaly_magnitude"]


# -- what the benchmark imports -------------------------------------------

def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module \
                and node.level == 0:
            yield node.module


def test_nothing_imports_jax_or_the_jax_package():
    for path in PB.rglob("*.py"):
        for mod in _imports(path):
            assert mod.split(".")[0] not in harness.FORBIDDEN, (path, mod)


def test_references_import_nothing_of_the_port():
    for path in (PB / "reference").glob("*.py"):
        for mod in _imports(path):
            assert mod.split(".")[0] not in (
                *harness.FORBIDDEN, "theia_tpu_torch"), (path, mod)


def test_fresh_process_holds_no_jax():
    code = (
        "import sys; sys.path.insert(0, %r)\n"
        "from portbench import harness\n"
        "b = harness.load_benchmark()\n"
        "for w in b['workloads']: harness.Cell(b, w['name']).kind()\n"
        "for m in b['per_layer']: harness.metric_reader(m['name'])\n"
        "import portbench.reference.ingest, portbench.reference.sad\n"
        "print(sorted({m.split('.')[0] for m in sys.modules}))\n"
        % str(harness.ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, check=True)
    held = set(eval(out.stdout.strip().splitlines()[-1]))
    assert not held & {*harness.FORBIDDEN, "theia_tpu_torch"}


# -- a run on the CPU, and runs with a fault or a control planted --------

def _run(name, plant=None, seconds=2.0, trace=False, device="cpu",
         seed=2**31 + 123, small=True):
    cmd = None
    if plant is not None:
        cmd = [sys.executable, str(Path(__file__).with_name(
            "faulty_manager.py")), plant]
    config, traffic = {}, {}
    if small and name.endswith("ingest-saturate"):
        # small blocks, so that the short window holds acks
        config = {"cluster": SMALL_CLUSTER}
        traffic = {"block_rows": 256, "max_rows_per_s": 20000}
        seconds = max(seconds, 4.0)
    elif small:
        config = {"cluster": SMALL_CLUSTER, "job_store": SMALL_STORE}
        traffic = {"block_rows": 1024}
    return harness.run(name, seed, seconds, trace, time.perf_counter(),
                       device=device, manager_command=cmd, config=config,
                       traffic=traffic, bench=ALL)


def test_result_line_keys():
    out = _run("default.ingest-saturate")
    assert list(out)[:5] == ["correct", "attempted", "failed", "metrics",
                             "device"]
    assert list(out)[-1] == "checks"
    assert out["correct"] is True, out["checks"]
    assert set(out["metrics"]) == {"ingest_rows_per_s", "ack_p90_ms",
                                   "setup_s"}
    for c in out["checks"].values():
        assert set(c) == {"value", "limit"}
    json.dumps(out)


@pytest.mark.parametrize("fault", ["state_unchanged", "half_batch",
                                   "altered"])
def test_ingest_fault_is_not_correct(fault):
    out = _run("default.ingest-saturate", fault)
    assert out["correct"] is False, out["checks"]


@pytest.mark.parametrize("fault", ["half_batch", "altered"])
def test_job_fault_is_not_correct(fault):
    out = _run("default.sad-job", fault)
    assert out["correct"] is False, out["checks"]


#: each cell's control: the configuration's precision, one step down
CONTROLS = {"default.ingest-saturate": "bf16_state",
            "default.sad-job": "bf16_pairs"}
#: a control's window on the card: long enough for the mix's longest
#: request and as many comparisons as a run makes of them
CONTROL_SECONDS = {"default.ingest-saturate": 20.0,
                   "default.sad-job": 10.0}


@pytest.mark.parametrize("name", sorted(CONTROLS))
def test_control_is_not_correct(name):
    out = _run(name, CONTROLS[name])
    assert out["correct"] is False, out["checks"]


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [2**31 + 11, 2**31 + 12, 2**31 + 13])
@pytest.mark.parametrize("name", sorted(CONTROLS))
def test_control_on_the_card_is_not_correct(name, seed):
    """The control at the cell's own size on the card; prints what each
    number read beside its limit."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = _run(name, CONTROLS[name], seconds=CONTROL_SECONDS[name],
               device="cuda", seed=seed, small=False)
    print(json.dumps({"control": name, "seed": seed,
                      "checks": out["checks"]}))
    assert out["correct"] is False, out["checks"]
