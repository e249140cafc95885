"""Tests of the span readers (portbench/spans.py and the metrics that
read the manager's spans), on the CPU; the test that needs the card
carries the `cuda` marker and skips without one:

    python -m pytest portbench/tests/test_spans.py -q

They hold the six readers to a hand-built Chrome trace whose answers
are worked by hand, the benchmark's earlier trace readers to the same
values with and without the span events on a trace recorded on the
card, and, on the card, the spans' clock to the CUDA runtime calls of
the job worker's thread.
"""

import gzip
import json
import shutil
import tempfile
from pathlib import Path
from types import SimpleNamespace

import pytest

from portbench import harness, spans

DATA = Path(__file__).with_name("data")
#: a traced SAD window recorded on the card (cut_recording: two jobs of
#: `default.sad-job`, seed 2**31 + 778, NVIDIA H100 80GB HBM3, 700 W)
RECORDED = DATA / "sad_trace.json.gz"
SPAN_READERS = ("job.stage_read_ms", "job.stage_embed_ms",
                "job.stage_write_ms", "sad.count_pass_ms",
                "sad.reach_pass_ms", "job.device_idle_ms")
#: the readers the cell had before the span readers, two of them of the trace
EARLIER_READERS = ("job.run_s", "job.queue_wait_ms", "sad.pairs_roofline",
                   "device.idle_share.job")


# -- a hand-built trace --------------------------------------------------

def _span(op, ts, dur, tid=11, **args):
    return {"ph": "X", "cat": "theia_span", "name": op, "pid": 1,
            "tid": tid, "ts": ts, "dur": dur, "args": args}


def _rt(ts, corr, tid=11, name="cudaLaunchKernel"):
    return {"ph": "X", "cat": "cuda_runtime", "name": name, "pid": 1,
            "tid": tid, "ts": ts, "dur": 5, "args": {"correlation": corr}}


def _dev(ts, dur, corr, cat="kernel"):
    return {"ph": "X", "cat": cat, "name": f"k{corr}", "pid": 0, "tid": 7,
            "ts": ts, "dur": dur, "args": {"correlation": corr}}


def _job(trace_id, ts, dur, kind="sad", stages=(), passes=()):
    out = [_span("job.run", ts, dur, traceId=trace_id, kind=kind,
                 job=f"job-{trace_id}")]
    for stage, s, d in stages:
        out.append(_span("job.stage", s, d, traceId=trace_id, stage=stage,
                         kind=kind, job=f"job-{trace_id}"))
    for op, s, d in passes:
        out.append(_span(op, s, d, traceId=trace_id, rows=4, points=4,
                         block=4))
    return out


def hand_trace():
    """Two whole SAD jobs, A (1,000–11,000 µs) and B (20,000–25,000),
    a TAD job and a SAD job that starts before the capture (0–10^6)."""
    ev = []
    ev += _job("A", 1000, 10000, stages=[
        ("read", 1000, 1000), ("embed", 2000, 1000), ("score", 3000, 6000),
        ("write", 9000, 1500)], passes=[
        ("dbscan.count_pass", 3500, 1500), ("dbscan.reach_pass", 5000,
                                            1500)])
    # A's count pass launches 1 and 2 (2 runs after the span closes),
    # its reach pass 3; 4 comes from another thread, 5 after the passes
    ev += [_rt(3600, 1), _rt(4000, 2), _rt(5100, 3), _rt(3700, 4, tid=99),
           _rt(7000, 5, name="cudaMemcpyAsync")]
    ev += [_dev(3700, 1000, 1), _dev(4700, 500, 2), _dev(5200, 2000, 3),
           _dev(8000, 100, 4), _dev(7200, 100, 5, cat="gpu_memcpy")]
    ev += _job("B", 20000, 5000, stages=[
        ("read", 20000, 500), ("embed", 20500, 1000),
        ("score", 21500, 2500), ("write", 24000, 900)], passes=[
        ("dbscan.count_pass", 22000, 500),
        ("dbscan.reach_pass", 22500, 500)])
    ev += [_rt(22100, 6), _rt(22600, 7)]
    ev += [_dev(22200, 400, 6), _dev(22600, 800, 7)]
    # not the cell's kind, and a job not wholly inside the capture
    ev += _job("C", 30000, 2000, kind="tad", stages=[
        ("read", 30000, 1000)])
    ev += _job("D", -500, 900, stages=[("read", -500, 400)], passes=[
        ("dbscan.count_pass", -400, 300)])
    ev += [_rt(-350, 8), _dev(-300, 200, 8)]
    return {"traceEvents": ev}


#: the answers, worked by hand: stage means over A and B; device time
#: of the operations each pass launched a job; idle time a job (A: its
#: 10,000 µs less 3,700 busy; B: 5,000 less 1,200)
HAND = {"job.stage_read_ms": (1000 + 500) / 2 / 1e3,
        "job.stage_embed_ms": (1000 + 1000) / 2 / 1e3,
        "job.stage_write_ms": (1500 + 900) / 2 / 1e3,
        "sad.count_pass_ms": (1500 + 400) / 2 / 1e3,
        "sad.reach_pass_ms": (2000 + 800) / 2 / 1e3,
        "job.device_idle_ms": (6300 + 3800) / 2 / 1e3}


def _ctx(trace, span=(0.0, 1e6)):
    return SimpleNamespace(trace_doc=trace, trace_span=span,
                           traffic={"resource": "spatialanomalydetections"},
                           data={}, prom0={}, prom1={})


@pytest.mark.parametrize("name", SPAN_READERS)
def test_span_reader_on_a_hand_built_trace(name):
    got = harness.metric_reader(name).read(_ctx(hand_trace()))
    assert got == pytest.approx(HAND[name], rel=1e-12)


@pytest.mark.parametrize("name", SPAN_READERS)
def test_span_reader_reads_nothing_without_spans(name):
    """A trace with no span events (the parent's program) and a run
    with no trace give no reading, and raise nothing."""
    bare = {"traceEvents": [e for e in hand_trace()["traceEvents"]
                            if e["cat"] != "theia_span"]}
    assert harness.metric_reader(name).read(_ctx(bare)) is None
    assert harness.metric_reader(name).read(_ctx(None)) is None


def test_idle_cover_of_a_job():
    trace = hand_trace()
    run = spans.job_runs(_ctx(trace))[0]
    idle, cover = spans.idle_cover(trace, run, ["job.stage",
                                                "job.stage:read",
                                                "dbscan.count_pass"])
    assert idle == 6300
    # idle in A: 1,000–3,700, 7,300–8,000, 8,100–11,000; the stages
    # cover it up to 10,500, read 1,000–2,000, the count pass 3,500–3,700
    assert cover == {"job.stage": 5800, "job.stage:read": 1000,
                     "dbscan.count_pass": 200, "all": 5800}


def test_idle_gaps_of_a_union():
    merged = [(0.0, 2.0), (5.0, 6.0), (8.0, 9.0)]
    assert spans.idle_gaps(merged, 1.0, 8.5) == [(2.0, 5.0), (6.0, 8.0)]
    assert spans.idle_gaps(merged, 10.0, 12.0) == [(10.0, 12.0)]
    assert spans.idle_gaps([], 0.0, 1.0) == [(0.0, 1.0)]


# -- the earlier readers, with and without the span events ---------------

def _recorded_ctx(doc, with_spans):
    """The recorded run's context, its capture's span found from the
    trace as job_loop.window finds it."""
    trace = doc["trace"] if with_spans else {
        **doc["trace"], "traceEvents": [
            e for e in doc["trace"]["traceEvents"]
            if e.get("cat") != spans.SPAN_CAT]}
    lo = min(float(e["ts"]) for e in trace["traceEvents"]
             if e.get("ph") == "X" and "ts" in e)
    prom = [{(n, tuple(map(tuple, labels))): v for n, labels, v in p}
            for p in (doc["prom0"], doc["prom1"])]
    return SimpleNamespace(
        trace_doc=trace, trace_span=(lo, lo + doc["capture_s"] * 1e6),
        traffic=doc["traffic"], prom0=prom[0], prom1=prom[1],
        data={**doc["data"], "jobs": doc["jobs"]})


@pytest.mark.parametrize("name", EARLIER_READERS)
def test_earlier_readers_ignore_the_span_events(name):
    doc = json.loads(gzip.decompress(RECORDED.read_bytes()))
    read = harness.metric_reader(name).read
    with_spans = read(_recorded_ctx(doc, True))
    assert with_spans is not None
    assert read(_recorded_ctx(doc, False)) == with_spans
    # and the recording holds what the span readers read
    for span_reader in SPAN_READERS:
        assert harness.metric_reader(span_reader).read(
            _recorded_ctx(doc, True)) is not None


# -- on the card ---------------------------------------------------------

def traced_window(name, seed, seconds, device="cuda", config=None,
                  traffic=None):
    """The set-up and the traced window of one run of a cell, as
    harness.run makes them, and its checks against the reference; the
    context the readers read."""
    cell = harness.Cell(harness.load_benchmark(), name)
    for group, keys in (config or {}).items():
        cell.config[group].update(keys)
    cell.traffic.update(traffic or {})
    kind = cell.kind()
    workdir = tempfile.mkdtemp(prefix="portbench-")
    ctx = harness.Ctx(cell, seed, seconds, True, device, workdir)
    mgr = ctx.mgr = harness.Manager(cell.config, workdir, device)
    try:
        mgr.start()
        kind.prepare(ctx)
        mgr.wait_ready()
        kind.setup(ctx)
        mgr.profile(0.2)
        ctx.prom0 = mgr.scrape()
        kind.window(ctx)
        ctx.prom1 = mgr.scrape()
    finally:
        mgr.stop()
        shutil.rmtree(workdir, ignore_errors=True)
    ctx.notes["checks"] = kind.check(ctx)
    return ctx


def cut_recording(ctx, jobs: int = 2) -> dict:
    """The recording the earlier readers' test reads, cut from a traced
    window: its first `jobs` jobs and the trace up to halfway between
    the last of their `job.run` spans and the next, with the events'
    args kept only where a reader reads them."""
    trace = ctx.trace_doc
    runs = spans.job_runs(ctx)
    lo = ctx.trace_span[0]
    last = float(runs[jobs - 1]["ts"]) + float(runs[jobs - 1]["dur"])
    cut = (last + float(runs[jobs]["ts"])) / 2
    keep = []
    for e in trace["traceEvents"]:
        if e.get("ph") != "X" or "ts" not in e or float(e["ts"]) >= cut:
            continue
        ev = {k: e[k] for k in ("ph", "cat", "name", "pid", "tid", "ts",
                                "dur") if k in e}
        args = e.get("args", {})
        if e.get("cat") == spans.SPAN_CAT:
            ev["args"] = args
        elif "correlation" in args:
            ev["args"] = {"correlation": args["correlation"]}
        keep.append(ev)
    wanted = ("theia_job_run_seconds", "theia_job_queue_wait_seconds")
    return {"trace": {"traceEvents": keep,
                      "theiaSpans": trace.get("theiaSpans")},
            "capture_s": (cut - lo) / 1e6,
            "traffic": {"resource": ctx.traffic["resource"]},
            "jobs": [{"t0": j["t0"], "t1": j["t1"], "doc": {}}
                     for j in ctx.data["jobs"][:jobs]],
            "data": {k: ctx.data[k] for k in ("sad_n", "sad_dim",
                                                "sad_core")},
            "prom0": [[n, list(lab), v] for (n, lab), v in ctx.prom0.items()
                      if n.startswith(wanted)],
            "prom1": [[n, list(lab), v] for (n, lab), v in ctx.prom1.items()
                      if n.startswith(wanted)]}


#: the host spans of a SAD job that may hold the card idle
HOST_SPANS = ("job.stage:read", "job.stage:embed", "job.stage:write",
              "sad.to_device", "sad.fetch", "sad.decode")
#: the spans whose idle time the host spans leave out
INNER_SPANS = ("job.stage", "job.stage:score", "dbscan.count_pass",
               "dbscan.reach_pass")


def span_clock_report(ctx) -> dict:
    """For each whole job of the capture: how many cudaLaunchKernel and
    cudaMemcpyAsync calls its worker's thread made between that thread's
    previous job and its next (or the capture's ends), and how many of
    them lie outside the job's `job.run` span; the idle time a job and
    what the host spans cover of it; the clock offset's error against
    baseTimeNanoseconds."""
    trace = ctx.trace_doc
    runs = spans.job_runs(ctx)
    lo, hi = ctx.trace_span
    calls = {}
    for e in trace["traceEvents"]:
        if e.get("cat") == "cuda_runtime" and e.get("name") in (
                "cudaLaunchKernel", "cudaMemcpyAsync"):
            calls.setdefault(e.get("tid"), []).append(float(e["ts"]))
    jobs = []
    for tid in sorted({r["tid"] for r in runs}):
        own = [r for r in runs if r["tid"] == tid]
        ts = sorted(calls.get(tid, []))
        ends = [lo] + [float(r["ts"]) + float(r["dur"]) for r in own]
        starts = [float(r["ts"]) for r in own[1:]] + [hi]
        for r, prev_end, next_start in zip(own, ends, starts):
            s, e = float(r["ts"]), float(r["ts"]) + float(r["dur"])
            mine = [c for c in ts if prev_end < c < next_start]
            idle, cover = spans.idle_cover(trace, r, HOST_SPANS)
            _, inner = spans.idle_cover(trace, r, INNER_SPANS)
            jobs.append({
                "tid": tid, "calls": len(mine),
                "outside": sum(1 for c in mine if not s <= c <= e),
                "first_call_after_start_us": (mine[0] - s) if mine else None,
                "last_call_before_end_us": (e - mine[-1]) if mine else None,
                "run_us": e - s, "idle_us": idle, "cover_us": cover,
                "inner_us": inner})
    return {"jobs": jobs, "theiaSpans": trace.get("theiaSpans")}


@pytest.mark.cuda
def test_span_clock_holds_the_worker_calls_on_the_card():
    """Every CUDA runtime call that the job worker's thread made during
    a job wholly inside the capture lies inside that job's `job.run`
    span, as converted to the trace's clock, and the host spans cover at
    least 90% of the card's idle time inside each such job; prints the
    offset's error against baseTimeNanoseconds, and the cover."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    ctx = traced_window("default.sad-job", 2**31 + 4242, 10.0)
    report = span_clock_report(ctx)
    print(json.dumps({"span_clock": report}))
    assert abs(report["theiaSpans"]["baseOffsetErrorUs"]) < 1000
    assert report["jobs"]
    for job in report["jobs"]:
        assert job["calls"] > 0 and job["outside"] == 0, job
        assert job["cover_us"]["all"] >= 0.9 * job["idle_us"], job
