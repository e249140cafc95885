"""Traffic kind `job_loop`: an analyst running one analytics job after
another through the intelligence API, as `theia <job> run --wait`,
`retrieve` and `delete` do.

Set-up posts the job's store (the configuration's `job_store`, its
cut of the deployment: series × points of a slice of the cluster,
with the mix's `store` distributions, as time-ordered TBLK blocks on
`setup_streams` exporters) through `POST /ingest`, then runs one job
untimed. The
window submits a job, polls it every `poll_s` until it is COMPLETED
(the last poll carries its result rows), deletes it, and submits the
next, running whole jobs until `--seconds` have passed.

End-to-end: the mix's `metric` (`job_s`), the window's seconds ÷ the
jobs completed.

Correct: the result rows of a seed-drawn sample of `compare_jobs` jobs
of the window against `reference/<job>.py`, run after the manager has
stopped.
"""

from __future__ import annotations

import json
import threading
import time
import uuid
from typing import Dict, List

import numpy as np

from portbench import flowgen, harness

GROUP = "/apis/intelligence.theia.antrea.io/v1alpha1"


def store_params(config: dict, traffic: dict):
    """(generator parameters, points a series) of the job's store."""
    cut = config["job_store"]
    cluster = {**config["cluster"],
               **{k: v for k, v in cut.items() if k != "points"},
               **traffic.get("store", {})}
    return cluster, int(cut["points"])


def prepare(ctx) -> None:
    t = ctx.traffic
    cluster, points = store_params(ctx.config, t)
    conns = flowgen.Connections(cluster, ctx.seed, points,
                                (points // 2, points))
    blocks = list(flowgen.stream_blocks(conns, int(t["setup_streams"]),
                                        int(t["block_rows"])))
    ctx.data.update(conns=conns, blocks=blocks, points=points)


def _post_blocks(ctx) -> None:
    import http.client
    n_streams = int(ctx.traffic["setup_streams"])
    per = [[b for s, b in ctx.data["blocks"] if s == i]
           for i in range(n_streams)]
    errors: List[str] = []

    def post(i):
        conn = http.client.HTTPConnection("127.0.0.1", ctx.mgr.port,
                                          timeout=300)
        try:
            for seq, blk in enumerate(per[i]):
                conn.request("POST", f"/ingest?stream=store-{i}&seq={seq}",
                             body=blk.payload, headers={
                                 "Content-Type": "application/octet-stream"})
                resp = conn.getresponse()
                raw = resp.read()
                if resp.status != 200 or json.loads(raw).get(
                        "rows") != len(blk.conns):
                    errors.append(f"block {seq} of stream {i}: "
                                  f"{resp.status} {raw[:200]!r}")
                    return
        finally:
            conn.close()
    threads = [threading.Thread(target=post, args=(i,))
               for i in range(n_streams)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    if errors:
        raise RuntimeError("the job store was not stored: " + errors[0])


def _job(ctx, i: int) -> dict:
    """Submit job i, poll it to its end, delete it."""
    t = ctx.traffic
    path = f"{GROUP}/{t['resource']}"
    name = t["prefix"] + str(uuid.UUID(int=(ctx.seed * 4099 + i)
                                       % (1 << 128)))
    mgr = ctx.mgr
    t0 = time.perf_counter()
    mgr.send_json("POST", path, {"metadata": {"name": name}, **t["spec"]})
    while True:
        doc = mgr.get_json(f"{path}/{name}")
        state = doc["status"]["state"]
        if state in ("COMPLETED", "FAILED"):
            break
        time.sleep(float(t["poll_s"]))
    t1 = time.perf_counter()
    status, raw = mgr.request("DELETE", f"{path}/{name}")
    if status != 200:
        raise harness.HttpError(status, raw)
    return {"name": name, "state": state, "t0": t0, "t1": t1,
            "doc": doc if state == "COMPLETED" else None,
            "error": doc["status"].get("errorMsg")}


def setup(ctx) -> None:
    t0 = time.perf_counter()
    _post_blocks(ctx)
    ctx.notes["store_post_s"] = time.perf_counter() - t0
    warm = _job(ctx, -1)
    if warm["state"] != "COMPLETED":
        raise RuntimeError(f"the warm-up job failed: {warm['error']}")
    ctx.notes["warm_job_s"] = warm["t1"] - warm["t0"]
    for blk in (b for _, b in ctx.data["blocks"]):
        blk.payload = None


def window(ctx) -> None:
    jobs: List[dict] = []
    t_start = time.perf_counter()
    capture_end = None
    if ctx.trace:
        d = min(60.0, ctx.seconds + 10.0)
        ctx.mgr.send_json("POST", "/apis/system.theia.antrea.io/"
                          "v1alpha1/profiles", {"durationSeconds": d})
        # the profiler starts within this (it was started once in
        # set-up); every job of the traced window lies in the capture
        time.sleep(1.5)
        capture_end = t_start + d - 1.0
        ctx.data["capture_s"] = d
    t0 = time.perf_counter()
    while True:
        jobs.append(_job(ctx, len(jobs)))
        now = time.perf_counter()
        if capture_end is None:
            if now - t0 >= ctx.seconds:
                break
        else:
            last = jobs[-1]["t1"] - jobs[-1]["t0"]
            if now + 1.5 * last > capture_end:
                break
    window_s = jobs[-1]["t1"] - t0
    done = [j for j in jobs if j["state"] == "COMPLETED"]
    ctx.data["jobs"] = jobs
    ctx.data["attempted"] = len(jobs)
    ctx.data["failed"] = len(jobs) - len(done)
    if done:
        ctx.e2e[ctx.traffic["metric"]] = window_s / len(done)
    if ctx.trace:
        ctx.trace_doc = ctx.mgr.profile_result(timeout=120)
        ev = [float(e["ts"]) for e in ctx.trace_doc.get("traceEvents", [])
              if e.get("ph") == "X" and "ts" in e]
        lo = min(ev)
        ctx.trace_span = (lo, lo + ctx.data["capture_s"] * 1e6)
    harness.note(jobs=len(jobs), completed=len(done), window_s=window_s,
                 job_seconds=[j["t1"] - j["t0"] for j in jobs],
                 errors=[j["error"] for j in jobs if j["doc"] is None])


def collect(ctx) -> None:
    pass


def cleanup(ctx) -> None:
    pass


def check(ctx) -> dict:
    """Hold a seed-drawn sample of the window's completed jobs against
    the plain reference of the job."""
    done = [j for j in ctx.data["jobs"] if j["doc"] is not None]
    rng = np.random.default_rng([ctx.seed, 7])
    k = min(int(ctx.traffic["compare_jobs"]), len(done))
    sample = [done[i] for i in sorted(rng.choice(len(done), k,
                                                 replace=False))]
    ref = harness.load_module(harness.PB / "reference"
                              / f"{ctx.traffic['job']}.py")
    return ref.check(ctx, [j["doc"].get("stats", []) for j in sample])


def stored_rows(ctx):
    """(round, connection) of every flow the store holds, in post
    order."""
    blocks = [b for _, b in ctx.data["blocks"]]
    return (np.concatenate([b.rounds for b in blocks]),
            np.concatenate([b.conns for b in blocks]))


def thr_of(conns, rounds, rows) -> np.ndarray:
    x = np.empty(len(rows), np.int64)
    for r in np.unique(rounds):
        at = rounds == r
        x[at] = conns.throughput(int(r))[rows[at]]
    return x


def job_trace_stats(ctx) -> Dict[str, float]:
    """Device busy seconds in the capture and the jobs' seconds there."""
    dev = harness.trace_device_events(ctx.trace_doc)
    lo, hi = ctx.trace_span
    return {"busy_s": harness.busy_us(dev, lo, hi) / 1e6,
            "jobs_s": sum(j["t1"] - j["t0"] for j in ctx.data["jobs"]),
            "jobs": len([j for j in ctx.data["jobs"]
                         if j["doc"] is not None])}
