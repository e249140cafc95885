"""Traffic kind `ingest_closed`: Flow Aggregator exporters posting TBLK
blocks to `POST /ingest` in a closed loop.

The deployment's Flow Aggregator (the configuration's `flow_aggregator`)
sets the shape: one exporter a replica, and a block of what one commit
holds, the rows that arrive in `commit_interval_s` when every
connection exports once an `active_flow_record_timeout_s`. A mix may
set `streams` and `block_rows` itself. Each exporter owns the
connections whose key hash falls to it and posts their records round
by round (every active connection exports once a round), each block's
next only after its ack. Set-up posts `setup_rounds` full rounds; the
window continues the same sequences. A generator thread in this
process encodes the set-up's blocks and the window's (as many as
`max_rows_per_s` would take, up to LOOKAHEAD) before the window starts,
and then rests: it encodes in the window only for a stream that found
its queue empty, and how long a stream waited for it is reported.

End-to-end: `ingest_rows_per_s` (rows of the acks received in the
window ÷ its seconds) and `ack_p90_ms` (90th percentile of every ack
received in the window, send to ack, from the client).

Correct: every block acked and scored in full (not degraded, refused
or a duplicate); every acked row stored (tableInfo's totalRows) and
read back by source namespace equal to what was sent (`POST /query`);
the count of connection-anomaly alerts equal to the plain detector's
over every scored row; every described alert in `GET /alerts` one of
its alerts.
"""

from __future__ import annotations

import collections
import http.client
import json
import math
import os
import threading
import time
from typing import Dict, List

import numpy as np

from portbench import flowgen, harness
from portbench.reference import ingest as ref

TABLE_INFO = "/apis/stats.theia.antrea.io/v1alpha1/clickhouse/tableInfo"
#: blocks encoded ahead of the streams at most
LOOKAHEAD = 1024
#: the readback's aggregates (POST /query), by source namespace
READBACK = [
    "count", "sum:octetDeltaCount", "sum:packetDeltaCount",
    "sum:throughput", "sum:sourceTransportPort",
    "sum:destinationTransportPort", "sum:flowEndSeconds",
    "min:flowEndSeconds", "max:flowEndSeconds"]


class Stream:
    """One exporter: its queue of encoded blocks and what became of
    each block it sent."""

    def __init__(self, index: int) -> None:
        self.index = index
        self.queue: collections.deque = collections.deque()
        #: (seq, block, outcome, t_send, t_ack, rows); outcome is
        #: "acked", "degraded", "duplicate", "refused" or "error"
        self.sent: List[tuple] = []
        self.supply_wait_s = 0.0
        self.exhausted = False
        self.rows_sent = 0


class Supply:
    """Encodes the streams' blocks on a thread of this process."""

    def __init__(self, conns, n_streams: int, block_rows: int,
                 budget: int) -> None:
        self.streams = [Stream(i) for i in range(n_streams)]
        self.cv = threading.Condition()
        self.done = False
        self.stop = False
        #: blocks the generator may encode; raised only for a stream
        #: that finds its queue empty
        self.budget = budget
        self.encoded = 0
        self._it = flowgen.stream_blocks(conns, n_streams, block_rows)
        self.thread = threading.Thread(target=self._run, daemon=True,
                                       name="block-supply")
        self.thread.start()

    def _run(self) -> None:
        try:
            for s, blk in self._it:
                with self.cv:
                    self.streams[s].queue.append(blk)
                    self.encoded += 1
                    self.cv.notify_all()
                    while ((self.encoded >= self.budget or sum(
                            len(x.queue) for x in self.streams)
                            >= LOOKAHEAD) and not self.stop):
                        self.cv.wait(0.5)
                    if self.stop:
                        return
        finally:
            with self.cv:
                self.done = True
                self.cv.notify_all()

    def fill(self, blocks: int, timeout: float = 300.0) -> None:
        """Wait until `blocks` blocks are encoded ahead (or the rounds
        are spent), so that the window's supply is ready before it
        starts."""
        deadline = time.monotonic() + timeout
        with self.cv:
            while (sum(len(x.queue) for x in self.streams) < blocks
                   and not self.done and time.monotonic() < deadline):
                self.cv.wait(0.5)

    def next(self, st: Stream):
        """The stream's next block, waiting for the generator if need
        be; None when its rounds are spent."""
        t0 = time.perf_counter()
        with self.cv:
            if not st.queue and not self.done:
                self.budget = self.encoded + len(self.streams)
                self.cv.notify_all()
            while not st.queue and not self.done:
                self.cv.wait(0.5)
            blk = st.queue.popleft() if st.queue else None
            self.cv.notify_all()
        st.supply_wait_s += time.perf_counter() - t0
        return blk

    def close(self) -> None:
        with self.cv:
            self.stop = True
            self.cv.notify_all()
        self.thread.join(30)


def _post(conn: http.client.HTTPConnection, st: Stream, seq: int,
          payload: bytes):
    conn.request("POST", f"/ingest?stream=exporter-{st.index}&seq={seq}",
                 body=payload,
                 headers={"Content-Type": "application/octet-stream"})
    resp = conn.getresponse()
    return resp.status, resp.read()


def _drive(ctx, supply: Supply, st: Stream, until, stop_rows=None):
    """Post the stream's blocks one after another until `until()` says
    stop (or `stop_rows` rows are sent); record each outcome."""
    mgr = ctx.mgr
    conn = http.client.HTTPConnection("127.0.0.1", mgr.port, timeout=300)
    try:
        while not until() and (stop_rows is None
                               or st.rows_sent < stop_rows):
            blk = supply.next(st)
            if blk is None:
                st.exhausted = True
                return
            seq = len(st.sent)
            t_send = time.perf_counter()
            try:
                status, raw = _post(conn, st, seq, blk.payload)
            except (OSError, http.client.HTTPException):
                conn.close()
                conn = http.client.HTTPConnection(
                    "127.0.0.1", mgr.port, timeout=300)
                status, raw = 0, b""
            t_ack = time.perf_counter()
            rows = len(blk.conns)
            st.rows_sent += rows
            if status == 200:
                ack = json.loads(raw)
                outcome = ("duplicate" if ack.get("duplicate") else
                           "degraded" if ack.get("degraded") else "acked")
                if ack.get("rows") != rows:
                    outcome = "error"
            elif status in (429, 503):
                outcome = "refused"
            else:
                outcome = "error"
            blk.payload = None
            st.sent.append((seq, blk, outcome, t_send, t_ack, rows))
    finally:
        conn.close()


def _run_streams(ctx, supply, until, stop_rows=None) -> None:
    threads = [threading.Thread(
        target=_drive, args=(ctx, supply, st, until,
                             None if stop_rows is None else stop_rows[i]),
        name=f"exporter-{i}") for i, st in enumerate(supply.streams)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()


def shape(config: dict, traffic: dict):
    """(exporters, rows a block): the mix's own, or the deployment's."""
    fa = config["flow_aggregator"]
    n = int(config["cluster"]["n_series"])
    streams = int(traffic.get("streams", fa["replicas"]))
    rows = int(traffic.get("block_rows", round(
        n * fa["commit_interval_s"] / fa["active_flow_record_timeout_s"])))
    return streams, rows


def prepare(ctx) -> None:
    t = ctx.traffic
    cluster = ctx.config["cluster"]
    s = int(cluster["n_series"])
    streams, block_rows = shape(ctx.config, t)
    ctx.data["block_rows"] = block_rows
    setup_rounds = int(t["setup_rounds"])
    # rounds enough for four times the rate the mix expects at most;
    # a round is encoded only when a stream reaches it
    rounds = setup_rounds + math.ceil(
        4 * float(t["max_rows_per_s"]) * ctx.seconds / s) + 2
    conns = flowgen.Connections(cluster, ctx.seed, rounds,
                                (setup_rounds, rounds))
    ctx.data["conns"] = conns
    # the set-up's blocks (each stream's last one may be partial) and
    # the window's
    ahead = (math.ceil(s * setup_rounds / block_rows) + streams
             + window_blocks(ctx, block_rows))
    ctx.data["supply"] = Supply(conns, streams, block_rows, ahead)


def window_blocks(ctx, block_rows: int) -> int:
    """The blocks the window may take at the most rows a second the
    mix expects."""
    return min(LOOKAHEAD, math.ceil(
        float(ctx.traffic["max_rows_per_s"]) * ctx.seconds / block_rows))


def setup(ctx) -> None:
    health = ctx.mgr.get_json("/healthz")
    ctx.notes["engine"] = health.get("ingest", {}).get("engine")
    supply = ctx.data["supply"]
    conns = ctx.data["conns"]
    owner = (conns.key_hash() % np.uint64(len(supply.streams)))
    rows = [int(np.count_nonzero(owner == i)) * int(
        ctx.traffic["setup_rounds"]) for i in range(len(supply.streams))]
    t0 = time.perf_counter()
    _run_streams(ctx, supply, lambda: False, rows)
    ctx.notes["setup_post_s"] = time.perf_counter() - t0
    ctx.data["setup_blocks"] = [len(st.sent) for st in supply.streams]
    # the window's blocks, encoded before it starts, so that no
    # encoding competes with it
    t0 = time.perf_counter()
    supply.fill(window_blocks(ctx, ctx.data["block_rows"]))
    ctx.notes["supply_fill_s"] = time.perf_counter() - t0


def window(ctx) -> None:
    supply = ctx.data["supply"]
    t0 = time.perf_counter()
    t_end = t0 + ctx.seconds
    waits0 = [st.supply_wait_s for st in supply.streams]
    encoded0 = supply.encoded
    prof: Dict[str, object] = {}
    side = None
    if ctx.trace:
        d = min(8.0, ctx.seconds / 2)

        def capture():
            time.sleep(ctx.seconds / 4)
            prof["trace"] = ctx.mgr.profile(d)
            prof["seconds"] = d
        side = threading.Thread(target=capture, name="capture")
        side.start()
    _run_streams(ctx, supply, lambda: time.perf_counter() >= t_end)
    if side is not None:
        side.join()
        ctx.trace_doc = prof["trace"]
        dev = [(float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)))
               for e in ctx.trace_doc.get("traceEvents", [])
               if e.get("ph") == "X" and "ts" in e]
        lo = min(s for s, _ in dev)
        ctx.trace_span = (lo, lo + prof["seconds"] * 1e6)
    acks, rows = [], 0
    slices = [0] * max(1, math.ceil(ctx.seconds / 5))
    outcomes: collections.Counter = collections.Counter()
    for st in supply.streams:
        for seq, blk, outcome, ts, ta, n in st.sent[
                ctx.data["setup_blocks"][st.index]:]:
            if ta <= t_end:
                outcomes[outcome] += 1
            if ta <= t_end and outcome == "acked":
                acks.append(ta - ts)
                rows += n
                slices[min(len(slices) - 1, int((ta - t0) // 5))] += n
    ctx.data["window_acks"] = len(acks)
    ctx.data["window_outcomes"] = outcomes
    ctx.e2e["ingest_rows_per_s"] = rows / ctx.seconds
    if acks:
        ctx.e2e["ack_p90_ms"] = harness.percentile(acks, 90) * 1e3
    harness.note(window_acks=len(acks), window_rows=rows,
                 rows_per_5s=slices,
                 supply_wait_s=[st.supply_wait_s - w for st, w in
                                zip(supply.streams, waits0)],
                 encoded_in_window=supply.encoded - encoded0,
                 exhausted=[st.exhausted for st in supply.streams])


def collect(ctx) -> None:
    mgr = ctx.mgr
    supply = ctx.data["supply"]
    sent = [x for st in supply.streams for x in st.sent]
    ctx.data["attempted"] = len(sent)
    ctx.data["failed"] = sum(1 for x in sent if x[2] != "acked")
    doc = mgr.get_json(TABLE_INFO)
    ctx.data["total_rows"] = next(int(t["totalRows"])
                                  for t in doc["tableInfos"]
                                  if t["tableName"] == "flows")
    ctx.data["readback"] = mgr.send_json("POST", "/query", {
        "groupBy": ["sourcePodNamespace"], "aggregates": READBACK,
        "k": 0, "cache": False, "rollup": False})
    ctx.data["ring"] = mgr.get_json("/alerts?limit=100000")["alerts"]
    ctx.data["conn_alerts"] = ctx.prom1.get(
        ("theia_ingest_alerts_total", (("kind", "connection_anomaly"),)),
        0.0)
    health = mgr.get_json("/healthz")
    ctx.notes["wal"] = health.get("wal")
    ctx.notes["admission"] = health.get("admission")
    ctx.notes["outcomes"] = dict(collections.Counter(x[2] for x in sent))
    disk = 0
    for root, _dirs, files in os.walk(ctx.workdir):
        for f in files:
            try:
                disk += os.path.getsize(os.path.join(root, f))
            except OSError:
                pass
    acked_rows = sum(x[5] for x in sent if x[2] in ("acked", "degraded"))
    ctx.notes["disk_bytes"] = disk
    ctx.notes["bytes_per_acked_row"] = disk / max(acked_rows, 1)
    harness.note(**{k: v for k, v in ctx.notes.items()})


def cleanup(ctx) -> None:
    supply = ctx.data.get("supply")
    if supply is not None:
        supply.close()


def _rows_of(blocks) -> tuple:
    if not blocks:
        return np.zeros(0, np.int32), np.zeros(0, np.int32)
    return (np.concatenate([b.rounds for b in blocks]),
            np.concatenate([b.conns for b in blocks]))


def reference_inputs(ctx) -> dict:
    """The rows the store must hold and the rows the detector scored, in
    the order each stream sent them."""
    supply = ctx.data["supply"]
    stored = [x[1] for st in supply.streams for x in st.sent
              if x[2] in ("acked", "degraded")]
    scored = [x[1] for st in supply.streams for x in st.sent
              if x[2] == "acked"]
    return {"stored": _rows_of(stored), "scored": _rows_of(scored)}


def detector_reference(conns, rounds, rows, dtype="float32"):
    """(anomaly flag of each scored row, key id of each row)."""
    kid, n_keys = ref.key_ids(conns)
    cache: Dict[int, np.ndarray] = {}

    def thr(r):
        if r not in cache:
            cache[r] = conns.throughput(r)
        return cache[r]
    x = np.empty(len(rows), np.int64)
    for r in np.unique(rounds):
        at = rounds == r
        x[at] = thr(int(r))[rows[at]]
    return ref.detector_flags(kid[rows], x, n_keys, dtype), kid, x


def check(ctx) -> dict:
    conns = ctx.data["conns"]
    lim = ctx.traffic["limits"]
    inp = reference_inputs(ctx)
    s_rounds, s_rows = inp["stored"]
    checks = {}
    checks["blocks_unscored"] = {"value": ctx.data["failed"],
                                 "limit": lim["blocks_unscored"]}
    checks["rows_lost"] = {"value": abs(len(s_rows)
                                        - ctx.data["total_rows"]),
                           "limit": lim["rows_lost"]}
    want = ref.store_groups(conns, s_rounds, s_rows, conns.throughput)
    checks["readback_differ"] = {
        "value": readback_differ(ctx.data["readback"], want),
        "limit": lim["readback_differ"]}
    r_rounds, r_rows = inp["scored"]
    flags, kid, x = detector_reference(conns, r_rounds, r_rows)
    checks["conn_alerts_differ"] = {
        "value": abs(int(ctx.data["conn_alerts"]) - int(flags.sum())),
        "limit": lim["conn_alerts_differ"]}
    checks["ring_alerts_unmatched"] = {
        "value": ring_unmatched(ctx.data["ring"], conns, kid, r_rounds,
                                r_rows, x, flags),
        "limit": lim["ring_alerts_unmatched"]}
    harness.note(reference_alerts=int(flags.sum()),
                 program_alerts=ctx.data["conn_alerts"],
                 stored_rows=len(s_rows), scored_rows=len(r_rows))
    return checks


def readback_differ(doc: dict, want: Dict[str, Dict[str, int]]) -> int:
    """Cells of the readback (group × aggregate) that differ from the
    reference, groups missing on either side counted whole."""
    got: Dict[str, Dict[str, int]] = {}
    for row in doc.get("rows", []):
        name = str(row.get("sourcePodNamespace"))
        got[name] = {_label(k): v for k, v in row.items()
                     if k != "sourcePodNamespace"}
    differ = 0
    for g in set(got) | set(want):
        a, b = got.get(g, {}), want.get(g, {})
        for k in set(b):
            if a.get(k) is None or int(a[k]) != b[k]:
                differ += 1
    return differ


def _label(k: str) -> str:
    # "sum(octetDeltaCount)" / "sum_octetDeltaCount" → sum_octetDeltaCount
    return k.replace("(", "_").replace(")", "").replace(":", "_")


def ring_unmatched(ring, conns, kid, rounds, rows, x, flags) -> int:
    """Described connection alerts of the ring that the reference does
    not flag (matched by key strings, flowEndSeconds and throughput)."""
    sip_t, sip = conns.strings["sourceIP"]
    dip_t, dip = conns.strings["destinationIP"]
    by_key: Dict[tuple, int] = {}
    for c in range(conns.n):
        by_key.setdefault((sip_t[sip[c]].decode(), int(conns.src_port[c]),
                           dip_t[dip[c]].decode(),
                           int(conns.dst_port[c])), int(kid[c]))
    interval = int(conns.p["interval_seconds"])
    start = int(conns.p["start_time"])
    flagged = set(zip(kid[rows][flags].tolist(),
                      rounds[flags].astype(np.int64).tolist(),
                      x[flags].tolist()))
    unmatched = 0
    for a in ring:
        if "slot" not in a or "sourceIP" not in a:
            continue
        k = by_key.get((a["sourceIP"], int(a["sourceTransportPort"]),
                        a["destinationIP"],
                        int(a["destinationTransportPort"])))
        r = (int(a["flowEndSeconds"]) - start) // interval
        if k is None or (k, r, int(a["throughput"])) not in flagged:
            unmatched += 1
    return unmatched
