"""`theia` — the command line interface (python -m theia_tpu_torch.cli).

Re-provides the reference's cobra CLI (pkg/theia/commands/): the same
command tree, flag names and output shapes, talking to the manager REST
API. Where the reference port-forwards into the cluster
(pkg/theia/portforwarder), this CLI takes --manager-addr (default
http://127.0.0.1:11347).

  theia policy-recommendation  run|status|retrieve|list|delete   (alias pr)
  theia throughput-anomaly-detection ...                        (alias tad)
  theia clickhouse status [--diskInfo --tableInfo --insertRate
                           --stackTraces]
  theia supportbundle
  theia version

`run --wait` polls job status every 5 s like the reference
(pkg/theia/commands/config/config.go StatusCheckPollInterval; loop at
policy_recommendation_run.go:223-259).
"""

from __future__ import annotations

import argparse
import datetime
import json
import os
import ssl
import sys
import time
import urllib.error
import urllib.parse
import urllib.request
import uuid
from typing import Dict, Optional

from ..utils import (
    AGG_FLOWS,
    POLICY_TYPES,
    TAD_ALGOS,
    get_manager_addr,
    validate_k8s_quantity,
)
from ..utils.backoff import capped_backoff

DEFAULT_ADDR = "http://127.0.0.1:11347"
GROUP = "/apis/intelligence.theia.antrea.io/v1alpha1"
POLL_INTERVAL = 5.0
POLL_TIMEOUT = 3600.0

NPR_RESOURCE = "networkpolicyrecommendations"
TAD_RESOURCE = "throughputanomalydetectors"
DD_RESOURCE = "trafficdropdetections"
FPM_RESOURCE = "flowpatternminings"
SAD_RESOURCE = "spatialanomalydetections"

TIME_FORMAT = "%Y-%m-%d %H:%M:%S"


class APIError(SystemExit):
    pass


class APIConnectionError(APIError):
    """Transient transport-level failure (connection refused/reset,
    timeout, HTTP 503): worth retrying inside a poll loop, fatal
    everywhere a human is waiting on one answer."""


class APIRetryAfterError(APIConnectionError):
    """HTTP 429: the manager is over CAPACITY (not down) and said when
    to come back. `retry_after` carries the server's hint; poll loops
    treat it like any transient failure, the ingest client honors the
    hint precisely."""

    retry_after = 1.0


_CA_CERT = ""
_TOKEN = ""


def _url_context():
    if not _CA_CERT:
        return None
    return ssl.create_default_context(cafile=_CA_CERT)


def _auth_headers() -> Dict[str, str]:
    """Bearer token for an authenticated manager (the reference CLI
    reads a ServiceAccount token Secret and sends it the same way,
    pkg/theia/commands/utils.go:122-144)."""
    return {"Authorization": f"Bearer {_TOKEN}"} if _TOKEN else {}


def _urlopen(addr: str, req: urllib.request.Request,
             timeout: float = 30) -> bytes:
    """Open a manager request, classifying failures into
    APIError/APIConnectionError (the one place the taxonomy lives)."""
    try:
        with urllib.request.urlopen(req, timeout=timeout,
                                    context=_url_context()) as resp:
            return resp.read()
    except urllib.error.HTTPError as e:
        body = e.read().decode(errors="replace")
        detail = body
        try:
            detail = json.loads(body).get("message", body)
        except Exception:
            pass
        if e.code == 429:
            from ..ingest.client import parse_retry_after
            err = APIRetryAfterError(
                f"error: manager over capacity (429): {detail}")
            err.retry_after = parse_retry_after(e.headers, body)
            raise err
        cls = APIConnectionError if e.code == 503 else APIError
        raise cls(f"error: {e.code} from manager: {detail}")
    except urllib.error.URLError as e:
        # covers socket.timeout too (URLError wraps it) — but a TLS
        # failure (bad CA, hostname mismatch) is permanent: retrying
        # it for the whole poll window would bury the real reason
        cls = (APIError if isinstance(e.reason, ssl.SSLError)
               else APIConnectionError)
        raise cls(
            f"error: cannot reach theia-manager at {addr}: {e.reason}")


def _request(addr: str, method: str, path: str,
             body: Optional[Dict] = None) -> Dict:
    req = urllib.request.Request(
        addr + path, method=method,
        data=json.dumps(body).encode() if body is not None else None,
        headers={"Content-Type": "application/json",
                 **_auth_headers()})
    raw = _urlopen(addr, req)
    return json.loads(raw) if raw else {}


def _poll_request(addr: str, path: str, deadline: float) -> Dict:
    """GET with transient retry: a poll loop that has been waiting on
    a job for minutes must not die to a single connection blip or a
    503 (manager restarting, replicas resyncing). Capped exponential
    backoff, bounded by the caller's overall poll deadline."""
    attempt = 0
    while True:
        try:
            return _request(addr, "GET", path)
        except APIConnectionError as e:
            attempt += 1
            backoff = capped_backoff(1.0, 30.0, attempt)
            if time.time() + backoff > deadline:
                raise
            print(f"warning: {e}; retrying in {backoff:.0f}s",
                  file=sys.stderr)
            time.sleep(backoff)


def _parse_time_arg(value: str, flag: str) -> Optional[int]:
    if not value:
        return None
    try:
        dt = datetime.datetime.strptime(value, TIME_FORMAT)
    except ValueError:
        raise SystemExit(
            f"error: {flag} should be in '{TIME_FORMAT}' format")
    return int(dt.replace(tzinfo=datetime.timezone.utc).timestamp())


def _wait_for_job(addr: str, resource: str, name: str) -> Dict:
    deadline = time.time() + POLL_TIMEOUT
    while time.time() < deadline:
        doc = _poll_request(addr, f"{GROUP}/{resource}/{name}",
                            deadline)
        state = (doc.get("status") or {}).get("state", "")
        if state in ("COMPLETED", "FAILED"):
            return doc
        time.sleep(POLL_INTERVAL)
    raise APIError(f"error: timed out waiting for job {name}")


def _print_job_table(items) -> None:
    fmt = "{:<44} {:<10} {:<10} {}"
    print(fmt.format("NAME", "STATE", "PROGRESS", "ERROR"))
    for doc in items:
        st = doc.get("status") or {}
        progress = f"{st.get('completedStages', 0)}/" \
                   f"{st.get('totalStages', 0)}"
        print(fmt.format(doc["metadata"]["name"], st.get("state", ""),
                         progress, st.get("errorMsg", "")))


def _sizing_body(args) -> Dict[str, object]:
    """Resource-sizing spec fields (reference CRD spec,
    pkg/apis/crd/v1alpha1/types.go)."""
    return {
        "executorInstances": args.executor_instances,
        "driverCoreRequest": args.driver_core_request,
        "driverMemory": args.driver_memory,
        "executorCoreRequest": args.executor_core_request,
        "executorMemory": args.executor_memory,
    }


# -- policy-recommendation ----------------------------------------------

def npr_run(args) -> None:
    name = "pr-" + str(uuid.uuid4())
    body = {
        "metadata": {"name": name},
        "jobType": args.type,
        "limit": args.limit,
        "policyType": args.policy_type,
        "startInterval": _parse_time_arg(args.start_time, "start-time"),
        "endInterval": _parse_time_arg(args.end_time, "end-time"),
        "nsAllowList": json.loads(args.ns_allow_list)
        if args.ns_allow_list else None,
        "excludeLabels": args.exclude_labels,
        "toServices": args.to_services,
        **_sizing_body(args),
    }
    body = {k: v for k, v in body.items() if v is not None}
    _request(args.manager_addr, "POST", f"{GROUP}/{NPR_RESOURCE}", body)
    print(f"Successfully created policy recommendation job with name "
          f"{name}")
    if args.wait:
        doc = _wait_for_job(args.manager_addr, NPR_RESOURCE, name)
        st = doc.get("status") or {}
        if st.get("state") == "FAILED":
            raise APIError(
                f"error: job failed: {st.get('errorMsg', '')}")
        outcome = st.get("recommendationOutcome", "")
        if args.file:
            with open(args.file, "w") as f:
                f.write(outcome)
            print(f"Recommendation written to {args.file}")
        else:
            print(outcome)


def npr_status(args) -> None:
    doc = _request(args.manager_addr, "GET",
                   f"{GROUP}/{NPR_RESOURCE}/{args.name}")
    st = doc.get("status") or {}
    print(f"Status of this policy recommendation job is "
          f"{st.get('state', '')}")
    if st.get("state") == "RUNNING":
        print(f"Completed stages: {st.get('completedStages', 0)}/"
              f"{st.get('totalStages', 0)}")


def npr_retrieve(args) -> None:
    doc = _request(args.manager_addr, "GET",
                   f"{GROUP}/{NPR_RESOURCE}/{args.name}")
    outcome = (doc.get("status") or {}).get("recommendationOutcome", "")
    if args.file:
        with open(args.file, "w") as f:
            f.write(outcome)
        print(f"Recommendation written to {args.file}")
    else:
        print(outcome)


def npr_list(args) -> None:
    doc = _request(args.manager_addr, "GET", f"{GROUP}/{NPR_RESOURCE}")
    _print_job_table(doc.get("items", []))


def npr_delete(args) -> None:
    _request(args.manager_addr, "DELETE",
             f"{GROUP}/{NPR_RESOURCE}/{args.name}")
    print(f"Successfully deleted policy recommendation job with name "
          f"{args.name}")


# -- throughput-anomaly-detection ---------------------------------------

def tad_run(args) -> None:
    name = "tad-" + str(uuid.uuid4())
    body = {
        "metadata": {"name": name},
        "jobType": args.algo,
        "startInterval": _parse_time_arg(args.start_time, "start-time"),
        "endInterval": _parse_time_arg(args.end_time, "end-time"),
        "nsIgnoreList": json.loads(args.ns_ignore_list)
        if args.ns_ignore_list else None,
        "aggFlow": args.agg_flow or None,
        "podLabel": args.pod_label or None,
        "podName": args.pod_name or None,
        "podNameSpace": args.pod_namespace or None,
        "externalIp": args.external_ip or None,
        "servicePortName": args.svc_port_name or None,
        "clusterUUID": args.cluster_uuid or None,
        # refitEvery=1 is the server default; 0 (auto) must survive the
        # None-filter below, so only drop the default.
        "refitEvery": args.refit_every
        if args.refit_every != 1 else None,
        **_sizing_body(args),
    }
    body = {k: v for k, v in body.items() if v is not None}
    _request(args.manager_addr, "POST", f"{GROUP}/{TAD_RESOURCE}", body)
    print(f"Successfully started Throughput Anomaly Detection job with "
          f"name: {name}")
    if args.wait:
        doc = _wait_for_job(args.manager_addr, TAD_RESOURCE, name)
        st = doc.get("status") or {}
        if st.get("state") == "FAILED":
            raise APIError(
                f"error: job failed: {st.get('errorMsg', '')}")
        _print_tad_stats(doc.get("stats", []))


def _print_table(rows, cols) -> None:
    """Column-aligned table; cells are newline-stripped and truncated."""
    def cell(r, c):
        return str(r.get(c, "")).replace("\n", " ")[:80]

    widths = {c: max(len(c), *(len(cell(r, c)) for r in rows))
              for c in cols}
    print("  ".join(c.ljust(widths[c]) for c in cols))
    for r in rows:
        print("  ".join(cell(r, c).ljust(widths[c]) for c in cols))


def _print_tad_stats(stats) -> None:
    if not stats:
        print("No anomalies found")
        return
    _print_table(stats, [
        "id", "sourceIP", "sourceTransportPort", "destinationIP",
        "destinationTransportPort", "flowEndSeconds", "throughput",
        "aggType", "algoType", "anomaly"])


def tad_status(args) -> None:
    doc = _request(args.manager_addr, "GET",
                   f"{GROUP}/{TAD_RESOURCE}/{args.name}")
    st = doc.get("status") or {}
    print(f"Status of this anomaly detection job is "
          f"{st.get('state', '')}")
    if st.get("state") == "RUNNING":
        print(f"Completed stages: {st.get('completedStages', 0)}/"
              f"{st.get('totalStages', 0)}")


def tad_retrieve(args) -> None:
    doc = _request(args.manager_addr, "GET",
                   f"{GROUP}/{TAD_RESOURCE}/{args.name}")
    stats = doc.get("stats", [])
    if args.file:
        with open(args.file, "w") as f:
            json.dump(stats, f, indent=2)
        print(f"Anomalies written to {args.file}")
    else:
        _print_tad_stats(stats)


def tad_list(args) -> None:
    doc = _request(args.manager_addr, "GET", f"{GROUP}/{TAD_RESOURCE}")
    _print_job_table(doc.get("items", []))


def tad_delete(args) -> None:
    _request(args.manager_addr, "DELETE",
             f"{GROUP}/{TAD_RESOURCE}/{args.name}")
    print(f"Successfully deleted Throughput Anomaly Detection job with "
          f"name: {args.name}")


# -- drop-detection (theia-sf drop-detection equivalent) ----------------

def _print_dd_stats(stats) -> None:
    if not stats:
        print("No abnormal traffic drops found")
        return
    _print_table(stats, [
        "id", "endpoint", "direction", "avgDrop", "stdevDrop",
        "anomalyDropDate", "anomalyDropNumber"])


def dd_run(args) -> None:
    name = "dd-" + str(uuid.uuid4())
    body = {
        "metadata": {"name": name},
        "jobType": args.type,
        "startInterval": _parse_time_arg(args.start_time, "start-time"),
        "endInterval": _parse_time_arg(args.end_time, "end-time"),
        "clusterUUID": args.cluster_uuid or None,
    }
    body = {k: v for k, v in body.items() if v is not None}
    _request(args.manager_addr, "POST", f"{GROUP}/{DD_RESOURCE}", body)
    print(f"Successfully started traffic drop detection job with "
          f"name: {name}")
    if args.wait:
        doc = _wait_for_job(args.manager_addr, DD_RESOURCE, name)
        st = doc.get("status") or {}
        if st.get("state") == "FAILED":
            raise APIError(
                f"error: job failed: {st.get('errorMsg', '')}")
        _print_dd_stats(doc.get("stats", []))


def dd_status(args) -> None:
    doc = _request(args.manager_addr, "GET",
                   f"{GROUP}/{DD_RESOURCE}/{args.name}")
    st = doc.get("status") or {}
    print(f"Status of this traffic drop detection job is "
          f"{st.get('state', '')}")
    if st.get("state") == "RUNNING":
        print(f"Completed stages: {st.get('completedStages', 0)}/"
              f"{st.get('totalStages', 0)}")


def dd_retrieve(args) -> None:
    doc = _request(args.manager_addr, "GET",
                   f"{GROUP}/{DD_RESOURCE}/{args.name}")
    stats = doc.get("stats", [])
    if args.file:
        with open(args.file, "w") as f:
            json.dump(stats, f, indent=2)
        print(f"Drop anomalies written to {args.file}")
    else:
        _print_dd_stats(stats)


def dd_list(args) -> None:
    doc = _request(args.manager_addr, "GET", f"{GROUP}/{DD_RESOURCE}")
    _print_job_table(doc.get("items", []))


def dd_delete(args) -> None:
    _request(args.manager_addr, "DELETE",
             f"{GROUP}/{DD_RESOURCE}/{args.name}")
    print(f"Successfully deleted traffic drop detection job with "
          f"name: {args.name}")


# -- pattern mining (north-star FP-Growth config; no reference CLI) -----

def _print_fpm_stats(stats) -> None:
    if not stats:
        print("No frequent patterns found")
        return
    _print_table(stats, ["id", "items", "itemsetLength", "support"])


def fpm_run(args) -> None:
    name = "fpm-" + str(uuid.uuid4())
    body = {
        "metadata": {"name": name},
        "minSupport": args.min_support or None,
        "maxLen": args.max_len,
        "columns": [c.strip() for c in args.columns.split(",")
                    if c.strip()] or None,
        "startInterval": _parse_time_arg(args.start_time, "start-time"),
        "endInterval": _parse_time_arg(args.end_time, "end-time"),
    }
    body = {k: v for k, v in body.items() if v is not None}
    _request(args.manager_addr, "POST", f"{GROUP}/{FPM_RESOURCE}", body)
    print(f"Successfully started flow pattern mining job with "
          f"name: {name}")
    if args.wait:
        doc = _wait_for_job(args.manager_addr, FPM_RESOURCE, name)
        st = doc.get("status") or {}
        if st.get("state") == "FAILED":
            raise APIError(
                f"error: job failed: {st.get('errorMsg', '')}")
        _print_fpm_stats(doc.get("stats", []))


def _simple_actions(resource, label, print_stats):
    """status/retrieve/list/delete handlers for a job resource."""

    def status(args):
        doc = _request(args.manager_addr, "GET",
                       f"{GROUP}/{resource}/{args.name}")
        st = doc.get("status") or {}
        print(f"Status of this {label} job is {st.get('state', '')}")
        if st.get("state") == "RUNNING":
            print(f"Completed stages: {st.get('completedStages', 0)}/"
                  f"{st.get('totalStages', 0)}")

    def retrieve(args):
        doc = _request(args.manager_addr, "GET",
                       f"{GROUP}/{resource}/{args.name}")
        stats = doc.get("stats", [])
        if args.file:
            with open(args.file, "w") as f:
                json.dump(stats, f, indent=2)
            print(f"Results written to {args.file}")
        else:
            print_stats(stats)

    def list_(args):
        doc = _request(args.manager_addr, "GET", f"{GROUP}/{resource}")
        _print_job_table(doc.get("items", []))

    def delete(args):
        _request(args.manager_addr, "DELETE",
                 f"{GROUP}/{resource}/{args.name}")
        print(f"Successfully deleted {label} job with name: "
              f"{args.name}")

    return status, retrieve, list_, delete


fpm_status, fpm_retrieve, fpm_list, fpm_delete = _simple_actions(
    FPM_RESOURCE, "flow pattern mining", _print_fpm_stats)


# -- spatial anomaly detection (north-star spatial-DBSCAN config) -------

def _print_sad_stats(stats) -> None:
    if not stats:
        print("No spatial anomalies found")
        return
    _print_table(stats, ["id", "sourceIP", "destinationIP",
                         "destinationTransportPort", "octetDeltaCount"])


def sad_run(args) -> None:
    name = "sad-" + str(uuid.uuid4())
    body = {
        "metadata": {"name": name},
        "eps": args.eps,
        "minSamples": args.min_samples,
        "startInterval": _parse_time_arg(args.start_time, "start-time"),
        "endInterval": _parse_time_arg(args.end_time, "end-time"),
    }
    body = {k: v for k, v in body.items() if v is not None}
    _request(args.manager_addr, "POST", f"{GROUP}/{SAD_RESOURCE}", body)
    print(f"Successfully started spatial anomaly detection job with "
          f"name: {name}")
    if args.wait:
        doc = _wait_for_job(args.manager_addr, SAD_RESOURCE, name)
        st = doc.get("status") or {}
        if st.get("state") == "FAILED":
            raise APIError(
                f"error: job failed: {st.get('errorMsg', '')}")
        _print_sad_stats(doc.get("stats", []))


sad_status, sad_retrieve, sad_list, sad_delete = _simple_actions(
    SAD_RESOURCE, "spatial anomaly detection", _print_sad_stats)


# -- clickhouse / supportbundle / version -------------------------------

def clickhouse_status(args) -> None:
    components = [c for c, on in (
        ("diskInfo", args.diskInfo), ("tableInfo", args.tableInfo),
        ("insertRate", args.insertRate),
        ("stackTraces", args.stackTraces),
        ("deviceInfo", args.deviceInfo)) if on]
    if not components:
        components = ["diskInfo", "tableInfo", "insertRate"]
    for comp in components:
        doc = _request(args.manager_addr, "GET",
                       "/apis/stats.theia.antrea.io/v1alpha1/"
                       f"clickhouse/{comp}")
        key = {"diskInfo": "diskInfos", "tableInfo": "tableInfos",
               "insertRate": "insertRates",
               "stackTraces": "stackTraces",
               "deviceInfo": "deviceInfos"}[comp]
        rows = doc.get(key, [])
        print(f"== {comp} ==")
        if rows:
            _print_table(rows, list(rows[0].keys()))


def _poll_and_download(addr: str, path: str, wait_s: float,
                       out_path: str, label: str) -> int:
    """Shared async-collect client: poll status until collected (or
    failed), then stream .../theia-manager/download to `out_path`.
    Returns the byte count."""
    deadline = time.time() + wait_s
    while time.time() < deadline:
        doc = _poll_request(addr, path, deadline)
        status = doc.get("status")
        if status == "collected":
            break
        if status == "failed":
            raise APIError(
                f"error: {label} failed: {doc.get('errorMsg', '')}")
        time.sleep(0.5)
    else:
        raise APIError(f"error: {label} collection timed out")
    req = urllib.request.Request(
        addr + path + "/theia-manager/download",
        headers=_auth_headers())
    with urllib.request.urlopen(req, timeout=60,
                                context=_url_context()) as resp:
        data = resp.read()
    with open(out_path, "wb") as f:
        f.write(data)
    return len(data)


def supportbundle(args) -> None:
    path = "/apis/system.theia.antrea.io/v1alpha1/supportbundles"
    _request(args.manager_addr, "POST", path)
    out = args.file or "theia-supportbundle.tar.gz"
    n = _poll_and_download(args.manager_addr, path, 60, out,
                           "support bundle")
    print(f"Support bundle written to {out} ({n} bytes)")


def profile(args) -> None:
    """Capture a torch.profiler trace from the manager (no reference
    equivalent — its closest surface is the ClickHouse stack-trace
    dump). The tarball holds one Chrome trace, `trace.json`."""
    path = "/apis/system.theia.antrea.io/v1alpha1/profiles"
    _request(args.manager_addr, "POST", path,
             {"durationSeconds": args.duration})
    out = args.file or "theia-profile.tar.gz"
    n = _poll_and_download(args.manager_addr, path,
                           args.duration + 120, out, "profile")
    print(f"torch.profiler trace written to {out} ({n} bytes); "
          f"view its trace.json in Perfetto (ui.perfetto.dev) or "
          f"chrome://tracing")


# -- ingest (exactly-once producer; the Flow-Aggregator-over-the-wire
# -- role, driven from a shell) -----------------------------------------

def ingest_cmd(args) -> None:
    """Produce synthetic flow batches to POST /ingest through the
    exactly-once client (stream+seq stamping, Retry-After honored
    with jittered capped backoff) — the operator's load/drill tool
    and the smallest correct producer to crib from."""
    from ..data.synth import SynthConfig, generate_flows
    from ..ingest import make_block_encoder
    from ..ingest.client import IngestClient, IngestError

    # TBLK by default; THEIA_INGEST_FORMAT=tfb2 keeps the legacy
    # dictionary-delta stream for drills against old managers
    enc = make_block_encoder()
    batch = generate_flows(SynthConfig(
        n_series=args.series, points_per_series=args.points,
        anomaly_fraction=args.anomaly_fraction, seed=args.seed),
        dicts=enc.dicts)
    client = IngestClient(args.manager_addr,
                          stream=args.stream or None,
                          token=_TOKEN, ca_cert=_CA_CERT or None)
    alerts = 0
    t0 = time.time()
    try:
        for i in range(args.batches):
            out = client.send(enc.encode(batch))
            alerts += int(out.get("alerts", 0))
            if args.interval > 0 and i + 1 < args.batches:
                time.sleep(args.interval)
    except IngestError as e:
        print(f"error: {e}", file=sys.stderr)
        raise SystemExit(1)
    dt = max(time.time() - t0, 1e-9)
    s = client.summary()
    print(f"stream {s['stream']}: acked {s['rowsAcked']} rows in "
          f"{s['batchesAcked']} batches ({s['rowsAcked'] / dt:,.0f} "
          f"rows/s), {alerts} alerts, {s['duplicates']} duplicate "
          f"acks, {s['rejected429']} over-capacity retries, "
          f"{s['transientRetries']} transient retries")


# -- query (filtered aggregations over the store — the vectorized
# -- read path of the parts engine) -------------------------------------

_WHERE_OPS = (">=", "<=", "!=", ">", "<", "=")


def _parse_where(clause: str) -> dict:
    """One --where clause → filter doc: `col>=443`, `sourceIP=10.0.0.9`,
    `destinationIP in 10.0.0.1,10.0.0.2`."""
    if " in " in clause:
        column, _, raw = clause.partition(" in ")
        return {"column": column.strip(), "op": "in",
                "value": [v for v in raw.strip().split(",") if v]}
    for op in _WHERE_OPS:
        if op in clause:
            column, _, value = clause.partition(op)
            return {"column": column.strip(), "op": op,
                    "value": value.strip()}
    raise SystemExit(
        f"error: --where {clause!r} has no operator "
        f"(expected one of {_WHERE_OPS} or ' in ')")


def query_cmd(args) -> None:
    """Run one filtered aggregation through POST /query and print the
    result rows (the CLI face of the vectorized query engine).

    Cluster-aware: --manager-addr takes a comma-separated endpoint
    list, and the request rides the IngestClient failover/redirect
    machinery — connection refusal / 5xx rotate endpoints, 307/308
    re-target at the node named in Location — so the command works
    against ANY node of a cluster, not just the one it was pointed
    at."""
    doc: dict = {}
    if getattr(args, "table", ""):
        doc["table"] = args.table
    if args.group_by:
        doc["groupBy"] = args.group_by
    if args.agg:
        doc["aggregates"] = args.agg
    if args.where:
        doc["filters"] = [_parse_where(w) for w in args.where]
    for name in ("start", "end", "k"):
        v = getattr(args, name)
        if v is not None:
            doc[name] = v
    if args.time_column:
        doc["timeColumn"] = args.time_column
    if args.order_by:
        doc["orderBy"] = args.order_by
    if args.explain:
        doc["explain"] = True
    from ..ingest.client import IngestClient, IngestError
    addrs = [a.strip() for a in args.manager_addr.split(",")
             if a.strip()]
    try:
        client = IngestClient(addrs, stream="cli-query",
                              token=_TOKEN, ca_cert=_CA_CERT or None,
                              max_attempts=4, backoff_base=0.2,
                              backoff_cap=2.0)
        out = client.request_json("POST", "/query", doc)
    except IngestError as e:
        raise APIError(f"error: {e}")
    if args.json:
        print(json.dumps(out, indent=2))
        return
    rows = out.get("rows", [])
    if rows:
        _print_table(rows, list(rows[0].keys()))
    else:
        print("no groups matched")
    footer = (f"-- {out.get('groupCount', 0)} groups, "
              f"{out.get('rowsScanned', 0):,} rows scanned, "
              f"{out.get('partsScanned', 0)} parts scanned / "
              f"{out.get('partsPruned', 0)} pruned, "
              f"{out.get('engine')} engine, cache {out.get('cache')}, "
              f"{out.get('tookMs', 0)} ms")
    peers = out.get("peers")
    if peers:
        footer += (f"; cluster {peers.get('queried', 0)} peers "
                   f"queried / {peers.get('pruned', 0)} pruned, "
                   f"{out.get('bytesShipped', 0):,} partial bytes")
    if out.get("traceId"):
        footer += f"; trace {out['traceId']}"
    print(footer)
    if args.explain and out.get("profile"):
        _print_explain(out["profile"])
    if out.get("partial"):
        print(f"!! PARTIAL result — peers unavailable: "
              f"{', '.join(out.get('missingPeers', []))} "
              f"(answer covers the reachable nodes only)",
              file=sys.stderr)


def _print_explain(prof: Dict) -> None:
    """Render the EXPLAIN profile: header facts, phase timings, then
    per-peer (coordinator) and per-part (local engine) tables."""
    head = [f"engine {prof.get('engine')}"]
    if prof.get("kernel"):
        head.append(f"kernel {prof['kernel']}")
    head.append(f"cache {prof.get('cache', '?')}")
    if prof.get("fingerprint"):
        head.append(f"fingerprint {prof['fingerprint']}")
    if prof.get("rowsMatched") is not None:
        head.append(f"{prof.get('rowsScanned', 0):,} rows scanned / "
                    f"{prof['rowsMatched']:,} matched")
    elif prof.get("rowsMatchedLocal") is not None:
        head.append(f"{prof.get('rowsScanned', 0):,} rows scanned "
                    f"cluster-wide / {prof['rowsMatchedLocal']:,} "
                    f"matched locally")
    print("EXPLAIN: " + ", ".join(head))
    phases = prof.get("phases") or {}
    if phases:
        print("  phases: " + ", ".join(
            f"{k} {v} ms" for k, v in phases.items()))
    peers = prof.get("peers") or []
    if peers:
        print("  peers:")
        _print_table(peers, ["peer", "status", "tookMs", "execMs",
                             "bytes", "rowsScanned", "partsScanned",
                             "partsPruned", "reason"])
    parts = prof.get("parts") or []
    if parts:
        print(f"  parts ({len(parts)}"
              + (f" shown, {prof['partsListTruncated']} more"
                 if prof.get("partsListTruncated") else "")
              + "):")
        shown = [{**p, "fate": (p.get("pruned") or "scanned")}
                 for p in parts]
        _print_table(shown, ["part", "tier", "rows", "fate"])
    if prof.get("memtableRows"):
        print(f"  memtable: {prof['memtableRows']:,} rows scanned")


# -- top (live rates from GET /metrics; no reference equivalent — the
# -- closest is watching the provisioned Grafana dashboards) ------------

def _request_text(addr: str, path: str) -> str:
    """GET returning raw text (the Prometheus exposition body)."""
    req = urllib.request.Request(addr + path, headers=_auth_headers())
    return _urlopen(addr, req).decode()


def _top_rows(sample, prev, dt):
    """One render pass: (metric, labels, rate string, value string)
    rows — counters (`*_total`) and histogram `*_count` series get a
    per-second rate against the previous sample; gauges print their
    value; `*_bucket` / `*_sum` series are elided (bucket grids don't
    read as a table)."""
    rows = []
    for (name, labels), value in sorted(sample.items()):
        if name.endswith(("_bucket", "_sum")):
            continue
        is_rate = name.endswith(("_total", "_count"))
        rate = ""
        if is_rate and prev is not None and dt > 0:
            delta = value - prev.get((name, labels), 0.0)
            rate = f"{max(delta, 0.0) / dt:,.1f}"
        label_s = ",".join(f"{k}={v}" for k, v in labels)
        value_s = (f"{value:,.0f}" if float(value).is_integer()
                   else f"{value:,.2f}")
        rows.append({"METRIC": name, "LABELS": label_s,
                     "RATE/s": rate, "VALUE": value_s})
    return rows


def trace_cmd(args) -> None:
    """Fetch one distributed trace by id (from ANY cluster node — the
    queried node fans the lookup out to its live peers and stitches
    the spans) and render the cross-node tree."""
    doc = _request(
        args.manager_addr, "GET",
        "/debug/traces?trace="
        + urllib.parse.quote(args.trace_id, safe=""))
    spans = doc.get("spans") or []
    if not spans:
        print(f"trace {args.trace_id}: no spans retained "
              f"(expired from the ring, unsampled, or "
              f"THEIA_TRACE_RING=0)")
        return
    nodes = doc.get("nodes") or []
    print(f"trace {doc.get('trace')} — {len(spans)} spans across "
          f"{len(nodes)} node(s): {', '.join(nodes)}")
    if doc.get("peersMissing"):
        print(f"!! peers unreachable (trace may be incomplete): "
              f"{', '.join(doc['peersMissing'])}", file=sys.stderr)
    if doc.get("clockNote"):
        print(f"   note: {doc['clockNote']}")
    by_id = {s.get("spanId"): s for s in spans if s.get("spanId")}
    children: Dict[str, list] = {}
    roots = []
    for s in spans:
        parent = s.get("parentSpanId")
        if parent and parent in by_id:
            children.setdefault(parent, []).append(s)
        else:
            roots.append(s)
    t0 = min(float(s.get("startTime") or 0) for s in spans)
    meta_keys = ("op", "startTime", "durationMs", "parent", "thread",
                 "traceId", "spanId", "parentSpanId", "node", "error")

    def render(s, depth):
        offset = (float(s.get("startTime") or 0) - t0) * 1000
        attrs = " ".join(f"{k}={v}" for k, v in s.items()
                         if k not in meta_keys)
        line = (f"{'  ' * depth}{'└ ' if depth else ''}{s['op']} "
                f"[{s.get('node') or 'local'}] "
                f"{s.get('durationMs', 0)} ms @+{offset:,.1f} ms")
        if s.get("error"):
            line += f" ERROR={s['error']}"
        if attrs:
            line += f"  {attrs}"
        print(line)
        kids = sorted(children.get(s.get("spanId"), []),
                      key=lambda c: float(c.get("startTime") or 0))
        for c in kids:
            render(c, depth + 1)

    for root in sorted(roots,
                       key=lambda s: float(s.get("startTime") or 0)):
        render(root, 0)


# -- cluster-wide top ----------------------------------------------------

def _cluster_top_sample(clients):
    """One scrape pass: addr → parsed exposition (None when the node
    is unreachable after the client's retry budget). Scrapes run
    CONCURRENTLY — one hung node costs one timeout, not its place in
    a serial chain, exactly when a degraded cluster is what the
    operator is trying to see."""
    from concurrent.futures import ThreadPoolExecutor

    from ..obs import prom as _prom

    def scrape(client):
        try:
            return _prom.parse(client.request_text("GET", "/metrics"))
        except Exception:   # IngestError, parse failure: node is down
            return None

    with ThreadPoolExecutor(max_workers=max(2, len(clients))) as pool:
        futs = [(addr, pool.submit(scrape, client))
                for addr, client in clients]
        return {addr: fut.result() for addr, fut in futs}


def _node_label(addr) -> str:
    """host:port — unambiguous even when peer ids are unknown (a node
    scrapes fine before its cluster tier is configured)."""
    return addr.split("://", 1)[-1]


#: rung names mirror manager/admission.py LEVEL_NAMES (kept literal
#: here so `theia top` stays import-light)
_ADMISSION_NAMES = ("ok", "sampled", "shed_detector", "reject")


def _cluster_top_rows(samples, prev, dt):
    """Per-node columns + a cluster-total row. Counters render as
    rates against the previous scrape of the SAME node."""
    def rate(sample, prior, name):
        if sample is None or prior is None or dt <= 0:
            return 0.0
        cur = sum(v for (n, _), v in sample.items() if n == name)
        old = sum(v for (n, _), v in prior.items() if n == name)
        return max(cur - old, 0.0) / dt

    def gauge(sample, name, default=0.0):
        if sample is None:
            return default
        return sum(v for (n, _), v in sample.items() if n == name)

    def skip_pct(scanned: float, skipped: float) -> str:
        total = scanned + skipped
        return f"{100.0 * skipped / total:,.0f}%" if total > 0 else "-"

    rows = []
    totals = {"rows": 0.0, "parts": 0.0, "q": 0.0,
              "gscan": 0.0, "gskip": 0.0}
    for addr, sample in samples.items():
        prior = (prev or {}).get(addr)
        if sample is None:
            rows.append({"NODE": _node_label(addr),
                         "STATUS": "DOWN", "ROWS/s": "", "REPL LAG": "",
                         "ADMISSION": "", "PARTS": "", "QUERY/s": "",
                         "GRAN SKIP": ""})
            continue
        rows_s = rate(sample, prior, "theia_ingest_rows_total")
        q_s = (rate(sample, prior, "theia_query_cache_hits_total")
               + rate(sample, prior, "theia_query_seconds_count")
               + rate(sample, prior, "theia_query_fanout_seconds_count"))
        lags = [v for (n, _), v in sample.items()
                if n == "theia_repl_lag_records"]
        lvl = int(gauge(sample, "theia_admission_level"))
        parts = gauge(sample, "theia_store_parts")
        # index effectiveness at a glance: lifetime share of index
        # granules the skip indexes pruned inside scanned parts
        # (theia_query_granules_*_total)
        gscan = gauge(sample, "theia_query_granules_scanned_total")
        gskip = gauge(sample, "theia_query_granules_skipped_total")
        totals["rows"] += rows_s
        totals["parts"] += parts
        totals["q"] += q_s
        totals["gscan"] += gscan
        totals["gskip"] += gskip
        rows.append({
            "NODE": _node_label(addr),
            "STATUS": "up",
            "ROWS/s": f"{rows_s:,.0f}",
            "REPL LAG": f"{max(lags):,.0f}" if lags else "-",
            "ADMISSION": _ADMISSION_NAMES[
                min(max(lvl, 0), len(_ADMISSION_NAMES) - 1)],
            "PARTS": f"{parts:,.0f}",
            "QUERY/s": f"{q_s:,.1f}",
            "GRAN SKIP": skip_pct(gscan, gskip),
        })
    rows.append({
        "NODE": "TOTAL", "STATUS": "",
        "ROWS/s": f"{totals['rows']:,.0f}", "REPL LAG": "",
        "ADMISSION": "", "PARTS": f"{totals['parts']:,.0f}",
        "QUERY/s": f"{totals['q']:,.1f}",
        "GRAN SKIP": skip_pct(totals["gscan"], totals["gskip"]),
    })
    return rows


def top_cluster(args) -> None:
    """`theia top --cluster`: scrape every endpoint in the (comma-
    separated) --manager-addr list and render per-node columns plus a
    cluster-total row. Each endpoint rides its own IngestClient, so a
    flapping node retries/backs off exactly like a producer would."""
    from ..ingest.client import IngestClient
    addrs = [a.strip() for a in args.manager_addr.split(",")
             if a.strip()]
    clients = [(a, IngestClient(a, stream="cli-top", token=_TOKEN,
                                ca_cert=_CA_CERT or None,
                                timeout=5.0,
                                max_attempts=2, backoff_base=0.1,
                                backoff_cap=0.5))
               for a in addrs]
    prev = None
    prev_t = 0.0
    i = 0
    try:
        while True:
            samples = _cluster_top_sample(clients)
            now = time.time()
            dt = now - prev_t if prev is not None else 0.0
            if not args.no_clear and sys.stdout.isatty():
                print("\x1b[2J\x1b[H", end="")
            stamp = datetime.datetime.fromtimestamp(now).strftime(
                TIME_FORMAT)
            n_up = sum(1 for s in samples.values() if s is not None)
            print(f"theia top --cluster — {n_up}/{len(addrs)} nodes "
                  f"up  {stamp}")
            # per-peer heartbeat RTT averages from any live node's
            # histogram (scrape-cumulative: sum/count)
            rtts = []
            for sample in samples.values():
                if sample is None:
                    continue
                for (name, labels), v in sample.items():
                    if name == "theia_cluster_heartbeat_rtt_seconds_sum" \
                            and labels:
                        peer = dict(labels).get("peer")
                        cnt = sample.get(
                            ("theia_cluster_heartbeat_rtt_seconds_count",
                             labels), 0.0)
                        if cnt:
                            rtts.append((peer, v / cnt * 1e3))
                break   # one node's view is the cluster's link set
            if rtts:
                print("heartbeat rtt: " + ", ".join(
                    f"{p} {ms:.1f}ms" for p, ms in sorted(rtts)))
            _print_table(_cluster_top_rows(samples, prev, dt),
                         ["NODE", "STATUS", "ROWS/s", "REPL LAG",
                          "ADMISSION", "PARTS", "QUERY/s",
                          "GRAN SKIP"])
            prev, prev_t = samples, now
            i += 1
            if args.iterations and i >= args.iterations:
                return
            time.sleep(args.interval)
    except KeyboardInterrupt:
        pass


# -- stored-history sparklines (theia top --history) ---------------------

_WINDOW_UNITS = {"s": 1, "m": 60, "h": 3600, "d": 86400}

_SPARK_CHARS = "▁▂▃▄▅▆▇█"


def _parse_window(raw: str) -> int:
    """'6h' / '30m' / '900' → seconds."""
    s = raw.strip().lower()
    try:
        if s and s[-1] in _WINDOW_UNITS:
            return int(float(s[:-1]) * _WINDOW_UNITS[s[-1]])
        return int(s)
    except ValueError:
        raise APIError(f"error: bad --history window {raw!r} "
                       f"(expected e.g. 6h, 30m, 900)")


def _sparkline(values) -> str:
    """One row of block characters; None (empty bucket) renders as a
    space; a flat series renders at the floor."""
    finite = [v for v in values if v is not None]
    if not finite:
        return ""
    lo, hi = min(finite), max(finite)
    span = hi - lo
    out = []
    for v in values:
        if v is None:
            out.append(" ")
        elif span <= 0:
            out.append(_SPARK_CHARS[0])
        else:
            out.append(_SPARK_CHARS[
                min(len(_SPARK_CHARS) - 1,
                    int((v - lo) / span * len(_SPARK_CHARS)))])
    return "".join(out)


def _history_series(rows, start: int, bucket: int, n_buckets: int):
    """Fold /query rows (metric, kind, labels, node, timeInserted +
    the four exact aggregate columns) into per-(metric, kind) bucket
    arrays of NATURAL-unit values: gauges → mean sample per bucket
    (pooled across children); cumulative kinds (counters, histogram
    sum/count) → rate/s computed PER SERIES — each labels × node
    child is its own monotone counter, whose bucket-to-bucket level
    increase is exact — then summed across the metric's series
    (differencing a max folded over unrelated children would track
    only the highest-level series and hide the rest)."""
    scale = 1e6   # METRICS_VALUE_SCALE (kept literal: import-light)
    gauge_acc: Dict[tuple, dict] = {}
    cum_acc: Dict[tuple, dict] = {}
    for r in rows:
        b = (int(r["timeInserted"]) - start) // bucket
        if b < 0:
            continue
        # the query window runs through `now` inclusive, which lands
        # past the last bucket boundary whenever window % bucket != 0
        # (and always for t == now); fold that remainder into the
        # final bucket instead of silently dropping the newest
        # samples — LAST must show the most recent stored value
        b = min(b, n_buckets - 1)
        if r["kind"] == "gauge":
            s = gauge_acc.setdefault((r["metric"], r["kind"]), {})
            cur = s.get(b)
            if cur is None:
                s[b] = {"sum": r["sum(valueSum)"],
                        "count": r["sum(valueCount)"]}
            else:
                cur["sum"] += r["sum(valueSum)"]
                cur["count"] += r["sum(valueCount)"]
        else:
            key = (r["metric"], r["kind"],
                   r.get("labels", ""), r.get("node", ""))
            s = cum_acc.setdefault(key, {})
            cur = s.get(b)
            if cur is None:
                s[b] = {"max": r["max(valueMax)"]}
            else:
                cur["max"] = max(cur["max"], r["max(valueMax)"])
    series: Dict[tuple, list] = {}
    for (metric, kind), buckets in sorted(gauge_acc.items()):
        vals: list = [None] * n_buckets
        for b, v in buckets.items():
            if v["count"]:
                vals[b] = v["sum"] / scale / v["count"]
        series[(metric, kind)] = vals
    for (metric, kind, _lab, _node), buckets in sorted(
            cum_acc.items()):
        # this one series' rate between consecutive non-empty buckets
        vals = [None] * n_buckets
        prev_level = None
        prev_b = None
        for b in sorted(buckets):
            level = buckets[b]["max"] / scale
            if prev_level is not None and b > prev_b:
                vals[b] = max(level - prev_level, 0.0) \
                    / ((b - prev_b) * bucket)
            prev_level, prev_b = level, b
        out = series.get((metric, kind))
        if out is None:
            series[(metric, kind)] = vals
        else:
            for i, v in enumerate(vals):
                if v is not None:
                    out[i] = v + (out[i] or 0.0)
    # derived mean series: where a histogram's _sum and _count rates
    # both exist, their ratio is the mean observation per bucket —
    # the "latency sparkline"
    for (metric, kind) in list(series):
        if kind != "sum" or not metric.endswith("_sum"):
            continue
        base = metric[:-4]
        cnt = series.get((base + "_count", "count"))
        if cnt is None:
            continue
        s_vals = series[(metric, kind)]
        mean = [
            (s_vals[i] / cnt[i])
            if (s_vals[i] is not None and cnt[i]) else None
            for i in range(n_buckets)]
        series[(base + " (mean)", "derived")] = mean
    return series


def top_history(args) -> None:
    """`theia top --history <window>`: render sparklines from the
    STORED `__metrics__` series instead of diffing two live scrapes —
    history survives restarts, and on a cluster the query plane
    answers for every node from any node. Windows past the rollup
    horizon read from downsampled parts transparently."""
    window = _parse_window(args.history)
    now = int(time.time())
    start = now - window
    # bucket floor = the default scrape cadence: narrower buckets
    # would alias raw 15s samples into an on/off checkerboard
    bucket = max(window // 48, 15)
    n_buckets = max(window // bucket, 1)
    filters = [{"column": "kind", "op": "ne", "value": "bucket"}]
    if getattr(args, "node", ""):
        filters.append({"column": "node", "op": "eq",
                        "value": args.node})
    doc = {"table": "__metrics__",
           "groupBy": "metric,kind,labels,node,timeInserted",
           "aggregates": ["min:valueMin", "max:valueMax",
                          "sum:valueSum", "sum:valueCount"],
           "filters": filters,
           "start": start, "end": now + 1, "k": 0,
           "cache": "0"}
    from ..ingest.client import IngestClient, IngestError
    addrs = [a.strip() for a in args.manager_addr.split(",")
             if a.strip()]
    try:
        client = IngestClient(addrs, stream="cli-top",
                              token=_TOKEN, ca_cert=_CA_CERT or None,
                              max_attempts=4, backoff_base=0.2,
                              backoff_cap=2.0)
        out = client.request_json("POST", "/query", doc)
    except IngestError as e:
        raise APIError(f"error: {e}")
    rows = out.get("rows", [])
    needle = (getattr(args, "metric", "") or "").strip()
    if needle:
        rows = [r for r in rows if needle in r["metric"]]
    series = _history_series(rows, start, bucket, n_buckets)
    stamp = datetime.datetime.fromtimestamp(now).strftime(TIME_FORMAT)
    print(f"theia top --history {args.history} — "
          f"{len(series)} series, {bucket}s buckets, "
          f"stored history through {stamp}")
    if not series:
        print("no stored series in the window (is the metrics "
              "history loop on? THEIA_METRICS_SCRAPE_INTERVAL)")
        return
    table = []
    for (metric, kind), vals in sorted(series.items()):
        finite = [v for v in vals if v is not None]
        last = finite[-1] if finite else None
        unit = "/s" if kind not in ("gauge", "derived") else ""
        table.append({
            "METRIC": metric,
            "KIND": kind,
            "SPARK": _sparkline(vals),
            "LAST": (f"{last:,.4g}{unit}"
                     if last is not None else "-"),
        })
    _print_table(table, ["METRIC", "KIND", "SPARK", "LAST"])
    if out.get("partial"):
        print(f"!! PARTIAL history — peers unavailable: "
              f"{', '.join(out.get('missingPeers', []))}",
              file=sys.stderr)


def alerts_cmd(args) -> None:
    """`theia alerts [--rules]`: the recent alert ring (detector +
    rule firings), and with --rules the declarative rule set with its
    per-(rule, node) hysteresis states."""
    doc = _request(args.manager_addr, "GET",
                   f"/alerts?limit={args.limit}")
    if args.json:
        print(json.dumps(doc, indent=2))
        return
    if args.rules:
        rules = doc.get("rules")
        if not rules:
            print("no alert rules engine on this manager (set "
                  "THEIA_ALERT_RULES and keep "
                  "THEIA_METRICS_SCRAPE_INTERVAL > 0)")
            return
        print(f"alert rules — {len(rules.get('rules', []))} loaded "
              f"from {rules.get('path') or '(unset)'}, "
              f"{rules.get('evaluations', 0)} evaluations, "
              f"{rules.get('transitions', 0)} transitions")
        if rules.get("loadError"):
            print(f"!! load error (previous rule set still active): "
                  f"{rules['loadError']}", file=sys.stderr)
        spec_rows = [{
            "RULE": r["name"], "TYPE": r["type"],
            "METRIC": r["metric"],
            "EXPR": f"{r['agg']} {r['op']} {r['threshold']:g}",
            "WINDOWS": ",".join(str(w) for w in r["windows"]),
            "FOR": f"{r['forTicks']}/{r['clearTicks']}",
        } for r in rules.get("rules", [])]
        if spec_rows:
            _print_table(spec_rows, ["RULE", "TYPE", "METRIC",
                                     "EXPR", "WINDOWS", "FOR"])
        state_rows = [{
            "RULE": s["rule"],
            "NODE": s.get("node", ""),
            "STATE": ("FIRING" if s["state"] == "firing"
                      else s["state"]),
            "VALUE": (f"{s['value']:,.4g}"
                      if s.get("value") is not None else "-"),
            "STREAK": s.get("breachStreak", 0),
        } for s in rules.get("states", [])]
        if state_rows:
            _print_table(state_rows, ["RULE", "NODE", "STATE",
                                      "VALUE", "STREAK"])
        else:
            print("(no rule states yet — waiting for the first "
                  "evaluation ticks)")
        return
    alerts = doc.get("alerts") or []
    if not alerts:
        print("no recent alerts")
        return
    rows = [{
        "TIME": (datetime.datetime.fromtimestamp(
            a["time"]).strftime(TIME_FORMAT)
            if a.get("time") else ""),
        "KIND": a.get("kind", a.get("algo", "")),
        "DETAIL": (f"rule {a.get('rule')} {a.get('state')} "
                   f"value={a.get('value'):,.4g} vs "
                   f"{a.get('op', '>=')} {a.get('threshold')}"
                   if a.get("kind") == "rule"
                   and a.get("value") is not None
                   else str({k: v for k, v in a.items()
                             if k not in ("time", "kind")})[:100]),
        "NODE": a.get("node", ""),
    } for a in alerts]
    _print_table(rows, ["TIME", "KIND", "NODE", "DETAIL"])


def top(args) -> None:
    """Poll GET /metrics and render a live rates table (rates are
    deltas between successive scrapes)."""
    if getattr(args, "history", ""):
        top_history(args)
        return
    if getattr(args, "cluster", False):
        top_cluster(args)
        return
    from ..obs import prom as _prom
    prev = None
    prev_t = 0.0
    i = 0
    failures = 0
    try:
        while True:
            try:
                text = _request_text(args.manager_addr, "/metrics")
            except APIConnectionError as e:
                # a monitoring loop must outlive the blip it exists to
                # observe (manager restarting, replicas resyncing) —
                # same discipline as the job-poll retry
                failures += 1
                backoff = capped_backoff(
                    max(args.interval, 0.1), 30.0, failures)
                print(f"warning: {e}; retrying in {backoff:.0f}s",
                      file=sys.stderr)
                time.sleep(backoff)
                continue
            failures = 0
            now = time.time()
            sample = _prom.parse(text)
            rows = _top_rows(sample, prev,
                             now - prev_t if prev is not None else 0.0)
            if not args.no_clear and sys.stdout.isatty():
                print("\x1b[2J\x1b[H", end="")
            stamp = datetime.datetime.fromtimestamp(now).strftime(
                TIME_FORMAT)
            print(f"theia top — {args.manager_addr}  {stamp}  "
                  f"({len(rows)} series)")
            lvl = sample.get(("theia_admission_level", ()))
            if lvl is not None:
                names = _ADMISSION_NAMES
                i_lvl = min(max(int(lvl), 0), len(names) - 1)
                pressure = sample.get(("theia_admission_pressure",
                                       ()), 0.0)
                print(f"admission: {names[i_lvl]} (rung {i_lvl}, "
                      f"pressure {pressure:.2f})")
            peer_rows = sorted(
                (labels[0][1], value)
                for (name, labels), value in sample.items()
                if name == "theia_cluster_peer_up" and labels)
            if peer_rows:
                # cluster header: per-peer liveness + replication lag
                # (the theia_repl_* gauges exist on the leader)
                def _peer_cell(peer, up):
                    lag = sample.get(
                        ("theia_repl_lag_records", (("peer", peer),)))
                    cell = f"{peer} {'up' if up else 'DOWN'}"
                    if lag is not None:
                        cell += f" lag {lag:,.0f}"
                    rtt_sum = sample.get(
                        ("theia_cluster_heartbeat_rtt_seconds_sum",
                         (("peer", peer),)))
                    rtt_n = sample.get(
                        ("theia_cluster_heartbeat_rtt_seconds_count",
                         (("peer", peer),)), 0.0)
                    if rtt_sum is not None and rtt_n:
                        cell += f" rtt {rtt_sum / rtt_n * 1e3:.1f}ms"
                    return cell
                n_up = sum(1 for _, up in peer_rows if up)
                print(f"cluster: {n_up}/{len(peer_rows)} peers up — "
                      + ", ".join(_peer_cell(p, up)
                                  for p, up in peer_rows))
            pc = sample.get(("theia_store_parts", ()))
            if pc is not None:
                # parts-engine header: part count, tier residency,
                # merge rate from scrape-to-scrape deltas
                hot = sample.get(
                    ("theia_store_part_bytes", (("tier", "hot"),)),
                    0.0)
                cold = sample.get(
                    ("theia_store_part_bytes", (("tier", "cold"),)),
                    0.0)
                dt_p = now - prev_t if prev is not None else 0.0
                dm = 0.0
                if prev is not None:
                    dm = max(sample.get(
                        ("theia_store_merges_total", ()), 0.0)
                        - prev.get(("theia_store_merges_total", ()),
                                   0.0), 0.0)
                print(f"parts engine: {pc:,.0f} parts, "
                      f"hot {hot / 1e6:,.1f} MB, "
                      f"cold {cold / 1e6:,.1f} MB, "
                      f"{dm / dt_p if dt_p > 0 else 0.0:,.2f} "
                      f"merges/s")
            rv = sample.get(("theia_rollup_views", ()))
            if rv:
                # rollup-maintenance header: active views, fold rate
                # of the insert path, cumulative tier folds — visible
                # whenever rollup maintenance is active
                dt_r = now - prev_t if prev is not None else 0.0
                dr = 0.0
                if prev is not None:
                    dr = max(sample.get(
                        ("theia_rollup_applied_rows_total", ()), 0.0)
                        - prev.get(
                            ("theia_rollup_applied_rows_total", ()),
                            0.0), 0.0)
                tier_folds = sum(
                    value for (name, _labels), value in sample.items()
                    if name == "theia_rollup_folds_total")
                print(f"rollup views: {rv:,.0f} active, "
                      f"{dr / dt_r if dt_r > 0 else 0.0:,.0f} "
                      f"rows/s applied, "
                      f"{tier_folds:,.0f} tier folds")
            qc = sample.get(("theia_query_seconds_count", ()))
            if qc is not None:
                # query-engine header: query rate, scan rate, cache
                # hit ratio — scrape-to-scrape deltas. q/s = cache
                # hits + executed queries (the seconds histogram):
                # the histogram alone misses cache hits, the cache
                # counters alone miss everything when the cache is
                # disabled — either half would read as an idle engine
                # under the other workload.
                def _qdelta(name):
                    if prev is None:
                        return 0.0
                    return max(sample.get((name, ()), 0.0)
                               - prev.get((name, ()), 0.0), 0.0)
                dt_q = now - prev_t if prev is not None else 0.0
                dscan = _qdelta("theia_query_rows_scanned_total")
                dh = _qdelta("theia_query_cache_hits_total")
                dm_q = _qdelta("theia_query_cache_misses_total")
                dq = dh + _qdelta("theia_query_seconds_count")
                hit_pct = (100.0 * dh / (dh + dm_q)
                           if (dh + dm_q) > 0 else 0.0)
                qline = (f"query engine: "
                         f"{dq / dt_q if dt_q > 0 else 0.0:,.1f} q/s, "
                         f"{dscan / dt_q if dt_q > 0 else 0.0:,.0f} "
                         f"rows/s scanned, "
                         f"cache hit {hit_pct:.0f}%")
                slow = sample.get(
                    ("theia_query_slow_queries_total", ()), 0.0)
                if slow:
                    # captured profiles live at /debug/slow_queries
                    qline += f", {slow:,.0f} slow captured"
                print(qline)
                # distributed fan-out header (routing-mesh nodes):
                # cumulative peers queried/pruned/failed — nonzero
                # only where the coordinator actually runs
                fanq = sample.get(
                    ("theia_query_peers_queried_total", ()), 0.0)
                fanp = sample.get(
                    ("theia_query_peers_pruned_total", ()), 0.0)
                fanf = sample.get(
                    ("theia_query_peers_failed_total", ()), 0.0)
                if fanq or fanp or fanf:
                    fb = sample.get(
                        ("theia_query_fanout_bytes_total", ()), 0.0)
                    print(f"query fanout: {fanq:,.0f} peers queried, "
                          f"{fanp:,.0f} pruned, {fanf:,.0f} failed, "
                          f"{fb / 1e3:,.1f} KB partials shipped")
            ld = sample.get(("theia_lockdep_locks", ()))
            if ld:
                # lockdep header: witness scope + the one number that
                # must stay zero, plus the currently worst lock by
                # cumulative wait (contention hot spot at a glance)
                inv_n = sample.get(
                    ("theia_lockdep_inversions", ()), 0.0)
                edges_n = sample.get(("theia_lockdep_edges", ()), 0.0)
                worst, worst_wait = "", 0.0
                for (name, labels), value in sample.items():
                    if name == "theia_lockdep_wait_seconds_total" \
                            and labels and value > worst_wait:
                        worst, worst_wait = labels[0][1], value
                line = (f"lockdep: {ld:,.0f} locks, "
                        f"{edges_n:,.0f} order edges, "
                        f"{inv_n:,.0f} inversions")
                if inv_n:
                    line += "  ** LATENT DEADLOCK — see theia locks"
                if worst:
                    line += (f"; top wait: {worst} "
                             f"({worst_wait:.2f}s total)")
                print(line)
            qd = sample.get(("theia_fused_queue_depth", ()))
            if qd is not None:
                # fused-engine header: pipeline backlog + step rate +
                # coalesced rows/step, from scrape-to-scrape deltas
                def _delta(name):
                    if prev is None:
                        return 0.0
                    return max(sample.get((name, ()), 0.0)
                               - prev.get((name, ()), 0.0), 0.0)
                steps = _delta("theia_fused_steps_total")
                step_rows = _delta("theia_fused_batch_rows_sum")
                dt_s = now - prev_t if prev is not None else 0.0
                print(f"fused engine: queue depth {qd:.0f}, "
                      f"{steps / dt_s if dt_s > 0 else 0.0:,.1f} "
                      f"steps/s, "
                      f"{step_rows / steps if steps > 0 else 0.0:,.0f}"
                      f" rows/step")
            hot = sample.get(("theia_state_hot_series", ()))
            if hot is not None:
                # working-set state tier header: occupancy split plus
                # promote/evict/drop rates from scrape-to-scrape
                # deltas (drops must stay 0 while the tier is on —
                # that is the tier's whole contract)
                def _sdelta(name):
                    if prev is None:
                        return 0.0
                    cur = sum(v for (n, _l), v in sample.items()
                              if n == name)
                    old = sum(v for (n, _l), v in prev.items()
                              if n == name)
                    return max(cur - old, 0.0)
                spilled = sample.get(
                    ("theia_state_spilled_series", ()), 0.0)
                dt_t = now - prev_t if prev is not None else 0.0
                ev = _sdelta("theia_state_evictions_total")
                pr = _sdelta("theia_state_promotions_total")
                drops = _sdelta("theia_detector_series_dropped_total")
                tline = (f"state tier: {hot:,.0f} hot, "
                         f"{spilled:,.0f} spilled, "
                         f"{pr / dt_t if dt_t > 0 else 0.0:,.1f} "
                         f"promotions/s, "
                         f"{ev / dt_t if dt_t > 0 else 0.0:,.1f} "
                         f"evictions/s, "
                         f"{drops / dt_t if dt_t > 0 else 0.0:,.1f} "
                         f"drops/s")
                if drops:
                    tline += "  ** SERIES DROPPED despite tier"
                print(tline)
            if rows:
                _print_table(rows, ["METRIC", "LABELS", "RATE/s",
                                    "VALUE"])
            prev, prev_t = sample, now
            i += 1
            if args.iterations and i >= args.iterations:
                return
            time.sleep(args.interval)
    except KeyboardInterrupt:
        pass


def parts_cmd(args) -> None:
    """`theia parts` — the storage engine at inspection depth: the
    `theia top` parts header expanded to per-table sort-key / granule
    / index stats and a bounded per-part inventory (token-gated
    GET /debug/parts)."""
    doc = _request(args.manager_addr, "GET",
                   f"/debug/parts?limit={args.limit}")
    if args.json:
        print(json.dumps(doc, indent=2))
        return
    if doc.get("engine") != "parts" or not doc.get("tables"):
        print("store engine: flat (no parts — set "
              "THEIA_STORE_ENGINE=parts)")
        return

    def kb(n) -> str:
        return f"{(n or 0) / 1e3:,.1f}K"

    for t in doc["tables"]:
        s = t.get("stats") or {}
        shard = f" [shard {t['shard']}]" if "shard" in t else ""
        print(f"table {t.get('table')}{shard}: "
              f"{s.get('count', 0):,} parts "
              f"({s.get('hot', 0):,} hot / {s.get('cold', 0):,} cold, "
              f"{s.get('sorted', 0):,} sorted v2), "
              f"{s.get('rows', 0):,} rows "
              f"+ {s.get('memtableRows', 0):,} memtable")
        key = ",".join(s.get("sortKey") or ()) or "(none — unsorted)"
        print(f"  sort key: {key}; granule {s.get('granuleRows', 0):,}"
              f" rows — {s.get('indexedParts', 0):,} indexed parts, "
              f"{s.get('granules', 0):,} granules, "
              f"index {kb(s.get('indexBytes'))}B resident")
        print(f"  lifetime: {s.get('sealed', 0):,} sealed, "
              f"{s.get('merges', 0):,} merges "
              f"({s.get('coldMerges', 0):,} cold), "
              f"{s.get('demoted', 0):,} demoted, "
              f"{s.get('upgraded', 0):,} upgraded v1→v2")
        entries = t.get("parts") or []
        if not entries:
            continue
        rows = [{
            "UID": e.get("uid", ""),
            "TIER": e.get("tier", ""),
            "FMT": f"v{e.get('fmt', 1)}",
            "ROWS": f"{e.get('rows', 0):,}",
            "RAM": kb(e.get("residentBytes")),
            "FILE": kb(e.get("fileBytes")),
            "GRANULES": e.get("granules", ""),
            "INDEX": (kb(e.get("indexBytes"))
                      if "indexBytes" in e else ""),
            "TIME-RANGE": "..".join(
                str(v) for v in (e.get("timeRange") or ())),
        } for e in entries]
        _print_table(rows, ["UID", "TIER", "FMT", "ROWS", "RAM",
                            "FILE", "GRANULES", "INDEX", "TIME-RANGE"])


def views_cmd(args) -> None:
    """`theia views` — the declared rollup views at inspection depth
    (token-gated GET /debug/views): definitions, tiers, per-store
    aggregate part/row counts, maintenance stats, loadError."""
    doc = _request(args.manager_addr, "GET", "/debug/views")
    if args.json:
        print(json.dumps(doc, indent=2))
        return
    if not doc.get("enabled") or not doc.get("views"):
        print("no rollup views declared (set THEIA_ROLLUP_VIEWS "
              "and/or THEIA_ROLLUP_DEFAULTS=1)")
        if doc.get("loadError"):
            print(f"load error: {doc['loadError']}")
        return
    print(f"rollup views: {len(doc['views'])} declared across "
          f"{doc.get('stores', 1)} store(s)  — "
          f"{doc.get('rowsApplied', 0):,} rows applied, "
          f"{doc.get('aggregateRows', 0):,} aggregate rows, "
          f"{doc.get('folds', 0):,} tier folds, "
          f"{doc.get('rebuilds', 0):,} rebuilds")
    if doc.get("configPath"):
        print(f"config: {doc['configPath']}")
    if doc.get("loadError"):
        print(f"LOAD ERROR (previous set still active): "
              f"{doc['loadError']}")
    rows = []
    for v in doc["views"]:
        d = v.get("definition") or {}
        tiers = d.get("tiers") or []
        tier_s = "→".join(
            [f"{d.get('bucketSeconds', '?')}s"]
            + [f"{t['resolutionSeconds']}s" for t in tiers])
        aggs = d.get("aggregates") or []
        agg_s = ",".join(
            (a["op"] if not a.get("column")
             else f"{a['op']}({a['column']})") for a in aggs)
        rows.append({
            "VIEW": v.get("name", ""),
            "GROUP-BY": len(d.get("groupBy") or ()),
            "AGGREGATES": agg_s[:40],
            "TIERS": tier_s,
            "FILTERS": len(d.get("filters") or ()),
            "ROWS": f"{v.get('rows', 0):,}",
            "PARTS": v.get("parts", 0),
            "RES-SEEN": ",".join(
                str(r) for r in (v.get("partResolutions") or ())),
        })
    _print_table(rows, ["VIEW", "GROUP-BY", "AGGREGATES", "TIERS",
                        "FILTERS", "ROWS", "PARTS", "RES-SEEN"])


def locks_cmd(args) -> None:
    """`theia locks` — the runtime lockdep witness at inspection
    depth (token-gated GET /debug/locks): per-lock acquire/contention
    counts, wait and hold p95s, the observed acquisition-order edges,
    and any witnessed inversions."""
    doc = _request(args.manager_addr, "GET", "/debug/locks")
    if args.json:
        print(json.dumps(doc, indent=2))
        return
    if not doc.get("enabled"):
        print("lockdep witness: off (start the manager with "
              "THEIA_LOCKDEP=1 to arm it)")
        return
    stats = doc.get("stats") or {}
    edges = doc.get("orderEdges") or []
    inv = doc.get("inversions") or []
    print(f"lockdep witness: {len(doc.get('locks') or ())} lock "
          f"classes, {len(edges)} order edges, "
          f"{len(inv)} inversion(s)")
    if inv:
        for i in inv:
            print(f"  INVERSION: {' -> '.join(i.get('cycle', ()))} "
                  f"(new edge at {i.get('site', '?')}, thread "
                  f"{i.get('thread', '?')})")
    rows = []
    order = sorted(stats.items(),
                   key=lambda kv: -kv[1].get("waitTotalSeconds", 0.0))
    for name, s in order[:args.limit]:
        rows.append({
            "LOCK": name,
            "ACQUIRES": f"{s.get('acquires', 0):,}",
            "CONTENDED": f"{s.get('contended', 0):,}",
            "WAIT-P95": f"{s.get('waitP95Seconds', 0.0) * 1e3:.3f}ms",
            "WAIT-MAX": f"{s.get('waitMaxSeconds', 0.0) * 1e3:.2f}ms",
            "HOLD-P95": f"{s.get('holdP95Seconds', 0.0) * 1e3:.3f}ms",
            "HOLD-TOT": f"{s.get('holdTotalSeconds', 0.0):.2f}s",
        })
    if rows:
        _print_table(rows, ["LOCK", "ACQUIRES", "CONTENDED",
                            "WAIT-P95", "WAIT-MAX", "HOLD-P95",
                            "HOLD-TOT"])
    if args.edges and edges:
        erows = [{"HELD": e.get("held", ""),
                  "THEN-ACQUIRED": e.get("acquired", ""),
                  "FIRST-SEEN": e.get("site", "")}
                 for e in edges]
        _print_table(erows, ["HELD", "THEN-ACQUIRED", "FIRST-SEEN"])
    nesting = doc.get("selfNesting") or {}
    if nesting:
        print("same-class nesting (instance order unproven — see "
              "docs/analysis.md): "
              + ", ".join(f"{k} x{v}"
                          for k, v in sorted(nesting.items())))


def version(args) -> None:
    from .. import __version__
    print(f"theia version: {__version__}")
    try:
        doc = _request(args.manager_addr, "GET", "/version")
        print(f"theia-manager version: {doc.get('version', 'unknown')}")
    except SystemExit:
        print("theia-manager version: unavailable")


# -- parser --------------------------------------------------------------

def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="theia", description="theia-tpu command line tool")
    p.add_argument("--manager-addr", default=get_manager_addr(DEFAULT_ADDR),
                   help="theia-manager API address (env "
                        "THEIA_MANAGER_ADDR overrides the default); "
                        "`theia query` accepts a comma-separated "
                        "endpoint list and fails over across it")
    p.add_argument("--ca-cert", default="",
                   help="CA certificate for a TLS manager (the "
                        "published theia-ca.crt)")
    p.add_argument("--token", default=os.environ.get("THEIA_TOKEN", ""),
                   help="API bearer token (env THEIA_TOKEN); required "
                        "for mutating calls on an authenticated "
                        "manager")
    p.add_argument("--token-file", default="",
                   help="read the API bearer token from this file "
                        "(e.g. the manager's --auth-token-file)")
    p.add_argument("--use-port-forward", action="store_true",
                   help="tunnel to the in-cluster manager Service via "
                        "`kubectl port-forward` (reference CLI "
                        "default; needs a kubeconfig)")
    p.add_argument("--namespace", default="flow-visibility",
                   help="manager namespace for --use-port-forward")
    p.add_argument("--service", default="theia-manager",
                   help="manager Service for --use-port-forward")
    p.add_argument("--kubectl", default="kubectl",
                   help="kubectl binary for --use-port-forward")
    p.add_argument("-v", "--verbosity", type=int, default=0,
                   help="log verbosity (klog-style)")
    sub = p.add_subparsers(dest="command", required=True)

    def quantity(flag):
        def parse(value):
            try:
                return validate_k8s_quantity(value, flag)
            except ValueError as e:
                raise argparse.ArgumentTypeError(str(e))
        return parse

    def sizing_flags(run):
        """Job resource sizing (reference CRD spec fields validated at
        pkg/controller/networkpolicyrecommendation/controller.go:586-608;
        defaults from pkg/theia/commands/policy_recommendation_run.go:
        324-352 — 1 executor, 200m CPU, 512M memory)."""
        run.add_argument("--executor-instances",
                         dest="executor_instances", type=int, default=1)
        run.add_argument("--driver-core-request",
                         dest="driver_core_request", default="200m",
                         type=quantity("driver-core-request"))
        run.add_argument("--driver-memory", dest="driver_memory",
                         default="512M", type=quantity("driver-memory"))
        run.add_argument("--executor-core-request",
                         dest="executor_core_request", default="200m",
                         type=quantity("executor-core-request"))
        run.add_argument("--executor-memory", dest="executor_memory",
                         default="512M",
                         type=quantity("executor-memory"))

    def add_job_commands(group, run_fn, status_fn, retrieve_fn, list_fn,
                         delete_fn, run_flags):
        gsub = group.add_subparsers(dest="action", required=True)
        run = gsub.add_parser("run")
        run_flags(run)
        run.add_argument("--wait", action="store_true")
        run.add_argument("-f", "--file", default="")
        run.set_defaults(fn=run_fn)
        for action, fn, needs_name in (
                ("status", status_fn, True), ("retrieve", retrieve_fn,
                                              True),
                ("list", list_fn, False), ("delete", delete_fn, True)):
            sp = gsub.add_parser(action)
            if needs_name:
                sp.add_argument("name")
            if action == "retrieve":
                sp.add_argument("-f", "--file", default="")
            sp.set_defaults(fn=fn)

    npr = sub.add_parser("policy-recommendation", aliases=["pr"])

    def npr_flags(run):
        run.add_argument("-t", "--type", default="initial",
                         choices=["initial", "subsequent"])
        run.add_argument("-l", "--limit", type=int, default=0)
        run.add_argument("-p", "--policy-type", dest="policy_type",
                         default="anp-deny-applied",
                         choices=list(POLICY_TYPES))
        run.add_argument("-s", "--start-time", dest="start_time",
                         default="")
        run.add_argument("-e", "--end-time", dest="end_time", default="")
        run.add_argument("-n", "--ns-allow-list", dest="ns_allow_list",
                         default="")
        run.add_argument("--exclude-labels", dest="exclude_labels",
                         type=lambda v: v != "false", default=True)
        run.add_argument("--to-services", dest="to_services",
                         type=lambda v: v != "false", default=True)
        sizing_flags(run)

    add_job_commands(npr, npr_run, npr_status, npr_retrieve, npr_list,
                     npr_delete, npr_flags)

    tad = sub.add_parser("throughput-anomaly-detection", aliases=["tad"])

    def tad_flags(run):
        run.add_argument("-a", "--algo", required=True,
                         choices=list(TAD_ALGOS))
        run.add_argument("-s", "--start-time", dest="start_time",
                         default="")
        run.add_argument("-e", "--end-time", dest="end_time", default="")
        run.add_argument("-n", "--ns-ignore-list", dest="ns_ignore_list",
                         default="")
        run.add_argument("--agg-flow", dest="agg_flow", default="",
                         choices=list(AGG_FLOWS))
        run.add_argument("--pod-label", dest="pod_label", default="")
        run.add_argument("--pod-name", dest="pod_name", default="")
        run.add_argument("--pod-namespace", dest="pod_namespace",
                         default="")
        run.add_argument("--external-ip", dest="external_ip", default="")
        run.add_argument("--svc-port-name", dest="svc_port_name",
                         default="")
        run.add_argument("--cluster-uuid", dest="cluster_uuid",
                         default="")
        run.add_argument("--refit-every", dest="refit_every", type=int,
                         default=1,
                         help="ARIMA refit cadence: 1 = exact "
                              "refit-per-step (default), k>1 = grouped "
                              "refits, 0 = auto for long series")
        sizing_flags(run)

    add_job_commands(tad, tad_run, tad_status, tad_retrieve, tad_list,
                     tad_delete, tad_flags)

    dd = sub.add_parser("drop-detection", aliases=["dd"],
                        help="abnormal traffic-drop detection")

    def dd_flags(run):
        run.add_argument("-t", "--type", default="initial",
                         choices=["initial"])
        run.add_argument("-s", "--start-time", dest="start_time",
                         default="")
        run.add_argument("-e", "--end-time", dest="end_time", default="")
        run.add_argument("--cluster-uuid", dest="cluster_uuid",
                         default="")

    add_job_commands(dd, dd_run, dd_status, dd_retrieve, dd_list,
                     dd_delete, dd_flags)

    fpm = sub.add_parser("pattern-mining", aliases=["fpm"],
                         help="frequent flow-pattern mining")

    def fpm_flags(run):
        run.add_argument("-m", "--min-support", dest="min_support",
                         type=int, default=0,
                         help="absolute support threshold (0 = auto: "
                              "1%% of rows, floor 2)")
        run.add_argument("-c", "--columns", default="",
                         help="comma-separated item columns")
        run.add_argument("--max-len", dest="max_len", type=int,
                         default=3, choices=[1, 2, 3])
        run.add_argument("-s", "--start-time", dest="start_time",
                         default="")
        run.add_argument("-e", "--end-time", dest="end_time",
                         default="")

    add_job_commands(fpm, fpm_run, fpm_status, fpm_retrieve, fpm_list,
                     fpm_delete, fpm_flags)

    sad = sub.add_parser("spatial-anomaly-detection", aliases=["sad"],
                         help="spatial DBSCAN over flow embeddings")

    def sad_flags(run):
        run.add_argument("--eps", type=float, default=None)
        run.add_argument("--min-samples", dest="min_samples", type=int,
                         default=None)
        run.add_argument("-s", "--start-time", dest="start_time",
                         default="")
        run.add_argument("-e", "--end-time", dest="end_time",
                         default="")

    add_job_commands(sad, sad_run, sad_status, sad_retrieve, sad_list,
                     sad_delete, sad_flags)

    ch = sub.add_parser("clickhouse")
    chsub = ch.add_subparsers(dest="action", required=True)
    status = chsub.add_parser("status")
    status.add_argument("--diskInfo", action="store_true")
    status.add_argument("--tableInfo", action="store_true")
    status.add_argument("--insertRate", action="store_true")
    status.add_argument("--stackTraces", action="store_true")
    status.add_argument("--deviceInfo", action="store_true",
                        help="accelerator inventory + HBM usage "
                             "(no reference equivalent)")
    status.set_defaults(fn=clickhouse_status)

    ing = sub.add_parser("ingest",
                         help="produce synthetic flow batches to "
                              "POST /ingest (exactly-once: stream+seq "
                              "stamped, 429 Retry-After honored)")
    ing.add_argument("--stream", default="",
                     help="producer stream id (default: random)")
    ing.add_argument("--batches", type=int, default=10)
    ing.add_argument("--series", type=int, default=64,
                     help="synthetic connection series per batch")
    ing.add_argument("--points", type=int, default=30,
                     help="points per series per batch")
    ing.add_argument("--anomaly-fraction", dest="anomaly_fraction",
                     type=float, default=0.1)
    ing.add_argument("--interval", type=float, default=0.0,
                     help="seconds between batches (0 = flat out)")
    ing.add_argument("--seed", type=int, default=0)
    ing.set_defaults(fn=ingest_cmd)

    q = sub.add_parser(
        "query",
        help="filtered aggregation over the flow store (the "
             "vectorized /query read path)")
    q.add_argument("--table", default="",
                   help="table to query: flows (default) or "
                        "__metrics__ (the stored metrics history)")
    q.add_argument("--group-by", default="",
                   help="comma-separated group-by columns "
                        "(e.g. sourceIP,destinationIP)")
    q.add_argument("--agg", action="append", default=[],
                   help="aggregate op:column (sum:octetDeltaCount, "
                        "mean:throughput) or `count`; repeatable")
    q.add_argument("--where", action="append", default=[],
                   help="filter clause: col>=443, sourceIP=10.0.0.9, "
                        "destinationIP in a,b; repeatable (ANDed)")
    q.add_argument("--start", type=int, default=None,
                   help="window start (unix seconds, inclusive)")
    q.add_argument("--end", type=int, default=None,
                   help="window end (unix seconds, exclusive)")
    q.add_argument("--time-column", default="",
                   help="window start column (default "
                        "flowStartSeconds)")
    q.add_argument("-k", type=int, default=None,
                   help="top-K groups by --order-by (0 = all)")
    q.add_argument("--order-by", default="",
                   help="aggregate label to order by (default: the "
                        "first aggregate)")
    q.add_argument("--json", action="store_true",
                   help="print the raw result document")
    q.add_argument("--explain", action="store_true",
                   help="attach the execution profile (per-part "
                        "scanned/pruned with reasons, kernel, cache, "
                        "per-peer fan-out timings) — the result rows "
                        "are identical either way")
    q.set_defaults(fn=query_cmd)

    sb = sub.add_parser("supportbundle")
    sb.add_argument("-f", "--file", default="")
    sb.set_defaults(fn=supportbundle)

    prof = sub.add_parser("profile",
                          help="capture a torch.profiler trace "
                               "(trace.json) from the manager")
    prof.add_argument("-d", "--duration", type=float, default=3.0)
    prof.add_argument("-f", "--file", default="")
    prof.set_defaults(fn=profile)

    tp = sub.add_parser("top",
                        help="live metric rates from the manager's "
                             "GET /metrics (Prometheus exposition)")
    tp.add_argument("-i", "--interval", type=float, default=2.0,
                    help="seconds between scrapes")
    tp.add_argument("-n", "--iterations", type=int, default=0,
                    help="render N tables then exit (0 = forever)")
    tp.add_argument("--no-clear", dest="no_clear", action="store_true",
                    help="append tables instead of clearing the screen")
    tp.add_argument("--cluster", action="store_true",
                    help="scrape EVERY endpoint in the (comma-"
                         "separated) --manager-addr list and render "
                         "per-node columns (rows/s, repl lag, "
                         "admission rung, parts, query/s, granule "
                         "skip ratio) plus a cluster-total row")
    tp.add_argument("--history", default="",
                    help="render sparklines from the STORED metrics "
                         "history (table __metrics__) over this "
                         "trailing window (e.g. 6h, 30m) instead of "
                         "diffing live scrapes")
    tp.add_argument("--metric", default="",
                    help="with --history: only series whose name "
                         "contains this substring")
    tp.add_argument("--node", default="",
                    help="with --history: only series recorded by "
                         "this node id")
    tp.set_defaults(fn=top)

    al = sub.add_parser("alerts",
                        help="recent alerts from the manager's ring "
                             "(detector + rule firings); --rules "
                             "shows the declarative rule set and "
                             "its hysteresis states")
    al.add_argument("--rules", action="store_true",
                    help="show the alert-rule set + per-(rule, node) "
                         "states instead of the alert ring")
    al.add_argument("--limit", type=int, default=100)
    al.add_argument("--json", action="store_true",
                    help="print the raw /alerts document")
    al.set_defaults(fn=alerts_cmd)

    tr = sub.add_parser("trace",
                        help="fetch one distributed trace by id from "
                             "any cluster node (the node stitches "
                             "every peer's spans) and render the "
                             "cross-node tree")
    tr.add_argument("trace_id", help="the traceId from an ingest ack, "
                                     "a /query result, or a span in "
                                     "/debug/traces")
    tr.set_defaults(fn=trace_cmd)

    pa = sub.add_parser("parts",
                        help="storage-engine part inventory from the "
                             "manager's GET /debug/parts: per-table "
                             "parts, tiers, formats, sort key, and "
                             "granule/index stats")
    pa.add_argument("--limit", type=int, default=64,
                    help="max per-part rows per table (the summary "
                         "header always covers everything)")
    pa.add_argument("--json", action="store_true",
                    help="print the raw /debug/parts document")
    pa.set_defaults(fn=parts_cmd)

    vw = sub.add_parser("views",
                        help="declared rollup views from the "
                             "manager's GET /debug/views: "
                             "definitions, tiers, aggregate part/row "
                             "counts, maintenance stats, loadError")
    vw.add_argument("--json", action="store_true",
                    help="print the raw /debug/views document")
    vw.set_defaults(fn=views_cmd)

    lk = sub.add_parser(
        "locks",
        help="lockdep witness: per-lock contention/hold stats, "
             "observed order edges, inversions (GET /debug/locks)")
    lk.add_argument("--json", action="store_true",
                    help="raw JSON document")
    lk.add_argument("--edges", action="store_true",
                    help="also print the observed order-edge table")
    lk.add_argument("--limit", type=int, default=30,
                    help="stats rows shown (sorted by total wait)")
    lk.set_defaults(fn=locks_cmd)

    ver = sub.add_parser("version")
    ver.set_defaults(fn=version)
    return p


def main(argv=None) -> None:
    global _CA_CERT, _TOKEN
    args = build_parser().parse_args(argv)
    _CA_CERT = getattr(args, "ca_cert", "") or ""
    _TOKEN = getattr(args, "token", "") or ""
    token_file = getattr(args, "token_file", "") or ""
    if not _TOKEN and token_file:
        try:
            with open(token_file) as f:
                _TOKEN = f.read().strip()
        except OSError as e:
            raise APIError(
                f"error: cannot read token file {token_file}: {e}")
    forwarder = None
    if getattr(args, "use_port_forward", False):
        from .portforward import PortForwarder
        forwarder = PortForwarder(args.namespace, args.service,
                                  kubectl=args.kubectl)
        local = forwarder.start()
        # a --ca-cert means the in-cluster manager serves TLS; the
        # tunnel carries the TLS bytes verbatim
        scheme = "https" if _CA_CERT else "http"
        args.manager_addr = f"{scheme}://127.0.0.1:{local}"
    from ..utils import set_verbosity
    set_verbosity(getattr(args, "verbosity", 0))
    try:
        args.fn(args)
    except BrokenPipeError:
        # stdout consumer (e.g. `| head`) closed the pipe — exit quietly
        try:
            sys.stdout.close()
        except Exception:
            pass
        raise SystemExit(0)
    finally:
        if forwarder is not None:
            forwarder.stop()


if __name__ == "__main__":
    main()
