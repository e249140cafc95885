"""theia-manager REST API.

Re-provides the reference's aggregated API server
(pkg/apiserver/apiserver.go:131-162 installs three groups) on the same
port (TheiaManagerAPIPort = 11347, pkg/apis/ports.go:7):

  intelligence.theia.antrea.io/v1alpha1
      networkpolicyrecommendations, throughputanomalydetectors
      (registry/intelligence/*/rest.go — Get/List/Create/Delete; Get of
      a COMPLETED job attaches results from the store)
  stats.theia.antrea.io/v1alpha1
      clickhouse (+ /diskInfo /tableInfo /insertRate /stackTraces)
  system.theia.antrea.io/v1alpha1
      supportbundles (async collect + download, reference
      registry/system/supportbundle/rest.go)

Serialization is the same JSON shape the reference's k8s types marshal
to (pkg/apis/intelligence/v1alpha1/types.go), so the CLI talks to either
server. Transport is plain HTTP on a ThreadingHTTPServer; the
reference's delegated authn/TLS sits in front of an equivalent seam.

Authentication: the reference delegates authn/authz to kube-apiserver
(cmd/theia-manager/theia-manager.go:60-83) and the CLI sends a
ServiceAccount bearer token (pkg/theia/commands/utils.go:122-144). The
equivalent here is a static bearer token (`auth_token`): when set,
every request that can mutate state or exfiltrate data — POST (job
create, /ingest, bundle collect), DELETE, the system group's bundle
status/download, AND the telemetry read paths that serve decoded
flow identities (GET /alerts, /dashboards/*) — must carry
`Authorization: Bearer <token>`. A missing/malformed header is 401
(unauthenticated); a well-formed but wrong token is 403
(unauthorized). Coarse read-only observability (healthz, version,
stats, job GETs) stays open, playing the role of the reference's
unauthenticated Grafana read path (Grafana queries ClickHouse
directly, values.yaml:38-40) — but unlike that in-cluster path this
server can bind 0.0.0.0, so anything carrying per-connection IPs is
gated.

Ports theia_tpu/manager/api.py: the handler is the reference's, and
`TheiaManagerServer(device=...)` (default "cuda") places the ingest
detectors, the job controller's analytics, the device stats and the
profiler on that device; without CUDA it raises unless device="cpu".
The dashboard routes serve the port's copy of the dashboards package.
"""

from __future__ import annotations

import io
import json
import math
import tarfile
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, Optional, Tuple

from .collect import AsyncCollector
from ..obs import metrics as _obs_metrics
from ..obs import prom as _obs_prom
from ..obs import trace as _obs_trace
from .jobs import (
    KIND_DD,
    KIND_FPM,
    KIND_NPR,
    KIND_SPATIAL,
    KIND_TAD,
    STATE_COMPLETED,
    DuplicateJobError,
    JobController,
    JobRecord,
)
from .stats import StatsProvider
from .. import __version__
from ..store import AllReplicasDownError, ReplicatedFlowDatabase
from ..utils import dump_logs, get_logger
from ..utils import faults as _faults
from ..analysis.lockdep import named_lock

logger = get_logger("apiserver")

API_PORT = 11347


class AuthError(Exception):
    """Request failed authentication (code 401) or authorization
    (code 403)."""

    def __init__(self, code: int, message: str) -> None:
        super().__init__(message)
        self.code = code

GROUP_INTELLIGENCE = "/apis/intelligence.theia.antrea.io/v1alpha1"
GROUP_STATS = "/apis/stats.theia.antrea.io/v1alpha1"
GROUP_SYSTEM = "/apis/system.theia.antrea.io/v1alpha1"

_RESOURCE_KIND = {
    "networkpolicyrecommendations": KIND_NPR,
    "throughputanomalydetectors": KIND_TAD,
    "trafficdropdetections": KIND_DD,
    "flowpatternminings": KIND_FPM,
    "spatialanomalydetections": KIND_SPATIAL,
}
_KIND_NAMES = {
    KIND_NPR: "NetworkPolicyRecommendation",
    KIND_TAD: "ThroughputAnomalyDetector",
    KIND_DD: "TrafficDropDetection",
    KIND_FPM: "FlowPatternMining",
    KIND_SPATIAL: "SpatialAnomalyDetection",
}

# Pre-serialized fragments for the two hot ingest ack shapes
# ({"rows","alerts"[,"traceId"]} and the duplicate variant). The
# ingest ingress answers every batch with one of these; building a
# fresh dict walk + json.dumps per request showed up in profiles next
# to the actual socket write.
_ACK_ROWS = b'{"rows":'
_ACK_ALERTS = b',"alerts":'
_ACK_DUP = b',"duplicate":true'
_ACK_TRACE = b',"traceId":"'


def _fast_ack_bytes(doc: Dict[str, object]) -> Optional[bytes]:
    """Serialize an ingest ack from cached fragments when it has one
    of the two fixed hot shapes; None for anything else (forwardedRows,
    degraded, parked...) — the caller falls back to json.dumps. The
    output is byte-identical to json.dumps(doc, separators=(',',':'))
    for the covered shapes."""
    try:
        rows = doc["rows"]
        alerts = doc["alerts"]
    except KeyError:
        return None
    dup = doc.get("duplicate")
    trace = doc.get("traceId")
    if len(doc) != 2 + (dup is not None) + (trace is not None):
        return None
    if type(rows) is not int or type(alerts) is not int \
            or dup not in (None, True):
        return None
    parts = [_ACK_ROWS, str(rows).encode(), _ACK_ALERTS,
             str(alerts).encode()]
    if dup:
        parts.append(_ACK_DUP)
    if trace is not None:
        if type(trace) is not str:
            return None
        try:
            tid = trace.encode("ascii")
        except UnicodeEncodeError:
            return None
        if b'"' in tid or b"\\" in tid:
            return None
        parts += [_ACK_TRACE, tid, b'"}']
    else:
        parts.append(b"}")
    return b"".join(parts)


def record_to_api(record: JobRecord, controller: JobController,
                  with_result: bool = False) -> Dict[str, object]:
    doc: Dict[str, object] = {
        "kind": _KIND_NAMES[record.kind],
        "apiVersion": "intelligence.theia.antrea.io/v1alpha1",
        "metadata": {"name": record.name},
        "status": record.status_dict(),
    }
    doc.update(record.spec)
    if with_result and record.state == STATE_COMPLETED:
        if record.kind == KIND_NPR:
            doc["status"]["recommendationOutcome"] = (  # type: ignore
                controller.recommendation_outcome(record.name))
        else:
            doc["stats"] = controller.result_stats(record.kind,
                                                   record.name)
    return doc


class SupportBundleManager(AsyncCollector):
    """Async support-bundle collection (reference supportBundleREST:
    Create spawns a collect goroutine, status polls, then download —
    rest.go:115-255,425). Contents mirror the reference ManagerDumper's
    component classes (pkg/support/dump.go:55-66): store stats (whole
    + per shard), device inventory, manager + runner logs, job records
    with progress, and recent alerts."""

    kind = "SupportBundle"

    def __init__(self, controller: JobController,
                 stats: StatsProvider, ingest=None) -> None:
        super().__init__()
        self.controller = controller
        self.stats = stats
        self.ingest = ingest

    def _collect(self) -> bytes:
        buf = io.BytesIO()
        with tarfile.open(fileobj=buf, mode="w:gz") as tar:
            def add(name: str, payload: str) -> None:
                raw = payload.encode()
                info = tarfile.TarInfo(name)
                info.size = len(raw)
                info.mtime = int(time.time())
                tar.addfile(info, io.BytesIO(raw))

            add("stats/diskInfo.json",
                json.dumps(self.stats.disk_infos(), indent=2))
            add("stats/tableInfo.json",
                json.dumps(self.stats.table_infos(), indent=2))
            add("stats/insertRate.json",
                json.dumps(self.stats.insert_rates(), indent=2))
            add("stats/stackTraces.json",
                json.dumps(self.stats.stack_traces(), indent=2))
            try:
                # touches jax.devices(): collected best-effort so a
                # wedged accelerator can't block the whole bundle
                add("stats/deviceInfo.json",
                    json.dumps(self.stats.device_infos(), indent=2))
            except Exception as e:
                add("stats/deviceInfo.json",
                    json.dumps({"error": str(e)}))
            # Per-shard store summary (sharded deployments): which
            # shard holds what — the Distributed-table operator view.
            db = self.controller.db
            if hasattr(db, "shards"):
                add("store/shards.json", json.dumps([
                    {"shard": i,
                     "flows": len(s.flows),
                     "flowBytes": s.flows.nbytes,
                     **{name: len(t) for name, t
                        in s.result_tables.items()}}
                    for i, s in enumerate(db.shards)], indent=2))
            add("jobs.json", json.dumps(
                [record_to_api(r, self.controller)
                 for r in self.controller.list()], indent=2,
                default=str))
            # Recent manager logs — the reference's ManagerDumper
            # copies log files out of the component pods
            # (pkg/support/dump.go:55-66); here the in-process ring
            # buffer is the log source.
            add("logs/theia-manager.log", dump_logs())
            # Runner children's stderr tails (the Spark driver/
            # executor pod-log class), one file per dispatched job.
            for r in self.controller.list():
                if r.runner_log_tail:
                    add(f"logs/runner-{r.name}.log",
                        r.runner_log_tail)
            if self.ingest is not None:
                from .ingest import MAX_ALERTS
                add("alerts.json", json.dumps(
                    self.ingest.recent_alerts(MAX_ALERTS),
                    indent=2, default=str))
            from ..store.migration import CURRENT_SCHEMA_VERSION
            add("version.json", json.dumps({
                "version": __version__,
                "schemaVersion": CURRENT_SCHEMA_VERSION,
                "dispatch": self.controller.dispatch,
            }, indent=2))
        return buf.getvalue()


def refresh_scrape_gauges(controller, ingest, retention) -> None:
    """Refresh the scrape-time gauges — state that is cheaper to read
    on scrape than to maintain on every write. Shared by GET /metrics
    and the metrics-history loop (obs/history.py), so the stored
    series and the live exposition agree at every tick."""
    db = controller.db
    try:
        _obs_metrics.gauge(
            "theia_store_flow_rows",
            "Current flow-table rows").set(len(db.flows))
        _obs_metrics.gauge(
            "theia_store_flow_bytes",
            "Current flow-table column bytes").set(db.flows.nbytes)
    except Exception:
        # e.g. every replica down: the store gauges go stale but
        # the rest of the registry must stay scrapeable — an
        # outage is exactly when the jobs/replica/fault series
        # matter most.
        pass
    health = controller.health()
    _obs_metrics.gauge(
        "theia_job_queue_depth",
        "Jobs waiting for a worker").set(health["queueDepth"])
    _obs_metrics.gauge(
        "theia_jobs_running",
        "Jobs currently executing").set(health["running"])
    if ingest is not None:
        live = ingest.shard_liveness()
        _obs_metrics.gauge(
            "theia_ingest_streams",
            "Active ingest streams").set(live["streams"])
        _obs_metrics.gauge(
            "theia_detector_series",
            "Tracked connection series across detector shards"
        ).set(sum(s["series"] for s in live["perShard"]))
        # Slot saturation pair: live vs capacity — read them with
        # theia_detector_series_dropped_total, which counts the
        # series silently turned away once every slot is taken.
        _obs_metrics.gauge(
            "theia_detector_series_capacity",
            "Total streaming-detector slot capacity across shards"
        ).set(sum(s.get("capacity", 0)
                  for s in live["perShard"]))
        _obs_metrics.gauge(
            "theia_ingest_insert_inflight",
            "Store-insert legs submitted but not finished (the "
            "bounded insert backlog)").set(ingest.inflight_count())
        adm = getattr(ingest, "admission", None)
        if adm is not None:
            # refresh theia_admission_level/_pressure at scrape
            # time (and let an idle manager step the ladder down)
            adm.evaluate()
    if isinstance(db, ReplicatedFlowDatabase):
        m = db.membership()
        _obs_metrics.gauge(
            "theia_replicas_live",
            "Replicas currently serving").set(len(m["live"]))
    if retention is not None:
        _obs_metrics.gauge(
            "theia_retention_usage_percent",
            "Store bytes vs retention capacity").set(
                retention.stats()["usagePercent"])
    try:
        # the getattr itself can raise on a replicated store with
        # every replica down (__getattr__ resolves via `active`)
        parts = db.store_stats().get("parts")
    except Exception:
        parts = None
    if parts:
        _obs_metrics.gauge(
            "theia_store_parts",
            "Sealed column parts in the flows table (parts "
            "engine)").set(parts["count"])
        pb = _obs_metrics.gauge(
            "theia_store_part_bytes",
            "Sealed-part bytes by tier: hot = resident "
            "encoded chunks, cold = on-disk part files",
            labelnames=("tier",))
        pb.labels(tier="hot").set(parts["hotBytes"])
        pb.labels(tier="cold").set(parts["coldBytes"])
    _refresh_lockdep_gauges()


def _refresh_lockdep_gauges() -> None:
    """Lockdep witness exposition (armed runs only): aggregate graph
    gauges plus per-lock cumulative stats. Values come from the
    witness's own accounting at scrape time — the hot path never
    touches the metrics registry for these."""
    from ..analysis import lockdep as _lockdep
    if not _lockdep.enabled():
        return
    stats = _lockdep.stats()
    _obs_metrics.gauge(
        "theia_lockdep_locks",
        "Lock classes the lockdep witness is tracking").set(
        len(_lockdep.lock_names()))
    _obs_metrics.gauge(
        "theia_lockdep_edges",
        "Distinct blocking acquisition-order edges observed").set(
        len(_lockdep.order_edges()))
    _obs_metrics.gauge(
        "theia_lockdep_inversions",
        "Lock-order inversions witnessed since start (any nonzero "
        "value is a latent deadlock)").set(
        len(_lockdep.inversions()))
    acq = _obs_metrics.gauge(
        "theia_lockdep_acquires_total",
        "Witnessed lock acquisitions by lock class (cumulative; "
        "scrape-time snapshot of the witness counters)",
        labelnames=("lock",))
    con = _obs_metrics.gauge(
        "theia_lockdep_contended_total",
        "Witnessed acquisitions that had to wait, by lock class",
        labelnames=("lock",))
    wai = _obs_metrics.gauge(
        "theia_lockdep_wait_seconds_total",
        "Cumulative seconds spent waiting for each lock class",
        labelnames=("lock",))
    hol = _obs_metrics.gauge(
        "theia_lockdep_hold_seconds_total",
        "Cumulative seconds each lock class was held",
        labelnames=("lock",))
    for name, s in stats.items():
        acq.labels(lock=name).set(s["acquires"])
        con.labels(lock=name).set(s["contended"])
        wai.labels(lock=name).set(s["waitTotalSeconds"])
        hol.labels(lock=name).set(s["holdTotalSeconds"])


class ManagerAPIHandler(BaseHTTPRequestHandler):
    server_version = f"theia-tpu-manager/{__version__}"
    # HTTP/1.1: keep-alive, so the cluster transport's persistent
    # per-peer connections (heartbeats at 1 Hz, a frame ship per
    # ingest batch, a partial per distributed query) actually reuse
    # sockets instead of paying a TCP handshake each. Every response
    # path sends Content-Length (the 1.1 framing contract).
    protocol_version = "HTTP/1.1"
    controller: JobController
    stats: StatsProvider
    bundles: SupportBundleManager
    profiles = None   # ProfileManager
    ingest = None     # IngestManager
    retention = None  # RetentionLoop
    maintenance = None  # PartMaintenanceLoop (parts engine)
    queries = None    # QueryEngine
    distqueries = None  # ClusterQueryCoordinator (routing mesh)
    cluster = None    # ClusterNode (multi-node tier)
    history = None    # MetricsHistoryLoop (scrape-to-store series)
    rules = None      # RulesEngine (alert rules over stored series)
    auth_token: Optional[str] = None
    quiet = True
    # Socket timeout (StreamRequestHandler honors it): a client that
    # declares a Content-Length then stalls mid-body would otherwise
    # hold a worker thread forever (slow-loris).
    timeout = 120
    # A response is two small send()s (headers, body); on a
    # keep-alive connection Nagle + the client's delayed ACK would
    # stall each by ~40ms — fatal for the cluster's persistent
    # peer links (heartbeats, frame ships, query partials).
    disable_nagle_algorithm = True

    def log_message(self, fmt, *args):  # noqa: N802
        logger.v(2).info("%s %s", self.address_string(), fmt % args)
        if not self.quiet:
            super().log_message(fmt, *args)

    # -- helpers ---------------------------------------------------------

    def _send_json(self, doc, code: int = 200) -> None:
        raw = json.dumps(doc, default=str).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(raw)))
        self.end_headers()
        self.wfile.write(raw)

    def _send_ingest_ack(self, doc: Dict[str, object]) -> None:
        """200 ack on the ingest hot path: cached-fragment
        serialization for the two fixed ack shapes, json.dumps
        fallback for the rest."""
        raw = _fast_ack_bytes(doc)
        if raw is None:
            self._send_json(doc)
            return
        self.send_response(200)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(raw)))
        self.end_headers()
        self.wfile.write(raw)

    def _send_error_json(self, code: int, message: str) -> None:
        # Error paths can fire BEFORE the request body was consumed
        # (auth, Content-Length validation, armed recv-side faults);
        # under HTTP/1.1 keep-alive the unread body bytes would be
        # parsed as the next request line — close instead of desync.
        self.close_connection = True
        self._send_json({"kind": "Status", "status": "Failure",
                         "message": message, "code": code}, code)

    def _send_retry_after(self, e) -> None:
        """429 Too Many Requests + Retry-After (integer header per
        RFC 9110; the JSON body carries the precise float for clients
        that can use it). Runs only on the reject path — the admit
        path never touches Retry-After math."""
        self.close_connection = True   # body may be unconsumed
        raw = json.dumps({
            "kind": "Status", "status": "Failure", "message": str(e),
            "reason": e.reason, "code": 429,
            "retryAfterSeconds": round(e.retry_after, 3),
        }).encode()
        self.send_response(429)
        self.send_header("Retry-After",
                         str(max(1, math.ceil(e.retry_after))))
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(raw)))
        self.end_headers()
        self.wfile.write(raw)

    def _require_auth(self) -> None:
        """Enforce the static bearer token (no-op when auth is off).
        Constant-time comparison; 401 for absent/malformed
        Authorization, 403 for a wrong token."""
        if self.auth_token is None:
            return
        import hmac
        header = self.headers.get("Authorization", "")
        if not header.startswith("Bearer "):
            raise AuthError(
                401, "missing or malformed Authorization header "
                     "(expected: Bearer <token>)")
        token = header[len("Bearer "):].strip()
        # compare bytes: compare_digest raises on non-ASCII str input,
        # which would turn a hostile token into a 500
        if not hmac.compare_digest(token.encode(),
                                   self.auth_token.encode()):
            raise AuthError(403, "invalid bearer token")

    def _send_auth_error(self, e: AuthError) -> None:
        self.close_connection = True   # body was never consumed
        raw = json.dumps({"kind": "Status", "status": "Failure",
                          "message": str(e), "code": e.code}).encode()
        self.send_response(e.code)
        if e.code == 401:
            self.send_header("WWW-Authenticate", "Bearer")
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(raw)))
        self.end_headers()
        self.wfile.write(raw)

    # 256 MiB: bounds what one request can make the server buffer.
    MAX_BODY_BYTES = 256 << 20

    def _read_raw_body(self) -> bytes:
        """Validated request body (Content-Length must be a sane
        non-negative size — a negative value would make read() block
        until the client hangs up, holding the worker thread)."""
        try:
            length = int(self.headers.get("Content-Length", 0))
        except ValueError:
            raise ValueError("invalid Content-Length")
        if length < 0 or length > self.MAX_BODY_BYTES:
            raise ValueError(
                f"Content-Length {length} outside "
                f"[0, {self.MAX_BODY_BYTES}]")
        return self.rfile.read(length) if length else b""

    def _read_body(self) -> Dict[str, object]:
        raw = self._read_raw_body()
        return json.loads(raw) if raw else {}

    def _query(self) -> Dict[str, str]:
        import urllib.parse
        q = urllib.parse.parse_qs(
            urllib.parse.urlsplit(self.path).query)
        return {k: v[0] for k, v in q.items()}

    def _route(self) -> Tuple[str, ...]:
        return tuple(p for p in self.path.split("?")[0].split("/") if p)

    # -- verbs -----------------------------------------------------------

    def do_GET(self) -> None:  # noqa: N802
        from ..cluster import StaleReadError
        from ..query import IncompleteResultError
        from .admission import AdmissionRejected
        try:
            self._get()
        except AuthError as e:
            self._send_auth_error(e)
        except AdmissionRejected as e:
            # heavy reads (/query) ride the pressure ladder — over
            # capacity is 429 + Retry-After, distinct from 503
            self._send_retry_after(e)
        except StaleReadError as e:
            # bounded-staleness follower read over budget: retryable
            # here after catch-up, or read from the leader
            self._send_error_json(503, str(e))
        except IncompleteResultError as e:
            # THEIA_QUERY_STRICT=1: a distributed query missing peers
            # refuses rather than answer partial — retry after heal
            self._send_error_json(503, str(e))
        except AllReplicasDownError as e:
            # "retry later", not "server bug": every store copy is out
            self._send_error_json(503, str(e))
        except KeyError:
            self._send_error_json(404, f"not found: {self.path}")
        except ValueError as e:  # malformed query params are the
            self._send_error_json(400, str(e))       # client's fault
        except Exception as e:  # surface handler bugs as 500s
            self._send_error_json(500, f"{type(e).__name__}: {e}")

    def do_POST(self) -> None:  # noqa: N802
        from ..cluster import (
            ClusterStateError,
            ReplicationLagError,
            RouterForwardError,
        )
        from ..query import IncompleteResultError
        from .admission import AdmissionRejected
        from .ingest import StreamCapacityError
        try:
            self._require_auth()   # every POST mutates state
            self._post()
        except AuthError as e:
            self._send_auth_error(e)
        except (DuplicateJobError, ClusterStateError) as e:
            self._send_error_json(409, str(e))
        except AdmissionRejected as e:
            # over CAPACITY (retry later, we are fine) — deliberately
            # distinct from 503 (the store itself is unavailable)
            self._send_retry_after(e)
        except (StreamCapacityError, AllReplicasDownError,
                ReplicationLagError, RouterForwardError,
                IncompleteResultError) as e:
            # retryable capacity/availability condition, not a client
            # payload error: quorum not met, owner unreachable, every
            # replica down — the producer's retry is dedup-idempotent
            self._send_error_json(503, str(e))
        except KeyError:
            self._send_error_json(404, f"not found: {self.path}")
        except (ValueError, json.JSONDecodeError) as e:
            self._send_error_json(400, str(e))
        except Exception as e:
            self._send_error_json(500, f"{type(e).__name__}: {e}")

    def do_DELETE(self) -> None:  # noqa: N802
        try:
            self._require_auth()   # every DELETE mutates state
            self._delete()
        except AuthError as e:
            self._send_auth_error(e)
        except AllReplicasDownError as e:
            self._send_error_json(503, str(e))
        except KeyError:
            self._send_error_json(404, f"not found: {self.path}")
        except Exception as e:
            self._send_error_json(500, f"{type(e).__name__}: {e}")

    # -- routing ---------------------------------------------------------

    def _get(self) -> None:
        parts = self._route()
        if parts == ("alerts",):
            # Alerts carry decoded source/destination IPs — the same
            # sensitivity class as the gated support bundles, so the
            # token (when configured) is required here too.
            self._require_auth()
            limit = int(self._query().get("limit", "100"))
            doc = {"alerts": self.ingest.recent_alerts(limit),
                   "rowsIngested": self.ingest.rows_ingested,
                   "detectorShards": self.ingest.n_shards}
            rules = getattr(self, "rules", None)
            if rules is not None:
                # declarative alert-rule states (obs/rules.py) ride
                # the same surface their firings land on
                doc["rules"] = rules.doc()
            self._send_json(doc)
            return
        if parts == ("metrics",):
            # Prometheus exposition. Latency histograms and trace
            # exemplars narrate traffic shape (and alert kinds carry
            # detector output), so the surface is token-gated when
            # auth is configured — the /alerts precedent.
            self._require_auth()
            self._send_metrics()
            return
        if parts == ("debug", "traces"):
            # Recent + slowest spans; same sensitivity class. With
            # ?trace=<id> the lookup is CLUSTER-AWARE: this node fans
            # out to live peers and stitches every node's spans for
            # that trace into one doc (&local=1 marks a peer-internal
            # lookup so the fan-out never recurses).
            self._require_auth()
            q = self._query()
            trace_id = q.get("trace", "").strip()
            if trace_id:
                local_only = q.get("local", "") in ("1", "true")
                self._send_json(self._trace_doc(trace_id, local_only))
                return
            limit = int(q.get("limit", "100"))
            self._send_json(_obs_prom.traces_doc(limit))
            return
        if parts == ("debug", "slow_queries"):
            # Captured slow-query profiles carry plans (flow
            # identities) — token-gated like /debug/traces.
            self._require_auth()
            from ..query.explain import SLOW_QUERIES
            self._send_json(SLOW_QUERIES.doc())
            return
        if parts == ("debug", "parts"):
            # Storage-engine inspection depth (`theia parts`):
            # per-table part inventories — tiers, formats, sort key,
            # index bytes, granule stats, time ranges. Part time
            # ranges narrate traffic shape and the doc names on-disk
            # paths, so token-gated like the other /debug surfaces.
            self._require_auth()
            limit = int(self._query().get("limit", "256"))
            self._send_json(self._parts_debug_doc(limit))
            return
        if parts == ("debug", "locks"):
            # Lockdep witness at inspection depth (`theia locks`):
            # per-lock contention/hold stats, observed order edges
            # with first-seen sites, inversions. Sites name source
            # files and the stats narrate traffic shape — token-gated
            # like the other /debug surfaces.
            self._require_auth()
            from ..analysis import lockdep as _lockdep
            self._send_json(_lockdep.stats_doc())
            return
        if parts == ("debug", "views"):
            # Declared rollup views at inspection depth (`theia
            # views`): definitions, tiers, per-store part/row counts,
            # maintenance stats, loadError — the /debug/parts shape
            # and sensitivity class (view definitions narrate traffic
            # shape), so token-gated.
            self._require_auth()
            from ..query.rollup import views_doc
            self._send_json(views_doc(self.controller.db))
            return
        if parts == ("query",):
            # Aggregation results decode flow identities (IPs, pods) —
            # the /alerts sensitivity class, so the token (when
            # configured) is required; the query itself rides the
            # admission pressure ladder (heavy reads shed at the
            # shed_detector rung, 429 + Retry-After).
            self._require_auth()
            q = self._query()
            self._serve_query(
                self._plan_from_get(),
                use_cache=self._cache_flag(q.get("cache", "1")),
                explain=self._explain_flag(q.get("explain")),
                use_rollup=self._cache_flag(q.get("rollup", "1")))
            return
        if parts == ("cluster", "ping"):
            # peer liveness + log-matching handshake; open (the
            # /healthz liveness class — no decoded identities). The
            # recv-side fault hook makes partition drills symmetric.
            from ..cluster.transport import NODE_HEADER, fire_recv
            fire_recv(self.headers.get(NODE_HEADER), "/cluster/ping")
            if self.cluster is None:
                raise KeyError(self.path)
            self._send_json(self.cluster.ping_doc())
            return
        if parts == ("healthz",):
            self._send_json(self._health_doc())
            return
        if parts == ("readyz",):
            doc, code = self._ready_doc()
            self._send_json(doc, code)
            return
        if parts == ("version",):
            self._send_json({"version": __version__})
            return
        if self.path.startswith(GROUP_INTELLIGENCE):
            self._get_intelligence(parts)
            return
        if self.path.startswith(GROUP_STATS):
            self._get_stats(parts)
            return
        if self.path.startswith(GROUP_SYSTEM):
            self._get_system(parts)
            return
        if parts and parts[0] == "dashboards":
            self._get_dashboard(parts)
            return
        raise KeyError(self.path)

    def _send_metrics(self) -> None:
        """Render the process registry, refreshing the scrape-time
        gauges first (shared with the metrics-history loop so both
        surfaces agree at the tick)."""
        refresh_scrape_gauges(self.controller, self.ingest,
                              self.retention)
        raw = _obs_prom.render().encode()
        self.send_response(200)
        self.send_header("Content-Type", _obs_prom.CONTENT_TYPE)
        self.send_header("Content-Length", str(len(raw)))
        self.end_headers()
        self.wfile.write(raw)

    def _parts_debug_doc(self, limit: int) -> Dict[str, object]:
        """GET /debug/parts: the parts engine at inspection depth —
        the `theia top` parts header expanded to one entry per part.
        Sharded stores report every shard table; the flat engine
        answers an empty table list (engine "flat") rather than 404,
        so the CLI can say "flat engine" instead of guessing."""
        db = self.controller.db
        flows = db.flows   # replicated: resolves the active replica
        tables = (list(flows.tables) if hasattr(flows, "tables")
                  else [flows])
        docs = []
        for i, t in enumerate(tables):
            ps = getattr(t, "parts_stats", None)
            if not callable(ps):
                continue
            tdoc: Dict[str, object] = {
                "table": t.name,
                "stats": ps(),
                "parts": t.parts_debug_entries(limit),
            }
            if len(tables) > 1:
                tdoc["shard"] = i
            docs.append(tdoc)
        return {"engine": "parts" if docs else "flat",
                "tables": docs}

    def _health_doc(self) -> Dict[str, object]:
        """Liveness + degradation surface (no decoded identities, so it
        stays on the open read path): `status` is "ok" while every
        replica serves and "degraded" when the store is down a copy
        but still serving — distinguishable from down, which /readyz
        reports. Covers replica membership/quarantine, job queue
        depth, ingest detector-shard liveness, and any armed fault
        sites (so an operator can see a fault drill is running)."""
        doc: Dict[str, object] = {
            "status": "ok",
            "jobs": self.controller.health(),
        }
        if self.ingest is not None:
            doc["ingest"] = self.ingest.shard_liveness()
            adm = getattr(self.ingest, "admission", None)
            if adm is not None:
                # current brownout rung + the pressure signals that
                # put it there (refreshed here so a scrape-only
                # manager still de-escalates); above rung 0 the
                # manager is serving but degraded
                adm.evaluate()
                doc["admission"] = adm.snapshot()
                if adm.level() > 0 and doc["status"] == "ok":
                    doc["status"] = "degraded"
            dedup = getattr(self.ingest, "dedup", None)
            if dedup is not None:
                doc["dedup"] = dedup.stats()
        db = self.controller.db
        if isinstance(db, ReplicatedFlowDatabase):
            m = db.membership()
            doc["replicas"] = m
            if m["down"] or m["quarantined"]:
                doc["status"] = "degraded"
        if self.retention is not None:
            doc["retention"] = self.retention.stats()
        # Metrics-history loop: scrape cadence, stored rows, rollup/
        # retention totals, failures — plus the rule engine's firing
        # count (the detail lives on GET /alerts).
        history = getattr(self, "history", None)
        if history is not None:
            hdoc = history.stats()
            rules = getattr(self, "rules", None)
            if rules is not None:
                hdoc["rulesFiring"] = len(rules.firing())
            doc["metricsHistory"] = hdoc
        # Query engine: executed count, worker/cold-buffer sizing,
        # kernel in use, and result-cache occupancy/hit counters.
        # (getattr like `maintenance` below: stub handler objects in
        # tests don't carry every binding)
        queries = getattr(self, "queries", None)
        if queries is not None:
            qdoc = queries.stats()
            dist = getattr(self, "distqueries", None)
            if dist is not None:
                qdoc["distributed"] = dist.stats()
            doc["query"] = qdoc
        # Storage engine + tier summary (parts engine: part counts,
        # hot/cold bytes, memtable, merge/seal/demote totals). The
        # attribute lookup itself can raise on a replicated store with
        # every replica down — healthz must keep serving `degraded`.
        try:
            store_doc = db.store_stats()
        except Exception:
            store_doc = None
        if store_doc:
            maint = getattr(self, "maintenance", None)
            if maint is not None:
                store_doc["maintenance"] = maint.stats()
            doc["store"] = store_doc
        # WAL health: segment count/bytes and the ack-durability lag
        # (records/bytes appended but not yet fsynced under the sync
        # policy) — the operator's read on the current loss bound.
        wal_stats = getattr(db, "wal_stats", None)
        if callable(wal_stats):
            try:
                ws = wal_stats()
            except Exception:
                ws = None
            if ws:
                doc["wal"] = ws
        # Cluster tier: role/term, peer liveness, replication lag or
        # follower staleness, router counters. A down peer or a
        # non-streaming follower degrades the node (it still serves).
        cluster = getattr(self, "cluster", None)
        if cluster is not None:
            cdoc = cluster.health_doc()
            if cdoc.pop("degraded", False) and doc["status"] == "ok":
                doc["status"] = "degraded"
            doc["cluster"] = cdoc
        armed = _faults.armed_sites()
        if armed:
            doc["faults"] = {"armed": armed}
        return doc

    def _ready_doc(self) -> Tuple[Dict[str, object], int]:
        """Readiness: can this manager serve reads/writes at all? All
        replicas down → 503 (take it out of rotation); degraded but
        serving → 200 (healthz carries the detail)."""
        db = self.controller.db
        try:
            if isinstance(db, ReplicatedFlowDatabase):
                db.live()
        except AllReplicasDownError as e:
            return {"ready": False, "reason": str(e)}, 503
        return {"ready": True}, 200

    def _trace_doc(self, trace_id: str,
                   local_only: bool) -> Dict[str, object]:
        """One trace's spans — local ring plus (unless `local_only`)
        every live peer's, fetched over the persistent cluster
        transport and stitched into one doc. Per-span `node` ids come
        from each recording process; timestamps are each node's OWN
        wall clock, so cross-node ordering inside the skew envelope is
        noted, not 'corrected' — fabricating an ordering would be a
        lie the renderer cannot check."""
        import urllib.parse

        from ..obs import trace as _t
        quoted = urllib.parse.quote(trace_id, safe="")
        spans = _t.spans_for_trace(trace_id)
        self_id = _t.node_id() or "local"
        for s in spans:
            if not s.get("node"):
                s["node"] = self_id
        doc: Dict[str, object] = {"trace": trace_id}
        cluster = getattr(self, "cluster", None)
        if cluster is not None and not local_only:
            from ..utils.pool import get_pool
            failed = []
            live = [p for p in cluster.cmap.others()
                    if cluster.cmap.is_alive(p)]
            failed.extend(p for p in cluster.cmap.others()
                          if p not in live)
            # concurrent fetches (the query fan-out discipline): one
            # hung peer costs one transport timeout, not its place in
            # a serial chain
            pool = get_pool("trace-fanout", 4)
            futs = [(p, pool.submit(
                cluster.transport.request, p,
                f"/debug/traces?trace={quoted}&local=1"))
                for p in live]
            for peer, fut in futs:
                try:
                    remote = fut.result()
                except Exception as e:
                    failed.append(peer)
                    logger.warning("trace fetch from %s failed: %s",
                                   peer, e)
                    continue
                # dedupe on span id: in-process test meshes share one
                # process-global ring, and a real peer re-answering a
                # retried fetch must not double its spans either
                seen = {s.get("spanId") for s in spans}
                for s in remote.get("spans") or []:
                    if s.get("spanId") in seen:
                        continue
                    if not s.get("node"):
                        s["node"] = peer
                    spans.append(s)
            if failed:
                doc["peersMissing"] = sorted(failed)
        spans.sort(key=lambda s: (s.get("startTime") or 0))
        doc["spans"] = spans
        doc["nodes"] = sorted({str(s.get("node")) for s in spans})
        if len(doc["nodes"]) > 1:
            doc["clockNote"] = (
                "span timestamps are per-node wall clocks; cross-node "
                "ordering within the nodes' clock skew is as-reported, "
                "not corrected")
        return doc

    def _get_dashboard(self, parts) -> None:
        """/dashboards/[<name>] → HTML page;
        /dashboards/api/<name>[?start=..&end=..&limit=..&k=..] → the
        underlying JSON data (the Grafana-datasource equivalent of the
        reference's read path; start/end play the $__timeFilter role);
        /dashboards/api/<name>?format=grafana → a Grafana-importable
        dashboard JSON (the reference's provisioned *.json equivalent,
        build/charts/theia/provisioning/dashboards/)."""
        # Dashboard pages and their JSON datasource serve the same
        # decoded per-flow identities the alerts do (the HTML embeds
        # the data server-side), so the whole surface is token-gated
        # when auth is configured.
        self._require_auth()
        import inspect

        from ..dashboards import DASHBOARDS, grafana_dashboard, render
        if len(parts) >= 3 and parts[1] == "api":
            qs = self._query()
            if qs.get("format") == "grafana":
                self._send_json(grafana_dashboard(parts[2]))
                return
            fn = DASHBOARDS[parts[2]]
            accepted = inspect.signature(fn).parameters
            kwargs = {name: int(qs[name]) for name
                      in ("start", "end", "limit", "k")
                      if name in qs and name in accepted}
            self._send_json({"dashboard": parts[2],
                             "data": fn(self.controller.db, **kwargs)})
            return
        name = parts[1] if len(parts) > 1 else "homepage"
        page = render(name, self.controller.db).encode()
        self.send_response(200)
        self.send_header("Content-Type", "text/html; charset=utf-8")
        self.send_header("Content-Length", str(len(page)))
        self.end_headers()
        self.wfile.write(page)

    def _get_intelligence(self, parts) -> None:
        resource = parts[3]
        kind = _RESOURCE_KIND[resource]
        if len(parts) == 4:   # list
            items = [record_to_api(r, self.controller)
                     for r in self.controller.list(kind)]
            self._send_json({
                "kind": _KIND_NAMES[kind] + "List",
                "apiVersion": "intelligence.theia.antrea.io/v1alpha1",
                "items": items})
        elif len(parts) == 5:
            record = self.controller.get(parts[4])
            if record.kind != kind:
                raise KeyError(parts[4])
            self._send_json(record_to_api(record, self.controller,
                                          with_result=True))
        else:
            raise KeyError(self.path)

    _STATS_COMPONENTS = ("diskInfo", "tableInfo", "insertRate",
                         "stackTraces", "deviceInfo", "detectorInfo")

    def _get_stats(self, parts) -> None:
        if len(parts) < 4 or parts[3] != "clickhouse":
            raise KeyError(self.path)
        component = parts[4] if len(parts) > 4 else None
        if component is not None and \
                component not in self._STATS_COMPONENTS:
            raise KeyError(self.path)
        doc: Dict[str, object] = {
            "kind": "ClickHouseStats",
            "apiVersion": "stats.theia.antrea.io/v1alpha1",
        }
        if component in (None, "diskInfo"):
            doc["diskInfos"] = self.stats.disk_infos()
        if component in (None, "tableInfo"):
            doc["tableInfos"] = self.stats.table_infos()
        if component in (None, "insertRate"):
            doc["insertRates"] = self.stats.insert_rates()
        if component in (None, "stackTraces"):
            doc["stackTraces"] = self.stats.stack_traces()
        if component in (None, "detectorInfo"):
            # Shard counts and per-shard series occupancy of the
            # ingest-path detector ensemble (no decoded identities —
            # stays on the open read path with the rest of stats).
            doc["detectorInfos"] = self.ingest.detector_stats()
        if component == "deviceInfo":
            # Opt-in only (not part of the bare-resource GET): touching
            # jax.devices() initializes a backend, which an operator
            # polling basic store stats shouldn't pay for.
            doc["deviceInfos"] = self.stats.device_infos()
        self._send_json(doc)

    def _get_system(self, parts) -> None:
        # Bundles/profiles carry logs/stats/traces — exfiltration
        # surface, so even their GETs require the token (reference
        # bundles sit behind the aggregated apiserver's delegated
        # authn).
        self._require_auth()

        def stream(data: Optional[bytes], what: str) -> None:
            if data is None:
                raise KeyError(f"{what} not collected")
            self.send_response(200)
            self.send_header("Content-Type", "application/gzip")
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)

        if len(parts) >= 4 and parts[3] == "supportbundles":
            if len(parts) == 6 and parts[5] == "download":
                stream(self.bundles.data(), "bundle")
                return
            self._send_json(self.bundles.to_api())
            return
        if len(parts) >= 4 and parts[3] == "profiles":
            if len(parts) == 6 and parts[5] == "download":
                stream(self.profiles.data(), "profile")
                return
            self._send_json(self.profiles.to_api())
            return
        raise KeyError(self.path)

    def _plan_from_get(self):
        from ..query import plan_from_params
        return plan_from_params(self._query())

    @staticmethod
    def _cache_flag(raw) -> bool:
        """`cache=0|false|no` (GET param / POST body key) bypasses the
        result cache for one query — the bench's timed windows measure
        execution, not cache hits."""
        return str(raw).strip().lower() not in ("0", "false", "no")

    @staticmethod
    def _explain_flag(raw) -> bool:
        """`explain=1|true|yes` (GET param) / `"explain": true` (POST
        body): attach the execution profile to the result doc."""
        if raw is True:
            return True
        return str(raw).strip().lower() in ("1", "true", "yes")

    def _serve_query(self, plan, use_cache: bool = True,
                     explain: bool = False,
                     use_rollup: bool = True) -> None:
        """Shared GET/POST /query tail: admission, execution, timing
        headers. 400s (PlanError is a ValueError) and 429s surface
        through the verb handlers' taxonomy. On a routing-mesh node
        the query coordinator scatter-gathers the whole cluster;
        everywhere else the local engine answers. The request's
        traceparent (if any) flows into the engine's ingress span, so
        a caller-supplied trace continues through the fan-out."""
        if self.queries is None:
            raise KeyError(self.path)
        if self.cluster is not None:
            # bounded-staleness follower reads: a copy that lost its
            # leader answers 503, not silently stale data
            self.cluster.check_query_staleness()
        adm = getattr(self.ingest, "admission", None) \
            if self.ingest is not None else None
        if adm is not None:
            adm.admit_query()
        dist = getattr(self, "distqueries", None)
        engine = dist if dist is not None else self.queries
        self._send_json(engine.execute(
            plan, use_cache=use_cache, explain=explain,
            traceparent=self.headers.get("traceparent"),
            use_rollup=use_rollup))

    def _send_ingest_redirect(self) -> None:
        """307 + Location at the current leader: this node is a
        follower and must not take writes (the Distributed-table
        'wrong shard' answer). Body carries the leader for clients
        that read JSON instead of headers."""
        target = self.cluster.leader_addr()
        if not target:
            raise AllReplicasDownError(
                "this node is a follower and no leader is known yet")
        location = target + self.path
        raw = json.dumps({
            "kind": "Status", "status": "Failure", "code": 307,
            "message": f"node {self.cluster.cmap.self_id} is a "
                       f"follower; ingest at the leader",
            "location": location}).encode()
        self.send_response(307)
        self.send_header("Location", location)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(raw)))
        self.end_headers()
        self.wfile.write(raw)

    def _post(self) -> None:
        parts = self._route()
        if parts == ("query",):
            from ..query import parse_plan
            body = self._read_body()
            self._serve_query(
                parse_plan(body),
                use_cache=self._cache_flag(body.get("cache", "1")),
                explain=self._explain_flag(body.get("explain")),
                use_rollup=self._cache_flag(body.get("rollup", "1")))
            return
        if parts == ("query", "partial"):
            self._post_query_partial()
            return
        if parts == ("ingest",):
            if self.cluster is not None and \
                    not self.cluster.accepts_ingest():
                # drain the body first: answering 307 mid-upload makes
                # some clients choke on the connection reset
                self._read_raw_body()
                self._send_ingest_redirect()
                return
            q = self._query()
            stream = q.get("stream", "default")
            seq_raw = q.get("seq")
            try:
                seq = int(seq_raw) if seq_raw is not None else None
            except ValueError:
                raise ValueError(f"seq={seq_raw!r} is not an integer")
            payload = self._read_raw_body()
            if not payload:
                raise ValueError("empty ingest payload")
            self._send_ingest_ack(self.ingest.ingest(
                payload, stream=stream, seq=seq,
                traceparent=self.headers.get("traceparent")))
            return
        if parts and parts[0] == "cluster":
            self._post_cluster(parts)
            return
        if self.path.startswith(GROUP_INTELLIGENCE) and len(parts) == 4:
            kind = _RESOURCE_KIND[parts[3]]
            body = self._read_body()
            name = (body.get("metadata") or {}).get("name")
            spec = {k: v for k, v in body.items()
                    if k not in ("kind", "apiVersion", "metadata",
                                 "status", "stats")}
            record = self.controller.create(kind, spec, name=name)
            self._send_json(record_to_api(record, self.controller), 201)
            return
        if self.path.startswith(GROUP_SYSTEM) and len(parts) >= 4 \
                and parts[3] == "supportbundles":
            self._send_json(self.bundles.create(), 201)
            return
        if self.path.startswith(GROUP_SYSTEM) and len(parts) >= 4 \
                and parts[3] == "profiles":
            body = self._read_body()
            self._send_json(self.profiles.create(
                float(body.get("durationSeconds", 3.0) or 3.0)), 201)
            return
        raise KeyError(self.path)

    def _post_query_partial(self) -> None:
        """Cluster-internal scatter-gather server half: execute the
        posted plan over the LOCAL store only and answer mergeable
        per-group partial aggregates as one binary TQPF frame (group
        keys + lowered count/sum/min/max columns — never rows).
        Token-gated like every POST; admission rides one rung ahead
        of ingest HERE TOO, so a shed peer answers 429 and the
        coordinator degrades to partial:true; the recv-side fault
        hook makes partition drills sever the read path
        symmetrically."""
        from ..cluster.transport import NODE_HEADER, fire_recv
        from ..query import parse_plan
        from ..query.distributed import serve_partial
        if self.queries is None:
            raise KeyError(self.path)
        fire_recv(self.headers.get(NODE_HEADER), "/query/partial")
        body = self._read_body()
        plan = parse_plan(body.get("plan") or {})
        adm = getattr(self.ingest, "admission", None) \
            if self.ingest is not None else None
        if adm is not None:
            adm.admit_query()
        node_id = (self.cluster.cmap.self_id
                   if self.cluster is not None else "")
        # trace ingress: the coordinator's context arrives on the
        # request, so this node's partial-execution span joins the
        # originating query's cross-node trace
        with _obs_trace.ingress_span(
                "query.partial",
                traceparent=self.headers.get("traceparent"),
                coordinator=self.headers.get(NODE_HEADER) or ""):
            raw = serve_partial(
                self.queries, plan, node_id=node_id,
                use_rollup=self._cache_flag(body.get("rollup", "1")))
        self.send_response(200)
        self.send_header("Content-Type", "application/octet-stream")
        self.send_header("Content-Length", str(len(raw)))
        self.end_headers()
        self.wfile.write(raw)

    def _post_cluster(self, parts) -> None:
        """Cluster control/replication plane (token-gated with every
        other POST): /cluster/replicate takes a batch of raw WAL
        frames, /cluster/resync a wholesale catch-up stream,
        /cluster/promote the WAL-delimited failover cutover."""
        from ..cluster.transport import NODE_HEADER, fire_recv
        if self.cluster is None or len(parts) < 2:
            raise KeyError(self.path)
        fire_recv(self.headers.get(NODE_HEADER),
                  "/" + "/".join(parts))
        # trace ingress: a leader's ship/resync span context arrives
        # on the request (cluster/replication.py mints it), so the
        # apply side of every replication RPC joins the same trace
        op = "cluster." + parts[1]
        with _obs_trace.ingress_span(
                op, traceparent=self.headers.get("traceparent"),
                peer=self.headers.get(NODE_HEADER) or ""):
            if parts == ("cluster", "replicate"):
                self._send_json(self.cluster.handle_replicate(
                    self._read_raw_body(), self.headers))
                return
            if parts == ("cluster", "resync"):
                self._send_json(self.cluster.handle_resync(
                    self._read_raw_body(), self.headers))
                return
            if parts == ("cluster", "promote"):
                body = self._read_body()
                at = body.get("atLsn")
                self._send_json(self.cluster.promote(
                    int(at) if at is not None else None))
                return
        raise KeyError(self.path)

    def _delete(self) -> None:
        parts = self._route()
        if self.path.startswith(GROUP_INTELLIGENCE) and len(parts) == 5:
            kind = _RESOURCE_KIND[parts[3]]
            record = self.controller.get(parts[4])
            if record.kind != kind:
                raise KeyError(parts[4])
            self.controller.delete(parts[4])
            self._send_json({"kind": "Status", "status": "Success"})
            return
        raise KeyError(self.path)


def resolve_auth_token(auth_token: Optional[str],
                       auth_token_file: Optional[str]) -> Optional[str]:
    """An explicit token wins; else read the token file, minting a
    fresh random token into it when absent (the deployment analogue of
    the reference's ServiceAccount token Secret, which kube generates
    and the CLI reads — pkg/theia/commands/utils.go:122-144). Returns
    None (auth off) only when neither source is configured."""
    if auth_token:
        return auth_token
    if not auth_token_file:
        return None
    import os
    import secrets
    try:
        with open(auth_token_file) as f:
            token = f.read().strip()
        if token:
            return token
    except FileNotFoundError:
        pass
    token = secrets.token_hex(32)
    fd = os.open(auth_token_file,
                 os.O_WRONLY | os.O_CREAT | os.O_TRUNC, 0o600)
    with os.fdopen(fd, "w") as f:
        f.write(token + "\n")
    logger.info("generated API bearer token at %s", auth_token_file)
    return token


class _TLSCapableServer(ThreadingHTTPServer):
    """HTTP server that performs the TLS handshake per connection on
    the worker thread — wrapping the *listening* socket would run the
    handshake inside accept() on the serve_forever thread, letting one
    silent client stall the entire API.

    Live connections are tracked so `server_close()` can SEVER them:
    with HTTP/1.1 keep-alive (the cluster transport's persistent
    per-peer connections) a handler thread otherwise keeps serving an
    established socket long after the listening socket closed — a
    shut-down node must go dark, not half-dark."""

    ssl_context = None
    handshake_timeout = 10.0

    def __init__(self, *args, **kwargs) -> None:
        self._conns: set = set()
        self._conns_lock = named_lock("api.conns")
        super().__init__(*args, **kwargs)

    def process_request(self, request, client_address):
        with self._conns_lock:
            self._conns.add(request)
        super().process_request(request, client_address)

    def shutdown_request(self, request):
        with self._conns_lock:
            self._conns.discard(request)
        super().shutdown_request(request)

    def server_close(self):
        super().server_close()
        import socket as _socket
        with self._conns_lock:
            conns = list(self._conns)
            self._conns.clear()
        for c in conns:
            try:
                c.shutdown(_socket.SHUT_RDWR)
            except OSError:
                pass

    def finish_request(self, request, client_address):
        if self.ssl_context is not None:
            request.settimeout(self.handshake_timeout)
            request = self.ssl_context.wrap_socket(request,
                                                   server_side=True)
            request.settimeout(None)
        super().finish_request(request, client_address)


class TheiaManagerServer:
    """Wires controller + stats + bundles into one HTTP server."""

    def __init__(self, db, port: int = API_PORT, workers: int = 2,
                 capacity_bytes: int = 8 << 30,
                 address: str = "127.0.0.1",
                 dispatch: str = "thread",
                 tls_cert_dir: Optional[str] = None,
                 tls_cert: Optional[str] = None,
                 tls_key: Optional[str] = None,
                 tls_ca: Optional[str] = None,
                 auth_token: Optional[str] = None,
                 auth_token_file: Optional[str] = None,
                 ingest_shards: Optional[int] = None,
                 cluster_peers: Optional[str] = None,
                 cluster_self: Optional[str] = None,
                 cluster_role: Optional[str] = None,
                 cluster_acks: Optional[str] = None,
                 device="cuda") -> None:
        import os as _os

        from .ingest import IngestManager
        self.ingest = IngestManager(db, n_shards=ingest_shards,
                                    device=device)
        device = self.ingest.device
        try:
            self.controller = JobController(
                db, workers=workers, dispatch=dispatch,
                alert_sink=self.ingest.push_alert, device=device)
        except Exception:
            # the fused engine's scorer thread is already running
            self.ingest.close()
            raise
        if self.ingest.admission is not None:
            # third pressure signal (the ingest manager wired the
            # insert backlog + WAL lag itself): a deep job queue means
            # the workers are saturated — stop piling ingest on top
            from ..utils.env import env_int as _env_int
            self.ingest.admission.add_signal(
                "jobQueue", self.controller._queue.qsize,
                _env_int("THEIA_JOB_QUEUE_HIGH", 64))
        self.stats = StatsProvider(db, capacity_bytes=capacity_bytes,
                                   device=device)
        # Vectorized read path: filtered aggregations over the store
        # (part-native on the parts engine, reference executor on
        # flat) behind GET/POST /query.
        from ..query import QueryEngine
        self.queries = QueryEngine(db, device=device)
        self.bundles = SupportBundleManager(self.controller, self.stats,
                                            ingest=self.ingest)
        from .profiling import ProfileManager
        self.profiles = ProfileManager(device=device)
        self.auth_token = resolve_auth_token(auth_token,
                                             auth_token_file)
        self.repairer = None
        # Capacity-based retention, supervised (the reference runs the
        # clickhouse-monitor sidecar unconditionally; here the loop is
        # on unless THEIA_RETENTION_INTERVAL <= 0 disables it).
        # THEIA_STORE_CAPACITY_BYTES overrides the API capacity arg as
        # the trim threshold's denominator. Constructed here (cannot
        # fail meaningfully), STARTED after the socket bind below.
        from ..utils.env import env_float, env_int
        self.retention = None
        retention_interval = env_float("THEIA_RETENTION_INTERVAL",
                                       60.0)
        if retention_interval > 0:
            from ..store import RetentionLoop
            monitor = db.monitor(
                env_int("THEIA_STORE_CAPACITY_BYTES",
                        capacity_bytes))
            self.retention = RetentionLoop(monitor,
                                           interval=retention_interval)
        # Parts engine → supervised background merge loop (compacts
        # small sealed parts; THEIA_STORE_MERGE_INTERVAL <= 0
        # disables). Constructed here, STARTED after the socket bind.
        self.maintenance = None
        merge_interval = env_float("THEIA_STORE_MERGE_INTERVAL", 5.0)
        store_stats = getattr(db, "store_stats", None)
        if merge_interval > 0 and callable(store_stats) and \
                callable(getattr(db, "maintenance_tick", None)):
            try:
                engine = store_stats().get("engine")
            except Exception:
                engine = None
            from ..query.rollup import rollup_configured
            if engine == "parts" or rollup_configured(db):
                # rollup views need the maintenance cadence (config
                # hot reload + tier folds + rollup-part compaction)
                # even on a flat flows engine — their tables are
                # parts-backed regardless, and a config source whose
                # file is torn/missing AT BOOT still needs the
                # cadence that will pick up its repair
                from ..store import PartMaintenanceLoop
                self.maintenance = PartMaintenanceLoop(
                    db, interval=merge_interval)

        # Multi-node cluster tier (theia_tpu/cluster): membership +
        # heartbeats, and per role the replication leader (WAL
        # shipping + quorum acks wired into the ingest durability
        # gate), the follower applier, or the ingest router. Off
        # entirely without a peer list — single-node managers carry
        # zero cluster overhead.
        self.cluster = None
        self.distqueries = None
        peers_spec = (cluster_peers
                      if cluster_peers is not None
                      else _os.environ.get("THEIA_CLUSTER_PEERS", ""))
        if peers_spec.strip():
            from ..cluster import ClusterNode
            self.cluster = ClusterNode(
                db, self.ingest, peers=peers_spec,
                self_id=cluster_self, role=cluster_role,
                acks=cluster_acks, token=self.auth_token or "",
                query_engine=self.queries)
            # stamp this node's id on every span it records, so the
            # cluster-stitched trace view attributes each span to the
            # node that ran it
            _obs_trace.set_node_id(self.cluster.cmap.self_id)
            # Scatter-gather /query on the routing mesh: data is
            # spread by destination hash, so the receiving node
            # coordinates a cluster-wide answer (leader/follower
            # topologies replicate the whole store — their local
            # engine already answers cluster-wide).
            if self.cluster.role == "peer" and \
                    len(self.cluster.cmap.order) > 1:
                from ..query import ClusterQueryCoordinator
                self.distqueries = ClusterQueryCoordinator(
                    self.cluster, self.queries)
            # wired unconditionally: the gate checks the node's role
            # at CALL time, so a follower promoted to leader later
            # starts enforcing the quorum without rewiring
            self.ingest.durability_gate = self.cluster.durability_gate
            if self.ingest.admission is not None:
                from ..utils.env import env_int as _env_int
                self.ingest.admission.add_signal(
                    "replLag", self.cluster.repl_lag,
                    _env_int("THEIA_REPL_LAG_HIGH", 10_000))

        # Metrics history: the scrape-to-store loop (obs/history.py)
        # snapshots the process registry into the parts-backed
        # `__metrics__` table on a cadence, downsamples/expires it,
        # and drives the declarative alert rules (obs/rules.py) over
        # the stored series THROUGH the same engine /query serves —
        # cluster-wide on a routing mesh. A non-positive
        # THEIA_METRICS_SCRAPE_INTERVAL disables the whole plane.
        # Constructed here, STARTED after the socket bind.
        self.history = None
        self.rules = None
        from ..obs.history import MetricsHistoryLoop, scrape_interval
        if scrape_interval() > 0:
            from ..obs.rules import RulesEngine
            from ..query import parse_plan

            rules_engine = (self.distqueries if self.distqueries
                            is not None else self.queries)
            self.rules = RulesEngine(
                lambda doc: rules_engine.execute(
                    parse_plan(doc), use_cache=False),
                alert_sink=self.ingest.push_alert)
            self.history = MetricsHistoryLoop(
                db,
                node=(self.cluster.cmap.self_id
                      if self.cluster is not None else ""),
                refresh=lambda: refresh_scrape_gauges(
                    self.controller, self.ingest, self.retention),
                accepts_writes=(self.cluster.accepts_ingest
                                if self.cluster is not None else None),
                rules=self.rules)

        handler = type("BoundHandler", (ManagerAPIHandler,), {
            "controller": self.controller,
            "stats": self.stats,
            "bundles": self.bundles,
            "profiles": self.profiles,
            "ingest": self.ingest,
            "retention": self.retention,
            "maintenance": self.maintenance,
            "queries": self.queries,
            "distqueries": self.distqueries,
            "cluster": self.cluster,
            "history": self.history,
            "rules": self.rules,
            "auth_token": self.auth_token,
        })
        self.httpd = _TLSCapableServer((address, port), handler)
        self.ca_cert_path: Optional[str] = None
        if tls_cert_dir is not None:
            # Self-signed (or provided) serving cert, reference
            # certificate.ApplyServerCert (manager/certs.py).
            import ssl

            from .certs import apply_server_cert
            cert, key, ca = apply_server_cert(
                tls_cert_dir, tls_cert, tls_key, tls_ca)
            ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
            ctx.minimum_version = ssl.TLSVersion.TLSv1_2
            ctx.load_cert_chain(cert, key)
            self.httpd.ssl_context = ctx
            self.ca_cert_path = ca
        self.port = self.httpd.server_address[1]
        # Replicated store → background self-healing: resync and
        # re-admit replicas auto-quarantined by failed fan-out writes
        # (manual set_replica_down marks are left alone). Started
        # last, after the socket bind and TLS setup can no longer
        # raise — a constructor failure must not leak a live repair
        # thread nothing can stop.
        if isinstance(db, ReplicatedFlowDatabase):
            from ..store import ReplicaRepairLoop
            self.repairer = ReplicaRepairLoop(db)
            self.repairer.start()
        if self.retention is not None:
            self.retention.start()
        if self.maintenance is not None:
            self.maintenance.start()
        if self.cluster is not None:
            # after the socket bind: peers probe us back immediately
            self.cluster.start()
        if self.history is not None:
            self.history.start()
        self._thread: Optional[threading.Thread] = None
        self._serving = False

    def start_background(self) -> None:
        self._serving = True
        self._thread = threading.Thread(
            target=self.httpd.serve_forever, daemon=True,
            name="theia-manager-api")
        self._thread.start()

    def serve_forever(self) -> None:
        self._serving = True
        self.httpd.serve_forever()

    def shutdown(self) -> None:
        # BaseServer.shutdown() blocks forever unless serve_forever is
        # running — guard so a never-started server can still shut down.
        if self._serving:
            self.httpd.shutdown()
        self.httpd.server_close()
        if self.repairer is not None:
            self.repairer.stop()
        if self.history is not None:
            self.history.stop()
        if self.retention is not None:
            self.retention.stop()
        if self.maintenance is not None:
            self.maintenance.stop()
        if self.cluster is not None:
            self.cluster.stop()
        self.ingest.close()
        self.controller.shutdown()
        if self._thread:
            self._thread.join(timeout=2)
