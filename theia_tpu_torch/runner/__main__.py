"""The job runner: the analytics jobs behind the Spark-job CLI contract.

Replaces the reference's SparkApplication payloads with a standalone
process the controllers can spawn. Option names/forms mirror the
reference scripts so the control plane stays drop-in compatible:

  tad — plugins/anomaly-detection/anomaly_detection.py:744-778 and the
        controller arg-build pkg/controller/anomalydetector/
        controller.go:525-620 (--algo, --start_time, --end_time, --id,
        --ns-ignore-list, --agg-flow, --pod-label, --pod-name,
        --pod-namespace, --external-ip, --svc-port-name)
  npr — plugins/policy-recommendation/policy_recommendation_job.py:
        1034-1084 (--type, --limit, --option, --start_time, --end_time,
        --ns_allow_list, --id, --rm_labels, --to_services)

Instead of a JDBC URL the runner takes --db (FlowDatabase .npz path);
results are written back into the same database file, or — with --out —
into a small results-only .npz (the manager's subprocess dispatch uses
this so a job over a large snapshot doesn't rewrite the whole flows
table just to hand back a few result rows). --progress-file emits
Spark-UI-shaped progress (see progress.py).

Ports theia_tpu/runner/__main__.py. Every subcommand takes --device
(default cuda; cuda:N or cpu), the torch device its analytics run on:
the manager's subprocess dispatch passes its own. Asked for the card
on a machine without one, the runner exits non-zero before it reads
the database; it never falls back to the CPU. After the timing lines
on stderr it prints one line naming the device and the hand-written
kernels' launch counts that moved during the job (B1, B2, points,
embed): the process dies with the job, so the parent reads them from
the stderr tail it keeps on the record.

Usage:
  python -m theia_tpu_torch.runner tad --db flows.npz --algo EWMA
  python -m theia_tpu_torch.runner npr --db flows.npz --type initial -o 1
  python -m theia_tpu_torch.runner spatial --db flows.npz --device cpu
"""

from __future__ import annotations

import argparse
import datetime
import json
from typing import Optional

from ..utils import AGG_FLOWS, TAD_ALGOS

TIME_FORMAT = "%Y-%m-%d %H:%M:%S"

#: exit status for an injected/transient I/O failure (EX_TEMPFAIL):
#: the controller classifies it retry-worthy, unlike a spec error's
#: generic non-zero exit
TRANSIENT_EXIT_CODE = 75


def parse_time(value: Optional[str]) -> Optional[int]:
    if not value:
        return None
    dt = datetime.datetime.strptime(value, TIME_FORMAT)
    return int(dt.replace(tzinfo=datetime.timezone.utc).timestamp())


def _save_results(db, args) -> None:
    """--out: results-only snapshot (uncompressed: short-lived handoff
    file); default: full database written back into --db."""
    if getattr(args, "out", None):
        # all result tables, straight from the store registry — a
        # hand-kept list here silently dropped newly added kinds
        db.save(args.out, tables=tuple(db.result_tables),
                compress=False)
    else:
        db.save(args.db)


def parse_json_list(value: Optional[str]) -> list:
    if not value:
        return []
    parsed = json.loads(value)
    if not isinstance(parsed, list):
        raise argparse.ArgumentTypeError(
            f"expected a JSON list, got {value!r}")
    return parsed


def _add_common_job_flags(sp) -> None:
    """The shared job contract every subcommand carries: database
    path, time window, job id, progress file, results-only output."""
    sp.add_argument("--db", required=True,
                    help="FlowDatabase .npz path")
    sp.add_argument("-s", "--start_time", default="",
                    help=f"'{TIME_FORMAT}' UTC")
    sp.add_argument("-e", "--end_time", default="")
    sp.add_argument("-i", "--id", default=None)
    sp.add_argument("--progress-file", default=None)
    sp.add_argument("--out", default=None,
                    help="write result tables only to this .npz "
                         "(skips saving the full db back to --db)")
    sp.add_argument("--device", default="cuda",
                    help="torch device of the job's analytics (cuda, "
                         "cuda:N or cpu); cuda without a card exits "
                         "with an error")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="theia_tpu_torch.runner",
        description="PyTorch analytics job runner")
    sub = p.add_subparsers(dest="job", required=True)

    tad = sub.add_parser("tad", help="throughput anomaly detection")
    _add_common_job_flags(tad)
    tad.add_argument("-a", "--algo", required=True,
                     choices=list(TAD_ALGOS))
    tad.add_argument("-n", "--ns-ignore-list", "--ns_ignore_list",
                     dest="ns_ignore_list", default="")
    tad.add_argument("-f", "--agg-flow", dest="agg_flow", default="",
                     choices=list(AGG_FLOWS))
    tad.add_argument("-l", "--pod-label", dest="pod_label", default="")
    tad.add_argument("-N", "--pod-name", dest="pod_name", default="")
    tad.add_argument("-P", "--pod-namespace", dest="pod_namespace",
                     default="")
    tad.add_argument("-x", "--external-ip", dest="external_ip",
                     default="")
    tad.add_argument("-p", "--svc-port-name", dest="svc_port_name",
                     default="")
    tad.add_argument("-c", "--cluster-uuid", dest="cluster_uuid",
                     default="",
                     help="scope to one cluster in a multicluster store")
    tad.add_argument("--refit-every", "--refit_every",
                     dest="refit_every", type=int, default=1,
                     help="ARIMA refit cadence (1=exact per-step, "
                          "0=auto for long series)")

    npr = sub.add_parser("npr", help="network policy recommendation")
    _add_common_job_flags(npr)
    npr.add_argument("-t", "--type", dest="rec_type", default="initial",
                     choices=["initial", "subsequent"])
    npr.add_argument("-l", "--limit", type=int, default=0)
    npr.add_argument("-o", "--option", type=int, default=1,
                     choices=[1, 2, 3])
    npr.add_argument("-n", "--ns_allow_list", default="")
    npr.add_argument("--rm_labels", default="true")
    npr.add_argument("--to_services", default="true")

    dd = sub.add_parser("dropdetection",
                        help="abnormal traffic-drop detection "
                             "(theia-sf drop-detection equivalent)")
    _add_common_job_flags(dd)
    dd.add_argument("-t", "--type", dest="job_type", default="initial",
                    choices=["initial"])
    dd.add_argument("-c", "--cluster-uuid", dest="cluster_uuid",
                    default="")

    fpm = sub.add_parser("patterns",
                         help="frequent flow-pattern mining "
                              "(FP-Growth-equivalent output)")
    _add_common_job_flags(fpm)
    fpm.add_argument("-m", "--min-support", dest="min_support",
                     type=int, default=0,
                     help="absolute support threshold "
                          "(0 = auto: 1%% of rows, floor 2)")
    fpm.add_argument("-c", "--columns", default="",
                     help="comma-separated item columns "
                          "(default: ns/port/protocol set)")
    fpm.add_argument("--max-len", dest="max_len", type=int, default=3,
                     choices=[1, 2, 3])

    sp = sub.add_parser("spatial",
                        help="spatial DBSCAN anomaly detection over "
                             "flow embeddings")
    _add_common_job_flags(sp)
    sp.add_argument("--eps", type=float, default=None)
    sp.add_argument("--min-samples", dest="min_samples", type=int,
                    default=None)
    return p


def run_tad_job(args) -> str:
    from ..analytics import TadQuerySpec, run_tad
    from ..store import FlowDatabase
    from .progress import TAD_STAGES, JobProgress

    spec = TadQuerySpec(
        start_time=parse_time(args.start_time),
        end_time=parse_time(args.end_time),
        ns_ignore_list=parse_json_list(args.ns_ignore_list),
        agg_flow=args.agg_flow,
        pod_label=args.pod_label,
        pod_name=args.pod_name,
        pod_namespace=args.pod_namespace,
        external_ip=args.external_ip,
        svc_port_name=args.svc_port_name,
        cluster_uuid=args.cluster_uuid,
        refit_every=args.refit_every,
    )
    if args.pod_namespace and not (args.pod_label or args.pod_name):
        raise SystemExit(
            "invalid request: 'pod-namespace' argument can not be used "
            "alone, should be specified along pod-label or pod-name")
    progress = JobProgress(args.id or "tad", TAD_STAGES,
                           path=args.progress_file)
    try:
        db = FlowDatabase.load(args.db)
        job_id = run_tad(db, args.algo, spec, tad_id=args.id,
                         progress=progress, device=args.device)
        _save_results(db, args)
    except BaseException as e:
        progress.fail(str(e))
        raise
    return job_id


def run_npr_job(args) -> str:
    from ..analytics import run_npr
    from ..store import FlowDatabase
    from .progress import NPR_STAGES, JobProgress

    progress = JobProgress(args.id or "npr", NPR_STAGES,
                           path=args.progress_file)
    try:
        db = FlowDatabase.load(args.db)
        job_id = run_npr(
            db,
            recommendation_type=args.rec_type,
            limit=args.limit,
            option=args.option,
            start_time=parse_time(args.start_time),
            end_time=parse_time(args.end_time),
            ns_allow_list=(parse_json_list(args.ns_allow_list) or None),
            rm_labels=args.rm_labels != "false",
            to_services=args.to_services != "false",
            recommendation_id=args.id,
            progress=progress,
            device=args.device,
        )
        _save_results(db, args)
    except BaseException as e:
        progress.fail(str(e))
        raise
    return job_id


def run_dd_job(args) -> str:
    from ..analytics import run_drop_detection
    from ..store import FlowDatabase
    from .progress import DD_STAGES, JobProgress

    progress = JobProgress(args.id or "dd", DD_STAGES,
                           path=args.progress_file)
    try:
        db = FlowDatabase.load(args.db)
        job_id = run_drop_detection(
            db,
            job_type=args.job_type,
            detection_id=args.id,
            start_time=parse_time(args.start_time),
            end_time=parse_time(args.end_time),
            cluster_uuid=args.cluster_uuid,
            progress=progress,
            device=args.device,
        )
        _save_results(db, args)
    except BaseException as e:
        progress.fail(str(e))
        raise
    return job_id


def run_patterns_job(args) -> str:
    from ..analytics import run_pattern_mining
    from ..analytics.itemsets import DEFAULT_COLUMNS
    from ..store import FlowDatabase
    from .progress import FPM_STAGES, JobProgress

    progress = JobProgress(args.id or "patterns", FPM_STAGES,
                           path=args.progress_file)
    try:
        db = FlowDatabase.load(args.db)
        columns = (tuple(c.strip() for c in args.columns.split(",")
                         if c.strip())
                   if args.columns else DEFAULT_COLUMNS)
        job_id = run_pattern_mining(
            db,
            min_support=args.min_support,
            columns=columns,
            max_len=args.max_len,
            start_time=parse_time(args.start_time),
            end_time=parse_time(args.end_time),
            mining_id=args.id,
            progress=progress,
            device=args.device,
        )
        _save_results(db, args)
    except BaseException as e:
        progress.fail(str(e))
        raise
    return job_id


def run_spatial_job(args) -> str:
    from ..analytics import run_spatial
    from ..analytics.spatial import DEFAULT_EPS, DEFAULT_MIN_SAMPLES
    from ..store import FlowDatabase
    from .progress import SPATIAL_STAGES, JobProgress

    progress = JobProgress(args.id or "spatial", SPATIAL_STAGES,
                           path=args.progress_file)
    try:
        db = FlowDatabase.load(args.db)
        job_id = run_spatial(
            db,
            eps=args.eps if args.eps is not None else DEFAULT_EPS,
            min_samples=(args.min_samples
                         if args.min_samples is not None
                         else DEFAULT_MIN_SAMPLES),
            start_time=parse_time(args.start_time),
            end_time=parse_time(args.end_time),
            spatial_id=args.id,
            progress=progress,
            device=args.device,
        )
        _save_results(db, args)
    except BaseException as e:
        progress.fail(str(e))
        raise
    return job_id


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    # The device comes from argv (the manager spawns runner children
    # with its own): a card that is not there fails the job here, with
    # resolve_device's message, rather than running it on the CPU.
    from ..utils.device import resolve_device
    try:
        args.device = str(resolve_device(args.device))
    except RuntimeError as e:
        raise SystemExit(f"--device {args.device}: {e}")
    # Fault point shared with thread dispatch: THEIA_FAULTS reaches
    # this child through the env the controller spawned it with. An
    # injected error exits TRANSIENT_EXIT_CODE (the controller's
    # retry classification); an injected hang sits here until the
    # controller's deadline kill.
    import sys

    from ..utils import faults
    try:
        faults.fire("runner.exec", job=args.job)
    except faults.FaultError as e:
        print(str(e), file=sys.stderr)
        raise SystemExit(TRANSIENT_EXIT_CODE)
    runners = {"tad": run_tad_job, "npr": run_npr_job,
               "dropdetection": run_dd_job,
               "patterns": run_patterns_job,
               "spatial": run_spatial_job}
    # Trace the whole run and ship the timing summary on stderr: this
    # process dies with the job, so its obs state surfaces through the
    # stderr tail the controller keeps on the record (runner_log_tail,
    # the support bundle's runner-log source).
    from ..obs import trace
    from ..ops import _build
    # the line's name of each kernel library
    labels = {"B1": "stream_scan", "B2": "dbscan_noise",
              "points": "points_pairs", "embed": "flow_embed"}
    before = _build.launches()
    with trace.span("runner.job", job=args.job, id=args.id or ""):
        job_id = runners[args.job](args)
    for op, rec in trace.slowest().items():
        print(f"timing {op}: {rec['durationMs']:.1f} ms",
              file=sys.stderr)
    # the child's counterpart of the trace summary for the card: its
    # device, and each hand-written kernel's launches in this job
    after = _build.launches()
    moved = {label: after.get(lib, 0) - before.get(lib, 0)
             for label, lib in labels.items()}
    print(", ".join([f"device {args.device}"]
                    + [f"{label} launches {n}"
                       for label, n in moved.items() if n]),
          file=sys.stderr)
    print(json.dumps({"id": job_id, "state": "COMPLETED"}))


if __name__ == "__main__":
    main()
