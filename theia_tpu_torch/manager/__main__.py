"""Run the theia-manager: REST API + job controllers over a FlowDatabase.

Ports theia_tpu/manager/__main__.py. `--device` (default cuda) is
where the detectors and the jobs' analytics run; without a card the
manager exits unless `--device cpu` is given. `--dispatch subprocess`
runs each job in a `python -m theia_tpu_torch.runner` child on the same
device, `--reconcile-dir` reconciles CR documents into jobs, and the
multi-node flags (--peers, --node-id, --role, --repl-acks, or
THEIA_CLUSTER_PEERS) join the cluster tier, as in the reference.

Usage:
  python -m theia_tpu_torch.manager [--device cuda|cpu] [--db flows.npz]
      [--port 11347] [--dispatch thread|subprocess] [--reconcile-dir DIR]
      [--address 0.0.0.0] [--capacity-bytes N] [--ttl-seconds N]
      [--synth N_SERIES] [--tls-cert-dir DIR [--tls-cert F --tls-key F
      [--tls-ca F]]] [--auth-token-file F | --auth-token T]

--synth seeds the store with synthetic flows (demo/e2e); --db loads a
persisted FlowDatabase (and persists results back on shutdown). With
--db, a background checkpointer also snapshots the store atomically
every --checkpoint-interval seconds (default 60; 0 disables), bounding
kill -9 data loss to one interval — the durability role the
reference's ReplicatedMergeTree+ZooKeeper plays. --wal-dir (or
THEIA_WAL_DIR) additionally journals every acknowledged insert to a
write-ahead log BEFORE it is acknowledged, tightening the loss bound
from the checkpoint interval to the WAL sync policy (THEIA_WAL_SYNC,
default interval:1 — see store/wal.py); on startup the snapshot is
loaded and the log replayed above its stamp. TTL can also come
from the THEIA_TTL_SECONDS env var (the deployment manifest sets it;
flag wins).
"""

from __future__ import annotations

import argparse
import os
import signal
import sys
import threading


def _persist_on_shutdown(db, db_path, checkpointer, log) -> bool:
    """Graceful-shutdown drain tail, in the only safe order: the WAL
    is fsynced FIRST (acknowledged rows are durable even if the final
    save fails), then the checkpointer is stopped, then the final
    snapshot is written and the now-covered WAL segments collected.
    A checkpointer whose writer thread failed to stop (wedged write)
    makes the final save unsafe — a racing late os.replace could
    clobber the newer file with the older one; both writes are atomic
    so nothing tears, but we skip the final save and say so (the
    synced WAL carries the tail). Returns True when a final snapshot
    was written."""
    sync = getattr(db, "wal_sync", None)
    if callable(sync):
        try:
            sync()
        except Exception as e:
            log.error("final WAL fsync failed: %s", e)
    stopped = checkpointer.stop() if checkpointer else True
    wrote = False
    try:
        if db_path:
            if not stopped:
                log.error(
                    "checkpoint thread wedged; SKIPPING the final "
                    "save (it could race the in-flight write) — the "
                    "synced WAL covers rows since the last completed "
                    "checkpoint")
            else:
                db.save(db_path)
                wrote = True
                # GC only up to the PREVIOUS snapshot's stamp (now in
                # <path>.prev): collecting up to the final stamp would
                # orphan the fallback snapshot if the file we just
                # wrote is later found corrupt.
                prev_stamp = getattr(checkpointer, "_gc_stamp", None)
                gc = getattr(db, "wal_gc", None)
                if prev_stamp is not None and callable(gc):
                    gc(prev_stamp)
    finally:
        # the WAL must close (final fsync) even if the save failed —
        # it is then the only durable copy of the tail
        close = getattr(db, "close_wal", None)
        if callable(close):
            close()
    return wrote


def main(argv=None) -> None:
    p = argparse.ArgumentParser(prog="theia_tpu_torch.manager")
    p.add_argument("--device", default="cuda",
                   help="torch device of the detectors and the jobs' "
                        "analytics (cuda, cuda:N or cpu)")
    p.add_argument("--config", default=None,
                   help="YAML config file (reference "
                        "cmd/theia-manager/options.go): apiServer."
                        "{apiPort,selfSignedCert,tlsCertDir}; flags win")
    p.add_argument("-v", "--verbosity", type=int, default=0,
                   help="log verbosity (klog-style)")
    p.add_argument("--db", default=None, help="FlowDatabase .npz path")
    p.add_argument("--port", type=int, default=None)
    p.add_argument("--address", default="127.0.0.1",
                   help="bind address (0.0.0.0 inside a pod)")
    p.add_argument("--capacity-bytes", type=int, default=8 << 30)
    p.add_argument("--ttl-seconds", type=int, default=None,
                   help="flow TTL; default THEIA_TTL_SECONDS env or off")
    p.add_argument("--checkpoint-interval", type=float, default=60.0,
                   help="seconds between background snapshots of --db "
                        "(0 = only save on clean shutdown)")
    p.add_argument("--wal-dir", default=None,
                   help="write-ahead log directory (env THEIA_WAL_DIR; "
                        "unset = snapshot-only durability): inserts "
                        "are journaled before acknowledgement, so "
                        "kill -9 loss is bounded by THEIA_WAL_SYNC "
                        "instead of the checkpoint interval")
    p.add_argument("--workers", type=int, default=2)
    p.add_argument("--dispatch", default="thread",
                   choices=["thread", "subprocess"],
                   help="job execution: in-process worker threads, or "
                        "one `python -m theia_tpu_torch.runner` child "
                        "per job on --device (process isolation — a "
                        "crashing kernel fails the JOB, not the "
                        "manager; the reference's Spark driver/executor "
                        "boundary)")
    p.add_argument("--synth", type=int, default=0,
                   help="seed the store with N synthetic series")
    p.add_argument("--shards", type=int, default=1,
                   help="flow store shards (the reference's ClickHouse "
                        "`shards` Helm value; >1 uses the Distributed-"
                        "table equivalent)")
    p.add_argument("--ingest-shards", type=int, default=None,
                   help="detector shards on the ingest path (default: "
                        "THEIA_INGEST_SHARDS env, else min(8, cores)); "
                        "concurrent producer streams score "
                        "concurrently, one lock per shard")
    p.add_argument("--replicas", type=int, default=1,
                   help="live copies of the logical store (the "
                        "reference's `replicas` Helm value / "
                        "ReplicatedMergeTree role): writes fan to all, "
                        "reads fail over; composes with --shards")
    p.add_argument("--tls-cert-dir", default=None,
                   help="enable TLS; certs generated/loaded here")
    p.add_argument("--tls-cert", default=None)
    p.add_argument("--tls-key", default=None)
    p.add_argument("--tls-ca", default=None,
                   help="issuing CA bundle to publish for provided certs")
    p.add_argument("--auth-token", default=None,
                   help="require this API bearer token on mutating/"
                        "ingest/bundle endpoints (env THEIA_AUTH_TOKEN)")
    p.add_argument("--auth-token-file", default=None,
                   help="require the bearer token stored here; a fresh "
                        "random token is generated into the file if "
                        "absent (mode 0600)")
    p.add_argument("--peers", default=None,
                   help="cluster peer list (env THEIA_CLUSTER_PEERS): "
                        "'id=http://host:port,...' identical on every "
                        "node; enables the multi-node tier "
                        "(docs/cluster.md)")
    p.add_argument("--node-id", default=None,
                   help="this node's id in --peers (env "
                        "THEIA_CLUSTER_SELF; default: the first peer)")
    p.add_argument("--role", default=None,
                   choices=["leader", "follower", "peer"],
                   help="cluster role (env THEIA_CLUSTER_ROLE, default "
                        "peer): leader ships its WAL to the others "
                        "(quorum acks via THEIA_REPL_ACKS); follower "
                        "applies it and redirects ingest; peer joins "
                        "the ingest-routing mesh")
    p.add_argument("--repl-acks", default=None,
                   choices=["leader", "quorum", "all"],
                   help="replication ack policy (env THEIA_REPL_ACKS, "
                        "default quorum): how many copies must hold a "
                        "batch before it is acknowledged")
    p.add_argument("--reconcile-dir", default=None,
                   help="reconcile CR YAML documents in this directory "
                        "into jobs (the CRD control-plane seam; status "
                        "written back as <name>.status.yaml)")
    args = p.parse_args(argv)

    from ..store import FlowDatabase, ShardedFlowDatabase
    from ..utils import get_logger, set_verbosity
    from .api import API_PORT, TheiaManagerServer

    set_verbosity(args.verbosity)
    log = get_logger("theia-manager")

    if args.config:
        import yaml
        with open(args.config) as f:
            conf = yaml.safe_load(f) or {}
        api_conf = conf.get("apiServer") or {}
        if args.port is None and "apiPort" in api_conf:
            args.port = int(api_conf["apiPort"])
        # TLS is on whenever the config carries TLS settings;
        # selfSignedCert=false means "use operator-provided certs from
        # the cert dir", not "plaintext" (reference options.go) — so
        # key presence, not truthiness, decides.
        if args.tls_cert_dir is None and (
                "selfSignedCert" in api_conf or "tlsCertDir" in api_conf):
            args.tls_cert_dir = str(
                api_conf.get("tlsCertDir", "/var/run/theia/tls"))
        if args.auth_token_file is None and "authTokenFile" in api_conf:
            args.auth_token_file = str(api_conf["authTokenFile"])
        log.v(1).info("loaded config from %s", args.config)

    if args.auth_token is None:
        args.auth_token = os.environ.get("THEIA_AUTH_TOKEN") or None

    from ..utils import env_int
    ttl = args.ttl_seconds
    if ttl is None:
        ttl = env_int("THEIA_TTL_SECONDS", 0) or None

    # Storage engine (THEIA_STORE_ENGINE=parts|flat, default flat):
    # the parts engine seals ingest into compressed column parts and
    # needs a directory for its cold tier + manifest — default
    # `<db path>.parts` beside the snapshot, THEIA_STORE_COLD_DIR
    # overrides, in-memory-only (pruning/compression, no tiering or
    # manifest recovery) when neither exists.
    from ..store import default_store_engine
    store_engine = default_store_engine()
    parts_dir = None
    if store_engine == "parts":
        parts_dir = (os.environ.get("THEIA_STORE_COLD_DIR")
                     or (args.db + ".parts" if args.db else None))
        print(f"store engine: parts"
              + (f" (part dir {parts_dir})" if parts_dir else
                 " (in-memory, no part directory)"),
              file=sys.stderr)

    if args.replicas > 1:
        import itertools

        from ..store import ReplicatedFlowDatabase
        _replica_seq = itertools.count()

        def _factory():
            idx = next(_replica_seq)
            rdir = (os.path.join(parts_dir, f"replica-{idx:03d}")
                    if parts_dir else None)
            if args.shards > 1:
                return ShardedFlowDatabase(n_shards=args.shards,
                                           ttl_seconds=ttl,
                                           parts_dir=rdir)
            return FlowDatabase(ttl_seconds=ttl, parts_dir=rdir)

        # Loads go through the loader even when the primary file is
        # missing: read_snapshot falls back to <path>.prev (the crash
        # window between prev-rotation and publish), and raises
        # FileNotFoundError only when NEITHER exists — an
        # os.path.exists() pre-check would silently start empty in
        # that window.
        if args.db:
            try:
                db = ReplicatedFlowDatabase.load(
                    args.db, replicas=args.replicas, factory=_factory)
            except FileNotFoundError:
                # the failed load consumed replica indices — restart
                # numbering so part dirs stay replica-000..N across
                # runs (a drifting numbering would strand old files)
                _replica_seq = itertools.count()
                db = ReplicatedFlowDatabase(replicas=args.replicas,
                                            factory=_factory)
        else:
            db = ReplicatedFlowDatabase(replicas=args.replicas,
                                        factory=_factory)
    elif args.shards > 1:
        if args.db:
            try:
                db = ShardedFlowDatabase.load(args.db,
                                              n_shards=args.shards,
                                              ttl_seconds=ttl,
                                              parts_dir=parts_dir)
            except FileNotFoundError:
                db = ShardedFlowDatabase(n_shards=args.shards,
                                         ttl_seconds=ttl,
                                         parts_dir=parts_dir)
        else:
            db = ShardedFlowDatabase(n_shards=args.shards,
                                     ttl_seconds=ttl,
                                     parts_dir=parts_dir)
    elif args.db:
        try:
            db = FlowDatabase.load(args.db, ttl_seconds=ttl,
                                   parts_dir=parts_dir)
        except FileNotFoundError:
            db = FlowDatabase(ttl_seconds=ttl, parts_dir=parts_dir)
    else:
        db = FlowDatabase(ttl_seconds=ttl, parts_dir=parts_dir)
    wal_dir = args.wal_dir or os.environ.get("THEIA_WAL_DIR") or None
    if wal_dir:
        # Attach BEFORE synth seeding / serving: recovery replays the
        # log above the snapshot stamp, then every insert is journaled
        # pre-acknowledgement.
        wal_stats = db.attach_wal(wal_dir)
        print(f"WAL at {wal_dir}: recovered "
              f"{wal_stats['recoveredRows']} rows in "
              f"{wal_stats['recoveredRecords']} records "
              f"({wal_stats['droppedRecords']} dropped)",
              file=sys.stderr)

    if args.synth:
        import contextlib

        from ..data.synth import SynthConfig, generate_flows
        # Demo seed rows are NOT journaled: a journaled seed would be
        # replayed at the next startup and then seeded again — one
        # extra seed per restart. (They still reach snapshots; demo
        # data does not need kill -9 durability.)
        suspended = getattr(db, "wal_suspended", None)
        with (suspended() if callable(suspended)
              else contextlib.nullcontext()):
            db.insert_flows(generate_flows(SynthConfig(
                n_series=args.synth, points_per_series=30,
                anomaly_fraction=0.1)))

    server = TheiaManagerServer(
        db, port=args.port if args.port is not None else API_PORT,
        workers=args.workers, capacity_bytes=args.capacity_bytes,
        address=args.address, dispatch=args.dispatch,
        tls_cert_dir=args.tls_cert_dir, tls_cert=args.tls_cert,
        tls_key=args.tls_key, tls_ca=args.tls_ca,
        auth_token=args.auth_token,
        auth_token_file=args.auth_token_file,
        ingest_shards=args.ingest_shards,
        cluster_peers=args.peers, cluster_self=args.node_id,
        cluster_role=args.role, cluster_acks=args.repl_acks,
        device=args.device)
    if server.cluster is not None:
        print(f"cluster node {server.cluster.cmap.self_id} "
              f"role={server.cluster.role} "
              f"peers={','.join(server.cluster.cmap.order)}",
              file=sys.stderr)
    if server.auth_token:
        print("API authentication enabled (bearer token)",
              file=sys.stderr)
    if server.ca_cert_path:
        print(f"CA certificate published at {server.ca_cert_path}",
              file=sys.stderr)
    print(f"theia-manager listening on {args.address}:{server.port}",
          file=sys.stderr)

    def stop(*_):
        # Only unblock serve_forever here; shutdown() would deadlock on
        # this thread (it IS the serve_forever thread) and the ordered
        # teardown below must finish before the db is persisted.
        threading.Thread(target=server.httpd.shutdown,
                         daemon=True).start()

    checkpointer = None
    if args.db and args.checkpoint_interval > 0:
        from ..store import Checkpointer
        # The store matches the on-disk file iff it was just loaded
        # from it and not re-seeded — then the first tick can skip.
        pristine = os.path.exists(args.db) and not args.synth
        checkpointer = Checkpointer(db, args.db,
                                    interval=args.checkpoint_interval,
                                    assume_current=pristine)
        checkpointer.start()
        print(f"checkpointing {args.db} every "
              f"{args.checkpoint_interval:g}s", file=sys.stderr)

    reconciler = None
    if args.reconcile_dir:
        from .reconciler import DeclarativeReconciler
        reconciler = DeclarativeReconciler(server.controller,
                                           args.reconcile_dir)
        reconciler.start()
        print(f"reconciling CRs in {args.reconcile_dir}",
              file=sys.stderr)

    signal.signal(signal.SIGINT, stop)
    signal.signal(signal.SIGTERM, stop)
    server.serve_forever()
    # Ordered drain: the HTTP server is already closed (no NEW ingest
    # or job submissions), so: finish reconciliation, drain in-flight
    # jobs, then shut the server stack down — which now WAITS for the
    # ingest insert pool (queued store-insert legs were acknowledged
    # work; dropping them on SIGTERM violated the durability
    # contract) — and only then fsync the WAL and take the final
    # checkpoint.
    if reconciler:
        reconciler.stop()
    server.controller.wait_all(timeout=60)
    server.shutdown()
    _persist_on_shutdown(db, args.db, checkpointer, log)


if __name__ == "__main__":
    main()
