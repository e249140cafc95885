"""Drift guard: the PyTorch port keeps its own copies of the host-only
modules it needs from theia_tpu (it may not import the reference
package). Each copy must equal its original apart from import
statements and docstrings (a copy's docstring may drop references
that only make sense in the original's history), so a change to
either's code cannot go unnoticed.

A derived module (DERIVED) is the reference's module with a few named
top-level functions, class methods or class bodies rewritten for
torch; every other unit, and the module's remaining top-level
statements ("<module>"), must match its original the same way."""

from __future__ import annotations

import ast
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent

COPIES = (
    "analysis/lockdep.py",
    "utils/env.py",
    "utils/logging.py",
    "utils/faults.py",
    "obs/metrics.py",
    "schema/flow_schema.py",
    "schema/columnar.py",
    "store/wire.py",
    "data/synth.py",
    "store/views.py",
    "ingest/native.py",
    "analytics/series.py",
    "analytics/policy_gen.py",
    "utils/atomic.py",
    "utils/backoff.py",
    "utils/pool.py",
    "utils/validation.py",
    "obs/prom.py",
    "obs/history.py",
    "obs/rules.py",
    "store/wal.py",
    "store/flow_store.py",
    "store/parts.py",
    "store/migration.py",
    "store/checkpoint.py",
    "store/sharded.py",
    "store/replicated.py",
    "store/__init__.py",
    "query/plan.py",
    "query/reference.py",
    "query/result.py",
    "query/explain.py",
    "query/rollup.py",
    "query/distributed.py",
    "query/__init__.py",
    "manager/admission.py",
    "manager/collect.py",
    "manager/certs.py",
    "manager/__init__.py",
    "ingest/client.py",
    "ingest/__init__.py",
    "utils/__init__.py",
    "obs/__init__.py",
    "schema/__init__.py",
    "runner/__init__.py",
    "cluster/transport.py",
    "cluster/membership.py",
    "cluster/node.py",
    "cluster/replication.py",
    "cluster/router.py",
    "cluster/__init__.py",
    "parallel/__init__.py",
    "manager/reconciler.py",
    "dashboards/__init__.py",
    "dashboards/grafana.py",
    "dashboards/queries.py",
    "dashboards/web.py",
    "analysis/__init__.py",
    "analysis/base.py",
    "analysis/lint.py",
    "analysis/lockgraph.py",
    "cli/__init__.py",
    "cli/portforward.py",
)

#: derived module → {unit that may differ: why}. A unit is a top-level
#: function or class ("Cls" is the class's own statements, methods
#: aside), a method ("Cls.meth"), a top-level assignment (by the name
#: it binds) or "<module>" (the other top-level statements). A unit
#: whose reason starts with "left out" must be missing from the port;
#: any other listed unit may differ or be missing.
DERIVED = {
    "obs/trace.py": {
        "CAPTURE_CAP": "the most span records one profile capture keeps",
        "SPAN_CATEGORY": "the Chrome trace category of exported spans",
        "Capture": "the span records of one profile capture",
        "Capture.__init__": "as Capture",
        "_capture": "the running capture",
        "Span.__exit__": "the record carries `tid`, the thread's native "
                         "id, as the profiler's CUDA runtime events do",
        "_publish": "also appends to the running capture, to its cap",
        "start_capture": "starts a capture (manager/profiling.py)",
        "stop_capture": "ends it",
        "record": "through record_in, under the innermost open span",
        "record_in": "record()'s body, with the parent span given (it "
                     "may have closed) and `tid` in the record",
        "chrome_events": "span records as Chrome trace events on a "
                         "profile's clock",
        "current_span": "the innermost open span, the parent of a "
                        "job stage's record",
        "thread_rows": "the row of each thread's CUDA runtime calls in a "
                       "profile's trace, for the exported spans",
        "spans_for_trace": "also the spans that link the trace (a fused "
                           "step serving several requests)",
        "traced": "left out: nothing in the port called the decorator",
    },
    "runner/progress.py": {
        "JobProgress.__init__": "takes the job's kind and name for the "
                                "attrs of its stage spans",
        "JobProgress.stage": "starts the stage's clock, publishing the "
                             "previous stage's `job.stage` record",
        "JobProgress.done": "publishes the last stage's record",
        "JobProgress.fail": "publishes the last stage's record, with "
                            "the error",
        "JobProgress._end_stage": "publishes the open stage's record",
    },
    "analytics/streaming.py": {
        "StreamState": "fields annotated as torch tensors",
        "init_state": "allocates torch tensors on the given device",
        "_update": "torch ops in place of jnp",
        "stream_update": "not jitted; torch ops",
        "stream_update_sparse": "in place, through B1 on a CUDA tensor",
        "StreamingDetector.__init__": "takes device=",
        "StreamingDetector.ingest": "plan tensors to the detector's "
                                    "device, flags back with .cpu()",
    },
    "ingest/state_tier.py": {
        "_gather": "padded slots as a tensor on the state's device, "
                   "results back with .cpu().numpy()",
        "_restore": "in-place restore_state with tensors on the "
                    "state's device",
    },
    "query/kernels.py": {
        "logger": "left out: no fallback, so nothing logs",
        "_jax_state_lock": "left out: no fallback; a failure in the "
                           "torch branch raises",
        "_jax_disabled_reason": "left out: no fallback",
        "_disable_jax": "left out: no fallback",
        "_jax_fns": "left out: torch ops run eagerly, no jit cache",
        "_reduce_jax": "left out: _reduce_torch takes its place",
        "_jax_segment_reduce": "left out: _reduce_torch takes its place",
        "_reduce_torch": "bincount, index_add_ and scatter_reduce_ in "
                         "int64 on the engine's device, in _reduce_jax's "
                         "place",
        "kernel_mode": "THEIA_QUERY_JAX=1 answers 'torch'; auto answers "
                       "numpy (the reference's answer without x64)",
        "aggregate": "takes device=; the torch branch raises where the "
                     "JAX branch fell back to numpy",
        "merge_partials": "takes device= for aggregate",
    },
    "query/engine.py": {
        "QueryEngine.__init__": "takes device=, where the torch branch "
                                "of kernels.aggregate runs",
        "QueryEngine._parts_partials": "passes device= to the kernels",
        "QueryEngine._fold_stripe": "passes device= to the kernels",
        "QueryEngine._encoded_partial": "passes device= to the kernels",
        "QueryEngine._decoded_partial": "passes device= to the kernels",
    },
    "cli/__main__.py": {
        "profile": "the manager's capture is a torch.profiler "
                   "trace.json, viewed in Perfetto or chrome://tracing, "
                   "where the reference's is an XLA trace for "
                   "TensorBoard/xprof",
        "build_parser": "the profile subcommand's help says the same",
    },
    "manager/ingest.py": {
        "resolve_auto_engine": "auto resolves on the manager's torch "
                               "device, not jax.default_backend()",
        "IngestManager.__init__": "takes device= for the detectors",
    },
    "manager/jobs.py": {
        "JobController.__init__": "takes device=",
        "JobController._run_inprocess": "every job kind on the "
                                        "controller's device",
        "JobController._runner_cmd": "the port's runner, with --device "
                                     "the controller's resolved device",
        "JobController._run": "the alert push is a `job.alert_push` "
                              "span",
    },
    "runner/__main__.py": {
        "_add_common_job_flags": "--device (default cuda), the torch "
                                 "device of the job's analytics",
        "build_parser": "prog theia_tpu_torch.runner",
        "run_tad_job": "passes device=",
        "run_npr_job": "passes device=",
        "run_dd_job": "passes device=",
        "run_patterns_job": "passes device=",
        "run_spatial_job": "passes device=",
        "main": "resolve_device(--device) in place of the JAX_PLATFORMS "
                "update, exiting non-zero without a card; after the "
                "timing lines one stderr line with the device and the "
                "B1/B2/points/embed kernel launches that moved "
                "(ops/_build.py's counts), the trace summary's "
                "counterpart for the card "
                "(the parent reads a child's kernels only from its "
                "stderr tail)",
    },
    "analysis/__main__.py": {
        "run_all": "scans theia_tpu_torch/, with chip_smoke.py (the "
                   "port's script that starts managers with knobs) in "
                   "place of bench.py",
        "main": "prog python -m theia_tpu_torch.analysis and the "
                "package name in the summary line",
    },
    "analysis/waivers.py": {
        "WAIVERS": "the reference's waivers at the port's paths, "
                   "invariants unchanged; left out, as the gate fails "
                   "a waiver that matches nothing: swallowed-except:"
                   "manager/stats.py:device_infos, whose torch rewrite "
                   "probes torch.cuda without a try",
    },
    "analytics/npr.py": {
        "read_distinct_flows": "takes device= for the port's "
                               "device_distinct",
        "run_npr": "takes device=, resolved when no mesh runs; mesh "
                   "'auto' is utils.device.auto_mesh (job_mesh only "
                   "when the job runs on a card)",
    },
    "analytics/spatial.py": {
        "spatial_outliers": "the port's dbscan_points_noise on "
                            "device=, or its sharded passes over a "
                            "mesh of torch devices (one controller); "
                            "embeds with device_embeddings on device= "
                            "or the mesh's first device, and takes "
                            "embeddings given as a tensor there as "
                            "they lie, with no copy",
        "run_spatial": "takes device=, resolved when no mesh runs; "
                       "mesh 'auto' is utils.device.auto_mesh; reads "
                       "only SPATIAL_COLUMNS and spans the read "
                       "(sad.read); embeds with device_embeddings on "
                       "device= or the mesh's first device, never "
                       "with the numpy flow_embeddings",
        "device_embeddings": "flow_embeddings on the job's device: "
                             "the four columns copied as stored, then "
                             "ops/embed.py's kernel (a card) or plain "
                             "version (the CPU), in a sad.embed span",
        "embedding_device": "where a job embeds: the mesh's first "
                            "device, else device=",
        "SPATIAL_COLUMNS": "the four columns run_spatial reads from "
                           "the store; the reference reads every "
                           "column",
    },
    "parallel/engine.py": {
        "job_mesh": "counts torch.cuda.device_count() in place of "
                    "jax.devices(): None on one card or on the CPU",
    },
    "parallel/mesh.py": {
        "shard_map": "left out: no counterpart in a single-controller "
                     "mesh; each sharded step is written as explicit "
                     "phases (per shard, collective, per shard), "
                     "parallel/tad_sharded.py and the jobs' sharded "
                     "branches",
        "Mesh": "a grid of torch devices read as jax.sharding.Mesh "
                "(shape, devices, size, axis_names); one device may "
                "stand for several logical shards",
        "Mesh.__init__": "the Mesh's fields",
        "Mesh.__eq__": "meshes compare by axes and devices (the "
                       "cached_kernel key)",
        "Mesh.__hash__": "as __eq__",
        "_grid": "the numpy grid of torch.device entries",
        "_devices": "the visible CUDA cards in place of jax.devices()",
        "make_mesh": "builds the torch Mesh",
        "make_rows_mesh": "builds the torch Mesh",
        "all_gather": "jax.lax.all_gather's counterpart: cross-device "
                      "copies in shard order",
        "psum": "jax.lax.psum's counterpart: partials summed in shard "
                "order, then copied to every shard",
    },
    "analytics/drop_detection.py": {
        "run_drop_detection": "takes device=: the count matrix to the "
                              "device, the scores back with .cpu()",
    },
    "manager/api.py": {
        "TheiaManagerServer.__init__": "takes device= for ingest, "
                                       "jobs, stats, profiles and "
                                       "queries",
    },
    "manager/stats.py": {
        "StatsProvider.__init__": "takes device=",
        "StatsProvider.device_infos": "torch.cuda in place of "
                                      "jax.devices()",
    },
    "manager/profiling.py": {
        "ProfileManager.__init__": "takes device=",
        "ProfileManager._collect": "torch.profiler in place of "
                                   "jax.profiler; the spans of the "
                                   "capture go into its trace.json",
        "CAPTURE_MARK": "the marker that ties the spans' clock to the "
                        "trace's",
        "MARK_TOLERANCE_US": "how far the marker's offset may differ "
                             "from baseTimeNanoseconds' unlogged",
        "_mark": "opens the marker",
        "add_spans": "puts the capture's spans into trace.json",
    },
    "manager/__main__.py": {
        "main": "--device in place of JAX_PLATFORMS",
    },
}


class _DropImportsAndDocstrings(ast.NodeTransformer):
    def visit_Import(self, node):
        return None

    def visit_ImportFrom(self, node):
        return None

    def generic_visit(self, node):
        body = getattr(node, "body", None)
        if isinstance(body, list) and body \
                and isinstance(body[0], ast.Expr) \
                and isinstance(body[0].value, ast.Constant) \
                and isinstance(body[0].value.value, str):
            node.body = body[1:]
        return super().generic_visit(node)


def _without_imports(path: Path) -> str:
    tree = _DropImportsAndDocstrings().visit(ast.parse(path.read_text()))
    return ast.dump(tree, include_attributes=False)


def _units(path: Path) -> dict:
    """unit name → AST dump, imports and docstrings dropped (see
    DERIVED for the unit names)."""
    tree = _DropImportsAndDocstrings().visit(ast.parse(path.read_text()))
    units, rest = {}, []
    defs = (ast.FunctionDef, ast.AsyncFunctionDef)
    for node in tree.body:
        if isinstance(node, defs):
            units[node.name] = ast.dump(node)
        elif isinstance(node, ast.ClassDef):
            own = [ast.dump(ast.Tuple(node.bases + node.decorator_list))]
            for sub in node.body:
                if isinstance(sub, defs):
                    units[f"{node.name}.{sub.name}"] = ast.dump(sub)
                else:
                    own.append(ast.dump(sub))
            units[node.name] = "\n".join(own)
        elif _bound_name(node):
            name = _bound_name(node)
            units[name] = "\n".join(filter(None, (units.get(name),
                                                   ast.dump(node))))
        else:
            rest.append(ast.dump(node))
    units["<module>"] = "\n".join(rest)
    return units


def _bound_name(node):
    """The name a top-level `X = ...` or `X: T = ...` binds, else
    None."""
    if isinstance(node, ast.Assign) and len(node.targets) == 1:
        target = node.targets[0]
    elif isinstance(node, ast.AnnAssign):
        target = node.target
    else:
        return None
    return target.id if isinstance(target, ast.Name) else None


#: the cluster tier's error types, each with the module that defines
#: it (the request handlers map them to HTTP codes)
CLUSTER_ERRORS = {
    "ClusterStateError": "cluster/node.py",
    "ReplicationLagError": "cluster/replication.py",
    "StaleReadError": "cluster/replication.py",
    "RouterForwardError": "cluster/router.py",
}


@pytest.mark.parametrize("rel", COPIES)
def test_copy_matches_reference(rel):
    port = REPO / "theia_tpu_torch" / rel
    ref = REPO / "theia_tpu" / rel
    assert _without_imports(port) == _without_imports(ref), (
        f"theia_tpu_torch/{rel} drifted from theia_tpu/{rel}: "
        "copy the change across (only imports and docstrings may "
        "differ)")


@pytest.mark.parametrize("rel", sorted(DERIVED))
def test_derived_module_differs_only_where_listed(rel):
    ref = _units(REPO / "theia_tpu" / rel)
    port = _units(REPO / "theia_tpu_torch" / rel)
    allowed = DERIVED[rel]
    drifted = sorted(name for name in set(ref) | set(port)
                     if name not in allowed
                     and ref.get(name) != port.get(name))
    assert not drifted, (
        f"theia_tpu_torch/{rel} differs from theia_tpu/{rel} in "
        f"{drifted}: copy the change across, or list the unit with "
        "its reason in DERIVED")
    stale = sorted(name for name in allowed
                   if name in ref and ref[name] == port.get(name))
    assert not stale, f"{rel}: {stale} listed in DERIVED but equal"
    shipped = sorted(name for name, why in allowed.items()
                     if why.startswith("left out") and name in port)
    assert not shipped, f"{rel}: {shipped} listed as left out but present"


@pytest.mark.parametrize("name", sorted(CLUSTER_ERRORS))
def test_cluster_error_type_matches_its_original(name):
    """Each error type is the reference's class, defined where the
    reference defines it and exported by the cluster package."""
    import theia_tpu_torch.cluster as port_cluster
    rel = CLUSTER_ERRORS[name]
    ref = _units(REPO / "theia_tpu" / rel)
    port = _units(REPO / "theia_tpu_torch" / rel)
    assert port[name] == ref[name], (
        f"theia_tpu_torch/{rel}::{name} drifted from theia_tpu/{rel}")
    assert name in port_cluster.__all__
    assert getattr(port_cluster, name).__module__ == \
        "theia_tpu_torch." + rel[:-3].replace("/", ".")
