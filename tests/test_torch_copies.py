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
    "obs/trace.py",
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
    "query/engine.py",
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
    "runner/progress.py",
    "ingest/client.py",
    "ingest/__init__.py",
    "utils/__init__.py",
    "obs/__init__.py",
    "schema/__init__.py",
    "runner/__init__.py",
    # the request handlers import the cluster transport's peer header
    "cluster/transport.py",
)

#: derived module → {unit that may differ: why}. A unit is a top-level
#: function or class ("Cls" is the class's own statements, methods
#: aside), a method ("Cls.meth"), a top-level assignment (by the name
#: it binds) or "<module>" (the other top-level statements). A unit
#: whose reason starts with "left out" must be missing from the port;
#: any other listed unit may differ or be missing.
DERIVED = {
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
        "logger": "left out: only the JAX branch logs (ROADMAP A15)",
        "_jax_state_lock": "left out: JAX branch, ROADMAP A15",
        "_jax_disabled_reason": "left out: JAX branch, ROADMAP A15",
        "_jax_fns": "left out: JAX branch, ROADMAP A15",
        "kernel_mode": "always numpy (the JAX branch is ROADMAP A15)",
        "aggregate": "no JAX branch",
        "_disable_jax": "left out: JAX branch, ROADMAP A15",
        "_reduce_jax": "left out: JAX branch, ROADMAP A15",
        "_jax_segment_reduce": "left out: JAX branch, ROADMAP A15",
    },
    "manager/ingest.py": {
        "resolve_auto_engine": "auto resolves on the manager's torch "
                               "device, not jax.default_backend()",
        "IngestManager.__init__": "takes device= for the detectors",
    },
    "manager/jobs.py": {
        "JobController.__init__": "takes device=; refuses subprocess "
                                  "dispatch (ROADMAP A17)",
        "JobController._run_inprocess": "every job kind on the "
                                        "controller's device",
        # unreachable once subprocess dispatch is refused: _run keeps
        # its call to _run_subprocess, never taken
        "_STAGES": "left out: subprocess dispatch only (ROADMAP A17)",
        "JobController._fmt_time": "left out: subprocess dispatch only "
                                   "(ROADMAP A17)",
        "JobController._runner_args": "left out: subprocess dispatch "
                                      "only (ROADMAP A17)",
        "JobController._runner_cmd": "left out: subprocess dispatch "
                                     "only (ROADMAP A17)",
        "JobController._run_subprocess": "left out: subprocess dispatch "
                                         "only (ROADMAP A17)",
        "JobController._merge_results": "left out: subprocess dispatch "
                                        "only (ROADMAP A17)",
    },
    "analytics/npr.py": {
        "read_distinct_flows": "takes device= for the port's "
                               "device_distinct",
        "run_npr": "takes device=; mesh 'auto' or None, one device "
                   "(the sharded DISTINCT is ROADMAP A16)",
    },
    "analytics/spatial.py": {
        "spatial_outliers": "the port's dbscan_points_noise on "
                            "device=; the mesh branch left out "
                            "(ROADMAP A16)",
        "run_spatial": "takes device=; mesh 'auto' or None, one device "
                       "(ROADMAP A16)",
    },
    "analytics/drop_detection.py": {
        "run_drop_detection": "takes device=: the count matrix to the "
                              "device, the scores back with .cpu()",
    },
    "cluster/__init__.py": {
        "__all__": "only the error types the request handlers map to "
                   "HTTP codes; the tier itself is ROADMAP A19",
        "ClusterStateError": "the reference's, from cluster/node.py "
                             "(CLUSTER_ERRORS)",
        "ReplicationLagError": "the reference's, from "
                               "cluster/replication.py (CLUSTER_ERRORS)",
        "StaleReadError": "the reference's, from cluster/replication.py "
                          "(CLUSTER_ERRORS)",
        "RouterForwardError": "the reference's, from cluster/router.py "
                              "(CLUSTER_ERRORS)",
    },
    "manager/api.py": {
        "TheiaManagerServer.__init__": "takes device= for ingest, "
                                       "jobs, stats and profiles",
    },
    "manager/stats.py": {
        "StatsProvider.__init__": "takes device=",
        "StatsProvider.device_infos": "torch.cuda in place of "
                                      "jax.devices()",
    },
    "manager/profiling.py": {
        "ProfileManager.__init__": "takes device=",
        "ProfileManager._collect": "torch.profiler in place of "
                                   "jax.profiler",
    },
    "manager/__main__.py": {
        "main": "--device in place of JAX_PLATFORMS; the cluster and "
                "reconciler flags refused (ROADMAP A19)",
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


#: the cluster tier's error types in the port's cluster/__init__.py →
#: the reference module that defines each
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
    ref = _units(REPO / "theia_tpu" / CLUSTER_ERRORS[name])
    port = _units(REPO / "theia_tpu_torch" / "cluster" / "__init__.py")
    assert port[name] == ref[name], (
        f"theia_tpu_torch/cluster/__init__.py::{name} drifted from "
        f"theia_tpu/{CLUSTER_ERRORS[name]}")
