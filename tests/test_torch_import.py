"""Import guards for the PyTorch port: theia_tpu_torch and
chip_smoke.py import neither JAX nor anything of the theia_tpu
package."""

from __future__ import annotations

import ast
import json
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
PORT_FILES = sorted((REPO / "theia_tpu_torch").rglob("*.py")) + [
    REPO / "chip_smoke.py"]

#: modules the fresh-process probe must find and import: the scoring
#: path and, from the manager slice on, the request half, the store,
#: the query layer and the control plane; from the jobs slice on, the
#: NPR, pattern-mining, spatial and drop-detection jobs; from the
#: control-plane slice on, the job runner, the reconciler, the
#: dashboards and the static analysis passes; from the scale-out slice
#: on, the multi-device job paths and the cluster tier; from the CLI
#: slice on, the `theia` CLI
SLICE_MODULES = (
    "theia_tpu_torch.ops.fused_detector",
    "theia_tpu_torch.ops.dbscan",
    "theia_tpu_torch.ops.drops",
    "theia_tpu_torch.analytics.npr",
    "theia_tpu_torch.analytics.npr_device",
    "theia_tpu_torch.analytics.policy_gen",
    "theia_tpu_torch.analytics.itemsets",
    "theia_tpu_torch.analytics.spatial",
    "theia_tpu_torch.analytics.drop_detection",
    "theia_tpu_torch.manager.ingest",
    "theia_tpu_torch.manager.api",
    "theia_tpu_torch.manager.jobs",
    "theia_tpu_torch.manager.stats",
    "theia_tpu_torch.manager.profiling",
    "theia_tpu_torch.manager.admission",
    "theia_tpu_torch.manager.__main__",
    "theia_tpu_torch.ingest.state_tier",
    "theia_tpu_torch.ingest.client",
    "theia_tpu_torch.store.wal",
    "theia_tpu_torch.store.flow_store",
    "theia_tpu_torch.store.parts",
    "theia_tpu_torch.query.engine",
    "theia_tpu_torch.query.kernels",
    "theia_tpu_torch.obs.trace",
    "theia_tpu_torch.cluster.transport",
    "theia_tpu_torch.runner.progress",
    "theia_tpu_torch.runner.__main__",
    "theia_tpu_torch.manager.reconciler",
    "theia_tpu_torch.dashboards",
    "theia_tpu_torch.dashboards.web",
    "theia_tpu_torch.analysis.lockgraph",
    "theia_tpu_torch.analysis.__main__",
    "theia_tpu_torch.parallel",
    "theia_tpu_torch.parallel.mesh",
    "theia_tpu_torch.parallel.engine",
    "theia_tpu_torch.parallel.tad_sharded",
    "theia_tpu_torch.cluster.membership",
    "theia_tpu_torch.cluster.node",
    "theia_tpu_torch.cluster.replication",
    "theia_tpu_torch.cluster.router",
    "theia_tpu_torch.cli",
    "theia_tpu_torch.cli.__main__",
    "theia_tpu_torch.cli.portforward",
)

_PROBE = """
import importlib, json, pkgutil, sys
import theia_tpu_torch
names = [m.name for m in pkgutil.walk_packages(
    theia_tpu_torch.__path__, "theia_tpu_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "theia_tpu"))
print(json.dumps({"modules": names, "bad": bad}))
"""


def test_port_imports_no_jax_and_no_reference_package():
    """In a fresh interpreter (this one has JAX loaded already)."""
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=REPO,
                         capture_output=True, text=True, timeout=300,
                         check=True)
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert set(got["modules"]) >= set(SLICE_MODULES)
    assert got["bad"] == []


def _absolute_imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=[str(p.relative_to(REPO)) for p in PORT_FILES])
def test_no_jax_or_reference_import_in_source(path):
    roots = {name.split(".")[0] for name in _absolute_imports(path)}
    assert not roots & {"jax", "jaxlib", "theia_tpu"}, (
        f"{path.relative_to(REPO)} imports {sorted(roots)}")
