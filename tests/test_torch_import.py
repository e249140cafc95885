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
    assert "theia_tpu_torch.ops.fused_detector" in got["modules"]
    assert "theia_tpu_torch.manager.ingest" in got["modules"]
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
