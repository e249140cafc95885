"""Drift guard: the PyTorch port keeps its own copies of the host-only
modules it needs from theia_tpu (it may not import the reference
package). Each copy must equal its original apart from import
statements and docstrings (a copy's docstring may drop references
that only make sense in the original's history), so a change to
either's code cannot go unnoticed."""

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
)


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


@pytest.mark.parametrize("rel", COPIES)
def test_copy_matches_reference(rel):
    port = REPO / "theia_tpu_torch" / rel
    ref = REPO / "theia_tpu" / rel
    assert _without_imports(port) == _without_imports(ref), (
        f"theia_tpu_torch/{rel} drifted from theia_tpu/{rel}: "
        "copy the change across (only imports and docstrings may "
        "differ)")
