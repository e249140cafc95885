"""Port parity: spatial DBSCAN over flow embeddings, theia_tpu_torch
against theia_tpu, on the CPU (device="cpu").

`dbscan_points_noise` computes d² = |t|² + |x|² − 2·t·xᵀ in float32,
as the reference does. A pair whose exact d² lies within float32
rounding of eps² can fall either way between two summation orders
(XLA's and torch's, or the CPU's and the card's). So flags are held
equal everywhere except at a point that `chip_smoke.points_recount`
marks ambiguous: one with a pair whose float64 d² lies within
2⁻²⁰·(|x|²+|y|²) of eps², or a non-core point with such a neighbour.
On the seeded inputs of tests/test_spatial.py no point is ambiguous,
and the flags are exact; on flow embeddings the ambiguous points are
counted and excused, never chosen away.
"""

from __future__ import annotations

import importlib.util
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from theia_tpu.analytics import spatial as ref_spatial
from theia_tpu.data.synth import SynthConfig
from theia_tpu.data.synth import generate_flows as ref_generate
from theia_tpu.ops import dbscan as ref_dbscan
from theia_tpu.schema import FLOW_SCHEMA as REF_SCHEMA
from theia_tpu.schema import ColumnarBatch as RefBatch
from theia_tpu.store import FlowDatabase as RefDatabase
from theia_tpu_torch.analytics import spatial as port_spatial
from theia_tpu_torch.data.synth import generate_flows as port_generate
from theia_tpu_torch.ops import dbscan as port_dbscan
from theia_tpu_torch.schema import FLOW_SCHEMA, ColumnarBatch
from theia_tpu_torch.store import FlowDatabase

REPO = Path(__file__).resolve().parent.parent


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", REPO / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _both(points, valid, eps, min_samples, block):
    want = np.asarray(ref_dbscan.dbscan_points_noise(
        jnp.asarray(points), jnp.asarray(valid), eps=eps,
        min_samples=min_samples, block=block))
    got = port_dbscan.dbscan_points_noise(
        torch.from_numpy(points), torch.from_numpy(valid), eps=eps,
        min_samples=min_samples, block=block).numpy()
    return got, want


def _test_spatial_points():
    """tests/test_spatial.py's seeded clusters and scattered points."""
    rng = np.random.default_rng(0)
    return np.concatenate([
        rng.normal(0, 0.3, (200, 4)),
        rng.normal(10, 0.3, (150, 4)),
        rng.uniform(-50, 50, (10, 4)),
    ]).astype(np.float32)


@pytest.mark.parametrize("block", [64, 1024, 7])
def test_points_noise_matches_reference_and_brute_force(block):
    pts = _test_spatial_points()
    valid = np.ones(len(pts), bool)
    got, want = _both(pts, valid, 2.0, 4, block)
    d2 = ((pts[:, None, :] - pts[None, :, :]) ** 2).sum(-1)
    within = d2 <= 4.0
    core = within.sum(-1) >= 4
    brute = ~core & ~(within & core[None, :]).any(-1)
    _, ambiguous = _chip_smoke().points_recount(
        torch.from_numpy(pts), torch.arange(len(pts)), 2.0, 4)
    assert not ambiguous.any()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, brute)
    assert got.sum() == 10


def test_padding_and_validity_mask():
    pts = np.zeros((5, 4), np.float32)   # 5 identical points
    valid = np.asarray([True] * 3 + [False] * 2)
    # only 3 valid points < min_samples=4 -> all valid points are noise
    got, want = _both(pts, valid, 1.0, 4, 4)
    np.testing.assert_array_equal(got, [True] * 3 + [False] * 2)
    np.testing.assert_array_equal(got, want)
    # N not a multiple of the block: the padding rows are invalid
    got, want = _both(pts, np.ones(5, bool), 1.0, 4, 3)
    np.testing.assert_array_equal(got, [False] * 5)
    np.testing.assert_array_equal(got, want)


def test_points_noise_on_flow_embeddings_outside_the_eps_band():
    """The job's own input: flow embeddings at CATEGORICAL_SCALE 100.
    Flags equal the reference's and the float64 recount's at every
    point the recount does not call ambiguous."""
    flows = port_generate(SynthConfig(n_series=96, points_per_series=24,
                                      seed=21))
    emb = port_spatial.flow_embeddings(flows)
    got, want = _both(emb, np.ones(len(emb), bool), 1.0, 4, 256)
    exact, ambiguous = _chip_smoke().points_recount(
        torch.from_numpy(emb), torch.arange(len(emb)), 1.0, 4)
    exact, ambiguous = exact.numpy(), ambiguous.numpy()
    sure = ~ambiguous
    assert want.any() and sure.mean() > 0.99
    np.testing.assert_array_equal(got[sure], want[sure])
    np.testing.assert_array_equal(got[sure], exact[sure])


def test_points_noise_holds_tf32_off(monkeypatch):
    """The reference's product runs at Precision.HIGHEST: the port
    switches TF32 off for CUDA matmuls itself, whoever turned it on."""
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    assert torch.backends.cuda.matmul.allow_tf32
    pts = _test_spatial_points()
    port_dbscan.dbscan_points_noise(torch.from_numpy(pts),
                                    torch.ones(len(pts), dtype=torch.bool),
                                    eps=2.0)
    assert not torch.backends.cuda.matmul.allow_tf32


def _one_off_rows():
    """tests/test_spatial.py's two recurring services and two probes."""
    rows = []
    for i in range(40):
        rows.append({"sourceIP": "10.0.0.1", "destinationIP": "10.0.1.1",
                     "destinationTransportPort": 5432,
                     "octetDeltaCount": 5000 + (i % 7) * 10})
        rows.append({"sourceIP": "10.0.0.2", "destinationIP": "10.0.1.2",
                     "destinationTransportPort": 443,
                     "octetDeltaCount": 800 + (i % 5) * 5})
    rows.append({"sourceIP": "172.16.9.9", "destinationIP": "10.0.1.1",
                 "destinationTransportPort": 22, "octetDeltaCount": 120})
    rows.append({"sourceIP": "172.16.9.9", "destinationIP": "10.0.1.2",
                 "destinationTransportPort": 3389, "octetDeltaCount": 95})
    return rows


def test_spatial_outliers_match_reference():
    rows = _one_off_rows()
    want = ref_spatial.spatial_outliers(RefBatch.from_rows(rows, REF_SCHEMA))
    got = port_spatial.spatial_outliers(
        ColumnarBatch.from_rows(rows, FLOW_SCHEMA), device="cpu")
    assert got == want
    assert {(o["sourceIP"], o["destinationTransportPort"]) for o in got} \
        == {("172.16.9.9", 22), ("172.16.9.9", 3389)}
    assert port_spatial.spatial_outliers(
        ColumnarBatch.from_rows([], FLOW_SCHEMA), device="cpu") == []


def _noise_rows(db):
    return sorted(tuple(sorted(r.items()))
                  for r in db.spatialnoise.scan().to_rows())


def test_run_spatial_matches_reference():
    """The reference on its default mesh (8 virtual CPU devices: the
    sharded pass), the port on one device: equal `spatialnoise` rows."""
    cfg = SynthConfig(n_series=60, points_per_series=10, seed=17)
    ref_db, port_db = RefDatabase(), FlowDatabase()
    ref_db.insert_flows(ref_generate(cfg))
    port_db.insert_flows(port_generate(cfg))
    probe = {"sourceIP": "203.0.113.99", "destinationIP": "198.51.100.7",
             "destinationTransportPort": 4444, "octetDeltaCount": 1234,
             "packetDeltaCount": 3, "timeInserted": 1_700_000_000}
    ref_db.insert_flows(RefBatch.from_rows([probe], REF_SCHEMA,
                                           ref_db.flows.dicts))
    port_db.insert_flows(ColumnarBatch.from_rows([probe], FLOW_SCHEMA,
                                                 port_db.flows.dicts))
    ref_spatial.run_spatial(ref_db, spatial_id="sad-parity", now=3)
    port_spatial.run_spatial(port_db, spatial_id="sad-parity", now=3,
                             device="cpu")
    want = _noise_rows(ref_db)
    assert any(("sourceIP", "203.0.113.99") in r for r in want)
    assert _noise_rows(port_db) == want


def test_explicit_mesh_raises_naming_a16():
    batch = ColumnarBatch.from_rows(_one_off_rows(), FLOW_SCHEMA)
    with pytest.raises(NotImplementedError, match="ROADMAP A16"):
        port_spatial.spatial_outliers(batch, mesh=object(), device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP A16"):
        port_spatial.run_spatial(FlowDatabase(), mesh="rows", device="cpu")


@pytest.mark.cuda
def test_points_noise_on_card_matches_cpu_outside_the_eps_band():
    """The card's flags (cuBLAS's summation order) against the CPU's,
    with TF32 switched on before the call: equal at every point the
    float64 recount does not call ambiguous."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    flows = port_generate(SynthConfig(n_series=512, points_per_series=32,
                                      seed=5))
    emb = torch.from_numpy(port_spatial.flow_embeddings(flows))
    valid = torch.ones(len(emb), dtype=torch.bool)
    torch.backends.cuda.matmul.allow_tf32 = True
    got = port_dbscan.dbscan_points_noise(emb.cuda(), valid.cuda(),
                                          eps=1.0).cpu()
    assert not torch.backends.cuda.matmul.allow_tf32
    want = port_dbscan.dbscan_points_noise(emb, valid, eps=1.0)
    _, ambiguous = _chip_smoke().points_recount(
        emb.cuda(), torch.arange(len(emb)).cuda(), 1.0, 4)
    sure = ~ambiguous.cpu()
    assert torch.equal(got[sure], want[sure])
