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
from theia_tpu_torch.store.parts import PART_FORMAT_SORTED
from test_torch_analysis import port_lockdep_clean  # noqa: F401

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


def test_explicit_mesh_flags_equal_one_device():
    """An explicit 8-shard CPU mesh: spatial_outliers finds the noise
    flows of mesh=None (the row count does not divide the shards), and
    run_spatial over it writes the same `spatialnoise` rows."""
    from theia_tpu_torch.parallel import make_mesh
    mesh = make_mesh(devices=[torch.device("cpu")] * 8)
    cfg = SynthConfig(n_series=61, points_per_series=9, seed=17)
    flows = port_generate(cfg)
    assert len(flows) % 8
    got = port_spatial.spatial_outliers(flows, mesh=mesh, block=64)
    want = port_spatial.spatial_outliers(flows, mesh=None, block=64,
                                         device="cpu")
    assert want and got == want
    dbs = FlowDatabase(), FlowDatabase()
    for db, m in zip(dbs, (mesh, None)):
        db.insert_flows(port_generate(cfg))
        db.insert_flows(ColumnarBatch.from_rows(
            _one_off_rows(), FLOW_SCHEMA, db.flows.dicts))
        port_spatial.run_spatial(db, spatial_id="s", now=3, mesh=m,
                                 device="cpu")
    assert _noise_rows(dbs[0]) and _noise_rows(dbs[0]) == \
        _noise_rows(dbs[1])


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


#: flowEndSeconds of the synth flows run 1609459200..08: this window
#: keeps the rows that end before 1609459205 and drops the one-off rows
#: (time 0)
WINDOWS = {"all": (None, None), "cut": (1609459190, 1609459205)}


def _spatial_store(kind, tmp_path):
    """A store of each engine the job reads: flat; parts with a part
    directory (sealed sorted parts, the memtable's tail); the same with
    every part demoted to the cold tier (read from its file); three
    shards. Synth flows in 100-row blocks, then the one-off rows."""
    from theia_tpu_torch.store.sharded import ShardedFlowDatabase
    if kind == "flat":
        db = FlowDatabase(engine="flat")
    elif kind == "sharded":
        db = ShardedFlowDatabase(n_shards=3, engine="flat")
    else:
        db = FlowDatabase(engine="parts", parts_config={"memtable_rows": 128},
                          parts_dir=str(tmp_path / "parts"))
    flows = port_generate(SynthConfig(n_series=61, points_per_series=9,
                                      seed=17))
    for lo in range(0, len(flows), 100):
        db.insert_flows(flows.take(np.arange(lo, min(lo + 100,
                                                     len(flows)))))
    db.insert_flows(ColumnarBatch.from_rows(_one_off_rows(), FLOW_SCHEMA))
    if kind.startswith("parts"):
        table = db.flows
        assert len(table._parts) > 1 and table._memtable_len
        assert all(p.fmt == PART_FORMAT_SORTED and p.rowid is not None
                   for p in table._parts)
        if kind == "parts_cold":
            table.demote_oldest(0)
            assert all(p.tier == "cold" for p in table._parts)
    return db


@pytest.mark.parametrize("window", sorted(WINDOWS))
@pytest.mark.parametrize("kind", ["flat", "parts", "parts_cold",
                                  "sharded"])
def test_run_spatial_reads_four_columns_and_writes_the_full_reads_rows(
        kind, window, tmp_path, monkeypatch):
    """run_spatial asks the store for SPATIAL_COLUMNS alone, in a
    `sad.read` span, and writes the `spatialnoise` rows, in their
    order, that spatial_outliers finds over every column of the same
    window."""
    from theia_tpu_torch.obs import trace
    db = _spatial_store(kind, tmp_path)
    start, end = WINDOWS[window]
    full = db.flows.select(start, end)
    assert len(full.column_names) == len(FLOW_SCHEMA)
    n_all = len(db.flows.select(None, None))
    assert 0 < len(full) <= n_all
    assert (len(full) < n_all) == (window == "cut")
    want = port_spatial.spatial_outliers(full, device="cpu")
    assert want

    calls, select = [], db.flows.select
    written, insert_rows = [], db.spatialnoise.insert_rows

    def spy(*a, **kw):
        calls.append((a, kw))
        return select(*a, **kw)

    def write(rows):
        written.extend(rows)
        return insert_rows(rows)

    monkeypatch.setattr(db.flows, "select", spy)
    monkeypatch.setattr(db.spatialnoise, "insert_rows", write)
    capture = trace.start_capture()
    try:
        port_spatial.run_spatial(db, start_time=start, end_time=end,
                                 spatial_id="s", now=3, device="cpu")
    finally:
        trace.stop_capture(capture)
    assert calls == [((start, end),
                      {"columns": port_spatial.SPATIAL_COLUMNS})]
    (read,) = [r for r in capture.records if r["op"] == "sad.read"]
    assert (read["columns"], read["rows"]) == (4, len(full))
    # the rows as the job wrote them (a sharded table scans in shard
    # order), then as the table holds them
    assert [{k: v for k, v in r.items() if k not in ("id", "timeCreated")}
            for r in written] == want
    assert _noise_rows(db) == sorted(tuple(sorted(r.items()))
                                     for r in written)


def test_embedding_and_noise_decode_read_only_spatial_columns():
    """flow_embeddings and spatial_outliers over a batch that holds
    SPATIAL_COLUMNS alone: the embedding bit-equal, the noise flows
    equal and in order, to theirs over all 52 columns."""
    flows = port_generate(SynthConfig(n_series=61, points_per_series=9,
                                      seed=17))
    flows = ColumnarBatch.concat([flows, ColumnarBatch.from_rows(
        _one_off_rows(), FLOW_SCHEMA, flows.dicts)])
    four = flows.select(port_spatial.SPATIAL_COLUMNS)
    assert list(four.column_names) == list(port_spatial.SPATIAL_COLUMNS)
    np.testing.assert_array_equal(port_spatial.flow_embeddings(four),
                                  port_spatial.flow_embeddings(flows))
    want = port_spatial.spatial_outliers(flows, device="cpu")
    assert want
    assert port_spatial.spatial_outliers(four, device="cpu") == want
