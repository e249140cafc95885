"""Port parity: frequent flow-pattern mining, theia_tpu_torch against
theia_tpu, on the CPU (device="cpu").

`_support_1/2/3` against the reference's jitted counters on seeded
item matrices (integer counts, exact), including f == 1 with invalid
slots, where the reference's `pair_id` gather reads at a negative
index that the port masks before its gather. `mine_frequent_patterns`
and `run_pattern_mining` on the same flows: itemsets and supports
exact, `flowpatterns` rows equal.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from theia_tpu.analytics import itemsets as ref_its
from theia_tpu.data.synth import SynthConfig
from theia_tpu.data.synth import generate_flows as ref_generate
from theia_tpu.schema import FLOW_SCHEMA as REF_SCHEMA
from theia_tpu.schema import ColumnarBatch as RefBatch
from theia_tpu.store import FlowDatabase as RefDatabase
from theia_tpu_torch.analytics import itemsets as port_its
from theia_tpu_torch.data.synth import generate_flows as port_generate
from theia_tpu_torch.schema import FLOW_SCHEMA, ColumnarBatch
from theia_tpu_torch.store import FlowDatabase

COLUMNS = ("sourcePodNamespace", "destinationPodNamespace",
           "destinationTransportPort")


def _dense(seed, n, k, f, invalid=0.3):
    rng = np.random.default_rng(seed)
    dense = rng.integers(0, f, size=(n, k)).astype(np.int32)
    dense[rng.random((n, k)) < invalid] = -1
    return dense


def test_support_1_matches_reference():
    items = np.random.default_rng(0).integers(
        0, 50, size=(700, 4)).astype(np.int32)
    want = np.asarray(ref_its._support_1(items, n_items=64))
    got = port_its._support_1(torch.from_numpy(items), n_items=64).numpy()
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("f,k", [(1, 2), (1, 4), (2, 3), (7, 4), (13, 5)])
def test_support_2_and_3_match_reference(f, k):
    """f == 1 with both slots -1 puts the reference's pair gather at
    index -2 of a one-entry table."""
    dense = _dense(f * 10 + k, 600, k, f)
    want2 = np.asarray(ref_its._support_2(dense, f=f))
    got2 = port_its._support_2(torch.from_numpy(dense), f=f).numpy()
    np.testing.assert_array_equal(got2, want2)
    freq = np.nonzero(want2 >= 3)[0]
    p = max(len(freq), 1)
    pair_id = np.full(f * f, -1, np.int32)
    pair_id[freq] = np.arange(len(freq), dtype=np.int32)
    want3 = np.asarray(ref_its._support_3(dense, pair_id, p=p, f=f))
    got3 = port_its._support_3(torch.from_numpy(dense),
                               torch.from_numpy(pair_id), p=p, f=f).numpy()
    np.testing.assert_array_equal(got3, want3)
    assert got2.dtype == got3.dtype == np.int32


def test_support_3_masks_invalid_pair_index():
    """Every slot -1, f == 1: unmasked, the pair index would be -2 into
    a one-entry table, which torch refuses on the CPU (IndexError) and
    a CUDA gather turns into a device-side assert. The port masks it
    and counts nothing."""
    dense = torch.full((5, 3), -1, dtype=torch.int32)
    pair_id = torch.zeros(1, dtype=torch.int32)
    with pytest.raises(IndexError):
        pair_id[torch.full((5,), -2, dtype=torch.int32)]
    got = port_its._support_3(dense, pair_id, p=1, f=1)
    np.testing.assert_array_equal(got.numpy(), [0])


def _rows(seed, n=400):
    rng = np.random.default_rng(seed)
    return [{"sourcePodNamespace": f"ns-{rng.integers(3)}",
             "destinationPodNamespace": f"dst-{rng.integers(3)}",
             "destinationTransportPort": int(rng.choice([80, 443, 5432]))}
            for _ in range(n)]


@pytest.mark.parametrize("min_support,max_len", [(40, 3), (10, 2),
                                                 (130, 3), (1, 1)])
def test_mine_frequent_patterns_matches_reference(min_support, max_len):
    rows = _rows(0)
    want = ref_its.mine_frequent_patterns(
        RefBatch.from_rows(rows, REF_SCHEMA), min_support=min_support,
        columns=COLUMNS, max_len=max_len, mesh=None)
    got = port_its.mine_frequent_patterns(
        ColumnarBatch.from_rows(rows, FLOW_SCHEMA), min_support=min_support,
        columns=COLUMNS, max_len=max_len, device="cpu")
    assert want and got == want


def test_one_frequent_item_and_invalid_slots():
    """f == 1: one item clears min_support, every other slot is
    invalid at level 2 and 3."""
    rows = [{"sourcePodNamespace": "web", "destinationPodNamespace": f"d{i}",
             "destinationTransportPort": 1000 + i} for i in range(30)]
    want = ref_its.mine_frequent_patterns(
        RefBatch.from_rows(rows, REF_SCHEMA), min_support=5,
        columns=COLUMNS, mesh=None)
    got = port_its.mine_frequent_patterns(
        ColumnarBatch.from_rows(rows, FLOW_SCHEMA), min_support=5,
        columns=COLUMNS, device="cpu")
    assert got == want == [((("sourcePodNamespace", "web"),), 30)]


def _patterns(db):
    return sorted(tuple(sorted(r.items()))
                  for r in db.flowpatterns.scan().to_rows())


@pytest.mark.parametrize("min_support", [0, 7])
def test_run_pattern_mining_matches_reference(min_support):
    cfg = SynthConfig(n_series=40, points_per_series=8, seed=12)
    ref_db, port_db = RefDatabase(), FlowDatabase()
    ref_db.insert_flows(ref_generate(cfg))
    port_db.insert_flows(port_generate(cfg))
    kw = dict(min_support=min_support, mining_id="fpm-parity", now=5)
    ref_its.run_pattern_mining(ref_db, **kw)
    port_its.run_pattern_mining(port_db, device="cpu", **kw)
    want = _patterns(ref_db)
    assert want and _patterns(port_db) == want


def test_explicit_mesh_raises_naming_a16():
    batch = ColumnarBatch.from_rows(_rows(1, 8), FLOW_SCHEMA)
    with pytest.raises(NotImplementedError, match="ROADMAP A16"):
        port_its.mine_frequent_patterns(batch, 2, columns=COLUMNS,
                                        mesh=object(), device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP A16"):
        port_its.run_pattern_mining(FlowDatabase(), mesh="rows",
                                    device="cpu")
