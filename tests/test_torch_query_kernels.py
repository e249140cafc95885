"""Port parity for the query engine's device segment-reduce: under
THEIA_QUERY_JAX=1 `theia_tpu_torch.query.kernels` reduces each part in
int64 torch ops (bincount, index_add_, scatter_reduce_) on the
engine's device, where the reference runs jitted `jax.ops.segment_*`.

On the CPU (device="cpu") the torch branch is held bit for bit against
the reference's JAX branch (tests/conftest.py enables x64, so the
reference takes it) and against the port's own numpy mode, on
tests/test_query.py's kernel inputs (values to ±10^12), a sum that
wraps past int64, presorted runs, a global aggregate and partial
merges; then through QueryEngine over parts stores. The branch has no
fallback: a failure raises and the next call tries the branch again.
One `cuda`-marked case runs it on the card against numpy.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from theia_tpu.data.synth import SynthConfig, generate_flows
from theia_tpu.query import QueryEngine as RefEngine
from theia_tpu.query import kernels as ref_kernels
from theia_tpu.query import parse_plan as ref_parse_plan
from theia_tpu.store import FlowDatabase as RefDatabase
from theia_tpu_torch.data.synth import SynthConfig as PortSynth
from theia_tpu_torch.data.synth import generate_flows as port_flows
from theia_tpu_torch.query import QueryEngine, parse_plan
from theia_tpu_torch.query import kernels
from theia_tpu_torch.store import FlowDatabase

SPECS = [("count", "count", None), ("sum(a)", "sum", "a"),
         ("min(b)", "min", "b"), ("max(a)", "max", "a"),
         ("min(a)", "min", "a"), ("sum(b)", "sum", "b")]
I64 = np.iinfo(np.int64)


def _case(name: str, seed: int = 42):
    """(keys, values, presorted) for one named input."""
    rng = np.random.default_rng(seed)
    n = 4096
    if name == "wide":            # tests/test_query.py's kernel inputs
        keys = rng.integers(0, 50, size=(n, 2)).astype(np.int64)
        values = {"a": rng.integers(-(10 ** 12), 10 ** 12, n),
                  "b": rng.integers(0, 10 ** 9, n)}
    elif name == "wraps":         # every group's sum of `a` wraps
        keys = rng.integers(0, 7, size=(n, 1)).astype(np.int64)
        values = {"a": rng.integers(I64.max - 10 ** 6, I64.max, n),
                  "b": rng.integers(I64.min, I64.min + 10 ** 6, n)}
    elif name == "presorted":
        keys = np.sort(rng.integers(0, 300, size=(n, 1)), axis=0)
        values = {"a": rng.integers(-50, 50, n),
                  "b": rng.integers(-(10 ** 15), 10 ** 15, n)}
    elif name == "global":        # no group-by: one group
        keys = np.zeros((n, 0), np.int64)
        values = {"a": rng.integers(-(10 ** 12), 10 ** 12, n),
                  "b": rng.integers(0, 10, n)}
    else:                         # "singletons": every key distinct
        keys = rng.permutation(n).reshape(n, 1)
        values = {"a": rng.integers(-5, 5, n), "b": rng.integers(0, 3, n)}
    values = {c: v.astype(np.int64) for c, v in values.items()}
    return keys.astype(np.int64), values, name == "presorted"


CASES = ("wide", "wraps", "presorted", "global", "singletons")


def _assert_equal(got, want):
    np.testing.assert_array_equal(got[0], want[0])
    assert sorted(got[1]) == sorted(want[1])
    for label in want[1]:
        assert got[1][label].dtype == np.int64, label
        np.testing.assert_array_equal(got[1][label], want[1][label],
                                      err_msg=label)


@pytest.mark.parametrize("name", CASES)
def test_torch_branch_matches_jax_branch_and_numpy(name, monkeypatch):
    keys, values, presorted = _case(name)
    monkeypatch.setenv("THEIA_QUERY_JAX", "0")
    numpy_out = kernels.aggregate(keys, values, SPECS, presorted=presorted)
    monkeypatch.setenv("THEIA_QUERY_JAX", "1")
    assert ref_kernels.kernel_mode() == "jax"
    jax_out = ref_kernels.aggregate(keys, values, SPECS,
                                    presorted=presorted)
    assert ref_kernels._jax_disabled_reason is None
    assert kernels.kernel_mode() == "torch"
    torch_out = kernels.aggregate(keys, values, SPECS, presorted=presorted,
                                  device="cpu")
    _assert_equal(torch_out, jax_out)
    _assert_equal(torch_out, numpy_out)
    if name == "wraps":   # the sums did wrap: numpy's wrapped sums agree
        sums = torch_out[1]["sum(a)"]
        assert (sums < 0).any()


@pytest.mark.parametrize("name", CASES)
def test_merge_partials_on_torch_matches_jax_and_numpy(name,
                                                       monkeypatch):
    keys, values, _ = _case(name, seed=7)
    cuts = (0, 1000, 1001, 3000, len(keys))

    def merged(mod, **kw):
        parts = [mod.aggregate(keys[a:b],
                               {c: v[a:b] for c, v in values.items()},
                               SPECS, **kw)
                 for a, b in zip(cuts, cuts[1:])]
        return mod.merge_partials(parts, SPECS, **kw)

    monkeypatch.setenv("THEIA_QUERY_JAX", "0")
    numpy_out = merged(kernels)
    whole = kernels.aggregate(keys, values, SPECS)
    monkeypatch.setenv("THEIA_QUERY_JAX", "1")
    jax_out = merged(ref_kernels)
    torch_out = merged(kernels, device="cpu")
    _assert_equal(torch_out, jax_out)
    _assert_equal(torch_out, numpy_out)
    _assert_equal(torch_out, whole)


@pytest.mark.parametrize("raw,mode", [
    (None, "numpy"), ("auto", "numpy"), ("0", "numpy"), ("off", "numpy"),
    ("1", "torch"), ("force", "torch"), ("on", "torch"), (" YES ", "torch"),
])
def test_mode_table(raw, mode, monkeypatch):
    """1 → torch where the reference answers jax; auto → numpy, the
    reference's answer in a process without x64 (its manager and
    runner never enable it)."""
    if raw is None:
        monkeypatch.delenv("THEIA_QUERY_JAX", raising=False)
    else:
        monkeypatch.setenv("THEIA_QUERY_JAX", raw)
    assert kernels.kernel_mode() == mode


def test_failure_raises_and_does_not_fall_back(monkeypatch):
    """With no card the default device raises (the port's device rule);
    the mode stays torch, and the next call on the CPU runs the
    branch."""
    keys, values, _ = _case("wide")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setenv("THEIA_QUERY_JAX", "1")
    for device in (None, "cuda"):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            kernels.aggregate(keys, values, SPECS, device=device)
    assert kernels.kernel_mode() == "torch"
    calls = []
    real = kernels._reduce_torch
    monkeypatch.setattr(kernels, "_reduce_torch",
                        lambda *a: calls.append(a[-1]) or real(*a))
    out = kernels.aggregate(keys, values, SPECS, device="cpu")
    assert calls == ["cpu"]
    monkeypatch.setenv("THEIA_QUERY_JAX", "0")
    _assert_equal(out, kernels.aggregate(keys, values, SPECS))


def _stores(tmp_path):
    """A reference and a port parts store over the same seeded flows
    (data/synth.py is a copy), with small memtables so each holds
    several sealed parts."""
    cfg = {"memtable_rows": 256}
    ref = RefDatabase(engine="parts", parts_config=cfg,
                      parts_dir=str(tmp_path / "ref"))
    port = FlowDatabase(engine="parts", parts_config=cfg,
                        parts_dir=str(tmp_path / "port"))
    for seed in range(3):
        shape = dict(n_series=40, points_per_series=12, seed=seed)
        ref.insert_flows(generate_flows(SynthConfig(**shape)))
        port.insert_flows(port_flows(PortSynth(**shape)))
    return ref, port


PLANS = (
    {"groupBy": "sourcePodNamespace,destinationPodNamespace",
     "aggregates": ["count", "sum:octetDeltaCount", "min:octetDeltaCount",
                    "max:octetDeltaCount"], "k": 0},
    {"groupBy": "sourceIP", "aggregates": ["count", "mean:throughput",
                                           "max:packetDeltaCount"],
     "filters": [{"column": "destinationTransportPort", "op": ">=",
                  "value": 0}], "k": 5},
    {"aggregates": ["count", "sum:octetDeltaCount"]},
)


@pytest.mark.parametrize("doc", PLANS, ids=("pods", "ip-top5", "global"))
def test_engine_on_torch_matches_reference_jax(doc, tmp_path, monkeypatch):
    """QueryEngine(device="cpu") under THEIA_QUERY_JAX=1 (the torch
    branch through every per-part and merge call) returns the
    reference engine's JAX-branch rows and its own numpy rows."""
    ref, port = _stores(tmp_path)
    monkeypatch.setenv("THEIA_QUERY_JAX", "1")
    want = RefEngine(ref).execute(ref_parse_plan(dict(doc)),
                                  use_cache=False)
    engine = QueryEngine(port, device="cpu")
    got = engine.execute(parse_plan(dict(doc)), use_cache=False,
                         explain=True)
    assert got["profile"]["kernel"] == "torch"
    assert engine.stats()["kernel"] == "torch"
    assert got["rows"] == want["rows"]
    assert got["groupCount"] == want["groupCount"]
    assert got["partsScanned"] == want["partsScanned"] > 1
    monkeypatch.setenv("THEIA_QUERY_JAX", "0")
    plain = QueryEngine(port).execute(parse_plan(dict(doc)),
                                      use_cache=False)
    assert plain["rows"] == got["rows"]


def test_engine_in_numpy_mode_resolves_no_device(tmp_path, monkeypatch):
    """QueryEngine(db) with the default device answers without a card
    while the mode is numpy; under 1 the same engine raises."""
    _, port = _stores(tmp_path)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    plan = parse_plan(dict(PLANS[0]))
    monkeypatch.setenv("THEIA_QUERY_JAX", "auto")
    engine = QueryEngine(port)
    assert engine.execute(plan, use_cache=False)["rows"]
    monkeypatch.setenv("THEIA_QUERY_JAX", "1")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        engine.execute(plan, use_cache=False)


@pytest.mark.cuda
@pytest.mark.parametrize("name", CASES)
def test_torch_branch_on_the_card_matches_numpy(name, monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    keys, values, presorted = _case(name)
    monkeypatch.setenv("THEIA_QUERY_JAX", "0")
    want = kernels.aggregate(keys, values, SPECS, presorted=presorted)
    monkeypatch.setenv("THEIA_QUERY_JAX", "1")
    got = kernels.aggregate(keys, values, SPECS, presorted=presorted,
                            device="cuda:0")
    _assert_equal(got, want)
