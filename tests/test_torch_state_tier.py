"""Port parity for the working-set state tier (ingest/state_tier.py,
THEIA_STATE_TIER): with at least four times as many keys as hot slots,
state spills and promotes constantly, and the port's alert stream,
counted as a sorted multiset, must equal the reference's tiered
detector's and an unbounded oracle's, with zero dropped series and
zero overflow. `_gather` then `_restore` (the two device adapters the
port rewrote) must round-trip state bit for bit."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from theia_tpu.analytics.streaming import StreamingDetector as RefDetector
from theia_tpu.ingest import state_tier as ref_tier
from theia_tpu.manager.ingest import IngestManager as RefManager
from theia_tpu.schema import ColumnarBatch as RefBatch
from theia_tpu.schema import StringDictionary as RefDictionary
from theia_tpu.store import FlowDatabase as RefDatabase
from theia_tpu_torch.analytics.streaming import StreamingDetector
from theia_tpu_torch.analytics.streaming import init_state
from theia_tpu_torch.ingest import state_tier
from theia_tpu_torch.manager.ingest import IngestManager
from theia_tpu_torch.schema import ColumnarBatch, StringDictionary
from theia_tpu_torch.store import FlowDatabase
from test_torch_analysis import port_lockdep_clean  # noqa: F401


def _key(i):
    return (i, 1234, i * 7, 80, 6, 1)


def _batch(cls, keys, vals):
    n = len(keys)
    cols = {name: np.array([k[j] for k in keys], np.int64)
            for j, name in enumerate((
                "sourceIP", "sourceTransportPort", "destinationIP",
                "destinationTransportPort", "protocolIdentifier",
                "flowStartSeconds"))}
    cols["throughput"] = np.asarray(vals, np.float64)
    cols["flowEndSeconds"] = np.full(n, 100, np.int64)
    return cls(cols, {})


def _multiset(alerts):
    """Alert content only: slot ids are allocation artifacts (a tiered
    detector reuses slots) and latency_s is a measurement."""
    return sorted(tuple(sorted((k, v) for k, v in a.items()
                               if k not in ("latency_s", "slot", "row")))
                  for a in alerts)


@pytest.mark.parametrize("cold", [False, True],
                         ids=["warm", "aged-out-to-cold"])
def test_tiered_detector_alerts_match_reference_and_oracle(cold):
    """16 hot slots, 64 keys (cold: 8 slots, 32 keys, warm blocks aged
    out to the detstate table after 10 ticks)."""
    cap, n_keys, per_batch, steps = (8, 32, 5, 120) if cold \
        else (16, 64, 10, 150)
    age = 10.0 if cold else 0.0
    clock = [0.0]

    def tiered(mod, det_cls, db_cls, **kw):
        store = None
        if cold:
            db = db_cls()
            store = mod.SpillStore(db.result_tables[mod.DETSTATE_TABLE])
        tier = mod.WorkingSetTier(
            mod.TierConfig(hot_watermark=0.9, evict_to=0.5,
                           age_out_seconds=age),
            store=store, clock=lambda: clock[0])
        return tier, det_cls(capacity=cap, tier=tier, **kw)

    tier, port = tiered(state_tier, StreamingDetector, FlowDatabase,
                        device="cpu")
    ref_t, ref = tiered(ref_tier, RefDetector, RefDatabase)
    oracle = StreamingDetector(capacity=10_000, device="cpu")
    rng = np.random.default_rng(3 if cold else 0)
    got, want_ref, want_oracle = [], [], []
    for _ in range(steps):
        clock[0] += 1.0
        idx = rng.integers(0, n_keys, size=per_batch)
        vals = rng.random(per_batch) * 100
        keys = [_key(i) for i in idx]
        got += port.ingest(_batch(ColumnarBatch, keys, vals))
        want_ref += ref.ingest(_batch(RefBatch, keys, vals))
        want_oracle += oracle.ingest(_batch(ColumnarBatch, keys, vals))
        assert port.dropped_series == 0 and tier.overflow == 0
        assert tier.n_hot <= cap
    assert got, "no alert fired: the comparison proves nothing"
    assert _multiset(got) == _multiset(want_ref) == _multiset(want_oracle)
    assert tier.stats() == ref_t.stats()
    if cold:
        assert tier.age_outs > 0 and tier.promotions_cold > 0
    else:
        assert tier.evictions > 100 and tier.promotions_warm > 100


def _flow_batch(dict_cls, batch_cls, n, n_flows, seed, offset):
    """tests/test_state_tier.py's rotating flow population: distinct
    keys per batch stay under the slot budget while their union is
    well above it."""
    rng = np.random.default_rng(seed)
    dicts = {"sourceIP": dict_cls(), "destinationIP": dict_cls()}
    src = np.array([dicts["sourceIP"].encode_one(
        f"10.0.{offset + i % n_flows}.1") for i in range(n)], np.int32)
    dst = np.array([dicts["destinationIP"].encode_one(
        f"10.1.{offset + i % n_flows}.1") for i in range(n)], np.int32)
    return batch_cls({
        "sourceIP": src, "destinationIP": dst,
        "sourceTransportPort": np.full(n, 1234, np.int32),
        "destinationTransportPort": np.full(n, 80, np.int32),
        "protocolIdentifier": np.full(n, 6, np.int32),
        "flowStartSeconds": np.full(n, 1, np.int64),
        "flowEndSeconds": np.full(n, 100, np.int64),
        "throughput": rng.integers(1, 1000, n).astype(np.int64),
        "octetDeltaCount": rng.integers(1, 1000, n).astype(np.int64),
        "packetDeltaCount": rng.integers(1, 100, n).astype(np.int64),
        "reverseOctetDeltaCount": np.zeros(n, np.int64),
    }, dicts)


@pytest.mark.parametrize("engine", ["fused", "sharded"])
def test_manager_tier_matches_reference_and_oracle(monkeypatch, engine):
    """THEIA_STATE_TIER=1 on a two-shard manager with 16 slots a shard:
    20 flows a batch from a rotating population, 160 distinct keys
    through 32 slots (5x). The port's alert multiset equals the tiered
    reference's and that of an unbounded port manager, and the tiers'
    counters equal the reference's."""
    monkeypatch.setenv("THEIA_STATE_TIER", "1")
    port_db = FlowDatabase()
    port = IngestManager(port_db, n_shards=2, streaming_capacity=16,
                         engine=engine, device="cpu")
    ref = RefManager(RefDatabase(), n_shards=2, streaming_capacity=16,
                     engine="fused")
    monkeypatch.delenv("THEIA_STATE_TIER")
    oracle = IngestManager(None, n_shards=2, engine=engine, device="cpu")
    got, want_ref, want_oracle = [], [], []
    try:
        assert len(port._tiers) == 2 and oracle._tiers == []
        for seed in range(12):
            offset = 20 * (seed % 8)
            got += port.score_batch(_flow_batch(
                StringDictionary, ColumnarBatch, 120, 20, seed, offset))[1]
            want_ref += ref.score_batch(_flow_batch(
                RefDictionary, RefBatch, 120, 20, seed, offset))[1]
            want_oracle += oracle.score_batch(_flow_batch(
                StringDictionary, ColumnarBatch, 120, 20, seed, offset))[1]
        tiers = [t.stats() for t in port._tiers]
        assert tiers == [t.stats() for t in ref._tiers]
        assert sum(t["evictions"] for t in tiers) > 0
        assert sum(t["promotions"] for t in tiers) > 0
        assert sum(t["overflow"] for t in tiers) == 0
        assert all(s.streaming.dropped_series == 0 for s in port.shards)
        assert len(port_db.result_tables[state_tier.DETSTATE_TABLE]) > 0
    finally:
        oracle.close()
        ref.close()
        port.close()
    assert got, "no alert fired: the comparison proves nothing"
    assert _multiset(got) == _multiset(want_ref) == _multiset(want_oracle)


@pytest.mark.parametrize("k", [1, 5, 64, 65])
def test_gather_then_restore_round_trips_bit_exact(k):
    """`_gather` reads k slots (padded to a power of two with the last
    row) and `_restore` writes them into a zeroed state at the same
    slots (padded with the capacity sentinel, which is dropped): every
    field's bytes come back, and no other row is touched."""
    cap = 128
    rng = np.random.default_rng(k)
    state = init_state(cap, "cpu")
    state.ewma.copy_(torch.from_numpy(rng.normal(size=cap)
                                      .astype(np.float32)))
    state.count.copy_(torch.from_numpy(rng.integers(0, 1 << 30, cap)
                                       .astype(np.int32)))
    state.mean.copy_(torch.from_numpy(rng.normal(size=cap)
                                      .astype(np.float32)))
    state.m2.copy_(torch.from_numpy(rng.random(cap).astype(np.float32)))
    slots = rng.choice(cap, size=k, replace=False).astype(np.int64)
    vals = state_tier._gather(state, slots, cap, k)
    for full, got in zip(state, vals):
        assert got.tobytes() == full.numpy()[slots].tobytes()
    fresh = init_state(cap, "cpu")
    out = state_tier._restore(fresh, slots, cap, *vals)
    assert out is fresh                     # in place, as det.state
    others = np.setdiff1d(np.arange(cap), slots)
    for full, back in zip(state, fresh):
        assert back.numpy()[slots].tobytes() == \
            full.numpy()[slots].tobytes()
        assert not back.numpy()[others].any()
    again = state_tier._gather(fresh, slots, cap, k)
    assert all(a.tobytes() == b.tobytes() for a, b in zip(again, vals))


def test_restart_recovers_the_cold_index(monkeypatch):
    """A port manager restarted over the same store rebuilds each
    shard's cold index from the detstate table (string-resolved keys)
    and promotes from it on re-arrival."""
    monkeypatch.setenv("THEIA_STATE_TIER", "1")
    db = FlowDatabase()
    im = IngestManager(db, n_shards=2, streaming_capacity=16,
                       device="cpu")
    try:
        for k in range(8):
            im.score_batch(_flow_batch(StringDictionary, ColumnarBatch,
                                       120, 20, k, 10 * (k % 4)))
    finally:
        im.close()
    im = IngestManager(db, n_shards=2, streaming_capacity=16,
                       device="cpu")
    try:
        assert sum(len(t.cold) for t in im._tiers) > 0
        for k in range(4):
            im.score_batch(_flow_batch(StringDictionary, ColumnarBatch,
                                       120, 20, k, 10 * (k % 4)))
        assert sum(t.promotions_cold for t in im._tiers) > 0
    finally:
        im.close()
