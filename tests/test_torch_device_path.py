"""Port parity for the slice as a whole: the port's IngestManager
(engines "fused" and "sharded", on the CPU) against the reference's
IngestManager(FlowDatabase(), engine="fused"), on the workloads of
tests/test_device_path.py, scored one batch at a time (the documented
determinism contract).

Connection alerts must be equal apart from latency_s (a wall-clock
measurement). Heavy-hitter alerts must be equal in kind and
destination; their estimate and share floats are held to rtol 1e-5:
the CMS total is a float32 sum over the batch in another order than
XLA's, which moves shares by a few ulp."""

from __future__ import annotations

import threading

import numpy as np
import pytest
import torch

from theia_tpu.data.synth import SynthConfig, generate_flows
from theia_tpu.manager.ingest import IngestManager as RefManager
from theia_tpu.store import FlowDatabase
from theia_tpu.store import wire as ref_wire
from theia_tpu_torch.analytics import streaming
from theia_tpu_torch.analytics.heavy_hitters import HeavyHitterDetector
from theia_tpu_torch.analytics.streaming import StreamingDetector
from theia_tpu_torch.data import synth as port_synth
from theia_tpu_torch.manager.ingest import IngestManager
from theia_tpu_torch.ops import _build
from theia_tpu_torch.ops import fused_detector as fd
from theia_tpu_torch.ops import sketch
from theia_tpu_torch.store import FlowDatabase as PortFlowDatabase
from theia_tpu_torch.store import wire as port_wire
from test_torch_analysis import port_lockdep_clean  # noqa: F401

HH_RTOL = 1e-5


def _strip(conn_alerts):
    return [{k: v for k, v in d.items() if k != "latency_s"}
            for d in conn_alerts]


def _assert_same_alerts(ref_out, port_out):
    hr, cr, nr = ref_out
    hp, cp, np_ = port_out
    assert np_ == nr
    assert _strip(cp) == _strip(cr)
    assert [(a.kind, a.destination) for a in hp] == \
        [(a.kind, a.destination) for a in hr]
    for a, b in zip(hp, hr):
        np.testing.assert_allclose([a.estimate, a.share],
                                   [b.estimate, b.share], rtol=HH_RTOL)


def _both(cfg):
    """The same flows from the reference's generator and the port's
    copy of it."""
    port_cfg = port_synth.SynthConfig(
        **{f: getattr(cfg, f) for f in cfg.__dataclass_fields__})
    return generate_flows(cfg), port_synth.generate_flows(port_cfg)


def _workload(seeds, n_series=150, points=8, anomaly=0.3):
    return [_both(SynthConfig(n_series=n_series, points_per_series=points,
                              anomaly_fraction=anomaly, seed=s))
            for s in seeds]


class _Pair:
    def __init__(self, engine, n_shards, **kwargs):
        self.ref = RefManager(FlowDatabase(), n_shards=n_shards,
                              engine="fused", **kwargs)
        self.port = IngestManager(None, n_shards=n_shards, engine=engine,
                                  device="cpu", **kwargs)

    def score(self, batches):
        b_ref, b_port = batches
        out = (self.ref.score_batch(b_ref), self.port.score_batch(b_port))
        _assert_same_alerts(*out)
        return out

    def close(self):
        self.port.close()
        self.ref.close()


ENGINES = ["fused", "sharded"]


@pytest.mark.parametrize("engine", ENGINES)
def test_parity_single_shard(engine):
    pair = _Pair(engine, 1)
    try:
        n = sum(pair.score(b)[1][2] for b in _workload(range(3)))
        assert n > 0
    finally:
        pair.close()


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("seed0", [0, 100, 200])
def test_parity_randomized_multi_shard(engine, seed0):
    pair = _Pair(engine, 4)
    try:
        rng = np.random.default_rng(seed0)
        for i in range(5):
            pair.score(_both(SynthConfig(
                n_series=int(rng.integers(20, 300)),
                points_per_series=int(rng.integers(2, 12)),
                anomaly_fraction=float(rng.uniform(0.0, 0.5)),
                seed=seed0 + i)))
        for s_ref, s_port in zip(pair.ref.shards, pair.port.shards):
            assert s_port.streaming.n_series == s_ref.streaming.n_series
    finally:
        pair.close()


@pytest.mark.parametrize("engine", ENGINES)
def test_parity_slot_overflow(engine):
    pair = _Pair(engine, 2, streaming_capacity=40)
    try:
        for b in _workload(range(4), n_series=120):
            pair.score(b)
        drop_r = [s.streaming.dropped_series for s in pair.ref.shards]
        drop_p = [s.streaming.dropped_series for s in pair.port.shards]
        assert drop_p == drop_r
        assert sum(drop_r) > 0
    finally:
        pair.close()


@pytest.mark.parametrize("engine", ENGINES)
def test_parity_every_series_dropped(engine):
    pair = _Pair(engine, 2, streaming_capacity=1)
    try:
        for b in _workload(range(3), n_series=60):
            pair.score(b)
    finally:
        pair.close()


def test_tblk_blocks_score_like_reference():
    """The slice from wire bytes: TBLK-encode with each package's
    codec, decode, score (fused engine), publish; alerts match."""
    pair = _Pair("fused", 4)
    try:
        for b_ref, b_port in _workload(range(3), n_series=100, points=6):
            blk_ref = ref_wire.encode_block(b_ref)
            blk_port = port_wire.encode_block(b_port)
            assert blk_port == blk_ref
            _, (_, conn, _) = pair.score((
                ref_wire.decode_block(blk_ref),
                port_wire.decode_block(blk_port)))
            for d in conn:
                pair.port.push_alert(d)
        ring = pair.port.recent_alerts(5)
        assert len(ring) == 5 and all("time" in a for a in ring)
    finally:
        pair.close()


def test_concurrent_producers_coalesce_without_loss():
    """Threads scoring at once on the port's fused engine: every
    request resolves and per-shard series counts equal the sharded
    engine's over the same batches."""
    fused = IngestManager(None, n_shards=4, engine="fused", device="cpu")
    sharded = IngestManager(None, n_shards=4, engine="sharded",
                            device="cpu")
    try:
        batches = [b for _, b in _workload(range(6), n_series=80,
                                           points=3, anomaly=0.0)]
        errs = []

        def feed(b):
            try:
                fused.score_batch(b)
            except Exception as e:   # noqa: BLE001
                errs.append(e)

        threads = [threading.Thread(target=feed, args=(b,))
                   for b in batches]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not errs and not any(t.is_alive() for t in threads)
        for b in batches:
            sharded.score_batch(b)
        assert sorted(s.streaming.n_series for s in fused.shards) == \
            sorted(s.streaming.n_series for s in sharded.shards)
        eng = fused.shard_liveness()["engine"]
        assert eng["coalescedBlocks"] == len(batches)
        assert eng["device"] == "cpu"
    finally:
        fused.close()
        sharded.close()


def test_engine_mechanics_on_cpu():
    """The reference's engine-mechanics cases on the port: empty batch
    fast path, staging reuse once both generations are warm, a block
    larger than the coalescing row cap, close idempotent and
    post-close errors."""
    im = IngestManager(None, n_shards=2, engine="fused", device="cpu")
    try:
        batches = [b for _, b in _workload(range(8), n_series=100,
                                           points=4)]
        assert im.score_batch(batches[0].take(np.zeros(0, np.int64))) \
            == ([], [], 0)
        for b in batches[:4]:
            im.score_batch(b)
        pool = im._fused._staging
        misses_warm = pool.misses
        for b in batches[4:]:
            im.score_batch(b)
        assert pool.hits > 0 and pool.misses == misses_warm
        im._fused.max_step_rows = 64
        assert im.score_batch(batches[0])[2] >= 0   # 400 rows > 64
    finally:
        im.close()
    im.close()
    with pytest.raises(RuntimeError):
        im._fused.score(batches[0], None)


def test_engine_tallies_the_stream_tiles_it_dispatches():
    """`tiles` counts one (T, U, live) per shard with rows per step,
    from the host plans; on the CPU no B1 kernel launches."""
    im = IngestManager(None, n_shards=2, engine="fused", device="cpu")
    launches = _build.launches()
    try:
        for _, b in _workload(range(3), n_series=100, points=4):
            im.score_batch(b)
        eng = im._fused
        tiles = eng.tiles
        assert eng.steps <= sum(tiles.values()) <= 2 * eng.steps
        for t, u, live in tiles:
            assert t & (t - 1) == 0 and u & (u - 1) == 0 and u >= 64
            assert 0 < live <= u
        assert sum(live * n for (_, _, live), n in tiles.items()) >= \
            sum(s.streaming.n_series for s in im.shards) > 0
    finally:
        im.close()
    assert _build.launches() == launches


def test_dispatch_failure_fails_the_batch_not_the_engine(monkeypatch):
    """A step that raises fails its own requests with that error; the
    scorer thread lives on and scores the next request."""
    from theia_tpu_torch.ingest import device_path

    real = device_path._ops.fused_step
    calls = []

    def fail_once(*args, **kwargs):
        calls.append(1)
        if len(calls) == 1:
            raise RuntimeError("injected step failure")
        return real(*args, **kwargs)

    monkeypatch.setattr(device_path._ops, "fused_step", fail_once)
    im = IngestManager(None, n_shards=2, engine="fused", device="cpu")
    try:
        batches = [b for _, b in _workload(range(2), n_series=50)]
        with pytest.raises(RuntimeError, match="injected step failure"):
            im.score_batch(batches[0])
        im.score_batch(batches[1])
        assert len(calls) == 2
    finally:
        im.close()


def test_auto_engine_and_rejections():
    im = IngestManager(None, n_shards=2, engine="auto", device="cpu")
    try:
        assert im.engine_name == "sharded"   # auto: fused on CUDA only
        assert im.shard_liveness()["engine"]["requested"] == "auto"
    finally:
        im.close()
    with pytest.raises(ValueError):
        IngestManager(None, engine="warp", device="cpu")
    # the request half is ported: the manager takes a flow store
    db = PortFlowDatabase()
    im = IngestManager(db, n_shards=1, device="cpu")
    try:
        assert im.db is db
    finally:
        im.close()


def test_entry_points_raise_without_a_card(monkeypatch):
    """No quiet CPU fallback: without CUDA the entry points raise
    unless the caller asked for the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        IngestManager(None, n_shards=1)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        StreamingDetector(capacity=8)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        HeavyHitterDetector()
    IngestManager(None, n_shards=1, device="cpu").close()


@pytest.mark.parametrize("make", [
    lambda **kw: sketch.cms_init(4, 64, **kw),
    lambda **kw: sketch.kmeans_init(np.zeros((2, 4)), **kw),
    lambda **kw: streaming.init_state(8, **kw),
], ids=["cms_init", "kmeans_init", "init_state"])
def test_state_allocators_default_to_the_card(monkeypatch, make):
    """The functions that allocate device state default to the card:
    without CUDA they raise unless the caller asked for the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make()
    for t in make(device="cpu"):
        assert t.device.type == "cpu"


def test_host_to_tensor_helpers_need_a_device():
    """keys_tensor and shard_state_from_numpy have no default device."""
    with pytest.raises(TypeError):
        sketch.keys_tensor(np.arange(4, dtype=np.uint32))
    with pytest.raises(TypeError):
        fd.shard_state_from_numpy(
            [np.zeros(4)] * 4, [np.zeros((1, 4)), np.zeros(())],
            [np.zeros((2, 4)), np.zeros(2)])


@pytest.mark.cuda
def test_fused_engine_on_card_matches_cpu():
    """The card's fused engine against the CPU's, one batch per step:
    connection alerts equal, final per-connection state bit-exact."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    card = IngestManager(None, n_shards=4, engine="fused")
    cpu = IngestManager(None, n_shards=4, engine="fused", device="cpu")
    try:
        for _, b in _workload(range(3)):
            hc, cc, nc = card.score_batch(b)
            hp, cp, np_ = cpu.score_batch(b)
            assert nc == np_ and _strip(cc) == _strip(cp)
        for sc, sp in zip(card.shards, cpu.shards):
            for a, b in zip(sc.streaming.state, sp.streaming.state):
                assert torch.equal(a.cpu(), b)
    finally:
        card.close()
        cpu.close()
