"""Port parity: theia_tpu_torch.ops.fused_detector against
theia_tpu.ops.fused_detector.

The reference's fused_step runs as its own tests run it on the CPU:
with the jnp tick scan (use_pallas=False) and with the Pallas tile
scan B1 through the Pallas interpreter (use_pallas=True,
interpret=True; the Pallas kernel engages only when U % 128 == 0, so
U=64 exercises its scan fallback and U=256 the kernel). The port runs
its plain versions on the CPU. Both start from the same carried-
across non-zero state (shard_state_from_numpy).

Tolerances: anomaly flags, count, ewma, mean, CMS counters and
estimates, assignments and k-means counts are exact. m2 rtol 1e-5:
XLA's CPU backend contracts `m2 + delta*(xa-mean)` into an FMA, the
port rounds the product first (tests/test_torch_streaming.py). CMS
total rtol 1e-6: another summation order over ≤ 512 float32 terms.
k-means centroids rtol 1e-5 (float32 matmuls in another order);
distances atol 1e-4 (d2 is a cancellation of terms near 1e2).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from theia_tpu.analytics.streaming import StreamState as RefStreamState
from theia_tpu.ops import fused_detector as ref_fd
from theia_tpu.ops.sketch import CmsState as RefCms
from theia_tpu.ops.sketch import KMeansState as RefKm
from theia_tpu_torch.analytics.streaming import StreamState
from theia_tpu_torch.ops import _build
from theia_tpu_torch.ops import fused_detector as fd
from theia_tpu_torch.ops.sketch import keys_tensor

CAP = 512
SIZE = 256


def _carried(rng, cap=CAP):
    stream = (rng.normal(5, 2, cap).astype(np.float32),
              rng.integers(0, 6, cap).astype(np.int32),
              rng.normal(5, 2, cap).astype(np.float32),
              rng.uniform(0, 30, cap).astype(np.float32))
    counts = rng.uniform(0, 1e6, (4, 256)).astype(np.float32)
    cms = (counts, np.float32(counts[0].sum(dtype=np.float64)))
    km = (rng.normal(0, 1, (8, 4)).astype(np.float32),
          rng.integers(0, 50, 8).astype(np.float32))
    return stream, cms, km


def _ref_state(stream, cms, km):
    return ref_fd.ShardStepState(
        RefStreamState(*(jnp.asarray(a) for a in stream)),
        RefCms(*(jnp.asarray(a) for a in cms)),
        RefKm(*(jnp.asarray(a) for a in km)))


def _inputs(rng, t, u, live, cap=CAP):
    slots = np.full(u, cap, np.int32)
    slots[:live] = np.sort(rng.choice(cap, live, replace=False))
    x = rng.normal(5, 3, (t, u)).astype(np.float32)
    active = rng.random((t, u)) < 0.8
    active[:, live:] = False
    n = SIZE - 20
    keys = np.zeros(SIZE, np.uint32)
    keys[:n] = rng.integers(0, 300, n)
    vols = np.zeros(SIZE, np.float32)
    vols[:n] = rng.uniform(0, 1e6, n)
    uq = np.unique(keys[:n])
    q = np.zeros(SIZE, np.uint32)
    q[:len(uq)] = uq
    feats = np.zeros((SIZE, 4), np.float32)
    feats[:n] = rng.normal(0, 1, (n, 4)) + rng.integers(0, 4, (n, 1)) * 3
    valid = np.zeros(SIZE, bool)
    valid[:n] = True
    return slots, x, active, keys, vols, q, feats, valid


def _ref_inputs(arrays):
    return ref_fd.ShardInputs(*(jnp.asarray(a) for a in arrays))


def _port_inputs(arrays):
    slots, x, active, keys, vols, q, feats, valid = arrays
    return fd.ShardInputs(
        torch.from_numpy(slots), torch.from_numpy(x),
        torch.from_numpy(active), keys_tensor(keys, "cpu"),
        torch.from_numpy(vols), keys_tensor(q, "cpu"),
        torch.from_numpy(feats),
        torch.from_numpy(valid))


def _assert_state_matches(p_state, r_state):
    (ewma, count, mean, m2), (counts, total), (cent, kcounts) = \
        fd.shard_state_to_numpy(p_state)
    r = r_state
    np.testing.assert_array_equal(ewma, np.asarray(r.stream.ewma))
    np.testing.assert_array_equal(count, np.asarray(r.stream.count))
    np.testing.assert_array_equal(mean, np.asarray(r.stream.mean))
    np.testing.assert_allclose(m2, np.asarray(r.stream.m2), rtol=1e-5)
    np.testing.assert_array_equal(counts, np.asarray(r.cms.counts))
    np.testing.assert_allclose(total, np.asarray(r.cms.total), rtol=1e-6)
    np.testing.assert_allclose(cent, np.asarray(r.km.centroids),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(kcounts, np.asarray(r.km.counts))


@pytest.mark.parametrize("use_pallas", [False, True],
                         ids=["jnp_scan", "pallas_interpret"])
@pytest.mark.parametrize("t,u,live", [(1, 64, 40), (3, 64, 64),
                                      (2, 256, 200), (4, 256, 256)])
def test_fused_step_matches_reference(use_pallas, t, u, live):
    rng = np.random.default_rng(100 * t + u + live)
    carried = [_carried(rng) for _ in range(2)]
    r_states = tuple(_ref_state(*c) for c in carried)
    p_states = tuple(fd.shard_state_from_numpy(*c, "cpu")
                     for c in carried)
    for _ in range(3):
        arrays = [_inputs(rng, t, u, live) for _ in range(2)]
        r_states, r_outs = ref_fd.fused_step(
            r_states, tuple(_ref_inputs(a) for a in arrays), alpha=0.5,
            use_pallas=use_pallas, interpret=use_pallas)
        p_states, p_outs = fd.fused_step(
            p_states, tuple(_port_inputs(a) for a in arrays), alpha=0.5)
        for ps, rs, po, ro in zip(p_states, r_states, p_outs, r_outs):
            _assert_state_matches(ps, rs)
            np.testing.assert_array_equal(po.anomaly.numpy(),
                                          np.asarray(ro.anomaly))
            np.testing.assert_array_equal(po.est.numpy(),
                                          np.asarray(ro.est))
            np.testing.assert_allclose(po.total.numpy(),
                                       np.asarray(ro.total), rtol=1e-6)
            np.testing.assert_allclose(po.dist.numpy(),
                                       np.asarray(ro.dist),
                                       rtol=1e-5, atol=1e-4)
    assert any(o.anomaly.any() for o in p_outs)


def test_stream_half_matches_reference_scan():
    """The plain B1 (`_stream_half_plain`) against the reference's
    `_stream_half` through the Pallas interpreter at U=256."""
    rng = np.random.default_rng(17)
    stream, _, _ = _carried(rng)
    slots, x, active = _inputs(rng, 4, 256, 230)[:3]
    r_state = RefStreamState(*(jnp.asarray(a) for a in stream))
    inp = ref_fd.ShardInputs(jnp.asarray(slots), jnp.asarray(x),
                             jnp.asarray(active), *([None] * 5))
    r_new, r_anom = ref_fd._stream_half(r_state, inp, 0.5,
                                        use_pallas=True, interpret=True)
    p_state = StreamState(*(torch.from_numpy(a.copy()) for a in stream))
    p_anom = fd.stream_scan(p_state, torch.from_numpy(slots),
                            torch.from_numpy(x), torch.from_numpy(active))
    np.testing.assert_array_equal(p_anom.numpy(), np.asarray(r_anom))
    for name, a, b in zip(StreamState._fields, p_state, r_new):
        if name == "m2":
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5)
        else:
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_stream_scan_checks_its_inputs():
    state = StreamState(torch.zeros(8), torch.zeros(8, dtype=torch.int32),
                        torch.zeros(8), torch.zeros(8))
    slots = torch.zeros(4, dtype=torch.int32)
    x = torch.zeros((1, 4))
    active = torch.zeros((1, 4), dtype=torch.bool)
    with pytest.raises(TypeError):
        fd.stream_scan(state, slots.long(), x, active)
    with pytest.raises(ValueError):
        fd.stream_scan(state, slots, x.T.contiguous(), active)
    with pytest.raises(ValueError):
        fd.stream_scan(state, slots, torch.zeros((2, 8))[:, ::2],
                       torch.zeros((2, 4), dtype=torch.bool))
    launches = _build.launches()
    fd.stream_scan(state, slots, x, active)
    assert _build.launches() == launches   # CPU: no kernel launch


def test_gather_and_restore_state_match_reference():
    rng = np.random.default_rng(23)
    stream, _, _ = _carried(rng)
    slots = np.array([5, 0, 511, 77, CAP, CAP], np.int32)
    r_state = RefStreamState(*(jnp.asarray(a) for a in stream))
    p_state = StreamState(*(torch.from_numpy(a.copy()) for a in stream))
    r_rows = ref_fd.gather_state(r_state, jnp.asarray(slots))
    p_rows = fd.gather_state(p_state, torch.from_numpy(slots))
    for a, b in zip(p_rows, r_rows):   # padding reads the clamped last row
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    new = _carried(rng)[0]
    rows = [a[:len(slots)] for a in new]
    r_new = ref_fd.restore_state(r_state, jnp.asarray(slots),
                                 *(jnp.asarray(a) for a in rows))
    p_new = fd.restore_state(p_state, torch.from_numpy(slots),
                             *(torch.from_numpy(a) for a in rows))
    assert p_new is p_state   # in place
    for a, b in zip(p_new, r_new):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_shard_state_round_trip():
    carried = _carried(np.random.default_rng(29))
    back = fd.shard_state_to_numpy(
        fd.shard_state_from_numpy(*carried, "cpu"))
    for part_in, part_out in zip(carried, back):
        for a, b in zip(part_in, part_out):
            np.testing.assert_array_equal(b, a)
            assert b.dtype == np.asarray(a).dtype


@pytest.mark.cuda
@pytest.mark.parametrize("t,u", [(1, 64), (2, 4096), (8, 65536)])
def test_stream_scan_kernel_matches_plain_on_card(t, u):
    """B1 on the card against its plain version on the card: state,
    untouched rows and flags bit-exact (no FMA on either side)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: B1 is a CUDA kernel")
    rng = np.random.default_rng(t + u)
    cap = 65536
    live = u - u // 8
    dev = torch.device("cuda", 0)
    base = StreamState(
        torch.tensor(rng.normal(5, 2, cap).astype(np.float32)),
        torch.tensor(rng.integers(0, 6, cap).astype(np.int32)),
        torch.tensor(rng.normal(5, 2, cap).astype(np.float32)),
        torch.tensor(rng.uniform(0, 30, cap).astype(np.float32)))
    slots = np.full(u, cap, np.int32)
    slots[:live] = np.sort(rng.choice(cap, live, replace=False))
    x = rng.normal(5, 3, (t, u)).astype(np.float32)
    active = rng.random((t, u)) < 0.8
    active[:, live:] = False
    args = [torch.tensor(a, device=dev) for a in (slots, x, active)]
    s_k = StreamState(*(a.to(dev) for a in base))
    s_p = StreamState(*(a.to(dev) for a in base))
    launches = _build.launches().get("stream_scan", 0)
    anom_k = fd.stream_scan(s_k, *args)
    assert _build.launches()["stream_scan"] == launches + 1
    anom_p = fd._stream_half_plain(s_p, *args, 0.5)
    torch.cuda.synchronize()
    assert torch.equal(anom_k, anom_p)
    for a, b in zip(s_k, s_p):
        assert torch.equal(a, b)


# -- B1 grouped: one launch over every shard's tile ---------------------

#: (T, U, live) of mixed tiles; the last is all padding (no live slot)
MIXED = [(1, 64, 40), (2, 256, 200), (3, 64, 64), (8, 128, 100),
         (4, 256, 0)]


def _scan_tiles(rng, spec, cap=CAP):
    tiles = []
    for t, u, live in spec:
        stream, _, _ = _carried(rng, cap)
        slots, x, active = _inputs(rng, t, u, live, cap)[:3]
        tiles.append((StreamState(*(torch.from_numpy(a.copy())
                                    for a in stream)),
                      torch.from_numpy(slots), torch.from_numpy(x),
                      torch.from_numpy(active)))
    return tiles


def _clone_tiles(tiles):
    return [(StreamState(*(a.clone() for a in st)), *rest)
            for st, *rest in tiles]


@pytest.mark.parametrize("n_copies", [1, 4], ids=["5_tiles", "20_tiles"])
def test_grouped_matches_plain_tile_by_tile(n_copies):
    """On CPU tensors the grouped wrapper is `_stream_half_plain` per
    tile, whatever the number of tiles (20 > MAX_TILES), and launches
    nothing."""
    rng = np.random.default_rng(41 + n_copies)
    tiles = _scan_tiles(rng, MIXED * n_copies)
    want_tiles = _clone_tiles(tiles)
    launches, counted = _build.launches(), fd.tiles
    got = fd.stream_scan_grouped(tiles)
    assert (_build.launches(), fd.tiles) == (launches, counted)
    want = [fd._stream_half_plain(*tile, 0.5) for tile in want_tiles]
    assert len(got) == len(tiles)
    for (st, _, x, _), (st_w, *_), g, w in zip(tiles, want_tiles, got,
                                                 want):
        assert g.shape == x.shape and g.dtype == torch.bool
        assert torch.equal(g, w)
        for a, b in zip(st, st_w):
            assert torch.equal(a, b)
    assert not got[4].any()            # the all-padding tile


@pytest.mark.parametrize("use_pallas", [False, True],
                         ids=["jnp_scan", "pallas_interpret"])
def test_fused_step_mixed_tiles_matches_reference(use_pallas):
    """One fused step over shards of mixed T and U (one of them all
    padding) against the reference's fused_step, three steps in a
    row."""
    rng = np.random.default_rng(43)
    carried = [_carried(rng) for _ in MIXED]
    r_states = tuple(_ref_state(*c) for c in carried)
    p_states = tuple(fd.shard_state_from_numpy(*c, "cpu")
                     for c in carried)
    for _ in range(3):
        arrays = [_inputs(rng, t, u, live) for t, u, live in MIXED]
        r_states, r_outs = ref_fd.fused_step(
            r_states, tuple(_ref_inputs(a) for a in arrays), alpha=0.5,
            use_pallas=use_pallas, interpret=use_pallas)
        p_states, p_outs = fd.fused_step(
            p_states, tuple(_port_inputs(a) for a in arrays), alpha=0.5)
        for ps, rs, po, ro in zip(p_states, r_states, p_outs, r_outs):
            _assert_state_matches(ps, rs)
            np.testing.assert_array_equal(po.anomaly.numpy(),
                                          np.asarray(ro.anomaly))
            np.testing.assert_array_equal(po.est.numpy(),
                                          np.asarray(ro.est))
            np.testing.assert_allclose(po.dist.numpy(),
                                       np.asarray(ro.dist),
                                       rtol=1e-5, atol=1e-4)
    assert any(o.anomaly.any() for o in p_outs)
    assert not p_outs[-1].anomaly.any()


def test_group_plan_block_offsets():
    """A tile takes ceil(U / THREADS) blocks; its first block is the sum
    over the tiles before it in its launch; the last entry is the
    grid."""
    shapes = [(1, 64), (2, 300), (1, 8192), (8, 65536)]
    assert fd._group_plan(shapes) == [([0, 1, 2, 3], [0, 1, 3, 35, 291])]
    assert fd.THREADS == 256


def test_group_plan_chunks_past_max_tiles():
    """More tiles than one launch takes go out in chunks of at most
    MAX_TILES, in order; tiles without work (T or U zero) get no
    blocks and no place in a launch."""
    shapes = ([(1, 64)] * 3 + [(2, 300), (0, 64), (4, 0)]
              + [(1, 8192)] * (2 * fd.MAX_TILES))
    plan = fd._group_plan(shapes)
    work = [k for k, (t, u) in enumerate(shapes) if t and u]
    assert [k for idx, _ in plan for k in idx] == work
    assert [len(idx) for idx, _ in plan] == [fd.MAX_TILES, fd.MAX_TILES, 4]
    for idx, first in plan:
        assert first[0] == 0 and len(first) == len(idx) + 1
        for k, a, b in zip(idx, first, first[1:]):
            assert b - a == -(-shapes[k][1] // fd.THREADS)
        # the kernel's lookup: the last tile whose first block is <= the
        # block's index owns the block
        owner = [max(n for n in range(len(idx)) if first[n] <= blk)
                 for blk in range(first[-1])]
        assert owner == [n for n, (a, b) in enumerate(zip(first, first[1:]))
                         for _ in range(a, b)]
    assert fd._group_plan([]) == [] and fd._group_plan([(0, 64)]) == []


def test_grouped_refuses_tiles_that_share_state():
    """Two tiles of one launch writing one state array would race: the
    wrapper refuses the same tensors and overlapping views, and takes
    disjoint views of one buffer."""
    rng = np.random.default_rng(47)
    a, b = _scan_tiles(rng, [(1, 64, 40), (2, 64, 30)])
    with pytest.raises(ValueError, match="shares state memory"):
        fd.stream_scan_grouped([a, (a[0], *b[1:])])
    buf = torch.zeros(4 * CAP)
    counts = torch.zeros(2 * CAP, dtype=torch.int32)

    def state(lo):
        return StreamState(buf[lo:lo + CAP], counts[lo:lo + CAP],
                           buf[2 * CAP + lo:2 * CAP + lo + CAP],
                           torch.zeros(CAP))

    with pytest.raises(ValueError, match="shares state memory"):
        fd.stream_scan_grouped([(state(0), *a[1:]),
                                (state(CAP // 2), *b[1:])])
    flags = fd.stream_scan_grouped([(state(0), *a[1:]),
                                    (state(CAP), *b[1:])])
    assert [f.shape for f in flags] == [a[2].shape, b[2].shape]
    with pytest.raises(ValueError):
        fd.stream_scan_grouped([a, (b[0], b[1], b[2][:, :32], b[3])])


@pytest.mark.cuda
def test_grouped_kernel_matches_plain_on_card():
    """B1 grouped over mixed tiles (two launches of at most MAX_TILES)
    on the card against the plain version tile by tile, bit-exact."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: B1 is a CUDA kernel")
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(53)
    spec = MIXED * 3 + [(1, 4096, 3000), (16, 512, 400)]
    tiles = [(StreamState(*(a.to(dev) for a in st)), *(v.to(dev)
                                                       for v in rest))
             for st, *rest in _scan_tiles(rng, spec, cap=4096)]
    plain = _clone_tiles(tiles)
    launches, counted = _build.launches().get("stream_scan", 0), fd.tiles
    got = fd.stream_scan_grouped(tiles)
    assert _build.launches()["stream_scan"] == launches + 2
    assert fd.tiles == counted + len(spec)
    want = [fd._stream_half_plain(*tile, 0.5) for tile in plain]
    torch.cuda.synchronize()
    for (st, *_), (st_p, *_), g, w in zip(tiles, plain, got, want):
        assert torch.equal(g, w)
        for a, b in zip(st, st_p):
            assert torch.equal(a, b)
