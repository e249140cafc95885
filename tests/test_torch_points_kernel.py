"""The spatial DBSCAN's pairwise kernel (csrc/points_pairs.cu) and its
wrappers in theia_tpu_torch/ops/dbscan.py: `points_neighbour_counts`
and `points_reachable` route CUDA tensors to one kernel launch a pass
and CPU tensors to the plain torch tiles.

The CPU cases hold what surrounds the kernel: the checks that refuse a
CUDA pass the kernel cannot take, the packed layout, the kernel's test
h − t·x ≤ lim (emulated in float64 with a float32 rounding a step)
against exact arithmetic outside the eps band, the reach pass's row
core flags on the plain path, and the passes' spans. The `cuda` cases
hold the kernel against the plain version on the card. This file
imports no JAX, so on a machine without it they run with
`python -m pytest --noconftest -m cuda tests/test_torch_points_kernel.py`.
"""

from __future__ import annotations

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from theia_tpu_torch.analytics import spatial as port_spatial
from theia_tpu_torch.data.synth import SynthConfig
from theia_tpu_torch.data.synth import generate_flows as port_generate
from theia_tpu_torch.obs import trace
from theia_tpu_torch.ops import _build, dbscan
from test_torch_analysis import port_lockdep_clean  # noqa: F401

REPO = Path(__file__).resolve().parent.parent


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", REPO / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _points(seed: int, n: int, f: int, scale: float = 1.0) -> torch.Tensor:
    """Clusters around a few centres plus scattered points, float32."""
    rng = np.random.default_rng(seed)
    centres = rng.uniform(-10, 10, (6, f))
    pts = centres[rng.integers(0, 6, n)] + rng.normal(0, 0.4, (n, f))
    pts[: n // 20] = rng.uniform(-30, 30, (n // 20, f))
    return torch.from_numpy((pts * scale).astype(np.float32))


def _flow_embeddings(n_series: int, seed: int) -> torch.Tensor:
    """The SAD job's own input: flow embeddings, 32 flows a series."""
    flows = port_generate(SynthConfig(n_series=n_series,
                                      points_per_series=32, seed=seed))
    return torch.from_numpy(port_spatial.flow_embeddings(flows))


# -- the checks, without a card ------------------------------------------

def _ok(m=10, n=12, f=7):
    return (torch.zeros(m, f), torch.zeros(n, f),
            torch.ones(n, dtype=torch.bool))


@pytest.mark.parametrize("f", [1, 4, 5, 7])
def test_check_points_takes_the_ports_widths(f):
    dbscan._check_points(*_ok(f=f))


@pytest.mark.parametrize("case", [
    "rows_float64", "points_float16", "width_8", "widths_differ",
    "rows_not_contiguous", "points_not_contiguous", "rows_1d",
    "flags_int", "flags_short"])
def test_check_points_refuses_what_the_kernel_does_not_take(case):
    rows, points, flags = _ok()
    if case == "rows_float64":
        rows = rows.double()
    elif case == "points_float16":
        points = points.half()
    elif case == "width_8":
        rows, points, flags = _ok(f=8)
    elif case == "widths_differ":
        rows = torch.zeros(10, 5)
    elif case == "rows_not_contiguous":
        rows = torch.zeros(7, 10).T
    elif case == "points_not_contiguous":
        points = torch.zeros(24, 7)[::2]
    elif case == "rows_1d":
        rows = torch.zeros(7)
    elif case == "flags_int":
        flags = flags.int()
    elif case == "flags_short":
        flags = flags[:-1]
    with pytest.raises(ValueError, match="points_pairs"):
        dbscan._check_points(rows, points, flags)


def test_route_by_device():
    """CPU tensors take the plain version; a device with no kernel and
    no plain route raises, never falls back."""
    assert dbscan._route(*_ok()) == "torch"
    meta = [t.to("meta") for t in _ok()]
    with pytest.raises(ValueError, match="no route"):
        dbscan._route(*meta)


# -- the packed layout and the kernel's test -----------------------------

def test_packed_layout():
    pts = _points(1, 300, 5)
    flags = torch.rand(300, generator=torch.Generator().manual_seed(2)) < 0.7
    rows, cols = dbscan._pack_pass(pts[:100], pts, flags, 1.5,
                                   dbscan._PTS_BLOCK_ROWS[False],
                                   dbscan._PTS_TILE)
    assert rows.shape == (2048, 8) and cols.shape == (512, 8)
    assert rows.dtype == cols.dtype == torch.float32
    p64 = pts.double()
    sq = p64[:, 0] ** 2
    for k in range(1, 5):
        sq = sq + p64[:, k] ** 2
    assert torch.equal(rows[:100, :5], pts[:100])
    assert torch.equal(cols[:300, :5], -pts)
    assert not rows[:100, 5:7].any() and not cols[:300, 5:7].any()
    assert torch.equal(rows[:100, 7], ((2.25 - sq[:100]) / 2).float())
    assert torch.equal(cols[:300, 7][flags], (sq[flags] / 2).float())
    assert cols[:300, 7][~flags].isnan().all()
    assert rows[100:].isnan().all() and cols[300:].isnan().all()


def test_norms_do_not_depend_on_the_rows_a_tensor_holds():
    """A shard's packed rows equal the same points' rows in the whole
    set bit for bit."""
    pts = _points(3, 1000, 7, scale=13.0)
    whole = dbscan._sq_norms(pts)
    for lo, hi in ((0, 250), (250, 500), (977, 1000)):
        assert torch.equal(dbscan._sq_norms(pts[lo:hi]), whole[lo:hi])


def test_non_finite_points_never_pass():
    pts = _points(4, 64, 4)
    pts[3, 1] = float("nan")
    pts[5, 0] = float("inf")
    pts[6] = 3e19          # |x|² overflows float32
    rows, cols = dbscan._pack_pass(pts, pts, torch.ones(64, dtype=torch.bool),
                                   1.0, 1, 1)
    assert rows[[3, 5, 6], 7].isnan().all()
    assert cols[[3, 5, 6], 7].isnan().all()
    assert not rows[[0, 1, 2, 4], 7].isnan().any()


def _emulated_within(rows, cols, f):
    """The kernel's test on packed points: F fused multiply-adds from
    h, emulated in float64 (the product is exact) with a float32
    rounding after each, then acc ≤ lim."""
    acc = cols[:, 7].double()[None, :].expand(len(rows), -1)
    for k in range(f):
        acc = (rows[:, k].double()[:, None] * cols[:, k].double()[None, :]
               + acc).float().double()
    return acc <= rows[:, 7].double()[:, None]


@pytest.mark.parametrize("which", ["clusters_f4", "clusters_f7_scaled",
                                   "flow_embeddings"])
def test_kernel_test_is_exact_outside_the_eps_band(which):
    """The packed test decides every pair whose float64 d² lies outside
    2⁻²⁰·(|x|²+|y|²) of eps² as exact arithmetic does (the rounding
    note of csrc/points_pairs.cu), at the embedding's scale too."""
    if which == "clusters_f4":
        pts, eps = _points(5, 700, 4), 0.8
    elif which == "clusters_f7_scaled":
        pts, eps = _points(6, 700, 7, scale=40.0), 20.0
    else:
        pts, eps = _flow_embeddings(24, 21), 1.0
    n, f = pts.shape
    rows, cols = dbscan._pack_pass(pts, pts, torch.ones(n, dtype=torch.bool),
                                   eps, 1, 1)
    got = _emulated_within(rows, cols, f)
    p64 = pts.double()
    d2 = ((p64[:, None, :] - p64[None, :, :]) ** 2).sum(-1)
    sq = (p64 * p64).sum(1)
    band = 2.0 ** -20 * (sq[:, None] + sq[None, :])
    sure = (d2 - eps * eps).abs() > band
    assert sure.float().mean() > 0.99
    assert torch.equal(got[sure], (d2 <= eps * eps)[sure])
    assert got.any() and not got.all()


# -- the plain path with the rows' core flags ----------------------------

@pytest.mark.parametrize("seed,n,lo,hi,block", [
    (7, 300, 0, 300, 64),       # rows = points
    (8, 300, 75, 150, 64),      # a shard's row block
    (9, 517, 100, 517, 128),    # N not a multiple of the block
])
def test_row_core_gives_the_same_noise_on_the_plain_path(seed, n, lo, hi,
                                                          block):
    pts = _points(seed, n, 5)
    valid = torch.ones(n, dtype=torch.bool)
    valid[-7:] = False                      # invalid padding
    counts = dbscan.points_neighbour_counts(pts, pts, valid, 1.0, block)
    core = (counts >= 4) & valid
    rows, c, v = pts[lo:hi], core[lo:hi], valid[lo:hi]
    without = dbscan._pairs_tiles(rows, pts, core, 1.0, block, reach=True)
    with_core = dbscan.points_reachable(rows, pts, core, 1.0, block,
                                        row_core=c)
    assert torch.equal(v & ~c & ~with_core, v & ~c & ~without)
    assert with_core[c].all()
    whole = dbscan.dbscan_points_noise(pts, valid, 1.0, block=block)
    assert torch.equal((v & ~c & ~with_core), whole[lo:hi])
    assert whole.any() and not whole.all()


@pytest.mark.parametrize("core_share", ["none", "all"])
def test_reach_pass_with_no_core_and_all_core_rows(core_share):
    pts = _points(10, 200, 4)
    core = torch.full((200,), core_share == "all")
    got = dbscan.points_reachable(pts, pts, core, 1.0, 64, row_core=core)
    assert torch.equal(got, core)


def test_pass_spans_carry_the_route_on_the_cpu():
    """Both passes are spans with route "torch" on CPU tensors; the
    reach span's `rows` counts the non-core rows it evaluated."""
    pts = _points(11, 300, 7)
    valid = torch.ones(300, dtype=torch.bool)
    cap = trace.start_capture()
    try:
        noise = dbscan.dbscan_points_noise(pts, valid, 1.0, block=128)
    finally:
        trace.stop_capture(cap)
    by_op = {r["op"]: r for r in cap.records}
    count, reach = by_op["dbscan.count_pass"], by_op["dbscan.reach_pass"]
    assert count["route"] == reach["route"] == "torch"
    assert (count["rows"], count["points"], count["block"]) == (384, 384,
                                                                128)
    padded = torch.cat([valid, torch.zeros(84, dtype=torch.bool)])
    counts = dbscan.points_neighbour_counts(
        dbscan._pad_rows(pts, 128), dbscan._pad_rows(pts, 128), padded, 1.0)
    assert reach["rows"] == int((~((counts >= 4) & padded)).sum())
    assert 0 < reach["rows"] < 384 and noise.any()


def test_no_launch_on_the_cpu():
    before = _build.launches()
    dbscan.dbscan_points_noise(_points(12, 100, 4),
                               torch.ones(100, dtype=torch.bool), 1.0)
    assert _build.launches() == before


# -- on the card ---------------------------------------------------------

def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def _shape_inputs(case: str, f: int):
    """(rows slice, points, valid, eps) for one card case."""
    if case == "flow_embeddings":
        pts = _flow_embeddings(512, 5)       # 16,384 flows, F = 7
        return slice(None), pts, torch.ones(len(pts), dtype=torch.bool), 1.0
    n = {"m_eq_n": 4096, "shard_rows": 4096, "ragged": 3001,
         "all_invalid": 777, "no_core": 500, "all_core": 600,
         "identical": 300}[case]
    pts = _points(20 + f, n, f)
    valid = torch.ones(n, dtype=torch.bool)
    eps = 1.0
    rows = slice(None)
    if case == "shard_rows":
        rows = slice(1024, 2048)
    elif case == "all_invalid":
        valid[:] = False
    elif case == "no_core":
        # a lattice of spacing 3 > eps: every point alone
        grid = np.stack(np.meshgrid(*[np.arange(5)] * f, indexing="ij"),
                        -1).reshape(-1, f)[:n]
        pts = torch.from_numpy(grid.astype(np.float32) * 3)
    elif case == "all_core":
        eps = 1e3
    elif case == "identical":
        pts = torch.full((n, f), 2.5)
    valid[-3:] = False                      # invalid padding
    return rows, pts, valid, eps


CARD_CASES = ["m_eq_n", "shard_rows", "ragged", "all_invalid", "no_core",
              "all_core", "identical"]


@pytest.mark.cuda
@pytest.mark.parametrize("f", [4, 5, 7])
@pytest.mark.parametrize("case", CARD_CASES + ["flow_embeddings"])
def test_kernel_matches_plain_outside_the_eps_band(case, f):
    """Counts and noise of the kernel's passes against the plain
    version's on the card: a row may differ only where the float64
    recount finds a pair in the eps band."""
    dev = _card()
    if case == "flow_embeddings" and f != 7:
        pytest.skip("the job's embedding is 7 wide")
    rows, pts, valid, eps = _shape_inputs(case, f)
    pts, valid = pts.to(dev), valid.to(dev)
    r = pts[rows].contiguous()
    got = dbscan.points_neighbour_counts(r, pts, valid, eps)
    want = dbscan._pairs_tiles(r, pts, valid, eps, 1024, reach=False)
    core_all = (dbscan.points_neighbour_counts(pts, pts, valid, eps) >= 4) \
        & valid
    c = core_all[rows]
    reach = dbscan.points_reachable(r, pts, core_all, eps, row_core=c)
    reach_p = dbscan._pairs_tiles(r, pts, core_all, eps, 1024, reach=True)
    noise = valid[rows] & ~c & ~reach
    noise_p = valid[rows] & ~c & ~reach_p
    idx = torch.arange(len(pts), device=dev)[rows]
    differ = ((got != want) | (noise != noise_p)).nonzero()[:, 0]
    if len(differ):
        _, amb = _chip_smoke().points_recount(pts, idx[differ], eps, 4)
        assert amb.all(), idx[differ][~amb.to(dev)].tolist()[:20]
    if case == "all_invalid":
        assert not got.any() and not noise.any()
    if case == "no_core":
        assert not c.any() and torch.equal(noise, valid[rows])
    if case in ("all_core", "identical"):
        assert c[valid[rows]].all() and not noise.any()


@pytest.mark.cuda
def test_nan_coordinates_compare_false_on_the_card():
    dev = _card()
    pts = _points(30, 500, 7)
    pts[10, 2] = float("nan")
    pts[11] = float("inf")
    valid = torch.ones(500, dtype=torch.bool)
    got = dbscan.points_neighbour_counts(pts.to(dev), pts.to(dev),
                                         valid.to(dev), 1.0).cpu()
    want = dbscan.points_neighbour_counts(pts, pts, valid, 1.0)
    assert got[10] == got[11] == 0 == want[10] == want[11]
    assert got.sum() > 0


@pytest.mark.cuda
def test_sharded_flags_equal_one_device_bit_for_bit():
    """Four logical shards of the card against one device: the same
    kernel over each shard's rows gives the same flags."""
    from theia_tpu_torch import parallel
    dev = _card()
    pts = _flow_embeddings(512, 9).to(dev)       # 16,384 flows
    valid = torch.ones(len(pts), dtype=torch.bool, device=dev)
    valid[-5:] = False
    one = dbscan.dbscan_points_noise(pts, valid, eps=1.0)
    core = (dbscan.points_neighbour_counts(pts, pts, valid, 1.0) >= 4) \
        & valid
    # a count pass a shard, and a reach pass a shard with a non-core row
    want = 4 + sum(bool((~c).any()) for c in core.chunk(4))
    mesh = parallel.make_rows_mesh(devices=[dev] * 4)
    before = _build.launches().get("points_pairs", 0)
    sharded = parallel.make_sharded_points_dbscan(mesh, eps=1.0)(pts, valid)
    assert _build.launches()["points_pairs"] - before == want
    assert torch.equal(sharded.to(dev), one)
    assert one.any()


@pytest.mark.cuda
def test_two_launches_a_one_device_call():
    dev = _card()
    pts = _flow_embeddings(128, 3).to(dev)
    valid = torch.ones(len(pts), dtype=torch.bool, device=dev)
    torch.backends.cuda.matmul.allow_tf32 = True
    before = _build.launches().get("points_pairs", 0)
    noise = dbscan.dbscan_points_noise(pts, valid, eps=1.0)
    assert _build.launches()["points_pairs"] - before == 2
    assert not torch.backends.cuda.matmul.allow_tf32
    assert noise.any()


@pytest.mark.cuda
def test_pass_memory_at_the_cells_size():
    """At N = 262,144 a pass allocates under 64 MiB above its inputs:
    no [block, N] temporary."""
    dev = _card()
    n = 262_144
    pts = _points(40, n, 7, scale=5.0).to(dev)
    valid = torch.ones(n, dtype=torch.bool, device=dev)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    counts = dbscan.points_neighbour_counts(pts, pts, valid, 1.0)
    core = (counts >= 4) & valid
    dbscan.points_reachable(pts, pts, core, 1.0, row_core=core)
    torch.cuda.synchronize()
    assert torch.cuda.max_memory_allocated() - base < 64 * 2 ** 20
