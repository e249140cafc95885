"""Port parity: theia_tpu_torch.ops.dbscan against theia_tpu.ops.dbscan
and the Pallas kernel B2 (theia_tpu/ops/dbscan_pallas.py), on the CPU.

The reference runs as its own tests run it on the CPU: `dbscan_noise`
through XLA, and `dbscan_noise_pallas` through the Pallas interpreter.
The port's `dbscan_noise` is the plain version; `dbscan_noise_cuda`,
B2's wrapper, runs the plain version on x cast to float32 when handed
CPU tensors. Noise flags are exact everywhere: the test is one
subtraction, an absolute value and a comparison per pair, each rounded
the same way on both sides. stddev (the row filler of dbscan_scores)
is a sum in another order: rtol 2e-15 in float64.

Inputs follow tests/test_kernels.py: half the points ~N(2e8, 1e7), the
rest U(1e5, 1e9), about 80% valid, plus pairs placed exactly eps apart
(within, since the test is <=), a core, a border and a noise point
(_KINDS), an all-padding row and T = 1.
"""

from __future__ import annotations

import importlib

import numpy as np
import pytest
import torch

from theia_tpu.ops.dbscan_pallas import dbscan_noise_pallas
from theia_tpu_torch.ops import _build

ref = importlib.import_module("theia_tpu.ops.dbscan")
port = importlib.import_module("theia_tpu_torch.ops.dbscan")

EPS = port.DEFAULT_EPS
SHAPES = [(5, 7), (33, 40), (1, 1), (16, 128)]


#: a core point with three neighbours below it, a border point 0.9 eps
#: above it (two neighbours: itself and the core) and an isolated
#: noise point, far above the rest of the data
_KINDS = 8.6e9 + EPS * np.array([0.0, -0.5, -0.6, -0.7, 0.9, 100.0])


def _inputs(seed, s, t, dtype=np.float32):
    rng = np.random.default_rng(seed)
    x = rng.uniform(1e5, 1e9, size=(s, t))
    half = max(t // 2, 1)
    x[:, :half] = rng.normal(2e8, 1e7, size=(s, half))
    mask = rng.random(size=(s, t)) > 0.2
    if t >= 4:
        # a chain of points exactly eps apart: each pair is within
        x[0, -4:] = 5e8 + EPS * np.arange(4)
        mask[0, -4:] = True
    if t >= 6 and (s > 1 or t >= 10):
        row = min(1, s - 1)
        x[row, :6] = _KINDS
        mask[row, :6] = True
    if s >= 3:
        mask[2] = False
    return x.astype(dtype), mask


def test_eps_apart_pairs_are_exact_in_float32():
    """The chain is representable: 5e8 + k·2.5e8 are float32 integers,
    so the differences are exactly eps."""
    x, _ = _inputs(0, 5, 7)
    assert np.all(np.diff(x[0, -4:].astype(np.float64)) == EPS)


@pytest.mark.parametrize("s,t", SHAPES)
def test_plain_matches_reference_and_pallas_float32(s, t):
    x, mask = _inputs(s * 1000 + t, s, t)
    got = port.dbscan_noise(torch.tensor(x), torch.tensor(mask)).numpy()
    want = np.asarray(ref.dbscan_noise(x, mask))
    pallas = np.asarray(dbscan_noise_pallas(x, mask, interpret=True))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, pallas)
    if s >= 3:
        assert not got[2].any()          # all-padding row
    assert not got[~mask].any()
    # B2's wrapper on CPU tensors is the same plain version
    wrapped = port.dbscan_noise_cuda(torch.tensor(x), torch.tensor(mask))
    np.testing.assert_array_equal(wrapped.numpy(), pallas)


def test_inputs_hold_core_border_and_noise_points():
    """The flags above are not all one value: each kind of point
    occurs, so a kernel writing a constant would fail."""
    for s, t in SHAPES[:2] + SHAPES[3:]:
        x, mask = _inputs(s * 1000 + t, s, t)
        xt, mt = torch.tensor(x), torch.tensor(mask)
        within = ((xt[:, :, None] - xt[:, None, :]).abs() <= EPS) \
            & mt[:, :, None] & mt[:, None, :]
        core = (within.sum(-1) >= 4) & mt
        reach = (within & core[:, None, :]).any(-1)
        noise = port.dbscan_noise(xt, mt)
        assert core.any() and (~core & reach & mt).any() and noise.any()


@pytest.mark.parametrize("s,t", [(5, 7), (33, 40)])
def test_plain_matches_reference_float64(s, t):
    x, mask = _inputs(s + t, s, t, np.float64)
    got = port.dbscan_noise(torch.tensor(x), torch.tensor(mask))
    assert got.dtype == torch.bool
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(ref.dbscan_noise(x, mask)))


@pytest.mark.parametrize("min_samples", [1, 2, 4, 9])
def test_plain_matches_reference_min_samples(min_samples):
    x, mask = _inputs(min_samples, 8, 24)
    got = port.dbscan_noise(torch.tensor(x), torch.tensor(mask),
                            eps=1e8, min_samples=min_samples).numpy()
    want = np.asarray(ref.dbscan_noise(x, mask, eps=1e8,
                                       min_samples=min_samples))
    np.testing.assert_array_equal(got, want)


def test_dbscan_scores_on_a_cpu_tensor_match_reference():
    x, mask = _inputs(7, 12, 32, np.float64)
    calc, std, anom = port.dbscan_scores(torch.tensor(x),
                                         torch.tensor(mask))
    rcalc, rstd, ranom = ref.dbscan_scores(x, mask, use_pallas=False)
    np.testing.assert_array_equal(anom.numpy(), np.asarray(ranom))
    np.testing.assert_array_equal(calc.numpy(), np.asarray(rcalc))
    assert calc.dtype == torch.float64
    np.testing.assert_allclose(std.numpy(), np.asarray(rstd), rtol=2e-15)


def test_wrapper_rejects_mismatched_shapes_and_takes_empty_batches():
    x = torch.zeros((3, 4))
    with pytest.raises(ValueError):
        port.dbscan_noise_cuda(x, torch.ones((3, 5), dtype=torch.bool))
    with pytest.raises(ValueError):
        port.dbscan_noise_cuda(x[0], torch.ones(4, dtype=torch.bool))
    launches = _build.launches()
    out = port.dbscan_noise_cuda(torch.zeros((0, 4)),
                                 torch.zeros((0, 4), dtype=torch.bool))
    assert out.shape == (0, 4) and out.dtype == torch.bool
    assert _build.launches() == launches     # CPU tensors launch nothing


@pytest.mark.cuda
@pytest.mark.parametrize("s,t", [(5, 7), (16, 128), (33, 40), (1, 1),
                                 (64, 1440), (4, 4096)])
def test_dbscan_kernel_matches_plain_on_card(s, t):
    """B2 on the card against its plain version on the card, bit-exact,
    and one launch counted per call."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: B2 is a CUDA kernel")
    x, mask = _inputs(s + t, s, t)
    dev = torch.device("cuda", 0)
    xt, mt = torch.tensor(x, device=dev), torch.tensor(mask, device=dev)
    launches = _build.launches().get("dbscan_noise", 0)
    got = port.dbscan_noise_cuda(xt, mt)
    assert _build.launches()["dbscan_noise"] == launches + 1
    want = port.dbscan_noise(xt, mt)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


# -- B2 redesign: folded mask, float64 input, pair recount, routes ------

def _chip_smoke():
    """chip_smoke.py (at the repo root), for its B2 pair count."""
    import importlib.util
    from pathlib import Path
    path = Path(__file__).resolve().parent.parent / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _folded_noise(x, mask, eps, min_samples):
    """B2's arithmetic in plain torch: the j side holds m_j ? x_j : NaN
    (pass 1) and core_j ? x_j : NaN (pass 2); the i side keeps m_i."""
    nan = torch.full_like(x, float("nan"))
    xm = torch.where(mask, x, nan)
    count = ((x[:, :, None] - xm[:, None, :]).abs() <= eps).sum(-1)
    core = mask & (count >= min_samples)
    xc = torch.where(core, x, nan)
    reach = ((x[:, :, None] - xc[:, None, :]).abs() <= eps).any(-1)
    return mask & ~core & ~reach


def _special_inputs(seed, s=6, t=24):
    """_inputs plus valid NaN and ±inf points, an invalid NaN, invalid
    points right beside valid ones, and chains exactly eps apart."""
    x, mask = _inputs(seed, s, t)
    x[2, :8] = [np.nan, np.inf, -np.inf, 1e9, 1e9 + EPS, 1e9 + 2 * EPS,
                np.nan, 9e9]
    mask[2, :8] = [True, True, True, True, True, True, False, True]
    x[3, :6] = [4e9, 4e9, 4e9, 4e9 + EPS, 4e9 + EPS / 2, 4e9 - EPS]
    mask[3, :6] = [True, False, False, True, False, True]
    x[4, :] = np.inf
    mask[4, ::2] = True
    return x, mask


@pytest.mark.parametrize("min_samples", [0, 1, 2, 4, 9])
def test_mask_folded_into_x_as_nan_is_exact(min_samples):
    """Folding the mask into x on the j side (NaN is within no one)
    gives dbscan_noise's flags and the reference's, with valid NaN and
    ±inf points, invalid neighbours and pairs exactly eps apart."""
    x, mask = _special_inputs(min_samples)
    xt, mt = torch.tensor(x), torch.tensor(mask)
    got = _folded_noise(xt, mt, EPS, min_samples)
    want = port.dbscan_noise(xt, mt, min_samples=min_samples)
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(ref.dbscan_noise(x, mask,
                                                 min_samples=min_samples)))
    if min_samples == 4:
        # a valid NaN or inf is noise; the masked-out neighbours of
        # row 3 do not make 4e9 core
        assert got[2, :3].all() and got[3, 0]


def test_float64_input_gives_the_float32_flags():
    """The wrapper computes in float32: float64 x is rounded first (on
    the card by the kernel). 2.5e8 + 1 is eps + 1 apart from 0 in
    float64 and exactly eps in float32."""
    x, mask = _inputs(61, 5, 24, np.float64)
    x[0, :4] = [0.0, EPS + 1, 3 * EPS, 3 * EPS + 1]
    mask[0, :4] = True
    mask[0, 4:] = False
    xt, mt = torch.tensor(x), torch.tensor(mask)
    got = port.dbscan_noise_cuda(xt, mt, min_samples=2)
    assert torch.equal(got, port.dbscan_noise(xt.float(), mt,
                                              min_samples=2))
    assert not torch.equal(got, port.dbscan_noise(xt, mt, min_samples=2))


def test_pair_recount_by_hand():
    """x = [0, 10, 20, 1e9], eps 15, min_samples 2: pass 1 needs 2, 2,
    3 and 4 tests (the last point never reaches two neighbours); pass 2
    tests the one non-core point against all 3 core points."""
    cs = _chip_smoke()
    x = torch.tensor([[0.0, 10.0, 20.0, 1e9]])
    got = cs.dbscan_pair_tests(x, torch.ones_like(x, dtype=torch.bool),
                               eps=15.0, min_samples=2)
    assert got == {"pairs_full": 4 * 4 + 1 * 3, "pairs_needed": 11 + 3}


@pytest.mark.parametrize("s,t", SHAPES)
def test_pair_recount_is_at_most_the_full_count(s, t):
    """The pairs these inputs need never exceed the pairs the two passes
    test without an early exit, and equal them when min_samples exceeds
    T (no point is core, so every valid pair is tested and no reach
    test is needed)."""
    cs = _chip_smoke()
    x, mask = _inputs(s * 1000 + t, s, t)
    xt, mt = torch.tensor(x), torch.tensor(mask)
    got = cs.dbscan_pair_tests(xt, mt)
    assert 0 <= got["pairs_needed"] <= got["pairs_full"]
    if t >= 16:
        assert got["pairs_needed"] < got["pairs_full"]
    big = cs.dbscan_pair_tests(xt, mt, min_samples=t + 1)
    assert big["pairs_needed"] == big["pairs_full"] \
        == int((mt.sum(-1).long() ** 2).sum())


@pytest.mark.parametrize("s,t,route,r,p,b", [
    (8192, 128, "one_launch", 2, 64, 2),      # the TAD path
    (256, 1440, "one_launch", 2, 736, 1),     # 256 blocks fill the SMs
    (64, 1440, "two_pass", 2, 736, 1),        # 64 long series: too few
    (4, 4096, "two_pass", 4, 1024, 1),
    (1, 4097, "two_pass", 4, 1056, 1),        # longer than a block holds
    (5, 7, "one_launch", 2, 8, 16),           # short: one launch whatever
    (33, 40, "one_launch", 2, 32, 4),
    (1, 512, "one_launch", 2, 256, 1),
    (16, 128, "one_launch", 2, 64, 2),
])
def test_route_and_block_plan(s, t, route, r, p, b):
    plan = port._plan(s, t)
    assert (plan.route, plan.points_per_thread, plan.threads_per_series,
            plan.series_per_block) == (route, r, p, b)
    assert plan.blocks == -(-s // b)
    assert plan.padded_t == -(-t // 16) * 16


@pytest.mark.parametrize("t", [1, 7, 16, 17, 40, 64, 100, 128, 129, 500,
                               1024, 1440, 2048, 2049, 4000, 4096])
def test_one_launch_geometry_is_what_the_kernel_takes(t):
    """P threads of R points (2, or 4 past 2,048) cover the padded
    series; a block is whole warps of at most 1,024 threads, at least
    128 where a series is a warp or less; its shared memory (two staged
    copies) stays under 48 KB."""
    plan = port._plan(1000, t)
    p, b, tp = plan.threads_per_series, plan.series_per_block, plan.padded_t
    assert tp % port._CHECK == 0 and tp >= t
    assert plan.points_per_thread == (2 if tp <= 2048 else 4)
    assert p * plan.points_per_thread >= tp
    assert p % 32 == 0 or (32 % p == 0 and (p * b) % 32 == 0)
    assert p * b <= 1024
    if p <= 32:
        assert p * b == 128
    assert 2 * b * tp * 4 <= 48 * 1024


@pytest.mark.cuda
@pytest.mark.parametrize("s,t", [(5, 7), (16, 128), (33, 40), (1, 1),
                                 (64, 1440), (4, 4096), (3, 5000)])
def test_dbscan_routes_match_plain_on_card(s, t):
    """Each of B2's routes that applies, float32 and float64 x, on the
    card against the plain version on x in float32, bit-exact; plus the
    special values."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: B2 is a CUDA kernel")
    dev = torch.device("cuda", 0)
    cases = [_inputs(s + t, s, t)]
    if s >= 5 and t >= 8:
        cases.append(_special_inputs(s, s, t))
    for x, mask in cases:
        xt = torch.tensor(x, device=dev)
        mt = torch.tensor(mask, device=dev)
        want = port.dbscan_noise(xt, mt)
        routes = [port._noise_two_pass]
        if t <= port._ONE_MAX_T:
            routes.append(port._noise_one_launch)
        for fn in routes:
            for xin in (xt, xt.double()):
                got = fn(xin, mt)
                torch.cuda.synchronize()
                assert torch.equal(got, want), (fn.__name__, xin.dtype)
