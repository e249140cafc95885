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
    launches = port.launches
    out = port.dbscan_noise_cuda(torch.zeros((0, 4)),
                                 torch.zeros((0, 4), dtype=torch.bool))
    assert out.shape == (0, 4) and out.dtype == torch.bool
    assert port.launches == launches     # CPU tensors launch nothing


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
    launches = port.launches
    got = port.dbscan_noise_cuda(xt, mt)
    assert port.launches == launches + 1
    want = port.dbscan_noise(xt, mt)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
