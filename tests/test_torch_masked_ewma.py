"""Port parity: theia_tpu_torch.ops.masked and .ewma against
theia_tpu.ops.masked and .ewma, on the CPU.

The same seeded numpy inputs go through the JAX function and the
port's. Tolerances: counts, NaN placement, EWMA values and anomaly
flags are exact (the port's scan is jax.lax.associative_scan's
recursion, so each EWMA value combines the same operands in the same
order). Means and sample stddevs are sums over T in another reduction
order than XLA's: rtol 2e-15 in float64 and 1e-6 in float32 (the
largest differences seen over these inputs are 4.4e-16 and 2.3e-7,
two ulps).
"""

from __future__ import annotations

import importlib

import numpy as np
import pytest
import torch

ref_masked = importlib.import_module("theia_tpu.ops.masked")
ref_ewma = importlib.import_module("theia_tpu.ops.ewma")
port_masked = importlib.import_module("theia_tpu_torch.ops.masked")
port_ewma = importlib.import_module("theia_tpu_torch.ops.ewma")

RTOL = {np.float64: 2e-15, np.float32: 1e-6}
DTYPES = (np.float64, np.float32)


def _batch(seed, dtype, s=48, t=100):
    """Ragged series with trailing padding; row 0 is all padding and
    row 1 has one point (stddev NaN for both)."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(1e5, 1e9, (s, t)).astype(dtype)
    mask = np.zeros((s, t), bool)
    for i in range(s):
        mask[i, :rng.integers(0, t + 1)] = True
    mask[0] = False
    mask[1] = False
    mask[1, 0] = True
    mask[2] = True
    return x, mask


def _close(got, want, dtype):
    want = np.asarray(want)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_allclose(got, want, rtol=RTOL[dtype], atol=0)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("seed", [0, 1])
def test_masked_stats_match_reference(seed, dtype):
    x, mask = _batch(seed, dtype)
    xt, mt = torch.tensor(x), torch.tensor(mask)
    np.testing.assert_array_equal(
        port_masked.masked_count(mt).numpy(),
        np.asarray(ref_masked.masked_count(mask)))
    _close(port_masked.masked_mean(xt, mt).numpy(),
           ref_masked.masked_mean(x, mask), dtype)
    std = port_masked.masked_stddev_samp(xt, mt).numpy()
    _close(std, ref_masked.masked_stddev_samp(x, mask), dtype)
    # stddev_samp is NULL (NaN) below two points
    n = mask.sum(axis=1)
    np.testing.assert_array_equal(np.isnan(std), n < 2)
    assert np.isnan(std[0]) and np.isnan(std[1])


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("t", [1, 2, 3, 5, 8, 37, 128])
def test_ewma_is_the_reference_scan_bit_for_bit(t, dtype):
    rng = np.random.default_rng(t)
    x = rng.uniform(1e5, 1e9, (6, t)).astype(dtype)
    for alpha in (0.5, 0.3):
        got = port_ewma.ewma(torch.tensor(x), alpha).numpy()
        want = np.asarray(ref_ewma.ewma(x, alpha))
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_ewma_scores_match_reference(seed, dtype):
    x, mask = _batch(seed, dtype)
    # garbage in the padding must not leak into anything
    x = np.where(mask, x, dtype(3.3e17))
    e, std, anom = port_ewma.ewma_scores(torch.tensor(x),
                                         torch.tensor(mask))
    re, rstd, ranom = ref_ewma.ewma_scores(x, mask)
    np.testing.assert_array_equal(e.numpy(), np.asarray(re))
    _close(std.numpy(), rstd, dtype)
    np.testing.assert_array_equal(anom.numpy(), np.asarray(ranom))
    assert anom.numpy().any()
    assert not anom.numpy()[~mask].any()
