"""Port parity: theia_tpu_torch.ops.arima against theia_tpu.ops.arima,
on the CPU, in float64 (the reference's tests run under x64).

The port computes the same formulas in the same order, but log, exp
and pow come from another libm than XLA's, XLA contracts some
multiply-adds into FMAs, and sums over T reduce in another order. So
the floats carry stated tolerances, each within 10× of the largest
difference seen over six seeds of these inputs:

| quantity | limit | largest seen |
|---|---|---|
| boxcox_llf | rtol 1e-12 | 2.2e-13 |
| boxcox_lambda | atol 1e-12 | 2.4e-13 |
| boxcox_transform | rtol 1e-13 | 1.9e-14 |
| inv_boxcox | rtol 1e-15 | 2.1e-16 |
| _fit_prefix (phi, theta) | rtol 1e-13 | 9.9e-15 |
| arima_walk_forward | atol 1e-13 × max\\|y\\| | 2.6e-14 × max\\|y\\| |
| arima_scores predictions | rtol 1e-9 | 1.5e-10 (refit 16) |
| arima_scores stddev | rtol 2e-15 | 3.7e-16 |

The Box-Cox grid is bit-equal to jnp.linspace, and the anomaly flags
are identical, on these inputs and on the golden cases of
tests/test_tad_golden.py and tests/test_kernels.py.
"""

from __future__ import annotations

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

ref = importlib.import_module("theia_tpu.ops.arima")
port = importlib.import_module("theia_tpu_torch.ops.arima")

T = torch.tensor


def _near_one(seed, s=24, t=64):
    """Positive series near 1 (what arima_scores hands boxcox after its
    geometric-mean normalisation), ragged with trailing padding."""
    rng = np.random.default_rng(seed)
    x = np.exp(rng.normal(0, 0.6, (s, t)))
    mask = np.ones((s, t), bool)
    for i in range(s):
        mask[i, rng.integers(4, t + 1):] = False
    return x, mask


def _levels(seed, s=24, t=64):
    """Throughput-scale series with spikes, a non-positive point, a
    short series and trailing padding."""
    rng = np.random.default_rng(100 + seed)
    x = rng.uniform(1e6, 2e6, (s, t))
    x[rng.random((s, t)) < 0.04] *= 25
    mask = np.ones((s, t), bool)
    for i in range(s):
        mask[i, rng.integers(4, t + 1):] = False
    x[0, 3] = 0.0               # non-positive → no anomalies
    mask[1, 3:] = False         # three points → no anomalies
    return x, mask


def test_grid_is_jnp_linspace_bit_for_bit():
    got = np.asarray(port._jax_linspace(-2.0, 2.0, 161))
    want = np.asarray(jnp.linspace(-2.0, 2.0, 161))
    np.testing.assert_array_equal(got, want)
    assert not np.array_equal(
        torch.linspace(-2.0, 2.0, 161, dtype=torch.float64).numpy(), want)


@pytest.mark.parametrize("seed", [0, 1])
def test_boxcox_llf_lambda_and_transforms_match_reference(seed):
    x, mask = _near_one(seed)
    for lam in (-1.3, 0.0, 1e-13, 0.4, 2.0):
        got = port.boxcox_llf(T(lam, dtype=torch.float64), T(x), T(mask))
        want = ref.boxcox_llf(jnp.float64(lam), x, mask)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-12)
    # the grid form (one [G, 1] lambda axis) equals the per-lambda form
    grid = T([[-1.3], [0.4]], dtype=torch.float64)
    both = port.boxcox_llf(grid, T(x), T(mask)).numpy()
    np.testing.assert_array_equal(
        both[1], port.boxcox_llf(T(0.4, dtype=torch.float64), T(x),
                                 T(mask)).numpy())

    lam_r = np.asarray(ref.boxcox_lambda(x, mask))
    lam_p = port.boxcox_lambda(T(x), T(mask)).numpy()
    np.testing.assert_allclose(lam_p, lam_r, rtol=0, atol=1e-12)

    y_r = np.asarray(ref.boxcox_transform(x, lam_r))
    y_p = port.boxcox_transform(T(x), T(lam_r)).numpy()
    np.testing.assert_allclose(y_p, y_r, rtol=1e-13)
    np.testing.assert_allclose(port.inv_boxcox(T(y_r), T(lam_r)).numpy(),
                               np.asarray(ref.inv_boxcox(y_r, lam_r)),
                               rtol=1e-15)


@pytest.mark.parametrize("cut", [0, 3, 10, 40, 63])
def test_fit_prefix_matches_reference(cut):
    x, mask = _near_one(3)
    lam = np.asarray(ref.boxcox_lambda(x, mask))
    y = np.asarray(ref.boxcox_transform(x, lam))
    d = np.diff(y[2])
    w = (np.arange(d.size) < cut).astype(np.float64)
    phi_r, theta_r = ref._fit_prefix(d, w)
    phi_p, theta_p = port._fit_prefix(T(d), T(w))
    np.testing.assert_allclose(phi_p.numpy(), np.asarray(phi_r), rtol=1e-13)
    np.testing.assert_allclose(theta_p.numpy(), np.asarray(theta_r),
                               rtol=1e-13)


@pytest.mark.parametrize("refit", [1, 16])
@pytest.mark.parametrize("chunk", [512, 5])
def test_walk_forward_matches_reference(refit, chunk):
    x, mask = _near_one(refit + chunk)
    lam = np.asarray(ref.boxcox_lambda(x, mask))
    y = np.asarray(ref.boxcox_transform(x, lam))
    got = port.arima_walk_forward(T(y), T(mask), refit_every=refit,
                                  group_chunk=chunk).numpy()
    want = np.asarray(ref.arima_walk_forward(y, mask, refit_every=refit,
                                             group_chunk=chunk))
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-13 * np.abs(y).max())
    np.testing.assert_array_equal(got[:, :3], np.where(mask, y, 0)[:, :3])


@pytest.mark.parametrize("t", [1, 2, 3, 4])
def test_walk_forward_short_batches_match_reference(t):
    """Up to three steps every prediction is the train prefix itself.
    (At T = 1 the reference's jitted walk cannot index its empty
    difference series; the port returns the prefix.)"""
    y = np.linspace(0.5, 1.5, 2 * t).reshape(2, t)
    mask = np.ones((2, t), bool)
    got = port.arima_walk_forward(T(y), T(mask)).numpy()
    if t == 1:
        np.testing.assert_array_equal(got, y)
        return
    np.testing.assert_allclose(
        got, np.asarray(ref.arima_walk_forward(y, mask)), rtol=1e-13)


@pytest.mark.parametrize("refit", [1, 16])
@pytest.mark.parametrize("seed", [0, 1])
def test_arima_scores_match_reference(seed, refit):
    x, mask = _levels(seed)
    pred, std, anom = port.arima_scores(T(x), T(mask), refit_every=refit)
    rpred, rstd, ranom = (np.asarray(a) for a in
                          ref.arima_scores(x, mask, refit_every=refit))
    np.testing.assert_array_equal(anom.numpy(), ranom)
    np.testing.assert_allclose(pred.numpy(), rpred, rtol=1e-9, atol=0)
    np.testing.assert_allclose(std.numpy(), rstd, rtol=2e-15)
    assert ranom.any()
    assert not anom.numpy()[:2].any()    # the error paths stay silent
    assert not pred.numpy()[:2].any()


def test_arima_flags_identical_on_golden_cases():
    """The inputs of tests/test_tad_golden.py's ARIMA case and of
    tests/test_kernels.py's spike/error-path case."""
    rng = np.random.default_rng(17)
    n_series, t = 12, 32
    base = rng.uniform(2, 6, size=(n_series, 1))
    x = base * (1.0 + 0.02 * rng.standard_normal((n_series, t)))
    spike_at = rng.integers(t // 2, t, size=n_series)
    x[np.arange(n_series), spike_at] *= 8.0
    cases = [(x, np.ones((n_series, t), bool))]

    rng = np.random.default_rng(42)   # the suite's rng fixture
    quiet = rng.normal(1e6, 2e4, size=40).clip(1e5)
    spiked = quiet.copy()
    spiked[25] = 3e7
    rows = [quiet, spiked, np.array([1e6, 1.1e6, 0.9e6]),
            np.concatenate([quiet[:10], [0.0]])]
    xk = np.zeros((4, 40))
    mk = np.zeros((4, 40), bool)
    for i, r in enumerate(rows):
        xk[i, :r.size] = r
        mk[i, :r.size] = True
    cases.append((xk, mk))

    for xc, mc in cases:
        _, _, ranom = ref.arima_scores(xc, mc)
        _, _, anom = port.arima_scores(T(xc), T(mc))
        np.testing.assert_array_equal(anom.numpy(), np.asarray(ranom))
        assert anom.numpy().any()
