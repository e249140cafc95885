"""Batched walk-forward ARIMA(1,1,1) forecasting.

Ports theia_tpu/ops/arima.py. Reference semantics (the TAD job's
ARIMA, anomaly_detection.py:215-309): for each connection's
throughput series x (needs > 3 points, all positive):
  1. Box-Cox transform with MLE lambda           (scipy.stats.boxcox)
  2. train = y[:3]; for each later step t, fit ARIMA(1,1,1) on history
     y[:t] and forecast one step ahead           (statsmodels, re-fit per t)
  3. predictions = train + forecasts, inverse Box-Cox back to levels
  4. anomaly_t = |x_t − pred_t| > stddev_samp(x)
Series that are too short or fail the transform yield no anomalies.

Every (series, prefix) pair is fitted at once:

  * Box-Cox lambda by a dense grid + parabolic refinement of the
    profile log-likelihood, the grid broadcast as a leading [G] axis.
  * ARIMA(1,1,1) = ARMA(1,1) on first differences, estimated per
    prefix with the Hannan–Rissanen two-stage regression: masked
    prefix-moment algebra broadcast over [S, groups, T].
  * The MA residual recursion is a loop over t on [S, groups] tensors,
    and the groups run in chunks, so memory stays O(S · chunk · T).

Numerics against the reference: the same formulas in the same order,
but log/exp/pow come from another libm than XLA's, XLA contracts some
multiply-adds into FMAs, and sums over T reduce in another order, so
floats agree to a stated tolerance (tests/test_torch_arima.py), not
bit for bit. The Box-Cox grid is JAX's own grid, bit for bit.
"""

from __future__ import annotations

import functools
from fractions import Fraction

import torch

from .masked import masked_count, masked_stddev_samp

MIN_POINTS = 4        # reference requires len > 3  (:232)
_RIDGE = 1e-6
_CLIP = 0.99


def boxcox_llf(lam: torch.Tensor, x: torch.Tensor,
               mask: torch.Tensor) -> torch.Tensor:
    """Profile log-likelihood of the Box-Cox parameter (scipy's
    boxcox_llf): llf = (λ−1)·Σ log x − n/2·log σ²(y_λ).

    `lam` broadcasts against x's leading axes (a scalar, or [G, 1] for
    a grid over [S, T] series); the result has the broadcast shape."""
    lam = torch.as_tensor(lam, dtype=x.dtype, device=x.device)[..., None]
    n = masked_count(mask).clamp_min(1)
    logx = torch.where(mask, torch.log(torch.where(mask, x, 1.0)), 0.0)
    small = lam.abs() < 1e-12
    y = torch.where(small, logx,
                    (torch.exp(lam * logx) - 1.0)
                    / torch.where(small, 1.0, lam))
    y = torch.where(mask, y, 0.0)
    mean = y.sum(dim=-1) / n
    var = torch.where(mask, (y - mean[..., None]) ** 2, 0.0).sum(dim=-1) / n
    return ((lam[..., 0] - 1.0) * logx.sum(dim=-1)
            - 0.5 * n * torch.log(var.clamp_min(1e-300)))


@functools.lru_cache(maxsize=8)
def _jax_linspace(lo: float, hi: float, num: int) -> tuple:
    """`jnp.linspace(lo, hi, num)` in float64, bit for bit, as XLA's
    CPU backend computes it: lo·(1 − i·(1/div)) + i·(hi/div) with the
    division folded into a reciprocal and the final add fused into
    one multiply-add (rounded once; done exactly here with rationals).
    torch.linspace differs from it in the last bit, which moves the
    argmax and the parabolic step of `boxcox_lambda`."""
    div = num - 1
    inv = 1.0 / div
    step_hi = hi * inv
    out = []
    for i in range(div):
        head = lo * (1.0 - i * inv)
        out.append(float(Fraction(i) * Fraction(step_hi) + Fraction(head)))
    return tuple(out) + (float(hi),)


def boxcox_lambda(x: torch.Tensor, mask: torch.Tensor,
                  lo: float = -2.0, hi: float = 2.0,
                  n_grid: int = 161) -> torch.Tensor:
    """MLE lambda per series via grid search + one parabolic refinement
    (scipy uses Brent on the same objective over (-2, 2))."""
    grid = torch.tensor(_jax_linspace(lo, hi, n_grid), dtype=x.dtype,
                        device=x.device)
    llf = boxcox_llf(grid[:, None], x, mask)                  # [G, S]
    idx = torch.argmax(llf, dim=0)
    step = (hi - lo) / (n_grid - 1)
    i = idx.clamp(1, n_grid - 2)
    f_m1 = llf.gather(0, (i - 1)[None, :])[0]
    f_0 = llf.gather(0, i[None, :])[0]
    f_p1 = llf.gather(0, (i + 1)[None, :])[0]
    denom = f_m1 - 2.0 * f_0 + f_p1
    shift = torch.where(denom.abs() > 1e-12,
                        0.5 * (f_m1 - f_p1) / denom, 0.0)
    shift = shift.clamp(-1.0, 1.0)
    lam = grid[i] + shift * step
    return torch.where(idx == i, lam, grid[idx])


def boxcox_transform(x: torch.Tensor, lam: torch.Tensor) -> torch.Tensor:
    lam = lam[..., None]
    safe = x.clamp_min(1e-300)
    small = lam.abs() < 1e-12
    return torch.where(small, torch.log(safe),
                       (torch.pow(safe, lam) - 1.0)
                       / torch.where(small, 1.0, lam))


def inv_boxcox(y: torch.Tensor, lam: torch.Tensor) -> torch.Tensor:
    lam = lam[..., None]
    small = lam.abs() < 1e-12
    return torch.where(small, torch.exp(y),
                       torch.pow((lam * y + 1.0).clamp_min(1e-300),
                                 1.0 / torch.where(small, 1.0, lam)))


def _shift1(a: torch.Tensor) -> torch.Tensor:
    """a delayed by one step along the last axis, zero first."""
    return torch.cat([torch.zeros_like(a[..., :1]), a[..., :-1]], dim=-1)


def _fit_prefix(d: torch.Tensor, w: torch.Tensor):
    """Hannan–Rissanen ARMA(1,1) fit on weighted (prefix-masked)
    difference series d [..., L] (w broadcasts against d); returns
    (phi, theta) of the broadcast leading shape.

    Stage 1: AR(1) OLS → provisional residuals.
    Stage 2: OLS of d_t on [d_{t-1}, resid_{t-1}] (2×2 normal equations).
    """
    d_lag = _shift1(d)
    w_pair = w * _shift1(w)
    # Stage 1
    a = ((w_pair * d * d_lag).sum(dim=-1)
         / ((w_pair * d_lag * d_lag).sum(dim=-1) + _RIDGE))
    eps1 = (d - a[..., None] * d_lag) * w_pair  # resid_0 := 0
    e_lag = _shift1(eps1)
    # Stage 2: X = [d_lag, e_lag], solve (XᵀWX + rI) β = XᵀW d
    s11 = (w_pair * d_lag * d_lag).sum(dim=-1) + _RIDGE
    s12 = (w_pair * d_lag * e_lag).sum(dim=-1)
    s22 = (w_pair * e_lag * e_lag).sum(dim=-1) + _RIDGE
    b1 = (w_pair * d_lag * d).sum(dim=-1)
    b2 = (w_pair * e_lag * d).sum(dim=-1)
    det = s11 * s22 - s12 * s12
    det = torch.where(det.abs() < 1e-30, 1e-30, det)
    phi = (s22 * b1 - s12 * b2) / det
    theta = (s11 * b2 - s12 * b1) / det
    return phi.clamp(-_CLIP, _CLIP), theta.clamp(-_CLIP, _CLIP)


def _group_preds(y0: torch.Tensor, d: torch.Tensor, gs: torch.Tensor,
                 k: int) -> torch.Tensor:
    """Forecasts [S, len(gs), k] of the refit groups `gs`: fit on the
    prefix available at each group's first step, then one CSS residual
    recursion eps_t = d_t − φ d_{t-1} − θ eps_{t-1} (eps_0 = 0) per
    group. eps_t for t < m−1 does not depend on the prefix cutoff, so
    step m reads eps[m−2]."""
    T = y0.shape[1]
    L = T - 1
    idx = torch.arange(L, device=d.device)
    m_fit = (gs * k).clamp_min(3)
    w = (idx[None, :] < (m_fit - 1)[:, None]).to(d.dtype)     # [C, L]
    phi, theta = _fit_prefix(d[:, None, :], w[None])            # [S, C]
    eps = torch.zeros(*phi.shape, L, dtype=d.dtype, device=d.device)
    eps_prev = torch.zeros_like(phi)
    for t in range(1, L):
        eps_prev = d[:, t, None] - phi * d[:, t - 1, None] \
            - theta * eps_prev
        eps[..., t] = eps_prev
    ms = gs[:, None] * k + torch.arange(k, device=d.device)     # [C, k]
    last = (ms - 2).clamp(0, T - 2)
    d_hat = (phi[..., None] * d[:, last]
             + theta[..., None] * eps.gather(
                 2, last[None].expand(eps.shape[0], -1, -1)))
    return y0[:, (ms - 1).clamp(0, T - 1)] + d_hat


def arima_walk_forward(y: torch.Tensor, mask: torch.Tensor,
                       refit_every: int = 1,
                       group_chunk: int = 512) -> torch.Tensor:
    """Walk-forward one-step forecasts for a padded [S, T] Box-Cox batch.

    pred[:, :3] = y[:, :3] (the reference's train prefix is passed
    through, :241-255); pred[:, m] for m ≥ 3 comes from a fit on a
    prefix of y.

    `refit_every=k` groups prefixes: the fit for steps [g·k, (g+1)·k)
    uses the prefix of length max(g·k, 3), and one CSS residual
    recursion per group serves all its steps — k=1 is the reference's
    exact refit-per-step semantics; k>1 trades refit freshness for a
    k× compute cut on long series. Groups evaluate in
    `group_chunk`-sized chunks, so peak memory is
    O(S · group_chunk · T) instead of O(S · T²).
    """
    S, T = y.shape
    k = refit_every
    y0 = torch.where(mask, y, 0.0)
    if T <= 3:
        return y0
    d = y0[:, 1:] - y0[:, :-1]                                  # [S, T-1]
    gs = torch.arange(-(-T // k), device=y.device)
    preds = torch.cat([_group_preds(y0, d, chunk, k).reshape(S, -1)
                       for chunk in gs.split(group_chunk)], dim=1)[:, :T]
    ms_all = torch.arange(T, device=y.device)
    return torch.where(ms_all < 3, y0, preds)


def arima_scores(x: torch.Tensor, mask: torch.Tensor, refit_every: int = 1):
    """Full ARIMA scoring: (pred levels [S,T], stddev [S], anomaly [S,T]).

    Series with ≤ 3 points or any non-positive value produce no anomalies
    and zero algoCalc, matching the reference's error paths (:232-234,
    :260-264: scipy.boxcox raises on x ≤ 0 → caught → None → [False]).
    `refit_every` (see arima_walk_forward) defaults to the reference's
    exact refit-per-step; long-series callers raise it."""
    n = masked_count(mask)
    positive = torch.where(mask, x > 0, True).all(dim=-1)
    ok = (n >= MIN_POINTS) & positive
    safe_x = torch.where(mask & (x > 0), x, 1.0)

    # Normalize each series by its geometric mean before the transform.
    # Raw throughputs are ~1e6-1e9; when the MLE lambda is negative,
    # x^λ underflows the mantissa and (λ·y + 1) cancels — fatally in
    # float32, noticeably even in float64. With x/gm ≈ 1 the transform
    # is well-conditioned in both dtypes; predictions are rescaled back
    # to levels afterwards. (The reference transforms raw values and
    # simply inherits the float64 cancellation.)
    log_gm = torch.where(mask, torch.log(safe_x), 0.0).sum(dim=-1) \
        / n.clamp_min(1)
    gm = torch.exp(log_gm)[..., None]
    xs = safe_x / gm

    lam = boxcox_lambda(xs, mask)
    y = boxcox_transform(xs, lam)
    # Auto-size the group chunk: each chunk materializes [S, chunk, T]
    # residual stacks — budgeted as in the reference, so peak memory
    # stays O(S · chunk · T).
    S, T = x.shape
    chunk = max(1, min(512, (256 << 20) // max(1, 4 * S * T)))
    preds_bc = arima_walk_forward(y, mask, refit_every=refit_every,
                                  group_chunk=chunk)
    preds = inv_boxcox(preds_bc, lam) * gm
    preds = torch.where(ok[..., None] & mask, preds, 0.0)

    std = masked_stddev_samp(x, mask)
    anomaly = ((x - preds).abs() > std[..., None]) & mask & ok[..., None]
    return preds, std, anomaly
