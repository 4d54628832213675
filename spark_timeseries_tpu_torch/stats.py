"""Statistical tests, batched (counterpart of
``spark_timeseries_tpu/stats.py``): ADF with the MacKinnon 1994
approximate p-value surface, KPSS (``"c"`` dense and ragged, ``"ct"``),
Durbin-Watson, Breusch-Godfrey, Ljung-Box and Breusch-Pagan.

Every test takes ``(..., n)`` tensors and returns batched statistics on
their device; the chi-squared and normal CDFs are
``torch.special.gammainc`` and ``torch.special.ndtr``.  The MacKinnon tau
tables and KPSS critical values are the published constants (MacKinnon
1994; Kwiatkowski et al. 1992), copied from the JAX package.
:func:`segment_plan` chooses the long-series tier's split geometry
(host arithmetic, a copy of the JAX package's).
"""

from __future__ import annotations

import functools
import math
from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from .ops.lag import lag_matrix, lag_stack
from .ops.linalg import ols, r_squared, t_statistics
from .ops.univariate import autocorr

# ---------------------------------------------------------------------------
# MacKinnon 1994 approximate asymptotic p-value surface for unit-root tests
# ("Approximate Asymptotic Distribution Functions for Unit-Root and
# Cointegration Tests", JBES 12.2), as tabulated in statsmodels adfvalues.py.
# Row index = n-1 (number of I(1) series); ADF uses row 0.
# ---------------------------------------------------------------------------

_ADF_REGRESSIONS = ("nc", "c", "ct", "ctt")

_ADF_TAU_STAR = {
    "nc": [-1.04, -1.53, -2.68, -3.09, -3.07, -3.77],
    "c": [-1.61, -2.62, -3.13, -3.47, -3.78, -3.93],
    "ct": [-2.89, -3.19, -3.50, -3.65, -3.80, -4.36],
    "ctt": [-3.21, -3.51, -3.81, -3.83, -4.12, -4.63],
}
_ADF_TAU_MIN = {
    "nc": [-19.04, -19.62, -21.21, -23.25, -21.63, -25.74],
    "c": [-18.83, -18.86, -23.48, -28.07, -25.96, -23.27],
    "ct": [-16.18, -21.15, -25.37, -26.63, -26.53, -26.18],
    "ctt": [-17.17, -21.1, -24.33, -24.03, -24.33, -28.22],
}
_ADF_TAU_MAX = {
    "nc": [np.inf, 1.51, 0.86, 0.88, 1.05, 1.24],
    "c": [2.74, 0.92, 0.55, 0.61, 0.79, 1.0],
    "ct": [0.7, 0.63, 0.71, 0.93, 1.19, 1.42],
    "ctt": [0.54, 0.79, 1.08, 1.43, 3.49, 1.92],
}
# small-p polynomials: ascending coefficients [b0, b1, b2]
_ADF_TAU_SMALLP = {
    "nc": [[0.6344, 1.2378, 3.2496e-2], [1.9129, 1.3857, 3.5322e-2],
           [2.7648, 1.4502, 3.4186e-2], [3.4336, 1.4835, 3.19e-2],
           [4.0999, 1.5533, 3.59e-2], [4.5388, 1.5344, 2.9807e-2]],
    "c": [[2.1659, 1.4412, 3.8269e-2], [2.92, 1.5012, 3.9796e-2],
          [3.4699, 1.4856, 3.164e-2], [3.9673, 1.4777, 2.6315e-2],
          [4.5509, 1.5338, 2.9545e-2], [5.1399, 1.6036, 3.4445e-2]],
    "ct": [[3.2512, 1.6047, 4.9588e-2], [3.6646, 1.5419, 3.6448e-2],
           [4.0983, 1.5173, 2.9898e-2], [4.5844, 1.5338, 2.8796e-2],
           [5.0722, 1.5634, 2.9472e-2], [5.53, 1.5914, 3.0392e-2]],
    "ctt": [[4.0003, 1.658, 4.8288e-2], [4.3534, 1.6016, 3.7947e-2],
            [4.7343, 1.5768, 3.2396e-2], [5.214, 1.6077, 3.3449e-2],
            [5.6481, 1.6274, 3.3455e-2], [5.9296, 1.5929, 2.8223e-2]],
}
# large-p polynomials: ascending [b0, b1*1e-1, b2*1e-1, b3*1e-2]
_ADF_LARGE_SCALING = np.array([1.0, 1e-1, 1e-1, 1e-2])
_ADF_TAU_LARGEP = {
    "nc": [[0.4797, 9.3557, -0.6999, 3.3066], [1.5578, 8.558, -2.083, -3.3549],
           [2.2268, 6.8093, -3.2362, -5.4448], [2.7654, 6.4502, -3.0811, -4.4946],
           [3.2684, 6.8051, -2.6778, -3.4972], [3.7268, 7.167, -2.3648, -2.8288]],
    "c": [[1.7339, 9.3202, -1.2745, -1.0368], [2.1945, 6.4695, -2.9198, -4.2377],
          [2.5893, 4.5168, -3.6529, -5.0074], [3.0387, 4.5452, -3.3666, -4.1921],
          [3.5049, 5.2098, -2.9158, -3.3468], [3.9489, 5.8933, -2.5359, -2.721]],
    "ct": [[2.5261, 6.1654, -3.7956, -6.0285], [2.85, 5.272, -3.6622, -5.1695],
           [3.221, 5.255, -3.2685, -4.1501], [3.652, 5.9758, -2.7483, -3.2081],
           [4.0712, 6.6428, -2.3464, -2.546], [4.4735, 7.1757, -2.0681, -2.1196]],
    "ctt": [[3.0778, 4.9529, -4.1477, -5.9359], [3.4713, 5.967, -3.2507, -4.2286],
            [3.8637, 6.7852, -2.6286, -3.1381], [4.2736, 7.6199, -2.1534, -2.4026],
            [4.6679, 8.2618, -1.822, -1.9147], [5.0009, 8.3735, -1.6994, -1.6928]],
}

# KPSS critical-value tables (Kwiatkowski, Phillips, Schmidt & Shin 1992,
# Journal of Econometrics; ref ``TimeSeriesStatisticalTests.scala:331-351``).
KPSS_CONSTANT_CRITICAL_VALUES: Dict[float, float] = {
    0.10: 0.347, 0.05: 0.463, 0.025: 0.574, 0.01: 0.739}
KPSS_CONSTANT_AND_TREND_CRITICAL_VALUES: Dict[float, float] = {
    0.10: 0.119, 0.05: 0.146, 0.025: 0.176, 0.01: 0.216}


def _polyval_ascending(coefs: np.ndarray, x: torch.Tensor) -> torch.Tensor:
    out = torch.zeros_like(x)
    for c in coefs[::-1]:
        out = out * x + float(c)
    return out


def mackinnonp(test_stat, regression: str = "c", n: int = 1
               ) -> torch.Tensor:
    """MacKinnon 1994 approximate p-value, batched over ``test_stat``."""
    i = n - 1
    stat = torch.as_tensor(test_stat)
    if not stat.dtype.is_floating_point:
        stat = stat.to(torch.get_default_dtype())
    small = _polyval_ascending(np.array(_ADF_TAU_SMALLP[regression][i]),
                               stat)
    large = _polyval_ascending(
        np.array(_ADF_TAU_LARGEP[regression][i]) * _ADF_LARGE_SCALING, stat)
    poly = torch.where(stat <= _ADF_TAU_STAR[regression][i], small, large)
    p = torch.special.ndtr(poly)
    p = torch.where(stat > _ADF_TAU_MAX[regression][i],
                    torch.ones_like(p), p)
    return torch.where(stat < _ADF_TAU_MIN[regression][i],
                       torch.zeros_like(p), p)


@functools.lru_cache(maxsize=64)
def _trend_columns_np(n_obs: int, regression: str) -> np.ndarray:
    order = {"nc": -1, "c": 0, "ct": 1, "ctt": 2}[regression]
    t = np.arange(1, n_obs + 1, dtype=np.float64)
    cols = [t ** k for k in range(order + 1)]
    if not cols:
        return np.zeros((n_obs, 0))
    return np.stack(cols, axis=1)


def _trend_columns(n_obs: int, regression: str, dtype,
                   device=None) -> torch.Tensor:
    """Deterministic trend regressors ``[1, t, t²][:order + 1]``,
    ``t = 1..n`` (the numpy design cached per length and regression)."""
    return torch.as_tensor(_trend_columns_np(n_obs, regression),
                           dtype=dtype, device=device)


def _chi2_sf(stat: torch.Tensor, df: int) -> torch.Tensor:
    """``1 - chi2.cdf(stat, df)``, the JAX package's form of the upper
    tail (``chi2.cdf(x, k)`` is the regularized ``gammainc(k/2, x/2)``)."""
    half = torch.full_like(stat, df / 2.0)
    cdf = torch.special.gammainc(half, torch.clamp(stat, min=0.0) / 2.0)
    return 1.0 - cdf


def adftest(ts: torch.Tensor, max_lag: int,
            regression: str = "c") -> Tuple[torch.Tensor, torch.Tensor]:
    """Augmented Dickey-Fuller unit-root test, batched: regresses
    ``Δy_t`` on ``[y_{t-1}, Δy_{t-1}, ..., Δy_{t-max_lag}, trend]`` with
    no intercept beyond the trend columns; the statistic is the t
    statistic of the ``y_{t-1}`` coefficient, the p-value
    :func:`mackinnonp`'s.  Returns ``(stat, p_value)``, each
    ``ts.shape[:-1]``."""
    if regression not in _ADF_REGRESSIONS:
        raise ValueError(f"regression must be one of {_ADF_REGRESSIONS}")
    n = ts.shape[-1]
    diff = ts[..., 1:] - ts[..., :-1]                       # (..., n-1)
    lm = lag_matrix(diff, max_lag, include_original=True)
    n_obs = n - 1 - max_lag
    # column 0 (the lag-0 difference) gives way to the lagged level
    levels = ts[..., n - n_obs - 1:n - 1]
    X = torch.cat([levels[..., None], lm[..., 1:]], dim=-1)
    trend = _trend_columns(n_obs, regression, ts.dtype, ts.device)
    trend = trend.expand(*X.shape[:-1], trend.shape[-1])
    X = torch.cat([X, trend], dim=-1)
    y = diff[..., -n_obs:]
    stat = t_statistics(ols(X, y, add_intercept=False))[..., 0]
    return stat, mackinnonp(stat, regression, 1)


def dwtest(residuals: torch.Tensor) -> torch.Tensor:
    """Durbin-Watson serial-correlation statistic, batched."""
    r = residuals
    diffs = r[..., 1:] - r[..., :-1]
    return (diffs * diffs).sum(dim=-1) / (r * r).sum(dim=-1)


def bgtest(residuals: torch.Tensor, factors: torch.Tensor,
           max_lag: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Breusch-Godfrey serial-correlation test, batched: the auxiliary
    regression (with intercept) of the residuals on ``[factors ‖ lagged
    residuals]``; statistic ``n_obs · R²`` ~ χ²(max_lag).
    ``residuals (..., n)``, ``factors (..., n, k)``."""
    u = residuals
    lag_u = lag_matrix(u, max_lag)                   # (..., n - max_lag, L)
    n_obs = u.shape[-1] - max_lag
    X = factors.expand(*u.shape[:-1], *factors.shape[-2:])
    aux_X = torch.cat([X[..., max_lag:, :], lag_u], dim=-1)
    aux_y = u[..., max_lag:]
    stat = n_obs * r_squared(ols(aux_X, aux_y, add_intercept=True), aux_y)
    return stat, _chi2_sf(stat, max_lag)


def lbtest(residuals: torch.Tensor,
           max_lag: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Ljung-Box test on the residual autocorrelations, batched."""
    r = residuals
    n = r.shape[-1]
    ac = autocorr(r, max_lag)                        # (..., max_lag)
    divisors = torch.tensor([n - k - 1 for k in range(max_lag)],
                            dtype=r.dtype, device=r.device)
    stat = n * (n + 2) * (ac * ac / divisors).sum(dim=-1)
    return stat, _chi2_sf(stat, max_lag)


def bptest(residuals: torch.Tensor,
           factors: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Breusch-Pagan heteroskedasticity test, batched: the auxiliary
    regression (with intercept) of the squared residuals on the factors;
    statistic ``n · R²`` ~ χ²(k)."""
    u2 = residuals * residuals
    X = factors.expand(*u2.shape[:-1], *factors.shape[-2:])
    stat = residuals.shape[-1] * r_squared(ols(X, u2, add_intercept=True),
                                           u2)
    return stat, _chi2_sf(stat, factors.shape[-1])



def _newey_west_variance(errors: torch.Tensor, lag: int,
                         n_eff=None) -> torch.Tensor:
    """Newey-West long-run variance with Bartlett weights, batched
    (ref ``TimeSeriesStatisticalTests.scala:405-431``): all ``lag``
    autocovariances from one stacked contraction.  ``n_eff (...)``
    replaces the denominator for ragged lanes whose errors are zero
    beyond their valid window."""
    e = errors
    n = e.shape[-1] if n_eff is None else n_eff
    var0 = (e * e).sum(dim=-1) / n
    if lag == 0:
        return var0
    # row i of the stack is [0]*i ++ e[:n-i], so row_i · e = Σ_t e[t-i]e[t]
    ep = torch.cat([e.new_zeros((*e.shape[:-1], lag)), e], dim=-1)
    covs = torch.einsum("...ln,...n->...l", lag_stack(ep, lag), e)
    w = 1.0 - torch.arange(1, lag + 1, dtype=e.dtype,
                           device=e.device) / (lag + 1.0)
    return 2.0 * (covs * w).sum(dim=-1) / n + var0


def kpsstest(ts: torch.Tensor, method: str = "c",
             n_valid: Optional[torch.Tensor] = None
             ) -> Tuple[torch.Tensor, Dict[float, float]]:
    """KPSS stationarity test, batched over leading dims
    (ref ``TimeSeriesStatisticalTests.scala:369-394``; R tseries
    semantics, with the Newey-West lag ``int(3·sqrt(n)/13)``).

    Returns ``(stat, critical_values)``: ``stat`` has shape
    ``ts.shape[:-1]``, the critical values are the method's KPSS table.
    ``n_valid (...)`` restricts each lane to its left-aligned valid
    window (the demeaning, partial sums, long-run variance and ``n²``
    normalization see the window length; the Newey-West lag stays the
    panel-level one, as in the JAX package)."""
    if method not in ("c", "ct"):
        raise ValueError("method must be 'c' or 'ct'")
    n = ts.shape[-1]
    lag = int(3 * math.sqrt(n) / 13)
    if n_valid is not None:
        if method != "c":
            raise ValueError("n_valid supports method 'c' only")
        nv = n_valid.to(ts.dtype)
        w = (torch.arange(n, device=ts.device) < nv[..., None]).to(ts.dtype)
        mean = (ts * w).sum(dim=-1, keepdim=True) \
            / torch.clamp(nv[..., None], min=1.0)
        resid = (ts - mean) * w
        s2 = (torch.cumsum(resid, dim=-1) ** 2 * w).sum(dim=-1)
        long_run_var = _newey_west_variance(resid, lag,
                                            n_eff=torch.clamp(nv, min=1.0))
        stat = (s2 / long_run_var) / torch.clamp(nv * nv, min=1.0)
        return stat, KPSS_CONSTANT_CRITICAL_VALUES
    if method == "c":
        resid = ts - ts.mean(dim=-1, keepdim=True)
        critical_values = KPSS_CONSTANT_CRITICAL_VALUES
    else:
        X = _trend_columns(n, "ct", ts.dtype, ts.device)
        X = X.expand(*ts.shape[:-1], *X.shape)
        resid = ols(X, ts, add_intercept=False).residuals
        critical_values = KPSS_CONSTANT_AND_TREND_CRITICAL_VALUES
    s2 = (torch.cumsum(resid, dim=-1) ** 2).sum(dim=-1)
    long_run_var = _newey_west_variance(resid, lag)
    stat = (s2 / long_run_var) / (n * n)
    return stat, critical_values


# ---------------------------------------------------------------------------
# DARIMA segmentation heuristics (the longseries tier; PAPERS.md
# "Distributed ARIMA Models for Ultra-long Time Series")
# ---------------------------------------------------------------------------

class SegmentPlan(NamedTuple):
    """One ultra-long series' split geometry (``longseries.split``).

    ``n_segments`` contiguous windows of ``window`` observations each
    (``window = seg_len + overlap``: every window extends ``overlap``
    observations left of its own ``seg_len`` stride for burn-in context);
    windows tile the **tail** of the series, so ``head_drop`` leading
    observations are excluded from estimation — the most recent data
    always participates, mirroring ``arima.fit_long``.  ``n_used`` counts
    the distinct observations covered (``n_segments·seg_len + overlap``).
    """
    n_segments: int
    seg_len: int
    overlap: int
    window: int
    n_used: int
    head_drop: int


def segment_plan(n_obs: int, p: int = 2, q: int = 2, *,
                 seg_len: int | None = None, overlap: int = 0,
                 min_seg_len: int | None = None,
                 max_segments: int = 4096) -> SegmentPlan:
    """Choose the DARIMA split geometry for an ``n_obs``-long series.

    The divide-and-conquer tradeoff (the paper's tuning discussion): each
    segment's CSS estimate carries O(1/seg_len) conditioning bias from
    its zero-initialized MA ring, while the combined estimator's variance
    shrinks with the segment count — balancing the two puts ``seg_len``
    near ``sqrt(n)`` up to a constant.  The default takes the power of
    two nearest ``8·sqrt(n)`` (powers of two keep every segment panel on
    one engine bucket), clamped to

    - at least ``min_seg_len`` (default: four Hannan-Rissanen floors for
      the order, ``4·(2·max(p,q) + 2 + p + q + 1)``, and never < 64), so
      each segment supports a reliable fit, and
    - at most ``n_obs // 2`` (two segments minimum — fewer means the
      split buys nothing; callers should use ``arima.fit`` directly).

    ``max_segments`` caps the panel height (more segments then simply
    get a longer ``seg_len``).  Raises when ``n_obs`` cannot hold two
    minimum-length segments.
    """
    n_obs = int(n_obs)
    overlap = max(0, int(overlap))
    mx = max(int(p), int(q))
    hr_floor = 2 * mx + 2 + int(p) + int(q) + 1
    floor = max(64, 4 * hr_floor, overlap + 1) if min_seg_len is None \
        else max(int(min_seg_len), overlap + 1)
    if n_obs < 2 * floor + overlap:
        raise ValueError(
            f"series too short to segment: {n_obs} obs cannot hold two "
            f"segments of >= {floor} (overlap={overlap}); call "
            f"arima.fit directly")
    if seg_len is None:
        target = 8.0 * float(np.sqrt(n_obs))
        seg_len = 1 << max(0, int(round(np.log2(max(target, 1.0)))))
        seg_len = max(floor, min(seg_len, n_obs // 2))
        # respect the panel-height cap: grow seg_len until it fits
        while (n_obs - overlap) // seg_len > int(max_segments):
            seg_len *= 2
    else:
        seg_len = int(seg_len)
        if seg_len < floor:
            raise ValueError(
                f"seg_len={seg_len} is below the reliability floor "
                f"{floor} for order (p={p}, q={q}, overlap={overlap}); "
                f"raise seg_len or pass min_seg_len explicitly")
    n_segments = (n_obs - overlap) // seg_len
    if n_segments < 2:
        raise ValueError(
            f"seg_len={seg_len} leaves {n_segments} segment(s) of "
            f"{n_obs} obs (overlap={overlap}); shrink seg_len or call "
            f"arima.fit directly")
    n_used = n_segments * seg_len + overlap
    return SegmentPlan(n_segments=int(n_segments), seg_len=int(seg_len),
                       overlap=overlap, window=int(seg_len + overlap),
                       n_used=int(n_used),
                       head_drop=int(n_obs - n_used))
