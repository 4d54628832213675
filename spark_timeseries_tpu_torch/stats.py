"""Statistical tests, batched (counterpart of the KPSS part of
``spark_timeseries_tpu/stats.py``).

Ported so far: the KPSS level-stationarity test (``method="c"``, dense
and ragged) with its Newey-West long-run variance, which the batched
auto-ARIMA's d-selection runs over the whole panel.  The trend form
``"ct"`` needs the OLS of ``ops/linalg.ols``, not ported yet, and raises.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch

from .ops.lag import lag_stack

# KPSS critical-value tables (Kwiatkowski, Phillips, Schmidt & Shin 1992,
# Journal of Econometrics; ref ``TimeSeriesStatisticalTests.scala:331-351``).
KPSS_CONSTANT_CRITICAL_VALUES: Dict[float, float] = {
    0.10: 0.347, 0.05: 0.463, 0.025: 0.574, 0.01: 0.739}
KPSS_CONSTANT_AND_TREND_CRITICAL_VALUES: Dict[float, float] = {
    0.10: 0.119, 0.05: 0.146, 0.025: 0.176, 0.01: 0.216}


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
    if method == "ct":
        raise NotImplementedError(
            "kpsstest method 'ct' needs ops.linalg.ols (the trend OLS), "
            "which is not ported yet")
    resid = ts - ts.mean(dim=-1, keepdim=True)
    s2 = (torch.cumsum(resid, dim=-1) ** 2).sum(dim=-1)
    long_run_var = _newey_west_variance(resid, lag)
    stat = (s2 / long_run_var) / (n * n)
    return stat, KPSS_CONSTANT_CRITICAL_VALUES
