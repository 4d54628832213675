"""Autoregressive AR(p) models, batched (counterpart of
``spark_timeseries_tpu/models/autoregression.py``): OLS on the lag stack,
optional intercept.  The ARIMA AR fast path and the first stage of the
Hannan-Rissanen initialization."""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..ops.lag import lag_stack
from ..ops.linalg import ols_gram
from ..ops.ragged import step_weights
from .base import FitDiagnostics


class ARModel(NamedTuple):
    """AR(p) parameters; ``c`` scalar or ``(batch,)``, ``coefficients``
    ``(p,)`` or ``(batch, p)`` in increasing lag order.
    ``diagnostics.converged`` marks lanes whose OLS solve came back
    finite (``n_iter`` is 0, ``fun`` a 0/NaN flag)."""
    c: torch.Tensor
    coefficients: torch.Tensor
    diagnostics: Optional[FitDiagnostics] = None

    @property
    def order(self) -> int:
        return self.coefficients.shape[-1]

    @property
    def n_params(self) -> int:
        """Intercept slot + AR lags (the slot counts even for
        ``no_intercept`` fits, as in the JAX package)."""
        return self.order + 1


def fit(ts: torch.Tensor, max_lag: int = 1, no_intercept: bool = False,
        n_valid: Optional[torch.Tensor] = None) -> ARModel:
    """Fit AR(max_lag) by OLS on the lag matrix; ``ts (..., n)``, all
    leading dims batched.  ``n_valid (...,)`` restricts each lane to its
    left-aligned valid window (rows whose target index falls at or past
    it get weight 0 — exactly the OLS of the trimmed series)."""
    y = ts[..., max_lag:]
    X = lag_stack(ts, max_lag)
    w = None
    if n_valid is not None:
        w = step_weights(y.shape[-1], n_valid[..., None], offset=max_lag,
                         dtype=ts.dtype)
    res = ols_gram(X, y, add_intercept=not no_intercept, row_weights=w)
    if no_intercept:
        c = ts.new_zeros(ts.shape[:-1])
        coefs = res.beta
    else:
        c, coefs = res.beta[..., 0], res.beta[..., 1:]
    ok = torch.isfinite(res.beta).all(dim=-1)
    nan = torch.full((), float("nan"), dtype=ts.dtype, device=ts.device)
    diag = FitDiagnostics(ok, torch.zeros(ok.shape, dtype=torch.int32,
                                          device=ts.device),
                          torch.where(ok, torch.zeros_like(nan), nan))
    return ARModel(c, coefs, diagnostics=diag)
