"""ARX: autoregression with exogenous regressors, batched (counterpart of
``spark_timeseries_tpu/models/autoregression_x.py``): OLS on ``[lagged y
‖ lagged X ‖ current X]`` in the reference's column order, through the
batched Householder QR of ``ops.linalg.ols``; the fail-soft
:func:`fit_resilient` (OLS -> intercept-only mean).  ARIMAX's
initialization."""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from .._device import as_tensor, resolve_device
from ..ops.lag import lag_matrix, lag_matrix_multi
from ..ops.linalg import ols
from ..utils import resilience as _resilience
from .base import FitDiagnostics


def _empty_cols(x: torch.Tensor, rows: int) -> torch.Tensor:
    return x.new_zeros((*x.shape[:-1], rows, 0))


def assemble_predictors(y: torch.Tensor, x: torch.Tensor, y_max_lag: int,
                        x_max_lag: int,
                        include_original_x: bool = True) -> torch.Tensor:
    """Design matrix ``(..., n - maxLag, cols)``: AR lags of y, per-column
    lags of x, then current x.  A shared unbatched ``x (n, k)``
    broadcasts over y's batch dims (and a batched x over an unbatched
    y)."""
    n = y.shape[-1]
    max_lag = max(y_max_lag, x_max_lag)
    rows = n - max_lag
    batch = torch.broadcast_shapes(y.shape[:-1], x.shape[:-2])
    y = y.expand(*batch, n)
    x = x.expand(*batch, *x.shape[-2:])
    if y_max_lag > 0:
        ar_y = lag_matrix(y, y_max_lag)[..., max_lag - y_max_lag:, :]
    else:
        ar_y = _empty_cols(y, rows)
    if x_max_lag > 0:
        lagged_x = lag_matrix_multi(x, x_max_lag)[..., max_lag - x_max_lag:,
                                                  :]
    else:
        lagged_x = _empty_cols(y, rows)
    parts = [ar_y, lagged_x]
    if include_original_x:
        parts.append(x[..., max_lag:, :])
    return torch.cat(parts, dim=-1)


class ARXModel(NamedTuple):
    """Coefficients in the reference's order: y lags ascending, then each
    x column's lags ascending, then the non-lagged x columns."""
    c: torch.Tensor
    coefficients: torch.Tensor
    y_max_lag: int
    x_max_lag: int
    includes_original_x: bool
    diagnostics: Optional[FitDiagnostics] = None

    def predict(self, y, x) -> torch.Tensor:
        """In-sample predictions ``(..., n - maxLag)``: one batched matvec
        of the design."""
        coefs = self.coefficients
        y = torch.as_tensor(y, dtype=coefs.dtype, device=coefs.device)
        x = torch.as_tensor(x, dtype=coefs.dtype, device=coefs.device)
        predictors = assemble_predictors(y, x, self.y_max_lag,
                                         self.x_max_lag,
                                         self.includes_original_x)
        out = torch.einsum("...nk,...k->...n", predictors, coefs)
        c = self.c
        return out + (c[..., None] if c.ndim else c)


def fit(y, x, y_max_lag: int, x_max_lag: int,
        include_original_x: bool = True, no_intercept: bool = False,
        device=None) -> ARXModel:
    """OLS fit on ``device`` (``None`` means CUDA): ``y (..., n)``, ``x
    (..., n, k)`` or a shared ``(n, k)``; leading dims batch through one
    QR solve."""
    dev = resolve_device(device)
    y = as_tensor(y, dev)
    x = torch.as_tensor(x, dtype=y.dtype, device=dev)
    max_lag = max(y_max_lag, x_max_lag)
    trim_y = y[..., max_lag:]
    predictors = assemble_predictors(y, x, y_max_lag, x_max_lag,
                                     include_original_x)
    res = ols(predictors, trim_y, add_intercept=not no_intercept)
    if no_intercept:
        c = y.new_zeros(res.beta.shape[:-1])
        coeffs = res.beta
    else:
        c, coeffs = res.beta[..., 0], res.beta[..., 1:]
    ok = torch.isfinite(res.beta).all(dim=-1)
    nan = torch.full((), float("nan"), dtype=y.dtype, device=dev)
    diag = FitDiagnostics(ok, torch.zeros(ok.shape, dtype=torch.int32,
                                          device=dev),
                          torch.where(ok, torch.zeros_like(nan), nan))
    return ARXModel(c, coeffs, y_max_lag, x_max_lag, include_original_x,
                    diagnostics=diag)


def _n_arx_coefs(k: int, y_max_lag: int, x_max_lag: int,
                 include_original_x: bool) -> int:
    return y_max_lag + k * x_max_lag + (k if include_original_x else 0)


def _mean_model(v: torch.Tensor, k: int, y_max_lag: int, x_max_lag: int,
                include_original_x: bool) -> ARXModel:
    """Terminal fallback: intercept only (every AR and exogenous
    coefficient zero), the NaN-ignoring mean of each lane."""
    c = torch.nanmean(v, dim=-1)
    ok = torch.isfinite(c)
    width = _n_arx_coefs(k, y_max_lag, x_max_lag, include_original_x)
    nan = torch.full((), float("nan"), dtype=v.dtype, device=v.device)
    return ARXModel(c, v.new_zeros((*v.shape[:-1], width)), y_max_lag,
                    x_max_lag, include_original_x,
                    diagnostics=FitDiagnostics(
                        ok, torch.zeros(ok.shape, dtype=torch.int32,
                                        device=v.device),
                        torch.where(ok, torch.zeros_like(nan), nan)))


def fit_resilient(y, x, y_max_lag: int, x_max_lag: int,
                  include_original_x: bool = True,
                  no_intercept: bool = False,
                  retry: Optional[_resilience.RetryPolicy] = None,
                  device=None):
    """Fail-soft batched ARX on ``device`` (``None`` means CUDA): OLS ->
    intercept-only mean model.  ``y (n_series, n)``; ``x`` must be a
    shared unbatched ``(n, k)`` design (a per-series design cannot be
    gathered alongside the panel).  The OLS is direct, so ``retry`` is
    taken for a uniform interface and unused.  Returns ``(model,
    FitOutcome)``."""
    del retry
    dev = resolve_device(device)
    values = as_tensor(y, dev)
    x = torch.as_tensor(x, dtype=values.dtype, device=dev)
    if x.ndim != 2:
        raise ValueError(
            "fit_resilient needs a shared unbatched (n, k) design; got "
            f"xreg shape {tuple(x.shape)}")
    k = x.shape[-1]
    chain = [
        ("ols", lambda v: fit(v, x, y_max_lag, x_max_lag,
                              include_original_x, no_intercept,
                              device=dev)),
        ("mean", lambda v: _mean_model(v, k, y_max_lag, x_max_lag,
                                       include_original_x)),
    ]
    min_len = max(y_max_lag, x_max_lag) \
        + _n_arx_coefs(k, y_max_lag, x_max_lag, include_original_x) + 2
    return _resilience.resilient_fit(values, chain, min_len=min_len,
                                     family="arx")
