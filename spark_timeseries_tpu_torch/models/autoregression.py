"""Autoregressive AR(p) models, batched (counterpart of
``spark_timeseries_tpu/models/autoregression.py``): OLS on the lag stack,
optional intercept, the time-dependent effects, sampling, and the
fail-soft :func:`fit_resilient` (OLS -> intercept-only mean).  The ARIMA
AR fast path and the first stage of the Hannan-Rissanen
initialization."""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from .._device import as_tensor, resolve_device
from ..ops.lag import lag_matvec, lag_stack
from ..ops.linalg import ols_gram
from ..ops.ragged import step_weights
from ..utils import resilience as _resilience
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

    def remove_time_dependent_effects(self, ts) -> torch.Tensor:
        """``out[i] = ts[i] - c - Σ_j coef_j · ts[i-j-1]``, out-of-range
        terms dropped (a zero-padded lag product)."""
        ts = torch.as_tensor(ts, dtype=self.coefficients.dtype,
                             device=self.coefficients.device)
        c = self.c
        p = self.coefficients.shape[-1]
        padded = torch.cat([ts.new_zeros((*ts.shape[:-1], p)), ts], dim=-1)
        ar_part = lag_matvec(padded, self.coefficients, p)
        return ts - (c[..., None] if c.ndim else c) - ar_part

    def add_time_dependent_effects(self, ts) -> torch.Tensor:
        """``out[i] = c + ts[i] + Σ_j coef_j · out[i-j-1]``: an order-p
        recurrence on the output, step by step over the lane batch."""
        ts = torch.as_tensor(ts, dtype=self.coefficients.dtype,
                             device=self.coefficients.device)
        coefs = self.coefficients
        p = coefs.shape[-1]
        c = self.c
        batch = torch.broadcast_shapes(ts.shape[:-1], c.shape,
                                       coefs.shape[:-1])
        carry = ts.new_zeros((*batch, p))
        outs = []
        for t in range(ts.shape[-1]):
            d = c + ts[..., t] + (coefs * carry).sum(dim=-1)
            carry = torch.cat([d[..., None], carry[..., :-1]], dim=-1)
            outs.append(d)
        return torch.stack(outs, dim=-1)

    def sample(self, n: int, generator: Optional[torch.Generator] = None,
               shape=()) -> torch.Tensor:
        """Gaussian innovations ``(*shape, n)`` from ``generator`` (on its
        device, then moved to the model's) pushed through the model."""
        gen_dev = generator.device if generator is not None \
            else self.coefficients.device
        noise = torch.randn((*shape, n), generator=generator,
                            dtype=self.coefficients.dtype, device=gen_dev)
        return self.add_time_dependent_effects(noise)


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


def fit_panel(panel, max_lag: int = 1, no_intercept: bool = False) -> ARModel:
    """Batched fit of a Panel's values on its device."""
    return fit(panel.values, max_lag, no_intercept)


def _mean_model(v: torch.Tensor, max_lag: int) -> ARModel:
    """Terminal fallback: intercept only (every AR coefficient zero), the
    NaN-ignoring mean of each lane."""
    c = torch.nanmean(v, dim=-1)
    ok = torch.isfinite(c)
    nan = torch.full((), float("nan"), dtype=v.dtype, device=v.device)
    return ARModel(c, v.new_zeros((*v.shape[:-1], max_lag)),
                   diagnostics=FitDiagnostics(
                       ok, torch.zeros(ok.shape, dtype=torch.int32,
                                       device=v.device),
                       torch.where(ok, torch.zeros_like(nan), nan)))


def fit_resilient(ts, max_lag: int = 1, no_intercept: bool = False,
                  retry: Optional[_resilience.RetryPolicy] = None,
                  device=None):
    """Fail-soft batched AR(p) on ``device`` (``None`` means CUDA): OLS ->
    intercept-only mean model.  The OLS is direct, so ``retry`` is taken
    for a uniform interface and unused.  ``ts (n_series, n)``; returns
    ``(model, FitOutcome)``."""
    del retry
    values = as_tensor(ts, resolve_device(device))
    chain = [
        ("ols", lambda v: fit(v, max_lag, no_intercept)),
        ("mean", lambda v: _mean_model(v, max_lag)),
    ]
    return _resilience.resilient_fit(values, chain, min_len=2 * max_lag + 2,
                                     family="ar")
