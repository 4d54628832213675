"""ARIMAX(p, d, q): ARIMA with exogenous regressors, batched (counterpart
of ``spark_timeseries_tpu/models/arimax.py``).

``Y_t = beta·X_t + ARIMA``, with per-column exogenous lags up to
``xreg_max_lag`` (and optionally the current values).  The fit starts
from an ARX OLS on the raw series with the order-d differenced
regressors and Hannan-Rissanen MA estimates, then refines the ARMA
slice ``[c?, φ, θ]`` by CSS on the xreg-adjusted differenced series
``diff_d(y) - bx·X_terms``, the exogenous coefficients frozen at their
ARX values.  That refine is arima's CSS residual on another series, so
it runs on arima's kernels: ``method="css-lm"`` is one launch of the
LM-fit kernel (``ops.arma_ne.fit_css_lm``) per fit on the card,
``"css-cgd"`` the batched BFGS over ``arma_ne``, ``"css-bobyqa"`` the
projected gradient over it.

Coefficients: slot 0 the intercept (zero when fit without one; the slot
stays), then AR, MA, then each exogenous column's lags in increasing
order, then the non-lagged columns.  The JAX package's deviations from
the reference (the full exogenous dot product, columns differenced
independently, the refine on the adjusted series) are kept.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from .._device import as_tensor, resolve_device
from ..ops.arma_ne import (check_kernel_order, css_neg_ll_value_and_grad,
                           fit_css_lm)
from ..ops.optimize import (MinimizeResult, _solve_with_policy,
                            minimize_bfgs, minimize_box)
from ..ops.univariate import differences_of_order_d
from ..utils import resilience as _resilience
from . import autoregression_x
from .arima import (LM_MAX_ITER, _add_effects, _difference_rows,
                    _log_likelihood_css_arma, _one_step_errors,
                    _remove_effects, hannan_rissanen_init)
from .base import FitDiagnostics, diagnostics_from, normal_quantile


def _assemble_xreg_terms(dx: torch.Tensor, xreg_max_lag: int,
                         include_original: bool) -> torch.Tensor:
    """``[per-column lags ascending ‖ current columns]`` rows over a
    differenced window, lags that reach before the window start zero:
    ``dx (..., r, k)`` -> ``(..., r, n_xreg_coefs)``."""
    k = dx.shape[-1]
    lags = []
    for lag in range(1, xreg_max_lag + 1):
        head = dx.new_zeros((*dx.shape[:-2], min(lag, dx.shape[-2]), k))
        lags.append(torch.cat([head, dx[..., :-lag, :]], dim=-2)
                    [..., :dx.shape[-2], :])
    parts = [lag_arr[..., col] for col in range(k) for lag_arr in lags]
    if include_original:
        parts += [dx[..., col] for col in range(k)]
    if not parts:
        return dx.new_zeros((*dx.shape[:-1], 0))
    return torch.stack(parts, dim=-1)


def _difference_columns(xreg: torch.Tensor, d: int) -> torch.Tensor:
    """Size-preserving order-d differencing of each column of ``(..., r,
    k)``."""
    return differences_of_order_d(xreg.transpose(-1, -2), d) \
        .transpose(-1, -2)


class ARIMAXModel(NamedTuple):
    """ARIMAX(p, d, q) with ``xreg_max_lag`` exogenous lags per column;
    ``coefficients`` may carry a leading batch dim."""
    p: int
    d: int
    q: int
    xreg_max_lag: int
    coefficients: torch.Tensor
    include_original_xreg: bool = True
    has_intercept: bool = True
    diagnostics: Optional[FitDiagnostics] = None

    @property
    def _n_arma(self) -> int:
        return 1 + self.p + self.q

    @property
    def arma_coefficients(self) -> torch.Tensor:
        """``[c, AR..., MA...]``: the slice the CSS likelihood sees."""
        return self.coefficients[..., :self._n_arma]

    @property
    def xreg_coefficients(self) -> torch.Tensor:
        return self.coefficients[..., self._n_arma:]

    def _like(self, x) -> torch.Tensor:
        return torch.as_tensor(x, dtype=self.coefficients.dtype,
                               device=self.coefficients.device)

    # -- likelihood (pure ARMA) ---------------------------------------------

    def log_likelihood_css_arma(self, diffed) -> torch.Tensor:
        """CSS log likelihood of the ARMA slice on an already-differenced
        series (the cost-only ``arma_css`` kernel on the card)."""
        return _log_likelihood_css_arma(self.arma_coefficients,
                                        self._like(diffed), self.p, self.q,
                                        1)

    def gradient_log_likelihood_css_arma(self, diffed) -> torch.Tensor:
        """Gradient of :meth:`log_likelihood_css_arma` with respect to the
        full coefficient vector, zero in the frozen xreg slots: ``-(n /
        css) Jᵀr`` from one normal-equations pass (on the card one
        ``arma_ne`` launch)."""
        y = self._like(diffed)
        params = self.arma_coefficients
        batch = torch.broadcast_shapes(params.shape[:-1], y.shape[:-1])
        params = params.expand(*batch, params.shape[-1])
        y = y.expand(*batch, y.shape[-1])
        k = params.shape[-1]
        if y.is_cuda:
            check_kernel_order(self.p, self.q, 1)
        _, grad = css_neg_ll_value_and_grad(
            params.reshape(-1, k), y.reshape(-1, y.shape[-1]), self.p,
            self.q, 1)
        pad = self.xreg_coefficients.expand(*batch, -1)
        return torch.cat([-grad.reshape(*batch, k), torch.zeros_like(pad)],
                         dim=-1)

    # -- effects (pure ARMA) ------------------------------------------------

    def remove_time_dependent_effects(self, ts) -> torch.Tensor:
        return _remove_effects(self.arma_coefficients, self._like(ts),
                               self.p, self.d, self.q, 1)

    def add_time_dependent_effects(self, ts) -> torch.Tensor:
        return _add_effects(self.arma_coefficients, self._like(ts), self.p,
                            self.d, self.q, 1)

    # -- exogenous terms ----------------------------------------------------

    def difference_xreg(self, xreg) -> torch.Tensor:
        """Order-d difference of each exogenous column, the first ``d``
        rows dropped: ``(..., r, k)`` -> ``(..., r - d, k)``."""
        return _difference_columns(self._like(xreg), self.d)[..., self.d:,
                                                             :]

    def _xreg_terms(self, dx: torch.Tensor) -> torch.Tensor:
        return _assemble_xreg_terms(dx, self.xreg_max_lag,
                                    self.include_original_xreg)

    def xreg_contribution(self, xreg) -> torch.Tensor:
        """Exogenous contribution ``bx·X_terms`` on the differenced scale,
        one value per row of ``diff_d(xreg)``."""
        terms = self._xreg_terms(self.difference_xreg(xreg))
        return torch.einsum("...nm,...m->...n", terms,
                            self.xreg_coefficients)

    # -- forecasting --------------------------------------------------------

    def _adjusted(self, params, ts, xreg):
        """``(dy - g, g)``: the xreg-adjusted differenced series and the
        exogenous part ``g`` at coefficients ``params``."""
        n_arma = self._n_arma
        dy = differences_of_order_d(ts, self.d)[..., self.d:]
        g = torch.einsum("...nm,...m->...n",
                         self._xreg_terms(self.difference_xreg(xreg)),
                         params[..., n_arma:])
        return dy - g, g

    def _broadcast(self, ts, xreg):
        ts, xreg = self._like(ts), self._like(xreg)
        params = self.coefficients
        batch = torch.broadcast_shapes(params.shape[:-1], ts.shape[:-1],
                                       xreg.shape[:-2])
        return (params.expand(*batch, params.shape[-1]),
                ts.expand(*batch, ts.shape[-1]),
                xreg.expand(*batch, *xreg.shape[-2:]))

    def forecast(self, ts, xreg) -> torch.Tensor:
        """One-step-ahead predictions over a window: ``ts (..., n)`` and
        ``xreg (..., n, k)`` (or a shared ``(n, k)``) cover the same time
        span, one prediction per observation.  On the differenced scale
        ``ŷ_t`` is the ARMA one-step fit of the adjusted series plus
        ``bx·X_terms_t``; for ``d > 0`` it is re-levelled through the
        lower-order differences at ``t-1``, and the first ``d`` outputs
        are the observations."""
        params, ts, xreg = self._broadcast(ts, xreg)
        p, d, q = self.p, self.d, self.q
        max_lag = max(p, q)
        n = ts.shape[-1]
        batch = params.shape[:-1]
        adjusted, g = self._adjusted(params, ts, xreg)
        c = params[..., 0]
        ext = torch.cat([c[..., None].expand(*batch, max_lag), adjusted],
                        dim=-1)
        yhat, _ = _one_step_errors(params[..., :self._n_arma], ext, p, q, 1)
        hist = torch.cat([ts.new_zeros((*batch, max_lag)), yhat], dim=-1)
        pred_diff = hist[..., max_lag:] + g        # 1-step preds of dy
        if d == 0:
            return pred_diff
        level = _difference_rows(ts, d).sum(dim=-2)
        t_idx = torch.arange(d, n, device=ts.device)
        preds = level[..., t_idx - 1] + pred_diff[..., t_idx - d]
        return torch.cat([ts[..., :d], preds], dim=-1)

    def _sigma2(self, params, ts, xreg) -> torch.Tensor:
        """One-step error variance of the xreg-adjusted ARMA, CSS
        convention (burn-in dropped from the sum, the differenced length
        the divisor)."""
        adjusted, _ = self._adjusted(params, ts, xreg)
        _, err = _one_step_errors(params[..., :self._n_arma], adjusted,
                                  self.p, self.q, 1)
        return (err * err).sum(dim=-1) / adjusted.shape[-1]

    def forecast_interval(self, ts, xreg, conf: float = 0.95):
        """:meth:`forecast` with ``± z·σ`` bands, σ² the constant one-step
        variance of the xreg-adjusted ARMA; the first ``d`` positions
        (observations, not forecasts) get NaN bands.  Returns ``(pred,
        lower, upper)``."""
        pred = self.forecast(ts, xreg)
        params, ts_b, xreg_b = self._broadcast(ts, xreg)
        sigma2 = self._sigma2(params, ts_b, xreg_b)
        z = normal_quantile(conf, pred.dtype).to(pred.device)
        half = z * torch.sqrt(sigma2)[..., None]
        pos = torch.arange(pred.shape[-1], device=pred.device)
        half = torch.where(pos < self.d, torch.full_like(half, math.nan),
                           half.expand(pred.shape))
        return pred, pred - half, pred + half


def _refine_inputs(p: int, d: int, q: int, ts: torch.Tensor, xreg,
                   xreg_max_lag: int, include_original_xreg: bool,
                   include_intercept: bool, user_init_params=None):
    """The refine's start and data: ``(init (..., icpt+p+q), bx (...,
    n_xreg), adjusted (..., n - d))``.  The ARX initialization runs on
    the raw series with the size-preserving differenced xreg, the terms
    on its rows past ``d``; the MA start is Hannan-Rissanen's on the
    differenced series; ``adjusted = diff_d(y) - terms·bx``."""
    dev = ts.device
    xreg = torch.as_tensor(xreg, dtype=ts.dtype, device=dev)
    if xreg.ndim < 2 or xreg.shape[-2] != ts.shape[-1]:
        raise ValueError(
            f"xreg must be (n, k) or (..., n, k) with n = series length "
            f"{ts.shape[-1]}; got {tuple(xreg.shape)}")
    diffed = differences_of_order_d(ts, d)[..., d:]
    dx_full = _difference_columns(xreg, d)
    terms = _assemble_xreg_terms(dx_full[..., d:, :], xreg_max_lag,
                                 include_original_xreg)
    lead = torch.broadcast_shapes(ts.shape[:-1], xreg.shape[:-2])
    if user_init_params is not None:
        init_full = torch.as_tensor(user_init_params, dtype=ts.dtype,
                                    device=dev)
        init_full = init_full.expand(*lead, init_full.shape[-1])
        c0 = init_full[..., :1]
        ar0 = init_full[..., 1:1 + p]
        ma0 = init_full[..., 1 + p:1 + p + q]
        bx = init_full[..., 1 + p + q:]
    else:
        arx = autoregression_x.fit(ts, dx_full, p, xreg_max_lag,
                                   include_original_xreg,
                                   no_intercept=not include_intercept,
                                   device=dev)
        c0 = arx.c[..., None] if include_intercept \
            else ts.new_zeros((*lead, 1))
        ar0 = arx.coefficients[..., :p]
        bx = arx.coefficients[..., p:]
        if q > 0:
            ma0 = hannan_rissanen_init(p, q, diffed, include_intercept
                                       )[..., -q:].expand(*lead, q)
        else:
            ma0 = ts.new_zeros((*lead, 0))
    adjusted = diffed - torch.einsum("...nm,...m->...n", terms, bx)
    adjusted = adjusted.expand(*lead, adjusted.shape[-1])
    parts = ([c0] if include_intercept else []) + [ar0, ma0]
    return torch.cat(parts, dim=-1), bx, adjusted


def fit(p: int, d: int, q: int, ts, xreg, xreg_max_lag: int,
        include_original_xreg: bool = True, include_intercept: bool = True,
        user_init_params=None, method: str = "css-lm",
        max_iter: Optional[int] = None, retry=None, device=None,
        stats: Optional[dict] = None, _restart_draws=None) -> ARIMAXModel:
    """Fit an ARIMAX(p, d, q) on ``device`` (``None`` means CUDA, float32;
    ``"cpu"`` takes float32 or float64): the ARX initialization by OLS on
    ``[y lags ‖ xreg lags ‖ xreg]`` with the xreg columns differenced to
    order d, Hannan-Rissanen MA estimates, then the CSS refine of the
    ARMA slice on the xreg-adjusted series, the xreg coefficients
    frozen.

    ``ts (..., n)``; ``xreg (n, k)`` or batched ``(..., n, k)``.
    ``method``: ``"css-lm"`` (the LM-fit kernel, one launch per fit on
    the card, :data:`~spark_timeseries_tpu_torch.models.arima.
    LM_MAX_ITER` iterations by default), ``"css-cgd"`` (BFGS over the
    ``arma_ne`` pass, one launch per evaluation; 500 iterations) or
    ``"css-bobyqa"`` (the projected gradient over it; 500 iterations).
    A lane whose refine is not finite keeps its initialization.  ``p =
    q = 0`` without intercept has nothing to refine: the fit is the
    direct ARX solve.  ``retry`` (a ``RetryPolicy``) runs the multi-start
    path as ``arima.fit`` does (``_restart_draws (R, S, k)`` hands in the
    draws).  ``stats`` receives ``lm_fit_launches`` (css-lm: LM-fit
    launches on CUDA, 0 on the CPU) or ``ne_launches`` (css-cgd,
    css-bobyqa: ``arma_ne`` launches on CUDA, 0 on the CPU)."""
    if method not in ("css-lm", "css-cgd", "css-bobyqa"):
        raise ValueError(f"unknown method {method!r}")
    dev = resolve_device(device)
    ts = as_tensor(ts, dev)
    icpt = 1 if include_intercept else 0
    dim = icpt + p + q
    if dev.type == "cuda" and dim > 0:
        check_kernel_order(p, q, icpt)
    init, bx, adjusted = _refine_inputs(p, d, q, ts, xreg, xreg_max_lag,
                                        include_original_xreg,
                                        include_intercept, user_init_params)
    lead = init.shape[:-1]

    if dim > 0:
        rk = _resilience.retry_kwargs(retry)
        if max_iter is None and retry is not None \
                and retry.max_iter is not None:
            max_iter = retry.max_iter
        x0 = init.reshape(-1, dim)
        y = adjusted.reshape(-1, adjusted.shape[-1])

        def rows(idx):
            return y if idx is None else y.index_select(0, idx)

        solver: dict = {}
        if method == "css-lm":
            # exactly arima's CSS residual on the adjusted series: the
            # LM-fit kernel applies unchanged
            mi = max_iter if max_iter is not None else LM_MAX_ITER
            tol = 1e-10 if ts.dtype == torch.float64 else 1e-6

            def solve(xs, idx):
                return fit_css_lm(xs, rows(idx), p, q, icpt, tol=tol,
                                  max_iter=mi)

            res = _solve_with_policy(solve, x0, rk.get("restarts", 0),
                                     rk.get("restart_scale", 0.25),
                                     rk.get("restart_seed", 0),
                                     _restart_draws, solver)
            if stats is not None:
                stats["lm_fit_launches"] = solver["solves"] \
                    if x0.is_cuda else 0
        else:
            def evaluator_for(idx):
                yy = rows(idx)
                return lambda x: css_neg_ll_value_and_grad(x, yy, p, q, icpt)

            mi = max_iter if max_iter is not None else 500
            if method == "css-cgd":
                res = minimize_bfgs(evaluator_for(None), x0, tol=1e-7,
                                    max_iter=mi, evaluator_for=evaluator_for,
                                    jitter_draws=_restart_draws,
                                    stats=solver, **rk)
            else:
                res = minimize_box(evaluator_for(None), x0, -math.inf,
                                   math.inf, tol=1e-10, max_iter=mi,
                                   evaluator_for=evaluator_for,
                                   jitter_draws=_restart_draws,
                                   stats=solver, **rk)
            if stats is not None:
                stats["ne_launches"] = solver.get("calls", 0) \
                    if x0.is_cuda else 0
        res = MinimizeResult(
            res.x.reshape(*lead, dim), res.fun.reshape(lead),
            res.converged.reshape(lead), res.n_iter.reshape(lead),
            None if res.attempts is None else res.attempts.reshape(lead))
        lane_ok = torch.isfinite(res.x).all(dim=-1, keepdim=True)
        refined = torch.where(lane_ok, res.x, init)
        diag = diagnostics_from(res, lane_ok)
    else:
        # nothing to refine (p = q = 0, no intercept): the direct ARX
        # solve, with its residual CSS as fun
        refined = init
        fun = (adjusted * adjusted).sum(dim=-1)
        diag = FitDiagnostics(
            torch.isfinite(bx).all(dim=-1) & torch.isfinite(fun),
            torch.zeros(fun.shape, dtype=torch.int32, device=dev), fun)

    if include_intercept:
        full = torch.cat([refined, bx], dim=-1)
    else:
        full = torch.cat([ts.new_zeros((*lead, 1)), refined, bx], dim=-1)
    return ARIMAXModel(p, d, q, xreg_max_lag, full, include_original_xreg,
                       include_intercept, diagnostics=diag)


def _pad_to_order(model: ARIMAXModel, p: int, q: int) -> ARIMAXModel:
    """A lower-ARMA-order fit in the (p, q) layout, the absent AR/MA
    slots zero (the intercept slot is always present)."""
    coefs = model.coefficients
    lead = coefs.shape[:-1]
    mp, mq = model.p, model.q
    full = torch.cat([coefs[..., :1 + mp],
                      coefs.new_zeros((*lead, p - mp)),
                      coefs[..., 1 + mp:1 + mp + mq],
                      coefs.new_zeros((*lead, q - mq)),
                      coefs[..., 1 + mp + mq:]], dim=-1)
    return ARIMAXModel(p, model.d, q, model.xreg_max_lag, full,
                       model.include_original_xreg, model.has_intercept,
                       diagnostics=model.diagnostics)


def _count(stats: Optional[dict], stage: str, st: dict) -> None:
    """Add a stage's kernel launches to the chain's ``stats``."""
    if stats is None:
        return
    for key in ("lm_fit_launches", "ne_launches"):
        n = int(st.get(key, 0))
        by = stats.setdefault(f"{key}_by_stage", {})
        by[stage] = by.get(stage, 0) + n
        stats[key] = stats.get(key, 0) + n


def fit_resilient(ts, xreg, p: int, d: int, q: int, xreg_max_lag: int,
                  include_original_xreg: bool = True,
                  include_intercept: bool = True, retry=None, device=None,
                  stats: Optional[dict] = None, **kwargs):
    """Fail-soft batched ARIMAX on ``device`` (``None`` means CUDA):
    css-lm with multi-start retry -> css-bobyqa -> xreg plus intercept
    only (the ARMA slots zero, the exogenous effects kept).  ``ts
    (n_series, n)``; ``xreg`` must be a shared unbatched ``(n, k)``
    design.  ``retry`` defaults to ``RetryPolicy()``; ``kwargs`` pass
    through to every stage's :func:`fit`.  Returns ``(model,
    FitOutcome)``.  ``stats`` receives ``lm_fit_launches`` and
    ``ne_launches`` over every stage (on CUDA; 0 on the CPU) and each by
    stage."""
    if retry is None:
        retry = _resilience.RetryPolicy()
    dev = resolve_device(device)
    values = as_tensor(ts, dev)
    xreg = torch.as_tensor(xreg, dtype=values.dtype, device=dev)
    if xreg.ndim != 2:
        raise ValueError(
            "fit_resilient needs a shared unbatched (n, k) design; got "
            f"xreg shape {tuple(xreg.shape)}")
    if stats is not None:
        stats.update(lm_fit_launches=0, ne_launches=0)

    def stage(name, pp, qq, **kw):
        def run(v):
            st: dict = {}
            m = fit(pp, d, qq, v, xreg, xreg_max_lag, include_original_xreg,
                    include_intercept, device=dev, stats=st, **kw)
            _count(stats, name, st)
            return m if (pp, qq) == (p, q) else _pad_to_order(m, p, q)
        return run

    chain = [
        ("css-lm", stage("css-lm", p, q, retry=retry, **kwargs)),
        ("css-bobyqa", stage("css-bobyqa", p, q,
                             **_resilience.override_kwargs(
                                 kwargs, method="css-bobyqa"))),
        ("xreg_only", stage("xreg_only", 0, 0, **kwargs)),
    ]
    min_len = d + max(2 * max(p, q) + 3 + p + q, xreg_max_lag + 2, 3)
    return _resilience.resilient_fit(values, chain, min_len=min_len,
                                     family="arimax")
