"""ARIMA(p, d, q) models, batched (counterpart of
``spark_timeseries_tpu/models/arima.py``).

Ported so far: the conditional-sum-of-squares fit with the batched
Levenberg-Marquardt solver (``method="css-lm"``, ``objective="css"``),
the AR fast path, ragged (NaN-padded) panels, short-lane quarantine,
forecasting, the CSS log likelihood and the stationarity/invertibility
root checks.  The LM solve's normal equations come from
``ops.arma_ne`` — on CUDA, the hand-written kernel.

Coefficients are laid out ``[intercept?, AR..., MA...]`` as in the JAX
package, panels series-major ``(n_series, n_obs)``.
"""

from __future__ import annotations

import math
import warnings
from typing import NamedTuple, Optional

import numpy as np
import torch

from .._device import as_tensor, resolve_device
from ..ops.arma_ne import (check_kernel_order, css_cost, fit_css_lm,
                           normal_equations_plain)
from ..ops.lag import lag_matvec, lag_stack
from ..ops.linalg import ols_gram
from ..ops.optimize import MinimizeResult
from ..ops.ragged import (apply_short_quarantine, ragged_view, short_lanes,
                          step_weights)
from ..ops.univariate import (differences_of_order_d,
                              inverse_differences_of_order_d)
from . import autoregression
from .base import FitDiagnostics, diagnostics_from

# LM iteration cap of the css-lm fit (the JAX package's LM_MAX_ITER)
LM_MAX_ITER = 50


def _split_params(params: torch.Tensor, p: int, q: int, icpt: int):
    """Split a ``(..., icpt+p+q)`` coefficient vector into (c, phi, theta)."""
    c = params[..., 0] if icpt else params.new_zeros(params.shape[:-1])
    return c, params[..., icpt:icpt + p], params[..., icpt + p:icpt + p + q]


def _lag_stack_or_empty(x: torch.Tensor, k: int) -> torch.Tensor:
    """``lag_stack`` that tolerates ``k == 0`` (returns ``(..., 0, n)``)."""
    if k == 0:
        return x.new_zeros((*x.shape[:-1], 0, x.shape[-1]))
    return lag_stack(x, k)


# ---------------------------------------------------------------------------
# core recurrences, batched over leading dims
# ---------------------------------------------------------------------------

def _one_step_errors(params: torch.Tensor, y: torch.Tensor,
                     p: int, q: int, icpt: int):
    """One-step-ahead fitted values and errors for ``t >= max(p, q)``:
    AR terms read the observed series, MA terms feed back the one-step
    errors.  ``params (..., k)``, ``y (..., n)`` broadcast; returns
    ``(yhat, err)``, each ``(..., n - max(p, q))``."""
    c, phi, theta = _split_params(params, p, q, icpt)
    max_lag = max(p, q)
    y_t = y[..., max_lag:]
    if p > 0:
        base = (c[..., None] + lag_matvec(y, phi, p))[..., max_lag - p:]
    else:
        base = c[..., None] + torch.zeros_like(y_t)
    if q == 0:
        return base, y_t - base
    y_t = y_t.expand(base.shape)
    errs = [torch.zeros_like(base[..., 0])] * q
    yhats, errors = [], []
    for t in range(base.shape[-1]):
        yhat = base[..., t]
        for m in range(q):
            yhat = yhat + theta[..., m] * errs[m]
        e = y_t[..., t] - yhat
        errs = [e] + errs[:-1]
        yhats.append(yhat)
        errors.append(e)
    return torch.stack(yhats, dim=-1), torch.stack(errors, dim=-1)


# The JAX package's per-step ``(JᵀJ, Jᵀr, sse)`` scan, batched over lanes:
# the plain version of the CUDA kernel in ``ops.arma_ne``.
_arma_normal_eqs = normal_equations_plain


def _log_likelihood_css_arma(params: torch.Tensor, diffed: torch.Tensor,
                             p: int, q: int, icpt: int,
                             n_valid: Optional[torch.Tensor] = None
                             ) -> torch.Tensor:
    """CSS log likelihood of an ARMA(p, q) on an already-differenced
    series: residuals for ``t < max(p, q)`` are dropped and
    ``sigma² = css / n`` (with the real ``-n / 2.0`` leading factor, as in
    the JAX package).  ``n_valid (...,)`` weights out the residuals past
    each lane's valid window and makes it the divisor.

    The sum of squares is ``ops.arma_ne.css_cost`` over the broadcast
    lanes — the cost-only CUDA kernel on the card; an order without
    parameters has no recurrence, and its residuals are the series."""
    n = diffed.shape[-1]
    n_eff = float(n) if n_valid is None else n_valid.to(diffed.dtype)
    if p + q + icpt == 0:
        w = 1.0 if n_valid is None else step_weights(
            n, n_valid[..., None], dtype=diffed.dtype)
        css = (w * diffed * diffed).sum(dim=-1)
    else:
        batch = torch.broadcast_shapes(params.shape[:-1], diffed.shape[:-1],
                                       () if n_valid is None
                                       else n_valid.shape)
        nv = None if n_valid is None else n_valid.expand(batch).reshape(-1)
        css = css_cost(params.expand(*batch, params.shape[-1])
                       .reshape(-1, params.shape[-1]),
                       diffed.expand(*batch, n).reshape(-1, n), p, q, icpt,
                       n_valid=nv).reshape(batch)
    sigma2 = css / n_eff
    return (-n_eff / 2.0) * torch.log(2.0 * math.pi * sigma2) \
        - css / (2.0 * sigma2)


def _difference_rows(ts: torch.Tensor, d: int) -> torch.Tensor:
    """Rows 0..d-1 of incremental differences ``(..., d, n)``; row ``i``
    holds the proper i-th order difference from index ``i`` on."""
    rows = [ts]
    for i in range(1, d):
        prev = rows[i - 1]
        rows.append(torch.cat(
            [ts.new_zeros((*ts.shape[:-1], i)),
             prev[..., i:] - prev[..., i - 1:-1]], dim=-1))
    return torch.stack(rows, dim=-2)


def _forecast(params: torch.Tensor, ts: torch.Tensor, n_future: int,
              p: int, d: int, q: int, icpt: int) -> torch.Tensor:
    """1-step-ahead fitted historicals + ``n_future`` forecast periods,
    with the d-order integration unwound through the incremental
    differences (the JAX package's ``_forecast_one``, batched)."""
    batch = torch.broadcast_shapes(params.shape[:-1], ts.shape[:-1])
    params = params.expand(*batch, params.shape[-1])
    ts = ts.expand(*batch, ts.shape[-1])
    c, phi, theta = _split_params(params, p, q, icpt)
    max_lag = max(p, q)
    n = ts.shape[-1]

    diffed = differences_of_order_d(ts, d)[..., d:]
    ext = torch.cat([c[..., None].expand(*batch, max_lag), diffed], dim=-1)
    yhat, _ = _one_step_errors(params, ext, p, q, icpt)
    hist = torch.cat([ts.new_zeros((*batch, max_lag)), yhat], dim=-1)

    # forward pass: future errors are zero, AR terms read prior forecasts;
    # both rings newest-first
    errs = list((ext - hist).flip(-1)[..., :q].unbind(-1))
    recent = list(hist.flip(-1)[..., :p].unbind(-1))
    outs = []
    for _ in range(n_future):
        out = c
        for j in range(p):
            out = out + phi[..., j] * recent[j]
        for m in range(q):
            out = out + theta[..., m] * errs[m]
        if p:
            recent = [out] + recent[:-1]
        if q:
            errs = [torch.zeros_like(out)] + errs[:-1]
        outs.append(out)
    fwd = torch.stack(outs, dim=-1) if outs \
        else ts.new_zeros((*batch, 0))

    results = ts.new_zeros((*batch, n + n_future))
    results[..., :d] = ts[..., :d]
    results[..., d:n] = hist[..., max_lag:]
    results[..., n:] = fwd
    if d != 0:
        diff_matrix = _difference_rows(ts, d)                # (..., d, n)
        i_idx = torch.arange(d, n - d, device=ts.device)
        level = diff_matrix.sum(dim=-2)
        results[..., d:n - d] = level[..., i_idx - 1] \
            + hist[..., max_lag + i_idx]
        prev_terms = torch.diagonal(diff_matrix[..., :, n - d:],
                                    dim1=-2, dim2=-1)        # (..., d)
        results[..., n - d:] = inverse_differences_of_order_d(
            torch.cat([prev_terms, fwd], dim=-1), d)
    return results


# ---------------------------------------------------------------------------
# polynomial root checks (host-side numpy, off the fit path)
# ---------------------------------------------------------------------------

def _all_roots_outside_unit_circle(polys: np.ndarray):
    """Batched check that every root of each ascending-coefficient
    polynomial ``polys (..., k+1)`` lies outside the unit circle, by
    companion-matrix eigenvalues batched per effective degree."""
    polys = np.asarray(polys, dtype=np.float64)
    batch = polys.shape[:-1]
    k = polys.shape[-1] - 1
    if k < 1:
        return np.ones(batch, dtype=bool)
    flat = polys.reshape(-1, k + 1)
    finite = np.all(np.isfinite(flat), axis=-1)        # NaN lane: not ok
    ok = finite.copy()
    remaining = finite.copy()
    for deg in range(k, 0, -1):
        lead = np.abs(flat[:, deg]) > 1e-300
        process = remaining & lead
        if np.any(process):
            sub = flat[process]
            comp = np.zeros((sub.shape[0], deg, deg))
            comp[:, deg - 1, :] = -sub[:, :deg] / sub[:, deg:deg + 1]
            if deg > 1:
                comp[:, :deg - 1, 1:] = np.eye(deg - 1)
            roots = np.linalg.eigvals(comp)
            ok[process] &= ~np.any(np.abs(roots) <= 1.0, axis=-1)
        remaining &= ~lead
    return ok.reshape(batch) if batch else bool(ok.reshape(()))


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

class ARIMAModel(NamedTuple):
    """ARIMA(p, d, q) with coefficients ``[intercept?, AR..., MA...]``;
    ``coefficients`` may carry a leading batch dim (a whole panel's fit)."""
    p: int
    d: int
    q: int
    coefficients: torch.Tensor
    has_intercept: bool = True
    diagnostics: Optional[FitDiagnostics] = None

    @property
    def _icpt(self) -> int:
        return 1 if self.has_intercept else 0

    def _like(self, x) -> torch.Tensor:
        return torch.as_tensor(x, dtype=self.coefficients.dtype,
                               device=self.coefficients.device)

    @property
    def intercept(self) -> torch.Tensor:
        return _split_params(self.coefficients, self.p, self.q,
                             self._icpt)[0]

    @property
    def ar_coefficients(self) -> torch.Tensor:
        return self.coefficients[..., self._icpt:self._icpt + self.p]

    @property
    def ma_coefficients(self) -> torch.Tensor:
        i = self._icpt + self.p
        return self.coefficients[..., i:i + self.q]

    @property
    def n_params(self) -> int:
        """Estimated-parameter count (intercept + AR + MA)."""
        return self.p + self.q + self._icpt

    def log_likelihood_css(self, ts) -> torch.Tensor:
        """CSS log likelihood on an *undifferenced* series."""
        diffed = differences_of_order_d(self._like(ts), self.d)[..., self.d:]
        return self.log_likelihood_css_arma(diffed)

    def log_likelihood_css_arma(self, diffed) -> torch.Tensor:
        """CSS log likelihood on an already-differenced series."""
        return _log_likelihood_css_arma(self.coefficients,
                                        self._like(diffed), self.p, self.q,
                                        self._icpt)

    def forecast(self, ts, n_future: int) -> torch.Tensor:
        """Fitted 1-step-ahead historicals followed by ``n_future``
        forecast periods."""
        ts = self._like(ts)
        need = self.d + max(self.p, self.q) + 1
        if ts.shape[-1] < need:
            raise ValueError(
                f"forecast needs at least d + max(p, q) + 1 = {need} trailing"
                f" observations for ARIMA({self.p},{self.d},{self.q}); "
                f"got {ts.shape[-1]}")
        return _forecast(self.coefficients, ts, n_future, self.p, self.d,
                         self.q, self._icpt)

    def is_stationary(self):
        """AR characteristic roots outside the unit circle."""
        phi = self.ar_coefficients.detach().cpu().numpy()
        if self.p == 0:
            shape = phi.shape[:-1]
            return np.ones(shape, bool) if shape else True
        ones = np.ones((*phi.shape[:-1], 1))
        return _all_roots_outside_unit_circle(
            np.concatenate([ones, -phi], axis=-1))

    def is_invertible(self):
        """MA characteristic roots outside the unit circle."""
        theta = self.ma_coefficients.detach().cpu().numpy()
        if self.q == 0:
            shape = theta.shape[:-1]
            return np.ones(shape, bool) if shape else True
        ones = np.ones((*theta.shape[:-1], 1))
        return _all_roots_outside_unit_circle(
            np.concatenate([ones, theta], axis=-1))


# ---------------------------------------------------------------------------
# fitting
# ---------------------------------------------------------------------------

def hannan_rissanen_init(p: int, q: int, y: torch.Tensor,
                         include_intercept: bool,
                         n_valid: Optional[torch.Tensor] = None
                         ) -> torch.Tensor:
    """Hannan-Rissanen initial ARMA estimates: fit AR(m) with
    ``m = max(p, q) + 1``, estimate the errors, then OLS of the series on
    [AR lag terms ‖ MA error-lag terms].  ``y (..., n)`` batched;
    ``n_valid (...,)`` weights out rows past each lane's valid window."""
    m = max(p, q) + 1
    mx = max(p, q)
    ar = autoregression.fit(y, m, n_valid=n_valid)
    est = lag_matvec(y, ar.coefficients, m) + ar.c[..., None]
    y_trunc = y[..., m:]
    errors = y_trunc - est
    n_rows = y_trunc.shape[-1] - mx
    Xs = torch.cat([_lag_stack_or_empty(y_trunc, p)[..., -n_rows:],
                    _lag_stack_or_empty(errors, q)[..., -n_rows:]], dim=-2)
    target = y_trunc[..., mx:]
    w = None
    if n_valid is not None:
        w = step_weights(n_rows, n_valid[..., None], offset=m + mx,
                         dtype=y.dtype)
    return ols_gram(Xs, target, add_intercept=include_intercept,
                    row_weights=w).beta


def _warn_stationarity_invertibility(model: ARIMAModel, warn: bool) -> None:
    if not warn:
        return
    if not np.all(model.is_stationary()):
        warnings.warn("AR parameters are not stationary", stacklevel=3)
    if not np.all(model.is_invertible()):
        warnings.warn("MA parameters are not invertible", stacklevel=3)


def fit(p: int, d: int, q: int, ts,
        include_intercept: bool = True, method: str = "css-lm",
        user_init_params=None, warn: bool = True,
        max_iter: Optional[int] = None, retry=None,
        n_valid=None, objective: str = "css",
        device=None, stats: Optional[dict] = None) -> ARIMAModel:
    """Fit an ARIMA(p, d, q) by conditional-sum-of-squares maximum
    likelihood with the batched Levenberg-Marquardt solver.

    ``ts`` may be ``(n,)`` or ``(n_series, n)`` (array-like or tensor);
    the whole panel fits in one batched solve on ``device`` (``None``
    means CUDA, which runs float32 and raises without a card; pass
    ``device="cpu"`` for the CPU, float32 or float64).  The LM fit is
    ``ops.arma_ne.fit_css_lm``: on the card one launch of its CUDA kernel
    runs every lane's whole fit.

    ``q == 0`` (without ``user_init_params``) is the AR fast path: a
    direct OLS, every finite lane converged in 0 iterations.  NaN-padded
    panels (leading/trailing NaN per lane) fit each lane's valid window;
    lanes too short for the order get NaN coefficients and
    ``diagnostics.converged == False``.  ``n_valid`` (per-lane lengths of
    an already left-aligned, zero-tailed panel) skips the NaN detection.

    ``max_iter`` caps the LM iterations (default :data:`LM_MAX_ITER`);
    the convergence tolerance is 1e-10 for float64 and 1e-6 for float32,
    as in the JAX package's LM solver.  ``diagnostics.fun`` is the
    residual sum of squares on the LM path and the negative CSS log
    likelihood on the AR fast path, as in the JAX package.

    ``stats`` (a dict), when the fit runs the LM solver, receives
    ``lm_fit_launches``: the LM-fit kernel's launches (1 on CUDA, 0 on the
    CPU).

    Not ported yet (raise ``NotImplementedError``): ``method`` css-cgd
    and css-bobyqa, ``retry``, and ``objective="exact"``.
    """
    if objective == "exact":
        raise NotImplementedError(
            "objective='exact' (the Kalman-likelihood refine) is not ported "
            "yet; it comes with the state-space slice")
    if objective != "css":
        raise ValueError(f"unknown objective {objective!r}; expected "
                         f"'css' or 'exact'")
    if method in ("css-cgd", "css-bobyqa"):
        raise NotImplementedError(
            f"method {method!r} is not ported yet; the port fits with "
            f"'css-lm'")
    if method != "css-lm":
        raise ValueError(f"unknown method {method!r}")
    if retry is not None:
        raise NotImplementedError(
            "retry (multi-start fits) is not ported yet; it comes with the "
            "resilient-fit slice")
    icpt = 1 if include_intercept else 0
    dim = p + q + icpt
    ar_fast = p > 0 and q == 0 and user_init_params is None
    dev = resolve_device(device)
    if dev.type == "cuda" and dim > 0 and not ar_fast:
        check_kernel_order(p, q, icpt)
    ts = as_tensor(ts, dev)

    if n_valid is not None:
        obs_len = torch.as_tensor(n_valid, device=dev)
    else:
        ts, obs_len = ragged_view(ts)
    diffed = differences_of_order_d(ts, d)[..., d:]
    nv = None if obs_len is None else torch.clamp(obs_len - d, min=0)

    def _short_lanes(min_n):
        """Lanes whose valid window can't support the order (ragged only);
        ``min_n`` counts post-differencing observations."""
        if nv is None:
            return None
        return short_lanes(nv, min_n,
                           f"ARIMA({p},{d},{q}) fit (post-differencing)")

    if ar_fast:
        short = _short_lanes(2 * p + icpt + 1)
        ar = autoregression.fit(diffed, p, no_intercept=not include_intercept,
                                n_valid=nv)
        parts = ([ar.c[..., None]] if include_intercept else []) \
            + [ar.coefficients]
        coefs = torch.cat(parts, dim=-1)
        lane_ok = torch.isfinite(coefs).all(dim=-1)
        fun = -_log_likelihood_css_arma(coefs, diffed, p, q, icpt, nv)
        coefs, lane_ok = apply_short_quarantine(coefs, lane_ok, short)
        model = ARIMAModel(p, d, q, coefs, include_intercept,
                           FitDiagnostics(lane_ok, torch.zeros(
                               lane_ok.shape, dtype=torch.int32,
                               device=dev), fun))
        _warn_stationarity_invertibility(model, warn)
        return model

    if dim == 0:
        coefs = ts.new_zeros((*ts.shape[:-1], 0))
        fun = -_log_likelihood_css_arma(coefs, diffed, p, q, icpt, nv)
        return ARIMAModel(p, d, q, coefs, include_intercept,
                          FitDiagnostics(torch.isfinite(fun), torch.zeros(
                              fun.shape, dtype=torch.int32, device=dev),
                              fun))

    max_lag = max(p, q)
    if diffed.shape[-1] <= max_lag:
        raise ValueError(
            f"series too short to fit ARIMA({p},{d},{q}): the CSS window "
            f"needs more than max(p, q) = {max_lag} observations after "
            f"order-{d} differencing, got {diffed.shape[-1]}")
    if user_init_params is None:
        min_n = 2 * max_lag + 2 + p + q + icpt
        if diffed.shape[-1] < min_n:
            raise ValueError(
                f"series too short to fit ARIMA({p},{d},{q}): the "
                f"Hannan-Rissanen initialization needs >= {min_n} "
                f"observations after order-{d} differencing, got "
                f"{diffed.shape[-1]}; pass user_init_params to skip it")
        short = _short_lanes(min_n)
        init = hannan_rissanen_init(p, q, diffed, include_intercept,
                                    n_valid=nv)
        if short is not None:
            # a too-short lane's HR gram may be singular-but-finite; pin
            # its init to a neutral zero vector so LM stays finite there
            init = torch.where(short[..., None], torch.zeros_like(init),
                               init)
    else:
        short = _short_lanes(max_lag + 1)
        init = torch.as_tensor(user_init_params, dtype=ts.dtype,
                               device=dev).expand(*ts.shape[:-1], dim)

    mi = max_iter if max_iter is not None else LM_MAX_ITER
    tol = 1e-10 if ts.dtype == torch.float64 else 1e-6
    lanes = init.shape[:-1]
    x, f, conv, n_iter = fit_css_lm(
        init.reshape(-1, dim), diffed.reshape(-1, diffed.shape[-1]), p, q,
        icpt, tol=tol, max_iter=mi,
        n_valid=None if nv is None else nv.reshape(-1))
    if stats is not None:
        stats["lm_fit_launches"] = 1 if x.is_cuda else 0
    res = MinimizeResult(x.reshape(*lanes, dim), f.reshape(lanes),
                         conv.reshape(lanes), n_iter.reshape(lanes))

    # quarantine failed lanes back to their (finite) initial guess rather
    # than poisoning the batch; per lane, so a partially-NaN result never
    # yields a mixed coefficient vector
    lane_ok = torch.isfinite(res.x).all(dim=-1, keepdim=True)
    params = torch.where(lane_ok, res.x, init)
    diag = diagnostics_from(res, lane_ok)
    params, conv_mask = apply_short_quarantine(params, diag.converged, short)
    model = ARIMAModel(p, d, q, params, include_intercept,
                       diagnostics=diag._replace(converged=conv_mask))
    _warn_stationarity_invertibility(model, warn)
    return model
