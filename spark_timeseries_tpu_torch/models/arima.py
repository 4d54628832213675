"""ARIMA(p, d, q) models, batched (counterpart of
``spark_timeseries_tpu/models/arima.py``).

Ported: the conditional-sum-of-squares fit (``objective="css"``) by the
batched Levenberg-Marquardt solver (``method="css-lm"``, on CUDA the
hand-written LM-fit kernel ``ops.arma_ne.fit_css_lm``) or by the
projected gradient over the CSS value and gradient (``"css-bobyqa"``),
with multi-start retry (``retry=``); the AR fast path, ragged (NaN-padded)
panels and short-lane quarantine; the model's forecasts with bands,
likelihood, AIC, gradient, Hessian, AR(∞) form, time-dependent effects
and sampling; the stationarity/invertibility root checks; the stepwise
:func:`auto_fit` and the batched :func:`auto_fit_panel`; and the fail-soft
:func:`fit_resilient` (health masking, retry, the fallback chain ARIMA ->
auto-order -> AR -> mean), and the batched BFGS ``method="css-cgd"``.
Not ported yet: ``objective="exact"`` and ``log_likelihood_exact`` (the
state-space slice), ``fit_long`` and ``segment_fit_outputs`` (the
long-series slice).

Coefficients are laid out ``[intercept?, AR..., MA...]`` as in the JAX
package, panels series-major ``(n_series, n_obs)``.
"""

from __future__ import annotations

import math
import warnings
from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from .._device import as_tensor, resolve_device
from ..ops.arma_ne import (check_kernel_order, css_cost,
                           css_neg_ll_value_and_grad, fit_css_lm,
                           normal_equations_plain)
from ..ops.lag import lag_matvec, lag_stack
from ..ops.linalg import ols_gram, spd_solve
from ..ops.optimize import (MinimizeResult, _solve_with_policy, minimize_bfgs,
                            minimize_box)
from ..ops.ragged import (apply_short_quarantine, ragged_view, short_lanes,
                          step_weights)
from ..ops.univariate import (differences_of_order_d,
                              inverse_differences_of_order_d)
from ..stats import KPSS_CONSTANT_CRITICAL_VALUES, kpsstest
from ..utils import resilience as _resilience
from . import autoregression
from .base import FitDiagnostics, diagnostics_from, normal_quantile

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


def _broadcast(params: torch.Tensor, ts: torch.Tensor):
    """``params (..., k)`` and ``ts (..., n)`` expanded to one batch."""
    batch = torch.broadcast_shapes(params.shape[:-1], ts.shape[:-1])
    return (params.expand(*batch, params.shape[-1]),
            ts.expand(*batch, ts.shape[-1]))


def _forecast(params: torch.Tensor, ts: torch.Tensor, n_future: int,
              p: int, d: int, q: int, icpt: int) -> torch.Tensor:
    """1-step-ahead fitted historicals + ``n_future`` forecast periods,
    with the d-order integration unwound through the incremental
    differences (the JAX package's ``_forecast_one``, batched)."""
    params, ts = _broadcast(params, ts)
    batch = params.shape[:-1]
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


def _remove_effects(params: torch.Tensor, ts: torch.Tensor, p: int, d: int,
                    q: int, icpt: int) -> torch.Tensor:
    """The underlying errors of an ARIMA(p, d, q) realization (the JAX
    package's ``_remove_effects_one``, batched): difference, left-extend
    ``max(p, q)`` entries equal to the intercept, then invert the ARMA
    recurrence (the recovered error at t feeds the MA terms after it)."""
    params, ts = _broadcast(params, ts)
    c, phi, theta = _split_params(params, p, q, icpt)
    max_lag = max(p, q)
    diffed = differences_of_order_d(ts, d)
    ext = torch.cat([c[..., None].expand(*c.shape, max_lag), diffed], dim=-1)
    if p > 0:
        ar_part = lag_matvec(ext, phi, p)[..., max_lag - p:]
    else:
        ar_part = torch.zeros_like(diffed)
    base = ext[..., max_lag:] - c[..., None] - ar_part
    if q == 0:
        return base
    errs = [torch.zeros_like(base[..., 0])] * q
    outs = []
    for t in range(base.shape[-1]):
        ma = theta[..., 0] * errs[0]
        for m in range(1, q):
            ma = ma + theta[..., m] * errs[m]
        out = base[..., t] - ma
        errs = [out] + errs[:-1]
        outs.append(out)
    return torch.stack(outs, dim=-1)


def _add_effects(params: torch.Tensor, ts: torch.Tensor, p: int, d: int,
                 q: int, icpt: int) -> torch.Tensor:
    """ARIMA(p, d, q) structure over i.i.d. draws (the JAX package's
    ``_add_effects_one``, batched): prior AR values equal the intercept,
    prior MA errors are zero, the MA terms read the input errors, and the
    result is inverse-differenced ``d`` times."""
    params, ts = _broadcast(params, ts)
    c, phi, theta = _split_params(params, p, q, icpt)
    max_lag = max(p, q)
    if q > 0:
        e_pad = torch.cat([ts.new_zeros((*ts.shape[:-1], max_lag)), ts],
                          dim=-1)
        ma_part = lag_matvec(e_pad, theta, q)[..., max_lag - q:]
    else:
        ma_part = torch.zeros_like(ts)
    drive = ts + c[..., None] + ma_part
    if p == 0:
        out = drive
    else:
        recent = [c] * p
        outs = []
        for t in range(drive.shape[-1]):
            ar = phi[..., 0] * recent[0]
            for j in range(1, p):
                ar = ar + phi[..., j] * recent[j]
            out_t = drive[..., t] + ar
            recent = [out_t] + recent[:-1]
            outs.append(out_t)
        out = torch.stack(outs, dim=-1)
    return inverse_differences_of_order_d(out, d)


def _psi_half_widths(params: torch.Tensor, ts: torch.Tensor, h: int, p: int,
                     d: int, q: int, icpt: int, conf: float) -> torch.Tensor:
    """Half-widths of symmetric ``conf`` forecast bands for horizons 1..h
    (the JAX package's ``_psi_half_widths``, batched): ψ-weights of the
    nonstationary AR polynomial ``φ(B)(1 - B)^d``, the h-step variance
    ``σ² Σ_{j<h} ψ_j²`` with ``σ² = css / n`` of the one-step residuals."""
    params, ts = _broadcast(params, ts)
    _, phi, theta = _split_params(params, p, q, icpt)
    diffed = differences_of_order_d(ts, d)[..., d:]
    _, err = _one_step_errors(params, diffed, p, q, icpt)
    sigma2 = (err * err).sum(dim=-1) / diffed.shape[-1]

    # φ*(B) = φ(B)(1-B)^d as 1 - Σ a_j B^j, j = 1..p+d
    binom = [math.comb(d, k) * (-1.0) ** k for k in range(d + 1)]
    ar_poly = torch.cat([torch.ones_like(phi[..., :1]), -phi], dim=-1)
    ar_star = [sum(ar_poly[..., i] * binom[j - i]
                   for i in range(max(0, j - d), min(j, p) + 1))
               for j in range(p + d + 1)]
    a = [-c for c in ar_star[1:]]                                # p + d
    th = [torch.zeros_like(sigma2)] * h
    for j in range(1, min(q, h - 1) + 1):
        th[j] = theta[..., j - 1]
    psis = [torch.ones_like(sigma2)]
    for j in range(1, h):
        psi = th[j]
        for i, a_i in enumerate(a):
            if j - i - 1 >= 0:
                psi = psi + a_i * psis[j - i - 1]
        psis.append(psi)
    psi = torch.stack(psis, dim=-1)
    var_h = sigma2[..., None] * torch.cumsum(psi * psi, dim=-1)
    z = normal_quantile(conf, ts.dtype).to(ts.device)
    return z * torch.sqrt(var_h)


def ar_truncation(c, phi, theta, n_terms: int
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Truncated AR(∞) form of a (batched) ARMA: ``(c_pi (...), pi (...,
    n_terms))`` with ``π_k = φ_k + θ_k - Σ_{i=1..min(k-1, q)} θ_i π_{k-i}``
    (taps past the order are zero) and ``c_pi = c / (1 + Σθ_i)``, the
    JAX package's ``ar_truncation``.  ``phi (..., p)``, ``theta (...,
    q)``, ``c (...)``."""
    phi = torch.as_tensor(phi)
    theta = torch.as_tensor(theta, dtype=phi.dtype, device=phi.device)
    c = torch.as_tensor(c, dtype=phi.dtype, device=phi.device)
    batch = phi.shape[:-1]
    p, q = phi.shape[-1], theta.shape[-1]
    n_terms = int(n_terms)
    if n_terms < 1:
        raise ValueError(f"ar_truncation needs n_terms >= 1, got {n_terms}")

    def taps(x, k):
        if k >= n_terms:
            return x[..., :n_terms]
        return torch.cat([x, x.new_zeros((*batch, n_terms - k))], dim=-1)

    phi_ext = taps(phi, p)
    c_pi = c / (1.0 + theta.sum(dim=-1))
    if q == 0:
        return c_pi, phi_ext
    th_ext = taps(theta, q)
    ring = [phi.new_zeros(batch)] * q          # π_{k-1} .. π_{k-q}
    pis = []
    for k in range(n_terms):
        pi_k = phi_ext[..., k] + th_ext[..., k] \
            - (theta * torch.stack(ring, dim=-1)).sum(dim=-1)
        ring = [pi_k] + ring[:-1]
        pis.append(pi_k)
    return c_pi, torch.stack(pis, dim=-1)


def _neg_ll_autograd(params: torch.Tensor, diffed: torch.Tensor, p: int,
                     q: int, icpt: int) -> torch.Tensor:
    """The negative CSS log likelihood as differentiable tensor ops over
    the residual recurrence (the JAX package's ``_log_likelihood_css_arma``,
    negated), per lane."""
    _, err = _one_step_errors(params, diffed, p, q, icpt)
    n_eff = float(diffed.shape[-1])
    css = (err * err).sum(dim=-1)
    sigma2 = css / n_eff
    return -((-n_eff / 2.0) * torch.log(2.0 * math.pi * sigma2)
             - css / (2.0 * sigma2))


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

    def approx_aic(self, ts) -> torch.Tensor:
        """Conditional-likelihood AIC, ``-2 LL + 2 k`` (the CSS likelihood
        through the cost-only kernel on the card)."""
        return -2.0 * self.log_likelihood_css(ts) + 2.0 * self.n_params

    def gradient_log_likelihood_css_arma(self, diffed) -> torch.Tensor:
        """Gradient of the CSS log likelihood on an already-differenced
        series, ``(..., k)``: ``-(n / css) Jᵀr`` from one normal-equations
        pass (``ops.arma_ne.css_neg_ll_value_and_grad``; on the card one
        ``arma_ne`` kernel launch)."""
        params, y = _broadcast(self.coefficients, self._like(diffed))
        k = params.shape[-1]
        if k == 0:
            return params.clone()
        if y.is_cuda:
            check_kernel_order(self.p, self.q, self._icpt)
        batch = params.shape[:-1]
        _, grad = css_neg_ll_value_and_grad(
            params.reshape(-1, k), y.reshape(-1, y.shape[-1]), self.p,
            self.q, self._icpt)
        return -grad.reshape(*batch, k)

    def remove_time_dependent_effects(self, ts) -> torch.Tensor:
        """The underlying errors of the series (the inverse of
        :meth:`add_time_dependent_effects`)."""
        return _remove_effects(self.coefficients, self._like(ts), self.p,
                               self.d, self.q, self._icpt)

    def add_time_dependent_effects(self, ts) -> torch.Tensor:
        """The ARIMA process applied to i.i.d. errors ``ts``."""
        return _add_effects(self.coefficients, self._like(ts), self.p,
                            self.d, self.q, self._icpt)

    def sample(self, n: int, generator: Optional[torch.Generator] = None,
               shape=()) -> torch.Tensor:
        """Gaussian innovations ``(*shape, n)`` from ``generator`` (on its
        device, then moved to the model's) pushed through the process."""
        gen_dev = generator.device if generator is not None \
            else self.coefficients.device
        noise = torch.randn((*shape, n), generator=generator,
                            dtype=self.coefficients.dtype, device=gen_dev)
        return self.add_time_dependent_effects(noise)

    def forecast_interval(self, ts, n_future: int, conf: float = 0.95):
        """Point forecast plus symmetric ``conf`` prediction bands:
        ``(forecast, lower, upper)``, ``forecast`` exactly
        :meth:`forecast`'s output, ``lower`` / ``upper`` over the
        ``n_future`` future steps only, widening with the ψ-weight error
        variance.  Bands are bounded only where the AR part is stationary:
        an explosive lane's bands grow at its rate and may overflow."""
        if n_future < 1:
            raise ValueError("forecast_interval needs n_future >= 1")
        ts = self._like(ts)
        point = self.forecast(ts, n_future)
        half = _psi_half_widths(self.coefficients, ts, n_future, self.p,
                                self.d, self.q, self._icpt, conf)
        future = point[..., ts.shape[-1]:]
        return point, future - half, future + half

    def ar_inf_coefficients(self, n_terms: int
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
        """The AR(∞) form truncated at ``n_terms``, ``(c_pi, pi)`` with
        ``y_t ≈ c_pi + Σ_j pi_j y_{t-j} + e_t`` on the differenced scale
        (:func:`ar_truncation`)."""
        return ar_truncation(self.intercept, self.ar_coefficients,
                             self.ma_coefficients, n_terms)

    def coefficient_precision(self, ts, assume_differenced: bool = False
                              ) -> torch.Tensor:
        """The exact Hessian of the negative CSS log likelihood at the
        coefficients, ``(..., k, k)``: the observed information the
        long-series combiner weights by.  ``ts`` is the fitted series
        (``assume_differenced=True`` when already differenced).

        Every lane's likelihood goes into one autograd graph (lanes are
        independent, so the gradient of their sum separates by lane):
        one backward with its graph kept for the gradient, then one
        backward per coefficient for the Hessian's rows."""
        y = self._like(ts)
        if not assume_differenced:
            y = differences_of_order_d(y, self.d)[..., self.d:]
        params, y = _broadcast(self.coefficients, y)
        k = params.shape[-1]
        if k == 0:
            return params.new_zeros((*params.shape, 0))
        with torch.enable_grad():
            x = params.detach().clone().requires_grad_(True)
            f = _neg_ll_autograd(x, y, self.p, self.q, self._icpt).sum()
            (g,) = torch.autograd.grad(f, x, create_graph=True)
            rows = [torch.autograd.grad(g[..., j].sum(), x,
                                        retain_graph=j + 1 < k)[0]
                    for j in range(k)]
        return torch.stack(rows, dim=-2).detach()


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
        device=None, stats: Optional[dict] = None,
        _restart_draws=None) -> ARIMAModel:
    """Fit an ARIMA(p, d, q) by conditional-sum-of-squares maximum
    likelihood.

    ``ts`` may be ``(n,)`` or ``(n_series, n)`` (array-like or tensor);
    the whole panel fits in one batched solve on ``device`` (``None``
    means CUDA, which runs float32 and raises without a card; pass
    ``device="cpu"`` for the CPU, float32 or float64).  ``method``:

    - ``"css-lm"`` (default): batched Levenberg-Marquardt on the one-step
      residuals, ``ops.arma_ne.fit_css_lm``: on the card one launch of its
      CUDA kernel runs every lane's whole fit;
    - ``"css-bobyqa"``: the projected gradient of ``ops.optimize.
      minimize_box`` over the CSS negative log likelihood and its
      gradient (``ops.arma_ne.css_neg_ll_value_and_grad``: on the card
      one ``arma_ne`` launch per trial), 500 iterations by default;
    - ``"css-cgd"``: the batched BFGS of ``ops.optimize.minimize_bfgs``
      over the same value and gradient (on the card one ``arma_ne``
      launch per evaluation, over the lanes still running), 500
      iterations by default; as in the JAX package, every lane stops at
      a gradient ∞-norm under 1e-5 (``jax.scipy.optimize.minimize`` drops
      the ``tol`` it is given).

    ``q == 0`` (without ``user_init_params``) is the AR fast path: a
    direct OLS, every finite lane converged in 0 iterations.  NaN-padded
    panels (leading/trailing NaN per lane) fit each lane's valid window;
    lanes too short for the order get NaN coefficients and
    ``diagnostics.converged == False``.  ``n_valid`` (per-lane lengths of
    an already left-aligned, zero-tailed panel) skips the NaN detection.

    ``max_iter`` caps the iterations (default :data:`LM_MAX_ITER` for
    css-lm); the LM tolerance is 1e-10 for float64 and 1e-6 for float32,
    as in the JAX package.  ``diagnostics.fun`` is the residual sum of
    squares on the LM path and the negative CSS log likelihood on the AR
    fast path and css-bobyqa, as in the JAX package.

    ``retry`` (a ``utils.resilience.RetryPolicy``) re-solves the lanes
    that did not converge from jittered starts
    (``ops.optimize.solve_with_restarts``): attempt 0 is the plain fit of
    every lane, and each restart one solve over the failing lanes alone,
    gathered (on the card one LM-fit launch each); the per-lane count
    lands in ``diagnostics.attempts``, and ``retry.max_iter`` (when set)
    is the per-attempt budget unless ``max_iter`` overrides it.  The
    jitter comes from a ``torch.Generator`` seeded with ``retry.seed``,
    not the JAX package's per-lane keys, so the same seed restarts from
    other points; ``_restart_draws (R, S, k)`` hands in the draws
    themselves.

    ``stats`` (a dict), when the fit runs the LM solver, receives
    ``lm_fit_launches`` (the LM-fit kernel's launches: one per attempt
    on CUDA, 0 on the CPU) and ``restart_lanes`` (lanes re-solved at
    each restart); on css-cgd ``ne_launches`` (``arma_ne`` launches: one
    per evaluation on CUDA, 0 on the CPU), ``bfgs_calls`` and
    ``restart_lanes``.

    Not ported yet (raises ``NotImplementedError``): ``objective="exact"``
    (ROADMAP Queue A item 4).
    """
    if objective == "exact":
        raise NotImplementedError(
            "objective='exact' (the Kalman-likelihood refine) is not ported "
            "yet (ROADMAP Queue A item 4)")
    if objective != "css":
        raise ValueError(f"unknown objective {objective!r}; expected "
                         f"'css' or 'exact'")
    if method not in ("css-lm", "css-bobyqa", "css-cgd"):
        raise ValueError(f"unknown method {method!r}")
    rk = _resilience.retry_kwargs(retry)
    if max_iter is None and retry is not None and retry.max_iter is not None:
        max_iter = retry.max_iter
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

    lanes = init.shape[:-1]
    x0 = init.reshape(-1, dim)
    y = diffed.reshape(-1, diffed.shape[-1])
    nv_flat = None if nv is None else nv.reshape(-1)

    def gathered(idx):
        """The panel rows (and windows) of lanes ``idx`` (None: all)."""
        if idx is None:
            return y, nv_flat
        return (y.index_select(0, idx),
                None if nv_flat is None else nv_flat.index_select(0, idx))

    solver: dict = {}
    if method == "css-lm":
        mi = max_iter if max_iter is not None else LM_MAX_ITER
        tol = 1e-10 if ts.dtype == torch.float64 else 1e-6

        def solve(xs, idx):
            yy, vv = gathered(idx)
            return fit_css_lm(xs, yy, p, q, icpt, tol=tol, max_iter=mi,
                              n_valid=vv)

        res = _solve_with_policy(solve, x0, rk.get("restarts", 0),
                                 rk.get("restart_scale", 0.25),
                                 rk.get("restart_seed", 0), _restart_draws,
                                 solver)
        if stats is not None:
            stats["lm_fit_launches"] = solver["solves"] if x0.is_cuda else 0
            stats["restart_lanes"] = solver["restart_lanes"]
    else:
        def evaluator_for(idx):
            yy, vv = gathered(idx)
            return lambda x: css_neg_ll_value_and_grad(x, yy, p, q, icpt,
                                                       n_valid=vv)

        mi = max_iter if max_iter is not None else 500
        if method == "css-cgd":
            res = minimize_bfgs(evaluator_for(None), x0, tol=1e-7,
                                max_iter=mi, evaluator_for=evaluator_for,
                                jitter_draws=_restart_draws, stats=solver,
                                **rk)
            if stats is not None:
                stats["ne_launches"] = solver["calls"] if x0.is_cuda else 0
                stats["bfgs_calls"] = solver["calls"]
                stats["restart_lanes"] = solver["restart_lanes"]
        else:
            res = minimize_box(evaluator_for(None), x0, -math.inf, math.inf,
                               tol=1e-10, max_iter=mi,
                               evaluator_for=evaluator_for,
                               jitter_draws=_restart_draws, **rk)
    res = MinimizeResult(
        res.x.reshape(*lanes, dim), res.fun.reshape(lanes),
        res.converged.reshape(lanes), res.n_iter.reshape(lanes),
        None if res.attempts is None else res.attempts.reshape(lanes))

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


def fit_panel(panel, p: int, d: int, q: int, engine=None,
              **kwargs) -> ARIMAModel:
    """Batched fit of a :class:`~spark_timeseries_tpu_torch.panel.Panel`
    on its device through :meth:`FitEngine.fit
    <spark_timeseries_tpu_torch.engine.FitEngine.fit>` (``engine``, or a
    new engine); ``engine=False`` calls :func:`fit` directly.  ``kwargs``
    pass through (``include_intercept``, ``method``, ``max_iter``,
    ``retry``; with ``engine=False`` any :func:`fit` keyword)."""
    warn = kwargs.pop("warn", True)
    if engine is False:
        return fit(p, d, q, panel.values, warn=warn, device=panel.device,
                   **kwargs)
    from ..engine import FitEngine
    eng = engine if engine is not None else FitEngine()
    return eng.fit(panel.values, "arima", device=panel.device, warn=warn,
                   p=p, d=d, q=q, **kwargs)


# ---------------------------------------------------------------------------
# the fail-soft panel fit
# ---------------------------------------------------------------------------

def _poly_roots_batched(coefs: np.ndarray) -> np.ndarray:
    """Roots of each ascending-coefficient polynomial row: ``(S, k+1)`` ->
    complex ``(S, k)``, host float64 numpy.  Rows whose leading
    coefficient is ~0 or that are not finite get NaN roots."""
    coefs = np.asarray(coefs, dtype=np.float64)
    S, k1 = coefs.shape
    k = k1 - 1
    roots = np.full((S, k), np.nan, np.complex128)
    ok = (np.abs(coefs[:, -1]) > 1e-8) & np.all(np.isfinite(coefs), axis=-1)
    if k >= 1 and np.any(ok):
        sub = coefs[ok]
        comp = np.zeros((sub.shape[0], k, k))
        comp[:, k - 1, :] = -sub[:, :k] / sub[:, k:k + 1]
        if k > 1:
            comp[:, :k - 1, 1:] = np.eye(k - 1)
        roots[ok] = np.linalg.eigvals(comp)
    return roots


def _cancellation_suspects(model: ARIMAModel,
                           tol: float = 0.15) -> np.ndarray:
    """Per-lane common-factor cancellation, on the host in float64 as in
    the JAX package: True where some AR root lies within ``tol``
    (relative to the root's magnitude, floor 1) of some MA root.  Such a
    lane is a lower-order ARMA on a flat likelihood ridge, which the
    ``auto_order`` stage refits at a searched lower order."""
    p, q = model.p, model.q
    coefs = model.coefficients.detach().cpu().numpy().astype(np.float64)
    if coefs.ndim == 1:
        coefs = coefs[None]
    S = coefs.shape[0]
    if p == 0 or q == 0:
        return np.zeros(S, bool)
    icpt = model._icpt
    phi = coefs[:, icpt:icpt + p]
    theta = coefs[:, icpt + p:icpt + p + q]
    one = np.ones((S, 1))
    # AR: 1 - φ₁z - ... ; MA: 1 + θ₁z + ...  (ascending coefficients)
    ar = _poly_roots_batched(np.concatenate([one, -phi], axis=1))
    ma = _poly_roots_batched(np.concatenate([one, theta], axis=1))
    dist = np.abs(ar[:, :, None] - ma[:, None, :])          # (S, p, q)
    scale = np.maximum(1.0, np.abs(ar))[:, :, None]
    rel = np.where(np.isfinite(dist), dist / scale, np.inf)
    return np.min(rel.reshape(S, -1), axis=-1) < tol


def _pad_to_order(model: ARIMAModel, p: int, q: int) -> ARIMAModel:
    """A lower-order fit as an ARIMA(p, d, q) model, the absent AR/MA
    slots zero (an AR(p') fit with θ = 0 is an ARIMA(p, d, q) point)."""
    icpt = model._icpt
    coefs = model.coefficients
    lead = coefs.shape[:-1]
    parts = [coefs[..., :icpt + model.p],
             coefs.new_zeros((*lead, p - model.p)),
             coefs[..., icpt + model.p:],
             coefs.new_zeros((*lead, q - model.q))]
    return ARIMAModel(p, model.d, q, torch.cat(parts, dim=-1),
                      model.has_intercept, diagnostics=model.diagnostics)


def _add_launches(stats: Optional[dict], stage: str, n: int) -> None:
    if stats is not None:
        by = stats.setdefault("lm_fit_launches_by_stage", {})
        by[stage] = by.get(stage, 0) + int(n)
        stats["lm_fit_launches"] = stats.get("lm_fit_launches", 0) + int(n)


def _make_auto_order_stage(p: int, d: int, q: int,
                           max_iter: Optional[int],
                           stats: Optional[dict] = None):
    """The ``auto_order`` fallback stage: re-select (p', q') <= (p, q) for
    the gathered failing lanes by :func:`auto_fit_panel` over their
    d-differenced rows (``max_d=0`` pins the primary's d), each winner's
    zero-padded coefficients in the primary ``[c, AR(p), MA(q)]`` slots.
    A lane converges here when the search found an admissible winner
    (finite AIC, carried in ``diagnostics.fun``).  Returns a
    :class:`~spark_timeseries_tpu_torch.utils.resilience.StageResult`
    with the selected (p', d, q') per lane."""

    def stage(v: torch.Tensor):
        diffed = differences_of_order_d(v, d)[..., d:] if d else v
        st: dict = {}
        with warnings.catch_warnings():
            # failing lanes routinely have no admissible candidate or a
            # capped screen: the outcome's status codes report them
            warnings.simplefilter("ignore")
            sel = auto_fit_panel(diffed, max_p=p, max_d=0, max_q=q,
                                 max_iter=max_iter, device=v.device,
                                 stats=st)
        _add_launches(stats, "auto_order", st["lm_fit_launches"])
        coefs = torch.as_tensor(sel.coefficients, dtype=v.dtype,
                                device=v.device)
        conv = np.isfinite(sel.aic) \
            & np.all(np.isfinite(sel.coefficients), axis=-1)
        n_sub = coefs.shape[0]
        diag = FitDiagnostics(
            torch.as_tensor(conv, device=v.device),
            torch.zeros((n_sub,), dtype=torch.int32, device=v.device),
            torch.as_tensor(sel.aic, dtype=v.dtype, device=v.device))
        model = ARIMAModel(p, d, q, coefs, True, diagnostics=diag)
        orders = np.asarray(sel.orders, np.int32).copy()
        orders[:, 1] = d           # the search ran at the primary's d
        return _resilience.StageResult(model, orders)

    return stage


def fit_resilient(ts, p: int, d: int, q: int,
                  include_intercept: bool = True,
                  fallbacks: Sequence[str] = ("ar", "mean"),
                  retry: Optional[_resilience.RetryPolicy] = None,
                  auto_order: bool = False, cancel_tol: float = 0.15,
                  device=None, stats: Optional[dict] = None, **kwargs):
    """Fail-soft batched ARIMA over a panel ``ts (n_series, n)``: health
    masking, multi-start retry and the fallback chain ARIMA(p, d, q) ->
    [``auto_order``] -> ``"ar"`` (AR(p) by the direct OLS, θ = 0) ->
    ``"mean"`` (intercept only, on the d-differenced series), each stage
    on the failing lanes alone, gathered on ``device`` (``None`` means
    CUDA).

    Returns ``(model, outcome)``: an :class:`ARIMAModel` in the full
    (p, d, q) layout whose lanes come from the first stage that converged
    for them, and a :class:`~spark_timeseries_tpu_torch.utils.resilience.
    FitOutcome` with per-series status, health, attempts, fallback index
    and effective ``orders`` (p, d, q).  Unfittable lanes (all-NaN, inf,
    interior gaps, too short) are skipped with NaN parameters instead of
    raising; healthy lanes equal :func:`fit`'s bit for bit.  ``retry``
    defaults to ``RetryPolicy()`` (two restarts).  ``kwargs`` pass
    through to the primary :func:`fit` (``method``, ``max_iter``, ...).

    ``auto_order=True`` inserts the adaptive stage ahead of the fixed
    fallbacks: lanes whose primary fit failed, or converged onto a
    common-factor plateau (an AR root within ``cancel_tol`` of an MA root,
    :func:`_cancellation_suspects`, host float64), are refitted by
    :func:`auto_fit_panel` over (p', q') <= (p, q) at the primary's d,
    and a suspect lane takes the winner only when it is admissible.

    ``stats`` (a dict) receives ``lm_fit_launches`` (the LM-fit kernel's
    launches over every stage on CUDA, 0 on the CPU),
    ``lm_fit_launches_by_stage`` and the primary's ``restart_lanes``."""
    if retry is None:
        retry = _resilience.RetryPolicy()
    dev = resolve_device(device)
    values = as_tensor(ts, dev)
    icpt = 1 if include_intercept else 0
    max_lag = max(p, q)
    # the Hannan-Rissanen floor (the binding one when q > 0), plus d
    min_len = d + max(2 * max_lag + 2 + p + q + icpt, max_lag + 2, 3)
    if stats is not None:
        stats["lm_fit_launches"] = 0

    def primary(v):
        st: dict = {}
        m = fit(p, d, q, v, include_intercept=include_intercept,
                retry=retry, warn=False, device=dev, stats=st, **kwargs)
        _add_launches(stats, "arima", st.get("lm_fit_launches", 0))
        if stats is not None:
            stats["restart_lanes"] = st.get("restart_lanes", [])
        return m

    def static_stage(name, pp, qq):
        def stage(v):
            st: dict = {}
            m = fit(pp, d, qq, v, include_intercept=include_intercept,
                    warn=False, device=dev, stats=st)
            _add_launches(stats, name, st.get("lm_fit_launches", 0))
            return _pad_to_order(m, p, q)
        return stage

    chain = [("arima", primary)]
    suspect_fn = None
    if auto_order:
        if not include_intercept:
            raise ValueError(
                "auto_order=True requires include_intercept=True: the "
                "batched order search always carries an intercept slot, "
                "and its winners must embed into the primary layout")
        if p == 0 and q == 0:
            raise ValueError(
                "auto_order=True needs p > 0 or q > 0: an ARIMA(0,d,0) "
                "primary has no lower order to search")
        chain.append(("auto_order", _make_auto_order_stage(
            p, d, q, kwargs.get("max_iter"), stats)))
        if p > 0 and q > 0:
            suspect_fn = lambda m: _cancellation_suspects(m, cancel_tol)  # noqa: E731
    for fb in fallbacks:
        if fb == "ar" and p > 0 and q > 0:
            chain.append(("ar", static_stage("ar", p, 0)))
        elif fb == "mean":
            chain.append(("mean", static_stage("mean", 0, 0)))
        elif fb != "ar":
            raise ValueError(f"unknown arima fallback {fb!r}; "
                             f"expected 'ar' or 'mean'")
    model, outcome = _resilience.resilient_fit(
        values, chain, min_len=min_len, family="arima",
        suspect_fn=suspect_fn)

    # back-fill the static per-stage orders so outcome.orders is total:
    # auto_order lanes already carry their searched (p', d, q')
    status = np.asarray(outcome.status)
    orders = outcome.orders
    if orders is None:
        orders = np.full((status.shape[0], 3), -1, np.int32)
    static_order = {"arima": (p, d, q), "ar": (p, d, 0), "mean": (0, d, 0)}
    unfilled = orders[:, 0] < 0
    primary_lanes = unfilled & np.isin(
        status, (_resilience.STATUS_OK, _resilience.STATUS_RETRIED,
                 _resilience.STATUS_ABANDONED))
    orders[primary_lanes] = (p, d, q)
    fb_used = np.asarray(outcome.fallback_used)
    for j, (name, _) in enumerate(chain):
        so = static_order.get(name)
        if so is None:
            continue
        mask = unfilled & (status == _resilience.STATUS_FALLBACK) \
            & (fb_used == j)
        orders[mask] = so
    return model, outcome._replace(orders=orders)


# ---------------------------------------------------------------------------
# automatic order selection over a panel (ref ARIMA.scala:280-375, batched)
# ---------------------------------------------------------------------------

KPSS_SIGNIFICANCE = 0.05

# screening budget of auto_fit_panel's candidate grid: selection only needs
# the AICs separated, and each series' winner is then refined at the
# remaining budget on S lanes instead of C·S
SCREEN_MAX_ITER = 25


def _step_down_stationary(phi: torch.Tensor, orders: torch.Tensor
                          ) -> torch.Tensor:
    """Batched stationarity by the Levinson step-down (Schur-Cohn) test:
    the AR polynomial ``1 - φ₁z - ... - φ_p z^p`` has all roots outside
    the unit circle iff every reflection coefficient lies in (-1, 1).

    ``phi (..., max_p)`` padded AR coefficients, ``orders (...)`` each
    lane's actual order (coefficients beyond it are ignored)."""
    max_p = phi.shape[-1]
    ok = torch.ones(torch.broadcast_shapes(phi.shape[:-1], orders.shape),
                    dtype=torch.bool, device=phi.device)
    if max_p == 0:
        return ok
    idx = torch.arange(max_p, device=phi.device)
    a = torch.where(idx < orders[..., None], phi, torch.zeros((),
                                                              dtype=phi.dtype,
                                                              device=phi.device))
    for m in range(max_p, 0, -1):
        k = a[..., m - 1]
        active = orders >= m
        ok = ok & (~active | (torch.abs(k) < 1.0))
        # (1-k)(1+k) instead of 1-k²: near-unit-root lanes keep their
        # leading digits in float32, where the squared form cancels
        denom = (1.0 - k) * (1.0 + k)
        safe = torch.where(torch.abs(denom) < 1e-12,
                           torch.ones((), dtype=a.dtype, device=a.device),
                           denom)
        lower = (a[..., :m - 1] + k[..., None] * a[..., :m - 1].flip(-1)) \
            / safe[..., None]
        a = torch.cat([torch.where(active[..., None], lower, a[..., :m - 1]),
                       torch.zeros_like(a[..., m - 1:])], dim=-1)
    return ok


def find_roots(coefficients: Sequence[float]) -> np.ndarray:
    """Roots of ``c[0] + c[1] x + ... + c[n] x^n`` by companion-matrix
    eigenvalues, host float64 numpy."""
    coefficients = np.asarray(coefficients, dtype=np.float64)
    n = coefficients.shape[-1] - 1
    if n < 1:
        return np.zeros((0,), dtype=np.complex128)
    companion = np.zeros((n, n))
    companion[n - 1, :] = -coefficients[:n] / coefficients[n]
    if n > 1:
        companion[:n - 1, 1:] = np.eye(n - 1)
    return np.linalg.eigvals(companion)


def _choose_d(ts: torch.Tensor, max_d: int) -> int:
    """The lowest differencing order whose KPSS statistic says level
    stationarity (R forecast::ndiffs)."""
    for diff in range(max_d + 1):
        stat, critical_values = kpsstest(differences_of_order_d(ts, diff),
                                         "c")
        if float(stat) < critical_values[KPSS_SIGNIFICANCE]:
            return diff
    raise ValueError(
        f"stationarity not achieved with differencing order <= {max_d}")


def auto_fit(ts, max_p: int = 5, max_d: int = 2, max_q: int = 5,
             device=None) -> ARIMAModel:
    """Hyndman-Khandakar stepwise automatic ARIMA of one series on
    ``device`` (``None`` means CUDA): ``d`` by KPSS, then a local search
    over (p, q, intercept) scored by :meth:`ARIMAModel.approx_aic`, only
    stationary and invertible candidates kept; a candidate whose css-lm
    fit raises or is not finite is fitted again by css-bobyqa.  The
    neighbourhood varies both p and q, as in the JAX package."""
    dev = resolve_device(device)
    ts = as_tensor(ts, dev)
    d = _choose_d(ts, max_d)
    # the search runs on the size-preserving differences (the first d
    # entries raw), as the JAX package's does
    diffed = differences_of_order_d(ts, d)
    add_intercept = d <= 1

    def try_fit(p, q, intercept):
        for method in ("css-lm", "css-bobyqa"):
            try:
                m = fit(p, 0, q, diffed, include_intercept=intercept,
                        method=method, warn=False, device=dev)
                if bool(torch.isfinite(m.coefficients).all()):
                    return m
            except (ValueError, FloatingPointError, np.linalg.LinAlgError,
                    torch.linalg.LinAlgError):
                # this candidate is numerically inadmissible (too short a
                # window, a singular solve); anything else propagates
                continue
        return None

    past = set()
    best_model, best_aic = None, math.inf
    next_params = [(p, q, add_intercept)
                   for p, q in [(0, 0), (2, 2), (1, 0), (0, 1)]]
    while next_params:
        past.update(next_params)
        improving = []
        for m in (try_fit(p, q, i) for p, q, i in next_params):
            if m is None or not (np.all(m.is_stationary())
                                 and np.all(m.is_invertible())):
                continue
            aic = float(m.approx_aic(diffed))
            if math.isfinite(aic) and aic < best_aic:
                improving.append((m, aic))
        if not improving:
            break
        best_model, best_aic = min(improving, key=lambda t: t[1])
        surrounding = []
        for dp in (-1, 0, 1):
            for dq in (-1, 0, 1):
                intercept = (not best_model.has_intercept) \
                    if (dp == 0 and dq == 0) else best_model.has_intercept
                surrounding.append(
                    (best_model.p + dp, best_model.q + dq, intercept))
        next_params = [c for c in surrounding
                       if c not in past and 0 <= c[0] <= max_p
                       and 0 <= c[1] <= max_q]

    if best_model is None:
        raise ValueError("auto_fit failed to fit any admissible ARMA model")
    return ARIMAModel(best_model.p, d, best_model.q,
                      best_model.coefficients, best_model.has_intercept,
                      diagnostics=best_model.diagnostics)


class _PanelARIMAFields(NamedTuple):
    orders: np.ndarray
    coefficients: np.ndarray
    aic: np.ndarray
    max_p: int


class PanelARIMAFit(_PanelARIMAFields):
    """Per-series automatic order selection over a panel, the JAX
    package's four fields: ``orders (n_series, 3)`` holds (p, d, q);
    ``coefficients (n_series, 1 + max_p + max_q)`` float64, zero-padded
    — slot 0 the intercept (zero when that series' ``d > 1``), slots
    ``1..max_p`` the AR terms, then the MA terms; ``aic (n_series,)``.

    The attribute ``device``, off the tuple, is where :meth:`model_for`
    puts a model (float32 on CUDA, float64 on the CPU): the fit's device
    when :func:`auto_fit_panel` made it (``_replace`` carries it over;
    ``_make`` has no fit to take it from), else CUDA."""
    device = torch.device("cuda")

    def _replace(self, **kwargs) -> "PanelARIMAFit":
        fit = super()._replace(**kwargs)
        fit.device = self.device
        return fit

    def model_for(self, i: int) -> ARIMAModel:
        """Series ``i``'s fit as a standalone model."""
        p, d, q = (int(v) for v in self.orders[i])
        icpt = d <= 1
        coefs = []
        if icpt:
            coefs.append(self.coefficients[i, :1])
        coefs.append(self.coefficients[i, 1:1 + p])
        coefs.append(self.coefficients[i, 1 + self.max_p:1 + self.max_p + q])
        dtype = torch.float32 if self.device.type == "cuda" \
            else torch.float64
        return ARIMAModel(p, d, q, torch.as_tensor(
            np.concatenate(coefs), dtype=dtype, device=self.device), icpt)


def _auto_fit_panel_kernel(values: torch.Tensor, masks_base: torch.Tensor,
                           pq: Sequence[Tuple[int, int]], crit: float,
                           max_p: int, max_q: int, max_d: int,
                           max_iter: int, screen_iter: int,
                           n_valid: Optional[torch.Tensor] = None):
    """The whole batched search on ``values (S, n)``'s device: KPSS
    d-selection over the stack of size-preserving differences (the
    per-series d a gather index), the per-series intercept mask, the
    Hannan-Rissanen init of the padded ``[c, AR(max_p), MA(max_q)]``
    parameterization (shared normal equations, one masked SPD solve per
    candidate), the masked LM SCREEN of every (candidate, series) lane at
    ``screen_iter`` iterations, the admissibility screen (step-down
    stationarity and invertibility) and AIC argmin, then the REFINE of
    each series' winner at the remaining budget, kept only while finite
    and admissible.  Each LM stage is one ``ops.arma_ne.fit_css_lm``
    call over ``x0 (C·S, k)`` and the unrepeated panel: on CUDA the screen
    is one LM-fit kernel launch per candidate at its own order (its
    ``grid_orders`` are ``pq``), the refine one padded launch.

    ``masks_base (C, k)`` sets slot 0 (intercept) for every candidate;
    it is zeroed per series whose d > 1.  ``pq`` is the host list of the
    C candidates' ``(p, q)``.  ``n_valid (S,)`` restricts each lane to its
    left-aligned valid window.  Returns ``(orders (S, 3), coefs (S, k),
    aic (S,), d_ok (S,), screen_capped (S,), lm_launches)``, the last
    the LM-fit kernel launches the stages make on CUDA (C + 1 with a
    refine)."""
    dtype = values.dtype
    dev = values.device
    S, n = values.shape
    k = 1 + max_p + max_q
    C = masks_base.shape[0]
    grid_orders = pq            # the screen's launches read the host list
    pq = torch.as_tensor(pq, dtype=torch.int32, device=dev)

    diffs = torch.stack([differences_of_order_d(values, dd)
                         for dd in range(max_d + 1)])          # (D, S, n)
    # n_valid is d-invariant: the size-preserving diff keeps the first d
    # entries raw, so every lane's window length survives differencing
    stats = torch.stack([kpsstest(diffs[dd], "c", n_valid=n_valid)[0]
                         for dd in range(max_d + 1)])          # (D, S)
    passes = stats < crit
    d_ok = passes.any(dim=0)
    d_per = torch.argmax(passes.to(torch.uint8), dim=0)        # (S,)
    diffed = torch.take_along_dim(diffs, d_per[None, :, None],
                                  dim=0)[0]                    # (S, n)
    icpt = d_per <= 1

    one = torch.ones((), dtype=dtype, device=dev)
    masks = masks_base[:, None, :].expand(C, S, k) * torch.where(
        (torch.arange(k, device=dev) == 0)[None, None, :],
        icpt.to(dtype)[None, :, None], one)                    # (C, S, k)

    # Hannan-Rissanen on the padded orders, m = max(max_p, max_q) + 1
    # shared by every candidate: AR(m) errors, then one masked OLS per
    # candidate from shared normal equations
    m = max(max_p, max_q) + 1
    mx = max(max_p, max_q)
    ar = autoregression.fit(diffed, m, n_valid=n_valid)
    est = lag_matvec(diffed, ar.coefficients, m) + ar.c[..., None]
    y_trunc = diffed[..., m:]
    errors = y_trunc - est
    n_rows = y_trunc.shape[-1] - mx
    Xs = torch.cat([values.new_ones((S, 1, n_rows)),
                    _lag_stack_or_empty(y_trunc, max_p)[..., -n_rows:],
                    _lag_stack_or_empty(errors, max_q)[..., -n_rows:]],
                   dim=-2)
    target = y_trunc[..., mx:]
    Xs_w = Xs
    if n_valid is not None:
        # rows whose target index falls past the valid window weigh 0
        w_hr = step_weights(n_rows, n_valid[..., None], offset=m + mx,
                            dtype=dtype)                       # (S, n_rows)
        Xs_w = Xs * w_hr[:, None, :]
    N = torch.einsum("skn,sln->skl", Xs_w, Xs)                 # (S, k, k)
    b = torch.einsum("skn,sn->sk", Xs_w, target)
    # (M N M + (I - M)) β = M b: SPD, so the unrolled Cholesky applies
    Mn = masks[..., :, None] * N[None] * masks[..., None, :]
    ident = torch.eye(k, dtype=dtype, device=dev) \
        * (1.0 - masks)[..., :, None]
    init = spd_solve(Mn + ident, masks * b[None])              # (C, S, k)
    del Mn, ident

    tol = 1e-10 if dtype == torch.float64 else 1e-6
    lm_launches = 0

    def grid_lm(x0, mask, iters, orders=None):
        nonlocal lm_launches
        lm_launches += 1 if orders is None else len(orders)
        lead = x0.shape[:-1]
        x, f, conv, n_it = fit_css_lm(
            x0.reshape(-1, k), diffed, max_p, max_q, 1, tol=tol,
            max_iter=iters, mask=mask.reshape(-1, k), n_valid=n_valid,
            grid_orders=orders)
        return MinimizeResult(x.reshape(*lead, k), f.reshape(lead),
                              conv.reshape(lead), n_it.reshape(lead))

    res = grid_lm(init, masks, screen_iter, grid_orders)
    lane_ok = torch.isfinite(res.x).all(dim=-1, keepdim=True)
    params = torch.where(lane_ok, res.x, init) * masks

    # CSS likelihood in closed form from the LM's own objective
    n_eff = float(n) if n_valid is None \
        else torch.clamp(n_valid.to(dtype), min=1.0)           # (S,)
    neg_ll = 0.5 * n_eff * (torch.log(2.0 * math.pi * res.fun / n_eff)
                            + 1.0)
    n_params = (pq[:, 0] + pq[:, 1])[:, None] \
        + icpt[None, :].to(pq.dtype)                           # (C, S)
    aic = 2.0 * neg_ll + 2.0 * n_params.to(dtype)
    ok = torch.isfinite(params).all(dim=-1) & torch.isfinite(aic)
    ok &= n_params > 0                           # empty candidate: no terms
    ok &= _step_down_stationary(params[..., 1:1 + max_p], pq[:, :1])
    # MA invertibility: the same criterion applied to -θ
    ok &= _step_down_stationary(-params[..., 1 + max_p:], pq[:, 1:])
    inf = torch.full((), math.inf, dtype=dtype, device=dev)
    aic = torch.where(ok, aic, inf)

    best = torch.argmin(aic, dim=0)                            # (S,)
    sel = torch.arange(S, device=dev)
    chosen_aic = aic[best, sel]
    failed = ~torch.isfinite(chosen_aic)
    # winners whose screen stage hit the reduced iteration cap
    screen_capped = (~res.converged)[best, sel] & ~failed
    zero = torch.zeros((), dtype=dtype, device=dev)
    coefs = torch.where(failed[:, None], zero, params[best, sel])
    izero = torch.zeros((), dtype=pq.dtype, device=dev)
    orders = torch.stack([torch.where(failed, izero, pq[best, 0]),
                          d_per.to(pq.dtype),
                          torch.where(failed, izero, pq[best, 1])], dim=-1)

    refine_iter = max_iter - screen_iter
    if refine_iter > 0:
        best_masks = masks[best, sel]                          # (S, k)
        res_r = grid_lm(coefs, best_masks, refine_iter)
        refined = res_r.x * best_masks
        keep = torch.isfinite(refined).all(dim=-1)
        keep &= _step_down_stationary(refined[:, 1:1 + max_p], orders[:, 0])
        keep &= _step_down_stationary(-refined[:, 1 + max_p:], orders[:, 2])
        keep &= ~failed
        neg_ll_r = 0.5 * n_eff * (
            torch.log(2.0 * math.pi * res_r.fun / n_eff) + 1.0)
        aic_r = 2.0 * neg_ll_r + 2.0 * (
            orders[:, 0] + orders[:, 2] + icpt.to(pq.dtype)).to(dtype)
        keep &= torch.isfinite(aic_r)
        coefs = torch.where(keep[:, None], refined, coefs)
        chosen_aic = torch.where(keep, aic_r, chosen_aic)
    return orders, coefs, chosen_aic, d_ok, screen_capped, lm_launches


def auto_fit_panel(values, max_p: int = 5, max_d: int = 2, max_q: int = 5,
                   max_iter: Optional[int] = None,
                   screen_max_iter: Optional[int] = None, device=None,
                   stats: Optional[dict] = None) -> PanelARIMAFit:
    """Batched automatic ARIMA over a panel ``values (n_series, n)``
    (array-like or tensor): the whole (p, q) candidate grid over padded
    ``[c, AR(max_p), MA(max_q)]`` parameters (inactive slots masked) is
    fitted for all series at once, non-stationary, non-invertible and
    non-finite fits get +inf AIC, and each series takes its argmin.  d is
    chosen per series by batched KPSS (the lowest order whose statistic
    is under the 5 % critical value).

    ``max_iter`` (default :data:`LM_MAX_ITER`) is the per-lane LM budget
    of screen plus refine; ``screen_max_iter`` (default
    :data:`SCREEN_MAX_ITER`) bounds the grid screen, and each series'
    winner is then refined at the rest.  Every candidate's CSS drops the
    common ``t < max(max_p, max_q)`` window, so AICs compare on one
    sample.

    Runs on ``device`` (``None`` means CUDA, float32, where the screen
    is one LM-fit kernel launch per candidate at its own order and the
    refine one launch, both over the unrepeated panel; ``device="cpu"``
    runs the plain LM, float32 or float64).
    NaN-padded panels fit each lane's valid window; lanes too short for
    the grid get NaN coefficients, +inf aic and orders (0, 0, 0).  A
    series whose d cannot be chosen raises ``ValueError`` (unless
    ``max_d == 0``).  ``stats`` (a dict) receives ``lm_fit_launches`` (C
    + 1 on CUDA with C candidates, C when the screen has the whole
    budget; 0 on the CPU) and ``screen_capped`` (the share of winners
    whose screen hit its cap).  Returns a :class:`PanelARIMAFit` of
    numpy arrays, as the JAX package's."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        check_kernel_order(max_p, max_q, 1)
    values = as_tensor(values, dev)
    values, obs_len = ragged_view(values)
    if max_iter is None:
        max_iter = LM_MAX_ITER
    screen_iter = min(SCREEN_MAX_ITER if screen_max_iter is None
                      else screen_max_iter, max_iter)

    width = 1 + max_p + max_q
    pq = [(p, q) for p in range(max_p + 1) for q in range(max_q + 1)]
    masks = np.zeros((len(pq), width))
    masks[:, 0] = 1.0        # zeroed per series when its d > 1
    for ci, (p, q) in enumerate(pq):
        masks[ci, 1:1 + p] = 1.0
        masks[ci, 1 + max_p:1 + max_p + q] = 1.0

    crit = KPSS_CONSTANT_CRITICAL_VALUES[KPSS_SIGNIFICANCE]
    # lanes whose window cannot hold the padded-order HR init quarantine
    # rather than poison the panel or raise
    short = None
    if obs_len is not None:
        mx = max(max_p, max_q)
        short = short_lanes(obs_len, 2 * mx + 3 + max_p + max_q,
                            f"auto_fit_panel (max_p={max_p}, max_q={max_q})"
                            f" Hannan-Rissanen initialization")
    orders, coefs, aic, d_ok, screen_capped, lm_launches = \
        _auto_fit_panel_kernel(
            values, torch.as_tensor(masks, dtype=values.dtype, device=dev),
            pq, crit, max_p, max_q, max_d, max_iter, screen_iter, obs_len)

    short_np = None if short is None else short.cpu().numpy()
    capped = screen_capped.cpu().numpy()
    if short_np is not None:
        capped = capped[~short_np]
    capped_frac = float(np.mean(capped)) if capped.size else 0.0
    if stats is not None:
        stats["lm_fit_launches"] = lm_launches if dev.type == "cuda" else 0
        stats["screen_capped"] = capped_frac
    # the reduced screen budget can change order selection on
    # slow-converging panels; say so when it plausibly did
    if screen_iter < max_iter and capped_frac > 0.5:
        warnings.warn(
            f"auto_fit_panel: {capped_frac:.0%} of winning lanes hit the "
            f"screen-stage iteration cap ({screen_iter}); order selection "
            f"may differ from a full-budget grid — pass "
            f"screen_max_iter=max_iter to restore one", stacklevel=2)

    d_ok = d_ok.cpu().numpy()
    if short_np is not None:
        d_ok = d_ok | short_np      # short lanes quarantine, never raise
    if not d_ok.all() and max_d > 0:
        # max_d == 0 pins d: a KPSS rejection is then a finite-sample
        # false positive on an already-differenced series, not a failure
        raise ValueError(
            f"stationarity not achieved with differencing order <= {max_d} "
            f"for {int(np.sum(~d_ok))} series")

    out_aic = aic.cpu().numpy()
    out_orders = orders.cpu().numpy().astype(np.int64)
    out_coefs = coefs.cpu().numpy().astype(np.float64)
    if short_np is not None and short_np.any():
        out_aic = np.where(short_np, np.inf, out_aic)
        out_coefs = np.where(short_np[:, None], np.nan, out_coefs)
        out_orders = np.where(short_np[:, None], 0, out_orders)
    n_failed = int(np.sum(~np.isfinite(out_aic))
                   - (short_np.sum() if short_np is not None else 0))
    if n_failed:
        warnings.warn(
            f"auto_fit_panel: no admissible ARMA candidate for {n_failed} "
            f"series; their aic is +inf and coefficients are zero",
            stacklevel=2)
    fit = PanelARIMAFit(out_orders, out_coefs, out_aic, max_p)
    fit.device = dev
    return fit
