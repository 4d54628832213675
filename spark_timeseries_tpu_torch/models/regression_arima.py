"""Regression with AR(1) errors by Cochrane-Orcutt, batched (counterpart
of ``spark_timeseries_tpu/models/regression_arima.py``):
``Y_t = B·X_t + e_t`` with ``e_t = rho·e_{t-1} + w_t``, the iteration
driven by a Durbin-Watson autocorrelation check, a rho-convergence
threshold of 0.001 and an iteration cap, per lane.

The JAX package runs the whole iteration as one ``lax.while_loop``;
here it is a host-driven loop of at most ``max_iter`` rounds over the
whole panel (each round one batched Householder OLS), finished lanes
frozen, which reads the device once a round for its exit test.  The
fail-soft :func:`fit_resilient` falls back to the plain OLS with
rho = 0."""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from .._device import as_tensor, resolve_device
from ..ops.linalg import ols
from ..stats import dwtest
from ..utils import resilience as _resilience
from .base import FitDiagnostics, normal_quantile

DW_MARGIN = 0.05
RHO_DIFF_THRESHOLD = 0.001


def _design(y: torch.Tensor, X) -> torch.Tensor:
    """``X`` on ``y``'s device and dtype; a shared unbatched ``(n, k)``
    design broadcasts over ``y``'s batch (one rule for the fit and the
    forecast surfaces)."""
    X = torch.as_tensor(X, dtype=y.dtype, device=y.device)
    if y.ndim > 1 and X.ndim == 2:
        X = X.expand(*y.shape[:-1], *X.shape)
    return X


def _is_autocorrelated(residuals: torch.Tensor) -> torch.Tensor:
    """Durbin-Watson statistic outside 2 ± 0.05."""
    dw = dwtest(residuals)
    return (dw <= 2.0 - DW_MARGIN) | (dw >= 2.0 + DW_MARGIN)


class RegressionARIMAModel(NamedTuple):
    """``regression_coeff`` holds the intercept then the k regressor
    coefficients; ``arima_orders`` is (p, d, q) = (1, 0, 0);
    ``arima_coeff`` the AR(1) rho."""
    regression_coeff: torch.Tensor
    arima_orders: Tuple[int, int, int]
    arima_coeff: torch.Tensor
    diagnostics: Optional[FitDiagnostics] = None

    def add_time_dependent_effects(self, ts):
        raise NotImplementedError(
            "unsupported in the reference too (RegressionARIMA.scala:186-191)")

    def remove_time_dependent_effects(self, ts):
        raise NotImplementedError(
            "unsupported in the reference too (RegressionARIMA.scala:193-198)")

    def _like(self, x) -> torch.Tensor:
        c = self.regression_coeff
        return torch.as_tensor(x, dtype=c.dtype, device=c.device)

    def _residuals(self, ts: torch.Tensor, X: torch.Tensor) -> torch.Tensor:
        beta = self.regression_coeff
        return ts - (torch.einsum("...nk,...k->...n", X, beta[..., 1:])
                     + beta[..., :1])

    def _point_from_resid(self, resid: torch.Tensor,
                          Xf: torch.Tensor) -> torch.Tensor:
        """``x_{n+h}'β + ρ^h e_n``, the powers of ρ as a cumulative
        product (ρ may be negative)."""
        beta = self.regression_coeff
        rho = self.arima_coeff
        H = Xf.shape[-2]
        decay = torch.cumprod(rho[..., None].expand(*rho.shape, H), dim=-1)
        reg_part = torch.einsum("...hk,...k->...h", Xf, beta[..., 1:]) \
            + beta[..., :1]
        return reg_part + decay * resid[..., -1][..., None]

    def forecast(self, ts, regressors, future_regressors) -> torch.Tensor:
        """GLS point forecasts under the fitted AR(1) error,
        ``y_{n+h} = x_{n+h}'β + ρ^h e_n``: ``future_regressors (..., H,
        k)`` -> ``(..., H)``; a shared unbatched design broadcasts over
        the batch as in the fit."""
        ts = self._like(ts)
        X = _design(ts, regressors)
        Xf = _design(ts, future_regressors)
        return self._point_from_resid(self._residuals(ts, X), Xf)

    def forecast_interval(self, ts, regressors, future_regressors,
                          conf: float = 0.95):
        """Bands for :meth:`forecast`: the AR(1)-error forecast variance
        ``σ_u² Σ_{j<h} ρ^{2j}``, ``σ_u²`` from ``u_t = e_t - ρ e_{t-1}``
        (regression coefficients treated as known).  Returns ``(point,
        lower, upper)``, each ``(..., H)``."""
        ts = self._like(ts)
        X = _design(ts, regressors)
        Xf = _design(ts, future_regressors)
        rho = self.arima_coeff
        resid = self._residuals(ts, X)
        point = self._point_from_resid(resid, Xf)
        u = resid[..., 1:] - rho[..., None] * resid[..., :-1]
        sigma_u2 = (u * u).mean(dim=-1)
        j = torch.arange(point.shape[-1], dtype=ts.dtype, device=ts.device)
        var_h = sigma_u2[..., None] \
            * torch.cumsum((rho * rho)[..., None] ** j, dim=-1)
        half = normal_quantile(conf, ts.dtype).to(ts.device) \
            * torch.sqrt(var_h)
        return point, point - half, point + half


def fit(ts, regressors, method: str, *optimization_args,
        device=None) -> RegressionARIMAModel:
    """Method dispatch: ``"cochrane-orcutt"`` with an optional
    max-iteration argument."""
    if method != "cochrane-orcutt":
        raise NotImplementedError(
            f'Regression ARIMA method "{method}" not defined.')
    if not optimization_args:
        return fit_cochrane_orcutt(ts, regressors, device=device)
    if not isinstance(optimization_args[0], int):
        raise ValueError(
            "Maximum iteration parameter to Cochrane-Orcutt must be integer")
    if len(optimization_args) > 1:
        raise ValueError(
            "Cochrane-Orcutt accepts at most one optimization argument "
            "(max_iter)")
    return fit_cochrane_orcutt(ts, regressors, optimization_args[0],
                               device=device)


def fit_cochrane_orcutt(ts, regressors, max_iter: int = 10, device=None,
                        stats: Optional[dict] = None
                        ) -> RegressionARIMAModel:
    """Iterative Cochrane-Orcutt on ``device`` (``None`` means CUDA):
    ``ts (..., n)``, ``regressors (..., n, k)`` (a shared unbatched
    ``(n, k)`` design broadcasts over the batch).  Every round solves
    one batched OLS; the stopping rules (no residual autocorrelation by
    Durbin-Watson, rho converged, ``max_iter``) are per lane.
    ``diagnostics``: ``converged`` the lanes that stopped by a rule,
    ``n_iter`` the rounds each lane ran, ``fun`` its residual sum of
    squares.  ``stats`` (a dict) receives ``co_rounds``, the rounds the
    loop ran."""
    dev = resolve_device(device)
    y = as_tensor(ts, dev)
    X = torch.as_tensor(regressors, dtype=y.dtype, device=dev)
    if X.shape[-2] != y.shape[-1]:
        raise ValueError(
            f"regressors have {X.shape[-2]} rows which is not equal to time "
            f"series length {y.shape[-1]}")
    X = _design(y, X)
    beta, resid, rho, finished, n_done, rounds = _co_loop(y, X, max_iter)
    if stats is not None:
        stats["co_rounds"] = rounds
    diag = FitDiagnostics(finished, n_done, (resid * resid).sum(dim=-1))
    return RegressionARIMAModel(beta, (1, 0, 0), rho, diagnostics=diag)


def _co_loop(y: torch.Tensor, X: torch.Tensor, max_iter: int):
    """The Cochrane-Orcutt iteration: the initial OLS, then per round
    [rho re-estimate -> transformed OLS -> residuals of the original
    regression -> stopping rules], finished lanes frozen, until every
    lane is finished or ``max_iter`` rounds ran.  Returns ``(beta, resid,
    rho, finished, n_done, rounds)``."""
    res = ols(X, y, add_intercept=True)
    beta, resid = res.beta, res.residuals
    finished = ~_is_autocorrelated(resid)
    rho = y.new_zeros(y.shape[:-1])
    n_done = torch.zeros(y.shape[:-1], dtype=torch.int32, device=y.device)
    it = 0
    while it < max_iter and not bool(finished.all()):
        n_done = n_done + (~finished).to(torch.int32)
        # rho from e_t = rho·e_{t-1} (no-intercept simple regression)
        e_prev, e_cur = resid[..., :-1], resid[..., 1:]
        rho_new = (e_prev * e_cur).sum(dim=-1) \
            / (e_prev * e_prev).sum(dim=-1)
        # the transformed regression Y'_t = Y_t - rho·Y_{t-1}, X' likewise
        y_dash = y[..., 1:] - rho_new[..., None] * y[..., :-1]
        x_dash = X[..., 1:, :] - rho_new[..., None, None] * X[..., :-1, :]
        tres = ols(x_dash, y_dash, add_intercept=True)
        beta_new = torch.cat([(tres.beta[..., 0] / (1.0 - rho_new))[..., None],
                              tres.beta[..., 1:]], dim=-1)
        # residuals of the original regression under the new coefficients
        yhat = torch.einsum("...nk,...k->...n", X, beta_new[..., 1:]) \
            + beta_new[..., :1]
        resid_new = y - yhat
        # the stopping rules on the round just run
        still_ar = _is_autocorrelated(tres.residuals)
        rhos_converged = torch.abs(rho_new - rho) <= RHO_DIFF_THRESHOLD
        if it < 1:
            rhos_converged = torch.zeros_like(rhos_converged)
        now_finished = ~still_ar | rhos_converged
        upd = ~finished
        beta = torch.where(upd[..., None], beta_new, beta)
        resid = torch.where(upd[..., None], resid_new, resid)
        rho = torch.where(upd, rho_new, rho)
        finished = finished | now_finished
        it += 1
    return beta, resid, rho, finished, n_done, it


def fit_panel(panel, regressors, max_iter: int = 10
              ) -> RegressionARIMAModel:
    """Batched Cochrane-Orcutt over a Panel, on its device, against a
    shared regressor design."""
    return fit_cochrane_orcutt(panel.values, regressors, max_iter,
                               device=panel.device)


def _plain_ols_model(v: torch.Tensor, X) -> RegressionARIMAModel:
    """Terminal fallback: the plain OLS regression with rho = 0."""
    Xb = _design(v, X)
    res = ols(Xb, v, add_intercept=True)
    ok = torch.isfinite(res.beta).all(dim=-1)
    diag = FitDiagnostics(ok, torch.zeros(ok.shape, dtype=torch.int32,
                                          device=v.device),
                          (res.residuals * res.residuals).sum(dim=-1))
    return RegressionARIMAModel(res.beta, (1, 0, 0),
                                v.new_zeros(v.shape[:-1]), diagnostics=diag)


def fit_resilient(ts, regressors, max_iter: int = 10, retry=None,
                  device=None):
    """Fail-soft batched Cochrane-Orcutt on ``device`` (``None`` means
    CUDA): the iterative fit -> the plain OLS with rho = 0 for lanes whose
    iteration never settled.  ``ts (n_series, n)``; ``regressors`` must
    be a shared unbatched ``(n, k)`` design.  ``retry`` is taken for a
    uniform interface and unused (the iteration has its own stopping
    rules).  Returns ``(model, FitOutcome)``."""
    del retry
    dev = resolve_device(device)
    values = as_tensor(ts, dev)
    X = torch.as_tensor(regressors, dtype=values.dtype, device=dev)
    if X.ndim != 2:
        raise ValueError(
            "fit_resilient needs a shared unbatched (n, k) design; got "
            f"regressors shape {tuple(X.shape)}")
    chain = [
        ("cochrane_orcutt",
         lambda v: fit_cochrane_orcutt(v, X, max_iter, device=dev)),
        ("ols", lambda v: _plain_ols_model(v, X)),
    ]
    return _resilience.resilient_fit(values, chain, min_len=X.shape[-1] + 3,
                                     family="regression_arima")
