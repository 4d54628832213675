"""Carrying fitted parameters into the port: numpy arrays (for example the
fields of a JAX-package model, read with ``np.asarray``) become the
port's model NamedTuples on a device, so both packages can forecast and
score from identical coefficients; a retry policy and a resilient fit's
outcome cross as their fields."""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from .._device import as_tensor, resolve_device
from ..utils.resilience import FitOutcome, RetryPolicy
from .arima import ARIMAModel, PanelARIMAFit
from .arimax import ARIMAXModel
from .autoregression import ARModel
from .autoregression_x import ARXModel
from .base import FitDiagnostics
from .ewma import EWMAModel
from .garch import ARGARCHModel, EGARCHModel, GARCHModel
from .holt_winters import HoltWintersModel
from .regression_arima import RegressionARIMAModel


def _diagnostics(diagnostics: Optional[Sequence], device
                 ) -> Optional[FitDiagnostics]:
    """``(converged, n_iter, fun[, attempts])`` arrays ->
    :class:`FitDiagnostics` (``attempts`` None stays None)."""
    if diagnostics is None:
        return None
    converged, n_iter, fun = diagnostics[:3]
    attempts = diagnostics[3] if len(diagnostics) > 3 else None
    return FitDiagnostics(
        torch.as_tensor(converged, dtype=torch.bool, device=device),
        torch.as_tensor(n_iter, dtype=torch.int32, device=device),
        as_tensor(fun, device),
        None if attempts is None
        else torch.as_tensor(attempts, dtype=torch.int32, device=device))


def arima_from_numpy(p: int, d: int, q: int, coefficients,
                     has_intercept: bool = True,
                     diagnostics: Optional[Sequence] = None,
                     device=None) -> ARIMAModel:
    """The port's :class:`ARIMAModel` from numpy coefficients
    ``(..., icpt+p+q)`` and optional ``(converged, n_iter, fun)``."""
    dev = resolve_device(device)
    coefs = as_tensor(coefficients, dev)
    k = (1 if has_intercept else 0) + p + q
    if coefs.shape[-1] != k:
        raise ValueError(f"ARIMA({p},{d},{q}) with has_intercept="
                         f"{has_intercept} has {k} coefficients, got "
                         f"{coefs.shape[-1]}")
    return ARIMAModel(int(p), int(d), int(q), coefs, bool(has_intercept),
                      _diagnostics(diagnostics, dev))


def panel_arima_fit_from_numpy(orders, coefficients, aic, max_p: int,
                               device=None) -> PanelARIMAFit:
    """The port's :class:`PanelARIMAFit` from an auto-fit's numpy
    ``orders (n_series, 3)``, ``coefficients (n_series, 1 + max_p +
    max_q)`` and ``aic (n_series,)`` (the JAX package's layout);
    :meth:`~PanelARIMAFit.model_for` then builds models on ``device``."""
    orders = np.asarray(orders, dtype=np.int64)
    coefficients = np.asarray(coefficients, dtype=np.float64)
    aic = np.asarray(aic)
    if orders.ndim != 2 or orders.shape[1] != 3 \
            or coefficients.shape[0] != orders.shape[0] \
            or aic.shape != orders.shape[:1] \
            or coefficients.shape[1] <= max_p:
        raise ValueError(
            f"expected orders (n, 3), coefficients (n, 1 + max_p + max_q) "
            f"and aic (n,); got {orders.shape}, {coefficients.shape}, "
            f"{aic.shape} with max_p={max_p}")
    fit = PanelARIMAFit(orders, coefficients, aic, int(max_p))
    fit.device = resolve_device(device)
    return fit


def autoregression_from_numpy(c, coefficients,
                              diagnostics: Optional[Sequence] = None,
                              device=None) -> ARModel:
    """The port's :class:`ARModel` from numpy ``c (...)`` and
    ``coefficients (..., p)``."""
    dev = resolve_device(device)
    return ARModel(as_tensor(c, dev), as_tensor(coefficients, dev),
                   _diagnostics(diagnostics, dev))


def holt_winters_from_numpy(model_type: str, period: int, alpha, beta,
                            gamma, diagnostics: Optional[Sequence] = None,
                            device=None) -> HoltWintersModel:
    """The port's :class:`HoltWintersModel` from numpy ``alpha``, ``beta``
    and ``gamma`` (scalars or ``(n_series,)``)."""
    dev = resolve_device(device)
    return HoltWintersModel(str(model_type), int(period),
                            as_tensor(alpha, dev), as_tensor(beta, dev),
                            as_tensor(gamma, dev),
                            _diagnostics(diagnostics, dev))


def ewma_from_numpy(smoothing, diagnostics: Optional[Sequence] = None,
                    device=None) -> EWMAModel:
    """The port's :class:`EWMAModel` from numpy ``smoothing`` (a scalar
    or ``(n_series,)``)."""
    dev = resolve_device(device)
    return EWMAModel(as_tensor(smoothing, dev), _diagnostics(diagnostics,
                                                             dev))


def garch_from_numpy(omega, alpha, beta,
                     diagnostics: Optional[Sequence] = None,
                     device=None) -> GARCHModel:
    """The port's :class:`GARCHModel` from numpy ``omega``, ``alpha`` and
    ``beta`` (scalars or ``(n_series,)``)."""
    dev = resolve_device(device)
    return GARCHModel(as_tensor(omega, dev), as_tensor(alpha, dev),
                      as_tensor(beta, dev), _diagnostics(diagnostics, dev))


def ar_garch_from_numpy(c, phi, omega, alpha, beta,
                        diagnostics: Optional[Sequence] = None,
                        device=None) -> ARGARCHModel:
    """The port's :class:`ARGARCHModel` from numpy ``c``, ``phi``,
    ``omega``, ``alpha`` and ``beta``."""
    dev = resolve_device(device)
    return ARGARCHModel(*(as_tensor(v, dev)
                          for v in (c, phi, omega, alpha, beta)),
                        diagnostics=_diagnostics(diagnostics, dev))


def egarch_from_numpy(omega, alpha, beta, gamma=0.0,
                      diagnostics: Optional[Sequence] = None,
                      device=None) -> EGARCHModel:
    """The port's :class:`EGARCHModel` from numpy ``omega``, ``alpha``,
    ``beta`` and ``gamma``."""
    dev = resolve_device(device)
    omega = as_tensor(omega, dev)
    return EGARCHModel(omega, as_tensor(alpha, dev), as_tensor(beta, dev),
                       torch.as_tensor(gamma, dtype=omega.dtype, device=dev),
                       diagnostics=_diagnostics(diagnostics, dev))


def arx_from_numpy(c, coefficients, y_max_lag: int, x_max_lag: int,
                   includes_original_x: bool = True,
                   diagnostics: Optional[Sequence] = None,
                   device=None) -> ARXModel:
    """The port's :class:`ARXModel` from numpy ``c (...)`` and
    ``coefficients (..., y_max_lag + k·x_max_lag [+ k])``."""
    dev = resolve_device(device)
    return ARXModel(as_tensor(c, dev), as_tensor(coefficients, dev),
                    int(y_max_lag), int(x_max_lag), bool(includes_original_x),
                    _diagnostics(diagnostics, dev))


def arimax_from_numpy(p: int, d: int, q: int, xreg_max_lag: int,
                      coefficients, include_original_xreg: bool = True,
                      has_intercept: bool = True,
                      diagnostics: Optional[Sequence] = None,
                      device=None) -> ARIMAXModel:
    """The port's :class:`ARIMAXModel` from numpy coefficients ``(...,
    1 + p + q + n_xreg)`` (the intercept slot always present)."""
    dev = resolve_device(device)
    return ARIMAXModel(int(p), int(d), int(q), int(xreg_max_lag),
                       as_tensor(coefficients, dev),
                       bool(include_original_xreg), bool(has_intercept),
                       _diagnostics(diagnostics, dev))


def regression_arima_from_numpy(regression_coeff, arima_coeff,
                                diagnostics: Optional[Sequence] = None,
                                device=None) -> RegressionARIMAModel:
    """The port's :class:`RegressionARIMAModel` from numpy
    ``regression_coeff (..., 1 + k)`` and ``arima_coeff (...)`` (rho)."""
    dev = resolve_device(device)
    return RegressionARIMAModel(as_tensor(regression_coeff, dev), (1, 0, 0),
                                as_tensor(arima_coeff, dev),
                                _diagnostics(diagnostics, dev))


def statespace_from_numpy(ssm, meta=None, state=None, device=None):
    """The port's ``(StateSpace, SSMeta, FilterState)`` from objects with
    their fields (the JAX package's, read with ``np.asarray``); ``meta``
    and ``state`` are optional and come back None when not given."""
    from ..statespace.ssm import FilterState, SSMeta, StateSpace
    dev = resolve_device(device)
    t_ssm = StateSpace(*(as_tensor(np.asarray(f), dev) for f in ssm))
    t_meta = None if meta is None else SSMeta(
        str(meta.family), str(meta.mode), int(meta.d_order), int(meta.m))
    t_state = None
    if state is not None:
        fields = [np.asarray(f) for f in state]
        t_state = FilterState(
            *(as_tensor(f, dev) for f in fields[:-1]),
            torch.as_tensor(fields[-1], dtype=torch.int32, device=dev))
    return t_ssm, t_meta, t_state


def retry_policy_from(policy) -> RetryPolicy:
    """The port's :class:`RetryPolicy` from any object with its four
    fields (the JAX package's ``RetryPolicy``)."""
    return RetryPolicy(int(policy.max_restarts), float(policy.perturb_scale),
                       int(policy.seed),
                       None if policy.max_iter is None
                       else int(policy.max_iter))


def fit_outcome_from_numpy(params, status, attempts, fallback_used, health,
                           orders=None) -> FitOutcome:
    """The port's :class:`FitOutcome` from numpy fields (a JAX-package
    outcome's, field for field), with the JAX package's dtypes."""
    return FitOutcome(
        None if params is None else np.asarray(params),
        np.asarray(status, np.int32), np.asarray(attempts, np.int64),
        np.asarray(fallback_used, np.int32), np.asarray(health, np.int32),
        None if orders is None else np.asarray(orders, np.int32))
