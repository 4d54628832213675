"""Fitted model -> state-space form, and the exact-likelihood objective
(counterpart of ``spark_timeseries_tpu/statespace/convert.py``).

:func:`to_statespace` turns a fitted model of the port into a
``(StateSpace, SSMeta)`` pair; :func:`bootstrap` also filters the
model's training history through it, calibrating the innovation
variance σ² and leaving a ready filter state.

- **ARIMA(p, d, q)**: the Harvey companion form on the d-times
  differenced series, ``m = max(p, q+1)``: ``T`` carries φ in its first
  column and an identity superdiagonal, the noise loads through ``R =
  (1, θ₁..θ_q, 0..)`` with ``Q = RRᵀ`` (unit scale), ``Z = e₁``, ``H =
  0``, the intercept in the state (``c·e₁``); ``d`` goes into the meta.
- **AR(p) / ARX**: the ARMA form with q = 0; ARX's exogenous part enters
  as a per-tick observation offset.
- **EWMA**: the SES innovations form, ``T = Z = (1,)``, pinned ``gain =
  (α,)``.
- **Holt-Winters (additive)**: the ETS(A,A,A) innovations form, state
  ``(ℓ, b, s₁..s_period)``, pinned ``gain = (α, αβ, 0.., γ(1-α))``; the
  multiplicative model has no linear form and raises.

:func:`arma_concentrated_neg_ll` is ``arima.fit(objective="exact")``'s
objective, batched over lanes.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from ..ops.ragged import step_weights
from .kalman import concentrated_loglik, filter_panel
from .ssm import FilterState, SSMeta, StateSpace, initial_state

__all__ = ["to_statespace", "bootstrap", "companion_arma",
           "arma_concentrated_neg_ll", "Bootstrapped"]


def companion_arma(phi: torch.Tensor, theta: torch.Tensor,
                   c: Optional[torch.Tensor] = None) -> StateSpace:
    """Harvey companion-form :class:`StateSpace` of a batched ARMA(p, q)
    at unit noise scale: ``phi (S, p)``, ``theta (S, q)``, ``c (S,)`` the
    intercept (in the state as ``c·e₁``).  Built out of place, so
    autograd reaches φ, θ and c."""
    S, p = phi.shape
    q = theta.shape[-1]
    m = max(p, q + 1)
    dt, dev = phi.dtype, phi.device
    first = torch.cat([phi, phi.new_zeros((S, m - p))], dim=-1)
    e0 = torch.zeros(m, dtype=dt, device=dev)
    e0[0] = 1.0
    # φ down the first column, the identity on the superdiagonal
    T = first[:, :, None] * e0 \
        + torch.diag(torch.ones(m - 1, dtype=dt, device=dev), 1)
    R = torch.cat([phi.new_ones((S, 1)), theta,
                   phi.new_zeros((S, m - 1 - q))], dim=-1)
    Q = R[:, :, None] * R[:, None, :]
    Z = torch.cat([phi.new_ones((S, 1)), phi.new_zeros((S, m - 1))], dim=-1)
    c_vec = phi.new_zeros((S, m)) if c is None else torch.cat(
        [torch.as_tensor(c, dtype=dt, device=dev).reshape(S, 1),
         phi.new_zeros((S, m - 1))], dim=-1)
    return StateSpace(T=T, Z=Z, c=c_vec, d=phi.new_zeros((S,)),
                      H=phi.new_zeros((S,)), Q=Q,
                      gain=phi.new_zeros((S, m)))


def _batched_coefs(x) -> torch.Tensor:
    return x[None] if x.ndim == 1 else x


def _arima_like(model, family: str) -> Tuple[StateSpace, SSMeta]:
    p, d, q = model.p, model.d, model.q
    coefs = _batched_coefs(model.coefficients)
    icpt = 1 if model.has_intercept else 0
    c = coefs[:, 0] if icpt else coefs.new_zeros((coefs.shape[0],))
    ssm = companion_arma(coefs[:, icpt:icpt + p],
                         coefs[:, icpt + p:icpt + p + q], c)
    return ssm, SSMeta(family, "exact", int(d), ssm.state_dim)


def _ar_like(model, family: str) -> Tuple[StateSpace, SSMeta]:
    coefs = _batched_coefs(model.coefficients)
    S = coefs.shape[0]
    phi = coefs[:, :int(model.y_max_lag)] if family == "arx" else coefs
    c = torch.as_tensor(model.c, dtype=coefs.dtype,
                        device=coefs.device).reshape(-1).expand(S)
    ssm = companion_arma(phi, coefs.new_zeros((S, 0)), c)
    return ssm, SSMeta(family, "exact", 0, ssm.state_dim)


def _ewma(model) -> Tuple[StateSpace, SSMeta]:
    alpha = torch.atleast_1d(model.smoothing)
    S = alpha.shape[0]
    one = alpha.new_ones((S, 1, 1))
    ssm = StateSpace(T=one, Z=alpha.new_ones((S, 1)),
                     c=alpha.new_zeros((S, 1)), d=alpha.new_zeros((S,)),
                     H=alpha.new_ones((S,)),
                     Q=(alpha * alpha)[:, None, None], gain=alpha[:, None])
    return ssm, SSMeta("ewma", "innovations", 0, 1)


def _holt_winters(model) -> Tuple[StateSpace, SSMeta]:
    if not model.additive:
        raise NotImplementedError(
            "multiplicative Holt-Winters has a state-nonlinear observation "
            "(level·season); only the additive model has a linear "
            "state-space form — refit with model_type='additive' or serve "
            "multiplicative panels through batch refits")
    period = int(model.period)
    a = torch.atleast_1d(model.alpha)
    b = torch.atleast_1d(model.beta).to(a.dtype)
    g = torch.atleast_1d(model.gamma).to(a.dtype)
    S = a.shape[0]
    m = 2 + period
    T = a.new_zeros((S, m, m))
    T[:, 0, 0] = 1.0
    T[:, 0, 1] = 1.0                                   # ℓ' = ℓ + b
    T[:, 1, 1] = 1.0                                   # b' = b
    idx = torch.arange(period - 1, device=a.device)
    T[:, 2 + idx, 3 + idx] = 1.0                       # ring rotation
    T[:, 2 + period - 1, 2] = 1.0                      # tail <- old head
    Z = a.new_zeros((S, m))
    Z[:, :3] = 1.0
    gain = a.new_zeros((S, m))
    gain[:, 0] = a
    gain[:, 1] = a * b
    gain[:, 2 + period - 1] = g * (1.0 - a)
    ssm = StateSpace(T=T, Z=Z, c=a.new_zeros((S, m)), d=a.new_zeros((S,)),
                     H=a.new_ones((S,)),
                     Q=gain[:, :, None] * gain[:, None, :], gain=gain)
    return ssm, SSMeta("holt_winters", "innovations", 0, m)


def to_statespace(model) -> Tuple[StateSpace, SSMeta]:
    """A fitted model (``ARIMAModel``, ``ARModel``, ``ARXModel``,
    ``EWMAModel``, additive ``HoltWintersModel``) in state-space form at
    unit noise scale; a single-series model is a batch of one.
    :func:`bootstrap` calibrates σ² from the training history."""
    name = type(model).__name__
    if name == "ARIMAModel":
        return _arima_like(model, "arima")
    if name == "ARModel":
        return _ar_like(model, "ar")
    if name == "ARXModel":
        return _ar_like(model, "arx")
    if name == "EWMAModel":
        return _ewma(model)
    if name == "HoltWintersModel":
        return _holt_winters(model)
    raise TypeError(
        f"no state-space form for {name}; supported: ARIMAModel, ARModel, "
        f"ARXModel, EWMAModel, HoltWintersModel (additive)")


class Bootstrapped(NamedTuple):
    """:func:`to_statespace` plus a calibrated pass over the history;
    ``sigma2`` is the per-lane innovation variance the ssm and state
    were rescaled with."""
    ssm: StateSpace
    meta: SSMeta
    state: FilterState
    sigma2: torch.Tensor


def _rescale(ssm: StateSpace, state: FilterState, meta: SSMeta,
             sigma2: torch.Tensor) -> Tuple[StateSpace, FilterState]:
    """The unit-scale filter at the calibrated σ²: Q (and H in
    innovations mode) and the predicted covariance scale linearly; gains
    and means are scale-invariant."""
    s2q = sigma2[:, None, None]
    ssm = ssm._replace(Q=ssm.Q * s2q,
                       H=ssm.H * (sigma2 if meta.mode == "innovations"
                                  else 1.0))
    return ssm, state._replace(P=state.P * s2q)


def bootstrap(model, history, *, offsets=None) -> Bootstrapped:
    """The serving form of a fitted model: convert, filter the training
    ``history (S, n)`` (NaN ticks are missing), calibrate σ² from the
    innovations and rescale.  The returned state's ``loglik`` is the
    exact log-likelihood of the history at the calibrated scale.
    ``offsets (S, n)`` carries ARX's per-tick exogenous offsets."""
    ssm, meta = to_statespace(model)
    dev = ssm.T.device
    history = torch.as_tensor(history, device=dev)
    if history.ndim == 1:
        history = history[None]
    if history.shape[0] != ssm.n_series:
        if ssm.n_series != 1:
            raise ValueError(
                f"history has {history.shape[0]} series but the model is "
                f"batched over {ssm.n_series}")
        # a single-series model over a panel: broadcast its parameters
        ssm = StateSpace(*(leaf.expand(history.shape[0], *leaf.shape[1:])
                           for leaf in ssm))
    dtype = history.dtype
    ssm = StateSpace(*(leaf.to(dtype) for leaf in ssm))
    state = initial_state(ssm, meta)
    if offsets is not None:
        offsets = torch.as_tensor(offsets, dtype=dtype, device=dev)

    def tail(k):
        return None if offsets is None else offsets[:, k:]

    if meta.family == "ewma":
        # S_0 = x_0 exactly (the model's own seed); filter from t = 1
        first = history[:, 0]
        state = state._replace(a=torch.where(
            torch.isfinite(first), first, torch.zeros_like(first))[:, None])
        res = filter_panel(ssm, state, history[:, 1:], meta, offsets=tail(1))
    elif meta.family == "holt_winters":
        period = meta.m - 2
        if history.shape[1] < 2 * period:
            raise ValueError(
                f"Holt-Winters bootstrap needs >= 2 periods of history "
                f"({2 * period} obs), got {history.shape[1]}")
        level0, trend0, season0 = model._init_components(history)
        a0 = torch.cat([level0[..., None], trend0[..., None], season0],
                       dim=-1)
        state = state._replace(a=a0.to(dtype))
        res = filter_panel(ssm, state, history[:, period:], meta,
                           offsets=tail(period))
    else:
        res = filter_panel(ssm, state, history, meta, offsets=offsets)
    final = res.state
    n = torch.clamp(final.n_obs.to(dtype), min=1.0)
    sigma2 = final.ssq / n
    sigma2 = torch.where(torch.isfinite(sigma2) & (sigma2 > 0), sigma2,
                         torch.ones_like(sigma2))
    ssm, final = _rescale(ssm, final, meta, sigma2)
    # the running loglik at the calibrated scale (the unit-scale pass
    # measured Σ log F and Σ v²/F; both shift by known σ² factors)
    final = final._replace(
        loglik=concentrated_loglik(final), ssq=final.ssq / sigma2,
        sumlogf=final.sumlogf + final.n_obs.to(dtype) * torch.log(sigma2))
    return Bootstrapped(ssm, meta, final, sigma2)


def arma_concentrated_neg_ll(params: torch.Tensor, diffed: torch.Tensor,
                             p: int, q: int, icpt: int,
                             n_valid=None) -> torch.Tensor:
    """Negative σ²-concentrated exact ARMA log-likelihood, batched: the
    ``arima.fit(objective="exact")`` objective.

    ``params (S, icpt+p+q)`` in the fit's ``[c?, φ.., θ..]`` layout (or
    ``(k,)`` with ``diffed (n,)``: one lane); ``diffed (S, n)`` the
    already-differenced series; ``n_valid (S,)`` restricts each
    left-aligned ragged lane to its valid window.  Builds the companion
    form at unit scale, runs the stationary-initialized filter and
    profiles σ² out; differentiable by autograd.  Returns ``(S,)``."""
    one = params.ndim == 1
    if one:
        params, diffed = params[None], diffed[None]
        if n_valid is not None:
            n_valid = torch.as_tensor(n_valid).reshape(1)
    params = params.to(diffed.dtype)
    S = diffed.shape[0]
    params = params.expand(S, params.shape[-1])
    c = params[:, 0] if icpt else params.new_zeros((S,))
    ssm = companion_arma(params[:, icpt:icpt + p],
                         params[:, icpt + p:icpt + p + q], c)
    meta = SSMeta("arima", "exact", 0, ssm.state_dim)
    state = initial_state(ssm, meta)
    weights = None
    if n_valid is not None:
        nv = torch.as_tensor(n_valid, device=diffed.device)
        weights = step_weights(diffed.shape[-1], nv[:, None],
                               dtype=diffed.dtype)
    res = filter_panel(ssm, state, diffed, meta, weights=weights)
    out = -concentrated_loglik(res.state)
    return out[0] if one else out
