"""Batched Kalman filtering: O(1) per-tick updates and the exact
likelihood (counterpart of ``spark_timeseries_tpu/statespace/kalman.py``).

The prediction-form filter (state = the one-step-ahead predicted mean and
covariance):

    v_t = y_t - d - Z·a_t                     innovation
    F_t = Z P Zᵀ + H        (exact)   |  H    (innovations)
    K_t = T P Zᵀ / F        (exact)   |  gain (innovations)
    a_{t+1} = T a_t + c + K_t v_t
    P_{t+1} = T P Tᵀ + Q - F K Kᵀ     (exact; predict-only when missing)
    ll     += -½ (log 2πF + v²/F)

A missing tick (NaN, or a zero step weight on ragged lanes) skips the
update: the state predicts forward and adds no likelihood.

The JAX package runs each lane's series as a vmapped ``lax.scan``; here
:func:`filter_panel` is one time loop over the whole panel's ``(S, m)``
and ``(S, m, m)`` state, each step a few dozen elementwise launches over
the lanes (``m`` is tiny: 3 at ARMA(2,2)), so the products are written
as broadcast multiplies and sums, not a batched matrix library call a
step.  Every op is out of place, so autograd differentiates through the
filter (the exact ARIMA refine takes its gradient this way).

:func:`filter_panel_parallel`, :func:`pinned_state_path` and
:func:`filter_forecast_origin` evaluate pinned-gain recursions in
logarithmic depth over ``ops.scan_parallel.affine_recurrence``.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch

from ..ops.scan_parallel import affine_recurrence
from .ssm import FilterState, SSMeta, StateSpace

_LOG_2PI = math.log(2.0 * math.pi)

__all__ = ["filter_step_one", "filter_step_panel", "filter_panel",
           "filter_panel_parallel", "concentrated_loglik", "FilterResult",
           "forecast_mean", "steady_gain", "filter_forecast_origin",
           "pinned_state_path"]


class FilterResult(NamedTuple):
    """Outcome of a whole-series filter pass: ``state`` the carry after
    the last tick, ``loglik`` the exact Gaussian log-likelihood at the
    model's noise scale, ``path`` (when asked for) the per-step
    predicted ``(a, P, v, F)``, lane-major: ``(S, n, ...)``."""
    state: FilterState
    loglik: torch.Tensor
    path: Optional[Tuple[torch.Tensor, ...]] = None


def _mv(A: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``A @ x`` over the batch, ``(..., m, m) x (..., m)``."""
    return (A * x[..., None, :]).sum(dim=-1)


def _mm(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """``A @ B`` over the batch, ``(..., m, m) x (..., m, m)``."""
    return (A[..., :, :, None] * B[..., None, :, :]).sum(dim=-2)


def _outer(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return x[..., :, None] * y[..., None, :]


def _diff_step(ring: torch.Tensor, y: torch.Tensor, d_order: int):
    """Advance the raw-difference ring by one tick: ``ring[..., j] = Δʲ
    y_prev``; returns ``(ring', Δ^d y)``.  The first ``d_order`` ticks
    after a zero ring make garbage differences, which callers weight out;
    a NaN tick holds the ring."""
    if d_order == 0:
        return ring, y
    levels = []
    cur = y
    for j in range(d_order):
        levels.append(cur)
        cur = cur - ring[..., j]
    ok = torch.isfinite(y)
    new_ring = torch.where(ok[..., None], torch.stack(levels, dim=-1), ring)
    diffed = torch.where(ok, cur, torch.full_like(cur, math.nan))
    return new_ring, diffed


def _update(ssm: StateSpace, meta: SSMeta, a: torch.Tensor,
            P: torch.Tensor, y: torch.Tensor, obs: Optional[torch.Tensor],
            joseph: bool):
    """The filter step's arithmetic: ``(a', P', v, v_eff, F)``.  ``obs``
    None means every lane observed this tick (the dense path: no masks,
    a third fewer launches a step)."""
    zero = None if obs is None \
        else torch.zeros((), dtype=a.dtype, device=a.device)
    v = y - ssm.d - (ssm.Z * a).sum(dim=-1)
    if meta.mode == "exact":
        pz = _mv(P, ssm.Z)
        F = (ssm.Z * pz).sum(dim=-1) + ssm.H
        K = _mv(ssm.T, pz) / F[..., None]
    else:
        F = ssm.H
        K = ssm.gain
    v_eff = v if obs is None else torch.where(obs, v, zero)
    a_next = _mv(ssm.T, a) + ssm.c + K * v_eff[..., None]
    if meta.mode != "exact":
        return a_next, P, v, v_eff, F
    Tt = ssm.T.transpose(-1, -2)
    if joseph:
        kf = pz / F[..., None]
        imkz = torch.eye(a.shape[-1], dtype=a.dtype, device=a.device) \
            - _outer(kf, ssm.Z)
        p_filt = _mm(_mm(imkz, P), imkz.transpose(-1, -2)) \
            + ssm.H[..., None, None] * _outer(kf, kf)
        if obs is not None:
            p_filt = torch.where(obs[..., None, None], p_filt, P)
        P_next = _mm(_mm(ssm.T, p_filt), Tt) + ssm.Q
        P_next = 0.5 * (P_next + P_next.transpose(-1, -2))
    else:
        f_obs = F if obs is None else torch.where(obs, F, zero)
        P_next = _mm(_mm(ssm.T, P), Tt) + ssm.Q \
            - f_obs[..., None, None] * _outer(K, K)
    return a_next, P_next, v, v_eff, F


def filter_step_one(ssm: StateSpace, meta: SSMeta, a: torch.Tensor,
                    P: torch.Tensor, y: torch.Tensor, w: torch.Tensor,
                    joseph: bool = False):
    """One prediction-form filter step, batched over the leading dims of
    ``a (..., m)`` (the JAX package's single-lane step).  ``w`` (0/1) is
    the ragged / burn-in step weight; a NaN ``y`` or ``w == 0`` predicts
    without updating.  Returns ``(a', P', v, F, ll_inc, observed)``.

    ``joseph=True`` (exact mode) replaces the covariance update by the
    Joseph form ``P_f = (I − K_f Z) P (I − K_f Z)ᵀ + K_f H K_fᵀ`` (``K_f =
    P Z / F``), then ``P' = T P_f Tᵀ + Q`` symmetrized: the same algebra,
    symmetric positive semi-definite by construction in float
    arithmetic."""
    obs = torch.isfinite(y) & (w > 0)
    a_next, P_next, v, v_eff, F = _update(ssm, meta, a, P, y, obs, joseph)
    ll_inc = torch.where(
        obs, -0.5 * (torch.log(2.0 * math.pi * F) + v_eff * v_eff / F),
        torch.zeros((), dtype=a.dtype, device=a.device))
    return a_next, P_next, v, F, ll_inc, obs


def _tick_one(ssm: StateSpace, meta: SSMeta, state: FilterState,
              y: torch.Tensor, offset: Optional[torch.Tensor],
              w: Optional[torch.Tensor], joseph: bool = False):
    """One raw-scale tick: difference through the ring, load the
    exogenous observation ``offset`` (ARX) into the state through ``Z``
    before the step (so the transition carries it into later AR lags),
    run the filter step, accumulate the likelihood pieces.  ``w`` None
    says every lane is observed (finite ``y``, live step), ``offset``
    None that there is none.  Returns ``(state', (v, F))``."""
    ring, z = _diff_step(state.ring, y, meta.d_order)
    a_in = state.a if offset is None else state.a + offset[..., None] * ssm.Z
    obs = None if w is None else torch.isfinite(z) & (w > 0)
    a, P, v, v_eff, F = _update(ssm, meta, a_in, state.P, z, obs, joseph)
    log_f = torch.log(F)
    vf = v_eff * v_eff / F
    ll_inc = -0.5 * (_LOG_2PI + log_f + vf)
    n_inc = 1
    if obs is not None:
        zero = torch.zeros((), dtype=F.dtype, device=F.device)
        ll_inc = torch.where(obs, ll_inc, zero)
        vf = torch.where(obs, vf, zero)
        log_f = torch.where(obs, log_f, zero)
        n_inc = obs.to(state.n_obs.dtype)
    return FilterState(
        a=a, P=P, ring=ring, loglik=state.loglik + ll_inc,
        ssq=state.ssq + vf, sumlogf=state.sumlogf + log_f,
        n_obs=state.n_obs + n_inc), (v, F)


def filter_step_panel(ssm: StateSpace, state: FilterState, y: torch.Tensor,
                      offset: torch.Tensor, meta: SSMeta, *,
                      joseph: bool = False):
    """One tick across the whole panel: ``y (S,)`` raw observations,
    ``offset (S,)`` exogenous observation offsets (zeros when none).
    Returns ``(state', (v, F))``."""
    w = torch.ones((), dtype=y.dtype, device=y.device)
    return _tick_one(ssm, meta, state, y, offset, w, joseph)


def filter_panel(ssm: StateSpace, state: FilterState, ys: torch.Tensor,
                 meta: SSMeta, *, weights: Optional[torch.Tensor] = None,
                 offsets: Optional[torch.Tensor] = None,
                 return_path: bool = False) -> FilterResult:
    """Filter a whole panel ``ys (S, n)`` from ``state``: one loop over
    the ``n`` steps, each over every lane, accumulating the exact
    log-likelihood.

    ``weights (S, n)`` (0/1) marks live steps: ragged valid windows and
    the ``d_order`` differencing burn-in (when None, every step past the
    burn-in is live).  ``offsets (S, n)`` are per-tick exogenous
    observation offsets (ARX).  ``return_path`` also returns the
    per-step predicted ``(a, P, v, F)``, lane-major."""
    S, n = ys.shape
    dt, dev = ys.dtype, ys.device
    burn = (torch.arange(n, device=dev) >= meta.d_order).to(dt)
    # every step observed (no weights, no burn-in, no NaN): the dense step
    dense = weights is None and meta.d_order == 0 \
        and bool(torch.isfinite(ys).all())
    ws = None if dense else burn.expand(S, n) if weights is None \
        else torch.as_tensor(weights, dtype=dt, device=dev) * burn
    offs = None if offsets is None \
        else torch.as_tensor(offsets, dtype=dt, device=dev).expand(S, n)
    path = []
    for t in range(n):
        prev = state
        state, (v, F) = _tick_one(ssm, meta, state, ys[:, t],
                                  None if offs is None else offs[:, t],
                                  None if ws is None else ws[:, t])
        if return_path:
            path.append((prev.a, prev.P, v, F))
    out = None
    if return_path:
        out = tuple(torch.stack(parts, dim=1) for parts in zip(*path))
    return FilterResult(state, state.loglik, out)


def concentrated_loglik(state: FilterState) -> torch.Tensor:
    """σ²-profiled Gaussian log-likelihood from the accumulated filter
    pieces: with ``σ̂² = ssq / n``, ``ll = -n/2 · (log 2πσ̂² + 1) - ½ Σ log
    F`` (the filter ran at unit noise scale); NaN where no step was
    observed."""
    n = state.n_obs.to(state.ssq.dtype)
    sigma2 = state.ssq / torch.clamp(n, min=1.0)
    ll = -0.5 * n * (torch.log(2.0 * math.pi * sigma2) + 1.0) \
        - 0.5 * state.sumlogf
    return torch.where(state.n_obs > 0, ll, torch.full_like(ll, math.nan))


def forecast_mean(meta: SSMeta, horizon: int, ssm: StateSpace,
                  a: torch.Tensor, ring: torch.Tensor,
                  offsets: torch.Tensor) -> torch.Tensor:
    """h-step point forecasts from a predicted state: ``x <- T(x +
    offset·Z) + c`` with zero future innovations, each step's observation
    integrated back to the raw scale through the ``d_order`` ring.
    ``a (S, m)``, ``ring (S, d_order)``, ``offsets (S, horizon)``;
    returns ``(S, horizon)``."""
    d_order = meta.d_order
    x, lasts = a, ring
    outs = []
    for h in range(horizon):
        off = offsets[:, h]
        z = ssm.d + (ssm.Z * x).sum(dim=-1) + off
        if d_order:
            vals = []
            cur = z
            for j in range(d_order - 1, -1, -1):
                cur = cur + lasts[:, j]
                vals.append(cur)
            y_out = cur
            lasts = torch.stack(vals[::-1], dim=-1)
        else:
            y_out = z
        x = _mv(ssm.T, x + off[:, None] * ssm.Z) + ssm.c
        outs.append(y_out)
    if not outs:
        return a.new_zeros((a.shape[0], 0))
    return torch.stack(outs, dim=-1)


def steady_gain(ssm: StateSpace, P: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The prediction-form gain and innovation variance a converged
    predicted covariance implies: ``F = Z P Zᵀ + H``, ``K = T P Zᵀ / F``.
    ``P (S, m, m)``; returns ``(K (S, m), F (S,))``."""
    pz = _mv(P, ssm.Z)
    F = (ssm.Z * pz).sum(dim=-1) + ssm.H
    K = _mv(ssm.T, pz) / F[:, None]
    return K, F


def _origin_chunk(A, K, F, Z, c, d, ys, x0):
    """One time chunk of the pinned-gain recursion ``x_t = A x_{t-1} + c +
    K (y_t - d)`` in logarithmic depth; the innovations and likelihood
    pieces follow elementwise off the prefix states.  Returns ``(x_last,
    ll_sum, ssq_sum, sumlogf_sum)`` per lane."""
    k = ys.shape[1]
    b = c[None] + K[None] * (ys.T - d[None])[..., None]       # (k, S, m)
    xs = affine_recurrence(A[None].expand(k, *A.shape), b, x0=x0)
    preds = torch.cat([x0[None], xs[:-1]], dim=0)
    v = ys.T - d[None] - (Z[None] * preds).sum(dim=-1)        # (k, S)
    ll = (-0.5 * (torch.log(2.0 * math.pi * F)[None] + v * v / F[None])) \
        .sum(dim=0)
    ssq = (v * v / F[None]).sum(dim=0)
    sumlogf = k * torch.log(F)
    return xs[-1], ll, ssq, sumlogf


def filter_forecast_origin(ssm: StateSpace, state: FilterState, ys,
                           meta: SSMeta, *, warm: int = 512,
                           chunk: int = 65536) -> FilterState:
    """Exact-mode forecast-origin state over a very long series without
    an O(n) sequential loop: filter the first ``warm`` observations with
    :func:`filter_panel`, pin the converged gain (:func:`steady_gain`)
    and evaluate the rest of the state-mean recursion, the affine map
    ``x_t = (T - KZ) x_{t-1} + c + K(y_t - d)``, chunk by chunk in
    logarithmic depth.  Matches the sequential filter to rounding once
    ``warm`` covers the covariance burn-in.  ``ys (S, n)`` must be fully
    observed; ``d_order`` must be 0."""
    if meta.mode != "exact":
        raise ValueError(
            "filter_forecast_origin is the exact-mode fast path; pinned-"
            "gain models already have filter_panel_parallel")
    if meta.d_order != 0:
        raise ValueError(
            "filter_forecast_origin runs on the filter scale; difference "
            "the series first (d_order must be 0)")
    ys = torch.as_tensor(ys, dtype=ssm.T.dtype, device=ssm.T.device)
    n = ys.shape[1]
    w = min(int(warm), n)
    origin = filter_panel(ssm, state, ys[:, :w], meta).state
    if w == n:
        return origin
    K, F = steady_gain(ssm, origin.P)
    A = ssm.T - _outer(K, ssm.Z)
    x = origin.a
    ll, ssq, slf = origin.loglik, origin.ssq, origin.sumlogf
    n_obs = origin.n_obs
    step = max(1, int(chunk))
    for s in range(w, n, step):
        part = ys[:, s:s + step]
        x, ll_c, ssq_c, slf_c = _origin_chunk(A, K, F, ssm.Z, ssm.c, ssm.d,
                                              part, x)
        ll, ssq, slf = ll + ll_c, ssq + ssq_c, slf + slf_c
        n_obs = n_obs + part.shape[1]
    return FilterState(a=x, P=origin.P, ring=origin.ring, loglik=ll,
                       ssq=ssq, sumlogf=slf, n_obs=n_obs)


def _pinned_maps(ssm: StateSpace, K: torch.Tensor, ys: torch.Tensor):
    """The time-major per-step maps of a pinned-gain filter: ``A_t = T -
    K Z`` and ``b_t = c + K (y_t - d)`` where observed, ``T`` and ``c``
    where the tick is missing."""
    obs = torch.isfinite(ys)                                  # (S, n)
    y_eff = torch.where(obs, ys, torch.zeros_like(ys))
    a_obs = ssm.T - _outer(K, ssm.Z)
    A = torch.where(obs.T[:, :, None, None], a_obs[None], ssm.T[None])
    b = ssm.c[None] + torch.where(
        obs.T[:, :, None], K[None] * (y_eff.T - ssm.d[None])[..., None],
        torch.zeros((), dtype=ys.dtype, device=ys.device))
    return obs, A, b


def pinned_state_path(ssm: StateSpace, x0: torch.Tensor, ys: torch.Tensor,
                      K: torch.Tensor) -> torch.Tensor:
    """Every predicted state along a series under a pinned per-lane gain
    ``K (S, m)``, in logarithmic depth: ``ys (S, n)`` (a NaN tick drops
    the gain term), ``x0 (S, m)`` the state predicted for the first
    tick.  Returns ``(n + 1, S, m)``, ``path[k]`` the state predicted
    after the first ``k`` observations."""
    ys = torch.as_tensor(ys, dtype=ssm.T.dtype, device=ssm.T.device)
    _, A, b = _pinned_maps(ssm, K, ys)
    xs = affine_recurrence(A, b, x0=x0)                       # (n, S, m)
    return torch.cat([x0[None], xs], dim=0)


def filter_panel_parallel(ssm: StateSpace, state: FilterState,
                          ys: torch.Tensor, meta: SSMeta) -> FilterResult:
    """Pinned-gain (innovations-mode) whole-series filter in logarithmic
    depth: the state recursion ``x_t = (T - g Z) x_{t-1} + c + g (y_t -
    d)`` (``x_t = T x_{t-1} + c`` at a missing tick) by
    ``ops.scan_parallel.affine_recurrence``, then the innovations and
    likelihood elementwise.  Matches :func:`filter_panel` to rounding."""
    if meta.mode != "innovations":
        raise ValueError(
            "filter_panel_parallel needs a pinned-gain (innovations-mode) "
            "model; exact-mode gains depend on the running covariance — "
            "use filter_panel")
    if meta.d_order != 0:
        raise ValueError(
            "filter_panel_parallel runs on the filter scale; difference "
            "the series first (d_order must be 0)")
    ys = torch.as_tensor(ys, dtype=ssm.T.dtype, device=ssm.T.device)
    obs, A, b = _pinned_maps(ssm, ssm.gain, ys)
    xs = affine_recurrence(A, b, x0=state.a)                  # (n, S, m)
    preds = torch.cat([state.a[None], xs[:-1]], dim=0)
    v = ys.T - ssm.d[None] - (ssm.Z[None] * preds).sum(dim=-1)
    F = ssm.H[None].expand(v.shape)
    zero = torch.zeros((), dtype=ys.dtype, device=ys.device)
    ot = obs.T
    v_eff = torch.where(ot, v, zero)
    ll_steps = torch.where(
        ot, -0.5 * (torch.log(2.0 * math.pi * F) + v_eff * v_eff / F), zero)
    final = FilterState(
        a=xs[-1], P=state.P, ring=state.ring,
        loglik=state.loglik + ll_steps.sum(dim=0),
        ssq=state.ssq + torch.where(ot, v_eff * v_eff / F, zero).sum(dim=0),
        sumlogf=state.sumlogf + torch.where(ot, torch.log(F), zero)
        .sum(dim=0),
        n_obs=state.n_obs + obs.sum(dim=1).to(state.n_obs.dtype))
    return FilterResult(final, final.loglik)
