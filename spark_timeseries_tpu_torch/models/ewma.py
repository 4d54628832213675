"""EWMA (simple exponential smoothing), batched (counterpart of
``spark_timeseries_tpu/models/ewma.py``).

The model ``S_t = a X_t + (1 - a) S_{t-1}``, ``S_0 = X_0``; the fit
minimizes the one-step-ahead SSE over the smoothing parameter ``a`` from
0.94.  The default ``method="lm"`` runs the batched Levenberg-Marquardt
state machine of ``ops.optimize.lm_state_machine`` on the fused normal
equations of :func:`_ewma_pass` (log-depth scans over the series'
differences), its accept test reading the sse's change term by term
(:func:`_sse_change`);
``method="box"`` and ``"bfgs"`` run ``minimize_box`` and
``minimize_bfgs`` on the SSE with its autograd gradient.  No Pallas
kernel: the JAX package runs these recurrences in XLA, the port in plain
PyTorch.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from .._device import as_tensor, resolve_device
from ..ops.optimize import (_solve_with_policy, lm_state_machine,
                            minimize_bfgs, minimize_box, value_and_grad_of)
from ..ops.ragged import (apply_short_quarantine, ragged_view, short_lanes,
                          step_weights)
from ..ops.scan_parallel import ewma_smooth, linear_recurrence
from ..utils import resilience as _resilience
from .base import FitDiagnostics, diagnostics_from, normal_quantile

# floor of the smoothing parameter when inverting the recurrence, and the
# box method's lower bound
SMOOTHING_FLOOR = 1e-4


class EWMAModel(NamedTuple):
    """Smoothing parameter ``a``: scalar for one series, ``(n_series,)``
    for a batched fit."""
    smoothing: torch.Tensor
    diagnostics: Optional[FitDiagnostics] = None

    @property
    def n_params(self) -> int:
        """Estimated-parameter count (the smoothing scalar)."""
        return 1

    def _ts(self, ts) -> torch.Tensor:
        if isinstance(self.smoothing, torch.Tensor):
            return torch.as_tensor(ts, dtype=self.smoothing.dtype,
                                   device=self.smoothing.device)
        return torch.as_tensor(ts)

    def _a(self, ts: torch.Tensor) -> torch.Tensor:
        return torch.as_tensor(self.smoothing, dtype=ts.dtype,
                               device=ts.device)

    def add_time_dependent_effects(self, ts) -> torch.Tensor:
        """Smooth: ``S_t = a X_t + (1-a) S_{t-1}``, ``S_0 = X_0``, over
        the last axis (a log-depth scan)."""
        ts = self._ts(ts)
        return ewma_smooth(ts, self._a(ts))

    def remove_time_dependent_effects(self, ts) -> torch.Tensor:
        """Invert the smoothing recurrence, elementwise; the divisor is
        floored at :data:`SMOOTHING_FLOOR` in magnitude."""
        ts = self._ts(ts)
        a = self._a(ts)
        if a.ndim and ts.ndim > 1:
            a = a[..., None]
        a = torch.where(a >= 0, torch.clamp(a, min=SMOOTHING_FLOOR),
                        torch.clamp(a, max=-SMOOTHING_FLOOR))
        rest = (ts[..., 1:] - (1.0 - a) * ts[..., :-1]) / a
        return torch.cat([ts[..., :1], rest], dim=-1)

    def sse(self, ts) -> torch.Tensor:
        """One-step-ahead SSE: the forecast of t+1 is the smoothed value
        at t."""
        ts = self._ts(ts)
        smoothed = self.add_time_dependent_effects(ts)
        err = ts[..., 1:] - smoothed[..., :-1]
        return (err * err).sum(dim=-1)

    def forecast(self, ts, n_future: int) -> torch.Tensor:
        """Flat forecast at the final smoothed level, ``(..., n_future)``."""
        if n_future < 1:
            raise ValueError("forecast needs n_future >= 1")
        level = self.add_time_dependent_effects(ts)[..., -1]
        return level[..., None].expand(*level.shape, n_future)

    def forecast_interval(self, ts, n_future: int, conf: float = 0.95):
        """Prediction bands of the flat forecast: ``var_h = σ²(1 +
        (h-1)α²)``, σ² from the one-step residuals.  Returns ``(point,
        lower, upper)``, each ``(..., n_future)``."""
        if n_future < 1:
            raise ValueError("forecast_interval needs n_future >= 1")
        ts = self._ts(ts)
        a = self._a(ts)
        smoothed = self.add_time_dependent_effects(ts)
        point = smoothed[..., -1:].expand(*smoothed.shape[:-1], n_future)
        err = ts[..., 1:] - smoothed[..., :-1]
        sigma2 = (err * err).mean(dim=-1)
        h = torch.arange(n_future, dtype=ts.dtype, device=ts.device)
        var_h = sigma2[..., None] * (1.0 + h * a[..., None] ** 2)
        half = normal_quantile(conf, ts.dtype).to(ts.device) \
            * torch.sqrt(var_h)
        return point, point - half, point + half


def _residuals(one_m_a: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """One-step residuals ``e_t = Δx_{t+1} + (1-a) e_{t-1}``, ``e_0 = x_1 -
    x_0``, t = 0..n-2, from the differences ``d (S, n-1)`` (a log-depth
    scan; ``s_t = s_{t-1} + a (x_t - s_{t-1})`` makes ``e_t = x_{t+1} -
    s_t`` obey it, and the level of the series never enters)."""
    return linear_recurrence(one_m_a.expand_as(d), d)


class _Pass(NamedTuple):
    """One EWMA normal-equations pass at a point: the residuals ``e (S,
    n-1)`` (unweighted), ``JᵀJ``, ``Jᵀr`` and ``sse`` per lane."""
    e: torch.Tensor
    jtj: torch.Tensor
    jtr: torch.Tensor
    sse: torch.Tensor


def _ewma_pass(a: torch.Tensor, d: torch.Tensor,
               w: Optional[torch.Tensor], w0) -> _Pass:
    """The JAX package's fused EWMA carry as two log-depth scans over the
    differences: the residuals, then the tangent ``ds_t = e_{t-1} + (1-a)
    ds_{t-1}``, ``ds_0 = 0`` (the JAX carry's ``x_t - s_{t-1}`` is
    ``e_{t-1}``), and the sums over the residuals ``t >= 1`` (weighted by
    ``w`` when given) plus ``e_0`` (zero tangent; ``w0`` its weight).
    About ``10 · ceil(log2 n) + 12`` elementwise launches."""
    one_m_a = 1.0 - a[:, None]
    e = _residuals(one_m_a, d)
    r, e0 = e[:, 1:], e[:, 0]
    ds = linear_recurrence(one_m_a.expand_as(r), e[:, :-1])
    if w is not None:
        r = w * r
        ds = w * ds
        e0 = w0 * e0
    return _Pass(e, (ds * ds).sum(dim=-1), -(ds * r).sum(dim=-1),
                 (r * r).sum(dim=-1) + e0 * e0)


def _sse_change(e: torch.Tensor, a: torch.Tensor, a_new: torch.Tensor,
                w: Optional[torch.Tensor]) -> torch.Tensor:
    """``sse(a_new) - sse(a)`` summed term by term from the residuals ``e``
    at ``a``: ``Δ_t = e_t(a_new) - e_t(a)`` obeys ``Δ_t = (1-a_new)
    Δ_{t-1} + (a - a_new) e_{t-1}(a)``, ``Δ_0 = 0``, and the change is
    ``Σ Δ_t (2 e_t(a) + Δ_t)``.  Exact algebra; its rounding is relative
    to the change, not to the sse, so a float32 solve still tells apart
    steps that move the sse by less than its last digit (a random-walk
    lane's sse is flat to ~1e-8 relative over ~1e-4 of ``a`` around its
    optimum)."""
    drive = (a - a_new)[:, None] * e[:, :-1]
    delta = linear_recurrence((1.0 - a_new)[:, None].expand_as(drive),
                              drive)
    term = delta * (2.0 * e[:, 1:] + delta)
    if w is not None:
        term = w * term
    return term.sum(dim=-1)


def _lm_solve(d: torch.Tensor, w: Optional[torch.Tensor], w0, x0, tol,
              max_iter: int):
    """``ops.optimize.lm_state_machine`` (per lane the JAX package's
    ``_minimize_lm_one``) over :func:`_ewma_pass`, its accept test and
    objective-drop exit reading the sse's change from
    :func:`_sse_change` instead of the difference of two rounded sse
    values.  Returns ``(x (S, 1), sse, done, n_iter)``."""
    def ne(x):
        p = _ewma_pass(x[:, 0], d, w, w0)
        return p.jtj[:, None, None], p.jtr[:, None], p.sse, p.e

    def change(cur, x, x_new):
        return _sse_change(cur[3], x[:, 0], x_new[:, 0], w)

    return lm_state_machine(ne, x0, tol, max_iter, change=change)


def _weights(series: torch.Tensor, n_valid: Optional[torch.Tensor]):
    """The residuals' weights ``(w (S, n-2), w0 (S,))`` of left-aligned
    lanes with ``n_valid`` points (residual t targets index t + 1), or
    ``(None, 1)``."""
    if n_valid is None:
        return None, 1.0
    w = step_weights(series.shape[-1] - 2, n_valid[:, None], offset=2,
                     dtype=series.dtype)
    return w, (n_valid >= 2).to(series.dtype)


def _sse_objective(params: torch.Tensor, series: torch.Tensor,
                   n_valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The batched one-step SSE of ``params (S, 1)`` (weighted to each
    lane's window when ``n_valid`` is given)."""
    smoothed = ewma_smooth(series, params[:, 0])
    err = series[:, 1:] - smoothed[:, :-1]
    if n_valid is None:
        return (err * err).sum(dim=-1)
    w = step_weights(err.shape[-1], n_valid[:, None], offset=1,
                     dtype=series.dtype)
    return (w * err * err).sum(dim=-1)


def fit(ts, init=0.94, tol: float = 1e-9, max_iter: Optional[int] = None,
        method: str = "lm", retry=None, device=None,
        stats: Optional[dict] = None, _restart_draws=None) -> EWMAModel:
    """Fit EWMA by minimizing the one-step SSE over the smoothing
    parameter from ``init`` (0.94, or one value per lane).

    ``ts (n,)`` or ``(n_series, n)`` fits in one batched solve on
    ``device`` (``None`` means CUDA: float32, and raises without a card;
    ``device="cpu"`` takes float32 or float64).  ``method``:

    - ``"lm"`` (default): Levenberg-Marquardt on the fused normal
      equations; the result is projected into [:data:`SMOOTHING_FLOOR`,
      1] and lanes that left that domain are flagged non-converged;
    - ``"box"``: the projected gradient on [1e-4, 1];
    - ``"bfgs"``: the unbounded BFGS (whose result, as the reference
      warns, should be sanity-checked).

    NaN-padded panels fit each lane's valid window; lanes with fewer than
    3 valid observations get NaN smoothing and are not converged;
    interior gaps raise.  ``retry`` (a ``utils.resilience.RetryPolicy``)
    re-solves unconverged lanes from jittered starts (draws from
    ``retry.seed``, or ``_restart_draws (R, S, 1)``); ``max_iter``
    defaults to ``retry.max_iter`` or 200.  ``stats`` receives the
    solver's ``solves`` and ``restart_lanes``."""
    dev = resolve_device(device)
    ts, obs_len = ragged_view(as_tensor(ts, dev))
    rk = _resilience.retry_kwargs(retry)
    if max_iter is None:
        max_iter = retry.max_iter if retry is not None \
            and retry.max_iter is not None else 200
    batch, n = ts.shape[:-1], ts.shape[-1]
    y = ts.reshape(-1, n)
    nv = None if obs_len is None else obs_len.reshape(-1)
    extra = () if nv is None else (nv,)
    x0 = torch.as_tensor(init, dtype=ts.dtype, device=dev)
    x0 = x0.reshape(-1, 1).expand(y.shape[0], 1) if x0.ndim \
        else x0.expand(y.shape[0], 1)
    x0 = x0.contiguous()
    st = {} if stats is None else stats
    if method == "lm":
        d = y[:, 1:] - y[:, :-1]
        w, w0 = _weights(y, nv)

        def solve(xs, idx):
            if idx is None:
                return _lm_solve(d, w, w0, xs, tol, max_iter)
            return _lm_solve(d.index_select(0, idx),
                             None if w is None else w.index_select(0, idx),
                             w0 if w is None else w0.index_select(0, idx),
                             xs, tol, max_iter)

        res = _solve_with_policy(solve, x0, rk.get("restarts", 0),
                                 rk.get("restart_scale", 0.25),
                                 rk.get("restart_seed", 0), _restart_draws,
                                 st)
        # the model domain is (0, 1]: a lane that converged outside it is
        # projected back and flagged, for refit_unconverged to retry
        in_domain = ((res.x >= SMOOTHING_FLOOR) & (res.x <= 1.0)).all(dim=-1)
        res = res._replace(x=torch.clamp(res.x, SMOOTHING_FLOOR, 1.0),
                           converged=res.converged & in_domain)
    elif method in ("box", "bfgs"):
        vag, evaluator_for = value_and_grad_of(_sse_objective, y, *extra)
        if method == "box":
            res = minimize_box(vag, x0, 1e-4, 1.0, tol=tol,
                               max_iter=max_iter,
                               evaluator_for=evaluator_for,
                               jitter_draws=_restart_draws, stats=st, **rk)
        else:
            res = minimize_bfgs(vag, x0, tol=tol, max_iter=max_iter,
                                evaluator_for=evaluator_for,
                                jitter_draws=_restart_draws, stats=st, **rk)
    else:
        raise ValueError(f"unknown method {method!r}")
    # a diverged lane falls back to its initial guess
    lane_ok = torch.isfinite(res.x).all(dim=-1, keepdim=True)
    params = torch.where(lane_ok, res.x, x0)
    conv = diagnostics_from(res, lane_ok)
    if nv is not None:
        short = short_lanes(nv, 3, "EWMA one-step SSE")
        params, conv_mask = apply_short_quarantine(params, conv.converged,
                                                   short)
        conv = conv._replace(converged=conv_mask)
    conv = FitDiagnostics(*(t.reshape(batch) for t in conv[:3]),
                          None if conv.attempts is None
                          else conv.attempts.reshape(batch))
    return EWMAModel(params[:, 0].reshape(batch), diagnostics=conv)


def fit_panel(panel, **kwargs) -> EWMAModel:
    """Batched fit of a :class:`~spark_timeseries_tpu_torch.panel.Panel`
    on its device."""
    return fit(panel.values, device=panel.device, **kwargs)


def _naive_model(v: torch.Tensor) -> EWMAModel:
    """Terminal fallback: ``a = 1``, the last-value smoother, defined for
    any lane with finite observations (NaN padding drops out of the
    sum)."""
    sse = torch.nansum((v[..., 1:] - v[..., :-1]) ** 2, dim=-1)
    m = EWMAModel(torch.ones(v.shape[:-1], dtype=v.dtype, device=v.device))
    return m._replace(diagnostics=FitDiagnostics(
        torch.isfinite(sse),
        torch.zeros(sse.shape, dtype=torch.int32, device=v.device), sse))


def fit_resilient(ts, retry: Optional[_resilience.RetryPolicy] = None,
                  device=None, **kwargs):
    """Fail-soft batched EWMA on ``device`` (``None`` means CUDA): LM with
    multi-start retry -> the box-constrained solve -> the naive ``a = 1``
    smoother, each stage on the lanes still failing.  ``ts (n_series,
    n)``; returns ``(model, FitOutcome)``."""
    if retry is None:
        retry = _resilience.RetryPolicy()
    dev = resolve_device(device)
    values = as_tensor(ts, dev)
    chain = [
        ("lm", lambda v: fit(v, retry=retry, device=dev, **kwargs)),
        ("box", lambda v: fit(v, device=dev, **_resilience.override_kwargs(
            kwargs, method="box"))),
        ("naive", _naive_model),
    ]
    return _resilience.resilient_fit(values, chain, min_len=3, family="ewma")
