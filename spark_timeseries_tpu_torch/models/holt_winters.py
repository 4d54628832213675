"""Holt-Winters triple exponential smoothing, batched (counterpart of
``spark_timeseries_tpu/models/holt_winters.py``).

Additive and multiplicative seasonality with the R ``stats::HoltWinters``
components recurrence, initialization from the first two periods, the SSE
objective over ``t >= period`` and level + trend + season forecasts with
prediction bands.  :func:`fit` minimizes the SSE over ``[0, 1]³`` with
the per-lane projected gradient of ``ops.hw_sse.box_fit`` — on CUDA, one
launch of the hand-written persistent kernel for the whole fit; on the
CPU, its plain version (``ops.optimize.minimize_box`` over the fused
value-and-grad pass).

Not ported yet (ROADMAP Queue A item 3): ``retry`` (raises
``NotImplementedError``), ``fit_resilient`` and ``fit_panel``.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from .._device import as_tensor, resolve_device
from ..ops import hw_sse
from ..ops.hw_sse import _kernel  # noqa: F401  (the JAX module's helper)
from ..ops.ragged import (apply_short_quarantine, ragged_view, short_lanes,
                          step_weights)
from .base import FitDiagnostics, diagnostics_from, normal_quantile


class HoltWintersModel(NamedTuple):
    """``model_type`` in {"additive", "multiplicative"}; smoothing
    parameters scalar or ``(n_series,)``."""
    model_type: str
    period: int
    alpha: torch.Tensor
    beta: torch.Tensor
    gamma: torch.Tensor
    diagnostics: Optional[FitDiagnostics] = None

    @property
    def additive(self) -> bool:
        return hw_sse.check_model_type(self.model_type)

    def _ts(self, ts) -> torch.Tensor:
        """``ts`` as a tensor on the parameters' device and dtype (as given
        when the parameters are plain numbers)."""
        if isinstance(self.alpha, torch.Tensor):
            return torch.as_tensor(ts, dtype=self.alpha.dtype,
                                   device=self.alpha.device)
        return torch.as_tensor(ts)

    def _params(self, ts: torch.Tensor):
        return tuple(torch.as_tensor(v, dtype=ts.dtype, device=ts.device)
                     for v in (self.alpha, self.beta, self.gamma))

    def _init_components(self, ts: torch.Tensor):
        """Initial ``(level, trend, season[period])`` from the first two
        periods (``ops.hw_sse.init_components``)."""
        return hw_sse.init_components(ts, self.period, self.additive)

    def _run(self, ts: torch.Tensor):
        """The components recurrence over ``t >= period``; returns
        ``(fitted, (final_level, final_trend, final_season_ring))`` with
        the ring's head the next step's season, as ``forecast`` needs."""
        m, additive = self.period, self.additive
        a, b, g = self._params(ts)
        level, trend, season0 = self._init_components(ts)
        seasons = list(season0.unbind(-1))            # ring: slot t mod m
        dests = []
        n_steps = ts.shape[-1] - m
        for t in range(n_steps):
            x, s_i = ts[..., m + t], seasons[t % m]
            base = level + trend
            dests.append(base + s_i if additive else base * s_i)
            lw = (x - s_i) if additive else (x / s_i)
            new_level = a * lw + (1.0 - a) * base
            trend = b * (new_level - level) + (1.0 - b) * trend
            sw = (x - new_level) if additive else (x / new_level)
            seasons[t % m] = g * sw + (1.0 - g) * s_i
            level = new_level
        head = n_steps % m
        ring = torch.stack(seasons[head:] + seasons[:head], dim=-1)
        dest = torch.stack(dests, dim=-1)
        fitted = torch.cat([dest.new_zeros((*dest.shape[:-1], m)), dest],
                           dim=-1)
        return fitted, (level, trend, ring)

    def get_holt_winters_components(self, ts):
        """``(fitted, final_level, final_trend, final_season[period])``."""
        fitted, (level, trend, seasons) = self._run(self._ts(ts))
        return fitted, level, trend, seasons

    def sse(self, ts) -> torch.Tensor:
        """``Σ_{t≥period} (ts_t - fitted_t)²``."""
        ts = self._ts(ts)
        fitted, _ = self._run(ts)
        err = ts[..., self.period:] - fitted[..., self.period:]
        return (err * err).sum(dim=-1)

    def add_time_dependent_effects(self, ts) -> torch.Tensor:
        """Fitted values."""
        return self._run(self._ts(ts))[0]

    def remove_time_dependent_effects(self, ts) -> torch.Tensor:
        raise NotImplementedError(
            "not implemented in the reference either "
            "(HoltWinters.scala:126-128)")

    def forecast(self, ts, n_future: int) -> torch.Tensor:
        """``(level + (h+1)·trend) ⊕ season`` per horizon step (R's extra
        trend weight)."""
        ts = self._ts(ts)
        _, (level, trend, seasons) = self._run(ts)
        h = torch.arange(1, n_future + 1, dtype=ts.dtype, device=ts.device)
        season = seasons[..., torch.arange(n_future, device=ts.device)
                         % self.period]
        base = level[..., None] + h * trend[..., None]
        return base + season if self.additive else base * season

    def forecast_interval(self, ts, n_future: int, conf: float = 0.95):
        """Point forecast and prediction bands ``(point, lower, upper)``,
        each ``(..., n_future)``: ``var_h = σ²(1 + Σ_{j<h} c_{h,j}²)`` with
        σ² from the one-step fitted residuals and the JAX package's
        coefficients ``c_{h,j}`` (exact for the additive model, a
        first-order linearization for the multiplicative one)."""
        if n_future < 1:
            raise ValueError("forecast_interval needs n_future >= 1")
        ts = self._ts(ts)
        additive, m = self.additive, self.period
        dt, dev = ts.dtype, ts.device
        fitted, (level, trend, seasons) = self._run(ts)
        h = torch.arange(1, n_future + 1, dtype=dt, device=dev)
        s_lead = seasons[..., torch.arange(n_future, device=dev) % m]
        base = level[..., None] + h * trend[..., None]
        point = base + s_lead if additive else base * s_lead
        err = ts[..., m:] - fitted[..., m:]
        sigma2 = (err * err).mean(dim=-1)

        a, b, g = self._params(ts)
        if additive:
            # c depends on the lag h-j alone — O(H) cumsum form
            j = torch.arange(1, n_future, dtype=dt, device=dev)
            hit = (torch.arange(1, n_future, device=dev) % m == 0).to(dt)
            cj = a[..., None] * (1.0 + j * b[..., None]) \
                + g[..., None] * (1.0 - a[..., None]) * hit
            csum = torch.cumsum(cj * cj, dim=-1)
            csum = torch.cat([csum.new_zeros((*csum.shape[:-1], 1)), csum],
                             dim=-1)
        else:
            # the season and trend ratios break lag-stationarity: (H, H)
            ar = torch.arange(1, n_future + 1, device=dev)
            lags = ar[:, None] - ar[None, :]                 # h - j
            future = (lags > 0).to(dt)
            hit = ((lags % m == 0) & (lags > 0)).to(dt)
            ratio_s = s_lead[..., :, None] / s_lead[..., None, :]
            ratio_f = base[..., :, None] / base[..., None, :]
            an = a[..., None, None]
            c = an * (1.0 + lags.to(dt) * b[..., None, None]) * ratio_s \
                + g[..., None, None] * (1.0 - an) * ratio_f * hit
            csum = ((c * future) ** 2).sum(dim=-1)
        var_h = sigma2[..., None] * (1.0 + csum)
        half = normal_quantile(conf, dt).to(dev) * torch.sqrt(var_h)
        return point, point - half, point + half


def fit(ts, period: int, model_type: str = "additive",
        init=(0.3, 0.1, 0.1), tol: float = 1e-10,
        max_iter: Optional[int] = None, retry=None, device=None,
        stats: Optional[dict] = None) -> HoltWintersModel:
    """Fit ``(alpha, beta, gamma)`` by minimizing the SSE over ``[0, 1]³``
    with the batched projected gradient from the R-style
    ``(0.3, 0.1, 0.1)`` start (default ``max_iter`` 1000).

    ``ts (..., n)`` (array-like or tensor) fits in one batched solve on
    ``device`` (``None`` means CUDA, which runs float32 and raises without
    a card; pass ``device="cpu"`` for the CPU, float32 or float64).  The
    solve is ``ops.hw_sse.box_fit``: on the card one launch of the
    persistent box-fit kernel, on the CPU the plain solver, several trials
    per call (``ops.hw_sse.CPU_TRIAL_LANES``).  ``stats`` (a dict,
    optional) receives ``evaluations``, the ``(S,)`` value-and-grad passes
    each lane needed, and the route's counts: ``box_fit_launches`` on the
    card, the solver's ``calls``/``iterations``/``trials`` on the CPU.

    NaN-padded panels (leading/trailing padding per lane) fit directly:
    valid windows are left-aligned and the SSE weighted to them.  Lanes
    with fewer than ``2 * period + 1`` valid observations get NaN
    parameters and ``diagnostics.converged == False``; interior gaps
    raise.  ``retry`` (multi-start) is not ported yet and raises.
    """
    if retry is not None:
        raise NotImplementedError(
            "retry (multi-start Holt-Winters fits) is not ported yet "
            "(ROADMAP Queue A item 3)")
    hw_sse.check_model_type(model_type)
    dev = resolve_device(device)
    ts, obs_len = ragged_view(as_tensor(ts, dev))
    batch, n = ts.shape[:-1], ts.shape[-1]
    lanes = ts.reshape(-1, n)
    inp = hw_sse.prepare(lanes, period, model_type,
                         None if obs_len is None else obs_len.reshape(-1))
    S = lanes.shape[0]
    x0 = torch.tensor(init, dtype=ts.dtype, device=dev).expand(S, 3)
    res, _ = hw_sse.box_fit(
        inp, x0, 0.0, 1.0, tol=tol,
        max_iter=1000 if max_iter is None else max_iter, stats=stats)
    ok = torch.isfinite(res.x).all(dim=-1, keepdim=True)
    p = torch.where(ok, res.x, x0)
    conv = diagnostics_from(res, ok)
    if obs_len is not None:
        short = short_lanes(obs_len.reshape(-1), 2 * period + 1,
                            "Holt-Winters fit (two init periods + 1)")
        p, conv_mask = apply_short_quarantine(p, conv.converged, short)
        conv = conv._replace(converged=conv_mask)
    conv = FitDiagnostics(*(t.reshape(batch) for t in conv[:3]))
    p = p.reshape(*batch, 3)
    return HoltWintersModel(model_type, period, p[..., 0], p[..., 1],
                            p[..., 2], diagnostics=conv)


def _naive_seasonal_model(v, period: int,
                          model_type: str) -> HoltWintersModel:
    """Terminal fallback: α = 1, β = γ = 0 — level tracks the last
    observation, trend and the initial seasonal pattern stay frozen.
    Ragged lanes evaluate the SSE on their valid window, like the primary
    fit."""
    aligned, nv = ragged_view(torch.as_tensor(v))
    ones = torch.ones(aligned.shape[:-1], dtype=aligned.dtype,
                      device=aligned.device)
    zeros = torch.zeros_like(ones)
    m = HoltWintersModel(model_type, period, ones, zeros, zeros)
    fitted, _ = m._run(aligned)
    err = aligned[..., period:] - fitted[..., period:]
    if nv is None:
        sse = (err * err).sum(dim=-1)
        ok = torch.isfinite(sse)
    else:
        w = step_weights(err.shape[-1], nv[..., None], offset=period,
                         dtype=aligned.dtype)
        # zero the tail BEFORE squaring: a multiplicative run over the
        # zero-padded tail can emit inf, and 0 * inf is NaN
        err = torch.where(w > 0, err, torch.zeros_like(err))
        sse = (err * err).sum(dim=-1)
        ok = torch.isfinite(sse) & (nv >= 2 * period + 1)
    return m._replace(diagnostics=FitDiagnostics(
        ok, torch.zeros(sse.shape, dtype=torch.int32, device=sse.device),
        sse))
