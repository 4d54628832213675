"""Holt-Winters triple exponential smoothing, batched (counterpart of
``spark_timeseries_tpu/models/holt_winters.py``).

Additive and multiplicative seasonality with the R ``stats::HoltWinters``
components recurrence, initialization from the first two periods, the SSE
objective over ``t >= period`` and level + trend + season forecasts with
prediction bands.  :func:`fit` minimizes the SSE over ``[0, 1]³`` with
the per-lane projected gradient of ``ops.hw_sse.box_fit`` — on CUDA, one
launch of the hand-written persistent kernel for the whole fit; on the
CPU, its plain version (``ops.optimize.minimize_box`` over the fused
value-and-grad pass).  ``retry`` re-solves the unconverged lanes from
jittered starts, one more box fit over those lanes alone each restart;
:func:`fit_resilient` is the fail-soft chain box -> mid-box start ->
naive model.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from .._device import as_tensor, resolve_device
from ..ops import hw_sse
from ..ops.optimize import _solve_with_policy
from ..ops.hw_sse import _kernel  # noqa: F401  (the JAX module's helper)
from ..ops.ragged import (apply_short_quarantine, ragged_view, short_lanes,
                          step_weights)
from ..utils import resilience as _resilience
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


def _gather_inputs(inp: hw_sse.HWInputs, lanes: torch.Tensor
                   ) -> hw_sse.HWInputs:
    """The prepared panel's rows of ``lanes`` (time-major, so columns)."""
    return inp._replace(
        y=inp.y.index_select(1, lanes).contiguous(),
        init=inp.init.index_select(1, lanes).contiguous(),
        n_valid=None if inp.n_valid is None
        else inp.n_valid.index_select(0, lanes).contiguous())


def fit(ts, period: int, model_type: str = "additive",
        init=(0.3, 0.1, 0.1), tol: float = 1e-10,
        max_iter: Optional[int] = None, retry=None, device=None,
        stats: Optional[dict] = None,
        _restart_draws=None) -> HoltWintersModel:
    """Fit ``(alpha, beta, gamma)`` by minimizing the SSE over ``[0, 1]³``
    with the batched projected gradient from the R-style
    ``(0.3, 0.1, 0.1)`` start (default ``max_iter`` 1000).

    ``ts (..., n)`` (array-like or tensor) fits in one batched solve on
    ``device`` (``None`` means CUDA, which runs float32 and raises without
    a card; pass ``device="cpu"`` for the CPU, float32 or float64).  The
    solve is ``ops.hw_sse.box_fit``: on the card one launch of the
    persistent box-fit kernel, on the CPU the plain solver, several trials
    per call (``ops.hw_sse.CPU_TRIAL_LANES``).

    ``retry`` (a ``utils.resilience.RetryPolicy``) re-solves the lanes
    that did not converge from jittered starts
    (``ops.optimize.solve_with_restarts``): attempt 0 is the plain fit,
    bit for bit, and each restart one box fit over the failing lanes
    alone, their prepared rows gathered (on the card one box-fit launch
    each); the per-lane count lands in ``diagnostics.attempts``.  The
    jitter comes from ``retry.seed`` (``ops.optimize.restart_draws``), or
    ``_restart_draws (R, S, 3)`` hands the draws in; ``max_iter``
    defaults to ``retry.max_iter`` when set.

    ``stats`` (a dict, optional) receives ``evaluations``, the ``(S,)``
    value-and-grad passes each lane needed over its attempts, and
    ``restart_lanes`` (lanes re-solved at each restart); on CUDA
    ``box_fit_launches`` (the box-fit kernel's launches, one per attempt)
    and ``box_fit_launches_per_attempt``, on the CPU the plain solver's
    ``calls``, ``iterations`` and ``trials``.

    NaN-padded panels (leading/trailing padding per lane) fit directly:
    valid windows are left-aligned and the SSE weighted to them.  Lanes
    with fewer than ``2 * period + 1`` valid observations get NaN
    parameters and ``diagnostics.converged == False``; interior gaps
    raise.
    """
    hw_sse.check_model_type(model_type)
    dev = resolve_device(device)
    ts, obs_len = ragged_view(as_tensor(ts, dev))
    batch, n = ts.shape[:-1], ts.shape[-1]
    lanes = ts.reshape(-1, n)
    inp = hw_sse.prepare(lanes, period, model_type,
                         None if obs_len is None else obs_len.reshape(-1))
    S = lanes.shape[0]
    x0 = torch.tensor(init, dtype=ts.dtype, device=dev).expand(S, 3)
    rk = _resilience.retry_kwargs(retry)
    if max_iter is None:
        max_iter = retry.max_iter if retry is not None \
            and retry.max_iter is not None else 1000
    evaluations = torch.zeros((S,), dtype=torch.int32, device=dev)
    per_attempt = []
    solver_counts = {}

    def solve(xs, idx):
        st: dict = {}
        res, ev = hw_sse.box_fit(inp if idx is None
                                 else _gather_inputs(inp, idx),
                                 xs, 0.0, 1.0, tol=tol, max_iter=max_iter,
                                 stats=st)
        if idx is None:
            evaluations.add_(ev)
        else:
            evaluations.index_add_(0, idx, ev)
        per_attempt.append(st.get("box_fit_launches", 0))
        for key in ("calls", "iterations", "trials"):
            if key in st:
                solver_counts[key] = solver_counts.get(key, 0) + st[key]
        return res[:4]

    policy: dict = {}
    res = _solve_with_policy(solve, x0, rk.get("restarts", 0),
                             rk.get("restart_scale", 0.25),
                             rk.get("restart_seed", 0), _restart_draws,
                             policy)
    if stats is not None:
        stats.update(solver_counts, evaluations=evaluations,
                     restart_lanes=policy["restart_lanes"])
        if x0.is_cuda:
            stats.update(box_fit_launches=sum(per_attempt),
                         box_fit_launches_per_attempt=per_attempt)
    ok = torch.isfinite(res.x).all(dim=-1, keepdim=True)
    p = torch.where(ok, res.x, x0)
    conv = diagnostics_from(res, ok)
    if obs_len is not None:
        short = short_lanes(obs_len.reshape(-1), 2 * period + 1,
                            "Holt-Winters fit (two init periods + 1)")
        p, conv_mask = apply_short_quarantine(p, conv.converged, short)
        conv = conv._replace(converged=conv_mask)
    conv = FitDiagnostics(*(t.reshape(batch) for t in conv[:3]),
                          None if conv.attempts is None
                          else conv.attempts.reshape(batch))
    p = p.reshape(*batch, 3)
    return HoltWintersModel(model_type, period, p[..., 0], p[..., 1],
                            p[..., 2], diagnostics=conv)


def fit_panel(panel, period: int, model_type: str = "additive",
              **kwargs) -> HoltWintersModel:
    """Batched fit of a :class:`~spark_timeseries_tpu_torch.panel.Panel`
    on its device."""
    return fit(panel.values, period, model_type, device=panel.device,
               **kwargs)


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


def _add_launches(stats: Optional[dict], stage: str, n: int) -> None:
    if stats is not None:
        by = stats.setdefault("box_fit_launches_by_stage", {})
        by[stage] = by.get(stage, 0) + int(n)
        stats["box_fit_launches"] = stats.get("box_fit_launches", 0) + int(n)


def fit_resilient(ts, period: int, model_type: str = "additive",
                  retry: Optional[_resilience.RetryPolicy] = None,
                  device=None, stats: Optional[dict] = None, **kwargs):
    """Fail-soft batched Holt-Winters on ``device`` (``None`` means CUDA):
    the box fit with multi-start retry -> a mid-box restart ``init=(0.5,
    0.3, 0.3)`` -> the naive ``α = 1`` model, each stage on the lanes
    still failing, gathered.  ``ts (n_series, n)``; returns ``(model,
    FitOutcome)``.  ``stats`` receives ``box_fit_launches`` (every
    stage's, on CUDA; 0 on the CPU), ``box_fit_launches_by_stage`` and
    the primary's ``restart_lanes``."""
    if retry is None:
        retry = _resilience.RetryPolicy()
    dev = resolve_device(device)
    values = as_tensor(ts, dev)
    if stats is not None:
        stats["box_fit_launches"] = 0

    def stage(name, **pinned):
        def run(v):
            st: dict = {}
            m = fit(v, period, model_type, device=dev, stats=st,
                    **_resilience.override_kwargs(kwargs, **pinned))
            _add_launches(stats, name, st.get("box_fit_launches", 0))
            if stats is not None and name == "box":
                stats["restart_lanes"] = st["restart_lanes"]
            return m
        return run

    chain = [
        ("box", stage("box", retry=retry)),
        ("box_midstart", stage("box_midstart", init=(0.5, 0.3, 0.3))),
        ("naive", lambda v: _naive_seasonal_model(v, period, model_type)),
    ]
    return _resilience.resilient_fit(values, chain, min_len=2 * period + 1,
                                     family="holt_winters")
