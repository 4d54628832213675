"""Live forecast-quality plane: per-tick anomaly scores, rolling online
accuracy and drift alarms, inside the serving tick (counterpart of
``spark_timeseries_tpu/statespace/quality.py``).

Three signals per lane, per tick, all tensor math in the same tick as
the filter and the health monitor (``serving._update_impl``):

- **anomaly score**: the standardized innovation ``ν/√F`` and its EW
  aggregate (``LaneHealth.ew``), on every ``TickResult``;
- **rolling online accuracy**: a bounded ring of the session's own
  ``horizon``-step forecasts (:class:`QualityState.fc_ring`) scores each
  arriving actual with the backtest tier's NaN-masked definitions
  (``backtest.evaluate.masked_pointwise``: sMAPE, MASE against the
  fit-time naive-MAE scale, interval coverage against the model's own
  ψ-weight half-widths), folded into EW means;
- **drift alarm**: a Page-Hinkley detector on ``ν²/F`` against its
  baseline of 1, ``ph' = max(0, ph + ν²/F − 1 − ph_delta)``; ``ph >
  ph_lambda`` trips a sticky ``drifted`` status (``health.LANE_DRIFTED``),
  which ``ServingSession.heal(drifted=True)`` clears by a refit.

ARX: online scoring adds the tick's own exogenous offset to the stored
forecast, exact at ``horizon=1``; at ``horizon>1`` the future offsets
are unknown at forecast time and taken as zero.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..backtest.evaluate import masked_pointwise
from ..models.base import normal_quantile
from .health import LANE_DIVERGED, LANE_DRIFTED, LaneHealth, monitored_step
from .kalman import _mv, forecast_mean
from .ssm import FilterState, SSMeta, StateSpace

__all__ = ["QualityPolicy", "QualityState", "initial_quality",
           "quality_step", "quality_panel", "forecast_half_widths",
           "naive_scale"]


class QualityPolicy(NamedTuple):
    """The quality knobs: ``horizon`` the online-accuracy lead time (the
    forecast ring's depth), ``ew_alpha`` the EW weight of the online
    sMAPE / MASE / coverage means, ``ph_delta`` / ``ph_lambda`` the
    Page-Hinkley allowance and alarm threshold, ``coverage`` the nominal
    level of the online interval coverage."""
    horizon: int = 1
    ew_alpha: float = 0.05
    ph_delta: float = 0.5
    ph_lambda: float = 50.0
    coverage: float = 0.9

    def validate(self) -> "QualityPolicy":
        if int(self.horizon) < 1:
            raise ValueError(f"horizon must be >= 1, got {self.horizon}")
        if not isinstance(self.horizon, int):
            # equal policies must compare equal: 2 and 2.0 are one horizon
            return self._replace(horizon=int(self.horizon)).validate()
        if not 0.0 < self.ew_alpha <= 1.0:
            raise ValueError(f"ew_alpha must be in (0, 1], "
                             f"got {self.ew_alpha}")
        if self.ph_delta <= 0 or self.ph_lambda <= 0:
            raise ValueError(
                f"ph_delta/ph_lambda must be > 0, got "
                f"{self.ph_delta}/{self.ph_lambda}")
        if not 0.0 < self.coverage < 1.0:
            raise ValueError(f"coverage must be in (0, 1), "
                             f"got {self.coverage}")
        return self


class QualityState(NamedTuple):
    """Per-lane quality carry beside ``FilterState`` / ``LaneHealth``:
    ``fc_ring[:, pos]`` the raw-scale ``horizon``-step forecast made for
    the current tick, ``pos`` cycling 0..horizon−1, ``warm`` saturating
    at ``horizon``; ``scale`` the fit-time lag-1 naive MAE and ``half``
    the ψ-weight interval half-width (constants refreshed on heal);
    ``ew_*`` / ``n_scored`` the EW online metrics; ``ph`` the
    Page-Hinkley statistic and ``drifted`` the sticky alarm."""
    fc_ring: torch.Tensor    # (S, horizon)
    pos: torch.Tensor        # (S,) int32
    warm: torch.Tensor       # (S,) int32, saturates at horizon
    scale: torch.Tensor      # (S,)
    half: torch.Tensor       # (S,)
    ew_smape: torch.Tensor   # (S,)
    ew_mase: torch.Tensor    # (S,)
    ew_cover: torch.Tensor   # (S,)
    n_scored: torch.Tensor   # (S,) int32
    ph: torch.Tensor         # (S,)
    drifted: torch.Tensor    # (S,) bool


def initial_quality(n_series: int, policy: QualityPolicy, dtype, scale,
                    half, device=None) -> QualityState:
    """A cold quality state: empty forecast ring, zeroed EW metrics and
    drift statistic; ``scale`` / ``half`` the per-lane baselines
    (:func:`naive_scale` / :func:`forecast_half_widths`)."""
    S = int(n_series)
    if device is None and isinstance(half, torch.Tensor):
        device = half.device
    zeros = torch.zeros((S,), dtype=dtype, device=device)
    zi = torch.zeros((S,), dtype=torch.int32, device=device)
    return QualityState(
        fc_ring=torch.full((S, int(policy.horizon)), float("nan"),
                           dtype=dtype, device=device),
        pos=zi, warm=zi,
        scale=torch.as_tensor(scale, dtype=dtype).to(device),
        half=torch.as_tensor(half, dtype=dtype).to(device),
        ew_smape=zeros, ew_mase=zeros, ew_cover=zeros, n_scored=zi,
        ph=zeros, drifted=torch.zeros((S,), dtype=torch.bool,
                                      device=device))


def naive_scale(history) -> np.ndarray:
    """Per-lane lag-1 naive MAE of a raw history window (NaN pairs
    masked): the fit-time MASE denominator.  Host numpy, float64; lanes
    with no finite pair are NaN."""
    if isinstance(history, torch.Tensor):
        history = history.cpu().numpy()
    h = np.asarray(history, np.float64)
    if h.ndim == 1:
        h = h[None]
    if h.shape[1] < 2:
        return np.full((h.shape[0],), np.nan)
    d1 = h[:, 1:] - h[:, :-1]
    m = np.isfinite(d1)
    cnt = m.sum(axis=1)
    s = np.where(m, np.abs(d1), 0.0).sum(axis=1)
    return np.where(cnt > 0, s / np.maximum(cnt, 1), np.nan)


def forecast_half_widths(ssm: StateSpace, meta: SSMeta, horizon: int,
                         conf: float) -> torch.Tensor:
    """``conf``-level forecast-band half-widths at lead time ``horizon``,
    per lane, off a serving-calibrated state-space form (σ² already in
    Q / H).  Exact mode reads the noise loading off ``Q``'s first column
    (``σ² = Q[0,0]``, ``σR = Q[:, 0]/σ``); innovations mode is ``ψ₀ = σ,
    ψ_k = σ·Z T^{k-1} gain``; ``d_order`` integrations are cumulative
    sums of the ψ sequence."""
    tiny = torch.full((), 1e-30, dtype=ssm.T.dtype, device=ssm.T.device)
    psis = []
    if meta.mode == "exact":
        s2 = torch.maximum(ssm.Q[:, 0, 0], tiny)
        x = ssm.Q[:, :, 0] / torch.sqrt(s2)[:, None]
        for _ in range(int(horizon)):
            psis.append((ssm.Z * x).sum(dim=-1))
            x = _mv(ssm.T, x)
    else:
        s = torch.sqrt(torch.maximum(ssm.H, tiny))
        x = ssm.gain * s[:, None]
        psis.append(s)
        for _ in range(int(horizon) - 1):
            psis.append((ssm.Z * x).sum(dim=-1))
            x = _mv(ssm.T, x)
    psi = torch.stack(psis, dim=-1)                          # (S, H)
    for _ in range(meta.d_order):
        psi = torch.cumsum(psi, dim=-1)
    var = torch.cumsum(psi * psi, dim=-1)[:, int(horizon) - 1]
    z = normal_quantile(float(conf), ssm.T.dtype).to(ssm.T.device)
    return z * torch.sqrt(var)


def quality_step(policy: QualityPolicy, meta: SSMeta, ssm: StateSpace,
                 state2: FilterState, health2: LaneHealth,
                 qstate: QualityState, y: torch.Tensor,
                 offset: torch.Tensor, v: torch.Tensor, f: torch.Tensor
                 ) -> Tuple[LaneHealth, QualityState]:
    """One quality tick across the panel, right after
    ``health.monitored_step``: score the ring's due forecast against
    ``y``, fold the EW online metrics, advance the Page-Hinkley statistic,
    overlay the sticky ``drifted`` status (never demoting ``diverged``),
    and write the next ``horizon``-step forecast into the freed slot.
    Returns ``(health', qstate')``."""
    dtype = y.dtype
    H = policy.horizon
    S = y.shape[0]
    zero = torch.zeros((), dtype=dtype, device=y.device)
    nan = torch.full((), float("nan"), dtype=dtype, device=y.device)
    pos = qstate.pos.long()[:, None]

    # v is NaN exactly on missing and quarantined (predict-only) ticks
    observed = torch.isfinite(v) & torch.isfinite(f) & (f > 0)
    score = torch.where(observed, v * v / f, zero)

    # the forecast made `horizon` ticks ago against this tick (its
    # exogenous offset added back: exact at horizon 1)
    fc_due = torch.gather(qstate.fc_ring, 1, pos)[:, 0] + offset
    ring_warm = qstate.warm >= H
    mask, abserr, smape_pt = masked_pointwise(
        torch.where(ring_warm, fc_due, nan), torch.where(observed, y, nan))
    ok_scale = torch.isfinite(qstate.scale) & (qstate.scale > 0)
    mase_pt = abserr / torch.where(ok_scale, qstate.scale,
                                   torch.ones_like(qstate.scale))
    cover_pt = (abserr <= qstate.half).to(dtype)

    beta = policy.ew_alpha
    first_ever = qstate.n_scored == 0

    def ew_fold(ew, pt, m):
        # seed on each metric's own first valid point (a NaN-scale lane
        # must never seed its MASE with an unscaled error)
        upd = (1.0 - beta) * ew + beta * pt
        return torch.where(m & first_ever, pt, torch.where(m, upd, ew))

    ew_smape = ew_fold(qstate.ew_smape, smape_pt, mask)
    ew_mase = ew_fold(qstate.ew_mase, mase_pt, mask & ok_scale)
    ew_cover = ew_fold(qstate.ew_cover, cover_pt, mask)
    n_scored = qstate.n_scored + mask.to(torch.int32)

    # Page-Hinkley on ν²/F against its baseline of 1 (holds on unscored
    # ticks; sticky: only heal resets it)
    ph = torch.where(observed,
                     torch.clamp(qstate.ph + score - 1.0 - policy.ph_delta,
                                 min=0.0),
                     qstate.ph)
    drifted = qstate.drifted | (ph > policy.ph_lambda)

    status = torch.where((health2.status != LANE_DIVERGED) & drifted,
                         LANE_DRIFTED, health2.status).to(torch.int32)

    # the next horizon-step forecast into the slot just scored (raw
    # scale, through the post-update difference ring)
    fc_new = forecast_mean(meta, H, ssm, state2.a, state2.ring,
                           torch.zeros((S, H), dtype=dtype,
                                       device=y.device))[:, H - 1]
    qstate2 = QualityState(
        fc_ring=qstate.fc_ring.scatter(1, pos, fc_new[:, None]),
        pos=torch.remainder(qstate.pos + 1, H).to(torch.int32),
        warm=torch.clamp(qstate.warm + 1, max=H).to(torch.int32),
        scale=qstate.scale, half=qstate.half,
        ew_smape=ew_smape, ew_mase=ew_mase, ew_cover=ew_cover,
        n_scored=n_scored, ph=ph, drifted=drifted)
    return health2._replace(status=status), qstate2


def quality_panel(ssm: StateSpace, state: FilterState, health: LaneHealth,
                  qstate: QualityState, ys, meta: SSMeta, policy,
                  quality, offsets: Optional[torch.Tensor] = None
                  ) -> Tuple[FilterState, LaneHealth, QualityState]:
    """Stream a whole ``(S, n)`` tick panel through the monitored and
    quality steps (a loop over the ticks; the JAX package's
    ``lax.scan``), with the per-tick ``ServingSession.update``
    semantics."""
    ys = torch.as_tensor(ys, device=state.a.device)
    rows = int(state.a.shape[0])
    if ys.ndim != 2 or int(ys.shape[0]) != rows:
        raise ValueError(
            f"quality_panel expects a (S, n) tick panel with S == the "
            f"filter state's {rows} bucketed lanes, got shape "
            f"{tuple(ys.shape)}; pad the panel to the session bucket "
            f"(or transpose a time-major stream) first")
    offs = torch.zeros_like(ys) if offsets is None \
        else torch.as_tensor(offsets, dtype=ys.dtype, device=ys.device)
    for t in range(ys.shape[1]):
        y, off = ys[:, t], offs[:, t]
        state2, health2, (v, f) = monitored_step(ssm, state, health, y, off,
                                                 meta, policy)
        health, qstate = quality_step(quality, meta, ssm, state2, health2,
                                      qstate, y, off, v, f)
        state = state2
    return state, health, qstate
