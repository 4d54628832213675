"""Per-lane serving health: divergence detection and quarantine
(counterpart of ``spark_timeseries_tpu/statespace/health.py``).

The monitor runs inside every serving tick (``serving._update_impl``) as
tensor math over the same ``(bucket,)`` lanes the filter touches: no host
branch and no synchronization inside a tick.  Three signals feed one
per-lane status in the ``ok(0) < suspect(1) < diverged(2)`` lattice (the
quality plane, :mod:`.quality`, adds ``drifted(3)``):

- **standardized-innovation tracking**: on a well-specified lane ``ν²/F``
  is χ²₁ (mean 1, variance 2).  Its exponentially-weighted mean (``ew' =
  (1−α)·ew + α·ν²/F``, missing ticks hold) has a standard deviation of
  about ``sqrt(α/(2−α) · 2)`` at stationarity, so the band edges are
  z-scores: the defaults (α = 0.02, σ_ew ≈ 0.142) put ``suspect`` near
  1 + 8.5σ and ``diverged`` near 1 + 21σ;
- **non-finite detection**: a NaN or inf in the lane's predicted state,
  covariance or difference ring, a non-finite innovation on an observed
  tick, or a non-positive innovation variance is ``diverged`` at once;
- **covariance conditioning**: ``HealthPolicy.joseph`` runs the exact
  mode's covariance update in the Joseph form (``kalman._update``),
  symmetric positive semi-definite by construction.

``diverged`` is sticky and quarantines the lane: its later ticks are
masked to missing (a ``torch.where`` in the same step: predict-only, no
likelihood), until ``ServingSession.heal()`` refits it and splices a
fresh state in.  ``suspect`` is advisory and self-clearing.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from .kalman import filter_step_panel
from .ssm import FilterState, SSMeta, StateSpace

__all__ = ["LANE_OK", "LANE_SUSPECT", "LANE_DIVERGED", "LANE_DRIFTED",
           "LANE_NAMES", "HealthPolicy", "LaneHealth", "initial_health",
           "monitored_step", "monitor_panel", "shed_priority"]

LANE_OK = 0        # EW standardized-innovation score inside the χ² band
LANE_SUSPECT = 1   # score out of band but finite: advisory, self-clears
LANE_DIVERGED = 2  # non-finite state/covariance or score far out of band:
#                    sticky, quarantined (predict-only) until heal
LANE_DRIFTED = 3   # the quality plane's drift alarm: serves on, sticky
#                    until heal(drifted=True)

LANE_NAMES = {LANE_OK: "ok", LANE_SUSPECT: "suspect",
              LANE_DIVERGED: "diverged", LANE_DRIFTED: "drifted"}


class HealthPolicy(NamedTuple):
    """The health knobs.  ``ew_alpha`` is the EW weight of the
    standardized-innovation mean; ``suspect_hi`` / ``diverged_hi`` the
    band edges on that mean; ``joseph`` selects the stabilized covariance
    update for exact-mode lanes; ``forecast_policy`` is what quarantined
    lanes report from ``forecast``: ``"nan"`` or ``"last_good"`` (mean
    propagation from the lane's last pre-divergence state)."""
    ew_alpha: float = 0.02
    suspect_hi: float = 2.2
    diverged_hi: float = 4.0
    joseph: bool = True
    forecast_policy: str = "nan"

    def validate(self) -> "HealthPolicy":
        if not 0.0 < self.ew_alpha <= 1.0:
            raise ValueError(f"ew_alpha must be in (0, 1], "
                             f"got {self.ew_alpha}")
        if not 1.0 < self.suspect_hi < self.diverged_hi:
            raise ValueError(
                f"need 1 < suspect_hi < diverged_hi, got "
                f"{self.suspect_hi} / {self.diverged_hi}")
        if self.forecast_policy not in ("nan", "last_good"):
            raise ValueError(
                f"forecast_policy must be 'nan' or 'last_good', "
                f"got {self.forecast_policy!r}")
        return self


class LaneHealth(NamedTuple):
    """Per-lane monitor carry beside ``FilterState``: ``ew`` the EW mean
    of ``ν²/F`` (starts at 1.0, the χ²₁ mean), ``status`` the ``LANE_*``
    code, ``good_a`` / ``good_ring`` the last non-diverged predicted state
    mean and difference ring (the ``"last_good"`` forecast source)."""
    ew: torch.Tensor         # (S,)
    status: torch.Tensor     # (S,) int32
    good_a: torch.Tensor     # (S, m)
    good_ring: torch.Tensor  # (S, d_order)


def initial_health(state: FilterState) -> LaneHealth:
    """All-OK monitor state seeded from a (bootstrapped) filter state."""
    a = state.a
    S = a.shape[0]
    return LaneHealth(ew=torch.ones((S,), dtype=a.dtype, device=a.device),
                      status=torch.zeros((S,), dtype=torch.int32,
                                         device=a.device),
                      good_a=a, good_ring=state.ring)


def monitored_step(ssm: StateSpace, state: FilterState, health: LaneHealth,
                   y: torch.Tensor, offset: torch.Tensor, meta: SSMeta,
                   policy: HealthPolicy
                   ) -> Tuple[FilterState, LaneHealth,
                              Tuple[torch.Tensor, torch.Tensor]]:
    """One health-monitored tick across the panel: quarantined lanes see
    a masked (missing) tick and predict forward; everyone else filters,
    then the three signals update the lane status.  Returns ``(state',
    health', (v, F))``."""
    quarantined = health.status == LANE_DIVERGED
    nan = torch.full((), float("nan"), dtype=y.dtype, device=y.device)
    y_eff = torch.where(quarantined, nan, y)
    state2, (v, F) = filter_step_panel(ssm, state, y_eff, offset, meta,
                                       joseph=policy.joseph)

    observed = torch.isfinite(y_eff)
    score = v * v / F
    score_ok = torch.isfinite(score)
    alpha = policy.ew_alpha
    ew = torch.where(observed & score_ok,
                     (1.0 - alpha) * health.ew + alpha * score, health.ew)

    finite = (torch.isfinite(state2.a).all(dim=-1)
              & torch.isfinite(state2.P).all(dim=-1).all(dim=-1)
              & torch.isfinite(state2.ring).all(dim=-1)
              & torch.isfinite(ew))
    f_bad = observed & ~(torch.isfinite(F) & (F > 0))
    v_bad = observed & ~score_ok
    bad_now = ~finite | f_bad | v_bad

    status = torch.where(ew > policy.suspect_hi, LANE_SUSPECT, LANE_OK)
    status = torch.where((ew > policy.diverged_hi) | bad_now | quarantined,
                         LANE_DIVERGED, status).to(torch.int32)

    good = status != LANE_DIVERGED
    good_a = torch.where(good[:, None], state2.a, health.good_a)
    good_ring = torch.where(good[:, None], state2.ring, health.good_ring) \
        if meta.d_order else health.good_ring
    return state2, LaneHealth(ew, status, good_a, good_ring), (v, F)


def shed_priority(status) -> Tuple[int, int, int]:
    """A tenant's rank in the fleet's shed ladder over a lane-status
    vector: ``(n_diverged, n_drifted, n_suspect)``, compared
    lexicographically descending (the ``ok < suspect < drifted <
    diverged`` severity order).  Host math."""
    s = status.cpu().numpy() if isinstance(status, torch.Tensor) \
        else np.asarray(status)
    return (int(np.sum(s == LANE_DIVERGED)),
            int(np.sum(s == LANE_DRIFTED)),
            int(np.sum(s == LANE_SUSPECT)))


def monitor_panel(ssm: StateSpace, state: FilterState, health: LaneHealth,
                  ys, meta: SSMeta, policy: HealthPolicy,
                  offsets: Optional[torch.Tensor] = None
                  ) -> Tuple[FilterState, LaneHealth]:
    """Stream a whole ``(S, n)`` tick panel through :func:`monitored_step`
    (a loop over the ``n`` ticks; the JAX package's ``lax.scan``): the
    batch driver for calibration testing and bulk catch-up."""
    ys = torch.as_tensor(ys, device=state.a.device)
    rows = int(state.a.shape[0])
    if ys.ndim != 2 or int(ys.shape[0]) != rows:
        raise ValueError(
            f"monitor_panel expects a (S, n) tick panel with S == the "
            f"filter state's {rows} bucketed lanes, got shape "
            f"{tuple(ys.shape)}; pad the panel to the session bucket "
            f"(or transpose a time-major stream) first")
    offs = torch.zeros_like(ys) if offsets is None \
        else torch.as_tensor(offsets, dtype=ys.dtype, device=ys.device)
    for t in range(ys.shape[1]):
        state, health, _ = monitored_step(ssm, state, health, ys[:, t],
                                          offs[:, t], meta, policy)
    return state, health
