"""State-space core and online serving tier of the port (counterpart of
``spark_timeseries_tpu/statespace``): :mod:`ssm` (the representation and
filter-state types), :mod:`kalman` (the step, whole-series and
logarithmic-depth filters and the likelihood pieces), :mod:`convert`
(fitted model -> state-space form, history bootstrap, and the exact ARMA
likelihood that ``models.arima.fit(objective="exact")`` maximizes),
:mod:`health` (per-lane divergence detection and quarantine),
:mod:`quality` (per-tick anomaly scores, online accuracy off a forecast
ring, Page-Hinkley drift alarms) and :mod:`serving` (warm sessions, tick
ingest, lane healing, checkpoint/restore).

Not ported yet: the fleet and its runtime (``fleet``, ``runtime``;
ROADMAP Queue A item 4).
"""

from . import convert, health, kalman, quality, serving, ssm  # noqa: F401
from .convert import (Bootstrapped, arma_concentrated_neg_ll,  # noqa: F401
                      bootstrap, companion_arma, to_statespace)
from .health import (LANE_DIVERGED, LANE_DRIFTED, LANE_OK,  # noqa: F401
                     LANE_SUSPECT, HealthPolicy, LaneHealth,
                     initial_health, monitor_panel, monitored_step,
                     shed_priority)
from .kalman import (FilterResult, concentrated_loglik,  # noqa: F401
                     filter_forecast_origin, filter_panel,
                     filter_panel_parallel, filter_step_panel,
                     forecast_mean, pinned_state_path, steady_gain)
from .quality import (QualityPolicy, QualityState,  # noqa: F401
                      initial_quality, quality_panel, quality_step)
from .serving import (ServingRestoreMismatch, ServingSession,  # noqa: F401
                      TickResult, start_session)
from .ssm import (FilterState, SSMeta, StateSpace,  # noqa: F401
                  initial_state, state_nbytes, stationary_covariance,
                  stationary_mean)

__all__ = [
    "ssm", "kalman", "convert", "health", "quality", "serving",
    "StateSpace", "SSMeta", "FilterState", "initial_state", "state_nbytes",
    "stationary_covariance", "stationary_mean",
    "filter_step_panel", "filter_panel", "filter_panel_parallel",
    "filter_forecast_origin", "forecast_mean", "pinned_state_path",
    "steady_gain", "concentrated_loglik", "FilterResult",
    "to_statespace", "bootstrap", "Bootstrapped", "companion_arma",
    "arma_concentrated_neg_ll",
    "HealthPolicy", "LaneHealth", "initial_health",
    "monitored_step", "monitor_panel",
    "LANE_OK", "LANE_SUSPECT", "LANE_DIVERGED", "LANE_DRIFTED",
    "QualityPolicy", "QualityState", "initial_quality",
    "quality_step", "quality_panel",
    "ServingSession", "TickResult", "start_session",
    "ServingRestoreMismatch", "shed_priority",
]
