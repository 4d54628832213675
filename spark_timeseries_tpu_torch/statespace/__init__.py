"""State-space and Kalman core of the port (counterpart of
``spark_timeseries_tpu/statespace``): :mod:`ssm` (the representation and
filter-state types), :mod:`kalman` (the step, whole-series and
logarithmic-depth filters and the likelihood pieces) and :mod:`convert`
(fitted model -> state-space form, history bootstrap, and the exact ARMA
likelihood that ``models.arima.fit(objective="exact")`` maximizes).

Not ported yet: the serving tier built on them (``serving``,
``health``, ``quality``; ROADMAP Queue A item 4b) and the fleet and its
runtime (``fleet``, ``runtime``; item 7).
"""

from . import convert, kalman, ssm  # noqa: F401
from .convert import (Bootstrapped, arma_concentrated_neg_ll,  # noqa: F401
                      bootstrap, companion_arma, to_statespace)
from .kalman import (FilterResult, concentrated_loglik,  # noqa: F401
                     filter_forecast_origin, filter_panel,
                     filter_panel_parallel, filter_step_panel,
                     forecast_mean, pinned_state_path, steady_gain)
from .ssm import (FilterState, SSMeta, StateSpace,  # noqa: F401
                  initial_state, state_nbytes, stationary_covariance,
                  stationary_mean)

__all__ = [
    "ssm", "kalman", "convert",
    "StateSpace", "SSMeta", "FilterState", "initial_state", "state_nbytes",
    "stationary_covariance", "stationary_mean",
    "filter_step_panel", "filter_panel", "filter_panel_parallel",
    "filter_forecast_origin", "forecast_mean", "pinned_state_path",
    "steady_gain", "concentrated_loglik", "FilterResult",
    "to_statespace", "bootstrap", "Bootstrapped", "companion_arma",
    "arma_concentrated_neg_ll",
]
