"""Backtest tier: rolling-origin evaluation and per-series champion
selection (counterpart of ``spark_timeseries_tpu/backtest``).

- :mod:`grid`: candidate grids, rolling-origin schedules (expanding /
  sliding fit windows, min-train floors), per-family adapters;
- :mod:`evaluate`: fit-once / replay-every-origin scoring: pinned-gain
  state paths in logarithmic depth, one gathered row per origin,
  NaN-masked sMAPE / MASE / RMSE / interval coverage on the device (with
  a sequential-refilter oracle for tests), and the pointwise error
  primitives the serving tier's online accuracy shares;
- :mod:`api`: ``backtest_panel`` streaming the grid through
  ``engine.stream_fit`` into a :class:`~api.BacktestReport` of
  per-series champions, per-horizon error tables and per-origin error
  bars.
"""

from . import api, evaluate, grid  # noqa: F401
from .api import BacktestReport, backtest_panel  # noqa: F401
from .evaluate import (CandidateEval, evaluate_candidate,  # noqa: F401
                       masked_pointwise)
from .grid import (Candidate, CandidateGrid, OriginSchedule,  # noqa: F401
                   default_grid, plan_origins)

__all__ = ["backtest_panel", "BacktestReport", "evaluate_candidate",
           "CandidateEval", "Candidate", "CandidateGrid",
           "OriginSchedule", "plan_origins", "default_grid",
           "grid", "evaluate", "api"]
