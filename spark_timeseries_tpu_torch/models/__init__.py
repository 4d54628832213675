"""Batched model fits of the port (counterpart of
``spark_timeseries_tpu/models``)."""

from ..utils.resilience import FitOutcome, RetryPolicy
from . import arima, autoregression, convert, ewma, garch, holt_winters
from .arima import ARIMAModel
from .autoregression import ARModel
from .base import FitDiagnostics, TimeSeriesModel, refit_unconverged
from .ewma import EWMAModel
from .garch import ARGARCHModel, EGARCHModel, GARCHModel
from .holt_winters import HoltWintersModel

__all__ = ["TimeSeriesModel", "FitDiagnostics", "refit_unconverged",
           "FitOutcome", "RetryPolicy",
           "ewma", "EWMAModel",
           "autoregression", "ARModel",
           "arima", "ARIMAModel",
           "garch", "GARCHModel", "ARGARCHModel", "EGARCHModel",
           "holt_winters", "HoltWintersModel", "convert"]
