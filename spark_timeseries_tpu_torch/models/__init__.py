"""Batched model fits of the port (counterpart of
``spark_timeseries_tpu/models``)."""

from ..utils.resilience import FitOutcome, RetryPolicy
from . import (arima, arimax, autoregression, autoregression_x, convert,
               ewma, garch, holt_winters, regression_arima)
from .arima import ARIMAModel
from .arimax import ARIMAXModel
from .autoregression import ARModel
from .autoregression_x import ARXModel
from .base import FitDiagnostics, TimeSeriesModel, refit_unconverged
from .ewma import EWMAModel
from .garch import ARGARCHModel, EGARCHModel, GARCHModel
from .holt_winters import HoltWintersModel
from .regression_arima import RegressionARIMAModel

__all__ = ["TimeSeriesModel", "FitDiagnostics", "refit_unconverged",
           "FitOutcome", "RetryPolicy",
           "ewma", "EWMAModel",
           "autoregression", "ARModel",
           "autoregression_x", "ARXModel",
           "arima", "ARIMAModel",
           "arimax", "ARIMAXModel",
           "regression_arima", "RegressionARIMAModel",
           "garch", "GARCHModel", "ARGARCHModel", "EGARCHModel",
           "holt_winters", "HoltWintersModel", "convert"]
