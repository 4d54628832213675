"""Batched model fits of the port (counterpart of
``spark_timeseries_tpu/models``)."""

from . import arima, autoregression, convert, holt_winters

__all__ = ["arima", "autoregression", "convert", "holt_winters"]
