"""Batched tensor ops of the port (counterpart of
``spark_timeseries_tpu/ops``)."""

from . import optimize, scan_parallel
from .anomaly import AnomalyResult, detect_anomalies
from .decompose import Decomposition, decompose
from .scan_parallel import (affine_recurrence, ar1_filter, ewma_smooth,
                            garch_variance, linear_recurrence)

__all__ = ["optimize", "scan_parallel", "AnomalyResult",
           "detect_anomalies", "Decomposition", "decompose",
           "linear_recurrence", "affine_recurrence", "ewma_smooth",
           "ar1_filter", "garch_variance"]
