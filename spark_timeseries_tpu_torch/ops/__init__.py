"""Batched tensor ops of the port (counterpart of
``spark_timeseries_tpu/ops``)."""

from . import optimize, scan_parallel
from .scan_parallel import (affine_recurrence, ar1_filter, ewma_smooth,
                            garch_variance, linear_recurrence)

__all__ = ["optimize", "scan_parallel", "linear_recurrence",
           "affine_recurrence", "ewma_smooth", "ar1_filter",
           "garch_variance"]
