"""Ultra-long series tier: DARIMA split-and-combine (counterpart of
``spark_timeseries_tpu/longseries``).

A single series with 10⁶–10⁸ observations cannot be fitted by any batch
path: the CSS MA recursion is sequential in t.  This subsystem changes
the axis (arXiv 2007.09577, "Distributed ARIMA Models for Ultra-long
Time Series"):

- :mod:`split`: partition the obs axis into contiguous (optionally
  overlapping) windows, an ``(n_segments, window)`` panel;
- :mod:`combine`: map each segment's ARMA estimate into the common
  truncated-AR(∞) space and combine with design-gram WLS weights, on the
  device chunk by chunk (fused with the segment fit: one ``arma_lm_fit``
  launch a chunk on the card);
- :mod:`api`: :func:`fit_long` plus exact forecasting over the FULL
  series (``statespace.kalman.filter_forecast_origin``).
"""

from . import api, combine, split  # noqa: F401
from .api import FusedDurabilityError, LongSeriesFit, fit_long  # noqa: F401
from .combine import CombinedResult, combine_segments  # noqa: F401
from .split import segment_panel, segment_plan, tail_ring  # noqa: F401

__all__ = ["api", "combine", "split", "fit_long", "LongSeriesFit",
           "combine_segments", "CombinedResult", "segment_panel",
           "segment_plan", "tail_ring"]
