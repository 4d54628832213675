"""Backtest tier of the port (counterpart of
``spark_timeseries_tpu/backtest``).  Ported so far: the NaN-masked
pointwise error primitives (:func:`evaluate.masked_pointwise`) that the
serving tier's online accuracy shares.  The rolling-origin backtest,
its grids and the champion selection wait for ROADMAP Queue A item 3."""

from . import evaluate  # noqa: F401
from .evaluate import masked_pointwise  # noqa: F401

__all__ = ["evaluate", "masked_pointwise"]
