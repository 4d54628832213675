"""Model-tier base types (counterpart of
``spark_timeseries_tpu/models/base.py``).  Models are NamedTuples of
tensors whose parameter fields may carry a leading ``(n_series,)`` dim:
one model object is a whole panel's fit."""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch


def normal_quantile(conf, dtype=torch.float64) -> torch.Tensor:
    """Two-sided standard-normal quantile: ``z`` with ``P(|Z| < z) =
    conf`` (1.95996 at 0.95)."""
    return math.sqrt(2.0) * torch.erfinv(torch.as_tensor(conf, dtype=dtype))


class FitDiagnostics(NamedTuple):
    """Per-lane optimizer outcome attached to every fitted model.

    ``converged`` is False for lanes whose optimizer hit its iteration cap
    and for lanes quarantined back to their initial guess; ``fun`` is the
    objective at the returned parameters.  ``attempts`` is the per-lane
    multi-start solve count of a fit with a retry policy; no fit of the
    port has one yet, so it is None."""
    converged: torch.Tensor   # bool (...,)
    n_iter: torch.Tensor      # (...,)
    fun: torch.Tensor         # (...,)
    attempts: Optional[torch.Tensor] = None   # (...,) multi-start solves


def diagnostics_from(res, lane_ok=None) -> FitDiagnostics:
    """:class:`FitDiagnostics` from a ``MinimizeResult``; ``lane_ok`` (True
    = kept the optimizer's result) demotes quarantined lanes, and a lane
    with a non-finite objective is never converged."""
    converged = res.converged
    if lane_ok is not None:
        converged = converged & lane_ok.reshape(converged.shape)
    return FitDiagnostics(converged & torch.isfinite(res.fun), res.n_iter,
                          res.fun)
