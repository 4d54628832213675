"""Optimizer result type (counterpart of ``MinimizeResult`` in
``spark_timeseries_tpu/ops/optimize.py``).  The port's one solver so far
is the batched Levenberg-Marquardt solver ``ops.arma_ne.fit_css_lm``;
the multi-start ``attempts`` field waits for the retry path."""

from __future__ import annotations

from typing import NamedTuple

import torch


class MinimizeResult(NamedTuple):
    """Batched optimization artifacts (leading dims ``...`` = batch)."""
    x: torch.Tensor          # (..., p) optimal parameters
    fun: torch.Tensor        # (...,)   objective at optimum
    converged: torch.Tensor  # (...,)   bool per-lane convergence mask
    n_iter: torch.Tensor     # (...,)   iterations taken
