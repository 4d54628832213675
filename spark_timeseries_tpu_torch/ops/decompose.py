"""Classical seasonal decomposition, batched (counterpart of
``spark_timeseries_tpu/ops/decompose.py``).

R ``stats::decompose`` semantics: a centered moving-average trend
(half-weight endpoints for even periods), seasonal figures as phase
means of the detrended series re-centered to sum to zero (additive) or
rescaled to mean one (multiplicative), and NaN trend / remainder edges
where the centered window does not fit.  The centered filter is
:func:`~spark_timeseries_tpu_torch.ops.univariate.roll_mean`'s
shifted-add sum (the even-period filter is exactly ``roll_mean(roll_mean
(x, period), 2)``); phase sums fold the series into ``(..., rows,
period)``.  Everything is batched over leading dims, on the caller's
device.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .univariate import roll_mean

__all__ = ["Decomposition", "decompose"]


class Decomposition(NamedTuple):
    """``trend`` / ``seasonal`` / ``remainder`` each shaped like the
    input; ``figure (..., period)`` is the per-phase seasonal figure."""
    trend: torch.Tensor
    seasonal: torch.Tensor
    remainder: torch.Tensor
    figure: torch.Tensor


def _centered_ma(x: torch.Tensor, period: int) -> torch.Tensor:
    """Centered moving average with NaN edges (R's ``filter(...,
    sides=2)``): odd periods ``period`` equal taps, even periods the
    ``period + 1``-tap half-weight-ends filter, a period-mean followed by
    a 2-mean."""
    if period % 2:
        core = roll_mean(x, period)
    else:
        core = roll_mean(roll_mean(x, period), 2)
    pad = x.new_full((*x.shape[:-1], period // 2), float("nan"))
    return torch.cat([pad, core, pad], dim=-1)


def _phase_sums(x: torch.Tensor, period: int) -> torch.Tensor:
    """Sums of ``x (..., n)`` by phase ``t % period``: ``(..., period)``."""
    n = x.shape[-1]
    rows = -(-n // period)
    padded = torch.nn.functional.pad(x, (0, rows * period - n))
    return padded.reshape(*x.shape[:-1], rows, period).sum(dim=-2)


def decompose(values, period: int, model: str = "additive"
              ) -> Decomposition:
    """Decompose ``values (..., n)`` (a tensor or an array) into trend +
    seasonal + remainder (additive) or trend * seasonal * remainder
    (multiplicative), batched over every leading dim.  Integer input
    promotes to float32.  Requires ``n >= 2 * period``, as R's
    ``decompose`` does."""
    if model not in ("additive", "multiplicative"):
        raise ValueError("model must be 'additive' or 'multiplicative'")
    v = torch.as_tensor(values)
    values = v.to(torch.promote_types(v.dtype, torch.float32))
    n = values.shape[-1]
    if n < 2 * period:
        raise ValueError(
            f"series of length {n} has fewer than two periods ({period})")

    trend = _centered_ma(values, period)
    detrended = values - trend if model == "additive" else values / trend

    # per-phase means over the valid (non-NaN-trend) window
    valid = torch.isfinite(detrended)
    sums = _phase_sums(torch.where(valid, detrended,
                                   torch.zeros_like(detrended)), period)
    counts = _phase_sums(valid.to(values.dtype), period)
    # a phase with no valid observation is NaN (R's na.rm mean of an
    # empty set), and the re-centering ignores it
    figure = torch.where(counts > 0, sums / counts.clamp(min=1.0),
                         torch.full_like(sums, float("nan")))
    if model == "additive":
        figure = figure - torch.nanmean(figure, dim=-1, keepdim=True)
    else:
        figure = figure / torch.nanmean(figure, dim=-1, keepdim=True)

    phase = torch.arange(n, device=values.device) % period
    seasonal = figure[..., phase]
    if model == "additive":
        remainder = values - trend - seasonal
    else:
        remainder = values / (trend * seasonal)
    return Decomposition(trend, seasonal, remainder, figure)
