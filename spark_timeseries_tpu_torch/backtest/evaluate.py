"""Forecast-error definitions (the part of
``spark_timeseries_tpu/backtest/evaluate.py`` the serving tier's online
accuracy needs)."""

from __future__ import annotations

import torch

__all__ = ["masked_pointwise"]


def masked_pointwise(fcst: torch.Tensor, actual: torch.Tensor):
    """The NaN-masked pointwise error primitives every quality consumer
    shares (the serving tier's fused online-accuracy step,
    ``statespace.quality.quality_step``).

    A point contributes only when both forecast and actual are finite;
    sMAPE's 0/0 (both sides zero, a perfect forecast of a zero)
    contributes 0.  Returns ``(mask, abserr, smape_pt)`` with masked-out
    points zeroed, at any broadcastable shape."""
    mask = torch.isfinite(actual) & torch.isfinite(fcst)
    zero = torch.zeros((), dtype=actual.dtype, device=actual.device)
    a = torch.where(mask, actual, zero)
    f = torch.where(mask, fcst, zero)
    abserr = (f - a).abs()
    denom = f.abs() + a.abs()
    pos = denom > 0
    smape_pt = torch.where(
        pos, 200.0 * abserr / torch.where(pos, denom, torch.ones_like(denom)),
        torch.zeros_like(abserr))
    return mask, abserr, smape_pt
