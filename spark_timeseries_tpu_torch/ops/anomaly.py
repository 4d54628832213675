"""Residual-based anomaly detection over fitted panels, batched
(counterpart of ``spark_timeseries_tpu/ops/anomaly.py``).

ARIMA_PLUS's model-based recipe: fit any model family, score each
observation by its one-step prediction residual against a per-series
noise scale, and flag points outside the confidence band.  Anything that
gives fitted one-step values works (``arima_model.forecast(ts, 1)[...,
:n]``, a Holt-Winters model's ``add_time_dependent_effects``, the EWMA
smooth, a ``decompose`` trend + season).  Elementwise passes and
per-series medians over the time axis, on the caller's device.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..models.base import normal_quantile

__all__ = ["AnomalyResult", "detect_anomalies"]


class AnomalyResult(NamedTuple):
    """``is_anomaly`` / ``score`` have the input's shape; ``sigma`` /
    ``center`` drop the time axis.  ``score`` is the absolute centered
    residual in sigma units, zeroed inside the burn-in window, so
    ``score > threshold_z`` holds exactly where a point is flagged."""
    is_anomaly: torch.Tensor
    score: torch.Tensor
    sigma: torch.Tensor
    center: torch.Tensor
    threshold_z: torch.Tensor


def _nanmedian(x: torch.Tensor) -> torch.Tensor:
    """Median over the last axis ignoring NaN, the mean of the two middle
    values for an even count (numpy's and the JAX package's; PyTorch's
    ``nanmedian`` takes the lower one), NaN for an all-NaN row.  One
    sort: NaN sorts last."""
    srt = torch.sort(x, dim=-1).values
    k = (~torch.isnan(x)).sum(dim=-1, keepdim=True)
    lo = torch.gather(srt, -1, ((k - 1) // 2).clamp(min=0))
    hi = torch.gather(srt, -1, (k // 2).clamp(max=x.shape[-1] - 1))
    mid = (lo + hi) * 0.5
    return torch.where(k > 0, mid, torch.full_like(mid, float("nan"))) \
        .squeeze(-1)


def _as_float(x, dtype: torch.dtype, device) -> torch.Tensor:
    return torch.as_tensor(x, device=device).to(dtype)


def detect_anomalies(values, fitted, conf: float = 0.99,
                     robust: bool = True, burn_in: int = 0
                     ) -> AnomalyResult:
    """Flag observations whose residual ``values - fitted`` falls outside
    the two-sided ``conf`` band of the per-series noise distribution.

    ``robust=True`` (default) estimates the noise scale by the median
    absolute deviation (× 1.4826, sigma-consistent under Gaussian noise),
    so the anomalies hunted do not inflate the threshold hunting them; a
    lane whose MAD is 0 (half its residuals tie at the median) falls back
    to the standard deviation.  ``robust=False`` uses the standard
    deviation.  ``burn_in`` masks the first observations from both the
    scale estimate and the flags (model warm-up positions).

    ``values`` / ``fitted`` are ``(..., n)`` tensors or arrays (on
    ``values``' device; integer panels promote to float32); returns
    :class:`AnomalyResult`."""
    v = torch.as_tensor(values)
    dtype = torch.promote_types(v.dtype, torch.float32)
    values = v.to(dtype)
    fitted = _as_float(fitted, dtype, values.device)
    if fitted.shape != values.shape:
        raise ValueError(
            f"fitted must match values' shape {tuple(values.shape)}; got "
            f"{tuple(fitted.shape)} — pass the one-step fitted view, not a "
            f"future forecast")
    n = values.shape[-1]
    if not 0 <= burn_in < n:
        raise ValueError(f"burn_in must be in [0, {n}); got {burn_in}")

    resid = values - fitted
    t_ok = torch.arange(n, device=values.device) >= burn_in
    masked = torch.where(t_ok, resid, torch.full_like(resid, float("nan")))
    center = _nanmedian(masked) if robust else torch.nanmean(masked, dim=-1)
    dev = masked - center[..., None]
    std = torch.sqrt(torch.nanmean(dev * dev, dim=-1))
    if robust:
        mad = 1.4826 * _nanmedian(torch.abs(dev))
        sigma = torch.where(mad > 0, mad, std)
    else:
        sigma = std

    z = normal_quantile(conf, dtype).to(values.device)
    # a constant-residual series has sigma 0: nothing is anomalous by
    # its own (degenerate) noise model, rather than everything
    safe = torch.where(sigma > 0, sigma, torch.full_like(sigma,
                                                         float("inf")))
    score = torch.where(t_ok,
                        torch.abs(resid - center[..., None])
                        / safe[..., None],
                        torch.zeros((), dtype=dtype, device=values.device))
    return AnomalyResult(score > z, score, sigma, center,
                         torch.broadcast_to(z, sigma.shape))
