"""Order-d differencing and its inverse (counterpart of the differencing
section of ``spark_timeseries_tpu/ops/univariate.py``).  The rest of that
module is not ported yet."""

from __future__ import annotations

import math

import torch


def differences_at_lag(x: torch.Tensor, lag: int,
                       start_index: int | None = None) -> torch.Tensor:
    """Size-preserving difference: ``out[i] = x[i] - x[i-lag]`` for
    ``i >= start_index``; earlier elements are copied."""
    if lag == 0:
        return x
    start = lag if start_index is None else start_index
    if start < lag:
        raise ValueError("starting index cannot be less than lag")
    n = x.shape[-1]
    shifted = torch.cat([x[..., :lag], x[..., :n - lag]], dim=-1)
    keep = torch.arange(n, device=x.device) >= start
    return torch.where(keep, x - shifted, x)


def inverse_differences_at_lag(x: torch.Tensor, lag: int,
                               start_index: int | None = None
                               ) -> torch.Tensor:
    """Inverse of :func:`differences_at_lag`: ``out[i] = x[i] + out[i-lag]``
    for ``i >= start_index``, in closed form — per residue class mod
    ``lag`` the recurrence is a strided cumulative sum plus the last
    copied element of its chain."""
    if lag == 0:
        return x
    start = lag if start_index is None else start_index
    if start < lag:
        raise ValueError("starting index cannot be less than lag")
    n = x.shape[-1]
    iota = torch.arange(n, device=x.device)
    k = math.ceil(n / lag)
    pad = k * lag - n
    contrib = torch.where(iota >= start, x, torch.zeros((), dtype=x.dtype,
                                                        device=x.device))
    contrib = torch.nn.functional.pad(contrib, (0, pad))
    csum = torch.cumsum(contrib.reshape(*x.shape[:-1], k, lag), dim=-2)
    csum = csum.reshape(*x.shape[:-1], k * lag)[..., :n]
    r = iota % lag
    base_idx = r + lag * torch.div(start - 1 - r, lag, rounding_mode="floor")
    base = torch.gather(x, -1, base_idx.expand(x.shape).contiguous())
    return torch.where(iota >= start, csum + base, x)


def differences_of_order_d(x: torch.Tensor, d: int) -> torch.Tensor:
    """Recursive order-d differencing; level i starts at index i."""
    out = x
    for i in range(1, d + 1):
        out = differences_at_lag(out, 1, i)
    return out


def inverse_differences_of_order_d(x: torch.Tensor, d: int) -> torch.Tensor:
    """Inverse of :func:`differences_of_order_d`."""
    out = x
    for i in range(d, 0, -1):
        out = inverse_differences_at_lag(out, 1, i)
    return out
