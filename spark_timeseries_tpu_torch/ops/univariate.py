"""Univariate series ops on ``(..., n)`` tensors: imputation, trimming,
differencing, ratios, autocorrelation, sampling and rolling sums
(counterpart of ``spark_timeseries_tpu/ops/univariate.py``).

The gap fills find each position's nearest valid neighbours with
``torch.cummax`` / ``torch.cummin`` over a marked iota (the JAX module's
``lax.cummax``), in int32 when ``n < 2**31`` so a (1M, 128) panel's
index tensors take 0.5 GiB each, not 1 GiB, and every elementwise step
is its own correctly rounded op, so the card's float32 fill equals the
CPU's bit for bit.  ``fill_spline`` runs on the host with scipy, as the
JAX one does; a tensor on a card is copied to the host and back.
"""

from __future__ import annotations

import math

import numpy as np
import torch

# ---------------------------------------------------------------------------
# neighbour-index primitives
# ---------------------------------------------------------------------------


def _iota(x: torch.Tensor) -> torch.Tensor:
    n = x.shape[-1]
    dtype = torch.int32 if n < 2 ** 31 - 1 else torch.int64
    return torch.arange(n, dtype=dtype, device=x.device)


def _prev_valid_idx(valid: torch.Tensor, iota: torch.Tensor
                    ) -> torch.Tensor:
    """Index of the nearest valid position at or before each position;
    -1 when none exists."""
    marked = torch.where(valid, iota, iota.new_tensor(-1))
    return torch.cummax(marked, dim=-1).values


def _next_valid_idx(valid: torch.Tensor, iota: torch.Tensor
                    ) -> torch.Tensor:
    """Index of the nearest valid position at or after each position; n
    when none exists."""
    n = valid.shape[-1]
    marked = torch.where(valid, iota, iota.new_tensor(n))
    return torch.flip(torch.cummin(torch.flip(marked, (-1,)), dim=-1).values,
                      (-1,))


def _gather(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    return torch.gather(x, -1, idx.expand(x.shape))


def _nan(x: torch.Tensor) -> torch.Tensor:
    return x.new_tensor(float("nan"))


# ---------------------------------------------------------------------------
# imputation
# ---------------------------------------------------------------------------


def fill_value(x: torch.Tensor, filler: float) -> torch.Tensor:
    """Replace NaNs with a constant."""
    return torch.where(torch.isnan(x), x.new_tensor(filler), x)


fill_with_default = fill_value


def fill_previous(x: torch.Tensor) -> torch.Tensor:
    """Carry the last valid value forward; leading NaNs stay NaN."""
    pidx = _prev_valid_idx(~torch.isnan(x), _iota(x))
    out = _gather(x, pidx.clamp(min=0))
    return torch.where(pidx < 0, _nan(x), out)


def fill_next(x: torch.Tensor) -> torch.Tensor:
    """Carry the next valid value backward; trailing NaNs stay NaN."""
    n = x.shape[-1]
    nidx = _next_valid_idx(~torch.isnan(x), _iota(x))
    out = _gather(x, nidx.clamp(max=n - 1))
    return torch.where(nidx >= n, _nan(x), out)


def fill_nearest(x: torch.Tensor) -> torch.Tensor:
    """Fill each NaN with the closest valid value; ties take the next one.
    All-NaN series stay NaN."""
    n = x.shape[-1]
    valid = ~torch.isnan(x)
    iota = _iota(x)
    pidx = _prev_valid_idx(valid, iota)
    nidx = _next_valid_idx(valid, iota)
    prev_val = torch.where(pidx < 0, _nan(x), _gather(x, pidx.clamp(min=0)))
    next_val = torch.where(nidx >= n, _nan(x),
                           _gather(x, nidx.clamp(max=n - 1)))
    use_prev = (pidx >= 0) & ((nidx >= n) | (iota - pidx < nidx - iota))
    return torch.where(valid, x, torch.where(use_prev, prev_val, next_val))


def fill_linear(x: torch.Tensor) -> torch.Tensor:
    """Linear interpolation across interior NaN runs; leading and trailing
    NaNs stay.  ``vp + (vq - vp) * (i - p) / (q - p)`` in ``x``'s dtype,
    one rounding per op, as the JAX function computes it."""
    n = x.shape[-1]
    valid = ~torch.isnan(x)
    iota = _iota(x)
    pidx = _prev_valid_idx(valid, iota)
    nidx = _next_valid_idx(valid, iota)
    interior = (pidx >= 0) & (nidx < n) & ~valid
    p = pidx.clamp_(min=0)
    q = nidx.clamp_(max=n - 1)
    vp = _gather(x, p)
    vq = _gather(x, q)
    step = (iota - p).to(x.dtype)
    span = (q - p).clamp_(min=1).to(x.dtype)
    interp = vp + (vq - vp) * step / span
    return torch.where(interior, interp, x)


def fill_zero(x: torch.Tensor) -> torch.Tensor:
    return fill_value(x, 0.0)


def fill_spline(x):
    """Natural-cubic-spline fill between the first and last valid knots;
    positions outside them are left as they are.  Host-side (scipy), as
    the JAX function: rows that share a NaN pattern are solved in one
    ``CubicSpline`` call.  A tensor comes back as a tensor of its dtype on
    its device (a card's tensor goes to the host and back); anything else
    as a float64 numpy array."""
    from scipy.interpolate import CubicSpline

    tensor = x if isinstance(x, torch.Tensor) else None
    arr = np.array(x.cpu().numpy() if tensor is not None else x,
                   dtype=np.float64, copy=True)
    batched = arr.ndim > 1
    rows = arr.reshape(-1, arr.shape[-1]) if batched else arr[None, :]
    nan_mask = np.isnan(rows)
    patterns: dict = {}
    for i in np.flatnonzero(nan_mask.any(axis=1)):
        patterns.setdefault(nan_mask[i].tobytes(), []).append(int(i))
    for idxs in patterns.values():
        knots = np.flatnonzero(~nan_mask[idxs[0]])
        if knots.size < 2:
            continue
        grid = np.arange(knots[0], knots[-1] + 1)
        sub = rows[idxs]
        if knots.size < 3:
            # two knots: the natural spline is the line through them
            v0 = sub[:, knots[0]:knots[0] + 1]
            v1 = sub[:, knots[-1]:knots[-1] + 1]
            interp = v0 + (v1 - v0) * (grid - knots[0]) / (knots[-1]
                                                           - knots[0])
        else:
            cs = CubicSpline(knots, sub[:, knots], axis=1, bc_type="natural")
            interp = cs(grid)
        rows[np.ix_(idxs, grid)] = interp
    out = rows.reshape(arr.shape) if batched else rows[0]
    if tensor is None:
        return out
    return torch.from_numpy(out).to(device=tensor.device, dtype=tensor.dtype)


_FILL_METHODS = {
    "linear": fill_linear,
    "nearest": fill_nearest,
    "next": fill_next,
    "previous": fill_previous,
    "spline": fill_spline,
    "zero": fill_zero,
}


def fillts(x, fill_method: str):
    """String-dispatched fill."""
    try:
        fn = _FILL_METHODS[fill_method]
    except KeyError:
        raise ValueError(f"unknown fill method {fill_method!r}") from None
    return fn(x)


# ---------------------------------------------------------------------------
# NaN trimming
# ---------------------------------------------------------------------------


def first_not_nan(x: torch.Tensor) -> torch.Tensor:
    """Index of the first non-NaN along the last axis; n when all NaN."""
    valid = ~torch.isnan(x)
    first = torch.argmax(valid.to(torch.uint8), dim=-1)
    return torch.where(valid.any(dim=-1), first,
                       first.new_tensor(x.shape[-1]))


def last_not_nan(x: torch.Tensor) -> torch.Tensor:
    """Index one past the last non-NaN along the last axis; 0 when all NaN
    (an exclusive end, as the JAX package returns it)."""
    n = x.shape[-1]
    valid = ~torch.isnan(x)
    rev_first = torch.argmax(torch.flip(valid, (-1,)).to(torch.uint8),
                             dim=-1)
    return torch.where(valid.any(dim=-1), n - rev_first,
                       rev_first.new_tensor(0))


def trim_leading(x) -> np.ndarray:
    """Drop leading NaNs (host-side: dynamic output shape; 1-D only)."""
    arr = x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
    return arr[int(first_not_nan(torch.from_numpy(arr))):]


def trim_trailing(x) -> np.ndarray:
    """Drop trailing NaNs (host-side: dynamic output shape; 1-D only)."""
    arr = x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
    return arr[:int(last_not_nan(torch.from_numpy(arr)))]


# ---------------------------------------------------------------------------
# differencing
# ---------------------------------------------------------------------------


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


# ---------------------------------------------------------------------------
# ratios / autocorrelation / sampling / rolling
# ---------------------------------------------------------------------------


def quotients(x: torch.Tensor, lag: int) -> torch.Tensor:
    """``x[i+lag] / x[i]``; the output is ``lag`` shorter."""
    return x[..., lag:] / x[..., :-lag]


def price2ret(x: torch.Tensor, lag: int) -> torch.Tensor:
    """Simple returns ``x[i+lag] / x[i] - 1``."""
    return quotients(x, lag) - 1.0


def autocorr(x: torch.Tensor, num_lags: int) -> torch.Tensor:
    """Sample autocorrelation at lags 1..num_lags, ``(..., num_lags)``:
    per lag the leading and trailing slices are demeaned and normalized
    apart, as the reference's estimator does."""
    n = x.shape[-1]
    corrs = []
    for lag in range(1, num_lags + 1):
        d1 = x[..., lag:] - x[..., lag:].mean(dim=-1, keepdim=True)
        d2 = x[..., :n - lag] - x[..., :n - lag].mean(dim=-1, keepdim=True)
        cov = (d1 * d2).sum(dim=-1)
        corrs.append(cov / (torch.sqrt((d1 * d1).sum(dim=-1))
                            * torch.sqrt((d2 * d2).sum(dim=-1))))
    return torch.stack(corrs, dim=-1)


def downsample(x: torch.Tensor, n: int, phase: int = 0) -> torch.Tensor:
    """Every n-th element starting at ``phase``."""
    return x[..., phase::n]


def upsample(x: torch.Tensor, n: int, phase: int = 0,
             use_zero: bool = False) -> torch.Tensor:
    """Insert ``n - 1`` fillers (NaN, or 0 with ``use_zero``) after each
    element, the elements starting at ``phase``."""
    out = torch.full((*x.shape[:-1], x.shape[-1] * n),
                     0.0 if use_zero else float("nan"), dtype=x.dtype,
                     device=x.device)
    out[..., phase::n] = x
    return out


def roll_sum(x: torch.Tensor, window: int) -> torch.Tensor:
    """Sliding-window sum, output length ``n - window + 1``: a sum of
    shifted slices, so a NaN poisons only the windows that hold it."""
    n = x.shape[-1]
    out = x[..., :n - window + 1]
    for i in range(1, window):
        out = out + x[..., i:n - window + 1 + i]
    return out


def roll_mean(x: torch.Tensor, window: int) -> torch.Tensor:
    """Sliding-window mean."""
    return roll_sum(x, window) / window
