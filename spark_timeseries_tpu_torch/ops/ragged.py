"""Ragged / NaN-padded panel support (counterpart of
``spark_timeseries_tpu/ops/ragged.py``).

Each lane's contiguous observed window is left-aligned by one gather and
reduced to a per-lane length; kernels derive 0/1 step weights from
``index < length``, so a fit of the padded panel equals fits of the
trimmed series.  NaN strictly inside a lane's window raises.
"""

from __future__ import annotations

import warnings
from typing import Optional, Tuple

import torch


def _windows(values: torch.Tensor):
    """Per-lane ``(start, length, n_observed)`` of the non-NaN window.
    NaN alone marks padding: ``inf`` is bad data and stays in."""
    n = values.shape[-1]
    obs = ~torch.isnan(values)
    obs_i = obs.to(torch.uint8)
    any_valid = obs.any(dim=-1)
    start = torch.argmax(obs_i, dim=-1)
    last = n - 1 - torch.argmax(obs_i.flip(-1), dim=-1)
    length = torch.where(any_valid, last - start + 1,
                         torch.zeros_like(start))
    return start, length, obs.sum(dim=-1)


def _left_align(values: torch.Tensor):
    """``(aligned, length, n_observed)``: every lane's window shifted to
    index 0 and its tail zeroed."""
    start, length, n_obs = _windows(values)
    n = values.shape[-1]
    iota = torch.arange(n, device=values.device)
    idx = torch.clamp(start[..., None] + iota, max=n - 1)
    rolled = torch.gather(values, -1, idx)
    tail = iota >= length[..., None]
    rolled = torch.where(tail, torch.zeros((), dtype=values.dtype,
                                           device=values.device), rolled)
    return rolled, length, n_obs


def ragged_view(values: torch.Tensor
                ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """``(aligned, lengths)`` of a possibly NaN-padded panel; a panel
    without NaN returns ``(values, None)`` untouched.  Raises when a lane
    has NaN strictly inside its observed window."""
    if not values.dtype.is_floating_point \
            or not bool(torch.isnan(values).any()):
        return values, None
    aligned, length, n_obs = _left_align(values)
    holes = int((n_obs != length).sum())
    if holes:
        raise ValueError(
            f"{holes} lane(s) have NaN strictly inside their observed "
            f"window; valid-window fits need contiguous observations — "
            f"impute interior gaps first, leading/trailing padding needs "
            f"no fill")
    return aligned, length


def step_weights(n_steps: int, n_valid: torch.Tensor, offset: int = 0,
                 dtype=None) -> torch.Tensor:
    """``(..., n_steps)`` 0/1 weights: step ``i`` is live iff
    ``offset + i < n_valid``.  Batched ``n_valid`` arrives pre-expanded
    (``n_valid[..., None]``)."""
    n_valid = torch.as_tensor(n_valid)
    w = (offset + torch.arange(n_steps, device=n_valid.device)) < n_valid
    return w if dtype is None else w.to(dtype)


def short_lanes(obs_len: torch.Tensor, min_n: int,
                what: str) -> Optional[torch.Tensor]:
    """Mask of lanes whose valid window is under ``min_n`` observations,
    with a warning, or ``None`` when no lane is short.  Never raises: a
    batched fit degrades per lane (NaN parameters, not converged)."""
    short = obs_len < min_n
    n = int(short.sum())
    if n == 0:
        return None
    count = f"all {n} lanes" if n == short.numel() else f"{n} lane(s)"
    warnings.warn(
        f"{count} have valid windows shorter than the "
        f"{min_n} observations the {what} needs; their parameters are NaN "
        f"and diagnostics.converged is False", stacklevel=4)
    return short


def apply_short_quarantine(params: torch.Tensor, converged: torch.Tensor,
                           short: Optional[torch.Tensor]):
    """NaN out short lanes' parameters and demote them to non-converged."""
    if short is None:
        return params, converged
    s = short[..., None] if params.ndim > short.ndim else short
    nan = torch.full((), float("nan"), dtype=params.dtype,
                     device=params.device)
    return (torch.where(s, nan, params),
            converged & ~short.reshape(converged.shape))
