"""Lag-matrix construction, batched over leading dims (counterpart of
``spark_timeseries_tpu/ops/lag.py``)."""

from __future__ import annotations

import torch


def lag_matrix(x: torch.Tensor, max_lag: int,
               include_original: bool = False) -> torch.Tensor:
    """Trimmed lag matrix ``(..., n - max_lag, cols)``: row ``r`` holds
    ``[x[r+max_lag] (optional), x[r+max_lag-1], ..., x[r]]``."""
    return lag_stack(x, max_lag, include_original).transpose(-1, -2)


def lag_stack(x: torch.Tensor, max_lag: int,
              include_original: bool = False) -> torch.Tensor:
    """``lag_matrix`` transposed: ``(..., cols, n - max_lag)``, the layout
    :func:`~spark_timeseries_tpu_torch.ops.linalg.ols_gram` takes."""
    n = x.shape[-1]
    if max_lag >= n:
        raise ValueError(f"max_lag {max_lag} must be < series length {n}")
    initial = 0 if include_original else 1
    rows = [x[..., max_lag - lag:n - lag]
            for lag in range(initial, max_lag + 1)]
    return torch.stack(rows, dim=-2)


def lag_matvec(x: torch.Tensor, coef: torch.Tensor,
               max_lag: int) -> torch.Tensor:
    """``lag_matrix(x, max_lag) @ coef`` as a sum of shifted slices.

    ``x (..., n)``, ``coef (..., max_lag)`` in increasing lag order ->
    ``(..., n - max_lag)``."""
    n = x.shape[-1]
    out = None
    for c in range(max_lag):
        term = coef[..., c:c + 1] * x[..., max_lag - c - 1:n - c - 1]
        out = term if out is None else out + term
    if out is None:
        return x.new_zeros((*x.shape[:-1], n))[..., :n - max_lag]
    return out


def lag_matrix_multi(x: torch.Tensor, max_lag: int,
                     include_original: bool = False) -> torch.Tensor:
    """Lag each column of ``x (..., n, k)`` and concatenate:
    ``(..., n - max_lag, k * cols)`` in the order ``[a_-1 a_-2 b_-1 b_-2
    ...]`` (column by column, lags ascending)."""
    per_col = lag_matrix(x.transpose(-1, -2), max_lag, include_original)
    # (..., k, rows, cols) -> (..., rows, k, cols) -> flatten the last two
    per_col = per_col.movedim(-3, -2)
    return per_col.reshape(*per_col.shape[:-2], -1)
