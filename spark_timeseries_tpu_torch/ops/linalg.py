"""Batched small SPD solves and gram-matrix OLS (counterpart of
``spark_timeseries_tpu/ops/linalg.py``).

The LM loop solves one ``(k, k)`` system per lane per iteration
(``k = 5`` at ARIMA(2,1,2) with intercept).  Like the JAX package, small
systems go through a fully unrolled Cholesky: elementwise arithmetic over
the lane batch, no pivoting, a non-SPD lane giving NaN rather than an
LU's garbage.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

_SPD_UNROLL_MAX = 16


def _chol_unrolled(A: torch.Tensor, p: int):
    """Lower Cholesky factor of SPD ``A (..., p, p)`` as a list of lists
    of ``(...)`` lanes."""
    L = [[None] * p for _ in range(p)]
    for i in range(p):
        for j in range(i + 1):
            s = A[..., i, j]
            for k in range(j):
                s = s - L[i][k] * L[j][k]
            L[i][j] = torch.sqrt(s) if i == j else s / L[j][j]
    return L


def _fwd_sub(L, b_cols, p: int):
    """Solve ``L y = b`` (list form)."""
    y = [None] * p
    for i in range(p):
        s = b_cols[i]
        for k in range(i):
            s = s - L[i][k] * y[k]
        y[i] = s / L[i][i]
    return y


def _back_sub(L, y, p: int):
    """Solve ``Lᵀ x = y`` (list form)."""
    x = [None] * p
    for i in reversed(range(p)):
        s = y[i]
        for k in range(i + 1, p):
            s = s - L[k][i] * x[k]
        x[i] = s / L[i][i]
    return x


def spd_solve(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve SPD ``A (..., p, p) @ x = b (..., p)`` by Cholesky: unrolled
    for ``p <= 16``, ``torch.linalg.cholesky`` beyond."""
    p = A.shape[-1]
    if p == 0:
        return torch.zeros_like(b)
    if p > _SPD_UNROLL_MAX:
        L = torch.linalg.cholesky(A)
        return torch.cholesky_solve(b[..., None], L)[..., 0]
    L = _chol_unrolled(A, p)
    x = _back_sub(L, _fwd_sub(L, [b[..., i] for i in range(p)], p), p)
    return torch.stack(x, dim=-1)


def spd_inverse(A: torch.Tensor) -> torch.Tensor:
    """Inverse of SPD ``A (..., p, p)``: ``A⁻¹ = L⁻ᵀ L⁻¹`` with the
    triangular inverse unrolled for ``p <= 16``."""
    p = A.shape[-1]
    if p == 0 or p > _SPD_UNROLL_MAX:
        return torch.cholesky_inverse(torch.linalg.cholesky(A))
    L = _chol_unrolled(A, p)
    Y = [[None] * p for _ in range(p)]
    for j in range(p):
        Y[j][j] = 1.0 / L[j][j]
        for i in range(j + 1, p):
            s = L[i][j] * Y[j][j]
            for k in range(j + 1, i):
                s = s + L[i][k] * Y[k][j]
            Y[i][j] = -s / L[i][i]
    rows = []
    for i in range(p):
        row = []
        for j in range(p):
            s = 0.0
            for k in range(max(i, j), p):
                s = s + Y[k][i] * Y[k][j]
            row.append(s)
        rows.append(torch.stack(row, dim=-1))
    return torch.stack(rows, dim=-2)


class OLSResult(NamedTuple):
    """Batched OLS fit artifacts (leading batch dims ``...``)."""
    beta: torch.Tensor        # (..., p) coefficients (intercept first)
    residuals: torch.Tensor   # (..., n)
    fitted: torch.Tensor      # (..., n)
    sigma2: torch.Tensor      # (...,)   residual variance
    xtx_inv: torch.Tensor     # (..., p, p)


def ols_gram(Xs: torch.Tensor, y: torch.Tensor,
             add_intercept: bool = False,
             row_weights: Optional[torch.Tensor] = None) -> OLSResult:
    """Least squares from a stacked design ``Xs (..., p, n)`` (features on
    the second-minor axis, see ``ops.lag.lag_stack``) via the normal
    equations ``(Xs Xsᵀ) β = Xs y``.

    ``row_weights (..., n)`` of 0/1 restricts the solve to the live rows —
    exactly OLS on the subset (ragged lanes).  ``sigma2``'s denominator
    counts live rows."""
    if add_intercept:
        ones = Xs.new_ones((*Xs.shape[:-2], 1, Xs.shape[-1]))
        Xs = torch.cat([ones, Xs], dim=-2)
    n, p = Xs.shape[-1], Xs.shape[-2]
    if row_weights is None:
        Xw = Xs
        dof = torch.tensor(float(max(n - p, 1)), dtype=Xs.dtype,
                           device=Xs.device)
    else:
        w = row_weights.to(Xs.dtype)
        Xw = Xs * w[..., None, :]
        dof = torch.clamp(w.sum(dim=-1) - p, min=1.0)
    N = torch.einsum("...pn,...qn->...pq", Xw, Xs)
    b = torch.einsum("...pn,...n->...p", Xw, y)
    xtx_inv = spd_inverse(N)
    beta = torch.einsum("...pq,...q->...p", xtx_inv, b)
    fitted = torch.einsum("...pn,...p->...n", Xs, beta)
    resid = y - fitted
    if row_weights is not None:
        resid = resid * w          # dead rows carry garbage y: zero them
    sigma2 = (resid * resid).sum(dim=-1) / dof
    return OLSResult(beta, resid, fitted, sigma2, xtx_inv)
