"""Batched small SPD solves and least squares (counterpart of
``spark_timeseries_tpu/ops/linalg.py``): the gram-matrix OLS of the lag
designs, and the QR OLS with its t statistics and R² that the residual
tests of ``stats`` run.

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


def _gram_solve_lanewise(Xw: torch.Tensor, Xs: torch.Tensor,
                         y: torch.Tensor):
    """``ols_gram``'s products on a card with each lane's arithmetic
    independent of the batch: cuBLAS's batched GEMM runs a batch of more
    than 65535 matrices as several launches whose remainder may take
    another kernel, so a lane's gram could change with its chunk's size
    (an OOM-halved chunk must be bitwise the whole one).  Here every
    entry is an elementwise product reduced over ``n`` (a reduction whose
    order follows ``n``, not the lane count) and the small products are
    unrolled elementwise sums."""
    p = Xs.shape[-2]
    rows = [[None] * p for _ in range(p)]
    for i in range(p):
        for j in range(i + 1):
            rows[i][j] = rows[j][i] = (Xw[..., i, :] * Xs[..., j, :]) \
                .sum(dim=-1)
    N = torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)
    b = (Xw * y[..., None, :]).sum(dim=-1)
    xtx_inv = spd_inverse(N)
    beta = xtx_inv[..., :, 0] * b[..., 0:1]
    for k in range(1, p):
        beta = beta + xtx_inv[..., :, k] * b[..., k:k + 1]
    fitted = Xs[..., 0, :] * beta[..., 0:1]
    for i in range(1, p):
        fitted = fitted + Xs[..., i, :] * beta[..., i:i + 1]
    return N, b, xtx_inv, beta, fitted


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
    if Xs.is_cuda:
        N, b, xtx_inv, beta, fitted = _gram_solve_lanewise(Xw, Xs, y)
    else:
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


def _maybe_add_intercept(X: torch.Tensor, add_intercept: bool
                         ) -> torch.Tensor:
    """Prepend a ones column (intercept first)."""
    if not add_intercept:
        return X
    return torch.cat([X.new_ones((*X.shape[:-1], 1)), X], dim=-1)


def _householder_qty_r(X: torch.Tensor, y: torch.Tensor):
    """``(Qᵀy (..., p), R (..., p, p))`` of the reduced QR of ``X (..., n,
    p)`` by Householder reflections unrolled over the ``p`` columns:
    each step a few reductions over the lane batch, where a batched
    library QR of many small matrices runs one factorization at a time on
    a card.  R's diagonal may be negative (as LAPACK's may); the least
    squares quantities do not depend on its signs."""
    p = X.shape[-1]
    cols = list(X.unbind(-1))
    b = y
    R = [[torch.zeros_like(y[..., 0])] * p for _ in range(p)]
    qty = []
    for k in range(p):
        a = cols[k][..., k:]
        norm = torch.sqrt((a * a).sum(dim=-1))
        alpha = -torch.copysign(norm, a[..., 0])
        v = torch.cat([(a[..., 0] - alpha)[..., None], a[..., 1:]], dim=-1)
        vv = (v * v).sum(dim=-1)
        R[k][k] = alpha

        def reflect(c):
            f = 2.0 * (v * c).sum(dim=-1) / vv
            return c - f[..., None] * v

        for j in range(k + 1, p):
            c = reflect(cols[j][..., k:])
            R[k][j] = c[..., 0]
            cols[j] = torch.cat([cols[j][..., :k + 1], c[..., 1:]], dim=-1)
        bk = reflect(b[..., k:])
        qty.append(bk[..., 0])
        b = torch.cat([b[..., :k + 1], bk[..., 1:]], dim=-1)
    R = torch.stack([torch.stack(row, dim=-1) for row in R], dim=-2)
    return torch.stack(qty, dim=-1), R


def _qr_solve(X: torch.Tensor, y: torch.Tensor):
    """``(beta, r)`` of least squares by the batched reduced QR of
    :func:`_householder_qty_r`."""
    X, y = torch.broadcast_tensors(X, y[..., None])
    qty, r = _householder_qty_r(X, y[..., 0])
    beta = torch.linalg.solve_triangular(r, qty[..., None], upper=True)[..., 0]
    return beta, r


def ols(X: torch.Tensor, y: torch.Tensor,
        add_intercept: bool = False) -> OLSResult:
    """Least squares by batched QR: ``X (..., n, p)``, ``y (..., n)``;
    ``sigma2``'s denominator is ``max(n - p, 1)``."""
    X = _maybe_add_intercept(X, add_intercept)
    n, p = X.shape[-2], X.shape[-1]
    beta, r = _qr_solve(X, y)
    fitted = torch.einsum("...np,...p->...n", X, beta)
    resid = y - fitted
    sigma2 = (resid * resid).sum(dim=-1) / max(n - p, 1)
    eye = torch.eye(p, dtype=X.dtype, device=X.device).expand(r.shape)
    r_inv = torch.linalg.solve_triangular(r, eye, upper=True)
    xtx_inv = torch.einsum("...ij,...kj->...ik", r_inv, r_inv)
    return OLSResult(beta, resid, fitted, sigma2, xtx_inv)


def ols_beta(X: torch.Tensor, y: torch.Tensor,
             add_intercept: bool = False) -> torch.Tensor:
    """Coefficients only: QR and one triangular solve."""
    return _qr_solve(_maybe_add_intercept(X, add_intercept), y)[0]


def t_statistics(res: OLSResult) -> torch.Tensor:
    """Per-coefficient t statistics ``beta / se(beta)``."""
    se = torch.sqrt(res.sigma2[..., None]
                    * torch.diagonal(res.xtx_inv, dim1=-2, dim2=-1))
    return res.beta / se


def r_squared(res: OLSResult, y: torch.Tensor) -> torch.Tensor:
    """Coefficient of determination of the fit."""
    ss_res = (res.residuals ** 2).sum(dim=-1)
    ss_tot = ((y - y.mean(dim=-1, keepdim=True)) ** 2).sum(dim=-1)
    return 1.0 - ss_res / ss_tot
