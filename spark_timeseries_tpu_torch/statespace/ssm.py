"""Batched linear-Gaussian state-space representation (counterpart of
``spark_timeseries_tpu/statespace/ssm.py``).

Every classical family the port fits (ARIMA, AR/ARX, EWMA, additive
Holt-Winters) can be written as

    y_t = d + Z·α_t (+ offset_t) + ε_t,   ε_t ~ N(0, H)
    α_t = c + T·α_{t-1} + η_t,            η_t ~ N(0, Q)

over a small hidden state α (``m = max(p, q+1)`` for ARMA, ``2 +
period`` for Holt-Winters).  A new observation is then one O(m²) Kalman
step, and the exact Gaussian likelihood falls out of the same recursion
(``statespace.kalman``).  Two modes share one step: ``"exact"``, the
covariance-propagating filter (the ARMA forms, ``arima.fit(objective=
"exact")``), and ``"innovations"``, the single-source-of-error form with
the gain pinned to the model's smoothing vector (EWMA, Holt-Winters).

Every tensor carries a leading ``(n_series,)`` batch dim; the static
facts (mode, state dimension, differencing order) live in
:class:`SSMeta`.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

__all__ = ["StateSpace", "SSMeta", "FilterState", "initial_state",
           "stationary_covariance", "stationary_mean", "state_nbytes"]


class StateSpace(NamedTuple):
    """One family's batched state-space parameters.  ``gain`` is the
    pinned predictive-form Kalman gain of ``mode="innovations"``; zeros,
    and unused, in ``mode="exact"``."""
    T: torch.Tensor       # (S, m, m) state transition
    Z: torch.Tensor       # (S, m)    observation row vector
    c: torch.Tensor       # (S, m)    state intercept
    d: torch.Tensor       # (S,)      observation intercept
    H: torch.Tensor       # (S,)      observation noise variance
    Q: torch.Tensor       # (S, m, m) state noise covariance
    gain: torch.Tensor    # (S, m)    pinned gain (innovations mode)

    @property
    def n_series(self) -> int:
        return self.T.shape[0]

    @property
    def state_dim(self) -> int:
        return self.T.shape[-1]


class SSMeta(NamedTuple):
    """Static facts about a :class:`StateSpace`.  ``d_order`` is the
    integration order folded out of the family (ARIMA's ``d``): the
    filter runs on the d-times-differenced series and carries a ring of
    the last raw differences."""
    family: str          # "arima" | "ar" | "arx" | "ewma" | "holt_winters"
    mode: str            # "exact" | "innovations"
    d_order: int         # integration order handled outside the filter
    m: int               # state dimension


class FilterState(NamedTuple):
    """Per-series filter carry: the one-step predicted state mean ``a``
    and covariance ``P``, the raw-difference ring (``ring[j] = Δʲ
    y_last``), and the pieces of the likelihood: ``loglik`` at the
    model's own noise scale, ``ssq`` (Σ v²/F), ``sumlogf`` (Σ log F) and
    ``n_obs``."""
    a: torch.Tensor        # (S, m)
    P: torch.Tensor        # (S, m, m)
    ring: torch.Tensor     # (S, d_order)
    loglik: torch.Tensor   # (S,)
    ssq: torch.Tensor      # (S,)
    sumlogf: torch.Tensor  # (S,)
    n_obs: torch.Tensor    # (S,) int32


def _solve_or_nan(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """``A⁻¹ B`` per lane, NaN on the lanes whose ``A`` is singular.

    ``torch.linalg.solve`` raises on a singular batch member where
    ``jnp.linalg.solve`` returns inf/NaN, so the solve runs as
    ``solve_ex`` and a lane whose factorization failed (``info != 0``)
    is re-solved against the identity, to keep its autograd finite, and
    then set to NaN."""
    X, info = torch.linalg.solve_ex(A, B)
    bad = info != 0
    if bool(bad.any()):
        eye = torch.eye(A.shape[-1], dtype=A.dtype, device=A.device)
        X = torch.linalg.solve(torch.where(bad[..., None, None], eye, A), B)
        X = torch.where(bad[..., None, None],
                        torch.full_like(X, float("nan")), X)
    return X


def stationary_covariance(T: torch.Tensor, Q: torch.Tensor,
                          fallback_scale: float = 1e6) -> torch.Tensor:
    """Batched stationary state covariance: ``P = T P Tᵀ + Q`` by the vec
    trick ``(I - T⊗T) vec(P) = vec(Q)`` (an m² × m² solve per lane).

    Lanes where that solve fails or is not finite (a unit or explosive
    root can make ``I - T⊗T`` singular) take the quasi-diffuse
    ``fallback_scale · (1 + |tr Q|) · I`` instead of NaN."""
    m = T.shape[-1]
    batch = T.shape[:-2]
    kron = (T[..., :, None, :, None] * T[..., None, :, None, :]) \
        .reshape(*batch, m * m, m * m)
    eye = torch.eye(m * m, dtype=T.dtype, device=T.device)
    vec_p = _solve_or_nan(eye - kron, Q.reshape(*batch, m * m, 1))
    P = vec_p.reshape(*batch, m, m)
    P = 0.5 * (P + P.transpose(-1, -2))
    ok = torch.isfinite(P).all(dim=-1).all(dim=-1)[..., None, None]
    trace = torch.diagonal(Q, dim1=-2, dim2=-1).sum(dim=-1)
    diffuse = fallback_scale * torch.eye(m, dtype=T.dtype, device=T.device) \
        * (1.0 + trace.abs())[..., None, None]
    return torch.where(ok, torch.where(ok, P, torch.zeros_like(P)), diffuse)


def stationary_mean(T: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """Batched stationary state mean ``(I - T)⁻¹ c``; lanes where that
    fails fall back to ``c`` itself."""
    m = T.shape[-1]
    eye = torch.eye(m, dtype=T.dtype, device=T.device)
    mu = _solve_or_nan(eye - T, c[..., None])[..., 0]
    ok = torch.isfinite(mu).all(dim=-1, keepdim=True)
    return torch.where(ok, torch.where(ok, mu, torch.zeros_like(mu)), c)


def initial_state(ssm: StateSpace, meta: SSMeta) -> FilterState:
    """Pre-data filter state: the stationary mean and covariance in
    ``mode="exact"`` (the exact likelihood's prior), zero mean and a
    degenerate covariance in ``mode="innovations"`` (the converters set
    ``a`` to the model's own initial components)."""
    S, m = ssm.n_series, ssm.state_dim
    T = ssm.T
    zeros = T.new_zeros((S,))
    if meta.mode == "exact":
        a0 = stationary_mean(T, ssm.c)
        p0 = stationary_covariance(T, ssm.Q)
    else:
        a0 = T.new_zeros((S, m))
        p0 = T.new_zeros((S, m, m))
    return FilterState(a=a0, P=p0, ring=T.new_zeros((S, meta.d_order)),
                       loglik=zeros, ssq=zeros, sumlogf=zeros,
                       n_obs=torch.zeros((S,), dtype=torch.int32,
                                         device=T.device))


def state_nbytes(tree) -> int:
    """Total bytes of the tensor leaves of a (nested) NamedTuple."""
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    if isinstance(tree, (tuple, list)):
        return sum(state_nbytes(leaf) for leaf in tree)
    return 0
