"""Linear recurrences in logarithmic depth (counterpart of
``spark_timeseries_tpu/ops/scan_parallel.py``).

The EWMA smoothing, the AR(1) filter and the GARCH variance path are
first-order affine maps ``y_t = a_t * y_{t-1} + b_t``.  Their composition
``(a2, b2) ∘ (a1, b1) = (a1 a2, a2 b1 + b2)`` is associative, so the whole
prefix evaluates by doubling over the time axis: after the step of
distance ``d`` every position holds the composition of the ``2d`` maps
ending at it, and ``ceil(log2 n)`` steps of one slice and one FMA each
finish the scan.  The JAX package runs ``lax.associative_scan``; the
combine order differs, so the two agree to rounding (the CPU tests hold
them to 1e-12 relative in float64), not bit for bit.

Every step is out of place, so autograd differentiates through the scan
(the GARCH Newton fit takes its Hessian through it).  On a card each
step is a handful of elementwise launches over the whole panel: about
``5 · ceil(log2 n)`` launches a scan, bound by memory traffic.
"""

from __future__ import annotations

from typing import Optional

import torch


def _as(x, like: torch.Tensor) -> torch.Tensor:
    """``x`` as a tensor of ``like``'s dtype and device."""
    return torch.as_tensor(x, dtype=like.dtype, device=like.device)


def _doubling_scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``y_t = a_t y_{t-1} + b_t`` along the last axis, ``y_{-1} = 0``."""
    n = a.shape[-1]
    d = 1
    while d < n:
        # position t >= d absorbs the composition ending at t - d
        b = torch.cat([b[..., :d],
                       torch.addcmul(b[..., d:], a[..., d:], b[..., :-d])],
                      dim=-1)
        if 2 * d < n:
            a = torch.cat([a[..., :d], a[..., d:] * a[..., :-d]], dim=-1)
        d *= 2
    return b


def linear_recurrence(a, b, axis: int = -1) -> torch.Tensor:
    """Solve ``y_t = a_t * y_{t-1} + b_t`` with ``y_{-1} = 0`` for all t,
    in ``ceil(log2 n)`` doubling steps.  ``a`` and ``b`` broadcast against
    each other; the recurrence runs along ``axis``."""
    b = torch.as_tensor(b)
    a = _as(a, b) if not isinstance(a, torch.Tensor) else a
    a, b = torch.broadcast_tensors(a, b)
    a = a.movedim(axis, -1)
    b = b.movedim(axis, -1)
    return _doubling_scan(a, b).movedim(-1, axis)


def affine_recurrence(A, b, x0=None) -> torch.Tensor:
    """Solve the vector recurrence ``x_t = A_t @ x_{t-1} + b_t`` for
    t = 1..n in logarithmic depth.  ``A (n, ..., m, m)`` and
    ``b (n, ..., m)`` with the time axis leading; ``x0 (..., m)`` seeds
    ``x_0`` (zeros when None).  The maps compose as ``(A2, b2) ∘ (A1, b1)
    = (A2 A1, A2 b1 + b2)``.  Returns the states ``x (n, ..., m)``."""
    b = torch.as_tensor(b)
    A = _as(A, b)
    if x0 is not None:
        # fold the seed into the first step: x_1 = A_1 x_0 + b_1
        first = b[:1] + (A[:1] @ _as(x0, b)[None, ..., None])[..., 0]
        b = torch.cat([first, b[1:]])
    n = b.shape[0]
    d = 1
    while d < n:
        b = torch.cat([b[:d], (A[d:] @ b[:-d, ..., None])[..., 0] + b[d:]])
        if 2 * d < n:
            A = torch.cat([A[:d], A[d:] @ A[:-d]])
        d *= 2
    return b


def ewma_smooth(x, alpha, axis: int = -1) -> torch.Tensor:
    """EWMA smoothing ``S_t = alpha·x_t + (1 - alpha)·S_{t-1}``,
    ``S_0 = x_0`` (``models.ewma.EWMAModel.add_time_dependent_effects``),
    in logarithmic depth.  ``alpha`` is a scalar or one value per lane."""
    x = torch.as_tensor(x)
    alpha = _as(alpha, x)
    if alpha.ndim and axis in (-1, x.ndim - 1):
        alpha = alpha[..., None]
    a = torch.broadcast_to(1.0 - alpha, x.shape).movedim(axis, -1)
    b = (alpha * x).movedim(axis, -1)
    xm = x.movedim(axis, -1)
    # S_0 = x_0 exactly: the first step carries the seed and no history
    a = torch.cat([torch.zeros_like(a[..., :1]), a[..., 1:]], dim=-1)
    b = torch.cat([xm[..., :1], b[..., 1:]], dim=-1)
    return _doubling_scan(a, b).movedim(-1, axis)


def ar1_filter(x, c, phi, axis: int = -1) -> torch.Tensor:
    """AR(1) filtering ``y_t = c + phi·y_{t-1} + x_t`` with ``y_{-1} = 0``
    (``ARModel.add_time_dependent_effects`` for p = 1)."""
    x = torch.as_tensor(x)
    c = _as(c, x)
    phi = _as(phi, x)
    if axis in (-1, x.ndim - 1):
        if phi.ndim:
            phi = phi[..., None]
        if c.ndim:
            c = c[..., None]
    a = torch.broadcast_to(phi, x.shape)
    return linear_recurrence(a, x + c, axis=axis)


def garch_variance(errors, omega, alpha, beta, axis: int = -1,
                   h0: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Conditional-variance path ``h_t = omega + alpha·e²_{t-1} +
    beta·h_{t-1}`` with ``h_0 = omega / (1 - alpha - beta)`` (the GARCH
    recurrence of ``models.garch.GARCHModel``).  Returns ``h`` aligned
    with ``errors`` (``h[0]`` is the seed).  ``h0`` overrides the
    stationary seed, e.g. with the sample variance of an IGARCH lane
    (α + β = 1), where the stationary value does not exist.  Parameters
    are scalars or one value per lane; on another ``axis`` than the last
    they broadcast against the series with that axis moved last."""
    e = torch.as_tensor(errors).movedim(axis, -1)
    omega, alpha, beta = (_as(v, e) for v in (omega, alpha, beta))
    omega, alpha, beta = (v[..., None] if v.ndim else v
                          for v in (omega, alpha, beta))
    e2_prev = torch.cat([torch.zeros_like(e[..., :1]), e[..., :-1] ** 2],
                        dim=-1)
    a = torch.broadcast_to(beta, e.shape)
    b = omega + alpha * e2_prev
    if h0 is None:
        h0 = omega / (1.0 - alpha - beta)
    else:
        h0 = _as(h0, e)
        if h0.ndim:
            h0 = h0[..., None]
    seed = torch.broadcast_to(h0, b[..., :1].shape)
    a = torch.cat([torch.zeros_like(a[..., :1]), a[..., 1:]], dim=-1)
    b = torch.cat([seed, b[..., 1:]], dim=-1)
    return _doubling_scan(a, b).movedim(-1, axis)
