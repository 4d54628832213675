"""GARCH(1,1), AR(1)+GARCH(1,1) and EGARCH(1,1) volatility models,
batched (counterpart of ``spark_timeseries_tpu/models/garch.py``).

The GARCH variance ``h_i = ω + α·η²_{i-1} + β·h_{i-1}``, ``h_0 = ω / (1 -
α - β)``, is affine in ``h`` with known driving terms, so the likelihood
evaluates it by the log-depth scan of ``ops.scan_parallel.garch_variance``
(autograd differentiates through it).  The EGARCH log variance reads
the residuals scaled by the evolving variance and is sequential: a step
loop over the lane batch.  The fits are maximum likelihood in an
unconstrained reparameterization, by the batched damped Newton of
``ops.optimize.minimize_newton`` on the exact Hessian (autograd's for
GARCH; for EGARCH a one-pass forward-mode recurrence of the derivatives,
:func:`_egarch_derivatives`), or BFGS, or for EGARCH the Armijo descent
of ``minimize_box``.  No Pallas
kernel: the JAX package runs these recurrences in XLA, the port in plain
PyTorch.

Sampling takes a ``torch.Generator`` where the JAX package takes a key.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch

from .._device import as_tensor, resolve_device
from ..ops.optimize import (minimize_bfgs, minimize_box, minimize_newton,
                            value_and_grad_of)
from ..ops.ragged import ragged_view, step_weights
from ..ops.scan_parallel import garch_variance, linear_recurrence
from ..utils import resilience as _resilience
from . import autoregression
from .base import FitDiagnostics, diagnostics_from

_LOG_2PI = math.log(2.0 * math.pi)


def _fields(model, names) -> Tuple[torch.Tensor, ...]:
    """The named parameter fields as tensors of one dtype and device (the
    first tensor field's; plain numbers otherwise)."""
    vals = [getattr(model, n) for n in names]
    like = next((v for v in vals if isinstance(v, torch.Tensor)), None)
    if like is None:
        return tuple(torch.as_tensor(v, dtype=torch.float64) for v in vals)
    return tuple(torch.as_tensor(v, dtype=like.dtype, device=like.device)
                 for v in vals)


def _series(ts, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(ts, dtype=like.dtype, device=like.device)


def _packed_gradient(ctor, params, ts) -> torch.Tensor:
    """Log-likelihood gradient with respect to a packed parameter vector
    over the broadcast of the parameters' batch dims and ``ts``'s
    leading dims; ``ctor(packed (..., k)) -> model``; returns ``(...,
    k)``.  One backward of the summed likelihood (lanes independent)."""
    packed = torch.stack(torch.broadcast_tensors(*params), dim=-1)
    ts = _series(ts, packed)
    batch = torch.broadcast_shapes(packed.shape[:-1], ts.shape[:-1])
    packed = packed.expand(*batch, packed.shape[-1]).detach().clone()
    ts = ts.expand(*batch, ts.shape[-1])
    with torch.enable_grad():
        packed.requires_grad_(True)
        ll = ctor(packed).log_likelihood(ts)
        g, = torch.autograd.grad(ll.sum(), packed)
    return g


def _gaussian_ll(ts: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """``Σ_{t>=1} -½ log h_t - ½ x_t² / h_t - ½ log 2π (n - 1)``."""
    n = ts.shape[-1]
    x, hh = ts[..., 1:], h[..., 1:]
    lls = -0.5 * torch.log(hh) - 0.5 * x * x / hh
    return lls.sum(dim=-1) - 0.5 * _LOG_2PI * (n - 1)


def _lane(p: torch.Tensor, ts: torch.Tensor) -> torch.Tensor:
    """A per-lane parameter broadcast over the time axis of ``ts``."""
    return p[..., None] if p.ndim and ts.ndim > 1 else p


class GARCHModel(NamedTuple):
    """GARCH(1,1) parameters, each scalar or ``(n_series,)``."""
    omega: torch.Tensor
    alpha: torch.Tensor
    beta: torch.Tensor
    diagnostics: Optional[FitDiagnostics] = None

    @property
    def _params(self):
        return _fields(self, ("omega", "alpha", "beta"))

    def _h0(self):
        w, a, b = self._params
        return w / (1.0 - a - b)

    def log_likelihood(self, ts) -> torch.Tensor:
        """Gaussian log likelihood under the variance recurrence (a
        log-depth scan); ``ts (..., n)`` -> ``(...)``."""
        w, a, b = self._params
        ts = _series(ts, w)
        return _gaussian_ll(ts, garch_variance(ts, w, a, b))

    def forecast_variance(self, ts, n_future: int) -> torch.Tensor:
        """k-step conditional variance forecasts, k = 1..n_future: ``σ² +
        κ^{k-1}(h_{t+1} - σ²)`` with ``κ = α + β``, ``σ² = ω / (1 - κ)``;
        an IGARCH lane (κ = 1) seeds its path with the sample variance and
        takes the limit ``h_{t+1} + k·ω``.  ``ts (..., n)`` -> ``(...,
        n_future)``."""
        if n_future < 1:
            raise ValueError("forecast_variance needs n_future >= 1")
        w, a, b = self._params
        ts = _series(ts, w)
        kappa = a + b
        unit = torch.isclose(kappa, torch.ones_like(kappa))
        safe = torch.where(unit, torch.ones_like(kappa), 1.0 - kappa)
        seed = torch.where(unit, (ts * ts).mean(dim=-1), w / safe)
        h = garch_variance(ts, w, a, b, h0=seed)
        h_next = w + a * ts[..., -1] ** 2 + b * h[..., -1]
        k = torch.arange(n_future, dtype=ts.dtype, device=ts.device)
        sigma2 = w / safe
        geo = sigma2[..., None] \
            + kappa[..., None] ** k * (h_next - sigma2)[..., None]
        lin = h_next[..., None] + w[..., None] * k
        return torch.where(unit[..., None], lin, geo)

    def gradient(self, ts) -> torch.Tensor:
        """d log-likelihood / d(ω, α, β) by autograd; ``(..., 3)``."""
        return _packed_gradient(
            lambda prm: GARCHModel(prm[..., 0], prm[..., 1], prm[..., 2]),
            self._params, ts)

    def remove_time_dependent_effects(self, ts) -> torch.Tensor:
        """Standardize: each observation over its conditional
        volatility."""
        w, a, b = self._params
        ts = _series(ts, w)
        var = self._h0().expand(ts.shape[:-1]) if ts.ndim > 1 \
            else self._h0()
        prev = ts[..., 0]
        out = [prev / torch.sqrt(var)]
        for t in range(1, ts.shape[-1]):
            var = w + a * prev * prev + b * var
            prev = ts[..., t]
            out.append(prev / torch.sqrt(var))
        return torch.stack(out, dim=-1)

    def add_time_dependent_effects(self, ts) -> torch.Tensor:
        """Filter: scale standardized draws by the conditional
        volatility."""
        w, a, b = self._params
        ts = _series(ts, w)
        var = self._h0().expand(ts.shape[:-1]) if ts.ndim > 1 \
            else self._h0()
        eta = ts[..., 0] * torch.sqrt(var)
        out = [eta]
        for t in range(1, ts.shape[-1]):
            var = w + a * eta * eta + b * var
            eta = ts[..., t] * torch.sqrt(var)
            out.append(eta)
        return torch.stack(out, dim=-1)

    def sample_with_variances(self, n: int,
                              generator: Optional[torch.Generator] = None,
                              shape=()):
        """``(ts, variances)``, each ``(*shape, n)``, from Gaussian draws of
        ``generator`` (on its device, then moved to the model's); as in
        the reference, index 0 of the sample stays 0 and only its variance
        seeds the recurrence."""
        w, a, b = self._params
        z = _draws(n, shape, generator, w)
        var = self._h0().expand(z.shape[1:])
        eta = torch.sqrt(var) * z[0]
        ts, vs = [torch.zeros_like(var)], [var]
        for i in range(1, n):
            var = w + b * var + a * eta * eta
            eta = torch.sqrt(var) * z[i]
            ts.append(eta)
            vs.append(var)
        return torch.stack(ts, dim=-1), torch.stack(vs, dim=-1)

    def sample(self, n: int, generator: Optional[torch.Generator] = None,
               shape=()) -> torch.Tensor:
        return self.sample_with_variances(n, generator, shape)[0]


def _draws(n: int, shape, generator, like: torch.Tensor) -> torch.Tensor:
    """Standard-normal draws ``(n, *shape)`` from ``generator``."""
    gen_dev = generator.device if generator is not None else like.device
    return torch.randn((n, *shape), generator=generator, dtype=like.dtype,
                       device=gen_dev).to(like.device)


def _logit(p: torch.Tensor) -> torch.Tensor:
    return torch.log(p) - torch.log1p(-p)


def _unconstrain(omega, alpha, beta):
    """(ω, α, β) -> unconstrained (u, s, r): ω = exp(u), α + β =
    sigmoid(s), α / (α + β) = sigmoid(r)."""
    total = alpha + beta
    return torch.log(omega), _logit(total), _logit(alpha / total)


def _constrain(params: torch.Tensor):
    u, s, r = params[..., 0], params[..., 1], params[..., 2]
    omega = torch.exp(u)
    total = torch.sigmoid(s)
    frac = torch.sigmoid(r)
    return omega, total * frac, total * (1.0 - frac)


def _garch_neg_ll(params: torch.Tensor, series: torch.Tensor):
    """The batched negative log likelihood of unconstrained ``params (S,
    3)`` on ``series (S, n)``."""
    omega, alpha, beta = _constrain(params)
    return -GARCHModel(omega, alpha, beta).log_likelihood(series)


def _on_device(ts, device):
    """``ts`` as a tensor on the resolved device, and that device."""
    dev = resolve_device(device)
    return as_tensor(ts, dev), dev


def fit(ts, init=(0.2, 0.2, 0.2), tol: float = 1e-6,
        max_iter: Optional[int] = None, method: str = "newton",
        retry=None, device=None, stats: Optional[dict] = None,
        _restart_draws=None) -> GARCHModel:
    """Fit GARCH(1,1) by maximum likelihood from the reference's (.2, .2,
    .2), in the unconstrained reparameterization ``ω = exp(u)``, ``α + β
    = sigmoid(s)``, ``α = sigmoid(r)·(α + β)`` (the stationarity region,
    where the likelihood is smooth everywhere).

    ``ts (..., n)`` fits in one batched solve on ``device`` (``None``
    means CUDA: float32, raises without a card; ``device="cpu"`` takes
    float32 or float64).  ``method="newton"`` (default): damped Newton on
    the exact 3 × 3 autograd Hessian, 100 iterations; ``"bfgs"``: BFGS,
    500.  ``retry`` re-solves unconverged lanes from jittered starts
    (draws from ``retry.seed`` or ``_restart_draws``); ``max_iter``
    defaults to ``retry.max_iter`` when set.  A lane whose solve went
    non-finite keeps the initial guess.  ``stats`` receives the solver's
    counts (``solves``, ``restart_lanes``; Newton's ``iterations`` and
    ``evaluations``, BFGS's ``calls``)."""
    ts, dev = _on_device(ts, device)
    batch, n = ts.shape[:-1], ts.shape[-1]
    y = ts.reshape(-1, n)
    init_t = [torch.as_tensor(v, dtype=ts.dtype, device=dev) for v in init]
    x0 = torch.stack(_unconstrain(*init_t), dim=-1).expand(y.shape[0], 3)
    x0 = x0.contiguous()
    rk = _resilience.retry_kwargs(retry)
    if max_iter is None and retry is not None:
        max_iter = retry.max_iter
    st = {} if stats is None else stats
    if method == "newton":
        res = minimize_newton(_garch_neg_ll, x0, y, tol=tol,
                              max_iter=100 if max_iter is None else max_iter,
                              jitter_draws=_restart_draws, stats=st, **rk)
    elif method == "bfgs":
        vag, evaluator_for = value_and_grad_of(_garch_neg_ll, y)
        res = minimize_bfgs(vag, x0, tol=tol,
                            max_iter=500 if max_iter is None else max_iter,
                            evaluator_for=evaluator_for,
                            jitter_draws=_restart_draws, stats=st, **rk)
    else:
        raise ValueError(f"unknown method {method!r}")
    ok = torch.isfinite(res.x).all(dim=-1, keepdim=True)
    params = torch.where(ok, res.x, x0)
    diag = _reshape_diag(diagnostics_from(res, ok), batch)
    w, a, b = (v.reshape(batch) for v in _constrain(params))
    return GARCHModel(w, a, b, diagnostics=diag)


def _reshape_diag(d: FitDiagnostics, batch) -> FitDiagnostics:
    return FitDiagnostics(*(t.reshape(batch) for t in d[:3]),
                          None if d.attempts is None
                          else d.attempts.reshape(batch))


def fit_panel(panel, **kwargs) -> GARCHModel:
    """Batched fit of a Panel on its device."""
    return fit(panel.values, device=panel.device, **kwargs)


def _nanvar(v: torch.Tensor) -> torch.Tensor:
    """Population variance over the observed (non-NaN) entries."""
    mean = torch.nanmean(v, dim=-1, keepdim=True)
    n = (~torch.isnan(v)).sum(dim=-1).to(v.dtype)
    return torch.nansum((v - mean) ** 2, dim=-1) / n


def _const_gaussian_neg_ll(v: torch.Tensor, var: torch.Tensor):
    """Constant-variance Gaussian negative log likelihood over the
    observed entries, in closed form."""
    n_valid = (~torch.isnan(v)).sum(dim=-1).to(v.dtype)
    return 0.5 * (torch.nansum(v * v, dim=-1) / var
                  + n_valid * (torch.log(var) + _LOG_2PI))


def _const_fallback_diag(v, var):
    neg_ll = _const_gaussian_neg_ll(v, var)
    return FitDiagnostics(
        torch.isfinite(neg_ll),
        torch.zeros(neg_ll.shape, dtype=torch.int32, device=v.device),
        neg_ll)


def _const_variance_model(v: torch.Tensor) -> GARCHModel:
    """Terminal fallback: constant conditional variance (α = β = 0, ω =
    the sample variance); NaN padding is ignored."""
    var = torch.clamp(_nanvar(v), min=1e-12)
    zeros = torch.zeros_like(var)
    return GARCHModel(var, zeros, zeros,
                      diagnostics=_const_fallback_diag(v, var))


def fit_resilient(ts, retry: Optional[_resilience.RetryPolicy] = None,
                  device=None, **kwargs):
    """Fail-soft batched GARCH(1,1) on ``device`` (``None`` means CUDA):
    Newton with multi-start retry -> BFGS -> the constant-variance model.
    ``ts (n_series, n)``; returns ``(model, FitOutcome)``."""
    if retry is None:
        retry = _resilience.RetryPolicy()
    values, dev = _on_device(ts, device)
    chain = [
        ("newton", lambda v: fit(v, retry=retry, device=dev, **kwargs)),
        ("bfgs", lambda v: fit(v, device=dev, **_resilience.override_kwargs(
            kwargs, method="bfgs"))),
        ("const", _const_variance_model),
    ]
    return _resilience.resilient_fit(values, chain, min_len=3,
                                     family="garch")


class ARGARCHModel(NamedTuple):
    """AR(1) + GARCH(1,1): ``y_i = c + φ·y_{i-1} + η_i`` with the GARCH
    variance on ``η``."""
    c: torch.Tensor
    phi: torch.Tensor
    omega: torch.Tensor
    alpha: torch.Tensor
    beta: torch.Tensor
    diagnostics: Optional[FitDiagnostics] = None

    @property
    def _params(self):
        return _fields(self, ("c", "phi", "omega", "alpha", "beta"))

    def _h0(self):
        _, _, w, a, b = self._params
        return w / (1.0 - a - b)

    def remove_time_dependent_effects(self, ts) -> torch.Tensor:
        """The standardized AR residuals ``η_i / sqrt(h_i)``."""
        c, phi, w, a, b = self._params
        ts = _series(ts, w)
        var = self._h0().expand(ts.shape[:-1]) if ts.ndim > 1 \
            else self._h0()
        eta = ts[..., 0] - c
        out = [eta / torch.sqrt(var)]
        for t in range(1, ts.shape[-1]):
            var = w + a * eta * eta + b * var
            eta = ts[..., t] - c - phi * ts[..., t - 1]
            out.append(eta / torch.sqrt(var))
        return torch.stack(out, dim=-1)

    def add_time_dependent_effects(self, ts) -> torch.Tensor:
        """Filter standardized draws; the AR feedback reads the output."""
        c, phi, w, a, b = self._params
        ts = _series(ts, w)
        var = self._h0().expand(ts.shape[:-1]) if ts.ndim > 1 \
            else self._h0()
        eta = ts[..., 0] * torch.sqrt(var)
        y = c + eta
        out = [y]
        for t in range(1, ts.shape[-1]):
            var = w + a * eta * eta + b * var
            eta = ts[..., t] * torch.sqrt(var)
            y = c + phi * y + eta
            out.append(y)
        return torch.stack(out, dim=-1)

    def sample_with_variances(self, n: int,
                              generator: Optional[torch.Generator] = None,
                              shape=()):
        """``(ts, variances)``, each ``(*shape, n)``; index 0 of the sample
        stays 0, as in the reference."""
        c, phi, w, a, b = self._params
        z = _draws(n, shape, generator, w)
        var = self._h0().expand(z.shape[1:])
        eta = torch.sqrt(var) * z[0]
        y = torch.zeros_like(var)
        ts, vs = [y], [var]
        for i in range(1, n):
            var = w + b * var + a * eta * eta
            eta = torch.sqrt(var) * z[i]
            y = c + phi * y + eta
            ts.append(y)
            vs.append(var)
        return torch.stack(ts, dim=-1), torch.stack(vs, dim=-1)

    def sample(self, n: int, generator: Optional[torch.Generator] = None,
               shape=()) -> torch.Tensor:
        return self.sample_with_variances(n, generator, shape)[0]


def fit_ar_garch(ts, retry=None, device=None,
                 stats: Optional[dict] = None,
                 _restart_draws=None) -> ARGARCHModel:
    """Two-stage AR(1)+GARCH(1,1): AR(1) by OLS, then :func:`fit` on its
    residuals, batched over leading dims on ``device`` (``None`` means
    CUDA)."""
    ts, dev = _on_device(ts, device)
    ar = autoregression.fit(ts, 1)
    residuals = ar.remove_time_dependent_effects(ts)
    g = fit(residuals, retry=retry, device=dev, stats=stats,
            _restart_draws=_restart_draws)
    return ARGARCHModel(ar.c, ar.coefficients[..., 0], g.omega, g.alpha,
                        g.beta, diagnostics=g.diagnostics)


def fit_ar_garch_panel(panel, **kwargs) -> ARGARCHModel:
    return fit_ar_garch(panel.values, device=panel.device, **kwargs)


def _const_variance_ar_model(v: torch.Tensor) -> ARGARCHModel:
    """Terminal AR(1)+GARCH fallback: AR(1) by OLS with constant residual
    variance (α = β = 0), each lane on its valid window; a lane whose AR
    solve is degenerate (a constant series) demotes to the mean model (φ
    = 0)."""
    aligned, nv = ragged_view(v)
    if nv is None:
        w = torch.ones_like(aligned)
        n_val = torch.full(aligned.shape[:-1], aligned.shape[-1],
                           dtype=v.dtype, device=v.device)
    else:
        w = step_weights(aligned.shape[-1], nv[..., None], dtype=v.dtype)
        n_val = torch.clamp(nv.to(v.dtype), min=1.0)
    ar = autoregression.fit(aligned, 1, n_valid=nv)
    c = ar.c
    phi = ar.coefficients[..., 0]
    mean_v = (w * aligned).sum(dim=-1) / n_val
    ar_ok = torch.isfinite(c) & torch.isfinite(phi)
    c = torch.where(ar_ok, c, mean_v)
    phi = torch.where(ar_ok, phi, torch.zeros_like(phi))
    resid = autoregression.ARModel(c, phi[..., None]) \
        .remove_time_dependent_effects(aligned)
    mean_r = (w * resid).sum(dim=-1) / n_val
    var = (w * (resid - mean_r[..., None]) ** 2).sum(dim=-1) / n_val
    var = torch.clamp(var, min=1e-12)
    zeros = torch.zeros_like(var)
    ok = torch.isfinite(var) & torch.isfinite(phi) & torch.isfinite(c)
    nan = torch.full((), float("nan"), dtype=v.dtype, device=v.device)
    return ARGARCHModel(c, phi, var, zeros, zeros,
                        diagnostics=FitDiagnostics(
                            ok, torch.zeros(ok.shape, dtype=torch.int32,
                                            device=v.device),
                            torch.where(ok, var, nan)))


def fit_ar_garch_resilient(ts,
                           retry: Optional[_resilience.RetryPolicy] = None,
                           device=None, **kwargs):
    """Fail-soft batched AR(1)+GARCH(1,1) on ``device``: the two-stage fit
    (multi-start retry on its GARCH stage) -> AR(1) with constant residual
    variance.  ``ts (n_series, n)``; returns ``(model, FitOutcome)``."""
    if retry is None:
        retry = _resilience.RetryPolicy()
    values, dev = _on_device(ts, device)
    chain = [
        ("argarch", lambda v: fit_ar_garch(v, retry=retry, device=dev,
                                           **kwargs)),
        ("ar_const", _const_variance_ar_model),
    ]
    return _resilience.resilient_fit(values, chain, min_len=3,
                                     family="argarch")


_EGARCH_KAPPA = 0.7978845608028654     # E|z| = sqrt(2/pi) for Gaussian z


class EGARCHModel(NamedTuple):
    """Nelson (1991) EGARCH(1,1)::

        log h_t = ω + β log h_{t-1} + α (|z_{t-1}| - sqrt(2/π)) + γ z_{t-1}
        z_t     = η_t / sqrt(h_t),     log h_0 = ω / (1 - β)

    ``gamma`` (the leverage term) defaults to 0.  Parameters are scalars
    or ``(n_series,)``."""
    omega: torch.Tensor
    alpha: torch.Tensor
    beta: torch.Tensor
    gamma: torch.Tensor = 0.0
    diagnostics: Optional[FitDiagnostics] = None

    @property
    def _params(self):
        return _fields(self, ("omega", "alpha", "beta", "gamma"))

    def _log_h0(self):
        w, _, b, _ = self._params
        return w / (1.0 - b)

    def _log_variances(self, ts: torch.Tensor) -> torch.Tensor:
        """The sequential log-variance path, a step loop over the lane
        batch: about 7 elementwise launches a step."""
        w, a, b, g = self._params
        base = w - a * _EGARCH_KAPPA
        logh = self._log_h0().expand(ts.shape[:-1]) if ts.ndim > 1 \
            else self._log_h0()
        out = [logh]
        for t in range(1, ts.shape[-1]):
            z = ts[..., t - 1] * torch.exp(-0.5 * logh)
            logh = torch.addcmul(torch.addcmul(torch.addcmul(
                base, b, logh), a, torch.abs(z)), g, z)
            out.append(logh)
        return torch.stack(out, dim=-1)

    def variances(self, ts) -> torch.Tensor:
        """Conditional-variance path ``h`` aligned with ``ts`` (``h[0]``
        the stationary seed)."""
        ts = _series(ts, self._params[0])
        return torch.exp(self._log_variances(ts))

    def log_likelihood(self, ts) -> torch.Tensor:
        """Gaussian log likelihood under the log-variance recurrence (the
        ``t >= 1`` window of :meth:`GARCHModel.log_likelihood`)."""
        ts = _series(ts, self._params[0])
        return _gaussian_ll(ts, self.variances(ts))

    def gradient(self, ts) -> torch.Tensor:
        """d log-likelihood / d(ω, α, β, γ) by autograd; ``(..., 4)``."""
        return _packed_gradient(
            lambda prm: EGARCHModel(prm[..., 0], prm[..., 1], prm[..., 2],
                                    prm[..., 3]),
            self._params, ts)

    def remove_time_dependent_effects(self, ts) -> torch.Tensor:
        """Standardize: ``z_t = η_t / sqrt(h_t)``."""
        ts = _series(ts, self._params[0])
        return ts / torch.sqrt(self.variances(ts))

    def _filter_with_log_variances(self, z):
        """Filter standardized draws; returns ``(η, log h)``.  The driving
        terms are the input z's, so ``log h`` is affine in itself: a
        log-depth scan (``ops.scan_parallel.linear_recurrence``)."""
        w, a, b, g = self._params
        z = _series(z, w)
        w, a, b, g = (_lane(p, z) for p in (w, a, b, g))
        drive = w + a * (torch.abs(z[..., :-1]) - _EGARCH_KAPPA) \
            + g * z[..., :-1]
        logh0 = torch.broadcast_to(w / (1.0 - b), z[..., :1].shape)
        coef = torch.cat([torch.zeros_like(logh0),
                          torch.broadcast_to(b, drive.shape)], dim=-1)
        off = torch.cat([logh0, drive], dim=-1)
        logh = linear_recurrence(coef, off)
        return z * torch.exp(0.5 * logh), logh

    def add_time_dependent_effects(self, ts) -> torch.Tensor:
        """Filter: scale standardized draws by the conditional
        volatility."""
        return self._filter_with_log_variances(ts)[0]

    def sample_with_variances(self, n: int,
                              generator: Optional[torch.Generator] = None,
                              shape=()):
        """Gaussian draws ``(*shape, n)`` pushed through the filter;
        returns ``(ts, h)``."""
        w = self._params[0]
        gen_dev = generator.device if generator is not None else w.device
        z = torch.randn((*shape, n), generator=generator, dtype=w.dtype,
                        device=gen_dev).to(w.device)
        ts, logh = self._filter_with_log_variances(z)
        return ts, torch.exp(logh)

    def sample(self, n: int, generator: Optional[torch.Generator] = None,
               shape=()) -> torch.Tensor:
        return self.sample_with_variances(n, generator, shape)[0]


def _eg_constrain(params: torch.Tensor):
    """Unconstrained (w, a, s, g) -> (ω, α, β, γ) with |β| < 1 by
    tanh."""
    return (params[..., 0], params[..., 1], torch.tanh(params[..., 2]),
            params[..., 3])


def _egarch_neg_ll(params: torch.Tensor, series: torch.Tensor):
    w, a, b, g = _eg_constrain(params)
    return -EGARCHModel(w, a, b, g).log_likelihood(series)


def _egarch_derivatives(params: torch.Tensor, series: torch.Tensor,
                        order: int = 2):
    """The EGARCH negative log likelihood of unconstrained ``params (S,
    4)`` on ``series (S, n)`` with its exact gradient (``order >= 1``)
    and Hessian (``order == 2``): ``(f (S,), g (S, 4), H (S, 4, 4))``.

    Forward-mode differentiation written out: the step loop carries the
    log variance ``L``, its gradient ``dL`` and its Hessian ``d2L`` over
    (ω, α, β, γ).  With ``z = x e^{-L/2}``, ``c = α sgn z + γ`` and ``m =
    β - c z / 2``, a step is ``dL' = u + m dL`` and ``d2L' = m d2L + v dLᵀ
    + dL vᵀ + (c z / 4) dL dLᵀ``, ``u = (1, |z| - κ, L, z)``, ``v = (0,
    -|z| / 2, 1, -z / 2)``; the likelihood's sums then run over the
    stacked path at once, and the chain rule through β = tanh(s) ends it.
    The same function as autograd's, in one pass: about 24 launches a
    step for ``order == 2``, 14 for 1 and 7 for 0, where the autograd
    Hessian runs the step loop's graph five times over.  The CPU tests
    hold it against autograd and the JAX package to rounding."""
    w, a, s_, g = params.unbind(-1)
    b = torch.tanh(s_)
    S, n = series.shape
    one = torch.ones_like(w)
    zero = torch.zeros_like(w)
    base = w - a * _EGARCH_KAPPA
    inv = 1.0 / (1.0 - b)
    L = w * inv
    Ls = []
    if order >= 1:
        dL = torch.stack([inv, zero, w * inv * inv, zero], dim=-1)
        dLs = []
    if order >= 2:
        d2L = torch.zeros((S, 4, 4), dtype=params.dtype,
                          device=params.device)
        d2L[:, 0, 2] = inv * inv
        d2L[:, 2, 0] = inv * inv
        d2L[:, 2, 2] = 2.0 * w * inv * inv * inv
        d2Ls = []
    for t in range(1, n):
        z = series[:, t - 1] * torch.exp(-0.5 * L)
        az = torch.abs(z)
        if order >= 1:
            c = torch.addcmul(g, a, torch.sign(z))
            cz = c * z
            m = torch.add(b, cz, alpha=-0.5)
            u = torch.stack([one, az - _EGARCH_KAPPA, L, z], dim=-1)
            if order >= 2:
                v = torch.stack([zero, -0.5 * az, one, -0.5 * z], dim=-1)
                vd = v[:, :, None] * dL[:, None, :]
                dd = dL[:, :, None] * dL[:, None, :]
                d2L = torch.addcmul(m[:, None, None] * d2L + vd
                                    + vd.transpose(1, 2),
                                    (0.25 * cz)[:, None, None], dd)
                d2Ls.append(d2L)
            dL = torch.addcmul(u, m[:, None], dL)
            dLs.append(dL)
        L = torch.addcmul(torch.addcmul(torch.addcmul(base, b, L), a, az),
                          g, z)
        Ls.append(L)
    Lt = torch.stack(Ls, dim=-1)                           # (S, n-1)
    # the likelihood through h = e^L, as EGARCHModel.log_likelihood: a
    # lane whose h over- or underflows gets the same f, and NaN
    # derivatives, as autograd gives it
    h = torch.exp(Lt)
    r = 0.5 * series[:, 1:] ** 2 / h
    f = (0.5 * torch.log(h) + r).sum(dim=-1) + 0.5 * _LOG_2PI * (n - 1)
    if order == 0:
        return f
    wgt = 0.5 - r
    wgt = torch.where(((h == 0) | torch.isinf(h)).any(dim=-1, keepdim=True),
                      torch.full_like(wgt, float("nan")), wgt)
    # the sums over time as elementwise products and reductions, not
    # einsum: a library matmul may pick its algorithm by the lane count,
    # and a lane's result must not depend on the lanes beside it
    dLt = torch.stack(dLs, dim=1)                          # (S, n-1, 4)
    grad = (wgt[:, :, None] * dLt).sum(dim=1)
    jb = 1.0 - b * b                       # d tanh(s) / ds
    scale = torch.stack([one, one, jb, one], dim=-1)
    if order == 1:
        return f, grad * scale
    rd = r[:, :, None] * dLt
    H = (wgt[:, :, None, None] * torch.stack(d2Ls, dim=1)
         + rd[:, :, :, None] * dLt[:, :, None, :]).sum(dim=1)
    H = H * scale[:, :, None] * scale[:, None, :]
    H[:, 2, 2] = H[:, 2, 2] - 2.0 * b * jb * grad[:, 2]
    return f, grad * scale, H


# line-search trials a call of the EGARCH descent evaluates for every lane
# (``minimize_box``'s ``trials_per_call``: the same per-lane result in
# fewer calls; a step at the variance-matched start takes ~10 halvings)
DESCENT_TRIALS = 16


class _ReplayedDerivatives:
    """:func:`_egarch_derivatives` at one ``order``, replayed from a CUDA
    graph on a card.  The pass is ~24 small launches a step, so its eager
    time is the host's launch rate; the graph, captured at the first
    call's lane count, replays them without the host.  A call with fewer
    lanes (the solver gathers the running ones out) fills the head of the
    captured buffers and reads the head of the outputs: lanes are
    independent, so the stale tail changes no lane.  On the CPU it is the
    eager pass."""

    def __init__(self, order: int):
        self.order = order
        self.graph = None

    def __call__(self, x: torch.Tensor, y: torch.Tensor):
        if not x.is_cuda:
            return _egarch_derivatives(x, y, self.order)
        W = x.shape[0]
        if self.graph is None or W > self.x.shape[0] \
                or y.shape[1] != self.y.shape[1]:
            self._capture(x, y)
        self.x[:W].copy_(x)
        self.y[:W].copy_(y)
        self.graph.replay()
        out = tuple(o[:W].clone() for o in self.out)
        return out if self.order else out[0]

    def _capture(self, x: torch.Tensor, y: torch.Tensor) -> None:
        self.graph = None
        self.x, self.y = x.clone(), y.clone()
        side = torch.cuda.Stream(x.device)
        side.wait_stream(torch.cuda.current_stream(x.device))
        with torch.cuda.stream(side):         # warm-up outside the capture
            _egarch_derivatives(self.x, self.y, self.order)
        torch.cuda.current_stream(x.device).wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            out = _egarch_derivatives(self.x, self.y, self.order)
        self.out = out if isinstance(out, tuple) else (out,)
        self.graph = graph


def fit_egarch(ts, init=(0.2, 0.9, 0.0), tol: Optional[float] = None,
               max_iter: Optional[int] = None, method: str = "newton",
               retry=None, device=None, stats: Optional[dict] = None,
               _restart_draws=None) -> EGARCHModel:
    """Fit EGARCH(1,1) by maximum likelihood, batched over leading dims
    on ``device`` (``None`` means CUDA).

    ``init = (α0, β0, γ0)``; ``ω0`` matches the stationary log variance to
    the sample ``log var(ts)``.  β is optimized through tanh, so every
    iterate keeps |β| < 1.  ``method="newton"`` (default): damped Newton
    on the exact 4 × 4 Hessian (the solver's dtype-aware tolerance, 200
    iterations); ``"descent"``: the Armijo-backtracking descent of
    ``minimize_box`` on an unbounded box (1e-12, 1000 iterations).  Both
    take the likelihood's derivatives from the one-pass forward-mode
    :func:`_egarch_derivatives` (exact; autograd's Hessian of the
    sequential step loop costs five passes of its graph), on a card
    replayed from a CUDA graph (:class:`_ReplayedDerivatives`).  Explicit ``tol`` / ``max_iter`` win; ``retry`` as in
    :func:`fit`."""
    ts, dev = _on_device(ts, device)
    batch, n = ts.shape[:-1], ts.shape[-1]
    y = ts.reshape(-1, n)
    a0, b0, g0 = (torch.as_tensor(v, dtype=ts.dtype, device=dev)
                  for v in init)
    logvar = torch.log(torch.clamp(y.var(dim=-1, unbiased=False),
                                   min=1e-12))
    w0 = (1.0 - b0) * logvar
    x0 = torch.stack(torch.broadcast_tensors(
        w0, a0, torch.atanh(b0), g0), dim=-1).to(ts.dtype).contiguous()
    rk = _resilience.retry_kwargs(retry)
    if max_iter is None and retry is not None:
        max_iter = retry.max_iter
    st = {} if stats is None else stats
    if method == "newton":
        res = minimize_newton(None, x0, y, tol=tol,
                              max_iter=200 if max_iter is None else max_iter,
                              jitter_draws=_restart_draws, stats=st,
                              value_grad_hess_fn=_ReplayedDerivatives(2),
                              **rk)
    elif method == "descent":
        def evaluator_for(lanes):
            yy = y if lanes is None else y.index_select(0, lanes)
            vag = _ReplayedDerivatives(1)

            def ev(x):
                if x.ndim == 2:
                    return vag(x, yy)
                K, L, k = x.shape             # K line-search trials a lane
                f, g = vag(x.reshape(K * L, k), yy.repeat(K, 1))
                return f.reshape(K, L), g.reshape(K, L, k)
            return ev

        vag = evaluator_for(None)
        res = minimize_box(vag, x0, -math.inf, math.inf,
                           tol=1e-12 if tol is None else tol,
                           max_iter=1000 if max_iter is None else max_iter,
                           trials_per_call=DESCENT_TRIALS,
                           evaluator_for=evaluator_for,
                           jitter_draws=_restart_draws, stats=st, **rk)
    else:
        raise ValueError(f"unknown method {method!r}")
    ok = torch.isfinite(res.x).all(dim=-1, keepdim=True)
    params = torch.where(ok, res.x, x0)
    diag = _reshape_diag(diagnostics_from(res, ok), batch)
    return EGARCHModel(*(v.reshape(batch) for v in _eg_constrain(params)),
                       diagnostics=diag)


def fit_egarch_panel(panel, **kwargs) -> EGARCHModel:
    """Batched EGARCH fit of a Panel on its device."""
    return fit_egarch(panel.values, device=panel.device, **kwargs)


def _const_log_variance_model(v: torch.Tensor) -> EGARCHModel:
    """Terminal EGARCH fallback: constant log variance matched to the
    sample variance (α = β = γ = 0); NaN padding is ignored."""
    var = torch.clamp(_nanvar(v), min=1e-12)
    zeros = torch.zeros_like(var)
    return EGARCHModel(torch.log(var), zeros, zeros, zeros,
                       diagnostics=_const_fallback_diag(v, var))


def fit_egarch_resilient(ts,
                         retry: Optional[_resilience.RetryPolicy] = None,
                         device=None, **kwargs):
    """Fail-soft batched EGARCH(1,1) on ``device``: Newton with
    multi-start retry -> Armijo descent -> the constant-log-variance
    model.  ``ts (n_series, n)``; returns ``(model, FitOutcome)``."""
    if retry is None:
        retry = _resilience.RetryPolicy()
    values, dev = _on_device(ts, device)
    chain = [
        ("newton", lambda v: fit_egarch(v, retry=retry, device=dev,
                                        **kwargs)),
        ("descent", lambda v: fit_egarch(
            v, device=dev, **_resilience.override_kwargs(
                kwargs, method="descent"))),
        ("const", _const_log_variance_model),
    ]
    return _resilience.resilient_fit(values, chain, min_len=3,
                                     family="egarch")
