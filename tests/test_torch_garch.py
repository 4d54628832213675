"""The port's volatility models (``models.garch``) against the JAX
package's, on the CPU in float64.

At fixed parameters the likelihoods, gradients, variance paths,
forecasts and time-dependent effects agree to 1e-10 relative (the GARCH
variance is a log-depth scan on one side and an associative scan on the
other; the EGARCH derivatives of the port's fits come from its one-pass
forward-mode recurrence, held here against autograd).  The three fits
run on 8 x 256 series and agree to 1e-5 on the lanes converged in both;
the three fail-soft chains agree on every lane's status and health.
Each JAX fit is called once per module (its programs compile for tens
of seconds), and the chains run without restarts at the fits' shape, so
their primary stages reuse those programs."""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spark_timeseries_tpu.models import garch as jg
from spark_timeseries_tpu.utils.resilience import RetryPolicy as JRetry
from spark_timeseries_tpu_torch import engine
from spark_timeseries_tpu_torch.models import garch
from spark_timeseries_tpu_torch.models.convert import (ar_garch_from_numpy,
                                                       egarch_from_numpy,
                                                       garch_from_numpy)
from spark_timeseries_tpu_torch.ops import optimize
from spark_timeseries_tpu_torch.utils.resilience import RetryPolicy

torch.set_num_threads(1)

S, N = 8, 256
RTOL = 1e-10


def ar_garch_panel(S, n, seed, c=0.1, phi=0.3, w=0.05, a=0.1, b=0.85):
    """BASELINE config #4's generator: AR(1) + GARCH(1,1) innovations."""
    rng = np.random.default_rng(seed)
    z = rng.normal(size=(S, n))
    y = np.zeros((S, n))
    h = np.full(S, w / (1 - a - b))
    eta = np.zeros(S)
    for t in range(n):
        h = w + a * eta ** 2 + b * h
        eta = np.sqrt(h) * z[:, t]
        y[:, t] = c + phi * (y[:, t - 1] if t else 0.0) + eta
    return y


@pytest.fixture(scope="module")
def panel():
    y = ar_garch_panel(S, N, 0)
    return y, y - y.mean(axis=1, keepdims=True)


@pytest.fixture(scope="module")
def fits(panel):
    y, e = panel
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return {
            "garch": (jg.fit(jnp.asarray(e)), garch.fit(e, device="cpu")),
            "argarch": (jg.fit_ar_garch(jnp.asarray(y)),
                        garch.fit_ar_garch(y, device="cpu")),
            "egarch": (jg.fit_egarch(jnp.asarray(e)),
                       garch.fit_egarch(e, device="cpu")),
        }


def _params(rng):
    return (rng.uniform(0.02, 0.1, S), rng.uniform(0.05, 0.2, S),
            rng.uniform(0.6, 0.78, S))


def _jit(fn, *args):
    """``fn(*args)`` of the JAX package compiled as one program, where its
    eager call would compile each operation on its own (the same
    arithmetic, ~1e-16 apart)."""
    return jax.jit(fn)(*args)


def _close(got, want, rtol=RTOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=1e-13)


def test_garch_model_matches_jax(panel):
    _, e = panel
    w, a, b = _params(np.random.default_rng(1))
    jm = jg.GARCHModel(jnp.asarray(w), jnp.asarray(a), jnp.asarray(b))
    tm = garch_from_numpy(w, a, b, device="cpu")
    je = jnp.asarray(e)
    _close(tm.log_likelihood(e), _jit(jm.log_likelihood, je))
    _close(tm.gradient(e), _jit(jm.gradient, je))
    _close(tm.forecast_variance(e, 7),
           _jit(lambda x: jm.forecast_variance(x, 7), je))
    _close(tm.remove_time_dependent_effects(e),
           _jit(jm.remove_time_dependent_effects, je))
    _close(tm.add_time_dependent_effects(e),
           _jit(jm.add_time_dependent_effects, je))
    # an IGARCH lane takes the κ → 1 limit
    ig = garch_from_numpy(*np.array([0.05, 0.1, 0.9]), device="cpu")
    _close(ig.forecast_variance(e[0], 4),
           _jit(lambda x: jg.GARCHModel(0.05, 0.1, 0.9)
                .forecast_variance(x, 4), je[0]))
    ts, vs = tm.sample_with_variances(64, torch.Generator().manual_seed(0),
                                      (S,))
    assert ts.shape == vs.shape == (S, 64) and (vs > 0).all()
    assert (ts[:, 0] == 0).all()


def test_ar_garch_model_matches_jax(panel):
    y, _ = panel
    rng = np.random.default_rng(2)
    c, phi = rng.normal(0, 0.1, S), rng.uniform(0.1, 0.5, S)
    w, a, b = _params(rng)
    args = (c, phi, w, a, b)
    jm = jg.ARGARCHModel(*(jnp.asarray(v) for v in args))
    tm = ar_garch_from_numpy(*args, device="cpu")
    _close(tm.remove_time_dependent_effects(y),
           _jit(jm.remove_time_dependent_effects, jnp.asarray(y)))
    _close(tm.add_time_dependent_effects(y),
           _jit(jm.add_time_dependent_effects, jnp.asarray(y)))
    ts, vs = tm.sample_with_variances(32, torch.Generator().manual_seed(1),
                                      (S,))
    assert ts.shape == (S, 32) and (vs > 0).all()


def test_egarch_model_matches_jax(panel):
    _, e = panel
    rng = np.random.default_rng(3)
    w, a, b, g = (rng.normal(-0.3, 0.1, S), rng.uniform(0.05, 0.3, S),
                  rng.uniform(0.6, 0.95, S), rng.normal(0, 0.1, S))
    jm = jg.EGARCHModel(*(jnp.asarray(v) for v in (w, a, b, g)))
    tm = egarch_from_numpy(w, a, b, g, device="cpu")
    je = jnp.asarray(e)
    _close(tm.log_likelihood(e), _jit(jm.log_likelihood, je))
    _close(tm.variances(e), _jit(jm.variances, je))
    _close(tm.gradient(e), _jit(jm.gradient, je))
    _close(tm.remove_time_dependent_effects(e),
           _jit(jm.remove_time_dependent_effects, je))
    _close(tm.add_time_dependent_effects(e),
           _jit(jm.add_time_dependent_effects, je))
    ts, h = tm.sample_with_variances(48, torch.Generator().manual_seed(2),
                                     (S,))
    assert ts.shape == h.shape == (S, 48) and (h > 0).all()


def test_egarch_fused_derivatives_are_autograds(panel):
    """The fits' one-pass EGARCH value, gradient and Hessian against
    autograd's of the same likelihood (the Hessian by double
    backward)."""
    _, e = panel
    rng = np.random.default_rng(4)
    x = torch.as_tensor(np.c_[rng.normal(-0.3, 0.1, S),
                              rng.uniform(0.05, 0.3, S),
                              rng.uniform(0.5, 2.0, S),
                              rng.normal(0, 0.1, S)])
    y = torch.as_tensor(e)
    f, g, H = optimize._value_grad_hess(garch._egarch_neg_ll, x, (y,))
    f2, g2, H2 = garch._egarch_derivatives(x, y, 2)
    for got, want in ((f2, f), (g2, g), (H2, H)):
        _close(got, want)
    f1, g1 = garch._egarch_derivatives(x, y, 1)
    _close(f1, f)
    _close(g1, g)
    _close(garch._egarch_derivatives(x, y, 0), f)


@pytest.mark.parametrize("family", ["garch", "argarch", "egarch"])
def test_fit_matches_jax(fits, family):
    want, got = fits[family]
    cw = np.asarray(want.diagnostics.converged)
    cg = got.diagnostics.converged.numpy()
    both = cw & cg
    assert both.mean() >= 0.75 and (cw == cg).mean() >= 0.75
    for f in want._fields:
        if f == "diagnostics":
            continue
        np.testing.assert_allclose(
            getattr(got, f).numpy()[both], np.asarray(getattr(want, f))[both],
            atol=1e-5, err_msg=f)
    np.testing.assert_allclose(got.diagnostics.fun.numpy()[both],
                               np.asarray(want.diagnostics.fun)[both],
                               rtol=1e-8)


def test_garch_bfgs_fit_reaches_the_newton_optimum(panel, fits):
    """``method="bfgs"`` (``minimize_bfgs``, held against the JAX solver
    in ``test_torch_optimize_newton_bfgs.py``) ends at the Newton fit's
    likelihood on the lanes both converge."""
    _, e = panel
    newton = fits["garch"][1]
    got = garch.fit(e, method="bfgs", device="cpu")
    both = (got.diagnostics.converged & newton.diagnostics.converged).numpy()
    assert both.mean() >= 0.75
    np.testing.assert_allclose(got.diagnostics.fun.numpy()[both],
                               newton.diagnostics.fun.numpy()[both],
                               rtol=1e-7)


def _pathological(y):
    y = y.copy()
    y[0] = np.nan
    y[1] = 2.0
    y[2, 5] = np.inf
    y[3, :-2] = np.nan
    return y


@pytest.mark.parametrize("family", ["garch", "argarch", "egarch"])
def test_fit_resilient_matches_jax(panel, fits, family):
    y, e = panel
    v = _pathological(y if family == "argarch" else e)
    j_fn = {"garch": jg.fit_resilient, "argarch": jg.fit_ar_garch_resilient,
            "egarch": jg.fit_egarch_resilient}[family]
    t_fn = engine.FitEngine.resilient_dispatch(family)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jm, jo = j_fn(jnp.asarray(v), retry=JRetry(max_restarts=0))
        tm, to = t_fn(v, retry=RetryPolicy(max_restarts=0), device="cpu")
    np.testing.assert_array_equal(to.status, np.asarray(jo.status))
    np.testing.assert_array_equal(to.health, np.asarray(jo.health))
    np.testing.assert_array_equal(to.fallback_used,
                                  np.asarray(jo.fallback_used))
    usable = np.isin(to.status, (0, 1, 2))
    np.testing.assert_allclose(to.params[usable],
                               np.asarray(jo.params)[usable], atol=1e-5)
    assert np.isnan(to.params[~usable & (to.status == 3)]).all()
