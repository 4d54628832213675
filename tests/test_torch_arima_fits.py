"""The port's new ARIMA fits against the JAX package's, on the CPU in
float64: ``method="css-bobyqa"``, ``retry=`` (the JAX package's restart
draws handed in), the stepwise ``auto_fit`` and ``refit_unconverged``.
Where a lane's AR part is explosive or its MA part not invertible, the
last bits of its coefficients set the leading digits of its residuals,
so coefficient comparisons keep to stationary and invertible lanes."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spark_timeseries_tpu.models import arima as j_arima
from spark_timeseries_tpu.models import base as j_base
from spark_timeseries_tpu.utils import resilience as j_res
from spark_timeseries_tpu_torch.models import arima, base, convert
from spark_timeseries_tpu_torch.utils import resilience
from torch_jax_line_search import without_line_search_faults

torch.set_num_threads(1)


def _arima_rows(rng, S, n, d=1):
    e = rng.normal(size=(S, n + 16))
    y = np.zeros_like(e)
    for t in range(2, e.shape[1]):
        y[:, t] = 1.0 + 0.25 * y[:, t - 1] + 0.35 * y[:, t - 2] + e[:, t] \
            + 0.3 * e[:, t - 1] + 0.1 * e[:, t - 2]
    y = y[:, 16:]
    for _ in range(d):
        y = np.cumsum(y, axis=1)
    return y


def _close(got, want, rtol=1e-10, atol=0.0, lanes=None):
    g = got.detach().numpy()
    w = np.asarray(want)
    if lanes is not None:
        g, w = g[lanes], w[lanes]
    np.testing.assert_allclose(g, w, rtol=rtol, atol=atol)


def test_css_bobyqa_and_retry_fits_match_jax():
    y = _arima_rows(np.random.default_rng(5), 12, 64)
    got = arima.fit(2, 1, 2, y, method="css-bobyqa", max_iter=20,
                    warn=False, device="cpu")
    want = j_arima.fit(2, 1, 2, jnp.asarray(y), method="css-bobyqa",
                       max_iter=20, warn=False)
    # the same projected-gradient state machine on gradients that agree
    # to ~1e-12 (20 steps along flat ridges amplify that to ~1e-8):
    # equal iterations, coefficients close on sane lanes
    np.testing.assert_array_equal(got.diagnostics.n_iter.numpy(),
                                  np.asarray(want.diagnostics.n_iter))
    sane = got.is_stationary() & got.is_invertible()
    _close(got.coefficients, want.coefficients, rtol=0, atol=1e-7,
           lanes=sane)
    # fun at coefficients 1e-7 apart, off the optimum
    _close(got.diagnostics.fun, want.diagnostics.fun, rtol=1e-8,
           lanes=sane)
    # retry: the JAX draws handed in, a budget small enough to retry
    keys = jax.random.split(jax.random.PRNGKey(0), 12)
    draws = np.stack([np.asarray(jax.vmap(
        lambda kk, a=a: jax.random.normal(jax.random.fold_in(kk, a), (5,),
                                          jnp.float64))(keys))
        for a in (1, 2)])
    got = arima.fit(2, 1, 2, y, warn=False, device="cpu", max_iter=6,
                    retry=resilience.RetryPolicy(), _restart_draws=draws)
    want = j_arima.fit(2, 1, 2, jnp.asarray(y), warn=False, max_iter=6,
                       retry=j_res.RetryPolicy())
    att = got.diagnostics.attempts.numpy()
    assert att.max() > 1
    np.testing.assert_array_equal(att, np.asarray(want.diagnostics.attempts))
    np.testing.assert_array_equal(got.diagnostics.converged.numpy(),
                                  np.asarray(want.diagnostics.converged))
    _close(got.coefficients, want.coefficients, rtol=0, atol=1e-7)
    # RetryPolicy.max_iter is the per-attempt budget
    capped = arima.fit(2, 1, 2, y, warn=False, device="cpu",
                       retry=resilience.RetryPolicy(max_restarts=0,
                                                    max_iter=6))
    assert capped.diagnostics.attempts is None
    assert capped.diagnostics.n_iter.max() <= 6
    assert convert.retry_policy_from(j_res.RetryPolicy(3, 0.1, 2, 9)) \
        == resilience.RetryPolicy(3, 0.1, 2, 9)


def test_stepwise_auto_fit_matches_jax():
    y = _arima_rows(np.random.default_rng(2), 1, 90)[0]
    got = arima.auto_fit(y, max_p=2, max_q=2, device="cpu")
    want = j_arima.auto_fit(jnp.asarray(y), max_p=2, max_q=2)
    assert (got.p, got.d, got.q, got.has_intercept) \
        == (want.p, want.d, want.q, want.has_intercept)
    _close(got.coefficients, want.coefficients, rtol=1e-7, atol=1e-9)
    with pytest.raises(ValueError, match="stationarity"):
        arima._choose_d(torch.from_numpy(np.exp(np.arange(40.0) / 3)), 0)


def test_refit_unconverged_matches_jax():
    y = _arima_rows(np.random.default_rng(7), 12, 64)
    jm = j_arima.fit(2, 1, 2, jnp.asarray(y), warn=False, max_iter=8)
    tm = arima.fit(2, 1, 2, y, warn=False, max_iter=8, device="cpu")
    conv = tm.diagnostics.converged.numpy()
    assert 0 < conv.sum() < 12

    def j_refit(v, m):
        return j_arima.fit(2, 1, 2, v, max_iter=30, warn=False,
                           user_init_params=m.coefficients)

    def t_refit(v, m):
        return arima.fit(2, 1, 2, v, max_iter=30, warn=False, device="cpu",
                         user_init_params=m.coefficients)

    want = j_base.refit_unconverged(jnp.asarray(y), jm, j_refit,
                                    min_bucket=4)
    got = base.refit_unconverged(torch.from_numpy(y), tm, t_refit,
                                 min_bucket=4)
    np.testing.assert_array_equal(got.diagnostics.converged.numpy(),
                                  np.asarray(want.diagnostics.converged))
    _close(got.coefficients, want.coefficients, rtol=0, atol=1e-7)
    # converged lanes come back as they were
    assert torch.equal(got.coefficients[conv], tm.coefficients[conv])
    with pytest.raises(ValueError, match="unbatched"):
        base.refit_unconverged(y[0], arima.fit(2, 1, 2, y[0], warn=False,
                                               device="cpu"), t_refit)


@pytest.fixture(scope="module")
def jax_cgd():
    """The JAX package's css-cgd references held with the port's line
    search, in one ``without_line_search_faults`` block (it clears jax's
    compile caches on entry and exit): the fit of the 16 x 128 rows of
    :func:`test_css_cgd_matches_jax` and the negative log likelihoods of
    the 64-lane panel of :func:`test_css_cgd_misses_css_lm_where_jax_does`."""
    import torch_cgd_vs_lm_share as share

    y = _arima_rows(np.random.default_rng(9), 16, 128)
    values = share.panel(64)
    with without_line_search_faults():
        fit = j_arima.fit(2, 1, 2, jnp.asarray(y), method="css-cgd",
                          warn=False)
        nll = share.jax_nll(values)
    return y, fit, values, nll


def test_css_cgd_matches_jax(jax_cgd):
    """``method="css-cgd"``: the batched BFGS over the CSS value and
    gradient (one ``arma_ne`` pass an evaluation on a card) against the
    JAX package's ``minimize_bfgs`` over the autodiff gradient, its line
    search the port's (``torch_jax_line_search``)."""
    y, want, _, _ = jax_cgd
    stats = {}
    got = arima.fit(2, 1, 2, y, method="css-cgd", warn=False, device="cpu",
                    stats=stats)
    np.testing.assert_array_equal(got.diagnostics.converged.numpy(),
                                  np.asarray(want.diagnostics.converged))
    same = got.diagnostics.n_iter.numpy() \
        == np.asarray(want.diagnostics.n_iter)
    assert same.mean() >= 0.9
    sane = got.is_stationary() & got.is_invertible()
    _close(got.coefficients, want.coefficients, rtol=0, atol=1e-7,
           lanes=sane)
    assert stats["ne_launches"] == 0                # no card
    assert stats["bfgs_calls"] > int(got.diagnostics.n_iter.max())


def test_css_cgd_misses_css_lm_where_jax_does(jax_cgd):
    """css-cgd ends within 1e-4 of the css-lm fit's neg-LL on the same
    lanes in the port as in the JAX package run with the port's line
    search (``chip_smoke.py``'s ARIMA panel, 64 lanes): the lanes where
    the BFGS stops short are the reference's, not the port's.  A lane
    within rounding of the 1e-4 edge may fall either side, so the masks
    need only agree on 0.95.  jax's own line search stops short on more
    lanes: every lane within 1e-4 there is within 1e-4 in the port."""
    import torch_cgd_vs_lm_share as share

    _, _, values, nll = jax_cgd
    got = share.shares(*share.port_nll(values))
    want = share.shares(*nll)
    both = got[3] & want[3]
    assert both.sum() >= 60
    assert (got[4] == want[4])[both].mean() >= 0.95
    raw = share.shares(*share.jax_nll(values))
    both = got[3] & raw[3]
    assert (got[4] | ~raw[4])[both].all()
    assert got[0] > raw[0]
