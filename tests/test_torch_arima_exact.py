"""The port's exact-likelihood ARIMA (``arima.fit(objective="exact")``,
``ARIMAModel.log_likelihood_exact``) against the JAX package's, on the
CPU in float64.

Both refine the CSS fit by BFGS on the σ²-concentrated Kalman
likelihood (the JAX package's BFGS run with the two line-search lines
the port changes, ``torch_jax_line_search``) and keep per lane the
better of the refined point and the start.  The exact negative log
likelihoods agree within 1e-8 relative on every lane finite in both.
Parameters are compared (within 1e-6) only on lanes whose CSS start and
exact optimum are both stationary, invertible and away from a
common-factor ridge (no AR root within 0.15 of an MA root,
``arima._cancellation_suspects``): on a ridge the likelihood is flat
along the ridge and the two BFGS runs may stop anywhere on it."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spark_timeseries_tpu.models import arima as j_arima
from spark_timeseries_tpu_torch.models import arima, convert
from torch_jax_line_search import without_line_search_faults

torch.set_num_threads(1)

S, N = 8, 80


def _arima_rows(rng, S, n):
    e = rng.normal(size=(S, n + 16))
    y = np.zeros_like(e)
    for t in range(2, e.shape[1]):
        y[:, t] = 1.0 + 0.25 * y[:, t - 1] + 0.35 * y[:, t - 2] + e[:, t] \
            + 0.3 * e[:, t - 1] + 0.1 * e[:, t - 2]
    return np.cumsum(y[:, 16:], axis=1)


def _ar1(n, phi, seed, const=0.0):
    rng = np.random.default_rng(seed)
    e = rng.normal(size=n)
    y = np.zeros(n)
    for t in range(1, n):
        y[t] = const + phi * y[t - 1] + e[t]
    return y


def _ar1_concentrated_nll(params, y):
    """Closed-form σ²-profiled exact AR(1) negative log likelihood."""
    c, phi = params
    n = len(y)
    mu = c / (1.0 - phi)
    f1 = 1.0 / (1.0 - phi * phi)
    ssq = (y[0] - mu) ** 2 / f1 + np.sum((y[1:] - c - phi * y[:-1]) ** 2)
    sigma2 = ssq / n
    return -(-0.5 * n * (np.log(2 * np.pi * sigma2) + 1.0)
             - 0.5 * np.log(f1))


@pytest.fixture(scope="module")
def fits():
    y = _arima_rows(np.random.default_rng(12), S, N)
    # the JAX fit as one compiled program: its eager call compiles each
    # operation of the CSS fit and the BFGS refine on its own
    with without_line_search_faults():
        want = jax.jit(lambda v: j_arima.fit(2, 1, 2, v, objective="exact",
                                             warn=False))(jnp.asarray(y))
    st = {}
    got = arima.fit(2, 1, 2, y, objective="exact", warn=False,
                    device="cpu", stats=st)
    css = arima.fit(2, 1, 2, y, warn=False, device="cpu")
    return {"y": y, "want": want, "got": got, "css": css, "stats": st}


def _separated(model) -> np.ndarray:
    sus = arima._cancellation_suspects(model)
    return model.is_stationary() & model.is_invertible() & ~sus


def test_exact_fit_matches_jax(fits):
    got, want, css = fits["got"], fits["want"], fits["css"]
    gf = got.diagnostics.fun.numpy()
    wf = np.asarray(want.diagnostics.fun)
    np.testing.assert_array_equal(np.isfinite(gf), np.isfinite(wf))
    fin = np.isfinite(gf)
    assert fin.sum() >= S - 2
    np.testing.assert_allclose(gf[fin], wf[fin], rtol=1e-8)
    jm = convert.arima_from_numpy(2, 1, 2, np.asarray(want.coefficients),
                                  device="cpu")
    lanes = _separated(got) & _separated(jm) & _separated(css)
    assert lanes.sum() >= S // 2
    np.testing.assert_allclose(got.coefficients.numpy()[lanes],
                               np.asarray(want.coefficients)[lanes],
                               rtol=1e-6, atol=1e-8)
    np.testing.assert_array_equal(got.diagnostics.n_iter.numpy()[lanes],
                                  np.asarray(want.diagnostics.n_iter)[lanes])
    np.testing.assert_array_equal(
        got.diagnostics.converged.numpy()[lanes],
        np.asarray(want.diagnostics.converged)[lanes])
    # the CSS stage ran on the CPU (no LM-fit launch), then the refine
    assert fits["stats"]["lm_fit_launches"] == 0
    assert fits["stats"]["exact_calls"] > got.diagnostics.n_iter.max()


def test_log_likelihood_exact_matches_jax_and_never_below_css(fits):
    """``log_likelihood_exact`` at the JAX package's parameters is minus
    its reported exact objective; and by the keep-the-better rule the
    exact fit's exact log likelihood is never below its CSS start's."""
    y, want = fits["y"], fits["want"]
    jm = convert.arima_from_numpy(2, 1, 2, np.asarray(want.coefficients),
                                  device="cpu")
    ll = jm.log_likelihood_exact(y).numpy()
    wf = np.asarray(want.diagnostics.fun)
    fin = np.isfinite(wf)
    np.testing.assert_allclose(-ll[fin], wf[fin], rtol=1e-10)
    ll_exact = fits["got"].log_likelihood_exact(y).numpy()
    ll_css = fits["css"].log_likelihood_exact(y).numpy()
    both = np.isfinite(ll_exact) & np.isfinite(ll_css)
    assert both.sum() >= S - 2
    assert (ll_exact[both] >= ll_css[both]).all()
    # a single series is a batch of one
    one = arima.ARIMAModel(2, 1, 2, fits["got"].coefficients[0])
    np.testing.assert_allclose(float(one.log_likelihood_exact(y[0])),
                               ll_exact[0], rtol=1e-12)


def test_exact_fit_ar1_oracle_and_ragged_lanes():
    """The AR(1) exact fit against the closed form (no Kalman machinery):
    its objective is the closed form at its coefficients and no worse
    than at the CSS solution.  A NaN-padded lane fits its valid window:
    as the trimmed series alone."""
    y = _ar1(300, 0.6, seed=5, const=0.4)
    css = arima.fit(1, 0, 0, y, warn=False, device="cpu")
    exact = arima.fit(1, 0, 0, y, warn=False, objective="exact",
                      device="cpu")
    nll_css = _ar1_concentrated_nll(css.coefficients.numpy(), y)
    nll_ex = _ar1_concentrated_nll(exact.coefficients.numpy(), y)
    assert nll_ex <= nll_css + 1e-9
    assert bool(exact.diagnostics.converged)
    np.testing.assert_allclose(float(exact.diagnostics.fun), nll_ex,
                               rtol=1e-8)
    rows = _arima_rows(np.random.default_rng(3), 2, 70)
    padded = rows.copy()
    padded[1, :9] = np.nan
    both = arima.fit(2, 1, 2, padded, warn=False, objective="exact",
                     device="cpu")
    alone = arima.fit(2, 1, 2, rows[1, 9:], warn=False, objective="exact",
                      device="cpu")
    np.testing.assert_allclose(both.coefficients[1].numpy(),
                               alone.coefficients.numpy(), rtol=1e-9,
                               atol=1e-12)
    np.testing.assert_allclose(float(both.diagnostics.fun[1]),
                               float(alone.diagnostics.fun), rtol=1e-10)
    with pytest.raises(ValueError, match="objective"):
        arima.fit(1, 0, 0, y, objective="banana", device="cpu")
