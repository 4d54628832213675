"""The port's QR least squares (``ops.linalg``) and residual tests
(``stats``) against the JAX package's, on the CPU in float64.

Both packages run the same formulas in float64; the port's QR is its
own unrolled Householder and its CDFs ``torch.special``'s, the JAX
package's XLA's, so
results agree to rounding: 1e-10 relative (the gram and QR solves of
these well-conditioned designs lose a few digits at most)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spark_timeseries_tpu import stats as j_stats
from spark_timeseries_tpu.ops import linalg as j_linalg
from spark_timeseries_tpu_torch import stats
from spark_timeseries_tpu_torch.ops import linalg

torch.set_num_threads(1)
RTOL = 1e-10


def _close(got, want, rtol=RTOL, atol=0.0):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=rtol,
                               atol=atol)


def _design(seed, S=12, n=60, p=3):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(S, n, p))
    beta = rng.normal(size=(S, p))
    y = np.einsum("snp,sp->sn", X, beta) + rng.normal(size=(S, n)) * 0.5 \
        + 2.0
    return X, y


@pytest.mark.parametrize("add_intercept", [False, True])
def test_ols_matches_jax(add_intercept):
    X, y = _design(0)
    got = linalg.ols(torch.from_numpy(X), torch.from_numpy(y),
                     add_intercept=add_intercept)
    want = j_linalg.ols(jnp.asarray(X), jnp.asarray(y),
                        add_intercept=add_intercept)
    for g, w in zip(got, want):
        _close(g, w, atol=1e-12)
    _close(linalg.ols_beta(torch.from_numpy(X), torch.from_numpy(y),
                           add_intercept),
           j_linalg.ols_beta(jnp.asarray(X), jnp.asarray(y), add_intercept))
    _close(linalg.t_statistics(got), j_linalg.t_statistics(want))
    _close(linalg.r_squared(got, torch.from_numpy(y)),
           j_linalg.r_squared(want, jnp.asarray(y)))
    # one unbatched design
    one = linalg.ols(torch.from_numpy(X[0]), torch.from_numpy(y[0]),
                     add_intercept=add_intercept)
    _close(one.beta, want.beta[0])


@pytest.mark.parametrize("p", [17, 24])
def test_ols_of_wide_designs_matches_jax(p):
    """The unrolled Householder QR takes any column count: here past the
    unrolled Cholesky's 16, as ``adftest``'s lags on long series give."""
    X, y = _design(5, S=4, n=80, p=p)
    got = linalg.ols(torch.from_numpy(X), torch.from_numpy(y), True)
    want = j_linalg.ols(jnp.asarray(X), jnp.asarray(y), True)
    assert got.beta.shape == (4, p + 1)
    for g, w in zip(got, want):
        _close(g, w, atol=1e-12)
    _close(linalg.t_statistics(got), j_linalg.t_statistics(want))


@pytest.mark.parametrize("regression", ["nc", "c", "ct", "ctt"])
def test_mackinnonp_matches_jax(regression):
    # every branch: below tau_min, the small- and large-p polynomials,
    # above tau_max
    t = np.linspace(-30.0, 4.0, 341)
    got = stats.mackinnonp(torch.from_numpy(t), regression)
    # deep in the lower tail the normal CDFs round to 0 or ~1e-17 apart
    _close(got, j_stats.mackinnonp(jnp.asarray(t), regression), atol=1e-15)
    assert got[0] == 0.0 and (regression == "nc" or got[-1] == 1.0)
    _close(stats.mackinnonp(torch.tensor(-2.5, dtype=torch.float64),
                            regression, 3),
           j_stats.mackinnonp(jnp.asarray(-2.5), regression, 3))


def _walks(seed, S=10, n=90):
    rng = np.random.default_rng(seed)
    y = np.cumsum(rng.normal(size=(S, n)), axis=1)
    y[: S // 2] = rng.normal(size=(S // 2, n)) + np.arange(n) * 0.05
    return y


@pytest.mark.parametrize("regression", ["nc", "c", "ct", "ctt"])
@pytest.mark.parametrize("max_lag", [0, 3])
def test_adftest_matches_jax(regression, max_lag):
    y = _walks(1)
    got = stats.adftest(torch.from_numpy(y), max_lag, regression)
    want = j_stats.adftest(jnp.asarray(y), max_lag, regression)
    _close(got[0], want[0])
    _close(got[1], want[1], atol=1e-15)
    with pytest.raises(ValueError, match="regression"):
        stats.adftest(torch.from_numpy(y), 1, "banana")


def test_kpss_trend_matches_jax():
    y = _walks(2)
    got, crit = stats.kpsstest(torch.from_numpy(y), "ct")
    want, j_crit = j_stats.kpsstest(jnp.asarray(y), "ct")
    _close(got, want)
    assert crit == j_crit == stats.KPSS_CONSTANT_AND_TREND_CRITICAL_VALUES


def test_residual_tests_match_jax():
    rng = np.random.default_rng(3)
    S, n = 10, 80
    u = rng.normal(size=(S, n))
    u[:4, 1:] += 0.9 * u[:4, :-1]            # serially correlated lanes
    u[4:7] *= np.linspace(0.2, 3.0, n)        # heteroskedastic lanes
    X = rng.normal(size=(S, n, 2))
    ut, Xt = torch.from_numpy(u), torch.from_numpy(X)
    uj, Xj = jnp.asarray(u), jnp.asarray(X)
    _close(stats.dwtest(ut), j_stats.dwtest(uj))
    for lag in (1, 4):
        for g, w in zip(stats.lbtest(ut, lag), j_stats.lbtest(uj, lag)):
            _close(g, w, atol=1e-14)
        for g, w in zip(stats.bgtest(ut, Xt, lag),
                        j_stats.bgtest(uj, Xj, lag)):
            _close(g, w, atol=1e-14)
    for g, w in zip(stats.bptest(ut, Xt), j_stats.bptest(uj, Xj)):
        _close(g, w, atol=1e-14)
    # the correlated lanes are the ones the tests flag
    lb_p = stats.lbtest(ut, 4)[1].numpy()
    assert (lb_p[:4] < 0.05).all()
