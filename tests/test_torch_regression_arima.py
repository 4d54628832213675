"""The port's regression with AR(1) errors (``models.regression_arima``:
Cochrane-Orcutt) against the JAX package's, on the CPU in float64.

The JAX package runs the iteration as one ``lax.while_loop``, the port
as a host loop of the same rounds; per lane the stopping decisions
(Durbin-Watson outside 2 ± 0.05, ρ moved at most 0.001 after the first
round, the cap) are equal and coefficients agree within 1e-6 (two QR
least squares each round, in other orders).  The panel mixes AR(1)
errors at ρ = 0, 0.6 and 0.95 so that lanes stop at different rounds,
or never."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spark_timeseries_tpu.models import regression_arima as j_ra
from spark_timeseries_tpu_torch import Panel, engine
from spark_timeseries_tpu_torch.models import convert, regression_arima
from spark_timeseries_tpu_torch.time import BusinessDayFrequency, uniform

torch.set_num_threads(1)

S, N, K = 16, 120, 2


def _data(seed=0):
    """k = 2 shared random-walk regressors, β ~ N(0, 1), an intercept,
    and AR(1) errors at ρ = 0, 0.6 or 0.95 per lane."""
    rng = np.random.default_rng(seed)
    X = np.cumsum(rng.normal(size=(N, K)), axis=0)
    beta = rng.normal(size=(S, K))
    rho = np.array([0.0, 0.6, 0.95, 0.6] * (S // 4))
    e = np.zeros((S, N))
    w = rng.normal(size=(S, N))
    for t in range(1, N):
        e[:, t] = rho * e[:, t - 1] + w[:, t]
    return 1.5 + beta @ X.T + e, X


@pytest.fixture(scope="module")
def fits():
    y, X = _data()
    bad = y.copy()
    bad[0] = np.nan
    bad[5] = 3.0
    bad[6, 30] = np.inf
    bad[9, :N - 4] = np.nan
    return {
        "y": y, "X": X, "bad": bad,
        "co": j_ra.fit_cochrane_orcutt(jnp.asarray(y), jnp.asarray(X)),
        "co_cap": j_ra.fit_cochrane_orcutt(jnp.asarray(y), jnp.asarray(X),
                                           2),
        "resilient": j_ra.fit_resilient(jnp.asarray(bad), jnp.asarray(X)),
    }


def _close(got, want, rtol=1e-6, atol=1e-9):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=rtol, atol=atol)


@pytest.mark.parametrize("case,max_iter", [("co", 10), ("co_cap", 2)])
def test_cochrane_orcutt_matches_jax(fits, case, max_iter):
    st = {}
    got = regression_arima.fit_cochrane_orcutt(fits["y"], fits["X"],
                                               max_iter, device="cpu",
                                               stats=st)
    want = fits[case]
    np.testing.assert_array_equal(got.diagnostics.converged.numpy(),
                                  np.asarray(want.diagnostics.converged))
    np.testing.assert_array_equal(got.diagnostics.n_iter.numpy(),
                                  np.asarray(want.diagnostics.n_iter))
    _close(got.regression_coeff, want.regression_coeff)
    _close(got.arima_coeff, want.arima_coeff)
    _close(got.diagnostics.fun, want.diagnostics.fun)
    assert got.arima_orders == (1, 0, 0)
    n_iter = got.diagnostics.n_iter.numpy()
    assert st["co_rounds"] == n_iter.max() <= max_iter
    if case == "co":
        # lanes stop at different rounds
        assert len(set(n_iter.tolist())) >= 3
    # fit() dispatch and fit_panel reach the same loop
    via = regression_arima.fit(fits["y"], fits["X"], "cochrane-orcutt",
                               max_iter, device="cpu")
    assert torch.equal(via.regression_coeff, got.regression_coeff)
    panel = Panel(uniform("2020-01-06T00:00Z", N, BusinessDayFrequency(1)),
                  fits["y"], [f"s{i}" for i in range(S)], device="cpu")
    assert torch.equal(regression_arima.fit_panel(panel, fits["X"],
                                                  max_iter).arima_coeff,
                       got.arima_coeff)


def test_forecast_and_interval_match_jax(fits):
    want = fits["co"]
    m = convert.regression_arima_from_numpy(
        np.asarray(want.regression_coeff), np.asarray(want.arima_coeff),
        device="cpu")
    Xf = fits["X"][-6:] + 1.0
    _close(m.forecast(fits["y"], fits["X"], Xf),
           want.forecast(jnp.asarray(fits["y"]), jnp.asarray(fits["X"]),
                         jnp.asarray(Xf)), rtol=1e-12)
    for g, w in zip(m.forecast_interval(fits["y"], fits["X"], Xf, 0.9),
                    want.forecast_interval(jnp.asarray(fits["y"]),
                                           jnp.asarray(fits["X"]),
                                           jnp.asarray(Xf), 0.9)):
        _close(g, w, rtol=1e-12)
    with pytest.raises(NotImplementedError):
        m.add_time_dependent_effects(fits["y"])
    with pytest.raises(NotImplementedError, match="not defined"):
        regression_arima.fit(fits["y"], fits["X"], "ols", device="cpu")
    with pytest.raises(ValueError, match="integer"):
        regression_arima.fit(fits["y"], fits["X"], "cochrane-orcutt", 2.5,
                             device="cpu")
    with pytest.raises(ValueError, match="rows"):
        regression_arima.fit_cochrane_orcutt(fits["y"], fits["X"][:-1],
                                             device="cpu")


def test_fit_resilient_matches_jax_through_engine_and_panel(fits):
    """Cochrane-Orcutt -> plain OLS with ρ = 0: statuses, attempts, fallback
    indices and health codes are the JAX package's; the engine's padded
    bucket and the Panel give the direct chain's lanes bit for bit.

    On the constant row (row 5) the first OLS fits exactly and its
    residuals are rounding: the port's Householder leaves them 0, so the
    Durbin-Watson statistic is NaN and the lane stops at once (c = 3, β
    = 0, ρ = 0); LAPACK's leave ~1e-15, the JAX package iterates on
    that noise and ends at ρ = 1 and a NaN intercept, also reported
    converged.  Its parameters are compared on the other rows."""
    model, out = regression_arima.fit_resilient(fits["bad"], fits["X"],
                                                device="cpu")
    jm, jo = fits["resilient"]
    for f in ("status", "attempts", "fallback_used", "health"):
        np.testing.assert_array_equal(getattr(out, f),
                                      np.asarray(getattr(jo, f)), f)
    rest = np.arange(S) != 5
    np.testing.assert_array_equal(np.isnan(out.params[rest]),
                                  np.isnan(np.asarray(jo.params)[rest]))
    np.testing.assert_allclose(out.params[rest], np.asarray(jo.params)[rest],
                               rtol=1e-6, atol=1e-9)
    np.testing.assert_array_equal(out.params[5], [3.0, 0.0, 0.0, 0.0])
    assert out.counts()["skipped"] == 3
    via, v_out = engine.FitEngine().fit_resilient(
        fits["bad"][:12], "regression_arima", fits["X"], device="cpu")
    direct, d_out = regression_arima.fit_resilient(fits["bad"][:12],
                                                   fits["X"], device="cpu")
    np.testing.assert_array_equal(v_out.status, d_out.status)
    assert torch.equal(via.regression_coeff.nan_to_num(7.0),
                       direct.regression_coeff.nan_to_num(7.0))
    panel = Panel(uniform("2020-01-06T00:00Z", N, BusinessDayFrequency(1)),
                  fits["bad"], [f"s{i}" for i in range(S)], device="cpu")
    pm, p_out = panel.fit_resilient("regression_arima", fits["X"])
    np.testing.assert_array_equal(p_out.status, out.status)
    assert torch.equal(pm.arima_coeff.nan_to_num(7.0),
                       model.arima_coeff.nan_to_num(7.0))
    with pytest.raises(ValueError, match="shared unbatched"):
        regression_arima.fit_resilient(fits["bad"],
                                       np.stack([fits["X"]] * S),
                                       device="cpu")
