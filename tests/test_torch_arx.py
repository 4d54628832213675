"""The port's ARX (``models.autoregression_x``) and ``ops.lag.
lag_matrix_multi`` against the JAX package's, on the CPU in float64.

Both solve the same least squares by QR (the port by its Householder
reflections, the JAX package by LAPACK's), so coefficients agree to
rounding: within 1e-6, as the ARIMA parity tests hold theirs; the
resilient chain's statuses, attempts and health codes are equal (but on
a rank-deficient row, whose pivot is rounding; see its test)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spark_timeseries_tpu.models import autoregression_x as j_arx
from spark_timeseries_tpu.ops import lag as j_lag
from spark_timeseries_tpu_torch import Panel, engine
from spark_timeseries_tpu_torch.models import autoregression_x, convert
from spark_timeseries_tpu_torch.ops import lag
from spark_timeseries_tpu_torch.time import BusinessDayFrequency, uniform

torch.set_num_threads(1)

S, N, K = 12, 80, 2


def _data(seed=0):
    rng = np.random.default_rng(seed)
    x = np.cumsum(rng.normal(size=(N, K)), axis=0)
    y = np.zeros((S, N))
    e = rng.normal(size=(S, N))
    for t in range(2, N):
        y[:, t] = 0.4 * y[:, t - 1] - 0.2 * y[:, t - 2] + 0.5 * x[t] @ [
            1.0, -0.6] + 0.3 * x[t - 1, 0] + e[:, t]
    return y, x


@pytest.fixture(scope="module")
def fits():
    """The JAX package's fits, once per module."""
    y, x = _data()
    xb = np.stack([x + 0.1 * k for k in range(S)])       # per-series design
    bad = y.copy()
    bad[0] = np.nan
    bad[1] = 2.0
    bad[2, :N - 5] = np.nan
    return {
        "y": y, "x": x, "xb": xb, "bad": bad,
        "plain": j_arx.fit(jnp.asarray(y), jnp.asarray(x), 2, 1),
        "no_icpt": j_arx.fit(jnp.asarray(y), jnp.asarray(x), 3, 2,
                             include_original_x=False, no_intercept=True),
        "batched_x": j_arx.fit(jnp.asarray(y), jnp.asarray(xb), 1, 1),
        "resilient": j_arx.fit_resilient(jnp.asarray(bad), jnp.asarray(x),
                                         2, 1),
    }


def _close(got, want, rtol=1e-6, atol=1e-9):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=rtol, atol=atol)


def test_lag_matrix_multi_matches_jax():
    x = np.random.default_rng(1).normal(size=(3, 20, 2))
    for ml, orig in ((1, False), (3, True)):
        _close(lag.lag_matrix_multi(torch.from_numpy(x), ml, orig),
               j_lag.lag_matrix_multi(jnp.asarray(x), ml, orig), rtol=0,
               atol=0)


@pytest.mark.parametrize("case,args", [
    ("plain", (2, 1, True, False)),
    ("no_icpt", (3, 2, False, True)),
    ("batched_x", (1, 1, True, False))])
def test_fit_and_predict_match_jax(fits, case, args):
    ylag, xlag, orig, no_icpt = args
    x = fits["xb"] if case == "batched_x" else fits["x"]
    got = autoregression_x.fit(fits["y"], x, ylag, xlag, orig, no_icpt,
                               device="cpu")
    want = fits[case]
    _close(got.c, want.c)
    _close(got.coefficients, want.coefficients)
    assert (got.y_max_lag, got.x_max_lag, got.includes_original_x) \
        == (want.y_max_lag, want.x_max_lag, want.includes_original_x)
    np.testing.assert_array_equal(got.diagnostics.converged.numpy(),
                                  np.asarray(want.diagnostics.converged))
    # predictions from the JAX package's coefficients carried across
    carried = convert.arx_from_numpy(np.asarray(want.c),
                                     np.asarray(want.coefficients), ylag,
                                     xlag, orig, device="cpu")
    _close(carried.predict(fits["y"], x),
           want.predict(jnp.asarray(fits["y"]), jnp.asarray(x)), rtol=1e-12)
    _close(autoregression_x.assemble_predictors(
        torch.from_numpy(fits["y"]), torch.from_numpy(x), ylag, xlag, orig),
        j_arx.assemble_predictors(jnp.asarray(fits["y"]), jnp.asarray(x),
                                  ylag, xlag, orig), rtol=0, atol=0)


def test_fit_resilient_matches_jax_through_engine_and_panel(fits):
    """OLS -> mean: the unfittable rows are skipped; the engine's padded
    bucket and the Panel give the direct chain's lanes bit for bit.

    The constant row (row 1) makes the design rank-deficient: its y lags
    are the intercept column.  LAPACK's QR leaves a 1e-14 pivot there and
    the JAX package's OLS a finite 4e14 coefficient (status OK); the
    port's Householder reflections leave an exact zero pivot, the OLS
    goes non-finite and the lane falls back to the mean model (``c`` the
    row's value, every other coefficient 0).  Every other row, and the
    health codes of all, are the JAX package's."""
    model, out = autoregression_x.fit_resilient(fits["bad"], fits["x"], 2,
                                                1, device="cpu")
    jm, jo = fits["resilient"]
    np.testing.assert_array_equal(out.health, np.asarray(jo.health))
    rest = np.arange(S) != 1
    for f in ("status", "attempts", "fallback_used"):
        np.testing.assert_array_equal(getattr(out, f)[rest],
                                      np.asarray(getattr(jo, f))[rest], f)
    np.testing.assert_array_equal(np.isnan(out.params[rest]),
                                  np.isnan(np.asarray(jo.params)[rest]))
    np.testing.assert_allclose(out.params[rest], np.asarray(jo.params)[rest],
                               rtol=1e-6, atol=1e-9)
    assert out.status[1] == 2 and float(model.c[1]) == 2.0
    assert not model.coefficients[1].any()
    assert out.counts()["skipped"] == 2
    via, v_out = engine.FitEngine().fit_resilient(fits["bad"], "arx",
                                                  fits["x"], 2, 1,
                                                  device="cpu")
    np.testing.assert_array_equal(v_out.status, out.status)
    assert torch.equal(via.coefficients.nan_to_num(7.0),
                       model.coefficients.nan_to_num(7.0))
    panel = Panel(uniform("2020-01-06T00:00Z", N, BusinessDayFrequency(1)),
                  fits["bad"], [f"s{i}" for i in range(S)], device="cpu")
    pm, p_out = panel.fit_resilient("arx", fits["x"], 2, 1)
    np.testing.assert_array_equal(p_out.status, out.status)
    assert torch.equal(pm.c.nan_to_num(7.0), model.c.nan_to_num(7.0))
    with pytest.raises(ValueError, match="shared unbatched"):
        autoregression_x.fit_resilient(fits["bad"], fits["xb"], 2, 1,
                                       device="cpu")
