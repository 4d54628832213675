"""The port's ARIMAX (``models.arimax``) against the JAX package's, on the
CPU in float64: the ARX + Hannan-Rissanen initialization, the css-lm,
css-cgd and css-bobyqa refines of the ARMA slice on the xreg-adjusted
series, ``retry=`` (the JAX package's restart draws handed in), the
direct solve at p = q = 0, the model's methods, and the fail-soft chain
through the engine and the Panel.

Coefficients agree within 1e-6 on lanes whose AR part is stationary and
MA part invertible (elsewhere the last bits of a coefficient set the
leading digits of the residuals, as the ARIMA parity tests note); the
css-cgd reference is jax's BFGS with the two line-search lines the port
changes (``torch_jax_line_search``)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spark_timeseries_tpu.models import arimax as j_arimax
from spark_timeseries_tpu_torch import Panel, engine
from spark_timeseries_tpu_torch.models import arima, arimax, convert
from spark_timeseries_tpu_torch.ops.univariate import differences_of_order_d
from spark_timeseries_tpu_torch.time import BusinessDayFrequency, uniform
from spark_timeseries_tpu_torch.utils import resilience
from torch_jax_line_search import without_line_search_faults

torch.set_num_threads(1)

S, N, K = 12, 96, 2


def _data(seed=0):
    """Stationary ARMA(2,2) rows plus two shared random-walk regressors.
    The fits are ARIMAX(2,0,2): the ARX initialization regresses the raw
    series on its own lags, so on an integrated series it starts the
    ARMA refine near a unit root and most lanes end explosive, where
    float64 rounding decides the last iterations (the model-method test
    below runs the d = 1 arithmetic on a cumulated panel)."""
    rng = np.random.default_rng(seed)
    x = np.cumsum(rng.normal(size=(N, K)), axis=0)
    e = rng.normal(size=(S, N + 16))
    y = np.zeros_like(e)
    for t in range(2, e.shape[1]):
        y[:, t] = 0.5 + 0.25 * y[:, t - 1] + 0.35 * y[:, t - 2] + e[:, t] \
            + 0.3 * e[:, t - 1] + 0.1 * e[:, t - 2]
    return y[:, 16:] + x @ [0.8, -0.5], x


def _jax_draws(seed, lanes, k, restarts):
    keys = jax.random.split(jax.random.PRNGKey(seed), lanes)
    return np.stack([np.asarray(jax.vmap(
        lambda kk, a=a: jax.random.normal(jax.random.fold_in(kk, a), (k,),
                                          jnp.float64))(keys))
        for a in range(1, restarts + 1)])


@pytest.fixture(scope="module")
def fits():
    """The JAX package's fits, once per module."""
    y, x = _data()
    jy, jx = jnp.asarray(y), jnp.asarray(x)
    bad = y.copy()
    bad[0] = np.nan
    bad[3, 40] = np.inf
    bad[4, :N - 6] = np.nan
    out = {"y": y, "x": x, "bad": bad,
           "lm": j_arimax.fit(2, 0, 2, jy, jx, 1),
           "bobyqa": j_arimax.fit(2, 0, 2, jy, jx, 1, method="css-bobyqa",
                                  max_iter=20),
           "direct": j_arimax.fit(0, 1, 0, jy, jx, 2,
                                  include_intercept=False),
           "resilient": j_arimax.fit_resilient(jnp.asarray(bad), jx, 2, 0,
                                               2, 1, max_iter=20)}
    with without_line_search_faults():
        out["cgd"] = j_arimax.fit(2, 0, 2, jy, jx, 1, method="css-cgd")
    return out


def _sane(model):
    """Lanes with a stationary AR and an invertible MA part (either
    package's model)."""
    coefs = torch.as_tensor(np.asarray(model.coefficients))
    m = arima.ARIMAModel(model.p, model.d, model.q,
                         coefs[..., :1 + model.p + model.q])
    return m.is_stationary() & m.is_invertible()


def _close(got, want, rtol=1e-6, atol=1e-9, lanes=None):
    g = got.detach().numpy()
    w = np.asarray(want)
    if lanes is not None:
        g, w = g[lanes], w[lanes]
    np.testing.assert_allclose(g, w, rtol=rtol, atol=atol)


@pytest.mark.parametrize("case", ["lm", "cgd", "bobyqa", "direct"])
def test_fit_matches_jax(fits, case):
    """Each method against the JAX package's; ``retry=`` is held by the
    resilient chain's first stage below (its attempts)."""
    y, x = fits["y"], fits["x"]
    kw = {"lm": {}, "cgd": {"method": "css-cgd"},
          "bobyqa": {"method": "css-bobyqa", "max_iter": 20},
          "direct": {}}[case]
    order = (0, 1, 0, 2, False) if case == "direct" else (2, 0, 2, 1, True)
    p, d, q, lag, icpt = order
    st = {}
    got = arimax.fit(p, d, q, y, x, lag, include_intercept=icpt,
                     device="cpu", stats=st, **kw)
    want = fits[case]
    assert got.coefficients.shape == tuple(np.asarray(
        want.coefficients).shape)
    sane = _sane(got) & _sane(want)
    assert sane.sum() >= S // 2
    np.testing.assert_array_equal(got.diagnostics.converged.numpy()[sane],
                                  np.asarray(want.diagnostics.converged)[sane])
    if case == "bobyqa":
        # 20 projected-gradient steps, not converged: where an Armijo
        # test is a tie to rounding (the port's analytic gradient and
        # jax's autodiff one differ by ~1e-12) the two paths take
        # different steps, ~1e-6 apart after 20 of them; the objective
        # is flat there
        diff = np.abs(got.coefficients.numpy()
                      - np.asarray(want.coefficients)).max(axis=-1)
        assert (diff[sane] <= 1e-6).mean() >= 0.75
        _close(got.diagnostics.fun, want.diagnostics.fun, rtol=1e-6,
               lanes=sane)
    else:
        # BFGS lanes agree as arima's css-cgd parity test holds them
        _close(got.coefficients, want.coefficients, lanes=sane,
               **({"rtol": 0, "atol": 1e-7} if case == "cgd" else {}))
        _close(got.diagnostics.fun, want.diagnostics.fun, rtol=1e-8,
               lanes=sane)
    if case in ("lm", "bobyqa"):
        np.testing.assert_array_equal(got.diagnostics.n_iter.numpy()[sane],
                                      np.asarray(want.diagnostics.n_iter)
                                      [sane])
    if case == "lm":
        assert st["lm_fit_launches"] == 0          # the CPU runs no kernel
    if case == "direct":
        assert not got.coefficients[..., 0].any()   # the kept c slot


def test_model_methods_match_jax(fits):
    """Forecasts, bands, CSS likelihood and gradient, effects and the
    exogenous contribution from the JAX package's coefficients carried
    across."""
    fitted = fits["lm"]
    want = fitted._replace(d=1)             # the d = 1 arithmetic
    m = convert.arimax_from_numpy(2, 1, 2, 1,
                                  np.asarray(fitted.coefficients),
                                  device="cpu")
    one = want._replace(coefficients=want.coefficients[0])
    y, x = np.cumsum(fits["y"], axis=1), fits["x"]
    jy, jx = jnp.asarray(y), jnp.asarray(x)
    # an explosive or non-invertible lane's recursions grow to ~1e13, so
    # its last digits are rounding: the sane lanes are compared
    sane = _sane(want)
    assert sane.sum() >= S // 2
    # each JAX method as one compiled program (jax.jit): the same
    # arithmetic, compiled once instead of an operation at a time
    _close(m.forecast(y, x), jax.jit(want.forecast)(jy, jx), rtol=1e-10,
           lanes=sane)
    for g, w in zip(m.forecast_interval(y, x),
                    jax.jit(want.forecast_interval)(jy, jx)):
        np.testing.assert_allclose(g.numpy()[sane], np.asarray(w)[sane],
                                   rtol=1e-10)
    diffed = differences_of_order_d(torch.from_numpy(y), 1)[..., 1:]
    assert torch.allclose(diffed, torch.from_numpy(fits["y"][:, 1:]))
    jd = jnp.asarray(diffed.numpy())
    _close(m.log_likelihood_css_arma(diffed),
           jax.jit(want.log_likelihood_css_arma)(jd), rtol=1e-10,
           lanes=sane)
    g = m.gradient_log_likelihood_css_arma(diffed)
    _close(g, jax.jit(want.gradient_log_likelihood_css_arma)(jd), rtol=1e-6,
           atol=1e-8, lanes=sane)
    assert not g[..., 5:].any()
    # the JAX package's contribution takes one lane's coefficients
    _close(m.xreg_contribution(x)[0], one.xreg_contribution(jx),
           rtol=1e-12)
    _close(m.remove_time_dependent_effects(y),
           jax.jit(want.remove_time_dependent_effects)(jy), rtol=1e-9,
           atol=1e-9,
           lanes=sane)
    noise = np.random.default_rng(2).normal(size=(S, N))
    _close(m.add_time_dependent_effects(noise),
           jax.jit(want.add_time_dependent_effects)(jnp.asarray(noise)),
           rtol=1e-9,
           atol=1e-9, lanes=sane)
    with pytest.raises(ValueError, match="xreg must be"):
        arimax.fit(2, 1, 2, y, x[:-1], 1, device="cpu")


def test_fit_resilient_matches_jax_through_engine_and_panel(fits):
    """css-lm with retry -> css-bobyqa -> xreg only, at 20 iterations a
    stage: health codes are the JAX package's; statuses, attempts and
    fallback indices too (its restart draws handed in) on the skipped
    lanes and on those that end stationary and invertible in both.  A
    lane that ends with a non-invertible MA part has residuals of ~1e11
    whose leading digits are rounding, and whether such a lane passes
    the LM's exit test by the cap is too.  The engine's padded bucket
    and the Panel give the direct chain's lanes bit for bit."""
    x = fits["x"]
    draws = _jax_draws(0, S, 5, 2)
    st = {}
    model, out = arimax.fit_resilient(fits["bad"], x, 2, 0, 2, 1,
                                      device="cpu", stats=st, max_iter=20,
                                      _restart_draws=draws)
    jm, jo = fits["resilient"]
    np.testing.assert_array_equal(out.health, np.asarray(jo.health))
    skipped = out.status == resilience.STATUS_SKIPPED
    sane = _sane(model) & _sane(jm) & ~skipped
    assert sane.sum() >= S // 2
    held = sane | skipped
    for f in ("status", "attempts", "fallback_used"):
        np.testing.assert_array_equal(getattr(out, f)[held],
                                      np.asarray(getattr(jo, f))[held], f)
    _close(model.coefficients, jm.coefficients, lanes=sane)
    assert out.counts()["skipped"] == 3
    assert out.attempts.max() > 1                  # the retry restarted
    assert st["lm_fit_launches"] == 0 and "css-lm" in \
        st["lm_fit_launches_by_stage"]
    # two skipped rows beside three healthy ones, padded to a bucket of 8
    rows = fits["bad"][[0, 3, 6, 10, 11]]
    via, v_out = engine.FitEngine().fit_resilient(
        rows, "arimax", x, 2, 0, 2, 1, device="cpu", max_iter=20)
    direct, d_out = arimax.fit_resilient(rows, x, 2, 0, 2, 1, device="cpu",
                                         max_iter=20)
    np.testing.assert_array_equal(v_out.status, d_out.status)
    assert torch.equal(via.coefficients.nan_to_num(7.0),
                       direct.coefficients.nan_to_num(7.0))
    panel = Panel(uniform("2020-01-06T00:00Z", N, BusinessDayFrequency(1)),
                  rows, [f"s{i}" for i in range(5)], device="cpu")
    pm, p_out = panel.fit_resilient("arimax", x, 2, 0, 2, 1, max_iter=20)
    np.testing.assert_array_equal(p_out.status, d_out.status)
    assert torch.equal(pm.coefficients.nan_to_num(7.0),
                       via.coefficients.nan_to_num(7.0))
    padded = arimax._pad_to_order(arimax.fit(0, 1, 0, fits["y"][:3], x, 1,
                                             device="cpu"), 2, 2)
    assert padded.coefficients.shape == (3, 1 + 2 + 2 + 2 * 2)
    with pytest.raises(ValueError, match="shared unbatched"):
        arimax.fit_resilient(fits["bad"], np.stack([x] * S), 2, 0, 2, 1,
                             device="cpu")
