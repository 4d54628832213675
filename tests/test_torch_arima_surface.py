"""The rest of the port's ARIMA model surface against the JAX package's,
on the CPU in float64: the model's forecast bands, AIC, gradient,
Hessian, AR(∞) form, time-dependent effects and sampling, the root and
common-factor checks, the AR model's new methods, and ``fit_panel``
(the new fits are in ``test_torch_arima_fits.py``).

Model methods run on identical coefficients (the JAX fit's, carried
across with ``models.convert``).  Where a lane's AR part is explosive or
its MA part not invertible, its recurrences blow up and the last bits of
the coefficients set the leading digits, so those comparisons keep to
stationary and invertible lanes, as ``test_torch_arima.py`` does."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spark_timeseries_tpu.models import arima as j_arima
from spark_timeseries_tpu.models import autoregression as j_ar
from spark_timeseries_tpu_torch import engine
from spark_timeseries_tpu_torch.models import arima, autoregression, convert
from spark_timeseries_tpu_torch.ops import arma_ne
from spark_timeseries_tpu_torch.panel import Panel
from spark_timeseries_tpu_torch.time import BusinessDayFrequency, uniform

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


@pytest.fixture(scope="module")
def fitted():
    """A JAX ARIMA(2,1,2) fit of 16 series and the port's model of the
    same coefficients; ``sane`` marks stationary and invertible lanes."""
    y = _arima_rows(np.random.default_rng(1), 16, 80)
    jm = j_arima.fit(2, 1, 2, jnp.asarray(y), warn=False)
    tm = convert.arima_from_numpy(2, 1, 2, np.asarray(jm.coefficients),
                                  device="cpu")
    sane = tm.is_stationary() & tm.is_invertible()
    assert sane.sum() >= 6
    return y, jm, tm, sane


def _jit(fn, *arrays):
    """The JAX package's ``fn(*arrays)`` as one compiled program (other
    arguments closed over in ``fn``), where an eager call compiles each
    operation on its own: the same arithmetic, compiled once."""
    return jax.jit(fn)(*arrays)


def _close(got, want, rtol=1e-10, atol=0.0, lanes=None):
    g = got.detach().numpy()
    w = np.asarray(want)
    if lanes is not None:
        g, w = g[lanes], w[lanes]
    np.testing.assert_allclose(g, w, rtol=rtol, atol=atol)


def test_forecast_interval_and_aic_match_jax(fitted):
    y, jm, tm, sane = fitted
    yt, yj = torch.from_numpy(y), jnp.asarray(y)
    for conf in (0.95, 0.8):
        got = tm.forecast_interval(yt, 12, conf=conf)
        want = _jit(lambda v: jm.forecast_interval(v, 12, conf=conf), yj)
        for g, w in zip(got, want):
            _close(g, w, rtol=1e-10, lanes=sane)
        assert got[1].shape == (16, 12)
    # d = 0 and one series, unbatched
    m0 = convert.arima_from_numpy(1, 0, 1, np.array([0.2, 0.5, 0.3]),
                                  device="cpu")
    j0 = j_arima.ARIMAModel(1, 0, 1, jnp.asarray([0.2, 0.5, 0.3]))
    for g, w in zip(m0.forecast_interval(yt[0], 5),
                    _jit(lambda v: j0.forecast_interval(v, 5), yj[0])):
        _close(g, w)
    with pytest.raises(ValueError, match="n_future"):
        tm.forecast_interval(yt, 0)
    _close(tm.approx_aic(yt), _jit(jm.approx_aic, yj), lanes=sane)


def test_gradient_hessian_and_ar_inf_match_jax(fitted):
    y, jm, tm, sane = fitted
    d = np.diff(y, axis=1)
    # off the optimum, where the gradient is not ~0
    coefs = np.asarray(jm.coefficients) * np.array([1.0, 0.9, 0.9, 0.7,
                                                    0.7])
    tp = convert.arima_from_numpy(2, 1, 2, coefs, device="cpu")
    jp = j_arima.ARIMAModel(2, 1, 2, jnp.asarray(coefs))
    ok = tp.is_stationary() & tp.is_invertible()
    got = tp.gradient_log_likelihood_css_arma(torch.from_numpy(d))
    want = _jit(jp.gradient_log_likelihood_css_arma, jnp.asarray(d))
    # (n / css) Jᵀr against autodiff of the whole expression
    _close(got, want, rtol=1e-9, atol=1e-9, lanes=ok)
    _close(tm.coefficient_precision(torch.from_numpy(y)),
           _jit(jm.coefficient_precision, jnp.asarray(y)), rtol=1e-9,
           lanes=sane)
    _close(tm.coefficient_precision(torch.from_numpy(d),
                                    assume_differenced=True),
           _jit(lambda v: jm.coefficient_precision(
               v, assume_differenced=True), jnp.asarray(d)),
           rtol=1e-9, lanes=sane)
    for g, w in zip(tm.ar_inf_coefficients(20),
                    _jit(lambda: jm.ar_inf_coefficients(20))):
        _close(g, w, rtol=1e-12, atol=1e-14)
    for g, w in zip(arima.ar_truncation(
            0.5, torch.tensor([0.3], dtype=torch.float64),
            torch.tensor([0.2, -0.1], dtype=torch.float64), 3),
            j_arima.ar_truncation(0.5, jnp.asarray([0.3]),
                                  jnp.asarray([0.2, -0.1]), 3)):
        _close(g, w, rtol=1e-12)
    with pytest.raises(ValueError, match="n_terms"):
        arima.ar_truncation(0.0, torch.zeros(1), torch.zeros(1), 0)


def test_css_value_and_grad_matches_jax_autodiff():
    rng = np.random.default_rng(4)
    S, n = 12, 60
    y = _arima_rows(rng, S, n, d=0)
    x = rng.normal(scale=0.2, size=(S, 5)) + [1.0, 0.2, 0.2, 0.2, 0.1]
    nv = rng.integers(30, n + 1, size=S)

    def neg_ll(prm, yy, v):
        return -j_arima._log_likelihood_css_arma(prm, yy, 2, 2, 1,
                                                 n_valid=v)

    f_j, g_j = jax.jit(jax.vmap(jax.value_and_grad(neg_ll)))(
        jnp.asarray(x), jnp.asarray(y), jnp.asarray(nv))
    f, g = arma_ne.css_neg_ll_value_and_grad(
        torch.from_numpy(x), torch.from_numpy(y), 2, 2, 1,
        n_valid=torch.from_numpy(nv))
    _close(f, f_j, rtol=1e-12)
    _close(g, g_j, rtol=1e-9, atol=1e-10)
    f0, _ = arma_ne.css_neg_ll_value_and_grad_plain(
        torch.from_numpy(x), torch.from_numpy(y), 2, 2, 1)
    _close(f0, jax.jit(jax.vmap(lambda a, b: neg_ll(a, b, None)))(
        jnp.asarray(x), jnp.asarray(y)), rtol=1e-12)


def test_time_dependent_effects_and_sample_match_jax(fitted):
    y, jm, tm, sane = fitted
    r = tm.remove_time_dependent_effects(torch.from_numpy(y))
    r_j = _jit(jm.remove_time_dependent_effects, jnp.asarray(y))
    _close(r, r_j, rtol=1e-10, atol=1e-10, lanes=sane)
    # add on shared noise: the same draws through both processes
    noise = np.random.default_rng(9).normal(size=(16, 50))
    _close(tm.add_time_dependent_effects(torch.from_numpy(noise)),
           _jit(jm.add_time_dependent_effects, jnp.asarray(noise)),
           rtol=1e-10, atol=1e-10, lanes=sane)
    # the round trip: add undoes remove on every sane lane
    _close(tm.add_time_dependent_effects(r), y, rtol=1e-9, atol=1e-9,
           lanes=sane)
    # sample = add on the generator's draws
    s = tm.sample(30, torch.Generator().manual_seed(3), shape=(16,))
    want = tm.add_time_dependent_effects(torch.randn(
        (16, 30), generator=torch.Generator().manual_seed(3),
        dtype=torch.float64))
    assert s.shape == (16, 30) and torch.equal(s, want)
    # pure AR and pure MA orders
    for p, q in ((2, 0), (0, 2)):
        c = np.array([0.5, 0.3, 0.2])
        mt = convert.arima_from_numpy(p, 0, q, c, device="cpu")
        mj = j_arima.ARIMAModel(p, 0, q, jnp.asarray(c))
        _close(mt.add_time_dependent_effects(torch.from_numpy(noise[0])),
               _jit(mj.add_time_dependent_effects, jnp.asarray(noise[0])))
        _close(mt.remove_time_dependent_effects(torch.from_numpy(y[0])),
               _jit(mj.remove_time_dependent_effects, jnp.asarray(y[0])),
               rtol=1e-10, atol=1e-9)


def test_roots_and_cancellation_match_jax(fitted):
    _, jm, tm, _ = fitted
    c = [1.0, -0.5, 0.06]
    np.testing.assert_allclose(np.sort_complex(arima.find_roots(c)),
                               np.sort_complex(j_arima.find_roots(c)))
    np.testing.assert_array_equal(arima._cancellation_suspects(tm),
                                  j_arima._cancellation_suspects(jm))
    coefs = np.asarray(jm.coefficients).copy()
    # AR roots 2 and 5, MA roots 2.22 and -3.33: a near-common factor
    coefs[0, 1:] = [0.7, -0.1, -0.15, -0.135]
    both = convert.arima_from_numpy(2, 1, 2, coefs, device="cpu")
    got = arima._cancellation_suspects(both)
    assert got[0]
    np.testing.assert_array_equal(
        got, j_arima._cancellation_suspects(
            j_arima.ARIMAModel(2, 1, 2, jnp.asarray(coefs))))
    ar = convert.arima_from_numpy(1, 1, 0, coefs[:, :2], device="cpu")
    padded = arima._pad_to_order(ar, 2, 2)
    assert padded.coefficients.shape == (16, 5)
    assert torch.equal(padded.coefficients[:, :2], ar.coefficients)
    assert (padded.coefficients[:, 2:] == 0).all()


def test_ar_model_surface_matches_jax():
    rng = np.random.default_rng(8)
    y = _arima_rows(rng, 6, 50, d=0)
    tm = autoregression.fit(torch.from_numpy(y), 2)
    jm = j_ar.fit(jnp.asarray(y), 2)
    _close(tm.remove_time_dependent_effects(y),
           _jit(jm.remove_time_dependent_effects, jnp.asarray(y)))
    noise = rng.normal(size=(6, 30))
    _close(tm.add_time_dependent_effects(noise),
           _jit(jm.add_time_dependent_effects, jnp.asarray(noise)))
    s = tm.sample(20, torch.Generator().manual_seed(1), shape=(6,))
    assert s.shape == (6, 20)
    index = uniform("2020-01-06T00:00Z", 50, BusinessDayFrequency(1))
    tp = Panel(index, y, [f"k{i}" for i in range(6)], device="cpu")
    assert torch.equal(autoregression.fit_panel(tp, 2).coefficients,
                       tm.coefficients)


def test_arima_fit_panel_routes_like_fit():
    y = _arima_rows(np.random.default_rng(10), 8, 50)
    index = uniform("2020-01-06T00:00Z", 50, BusinessDayFrequency(1))
    tp = Panel(index, y, [f"k{i}" for i in range(8)], device="cpu")
    direct = arima.fit(2, 1, 2, y, warn=False, device="cpu", max_iter=10)
    for eng in (None, False, engine.FitEngine()):
        m = arima.fit_panel(tp, 2, 1, 2, engine=eng, warn=False,
                            max_iter=10)
        assert torch.equal(m.coefficients, direct.coefficients)
