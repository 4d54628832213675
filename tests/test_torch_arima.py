"""The port's ARIMA fit against the JAX package's, on the CPU.

Panels come from numpy and go to both packages at float64 (JAX runs with
x64, ``tests/conftest.py``; the port with ``device="cpu"``).  On the CPU
the JAX fit takes its XLA LM route and the port its plain normal
equations, so the two run the same LM state machine at float64.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spark_timeseries_tpu.models import arima as jarima
from spark_timeseries_tpu_torch import _device
from spark_timeseries_tpu_torch.models import arima, convert

torch.set_num_threads(1)


def _arima_panel(rng, S, n, d=1):
    """ARIMA(2,d,2) draws with an intercept."""
    e = rng.normal(size=(S, n + 16))
    y = np.zeros_like(e)
    for t in range(2, e.shape[1]):
        y[:, t] = 1.0 + 0.25 * y[:, t - 1] + 0.35 * y[:, t - 2] + e[:, t] \
            + 0.3 * e[:, t - 1] + 0.1 * e[:, t - 2]
    y = y[:, 16:]
    for _ in range(d):
        y = np.cumsum(y, axis=1)
    return y


def _ragged(rng, y):
    """NaN-pad lanes at both ends, with a few lanes too short to fit."""
    y = y.copy()
    S, n = y.shape
    lead = rng.integers(0, 12, size=S)
    trail = rng.integers(0, 20, size=S)
    for i in range(S):
        y[i, :lead[i]] = np.nan
        if trail[i]:
            y[i, n - trail[i]:] = np.nan
    y[3, 8:] = np.nan            # 8 observations: too short for ARIMA(2,1,2)
    y[7, :] = np.nan             # nothing observed
    return y


def _assert_fits_agree(got, want, coef_atol=1e-7):
    conv = got.diagnostics.converged.numpy()
    j_conv = np.asarray(want.diagnostics.converged)
    # the same float64 state machine: identical accept/reject decisions
    np.testing.assert_array_equal(conv, j_conv)
    np.testing.assert_array_equal(got.diagnostics.n_iter.numpy(),
                                  np.asarray(want.diagnostics.n_iter))
    # NaN (quarantined) lanes in the same places; coefficients to 1e-7
    # (float64 sums in another order, amplified along the flat CSS ridge)
    np.testing.assert_allclose(got.coefficients.numpy(),
                               np.asarray(want.coefficients), rtol=0,
                               atol=coef_atol)
    # fun where the MA part is invertible: past it the residual recurrence
    # explodes (SSEs of 1e100+, which the pinned exit may still call
    # converged) and the last bits of x move the SSE by orders of magnitude
    sane = got.is_invertible() & np.isfinite(got.coefficients.numpy()).all(-1)
    assert sane.mean() > 0.3
    np.testing.assert_allclose(got.diagnostics.fun.numpy()[sane],
                               np.asarray(want.diagnostics.fun)[sane],
                               rtol=1e-9)


@pytest.mark.parametrize("include_intercept", [True, False])
def test_fit_dense_matches_jax(include_intercept):
    rng = np.random.default_rng(0)
    y = _arima_panel(rng, 48, 96)
    got = arima.fit(2, 1, 2, y, include_intercept=include_intercept,
                    warn=False, device="cpu")
    want = jarima.fit(2, 1, 2, jnp.asarray(y),
                      include_intercept=include_intercept, warn=False)
    assert got.coefficients.dtype == torch.float64
    assert got.diagnostics.converged.numpy().mean() > 0.5
    _assert_fits_agree(got, want)


def test_fit_ragged_with_short_lanes_matches_jax():
    rng = np.random.default_rng(1)
    y = _ragged(rng, _arima_panel(rng, 40, 80))
    with pytest.warns(UserWarning, match="shorter than"):
        got = arima.fit(2, 1, 2, y, warn=False, device="cpu")
    with pytest.warns(UserWarning, match="shorter than"):
        want = jarima.fit(2, 1, 2, jnp.asarray(y), warn=False)
    coefs = got.coefficients.numpy()
    assert np.isnan(coefs[[3, 7]]).all()
    assert not got.diagnostics.converged.numpy()[[3, 7]].any()
    assert np.isfinite(np.delete(coefs, [3, 7], axis=0)).all()
    _assert_fits_agree(got, want)


@pytest.mark.parametrize("include_intercept", [True, False])
def test_fit_ar_fast_path_matches_jax(include_intercept):
    rng = np.random.default_rng(2)
    y = _ragged(rng, _arima_panel(rng, 24, 64))
    with pytest.warns(UserWarning, match="shorter than"):
        got = arima.fit(2, 1, 0, y, include_intercept=include_intercept,
                        warn=False, device="cpu")
    with pytest.warns(UserWarning, match="shorter than"):
        want = jarima.fit(2, 1, 0, jnp.asarray(y),
                          include_intercept=include_intercept, warn=False)
    # a direct OLS: 0 iterations, every finite lane converged
    assert (got.diagnostics.n_iter.numpy() == 0).all()
    np.testing.assert_array_equal(got.diagnostics.converged.numpy(),
                                  np.asarray(want.diagnostics.converged))
    # OLS solves of well-conditioned lag designs, float64 both sides
    np.testing.assert_allclose(got.coefficients.numpy(),
                               np.asarray(want.coefficients), rtol=1e-10,
                               atol=1e-12)
    conv = got.diagnostics.converged.numpy()
    np.testing.assert_allclose(got.diagnostics.fun.numpy()[conv],
                               np.asarray(want.diagnostics.fun)[conv],
                               rtol=1e-10)


def test_fit_user_init_and_max_iter_match_jax():
    rng = np.random.default_rng(3)
    y = _arima_panel(rng, 16, 72)
    init = np.array([0.5, 0.2, 0.2, 0.1, 0.0])
    got = arima.fit(2, 1, 2, y, user_init_params=init, max_iter=7,
                    warn=False, device="cpu")
    want = jarima.fit(2, 1, 2, jnp.asarray(y),
                      user_init_params=jnp.asarray(init), max_iter=7,
                      warn=False)
    assert got.diagnostics.n_iter.numpy().max() <= 7
    _assert_fits_agree(got, want)


@pytest.mark.parametrize("p,d,q,icpt", [(2, 1, 2, True), (1, 0, 1, False),
                                        (0, 2, 2, True), (3, 1, 0, True)])
def test_forecast_and_likelihood_from_jax_coefficients(p, d, q, icpt):
    rng = np.random.default_rng(4)
    y = _arima_panel(rng, 10, 50, d=d)
    k = int(icpt) + p + q
    coefs = 0.2 * rng.normal(size=(10, k))
    j_model = jarima.ARIMAModel(p, d, q, jnp.asarray(coefs), icpt)
    model = convert.arima_from_numpy(p, d, q, np.asarray(j_model.coefficients),
                                     has_intercept=icpt, device="cpu")
    assert model.n_params == j_model.n_params
    # the same recurrences in float64; integration sums amplify roundoff
    # by the series' length
    np.testing.assert_allclose(
        model.forecast(y, 6).numpy(),
        np.asarray(jax.jit(lambda v: j_model.forecast(v, 6))(
            jnp.asarray(y))), rtol=1e-10,
        atol=1e-9)
    np.testing.assert_allclose(
        model.log_likelihood_css(y).numpy(),
        np.asarray(jax.jit(j_model.log_likelihood_css)(jnp.asarray(y))),
        rtol=1e-10)
    np.testing.assert_array_equal(model.is_stationary(),
                                  np.asarray(j_model.is_stationary()))
    np.testing.assert_array_equal(model.is_invertible(),
                                  np.asarray(j_model.is_invertible()))


def test_fitted_model_carries_across_with_diagnostics():
    rng = np.random.default_rng(5)
    y = _arima_panel(rng, 12, 64)
    want = jarima.fit(2, 1, 2, jnp.asarray(y), warn=False)
    diag = tuple(np.asarray(x) for x in want.diagnostics[:3])
    model = convert.arima_from_numpy(2, 1, 2, np.asarray(want.coefficients),
                                     diagnostics=diag, device="cpu")
    np.testing.assert_array_equal(model.diagnostics.converged.numpy(),
                                  diag[0])
    np.testing.assert_allclose(
        model.forecast(y, 4).numpy(),
        np.asarray(jax.jit(lambda v: want.forecast(v, 4))(jnp.asarray(y))),
        rtol=1e-10, atol=1e-9)
    ar = convert.autoregression_from_numpy(np.ones(3), np.zeros((3, 2)),
                                           device="cpu")
    assert ar.order == 2 and ar.n_params == 3
    with pytest.raises(ValueError, match="has 5 coefficients"):
        convert.arima_from_numpy(2, 1, 2, np.zeros((3, 4)), device="cpu")


def test_default_device_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    y = _arima_panel(np.random.default_rng(6), 4, 40).astype(np.float32)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        arima.fit(2, 1, 2, y, warn=False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        _device.default_device()


def test_cuda_requests_the_kernel_cannot_take_raise(monkeypatch):
    # pretend a card is there: the checks must raise before any tensor
    # reaches the (absent) device
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    y = _arima_panel(np.random.default_rng(7), 4, 40)
    with pytest.raises(ValueError, match="float32"):
        arima.fit(2, 1, 2, y, warn=False, device="cuda")
    with pytest.raises(ValueError, match="p, q <= 5"):
        arima.fit(6, 1, 1, y.astype(np.float32), warn=False, device="cuda")


def test_unported_options_raise():
    """``objective="exact"`` is ported (its parity tests are
    ``test_torch_arima_exact.py``): it runs, and an unknown objective
    raises.  The long-series fits are ported too (their parity tests
    are ``test_torch_arima_long.py``)."""
    y = _arima_panel(np.random.default_rng(8), 4, 40)
    assert callable(arima.fit_long)
    assert callable(arima.segment_fit_outputs)
    m = arima.fit(2, 1, 2, y, warn=False, device="cpu", objective="exact",
                  max_iter=3)
    assert m.coefficients.shape == (4, 5)
    with pytest.raises(ValueError, match="objective"):
        arima.fit(2, 1, 2, y, warn=False, device="cpu", objective="full")
