"""The port's fit engine against the JAX package's on the keywords that
route a fit: arima's ``objective``, ``FitEngine.fit``'s ``bucket_obs``,
keywords the statics builder rejects (the direct bypass) and families
the engine does not fit.  On the CPU in float64, on a 16 × 64 random-walk
panel made from a numpy seed.

The exact fits hold the port to the JAX package's engine as
``test_torch_arima_exact.py`` holds ``arima.fit(objective="exact")``: the
JAX package's BFGS runs with the line-search lines the port changes
(``torch_jax_line_search``); the exact negative log likelihoods agree
within 1e-8 relative on every lane finite in both, and the coefficients
within 1e-6 on the lanes away from a common-factor ridge (both stationary
and invertible, no AR root within 0.15 of an MA root), where BFGS may
stop anywhere along the ridge.  The CSS fits agree within 1e-7, as in
``test_torch_engine.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spark_timeseries_tpu import engine as jengine
from spark_timeseries_tpu.models import arima as j_arima
from spark_timeseries_tpu_torch import Panel, engine
from spark_timeseries_tpu_torch import time as ttime
from spark_timeseries_tpu_torch.models import arima, convert
from torch_jax_line_search import without_line_search_faults

torch.set_num_threads(1)

S, N = 16, 64


@pytest.fixture(scope="module")
def walk():
    return np.cumsum(np.random.default_rng(41).normal(size=(S, N)), axis=1)


def _separated(model) -> np.ndarray:
    sus = arima._cancellation_suspects(model)
    return model.is_stationary() & model.is_invertible() & ~sus


def _assert_exact_close(coefs, fun, want_coefs, want_fun):
    got = arima.ARIMAModel(1, 1, 1, coefs)
    gf = fun.numpy()
    wf = np.asarray(want_fun)
    np.testing.assert_array_equal(np.isfinite(gf), np.isfinite(wf))
    fin = np.isfinite(gf)
    assert fin.sum() >= S - 2
    np.testing.assert_allclose(gf[fin], wf[fin], rtol=1e-8)
    jm = convert.arima_from_numpy(1, 1, 1, np.asarray(want_coefs),
                                  device="cpu")
    lanes = _separated(got) & _separated(jm)
    assert lanes.sum() >= S // 2
    np.testing.assert_allclose(got.coefficients.numpy()[lanes],
                               np.asarray(want_coefs)[lanes], rtol=1e-6,
                               atol=1e-8)


def test_exact_objective_through_the_engine_matches_jax(walk):
    kw = dict(p=1, d=1, q=1, objective="exact")
    with without_line_search_faults():
        want = jengine.FitEngine().fit(jnp.asarray(walk), "arima", **kw)
        want_s = jengine.FitEngine().stream_fit(walk, "arima", chunk_size=8,
                                                collect=True, **kw)
    got = engine.FitEngine().fit(walk, "arima", device="cpu", **kw)
    _assert_exact_close(got.coefficients, got.diagnostics.fun,
                        want.coefficients, want.diagnostics.fun)
    # the same as arima.fit's exact fit of the panel
    direct = arima.fit(1, 1, 1, walk, objective="exact", warn=False,
                       device="cpu")
    assert torch.equal(got.coefficients, direct.coefficients)

    got_s = engine.FitEngine().stream_fit(walk, "arima", chunk_size=8,
                                          collect=True, device="cpu", **kw)
    assert (got_s.n_chunks, got_s.n_fitted) == (want_s.n_chunks,
                                                want_s.n_fitted) == (2, S)
    assert not got_s.chunk_failures
    _assert_exact_close(
        torch.cat([m.coefficients for m in got_s.models]),
        torch.cat([m.diagnostics.fun for m in got_s.models]),
        np.concatenate([np.asarray(m.coefficients) for m in want_s.models]),
        np.concatenate([np.asarray(m.diagnostics.fun)
                        for m in want_s.models]))
    # a chunk's exact fit is the direct exact fit of its rows
    assert torch.equal(got_s.models[1].coefficients,
                       direct.coefficients[8:])

    # Panel.stream_fit passes the keyword through to the same engine
    index = ttime.uniform("2020-01-06T00:00Z", N,
                          ttime.BusinessDayFrequency(1))
    panel = Panel(index, walk, [f"s{i}" for i in range(S)], device="cpu")
    got_p = panel.stream_fit("arima", chunk_size=8, collect=True, **kw)
    for a, b in zip(got_p.models, got_s.models):
        assert torch.equal(a.coefficients, b.coefficients)


def test_fit_sends_rejected_keywords_to_the_family_fit(walk):
    """``user_init_params`` is no static of the arima builder: both
    engines fit it through the family's own fit (the JAX engine's
    ``_direct``)."""
    init = np.tile([0.1, 0.2, 0.1], (S, 1))
    got = engine.FitEngine().fit(walk, "arima", p=1, d=1, q=1,
                                 user_init_params=init, device="cpu")
    want = jengine.FitEngine().fit(jnp.asarray(walk), "arima", p=1, d=1,
                                   q=1, user_init_params=jnp.asarray(init))
    direct = arima.fit(1, 1, 1, walk, user_init_params=init, warn=False,
                       device="cpu")
    assert torch.equal(got.coefficients, direct.coefficients)
    np.testing.assert_array_equal(got.diagnostics.converged.numpy(),
                                  np.asarray(want.diagnostics.converged))
    np.testing.assert_allclose(got.coefficients.numpy(),
                               np.asarray(want.coefficients), rtol=0,
                               atol=1e-7)
    # a single series (not a panel) takes the same bypass in both
    one = engine.FitEngine().fit(walk[3], "arima", p=1, d=1, q=1,
                                 device="cpu")
    j_one = jengine.FitEngine().fit(jnp.asarray(walk[3]), "arima", p=1,
                                    d=1, q=1)
    np.testing.assert_allclose(one.coefficients.numpy(),
                               np.asarray(j_one.coefficients), rtol=0,
                               atol=1e-7)


@pytest.fixture(scope="module")
def direct60(walk):
    """The JAX package's direct fit of the first 60 observations, once
    per module (both ``bucket_obs`` cases hold against it)."""
    return j_arima.fit(1, 1, 1, jnp.asarray(walk[:, :60]), warn=False)


@pytest.mark.parametrize("bucket_obs", [False, True])
def test_fit_takes_bucket_obs(walk, direct60, bucket_obs):
    """60 observations: the JAX engine pads them to 64 (NaN, its ragged
    program) with ``bucket_obs`` and fits them as they are without; the
    port fits every panel at its own shape.  Both are the direct fit."""
    y = walk[:, :60]
    got = engine.FitEngine().fit(y, "arima", p=1, d=1, q=1,
                                 bucket_obs=bucket_obs, device="cpu")
    want = jengine.FitEngine().fit(jnp.asarray(y), "arima", p=1, d=1, q=1,
                                   bucket_obs=bucket_obs)
    j_direct = direct60
    np.testing.assert_array_equal(got.diagnostics.converged.numpy(),
                                  np.asarray(want.diagnostics.converged))
    for ref in (want, j_direct):
        np.testing.assert_allclose(got.coefficients.numpy(),
                                   np.asarray(ref.coefficients), rtol=0,
                                   atol=1e-7)


@pytest.mark.parametrize("family", ["arimax", "arx", "banana"])
def test_families_the_engine_does_not_fit_raise_as_jax(walk, family):
    """``arimax`` and ``arx`` have resilient chains but no engine fit in
    either package: ``ValueError`` from ``fit`` and ``stream_fit``."""
    for eng, kw in ((engine.FitEngine(), {"device": "cpu"}),
                    (jengine.FitEngine(), {})):
        with pytest.raises(ValueError, match="unknown engine family"):
            eng.fit(walk, family, **kw)
        with pytest.raises(ValueError, match="unknown engine family"):
            eng.stream_fit(walk, family, **kw)
