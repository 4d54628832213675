"""The port's EWMA (``models.ewma``) against the JAX package's, on the CPU
in float64: the three fits (LM over the fused normal equations, the box
projected gradient and BFGS) dense and ragged, the model methods at the
JAX package's fitted parameters, and the fail-soft chain's statuses.

The port's smoothing is a log-depth scan where the JAX package walks the
series with ``lax.scan``; both round the same function, so fits agree to
1e-9 and iteration counts lane for lane, and the methods to 1e-10
relative."""

import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spark_timeseries_tpu import engine as jengine
from spark_timeseries_tpu.models import ewma as jewma
from spark_timeseries_tpu_torch import engine
from spark_timeseries_tpu_torch.models import ewma
from spark_timeseries_tpu_torch.models.convert import ewma_from_numpy
from torch_jax_line_search import without_line_search_faults

torch.set_num_threads(1)


def _panel(seed=0, S=16, n=96):
    """Random walks around 100 (BASELINE config #1's recipe), four lanes
    of a noisy level (interior optima), and ragged lanes: a late start,
    an early stop, a too-short lane."""
    rng = np.random.default_rng(seed)
    y = np.cumsum(rng.normal(size=(S, n)), axis=1) + 100.0
    y[:4] = 0.1 * np.cumsum(rng.normal(size=(4, n)), axis=1) \
        + rng.normal(size=(4, n))
    y[4, :10] = np.nan
    y[5, -20:] = np.nan
    y[6, 2:] = np.nan
    return y


@pytest.fixture(scope="module")
def fits():
    y = _panel()
    out = {}
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        for method in ("lm", "box", "bfgs"):
            # the BFGS is held to jax's with the port's line search
            # (torch_jax_line_search)
            with without_line_search_faults():
                want = jewma.fit(jnp.asarray(y), method=method)
            out[method] = (want, ewma.fit(y, method=method, device="cpu"))
    return y, out


@pytest.mark.parametrize("method", ["lm", "box", "bfgs"])
def test_fit_matches_jax(fits, method):
    _, out = fits
    want, got = out[method]
    cw = np.asarray(want.diagnostics.converged)
    np.testing.assert_array_equal(got.diagnostics.converged.numpy(), cw)
    np.testing.assert_array_equal(got.diagnostics.n_iter.numpy(),
                                  np.asarray(want.diagnostics.n_iter))
    np.testing.assert_allclose(got.smoothing.numpy(),
                               np.asarray(want.smoothing), atol=1e-9)
    # the too-short lane is quarantined, the other ragged lanes fit
    assert np.isnan(got.smoothing.numpy()[6]) and not cw[6]
    if method == "lm":
        assert cw[:4].all()          # the noisy levels' interior optima


def test_model_methods_match_jax(fits):
    y, out = fits
    want = out["lm"][0]
    a = np.asarray(want.smoothing)[7:]
    dense = y[7:]
    jm = jewma.EWMAModel(jnp.asarray(a))
    tm = ewma_from_numpy(a, device="cpu")
    for name, args in (("add_time_dependent_effects", ()),
                       ("remove_time_dependent_effects", ()),
                       ("sse", ()), ("forecast", (5,))):
        np.testing.assert_allclose(
            getattr(tm, name)(dense, *args).numpy(),
            np.asarray(getattr(jm, name)(jnp.asarray(dense), *args)),
            rtol=1e-10)
    for got, w in zip(tm.forecast_interval(dense, 6, 0.9),
                      jm.forecast_interval(jnp.asarray(dense), 6, 0.9)):
        np.testing.assert_allclose(got.numpy(), np.asarray(w), rtol=1e-10)
    assert tm.n_params == jm.n_params == 1


def test_fit_resilient_matches_jax():
    y = _panel(seed=1, S=12, n=64)
    y[7] = 3.0                       # constant: the naive model's lane
    y[8, 30] = np.inf
    y[9] = np.nan
    y[10, 20] = np.nan               # interior gap
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jm, jo = jewma.fit_resilient(jnp.asarray(y))
        tm, to = ewma.fit_resilient(y, device="cpu")
    np.testing.assert_array_equal(to.status, np.asarray(jo.status))
    np.testing.assert_array_equal(to.health, np.asarray(jo.health))
    np.testing.assert_array_equal(to.attempts, np.asarray(jo.attempts))
    np.testing.assert_allclose(to.params, np.asarray(jo.params), atol=1e-9)
    np.testing.assert_array_equal(tm.diagnostics.converged.numpy(),
                                  np.asarray(jm.diagnostics.converged))


def test_engine_stream_fit_is_the_direct_fit():
    y = _panel(seed=2, S=16, n=64)[7:15]          # dense lanes
    res = engine.FitEngine().stream_fit(y, "ewma", chunk_size=8,
                                        collect=True, device="cpu")
    direct = ewma.fit(y, device="cpu")
    assert torch.equal(res.models[0].smoothing, direct.smoothing)
    assert res.n_converged == int(direct.diagnostics.converged.sum())
    assert res.stats["solver_iterations"] == [
        int(direct.diagnostics.n_iter.max())]
    want = jengine.FitEngine().stream_fit(jnp.asarray(y), "ewma",
                                          chunk_size=8, collect=True)
    np.testing.assert_allclose(res.models[0].smoothing.numpy(),
                               np.asarray(want.models[0].smoothing),
                               atol=1e-9)
