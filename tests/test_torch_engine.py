"""The port's fit engine against the JAX package's, on the CPU.

A NaN-padded panel streams in several chunks (the last one short and
ragged) through both engines at float64; the port runs with
``device="cpu"``, which stages chunks through plain host buffers instead
of the pinned buffers and side-stream copies it uses on a card.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spark_timeseries_tpu import engine as jengine
from spark_timeseries_tpu_torch import engine

torch.set_num_threads(1)


def _panel(rng, S, n):
    e = rng.normal(size=(S, n + 16))
    y = np.zeros_like(e)
    for t in range(2, e.shape[1]):
        y[:, t] = 1.0 + 0.25 * y[:, t - 1] + 0.35 * y[:, t - 2] + e[:, t] \
            + 0.3 * e[:, t - 1] + 0.1 * e[:, t - 2]
    return np.cumsum(y[:, 16:], axis=1)


def test_buckets_match_jax():
    for n_series, n_obs in ((1, 1), (8, 32), (9, 33), (100, 128),
                            (131072, 127)):
        assert engine.series_bucket(n_series) \
            == jengine.series_bucket(n_series)
        assert engine.pad_bucket(n_series, n_obs) \
            == jengine.pad_bucket(n_series, n_obs)


def test_stream_fit_matches_jax_engine():
    rng = np.random.default_rng(0)
    y = _panel(rng, 150, 64)
    y[-3:, :5] = np.nan          # the tail chunk is ragged
    y[140, -4:] = np.nan
    kw = dict(chunk_size=64, collect=True, p=2, d=1, q=2)
    got = engine.FitEngine().stream_fit(y, "arima", device="cpu", **kw)
    want = jengine.FitEngine().stream_fit(y, "arima", **kw)
    assert (got.n_series, got.n_fitted, got.n_chunks) \
        == (want.n_series, want.n_fitted, want.n_chunks) == (150, 150, 3)
    assert not got.chunk_failures
    assert got.stats["collected_ranges"] == [[0, 64], [64, 128], [128, 150]]
    # one LM loop per chunk, each at most the cap
    assert len(got.stats["lm_iterations"]) == 3
    assert max(got.stats["lm_iterations"]) <= 50
    assert got.stats["lm_fit_launches"] == [0, 0, 0]    # no kernel here
    assert got.n_converged == want.n_converged
    coefs = np.concatenate([m.coefficients.numpy() for m in got.models])
    j_coefs = np.concatenate([np.asarray(m.coefficients)
                              for m in want.models])
    conv = np.concatenate([m.diagnostics.converged.numpy()
                           for m in got.models])
    np.testing.assert_array_equal(conv, np.concatenate(
        [np.asarray(m.diagnostics.converged) for m in want.models]))
    # the same float64 LM per lane (padding lanes never touch real ones)
    np.testing.assert_allclose(coefs, j_coefs, rtol=0, atol=1e-7)


def test_fit_matches_jax_engine():
    rng = np.random.default_rng(1)
    y = _panel(rng, 32, 64)
    y[:4, :6] = np.nan
    got = engine.FitEngine().fit(y, "arima", p=1, d=1, q=1, device="cpu")
    want = jengine.FitEngine().fit(jnp.asarray(y), "arima", p=1, d=1, q=1)
    np.testing.assert_array_equal(got.diagnostics.converged.numpy(),
                                  np.asarray(want.diagnostics.converged))
    np.testing.assert_allclose(got.coefficients.numpy(),
                               np.asarray(want.coefficients), rtol=0,
                               atol=1e-7)
    ar = engine.FitEngine().fit(y, "ar", max_lag=2, device="cpu")
    j_ar = jengine.FitEngine().fit(jnp.asarray(y), "ar", max_lag=2)
    # direct OLS, float64 both sides
    np.testing.assert_allclose(ar.coefficients.numpy(),
                               np.asarray(j_ar.coefficients), rtol=1e-10)


def test_stream_fit_isolates_a_bad_chunk():
    rng = np.random.default_rng(2)
    y = _panel(rng, 48, 40)
    y[20, 10] = np.nan           # interior gap: chunk [16, 32) violates
    res = engine.FitEngine().stream_fit(y, "arima", chunk_size=16,
                                        collect=True, p=1, d=1, q=1,
                                        device="cpu")
    assert res.n_chunks == 3 and res.n_fitted == 32
    (fail,) = res.chunk_failures
    assert (fail["chunk_start"], fail["chunk_stop"], fail["kind"]) \
        == (16, 32, "data")
    assert res.stats["collected_ranges"] == [[0, 16], [32, 48]]
    assert res.rate > 0


def test_stream_fit_rejects_what_the_port_lacks(monkeypatch, tmp_path):
    y = np.zeros((8, 40))
    # the durability tier is ported: a journal commits the chunk and a
    # rerun restores it instead of fitting
    y_fit = _panel(np.random.default_rng(4), 8, 40)
    first = engine.FitEngine().stream_fit(y_fit, "arima", p=1, d=1, q=1,
                                          journal=str(tmp_path / "j"),
                                          device="cpu")
    again = engine.FitEngine().stream_fit(y_fit, "arima", p=1, d=1, q=1,
                                          journal=str(tmp_path / "j"),
                                          device="cpu")
    assert (first.stats["journal_commits"], first.stats["journal_hits"]) \
        == (1, 0)
    assert (again.stats["journal_commits"], again.stats["journal_hits"]) \
        == (0, 1)
    assert again.n_converged == first.n_converged
    # a family the JAX engine does not stream either: its ValueError
    with pytest.raises(ValueError, match="unknown engine family"):
        engine.FitEngine().stream_fit(y, "arimax", device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        engine.FitEngine().stream_fit(y, "arima")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    with pytest.raises(ValueError, match="float32"):
        engine.FitEngine().stream_fit(y, "arima", device="cuda")


@pytest.mark.parametrize("family", ["ewma", "garch", "argarch", "egarch"])
def test_stream_fit_is_the_direct_fit(family):
    """The new engine families: each chunk of ``stream_fit`` is the
    family's direct fit of those rows, bit for bit, and the engine's fit
    the same; a NaN chunk is a data failure (no ragged path)."""
    from spark_timeseries_tpu_torch.models import ewma, garch
    rng = np.random.default_rng(21)
    y = rng.standard_t(6, size=(16, 96)) * 0.5
    if family == "ewma":
        y = np.cumsum(y, axis=1) + 100.0
    direct = {"ewma": ewma.fit, "garch": garch.fit,
              "argarch": garch.fit_ar_garch,
              "egarch": garch.fit_egarch}[family]
    res = engine.FitEngine().stream_fit(y, family, chunk_size=8,
                                        collect=True, device="cpu")
    assert res.n_chunks == 2 and not res.chunk_failures
    assert len(res.stats["solver_iterations"]) == 2
    conv = 0
    for (a, b), got in zip(res.stats["collected_ranges"], res.models):
        want = direct(y[a:b], device="cpu")
        for f in want._fields:
            if f != "diagnostics":
                assert torch.equal(getattr(got, f), getattr(want, f)), f
        assert torch.equal(got.diagnostics.n_iter, want.diagnostics.n_iter)
        conv += int(want.diagnostics.converged.sum())
    assert res.n_converged == conv
    one = engine.FitEngine().fit(y[:8], family, device="cpu")
    assert torch.equal(one[0], res.models[0][0])
    bad = y.copy()
    bad[3, :4] = np.nan
    res = engine.FitEngine().stream_fit(bad, family, chunk_size=8,
                                        device="cpu")
    assert [f["kind"] for f in res.chunk_failures] == ["data"]


@pytest.mark.parametrize("family", ["holt_winters", "ewma", "garch",
                                    "argarch", "egarch"])
def test_resilient_dispatch_covers_the_new_families(family):
    """``resilient_dispatch`` reaches each family's chain, and
    ``fit_resilient`` pads to the bucket without changing a lane."""
    rng = np.random.default_rng(22)
    y = rng.standard_t(6, size=(6, 48)) * 0.5
    if family in ("ewma", "holt_winters"):
        y = np.cumsum(y, axis=1) + 100.0
    y[0] = np.nan
    kw = {"period": 4} if family == "holt_winters" else {}
    fn = engine.FitEngine.resilient_dispatch(family)
    rp = None
    from spark_timeseries_tpu_torch.utils.resilience import RetryPolicy
    rp = RetryPolicy(max_restarts=0, max_iter=10)
    m1, o1 = fn(y, retry=rp, device="cpu", **kw)
    m2, o2 = engine.FitEngine().fit_resilient(y, family, retry=rp,
                                              device="cpu", **kw)
    assert o1.status[0] == o2.status[0] == 3          # skipped
    np.testing.assert_array_equal(o1.status, o2.status)
    np.testing.assert_array_equal(np.nan_to_num(o1.params, nan=7.0),
                                  np.nan_to_num(o2.params, nan=7.0))
    # the exogenous-regressor families dispatch to their own chains
    from spark_timeseries_tpu_torch.models import (arimax, autoregression_x,
                                                   regression_arima)
    assert engine.FitEngine.resilient_dispatch("arimax") \
        is arimax.fit_resilient
    assert engine.FitEngine.resilient_dispatch("arx") \
        is autoregression_x.fit_resilient
    assert engine.FitEngine.resilient_dispatch("regression_arima") \
        is regression_arima.fit_resilient
