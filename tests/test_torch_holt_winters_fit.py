"""The port's Holt-Winters fits against the JAX package, on the CPU.

``fit`` (the JAX fit forced onto its fused pass with ``STS_HW_FUSED=1``)
dense, ragged and short, its retry and fail-soft chain, the model surface
and the engine family against their JAX twins, and the fit against R's
``stats::HoltWinters`` oracles.  The pass-level cases (the plain pass,
``minimize_box``, the plain box fit) are in ``test_torch_holt_winters.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from r_datasets import AIR_PASSENGERS, CO2
from spark_timeseries_tpu import engine as jengine
from spark_timeseries_tpu.models import holt_winters as jhw
from spark_timeseries_tpu_torch import engine
from spark_timeseries_tpu_torch.models import holt_winters as hw
from spark_timeseries_tpu_torch.models.convert import holt_winters_from_numpy
from spark_timeseries_tpu_torch.ops import hw_sse

torch.set_num_threads(1)

# R stats::HoltWinters forecasts (tests/test_holt_winters.py)
R_ADDITIVE_FORECAST = np.array([
    453.4977, 429.3906, 467.0361, 503.2574, 512.3395, 571.8880,
    652.6095, 637.4623, 539.7548, 490.7250, 424.4593, 469.5315])
R_MULT_FORECAST = np.array([
    365.1079, 365.9664, 366.7343, 368.1364, 368.6674, 367.9508,
    366.5318, 364.3799, 362.4731, 362.7520, 364.2203, 365.6741])


def _panel(rng, S, n, m):
    """The bench recipe ``100 + 0.5 t + 10 sin(2πt/m) + N(0, 2²)``."""
    t = np.arange(n)
    return 100.0 + 0.5 * t + 10.0 * np.sin(2 * np.pi * t / m) \
        + rng.normal(0.0, 2.0, size=(S, n))


def _jax_fit(monkeypatch, y, m, model_type, **kw):
    monkeypatch.setenv("STS_HW_FUSED", "1")   # the JAX fit's fused pass
    return jhw.fit(jnp.asarray(y), m, model_type, **kw)


def _assert_fits_agree(got, want):
    conv = got.diagnostics.converged.numpy()
    np.testing.assert_array_equal(conv, np.asarray(want.diagnostics.converged))
    np.testing.assert_array_equal(got.diagnostics.n_iter.numpy(),
                                  np.asarray(want.diagnostics.n_iter))
    for name in ("alpha", "beta", "gamma"):
        a = getattr(got, name).numpy()
        b = np.asarray(getattr(want, name))
        np.testing.assert_array_equal(np.isnan(a), np.isnan(b))
        # converged lanes sit at the same optimum; lanes cut at max_iter
        # drift apart by the passes' last-digit differences
        np.testing.assert_allclose(a[conv], b[conv], rtol=0, atol=1e-8)
        np.testing.assert_allclose(a[~conv], b[~conv], rtol=0, atol=1e-3)
    np.testing.assert_allclose(got.diagnostics.fun.numpy()[conv],
                               np.asarray(want.diagnostics.fun)[conv],
                               rtol=1e-9)


@pytest.mark.parametrize("case", ["dense", "ragged", "short"])
def test_fit_matches_jax(monkeypatch, case):
    rng = np.random.default_rng(4)
    S, n, m = 24, 44, 4
    model_type = "multiplicative" if case == "ragged" else "additive"
    y = _panel(rng, S, n, m)
    if case != "dense":
        nv = rng.integers(2 * m + 1, n + 1, size=S)
        if case == "short":
            nv[:3] = [2 * m, 5, 0]          # under 2m + 1: quarantined
        lead = rng.integers(0, n - nv + 1)
        idx = np.arange(n)[None, :]
        y = np.where((idx >= lead[:, None]) & (idx < (lead + nv)[:, None]),
                     y, np.nan)
    want = _jax_fit(monkeypatch, y, m, model_type, max_iter=150)
    got = hw.fit(y, m, model_type, max_iter=150, device="cpu")
    _assert_fits_agree(got, want)
    if case == "short":
        assert np.isnan(got.alpha.numpy()[:3]).all()
        assert not got.diagnostics.converged.numpy()[:3].any()


@pytest.mark.parametrize("data,model_type,r_params,r_forecast", [
    (AIR_PASSENGERS, "additive", (0.24796, 0.03453, 1.0),
     R_ADDITIVE_FORECAST),
    (CO2, "multiplicative", (0.51265, 0.00949, 0.47289), R_MULT_FORECAST)])
def test_r_oracles(monkeypatch, data, model_type, r_params, r_forecast):
    got = hw.fit(np.asarray(data), 12, model_type, device="cpu")
    want = _jax_fit(monkeypatch, np.asarray(data), 12, model_type)
    # the R oracle, with tests/test_holt_winters.py's tolerances
    for name, r, tol in zip(("alpha", "beta", "gamma"), r_params,
                            (0.01, 0.01, 0.01 if model_type == "additive"
                             else 0.1)):
        assert abs(float(getattr(got, name)) - r) < tol
    fc = got.forecast(np.asarray(data), 12).numpy()
    np.testing.assert_allclose(fc, r_forecast, atol=10)
    # and the JAX fit's optimum, the same float64 state machine
    _assert_fits_agree(got, want)


@pytest.mark.parametrize("model_type", ["additive", "multiplicative"])
def test_model_surface_from_jax_parameters(model_type):
    rng = np.random.default_rng(5)
    S, n, m = 8, 30, 5
    y = _panel(rng, S, n, m)
    a, b, g = (rng.uniform(0.05, 0.9, size=S) for _ in range(3))
    jm = jhw.HoltWintersModel(model_type, m, jnp.asarray(a), jnp.asarray(b),
                              jnp.asarray(g))
    tm = holt_winters_from_numpy(model_type, m, a, b, g, device="cpu")
    yj = jnp.asarray(y)

    def jx(fn):
        """The JAX method as one compiled program (the same arithmetic,
        compiled once instead of an operation at a time)."""
        return jax.jit(fn)(yj)

    # float64 both sides, the same recurrences
    for got, want in (
            (tm.forecast(y, 11), jx(lambda v: jm.forecast(v, 11))),
            (tm.sse(y), jx(jm.sse)),
            (tm.add_time_dependent_effects(y),
             jx(jm.add_time_dependent_effects)),
            *zip(tm.get_holt_winters_components(y),
                 jx(jm.get_holt_winters_components)),
            *zip(tm.forecast_interval(y, 14, conf=0.9),
                 jx(lambda v: jm.forecast_interval(v, 14, conf=0.9)))):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-11, atol=1e-9)
    with pytest.raises(NotImplementedError):
        tm.remove_time_dependent_effects(y)
    with pytest.raises(ValueError, match="Invalid model type"):
        hw.HoltWintersModel("banana", m, 0.3, 0.1, 0.1).additive
    with pytest.raises(ValueError, match="n_future"):
        tm.forecast_interval(y, 0)


def test_naive_seasonal_model_matches_jax():
    rng = np.random.default_rng(6)
    y = _panel(rng, 6, 30, 4)
    y[0, :4] = np.nan
    y[1, -25:] = np.nan             # too short: not ok
    for model_type in ("additive", "multiplicative"):
        got = hw._naive_seasonal_model(torch.from_numpy(y), 4, model_type)
        want = jhw._naive_seasonal_model(jnp.asarray(y), 4, model_type)
        for g, w in zip(got.diagnostics[:3], want.diagnostics[:3]):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-12)
        assert got.diagnostics.attempts is None \
            and want.diagnostics.attempts is None


def test_fit_rejects_what_the_port_lacks(monkeypatch):
    y = _panel(np.random.default_rng(7), 4, 20, 4)
    with pytest.raises(ValueError, match="Invalid model type"):
        hw.fit(y, 4, "banana", device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        hw.fit(y, 4)


def test_engine_matches_jax_engine(monkeypatch):
    monkeypatch.setenv("STS_HW_FUSED", "1")
    rng = np.random.default_rng(8)
    y = _panel(rng, 7, 28, 4)
    kw = dict(chunk_size=3, collect=True, period=4, model_type="additive")
    got = engine.FitEngine().stream_fit(y, "holt_winters", device="cpu",
                                        **kw)
    want = jengine.FitEngine().stream_fit(y, "holt_winters", **kw)
    assert (got.n_series, got.n_fitted, got.n_chunks, got.n_converged) \
        == (want.n_series, want.n_fitted, want.n_chunks, want.n_converged)
    assert not got.chunk_failures and got.n_chunks == 3
    # the tail chunk of one series pads to a bucket of 3 zero lanes
    assert got.stats["collected_ranges"] == [[0, 3], [3, 6], [6, 7]]
    assert len(got.stats["value_and_grad_calls"]) == 3
    for g, w in zip(got.models, want.models):
        _assert_fits_agree(g, w)
    direct = engine.FitEngine().fit(y[:3], "holt_winters", period=4,
                                    device="cpu")
    np.testing.assert_array_equal(direct.alpha.numpy(),
                                  got.models[0].alpha.numpy())

    # a NaN chunk is a data failure: Holt-Winters has no ragged engine path
    y = y[:6].copy()
    y[1, :3] = np.nan
    got = engine.FitEngine().stream_fit(y, "holt_winters", device="cpu",
                                        **kw)
    want = jengine.FitEngine().stream_fit(y, "holt_winters", **kw)
    (fail,) = got.chunk_failures
    (j_fail,) = want.chunk_failures
    assert (fail["chunk_start"], fail["chunk_stop"], fail["kind"]) \
        == (j_fail["chunk_start"], j_fail["chunk_stop"], j_fail["kind"]) \
        == (0, 3, "data")
    assert got.stats["collected_ranges"] == [[3, 6]]
    assert got.n_fitted == want.n_fitted == 3


def test_fit_on_cpu_runs_the_plain_box_fit(monkeypatch):
    rng = np.random.default_rng(12)
    y = _panel(rng, 8, 30, 4)
    routed = []
    plain = hw_sse.box_fit_plain

    def spy(*args, **kwargs):
        routed.append(args[0].y.device.type)
        return plain(*args, **kwargs)

    monkeypatch.setattr(hw_sse, "box_fit_plain", spy)
    launches = (hw_sse.box_fit.launches, hw_sse.value_and_grad.launches)
    stats = {}
    got = hw.fit(y, 4, max_iter=60, device="cpu", stats=stats)
    assert routed == ["cpu"]
    assert (hw_sse.box_fit.launches, hw_sse.value_and_grad.launches) \
        == launches                               # no kernel on the CPU
    assert stats["evaluations"].shape == (8,)
    assert stats["iterations"] == int(got.diagnostics.n_iter.max())
    assert "box_fit_launches" not in stats

    # the engine reports each chunk's counts from the same solver
    res = engine.FitEngine().stream_fit(y, "holt_winters", chunk_size=4,
                                        period=4, device="cpu")
    assert routed == ["cpu"] * 3
    chunks = [{}, {}]
    for part, st in zip((y[:4], y[4:]), chunks):
        hw.fit(part, 4, device="cpu", stats=st)
    assert res.stats["box_fit_launches"] == [0, 0]
    assert res.stats["lane_evaluations"] == [
        int(st["evaluations"].sum()) for st in chunks]
    assert res.stats["box_iterations"] == [st["iterations"]
                                           for st in chunks]
    assert res.stats["value_and_grad_calls"] == [st["calls"]
                                                 for st in chunks]


def _jax_draws(seed, S, k, restarts):
    keys = jax.random.split(jax.random.PRNGKey(seed), S)
    return np.stack([
        np.asarray(jax.vmap(lambda kk, a=a: jax.random.normal(
            jax.random.fold_in(kk, a), (k,), jnp.float64))(keys))
        for a in range(1, restarts + 1)])


def test_fit_retry_matches_jax_given_its_draws(monkeypatch):
    """``fit(retry=...)``: attempt 0 is the plain fit bit for bit, each
    restart one box fit over the failing lanes' gathered rows; with the
    JAX package's draws handed in, attempts and results are the JAX
    restart loop's."""
    from spark_timeseries_tpu.utils import resilience as jres
    from spark_timeseries_tpu_torch.utils import resilience as res
    rng = np.random.default_rng(11)
    S, n, m = 16, 40, 4
    y = _panel(rng, S, n, m)
    draws = _jax_draws(0, S, 3, 2)
    want = _jax_fit(monkeypatch, y, m, "additive", max_iter=8,
                    retry=jres.RetryPolicy())
    stats = {}
    got = hw.fit(y, m, "additive", max_iter=8, retry=res.RetryPolicy(),
                 device="cpu", stats=stats, _restart_draws=draws)
    att = got.diagnostics.attempts.numpy()
    np.testing.assert_array_equal(att, np.asarray(want.diagnostics.attempts))
    assert att.max() > 1                      # the restarts really ran
    _assert_fits_agree(got, want)
    assert "box_fit_launches" not in stats    # no card
    assert stats["restart_lanes"][0] == int((att > 1).sum())
    plain = hw.fit(y, m, "additive", max_iter=8, device="cpu")
    first = att == 1
    for name in ("alpha", "beta", "gamma"):
        assert torch.equal(getattr(got, name)[torch.as_tensor(first)],
                           getattr(plain, name)[torch.as_tensor(first)])


def test_fit_resilient_matches_jax(monkeypatch):
    rng = np.random.default_rng(12)
    S, n, m = 12, 40, 4
    y = _panel(rng, S, n, m)
    y[0] = np.nan
    y[1] = 5.0                                 # constant
    y[2, 7] = np.inf
    y[3, :-6] = np.nan                         # too short
    y[4, :3] = np.nan                          # a late start
    monkeypatch.setenv("STS_HW_FUSED", "1")
    jm, jo = jhw.fit_resilient(jnp.asarray(y), m, max_iter=20)
    stats = {}
    tm, to = engine.FitEngine.resilient_dispatch("holt_winters")(
        y, m, max_iter=20, device="cpu", stats=stats)
    np.testing.assert_array_equal(to.status, np.asarray(jo.status))
    np.testing.assert_array_equal(to.health, np.asarray(jo.health))
    np.testing.assert_array_equal(to.fallback_used,
                                  np.asarray(jo.fallback_used))
    usable = np.isin(to.status, (0, 1, 2))
    assert usable.sum() >= 8
    # restarted lanes start from other draws than the JAX package's
    same = usable & (to.attempts == 1)
    np.testing.assert_allclose(to.params[same], np.asarray(jo.params)[same],
                               atol=1e-8)
    assert set(stats["box_fit_launches_by_stage"]) <= {"box", "box_midstart"}
    # through the engine's bucketing and the stream: the same lanes
    pm, po = engine.FitEngine().fit_resilient(y, "holt_winters", m,
                                              max_iter=20, device="cpu")
    np.testing.assert_array_equal(po.status, to.status)
    res = engine.FitEngine().stream_fit(y, "holt_winters", period=m,
                                        max_iter=20, resilient=True,
                                        chunk_size=S, device="cpu")
    assert res.stats["box_fit_launches"] == [0]
    assert sum(res.stats["resilient_statuses"].values()) == S
