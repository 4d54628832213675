"""The port's Holt-Winters slice against the JAX package, on the CPU.

``ops.hw_sse.value_and_grad_plain`` (what a CPU tensor runs, and what the
CUDA kernel ``csrc/hw_sse.cu`` is held against on a card) is compared with
the vmapped JAX pass ``_hw_sse_value_and_grad`` at float64 and with the
archived Pallas kernel in interpret mode at float32; ``minimize_box``,
``fit`` (the JAX fit forced onto its fused pass with ``STS_HW_FUSED=1``),
the model surface and the engine family against their JAX twins; and the
fit against R's ``stats::HoltWinters`` oracles.
"""

import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from r_datasets import AIR_PASSENGERS, CO2
from spark_timeseries_tpu import engine as jengine
from spark_timeseries_tpu.models import holt_winters as jhw
from spark_timeseries_tpu.ops import pallas_arma
from spark_timeseries_tpu.ops.optimize import minimize_box as jminimize_box
from spark_timeseries_tpu_torch import engine
from spark_timeseries_tpu_torch.models import holt_winters as hw
from spark_timeseries_tpu_torch.models.convert import holt_winters_from_numpy
from spark_timeseries_tpu_torch.ops import hw_sse
from spark_timeseries_tpu_torch.ops.optimize import minimize_box

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


def _ragged(rng, y, m):
    """Left-aligned, zero-tailed lanes and their valid lengths (>= 2m+1)."""
    S, n = y.shape
    nv = rng.integers(2 * m + 1, n + 1, size=S)
    return np.where(np.arange(n)[None, :] < nv[:, None], y, 0.0), nv


def _jax_pass(params, y, m, model_type, nv=None):
    def one(p, s, *v):
        return jhw._hw_sse_value_and_grad(p, s, m, model_type,
                                          n_valid=v[0] if v else None)
    extra = () if nv is None else (jnp.asarray(nv),)
    return jax.vmap(one)(jnp.asarray(params), jnp.asarray(y), *extra)


def _grad_err(g, ref, sse):
    """Gradient error per entry, relative to the larger of the lane's
    largest entry and its SSE (the gradient's natural scale over the unit
    box, where the gradient happens to be small)."""
    scale = np.maximum(np.abs(ref).max(axis=1), np.abs(sse))[:, None]
    return (np.abs(g - ref) / scale).max()


@pytest.mark.parametrize("model_type,m", [("additive", 4),
                                          ("multiplicative", 5)])
@pytest.mark.parametrize("ragged", [False, True])
def test_plain_matches_jax_pass(model_type, m, ragged):
    rng = np.random.default_rng(0)
    y = _panel(rng, 48, 40, m)
    nv = None
    if ragged:
        y, nv = _ragged(rng, y, m)
    params = rng.uniform(0.05, 0.95, size=(48, 3))
    f, g = hw_sse.value_and_grad_plain(
        torch.from_numpy(params), torch.from_numpy(y), m, model_type,
        n_valid=None if nv is None else torch.from_numpy(nv))
    jf, jg = _jax_pass(params, y, m, model_type, nv)
    # float64 both sides; the tangent rows add their unit-vector term in
    # another order than the JAX pass
    np.testing.assert_allclose(f.numpy(), np.asarray(jf), rtol=1e-12)
    assert _grad_err(g.numpy(), np.asarray(jg), np.asarray(jf)) < 1e-12


def test_plain_takes_a_trial_dimension():
    rng = np.random.default_rng(1)
    y, nv = _ragged(rng, _panel(rng, 16, 30, 4), 4)
    inp = hw_sse.prepare(torch.from_numpy(y), 4, "multiplicative",
                         torch.from_numpy(nv))
    x = torch.from_numpy(rng.uniform(0.05, 0.95, size=(3, 16, 3)))
    fs, gs = hw_sse.evaluator(inp)(x)
    for k in range(3):
        f, g = hw_sse.evaluator(inp)(x[k])
        # the same elementwise arithmetic, broadcast over the trial dim
        assert torch.equal(fs[k], f) and torch.equal(gs[k], g)


def _load_hw_pallas():
    path = Path(__file__).resolve().parents[1] / "docs" / "experiments" \
        / "hw_pallas.py"
    spec = importlib.util.spec_from_file_location("_hw_pallas", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("model_type", ["additive", "multiplicative"])
def test_plain_f32_matches_pallas_interpret(model_type):
    # n - m = 37 steps: two 16-step chunks and the kernel's static tail
    rng = np.random.default_rng(2)
    S, n, m = 64, 41, 4
    y = _panel(rng, S, n, m).astype(np.float32)
    params = rng.uniform(0.05, 0.95, size=(S, 3)).astype(np.float32)
    additive = model_type == "additive"
    level0, trend0, season0 = jhw.HoltWintersModel(
        model_type, m, 0.0, 0.0, 0.0)._init_components(jnp.asarray(y))
    init = jnp.concatenate([level0[:, None], trend0[:, None], season0],
                           axis=-1).astype(jnp.float32)
    rows = pallas_arma._block_rows(S)
    y_b, n_blocks = pallas_arma._blocked(jnp.asarray(y[:, m:]), S, rows)
    init_b, _ = pallas_arma._blocked(init, S, rows)
    jf, jg = _load_hw_pallas().sse_value_and_grad(
        jnp.asarray(params), y_b, init_b, S, rows, n_blocks, m, additive,
        n - m, interpret=True)
    f, g = hw_sse.value_and_grad_plain(torch.from_numpy(params),
                                       torch.from_numpy(y), m, model_type)
    # float32 recurrences over 37 steps from initial components that the
    # two packages compute in float32 in other summation orders
    np.testing.assert_allclose(f.numpy(), np.asarray(jf), rtol=1e-4)
    assert _grad_err(g.numpy(), np.asarray(jg), np.asarray(jf)) < 1e-3


@pytest.mark.parametrize("trials_per_call", [1, 8])
def test_minimize_box_matches_jax(trials_per_call):
    rng = np.random.default_rng(3)
    S, n, m = 12, 32, 4
    y = _panel(rng, S, n, m)
    x0 = np.tile([0.3, 0.1, 0.1], (S, 1))
    # an out-of-box start: projected before the first evaluation
    x0[0] = [1.4, -0.2, 0.5]

    def vag(p, s):
        return jhw._hw_sse_value_and_grad(p, s, m, "additive")

    want = jminimize_box(lambda p, s: vag(p, s)[0], jnp.asarray(x0), 0.0,
                         1.0, jnp.asarray(y), tol=1e-10, max_iter=80,
                         value_and_grad_fn=vag)
    inp = hw_sse.prepare(torch.from_numpy(y), m, "additive")
    stats = {}
    got = minimize_box(hw_sse.evaluator(inp), torch.from_numpy(x0), 0.0,
                       1.0, tol=1e-10, max_iter=80,
                       trials_per_call=trials_per_call, stats=stats)
    # the same per-lane state machine on passes that agree to 1e-15
    np.testing.assert_array_equal(got.n_iter.numpy(),
                                  np.asarray(want.n_iter))
    np.testing.assert_array_equal(got.converged.numpy(),
                                  np.asarray(want.converged))
    np.testing.assert_allclose(got.x.numpy(), np.asarray(want.x),
                               rtol=1e-9, atol=1e-9)
    np.testing.assert_allclose(got.fun.numpy(), np.asarray(want.fun),
                               rtol=1e-9)
    assert stats["iterations"] == int(np.asarray(want.n_iter).max())
    assert stats["calls"] >= 1 + stats["iterations"]
    # restarts re-solve gathered lanes: without their evaluator it raises
    with pytest.raises(ValueError, match="evaluator_for"):
        minimize_box(hw_sse.evaluator(inp), torch.from_numpy(x0), 0.0, 1.0,
                     restarts=2)


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


def _lanes(inp, idx):
    """Lanes ``idx`` of a prepared panel."""
    return inp._replace(
        y=inp.y[:, idx].contiguous(), init=inp.init[:, idx].contiguous(),
        n_valid=None if inp.n_valid is None
        else inp.n_valid[idx].contiguous())


@pytest.mark.parametrize("ragged", [False, True])
def test_box_fit_plain_matches_jax(ragged):
    rng = np.random.default_rng(9)
    S, n, m = 16, 36, 4
    model_type = "multiplicative" if ragged else "additive"
    y = _panel(rng, S, n, m)
    nv = None
    if ragged:
        y, nv = _ragged(rng, y, m)
    x0 = np.tile([0.3, 0.1, 0.1], (S, 1))
    x0[1] = [0.9, 1.3, -0.1]               # out of the box: projected first

    def vag(p, s, *v):
        return jhw._hw_sse_value_and_grad(p, s, m, model_type,
                                          n_valid=v[0] if v else None)

    args = (jnp.asarray(y),) + (() if nv is None else (jnp.asarray(nv),))
    want = jminimize_box(lambda p, *a: vag(p, *a)[0], jnp.asarray(x0), 0.0,
                         1.0, *args, tol=1e-10, max_iter=120,
                         value_and_grad_fn=vag)
    inp = hw_sse.prepare(torch.from_numpy(y), m, model_type,
                         None if nv is None else torch.from_numpy(nv))
    stats = {}
    got, evaluations = hw_sse.box_fit_plain(inp, torch.from_numpy(x0),
                                            tol=1e-10, max_iter=120,
                                            stats=stats)
    # the JAX state machine per lane, on float64 passes that agree to 1e-12
    np.testing.assert_array_equal(got.n_iter.numpy(),
                                  np.asarray(want.n_iter))
    np.testing.assert_array_equal(got.converged.numpy(),
                                  np.asarray(want.converged))
    np.testing.assert_allclose(got.x.numpy(), np.asarray(want.x), rtol=0,
                               atol=1e-8)
    np.testing.assert_allclose(got.fun.numpy(), np.asarray(want.fun),
                               rtol=1e-9)
    assert torch.equal(stats["evaluations"], evaluations)
    # an evaluation for the start, then from one to K = 40 trials a call
    assert (evaluations >= 1 + got.n_iter).all()
    assert (evaluations <= 1 + 40 * (stats["calls"] - 1)).all()


def test_box_fit_lanes_are_independent():
    # the property the card's per-lane kernel rests on: a lane's result
    # depends on that lane alone, not on its batch or its place in it
    rng = np.random.default_rng(10)
    S, n, m = 12, 30, 4
    y, nv = _ragged(rng, _panel(rng, S, n, m), m)
    y[:3] += rng.normal(0.0, 15.0, size=(3, n))      # hard, long fits
    inp = hw_sse.prepare(torch.from_numpy(y), m, "multiplicative",
                         torch.from_numpy(nv))
    x0 = torch.from_numpy(rng.uniform(0.0, 1.0, size=(S, 3)))
    kw = dict(tol=1e-10, max_iter=60)
    batch, b_evals = hw_sse.box_fit_plain(inp, x0, **kw)
    assert len(set(batch.n_iter.tolist())) > 2      # lanes of unlike length
    perm = torch.from_numpy(rng.permutation(S))
    permuted, p_evals = hw_sse.box_fit_plain(_lanes(inp, perm), x0[perm],
                                             **kw)
    for got, want in zip((*permuted[:4], p_evals), (*batch[:4], b_evals)):
        assert torch.equal(got, want[perm])
    assert permuted.attempts is None and batch.attempts is None
    for lane in (0, 5):
        alone, a_evals = hw_sse.box_fit_plain(_lanes(inp, [lane]),
                                              x0[lane:lane + 1], **kw)
        for got, want in zip((*alone[:4], a_evals), (*batch[:4], b_evals)):
            assert torch.equal(got[0], want[lane])


def test_box_fit_counts_each_lanes_evaluations():
    # a lane's evaluations in a batch (several trials per call) are the
    # value-and-grad calls the solver makes when it fits that lane alone,
    # one trial per call
    rng = np.random.default_rng(11)
    S, n, m = 8, 24, 4
    y = _panel(rng, S, n, m)
    y[0] += rng.normal(0.0, 10.0, size=n)
    inp = hw_sse.prepare(torch.from_numpy(y), m, "additive")
    x0 = torch.full((S, 3), 0.2, dtype=torch.float64)
    _, evaluations = hw_sse.box_fit_plain(inp, x0, max_iter=40)
    for lane in (0, 3):
        stats = {}
        minimize_box(hw_sse.evaluator(_lanes(inp, [lane]),
                                      hw_sse._packed_plain),
                     x0[lane:lane + 1], 0.0, 1.0, tol=1e-10, max_iter=40,
                     trials_per_call=1, stats=stats)
        assert int(evaluations[lane]) == stats["calls"]
        assert torch.equal(stats["evaluations"],
                           torch.tensor([stats["calls"]], dtype=torch.int32))


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
