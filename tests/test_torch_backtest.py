"""The port's rolling-origin planner and evaluator (``backtest.grid``,
``backtest.evaluate``) against the JAX package's, on the CPU in float64:
``plan_origins`` and ``CandidateGrid`` (their errors included), and
``evaluate_candidate`` (forecasts, half-widths, σ², every metric table
and score) for ARIMA at d = 0 and 1, AR with NaN-masked lanes and EWMA,
by the pinned-gain replay and by the sequential refilter oracle, each
JAX evaluation computed once per module; and the port's log-depth
training prefix against its step loop.

Tolerance: 1e-9 relative (1e-12 absolute) on every array: the same
filter recursions in float64, the pinned-gain path and the metric sums
in other association orders."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spark_timeseries_tpu.backtest import evaluate as jevaluate
from spark_timeseries_tpu.backtest import grid as jgrid
from spark_timeseries_tpu.models.arima import ARIMAModel as JARIMAModel
from spark_timeseries_tpu.models.autoregression import ARModel as JARModel
from spark_timeseries_tpu.models.ewma import EWMAModel as JEWMAModel
from spark_timeseries_tpu_torch.backtest import evaluate, grid
from spark_timeseries_tpu_torch.models.arima import ARIMAModel
from spark_timeseries_tpu_torch.models.autoregression import ARModel
from spark_timeseries_tpu_torch.models.ewma import EWMAModel

pytestmark = pytest.mark.backtest

S, N = 4, 600


def _arma_panel(S, n, phi, theta, c=2.0, seed=1, burn=128):
    r = np.random.default_rng(seed)
    e = r.standard_normal((S, n + burn))
    y = np.zeros((S, n + burn))
    for t in range(1, n + burn):
        y[:, t] = c + sum(p * y[:, t - 1 - i] for i, p in enumerate(phi)) \
            + e[:, t] + sum(q * e[:, t - 1 - i] for i, q in enumerate(theta))
    return y[:, burn:]


Y0 = _arma_panel(S, N, (0.6, -0.2), (0.4,), seed=7)
Y1 = np.cumsum(_arma_panel(S, N, (0.5,), (0.3,), seed=9), axis=1)
YNAN = Y0.copy()
YNAN[1, 410] = YNAN[1, 455] = np.nan     # missing actuals in the eval region
YNAN[2, :9] = np.nan                     # a ragged lane: leading padding
COEF = {"d0": np.tile([0.8, 0.6, -0.2, 0.4], (S, 1)),
        "d1": np.tile([0.01, 0.5, 0.3], (S, 1))}


def _models(case):
    """(panel, port model, JAX model, horizons) of one case."""
    if case == "d0":
        c = COEF["d0"]
        return Y0, ARIMAModel(2, 0, 1, torch.from_numpy(c)), \
            JARIMAModel(2, 0, 1, jnp.asarray(c)), (1, 3, 6)
    if case == "d1":
        c = COEF["d1"]
        return Y1, ARIMAModel(1, 1, 1, torch.from_numpy(c)), \
            JARIMAModel(1, 1, 1, jnp.asarray(c)), (1, 6)
    if case == "ar_nan":
        c, phi = np.full(S, 1.2), np.full((S, 1), 0.6)
        return YNAN, ARModel(torch.from_numpy(c), torch.from_numpy(phi)), \
            JARModel(jnp.asarray(c), jnp.asarray(phi)), (1, 4)
    a = np.full(S, 0.4)
    return Y1, EWMAModel(torch.from_numpy(a)), \
        JEWMAModel(jnp.asarray(a)), (2, 5)


CASES = [("d0", "pinned"), ("d0", "refilter"), ("d1", "pinned"),
         ("d1", "refilter"), ("ar_nan", "pinned"), ("ewma", "pinned")]


def _schedule(m):
    return m.plan_origins(N, 6, n_origins=8, stride=12, min_train=400)


@pytest.fixture(scope="module")
def jax_evals():
    out = {}
    for case, replay in CASES:
        y, _, jm, hs = _models(case)
        out[case, replay] = jevaluate.evaluate_candidate(
            y, jm, _schedule(jgrid), hs, replay=replay, coverage=0.8,
            mase_m=1 if case != "ewma" else 3)
    return out


@pytest.mark.parametrize("case,replay", CASES)
def test_evaluate_candidate_matches_jax(jax_evals, case, replay):
    y, m, _, hs = _models(case)
    got = evaluate.evaluate_candidate(y, m, _schedule(grid), hs,
                                      replay=replay, coverage=0.8,
                                      mase_m=1 if case != "ewma" else 3,
                                      device="cpu")
    want = jax_evals[case, replay]
    assert got._fields == want._fields
    for name in got._fields:
        g, w = getattr(got, name), np.asarray(getattr(want, name))
        assert g.shape == w.shape, name
        np.testing.assert_allclose(g, w, rtol=1e-9, atol=1e-12,
                                   err_msg=name)
    if case == "ar_nan":
        assert np.isnan(got.forecasts).sum() == 0
        assert np.isfinite(got.score_mase).all()


@pytest.mark.parametrize("args,kw", [
    ((512, 8), dict(n_origins=6)),
    ((512, 4), dict(n_origins=8, stride=16, min_train=300,
                    mode="sliding", window=200)),
    ((100, 4), dict(n_origins=1)),
    ((768, 4), dict(n_origins=128, stride=2, min_train=512)),
    ((768, 4), dict(n_origins=40, min_train=700)),
    ((1000, 1), dict(n_origins=3, mode="sliding")),
])
def test_plan_origins_matches_jax(args, kw):
    got = grid.plan_origins(*args, **kw)
    want = jgrid.plan_origins(*args, **kw)
    assert got._fields == want._fields
    np.testing.assert_array_equal(got.origins, want.origins)
    assert got.origins.dtype == np.int64
    assert got[1:] == want[1:]
    assert got.fit_window() == want.fit_window()
    assert got.describe() == want.describe()
    assert got.n_origins == want.n_origins


def test_plan_origins_and_grid_raise_like_jax():
    bad_plans = [((64, 60), {}), ((512, 0), {}), ((512, 4), dict(stride=0)),
                 ((512, 4), dict(mode="sliding", window=1)),
                 ((512, 4), dict(mode="jackknife")),
                 ((512, 4), dict(n_origins=0))]
    for args, kw in bad_plans:
        with pytest.raises(ValueError) as got:
            grid.plan_origins(*args, **kw)
        with pytest.raises(ValueError) as want:
            jgrid.plan_origins(*args, **kw)
        assert str(got.value) == str(want.value)
    bad_grids = [({"garch": [()]}, {}), ({"ar": [1, (1,)]}, {}),
                 ({"arima": [(0, 0, 0)]}, {}), ({"arima": [(1, 0)]}, {}),
                 ({}, {}), ({"ar": []}, {}), ({"ar": [-1]}, {}),
                 ({"ar": [1]}, dict(horizons=(0,)))]
    for fam, kw in bad_grids:
        with pytest.raises(ValueError) as got:
            grid.CandidateGrid(fam, **kw)
        with pytest.raises(ValueError) as want:
            jgrid.CandidateGrid(fam, **kw)
        assert str(got.value) == str(want.value)


def test_candidate_grid_matches_jax():
    fams = {"ar": [1, (2,)], "arima": [(1, 0, 1), (0, 1, 1)], "ewma": True}
    got = grid.CandidateGrid(fams, horizons=(4, 1, 1))
    want = jgrid.CandidateGrid(fams, horizons=(4, 1, 1))
    assert [tuple(c) for c in got] == [tuple(c) for c in want]
    assert [c.label for c in got] == [c.label for c in want]
    assert [c.slug for c in got] == [c.slug for c in want]
    assert got.horizons == want.horizons and got.horizon == want.horizon
    assert got.min_train_floor() == want.min_train_floor()
    assert got.describe() == want.describe() and repr(got) == repr(want)
    assert len(grid.default_grid()) == len(jgrid.default_grid()) == 5
    assert grid.default_grid().describe() == jgrid.default_grid().describe()
    for c in got:
        spec, jspec = grid.FAMILIES[c.family], jgrid.FAMILIES[c.family]
        for f in ("row_width", "n_params", "d_of", "min_train_floor",
                  "stream_kwargs"):
            assert getattr(spec, f)(c.order) == getattr(jspec, f)(c.order)
        # rows round-trip through the batched model on the device
        rows = np.random.default_rng(0).normal(
            size=(3, spec.row_width(c.order)))
        m = spec.rebuild(c.order, rows, torch.device("cpu"))
        np.testing.assert_array_equal(spec.rows_of(m), rows)


def test_evaluate_rejects_like_jax():
    y, m, jm, _ = _models("d0")
    sched = _schedule(grid)
    for kw, match in ((dict(replay="approximate"), "replay"),
                      (dict(mase_m=0), "mase_m")):
        with pytest.raises(ValueError, match=match):
            evaluate.evaluate_candidate(y, m, sched, (1,), device="cpu",
                                        **kw)
        with pytest.raises(ValueError, match=match):
            jevaluate.evaluate_candidate(y, jm, _schedule(jgrid), (1,),
                                         **kw)
    with pytest.raises(ValueError, match="n_series"):
        evaluate.evaluate_candidate(y[0], m, sched, (1,), device="cpu")
    with pytest.raises(ValueError, match="horizons"):
        evaluate.evaluate_candidate(y, m, sched, (9,), device="cpu")
    with pytest.raises(TypeError, match="state-space"):
        evaluate.evaluate_candidate(y, object(), sched, (1,), device="cpu")


def test_long_training_prefix_runs_in_log_depth(monkeypatch):
    """Past ``SEQUENTIAL_PREFIX_MAX`` steps a fully observed prefix runs
    at the pinned gain in logarithmic depth (exact mode after 512
    sequential steps, innovations mode from the start): the same
    forecasts and σ² as the step loop to rounding; a gappy prefix keeps
    the loop."""
    sched = grid.plan_origins(N, 6, n_origins=4, stride=20, min_train=560)
    for y, m, hs in ((Y0, _models("d0")[1], (1, 6)),
                     (Y1, _models("ewma")[1], (2,))):
        loop = evaluate.evaluate_candidate(y, m, sched, hs, device="cpu")
        monkeypatch.setattr(evaluate, "SEQUENTIAL_PREFIX_MAX", 100)
        fast = evaluate.evaluate_candidate(y, m, sched, hs, device="cpu")
        monkeypatch.undo()
        np.testing.assert_allclose(fast.forecasts, loop.forecasts,
                                   rtol=1e-9, atol=1e-9)
        np.testing.assert_allclose(fast.sigma2, loop.sigma2, rtol=1e-9)
    monkeypatch.setattr(evaluate, "SEQUENTIAL_PREFIX_MAX", 100)
    gappy = evaluate.evaluate_candidate(YNAN, _models("ar_nan")[1], sched,
                                        (1,), device="cpu")
    monkeypatch.undo()
    want = evaluate.evaluate_candidate(YNAN, _models("ar_nan")[1], sched,
                                       (1,), device="cpu")
    np.testing.assert_array_equal(gappy.forecasts, want.forecasts)
