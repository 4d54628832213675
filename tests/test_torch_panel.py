"""The port's ``Panel`` against the JAX package's, on the CPU in float64
(JAX with x64, ``tests/conftest.py``; the port with ``device="cpu"``).

Both panels are built from one seed: the JAX panel from numpy, the
port's from the JAX panel's index string, values and keys
(:func:`panel_from_numpy`).  Every ported method is held against its JAX
twin: values within 1e-12 relative (float64 up to the order of a sum;
exact where the method is a gather), index ``to_string()`` and keys
equal.  Then the slice as a whole: CSV, ``Panel``, ``fill("linear")``
and the fits, with the fits' coefficients within 1e-6 (the tolerance of
the ARIMA parity tests: both run the same float64 LM, which stops at a
relative SSE change of 1e-10) and equal orders.
"""

import datetime as dt

import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

import spark_timeseries_tpu as stt
from spark_timeseries_tpu import io as jio
from spark_timeseries_tpu import time as jtime
from spark_timeseries_tpu_torch import Panel, io, panel_from_numpy
from spark_timeseries_tpu_torch import time as ttime
from spark_timeseries_tpu_torch.panel import lagged_string_key
from spark_timeseries_tpu_torch.utils import metrics

torch.set_num_threads(1)

RTOL = 1e-12


def _pair(values, keys=None, index=None):
    """The JAX panel and the port's, from one numpy panel."""
    values = np.asarray(values, dtype=np.float64)
    if keys is None:
        keys = [f"s{i}" for i in range(values.shape[0])]
    if index is None:
        index = jtime.uniform("2020-01-06T00:00Z", values.shape[1],
                              jtime.BusinessDayFrequency(1))
    jp = stt.Panel(index, jnp.asarray(values), keys)
    tp = panel_from_numpy(jp.index.to_string(), np.asarray(jp.values),
                          jp.keys, device="cpu")
    return jp, tp


def _same(tp, jp, exact=False):
    """Index string, keys and values of two panels agree."""
    assert tp.index.to_string() == jp.index.to_string()
    assert list(tp.keys) == list(jp.keys)
    got, want = tp.values.numpy(), np.asarray(jp.values)
    assert tp.values.dtype == torch.float64
    assert got.shape == want.shape
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    if exact:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=0)


def _gappy(seed=0, S=12, n=30):
    rng = np.random.default_rng(seed)
    x = 50.0 + rng.normal(size=(S, n)).cumsum(axis=1)
    x[rng.random((S, n)) < 0.1] = np.nan
    x[1, :4] = np.nan
    x[-1, -3:] = np.nan
    return x


def test_introspection_and_lookup():
    jp, tp = _pair(_gappy(), keys=[f"k{i % 10}" for i in range(12)])
    assert (tp.n_series, tp.n_obs, len(tp)) == (jp.n_series, jp.n_obs,
                                               len(jp))
    assert tp.device == torch.device("cpu")
    for (tk, tv), (jk, jv) in zip(tp, jp):
        assert tk == jk
        np.testing.assert_array_equal(tv, jv)
    assert tp.head()[0] == jp.head()[0]
    np.testing.assert_array_equal(tp.head()[1], jp.head()[1])
    np.testing.assert_array_equal(tp.find_series("k3"), jp.find_series("k3"))
    np.testing.assert_array_equal(tp.to_time_major().numpy(),
                                  np.asarray(jp.to_time_major()))
    np.testing.assert_array_equal(tp.to_row_matrix().numpy(),
                                  np.asarray(jp.to_indexed_row_matrix()))
    # a repeated key resolves to its first occurrence, as in JAX
    _same(tp.select(["k7", "k1", "k0"]), jp.select(["k7", "k1", "k0"]),
          exact=True)
    with pytest.raises(ValueError, match="not in the panel keys"):
        tp.select(["nope"])
    _same(tp.filter_keys(lambda k: k in ("k2", "k5")),
          jp.filter_keys(lambda k: k in ("k2", "k5")), exact=True)
    _same(tp.filter_start_with("k1"), jp.filter_start_with("k1"), exact=True)
    _same(tp.filter_end_with("3"), jp.filter_end_with("3"), exact=True)
    series = np.arange(30.0)
    _same(tp.add_series("new", series), jp.add_series("new", series),
          exact=True)
    _same(tp.union(tp), jp.union(jp), exact=True)
    with pytest.raises(ValueError, match="identical index lengths"):
        tp.union(tp.islice(0, 5))


def test_slicing_and_transforms():
    jp, tp = _pair(_gappy(1))
    _same(tp.islice(3, 17), jp.islice(3, 17), exact=True)
    lo, hi = dt.datetime(2020, 1, 8, tzinfo=dt.timezone.utc), \
        dt.datetime(2020, 1, 20, 12, tzinfo=dt.timezone.utc)
    _same(tp.slice(lo, hi), jp.slice(lo, hi), exact=True)
    _same(tp.map_values(lambda v: v * 2.0 - 1.0),
          jp.map_values(lambda v: v * 2.0 - 1.0))
    _same(tp.map_series(lambda s: s - s[0]),
          jp.map_series(lambda s: s - s[0]))
    _same(tp.map_series(lambda s: s[1:] * s[:-1], tp.index.islice(1, 30)),
          jp.map_series(lambda s: s[1:] * s[:-1], jp.index.islice(1, 30)))
    with pytest.raises(ValueError, match="index size"):
        tp.map_series(lambda s: s[1:])
    for method in ("linear", "nearest", "next", "previous", "spline",
                   "zero"):
        _same(tp.fill(method), jp.fill(method),
              exact=method not in ("linear", "spline"))
    for lag in (1, 3):
        _same(tp.differences(lag), jp.differences(lag))
        _same(tp.quotients(lag), jp.quotients(lag))
    _same(tp.price2ret(), jp.price2ret())
    _same(tp.return_rates(), jp.return_rates())
    for window in (1, 4):
        _same(tp.roll_sum(window), jp.roll_sum(window))
        _same(tp.roll_mean(window), jp.roll_mean(window))


@pytest.mark.parametrize("zone", ["Z", "America/New_York"])
def test_differences_by_frequency(zone):
    # an hourly panel across the US spring DST change, differenced by day
    idx = jtime.uniform("2021-03-12T00:00Z", 96, jtime.HourFrequency(1), zone)
    jp, tp = _pair(_gappy(2, S=5, n=96), index=idx)
    for freq in ("DayFrequency", "HourFrequency"):
        _same(tp.differences_by_frequency(getattr(ttime, freq)(1)),
              jp.differences_by_frequency(getattr(jtime, freq)(1)))


def test_lags():
    jp, tp = _pair(_gappy(3, S=4, n=20))
    for max_lag, include in ((1, False), (3, True)):
        _same(tp.lags(max_lag, include), jp.lags(max_lag, include),
              exact=True)
    _same(tp.lags(2, True, lagged_string_key),
          jp.lags(2, True, stt.panel.lagged_string_key), exact=True)
    spec = {"s0": (True, 2), "s1": (False, 1), "s2": (False, 3),
            "s3": (True, 0)}
    _same(tp.lags_per_key(spec), jp.lags_per_key(spec), exact=True)
    irregular = _pair(_gappy(3, S=2, n=3),
                      index=jtime.irregular([1, 5, 9], "Z"))[1]
    with pytest.raises(ValueError, match="UniformDateTimeIndex"):
        irregular.lags(1, False)


def test_instant_filters_resample_and_rebase():
    x = _gappy(4, S=6, n=40)
    x[:, 7] = np.nan
    jp, tp = _pair(x)
    _same(tp.filter_by_instant(lambda v: v > 52.0),
          jp.filter_by_instant(lambda v: v > 52.0), exact=True)
    _same(tp.filter_by_instant(lambda v: v < 48.0, ["s1", "s4"]),
          jp.filter_by_instant(lambda v: v < 48.0, ["s1", "s4"]), exact=True)
    _same(tp.remove_instants_with_nans(), jp.remove_instants_with_nans(),
          exact=True)
    weekly = (jtime.uniform("2020-01-06T00:00Z", 8, jtime.DayFrequency(7)),
              ttime.uniform("2020-01-06T00:00Z", 8, ttime.DayFrequency(7)))
    for aggr in ("mean", "sum", "min", "max", "first", "last", "count"):
        for closed_right, stamp_right in ((False, False), (True, True)):
            _same(tp.resample(weekly[1], aggr, closed_right, stamp_right),
                  jp.resample(weekly[0], aggr, closed_right, stamp_right),
                  exact=aggr not in ("mean", "sum"))
    daily = (jtime.uniform("2020-01-01T00:00Z", 70, jtime.DayFrequency(1)),
             ttime.uniform("2020-01-01T00:00Z", 70, ttime.DayFrequency(1)))
    _same(tp.with_index(daily[1]), jp.with_index(daily[0]), exact=True)
    _same(tp.with_index(daily[1], -1.0), jp.with_index(daily[0], -1.0),
          exact=True)


def test_stats_and_bridges():
    x = _gappy(5, S=5, n=12)
    x[3] = np.nan
    jp, tp = _pair(x)
    got, want = tp.series_stats(), jp.series_stats()
    assert sorted(got) == sorted(want)
    for k in got:
        np.testing.assert_allclose(got[k], want[k], rtol=RTOL, atol=0)
    for (td, tv), (jd, jv) in zip(tp.to_instants(), jp.to_instants()):
        assert td == jd
        np.testing.assert_array_equal(tv, jv)
    pd.testing.assert_frame_equal(tp.to_instants_dataframe(),
                                  jp.to_instants_dataframe())
    pd.testing.assert_frame_equal(tp.to_observations_dataframe(),
                                  jp.to_observations_dataframe())
    pd.testing.assert_frame_equal(tp.to_pandas(), jp.to_pandas())
    metrics.reset()
    keys, host = tp.collect()
    assert keys == jp.collect()[0]
    np.testing.assert_array_equal(host, np.asarray(jp.values))
    assert metrics.snapshot()["counters"]["panel.d2h_bytes"] == host.nbytes


def test_constructors():
    rng = np.random.default_rng(6)
    target = (jtime.uniform("2020-01-01T00:00Z", 10, jtime.DayFrequency(1)),
              ttime.uniform("2020-01-01T00:00Z", 10, ttime.DayFrequency(1)))
    stamps = np.sort(rng.choice(14, size=8, replace=False)) * 86_400 \
        * 10 ** 9 + 1_577_750_400 * 10 ** 9
    triples = [("a", stamps, rng.normal(size=8)),
               ("b", stamps[2:], rng.normal(size=6))]
    _same(Panel.from_series([(k, ttime.irregular(s, "Z"), v)
                             for k, s, v in triples], target[1],
                            device="cpu"),
          stt.Panel.from_series([(k, jtime.irregular(s, "Z"), v)
                                 for k, s, v in triples], target[0]),
          exact=True)
    df = pd.DataFrame({
        "timestamp": pd.to_datetime(stamps[rng.integers(0, 8, 20)], utc=True),
        "key": rng.choice(["x", "y", "z"], 20),
        "value": rng.normal(size=20)}).drop_duplicates(["timestamp", "key"])
    _same(Panel.from_observations(df, target[1], device="cpu"),
          stt.Panel.from_observations(df, target[0]), exact=True)
    jp, tp = _pair(_gappy(7, S=3, n=10))
    wide = jp.to_pandas()
    _same(Panel.from_pandas(wide, device="cpu"), stt.Panel.from_pandas(wide),
          exact=True)
    with pytest.raises(ValueError, match="observations"):
        Panel(target[1], np.zeros((2, 9)), ["a", "b"], device="cpu")
    with pytest.raises(ValueError, match="keys"):
        Panel(target[1], np.zeros((2, 10)), ["a"], device="cpu")


def test_device_policy_and_waiting_methods(monkeypatch, tmp_path):
    jp, tp = _pair(_gappy(8, S=2, n=6))
    assert Panel(tp.index, tp.values.float(), tp.keys,
                 device="cpu").values.dtype == torch.float32
    for call, item in ((lambda: tp.shard(None), "5"),
                       (lambda: tp.describe_costs(), "5")):
        with pytest.raises(NotImplementedError, match=f"item {item}"):
            call()
    # the backtest's journal is the engine's durability tier now: it
    # passes through, and this 6-step panel fails the schedule's own check
    with pytest.raises(ValueError, match="cannot place any origin"):
        tp.backtest(journal=str(tmp_path / "j"))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Panel(tp.index, np.zeros((2, 6)), ["a", "b"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Panel.from_pandas(jp.to_pandas())


def test_panel_owns_an_array_it_is_given():
    """An array is copied, as the JAX Panel's ``jnp.asarray`` puts it in
    a device buffer of its own: changing the caller's array later leaves
    the panel as it was.  (JAX's CPU backend may alias an aligned numpy
    buffer instead, so the JAX panel is not held to this here.)"""
    vals = _gappy(9, S=3, n=6)
    before = vals.copy()
    index = ttime.uniform("2020-01-01T00:00Z", 6, ttime.DayFrequency(1))
    tp = Panel(index, vals, ["a", "b", "c"], device="cpu")
    vals[:] = 7.0
    np.testing.assert_array_equal(tp.values.numpy(), before)


# ---------------------------------------------------------------------------
# the slice as a whole
# ---------------------------------------------------------------------------


def _arima_panel(rng, S, n):
    e = rng.normal(size=(S, n + 16))
    y = np.zeros_like(e)
    for t in range(2, e.shape[1]):
        y[:, t] = 1.0 + 0.25 * y[:, t - 1] + 0.35 * y[:, t - 2] + e[:, t] \
            + 0.3 * e[:, t - 1] + 0.1 * e[:, t - 2]
    return np.cumsum(y[:, 16:], axis=1)


def _with_gaps(rng, y):
    """``chip_smoke.py``'s gap recipe: 1 % of each series' observations
    knocked out inside its window, 5 % of the series starting 1-16 steps
    late."""
    y = y.copy()
    S, n = y.shape
    late = rng.random(S) < 0.05
    start = np.where(late, rng.integers(1, 17, S), 0)
    y[np.arange(n)[None, :] < start[:, None]] = np.nan
    inner = (rng.random((S, n)) < 0.01) \
        & (np.arange(n)[None, :] > start[:, None]) \
        & (np.arange(n)[None, :] < n - 1)
    y[inner] = np.nan
    return y


def _csv_pair(tmp_path, values):
    """Write the JAX panel with the JAX ``save_csv``; each package loads
    the file."""
    index = jtime.uniform("2021-01-04T00:00Z", values.shape[1],
                          jtime.BusinessDayFrequency(1))
    keys = [f"series-{i}" for i in range(values.shape[0])]
    jio.save_csv(stt.Panel(index, jnp.asarray(values), keys),
                 str(tmp_path / "panel"))
    jp = jio.load_csv(str(tmp_path / "panel"))
    tp = io.load_csv(str(tmp_path / "panel"), device="cpu")
    _same(tp, jp, exact=True)
    return jp, tp


def _coefs(models):
    return np.concatenate([np.asarray(m.coefficients) for m in models])


def test_slice_csv_fill_stream_fit_arima_matches_jax(tmp_path):
    rng = np.random.default_rng(10)
    y = _with_gaps(rng, _arima_panel(rng, 256, 64))
    jp, tp = _csv_pair(tmp_path, y)
    jf, tf = jp.fill("linear"), tp.fill("linear")
    _same(tf, jf)
    kw = dict(chunk_size=128, collect=True, p=2, d=1, q=2)
    got = tf.stream_fit("arima", **kw)
    want = jf.stream_fit("arima", **kw)
    assert not got.chunk_failures and not want.chunk_failures
    assert (got.n_series, got.n_fitted, got.n_chunks, got.n_converged) \
        == (want.n_series, want.n_fitted, want.n_chunks, want.n_converged)
    assert got.stats["input_d2h_s"] >= 0.0
    conv = np.concatenate([m.diagnostics.converged.numpy()
                           for m in got.models])
    np.testing.assert_array_equal(conv, np.concatenate(
        [np.asarray(m.diagnostics.converged) for m in want.models]))
    np.testing.assert_allclose(_coefs(got.models), _coefs(want.models),
                               rtol=0, atol=1e-6)
    # the filled panel still has late starts: some lanes fit ragged
    assert np.isnan(tf.values.numpy()[:, 0]).any()
    # without the fill, the interior gaps are a data failure in both
    assert tp.stream_fit("arima", **kw).chunk_failures[0]["kind"] \
        == jp.stream_fit("arima", **kw).chunk_failures[0]["kind"] == "data"


def test_slice_auto_fit_matches_jax(tmp_path):
    rng = np.random.default_rng(11)
    y = _with_gaps(rng, _arima_panel(rng, 64, 80))
    jp, tp = _csv_pair(tmp_path, y)
    jf, tf = jp.fill("linear"), tp.fill("linear")
    stats = {}
    got = tf.auto_fit(max_p=2, max_q=2, stats=stats)
    want = jf.auto_fit(max_p=2, max_q=2)
    assert stats["lm_fit_launches"] == 0        # no kernel on the CPU
    np.testing.assert_array_equal(got.orders, np.asarray(want.orders))
    np.testing.assert_allclose(got.coefficients,
                               np.asarray(want.coefficients), rtol=0,
                               atol=1e-6)
    np.testing.assert_allclose(got.aic, np.asarray(want.aic), rtol=1e-6)


def test_slice_stream_fit_holt_winters_matches_jax(tmp_path, monkeypatch):
    monkeypatch.setenv("STS_HW_FUSED", "1")     # the JAX fit's fused pass
    rng = np.random.default_rng(12)
    t = np.arange(48)
    y = 100.0 + 0.5 * t + 10.0 * np.sin(2 * np.pi * t / 12) \
        + rng.normal(0.0, 2.0, size=(64, 48))
    inner = rng.random(y.shape) < 0.01
    inner[:, [0, -1]] = False
    y[inner] = np.nan
    jp, tp = _csv_pair(tmp_path, y)
    jf, tf = jp.fill("linear"), tp.fill("linear")
    kw = dict(chunk_size=32, collect=True, period=12)
    got = tf.stream_fit("holt_winters", **kw)
    want = jf.stream_fit("holt_winters", **kw)
    assert not got.chunk_failures
    assert (got.n_fitted, got.n_chunks, got.n_converged) \
        == (want.n_fitted, want.n_chunks, want.n_converged)
    for g, w in zip(got.models, want.models):
        conv = g.diagnostics.converged.numpy()
        np.testing.assert_array_equal(conv,
                                      np.asarray(w.diagnostics.converged))
        for name in ("alpha", "beta", "gamma"):
            np.testing.assert_allclose(getattr(g, name).numpy()[conv],
                                       np.asarray(getattr(w, name))[conv],
                                       rtol=0, atol=1e-6)
