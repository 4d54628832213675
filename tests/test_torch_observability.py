"""The port's observability and plotting helpers against the JAX
package's.

``timed``, ``timed_min`` and ``fit_report`` give the JAX helpers' results
for models carried across from the JAX package (``models.convert``, with
their diagnostics); ``trace`` and ``profile`` are ``torch.profiler``
scopes and traces; ``calc_conf_val`` equals the JAX one; and the plots
draw the JAX plots' arrays under matplotlib's Agg backend.
"""

import io
import json
import logging
import os

import jax.numpy as jnp
import matplotlib
import numpy as np
import pytest
import torch

from spark_timeseries_tpu.models import arima as j_arima
from spark_timeseries_tpu.models import holt_winters as j_hw
from spark_timeseries_tpu.models.base import FitDiagnostics as JDiag
from spark_timeseries_tpu.utils import metrics as jmetrics
from spark_timeseries_tpu.utils import observability as jobs
from spark_timeseries_tpu.utils import plot as jplot
from spark_timeseries_tpu_torch.models import convert
from spark_timeseries_tpu_torch.utils import metrics, observability, plot

torch.set_num_threads(1)

matplotlib.use("Agg")

S, N = 6, 60


def _series(seed=0):
    rng = np.random.default_rng(seed)
    e = rng.normal(size=(S, N + 8))
    y = np.zeros_like(e)
    for t in range(2, e.shape[1]):
        y[:, t] = 0.2 + 0.5 * y[:, t - 1] + e[:, t] + 0.3 * e[:, t - 1]
    return np.cumsum(y[:, 8:], axis=1)


def _diag(seed):
    rng = np.random.default_rng(seed)
    conv = rng.uniform(size=S) > 0.25
    n_iter = rng.integers(2, 30, size=S).astype(np.int32)
    fun = rng.normal(size=S)
    fun[1] = np.nan
    return conv, n_iter, fun


@pytest.fixture(scope="module")
def models():
    """An ARIMA(1,1,1) and an additive Holt-Winters model with
    diagnostics, built in the JAX package and carried across."""
    rng = np.random.default_rng(4)
    c = np.column_stack([rng.uniform(-0.1, 0.1, S), rng.uniform(0.2, 0.5, S),
                         rng.uniform(-0.3, 0.3, S)])
    d1, d2 = _diag(1), _diag(2)
    ja = j_arima.ARIMAModel(1, 1, 1, jnp.asarray(c), True,
                            JDiag(*map(jnp.asarray, d1)))
    ta = convert.arima_from_numpy(1, 1, 1, c, diagnostics=d1, device="cpu")
    a, b, g = (rng.uniform(0.1, 0.5, S) for _ in range(3))
    jh = j_hw.HoltWintersModel("additive", 4, jnp.asarray(a),
                               jnp.asarray(b), jnp.asarray(g),
                               JDiag(*map(jnp.asarray, d2)))
    th = convert.holt_winters_from_numpy("additive", 4, a, b, g,
                                         diagnostics=d2, device="cpu")
    return {"arima": (ja, ta), "holt_winters": (jh, th)}


@pytest.mark.parametrize("family", ["arima", "holt_winters"])
def test_fit_report_equals_jax(models, family):
    jm, tm = models[family]
    jreg = jmetrics.get_registry()
    treg = metrics.get_registry()
    before = (dict(jreg.snapshot()["counters"]),
              dict(treg.snapshot()["counters"]))
    want, got = jobs.fit_report(jm), observability.fit_report(tm)
    assert got == want
    after = (jreg.snapshot()["counters"], treg.snapshot()["counters"])
    deltas = [{k: v - b.get(k, 0) for k, v in a.items()
               if k.startswith(f"fit_report.{family}.")}
              for b, a in zip(before, after)]
    assert deltas[1] == deltas[0] and deltas[1]
    with pytest.raises(TypeError):
        observability.fit_report(object())


def test_timed_and_timed_min_as_jax(models):
    y = _series()
    jm, tm = models["arima"]
    ty = torch.from_numpy(y)
    res = observability.timed(tm.forecast, ty, 5, warmup=1, iters=2)
    jres = jobs.timed(jm.forecast, jnp.asarray(y), 5, warmup=1, iters=2)
    assert set(res) == set(jres) == {"mean_s", "min_s", "result"}
    np.testing.assert_allclose(res["result"].numpy(),
                               np.asarray(jres["result"]), rtol=1e-10)
    assert 0 <= res["min_s"] <= res["mean_s"]
    best, out = observability.timed_min(tm.forecast_interval, ty, 4,
                                        reps=2, want_out=True)
    jbest, jout = jobs.timed_min(jm.forecast_interval, jnp.asarray(y), 4,
                                 reps=2, want_out=True)
    assert isinstance(best, float) and best >= 0
    assert type(out) is type(jout) and len(out) == len(jout) == 3
    for a, b in zip(out, jout):
        assert isinstance(a, np.ndarray)
        np.testing.assert_allclose(a, b, rtol=1e-10)
    assert isinstance(observability.timed_min(tm.forecast, ty, 2), float)


def test_trace_profile_and_logging(tmp_path):
    with observability.profile(str(tmp_path / "prof")) as prof:
        with observability.trace("observability.test.scope"):
            torch.ones(8).sum()
    names = {e.name for e in prof.events()}
    assert "observability.test.scope" in names
    (trace_file,) = os.listdir(tmp_path / "prof")
    with open(tmp_path / "prof" / trace_file) as f:
        doc = json.load(f)
    assert any(e.get("name") == "observability.test.scope"
               for e in doc["traceEvents"])
    buf = io.StringIO()
    try:
        h1 = observability.configure_logging("INFO", stream=buf)
        h2 = observability.configure_logging(logging.INFO, stream=buf)
        lg = logging.getLogger("spark_timeseries_tpu_torch")
        assert h1 not in lg.handlers and h2 in lg.handlers
        assert not lg.propagate
        lg.info("observability.test line")
        assert buf.getvalue().count("observability.test line") == 1
    finally:
        lg.removeHandler(observability._configured_handler)
        observability._configured_handler = None
        lg.propagate = True


@pytest.mark.parametrize("conf,n", [(0.95, 100), (0.99, 17), (0.5, 3)])
def test_calc_conf_val_equals_jax(conf, n):
    assert plot.calc_conf_val(conf, n) == jplot.calc_conf_val(conf, n)


def _drawn(fig):
    """The arrays a figure drew: each line's x and y, each filled
    region's vertices."""
    ax = fig.axes[0]
    lines = [(np.asarray(ln.get_xdata(), float),
              np.asarray(ln.get_ydata(), float)) for ln in ax.get_lines()]
    fills = [np.asarray(c.get_paths()[0].vertices, float)
             for c in ax.collections]
    return lines, fills


def _same_drawing(fig, jfig, rtol=1e-10):
    (lines, fills), (jlines, jfills) = _drawn(fig), _drawn(jfig)
    assert len(lines) == len(jlines) and len(fills) == len(jfills)
    for (x, y), (jx, jy) in zip(lines, jlines):
        np.testing.assert_array_equal(x, jx)
        np.testing.assert_allclose(y, jy, rtol=rtol, atol=1e-12)
    for v, jv in zip(fills, jfills):
        np.testing.assert_allclose(v, jv, rtol=rtol, atol=1e-12)


def test_forecast_plot_draws_the_jax_arrays(models):
    import matplotlib.pyplot as plt

    y = _series(1)[2]
    jm, tm = models["arima"]
    one = convert.arima_from_numpy(1, 1, 1,
                                   tm.coefficients[2].numpy(), device="cpu")
    jone = j_arima.ARIMAModel(1, 1, 1, jm.coefficients[2], True)
    fig = plot.forecast_plot(y, one, 6, conf=0.9)
    jfig = jplot.forecast_plot(y, jone, 6, conf=0.9)
    _same_drawing(fig, jfig)
    with pytest.raises(ValueError, match="one series"):
        plot.forecast_plot(_series(1), one, 3)
    plt.close("all")


def test_acf_pacf_and_ezplot_draw_the_jax_arrays():
    import matplotlib.pyplot as plt

    y = _series(2)[0]
    _same_drawing(plot.acf_plot(y, 8), jplot.acf_plot(y, 8))
    _same_drawing(plot.pacf_plot(y, 4), jplot.pacf_plot(y, 4), rtol=1e-8)
    _same_drawing(plot.ezplot(_series(3)[:2]), jplot.ezplot(_series(3)[:2]))
    plt.close("all")
