"""The port's metrics plane against the JAX package's.

Counters, gauges and histograms keep the JAX module's semantics (the
sample cap leaves count, sum, min and max exact), reset and the disabled
registry record nothing, spans nest; and the same sequence of ``inc``,
``set_gauge``, ``record`` and ``span`` through a JAX and a port
``MetricsRegistry`` gives equal Prometheus text (span timings are
written as equal values through ``record_span``, since a span's seconds
are the host clock's) and equal snapshot keys and counts.  Fit recording
reads a port model's tensors as the JAX module reads its arrays.
"""

import json

import numpy as np
import pytest
import torch

from spark_timeseries_tpu.utils import metrics as jmetrics
from spark_timeseries_tpu_torch.utils import metrics

torch.set_num_threads(1)


def _drive(mod, reg):
    """One sequence of registry calls, the same through either package."""
    reg.inc("engine.chunks", 3)
    reg.inc("engine.chunks")
    reg.set_gauge("serving.session.s1.tick_p50_ms", 0.25)
    reg.set_gauge("weird-name with spaces!", -1.5)
    for v in (0.1, 0.2, 0.3, 7.0):
        reg.record("telemetry.scrape_s", v)
    reg.histogram("empty.hist")
    rng = np.random.default_rng(0)
    for v in rng.uniform(0, 1, size=50):
        reg.record_span("engine.stream/engine.dispatch", float(v))
    reg.record_span("engine.stream", 2.5)
    with mod.span("outer", registry=reg):
        with mod.span("inner", registry=reg):
            pass


def test_counter_gauge_semantics():
    reg = metrics.MetricsRegistry()
    c = reg.counter("a")
    c.inc()
    c.inc(4)
    assert reg.counter("a") is c and c.value == 5
    with pytest.raises(ValueError):
        c.inc(-1)
    g = reg.gauge("g")
    g.set(3)
    g.set(-2.5)
    assert reg.snapshot()["gauges"]["g"] == -2.5
    assert isinstance(metrics.Gauge().value, float)


def test_histogram_semantics():
    h = metrics.Histogram()
    assert h.stats() == {"count": 0, "sum": 0.0}
    for v in (1.0, 2.0, 3.0, 4.0):
        h.record(v)
    st = h.stats()
    assert (st["count"], st["sum"], st["min"], st["max"]) == (4, 10.0, 1.0,
                                                              4.0)
    assert st["mean"] == 2.5 and st["p50"] == 2.5
    assert h.percentile(100) == 4.0


def test_histogram_sample_cap_keeps_exact_aggregates():
    h = metrics.Histogram(max_samples=8)
    jh = jmetrics.Histogram(max_samples=8)
    vals = np.random.default_rng(1).normal(size=100)
    for v in vals:
        h.record(v)
        jh.record(v)
    count, total, mn, mx, samples = h.raw()
    assert count == 100 and len(samples) == 8
    assert total == pytest.approx(float(np.sum(vals)), abs=1e-12)
    assert (mn, mx) == (float(vals.min()), float(vals.max()))
    # the ring keeps the newest samples in arrival order, as the JAX one
    assert h.raw() == jh.raw()
    assert h.stats() == jh.stats()


def test_reset_and_disabled_registry():
    reg = metrics.MetricsRegistry()
    _drive(metrics, reg)
    reg.reset()
    snap = reg.snapshot()
    assert snap == {"counters": {}, "gauges": {}, "histograms": {},
                    "spans": {}}
    assert reg.to_prometheus() == ""
    reg.enabled = False
    _drive(metrics, reg)
    snap = reg.snapshot()
    assert not snap["counters"] and not snap["gauges"] \
        and not snap["spans"]
    # the accessor still creates a handle; nothing is recorded into it
    assert snap["histograms"] == {"empty.hist": {"count": 0, "sum": 0.0}}


def test_module_level_enabled_switch():
    before = metrics.enabled()
    metrics.set_enabled(False)
    try:
        n0 = len(metrics.trace_events())
        metrics.inc("metrics.test.off")
        metrics.trace_instant("metrics.test.off")
        with metrics.span("metrics.test.off"):
            pass
        assert "metrics.test.off" not in metrics.snapshot()["counters"]
        assert len(metrics.trace_events()) == n0
    finally:
        metrics.set_enabled(before)
    assert metrics.enabled() == before


def test_span_nesting_and_pop_on_exception():
    reg = metrics.MetricsRegistry()
    with metrics.span("a", registry=reg):
        assert metrics.current_span_path() == "a"
        with metrics.span("b", registry=reg):
            assert metrics.current_span_path() == "a/b"
        with metrics.span("b", registry=reg):
            pass
    with pytest.raises(RuntimeError):
        with metrics.span("a", registry=reg):
            raise RuntimeError("boom")
    assert metrics.current_span_path() == ""
    spans = reg.snapshot()["spans"]
    assert spans["a"]["count"] == 2 and spans["a/b"]["count"] == 2
    assert spans["a"]["total_s"] >= spans["a/b"]["total_s"]
    assert set(spans["a"]) == {"count", "total_s", "mean_s", "min_s",
                               "max_s", "p50_s", "p95_s"}


def test_prometheus_text_equals_jax():
    """The same calls give byte-equal exposition text: every timing
    that reaches the text goes through ``record_span`` with equal
    values, except the two ``span`` scopes, whose seconds are
    normalised to the same value in both texts."""
    reg, jreg = metrics.MetricsRegistry(), jmetrics.MetricsRegistry()
    _drive(metrics, reg)
    _drive(jmetrics, jreg)
    for r in (reg, jreg):
        for path in ("outer", "outer/inner"):
            r._spans[path] = type(r._spans[path])(lock=r._lock)
            r._spans[path].record(0.125)
    assert reg.to_prometheus() == jreg.to_prometheus()
    assert reg.to_prometheus(prefix="x") == jreg.to_prometheus(prefix="x")


def test_snapshot_keys_and_counts_equal_jax():
    reg, jreg = metrics.MetricsRegistry(), jmetrics.MetricsRegistry()
    _drive(metrics, reg)
    _drive(jmetrics, jreg)
    snap, jsnap = reg.snapshot(), jreg.snapshot()
    assert snap["counters"] == jsnap["counters"]
    assert snap["gauges"] == jsnap["gauges"]
    assert snap["histograms"] == jsnap["histograms"]
    assert set(snap["spans"]) == set(jsnap["spans"])
    for k, st in snap["spans"].items():
        assert set(st) == set(jsnap["spans"][k])
        assert st["count"] == jsnap["spans"][k]["count"]
    assert json.loads(reg.to_json())["counters"] == snap["counters"]


def test_span_listeners_fire_and_raising_one_is_dropped():
    seen = []

    def good(path, dt):
        seen.append((path, dt >= 0))

    def bad(path, dt):
        raise RuntimeError("listener bug")

    metrics.add_span_listener(good)
    metrics.add_span_listener(good)          # idempotent
    metrics.add_span_listener(bad)
    try:
        with metrics.span("metrics.test.listen"):
            pass
        assert seen == [("metrics.test.listen", True)]
        assert bad not in metrics._span_listeners
    finally:
        metrics.remove_span_listener(good)
        metrics.remove_span_listener(bad)
    assert good not in metrics._span_listeners


def test_fit_recorders_read_tensors_as_jax_reads_arrays():
    """``record_fit`` / ``observe_minimize`` / ``record_fit_report`` over
    the same diagnostics as tensors (port) and arrays (JAX) give equal
    counter bundles and histograms."""
    from spark_timeseries_tpu_torch.models.base import FitDiagnostics

    rng = np.random.default_rng(2)
    conv = rng.uniform(size=32) > 0.3
    n_iter = rng.integers(1, 40, size=32)
    fun = rng.normal(size=32)
    fun[3] = np.inf

    class Model:
        pass

    tm, jm = Model(), Model()
    tm.diagnostics = FitDiagnostics(torch.from_numpy(conv),
                                    torch.from_numpy(n_iter),
                                    torch.from_numpy(fun))
    jm.diagnostics = FitDiagnostics(conv, n_iter, fun)

    class Result:
        def __init__(self, lib):
            self.x = lib(np.zeros((32, 2)))
            self.converged = lib(conv)
            self.n_iter = lib(n_iter)

    report = {"n_series": 32, "n_converged": 20, "n_diverged": 1,
              "iters_mean": 4.5, "frac_converged": 0.625}
    out = []
    for mod, model, lib in ((metrics, tm, torch.from_numpy),
                            (jmetrics, jm, np.asarray)):
        reg = mod.MetricsRegistry()
        mod.record_fit("arima", model, reg)
        res = Result(lib)
        assert mod.observe_minimize("lm", res, reg) is res
        mod.record_fit_report("arima", report, reg)
        out.append(reg.snapshot())
    assert out[0]["counters"] == out[1]["counters"]
    assert out[0]["histograms"] == out[1]["histograms"]
    assert out[0]["counters"]["fit.arima.diverged"] == 1


def test_instrument_fit_and_instrumented_decorators():
    from spark_timeseries_tpu_torch.models import ewma

    calls = []

    @metrics.instrumented("metrics.test.io")
    def io_call(x):
        calls.append(x)
        return x + 1

    assert io_call(1) == 2 and calls == [1]
    fit = metrics.instrument_fit("ewma")(ewma.fit)
    y = torch.from_numpy(
        np.random.default_rng(3).normal(size=(4, 30)).cumsum(1))
    before = metrics.snapshot()["counters"].get("fit.ewma.series", 0)
    fit(y, device="cpu")
    snap = metrics.snapshot()
    assert snap["counters"]["fit.ewma.series"] == before + 4
    assert snap["spans"]["ewma.fit"]["count"] >= 1
    assert snap["spans"]["metrics.test.io"]["count"] >= 1


def test_events_keep_instants_with_args():
    metrics.trace_instant("metrics.test.instant", {"k": 7})
    ev = [e for e in metrics.events()
          if e["name"] == "metrics.test.instant"][-1]
    assert ev["kind"] == "instant" and ev["args"] == {"k": 7}
    assert {"ts", "tid", "tname"} <= set(ev)
