"""The engine's compile tier against the JAX engine's, on the CPU.

``FitEngine.warmup`` gives the JAX engine's ``built`` list and report
keys for the same arguments; ``cache_stats`` after warm-up, fits and
streams counts the JAX engine's hits and misses in the same sequence;
``bucket=False`` keys shapes as the stream does; an unknown family
raises.  ``configure_compile_cache`` is a no-op without a path and with
one points the kernel build directory and sets the gauge; the CLI's JSON
has the JAX CLI's keys (``kernels`` for ``jax``) and exits 2 on bad
shapes or families as the JAX CLI does; and a fit after a warm-up is
bitwise a fit without one.
"""

import contextlib
import io
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from spark_timeseries_tpu import engine as jengine
from spark_timeseries_tpu.utils import metrics as jmetrics
from spark_timeseries_tpu_torch import _build, engine
from spark_timeseries_tpu_torch.utils import metrics

torch.set_num_threads(1)


def _panel(n_series, n_obs, seed):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(n_series, n_obs)).cumsum(axis=1)


def _sequence(pkg, eng):
    """Warm-up, fits and streams in one order through either engine:
    each step's report or ``cache_stats()``."""
    kw = {} if pkg is jengine else {"device": "cpu"}
    out = []
    out.append(eng.warmup(("ar", "ewma"), [(12, 40), (16, 64)],
                          dtype=np.float64, **kw))
    out.append(eng.warmup(("ar",), [(16, 40)], dtype=np.float64,
                          bucket=False, max_lag=2, **kw))
    out.append(eng.warmup(("arima",), [(16, 64)], dtype=np.float64,
                          variants=("dense",), **kw))
    eng.fit(_panel(16, 64, 1), "ar", **kw)              # warmed: a hit
    eng.fit(_panel(10, 50, 2), "ar", **kw)              # ragged (16, 64)
    eng.fit(_panel(16, 64, 3), "arima", p=1, d=1, q=1, **kw)   # new statics
    eng.fit(_panel(16, 64, 4), "arima", **kw)           # warmed: a hit
    eng.fit(_panel(16, 50, 5), "ewma", **kw)            # no ragged path
    out.append(eng.cache_stats())
    # full chunks at (16, 40) were warmed with bucket=False; the tail of
    # 8 is its own bucket
    eng.stream_fit(_panel(40, 40, 6), "ar", chunk_size=16, max_lag=2, **kw)
    gappy = _panel(32, 40, 7)
    gappy[::3, 30:] = np.nan
    eng.stream_fit(gappy, "ar", chunk_size=16, max_lag=2, **kw)
    out.append(eng.cache_stats())
    return out


@pytest.fixture(scope="module")
def both():
    res = {}
    for name, pkg, mod in (("jax", jengine, jmetrics),
                           ("torch", engine, metrics)):
        reg = mod.MetricsRegistry()
        res[name] = _sequence(pkg, pkg.FitEngine(registry=reg))
    return res


@pytest.mark.parametrize("step", range(3))
def test_warmup_report_equals_jax(both, step):
    got, want = both["torch"][step], both["jax"][step]
    assert got["built"] == want["built"]
    assert set(got) == set(want)
    assert got["platform"] == want["platform"] == "cpu"
    assert {k: got[k] for k in ("executables", "cache_hits",
                                "cache_misses")} == \
        {k: want[k] for k in ("executables", "cache_hits", "cache_misses")}


@pytest.mark.parametrize("step", [3, 4])
def test_cache_stats_after_fits_and_streams_equal_jax(both, step):
    assert both["torch"][step] == both["jax"][step]


def test_bucket_false_keys_shapes_as_the_stream_does():
    reg = metrics.MetricsRegistry()
    eng = engine.FitEngine(registry=reg)
    rep = eng.warmup(("ar",), [(16, 40)], bucket=False, max_lag=2,
                     dtype=torch.float64, device="cpu")
    assert rep["built"] == [{"family": "ar", "bucket": [16, 40],
                             "variant": v} for v in ("dense", "ragged")]
    eng.stream_fit(_panel(32, 40, 0), "ar", chunk_size=16, max_lag=2,
                   device="cpu")
    assert eng.cache_stats() == {"executables": 2, "cache_hits": 2,
                                 "cache_misses": 2}
    assert reg.snapshot()["gauges"]["engine.executables"] == 2
    with pytest.raises(ValueError, match="unknown engine family"):
        eng.warmup(("nope",), [(8, 32)], device="cpu")


def test_warmed_fit_is_bitwise_an_unwarmed_fit():
    y = _panel(16, 64, 9)
    cold = engine.FitEngine().fit(y, "arima", device="cpu")
    eng = engine.FitEngine()
    eng.warmup(("arima",), [(16, 64)], dtype=torch.float64, device="cpu")
    warm = eng.fit(y, "arima", device="cpu")
    assert torch.equal(warm.coefficients, cold.coefficients)
    assert torch.equal(warm.diagnostics.n_iter, cold.diagnostics.n_iter)
    s_cold = engine.FitEngine().stream_fit(y, "arima", chunk_size=8,
                                           collect=True, device="cpu")
    s_warm = eng.stream_fit(y, "arima", chunk_size=8, collect=True,
                            device="cpu")
    for a, b in zip(s_warm.models, s_cold.models):
        assert torch.equal(a.coefficients, b.coefficients)


@pytest.fixture
def build_dir(monkeypatch):
    """The module build directory and cache state, restored after."""
    monkeypatch.setattr(_build, "BUILD_DIR", _build.BUILD_DIR)
    monkeypatch.setattr(engine, "_cache_state", {"dir": None})
    monkeypatch.delenv("STS_COMPILE_CACHE", raising=False)
    return _build.BUILD_DIR


def test_configure_compile_cache(build_dir, tmp_path, monkeypatch):
    assert engine.configure_compile_cache() is None
    assert _build.BUILD_DIR == build_dir
    d = str(tmp_path / "kernels")
    assert engine.configure_compile_cache(d) == d
    assert engine.configure_compile_cache(d) == d            # idempotent
    assert _build.BUILD_DIR == Path(d).resolve()
    assert metrics.snapshot()["gauges"]["engine.compile_cache_enabled"] \
        == 1.0
    # the environment's directory, through a new engine and the default
    d2 = str(tmp_path / "env")
    monkeypatch.setenv("STS_COMPILE_CACHE", d2)
    engine.FitEngine()
    assert _build.BUILD_DIR == Path(d2).resolve()
    monkeypatch.setattr(engine, "_default_engine", None)
    d3 = str(tmp_path / "default")
    monkeypatch.setenv("STS_COMPILE_CACHE", d3)
    engine.default_engine()
    assert _build.BUILD_DIR == Path(d3).resolve()
    # a CUDA library already loaded pins the directory
    monkeypatch.setitem(_build._libs, "arma_ne", object())
    with pytest.raises(RuntimeError, match="already loaded"):
        engine.configure_compile_cache(str(tmp_path / "late"))


def _cli(main, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(argv)
    return rc, buf.getvalue()


def test_cli_report_keys_and_exit_codes(both, build_dir, tmp_path):
    d = str(tmp_path / "cli")
    rc, out = _cli(engine.main, ["--families", "arima,holt_winters",
                                 "--shapes", "8x48", "--serving",
                                 "--device", "cpu", "--cache-dir", d])
    rep = json.loads(out)
    assert rc == 0
    # the JAX CLI's report: the warm-up report, "serving", "jax"
    want = set(both["jax"][0]) | {"serving", "jax"}
    assert set(rep) == want - {"jax"} | {"kernels"}
    assert [r["family"] for r in rep["serving"]] == ["arima",
                                                     "holt_winters"]
    assert rep["kernels"]["build_dir"] == str(Path(d).resolve())
    assert rep["kernels"]["builds"] == 0          # no card, no nvcc
    for argv in (["--shapes", "0x3"], ["--shapes", "axb"],
                 ["--families", "nope"]):
        codes = []
        for main in (engine.main, jengine.main):
            with pytest.raises(SystemExit) as e, \
                    contextlib.redirect_stderr(io.StringIO()):
                main(argv + ["--device", "cpu"] if main is engine.main
                     else argv)
            codes.append(e.value.code)
        assert codes == [2, 2]
