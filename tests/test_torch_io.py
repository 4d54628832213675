"""The port's CSV tier against the JAX package's: one file contract on
both codec paths of each package (the C++ codec, built with g++ as the
tests run, and the Python path, which in the port needs no pandas).

Files interchange bit-exactly: a ``data.csv`` + ``timeIndex`` written by
the JAX ``save_csv`` is read by the port to identical float64 bits and
keys, and the port's files are byte-identical to the JAX package's on
the same codec (shortest round-trip decimals natively, ``%.17g`` in
Python).  Quoted keys, NaN and out-of-range tokens, and the corruption
errors follow ``tests/test_io_parallel_utils.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import spark_timeseries_tpu as stt
import spark_timeseries_tpu.native as jnative
from spark_timeseries_tpu import io as jio
from spark_timeseries_tpu_torch import Panel, io
from spark_timeseries_tpu_torch import time as ttime
from spark_timeseries_tpu_torch.utils import metrics

SPECIALS = [5e-324, 1.7976931348623157e308, np.nan, np.inf, -np.inf, -0.0,
            1 / 3, 0.1]


@pytest.fixture(params=["native", "python"])
def codec(request, monkeypatch):
    """Both packages on one codec path: the native codec (built with
    g++) or the Python path."""
    if request.param == "python":
        monkeypatch.setattr(io, "fastcsv", lambda: None)
        monkeypatch.setenv("STS_NO_NATIVE", "1")
    else:
        assert io.fastcsv() is not None, "g++ could not build the codec"
        if jnative.fastcsv() is None:
            pytest.skip("the JAX package's codec did not build")
    return request.param


def _values(seed=0, S=6, n=9):
    rng = np.random.default_rng(seed)
    vals = rng.normal(size=(S, n)).cumsum(axis=1) * 10.0 ** rng.integers(
        -5, 5, size=(S, 1))
    vals[0, :len(SPECIALS)] = SPECIALS
    vals[3, 2] = np.nan
    return vals


def _index(n):
    return ttime.uniform("2020-01-01T00:00-05:00[America/New_York]", n,
                         ttime.BusinessDayFrequency(1), "America/New_York")


def _bits(a):
    return np.asarray(a, np.float64).view(np.int64)


def _read(path, name):
    with open(f"{path}/{name}", "rb") as f:
        return f.read()


def test_csv_round_trip_and_interchange(tmp_path, codec):
    vals = _values()
    keys = ["plain", "a,b", 'quo"te', 'both",and,', "ünï", "k5"]
    tp = Panel(_index(vals.shape[1]), vals, keys, device="cpu")
    jp = stt.Panel(stt.time.from_string(tp.index.to_string()),
                   jnp.asarray(vals), keys)
    metrics.reset()
    io.save_csv(tp, str(tmp_path / "port"))
    jio.save_csv(jp, str(tmp_path / "jax"))
    # the same bytes in both files on the same codec
    for name in (io.CSV_DATA_FILE, io.CSV_INDEX_FILE):
        assert _read(tmp_path / "port", name) == _read(tmp_path / "jax", name)
    back = io.load_csv(str(tmp_path / "jax"), device="cpu")
    jback = jio.load_csv(str(tmp_path / "port"))
    for got in (back.values.numpy(), np.asarray(jback.values)):
        np.testing.assert_array_equal(_bits(got), _bits(vals))
    assert back.keys == keys == jback.keys
    assert back.values.dtype == torch.float64
    assert back.index.to_string() == tp.index.to_string() \
        == jback.index.to_string()
    counters = metrics.snapshot()["counters"]
    assert counters[f"io.csv_codec_{codec}"] == 2
    assert counters["io.csv_series_loaded"] == len(keys)
    # plain keys stay bare (the reference's contract)
    assert _read(tmp_path / "port", io.CSV_DATA_FILE).startswith(b"plain,")


def test_csv_cross_codec_bit_exact(tmp_path, monkeypatch):
    """The native writer's file through the Python reader and the
    reverse, in the port and across the packages."""
    assert io.fastcsv() is not None
    vals = _values(1)
    keys = [f"s{i}" for i in range(vals.shape[0])]
    p = Panel(_index(vals.shape[1]), vals, keys, device="cpu")
    io.save_csv(p, str(tmp_path / "nat"))
    monkeypatch.setattr(io, "fastcsv", lambda: None)
    io.save_csv(p, str(tmp_path / "py"))
    monkeypatch.setenv("STS_NO_NATIVE", "1")
    backs = [io.load_csv(str(tmp_path / "nat"), device="cpu").values,
             jio.load_csv(str(tmp_path / "nat")).values]
    monkeypatch.undo()
    backs += [io.load_csv(str(tmp_path / "py"), device="cpu").values]
    if jnative.fastcsv() is not None:
        backs.append(jio.load_csv(str(tmp_path / "py")).values)
    for back in backs:
        np.testing.assert_array_equal(_bits(back), _bits(vals))


def test_float32_panel_round_trips_exactly(tmp_path, codec):
    vals = _values(2)
    vals[0, :len(SPECIALS)] = [1e-45, 3.4028235e38] + SPECIALS[2:]
    vals = vals.astype(np.float32)
    p = Panel(_index(vals.shape[1]), vals, list("abcdef"), device="cpu")
    assert p.values.dtype == torch.float32
    io.save_csv(p, str(tmp_path / "p"))
    back = io.load_csv(str(tmp_path / "p"), device="cpu")
    # written as the float64 value of each float32, read back as float64
    np.testing.assert_array_equal(_bits(back.values),
                                  _bits(vals.astype(np.float64)))


def test_newline_keys_and_reference_quote_keys(tmp_path, codec):
    idx = _index(4)
    vals = np.arange(16, dtype=np.float64).reshape(4, 4)
    path = str(tmp_path / "p")
    with pytest.raises(ValueError, match="newline"):
        io.save_csv(Panel(idx, vals, ["a\nb", "c", "d", "e"], device="cpu"),
                    path)
    io.save_csv(Panel(idx, vals, list("abcd"), device="cpu"), path)
    # a reference-written file whose raw key starts with a quote
    with open(path + "/data.csv", "w") as f:
        f.write('"rawquote,1.0,2.0,3.0,4.0\n\nb,5,6,7,8\n')
    back = io.load_csv(path, device="cpu")
    jback = jio.load_csv(path)
    assert back.keys == ['"rawquote', "b"] == jback.keys
    np.testing.assert_array_equal(back.values.numpy(),
                                  np.asarray(jback.values))
    # an empty file is an empty panel
    with open(path + "/data.csv", "w") as f:
        f.write("")
    empty = io.load_csv(path, device="cpu")
    assert empty.n_series == 0 and empty.n_obs == 4


def test_load_csv_out_of_range_tokens(tmp_path, codec):
    d = tmp_path / "p"
    d.mkdir()
    (d / "timeIndex").write_text(_index(6).to_string())
    (d / "data.csv").write_text("a,1e400,-1e400,1e-400,-4e-400,NaN,-inf\n")
    got = io.load_csv(str(d), device="cpu").values.numpy()[0]
    want = np.asarray(jio.load_csv(str(d)).values)[0]
    np.testing.assert_array_equal(_bits(got), _bits(want))
    assert got[0] == np.inf and got[1] == -np.inf
    assert got[2] == 0.0 and got[3] == 0.0 and np.signbit(got[3])


@pytest.mark.parametrize("text", ["a,1.0,2.0,3.0\nb,4.0,5.0\n",
                                  "a,1.0,2.0,3.0\nb,4.0,,6.0\n",
                                  "a,1.0,2.0,3.0\nb,4.0,xx,6.0\n",
                                  "a,1.0,2.0,3.0,\n"])
def test_load_csv_rejects_corruption(tmp_path, codec, text):
    d = tmp_path / "p"
    d.mkdir()
    (d / "timeIndex").write_text(_index(3).to_string())
    (d / "data.csv").write_text(text)
    with pytest.raises(ValueError, match="corrupt data.csv"):
        io.load_csv(str(d), device="cpu")
    with pytest.raises(ValueError, match="corrupt data.csv"):
        jio.load_csv(str(d))


def test_parquet_and_yahoo_match_jax(tmp_path):
    vals = _values(3)
    vals[:, 0] = np.nan
    keys = [f"k{i}" for i in range(vals.shape[0])]
    p = Panel(ttime.uniform("2020-01-01T00:00Z", vals.shape[1],
                            ttime.DayFrequency(1)), vals, keys, device="cpu")
    io.save_parquet(p, str(tmp_path / "p.parquet"))
    jback = jio.load_parquet(str(tmp_path / "p.parquet"))
    back = io.load_parquet(str(tmp_path / "p.parquet"), device="cpu")
    for got in (back.values.numpy(), np.asarray(jback.values)):
        np.testing.assert_array_equal(_bits(got), _bits(vals))
    assert back.keys == keys == list(jback.keys)
    assert back.index.to_string() == jback.index.to_string()

    (tmp_path / "y").mkdir()
    (tmp_path / "y" / "A.csv").write_text(
        "Date,Open,Close\n2014-10-23,10.0,11.0\n2014-10-22,8.0,9.0\n")
    (tmp_path / "y" / "B.csv").write_text(
        "Date,Open,Close\n2014-10-24,20.0,21.0\n2014-10-23,18.0,19.0\n")
    got = io.yahoo_files_to_panel(str(tmp_path / "y"), device="cpu")
    want = jio.yahoo_files_to_panel(str(tmp_path / "y"))
    assert got.keys == want.keys
    assert got.index.to_string() == want.index.to_string()
    np.testing.assert_array_equal(got.values.numpy(),
                                  np.asarray(want.values))


def test_save_csv_raises_when_the_native_codec_fails(tmp_path, monkeypatch):
    """A negative count from ``sts_format_csv`` raises: the Python path
    writes only when the codec cannot be built."""
    class Failing:
        @staticmethod
        def sts_format_csv(*args):
            return -1

    monkeypatch.setattr(io, "fastcsv", lambda: Failing)
    p = Panel(_index(4), np.ones((2, 4)), ["a", "b"], device="cpu")
    metrics.reset()
    with pytest.raises(ValueError, match="native CSV codec failed"):
        io.save_csv(p, str(tmp_path / "p"))
    assert not (tmp_path / "p" / io.CSV_DATA_FILE).exists()
    assert "io.csv_codec_python" not in metrics.snapshot()["counters"]


def test_load_csv_needs_cuda_unless_told(tmp_path, monkeypatch):
    p = Panel(_index(4), np.ones((2, 4)), ["a", "b"], device="cpu")
    io.save_csv(p, str(tmp_path / "p"))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        io.load_csv(str(tmp_path / "p"))


def test_metrics_spans_nest_and_counters_reset():
    metrics.reset()
    with metrics.span("outer"):
        with metrics.span("inner"):
            metrics.inc("panel.ingested_series", 3)
        with metrics.span("inner"):
            pass
    metrics.counter("io.csv_series_loaded").inc()
    snap = metrics.snapshot()
    assert snap["counters"] == {"io.csv_series_loaded": 1,
                                "panel.ingested_series": 3}
    assert sorted(snap["spans"]) == ["outer", "outer/inner"]
    assert snap["spans"]["outer/inner"]["count"] == 2
    assert snap["spans"]["outer"]["total_s"] \
        >= snap["spans"]["outer/inner"]["total_s"]
    with pytest.raises(ValueError, match=">= 0"):
        metrics.inc("x", -1)
    metrics.reset()
    assert metrics.snapshot() == {"counters": {}, "gauges": {}, "spans": {}}
