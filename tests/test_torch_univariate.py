"""The port's univariate ops and resampling against the JAX package's, on
the CPU in float64 (JAX with x64, ``tests/conftest.py``).

Fills that only move values (previous, next, nearest, zero, value), the
trims, the index searches, ``downsample`` / ``upsample`` and the
``first`` / ``last`` / ``count`` / ``min`` / ``max`` aggregators are
gathers or selections: exact.  Arithmetic ops are held to 1e-12
relative, float64 up to the order of a sum.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spark_timeseries_tpu.ops import univariate as juni
from spark_timeseries_tpu.time import (DayFrequency, HourFrequency,
                                       irregular, uniform)
from spark_timeseries_tpu_torch import time as ttime
from spark_timeseries_tpu_torch.ops import resample, univariate

# the JAX package's ops/__init__ binds the name ``resample`` to the function
jres = importlib.import_module("spark_timeseries_tpu.ops.resample")

torch.set_num_threads(1)

RTOL = 1e-12


def _gappy(seed=0, S=24, n=40):
    """A float64 panel with interior gaps, late starts, early ends, an
    all-NaN row, a one-observation row and a dense row."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(S, n)).cumsum(axis=1)
    x[rng.random((S, n)) < 0.2] = np.nan
    x[1, :7] = np.nan
    x[2, -5:] = np.nan
    x[3] = np.nan
    x[4] = np.nan
    x[4, 17] = 2.5
    x[5] = rng.normal(size=n)
    x[6, :3] = np.nan
    x[6, 10:20] = np.nan
    return x


def _same(got, want, exact):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    if exact:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=0)


@pytest.mark.parametrize("method", ["previous", "next", "nearest", "zero",
                                    "linear", "spline"])
@pytest.mark.parametrize("shape", [(24, 40), (40,), (2, 3, 40)])
def test_fills_match_jax(method, shape):
    x = _gappy().reshape(-1)[:int(np.prod(shape))].reshape(shape)
    got = univariate.fillts(torch.from_numpy(x), method)
    want = juni.fillts(x if method == "spline" else jnp.asarray(x), method)
    assert isinstance(got, torch.Tensor) and got.dtype == torch.float64
    _same(got, want, exact=method not in ("linear", "spline"))


def test_fill_linear_float32_is_exact_against_jax():
    # one rounding per op in float32 on both sides
    x = _gappy(1).astype(np.float32)
    got = univariate.fill_linear(torch.from_numpy(x))
    want = juni.fill_linear(jnp.asarray(x))
    assert got.dtype == torch.float32
    _same(got, want, exact=True)


def test_fill_value_and_errors():
    x = _gappy(2)
    _same(univariate.fill_value(torch.from_numpy(x), -7.5),
          juni.fill_value(jnp.asarray(x), -7.5), exact=True)
    assert univariate.fill_with_default is univariate.fill_value
    np.testing.assert_array_equal(univariate.fill_spline(x),
                                  juni.fill_spline(x))
    with pytest.raises(ValueError, match="unknown fill method"):
        univariate.fillts(torch.from_numpy(x), "cubic")


def test_nan_positions_and_trims_match_jax():
    x = _gappy(3)
    for fn in ("first_not_nan", "last_not_nan"):
        got = getattr(univariate, fn)(torch.from_numpy(x))
        want = getattr(juni, fn)(jnp.asarray(x))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    for row in (x[1], x[2], x[3], x[4], x[5]):
        for fn in ("trim_leading", "trim_trailing"):
            got = getattr(univariate, fn)(torch.from_numpy(row))
            np.testing.assert_array_equal(got, getattr(juni, fn)(row))


@pytest.mark.parametrize("lag", [1, 3])
def test_ratios_autocorr_rolling_match_jax(lag):
    rng = np.random.default_rng(4)
    x = 50.0 + rng.normal(size=(6, 48)).cumsum(axis=1)
    x[2, 9] = np.nan
    t, j = torch.from_numpy(x), jnp.asarray(x)
    _same(univariate.quotients(t, lag), juni.quotients(j, lag), exact=False)
    _same(univariate.price2ret(t, lag), juni.price2ret(j, lag), exact=False)
    _same(univariate.autocorr(t, 4 + lag), juni.autocorr(j, 4 + lag),
          exact=False)
    for window in (1, 2, 5):
        _same(univariate.roll_sum(t, window), juni.roll_sum(j, window),
              exact=False)
        _same(univariate.roll_mean(t, window), juni.roll_mean(j, window),
              exact=False)


@pytest.mark.parametrize("n,phase,use_zero", [(2, 0, False), (3, 1, True),
                                              (4, 3, False)])
def test_down_and_upsample_match_jax(n, phase, use_zero):
    x = _gappy(5)
    t, j = torch.from_numpy(x), jnp.asarray(x)
    _same(univariate.downsample(t, n, phase), juni.downsample(j, n, phase),
          exact=True)
    _same(univariate.upsample(t, n, phase, use_zero),
          juni.upsample(j, n, phase, use_zero), exact=True)


def _resample_case(seed, irregular_source):
    rng = np.random.default_rng(seed)
    if irregular_source:
        nanos = np.sort(rng.integers(0, 10 * 86400, size=60)) * 10 ** 9 \
            + 1_577_836_800 * 10 ** 9
        src = (irregular(nanos, "Z"), ttime.irregular(nanos, "Z"))
    else:
        src = (uniform("2020-01-01T00:00Z", 60, HourFrequency(4)),
               ttime.uniform("2020-01-01T00:00Z", 60, ttime.HourFrequency(4)))
    # daily stamps from the second day: observations before the first and
    # after the last stamp, and days with no observation
    tgt = (uniform("2020-01-02T00:00Z", 12, DayFrequency(1)),
           ttime.uniform("2020-01-02T00:00Z", 12, ttime.DayFrequency(1)))
    x = rng.normal(size=(5, 60))
    return src, tgt, x


@pytest.mark.parametrize("closed_right,stamp_right",
                         [(False, False), (True, False), (False, True),
                          (True, True)])
@pytest.mark.parametrize("aggr", ["mean", "sum", "min", "max", "first",
                                  "last", "count"])
@pytest.mark.parametrize("nan", ["none", "one_per_bucket"])
def test_resample_matches_jax(aggr, closed_right, stamp_right, nan):
    src, tgt, x = _resample_case(6, irregular_source=aggr in ("mean", "max"))
    bucket = jres.bucket_assignments(src[0].to_nanos_array(),
                                     tgt[0].to_nanos_array(), closed_right,
                                     stamp_right)
    np.testing.assert_array_equal(
        resample.bucket_assignments(src[1].to_nanos_array(),
                                    tgt[1].to_nanos_array(), closed_right,
                                    stamp_right), bucket)
    assert (np.bincount(bucket[bucket >= 0], minlength=12) == 0).any() \
        or aggr not in ("mean", "max")   # empty buckets give NaN
    if nan == "one_per_bucket":
        for b in np.unique(bucket[bucket >= 0]):
            x[b % x.shape[0], np.flatnonzero(bucket == b)[-1]] = np.nan
    got = resample.resample(torch.from_numpy(x), src[1], tgt[1], aggr,
                            closed_right, stamp_right)
    want = jres.resample(jnp.asarray(x), src[0], tgt[0], aggr, closed_right,
                         stamp_right)
    _same(got, want, exact=aggr not in ("mean", "sum"))


def test_resample_callable_and_unknown():
    src, tgt, x = _resample_case(7, irregular_source=True)

    def spread(row, start, end):
        return float(np.nanmax(row[start:end]) - np.nanmin(row[start:end]))

    got = resample.resample(torch.from_numpy(x), src[1], tgt[1], spread)
    want = jres.resample(x, src[0], tgt[0], spread)
    np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError, match="unknown aggregator"):
        resample.resample(torch.from_numpy(x), src[1], tgt[1], "median")
