"""The port's ``ops.decompose`` and ``ops.detect_anomalies`` against the
JAX package's, on the CPU in float64, on the cases of the JAX package's
``tests/test_decompose.py`` and ``tests/test_anomaly.py``: every output
field within 1e-12 of the lane's scale (the same elementwise passes and
medians, sums in other orders; 4e-6 for the integer panel, which both
promote to float32), NaN where the JAX package has NaN, and equal
flags; the spike recovery through an ARIMA fit on each side; the
same errors."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spark_timeseries_tpu import ops as jops
from spark_timeseries_tpu.models import arima as jarima
from spark_timeseries_tpu_torch import ops
from spark_timeseries_tpu_torch.models import arima

TOL = 1e-12
TOL32 = 4e-6      # erfinv and the medians of a float32 panel


def _signal(n, period, amp=5.0, slope=0.3, level=20.0):
    t = np.arange(n, dtype=np.float64)
    figure = amp * np.sin(2 * np.pi * np.arange(period) / period)
    figure -= figure.mean()
    return level + slope * t, figure[t.astype(int) % period]


def _close(got, want, name):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, name
    if want.dtype == bool:
        np.testing.assert_array_equal(got, want, err_msg=name)
        return
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want),
                                  err_msg=name)
    scale = max(1.0, float(np.nanmax(np.abs(want))) if np.isfinite(
        want).any() else 1.0)
    # a float32 panel (promoted integers): a few float32 ulps apart
    tol = TOL if want.dtype == np.float64 else TOL32
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * scale,
                               err_msg=name)


def _decompose_cases():
    trend, seasonal = _signal(120, 12)
    cases = {"additive": (trend + seasonal, 12, "additive")}
    trend, seasonal = _signal(105, 7)
    cases["odd_period"] = (trend + seasonal, 7, "additive")
    trend, _ = _signal(120, 12, amp=0.2, slope=0.05, level=10.0)
    fig = 1.0 + 0.2 * np.sin(2 * np.pi * np.arange(12) / 12)
    cases["multiplicative"] = (trend * fig[np.arange(120) % 12], 12,
                               "multiplicative")
    rng = np.random.default_rng(0)
    cases["batched"] = (rng.normal(size=(5, 96)).cumsum(axis=1) + 50.0, 8,
                        "additive")
    cases["integer"] = (np.arange(48), 12, "additive")
    trend, seasonal = _signal(96, 8)
    x = trend + seasonal
    x[3::8] = np.nan
    y = trend + seasonal
    y[40] = np.nan
    cases["nan_input"] = (np.stack([x, y]), 8, "additive")
    return cases


DECOMPOSE = _decompose_cases()


@pytest.mark.parametrize("name", list(DECOMPOSE))
def test_decompose_matches_jax(name):
    values, period, model = DECOMPOSE[name]
    got = ops.decompose(torch.from_numpy(np.asarray(values)), period, model)
    want = jax.jit(jops.decompose, static_argnums=(1, 2))(
        jnp.asarray(values), period, model)
    assert isinstance(got, ops.Decomposition)
    for field in got._fields:
        _close(getattr(got, field), getattr(want, field), field)


def _anomaly_cases():
    rng = np.random.default_rng(7)
    clean = rng.normal(size=(16, 512))
    y = np.zeros((2, 32))
    y[:, 0] = 100.0
    resid = np.random.default_rng(11).normal(size=(1, 400))
    resid[0, ::20] += 50.0
    counts = np.random.default_rng(13).poisson(20, size=(4, 128)) \
        .astype(np.int32)
    counts[:, 64] += 200
    sparse = np.zeros((2, 100))
    sparse[:, 10:30] = np.random.default_rng(17).poisson(1.0, size=(2, 20))
    sparse[:, 50] = 80.0
    nan_lane = rng.normal(size=(3, 64))
    nan_lane[1] = np.nan
    nan_lane[2, 10:14] = np.nan
    return {
        "gaussian_noise": (clean, np.zeros_like(clean), dict(conf=0.999)),
        "burn_in": (y, np.zeros_like(y), dict(burn_in=4)),
        "constant": (np.full((3, 64), 5.0), np.full((3, 64), 5.0), {}),
        "robust": (resid, np.zeros_like(resid), dict(conf=0.999)),
        "std": (resid, np.zeros_like(resid), dict(conf=0.999,
                                                  robust=False)),
        "integer_counts": (counts, np.full_like(counts, 20),
                           dict(conf=0.999)),
        "sparse_counts": (sparse, np.zeros_like(sparse), dict(conf=0.999)),
        "nan_lanes": (nan_lane, np.zeros_like(nan_lane), dict(burn_in=2)),
    }


ANOMALY = _anomaly_cases()


@pytest.mark.parametrize("name", list(ANOMALY))
def test_detect_anomalies_matches_jax(name):
    values, fitted, kw = ANOMALY[name]
    got = ops.detect_anomalies(torch.from_numpy(values),
                               torch.from_numpy(fitted), **kw)
    want = jax.jit(jops.detect_anomalies,
                   static_argnames=tuple(kw))(values, fitted, **kw)
    assert isinstance(got, ops.AnomalyResult)
    assert got.score.dtype == (torch.float32 if values.dtype == np.int32
                               else torch.float64)
    for field in got._fields:
        _close(getattr(got, field), getattr(want, field), field)


def test_spikes_through_an_arima_fit_and_errors_like_jax():
    """The JAX package's first anomaly case through the port's
    ARIMA(1,0,1) fit, its one-step fitted values taken by each package's
    forecast of the same coefficients: every injected spike flagged, the
    flags equal; and the same ``ValueError`` texts."""
    rng = np.random.default_rng(0)
    e = rng.normal(size=(8, 257))
    clean = 1.0 + e[:, 1:] + 0.3 * e[:, :-1]
    for t in range(1, 256):
        clean[:, t] += 0.5 * (clean[:, t - 1] - 1.0)
    dirty = clean.copy()
    spikes = np.zeros_like(dirty, dtype=bool)
    for i in range(8):
        locs = rng.choice(np.arange(64, 256), size=3, replace=False)
        dirty[i, locs] += rng.choice([-1.0, 1.0], size=3) * 8.0
        spikes[i, locs] = True
    m = arima.fit(1, 0, 1, dirty, warn=False, device="cpu")
    got = ops.detect_anomalies(dirty, m.forecast(dirty, 1)[..., :256],
                               conf=0.999, burn_in=2)
    jm = jarima.ARIMAModel(1, 0, 1, jnp.asarray(m.coefficients.numpy()))
    want = jax.jit(jops.detect_anomalies, static_argnums=(2, 3, 4))(
        dirty, jm.forecast(jnp.asarray(dirty), 1)[..., :256], 0.999, True, 2)
    assert got.is_anomaly.numpy()[spikes].all()
    np.testing.assert_array_equal(got.is_anomaly.numpy(),
                                  np.asarray(want.is_anomaly))
    y = np.zeros((2, 32))
    for kw in (dict(burn_in=32), dict(fitted=np.zeros((2, 33)))):
        fitted = kw.pop("fitted", np.zeros_like(y))
        with pytest.raises(ValueError) as a:
            ops.detect_anomalies(y, fitted, **kw)
        with pytest.raises(ValueError) as b:
            jops.detect_anomalies(y, fitted, **kw)
        assert str(a.value).replace("(2, 32)", "") \
            == str(b.value).replace("(2, 32)", "")
    for args in ((np.ones(10), 12), (np.ones(48), 12, "banana")):
        with pytest.raises(ValueError) as a:
            ops.decompose(*args)
        with pytest.raises(ValueError) as b:
            jops.decompose(*args)
        assert str(a.value) == str(b.value)
