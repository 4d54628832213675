"""The port's serving health and quality planes (``statespace.health``,
``statespace.quality``, ``backtest.evaluate.masked_pointwise``) against
the JAX package's, on the CPU in float64.

One ARIMA(2,1,2)+c and one additive Holt-Winters (period 4) state-space
form, bootstrapped by both packages from the same 16 × 40 history, tick
through 48 steps with NaN ticks, inf ticks and a poisoned lane (its state
mean set to 1e30 before the first tick).  Floats agree within 1e-10
relative (the same float64 arithmetic in another order), statuses and
integer fields exactly.  The JAX functions run jitted with their static
arguments, each compiled once per module."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spark_timeseries_tpu.backtest import evaluate as j_eval
from spark_timeseries_tpu.models import arima as j_arima
from spark_timeseries_tpu.models import holt_winters as j_hw
from spark_timeseries_tpu.statespace import convert as j_conv
from spark_timeseries_tpu.statespace import health as j_health
from spark_timeseries_tpu.statespace import quality as j_quality
from spark_timeseries_tpu.statespace import serving as j_serving
from spark_timeseries_tpu_torch.backtest import evaluate
from spark_timeseries_tpu_torch.models import convert as mconv
from spark_timeseries_tpu_torch.statespace import convert, health, quality
from spark_timeseries_tpu_torch.statespace import serving

pytestmark = pytest.mark.serving

torch.set_num_threads(1)

RTOL = 1e-10
S, N_HIST, N_LIVE = 16, 40, 48
POISONED = 3
PERIOD = 4
HORIZON = {"arima": 3, "holt_winters": 1}


def _close(got, want, rtol=RTOL):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.dtype.kind == want.dtype.kind, (got.dtype, want.dtype)
    if got.dtype.kind in "biu":
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=rtol, atol=0.0)


def _close_tree(got, want, rtol=RTOL):
    assert got._fields == want._fields
    for g, w in zip(got, want):
        _close(g, w, rtol)


def _panel(family):
    """History and live ticks: integrated AR(2) walks (ARIMA) or
    seasonal levels (Holt-Winters); the live ticks carry NaN and inf
    at fixed places."""
    rng = np.random.default_rng(7 if family == "arima" else 8)
    n = N_HIST + N_LIVE
    e = rng.normal(size=(S, n + 16))
    y = np.zeros_like(e)
    for t in range(2, n + 16):
        y[:, t] = 0.2 + 0.5 * y[:, t - 1] - 0.2 * y[:, t - 2] + e[:, t]
    y = y[:, 16:]
    if family == "arima":
        y = np.cumsum(y, axis=1)
    else:
        season = np.sin(2 * np.pi * np.arange(n) / PERIOD)
        y = 10.0 + 0.05 * np.arange(n) + 2.0 * season + 0.3 * y
    live = y[:, N_HIST:].copy()
    live[1, 5] = np.nan
    live[2, 10:13] = np.nan
    live[5, 20] = np.inf
    live[6, 30] = -np.inf
    live[:4, 40] = np.nan
    return y[:, :N_HIST], live


def _models(family):
    rng = np.random.default_rng(11)
    if family == "arima":
        coefs = np.column_stack([
            rng.uniform(-0.1, 0.1, S), rng.uniform(0.2, 0.5, S),
            rng.uniform(-0.3, 0.0, S), rng.uniform(-0.4, 0.4, S),
            rng.uniform(-0.2, 0.2, S)])
        return (j_arima.ARIMAModel(2, 1, 2, jnp.asarray(coefs), True),
                mconv.arima_from_numpy(2, 1, 2, coefs, device="cpu"))
    a, b, g = (rng.uniform(0.1, 0.6, S) for _ in range(3))
    b = b * 0.2
    return (j_hw.HoltWintersModel("additive", PERIOD, jnp.asarray(a),
                                  jnp.asarray(b), jnp.asarray(g)),
            mconv.holt_winters_from_numpy("additive", PERIOD, a, b, g,
                                          device="cpu"))


@functools.lru_cache(maxsize=None)
def _case(family):
    """Both packages' bootstrapped forms, the poisoned lane set."""
    hist, live = _panel(family)
    j_model, t_model = _models(family)
    jb = j_conv.bootstrap(j_model, jnp.asarray(hist))
    tb = convert.bootstrap(t_model, torch.from_numpy(hist))
    j_state = jb.state._replace(a=jb.state.a.at[POISONED].set(1e30))
    t_a = tb.state.a.clone()
    t_a[POISONED] = 1e30
    t_state = tb.state._replace(a=t_a)
    return hist, live, (jb.ssm, jb.meta, j_state), (tb.ssm, tb.meta, t_state)


_j_step = jax.jit(j_health.monitored_step, static_argnums=(5, 6))
_j_qstep = jax.jit(j_quality.quality_step, static_argnums=(0, 1))
_j_panel = jax.jit(j_health.monitor_panel, static_argnums=(4, 5))
_j_qpanel = jax.jit(j_quality.quality_panel, static_argnums=(5, 6, 7))
_j_forecast = jax.jit(j_serving._forecast_impl, static_argnums=(0, 1, 2))


def _policies(joseph):
    return (j_health.HealthPolicy(joseph=joseph),
            health.HealthPolicy(joseph=joseph))


def _quality_states(family, j_ssm, j_meta, t_ssm, t_meta, hist):
    pol = quality.QualityPolicy(horizon=HORIZON[family])
    j_pol = j_quality.QualityPolicy(horizon=HORIZON[family])
    scale = quality.naive_scale(hist)
    j_half = j_quality.forecast_half_widths(j_ssm, j_meta, pol.horizon,
                                            pol.coverage)
    t_half = quality.forecast_half_widths(t_ssm, t_meta, pol.horizon,
                                          pol.coverage)
    jq = j_quality.initial_quality(S, j_pol, jnp.float64, scale, j_half)
    tq = quality.initial_quality(S, pol, torch.float64, scale, t_half)
    return j_pol, pol, jq, tq


@pytest.mark.parametrize("family", ["arima", "holt_winters"])
@pytest.mark.parametrize("joseph", [True, False])
def test_monitored_step_matches_jax(family, joseph):
    """Step by step: v, F, every state and health field, the statuses
    (the poisoned lane and the lanes fed inf quarantine; NaN ticks
    hold) and the shed priority of each tick's statuses."""
    hist, live, (j_ssm, j_meta, j_st), (t_ssm, t_meta, t_st) = _case(family)
    j_pol, t_pol = _policies(joseph)
    j_h, t_h = j_health.initial_health(j_st), health.initial_health(t_st)
    off = np.zeros(S)
    for t in range(N_LIVE):
        j_st, j_h, (j_v, j_f) = _j_step(j_ssm, j_st, j_h,
                                        jnp.asarray(live[:, t]),
                                        jnp.asarray(off), j_meta, j_pol)
        t_st, t_h, (t_v, t_f) = health.monitored_step(
            t_ssm, t_st, t_h, torch.from_numpy(live[:, t]),
            torch.from_numpy(off), t_meta, t_pol)
        _close(t_v, j_v)
        _close(t_f, j_f)
        _close(t_h.status, j_h.status)
        assert health.shed_priority(t_h.status) \
            == j_health.shed_priority(np.asarray(j_h.status))
    _close_tree(t_st, j_st)
    _close_tree(t_h, j_h)
    status = t_h.status.numpy()
    assert status[POISONED] == health.LANE_DIVERGED
    assert (status[[0, 1, 2]] != health.LANE_DIVERGED).all()


@pytest.mark.parametrize("family", ["arima", "holt_winters"])
def test_monitor_panel_matches_jax(family):
    """The whole tick panel at once (the JAX package's scan, the port's
    loop), and its shape check."""
    hist, live, (j_ssm, j_meta, j_st), (t_ssm, t_meta, t_st) = _case(family)
    j_pol, t_pol = _policies(True)
    offs = np.full(live.shape, 0.25)
    j_out = _j_panel(j_ssm, j_st, j_health.initial_health(j_st),
                     jnp.asarray(live), j_meta, j_pol, jnp.asarray(offs))
    t_out = health.monitor_panel(t_ssm, t_st, health.initial_health(t_st),
                                 torch.from_numpy(live), t_meta, t_pol,
                                 torch.from_numpy(offs))
    _close_tree(t_out[0], j_out[0])
    _close_tree(t_out[1], j_out[1])
    with pytest.raises(ValueError, match="bucketed lanes"):
        health.monitor_panel(t_ssm, t_st, health.initial_health(t_st),
                             torch.from_numpy(live.T), t_meta, t_pol)


@pytest.mark.parametrize("family", ["arima", "holt_winters"])
def test_quality_step_matches_jax(family):
    """The monitored step then the quality step, tick by tick: the
    forecast ring, EW sMAPE / MASE / coverage, Page-Hinkley and the
    drifted overlay (a small ``ph_lambda`` so that lanes alarm)."""
    hist, live, (j_ssm, j_meta, j_st), (t_ssm, t_meta, t_st) = _case(family)
    j_pol, t_pol = _policies(True)
    j_qp, t_qp, jq, tq = _quality_states(family, j_ssm, j_meta, t_ssm,
                                         t_meta, hist)
    j_qp = j_qp._replace(ph_lambda=2.0)
    t_qp = t_qp._replace(ph_lambda=2.0)
    j_h, t_h = j_health.initial_health(j_st), health.initial_health(t_st)
    off = np.zeros(S)
    drifted = 0
    for t in range(N_LIVE):
        y_j, y_t = jnp.asarray(live[:, t]), torch.from_numpy(live[:, t])
        j_st, j_h, (j_v, j_f) = _j_step(j_ssm, j_st, j_h, y_j,
                                        jnp.asarray(off), j_meta, j_pol)
        t_st, t_h, (t_v, t_f) = health.monitored_step(
            t_ssm, t_st, t_h, y_t, torch.from_numpy(off), t_meta, t_pol)
        j_h, jq = _j_qstep(j_qp, j_meta, j_ssm, j_st, j_h, jq, y_j,
                           jnp.asarray(off), j_v, j_f)
        t_h, tq = quality.quality_step(t_qp, t_meta, t_ssm, t_st, t_h, tq,
                                       y_t, torch.from_numpy(off), t_v, t_f)
        _close_tree(tq, jq)
        _close(t_h.status, j_h.status)
        drifted = max(drifted, int((t_h.status == health.LANE_DRIFTED).sum()))
    assert drifted > 0
    assert int(tq.n_scored.sum()) > 0


@pytest.mark.parametrize("family", ["arima", "holt_winters"])
def test_quality_panel_matches_jax(family):
    hist, live, (j_ssm, j_meta, j_st), (t_ssm, t_meta, t_st) = _case(family)
    j_pol, t_pol = _policies(False)
    j_qp, t_qp, jq, tq = _quality_states(family, j_ssm, j_meta, t_ssm,
                                         t_meta, hist)
    j_out = _j_qpanel(j_ssm, j_st, j_health.initial_health(j_st), jq,
                      jnp.asarray(live), j_meta, j_pol, j_qp)
    t_out = quality.quality_panel(t_ssm, t_st, health.initial_health(t_st),
                                  tq, torch.from_numpy(live), t_meta, t_pol,
                                  t_qp)
    for got, want in zip(t_out, j_out):
        _close_tree(got, want)
    with pytest.raises(ValueError, match="bucketed lanes"):
        quality.quality_panel(t_ssm, t_st, health.initial_health(t_st), tq,
                              torch.from_numpy(live[:3]), t_meta, t_pol,
                              t_qp)


@pytest.mark.parametrize("family", ["arima", "holt_winters"])
@pytest.mark.parametrize("forecast_policy", ["nan", "last_good"])
def test_quarantined_forecast_policy_matches_jax(family, forecast_policy):
    """After the poisoned lane quarantines: forecasts off the state, NaN
    or from the last good state on the quarantined lane."""
    hist, live, (j_ssm, j_meta, j_st), (t_ssm, t_meta, t_st) = _case(family)
    j_pol = j_health.HealthPolicy(forecast_policy=forecast_policy)
    t_pol = health.HealthPolicy(forecast_policy=forecast_policy)
    j_st, j_h = _j_panel(j_ssm, j_st, j_health.initial_health(j_st),
                         jnp.asarray(live[:, :8]), j_meta, j_pol)
    t_st, t_h = health.monitor_panel(
        t_ssm, t_st, health.initial_health(t_st), torch.from_numpy(
            live[:, :8]), t_meta, t_pol)
    offs = np.linspace(0.0, 1.0, S * 6).reshape(S, 6)
    want = _j_forecast(j_meta, 6, j_pol, j_ssm, j_st, j_h, jnp.asarray(offs))
    got = serving._forecast_impl(t_meta, 6, t_pol, t_ssm, t_st, t_h,
                                 torch.from_numpy(offs))
    _close(got, want)
    assert np.isnan(got[POISONED].numpy()).all() \
        == (forecast_policy == "nan")


@pytest.mark.parametrize("family", ["arima", "holt_winters"])
def test_baselines_match_jax(family):
    """``naive_scale`` (with NaN pairs and a too-short window) and
    ``forecast_half_widths`` at horizons 1 and 4 and two levels."""
    hist, live, (j_ssm, j_meta, _), (t_ssm, t_meta, _) = _case(family)
    gappy = hist.copy()
    gappy[0, ::3] = np.nan
    gappy[1] = np.nan
    _close(quality.naive_scale(gappy), j_quality.naive_scale(gappy))
    _close(quality.naive_scale(torch.from_numpy(gappy[:, :1])),
           j_quality.naive_scale(gappy[:, :1]))
    for h, conf in ((1, 0.9), (4, 0.8)):
        _close(quality.forecast_half_widths(t_ssm, t_meta, h, conf),
               j_quality.forecast_half_widths(j_ssm, j_meta, h, conf))


def test_masked_pointwise_matches_jax():
    rng = np.random.default_rng(3)
    fc = rng.normal(size=(6, 5))
    act = rng.normal(size=(6, 5))
    fc[0, 0], act[1, 1], act[2, 2] = np.nan, np.inf, np.nan
    fc[3, 3] = act[3, 3] = 0.0
    got = evaluate.masked_pointwise(torch.from_numpy(fc),
                                    torch.from_numpy(act))
    want = j_eval.masked_pointwise(jnp.asarray(fc), jnp.asarray(act))
    for g, w in zip(got, want):
        _close(g, w)
    assert float(got[2][3, 3]) == 0.0


def test_policies_validate_like_jax():
    for bad in (dict(ew_alpha=0.0), dict(suspect_hi=5.0, diverged_hi=4.0),
                dict(forecast_policy="banana")):
        with pytest.raises(ValueError):
            health.HealthPolicy(**bad).validate()
        with pytest.raises(ValueError):
            j_health.HealthPolicy(**bad).validate()
    for bad in (dict(horizon=0), dict(ew_alpha=2.0), dict(ph_delta=0.0),
                dict(coverage=1.0)):
        with pytest.raises(ValueError):
            quality.QualityPolicy(**bad).validate()
    assert quality.QualityPolicy(horizon=2.0).validate().horizon == 2
    assert health.LANE_NAMES == j_health.LANE_NAMES
