"""The port's online serving tier (``statespace.serving``) against the JAX
package's, on the CPU in float64: ticks, ``update_batch``, forecasts,
counters, the quality plane, checkpoints and faults (a JAX session's
blob, ``warmup_update`` and the accounting are in
``test_torch_serving_session.py``).

For each serving family (ARIMA(2,1,2)+c, AR(2), ARX with per-tick
offsets, EWMA, additive Holt-Winters) one model, built in the JAX
package and carried across with ``models.convert``, starts a session in
both packages on the same 16 × 64 history (``torch_serving_cases``).
Floats agree within 1e-10 relative (the same float64 arithmetic in
another order), statuses and counters exactly, ``update_batch`` and a
checkpoint round trip bit for bit.  The ticked sessions are built once
per family, so that the JAX package traces each session's tick once."""

import functools

import numpy as np
import pytest
import torch

from spark_timeseries_tpu.statespace import serving as j_ss
from spark_timeseries_tpu.utils import resilience as j_res
from spark_timeseries_tpu_torch.models import arima as t_arima
from spark_timeseries_tpu_torch.statespace import health, quality, serving
from spark_timeseries_tpu_torch.utils import resilience
from torch_serving_cases import (K, N_HIST, FAMILIES, S, bitwise, close,
                                 models, snapshot_counters, start, tick_offs)

pytestmark = pytest.mark.serving

torch.set_num_threads(1)


@functools.lru_cache(maxsize=None)
def _ticked(family):
    """Both sessions after K ticks, their results, and a second port
    session fed the same ticks through ``update_batch``."""
    js, ts, y, offs = start(family)
    js.warmup()
    ts.warmup()
    outs = []
    for t in range(K):
        o = tick_offs(offs, t)
        outs.append((js.update(y[:, N_HIST + t], o),
                     ts.update(y[:, N_HIST + t], o)))
    _, batch, _, _ = start(family)
    live = y[:, N_HIST:N_HIST + K]
    last = batch.update_batch(
        live, None if offs is None else offs[:, N_HIST:N_HIST + K])
    return js, ts, batch, last, outs, y, offs


@pytest.mark.parametrize("family", FAMILIES)
def test_ticks_forecast_and_counters_match_jax(family):
    js, ts, batch, last, outs, y, offs = _ticked(family)
    assert ts.describe() == js.describe()
    assert ts.update_key[:2] == js.update_key[:2]
    for j_out, t_out in outs:
        for g, w in zip(t_out, j_out):
            close(g, w)
        assert t_out.status.dtype == np.int32
    # update_batch is bitwise the k single updates
    bitwise(last, outs[-1][1])
    for a, b in zip(batch._state, ts._state):
        bitwise([a.numpy()], [b.numpy()])
    np.testing.assert_array_equal(batch._ring_history(), ts._ring_history())
    fo = None if offs is None else offs[:, :5]
    close(ts.forecast(5, fo), js.forecast(5, fo))
    close(ts.loglik, js.loglik)
    assert ts.health_counts() == js.health_counts()
    assert snapshot_counters(ts._reg) == snapshot_counters(js._reg)
    assert ts.state_bytes == js.state_bytes
    assert ts.tick_latency_stats()["window"] == K


def test_quality_session_matches_jax():
    """Quality armed (horizon 2): every TickResult field, the EW online
    metrics and the quality summary."""
    js, ts, y, _ = start(
        "arima", quality=(j_ss.QualityPolicy(horizon=2),
                          quality.QualityPolicy(horizon=2)))
    for t in range(2 * K):
        j_out = js.update(y[:, N_HIST + t])
        t_out = ts.update(y[:, N_HIST + t])
        for g, w in zip(t_out, j_out):
            close(g, w)
    for g, w in zip(ts._qstate, js._qstate):
        close(g.numpy(), w)
    assert ts.quality_summary() == js.quality_summary()
    assert ts.update_key[2:] != serving.ServingSession.start(
        models("arima")[1], y[:, :N_HIST], device="cpu").update_key[2:]


def test_checkpoint_round_trip_is_bitwise(tmp_path):
    js, ts, y, _ = start("arima", quality=(j_ss.QualityPolicy(),
                                            quality.QualityPolicy()))
    with resilience.fault_injection("state_poison", lane_stride=3):
        ts.update(y[:, N_HIST])
    path = str(tmp_path / "s.ckpt")
    ts.checkpoint(path)
    back = serving.ServingSession.restore(path, device="cpu")
    assert back.describe() == ts.describe()
    np.testing.assert_array_equal(back.lane_status, ts.lane_status)
    np.testing.assert_array_equal(back._ring_history(), ts._ring_history())
    for t in range(1, 3):
        bitwise(back.update(y[:, N_HIST + t]), ts.update(y[:, N_HIST + t]))
    bitwise(back.forecast(4)[None], ts.forecast(4)[None])
    for a, b in zip((*back._state, *back._qstate),
                    (*ts._state, *ts._qstate)):
        bitwise([a.numpy()], [b.numpy()])


def test_tick_validation_and_serving_faults_match_jax():
    """Wrong tick counts and panel shapes raise; the three serving faults
    act as in the JAX package (state_poison once per scope)."""
    js, ts, y, _ = start("ar")
    for bad in (np.zeros(S - 1), np.zeros(S + 2)):
        with pytest.raises(ValueError, match="one tick per series"):
            ts.update(bad)
    with pytest.raises(ValueError, match="one exogenous offset"):
        ts.update(y[:, N_HIST], np.zeros(3))
    with pytest.raises(ValueError, match="update_batch expects"):
        ts.update_batch(y[:, N_HIST:N_HIST + 3].T)
    with pytest.raises(ValueError, match="at least one"):
        ts.update_batch(np.zeros((S, 0)))
    with pytest.raises(ValueError, match="horizon"):
        ts.forecast(0)
    with pytest.raises(ValueError, match="unknown serving fault"):
        resilience.serving_fault("oom_chunk")
    t = 0
    for mode in ("tick_corrupt_nan", "tick_corrupt_inf", "state_poison"):
        with j_res.fault_injection(mode, lane_stride=3):
            j_outs = [js.update(y[:, N_HIST + t + i]) for i in range(2)]
        with resilience.fault_injection(mode, lane_stride=3):
            assert resilience.serving_fault(mode).lane_stride == 3
            assert resilience.fault_scope_token() is not None
            t_outs = [ts.update(y[:, N_HIST + t + i]) for i in range(2)]
        t += 2
        for j_out, t_out in zip(j_outs, t_outs):
            for g, w in zip(t_out, j_out):
                close(g, w)
    assert resilience.fault_scope_token() is None
    assert (ts.lane_status[::3] == health.LANE_DIVERGED).all()
    assert ts._reg.snapshot()["counters"]["serving.diverged"] == 6


def test_no_fit_reachable_from_the_tick_path(monkeypatch):
    """With every minimizer and fit entry point made to raise, ticks and
    forecasts still serve."""
    _, ts, y, _ = start("arima")
    ts.warmup()

    def boom(*a, **k):
        raise AssertionError("a fit was reached from the tick path")

    from spark_timeseries_tpu_torch.models import autoregression, ewma
    from spark_timeseries_tpu_torch.models import holt_winters
    from spark_timeseries_tpu_torch.ops import arma_ne, optimize
    for mod, names in (
            (optimize, [n for n in dir(optimize)
                        if n.startswith("minimize_")]),
            (arma_ne, ["fit_css_lm", "fit_css_lm_plain", "normal_equations",
                       "css_cost"]),
            (t_arima, ["fit", "fit_resilient", "auto_fit_panel"]),
            (autoregression, ["fit"]), (ewma, ["fit"]),
            (holt_winters, ["fit"])):
        for name in names:
            monkeypatch.setattr(mod, name, boom)
    ts.update(y[:, N_HIST])
    ts.update_batch(y[:, N_HIST + 1:N_HIST + 3])
    assert ts.forecast(3).shape == (S, 3)
