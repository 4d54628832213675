"""The port's online serving tier (``statespace.serving``) against the JAX
package's, on the CPU in float64: ticks, ``update_batch``, forecasts,
counters, the quality plane, checkpoints, faults, a JAX session's blob
resumed in the port, and ``warmup_update``.

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
from spark_timeseries_tpu_torch.models import convert as mconv
from spark_timeseries_tpu_torch.statespace import health, quality, serving
from spark_timeseries_tpu_torch.utils import checkpoint, resilience
from torch_serving_cases import (K, N_HIST, PERIOD, FAMILIES, S, bitwise,
                                 close, models, panel, snapshot_counters,
                                 start, tick_offs)

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


def test_restore_rejects_geometry_and_format_one(tmp_path):
    _, ts, _, _ = start("ar")
    path = str(tmp_path / "g.ckpt")
    ts.checkpoint(path)
    blob = checkpoint.load_pytree(path)
    for field, value, match in (("bucket", 32, "bucket"),
                                ("meta", blob["meta"]._replace(d_order=2),
                                 "d_order"),
                                ("hist", blob["hist"][:3], "hist.rows")):
        bad = dict(blob, **{field: value})
        p2 = str(tmp_path / f"bad_{field}.ckpt")
        checkpoint.save_pytree_atomic(p2, bad)
        with pytest.raises(serving.ServingRestoreMismatch, match=match):
            serving.ServingSession.restore(p2, device="cpu")
    p3 = str(tmp_path / "old.ckpt")
    checkpoint.save_pytree_atomic(p3, {"format": 1})
    with pytest.raises(ValueError, match="format-1"):
        serving.ServingSession.restore(p3, device="cpu")
    with open(str(tmp_path / "g.ckpt.tree.json")) as f:
        text = f.read()
    with open(str(tmp_path / "g.ckpt.tree.json"), "w") as f:
        f.write(text.replace('"shape": [16, 2]', '"shape": [16, 3]', 1))
    with pytest.raises(checkpoint.CheckpointMismatchError):
        serving.ServingSession.restore(path, device="cpu")


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


@pytest.mark.parametrize("family", ["arima", "arx"])
def test_jax_blob_resumes_in_the_port(family):
    """A JAX session's ``checkpoint_blob()`` carried across mid-stream:
    the port's session ticks on equal to the JAX session."""
    js, _, y, offs = start(family, quality=(j_ss.QualityPolicy(),
                                             quality.QualityPolicy()))
    for t in range(3):
        js.update(y[:, N_HIST + t], tick_offs(offs, t))
    blob = mconv.serving_blob_from_numpy(js.checkpoint_blob(), device="cpu")
    ts = serving.ServingSession.from_blob(blob, device="cpu")
    assert ts.describe() == js.describe()
    assert ts.ticks_seen == js.ticks_seen
    for t in range(3, 3 + K):
        o = tick_offs(offs, t)
        for g, w in zip(ts.update(y[:, N_HIST + t], o),
                        js.update(y[:, N_HIST + t], o)):
            close(g, w)
    close(ts.forecast(3), js.forecast(3))
    assert ts.quality_summary() == js.quality_summary()


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


@pytest.mark.parametrize("family", serving.WARMUP_FAMILIES)
def test_warmup_update_per_family(family):
    rep = serving.warmup_update(family, 8, period=PERIOD, device="cpu",
                                quality=quality.QualityPolicy())
    want = j_ss.warmup_update(family, 8, period=PERIOD,
                              quality=j_ss.QualityPolicy())
    assert rep == want


def test_what_has_no_serving_form_raises():
    with pytest.raises(ValueError, match="serving form"):
        serving.warmup_update("garch", 8, device="cpu")
    y, _ = panel("holt_winters")
    mult = mconv.holt_winters_from_numpy("multiplicative", PERIOD, 0.3, 0.1,
                                         0.2, device="cpu")
    with pytest.raises(NotImplementedError, match="multiplicative"):
        serving.ServingSession.start(mult, y[:, :N_HIST], device="cpu")
    with pytest.raises(ValueError, match="label"):
        serving.check_label("a b")
    with pytest.raises(ValueError, match="STS_SERVING_SLO_MS"):
        with pytest.MonkeyPatch.context() as mp:
            mp.setenv("STS_SERVING_SLO_MS", "-1")
            start("ewma")


def test_slo_and_latency_accounting(monkeypatch):
    """``STS_SERVING_SLO_MS``: every tick over it burns, counted per
    session and globally as in the JAX package; the latency window and
    the per-session gauges fill."""
    monkeypatch.setenv("STS_SERVING_SLO_MS", "1e-9")
    js, ts, y, _ = start("ewma")
    for t in range(3):
        js.update(y[:, N_HIST + t])
        ts.update(y[:, N_HIST + t])
    for sess in (js, ts):
        snap = sess._reg.snapshot()
        assert snap["counters"]["serving.slo_burns"] == 3
        assert snap["counters"][f"serving.session.{sess.label}.slo_burns"] \
            == 3
        assert f"serving.session.{sess.label}.tick_p95_ms" in snap["gauges"]
    got, want = ts.tick_latency_stats(), js.tick_latency_stats()
    assert (got["window"], got["slo_ms"], got["slo_burns"]) \
        == (want["window"], want["slo_ms"], want["slo_burns"]) == (3, 1e-9, 3)
    assert set(ts.telemetry_summary()) == set(js.telemetry_summary())


def test_telemetry_and_metrics_pieces(monkeypatch):
    """``metrics.get_registry`` is the default registry, ``span`` records
    into the registry it is given; ``STS_TELEMETRY_PORT`` asks for the
    exporter, which is not ported, so a session start raises."""
    from spark_timeseries_tpu_torch.utils import metrics, telemetry

    reg = metrics.MetricsRegistry()
    with metrics.span("serving.test_span", registry=reg):
        pass
    assert reg.snapshot()["spans"]["serving.test_span"]["count"] == 1
    assert "serving.test_span" not in metrics.get_registry().snapshot()[
        "spans"]
    monkeypatch.setenv("STS_X", "2.5")
    assert telemetry.env_positive("STS_X") == 2.5
    assert telemetry.env_positive("STS_UNSET_KNOB", int, 7) == 7
    y, _ = panel("ar")
    model = models("ar")[1]
    monkeypatch.setenv("STS_TELEMETRY_PORT", "9100")
    with pytest.raises(NotImplementedError, match="item 5"):
        serving.ServingSession.start(model, y[:, :N_HIST], device="cpu")
