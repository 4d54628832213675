"""The port's online serving tier (``statespace.serving``) against the JAX
package's, on the CPU in float64: a JAX session's blob resumed in the
port, checkpoint refusals, ``warmup_update`` per family, the families
without a serving form, and the SLO, latency and telemetry accounting.
The ticks, batches, forecasts, quality plane, checkpoints and faults are
in ``test_torch_serving.py``; the models and histories are
``torch_serving_cases``'."""

import pytest
import torch

from spark_timeseries_tpu.statespace import serving as j_ss
from spark_timeseries_tpu_torch.models import convert as mconv
from spark_timeseries_tpu_torch.statespace import quality, serving
from spark_timeseries_tpu_torch.utils import checkpoint
from torch_serving_cases import (K, N_HIST, PERIOD, close, models, panel,
                                 start, tick_offs)

pytestmark = pytest.mark.serving

torch.set_num_threads(1)


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
    into the registry it is given; with ``STS_TELEMETRY_PORT`` set a
    session start starts the telemetry exporter, as in the JAX package
    (junk in it raises the JAX package's ``ValueError``)."""
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
    telemetry.stop()
    monkeypatch.setenv("STS_TELEMETRY_PORT", "0")
    try:
        serving.ServingSession.start(model, y[:, :N_HIST], device="cpu")
        srv = telemetry.server()
        assert srv is not None and srv.alive
    finally:
        telemetry.stop()
    monkeypatch.setenv("STS_TELEMETRY_PORT", "91OO")
    with pytest.raises(ValueError, match="STS_TELEMETRY_PORT"):
        serving.ServingSession.start(model, y[:, :N_HIST], device="cpu")
