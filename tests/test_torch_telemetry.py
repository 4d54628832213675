"""The port's telemetry exporter against the JAX package's.

The exporter's four routes answer during a small CPU ``stream_fit``
(every ``/metrics`` scrape holds to the Prometheus grammar the JAX
package's telemetry tests check), its life cycle ends with no thread
left, ``STS_TELEMETRY_PORT`` opts in with the JAX package's ``ValueError``
text for junk, a stale job answers 503 and a junk trace limit 400;
``snapshot_doc`` and ``healthz_doc`` carry the JAX documents' keys (the
port's ``kernels`` block in place of the JAX ``jax`` block); and the
port's serving session, fleet and stream start the exporter from the
environment, their summaries showing as in the JAX package.  Incident
bundles carry the ``trace`` member.
"""

import json
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from spark_timeseries_tpu.statespace import fleet as j_fleet
from spark_timeseries_tpu.statespace import serving as j_serving
from spark_timeseries_tpu.utils import metrics as jmetrics
from spark_timeseries_tpu.utils import telemetry as jtelemetry
from spark_timeseries_tpu_torch import engine
from spark_timeseries_tpu_torch.statespace import fleet, serving
from spark_timeseries_tpu_torch.utils import (flightrec, metrics, resilience,
                                              telemetry)
from test_telemetry import assert_prometheus_grammar
import torch_serving_cases as cases

torch.set_num_threads(1)


def _panel(n_series=96, n_obs=64, seed=0):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(n_series, n_obs)).cumsum(axis=1)


def _get(url, timeout=10):
    with urllib.request.urlopen(url, timeout=timeout) as resp:
        return resp.status, resp.read()


@pytest.fixture
def exporter():
    srv = telemetry.start(port=0)
    yield srv
    telemetry.stop()


@pytest.fixture
def no_exporter():
    """Both packages' exporters stopped around the case."""
    telemetry.stop()
    jtelemetry.stop()
    yield
    telemetry.stop()
    jtelemetry.stop()


def test_exporter_lifecycle_scrapes_during_active_stream(exporter):
    v = _panel()
    results = {}

    def run():
        results["res"] = engine.FitEngine().stream_fit(
            v, "ar", chunk_size=8, max_lag=2, device="cpu",
            job_label="telemetry-test")

    worker = threading.Thread(target=run)
    worker.start()
    bodies = {"/metrics": [], "/snapshot.json": [], "/trace.json": [],
              "/healthz": []}
    try:
        while worker.is_alive():
            for route, seen in bodies.items():
                status, body = _get(exporter.url + route)
                assert status == 200
                seen.append(body.decode())
            time.sleep(0.005)
    finally:
        worker.join(120)
    assert not worker.is_alive()
    for text in bodies["/metrics"]:
        assert_prometheus_grammar(text)
    for route in ("/snapshot.json", "/trace.json", "/healthz"):
        assert bodies[route]
        for text in bodies[route]:
            json.loads(text)

    status, body = _get(exporter.url + "/snapshot.json")
    snap = json.loads(body)
    assert status == 200 and snap["format"] == 1
    (job,) = [j for j in snap["recent_jobs"]
              if j["family"] == "telemetry-test"]
    assert job["status"] == "done" and job["chunks_done"] == 12
    assert "engine.chunks" in snap["registry"]["counters"]
    status, body = _get(exporter.url + "/trace.json?limit=64")
    trace = json.loads(body)
    assert status == 200 and trace["otherData"]["events_exported"] <= 64
    status, body = _get(exporter.url + "/healthz")
    assert status == 200 and json.loads(body)["status"] == "ok"
    with pytest.raises(urllib.error.HTTPError):
        _get(exporter.url + "/no-such-route")
    with pytest.raises(telemetry.TelemetryAlreadyStarted):
        telemetry.start(port=0)
    assert telemetry.stop() is True
    assert not exporter.alive
    with pytest.raises((urllib.error.URLError, OSError)):
        _get(exporter.url + "/metrics", timeout=2)
    assert results["res"].n_fitted == 96


def test_env_port_optin_and_validation(monkeypatch, no_exporter):
    """Unset is a no-op; junk raises the JAX package's ValueError, word
    for word; a port starts one exporter and reuses it; a port taken by
    another socket counts ``telemetry.start_errors`` and raises
    nothing."""
    assert telemetry.ensure_started_from_env() is None
    monkeypatch.setenv("STS_TELEMETRY_PORT", "junk")
    with pytest.raises(ValueError) as got:
        telemetry.ensure_started_from_env()
    with pytest.raises(ValueError) as want:
        jtelemetry.ensure_started_from_env()
    assert str(got.value) == str(want.value)
    monkeypatch.setenv("STS_TELEMETRY_PORT", "70000")
    with pytest.raises(ValueError, match="STS_TELEMETRY_PORT"):
        telemetry.ensure_started_from_env()
    monkeypatch.setenv("STS_TELEMETRY_PORT", "0")
    srv = telemetry.ensure_started_from_env()
    assert srv is not None and srv.alive
    assert telemetry.ensure_started_from_env() is srv
    taken = srv.port
    telemetry.stop()
    blocker = telemetry.start(port=0)
    monkeypatch.setenv("STS_TELEMETRY_PORT", str(blocker.port))
    telemetry._server = None        # as if another process held the port
    before = metrics.snapshot()["counters"].get("telemetry.start_errors", 0)
    try:
        assert telemetry.ensure_started_from_env() is None
        assert metrics.snapshot()["counters"]["telemetry.start_errors"] \
            == before + 1
    finally:
        blocker.stop()
    assert taken > 0


def test_stale_job_answers_503_and_junk_limit_400(exporter):
    p = telemetry.JobProgress(telemetry.new_job_id("t"), "ar", 8, 4, 2)
    telemetry.register_job(p)
    try:
        status, body = _get(exporter.url + "/healthz")
        assert status == 200 and json.loads(body)["status"] == "ok"
        p.last_heartbeat_unix = time.time() - 10 * p.stale_after_s()
        with pytest.raises(urllib.error.HTTPError) as ei:
            _get(exporter.url + "/healthz")
        assert ei.value.code == 503
        doc = json.loads(ei.value.read())
        (job,) = [j for j in doc["jobs"] if j["job_id"] == p.job_id]
        assert doc["status"] == "stale" and job["stale"]
    finally:
        telemetry.finish_job(p, "done")
    assert _get(exporter.url + "/healthz")[0] == 200
    with pytest.raises(urllib.error.HTTPError) as ei:
        _get(exporter.url + "/trace.json?limit=5OOO")
    assert ei.value.code == 400
    assert _get(exporter.url + "/trace.json?limit=5")[0] == 200


def _fill(mod, reg):
    reg.inc("engine.chunks", 2)
    reg.set_gauge("engine.job.eta_s", 1.5)
    reg.record("telemetry.scrape_s", 0.01)
    reg.record_span("engine.stream", 0.2)


def test_documents_carry_the_jax_keys(no_exporter):
    """For the same registry contents and an active job in each package,
    ``snapshot_doc`` has the JAX document's keys (``kernels`` in place of
    ``jax``), equal registry counters and gauges, equal job and recent-job
    keys; ``healthz_doc`` has the JAX document's keys."""
    reg, jreg = metrics.MetricsRegistry(), jmetrics.MetricsRegistry()
    _fill(metrics, reg)
    _fill(jmetrics, jreg)
    jobs = []
    for mod in (telemetry, jtelemetry):
        p = mod.JobProgress(mod.new_job_id("docs"), "arima", 16, 2, 8)
        mod.register_job(p)
        jobs.append((mod, p))
    try:
        doc, jdoc = telemetry.snapshot_doc(reg), jtelemetry.snapshot_doc(jreg)
        hz, jhz = telemetry.healthz_doc(reg), jtelemetry.healthz_doc(jreg)
    finally:
        for mod, p in jobs:
            mod.finish_job(p, "done")
    assert set(doc) - {"kernels"} == set(jdoc) - {"jax"}
    assert set(doc["kernels"]) >= {"builds", "cache_hits", "launches"}
    assert set(doc["kernels"]["launches"]) == {
        "arma_lm_fit", "arma_ne", "arma_css", "hw_box_fit", "hw_sse"}
    for key in ("counters", "gauges", "histograms"):
        assert doc["registry"][key] == jdoc["registry"][key]
    assert set(doc["registry"]["spans"]) == set(jdoc["registry"]["spans"])
    job = [j for j in doc["jobs"] if j["job_id"] == jobs[0][1].job_id]
    jjob = [j for j in jdoc["jobs"] if j["job_id"] == jobs[1][1].job_id]
    assert set(job[0]) == set(jjob[0])
    assert set(doc["attribution"]) == set(jdoc["attribution"])
    assert set(hz) == set(jhz)
    assert hz["status"] == jhz["status"] == "ok"
    json.dumps(doc)


def test_serving_session_and_fleet_start_the_exporter(monkeypatch,
                                                      no_exporter):
    """A port session and a fleet built with ``STS_TELEMETRY_PORT`` set
    start the exporter (the JAX package's behaviour) and show in
    ``/snapshot.json`` with the JAX summaries' keys; a fleet runtime's
    pump shows in ``/healthz``."""
    from spark_timeseries_tpu_torch.statespace import runtime

    monkeypatch.setenv("STS_TELEMETRY_PORT", "0")
    y, _ = cases.panel("ar")
    j_model, t_model = cases.models("ar")
    hist = y[:, :cases.N_HIST]
    ts = serving.ServingSession.start(t_model, hist, label="tele-port",
                                      device="cpu")
    srv = telemetry.server()
    assert srv is not None and srv.alive
    js = j_serving.ServingSession.start(j_model, hist, label="tele-jax")
    sched = fleet.FleetScheduler(auto_pump=False, device="cpu")
    sched.attach(serving.ServingSession.start(t_model, hist, label="tf0",
                                              device="cpu"))
    jsched = j_fleet.FleetScheduler(auto_pump=False)
    jsched.attach(j_serving.ServingSession.start(j_model, hist,
                                                 label="jf0"))
    for sess in (ts, js):
        sess.update(y[:, cases.N_HIST])
    status, body = _get(srv.url + "/snapshot.json")
    doc = json.loads(body)
    (srow,) = [s for s in doc["serving_sessions"]
               if s.get("label") == "tele-port"]
    (jrow,) = [s for s in jtelemetry.session_summaries()
               if s.get("label") == "tele-jax"]
    assert set(srow) == set(jrow)
    (frow,) = [f for f in doc["fleets"] if "tf0" in json.dumps(f)]
    (jfrow,) = [f for f in jtelemetry.fleet_summaries()
                if "jf0" in json.dumps(f)]
    assert set(frow) == set(jfrow)
    rt = runtime.FleetRuntime(sched)
    try:
        status, body = _get(srv.url + "/healthz")
        hz = json.loads(body)
        assert status == 200 and hz["n_fleet_pumps"] >= 1
        assert hz["n_serving_sessions"] >= 2
    finally:
        rt.stop()
    # the stream's opt-in: a fresh exporter from the same environment
    telemetry.stop()
    engine.FitEngine().stream_fit(_panel(16, 32), "ar", chunk_size=8,
                                  max_lag=1, device="cpu")
    assert telemetry.server() is not None and telemetry.server().alive


def test_dead_chunk_bundle_carries_the_trace(tmp_path):
    """A hung chunk's dead-chunk bundle is schema-valid and its
    ``trace`` member holds the stream's span events."""
    d = str(tmp_path / "incidents")
    flightrec.configure(d)
    try:
        with resilience.fault_injection("hang_chunk", chunk_index=0,
                                        hang_s=0.6):
            engine.FitEngine().stream_fit(_panel(16, 32), "ar",
                                          chunk_size=8, max_lag=1,
                                          device="cpu", deadline_s=0.2,
                                          retry=0)
    finally:
        flightrec.configure(None)
        for t in threading.enumerate():
            if t.name.startswith("sts-chunk-"):
                t.join(10)
    index = flightrec.list_incidents(d)
    kinds = sorted(e["kind"] for e in index)
    assert kinds == ["chunk_dead", "deadline_expired"]
    dead = flightrec.load_incident(
        [e for e in index if e["kind"] == "chunk_dead"][0]["path"])
    assert flightrec.validate_bundle(dead) == []
    evs = dead["trace"]["traceEvents"]
    assert "engine.deadline_expired" in {e["name"] for e in evs
                                         if e["ph"] == "i"}
    # the chunk that fitted: its spans (the fit's on its watchdog
    # worker's row, the staging and publish under the stream's span)
    assert {"engine.stage", "engine.dispatch", "engine.collect",
            "engine.publish"} <= {e["name"].rsplit("/", 1)[-1]
                                  for e in evs if e["ph"] == "X"}
    assert flightrec.validate_bundle({"format": 1}) != []
