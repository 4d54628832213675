"""The port's trace ring and Chrome-trace export against the JAX
package's ``utils.tracing``.

The ring is bounded and resizes keeping the newest events; nested span
events enclose one another; instant events carry their args; the export
follows the Chrome trace-event schema, round-trips through
``write_trace`` and ``STS_TRACE`` dumps it at exit in a subprocess; and
``self_times``, ``slowest_spans`` and ``self_time_report`` on one
synthetic event list are equal through both packages.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from spark_timeseries_tpu.utils import tracing as jtracing
from spark_timeseries_tpu_torch.utils import lineage, metrics, tracing

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _fresh_ring():
    """Each case on an empty module ring at its own capacity, with no
    tick lineage from earlier tests (the export merges it)."""
    cap = metrics.trace_buffer().capacity
    metrics.clear_trace()
    lineage.reset()
    yield
    metrics.set_trace_capacity(cap)
    metrics.clear_trace()


def test_trace_buffer_bounded_resizes_keeping_newest():
    buf = metrics.TraceBuffer(capacity=4)
    for i in range(10):
        buf.append({"kind": "instant", "name": str(i), "ts": float(i)})
    assert [e["name"] for e in buf.events()] == ["6", "7", "8", "9"]
    assert len(buf) == 4 and buf.dropped == 6
    buf.set_capacity(2)
    assert [e["name"] for e in buf.events()] == ["8", "9"]
    buf.set_capacity(5)
    buf.append({"kind": "instant", "name": "10", "ts": 10.0})
    assert [e["name"] for e in buf.events()] == ["8", "9", "10"]
    with pytest.raises(ValueError):
        buf.set_capacity(0)
    metrics.set_trace_capacity(3)
    for i in range(5):
        metrics.trace_instant(f"tracing.test.{i}")
    assert len(metrics.trace_events()) == 3


def test_nested_span_events_enclose_and_instants_carry_args():
    with metrics.span("tracing.test.outer"):
        with metrics.span("tracing.test.inner"):
            metrics.trace_instant("tracing.test.mark", {"n": 3})
    evs = metrics.trace_events()
    spans = {e["name"]: e for e in evs if e["kind"] == "span"}
    outer = spans["tracing.test.outer"]
    inner = spans["tracing.test.outer/tracing.test.inner"]
    assert outer["ts"] <= inner["ts"]
    assert inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"]
    # the ring appends at scope exit: the child first
    assert [e["name"] for e in evs if e["kind"] == "span"] == [
        "tracing.test.outer/tracing.test.inner", "tracing.test.outer"]
    (mark,) = [e for e in evs if e["kind"] == "instant"]
    assert mark["args"] == {"n": 3} and outer["ts"] <= mark["ts"]
    # a private registry's spans stay off the process timeline
    with metrics.span("tracing.test.private",
                      registry=metrics.MetricsRegistry()):
        pass
    assert not any(e["name"] == "tracing.test.private"
                   for e in metrics.trace_events())


def test_chrome_trace_schema():
    with metrics.span("fit"):
        with metrics.span("solve"):
            pass
    metrics.trace_instant("stage", {"n": 1})
    doc = tracing.to_chrome_trace()
    json.dumps(doc)
    assert set(doc) == {"traceEvents", "displayTimeUnit", "otherData"}
    phs = {}
    for e in doc["traceEvents"]:
        assert {"name", "ph", "pid", "tid"} <= set(e)
        phs.setdefault(e["ph"], []).append(e)
        if e["ph"] == "X":
            assert e["ts"] >= 0 and e["dur"] >= 0
        if e["ph"] == "i":
            assert e["s"] == "t" and e["args"] == {"n": 1}
        if e["ph"] == "M":
            assert e["name"] in ("process_name", "thread_name")
    assert [e["name"] for e in phs["X"]] == ["fit", "fit/solve"]
    assert len(phs["i"]) == 1
    assert "spark_timeseries_tpu_torch" in {e["args"]["name"]
                                            for e in phs["M"]}
    assert doc["otherData"]["capacity"] == metrics.trace_buffer().capacity
    for i in range(20):
        metrics.trace_instant(f"n{i}")
    assert tracing.to_chrome_trace(limit=5)["otherData"][
        "events_exported"] == 5


def test_lineage_lanes_interleave_in_the_export():
    """Completed tick lineages render on their own ``lineage-*`` thread
    rows beside the engine's spans, as in the JAX export."""
    prev = lineage.arm(True)
    try:
        rec = lineage.begin("tenant-a")
        rec.stage_end("queue")
        rec.stage_end("dispatch")
        lineage.complete(rec)
        with metrics.span("engine.stream"):
            pass
        doc = tracing.to_chrome_trace()
        evs = doc["traceEvents"]
        lanes = {e["tid"] for e in evs if e["ph"] == "M"
                 and e["args"]["name"].startswith("lineage-")}
        names = {(e["name"], e["tid"] in lanes) for e in evs
                 if e["ph"] == "X"}
        assert names == {("lineage.queue", True),
                         ("lineage.dispatch", True),
                         ("engine.stream", False)}
        # attribution keeps reading the span ring alone
        assert {r["name"] for r in tracing.self_times()} == \
            {"engine.stream"}
    finally:
        lineage.arm(prev)
        lineage.reset()


def test_write_trace_roundtrip(tmp_path):
    with metrics.span("s"):
        pass
    p = tracing.write_trace(str(tmp_path / "sub" / "trace.json"))
    with open(p) as f:
        doc = json.load(f)
    assert any(e["ph"] == "X" and e["name"] == "s"
               for e in doc["traceEvents"])


def test_sts_trace_env_dumps_at_exit(tmp_path):
    out = tmp_path / "t.json"
    code = ("from spark_timeseries_tpu_torch.utils import metrics\n"
            "with metrics.span('workload'):\n"
            "    with metrics.span('step'):\n"
            "        pass\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         env=dict(os.environ, STS_TRACE=str(out)),
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    with open(out) as f:
        doc = json.load(f)
    names = {e["name"] for e in doc["traceEvents"] if e["ph"] == "X"}
    assert {"workload", "workload/step"} <= names


def _synthetic_events():
    """Nested spans on two threads, partial overlaps, equal begins and
    instants, in arrival (scope-exit) order."""
    rng = np.random.default_rng(5)
    evs = []
    for tid in (1, 2):
        t = 0.0
        for k in range(12):
            dur = float(rng.uniform(0.5, 2.0))
            name = ["engine.stream", "serving.update", "arima.fit",
                    "backtest.fit", "io.load", "telemetry.scrape"][k % 6]
            child = dur * float(rng.uniform(0.1, 0.6))
            evs.append({"kind": "span", "name": f"{name}/arima.fit",
                        "ts": t + 0.1, "dur": child, "tid": tid,
                        "tname": f"t{tid}"})
            evs.append({"kind": "span", "name": name, "ts": t, "dur": dur,
                        "tid": tid, "tname": f"t{tid}"})
            if k % 4 == 0:
                evs.append({"kind": "instant", "name": "mark", "ts": t,
                            "tid": tid, "tname": f"t{tid}"})
            t += dur + float(rng.uniform(0.0, 0.2))
    evs.append({"kind": "span", "name": "fleet.dispatch", "ts": 1.0,
                "dur": 5.0, "tid": 3, "tname": "t3"})
    evs.append({"kind": "span", "name": "lineage.deliver", "ts": 4.0,
                "dur": 5.0, "tid": 3, "tname": "t3"})
    return evs


def test_self_time_attribution_equals_jax():
    evs = _synthetic_events()
    assert tracing.self_times(evs) == jtracing.self_times(evs)
    assert tracing.slowest_spans(7, evs) == jtracing.slowest_spans(7, evs)
    assert tracing.self_time_report(5, evs) == \
        jtracing.self_time_report(5, evs)
    assert tracing.span_events(evs) == jtracing.span_events(evs)
    for path in ("bench.fit/engine.stream", "serving.update",
                 "a/garch.fit", "telemetry.scrape", "kalman.step"):
        assert tracing.span_subsystem(path) == jtracing.span_subsystem(path)
    rep = tracing.self_time_report(3, evs)
    assert set(rep["subsystems"]) == set(tracing.SUBSYSTEMS)
