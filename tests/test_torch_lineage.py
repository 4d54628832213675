"""The port's tick-lineage plane (``utils.lineage``, a copy of the JAX
package's JAX-free module) against the JAX package's: the same stage
sequence, detours and outcomes through both modules, on one fake clock
that advances the same way for each, must leave the same records, ring,
summary, trace events and incident block, to the last field."""

import itertools
import time

import pytest

from spark_timeseries_tpu.utils import lineage as j_lineage
from spark_timeseries_tpu.utils import metrics as j_metrics
from spark_timeseries_tpu_torch.utils import lineage as t_lineage
from spark_timeseries_tpu_torch.utils import metrics as t_metrics

pytestmark = pytest.mark.lineage

DISPATCH = ("admit", "queue", "gather", "dispatch", "scatter", "deliver")


def _journeys(lin, reg):
    """Delivered, replayed, cache-served, rejected, dropped and migrated
    journeys over three tenants, a duplicate completion and a None."""
    recs = []
    for i in range(9):
        r = lin.begin(f"t{i % 3}")
        for stage in DISPATCH[:1 + i % len(DISPATCH)]:
            r.stage_end(stage)
        if i % 4 == 0:
            r.detour("window_deadline")
            r.detour("window_deadline")          # idempotent
        recs.append(r)
    lin.complete(recs[0], reg)
    lin.complete(recs[1], reg, outcome="rejected")
    lin.complete(recs[2], reg, outcome="dropped")
    lin.complete(recs[3], reg, outcome="migrated")
    recs[4].via = "replay"
    recs[4].detour("catchup_replay")
    recs[4].stage_end("replay")
    lin.complete(recs[4], reg)
    for r in recs[5:8]:
        lin.complete(r, reg)
    lin.complete(recs[0], reg)                   # a duplicate: counted
    lin.complete(None, reg)
    c = lin.begin("t1", via="cache")
    c.detour("cache_stale")
    c.stage_end("cache")
    lin.complete(c, reg)
    # recs[8] stays open


def _backpressure(lin, reg):
    """The runtime's submit context: the clock starts at entry, a park
    marks the record; an abandoned submit leaks nothing."""
    lin.submit_entry()
    lin.submit_parked()
    r = lin.begin("t0")
    r.stage_end("admit")
    lin.complete(r, reg)
    lin.submit_entry()
    lin.submit_parked()
    lin.submit_abandon()
    r = lin.begin("t0")
    r.stage_end("admit")
    lin.complete(r, reg, outcome="rejected")


def _overflow(lin, reg):
    """A ring of 4 over 10 completions, and the per-tenant maps bounded
    at MAX_TENANTS."""
    lin.set_capacity(4)
    for i in range(10):
        r = lin.begin(f"x{i}")
        r.stage_end("admit")
        lin.complete(r, reg)
    lin.MAX_TENANTS, old = 3, lin.MAX_TENANTS
    try:
        for i in range(6):
            r = lin.begin(f"y{i}")
            lin.complete(r, reg)
    finally:
        lin.MAX_TENANTS = old


def _disarmed(lin, reg):
    prev = lin.arm(False)
    try:
        assert lin.begin("t0") is None
        lin.submit_entry()
        lin.complete(None, reg)
    finally:
        lin.arm(prev)
    r = lin.begin("t0")
    lin.complete(r, reg)


SCENARIOS = {"journeys": _journeys, "backpressure": _backpressure,
             "overflow": _overflow, "disarmed": _disarmed}


def _renumber(doc, base):
    """Trace ids come from a process-wide counter that ``reset()`` leaves
    alone (earlier tests in the process advance it): count each from the
    run's first id, and replace each trace event's lane, a function of
    the id, by a check of that function."""
    if isinstance(doc, dict):
        out = {}
        for k, v in doc.items():
            if k == "trace_id":
                out[k] = v - base
            elif k in ("tid", "tname"):
                lane = doc["args"]["trace_id"] % 4
                assert v in (lane + (1 << 20), f"lineage-{lane}")
            else:
                out[k] = _renumber(v, base)
        return out
    if isinstance(doc, (list, tuple)):
        return type(doc)(_renumber(v, base) for v in doc)
    return doc


def _drive(lin, metrics, scenario, monkeypatch):
    """One scenario through one module on a fresh fake clock; returns
    everything the plane exposes."""
    clock = itertools.count(1000)
    monkeypatch.setattr(time, "perf_counter",
                        lambda: next(clock) * 1e-3)
    cap = lin._cap
    lin.reset()
    reg = metrics.MetricsRegistry()
    base = next(lin._trace_seq) + 1
    try:
        SCENARIOS[scenario](lin, reg)
        return _renumber({"records": lin.records(),
                "summary": lin.lineage_summary(),
                "open": lin.open_records(),
                "trace": lin.trace_events(limit=16),
                "incident": lin.incident_block(limit=8),
                "counters": reg.snapshot()["counters"],
                "gauges": {k: v for k, v in reg.snapshot()["gauges"].items()
                           if k.startswith("fleet.")}}, base)
    finally:
        lin.set_capacity(cap)
        lin.reset()


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_lineage_plane_matches_jax(scenario, monkeypatch):
    want = _drive(j_lineage, j_metrics, scenario, monkeypatch)
    got = _drive(t_lineage, t_metrics, scenario, monkeypatch)
    assert got == want
    if scenario == "journeys":
        s = got["summary"]
        assert s["outcomes"] == {"delivered": 6, "rejected": 1,
                                 "dropped": 1, "migrated": 1}
        assert s["open"] == got["open"] == 1
        assert s["duplicate_completions"] == 1
        assert got["counters"]["fleet.e2e.duplicate_completions"] == 1
    if scenario == "backpressure":
        assert got["records"][0]["detours"] == ["backpressure"]
        assert got["records"][1]["detours"] == []
    if scenario == "overflow":
        s = got["summary"]
        assert s["ring"] == {"len": 4, "capacity": 4, "dropped": 12}
        assert s["tenant_overflow"] == 6
    assert t_lineage.STAGES == j_lineage.STAGES
    assert t_lineage.OUTCOMES == j_lineage.OUTCOMES
