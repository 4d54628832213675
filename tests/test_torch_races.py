"""The port's race harness against the JAX package's ``utils.races``.

The same seed gives the same ``schedule_trace`` through both harnesses
on the same thread programs; the racy fixture trips and the locked one
never does; lock-order cycles are found; the metrics registry's lock is
wrapped in place; and the known-hot concurrent pairs of the port run
instrumented with an acyclic lock-order graph: the engine's watchdog
expiry against a chunk's fit, a fleet pump against telemetry scrapes,
and a journal commit against flight-recorder reads.
"""

import threading

import numpy as np
import pytest
import torch

from spark_timeseries_tpu.utils import races as jraces
from spark_timeseries_tpu_torch import engine
from spark_timeseries_tpu_torch.utils import metrics, races

torch.set_num_threads(1)

SEEDS = range(6)


def _locked_increments(mod, seed):
    with mod.instrument(seed=seed) as h:
        counter = {"v": 0}
        lock = threading.Lock()

        def worker():
            for _ in range(5):
                with lock:
                    counter["v"] += 1
                mod.yield_point()

        h.spawn(worker, label="a")
        h.spawn(worker, label="b")
        h.join_all()
        h.raise_errors()
        return h.schedule_trace, counter["v"]


@pytest.mark.parametrize("seed", [3, 7])
def test_same_seed_same_schedule_as_jax(seed):
    t1, v1 = _locked_increments(races, seed)
    t2, v2 = _locked_increments(races, seed)
    tj, vj = _locked_increments(jraces, seed)
    assert t1 == t2 == tj
    assert v1 == v2 == vj == 10
    assert len(t1) > 10
    traces = {tuple(_locked_increments(races, s)[0]) for s in SEEDS}
    assert len(traces) > 1


class RacyCounter:
    def __init__(self):
        self.value = 0

    def bump(self):
        v = self.value
        races.yield_point()
        self.value = v + 1


class LockedCounter:
    def __init__(self):
        self.value = 0
        self._lock = threading.Lock()

    def bump(self):
        with self._lock:
            v = self.value
            races.yield_point()
            self.value = v + 1


def _drive(counter_cls, seed, per_thread=4):
    with races.instrument(seed=seed) as h:
        c = counter_cls()
        if hasattr(c, "_lock"):
            c._lock = h.wrap("fixture.lock", c._lock)

        def w():
            for _ in range(per_thread):
                c.bump()

        h.spawn(w, label="a")
        h.spawn(w, label="b")
        h.join_all()
        h.raise_errors()
        return c.value


def test_racy_fixture_trips_and_locked_never_does():
    racy = {s: _drive(RacyCounter, s) for s in SEEDS}
    assert any(v < 8 for v in racy.values()), racy
    locked = {s: _drive(LockedCounter, s) for s in SEEDS}
    assert all(v == 8 for v in locked.values()), locked


def test_order_graph_cycles_found_and_factories_restored():
    from spark_timeseries_tpu_torch.utils import telemetry

    before = telemetry._jobs_lock
    with races.instrument() as h:
        assert isinstance(telemetry._jobs_lock, races.TracedLock)
        a = threading.Lock()
        b = threading.Lock()
        with a:
            with b:
                pass
        h.assert_acyclic()
        with b:
            with a:
                pass
        assert h.cycles()
        with pytest.raises(AssertionError, match="cycle"):
            h.assert_acyclic()
    assert telemetry._jobs_lock is before
    assert threading.Lock is races._REAL_LOCK
    assert threading.Thread.start is races._REAL_THREAD_START
    with pytest.raises(RuntimeError, match="nest"):
        with races.instrument():
            with races.instrument():
                pass


def test_registry_lock_wrapped_in_place():
    reg = metrics.get_registry()
    inner = reg._lock
    reg.counter("races.test.handle")
    with races.instrument() as h:
        assert isinstance(reg._lock, races.TracedLock)
        assert reg.counter("races.test.handle")._lock is reg._lock
        reg.inc("races.test.wrap_probe")
        assert any(name == "metrics.registry" for _t, _op, name in h.events)
    assert reg._lock is inner
    assert reg.counter("races.test.handle")._lock is inner


def test_scrape_vs_inc_under_adversarial_schedule():
    reg = metrics.get_registry()
    name = "races.test.scrape_vs_inc"
    with races.instrument(seed=3) as h:
        seen = []

        def writer():
            for _ in range(30):
                reg.inc(name)

        def scraper():
            for _ in range(6):
                seen.append(reg.snapshot()["counters"].get(name, 0))
                reg.to_prometheus()

        h.spawn(writer, label="writer")
        h.spawn(scraper, label="scraper")
        h.join_all()
        h.raise_errors()
        h.assert_acyclic()
    assert reg.snapshot()["counters"][name] >= 30
    assert seen == sorted(seen)


def _ar_panel(n_series, n_obs, seed=0):
    rng = np.random.default_rng(seed)
    e = rng.normal(size=(n_series, n_obs))
    y = np.zeros((n_series, n_obs))
    for t in range(1, n_obs):
        y[:, t] = 0.6 * y[:, t - 1] + e[:, t]
    return y


def _join_chunk_workers():
    for t in threading.enumerate():
        if t.name.startswith("sts-chunk-"):
            t.join(30.0)


def test_watchdog_expiry_vs_chunk_fit_instrumented():
    v = _ar_panel(32, 48, seed=5)
    from spark_timeseries_tpu_torch.utils import resilience

    try:
        with races.instrument() as h:
            with resilience.fault_injection("hang_chunk", chunk_index=0,
                                            hang_s=0.8):
                out = engine.FitEngine().stream_fit(
                    v, "ar", chunk_size=16, max_lag=2, device="cpu",
                    deadline_s=0.25, retry=0)
            h.assert_acyclic()
            assert any(op == "spawn" for _t, op, _n in h.events)
    finally:
        _join_chunk_workers()
    assert out.stats["dead_chunks"] == 1
    assert out.chunk_failures[0]["kind"] == "deadline"
    assert out.n_fitted == 16


def test_fleet_pump_vs_scrape_instrumented():
    import torch_fleet_data as fd
    from spark_timeseries_tpu_torch.statespace import fleet, serving
    from spark_timeseries_tpu_torch.utils import telemetry

    sched = fleet.FleetScheduler(auto_pump=False, device="cpu")
    for lbl in ("a0", "a1"):
        sched.attach(serving.ServingSession.start(
            fd.port_model(lbl), fd.history(lbl), label=lbl, device="cpu"))
    ticks = {lbl: fd.ticks(lbl) for lbl in ("a0", "a1")}
    with races.instrument() as h:
        stop = {"flag": False}

        def scraper():
            while not stop["flag"]:
                telemetry.snapshot_doc()
                telemetry.fleet_summaries()

        t = h.spawn(scraper, label="scraper")
        for k in range(6):
            for lbl in sched.tenants:
                sched.submit(lbl, ticks[lbl][:, k])
            sched.pump(force=True)
        stop["flag"] = True
        t.join(30.0)
        h.raise_errors()
        h.assert_acyclic()
    assert sched.stats()["tenants"] == 2


def test_journal_commit_vs_flightrec_read_instrumented(tmp_path,
                                                       monkeypatch):
    from spark_timeseries_tpu_torch.utils import flightrec, telemetry

    monkeypatch.setenv("STS_INCIDENT_DIR", str(tmp_path / "incidents"))
    v = _ar_panel(48, 48, seed=6)
    with races.instrument() as h:
        stop = {"flag": False}

        def reader():
            while not stop["flag"]:
                flightrec.list_incidents(limit=4)
                telemetry.snapshot_doc()

        t = h.spawn(reader, label="reader")
        out = engine.FitEngine().stream_fit(
            v, "ar", chunk_size=16, max_lag=2, device="cpu",
            journal=str(tmp_path / "journal"))
        stop["flag"] = True
        t.join(30.0)
        h.raise_errors()
        h.assert_acyclic()
    assert out.n_fitted == 48
    assert out.stats["journal_commits"] == 3
