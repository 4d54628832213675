"""The port's supervised fleet runtime (``statespace.runtime``) on the
CPU in float64: asynchronous delivery (bitwise the per-session ticks,
and within 1e-10 of the JAX package's sessions fed the same ticks),
backpressure and its timeout, a ``pump_crash`` restart with exactly-once
lineage, the ``pump_hang`` watchdog, checkpoint generations (committed,
pruned, restored, torn, failed), rebalancing, and a device fault in the
pump raised to the caller instead of restarted.

Tenants come from ``torch_fleet_cases`` (built in the JAX package and
carried across with ``models.convert``).  Every blocking call has a
timeout and every runtime is stopped in a ``finally``."""

import functools
import os
import threading
import time

import numpy as np
import pytest
import torch

from spark_timeseries_tpu_torch._device import KernelError
from spark_timeseries_tpu_torch.models import convert as mconv
from spark_timeseries_tpu_torch.statespace import fleet as t_fleet
from spark_timeseries_tpu_torch.statespace import runtime as t_runtime
from spark_timeseries_tpu_torch.statespace import serving as t_serving
from spark_timeseries_tpu_torch.utils import lineage as t_lineage
from spark_timeseries_tpu_torch.utils import metrics as t_metrics
from spark_timeseries_tpu_torch.utils import resilience as t_res
from torch_fleet_cases import (JAX, LABELS, N_HIST, PORT, S, bitwise,
                               close, history, scheduler, session,
                               session_view, ticks)

pytestmark = pytest.mark.runtime

torch.set_num_threads(1)

WAIT = 60.0                  # seconds any blocking call may take here
RuntimePolicy = t_runtime.RuntimePolicy
FleetRuntime = t_runtime.FleetRuntime


def _runtime(labels, *, policy=None, admission=None, n_shards=1,
             warm=True):
    reg = t_metrics.MetricsRegistry()
    shards = [scheduler(PORT, [], admission, registry=reg)[0]
              for _ in range(n_shards)]
    for i, la in enumerate(labels):
        shards[i % n_shards].attach(session(PORT, la, reg))
    rt = FleetRuntime(shards if n_shards > 1 else shards[0],
                      policy=policy, registry=reg)
    if warm:
        rt.warmup()
    return rt, reg


def _mirrors(labels):
    return {la: session(PORT, la, t_metrics.MetricsRegistry())
            for la in labels}


def _assert_bitwise(rt, mirrors):
    for la, mirror in mirrors.items():
        _, t = rt._find(la)
        assert t.session.ticks_seen == mirror.ticks_seen
        bitwise(t.session._state, mirror._state)


def _stop(rt):
    try:
        rt.stop(checkpoint=False)
    except KernelError:
        pass


@functools.lru_cache(maxsize=None)
def _jax_views(n_ticks):
    """The JAX package's sessions fed each tenant's first ``n_ticks``
    ticks one by one."""
    reg = JAX.metrics.MetricsRegistry()
    out = {}
    for la in LABELS:
        s = session(JAX, la, reg)
        for t in range(n_ticks):
            s.update(ticks(la)[:, t])
        out[la] = (session_view(s), s.forecast(5))
    return out


def test_policy_validation_and_lifecycle():
    with pytest.raises(ValueError, match="pump_interval_s"):
        RuntimePolicy(pump_interval_s=0).validate()
    with pytest.raises(ValueError, match="keep_generations"):
        RuntimePolicy(keep_generations=0).validate()
    with pytest.raises(ValueError, match="rebalance_imbalance"):
        RuntimePolicy(rebalance_imbalance=0.5).validate()
    with pytest.raises(ValueError, match="checkpoint_dir"):
        RuntimePolicy(checkpoint_dirty_ticks=8).validate()
    assert RuntimePolicy().validate() == RuntimePolicy()
    for mode in ("pump_crash", "pump_hang", "checkpoint_torn"):
        assert t_res.fleet_fault(mode) is None
    a, _ = scheduler(PORT, ["a0"])
    b, _ = scheduler(PORT, [])
    b.attach(session(PORT, "a0", t_metrics.MetricsRegistry()))
    with pytest.raises(ValueError, match="unique"):
        FleetRuntime([a, b])
    # start once, stop idempotent; an unstarted runtime does not block
    rt, _ = _runtime(["a0"], admission=t_fleet.AdmissionPolicy(
        queue_depth=2), warm=False)
    try:
        rt.submit("a0", ticks("a0")[:, 0])
        rt.submit("a0", ticks("a0")[:, 1])
        with pytest.raises(t_fleet.FleetSaturated):
            rt.submit("a0", ticks("a0")[:, 2], block=True)
        assert [rt.pump_once() for _ in range(3)] == [1, 1, 0]
        with rt:
            assert rt.running
            with pytest.raises(RuntimeError, match="already"):
                rt.start()
    finally:
        _stop(rt)
    rt.stop()
    with pytest.raises(RuntimeError, match="stopped"):
        rt.start()


def test_async_delivery_bitwise_and_against_jax():
    rt, reg = _runtime(LABELS)
    mirrors = _mirrors(LABELS)
    n = 8
    try:
        with rt:
            for t in range(n):
                for la in LABELS:
                    rt.submit(la, ticks(la)[:, t], block=True, timeout=WAIT)
            assert rt.quiesce(timeout=WAIT)
            fc = rt.forecast("a0", 5)
    finally:
        _stop(rt)
    for la in LABELS:
        for t in range(n):
            mirrors[la].update(ticks(la)[:, t])
    _assert_bitwise(rt, mirrors)
    bitwise([fc], [mirrors["a0"].forecast(5)])
    want = _jax_views(n)
    for la in LABELS:
        got = session_view(rt._find(la)[1].session)
        assert got["ticks_seen"] == want[la][0]["ticks_seen"]
        np.testing.assert_array_equal(got["status"], want[la][0]["status"])
        for k in ("a", "P", "loglik", "ew"):
            close(got[k], want[la][0][k])
    close(fc, want["a0"][1])
    assert rt.pump_summary()["restarts"] == 0
    assert reg.snapshot()["counters"].get("fleet.pump_restarts", 0) == 0


def test_backpressure_blocks_then_times_out():
    rt, reg = _runtime(["a0"], admission=t_fleet.AdmissionPolicy(
        queue_depth=2), policy=RuntimePolicy(stall_after_s=30.0))
    mirror = _mirrors(["a0"])
    y = ticks("a0")
    try:
        with t_res.fault_injection("pump_hang", hang_s=1.0):
            with rt:
                # the first sweep sleeps outside the lock: nothing drains
                rt.submit("a0", y[:, 0], block=False)
                rt.submit("a0", y[:, 1], block=False)
                t0 = time.monotonic()
                with pytest.raises(t_runtime.FleetBackpressureTimeout,
                                   match="a0"):
                    rt.submit("a0", y[:, 2], block=True, timeout=0.3)
                assert time.monotonic() - t0 >= 0.3
                for t in range(2, 6):
                    rt.submit("a0", y[:, t], block=True, timeout=WAIT)
                assert rt.quiesce(timeout=WAIT)
    finally:
        _stop(rt)
    for t in range(6):
        mirror["a0"].update(y[:, t])
    _assert_bitwise(rt, mirror)
    c = reg.snapshot()["counters"]
    assert c["fleet.backpressure_timeouts"] == 1
    assert c["fleet.backpressure_waits"] >= 1
    assert c.get("fleet.rejected", 0) == 0


def test_pump_crash_restarts_with_exactly_once_lineage(tmp_path,
                                                      monkeypatch):
    monkeypatch.setenv("STS_INCIDENT_DIR", str(tmp_path / "incidents"))
    labels = ["a0", "a1", "h0"]
    rt, reg = _runtime(labels, policy=RuntimePolicy(
        pump_interval_s=0.002, watchdog_interval_s=0.01))
    mirrors = _mirrors(labels)
    t_lineage.reset()
    n = 8
    try:
        with t_res.fault_injection("pump_crash", n_attempts=3):
            with rt:
                for t in range(n):
                    for la in labels:
                        rt.submit(la, ticks(la)[:, t], block=True,
                                  timeout=WAIT)
                assert rt.quiesce(timeout=WAIT)
                summary = rt.pump_summary()
    finally:
        _stop(rt)
    assert summary["restarts"] >= 1
    c = reg.snapshot()["counters"]
    assert c["fleet.pump_restarts"] == summary["restarts"]
    assert c["fleet.pump_deaths"] >= 1
    doc = t_lineage.lineage_summary()
    assert doc["outcomes"] == {"delivered": n * len(labels)}
    assert doc["open"] == 0 and doc["duplicate_completions"] == 0
    for la in labels:
        for t in range(n):
            mirrors[la].update(ticks(la)[:, t])
    _assert_bitwise(rt, mirrors)
    names = os.listdir(tmp_path / "incidents")
    assert any("fleet_pump_death" in nm for nm in names)


def test_pump_hang_watchdog_recovers(tmp_path, monkeypatch):
    monkeypatch.setenv("STS_INCIDENT_DIR", str(tmp_path / "incidents"))
    monkeypatch.setenv("STS_TELEMETRY_STALE_FACTOR", "0.25")
    rt, reg = _runtime(["a0"], policy=RuntimePolicy(
        pump_interval_s=0.005, watchdog_interval_s=0.02,
        stall_after_s=0.4))
    assert rt.stale_after_s() == pytest.approx(0.25)
    try:
        with t_res.fault_injection("pump_hang", hang_s=1.2):
            with rt:
                deadline = time.monotonic() + WAIT
                while not rt.pump_health()["stale"]:
                    assert time.monotonic() < deadline, "never went stale"
                    time.sleep(0.01)
                while rt.pump_summary()["restarts"] < 1:
                    assert time.monotonic() < deadline, "never restarted"
                    time.sleep(0.01)
                while rt.pump_health()["stale"]:
                    assert time.monotonic() < deadline, "never recovered"
                    time.sleep(0.01)
                for t in range(3):
                    rt.submit("a0", ticks("a0")[:, t], block=True,
                              timeout=WAIT)
                assert rt.quiesce(timeout=WAIT)
                assert rt._find("a0")[1].session.ticks_seen == N_HIST + 3
    finally:
        _stop(rt)
    assert reg.snapshot()["counters"]["fleet.pump_restarts"] >= 1
    names = os.listdir(tmp_path / "incidents")
    assert any("fleet_pump_stall" in nm for nm in names)


def test_generations_commit_prune_restore_and_stay_bitwise(tmp_path):
    ck = str(tmp_path / "ck")
    labels = ["a0", "h1"]
    rt, reg = _runtime(labels, policy=RuntimePolicy(
        checkpoint_dir=ck, checkpoint_dirty_ticks=4, keep_generations=2))
    for _ in range(3):                       # three dirty-tick triggers
        for k in range(2):
            for la in labels:
                rt.submit(la, ticks(la)[:, k])
        rt.pump_once()
    assert reg.snapshot()["counters"]["fleet.checkpoints"] == 3
    assert [g for g, _ in FleetRuntime._scan_generations(ck)] == [2, 3]
    gen, gdir, manifest = FleetRuntime.latest_generation(ck)
    assert gen == 3 and manifest["format"] == 1
    assert {r["tenant"] for r in manifest["tenants"]} == set(labels)
    # two pending ticks a tenant ride the next generation
    for la in labels:
        rt.submit(la, ticks(la)[:, 2])
        rt.submit(la, ticks(la)[:, 3])
    rep = rt.checkpoint()
    assert rep["generation"] == 4 and rep["tenants"] == 2
    reg2 = t_metrics.MetricsRegistry()
    rt2 = FleetRuntime(scheduler(PORT, [], registry=reg2)[0],
                       policy=RuntimePolicy(checkpoint_dir=ck),
                       registry=reg2)
    assert sorted(rt2.restore_latest()) == sorted(labels)
    mirrors = _mirrors(labels)
    # the stream each tenant saw: ticks 0,1 three times, then 2 and 3
    for la in labels:
        for _ in range(3):
            for k in range(2):
                mirrors[la].update(ticks(la)[:, k])
        mirrors[la].update(ticks(la)[:, 2])
        mirrors[la].update(ticks(la)[:, 3])
    _assert_bitwise(rt2, mirrors)
    for t in range(4, 7):
        for la in labels:
            rt2.submit(la, ticks(la)[:, t])
            mirrors[la].update(ticks(la)[:, t])
        rt2.pump_once()
    _assert_bitwise(rt2, mirrors)
    bitwise([rt2.forecast("h1", 4)], [mirrors["h1"].forecast(4)])
    assert reg2.snapshot()["counters"]["fleet.restored_tenants"] == 2
    # stop() commits a final generation
    with rt2:
        pass
    assert FleetRuntime.latest_generation(ck)[0] == 5


def test_torn_and_failed_generations_never_commit(tmp_path):
    ck = str(tmp_path / "ck")
    rt, _ = _runtime(["a0"], policy=RuntimePolicy(checkpoint_dir=ck),
                     warm=False)
    rt.submit("a0", ticks("a0")[:, 0])
    rt.pump_once()
    assert rt.checkpoint()["generation"] == 1
    torn = os.path.join(ck, "gen-00000002")
    os.makedirs(torn)
    with open(os.path.join(torn, "a0.npz"), "wb") as f:
        f.write(b"half a bundle")
    assert FleetRuntime.latest_generation(ck)[0] == 1
    reg2 = t_metrics.MetricsRegistry()
    rt2 = FleetRuntime(scheduler(PORT, [], registry=reg2)[0],
                       policy=RuntimePolicy(checkpoint_dir=ck),
                       registry=reg2)
    assert rt2.restore_latest() == ["a0"]
    # numbered past the debris: generation 2 is never reused
    assert rt2.checkpoint()["generation"] == 3
    # a file squatting on the next generation's path: the pass fails,
    # counts, and commits nothing
    with open(os.path.join(ck, "gen-00000004"), "w") as f:
        f.write("in the way")
    assert rt2.checkpoint() is None
    assert reg2.snapshot()["counters"]["fleet.checkpoint_failures"] == 1
    assert FleetRuntime.latest_generation(ck)[0] == 3
    with pytest.raises(RuntimeError, match="checkpoint_dir"):
        _runtime(["a1"], warm=False)[0].checkpoint()


def test_rebalance_consolidates_then_spreads(tmp_path):
    labels = ["a0", "a1", "a2"]
    rt, reg = _runtime(labels, n_shards=2, policy=RuntimePolicy(
        checkpoint_dir=str(tmp_path / "ck")))
    mirrors = _mirrors(labels)
    for t in range(3):
        for la in labels:
            rt.submit(la, ticks(la)[:, t])
        rt.pump_once()
    assert sorted(rt.shards[1]._tenants) == ["a1"]
    moves = rt.rebalance()
    assert [(m["tenant"], m["from"], m["to"]) for m in moves] == \
        [("a1", rt.shards[1].label, rt.shards[0].label)]
    assert rt.rebalance() == []
    for t in range(3, 6):
        for la in labels:
            rt.submit(la, ticks(la)[:, t])
        rt.pump_once()
    for la in labels:
        for t in range(6):
            mirrors[la].update(ticks(la)[:, t])
    _assert_bitwise(rt, mirrors)
    # whole groups of different keys, 3 against 0: one tenant spreads
    reg2 = t_metrics.MetricsRegistry()
    shards = [scheduler(PORT, [], registry=reg2)[0] for _ in range(2)]
    rng = np.random.default_rng(3)
    for i, (p, q) in enumerate(((2, 0), (1, 0), (0, 1))):
        c = np.column_stack([rng.uniform(-0.1, 0.1, S)]
                            + [rng.uniform(0.1, 0.3, S)] * (p + q))
        m = mconv.arima_from_numpy(p, 0, q, c, device="cpu")
        shards[0].attach(t_serving.ServingSession.start(
            m, history("h0"), label=f"k{i}", registry=reg2, device="cpu"))
    rt2 = FleetRuntime(shards, registry=reg2, policy=RuntimePolicy(
        checkpoint_dir=str(tmp_path / "ck2")))
    moves = rt2.rebalance()
    assert len(moves) == 1 and moves[0]["to"] == shards[1].label
    assert (len(shards[0].tenants), len(shards[1].tenants)) == (2, 1)
    assert reg.snapshot()["counters"]["fleet.rebalanced_tenants"] == 1


def test_device_fault_in_the_pump_is_raised_not_restarted(tmp_path,
                                                          monkeypatch):
    """A kernel fault inside the coalesced tick stops the runtime: no
    restart, an incident, and the fault raised from the next submit,
    quiesce and stop."""
    monkeypatch.setenv("STS_INCIDENT_DIR", str(tmp_path / "incidents"))
    rt, reg = _runtime(["a0", "a1"], policy=RuntimePolicy(
        pump_interval_s=0.002, watchdog_interval_s=0.01))
    calls = []

    def broken(*args):
        calls.append(threading.current_thread().name)
        raise KernelError("injected kernel launch failure")

    monkeypatch.setattr(t_fleet, "_update_impl", broken)
    try:
        rt.start()
        for la in ("a0", "a1"):
            rt.submit(la, ticks(la)[:, 0], block=True, timeout=WAIT)
        with pytest.raises(KernelError, match="injected"):
            rt.quiesce(timeout=WAIT)
        with pytest.raises(KernelError, match="injected"):
            rt.submit("a0", ticks("a0")[:, 1], block=True, timeout=WAIT)
        time.sleep(0.1)                      # several watchdog periods
        summary = rt.pump_summary()
        with pytest.raises(KernelError, match="injected"):
            rt.stop()
    finally:
        _stop(rt)
    assert not rt.running
    assert summary["restarts"] == 0 and summary["device_fault"]
    assert len(calls) == 1 and "pump" in calls[0]
    c = reg.snapshot()["counters"]
    assert c.get("fleet.pump_restarts", 0) == 0
    assert c["fleet.pump_device_faults"] == 1
    names = os.listdir(tmp_path / "incidents")
    assert any("fleet_pump_device_fault" in nm for nm in names)
