"""The port's fleet scheduler (``statespace.fleet``) against the JAX
package's, on the CPU in float64.

Four ARIMA(2,1,2)+c tenants and two additive Holt-Winters tenants of 4
series (``torch_fleet_cases``), built in the JAX package and carried
across with ``models.convert``, go through the same scenario in both
packages: coalesced rounds, the three admission policies under
``tenant_flood``, ``coalesce_straggler`` and the window-deadline flush,
the SLO shed / restore ladder (the dispatch latency fixed by the test,
so that the ladder runs the same everywhere), and the forecast cache.
TickResult floats and forecasts agree within 1e-10 relative; statuses,
reports, counters and lineage outcomes exactly.  The port is also held
against itself: coalesced ticks bitwise the per-session ticks, a shed
tenant's catch-up bitwise, ``drain`` / ``adopt`` bitwise (in process and
across a ``kill -9`` child), ``warmup`` changing nothing.  Each JAX
scenario runs once per module."""

import functools
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from spark_timeseries_tpu_torch.statespace import fleet as t_fleet
from spark_timeseries_tpu_torch.utils import checkpoint as t_ckpt
from spark_timeseries_tpu_torch.utils import lineage as t_lineage
from spark_timeseries_tpu_torch.utils import metrics as t_metrics
from spark_timeseries_tpu_torch.utils import resilience as t_res
from torch_fleet_cases import (JAX, LABELS, N_ARIMA, N_HIST, PORT, S,
                               assert_views_close, bitwise, close,
                               fixed_latency, fleet_counters,
                               lineage_counts, record_ticks,
                               scheduler, session, session_view, ticks)

pytestmark = pytest.mark.fleet

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROUNDS = 6


# ---------------------------------------------------------------------------
# the scenarios, each driven the same way through either package
# ---------------------------------------------------------------------------

def _coalesce(api):
    """Every tenant ticks each round; one pump a round: one dispatch per
    group.  Returns the reports, every absorbed TickResult, the end
    views, forecasts, counters and lineage outcomes."""
    api.lineage.reset()
    sched, reg = scheduler(api, LABELS)
    logs = {la: [] for la in LABELS}
    for la in LABELS:
        record_ticks(sched.session(la), logs[la])
    reports = []
    for t in range(ROUNDS):
        for la in LABELS:
            sched.submit(la, ticks(la)[:, t])
        reports.append(sorted((r["key"][1], r["tenants"], r["slots"])
                              for r in sched.pump()))
    return {"reports": reports, "logs": logs,
            "views": {la: session_view(sched.session(la)) for la in LABELS},
            "forecasts": {la: sched.forecast(la, 4) for la in LABELS},
            "counters": fleet_counters(reg), "lineage": lineage_counts(api),
            "n_groups": sched.n_groups, "stats": sched.stats()}


def _admission(api, mode):
    api.lineage.reset()
    out = {}
    if mode == "reject":
        sched, reg = scheduler(api, ["a0", "a1"], api.fleet.AdmissionPolicy(
            queue_depth=3, on_full="reject"))
        try:
            with api.res.fault_injection("tenant_flood", n_attempts=16):
                sched.submit("a0", ticks("a0")[:, 0])
        except api.fleet.FleetSaturated as e:
            out["raised"] = "a0" in str(e) and "queue is full" in str(e)
        out["after_flood"] = fleet_counters(reg)
        for _ in range(3):                   # one tick a tenant a pump
            sched.pump(force=True)
        sched.submit("a0", ticks("a0")[:, 1])
        sched.submit("a1", ticks("a1")[:, 1])
        sched.pump()
    elif mode == "drop_oldest":
        sched, reg = scheduler(api, ["a0"], api.fleet.AdmissionPolicy(
            queue_depth=2, on_full="drop_oldest"))
        for k in range(5):
            sched.submit("a0", ticks("a0")[:, k])
        out["queued"] = [np.array(q[0]) for q in sched._require("a0").queue]
        sched.pump(force=True)
        sched.pump(force=True)
    else:
        sched, reg = scheduler(api, ["a0"], api.fleet.AdmissionPolicy(
            queue_depth=2, on_full="degrade", shed_cooldown=1))
        out["primed"] = sched.forecast("a0", 4)
        for k in range(4):
            sched.submit("a0", ticks("a0")[:, k])
        t = sched._require("a0")
        out["shed"] = (t.mode, t.shed_reason)
        out["cache_read"] = sched.forecast("a0", 2)
        modes = []
        for _ in range(3):
            sched.pump()
            modes.append(t.mode)
        out["modes"] = modes
    out.update(counters=fleet_counters(reg), lineage=lineage_counts(api),
               views={la: session_view(sched.session(la))
                      for la in sched.tenants})
    return out


def _straggler(api):
    api.lineage.reset()
    sched, reg = scheduler(api, ["a0", "a1", "a2"],
                           api.fleet.AdmissionPolicy(coalesce_window_s=10.0))
    with api.res.fault_injection("coalesce_straggler", lane_stride=3):
        for la in ("a0", "a1", "a2"):
            sched.submit(la, ticks(la)[:, 0])
        first = [r["tenants"] for r in sched.pump()]
    seen = [sched.session(la).ticks_seen for la in ("a0", "a1", "a2")]
    second = [r["tenants"] for r in sched.pump(force=True)]
    return {"first": first, "seen": seen, "second": second,
            "views": {la: session_view(sched.session(la))
                      for la in sched.tenants},
            "counters": fleet_counters(reg), "lineage": lineage_counts(api)}


def _window_deadline(api):
    api.lineage.reset()
    sched, reg = scheduler(api, ["a0", "a1"],
                           api.fleet.AdmissionPolicy(coalesce_window_s=0.02))
    sched.submit("a0", ticks("a0")[:, 0])      # a1 stays silent
    waiting = sched.pump()
    time.sleep(0.05)
    flushed = [r["tenants"] for r in sched.pump()]
    detours = [r["detours"] for r in api.lineage.records()]
    return {"waiting": waiting, "flushed": flushed, "detours": detours,
            "views": {la: session_view(sched.session(la))
                      for la in sched.tenants},
            "counters": fleet_counters(reg), "lineage": lineage_counts(api)}


def _shed_ladder(api):
    """a1 carries quarantined lanes; every dispatch burns a 5 ms SLO
    until a tenant sheds; reads serve the cache; then the burn clears
    and the ladder restores and replays."""
    api.lineage.reset()
    reg = api.metrics.MetricsRegistry()
    sessions = [session(api, la, reg) for la in ("a0", "a1")]
    with api.res.fault_injection("state_poison", lane_stride=2):
        sessions[1].update(ticks("a1")[:, 0])
    sessions[0].update(ticks("a0")[:, 0])
    sched = api.fleet.FleetScheduler(
        api.fleet.AdmissionPolicy(slo_window=4, shed_cooldown=2,
                                  cache_staleness=16, catchup_ring=64),
        registry=reg, auto_pump=False, **api.kw)
    for s in sessions:
        sched.attach(s)
    sched._slo_ms = 5.0
    latency = [1.0]
    fixed_latency(sched, latency)
    primed = {la: sched.forecast(la, 4) for la in sched.tenants}
    modes = []
    t = 1
    while t < 12:
        for la in ("a0", "a1"):
            sched.submit(la, ticks(la)[:, t])
        sched.pump()
        t += 1
        modes.append([sched._tenants[la].mode for la in ("a0", "a1")])
        if t_fleet.TENANT_SHED in modes[-1]:
            break
    dispatches = reg.snapshot()["counters"]["fleet.coalesced_dispatches"]
    reads = [sched.forecast("a1", 4), sched.forecast("a1", 4)]
    no_tick_work = reg.snapshot()["counters"][
        "fleet.coalesced_dispatches"] == dispatches
    latency[0] = 1e-4
    for _ in range(8):
        for la in ("a0", "a1"):
            sched.submit(la, ticks(la)[:, t])
        sched.pump()
        t += 1
        modes.append([sched._tenants[la].mode for la in ("a0", "a1")])
    return {"primed": primed, "modes": modes, "reads": reads,
            "no_tick_work": no_tick_work, "ticks": t,
            "views": {la: session_view(sched.session(la))
                      for la in ("a0", "a1")},
            "forecasts": {la: sched.forecast(la, 4) for la in ("a0", "a1")},
            "counters": fleet_counters(reg), "lineage": lineage_counts(api)}


def _cache(api):
    """A long-shed tenant's cache phase keeps advancing past a saturated
    catch-up ring: stale, refreshed, served, stale again."""
    api.lineage.reset()
    sched, reg = scheduler(api, ["h0"], api.fleet.AdmissionPolicy(
        catchup_ring=4, cache_staleness=2, shed_cooldown=100))
    out = {"primed": sched.forecast("h0", 3)}
    sched._shed(sched._require("h0"), reason="slo")
    for k in range(10):
        sched.submit("h0", ticks("h0")[:, k])
    t = sched._require("h0")
    out["ring"] = len(t.catchup)
    out["elapsed"] = t.elapsed_since_cache()
    out["reads"] = [sched.forecast("h0", 3), sched.forecast("h0", 3)]
    for k in range(10, 14):
        sched.submit("h0", ticks("h0")[:, k])
    out["reads"].append(sched.forecast("h0", 3))
    out.update(counters=fleet_counters(reg), lineage=lineage_counts(api))
    return out


SCENARIOS = {"coalesce": _coalesce, "straggler": _straggler,
             "window_deadline": _window_deadline,
             "shed_ladder": _shed_ladder, "cache": _cache,
             "reject": functools.partial(_admission, mode="reject"),
             "drop_oldest": functools.partial(_admission,
                                              mode="drop_oldest"),
             "degrade": functools.partial(_admission, mode="degrade")}


@functools.lru_cache(maxsize=None)
def _run(name, pkg):
    return SCENARIOS[name](JAX if pkg == "jax" else PORT)


def _assert_same(got, want):
    """Recursive comparison: floats within RTOL, the rest exactly."""
    if isinstance(want, dict):
        assert set(got) == set(want)
        for k in want:
            _assert_same(got[k], want[k])
    elif isinstance(want, (list, tuple)) and not hasattr(want, "_fields"):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _assert_same(g, w)
    elif hasattr(want, "_fields"):
        for g, w in zip(got, want):
            close(g, w)
    elif isinstance(want, np.ndarray) or hasattr(want, "__array__"):
        close(got, want)
    elif isinstance(want, float):
        close(got, want)
    else:
        assert got == want


# ---------------------------------------------------------------------------
# against the JAX package
# ---------------------------------------------------------------------------

def test_coalesced_rounds_match_jax():
    got, want = _run("coalesce", "port"), _run("coalesce", "jax")
    # one dispatch per group and round: the four ARIMA tenants at 4
    # slots, the two Holt-Winters tenants at 2
    assert want["reports"][0] == [("arima", N_ARIMA, 4),
                                  ("holt_winters", 2, 2)]
    assert got["reports"] == want["reports"]
    assert got["n_groups"] == want["n_groups"] == 2
    for la in LABELS:
        assert len(got["logs"][la]) == len(want["logs"][la]) == ROUNDS
        for g, w in zip(got["logs"][la], want["logs"][la]):
            for gf, wf in zip(g, w):
                close(gf, wf)
            assert g.status.dtype == np.int32
        assert_views_close(got["views"][la], want["views"][la])
        close(got["forecasts"][la], want["forecasts"][la])
    assert got["counters"] == want["counters"]
    assert got["lineage"] == want["lineage"] == {
        "started": ROUNDS * len(LABELS),
        "outcomes": {"delivered": ROUNDS * len(LABELS)}, "open": 0,
        "duplicates": 0}
    assert got["stats"]["tenants"] == want["stats"]["tenants"]


@pytest.mark.parametrize("mode", ["reject", "drop_oldest", "degrade"])
def test_admission_policies_match_jax(mode):
    got, want = _run(mode, "port"), _run(mode, "jax")
    _assert_same(got, want)
    c = got["counters"]
    if mode == "reject":
        assert got["raised"]
        assert got["after_flood"]["fleet.admitted"] == 3
        assert got["after_flood"]["fleet.rejected"] >= 1
    elif mode == "drop_oldest":
        assert c["fleet.dropped_ticks"] == 3
        np.testing.assert_array_equal(got["queued"][0], ticks("a0")[:, 3])
    else:
        assert got["shed"] == (t_fleet.TENANT_SHED, "admission")
        assert got["modes"][-1] == t_fleet.TENANT_LIVE
        assert got["views"]["a0"]["ticks_seen"] == N_HIST + 4
    assert got["lineage"]["open"] == 0


def test_straggler_and_window_deadline_match_jax():
    got, want = _run("straggler", "port"), _run("straggler", "jax")
    _assert_same(got, want)
    # the silent tenant delayed only itself, then flushed alone
    assert got["first"] == [2] and got["second"] == [1]
    assert got["seen"] == [N_HIST, N_HIST + 1, N_HIST + 1]
    got, want = (_run("window_deadline", "port"),
                 _run("window_deadline", "jax"))
    _assert_same(got, want)
    assert got["waiting"] == [] and got["flushed"] == [1]
    assert got["detours"] == [["window_deadline"]]


def test_shed_ladder_matches_jax():
    got, want = _run("shed_ladder", "port"), _run("shed_ladder", "jax")
    _assert_same(got, want)
    shed = [m for m in got["modes"] if t_fleet.TENANT_SHED in m]
    # the quarantine-laden tenant sheds first, and everything restores
    assert shed and shed[0] == [t_fleet.TENANT_LIVE, t_fleet.TENANT_SHED]
    assert got["modes"][-1] == [t_fleet.TENANT_LIVE] * 2
    assert got["no_tick_work"]
    np.testing.assert_array_equal(got["reads"][0], got["reads"][1])
    c = got["counters"]
    assert c["fleet.shed_lanes"] >= S and c["fleet.slo_burns"] >= 1
    assert c["fleet.restored_tenants"] >= 1 and c["fleet.cache_serves"] >= 1
    for la in ("a0", "a1"):
        assert got["views"][la]["ticks_seen"] == N_HIST + got["ticks"]
    assert got["lineage"]["open"] == 0


def test_forecast_cache_phase_matches_jax():
    got, want = _run("cache", "port"), _run("cache", "jax")
    _assert_same(got, want)
    assert got["ring"] == 4 and got["elapsed"] == 10
    c = got["counters"]
    assert c["fleet.cache_stale"] == 2 and c["fleet.cache_serves"] == 1


# ---------------------------------------------------------------------------
# the port against itself
# ---------------------------------------------------------------------------

def test_coalesced_ticks_bitwise_equal_per_session():
    """Every TickResult, the end state and the forecasts of each
    coalesced tenant equal those of a solo session fed the same ticks,
    bit for bit."""
    got = _run("coalesce", "port")
    for la in LABELS:
        solo = session(PORT, la, t_metrics.MetricsRegistry())
        for t in range(ROUNDS):
            bitwise(solo.update(ticks(la)[:, t]), got["logs"][la][t])
        view = session_view(solo)
        for k in ("a", "P", "loglik", "ew", "status", "ring"):
            bitwise([view[k]], [got["views"][la][k]])
        bitwise([solo.forecast(4)], [got["forecasts"][la]])


def test_shed_restore_catchup_is_bitwise_sequential():
    """A tenant that rode out an overload window shed and restored lands
    bit for bit where a never-shed session fed the same stream lands."""
    sched, _ = scheduler(PORT, ["a0"], t_fleet.AdmissionPolicy(
        slo_window=4, shed_cooldown=100, catchup_ring=64))
    mirror = session(PORT, "a0", t_metrics.MetricsRegistry())
    y = ticks("a0")
    for t in range(4):
        sched.submit("a0", y[:, t])
        sched.pump()
    sched._shed(sched._require("a0"), reason="slo")
    for t in range(4, 9):
        sched.submit("a0", y[:, t])
        sched.pump()
    assert sched.session("a0").ticks_seen == N_HIST + 4
    sched._restore(sched._require("a0"))
    for t in range(9, 12):
        sched.submit("a0", y[:, t])
        sched.pump()
    for t in range(12):
        mirror.update(y[:, t])
    sess = sched.session("a0")
    bitwise(sess._state, mirror._state)
    bitwise([sched.forecast("a0", 6)], [mirror.forecast(6)])


def test_drain_adopt_roundtrip_bitwise(tmp_path):
    """Queued ticks ride the bundle (with their offsets, and a catch-up
    ring's too); adopt replays them, or with ``replay=False`` parks them
    at the front of the live queue in stream order."""
    for replay in (True, False):
        sched, _ = scheduler(PORT, ["a1"], t_fleet.AdmissionPolicy(
            shed_cooldown=100))
        mirror = session(PORT, "a1", t_metrics.MetricsRegistry())
        y = ticks("a1")
        offs = np.random.default_rng(31).normal(size=y.shape) * 0.1
        for t in range(3):
            sched.submit("a1", y[:, t], offset=offs[:, t])
            sched.pump(force=True)
        sched._shed(sched._require("a1"), reason="slo")
        sched.submit("a1", y[:, 3], offset=offs[:, 3])   # -> catch-up
        t = sched._require("a1")
        t.mode = t_fleet.TENANT_LIVE
        sched._shed_order.remove("a1")
        t.shed_reason = None
        sched.submit("a1", y[:, 4], offset=offs[:, 4])   # -> pending
        sched.submit("a1", y[:, 5], offset=offs[:, 5])
        path = str(tmp_path / f"a1-{replay}")
        rep = sched.drain("a1", path)
        assert rep["pending"] == 2 and rep["catchup"] == 1
        assert sched.tenants == []
        dest, _ = scheduler(PORT, [])
        assert dest.adopt(path, replay=replay) == "a1"
        if not replay:
            assert dest._require("a1").arrived == 3
            dest.submit("a1", y[:, 6], offset=offs[:, 6])
            for _ in range(4):
                dest.pump(force=True)
        n = 6 if replay else 7
        for k in range(n):
            mirror.update(y[:, k], offs[:, k])
        sess = dest.session("a1")
        assert sess.ticks_seen == mirror.ticks_seen == N_HIST + n
        bitwise(sess._state, mirror._state)
        bitwise([dest.forecast("a1", 4)], [mirror.forecast(4)])


def test_adopt_names_each_mismatched_field(tmp_path):
    sched, _ = scheduler(PORT, ["a0"])
    path = str(tmp_path / "ok")
    sched.drain("a0", path)
    blob = t_ckpt.load_pytree(path)

    def adopt(bundle, name):
        p = str(tmp_path / name)
        t_ckpt.save_pytree_atomic(p, bundle)
        return scheduler(PORT, [])[0].adopt(p)

    for name, bad, match in (
            ("format", dict(blob, format=99), "format"),
            ("label", dict(blob, label="no way"), "label"),
            ("pending", dict(blob, pending=np.zeros((1, S + 3))),
             "pending"),
            ("catchup", dict(blob, catchup=np.zeros(3)), "catchup"),
            ("session", dict(blob, session=dict(blob["session"],
                                                bucket=16)),
             "session half")):
        with pytest.raises(t_fleet.FleetRestoreMismatch, match=match):
            adopt(bad, name)
    with pytest.raises(t_fleet.FleetRestoreMismatch, match="cannot be read"):
        scheduler(PORT, [])[0].adopt(str(tmp_path / "missing"))
    dest, _ = scheduler(PORT, [])
    dest.adopt(path)
    with pytest.raises(t_fleet.FleetRestoreMismatch, match="exactly one"):
        dest.adopt(path)


def test_warmup_changes_no_state_counters_or_lineage():
    """The ticks after a warmup are bit for bit the ticks without one;
    warmup moves no counter and begins no lineage record."""
    runs = []
    for warm in (False, True):
        t_lineage.reset()
        sched, reg = scheduler(PORT, LABELS)
        before = (reg.snapshot()["counters"], lineage_counts(PORT))
        if warm:
            sched.warmup()
            assert (reg.snapshot()["counters"],
                    lineage_counts(PORT)) == before
        # a partial flush (two ARIMA tenants) and full rounds
        for la in ("a0", "a1"):
            sched.submit(la, ticks(la)[:, 0])
        sched.pump(force=True)
        for t in range(1, 3):
            for la in LABELS:
                sched.submit(la, ticks(la)[:, t])
            sched.pump()
        runs.append(({la: session_view(sched.session(la)) for la in LABELS},
                     fleet_counters(reg), lineage_counts(PORT)))
    (v0, c0, l0), (v1, c1, l1) = runs
    assert c0 == c1 and l0 == l1
    for la in LABELS:
        for k in ("a", "P", "loglik", "ew", "status", "ring"):
            bitwise([v1[la][k]], [v0[la][k]])


def test_plumbing_validation_and_gather_cache():
    with pytest.raises(ValueError, match="queue_depth"):
        t_fleet.AdmissionPolicy(queue_depth=0).validate()
    with pytest.raises(ValueError, match="on_full"):
        t_fleet.AdmissionPolicy(on_full="banana").validate()
    assert [t_fleet._slots_for(n) for n in (1, 2, 3, 4, 5, 8, 9)] \
        == [1, 2, 4, 4, 8, 8, 16]
    with pytest.raises(ValueError, match="fleet fault"):
        t_res.fleet_fault("banana")
    sched, reg = scheduler(PORT, ["a0", "a1"])
    assert sched.tenants == ["a0", "a1"] and sched.n_groups == 1
    with pytest.raises(ValueError, match="already attached"):
        sched.attach(sched.session("a0"))
    with pytest.raises(KeyError, match="no tenant"):
        sched.submit("nope", np.zeros(S))
    sched.submit("a0", ticks("a0")[:, 0])
    with pytest.raises(ValueError, match="a1.*one tick per series"):
        sched.submit("a1", np.zeros(S + 2))
    with pytest.raises(ValueError, match="a1.*offset per series"):
        sched.submit("a1", np.zeros(S), offset=np.zeros(S + 1))
    assert len(sched._require("a0").queue) == 1
    sched.submit("a1", ticks("a1")[:, 0])
    assert sched.pump()[0]["tenants"] == 2
    # the gathered SSM is reused until a member's SSM object changes
    for t in (1, 2):
        for la in ("a0", "a1"):
            sched.submit(la, ticks(la)[:, t])
        sched.pump()
    (_, gathered), = sched._gather_cache.values()
    sess = sched.session("a0")
    sess._ssm = type(sess._ssm)(*(x.clone() for x in sess._ssm))
    for la in ("a0", "a1"):
        sched.submit(la, ticks(la)[:, 3])
    sched.pump()
    (_, regathered), = sched._gather_cache.values()
    assert regathered is not gathered
    # a detached session owns its tensors and keeps serving
    det = sched.detach("a1")
    assert det._state.a.untyped_storage().nbytes() \
        == det._state.a.numel() * det._state.a.element_size()
    det.update(ticks("a1")[:, 4])
    # a scheduler's device is CUDA unless asked otherwise, with no
    # silent CPU path; a session on another device does not attach
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            t_fleet.FleetScheduler()
    summary = sched.telemetry_summary()
    assert [r["tenant"] for r in summary["tenant_rows"]] == ["a0"]


_MIGRATE_CHILD = """
import os, sys
sys.path.insert(0, os.environ["STS_TEST_TESTS"])
from torch_fleet_data import history, port_model, ticks
from spark_timeseries_tpu_torch.statespace import fleet, serving
from spark_timeseries_tpu_torch.utils import resilience
sched = fleet.FleetScheduler(auto_pump=False, device="cpu")
sched.attach(serving.ServingSession.start(
    port_model("a2"), history("a2"), label="a2", device="cpu"))
for t in range(12):
    sched.submit("a2", ticks("a2")[:, t])
    sched.pump()
sched.submit("a2", ticks("a2")[:, 12])   # two undispatched ticks ride
sched.submit("a2", ticks("a2")[:, 13])   # the bundle
with resilience.fault_injection("drop_tenant_process"):
    sched.drain("a2", os.environ["STS_TEST_BUNDLE"])
print("UNREACHABLE: drain survived drop_tenant_process", flush=True)
raise SystemExit(3)
"""


def test_drain_kill9_adopt_subprocess_pair(tmp_path):
    """A process SIGKILLed the instant its drain bundle commits loses
    nothing: this process adopts the bundle, replays the queued ticks,
    and the tenant's state and forecasts are bitwise an uninterrupted
    session's."""
    bundle = str(tmp_path / "a2")
    inc_dir = str(tmp_path / "incidents")
    env = dict(os.environ, STS_TEST_BUNDLE=bundle, STS_INCIDENT_DIR=inc_dir,
               STS_TEST_TESTS=os.path.join(REPO, "tests"),
               PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH",
                                                             ""))
    out = subprocess.run([sys.executable, "-c", _MIGRATE_CHILD],
                         capture_output=True, text=True, cwd=REPO, env=env,
                         timeout=120)
    assert out.returncode == -9, (out.returncode, out.stderr[-2000:])
    assert os.path.exists(bundle + ".npz")
    assert any("drop_tenant_process" in f for f in os.listdir(inc_dir))
    sched, _ = scheduler(PORT, [])
    assert sched.adopt(bundle) == "a2"
    mirror = session(PORT, "a2", t_metrics.MetricsRegistry())
    y = ticks("a2")
    for t in range(14):
        mirror.update(y[:, t])
    sess = sched.session("a2")
    assert sess.ticks_seen == mirror.ticks_seen == N_HIST + 14
    bitwise(sess._state, mirror._state)
    for t in range(14, 18):
        sched.submit("a2", y[:, t])
        sched.pump()
        mirror.update(y[:, t])
    bitwise([sched.forecast("a2", 6)], [mirror.forecast(6)])
