"""The port's durable streaming against the JAX engine's, on the CPU.

The same small AR and ARIMA panels stream in chunks of 8 through both
engines at float64 under the same fault scope (``oom_chunk``,
``hang_chunk``, ``corrupt_journal``) and journals: the durability
counters, the failed ranges and their kinds are the JAX engine's, the
coefficients agree within the float64 ARIMA tolerance, and a resume is
bitwise the uninterrupted run.  The JAX engine runs each scenario once
per module.  Then the port alone: a ``kill -9`` child and its resume, a
card-style out-of-memory error (halved) beside a kernel fault (raised),
the resilient and Holt-Winters journals, spec refusals, progress,
incidents and the knobs' parsing.
"""

import json
import os
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

from spark_timeseries_tpu import engine as jengine
from spark_timeseries_tpu.utils import durability as jdur
from spark_timeseries_tpu.utils import resilience as jres
from spark_timeseries_tpu_torch import engine
from spark_timeseries_tpu_torch._device import KernelError
from spark_timeseries_tpu_torch.utils import durability, metrics, resilience

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARIMA_TOL = 6e-8      # ROADMAP's float64 ARIMA tolerance against the JAX fit
DEADLINE_S = 0.5
HANG_S = 1.5
COUNTERS = ("journal_hits", "journal_commits", "journal_corrupt",
            "degraded_chunks", "quarantined", "retry_attempts", "recovered",
            "dead_chunks", "abandoned_workers")


def _ar_panel(n_series, n_obs, seed):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(n_series, n_obs)).cumsum(axis=1)


def _arima_panel(n_series, n_obs, seed):
    rng = np.random.default_rng(seed)
    e = rng.normal(size=(n_series, n_obs + 16))
    y = np.zeros_like(e)
    for t in range(2, e.shape[1]):
        y[:, t] = 1.0 + 0.3 * y[:, t - 1] + e[:, t] + 0.4 * e[:, t - 1]
    return np.cumsum(y[:, 16:], axis=1)


AR = _ar_panel(40, 48, 1)
ARIMA = _arima_panel(24, 40, 2)
AR_KW = dict(family="ar", chunk_size=8, max_lag=2)
ARIMA_KW = dict(family="arima", chunk_size=8, p=1, d=1, q=1)


def _join_workers(timeout_s=10.0):
    """Wait until every abandoned watchdog worker has ended."""
    end = time.monotonic() + timeout_s
    while time.monotonic() < end:
        if not any(t.name.startswith("sts-chunk-")
                   for t in threading.enumerate()):
            return
        time.sleep(0.02)
    raise AssertionError("an abandoned chunk worker is still alive")


class _Pkg:
    """One package's engine, faults and backoff behind one interface."""

    def __init__(self, name):
        self.name = name
        self.torch = name == "torch"
        self.engine = engine if self.torch else jengine
        self.res = resilience if self.torch else jres
        self.dur = durability if self.torch else jdur
        self.eng = self.engine.FitEngine()

    def stream(self, values, family, **kw):
        if self.torch:
            kw["device"] = "cpu"
        return self.eng.stream_fit(values, family, **kw)


def _summary(res):
    return {"n_fitted": res.n_fitted, "n_chunks": res.n_chunks,
            **{k: res.stats[k] for k in COUNTERS},
            "failures": [(f["chunk_start"], f["chunk_stop"], f["kind"],
                          f["error_type"], f["attempts"])
                         for f in res.chunk_failures],
            "ranges": res.stats.get("collected_ranges")}


def _coefs(res):
    return np.concatenate([np.asarray(m.coefficients) for m in res.models])


def _scenarios(pkg, work):
    """Every fault scenario through one package: ``{name: [(summary,
    coefficients or None), ...]}``."""
    out = {}
    ar, ar_kw = AR, dict(AR_KW)
    fam = ar_kw.pop("family")
    if not pkg.torch:
        # compile the AR executables first: the deadlines below must race
        # only the injected hang
        pkg.eng.warmup(("ar",), [(8, AR.shape[1])], dtype=np.float64,
                       variants=("dense",), bucket=False, max_lag=2)

    def run(name, values=ar, family=fam, fault=None, kwargs=None, **kw):
        kw = {**(kwargs if kwargs is not None else ar_kw), **kw}
        if fault is None:
            res = pkg.stream(values, family, **kw)
        else:
            mode, fkw = fault
            with pkg.res.fault_injection(mode, **fkw):
                res = pkg.stream(values, family, **kw)
        out.setdefault(name, []).append(
            (_summary(res), _coefs(res) if res.models else None))

    j = os.path.join(work, pkg.name)
    run("journal", journal=j + "-ar", collect=True)
    run("journal", journal=j + "-ar", collect=True)
    run("journal", collect=True)
    # chunks of 8 halve to 4 lanes under a floor of 4
    run("oom_chunk", fault=("oom_chunk", dict(chunk_index=1)), retry=0,
        degrade_floor=4, collect=True)
    run("oom_at_floor", fault=("oom_chunk", dict(chunk_index=0)),
        degrade_floor=8, retry=0)
    run("degraded_resume", fault=("oom_chunk", dict(chunk_index=0)),
        journal=j + "-deg", collect=True, retry=0, degrade_floor=4)
    run("degraded_resume", journal=j + "-deg", collect=True)
    run("corrupt_journal", fault=("corrupt_journal", dict(chunk_index=1)),
        journal=j + "-cor", collect=True)
    run("corrupt_journal", journal=j + "-cor", collect=True)
    try:
        run("hang_deadline", fault=("hang_chunk",
                                    dict(chunk_index=1, hang_s=HANG_S)),
            deadline_s=DEADLINE_S, retry=0)
        run("retry_gate", fault=("hang_chunk",
                                 dict(chunk_index=0, hang_s=HANG_S)),
            deadline_s=DEADLINE_S,
            retry=pkg.dur.BackoffPolicy(max_retries=2, base_delay_s=0.01))
    finally:
        _join_workers()
    arima_kw = dict(ARIMA_KW)
    arima_fam = arima_kw.pop("family")
    run("arima_journal", ARIMA, arima_fam, kwargs=arima_kw,
        journal=j + "-arima", collect=True)
    run("arima_journal", ARIMA, arima_fam, kwargs=arima_kw,
        journal=j + "-arima", collect=True)
    return out


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    work = str(tmp_path_factory.mktemp("durability"))
    return {name: _scenarios(_Pkg(name), work) for name in ("jax", "torch")}


SCENARIOS = ("journal", "oom_chunk", "oom_at_floor", "degraded_resume",
             "corrupt_journal", "hang_deadline", "retry_gate",
             "arima_journal")


@pytest.mark.parametrize("name", SCENARIOS)
def test_faults_and_journals_count_like_jax(both, name):
    """Each run's durability counters, failed ranges and kinds are the
    JAX engine's; its coefficients agree with the JAX run's, and a
    journal's resume is bitwise the port's own first run and its
    journal-free run."""
    got, want = both["torch"][name], both["jax"][name]
    assert [s for s, _ in got] == [s for s, _ in want]
    tol = ARIMA_TOL if name == "arima_journal" else 1e-10
    for (_, c), (_, cj) in zip(got, want):
        if c is not None:
            np.testing.assert_allclose(c, cj, rtol=0, atol=tol)
    if name in ("journal", "degraded_resume", "corrupt_journal",
                "arima_journal"):
        np.testing.assert_array_equal(got[1][1], got[0][1])
    if name == "journal":
        np.testing.assert_array_equal(got[0][1], got[2][1])
    if name in ("oom_chunk", "degraded_resume"):
        # the halves are bitwise the whole chunk's lanes
        np.testing.assert_array_equal(got[0][1],
                                      both["torch"]["journal"][2][1])


_CHILD = r"""
import contextlib, hashlib, json, os, sys
import numpy as np
import torch
from spark_timeseries_tpu_torch import engine
from spark_timeseries_tpu_torch.utils import resilience
torch.set_num_threads(1)
rng = np.random.default_rng(0)
v = rng.normal(size=(32, 48)).cumsum(axis=1)
ctx = resilience.fault_injection("kill_after_chunk", chunk_index=1) \
    if os.environ.get("STS_TEST_KILL") == "1" else contextlib.nullcontext()
with ctx:
    res = engine.FitEngine().stream_fit(
        v, "ar", chunk_size=8, max_lag=2, collect=True, device="cpu",
        journal=os.environ.get("STS_TEST_JOURNAL") or None)
h = hashlib.sha256()
for m in res.models:
    h.update(np.ascontiguousarray(m.coefficients.numpy()).tobytes())
print(json.dumps({"sha": h.hexdigest(), "n_fitted": res.n_fitted,
                  "journal_hits": res.stats["journal_hits"],
                  "journal_commits": res.stats["journal_commits"]}))
"""


def test_kill9_child_then_resume_bitwise(tmp_path):
    """``kill_after_chunk`` SIGKILLs the child right after chunk 1's
    commit (its incident bundle first): two markers on disk; a resume
    restores them and fits only the rest, bitwise an uninterrupted run
    (the JAX engine's ``test_kill9_mid_stream_then_resume_bitwise``)."""
    jdir = str(tmp_path / "journal")
    env = dict(os.environ, STS_TEST_KILL="1", STS_TEST_JOURNAL=jdir,
               STS_INCIDENT_DIR=str(tmp_path / "incidents"))
    killed = subprocess.run([sys.executable, "-c", _CHILD], cwd=REPO,
                            env=env, capture_output=True, text=True,
                            timeout=120)
    assert killed.returncode == -9, killed.stderr[-2000:]
    assert len([f for f in os.listdir(jdir) if f.endswith(".ok")]) == 2
    assert any("kill_after_chunk" in n
               for n in os.listdir(tmp_path / "incidents"))
    rng = np.random.default_rng(0)
    v = rng.normal(size=(32, 48)).cumsum(axis=1)
    kw = dict(chunk_size=8, max_lag=2, collect=True, device="cpu")
    resumed = engine.FitEngine().stream_fit(v, "ar", journal=jdir, **kw)
    assert (resumed.stats["journal_hits"],
            resumed.stats["journal_commits"]) == (2, 2)
    whole = engine.FitEngine().stream_fit(v, "ar", **kw)
    np.testing.assert_array_equal(_coefs(resumed), _coefs(whole))


def test_device_oom_halves_and_kernel_fault_raises(monkeypatch):
    """A ``torch.cuda.OutOfMemoryError`` in a full chunk halves it (each
    half bitwise the whole run's lanes); a kernel fault is never
    isolated, retried or halved: it raises out of the stream."""
    real = engine._fit_values

    def oom_at_full(family, statics, values, warn=False, stats=None):
        if values.shape[0] == 16:
            raise torch.cuda.OutOfMemoryError("CUDA out of memory (test)")
        return real(family, statics, values, warn=warn, stats=stats)

    kw = dict(chunk_size=16, max_lag=2, collect=True, device="cpu",
              retry=1)
    whole = engine.FitEngine().stream_fit(AR, "ar", **kw)
    monkeypatch.setattr(engine, "_fit_values", oom_at_full)
    halved = engine.FitEngine().stream_fit(AR, "ar", **kw)
    # 40 series in chunks of 16: two full chunks halve, the 8-lane tail
    # (bucket 8) fits whole
    assert halved.stats["degraded_chunks"] == 2
    assert not halved.chunk_failures and halved.n_fitted == 40
    np.testing.assert_array_equal(_coefs(halved), _coefs(whole))

    def kernel_fault(*a, **k):
        raise KernelError("arma_lm_fit launch failed (test)")

    monkeypatch.setattr(engine, "_fit_values", kernel_fault)
    with pytest.raises(KernelError):
        engine.FitEngine().stream_fit(AR, "ar", **kw)


def test_resilient_and_holt_winters_journals_resume(tmp_path):
    """The resilient chain's chunks and the Holt-Winters box fit's
    commit and restore like the plain ARIMA stream's: the resume fits
    nothing and is bitwise, statuses included."""
    y = ARIMA[:16].copy()
    y[3] = np.nan                      # an unfittable row: skipped
    kw = dict(chunk_size=8, p=1, d=1, q=1, resilient=True, collect=True,
              device="cpu", max_iter=20)
    first = engine.FitEngine().stream_fit(
        y, "arima", journal=str(tmp_path / "res"), **kw)
    again = engine.FitEngine().stream_fit(
        y, "arima", journal=str(tmp_path / "res"), **kw)
    assert first.stats["journal_commits"] == 2
    assert again.stats["journal_hits"] == 2
    assert again.stats["resilient_statuses"] \
        == first.stats["resilient_statuses"]
    assert again.n_converged == first.n_converged
    np.testing.assert_array_equal(_coefs(again), _coefs(first))

    rng = np.random.default_rng(5)
    t = np.arange(24)
    hw = (20 + 0.1 * t + 3 * np.sin(2 * np.pi * t / 4))[None, :] \
        + rng.normal(scale=0.3, size=(4, 24))
    hkw = dict(chunk_size=2, period=4, collect=True, device="cpu")
    h1 = engine.FitEngine().stream_fit(hw, "holt_winters",
                                       journal=str(tmp_path / "hw"), **hkw)
    h2 = engine.FitEngine().stream_fit(hw, "holt_winters",
                                       journal=str(tmp_path / "hw"), **hkw)
    assert (h1.stats["journal_commits"], h2.stats["journal_hits"]) == (2, 2)
    assert h2.stats["box_fit_launches"] == []
    for a, b in zip(h2.models, h1.models):
        for f in ("alpha", "beta", "gamma"):
            assert torch.equal(getattr(a, f), getattr(b, f))
        assert a.period == b.period and a.model_type == b.model_type


def test_journal_refuses_another_job(tmp_path):
    """A journal of another spec refuses to resume (:class:`engine.
    JournalSpecMismatch`): other statics, other data, another device
    type recorded in the manifest, other ``job_meta``."""
    j = str(tmp_path / "j")
    kw = dict(chunk_size=8, device="cpu")
    engine.FitEngine().stream_fit(AR, "ar", max_lag=2, journal=j,
                                  job_meta={"run": 1}, **kw)
    with pytest.raises(engine.JournalSpecMismatch, match="statics"):
        engine.FitEngine().stream_fit(AR, "ar", max_lag=3, journal=j,
                                      job_meta={"run": 1}, **kw)
    other = AR.copy()
    other[5, 5] += 1.0
    with pytest.raises(engine.JournalSpecMismatch, match="data_sha256"):
        engine.FitEngine().stream_fit(other, "ar", max_lag=2, journal=j,
                                      job_meta={"run": 1}, **kw)
    with pytest.raises(engine.JournalSpecMismatch, match="job"):
        engine.FitEngine().stream_fit(AR, "ar", max_lag=2, journal=j,
                                      job_meta={"run": 2}, **kw)
    with open(os.path.join(j, "MANIFEST.json")) as f:
        manifest = json.load(f)
    assert manifest["spec"]["device"] == "cpu"
    manifest["spec"]["device"] = "cuda"
    manifest["digest"] = durability.spec_digest(manifest["spec"])
    with open(os.path.join(j, "MANIFEST.json"), "w") as f:
        json.dump(manifest, f)
    with pytest.raises(engine.JournalSpecMismatch, match="device"):
        engine.FitEngine().stream_fit(AR, "ar", max_lag=2, journal=j,
                                      job_meta={"run": 1}, **kw)
    with pytest.raises(ValueError, match="JSON"):
        engine.FitEngine().stream_fit(AR, "ar", max_lag=2,
                                      job_meta={"x": object()}, **kw)


def test_progress_counters_and_incidents(tmp_path, monkeypatch):
    """``on_progress`` sees the run's ``JobProgress`` under its
    ``job_label``, the engine's registry counts the durability events,
    and ``STS_INCIDENT_DIR`` receives the deadline, OOM-at-floor and
    dead-chunk bundles."""
    monkeypatch.setenv("STS_INCIDENT_DIR", str(tmp_path / "inc"))
    reg = metrics.MetricsRegistry()
    seen = []
    eng = engine.FitEngine(registry=reg, prefetch=2)
    res = eng.stream_fit(AR, "ar", chunk_size=8, max_lag=2, device="cpu",
                         on_progress=lambda p: seen.append(
                             (p.family, p.chunks_done)),
                         job_label="sweep:ar")
    assert seen[-1] == ("sweep:ar", 5) and res.stats["prefetch"] == 2
    try:
        with resilience.fault_injection("hang_chunk", chunk_index=0,
                                        hang_s=HANG_S):
            eng.stream_fit(AR[:8], "ar", chunk_size=8, max_lag=2,
                           device="cpu", deadline_s=DEADLINE_S, retry=0)
    finally:
        _join_workers()
    with resilience.fault_injection("oom_chunk", chunk_index=0):
        eng.stream_fit(AR[:8], "ar", chunk_size=8, max_lag=2, device="cpu",
                       degrade=False, retry=0)
    c = reg.snapshot()["counters"]
    assert c["engine.deadline_expired"] == 1
    assert c["engine.dead_chunks"] == 2 and c["engine.quarantined"] == 2
    assert c["engine.chunks"] == 5
    kinds = sorted(n.split("_", 3)[-1][:-5]
                   for n in os.listdir(tmp_path / "inc"))
    assert kinds == ["chunk_dead", "chunk_dead", "deadline_expired",
                     "oom_at_floor"]


def test_retry_keywords_and_env_knobs(monkeypatch):
    """``retry=`` an int or a ``BackoffPolicy`` is the chunk re-dispatch
    policy (``stats["retries"]``); a ``RetryPolicy`` keeps the port's
    meaning, the fits' restarts; ``STS_CHUNK_RETRIES`` and
    ``STS_CHUNK_DEADLINE_S`` are parsed or refused by name, as in the
    JAX engine."""
    kw = dict(chunk_size=8, p=1, d=1, q=1, device="cpu", collect=True)
    y = ARIMA[:8]
    chunked = engine.FitEngine().stream_fit(
        y, "arima", retry=durability.BackoffPolicy(max_retries=3), **kw)
    assert chunked.stats["retries"] == 3
    with resilience.fault_injection("force_nonconverge"):
        restarted = engine.FitEngine().stream_fit(
            y, "arima", retry=resilience.RetryPolicy(max_restarts=2), **kw)
    assert restarted.stats["retries"] == 0
    assert restarted.models[0].diagnostics.attempts is not None
    monkeypatch.setenv("STS_CHUNK_RETRIES", "2")
    assert engine.FitEngine().stream_fit(y, "arima", **kw) \
        .stats["retries"] == 2
    monkeypatch.setenv("STS_CHUNK_RETRIES", "two")
    with pytest.raises(ValueError, match="STS_CHUNK_RETRIES"):
        engine.FitEngine().stream_fit(y, "arima", **kw)
    monkeypatch.delenv("STS_CHUNK_RETRIES")
    monkeypatch.setenv("STS_CHUNK_DEADLINE_S", "10m")
    with pytest.raises(ValueError, match="STS_CHUNK_DEADLINE_S"):
        engine.FitEngine().stream_fit(y, "arima", **kw)
    monkeypatch.setenv("STS_CHUNK_DEADLINE_S", "30")
    assert engine.FitEngine().stream_fit(y, "arima", **kw) \
        .stats["deadline_s"] == 30.0
    with pytest.raises(TypeError, match="BackoffPolicy"):
        engine.FitEngine().stream_fit(y, "arima", retry="2", **kw)
