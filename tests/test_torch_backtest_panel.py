"""The port's ``backtest_panel`` (and ``Panel.backtest``) against the
JAX package's, on the CPU in float64: a seeded panel of the three
generating processes of ``bench.py``'s backtest demo (AR(1), ARMA(1,1),
SES), with a NaN-padded lane and a lane with an interior gap, swept
through an AR / ARMA / EWMA grid; the report's champions, score tables,
error bars, summary; the long-series route at a lowered
``long_threshold``; candidate isolation; the durability knobs and a
journaled sweep's bitwise resume; validation.  Each JAX sweep runs once per
module.

Tolerance: scores and tables within 1e-7 relative (1e-10 absolute): the
candidates' fits run the same float64 solvers to their stopping rules
(LM 1e-10 relative) with sums in other orders, which moves a forecast by
~1e-10; champions must be equal."""

import numpy as np
import pytest
import torch

from spark_timeseries_tpu import backtest as jbt
from spark_timeseries_tpu_torch import Panel, backtest
from spark_timeseries_tpu_torch import time as ttime
from spark_timeseries_tpu_torch._device import KernelError
from spark_timeseries_tpu_torch.backtest import api

pytestmark = pytest.mark.backtest

N = 400
FAMS = {"ar": [1], "arima": [(1, 0, 1)], "ewma": True}
KW = dict(n_origins=16, stride=4, min_train=300)


def _arma(S, phi, theta, seed, burn=128):
    r = np.random.default_rng(seed)
    e = r.standard_normal((S, N + burn))
    y = np.zeros((S, N + burn))
    for t in range(1, N + burn):
        y[:, t] = 2.0 + sum(p * y[:, t - 1 - i] for i, p in enumerate(phi)) \
            + e[:, t] + sum(q * e[:, t - 1 - i] for i, q in enumerate(theta))
    return y[:, burn:]


def _ses(S, alpha, seed):
    r = np.random.default_rng(seed)
    e = r.standard_normal((S, N))
    y = np.zeros((S, N))
    lvl = np.full(S, 10.0)
    for t in range(N):
        y[:, t] = lvl + e[:, t]
        lvl = lvl + alpha * e[:, t]
    return y


PANEL = np.concatenate([_arma(4, (0.8,), (), 101), _arma(4, (0.4,), (0.9,), 102),
                        _ses(4, 0.4, 103)])
PANEL[1, :6] = np.nan           # late start: ragged families fit its window
PANEL[6, 100:103] = np.nan      # interior gap: that lane scores as dead


@pytest.fixture(scope="module")
def jax_report():
    return jbt.backtest_panel(PANEL, jbt.CandidateGrid(FAMS, (1, 2, 4)),
                              **KW)


def _close(got, want, name):
    np.testing.assert_allclose(got, want, rtol=1e-7, atol=1e-10,
                               err_msg=name)


def test_report_matches_jax(jax_report):
    rep = backtest.backtest_panel(PANEL, backtest.CandidateGrid(FAMS,
                                                                (1, 2, 4)),
                                  device="cpu", **KW)
    want = jax_report
    assert isinstance(rep, backtest.BacktestReport)
    assert [tuple(c) for c in rep.candidates] \
        == [tuple(c) for c in want.candidates]
    assert rep.horizons == want.horizons
    assert rep.schedule.describe() == want.schedule.describe()
    np.testing.assert_array_equal(rep.champion, want.champion)
    np.testing.assert_array_equal(rep.n_params, want.n_params)
    for name in ("scores_smape", "scores_mase", "score_std", "smape", "mase",
                 "rmse", "coverage", "sigma2"):
        _close(getattr(rep, name), getattr(want, name), name)
    assert rep.champion_counts() == want.champion_counts()
    for metric in ("smape", "mase"):
        _close(rep.champion_score(metric), want.champion_score(metric),
               metric)
    for metric in ("smape", "mase", "rmse", "coverage"):
        _close(rep.horizon_table(metric), want.horizon_table(metric),
               metric)
    s, w = rep.summary(), want.summary()
    assert s.keys() == w.keys()
    for k in s:
        if k.startswith("champion_") and k != "champion_counts":
            assert s[k] == pytest.approx(w[k], rel=1e-7)
        else:
            assert s[k] == w[k], k
    assert [st["path"] for st in rep.stream_stats] \
        == [st["path"] for st in want.stream_stats]
    assert [st["lanes_skipped"] for st in rep.stream_stats] \
        == [st["lanes_skipped"] for st in want.stream_stats]
    assert rep.champion[6] == -1 and rep.champion_for(6) is None


def test_report_is_deterministic_and_panel_backtest_is_backtest_panel():
    g = backtest.CandidateGrid(FAMS, (1, 2, 4))
    a = backtest.backtest_panel(PANEL, g, device="cpu", **KW)
    b = backtest.backtest_panel(torch.from_numpy(PANEL), g, device="cpu",
                                **KW)
    assert a.digest() == b.digest()
    index = ttime.uniform("2020-01-01T00:00Z", N, ttime.DayFrequency(1))
    pan = Panel(index, PANEL, [f"s{i}" for i in range(len(PANEL))],
                device="cpu")
    c = pan.backtest(g, **KW)
    assert c.digest() == a.digest()
    assert "12 series x 3 candidates x 16 origins" in repr(c)


def test_long_route_matches_jax():
    """Past ``long_threshold`` the ARIMA candidate fits each series
    through ``longseries.fit_long`` and replays its AR(12) like any
    other model."""
    y = PANEL[[0, 5], :].repeat(6, axis=1)[:, :2048]
    y = y + np.linspace(0.0, 0.1, y.shape[1])
    g = {"arima": [(1, 0, 1)]}
    kw = dict(horizons=(1, 4), n_origins=8, min_train=1536,
              long_threshold=1536)
    rep = backtest.backtest_panel(y, backtest.CandidateGrid(g), device="cpu",
                                  **kw)
    want = jbt.backtest_panel(y, jbt.CandidateGrid(g), **kw)
    assert rep.stream_stats[0]["path"] == want.stream_stats[0]["path"] \
        == "longseries"
    assert rep.stream_stats[0]["lm_fit_launches"] == 0
    np.testing.assert_array_equal(rep.champion, want.champion)
    for name in ("scores_mase", "smape", "sigma2"):
        _close(getattr(rep, name), getattr(want, name), name)


@pytest.fixture(scope="module")
def port_report():
    return backtest.backtest_panel(PANEL, backtest.CandidateGrid(FAMS,
                                                                 (1, 2, 4)),
                                   device="cpu", **KW)


@pytest.mark.parametrize("knob", [dict(journal="j"), dict(deadline_s=30.0),
                                  dict(retry=object()), dict(degrade=False)])
def test_durability_knobs_wait_for_the_engine_tier(knob, tmp_path,
                                                   port_report):
    """The durability knobs reach every streamed candidate, as in the JAX
    package: a journal, a deadline and ``degrade=False`` leave the report
    bit for bit the knob-free one; a ``retry`` that is not a chunk
    re-dispatch policy fails each streamed candidate with the JAX
    package's ``TypeError``."""
    if "journal" in knob:
        knob = dict(journal=str(tmp_path / "j"))
    g = backtest.CandidateGrid(FAMS, (1, 2, 4))
    rep = backtest.backtest_panel(PANEL, g, device="cpu", **KW, **knob)
    if "retry" in knob:
        assert [s["path"] for s in rep.stream_stats] == ["failed"] * 3
        assert all("TypeError" in s["error"] and "BackoffPolicy"
                   in s["error"] for s in rep.stream_stats)
        assert (rep.champion == -1).all()
    else:
        assert rep.digest() == port_report.digest()


def test_journal_resume_is_bitwise_and_counts_hits(tmp_path, port_report):
    """``journal=dir`` keeps one journal per candidate
    (``cand-XX-<slug>``); a second sweep restores every candidate's chunk
    (``journal_hits``, nothing committed) and its report is the first's
    and the journal-free one's bit for bit; a journal of another sweep
    (changed data) refuses loudly instead of scoring dead candidates."""
    import os

    from spark_timeseries_tpu_torch.utils.durability import \
        JournalSpecMismatch

    g = backtest.CandidateGrid(FAMS, (1, 2, 4))
    j = str(tmp_path / "bt")
    a = backtest.backtest_panel(PANEL, g, device="cpu", journal=j, **KW)
    b = backtest.backtest_panel(PANEL, g, device="cpu", journal=j, **KW)
    assert sorted(os.listdir(j)) == ["cand-00-ar-1", "cand-01-arima-1-0-1",
                                     "cand-02-ewma"]
    assert [s["journal_commits"] for s in a.stream_stats] == [1, 1, 1]
    assert [s["journal_hits"] for s in b.stream_stats] == [1, 1, 1]
    assert [s["journal_commits"] for s in b.stream_stats] == [0, 0, 0]
    assert a.digest() == b.digest() == port_report.digest()
    other = PANEL.copy()
    other[0, 50] += 1.0
    with pytest.raises(JournalSpecMismatch, match="data_sha256"):
        backtest.backtest_panel(other, g, device="cpu", journal=j, **KW)


def test_validation_like_jax():
    for kw in (dict(select_by="rmse"), dict(tie_tol=-1.0),
               dict(mase_m=0), dict(replay="refit"),
               dict(mode="sliding", window=5),
               dict(horizons=(0,))):
        with pytest.raises(ValueError) as got:
            backtest.backtest_panel(PANEL, device="cpu", **{**KW, **kw})
        with pytest.raises(ValueError) as want:
            jbt.backtest_panel(PANEL, **{**KW, **kw})
        assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="n_series"):
        backtest.backtest_panel(PANEL[None], device="cpu", **KW)


def test_a_failing_candidate_scores_dead_and_a_kernel_fault_raises(
        monkeypatch):
    spec = backtest.grid.FAMILIES["ewma"]
    monkeypatch.setitem(backtest.grid.FAMILIES, "ewma",
                        spec._replace(stream_kwargs=lambda o: {"bad": 1}))
    g = backtest.CandidateGrid(FAMS, (1, 2, 4))
    rep = backtest.backtest_panel(PANEL, g, device="cpu", **KW)
    assert rep.stream_stats[2]["path"] == "failed"
    assert "TypeError" in rep.stream_stats[2]["error"]
    assert np.isnan(rep.scores_mase[:, 2]).all()
    assert (rep.champion != 2).all()
    monkeypatch.undo()

    def fault(*a, **k):
        raise KernelError("arma_lm_fit kernel launch failed")

    monkeypatch.setattr(api, "_fit_candidate", fault)
    with pytest.raises(KernelError):
        backtest.backtest_panel(PANEL, g, device="cpu", **KW)
