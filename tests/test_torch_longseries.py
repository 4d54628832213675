"""The port's long-series tier (``longseries.fit_long`` and
``LongSeriesFit``) against the JAX package's, on the CPU in float64.

A 4,096-observation ARMA(1,1) (and its integral, for d = 1) split into
16 segments of 256: the fused, staged and auto paths' combined
coefficients, σ², segment accounting, ``describe()``, ``forecast`` and
``loglik`` against the JAX package's (each JAX fit computed once per
module); the fused path's segments bit for bit the staged path's; the
forecast against the sequential Kalman filter over the whole series;
the counters; the durability knobs (the staged path, a journal's
bitwise resume); the error surface (``FusedDurabilityError``,
``retry=``, NaN and 2-D input).

Tolerances: coefficients and σ² within 1e-8 (both sides run the same
float64 LM state machine to its 1e-10 relative stopping rule, with sums
in other orders, then the same WLS); forecasts and the likelihood within
1e-8 relative (the same filter recursion, the pinned-gain chunks in
another association)."""

import numpy as np
import pytest
import torch

from spark_timeseries_tpu import longseries as jls
from spark_timeseries_tpu_torch import longseries
from spark_timeseries_tpu_torch.engine import FitEngine
from spark_timeseries_tpu_torch.longseries import api, split
from spark_timeseries_tpu_torch.models import arima
from spark_timeseries_tpu_torch.utils import metrics

pytestmark = pytest.mark.long

SEG = 256


def _arma11(n, seed=0):
    rng = np.random.default_rng(seed)
    e = rng.normal(size=n + 1)
    x = e[1:] + 0.4 * e[:-1]
    y = np.zeros(n)
    for t in range(n):
        y[t] = 0.1 + 0.6 * (y[t - 1] if t else 0.0) + x[t]
    return y


Y0 = _arma11(4096)
Y1 = np.concatenate([[5.0], 5.0 + np.cumsum(_arma11(4096, seed=1))])

# path -> (series, fit_long keywords)
PATHS = {
    "fused": (Y0, dict(order=(1, 0, 1))),
    "staged": (Y0, dict(order=(1, 0, 1), fused=False)),
    "auto": (Y0, dict(order=(1, 0, 1), auto=True, max_p=1, max_q=1)),
    "d1": (Y1, dict(order=(1, 1, 1))),
}


@pytest.fixture(scope="module")
def jax_fits():
    """Each JAX path's fit, forecast and likelihood, once per module."""
    out = {}
    for name, (y, kw) in PATHS.items():
        fl = jls.fit_long(y, seg_len=SEG, warn=False, **kw)
        out[name] = (fl, np.asarray(fl.forecast(8)), fl.loglik)
    return out


@pytest.mark.parametrize("path", list(PATHS))
def test_fit_long_matches_jax(jax_fits, path):
    y, kw = PATHS[path]
    want, want_fc, want_ll = jax_fits[path]
    got = longseries.fit_long(y, seg_len=SEG, warn=False, device="cpu",
                              **kw)
    assert isinstance(got, longseries.LongSeriesFit)
    np.testing.assert_allclose(got.coefficients.numpy(),
                               np.asarray(want.coefficients), rtol=0,
                               atol=1e-8)
    np.testing.assert_allclose(got.sigma2, want.sigma2, rtol=1e-8)
    gd, wd = got.describe(), want.describe()
    assert gd.keys() == wd.keys()
    for k in gd:
        if k != "sigma2":
            assert gd[k] == wd[k], k
    assert tuple(got.plan) == tuple(want.plan)
    assert got.model.p == want.model.p == 12
    assert got.model.d == want.model.d
    assert bool(got.diagnostics.converged) \
        == bool(want.diagnostics.converged)
    if path == "auto":
        np.testing.assert_array_equal(got.segment_orders,
                                      want.segment_orders)
        assert got.stream_stats == {"auto": True, "lm_fit_launches": 0}
    np.testing.assert_allclose(got.forecast(8), want_fc, rtol=1e-8,
                               atol=1e-8)
    assert got._diffed is None          # released once the origin is cached
    assert got.loglik == pytest.approx(want_ll, rel=1e-8)


def test_fused_segments_are_the_staged_ones_bit_for_bit():
    fused = longseries.fit_long(Y0, (1, 0, 1), seg_len=SEG, warn=False,
                                device="cpu", chunk_segments=8)
    staged = longseries.fit_long(Y0, (1, 0, 1), seg_len=SEG, warn=False,
                                 device="cpu", chunk_segments=8,
                                 combine_chunk=8, engine=FitEngine())
    assert fused.stream_stats["fused"] is True
    assert fused.stream_stats["n_chunks"] == 2
    assert staged.stream_stats["n_chunks"] == 2
    assert "fused" not in staged.stream_stats
    plan = fused.plan
    panel = split.segment_panel(Y0, plan)
    seg_coefs = torch.cat([arima.segment_fit_outputs(
        1, 1, torch.from_numpy(panel[s:s + 8]), device="cpu")[0]
        for s in range(0, plan.n_segments, 8)]).numpy()
    res = FitEngine().stream_fit(panel, "arima", chunk_size=8,
                                 collect=True, device="cpu", p=1, d=0, q=1)
    staged_coefs, _ = api._collect_segment_coefs(res, plan.n_segments, 3,
                                                 panel.dtype)
    np.testing.assert_array_equal(seg_coefs, staged_coefs)
    # the same segments through the same combiner chunks
    np.testing.assert_array_equal(fused.coefficients.numpy(),
                                  staged.coefficients.numpy())
    assert fused.sigma2 == staged.sigma2


def test_forecast_is_the_sequential_filter_over_the_whole_series():
    """The acceptance pin of the tier: the forecast off the recovered
    origin equals the statespace filter run step by step over every
    differenced observation; the likelihood is the σ²-concentrated
    exact one of ``ARIMAModel.log_likelihood_exact``."""
    from spark_timeseries_tpu_torch.statespace.convert import to_statespace
    from spark_timeseries_tpu_torch.statespace.health import (HealthPolicy,
                                                             initial_health)
    from spark_timeseries_tpu_torch.statespace.kalman import filter_panel
    from spark_timeseries_tpu_torch.statespace.serving import _forecast_impl
    from spark_timeseries_tpu_torch.statespace.ssm import (SSMeta,
                                                          initial_state)

    fl = longseries.fit_long(Y1, (1, 1, 1), seg_len=SEG, warn=False,
                             device="cpu", warm=128, origin_chunk=512)
    got = fl.forecast(8)
    ssm, meta = to_statespace(fl.model)
    meta0 = SSMeta(meta.family, meta.mode, 0, meta.m)
    seq = filter_panel(ssm, initial_state(ssm, meta0),
                       torch.from_numpy(np.diff(Y1)[None]), meta0).state
    seq = seq._replace(ring=torch.from_numpy(fl._ring[None]))
    want = _forecast_impl(meta, 8, HealthPolicy().validate(), ssm, seq,
                          initial_health(seq),
                          torch.zeros((1, 8), dtype=torch.float64))[0]
    np.testing.assert_allclose(got, want.numpy(), rtol=1e-7, atol=1e-7)
    want_ll = float(fl.model.log_likelihood_exact(torch.from_numpy(Y1)))
    assert fl.loglik == pytest.approx(want_ll, rel=1e-6)


def test_counters_and_fused_bytes():
    reg = metrics.get_registry()
    before = reg.snapshot()["counters"]
    fl = longseries.fit_long(Y0, (1, 0, 1), seg_len=SEG, warn=False,
                             device="cpu", chunk_segments=5)
    after = reg.snapshot()["counters"]

    def delta(name):
        return after.get(name, 0) - before.get(name, 0)

    assert delta("longseries.fits") == 1
    assert delta("longseries.segments") == 16
    assert delta("longseries.fused_programs") == 4
    assert fl.stream_stats["n_chunks"] == 4
    assert fl.stream_stats["lm_fit_launches"] == 0      # the CPU's
    assert delta("longseries.fused_bytes_d2h") \
        == longseries.combine.expected_combine_acc_bytes(12, True,
                                                         np.float64)
    assert delta("longseries.segments_combined") == fl.combined.n_weighted
    assert reg.snapshot()["gauges"]["longseries.last_n_obs"] == 4096.0


@pytest.mark.parametrize("knob", [dict(journal="j"), dict(deadline_s=1.0),
                                  dict(chunk_retry=object()),
                                  dict(engine=FitEngine()),
                                  dict(degrade=False), dict(auto=True)])
def test_fused_true_refuses_what_it_cannot_honor(knob):
    with pytest.raises(longseries.FusedDurabilityError) as got:
        longseries.fit_long(Y0, (1, 0, 1), seg_len=SEG, fused=True,
                            device="cpu", **knob)
    jknob = {k: (None if k == "engine" else v) for k, v in knob.items()}
    if "engine" in knob:
        from spark_timeseries_tpu.engine import FitEngine as JEngine
        jknob["engine"] = JEngine()
    with pytest.raises(jls.api.FusedDurabilityError) as want:
        jls.fit_long(Y0, (1, 0, 1), seg_len=SEG, fused=True, **jknob)
    assert isinstance(got.value, ValueError)
    assert str(got.value) == str(want.value)


def test_durability_knobs_wait_for_the_engine_tier(tmp_path):
    """Each durability knob selects the staged (durable) path, as in the
    JAX package: the combined coefficients are the staged path's bit for
    bit.  A ``chunk_retry`` that is not a re-dispatch policy, and any
    streaming knob under ``auto=True``, raise the JAX package's
    errors."""
    staged = longseries.fit_long(Y0, (1, 0, 1), seg_len=SEG, warn=False,
                                 fused=False, device="cpu")
    for knob in (dict(journal=str(tmp_path / "j")), dict(deadline_s=30.0),
                 dict(chunk_retry=1), dict(degrade=False)):
        fl = longseries.fit_long(Y0, (1, 0, 1), seg_len=SEG, warn=False,
                                 device="cpu", **knob)
        assert "fused" not in fl.stream_stats
        assert torch.equal(fl.coefficients, staged.coefficients)
    with pytest.raises(TypeError, match="BackoffPolicy") as got:
        longseries.fit_long(Y0, (1, 0, 1), seg_len=SEG, device="cpu",
                            chunk_retry=object())
    with pytest.raises(TypeError, match="BackoffPolicy") as want:
        jls.fit_long(Y0, (1, 0, 1), seg_len=SEG, chunk_retry=object())
    assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="auto=True") as got:
        longseries.fit_long(Y0, (1, 0, 1), auto=True, seg_len=SEG,
                            journal="j", device="cpu")
    with pytest.raises(ValueError, match="auto=True") as want:
        jls.fit_long(Y0, (1, 0, 1), auto=True, seg_len=SEG, journal="j")
    assert str(got.value) == str(want.value)


def test_journal_resume_is_bitwise(tmp_path):
    """``journal=`` commits every segment chunk with the split geometry
    in its spec (``job_meta``); a second call restores every chunk (no
    commit, no fit) and combines to the same coefficients bit for bit; a
    changed geometry refuses the journal, as in the JAX package."""
    from spark_timeseries_tpu_torch.utils.durability import \
        JournalSpecMismatch

    j = str(tmp_path / "j")
    kw = dict(seg_len=SEG, warn=False, device="cpu", journal=j,
              chunk_segments=5)
    a = longseries.fit_long(Y0, (1, 0, 1), **kw)
    b = longseries.fit_long(Y0, (1, 0, 1), **kw)
    assert a.stream_stats["journal_commits"] == a.stream_stats["n_chunks"] \
        == b.stream_stats["journal_hits"] == 4
    assert b.stream_stats["journal_commits"] == 0
    assert torch.equal(a.coefficients, b.coefficients)
    assert b.sigma2 == a.sigma2
    with pytest.raises(JournalSpecMismatch, match="job"):
        longseries.fit_long(Y0, (1, 0, 1), **dict(kw, seg_len=SEG // 2,
                                                  n_ar=12))


def test_bad_inputs_raise_like_jax():
    """The JAX package's ValueErrors, and float64 refused on the card
    (``_device.check_dtype``, which ``fit_long`` applies before any
    work)."""
    cases = [
        ((np.stack([Y0, Y0]),), {}, "ONE ultra-long series"),
        ((np.where(np.arange(Y0.size) == 7, np.nan, Y0),), {},
         "fully-observed"),
        ((Y0,), dict(retry=object()), "retry"),
        ((Y0,), dict(auto=True, method="css-cgd"), "max_iter"),
        ((Y0,), dict(method="css-lm", user_init_params=[0.0, 0.1, 0.1]),
         "fused"),
        ((Y0,), dict(auto=True, chunk_segments=8), "no effect"),
    ]
    for args, kw, match in cases:
        with pytest.raises(ValueError, match=match):
            longseries.fit_long(*args, order=(1, 0, 1), seg_len=SEG,
                                device="cpu", **kw)
        with pytest.raises(ValueError, match=match):
            jls.fit_long(*args, order=(1, 0, 1), seg_len=SEG, **kw)
    with pytest.raises(ValueError, match="auto=True"):
        longseries.fit_long(Y0, (1, 0, 1), auto=True, engine=FitEngine(),
                            seg_len=SEG, device="cpu")
    with pytest.raises(ValueError, match="horizon"):
        longseries.fit_long(Y0, (1, 0, 1), seg_len=SEG, warn=False,
                            device="cpu").forecast(0)
    with pytest.raises(ValueError, match="float32"):
        api.check_dtype(torch.float64, torch.device("cuda"))


def test_entry_point_runs_on_the_card_unless_told(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        longseries.fit_long(Y0, (1, 0, 1), seg_len=SEG)
