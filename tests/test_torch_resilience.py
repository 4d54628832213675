"""The port's fail-soft tier (``utils.resilience``, the restart loop,
``arima.fit_resilient``, the engine's and the Panel's resilient entry
points) against the JAX package's, on the CPU in float64.

The JAX package draws its restart jitter from per-lane threefry keys
(``ops.optimize._lane_keys`` + ``fold_in``), which torch cannot make;
the tests compute those draws with JAX and hand them to the port, so
that both restart from the same points.  With the same draws the two run
the same per-lane state machines: statuses, attempts, fallback indices,
health codes and orders must be equal, parameters within 1e-6 (float64
sums in other orders, amplified along flat CSS ridges; the LM tests of
``test_torch_arima.py`` see 1e-7)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spark_timeseries_tpu.models import arima as j_arima
from spark_timeseries_tpu.models import autoregression as j_ar
from spark_timeseries_tpu.utils import resilience as j_res
from spark_timeseries_tpu_torch import _device, engine
from spark_timeseries_tpu_torch.models import arima, autoregression, convert
from spark_timeseries_tpu_torch.panel import Panel
from spark_timeseries_tpu_torch.time import BusinessDayFrequency, uniform
from spark_timeseries_tpu_torch.utils import metrics, resilience

torch.set_num_threads(1)


def jax_draws(seed, S, k, restarts):
    """The JAX restart loop's draws ``(restarts, S, k)``: lane ``s``'s
    key split from ``PRNGKey(seed)``, folded with the attempt."""
    keys = jax.random.split(jax.random.PRNGKey(seed), S)
    return np.stack([
        np.asarray(jax.vmap(lambda kk, a=a: jax.random.normal(
            jax.random.fold_in(kk, a), (k,), jnp.float64))(keys))
        for a in range(1, restarts + 1)])


def _arima_rows(rng, S, n):
    e = rng.normal(size=(S, n + 16))
    y = np.zeros_like(e)
    for t in range(2, e.shape[1]):
        y[:, t] = 1.0 + 0.25 * y[:, t - 1] + 0.35 * y[:, t - 2] + e[:, t] \
            + 0.3 * e[:, t - 1] + 0.1 * e[:, t - 2]
    return np.cumsum(y[:, 16:], axis=1)


def pathological_panel(S=64, n=96, seed=0):
    """ARIMA(2,1,2) rows with one lane of each pathology: all-NaN,
    constant, an inf, an interior gap, too short, a late start."""
    y = _arima_rows(np.random.default_rng(seed), S, n)
    y[0] = np.nan
    y[1] = 3.0
    y[2, 40] = np.inf
    y[3, 50] = np.nan
    y[4, :88] = np.nan
    y[5, :10] = np.nan
    return y


def _assert_outcomes_equal(got, want, params_atol=1e-6):
    for f in ("status", "attempts", "fallback_used", "health", "orders"):
        np.testing.assert_array_equal(getattr(got, f),
                                      np.asarray(getattr(want, f)), f)
    gp, wp = got.params, np.asarray(want.params)
    np.testing.assert_array_equal(np.isnan(gp), np.isnan(wp))
    np.testing.assert_allclose(gp, wp, rtol=0, atol=params_atol)


# -- health -----------------------------------------------------------------

def test_classify_series_matches_jax_on_every_code_and_clash():
    n = 12
    ok = np.linspace(0.0, 1.0, n)
    rows = {
        "ok": ok,
        "all_nan": np.full(n, np.nan),
        "constant": np.full(n, 2.0),
        "too_short": np.r_[np.full(n - 2, np.nan), 1.0, 2.0],
        "has_inf": np.r_[ok[:5], np.inf, ok[6:]],
        "interior_gap": np.r_[ok[:5], np.nan, ok[6:]],
        "padded_ok": np.r_[np.nan, ok[1:-1], np.nan],
        # priority clashes: inf > gap > short > constant
        "inf_and_gap": np.r_[np.inf, np.nan, ok[2:]],
        "gap_and_short": np.r_[np.full(n - 3, np.nan), 1.0, np.nan, 2.0],
        "short_and_constant": np.r_[np.full(n - 2, np.nan), 4.0, 4.0],
        "constant_padded": np.r_[np.nan, np.full(n - 1, 1.5)],
        "neg_inf_constant": np.r_[np.full(n - 1, 1.0), -np.inf],
        "lone_inf": np.r_[np.full(n - 1, np.nan), np.inf],
    }
    panel = np.stack(list(rows.values()))
    for min_len in (1, 3, 8):
        got = resilience.classify_series(torch.from_numpy(panel), min_len)
        want = np.asarray(j_res.classify_series(jnp.asarray(panel),
                                                min_len))
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)
    codes = resilience.classify_series(torch.from_numpy(panel), 3).numpy()
    assert {resilience.HEALTH_NAMES[c] for c in codes} \
        == set(resilience.HEALTH_NAMES.values())
    np.testing.assert_array_equal(resilience.unfittable_mask(codes),
                                  j_res.unfittable_mask(codes))
    empty = resilience.classify_series(torch.zeros((2, 0)))
    assert empty.tolist() == [resilience.HEALTH_TOO_SHORT] * 2
    assert resilience.HEALTH_NAMES == j_res.HEALTH_NAMES
    assert resilience.STATUS_NAMES == j_res.STATUS_NAMES


def test_policy_helpers_match_jax():
    pol = resilience.RetryPolicy(3, 0.5, 7, 40)
    assert resilience.retry_kwargs(None) == {} \
        == resilience.retry_kwargs(resilience.RetryPolicy(max_restarts=0))
    assert resilience.retry_kwargs(pol) == {
        "restarts": 3, "restart_scale": 0.5, "restart_seed": 7}
    assert resilience.override_kwargs({"a": 1, "m": 2}, m=3) \
        == j_res.override_kwargs({"a": 1, "m": 2}, m=3)
    out = resilience.FitOutcome(None, np.array([0, 1, 1, 3, 4]),
                                np.ones(5), np.zeros(5), np.zeros(5))
    assert out.counts() == j_res.FitOutcome(*out).counts() \
        == {"ok": 1, "retried": 2, "skipped": 1, "abandoned": 1}


# -- faults -----------------------------------------------------------------

def test_fault_modes_corrupt_like_jax_and_the_rest_wait():
    y = np.arange(24.0).reshape(4, 6)
    for mode in ("corrupt_nan", "corrupt_inf"):
        spec = resilience.FaultSpec(mode, lane_stride=3)
        got = resilience.corrupt_values(torch.from_numpy(y), spec)
        want = j_res.corrupt_values(y, j_res.FaultSpec(mode, lane_stride=3))
        np.testing.assert_array_equal(got.numpy(), want)
    # the streaming-chunk modes are live: the spec of the named mode at
    # its chunk, None for another chunk, another mode or outside the scope
    for mode in ("hang_chunk", "oom_chunk", "kill_after_chunk",
                 "corrupt_journal"):
        for mod in (resilience, j_res):
            assert mod.chunk_fault(mode, 2) is None
            with mod.fault_injection(mode, chunk_index=2, hang_s=0.5) as sp:
                assert mod.chunk_fault(mode, 2) is sp
                assert mod.chunk_fault(mode, 1) is None
                other = "oom_chunk" if mode != "oom_chunk" else "hang_chunk"
                assert mod.chunk_fault(other, 2) is None
    # the serving modes act as the JAX package's do: the active spec of
    # the named mode inside its scope, None outside it or for another
    # serving mode, ValueError for a mode that is not a serving one
    for mode in ("tick_corrupt_nan", "tick_corrupt_inf", "state_poison"):
        assert resilience.serving_fault(mode) is None \
            and j_res.serving_fault(mode) is None
        assert resilience.fault_scope_token() is None \
            and j_res.fault_scope_token() is None
        with resilience.fault_injection(mode, lane_stride=3) as spec, \
                j_res.fault_injection(mode, lane_stride=3) as j_spec:
            assert tuple(resilience.serving_fault(mode)) == tuple(spec) \
                == tuple(j_res.serving_fault(mode)) == tuple(j_spec)
            for other in ("tick_corrupt_nan", "state_poison"):
                if other != mode:
                    assert resilience.serving_fault(other) is None \
                        and j_res.serving_fault(other) is None
            token = resilience.fault_scope_token()
            with resilience.fault_injection(mode):
                assert resilience.fault_scope_token() not in (None, token)
            assert resilience.fault_scope_token() == token
    for mod in (resilience, j_res):
        with pytest.raises(ValueError, match="unknown serving fault"):
            mod.serving_fault("corrupt_nan")
    # the fleet modes are live: the spec inside the scope, None outside
    assert resilience.fleet_fault("tenant_flood") is None
    with resilience.fault_injection("tenant_flood", n_attempts=4) as spec:
        assert resilience.fleet_fault("tenant_flood") is spec
        assert spec.n_attempts == 4
    oom = resilience.InjectedOOM("RESOURCE_EXHAUSTED: injected")
    assert isinstance(oom, RuntimeError) and str(oom) \
        == "RESOURCE_EXHAUSTED: injected"
    assert issubclass(j_res.InjectedOOM, RuntimeError)
    err = resilience.InjectedPumpCrash("pump died")
    assert isinstance(err, RuntimeError) and str(err) == "pump died"
    assert issubclass(j_res.InjectedPumpCrash, RuntimeError)
    with pytest.raises(ValueError, match="unknown fault mode"):
        with resilience.fault_injection("banana"):
            pass


FLEET_MODES = ("tenant_flood", "coalesce_straggler", "drop_tenant_process",
               "pump_crash", "pump_hang", "checkpoint_torn")


@pytest.mark.parametrize("mode", FLEET_MODES)
def test_fleet_fault_modes_act_like_jax(mode):
    """Each fleet mode is the active spec of its own name in both
    packages, None for the other fleet modes and outside the scope; a
    serving accessor refuses it and a fleet accessor refuses a serving
    mode."""
    for mod in (resilience, j_res):
        assert mod.fleet_fault(mode) is None
        with pytest.raises(ValueError, match="serving fault"):
            mod.serving_fault(mode)
        with pytest.raises(ValueError, match="fleet fault"):
            mod.fleet_fault("state_poison")
    with resilience.fault_injection(mode, n_attempts=3, lane_stride=2,
                                    hang_s=0.5) as spec, \
            j_res.fault_injection(mode, n_attempts=3, lane_stride=2,
                                  hang_s=0.5) as j_spec:
        assert tuple(resilience.fleet_fault(mode)) == tuple(spec) \
            == tuple(j_res.fleet_fault(mode)) == tuple(j_spec)
        for other in FLEET_MODES:
            if other != mode:
                assert resilience.fleet_fault(other) is None \
                    and j_res.fleet_fault(other) is None
    assert resilience.fleet_fault(mode) is None


def test_env_fault_arm_waits(monkeypatch):
    """``STS_FAULT_INJECT=1`` arms ``force_nonconverge`` around the base
    stage only (the JAX package's CI arm): the primary sees one forced
    failure, the fallback stage none; a scope the caller set wins
    everywhere."""
    from typing import NamedTuple

    from spark_timeseries_tpu_torch.models.base import FitDiagnostics

    class _Model(NamedTuple):
        c: torch.Tensor
        diagnostics: FitDiagnostics

    seen = []

    def stage(name, converged):
        def fn(v):
            seen.append((name, resilience.forced_optimizer_failures()))
            n = v.shape[0]
            return _Model(v[:, :1].clone(), FitDiagnostics(
                torch.full((n,), converged), torch.zeros(n, dtype=torch.int32),
                torch.zeros(n, dtype=v.dtype)))
        return fn

    y = torch.randn(4, 12, generator=torch.Generator().manual_seed(0),
                    dtype=torch.float64)
    fits = [("primary", stage("primary", False)),
            ("fallback", stage("fallback", True))]
    monkeypatch.setenv("STS_FAULT_INJECT", "1")
    _, out = resilience.resilient_fit(y, fits)
    assert seen == [("primary", 1), ("fallback", 0)]
    assert (out.status == resilience.STATUS_FALLBACK).all()
    seen.clear()
    with resilience.fault_injection("force_nonconverge", n_attempts=3):
        resilience.resilient_fit(y, fits)
    assert seen == [("primary", 3), ("fallback", 3)]


# -- the ARIMA chain --------------------------------------------------------

@pytest.fixture(scope="module")
def chain_pair():
    """The pathological panel through both packages' direct chains, the
    JAX draws handed to the port."""
    y = pathological_panel()
    draws = jax_draws(0, y.shape[0], 5, 2)
    want = j_arima.fit_resilient(jnp.asarray(y), 2, 1, 2, auto_order=True)
    metrics.reset()
    stats = {}
    got = arima.fit_resilient(y, 2, 1, 2, auto_order=True,
                              retry=resilience.RetryPolicy(), device="cpu",
                              stats=stats, _restart_draws=draws)
    return y, draws, got, want, stats, metrics.snapshot()


def test_fit_resilient_matches_the_jax_direct_chain(chain_pair):
    y, _, (model, out), (j_model, j_out), stats, snap = chain_pair
    _assert_outcomes_equal(out, j_out)
    # the JAX outcome carried across field for field
    _assert_outcomes_equal(out, convert.fit_outcome_from_numpy(
        *(None if f is None else np.asarray(f) for f in j_out)))
    counts = out.counts()
    # every disposition shows on this panel
    assert set(counts) == {"ok", "retried", "fallback", "skipped"}
    assert counts["skipped"] == 4
    assert (out.fallback_used[out.status == resilience.STATUS_FALLBACK]
            >= 1).all()
    np.testing.assert_array_equal(model.diagnostics.converged.numpy(),
                                  np.asarray(j_model.diagnostics.converged))
    np.testing.assert_array_equal(model.diagnostics.attempts.numpy(),
                                  np.asarray(j_model.diagnostics.attempts))
    np.testing.assert_allclose(model.coefficients.numpy(),
                               np.asarray(j_model.coefficients), atol=1e-6)
    assert stats["lm_fit_launches"] == 0          # no card
    assert set(stats["lm_fit_launches_by_stage"]) \
        == {"arima", "auto_order", "ar", "mean"}
    c = snap["counters"]
    assert c["resilience.arima.series"] == y.shape[0]
    assert c["resilience.skipped"] == 4
    assert c["resilience.arima.retried"] == counts["retried"]
    assert snap["gauges"]["resilience.arima.frac_fallback"] \
        == counts["fallback"] / y.shape[0]
    assert any(e["name"] == "resilience.arima.fallback"
               for e in metrics.events())


def test_fit_resilient_ok_lanes_equal_the_plain_fit(chain_pair):
    y, draws, (model, out), _, _, _ = chain_pair
    safe = y.copy()
    skipped = resilience.unfittable_mask(out.health)
    safe[skipped] = resilience._placeholder_rows(y.shape[1], y.dtype)
    plain = arima.fit(2, 1, 2, safe, warn=False, device="cpu")
    ok = out.status == resilience.STATUS_OK
    assert ok.sum() > 30
    assert torch.equal(model.coefficients[ok], plain.coefficients[ok])
    # skipped lanes read as absent
    assert np.isnan(out.params[skipped]).all()
    assert (out.attempts[skipped] == 0).all()
    assert (out.orders[skipped] == -1).all()


@pytest.mark.parametrize("fault", [
    _device.KernelError("arma_lm_fit: CUDA error 719"),
    _device.KernelInputError("the CUDA arma_lm_fit kernel takes float32"),
    torch.cuda.OutOfMemoryError("CUDA out of memory"),
])
def test_a_kernel_or_device_fault_is_never_isolated(monkeypatch, fault):
    """A kernel that does not build or launch, or a card out of memory,
    raises through every stage and the suspect screen: no fallback serves
    lanes in its place.  The engine's chunks raise a kernel fault too; a
    card out of memory is the durability tier's to route (halved while a
    chunk can halve, then a recorded ``oom`` failure: here 8 and 4 lanes
    at the floor of 8; the plain stream's first chunk, with an interior
    gap, is a data failure before any fit), never a fallback's."""
    y = pathological_panel(S=12, seed=2)

    def broken(*a, **k):
        raise fault

    monkeypatch.setattr(arima, "fit_css_lm", broken)
    with pytest.raises(type(fault)):
        arima.fit_resilient(y, 2, 1, 2, auto_order=True, device="cpu")
    for kw in (dict(resilient=True), {}):
        if isinstance(fault, torch.cuda.OutOfMemoryError):
            res = engine.FitEngine().stream_fit(
                y, "arima", p=2, d=1, q=2, chunk_size=8, device="cpu", **kw)
            assert res.n_fitted == 0 and res.stats["degraded_chunks"] == 0
            first = "oom" if kw else "data"
            assert [(f["chunk_start"], f["kind"])
                    for f in res.chunk_failures] == [(0, first), (8, "oom")]
            continue
        with pytest.raises(type(fault)):
            engine.FitEngine().stream_fit(y, "arima", p=2, d=1, q=2,
                                          chunk_size=8, device="cpu", **kw)


def test_a_stage_that_fails_on_its_numbers_is_isolated(monkeypatch):
    """The LM stages raising a numerical error are recorded, and the AR
    stage (OLS, no LM) serves the lanes; the constant row, which the AR
    fit leaves unconverged, finds no mean fit (an LM stage too)."""
    y = pathological_panel(S=12, seed=2)

    def diverged(*a, **k):
        raise FloatingPointError("overflow in the CSS recursion")

    monkeypatch.setattr(arima, "fit_css_lm", diverged)
    metrics.reset()
    _, out = arima.fit_resilient(y, 2, 1, 2, auto_order=True, device="cpu")
    fb = out.status == resilience.STATUS_FALLBACK
    assert (out.fallback_used[fb] == 2).all()
    np.testing.assert_array_equal(
        np.flatnonzero(~fb), np.r_[0:5])            # 4 skipped, 1 constant
    assert out.status[1] == resilience.STATUS_ABANDONED
    assert metrics.snapshot()["counters"][
        "resilience.arima.stage_errors"] >= 2


def test_engine_and_panel_resilient_equal_the_direct_chain(chain_pair):
    y, draws, (model, out), _, _, _ = chain_pair
    # 28 real lanes pad to a bucket of 32 with all-NaN lanes
    sub, sub_draws = y[:28], draws[:, :28]
    # a 12-iteration budget keeps the plain LM's CPU loops short
    direct, d_out = arima.fit_resilient(sub, 2, 1, 2, auto_order=True,
                                        device="cpu", max_iter=12,
                                        _restart_draws=sub_draws)
    eng_draws = draws[:, :32]            # the padded lanes' draws after
    via, v_out = engine.FitEngine().fit_resilient(
        sub, "arima", 2, 1, 2, auto_order=True, device="cpu", max_iter=12,
        _restart_draws=eng_draws)
    assert via.coefficients.shape == (28, 5)
    assert torch.equal(via.coefficients.nan_to_num(7.0),
                       direct.coefficients.nan_to_num(7.0))
    for f in resilience.FitOutcome._fields:
        np.testing.assert_array_equal(np.asarray(getattr(v_out, f)),
                                      np.asarray(getattr(d_out, f)))
    # the Panel goes through the engine on its device
    index = uniform("2020-01-06T00:00Z", y.shape[1], BusinessDayFrequency(1))
    tp = Panel(index, sub, [f"s{i}" for i in range(28)], device="cpu")
    p_model, p_out = tp.fit_resilient("arima", 2, 1, 2, auto_order=True,
                                      max_iter=12, _restart_draws=eng_draws)
    assert torch.equal(p_model.coefficients.nan_to_num(7.0),
                       direct.coefficients.nan_to_num(7.0))
    np.testing.assert_array_equal(p_out.status, d_out.status)


def test_stream_fit_resilient_equals_the_direct_chain_per_chunk():
    y = pathological_panel(S=20, n=64, seed=4)
    res = engine.FitEngine().stream_fit(
        y, "arima", p=2, d=1, q=2, resilient=True, max_iter=12,
        retry=resilience.RetryPolicy(), chunk_size=8, collect=True,
        device="cpu")
    assert res.stats["resilient"] and res.n_chunks == 3
    assert res.stats["collected_ranges"] == [[0, 8], [8, 16], [16, 20]]
    assert res.stats["lm_fit_launches"] == [0, 0, 0]
    statuses, ok = {}, 0
    for (a, b), m in zip(res.stats["collected_ranges"], res.models):
        # the tail of 4 lanes runs padded to a bucket of 8
        want, w_out = arima.fit_resilient(y[a:b], 2, 1, 2, device="cpu",
                                          max_iter=12)
        assert torch.equal(m.coefficients.nan_to_num(7.0),
                           want.coefficients.nan_to_num(7.0))
        assert torch.equal(m.diagnostics.converged,
                           want.diagnostics.converged)
        for k, v in w_out.counts().items():
            statuses[k] = statuses.get(k, 0) + v
        ok += int(np.isin(w_out.status, (0, 1, 2)).sum())
    assert res.stats["resilient_statuses"] == statuses
    assert res.n_converged == ok
    assert sum(res.stats["resilient_attempts"].values()) == 20
    # the exogenous families' chains need their design: streamed without
    # it, every chunk fails on its own (a TypeError, recorded), as in the
    # JAX engine
    res = engine.FitEngine().stream_fit(y, "arimax", resilient=True,
                                        chunk_size=8, device="cpu")
    assert len(res.chunk_failures) == res.n_chunks == 3
    assert {f["error_type"] for f in res.chunk_failures} == {"TypeError"}


def test_ar_fit_resilient_matches_jax():
    y = _arima_rows(np.random.default_rng(6), 24, 40)
    y[0] = np.nan
    y[1] = 5.0
    y[2, :35] = np.nan
    y[3, :6] = np.nan          # ragged: the OLS gives NaN, the mean fits
    model, out = autoregression.fit_resilient(y, 2, device="cpu")
    j_model, j_out = j_ar.fit_resilient(jnp.asarray(y), 2)
    for f in ("status", "attempts", "fallback_used", "health"):
        np.testing.assert_array_equal(getattr(out, f),
                                      np.asarray(getattr(j_out, f)))
    assert out.orders is None and j_out.orders is None
    np.testing.assert_allclose(out.params, np.asarray(j_out.params),
                               rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(model.c.numpy(), np.asarray(j_model.c),
                               rtol=1e-10, atol=1e-12)
