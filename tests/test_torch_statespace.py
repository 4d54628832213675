"""The port's state-space core (``statespace.ssm``, ``kalman``, ``convert``)
against the JAX package's, on the CPU in float64.

The same random stable state-space models go through both filters: the
predicted ``(a, P, v, F)`` path and the exact log-likelihood agree
within 1e-10 relative (the two sum the same terms in other orders; the
filter's recursion is contractive on stable models, so rounding does
not grow).  The AR(1) closed-form exact likelihood is a scalar oracle
with no Kalman machinery in it."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spark_timeseries_tpu.models import ewma as j_ewma
from spark_timeseries_tpu.models import holt_winters as j_hw
from spark_timeseries_tpu.statespace import convert as j_conv
from spark_timeseries_tpu.statespace import kalman as j_kal
from spark_timeseries_tpu.statespace import ssm as j_ssm
from spark_timeseries_tpu_torch.models import convert as mconv
from spark_timeseries_tpu_torch.models import ewma, holt_winters
from spark_timeseries_tpu_torch.statespace import convert, kalman, ssm

torch.set_num_threads(1)

RTOL = 1e-10


def _random_ssm(rng, S, m):
    """Random stable exact-mode models (spectral radius of T under 0.9),
    as numpy fields of a StateSpace."""
    T = rng.normal(size=(S, m, m))
    T *= 0.9 / np.abs(np.linalg.eigvals(T)).max(axis=-1)[:, None, None]
    R = rng.normal(size=(S, m, m)) * 0.5
    Q = R @ R.transpose(0, 2, 1) + 0.1 * np.eye(m)
    return j_ssm.StateSpace(
        T=jnp.asarray(T), Z=jnp.asarray(rng.normal(size=(S, m))),
        c=jnp.asarray(rng.normal(size=(S, m)) * 0.2),
        d=jnp.asarray(rng.normal(size=S)),
        H=jnp.asarray(rng.uniform(0.1, 1.0, size=S)), Q=jnp.asarray(Q),
        gain=jnp.zeros((S, m)))


def _close(got, want, rtol=RTOL, atol=0.0):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=rtol, atol=atol)


def _ar1(n, phi, seed, const=0.0):
    rng = np.random.default_rng(seed)
    e = rng.normal(size=n)
    y = np.zeros(n)
    for t in range(1, n):
        y[t] = const + phi * y[t - 1] + e[t]
    return y


def _ar1_concentrated_nll(params, y):
    """Closed-form σ²-profiled exact AR(1) negative log likelihood: the
    stationary prior on y₁ and the conditional normals after it."""
    c, phi = params
    n = len(y)
    mu = c / (1.0 - phi)
    f1 = 1.0 / (1.0 - phi * phi)
    ssq = (y[0] - mu) ** 2 / f1 + np.sum((y[1:] - c - phi * y[:-1]) ** 2)
    sigma2 = ssq / n
    return -(-0.5 * n * (np.log(2 * np.pi * sigma2) + 1.0)
             - 0.5 * np.log(f1))


@pytest.mark.parametrize("m,d_order,joseph", [(3, 0, False), (2, 1, False),
                                              (3, 0, True)])
def test_filter_path_and_loglik_match_jax(m, d_order, joseph):
    """``filter_panel`` (with a NaN tick and ragged weights) and the
    one-tick ``filter_step_panel`` against the JAX package's."""
    rng = np.random.default_rng(10 + m + d_order)
    S, n = 5, 40
    j_model = _random_ssm(rng, S, m)
    meta = j_ssm.SSMeta("arima", "exact", d_order, m)
    ys = rng.normal(size=(S, n)).cumsum(axis=1) if d_order \
        else rng.normal(size=(S, n))
    ys[1, 7] = np.nan
    w = np.ones((S, n))
    w[3, 30:] = 0.0
    t_model, t_meta, _ = mconv.statespace_from_numpy(j_model, meta,
                                                     device="cpu")
    assert t_meta == ssm.SSMeta("arima", "exact", d_order, m)
    j_state = j_ssm.initial_state(j_model, meta)
    t_state = ssm.initial_state(t_model, t_meta)
    for got, want in zip(t_state, j_state):
        _close(got, want, atol=1e-12)
    carried = mconv.statespace_from_numpy(j_model, meta, j_state,
                                          device="cpu")[2]
    assert carried.n_obs.dtype == torch.int32
    for got, want in zip(carried, j_state):
        _close(got, want, rtol=0)
    if not joseph:
        want = jax.jit(lambda mdl, st, v, wt: j_kal.filter_panel(
            mdl, st, v, meta, weights=wt, return_path=True))(
            j_model, j_state, jnp.asarray(ys), jnp.asarray(w))
        got = kalman.filter_panel(t_model, t_state, torch.from_numpy(ys),
                                  t_meta, weights=torch.from_numpy(w),
                                  return_path=True)
        for g, wp in zip(got.path, want.path):
            _close(g, wp, atol=1e-12)
        _close(got.loglik, want.loglik)
        for f in ("ssq", "sumlogf", "a", "P", "ring"):
            _close(getattr(got.state, f), getattr(want.state, f), atol=1e-12)
        np.testing.assert_array_equal(got.state.n_obs.numpy(),
                                      np.asarray(want.state.n_obs))
    # one tick across the panel, with exogenous offsets
    y1 = ys[:, 0].copy()
    off = rng.normal(size=S)
    j_st, (jv, jf) = jax.jit(lambda mdl, st, v, o: j_kal.filter_step_panel(
        mdl, st, v, o, meta, joseph=joseph))(j_model, j_state,
                                             jnp.asarray(y1),
                                             jnp.asarray(off))
    t_st, (tv, tf) = kalman.filter_step_panel(t_model, t_state,
                                              torch.from_numpy(y1),
                                              torch.from_numpy(off), t_meta,
                                              joseph=joseph)
    _close(tv, jv, atol=1e-12)
    _close(tf, jf)
    for g, wp in zip(t_st, j_st):
        _close(g, wp, atol=1e-12)


def test_stationary_covariance_with_unit_root_lanes():
    """A unit-root lane (``I - T⊗T`` singular) beside stationary ones in
    one batch: ``torch.linalg.solve`` would raise, the port's solve
    falls back to the diffuse prior on that lane alone, as the JAX
    package does, and autograd stays finite on every lane."""
    rng = np.random.default_rng(3)
    j_model = _random_ssm(rng, 4, 2)
    T = np.asarray(j_model.T).copy()
    T[1] = [[1.0, 0.0], [0.0, 0.5]]             # unit root
    T[3] = [[0.5, 1.0], [0.0, 1.0]]             # unit root, non-diagonal
    Q = np.asarray(j_model.Q)
    want = j_ssm.stationary_covariance(jnp.asarray(T), jnp.asarray(Q))
    Tt = torch.tensor(T, requires_grad=True)
    got = ssm.stationary_covariance(Tt, torch.from_numpy(Q))
    _close(got, want)
    assert got[1, 0, 0] > 1e5 and got[3, 0, 0] > 1e5
    got.sum().backward()
    assert torch.isfinite(Tt.grad).all()
    mu_want = j_ssm.stationary_mean(jnp.asarray(T), j_model.c)
    mu_got = ssm.stationary_mean(torch.from_numpy(T),
                                 torch.from_numpy(np.asarray(j_model.c)))
    _close(mu_got, mu_want)
    assert ssm.state_nbytes(ssm.initial_state(
        convert.companion_arma(torch.zeros(4, 2), torch.zeros(4, 1)),
        ssm.SSMeta("arima", "exact", 0, 2))) == 4 * 4 * (2 + 4 + 3) \
        + 4 * 4         # float32 a, P, loglik, ssq, sumlogf; int32 n_obs


def test_arma_concentrated_neg_ll_matches_jax_and_ar1_oracle():
    rng = np.random.default_rng(4)
    S, n = 6, 60
    prm = np.concatenate([rng.normal(size=(S, 1)),
                          rng.uniform(-0.4, 0.4, size=(S, 4))], axis=1)
    ys = rng.normal(size=(S, n))
    nv = np.array([60, 45, 60, 30, 52, 60])
    for k in range(S):
        ys[k, nv[k]:] = 0.0
    want = np.asarray(jax.jit(jax.vmap(
        lambda p_, y_, v_: j_conv.arma_concentrated_neg_ll(
            p_, y_, 2, 2, 1, n_valid=v_)))(jnp.asarray(prm),
                                           jnp.asarray(ys), jnp.asarray(nv)))
    got = convert.arma_concentrated_neg_ll(
        torch.from_numpy(prm), torch.from_numpy(ys), 2, 2, 1,
        n_valid=torch.from_numpy(nv))
    _close(got, want)
    # a left-aligned ragged lane scores as its trimmed series
    trimmed = convert.arma_concentrated_neg_ll(
        torch.from_numpy(prm[1]), torch.from_numpy(ys[1, :45]), 2, 2, 1)
    _close(trimmed, want[1])
    # the AR(1) closed form, no Kalman machinery in it
    y = _ar1(200, 0.6, seed=3, const=0.8)
    params = np.array([0.5, 0.55])
    got1 = convert.arma_concentrated_neg_ll(torch.from_numpy(params),
                                            torch.from_numpy(y), 1, 0, 1)
    np.testing.assert_allclose(float(got1),
                               _ar1_concentrated_nll(params, y), rtol=1e-9)


def test_forecast_mean_steady_gain_and_origin_match_jax():
    rng = np.random.default_rng(5)
    S, m, n, h = 4, 3, 160, 6
    j_model = _random_ssm(rng, S, m)
    t_model, _, _ = mconv.statespace_from_numpy(j_model, device="cpu")
    meta = j_ssm.SSMeta("arima", "exact", 2, m)
    a = rng.normal(size=(S, m))
    ring = rng.normal(size=(S, 2))
    offs = rng.normal(size=(S, h))
    want = jax.jit(lambda *args: j_kal.forecast_mean(meta, h, *args))(
        j_model, jnp.asarray(a), jnp.asarray(ring), jnp.asarray(offs))
    got = kalman.forecast_mean(ssm.SSMeta(*meta), h, t_model,
                               torch.from_numpy(a), torch.from_numpy(ring),
                               torch.from_numpy(offs))
    _close(got, want)
    P = np.asarray(jax.jit(j_ssm.stationary_covariance)(j_model.T,
                                                        j_model.Q))
    for g, w in zip(kalman.steady_gain(t_model, torch.from_numpy(P)),
                    jax.jit(j_kal.steady_gain)(j_model, jnp.asarray(P))):
        _close(g, w)
    # the long-series forecast origin: sequential head, log-depth tail
    meta0 = j_ssm.SSMeta("arima", "exact", 0, m)
    ys = rng.normal(size=(S, n))
    j0 = j_ssm.initial_state(j_model, meta0)
    t0 = ssm.initial_state(t_model, ssm.SSMeta(*meta0))
    want = jax.jit(lambda mdl, st, v: j_kal.filter_forecast_origin(
        mdl, st, v, meta0, warm=48, chunk=64))(j_model, j0, jnp.asarray(ys))
    got = kalman.filter_forecast_origin(t_model, t0, torch.from_numpy(ys),
                                        ssm.SSMeta(*meta0), warm=48,
                                        chunk=64)
    for f in ("a", "loglik", "ssq", "sumlogf", "P"):
        _close(getattr(got, f), getattr(want, f), rtol=1e-9)
    # ... and the pinned-gain state path
    K = np.asarray(j_kal.steady_gain(j_model, jnp.asarray(P))[0])
    ys = ys[:, :24].copy()
    ys[2, 11] = np.nan
    want = jax.jit(j_kal.pinned_state_path)(j_model, jnp.asarray(a),
                                            jnp.asarray(ys), jnp.asarray(K))
    got = kalman.pinned_state_path(t_model, torch.from_numpy(a),
                                   torch.from_numpy(ys), torch.from_numpy(K))
    _close(got, want, rtol=1e-9, atol=1e-12)


def test_converters_bootstrap_and_parallel_filter_match_jax():
    """``to_statespace`` + ``bootstrap`` of EWMA and additive Holt-Winters
    fits carried across from the JAX package, and the log-depth
    pinned-gain filter against the sequential one (a NaN tick
    included)."""
    rng = np.random.default_rng(6)
    S, n, period = 3, 48, 4
    t = np.arange(n)
    y = 10.0 + 0.1 * t + np.sin(2 * np.pi * t / period) \
        + rng.normal(size=(S, n)) * 0.3
    jm = j_hw.HoltWintersModel("additive", period, jnp.asarray([0.3, 0.5,
                                                                0.2]),
                               jnp.asarray([0.1, 0.05, 0.2]),
                               jnp.asarray([0.2, 0.4, 0.3]))
    tm = mconv.holt_winters_from_numpy("additive", period,
                                       np.asarray(jm.alpha),
                                       np.asarray(jm.beta),
                                       np.asarray(jm.gamma), device="cpu")
    want = j_conv.bootstrap(jm, jnp.asarray(y))
    got = convert.bootstrap(tm, torch.from_numpy(y))
    assert got.meta == ssm.SSMeta(*want.meta)
    for g, w in zip(got.ssm, want.ssm):
        _close(g, w, atol=1e-12)
    for g, w in zip(got.state, want.state):
        _close(g, w, rtol=1e-9, atol=1e-12)
    _close(got.sigma2, want.sigma2, rtol=1e-9)
    je = j_ewma.EWMAModel(jnp.asarray([0.2, 0.6, 0.9]))
    te = mconv.ewma_from_numpy(np.asarray(je.smoothing), device="cpu")
    yw = np.cumsum(rng.normal(size=(S, n)), axis=1)
    yw[1, 20] = np.nan
    want = j_conv.bootstrap(je, jnp.asarray(yw))
    got = convert.bootstrap(te, torch.from_numpy(yw))
    for g, w in zip(got.state, want.state):
        _close(g, w, rtol=1e-9, atol=1e-12)
    t_model, meta = convert.to_statespace(te)
    st0 = ssm.initial_state(t_model, meta)
    seq = kalman.filter_panel(t_model, st0, torch.from_numpy(yw), meta)
    par = kalman.filter_panel_parallel(t_model, st0, torch.from_numpy(yw),
                                       meta)
    for f in ("a", "loglik", "ssq", "sumlogf"):
        _close(getattr(par.state, f), getattr(seq.state, f), rtol=1e-9)
    assert torch.equal(par.state.n_obs, seq.state.n_obs)
    with pytest.raises(ValueError, match="pinned-gain"):
        kalman.filter_panel_parallel(
            t_model, st0, torch.from_numpy(yw),
            ssm.SSMeta("arima", "exact", 0, 1))
    mult = holt_winters.HoltWintersModel(
        "multiplicative", period, torch.tensor([0.3]), torch.tensor([0.1]),
        torch.tensor([0.2]))
    with pytest.raises(NotImplementedError, match="multiplicative"):
        convert.to_statespace(mult)
    assert isinstance(ewma.EWMAModel(torch.tensor(0.5)).smoothing,
                      torch.Tensor)
