"""The port's batched auto-ARIMA against the JAX package, on the CPU.

``stats.kpsstest`` and ``models.arima._step_down_stationary`` against
their JAX counterparts; the candidate-grid form of the LM fit
(``x0 (C·S, k)`` over one ``(S, n)`` panel, the shape the LM-fit kernel
takes on the card) against the Pallas solver's grid in interpret mode;
``models.arima.auto_fit_panel`` against the JAX ``auto_fit_panel`` at
float64 (orders, coefficients, AIC, the d = 2 intercept rule, short
lanes, the screen budget, the d failure), and its fits' forecasts
through ``convert.panel_arima_fit_from_numpy``.  The kernel itself runs
only on a card (``tests/test_torch_cuda.py``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spark_timeseries_tpu import stats as jstats
from spark_timeseries_tpu.models import arima as jarima
from spark_timeseries_tpu.ops import pallas_arma
from spark_timeseries_tpu_torch import stats
from spark_timeseries_tpu_torch.models import arima, convert
from spark_timeseries_tpu_torch.ops import arma_ne

torch.set_num_threads(1)


def _arma(rng, S, n, phi=(0.25, 0.35), theta=(0.3, 0.1)):
    e = rng.normal(size=(S, n + 16))
    y = np.zeros_like(e)
    for t in range(2, e.shape[1]):
        y[:, t] = 1.0 + phi[0] * y[:, t - 1] + phi[1] * y[:, t - 2] \
            + e[:, t] + theta[0] * e[:, t - 1] + theta[1] * e[:, t - 2]
    return y[:, 16:]


def _mixed_panel(rng, S, n):
    """Series that KPSS sends to d = 0, 1 and 2: stationary ARMA draws,
    their sums, and double sums of white noise.  At the 5 % level KPSS
    rejects about one stationary draw in twenty, so on some panels a
    series passes at no d <= 2 and the fit raises (as the JAX package's
    does; ``test_auto_fit_panel_raises_when_d_fails``): the seeds below
    give panels on which every series passes."""
    y = _arma(rng, S, n)
    y[S // 3:2 * S // 3] = np.cumsum(y[S // 3:2 * S // 3], axis=1)
    y[2 * S // 3:] = np.cumsum(np.cumsum(
        rng.normal(size=(S - 2 * S // 3, n)), axis=1), axis=1)
    return y


def _grid_masks(max_p, max_q):
    pq = [(p, q) for p in range(max_p + 1) for q in range(max_q + 1)]
    masks = np.zeros((len(pq), 1 + max_p + max_q), np.float32)
    masks[:, 0] = 1.0
    for c, (p, q) in enumerate(pq):
        masks[c, 1:1 + p] = 1.0
        masks[c, 1 + max_p:1 + max_p + q] = 1.0
    return masks


@pytest.mark.parametrize("ragged", [False, True])
def test_kpsstest_matches_jax(ragged):
    rng = np.random.default_rng(0)
    S, n = 24, 90
    y = np.cumsum(rng.normal(size=(S, n)), axis=1) * rng.uniform(
        0.1, 3.0, size=(S, 1))
    y[:8] = rng.normal(size=(8, n))
    nv = None
    if ragged:
        nv = rng.integers(30, n + 1, size=S)
        y = np.where(np.arange(n)[None, :] < nv[:, None], y, 0.0)
    got, crit = stats.kpsstest(torch.from_numpy(y), "c",
                               n_valid=None if nv is None
                               else torch.from_numpy(nv))
    want, want_crit = jstats.kpsstest(
        jnp.asarray(y), "c", n_valid=None if nv is None else jnp.asarray(nv))
    # float64 on both sides, the same sums in other orders
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-10)
    assert crit == want_crit == stats.KPSS_CONSTANT_CRITICAL_VALUES
    assert stats.KPSS_CONSTANT_AND_TREND_CRITICAL_VALUES \
        == jstats.KPSS_CONSTANT_AND_TREND_CRITICAL_VALUES
    got_ct, crit_ct = stats.kpsstest(torch.from_numpy(y), "ct")
    want_ct, _ = jstats.kpsstest(jnp.asarray(y), "ct")
    np.testing.assert_allclose(got_ct.numpy(), np.asarray(want_ct),
                               rtol=1e-10)
    assert crit_ct == stats.KPSS_CONSTANT_AND_TREND_CRITICAL_VALUES
    with pytest.raises(ValueError, match="'c' only"):
        stats.kpsstest(torch.from_numpy(y), "ct",
                       n_valid=torch.full((S,), n))


def test_step_down_stationary_matches_jax():
    rng = np.random.default_rng(1)
    lanes = 400
    for max_p in range(6):
        phi = rng.uniform(-1.5, 1.5, size=(lanes, max_p))
        # near-unit roots: (1 - r z)(1 + r z)... products with |r| ~ 1
        if max_p >= 2:
            r = 1.0 - 10.0 ** rng.uniform(-9, -1, size=lanes // 4)
            phi[:lanes // 4, :2] = np.stack([np.zeros_like(r), r * r], 1)
            phi[:lanes // 8, 0] = 2 * r[:lanes // 8]
            phi[:lanes // 8, 1] = -(r[:lanes // 8] ** 2)
        phi = np.concatenate([phi, -phi])   # AR as is; MA through -θ
        orders = rng.integers(0, max_p + 1, size=2 * lanes)
        got = arima._step_down_stationary(torch.from_numpy(phi),
                                          torch.from_numpy(orders))
        # op by op, as written (under jit XLA may fuse a product and a
        # sum into one rounding, which moves a lane at |k| = 1 - 1e-9)
        want = jarima._step_down_stationary(jnp.asarray(phi),
                                            jnp.asarray(orders))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # the grid's shapes: (C, S, max_p) coefficients, (C, 1) orders
    phi = rng.uniform(-1.2, 1.2, size=(6, 50, 5))
    orders = rng.integers(0, 6, size=(6, 1))
    np.testing.assert_array_equal(
        arima._step_down_stationary(torch.from_numpy(phi),
                                    torch.from_numpy(orders)).numpy(),
        np.asarray(jarima._step_down_stationary(jnp.asarray(phi),
                                                jnp.asarray(orders))))


@pytest.mark.parametrize("ragged", [False, True])
def test_grid_lm_matches_pallas_grid(ragged):
    # x0 (C·S, k) candidate-major over one (S, n) panel, with the grid's
    # masks: the port's plain LM against the Pallas solver's y_blocks
    # grid (interpret mode), float32, a few iterations
    rng = np.random.default_rng(2)
    S, n, max_p, max_q = 64, 40, 1, 2
    masks = np.repeat(_grid_masks(max_p, max_q), S, axis=0)
    C, k = masks.shape[0] // S, masks.shape[1]
    y = _arma(rng, S, n).astype(np.float32)
    x0 = (0.1 * rng.normal(size=(C * S, k))).astype(np.float32) * masks
    nv = None
    if ragged:
        nv = rng.integers(24, n + 1, size=S)
        y = np.where(np.arange(n)[None, :] < nv[:, None], y, 0.0) \
            .astype(np.float32)
    kw = dict(max_iter=4)
    got = arma_ne.fit_css_lm(
        torch.from_numpy(x0), torch.from_numpy(y), max_p, max_q, 1,
        mask=torch.from_numpy(masks),
        n_valid=None if nv is None else torch.from_numpy(nv), **kw)
    want = pallas_arma.fit_css_lm(
        jnp.asarray(x0), jnp.asarray(y), max_p, max_q, 1,
        mask=jnp.asarray(masks),
        n_valid=None if nv is None else jnp.asarray(nv), interpret=True,
        **kw)
    # the same state machine over float32 sums taken in another order:
    # a lane parts where rounding flips an accept or the relative-drop
    # test (the sse's last bits against tol = 1e-6), so, as between the
    # JAX package's own two float32 solvers, most lanes take the same
    # iterations and nearly all end at the same point and objective
    it, it_w = got[3].numpy(), np.asarray(want[3])
    dx = np.abs(got[0].numpy() - np.asarray(want[0])).max(axis=1)
    rel = np.abs(got[1].numpy() - np.asarray(want[1])) \
        / np.asarray(want[1])
    assert np.mean(it == it_w) >= 0.85
    assert np.median(dx) < 1e-5 and np.mean(dx < 1e-3) >= 0.98
    assert np.mean(rel < 1e-4) >= 0.98
    # frozen slots never move
    assert np.all(got[0].numpy()[masks == 0.0] == 0.0)

    # each candidate's run equals a fit of that slice alone, bit for bit
    for c in (0, C // 2, C - 1):
        sl = slice(c * S, (c + 1) * S)
        alone = arma_ne.fit_css_lm(
            torch.from_numpy(x0[sl]), torch.from_numpy(y), max_p, max_q, 1,
            mask=torch.from_numpy(masks[sl]),
            n_valid=None if nv is None else torch.from_numpy(nv), **kw)
        for a, b in zip(got, alone):
            assert torch.equal(a[sl], b)


def test_grid_lm_shapes_raise():
    y = torch.zeros((10, 40))
    with pytest.raises(ValueError, match="not a multiple"):
        arma_ne.fit_css_lm(torch.zeros((25, 11)), y, 5, 5, 1)
    with pytest.raises(ValueError, match="shape mismatch"):
        arma_ne.fit_css_lm(torch.zeros((30, 11)), y, 5, 5, 1,
                           n_valid=torch.full((30,), 40))
    with pytest.raises(ValueError, match="shape mismatch"):
        arma_ne.fit_css_lm(torch.zeros((30, 11)), y, 5, 5, 1,
                           mask=torch.ones((10, 11)))


def _compare(port, ref, min_equal=0.95):
    """Orders equal on at least ``min_equal`` of series; where they are,
    coefficients within 1e-6 and AIC within 1e-8 relative (float64 LM at
    tol 1e-10 on both sides, sums in other orders); returns the share."""
    same = np.all(port.orders == np.asarray(ref.orders), axis=1)
    assert same.mean() >= min_equal
    fin = same & np.isfinite(np.asarray(ref.aic))
    np.testing.assert_allclose(port.coefficients[fin],
                               np.asarray(ref.coefficients)[fin], rtol=0,
                               atol=1e-6)
    np.testing.assert_allclose(port.aic[fin], np.asarray(ref.aic)[fin],
                               rtol=1e-8)
    np.testing.assert_array_equal(np.isfinite(port.aic)[same],
                                  np.isfinite(np.asarray(ref.aic))[same])
    return float(same.mean())


def test_auto_fit_panel_matches_jax():
    rng = np.random.default_rng(4)
    y = _mixed_panel(rng, 48, 96)
    launches = arma_ne.fit_css_lm.launches
    run = {}
    got = arima.auto_fit_panel(y, max_p=2, max_q=2, device="cpu", stats=run)
    assert arma_ne.fit_css_lm.launches == launches   # no kernel on the CPU
    assert run["lm_fit_launches"] == 0 and 0.0 <= run["screen_capped"] <= 1
    want = jarima.auto_fit_panel(jnp.asarray(y), max_p=2, max_q=2)
    _compare(got, want)
    assert got.orders.dtype == np.int64 and got.coefficients.dtype \
        == np.float64 and got.coefficients.shape == (48, 5)
    # every d of the panel appears, and d = 2 drops the intercept: its
    # slot is exactly zero and the model has none
    d = got.orders[:, 1]
    assert set(d.tolist()) == {0, 1, 2}
    assert np.all(got.coefficients[d == 2, 0] == 0.0)
    i = int(np.flatnonzero(d == 2)[0])
    m = got.model_for(i)
    assert not m.has_intercept and m.d == 2
    assert m.coefficients.shape == (m.p + m.q,)
    assert got.model_for(0).has_intercept


def test_auto_fit_panel_default_grid_matches_jax():
    # the default grid's padded (5, 5) parameterization, k = 11
    rng = np.random.default_rng(5)
    y = _mixed_panel(rng, 12, 96)
    got = arima.auto_fit_panel(y, device="cpu")
    want = jarima.auto_fit_panel(jnp.asarray(y))
    _compare(got, want)
    assert got.coefficients.shape == (12, 11)


def test_auto_fit_panel_ragged_matches_jax():
    rng = np.random.default_rng(3)
    S, n = 24, 90
    y = _mixed_panel(rng, S, n)
    y[3, :40] = np.nan                 # leading padding
    y[7, 60:] = np.nan                 # trailing padding
    y[11, 5:] = np.nan                 # too short for the grid: quarantined
    with pytest.warns(UserWarning, match="shorter than"):
        got = arima.auto_fit_panel(y, max_p=1, max_q=2, device="cpu")
    want = jarima.auto_fit_panel(jnp.asarray(y), max_p=1, max_q=2)
    _compare(got, want)
    assert np.all(np.isnan(got.coefficients[11]))
    assert got.aic[11] == np.inf and tuple(got.orders[11]) == (0, 0, 0)
    assert np.all(np.isfinite(got.aic[[3, 7]]))


def test_auto_fit_panel_screen_budget():
    rng = np.random.default_rng(3)
    y = _mixed_panel(rng, 24, 64)
    kw = dict(max_p=1, max_q=1, max_iter=8, screen_max_iter=3)
    launches = []
    real = arima.fit_css_lm

    def counted(x0, *args, **kw):
        launches.append((x0.shape[0], kw["max_iter"]))
        return real(x0, *args, **kw)
    arima.fit_css_lm = counted
    try:
        got = arima.auto_fit_panel(y, device="cpu", **kw)
    finally:
        arima.fit_css_lm = real
    # the screen over 4 candidates x 24 series, then the refine of the
    # 24 winners at the rest of the budget
    assert launches == [(4 * 24, 3), (24, 5)]
    want = jarima.auto_fit_panel(jnp.asarray(y), **kw)
    _compare(got, want)
    # a full-budget screen leaves nothing to refine
    launches.clear()
    arima.fit_css_lm = counted
    try:
        arima.auto_fit_panel(y, device="cpu", max_p=1, max_q=1, max_iter=8,
                             screen_max_iter=8)
    finally:
        arima.fit_css_lm = real
    assert launches == [(4 * 24, 8)]


def test_auto_fit_panel_raises_when_d_fails():
    rng = np.random.default_rng(7)
    y = np.cumsum(np.cumsum(rng.normal(size=(4, 80)), axis=1), axis=1)
    y[1] = np.cumsum(y[1]) * 50.0          # I(3): d <= 1 cannot pass
    with pytest.raises(ValueError, match="differencing order <= 1"):
        jarima.auto_fit_panel(jnp.asarray(y), max_p=1, max_d=1, max_q=1)
    with pytest.raises(ValueError, match="differencing order <= 1"):
        arima.auto_fit_panel(y, max_p=1, max_d=1, max_q=1, device="cpu")
    # max_d = 0 pins d: nothing to select, so nothing raises
    got = arima.auto_fit_panel(y, max_p=1, max_d=0, max_q=1, device="cpu")
    assert np.all(got.orders[:, 1] == 0)


def test_model_for_forecasts_match_jax():
    rng = np.random.default_rng(4)
    y = _mixed_panel(rng, 18, 80)
    want = jarima.auto_fit_panel(jnp.asarray(y), max_p=2, max_q=1)
    fit = convert.panel_arima_fit_from_numpy(
        np.asarray(want.orders), np.asarray(want.coefficients),
        np.asarray(want.aic), want.max_p, device="cpu")
    for i in (0, 1, 6, 7, 12, 13, 16, 17):      # d = 0, 1 and 2
        m, m_ref = fit.model_for(i), want.model_for(i)
        assert (m.p, m.d, m.q, m.has_intercept) == (
            m_ref.p, m_ref.d, m_ref.q, m_ref.has_intercept)
        got = m.forecast(torch.from_numpy(y[i]), 6).numpy()
        ref = np.asarray(m_ref.forecast(jnp.asarray(y[i]), 6))
        # float64, the same recurrences
        np.testing.assert_allclose(got, ref, rtol=1e-10, atol=1e-10)
    with pytest.raises(ValueError, match="expected orders"):
        convert.panel_arima_fit_from_numpy(np.zeros((3, 2)),
                                           np.zeros((3, 5)), np.zeros(3), 2)


def test_auto_fit_panel_needs_cuda_unless_told(monkeypatch):
    y = _arma(np.random.default_rng(9), 4, 40)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        arima.auto_fit_panel(y)
    # a card that is there: an order grid past the kernel's raises before
    # any tensor reaches it, as does float64
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    with pytest.raises(ValueError, match="p, q <= 5"):
        arima.auto_fit_panel(y.astype(np.float32), max_p=6, device="cuda")
    with pytest.raises(ValueError, match="float32"):
        arima.auto_fit_panel(y, device="cuda")
