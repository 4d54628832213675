"""The port on an NVIDIA card: the CUDA kernels (ARMA normal equations,
ARMA LM fit, per series and over a candidate grid, CSS cost, Holt-Winters
SSE value and gradient, Holt-Winters box fit) against their plain
versions, the series-major one-pass ARMA kernels against the time-major
ones bit for bit at every order, width and block shape, the fits
(``auto_fit_panel`` among them) and the streaming engine on CUDA against
the same calls on the CPU, and the ``Panel`` on
the card: its fills against the CPU's, ``Panel.stream_fit`` /
``Panel.auto_fit`` against the engine and ``auto_fit_panel``, the CSV
codec built on the card's machine, and the fail-soft tier: the CSS
gradient through the single-pass kernel, the restart loop over the LM-fit
kernel against the route, ``fit_resilient`` on the card; and the serving
tier: a session on the card against the CPU's, ``update_batch`` bit for
bit, ``heal()`` through the LM-fit kernel; and the long-series and
backtest tiers: ``longseries.fit_long`` (fused and staged),
``arima.fit_long`` and ``backtest_panel`` on the card against the same
float32 runs on the CPU, with their ``arma_lm_fit`` launches; and the
engine's durability tier: OOM halving bit for bit, a journal's resume,
the deadline watchdog over the side-stream staging.

Every test here needs a card and skips without one.  The file imports
neither ``jax`` nor the JAX package, so a machine without JAX runs it
(``tests/conftest.py`` imports JAX, hence ``--noconftest``)::

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q
"""

import numpy as np
import pytest
import torch

from spark_timeseries_tpu_torch import Panel, io
from spark_timeseries_tpu_torch import time as ttime
from spark_timeseries_tpu_torch.engine import FitEngine
from spark_timeseries_tpu_torch.models import arima, holt_winters
from spark_timeseries_tpu_torch.ops import arma_ne, hw_sse
from spark_timeseries_tpu_torch.ops.optimize import minimize_box

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


def _panel(rng, S, n):
    e = rng.normal(size=(S, n + 16))
    y = np.zeros_like(e)
    for t in range(2, e.shape[1]):
        y[:, t] = 1.0 + 0.25 * y[:, t - 1] + 0.35 * y[:, t - 2] + e[:, t] \
            + 0.3 * e[:, t - 1] + 0.1 * e[:, t - 2]
    return y[:, 16:]


@pytest.mark.parametrize("p,q,icpt,ragged", [(2, 2, 1, False),
                                             (2, 2, 1, True),
                                             (1, 0, 0, False),
                                             (3, 3, 1, True)])
def test_kernel_matches_plain(cuda, p, q, icpt, ragged):
    rng = np.random.default_rng(4)
    S, n = 1000, 90
    y = torch.from_numpy(_panel(rng, S, n).astype(np.float32)).to(cuda)
    params = torch.from_numpy(
        (0.1 * rng.normal(size=(S, icpt + p + q))).astype(np.float32)
    ).to(cuda)
    nv = torch.from_numpy(rng.integers(20, n + 1, size=S)).to(cuda) \
        if ragged else None
    before = arma_ne.normal_equations.launches
    got = arma_ne.normal_equations(params, y, p, q, icpt, n_valid=nv)
    want = arma_ne.normal_equations_plain(params, y, p, q, icpt, n_valid=nv)
    torch.cuda.synchronize()
    assert arma_ne.normal_equations.launches == before + 1
    # float32 sums over ~90 steps; the kernel contracts into FMAs
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-3)
    with pytest.raises(ValueError, match="float32"):
        arma_ne.normal_equations(params.double(), y.double(), p, q, icpt)
    with pytest.raises(ValueError, match="p, q <= 5"):
        arma_ne.normal_equations(params.new_zeros((S, icpt + 7)), y, 6, 1,
                                 icpt)


def test_fit_on_cuda_matches_cpu(cuda):
    rng = np.random.default_rng(5)
    y = np.cumsum(_panel(rng, 2048, 96), axis=1).astype(np.float32)
    before = (arma_ne.fit_css_lm.launches, arma_ne.normal_equations.launches)
    got = arima.fit(2, 1, 2, y, warn=False, device=cuda)
    # the whole LM fit is one LM-fit kernel launch, and no single pass
    assert (arma_ne.fit_css_lm.launches,
            arma_ne.normal_equations.launches) == (before[0] + 1, before[1])
    want = arima.fit(2, 1, 2, y, warn=False, device="cpu")
    conv = got.diagnostics.converged.cpu().numpy()
    w_conv = want.diagnostics.converged.numpy()
    # the same float32 LM; FMA contraction may flip a decision on the flat
    # common-factor ridges, so converged shares and not bits are compared
    assert abs(conv.mean() - w_conv.mean()) < 0.02
    both = conv & w_conv
    dx = np.abs(got.coefficients.cpu().numpy()
                - want.coefficients.numpy()).max(axis=1)[both]
    assert np.mean(dx < 5e-3) >= 0.9


def test_stream_fit_on_cuda_matches_cpu(cuda):
    rng = np.random.default_rng(6)
    y = np.cumsum(_panel(rng, 700, 64), axis=1).astype(np.float32)
    y[-5:, :4] = np.nan              # ragged tail chunk
    kw = dict(chunk_size=256, collect=True, p=2, d=1, q=2)
    got = FitEngine().stream_fit(y, "arima", device=cuda, **kw)
    want = FitEngine().stream_fit(y, "arima", device="cpu", **kw)
    assert not got.chunk_failures and got.n_chunks == 3
    assert got.stats["collected_ranges"] == want.stats["collected_ranges"]
    coefs = torch.cat([m.coefficients for m in got.models]).numpy()
    w_coefs = torch.cat([m.coefficients for m in want.models]).numpy()
    conv = torch.cat([m.diagnostics.converged for m in got.models]).numpy()
    w_conv = torch.cat([m.diagnostics.converged
                        for m in want.models]).numpy()
    assert abs(conv.mean() - w_conv.mean()) < 0.03
    both = conv & w_conv
    dx = np.abs(coefs - w_coefs).max(axis=1)[both]
    assert np.mean(dx < 5e-3) >= 0.9


# The LM-fit kernel runs arma_ne_kernel's pass and the batched LM loop's
# arithmetic in the loop's order, so against that loop over
# arma_ne_kernel (fit_css_lm_route) it may part only where a contraction
# or a reduction rounds otherwise: at least LM_ROUTE_SHARE of lanes must
# take the same iterations and end within 1e-5 of the same objective.
# The plain pass rounds otherwise on every step (no FMA), so in float32
# lanes part from it near the end of their fit, where the accept and
# stop tests turn on the last bits of f; the route parts from it the same
# way, so the kernel is held to the route: its shares against the plain
# fit at most LM_PLAIN_MARGIN below the route's.
LM_ROUTE_SHARE = 0.95
LM_PLAIN_MARGIN = 0.1
LM_PLAIN_LANES = 64
LM_ORDERS = [(p, q, icpt) for p in range(4) for q in range(4)
             for icpt in (0, 1) if p + q + icpt]


def _assert_bitwise(a, b):
    torch.testing.assert_close(a, b, rtol=0, atol=0, equal_nan=True)


def _lm_agreement(got, want):
    """Shares of lanes with the same iteration count, with ``fun`` within
    1e-5 relative (NaN matching NaN), and with the same converged flag."""
    _, fun, conv, n_iter = got
    same = (n_iter == want[3]).double().mean()
    close = torch.isclose(fun.double(), want[1].double(), rtol=1e-5,
                          atol=0.0, equal_nan=True).double().mean()
    return (float(same), float(close),
            float((conv == want[2]).double().mean()))


def _lm_case(cuda, p, q, icpt, mode="dense", S=1000, n=90, seed=16):
    rng = np.random.default_rng(seed)
    y = _panel(rng, S, n)
    k = icpt + p + q
    x0 = torch.from_numpy((0.1 * rng.normal(size=(S, k))).astype(
        np.float32)).to(cuda)
    mask = nv = None
    if mode == "ragged":
        nv = rng.integers(20, n + 1, size=S)
        y = np.where(np.arange(n)[None, :] < nv[:, None], y, 0.0)
        nv = torch.from_numpy(nv).to(cuda)
    if mode == "masked":
        mask = torch.from_numpy((rng.uniform(size=(S, k)) > 0.3).astype(
            np.float32)).to(cuda)
    return x0, torch.from_numpy(y.astype(np.float32)).to(cuda), mask, nv


def _check_lm_against_route(cuda, p, q, icpt, mode, plain_lanes=0,
                            **kw):
    x0, y, mask, nv = _lm_case(cuda, p, q, icpt, mode)
    before = (arma_ne.fit_css_lm.launches, arma_ne.normal_equations.launches)
    got = arma_ne.fit_css_lm(x0, y, p, q, icpt, mask=mask, n_valid=nv, **kw)
    torch.cuda.synchronize()
    assert (arma_ne.fit_css_lm.launches,
            arma_ne.normal_equations.launches) == (before[0] + 1, before[1])
    route = arma_ne.fit_css_lm_route(x0, y, p, q, icpt, mask=mask,
                                     n_valid=nv, **kw)
    shares = _lm_agreement(got, route)
    print(f"ARMA({p},{q}) icpt={icpt} {mode} vs route {shares}")
    assert min(shares[:2]) >= LM_ROUTE_SHARE
    same = got[3] == route[3]
    assert bool((got[2] == route[2])[same].all())
    if mask is not None:         # frozen slots never move
        assert bool((got[0][mask == 0] == 0).all())
    if plain_lanes:
        k = slice(0, plain_lanes)
        plain = arma_ne.fit_css_lm_plain(
            x0[k], y[k], p, q, icpt, mask=None if mask is None else mask[k],
            n_valid=None if nv is None else nv[k], **kw)
        g_shares = _lm_agreement([t[k] for t in got], plain)
        r_shares = _lm_agreement([t[k] for t in route], plain)
        print(f"ARMA({p},{q}) icpt={icpt} {mode} vs plain {g_shares}, "
              f"route vs plain {r_shares}")
        for g_share, r_share in zip(g_shares, r_shares):
            assert g_share >= r_share - LM_PLAIN_MARGIN
    return got, route


@pytest.mark.parametrize("p,q,icpt", LM_ORDERS)
def test_lm_fit_kernel_matches_route(cuda, p, q, icpt):
    _check_lm_against_route(cuda, p, q, icpt, "dense")


@pytest.mark.parametrize("mode", ["dense", "ragged", "masked"])
@pytest.mark.parametrize("p,q,icpt", [(2, 2, 1), (3, 3, 1), (1, 0, 0)])
def test_lm_fit_kernel_matches_route_and_plain(cuda, p, q, icpt, mode):
    _check_lm_against_route(cuda, p, q, icpt, mode,
                            plain_lanes=LM_PLAIN_LANES)


def test_lm_fit_kernel_iteration_cap(cuda):
    got, _ = _check_lm_against_route(cuda, 2, 2, 1, "dense", max_iter=3)
    assert int(got[3].max()) == 3
    x0, y, _, _ = _lm_case(cuda, 2, 2, 1)
    x, fun, conv, n_iter = arma_ne.fit_css_lm(x0, y, 2, 2, 1, max_iter=0)
    # no iterations: the start, evaluated once
    assert bool((n_iter == 0).all()) and not bool(conv.any())
    _assert_bitwise(x, x0)
    _, _, sse = arma_ne.normal_equations(x0, y, 2, 2, 1)
    _assert_bitwise(fun, sse)


def test_lm_fit_kernel_grid_shapes(cuda):
    # more lanes than the card holds resident threads, and a count that
    # is no multiple of a block: every block size gives every lane the
    # same result, which a lane fitted alone matches
    S = 132 * 2048 + 37
    x0, y, _, nv = _lm_case(cuda, 2, 2, 1, "ragged", S=S, n=40)
    args = (x0, y, 2, 2, 1, 1e-6, 50, None, nv)
    cfg = arma_ne.lm_fit_config(S, 40, 2, 2, 1, True, cuda, 64)
    assert cfg.blocks * cfg.threads >= S > (cfg.blocks - 1) * cfg.threads
    assert cfg.blocks > cfg.blocks_per_sm * cfg.sms
    small = arma_ne._lm_launch(*args, threads=64)
    large = arma_ne._lm_launch(*args, threads=256)
    for a, b in zip(small, large):
        _assert_bitwise(a, b)
    last = slice(S - 1, S)
    alone = arma_ne.fit_css_lm(x0[last], y[last], 2, 2, 1, n_valid=nv[last])
    for a, b in zip(alone, small):
        _assert_bitwise(a, b[last])


def test_lm_fit_kernel_rejects(cuda):
    x0, y, _, nv = _lm_case(cuda, 2, 2, 1, "ragged", S=64)
    before = arma_ne.fit_css_lm.launches
    with pytest.raises(ValueError, match="float32"):
        arma_ne.fit_css_lm(x0.double(), y.double(), 2, 2, 1)
    with pytest.raises(ValueError, match="p, q <= 5"):
        arma_ne.fit_css_lm(x0.new_zeros((64, 8)), y, 6, 1, 1)
    with pytest.raises(ValueError, match="lanes"):
        arma_ne.fit_css_lm(x0[:32], y, 2, 2, 1)
    # a parameter vector, mask or n_valid of the wrong shape never reaches
    # the kernel, which would read past it
    with pytest.raises(ValueError, match="shape mismatch"):
        arma_ne.fit_css_lm(x0[:, :4], y, 2, 2, 1)
    with pytest.raises(ValueError, match="shape mismatch"):
        arma_ne.fit_css_lm(x0.new_zeros((64, 6)), y, 2, 2, 1)
    with pytest.raises(ValueError, match="shape mismatch"):
        arma_ne.fit_css_lm(x0, y, 2, 2, 1, mask=torch.ones_like(x0[:, :4]))
    with pytest.raises(ValueError, match="shape mismatch"):
        arma_ne.fit_css_lm(x0, y, 2, 2, 1, n_valid=nv[:32])
    assert arma_ne.fit_css_lm.launches == before


def test_stream_fit_launches_lm_fit_once_per_chunk(cuda):
    rng = np.random.default_rng(17)
    y = np.cumsum(_panel(rng, 700, 64), axis=1).astype(np.float32)
    before = (arma_ne.fit_css_lm.launches, arma_ne.normal_equations.launches)
    res = FitEngine().stream_fit(y, "arima", chunk_size=256, p=2, d=1, q=2,
                                 device=cuda)
    assert not res.chunk_failures and res.n_chunks == 3
    assert (arma_ne.fit_css_lm.launches,
            arma_ne.normal_equations.launches) == (before[0] + 3, before[1])
    assert res.stats["lm_fit_launches"] == [1, 1, 1]
    assert len(res.stats["lm_iterations"]) == 3


# The candidate grid: x0 (C·S, k) over one (S, n) panel, lane i fitting
# series i % S (the auto-fit's screen).  The route and the plain LM
# gather the panel to C copies; the kernel reads the one panel.
GRID_ORDERS = [(p, q) for p in range(6) for q in range(6)]


def _grid_case(cuda, p, q, icpt, ragged, C=3, S=400, n=90, seed=18):
    rng = np.random.default_rng(seed + 7 * p + q)
    y = _panel(rng, S, n)
    k = icpt + p + q
    mask = (rng.uniform(size=(C * S, k)) > 0.25).astype(np.float32)
    x0 = (0.1 * rng.normal(size=(C * S, k))).astype(np.float32) * mask
    nv = None
    if ragged:
        nv = rng.integers(30, n + 1, size=S)
        y = np.where(np.arange(n)[None, :] < nv[:, None], y, 0.0)
        nv = torch.from_numpy(nv).to(cuda)
    return (torch.from_numpy(x0).to(cuda),
            torch.from_numpy(y.astype(np.float32)).to(cuda),
            torch.from_numpy(mask).to(cuda), nv)


def _check_grid(cuda, p, q, icpt, ragged, plain_series=0, **kw):
    x0, y, mask, nv = _grid_case(cuda, p, q, icpt, ragged)
    S, C = y.shape[0], x0.shape[0] // y.shape[0]
    before = (arma_ne.fit_css_lm.launches, arma_ne.normal_equations.launches)
    got = arma_ne.fit_css_lm(x0, y, p, q, icpt, mask=mask, n_valid=nv, **kw)
    torch.cuda.synchronize()
    assert (arma_ne.fit_css_lm.launches,
            arma_ne.normal_equations.launches) == (before[0] + 1, before[1])
    route = arma_ne.fit_css_lm_route(x0, y, p, q, icpt, mask=mask,
                                     n_valid=nv, **kw)
    shares = _lm_agreement(got, route)
    print(f"grid ARMA({p},{q}) icpt={icpt} ragged={ragged} vs route "
          f"{shares}")
    assert min(shares[:2]) >= LM_ROUTE_SHARE
    assert bool((got[0][mask == 0] == 0).all())     # frozen slots stay
    if plain_series:
        # the first plain_series series of every candidate
        lanes = (torch.arange(C, device=cuda)[:, None] * S
                 + torch.arange(plain_series, device=cuda)).reshape(-1)
        plain = arma_ne.fit_css_lm_plain(
            x0.view(C, S, -1)[:, :plain_series].reshape(len(lanes), -1),
            y[:plain_series], p, q, icpt,
            mask=mask.view(C, S, -1)[:, :plain_series].reshape(
                len(lanes), -1),
            n_valid=None if nv is None else nv[:plain_series], **kw)
        g_shares = _lm_agreement([t[lanes] for t in got], plain)
        r_shares = _lm_agreement([t[lanes] for t in route], plain)
        print(f"grid ARMA({p},{q}) icpt={icpt} ragged={ragged} vs plain "
              f"{g_shares}, route vs plain {r_shares}")
        for g_share, r_share in zip(g_shares, r_shares):
            assert g_share >= r_share - LM_PLAIN_MARGIN
    return x0, y, mask, nv, got


@pytest.mark.parametrize("ragged", [False, True])
@pytest.mark.parametrize("p,q", GRID_ORDERS)
def test_lm_fit_grid_matches_route(cuda, p, q, ragged):
    _check_grid(cuda, p, q, 1, ragged)


@pytest.mark.parametrize("ragged", [False, True])
@pytest.mark.parametrize("p,q,icpt", [(5, 5, 1), (4, 5, 0), (5, 2, 0),
                                      (1, 5, 1)])
def test_lm_fit_grid_matches_route_and_plain(cuda, p, q, icpt, ragged):
    _check_grid(cuda, p, q, icpt, ragged, plain_series=24, max_iter=25)


def test_lm_fit_grid_candidates_equal_dense_calls(cuda):
    # S_y == S is the per-series fit: each candidate's run of the grid
    # equals a dense call on that candidate's lanes alone, bit for bit
    x0, y, mask, nv, got = _check_grid(cuda, 5, 5, 1, True)
    S = y.shape[0]
    for c in range(x0.shape[0] // S):
        sl = slice(c * S, (c + 1) * S)
        alone = arma_ne.fit_css_lm(x0[sl], y, 5, 5, 1, mask=mask[sl],
                                   n_valid=nv)
        for a, b in zip(got, alone):
            _assert_bitwise(a[sl], b)
    cfg = arma_ne.lm_fit_config(x0.shape[0], y.shape[1], 5, 5, 1, True,
                                cuda)
    assert cfg.blocks * cfg.threads >= x0.shape[0] > (cfg.blocks - 1) \
        * cfg.threads


def test_lm_fit_grid_rejects(cuda):
    x0, y, mask, nv = _grid_case(cuda, 2, 2, 1, True)
    before = arma_ne.fit_css_lm.launches
    with pytest.raises(ValueError, match="not a multiple"):
        arma_ne.fit_css_lm(x0[:-1], y, 2, 2, 1)
    with pytest.raises(ValueError, match="shape mismatch"):
        arma_ne.fit_css_lm(x0, y, 2, 2, 1, mask=mask[:400])
    with pytest.raises(ValueError, match="shape mismatch"):
        arma_ne.fit_css_lm(x0, y, 2, 2, 1,
                           n_valid=nv.repeat(x0.shape[0] // 400))
    # an order past the instantiated ones raises; nothing falls back
    with pytest.raises(ValueError, match="p, q <= 5"):
        arma_ne.fit_css_lm(x0.new_zeros((1200, 8)), y, 6, 1, 0)
    with pytest.raises(ValueError, match="p, q <= 5"):
        arma_ne.fit_css_lm(x0.new_zeros((1200, 7)), y, 0, 6, 1)
    assert arma_ne.fit_css_lm.launches == before


def _equal_by_value(got, want):
    """Per lane: every output equal, NaN matching NaN (a zero's sign may
    differ in the slots a candidate does not own)."""
    same = torch.ones_like(got[3], dtype=torch.bool)
    for a, b in zip(got, want):
        eq = a == b
        if a.is_floating_point():
            eq |= torch.isnan(a) & torch.isnan(b)
        same &= eq if eq.dim() == 1 else eq.all(dim=1)
    return same


@pytest.mark.parametrize("icpt_mask", [False, True])
@pytest.mark.parametrize("ragged", [False, True])
def test_lm_fit_grid_per_candidate_equals_padded(cuda, ragged, icpt_mask):
    # the auto-fit's grid, (p, q) <= 5 with intercept: one launch per
    # candidate at its own order against the padded (5,5,1) launch over a
    # mask of each candidate's order; the masked slots' terms are exact
    # zeros, so every lane with a finite fit agrees bit for bit
    rng = np.random.default_rng(23 + 2 * ragged + icpt_mask)
    S, n, k = 256, 96, 11
    orders = GRID_ORDERS
    C = len(orders)
    y = _panel(rng, S, n)
    nv = None
    if ragged:
        nv = rng.integers(40, n + 1, size=S)
        y = np.where(np.arange(n)[None, :] < nv[:, None], y, 0.0)
        nv = torch.from_numpy(nv).to(cuda)
    y = torch.from_numpy(y.astype(np.float32)).to(cuda)
    x0 = torch.from_numpy(
        (0.1 * rng.normal(size=(C * S, k))).astype(np.float32)).to(cuda)
    mask = torch.ones_like(x0)
    if icpt_mask:       # a series whose d > 1 has no intercept
        mask[torch.from_numpy(rng.uniform(size=C * S) < 0.3).to(cuda), 0] = 0
    own = arma_ne._order_mask(orders, C * S, S, 5, 5, 1, torch.float32,
                              cuda)
    kw = dict(max_iter=25, n_valid=nv)
    before = arma_ne.fit_css_lm.launches
    padded = arma_ne.fit_css_lm(x0, y, 5, 5, 1, mask=mask * own, **kw)
    got = arma_ne.fit_css_lm(x0, y, 5, 5, 1, mask=mask, grid_orders=orders,
                             **kw)
    torch.cuda.synchronize()
    assert arma_ne.fit_css_lm.launches == before + 1 + C
    finite = torch.isfinite(padded[0]).all(dim=1) \
        & torch.isfinite(padded[1])
    same = _equal_by_value(got, padded)
    print(f"per candidate vs padded, ragged={ragged} icpt_mask={icpt_mask}:"
          f" equal {same.double().mean():.4f}, finite "
          f"{finite.double().mean():.4f}")
    assert finite.double().mean() > 0.99
    assert bool(same[finite].all())
    # the slots a candidate does not own hold x0 * mask: zero
    assert bool((got[0][own == 0] == 0).all())


def test_lm_fit_grid_orders_rejects(cuda):
    x0, y, mask, nv = _grid_case(cuda, 2, 2, 1, True)
    before = arma_ne.fit_css_lm.launches
    with pytest.raises(ValueError, match="grid_orders has 2 candidates"):
        arma_ne.fit_css_lm(x0, y, 2, 2, 1, mask=mask, n_valid=nv,
                           grid_orders=[(1, 1), (2, 2)])
    with pytest.raises(ValueError, match="does not fit"):
        arma_ne.fit_css_lm(x0, y, 2, 2, 1, grid_orders=[(3, 1)] * 3)
    with pytest.raises(ValueError, match="float32"):
        arma_ne.fit_css_lm(x0.double(), y.double(), 2, 2, 1,
                           grid_orders=[(1, 1)] * 3)
    assert arma_ne.fit_css_lm.launches == before


def test_auto_fit_panel_on_cuda(cuda):
    # the screen, one LM-fit launch per candidate at its own order, and
    # the refine, one padded launch: C + 1 = 37 launches, no single pass;
    # orders as the float32 fit on the CPU chooses them
    rng = np.random.default_rng(19)
    y = np.cumsum(_panel(rng, 512, 96), axis=1).astype(np.float32)
    y[:128] = np.diff(y[:128], axis=1, prepend=0.0)
    y[-3:, :50] = np.nan                     # ragged, one lane too short
    y[-1, 60:] = np.nan
    calls = []
    real = arima.fit_css_lm

    def counted(x0, yy, *args, **kw):
        calls.append((tuple(x0.shape), tuple(yy.shape)))
        return real(x0, yy, *args, **kw)
    before = (arma_ne.fit_css_lm.launches, arma_ne.normal_equations.launches)
    stats = {}
    arima.fit_css_lm = counted
    try:
        with pytest.warns(UserWarning, match="shorter than"):
            got = arima.auto_fit_panel(y, device=cuda, stats=stats)
    finally:
        arima.fit_css_lm = real
    assert (arma_ne.fit_css_lm.launches,
            arma_ne.normal_equations.launches) == (before[0] + 37, before[1])
    assert stats["lm_fit_launches"] == 37
    # the screen over 36 candidates x 512 series and the refine, both
    # against the unrepeated (512, 96) panel
    assert calls == [((36 * 512, 11), (512, 96)), ((512, 11), (512, 96))]
    with pytest.warns(UserWarning, match="shorter than"):
        want = arima.auto_fit_panel(y, device="cpu")
    assert got.orders[-1].tolist() == [0, 0, 0] and got.aic[-1] == np.inf
    same = np.all(got.orders == want.orders, axis=1)
    # float32 on both sides; the kernel contracts into FMAs where the
    # plain pass does not, so close AICs may rank otherwise on a few
    # series
    print(f"auto_fit_panel on CUDA vs CPU: equal orders {same.mean():.3f}")
    assert same.mean() >= 0.9
    assert np.all(got.orders[:, 1] == want.orders[:, 1])


@pytest.mark.parametrize("ragged", [False, True])
def test_css_cost_kernel_every_order(cuda, ragged):
    # every (P, Q) the cost-only kernel holds in registers, and two AR
    # orders past them (its runtime-p form)
    rng = np.random.default_rng(18)
    S, n = 1000, 90
    y = torch.from_numpy(_panel(rng, S, n).astype(np.float32)).to(cuda)
    nv = torch.from_numpy(rng.integers(20, n + 1, size=S)).to(cuda) \
        if ragged else None
    orders = [(p, q) for p in range(6) for q in range(6)] + [(7, 1), (9, 4)]
    for i, (p, q) in enumerate(orders):
        icpt = 1 if p + q == 0 else i % 2
        params = torch.from_numpy((0.1 * rng.normal(
            size=(S, icpt + p + q))).astype(np.float32)).to(cuda)
        before = arma_ne.css_cost.launches
        got = arma_ne.css_cost(params, y, p, q, icpt, n_valid=nv)
        want = arma_ne.css_cost_plain(params, y, p, q, icpt, n_valid=nv)
        torch.cuda.synchronize()
        assert arma_ne.css_cost.launches == before + 1
        # float32 sums over ~90 steps
        torch.testing.assert_close(got, want, rtol=1e-4, atol=0)


# -- the series-major one-pass kernels against the time-major ones ---------

ROWS_ORDERS = [(p, q, icpt) for p in range(6) for q in range(6)
               for icpt in (0, 1) if p + q + icpt]
ROWS_WIDTHS = (1, 33, 1000, 4097)


def _bits_equal(a, b):
    return torch.equal(a.contiguous().view(torch.int32),
                       b.contiguous().view(torch.int32))


def _rows_inputs(rng, S, n, k, mode, cuda):
    params = torch.from_numpy(
        (0.1 * rng.normal(size=(S, k))).astype(np.float32)).to(cuda)
    nv = torch.from_numpy(rng.integers(n // 3, n + 1, size=S).astype(
        np.float32)).to(cuda) if mode == "ragged" else None
    mask = torch.from_numpy((rng.random((S, k)) > 0.3).astype(
        np.float32)).to(cuda) if mode == "masked" else None
    return params, nv, mask


@pytest.mark.parametrize("n", [127, 97, 128])
@pytest.mark.parametrize("mode", ["dense", "ragged", "masked"])
def test_ne_rows_kernel_equals_time_major_every_order(cuda, mode, n):
    """``normal_equations`` (one ``arma_ne_rows_kernel`` launch on the
    operands as given) against ``normal_equations_time_major`` (the
    transposes, ``arma_ne_kernel`` and the unpack), bit for bit, at every
    instantiated order and awkward widths."""
    rng = np.random.default_rng(31 + n)
    y_all = torch.from_numpy(_panel(rng, max(ROWS_WIDTHS), n)
                             .astype(np.float32)).to(cuda)
    for S in ROWS_WIDTHS:
        y = y_all[:S]
        for p, q, icpt in ROWS_ORDERS:
            params, nv, mask = _rows_inputs(rng, S, n, icpt + p + q, mode,
                                            cuda)
            before = arma_ne.normal_equations.launches
            got = arma_ne.normal_equations(params, y, p, q, icpt, mask=mask,
                                           n_valid=nv)
            want = arma_ne.normal_equations_time_major(
                params, y, p, q, icpt, mask=mask, n_valid=nv)
            torch.cuda.synchronize()
            assert arma_ne.normal_equations.launches == before + 1
            k = icpt + p + q
            assert [tuple(t.shape) for t in got] == [(S, k, k), (S, k), (S,)]
            assert all(t.is_contiguous() for t in got)
            for g, w in zip(got, want):
                assert _bits_equal(g, w), (S, p, q, icpt)


@pytest.mark.parametrize("n", [127, 97, 128])
@pytest.mark.parametrize("ragged", [False, True])
def test_css_rows_kernel_equals_time_major_every_order(cuda, ragged, n):
    """``css_cost`` (one ``arma_css_rows_kernel`` launch) against
    ``css_cost_time_major``, bit for bit: every static AR order, q <= 5,
    and the runtime-p form at p = 7 and 9."""
    rng = np.random.default_rng(41 + n)
    y_all = torch.from_numpy(_panel(rng, max(ROWS_WIDTHS), n)
                             .astype(np.float32)).to(cuda)
    orders = [(p, q) for p in range(6) for q in range(6)] + [(7, 0), (7, 3),
                                                             (9, 5)]
    for S in ROWS_WIDTHS:
        y = y_all[:S]
        for i, (p, q) in enumerate(orders):
            icpt = 1 if p + q == 0 else i % 2
            params, nv, _ = _rows_inputs(rng, S, n, icpt + p + q,
                                         "ragged" if ragged else "dense",
                                         cuda)
            before = arma_ne.css_cost.launches
            got = arma_ne.css_cost(params, y, p, q, icpt, n_valid=nv)
            want = arma_ne.css_cost_time_major(params, y, p, q, icpt,
                                               n_valid=nv)
            torch.cuda.synchronize()
            assert arma_ne.css_cost.launches == before + 1
            assert got.shape == (S,) and got.is_contiguous()
            assert _bits_equal(got, want), (S, p, q, icpt)


@pytest.mark.parametrize("n", [127, 1000])
def test_rows_kernels_every_tile(cuda, n):
    """Every block shape (32 to 128 lanes) gives the time-major kernels'
    bits, dense, ragged and masked, with the runtime-p cost form among
    the orders; at n = 1000 the rows are too long to stage whole and the
    kernels read them from global memory."""
    rng = np.random.default_rng(43 + n)
    S = 1000
    y = torch.from_numpy(_panel(rng, S, n).astype(np.float32)).to(cuda)
    lane_counts = [0, 32, 64, 96, 128]
    # the kernels' own tile: the whole rows while 32 lanes' rows fit in
    # 72 KB, else global memory
    assert arma_ne.rows_tile(S, n, 2, 2, 1, False, cuda).staged \
        == (0 if 32 * (n | 1) * 4 > 72 * 1024 else 1)
    for mode in ("dense", "ragged", "masked"):
        for p, q, icpt in ((2, 2, 1), (5, 5, 1), (1, 0, 0)):
            params, nv, mask = _rows_inputs(rng, S, n, icpt + p + q, mode,
                                            cuda)
            want = arma_ne.normal_equations_time_major(
                params, y, p, q, icpt, mask=mask, n_valid=nv)
            for lanes in lane_counts:
                got = arma_ne._ne_rows(params, y, nv, mask, p, q, icpt,
                                       lanes)
                for g, w in zip(got, want):
                    assert _bits_equal(g, w), (mode, p, q, lanes)
        for p, q, icpt in ((2, 2, 1), (7, 1, 1), (12, 2, 0)):
            params, nv, _ = _rows_inputs(rng, S, n, icpt + p + q, mode,
                                         cuda)
            want = arma_ne.css_cost_time_major(params, y, p, q, icpt,
                                               n_valid=nv)
            for lanes in lane_counts:
                got = arma_ne._css_rows(params, y, nv, p, q, icpt, lanes)
                assert _bits_equal(got, want), (mode, p, q, lanes)
    torch.cuda.synchronize()


def test_rows_kernels_on_every_card(cuda):
    """The staged kernels raise their shared-memory limit on the card they
    launch on: a 128-lane tile (over 48 KB a block) on each card in turn,
    the first one last again, gives the time-major kernels' bits."""
    rng = np.random.default_rng(45)
    S, n = 4096, 127
    y = torch.from_numpy(_panel(rng, S, n).astype(np.float32))
    params, nv, _ = _rows_inputs(rng, S, n, 5, "ragged", cuda)
    params, nv = params.cpu(), nv.cpu()
    for i in list(range(torch.cuda.device_count())) + [0]:
        dev = torch.device("cuda", i)
        for cost in (False, True):
            assert arma_ne.rows_tile(S, n, 2, 2, 1, cost, dev,
                                     128).smem_bytes > 48 * 1024
        yd, pd, nd = y.to(dev), params.to(dev), nv.to(dev)
        got = (*arma_ne._ne_rows(pd, yd, nd, None, 2, 2, 1, 128),
               arma_ne._css_rows(pd, yd, nd, 2, 2, 1, 128))
        want = (*arma_ne.normal_equations_time_major(pd, yd, 2, 2, 1,
                                                     n_valid=nd),
                arma_ne.css_cost_time_major(pd, yd, 2, 2, 1, n_valid=nd))
        torch.cuda.synchronize(dev)
        for g, w in zip(got, want):
            assert _bits_equal(g, w), i


def test_rows_kernels_one_launch_a_call(cuda):
    """A ``normal_equations`` call without a mask and a ``css_cost`` call
    run one kernel each on the card (``torch.profiler``): no transpose,
    no unpack; and the widths histogram counts each launch."""
    from torch.profiler import ProfilerActivity, profile

    rng = np.random.default_rng(44)
    S, n = 4097, 127
    y = torch.from_numpy(_panel(rng, S, n).astype(np.float32)).to(cuda)
    params, nv, _ = _rows_inputs(rng, S, n, 5, "ragged", cuda)
    arma_ne.normal_equations(params, y, 2, 2, 1, n_valid=nv)
    arma_ne.css_cost(params, y, 2, 2, 1, n_valid=nv)
    torch.cuda.synchronize()
    arma_ne.normal_equations.widths.clear()
    arma_ne.css_cost.widths.clear()
    for fn in (lambda: arma_ne.normal_equations(params, y, 2, 2, 1,
                                                n_valid=nv),
               lambda: arma_ne.css_cost(params, y, 2, 2, 1, n_valid=nv)):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        kernels = [e for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA]
        assert len(kernels) == 1, [e.name for e in kernels]
    assert arma_ne.normal_equations.widths == {8192: 1}
    assert arma_ne.css_cost.widths == {8192: 1}


def _hw_panel(rng, S, n, m):
    t = np.arange(n)
    return (100.0 + 0.5 * t + 10.0 * np.sin(2 * np.pi * t / m)
            + rng.normal(0.0, 2.0, size=(S, n))).astype(np.float32)


@pytest.mark.parametrize("m", [4, 7, 12, 24, 5, 52])
@pytest.mark.parametrize("model_type", ["additive", "multiplicative"])
@pytest.mark.parametrize("ragged", [False, True])
def test_hw_kernel_matches_plain(cuda, m, model_type, ragged):
    # m in {4, 7, 12, 24} keeps the ring in registers; 5 and 52 run the
    # generic form
    rng = np.random.default_rng(7)
    S, n = 1000, 3 * m + 5
    y = _hw_panel(rng, S, n, m)
    nv = None
    if ragged:
        nv = rng.integers(2 * m + 1, n + 1, size=S)
        y = np.where(np.arange(n)[None, :] < nv[:, None], y, 0.0)
        nv = torch.from_numpy(nv).to(cuda)
    params = torch.from_numpy(
        rng.uniform(0.05, 0.95, size=(S, 3)).astype(np.float32)).to(cuda)
    y = torch.from_numpy(y).to(cuda)
    before = hw_sse.value_and_grad.launches
    f, g = hw_sse.value_and_grad(params, y, m, model_type, n_valid=nv)
    pf, pg = hw_sse.value_and_grad_plain(params, y, m, model_type,
                                         n_valid=nv)
    torch.cuda.synchronize()
    assert hw_sse.value_and_grad.launches == before + 1
    # float32 recurrences over <= 3m + 5 steps; the kernel contracts into
    # FMAs and adds the tangents' unit-vector terms in another order
    torch.testing.assert_close(f, pf, rtol=1e-4, atol=0)
    # each gradient entry against the larger of its lane's largest entry
    # and its SSE, the gradient's natural scale over the unit box
    scale = torch.maximum(pg.abs().amax(dim=1), pf.abs())[:, None]
    assert float(((g - pg).abs() / scale).max()) < 1e-3


@pytest.mark.parametrize("m", [4, 5, 7, 12, 24, 52])
@pytest.mark.parametrize("model_type", ["additive", "multiplicative"])
@pytest.mark.parametrize("ragged", [False, True])
def test_hw_rows_kernel_matches_time_major_bitwise(cuda, m, model_type,
                                                   ragged):
    # value_and_grad's series-major kernel on the caller's rows, and on a
    # time-major copy through the evaluator, is the time-major kernel it
    # replaced bit for bit on every lane: one lane, widths that are no
    # multiple of the block, and widths at which it takes blocks of 32,
    # 64 and 128 lanes (the widest that gives every SM two blocks)
    rng = np.random.default_rng(m + 100 * ragged)
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    widths = set()
    for S in (1, 1000, 2 * sms * 64, 2 * sms * 128 + 5):
        n = 3 * m + 5
        y = _hw_panel(rng, S, n, m)
        nv = None
        if ragged:
            nv = rng.integers(2 * m + 1, n + 1, size=S)
            y = np.where(np.arange(n)[None, :] < nv[:, None], y, 0.0)
            nv = torch.from_numpy(nv).to(cuda)
        params = torch.from_numpy(
            rng.uniform(0.05, 0.95, size=(S, 3)).astype(np.float32)).to(cuda)
        y = torch.from_numpy(y).to(cuda)
        before = (hw_sse.value_and_grad.launches,
                  hw_sse.value_and_grad_time_major.launches)
        got = hw_sse.value_and_grad(params, y, m, model_type, n_valid=nv)
        assert (hw_sse.value_and_grad.launches,
                hw_sse.value_and_grad_time_major.launches) \
            == (before[0] + 1, before[1])
        old = hw_sse.value_and_grad_time_major(params, y, m, model_type,
                                               n_valid=nv)
        assert hw_sse.value_and_grad_time_major.launches == before[1] + 1
        inp_tm = hw_sse.prepare(y, m, model_type, nv)
        copied = hw_sse.evaluator(inp_tm)(params)
        torch.cuda.synchronize()
        widths.add(hw_sse.sse_config(S, m, model_type == "additive", ragged,
                                     True, cuda).lanes)
        assert all(_bits_equal(a, b) for a, b in zip(got, old))
        assert all(_bits_equal(a, b) for a, b in zip(copied, old))
    assert widths == {32, 64, 128}


def test_hw_rows_kernel_long_period_keeps_its_ring_in_global_memory(cuda):
    # a period whose ring does not fit a block of 32 lanes in shared
    # memory: the same pass with the ring in a global scratch
    rng = np.random.default_rng(11)
    S, m = 300, 500
    y = torch.from_numpy(_hw_panel(rng, S, 2 * m + 40, m)).to(cuda)
    params = torch.from_numpy(
        rng.uniform(0.05, 0.95, size=(S, 3)).astype(np.float32)).to(cuda)
    cfg = hw_sse.sse_config(S, m, True, False, True, cuda)
    assert not cfg.ring_in_smem and cfg.lanes == 32
    got = hw_sse.value_and_grad(params, y, m, "additive")
    old = hw_sse.value_and_grad_time_major(params, y, m, "additive")
    torch.cuda.synchronize()
    assert all(_bits_equal(a, b) for a, b in zip(got, old))
    assert hw_sse.sse_config(S, 12, True, False, True, cuda).ring_in_smem


def test_hw_value_and_grad_that_does_not_launch_raises(cuda):
    rng = np.random.default_rng(12)
    y = torch.from_numpy(_hw_panel(rng, 64, 40, 4)).to(cuda)
    params = torch.full((64, 3), 0.3, device=cuda)
    before = hw_sse.value_and_grad.launches
    with pytest.raises(ValueError, match="float32"):
        hw_sse.value_and_grad(params, y.double(), 4, "additive")
    inp = hw_sse.prepare(y, 4, "additive", time_major=False)
    # parameters of another shape: refused, never launched
    with pytest.raises(ValueError, match="shape mismatch"):
        hw_sse._launch(params.T[:2], inp)
    assert hw_sse.value_and_grad.launches == before
    hw_sse.value_and_grad(params, y, 4, "additive")
    assert hw_sse.value_and_grad.launches == before + 1


def test_css_cost_kernel_matches_plain(cuda):
    rng = np.random.default_rng(8)
    S, n = 1000, 90
    y = torch.from_numpy(_panel(rng, S, n).astype(np.float32)).to(cuda)
    nv = torch.from_numpy(rng.integers(20, n + 1, size=S)).to(cuda)
    for p, q, icpt, v in ((2, 2, 1, None), (2, 2, 1, nv), (5, 0, 1, None),
                          (1, 5, 0, nv)):
        params = torch.from_numpy((0.1 * rng.normal(
            size=(S, icpt + p + q))).astype(np.float32)).to(cuda)
        before = arma_ne.css_cost.launches
        got = arma_ne.css_cost(params, y, p, q, icpt, n_valid=v)
        want = arma_ne.css_cost_plain(params, y, p, q, icpt, n_valid=v)
        torch.cuda.synchronize()
        assert arma_ne.css_cost.launches == before + 1
        # float32 sums over ~90 steps
        torch.testing.assert_close(got, want, rtol=1e-4, atol=0)
    with pytest.raises(ValueError, match="q <= 5"):
        arma_ne.css_cost(params.new_zeros((S, 7)), y, 1, 6, 0)


def test_hw_fit_on_cuda_matches_cpu(cuda):
    rng = np.random.default_rng(9)
    y = _hw_panel(rng, 512, 60, 12)
    stats = {}
    before = (hw_sse.box_fit.launches, hw_sse.value_and_grad.launches)
    got = holt_winters.fit(y, 12, device=cuda, stats=stats)
    # the whole fit is one box-fit launch, and no single-pass launch
    assert (hw_sse.box_fit.launches, hw_sse.value_and_grad.launches) \
        == (before[0] + 1, before[1])
    assert stats["box_fit_launches"] == 1
    want = holt_winters.fit(y, 12, device="cpu")
    conv = got.diagnostics.converged.cpu().numpy()
    w_conv = want.diagnostics.converged.numpy()
    # the same float32 state machine; FMA contraction may flip an Armijo
    # decision, so objectives and converged shares are compared, not bits
    assert abs(conv.mean() - w_conv.mean()) < 0.05
    both = conv & w_conv
    rel = np.abs(got.diagnostics.fun.cpu().numpy()
                 - want.diagnostics.fun.numpy()) / want.diagnostics.fun.numpy()
    assert np.mean(rel[both] < 1e-3) >= 0.9


def test_hw_float64_on_cuda_raises(cuda):
    y = _hw_panel(np.random.default_rng(10), 8, 40, 4).astype(np.float64)
    with pytest.raises(ValueError, match="float32"):
        holt_winters.fit(y, 4, device=cuda)
    yt = torch.from_numpy(y).to(cuda)
    x0 = torch.full((8, 3), 0.3, dtype=torch.float64, device=cuda)
    with pytest.raises(ValueError, match="float32"):
        hw_sse.value_and_grad(x0, yt, 4, "additive")
    before = hw_sse.box_fit.launches
    with pytest.raises(ValueError, match="float32"):
        hw_sse.box_fit(hw_sse.prepare(yt, 4, "additive"), x0)
    with pytest.raises(ValueError, match="float32"):
        hw_sse.box_fit(hw_sse.prepare(yt.float(), 4, "additive"), x0)
    assert hw_sse.box_fit.launches == before


# Per-lane agreement of the box-fit kernel with the batched solver over
# the single-pass kernel, and with the plain box fit, in float32.  (See
# the thresholds below.)
def _agreement(got, want):
    """Shares of lanes with the same iteration count, and with ``fun``
    within 1e-5 relative."""
    same_iter = (got.n_iter == want.n_iter).double().mean()
    rel = (got.fun - want.fun).abs() / want.fun.abs()
    return float(same_iter), float((rel <= 1e-5).double().mean())


def _solver_route(inp, x0, max_iter=1000):
    """The batched solver over the single-pass kernel: one launch per
    line-search trial."""
    stats = {}
    res = minimize_box(hw_sse.evaluator(inp), x0, 0.0, 1.0, tol=1e-10,
                       max_iter=max_iter, stats=stats)
    return res, stats["evaluations"]


def _lanes(inp, idx):
    return inp._replace(
        y=inp.y[:, idx].contiguous(), init=inp.init[:, idx].contiguous(),
        n_valid=None if inp.n_valid is None
        else inp.n_valid[idx].contiguous())


# The kernel runs the single-pass kernel's pass and the solver's
# arithmetic in the solver's order, so against the solver route it may
# part only where a reduction or a contraction rounds otherwise: at least
# SOLVER_SHARE of lanes must take the same iterations and end within
# 1e-5 of the same objective.  The plain pass rounds otherwise on every
# step (no FMA, its own order of the tangent terms), so in float32 most
# lanes part from it near the end of their fit, where Armijo decisions
# and the stall test turn on the last bits of f.  The solver route parts
# from the plain fit the same way, so the kernel is held to the route:
# its shares against the plain fit at most PLAIN_MARGIN below the route's.
SOLVER_SHARE = (0.95, 0.95)
PLAIN_MARGIN = 0.1
PLAIN_LANES = 32


@pytest.mark.parametrize("m", [4, 7, 12, 24, 5, 52])
@pytest.mark.parametrize("model_type", ["additive", "multiplicative"])
@pytest.mark.parametrize("ragged", [False, True])
def test_hw_box_fit_matches_solver_and_plain(cuda, m, model_type, ragged):
    rng = np.random.default_rng(11)
    S, n = 512, 3 * m + 5
    y = _hw_panel(rng, S, n, m)
    nv = None
    if ragged:
        nv = rng.integers(2 * m + 1, n + 1, size=S)
        y = np.where(np.arange(n)[None, :] < nv[:, None], y, 0.0)
        nv = torch.from_numpy(nv).to(cuda)
    inp = hw_sse.prepare(torch.from_numpy(y).to(cuda), m, model_type, nv)
    x0 = torch.tensor([0.3, 0.1, 0.1], device=cuda).expand(S, 3)
    before = (hw_sse.box_fit.launches, hw_sse.value_and_grad.launches)
    got, evals = hw_sse.box_fit(inp, x0)
    torch.cuda.synchronize()
    assert (hw_sse.box_fit.launches, hw_sse.value_and_grad.launches) \
        == (before[0] + 1, before[1])
    assert bool(((got.x >= 0) & (got.x <= 1)).all())
    assert bool((evals >= 1 + got.n_iter).all())
    route, r_evals = _solver_route(inp, x0)
    shares = _agreement(got, route)
    print(f"m={m} {model_type} ragged={ragged} vs solver {shares}")
    assert shares[0] >= SOLVER_SHARE[0] and shares[1] >= SOLVER_SHARE[1]
    same = got.n_iter == route.n_iter
    assert float((evals == r_evals)[same].double().mean()) >= 0.95
    assert bool((got.converged == route.converged)[same].all())
    k = PLAIN_LANES
    plain, _ = hw_sse.box_fit_plain(_lanes(inp, slice(0, k)), x0[:k])
    p_shares = _agreement(got._replace(n_iter=got.n_iter[:k],
                                       fun=got.fun[:k]), plain)
    r_shares = _agreement(route._replace(n_iter=route.n_iter[:k],
                                         fun=route.fun[:k]), plain)
    print(f"m={m} {model_type} ragged={ragged} vs plain {p_shares}, "
          f"solver route vs plain {r_shares}")
    for got_share, route_share in zip(p_shares, r_shares):
        assert got_share >= route_share - PLAIN_MARGIN


def test_hw_box_fit_iteration_cap(cuda):
    rng = np.random.default_rng(12)
    y = torch.from_numpy(_hw_panel(rng, 256, 40, 4)).to(cuda)
    inp = hw_sse.prepare(y, 4, "multiplicative")
    x0 = torch.tensor([0.3, 0.1, 0.1], device=cuda).expand(256, 3)
    got, evals = hw_sse.box_fit(inp, x0, max_iter=5)
    route, r_evals = _solver_route(inp, x0, max_iter=5)
    assert int(got.n_iter.max()) == 5
    shares = _agreement(got, route)
    assert shares[0] >= SOLVER_SHARE[0] and shares[1] >= SOLVER_SHARE[1]
    same = got.n_iter == route.n_iter
    assert bool((got.converged == route.converged)[same].all())
    assert bool((evals == r_evals)[same].all())
    # no iterations: the projected start, evaluated once
    none, n_evals = hw_sse.box_fit(inp, x0, max_iter=0)
    assert bool((none.n_iter == 0).all() and (n_evals == 1).all())
    assert not bool(none.converged.any())
    torch.testing.assert_close(none.x, x0)


def test_hw_box_fit_lane_queue(cuda):
    # lanes of very different iteration counts, and far more lanes than
    # threads: every thread works through the queue
    rng = np.random.default_rng(13)
    S, n, m = 2048, 60, 12
    y = _hw_panel(rng, S, n, m)
    y[S // 2:3 * S // 4] += rng.normal(0.0, 20.0, size=(S // 4, n))
    y[3 * S // 4:] += np.cumsum(rng.normal(0.0, 3.0, size=(S // 4, n)),
                                axis=1).astype(np.float32)
    y = y[rng.permutation(S)]
    inp = hw_sse.prepare(torch.from_numpy(y).to(cuda), m, "additive")
    x0 = torch.tensor([0.3, 0.1, 0.1], device=cuda).expand(S, 3)
    full, f_evals, _ = hw_sse._box_launch(inp, x0, 0.0, 1.0, 1e-10, 1000,
                                          40)
    cfg = hw_sse.box_fit_config(inp, 64, max_blocks=2)
    assert cfg.blocks == 2 and cfg.smem_bytes > 0
    queued, q_evals, per_thread = hw_sse._box_launch(
        inp, x0, 0.0, 1.0, 1e-10, 1000, 40, threads=64, max_blocks=2,
        thread_evals=True)
    torch.cuda.synchronize()
    assert len(set(full.n_iter.tolist())) > 20
    # a lane's result does not depend on the thread that ran it
    for a, b in zip((*queued[:4], q_evals), (*full[:4], f_evals)):
        assert torch.equal(a, b)
    assert queued.attempts is None and full.attempts is None
    assert int(per_thread.sum()) == int(q_evals.sum())
    route, _ = _solver_route(inp, x0)
    shares = _agreement(full, route)
    assert shares[0] >= SOLVER_SHARE[0] and shares[1] >= SOLVER_SHARE[1]


def test_hw_box_fit_long_series_reads_global_memory(cuda):
    # a series too long for a block's shared tile at any block size
    # (1002 rows of 64 threads: 256 KB) runs from global memory
    rng = np.random.default_rng(14)
    S, n, m = 256, 1000, 4
    inp = hw_sse.prepare(torch.from_numpy(_hw_panel(rng, S, n, m)).to(cuda),
                         m, "additive")
    assert hw_sse.box_fit_config(inp).smem_bytes == 0
    x0 = torch.tensor([0.3, 0.1, 0.1], device=cuda).expand(S, 3)
    got, _ = hw_sse.box_fit(inp, x0)
    route, _ = _solver_route(inp, x0)
    shares = _agreement(got, route)
    assert shares[0] >= SOLVER_SHARE[0] and shares[1] >= SOLVER_SHARE[1]


def test_hw_stream_fit_launches_box_fit_once_per_chunk(cuda):
    rng = np.random.default_rng(15)
    y = _hw_panel(rng, 600, 48, 12)
    before = (hw_sse.box_fit.launches, hw_sse.value_and_grad.launches)
    res = FitEngine().stream_fit(y, "holt_winters", chunk_size=256,
                                 period=12, device=cuda)
    assert not res.chunk_failures and res.n_chunks == 3
    assert (hw_sse.box_fit.launches, hw_sse.value_and_grad.launches) \
        == (before[0] + 3, before[1])
    assert res.stats["box_fit_launches"] == [1, 1, 1]
    assert "value_and_grad_calls" not in res.stats
    assert len(res.stats["lane_evaluations"]) == 3
    # the start and at least one trial for each lane of the smallest
    # (tail) bucket, 128 lanes
    assert min(res.stats["lane_evaluations"]) >= 2 * 128


def _gappy(rng, S, n):
    """A float32 ARIMA panel with ``chip_smoke.py``'s gaps: 1 % of the
    observations knocked out inside each series' window, 5 % of the
    series starting 1-16 steps late; one series all NaN."""
    y = np.cumsum(_panel(rng, S, n), axis=1).astype(np.float32)
    start = np.where(rng.random(S) < 0.05, rng.integers(1, 17, S), 0)
    t = np.arange(n)[None, :]
    y[t < start[:, None]] = np.nan
    y[(rng.random((S, n)) < 0.01) & (t > start[:, None]) & (t < n - 1)] \
        = np.nan
    y[3] = np.nan
    return y


def _index(n):
    return ttime.uniform("2000-01-03T00:00Z", n,
                         ttime.BusinessDayFrequency(1))


@pytest.mark.parametrize("method", ["linear", "nearest", "next", "previous",
                                    "zero", "spline"])
def test_panel_fill_on_cuda_matches_cpu(cuda, method):
    # each step of a fill is its own correctly rounded op: bit for bit
    y = _gappy(np.random.default_rng(30), 4096, 128)
    keys = [f"s{i}" for i in range(y.shape[0])]
    got = Panel(_index(128), y, keys, device=cuda).fill(method)
    want = Panel(_index(128), y, keys, device="cpu").fill(method)
    assert got.device.type == "cuda" and got.values.dtype == torch.float32
    _assert_bitwise(got.values.cpu(), want.values)


def test_panel_on_cuda_is_float32_and_gathers_on_the_card(cuda):
    y = _gappy(np.random.default_rng(31), 64, 40).astype(np.float64)
    keys = [f"s{i}" for i in range(64)]
    p = Panel(_index(40), y, keys, device=cuda)
    assert p.values.dtype == torch.float32
    cpu = Panel(_index(40), y.astype(np.float32), keys, device="cpu")
    for got, want in ((p.select(["s9", "s2"]), cpu.select(["s9", "s2"])),
                      (p.remove_instants_with_nans(),
                       cpu.remove_instants_with_nans()),
                      (p.fill("linear").differences_by_frequency(
                          ttime.DayFrequency(3)),
                       cpu.fill("linear").differences_by_frequency(
                           ttime.DayFrequency(3))),
                      (p.with_index(_index(50)), cpu.with_index(_index(50)))):
        assert got.device.type == "cuda"
        assert got.index.to_string() == want.index.to_string()
        _assert_bitwise(got.values.cpu(), want.values)


def test_panel_stream_fit_on_cuda_matches_engine(cuda):
    y = _gappy(np.random.default_rng(32), 2000, 96)
    y = np.delete(y, 3, axis=0)               # no all-NaN lane to fit
    p = Panel(_index(96), y, [f"s{i}" for i in range(y.shape[0])],
              device=cuda).fill("linear")
    kw = dict(chunk_size=512, collect=True, p=2, d=1, q=2)
    before = (arma_ne.fit_css_lm.launches, arma_ne.normal_equations.launches)
    got = p.stream_fit("arima", **kw)
    assert (arma_ne.fit_css_lm.launches - before[0],
            arma_ne.normal_equations.launches - before[1]) == (4, 0)
    want = FitEngine().stream_fit(p.values.cpu().numpy(), "arima",
                                  device=cuda, **kw)
    assert not got.chunk_failures and got.n_chunks == 4
    assert got.n_converged == want.n_converged
    assert got.stats["input_d2h_s"] > 0
    for g, w in zip(got.models, want.models):
        _assert_bitwise(g.coefficients, w.coefficients)
    # some lanes started late, so the kernel ran its ragged form
    assert np.isnan(p.values[:, 0].cpu().numpy()).any()


def test_panel_auto_fit_on_cuda_matches_auto_fit_panel(cuda):
    y = np.cumsum(_panel(np.random.default_rng(33), 512, 80),
                  axis=1).astype(np.float32)
    p = Panel(_index(80), y, [f"s{i}" for i in range(512)], device=cuda)
    stats = {}
    got = p.auto_fit(max_p=2, max_q=2, stats=stats)
    assert stats["lm_fit_launches"] == 10
    want = arima.auto_fit_panel(y, max_p=2, max_q=2, device=cuda)
    np.testing.assert_array_equal(got.orders, want.orders)
    np.testing.assert_array_equal(got.coefficients, want.coefficients)


def test_csv_codec_builds_on_this_machine(cuda, tmp_path):
    assert io.fastcsv() is not None, "g++ could not build the codec"
    y = _gappy(np.random.default_rng(34), 300, 50)
    p = Panel(_index(50), y, [f"s,{i}" for i in range(300)], device=cuda)
    io.save_csv(p, str(tmp_path / "p"))
    back = io.load_csv(str(tmp_path / "p"), device=cuda)
    assert back.keys == p.keys
    assert back.index.to_string() == p.index.to_string()
    _assert_bitwise(back.values, p.values)


# -- the fail-soft tier on the card ----------------------------------------

@pytest.mark.parametrize("ragged", [False, True])
def test_css_gradient_through_arma_ne_matches_plain(cuda, ragged):
    rng = np.random.default_rng(21)
    S, n = 2048, 90
    y = torch.from_numpy(_panel(rng, S, n).astype(np.float32)).to(cuda)
    x = torch.from_numpy((0.1 * rng.normal(size=(S, 5))
                          + [1.0, 0.2, 0.2, 0.1, 0.1]).astype(np.float32)
                         ).to(cuda)
    nv = torch.from_numpy(rng.integers(30, n + 1, size=S)).to(cuda) \
        if ragged else None
    before = arma_ne.normal_equations.launches
    f, g = arma_ne.css_neg_ll_value_and_grad(x, y, 2, 2, 1, n_valid=nv)
    assert arma_ne.normal_equations.launches == before + 1
    f0, g0 = arma_ne.css_neg_ll_value_and_grad_plain(x, y, 2, 2, 1,
                                                     n_valid=nv)
    # float32 both, the pass's sums in other orders
    torch.testing.assert_close(f, f0, rtol=1e-5, atol=1e-4)
    scale = g0.abs().amax(dim=1, keepdim=True) + 1.0
    assert ((g - g0).abs() <= 1e-4 * scale).all()
    model = arima.ARIMAModel(2, 0, 2, x)
    before = arma_ne.normal_equations.launches
    grad = model.gradient_log_likelihood_css_arma(y)
    assert arma_ne.normal_equations.launches == before + 1
    if not ragged:
        torch.testing.assert_close(grad, -g)


def test_restart_loop_over_kernel_matches_route(cuda):
    from spark_timeseries_tpu_torch.ops import optimize

    rng = np.random.default_rng(22)
    S, n = 4096, 100
    y = torch.from_numpy(np.diff(_panel(rng, S, n), axis=1)
                         .astype(np.float32)).to(cuda)
    x0 = arima.hannan_rissanen_init(2, 2, y, True)
    draws = optimize.restart_draws(2, S, 5, torch.float32, cuda, seed=3)

    def restarted(fit):
        def solve(xs, idx):
            yy = y if idx is None else y.index_select(0, idx)
            return fit(xs, yy, 2, 2, 1, max_iter=12)
        stats = {}
        res = optimize.solve_with_restarts(solve, x0, 2, 0.25,
                                           jitter_draws=draws, stats=stats)
        return res, stats

    before = arma_ne.fit_css_lm.launches
    kern, ks = restarted(arma_ne.fit_css_lm)
    assert arma_ne.fit_css_lm.launches - before == ks["solves"]
    assert ks["solves"] == 1 + len(ks["restart_lanes"]) >= 2
    route, rs = restarted(arma_ne.fit_css_lm_route)
    assert rs["restart_lanes"] == ks["restart_lanes"]
    same = (kern.n_iter == route.n_iter) & (kern.attempts == route.attempts)
    assert same.double().mean() >= 0.95
    close = torch.isclose(kern.fun, route.fun, rtol=1e-5, equal_nan=True)
    assert close.double().mean() >= 0.95


def test_fit_resilient_on_cuda_matches_cpu(cuda):
    from spark_timeseries_tpu_torch.utils import resilience

    rng = np.random.default_rng(23)
    y = np.cumsum(_panel(rng, 512, 96), axis=1).astype(np.float32)
    y[0] = np.nan
    y[1] = 2.0
    y[2, 30] = np.inf
    y[3, 40] = np.nan
    y[4, :90] = np.nan
    stats = {}
    model, out = arima.fit_resilient(y, 2, 1, 2, auto_order=True,
                                     device=cuda, stats=stats)
    cpu_model, cpu_out = arima.fit_resilient(y, 2, 1, 2, auto_order=True,
                                             device="cpu")
    np.testing.assert_array_equal(out.health, cpu_out.health)
    assert out.counts()["skipped"] == cpu_out.counts()["skipped"] == 4
    assert stats["lm_fit_launches"] == sum(
        stats["lm_fit_launches_by_stage"].values()) >= 2
    usable = np.isin(out.status, (0, 1, 2)).mean()
    assert usable >= np.isin(cpu_out.status, (0, 1, 2)).mean() - 0.02
    # a padded bucket through the engine is the direct chain bit for bit
    via, v_out = FitEngine().fit_resilient(y[:500], "arima", 2, 1, 2,
                                           auto_order=True, device=cuda)
    direct, d_out = arima.fit_resilient(y[:500], 2, 1, 2, auto_order=True,
                                        device=cuda)
    assert torch.equal(via.coefficients.nan_to_num(7.0),
                       direct.coefficients.nan_to_num(7.0))
    np.testing.assert_array_equal(v_out.status, d_out.status)
    assert resilience.unfittable_mask(out.health)[:5].tolist() == [
        True, False, True, True, True]


def test_css_cgd_counts_one_arma_ne_launch_per_evaluation(cuda):
    """``method="css-cgd"`` on the card: every BFGS evaluation is one
    ``arma_ne`` launch over the lanes still running, as its stats say;
    the BFGS over the kernel agrees with the BFGS over the plain pass.
    A lane agrees when both ``fun`` are NaN (its float32 objective is
    NaN at the start, so both runs stay there) or both are finite and
    within 1e-5; the finite lanes part only where float32 rounding,
    amplified along a failing line search, sends the two runs apart
    (``tools/torch_cgd_miss_trace.py``; PERF.md §6)."""
    from spark_timeseries_tpu_torch.ops import optimize
    from spark_timeseries_tpu_torch.ops.univariate import \
        differences_of_order_d
    rng = np.random.default_rng(31)
    y = torch.from_numpy(np.cumsum(_panel(rng, 512, 96), axis=1)
                         .astype(np.float32)).to(cuda)
    arma_ne.normal_equations.launches = 0
    st = {}
    m = arima.fit(2, 1, 2, y, method="css-cgd", warn=False, device=cuda,
                  stats=st)
    assert arma_ne.normal_equations.launches == st["ne_launches"] > 0
    lm = arima.fit(2, 1, 2, y, warn=False, device=cuda)
    fin = torch.isfinite(lm.coefficients).all(dim=-1)
    assert torch.isfinite(m.coefficients[fin]).all()
    diffed = differences_of_order_d(y, 1)[..., 1:]
    x0 = arima.hannan_rissanen_init(2, 2, diffed, True)

    def bfgs(fn):
        def ev_for(idx):
            yy = diffed if idx is None else diffed.index_select(0, idx)
            return lambda x: fn(x, yy, 2, 2, 1)
        return optimize.minimize_bfgs(ev_for(None), x0,
                                      evaluator_for=ev_for)

    kern = bfgs(arma_ne.css_neg_ll_value_and_grad)
    plain = bfgs(arma_ne.css_neg_ll_value_and_grad_plain)
    both_nan = torch.isnan(kern.fun) & torch.isnan(plain.fun)
    both_fin = torch.isfinite(kern.fun) & torch.isfinite(plain.fun)
    rel = (kern.fun - plain.fun).abs() / plain.fun.abs()
    close = both_fin & (rel <= 1e-5)
    assert (close | both_nan).double().mean() >= 0.9
    assert close[both_fin].double().mean() >= 0.9


def test_holt_winters_retry_on_cuda(cuda):
    """``holt_winters.fit(retry=...)`` on the card: attempt 0 is the plain
    fit bit for bit, each restart one ``hw_box_fit`` launch over the
    gathered failing lanes."""
    from spark_timeseries_tpu_torch.utils.resilience import RetryPolicy
    rng = np.random.default_rng(32)
    t = np.arange(72)
    y = (100 + 0.5 * t + 10 * np.sin(2 * np.pi * t / 12)
         + rng.normal(0, 2, (2048, 72))).astype(np.float32)
    hw_sse.box_fit.launches = 0
    st = {}
    got = holt_winters.fit(y, 12, max_iter=20, retry=RetryPolicy(),
                           device=cuda, stats=st)
    assert hw_sse.box_fit.launches == st["box_fit_launches"] \
        == 1 + len(st["restart_lanes"]) >= 2
    plain = holt_winters.fit(y, 12, max_iter=20, device=cuda)
    first = got.diagnostics.attempts == 1
    assert torch.equal(got.alpha[first], plain.alpha[first])


@pytest.mark.parametrize("family", ["ewma", "garch", "argarch", "egarch"])
def test_new_families_stream_on_cuda(cuda, family):
    """The volatility and smoothing families through the engine on the
    card: each chunk bitwise the direct fit, parameters finite, objectives
    near the CPU's float64 fit of the same rows."""
    from spark_timeseries_tpu_torch.models import ewma, garch
    rng = np.random.default_rng(33)
    y = rng.standard_t(6, size=(512, 256)) * 0.5
    if family == "ewma":
        y = np.cumsum(y, axis=1) + 100.0
    y = y.astype(np.float32)
    direct = {"ewma": ewma.fit, "garch": garch.fit,
              "argarch": garch.fit_ar_garch,
              "egarch": garch.fit_egarch}[family]
    res = FitEngine().stream_fit(y, family, chunk_size=256, collect=True,
                                 device=cuda)
    assert not res.chunk_failures
    want = direct(torch.from_numpy(y[:256]).to(cuda), device=cuda)
    got = res.models[0]
    for f in want._fields:
        if f != "diagnostics":
            assert torch.equal(getattr(got, f), getattr(want, f).cpu())
            assert torch.isfinite(getattr(got, f)).all()
    ref = direct(y[:64].astype(np.float64), device="cpu")
    both = (got.diagnostics.converged[:64] & ref.diagnostics.converged)
    rel = ((got.diagnostics.fun[:64].double() - ref.diagnostics.fun).abs()
           / ref.diagnostics.fun.abs())[both]
    assert both.sum() >= 16 and (rel <= 1e-4).double().mean() >= 0.9


def test_egarch_graph_replay_is_the_eager_pass(cuda):
    """The CUDA-graph replay of the EGARCH derivative pass equals the
    eager pass to float32 rounding, also on fewer lanes than it was
    captured at, and a fit through it is reproducible bit for bit (the
    resilient and Panel checks of ``chip_smoke.py`` rely on that)."""
    from spark_timeseries_tpu_torch.models import garch
    rng = np.random.default_rng(34)
    y = torch.from_numpy((rng.standard_t(6, size=(1024, 128)) * 0.5)
                         .astype(np.float32)).to(cuda)
    x = torch.from_numpy(np.c_[rng.normal(-0.3, 0.1, 1024),
                               rng.uniform(0.05, 0.3, 1024),
                               rng.uniform(0.5, 2.0, 1024),
                               rng.normal(0, 0.1, 1024)]
                         .astype(np.float32)).to(cuda)
    rep = garch._ReplayedDerivatives(2)
    want = garch._egarch_derivatives(x, y, 2)
    for lanes in (1024, 300):
        for g, w in zip(rep(x[:lanes], y[:lanes]), want):
            torch.testing.assert_close(g, w[:lanes], rtol=1e-4, atol=1e-3,
                                       equal_nan=True)
    a = garch.fit_egarch(y, device=cuda)
    b = garch.fit_egarch(y, device=cuda)
    for f in ("omega", "alpha", "beta", "gamma"):
        assert torch.equal(getattr(a, f), getattr(b, f))


def _arimax_rows(rng, S, n):
    """ARIMA(2,1,2) rows plus two shared random-walk regressors, float32."""
    x = np.cumsum(rng.normal(size=(n, 2)), axis=0)
    y = np.cumsum(_panel(rng, S, n), axis=1) + x @ [0.8, -0.5]
    return y.astype(np.float32), x.astype(np.float32)


def test_arimax_css_lm_is_one_lm_fit_launch(cuda):
    """ARIMAX's css-lm refine on the card is one LM-fit launch over the
    xreg-adjusted series (no ``arma_ne``); its lanes agree with the
    float64 CPU fit by objective where both converged."""
    from spark_timeseries_tpu_torch.models import arimax
    y, x = _arimax_rows(np.random.default_rng(35), 2048, 96)
    arma_ne.fit_css_lm.launches = 0
    arma_ne.normal_equations.launches = 0
    st = {}
    m = arimax.fit(2, 1, 2, torch.from_numpy(y).to(cuda), x, 1, device=cuda,
                   stats=st)
    assert arma_ne.fit_css_lm.launches == st["lm_fit_launches"] == 1
    assert arma_ne.normal_equations.launches == 0
    ref = arimax.fit(2, 1, 2, y[:128].astype(np.float64),
                     x.astype(np.float64), 1, device="cpu")
    both = (m.diagnostics.converged[:128].cpu()
            & ref.diagnostics.converged)
    # fun is the residual sum of squares at each fit's own optimum
    rel = ((m.diagnostics.fun[:128].cpu().double() - ref.diagnostics.fun)
           .abs() / ref.diagnostics.fun.abs())[both]
    assert both.sum() >= 64 and (rel <= 1e-3).double().mean() >= 0.9


def test_arimax_css_cgd_counts_one_arma_ne_launch_per_evaluation(cuda):
    """ARIMAX's css-cgd on the card: one ``arma_ne`` launch per BFGS
    evaluation, as its stats say, and no LM-fit launch."""
    from spark_timeseries_tpu_torch.models import arimax
    y, x = _arimax_rows(np.random.default_rng(36), 1024, 96)
    arma_ne.fit_css_lm.launches = 0
    arma_ne.normal_equations.launches = 0
    st = {}
    m = arimax.fit(2, 1, 2, torch.from_numpy(y).to(cuda), x, 1,
                   method="css-cgd", device=cuda, stats=st)
    assert arma_ne.normal_equations.launches == st["ne_launches"] > 0
    assert arma_ne.fit_css_lm.launches == 0
    assert torch.isfinite(m.coefficients).all(dim=-1).double().mean() > 0.9


def test_statespace_filter_on_cuda_matches_cpu_float64(cuda):
    """``stationary_covariance`` and ``filter_panel`` (a NaN tick and a
    ragged lane included) in float32 on the card against float64 on the
    CPU, within float32 tolerance."""
    from spark_timeseries_tpu_torch.statespace import convert, kalman, ssm
    rng = np.random.default_rng(37)
    S, n = 4096, 120
    phi = rng.uniform(-0.4, 0.4, size=(S, 2))
    theta = rng.uniform(-0.4, 0.4, size=(S, 2))
    c = rng.normal(size=S)
    ys = rng.normal(size=(S, n))
    ys[3, 17] = np.nan
    w = np.ones((S, n))
    w[5, 90:] = 0.0
    out = {}
    for dev, dt in ((cuda, torch.float32), ("cpu", torch.float64)):
        model = convert.companion_arma(
            torch.from_numpy(phi).to(dev, dt),
            torch.from_numpy(theta).to(dev, dt),
            torch.from_numpy(c).to(dev, dt))
        meta = ssm.SSMeta("arima", "exact", 0, model.state_dim)
        st0 = ssm.initial_state(model, meta)
        res = kalman.filter_panel(model, st0,
                                  torch.from_numpy(ys).to(dev, dt), meta,
                                  weights=torch.from_numpy(w).to(dev, dt))
        out[str(dev)] = (st0.P.cpu().double(), res.loglik.cpu().double(),
                         kalman.concentrated_loglik(res.state).cpu()
                         .double())
    got, want = out[str(cuda)], out["cpu"]
    torch.testing.assert_close(got[0], want[0], rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(got[1], want[1], rtol=1e-4, atol=1e-3)
    torch.testing.assert_close(got[2], want[2], rtol=1e-4, atol=1e-3)


def test_exact_objective_on_cuda_is_monotone_against_css(cuda):
    """``arima.fit(objective="exact")`` on the card: one LM-fit launch for
    its CSS stage, then the BFGS refine; no lane's exact log likelihood
    (the fit's reported ``-diagnostics.fun``) falls below its CSS
    start's, and recomputing it agrees to float32 rounding on the
    stationary, invertible lanes (elsewhere the filter's recursion grows
    until rounding sets its leading digits)."""
    rng = np.random.default_rng(38)
    y = torch.from_numpy(np.cumsum(_panel(rng, 2048, 96), axis=1)
                         .astype(np.float32)).to(cuda)
    arma_ne.fit_css_lm.launches = 0
    st = {}
    exact = arima.fit(2, 1, 2, y, objective="exact", warn=False,
                      device=cuda, stats=st)
    assert arma_ne.fit_css_lm.launches == st["lm_fit_launches"] == 1
    css = arima.fit(2, 1, 2, y, warn=False, device=cuda)
    ll_ex = -exact.diagnostics.fun
    ll_css = css.log_likelihood_exact(y)
    both = torch.isfinite(ll_ex) & torch.isfinite(ll_css)
    # a CSS start with an explosive AR part has no stationary prior: its
    # exact log likelihood is NaN in both (~14 % of these lanes)
    assert both.double().mean() > 0.75
    assert (ll_ex[both] >= ll_css[both]).all()
    sane = both & torch.from_numpy(exact.is_stationary()
                                   & exact.is_invertible()).to(cuda)
    assert sane.double().mean() > 0.5
    torch.testing.assert_close(exact.log_likelihood_exact(y)[sane],
                               ll_ex[sane], rtol=1e-4, atol=1e-3)


# -- the online serving tier ------------------------------------------------

def _serving_case(rng, S, n_hist, n_live):
    """An ARIMA(2,1,2)+c model with stationary, invertible per-lane
    coefficients (no fit: the serving tier is held, not the fit) and an
    integrated ARMA panel, float32."""
    coefs = np.column_stack([
        rng.uniform(-0.1, 0.1, S), rng.uniform(0.2, 0.5, S),
        rng.uniform(-0.3, 0.0, S), rng.uniform(-0.4, 0.4, S),
        rng.uniform(-0.2, 0.2, S)]).astype(np.float32)
    y = np.cumsum(_panel(rng, S, n_hist + n_live), axis=1) \
        .astype(np.float32)
    return coefs, y[:, :n_hist], y[:, n_hist:]


def test_serving_session_on_cuda_matches_cpu(cuda):
    """A 512-lane session on the card against the same float32 session
    on the CPU: v, F, the likelihood increments and the forecasts within
    float32 rounding, statuses equal."""
    from spark_timeseries_tpu_torch.statespace import serving

    rng = np.random.default_rng(40)
    coefs, hist, live = _serving_case(rng, 512, 64, 16)
    out = {}
    for dev in (cuda, torch.device("cpu")):
        model = arima.ARIMAModel(2, 1, 2, torch.from_numpy(coefs), True)
        sess = serving.ServingSession.start(model, hist, device=dev)
        sess.warmup()
        ticks = [sess.update(live[:, t]) for t in range(live.shape[1])]
        out[dev.type] = (ticks, sess.forecast(12))
    for got, want in zip(out["cuda"][0], out["cpu"][0]):
        np.testing.assert_array_equal(got.status, want.status)
        for g, w in zip(got[:3], want[:3]):
            np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(out["cuda"][1], out["cpu"][1], rtol=1e-4,
                               atol=1e-3)


def test_serving_update_batch_is_the_single_updates_on_cuda(cuda):
    from spark_timeseries_tpu_torch.statespace import serving

    rng = np.random.default_rng(41)
    coefs, hist, live = _serving_case(rng, 1000, 64, 12)
    model = arima.ARIMAModel(2, 1, 2, torch.from_numpy(coefs).to(cuda), True)
    one = serving.ServingSession.start(model, hist, device=cuda)
    batch = serving.ServingSession.start(model, hist, device=cuda)
    for t in range(live.shape[1]):
        last = one.update(live[:, t])
    b_last = batch.update_batch(live)
    for a, b in zip(b_last, last):
        assert np.array_equal(a.view(np.uint8), b.view(np.uint8))
    for a, b in zip(batch._state, one._state):
        assert torch.equal(a, b)


def test_serving_heal_launches_the_lm_fit_kernel(cuda):
    """``heal()`` of poisoned lanes on the card refits them through the
    LM-fit kernel: its launches are the refit chain's own count, and the
    poisoned lanes leave quarantine."""
    from spark_timeseries_tpu_torch.statespace import health, serving
    from spark_timeseries_tpu_torch.utils import resilience

    rng = np.random.default_rng(42)
    coefs, hist, live = _serving_case(rng, 256, 96, 4)
    model = arima.ARIMAModel(2, 1, 2, torch.from_numpy(coefs).to(cuda), True)
    sess = serving.ServingSession.start(model, hist, device=cuda)
    with resilience.fault_injection("state_poison", lane_stride=32):
        sess.update(live[:, 0])
    sess.update(live[:, 1])
    poisoned = np.arange(256)[::32]
    assert (sess.lane_status[poisoned] == health.LANE_DIVERGED).all()
    before = arma_ne.fit_css_lm.launches
    st = {}
    rep = sess.heal(stats=st)
    assert arma_ne.fit_css_lm.launches - before == st["lm_fit_launches"] >= 1
    assert rep["healed"] >= poisoned.size
    assert (sess.lane_status[poisoned] != health.LANE_DIVERGED).all()


# -- the long-series tier and backtesting -------------------------------------

def _long_arma11(n, seed):
    rng = np.random.default_rng(seed)
    e = rng.standard_normal(n + 1)
    x = e[1:] + 0.4 * e[:-1]
    y = np.zeros(n)
    for t in range(n):
        y[t] = 0.1 + 0.6 * (y[t - 1] if t else 0.0) + x[t]
    return y.astype(np.float32)


@pytest.mark.parametrize("fused", [True, False])
def test_fit_long_on_cuda_matches_cpu(cuda, fused):
    """``longseries.fit_long`` on the card (one ``arma_lm_fit`` launch a
    segment chunk, no one-pass launch) against the same float32 fit on
    the CPU: the combined coefficients and the forecast within float32
    rounding of the segment fits (the LM stops at a relative drop of
    1e-6 on both, their sums in other orders)."""
    from spark_timeseries_tpu_torch import longseries

    y = _long_arma11(16384, 50)
    kw = dict(order=(1, 0, 1), seg_len=1024, chunk_segments=8, warn=False,
              fused=fused)
    lm0, ne0 = arma_ne.fit_css_lm.launches, arma_ne.normal_equations.launches
    got = longseries.fit_long(y, device=cuda, **kw)
    assert arma_ne.fit_css_lm.launches - lm0 == 2       # 16 segments / 8
    assert arma_ne.normal_equations.launches == ne0
    want = longseries.fit_long(y, device="cpu", **kw)
    np.testing.assert_allclose(got.coefficients.cpu().numpy(),
                               want.coefficients.numpy(), rtol=0, atol=1e-3)
    np.testing.assert_allclose(got.forecast(12), want.forecast(12),
                               rtol=1e-3, atol=1e-3)
    if fused:
        assert got.stream_stats["lm_fit_launches"] == 2
    assert got.combined.n_weighted == want.combined.n_weighted == 16


def test_arima_fit_long_on_cuda_matches_cpu(cuda):
    from spark_timeseries_tpu_torch.models import arima as tarima

    y = np.stack([_long_arma11(8192, 51), _long_arma11(8192, 52)])
    st = {}
    lm0 = arma_ne.fit_css_lm.launches
    got = tarima.fit_long(1, 0, 1, y, segment_len=2048, warn=False,
                          device=cuda, stats=st)
    assert arma_ne.fit_css_lm.launches - lm0 == st["lm_fit_launches"] == 1
    want = tarima.fit_long(1, 0, 1, y, segment_len=2048, warn=False,
                           device="cpu")
    np.testing.assert_allclose(got.coefficients.cpu().numpy(),
                               want.coefficients.numpy(), rtol=0, atol=1e-3)


def test_backtest_panel_on_cuda_matches_cpu(cuda):
    """``backtest_panel`` on the card against the same float32 sweep on
    the CPU: equal champions, scores within 1e-3 relative (float32 fits
    end ~1e-5 apart), one ``arma_lm_fit`` launch for the ARIMA
    candidate's one chunk."""
    from spark_timeseries_tpu_torch.backtest import (CandidateGrid,
                                                     backtest_panel)

    rng = np.random.default_rng(53)
    S, n = 24, 400
    e = rng.standard_normal((S, n + 1))
    y = np.zeros((S, n))
    for t in range(n):
        y[:, t] = 2.0 + 0.5 * (y[:, t - 1] if t else 0.0) + e[:, t + 1] \
            + 0.3 * e[:, t]
    y = y.astype(np.float32)
    grid = CandidateGrid({"ar": [1], "arima": [(1, 0, 1)], "ewma": True},
                         horizons=(1, 4))
    kw = dict(n_origins=16, stride=4, min_train=300)
    lm0 = arma_ne.fit_css_lm.launches
    got = backtest_panel(y, grid, device=cuda, **kw)
    assert arma_ne.fit_css_lm.launches - lm0 == 1
    assert got.stream_stats[1]["lm_fit_launches"] == 1
    want = backtest_panel(y, grid, device="cpu", **kw)
    assert (got.champion == want.champion).mean() >= 0.95
    np.testing.assert_allclose(got.scores_mase, want.scores_mase, rtol=1e-3)


# -- the engine's durability tier -----------------------------------------------

def _cat_models(models, field="coefficients"):
    if field == "coefficients":
        return torch.cat([m.coefficients.cpu() for m in models])
    return torch.cat([getattr(m.diagnostics, field).cpu() for m in models])


def _bits(t):
    """``t`` on the host, a float's bits as an integer (NaN lanes compare
    equal to the same NaN)."""
    t = t.cpu().contiguous()
    if t.is_floating_point():
        return t.view(torch.int32 if t.element_size() == 4 else torch.int64)
    return t


def _same_lanes(got, want):
    return all(torch.equal(_bits(_cat_models(got, f)),
                           _bits(_cat_models(want, f)))
               for f in ("coefficients", "converged", "n_iter", "fun"))


def test_oom_halving_on_cuda_is_bitwise(cuda):
    """A ``torch.cuda.OutOfMemoryError`` (the ``oom_chunk`` fault, and a
    real one raised from the fit) halves a 4096-lane chunk into two
    2048-lane sub-chunks whose lanes are the whole chunk's bit for bit
    (the Hannan-Rissanen grams reduce per lane, not through a batched
    GEMM whose kernel may change with the batch); a kernel fault raises
    out of the stream."""
    from spark_timeseries_tpu_torch import engine
    from spark_timeseries_tpu_torch._device import KernelError
    from spark_timeseries_tpu_torch.utils import resilience

    y = _panel(np.random.default_rng(61), 8192, 96).astype(np.float32)
    kw = dict(chunk_size=4096, p=2, d=1, q=2, device=cuda, collect=True)
    whole = FitEngine().stream_fit(y, "arima", **kw)
    with resilience.fault_injection("oom_chunk", chunk_index=1):
        injected = FitEngine().stream_fit(y, "arima", **kw)
    assert injected.stats["degraded_chunks"] == 1
    assert injected.stats["collected_ranges"] == [[0, 4096], [4096, 6144],
                                                  [6144, 8192]]
    assert _same_lanes(injected.models, whole.models)

    real = engine._fit_values

    def oom_at_full(family, statics, values, warn=False, stats=None):
        if values.shape[0] == 4096:
            raise torch.cuda.OutOfMemoryError("CUDA out of memory (test)")
        return real(family, statics, values, warn=warn, stats=stats)

    engine._fit_values = oom_at_full
    try:
        halved = FitEngine().stream_fit(y, "arima", **kw)
    finally:
        engine._fit_values = real
    assert halved.stats["degraded_chunks"] == 2
    assert halved.stats["lm_fit_launches"] == [1, 1, 1, 1]
    assert _same_lanes(halved.models, whole.models)

    def fault(*a, **k):
        raise KernelError("arma_lm_fit launch failed (test)")

    engine._fit_values = fault
    try:
        with pytest.raises(KernelError):
            FitEngine().stream_fit(y, "arima", **kw)
    finally:
        engine._fit_values = real


def test_journal_resume_on_cuda_is_bitwise(cuda, tmp_path):
    """A journaled stream on the card commits each chunk; a rerun
    restores them (no launch) bit for bit, and a CPU stream of the same
    panel refuses the card's journal (the spec records the device
    type)."""
    from spark_timeseries_tpu_torch.utils.durability import \
        JournalSpecMismatch

    y = _panel(np.random.default_rng(62), 3000, 96).astype(np.float32)
    kw = dict(chunk_size=1024, p=2, d=1, q=2, collect=True,
              journal=str(tmp_path / "j"))
    lm0 = arma_ne.fit_css_lm.launches
    first = FitEngine().stream_fit(y, "arima", device=cuda, **kw)
    assert arma_ne.fit_css_lm.launches - lm0 == 3
    assert first.stats["journal_commits"] == 3
    lm0 = arma_ne.fit_css_lm.launches
    again = FitEngine().stream_fit(y, "arima", device=cuda, **kw)
    assert arma_ne.fit_css_lm.launches - lm0 == 0
    assert again.stats["journal_hits"] == 3
    assert _same_lanes(again.models, first.models)
    with pytest.raises(JournalSpecMismatch, match="device"):
        FitEngine().stream_fit(y, "arima", device="cpu", **kw)


def test_deadline_worker_with_side_stream_staging_on_cuda(cuda):
    """Under ``deadline_s`` every chunk fits in a worker thread on the
    caller's stream while the next chunk's copy runs on the side stream
    (``prefetch=2``): the results are the plain stream's bit for bit; a
    hung chunk is abandoned with its staging slot, the stream goes on,
    and the retry after the worker ends recovers it, bitwise."""
    from spark_timeseries_tpu_torch.utils import resilience
    from spark_timeseries_tpu_torch.utils.durability import BackoffPolicy

    y = _panel(np.random.default_rng(63), 4096, 96).astype(np.float32)
    kw = dict(chunk_size=1024, p=2, d=1, q=2, device=cuda, collect=True)
    plain = FitEngine().stream_fit(y, "arima", **kw)
    watched = FitEngine(prefetch=2).stream_fit(y, "arima", deadline_s=30.0,
                                               **kw)
    assert _same_lanes(watched.models, plain.models)
    side = torch.cuda.Stream()
    with torch.cuda.stream(side):
        with resilience.fault_injection("hang_chunk", chunk_index=1,
                                        hang_s=2.0):
            hung = FitEngine(prefetch=2).stream_fit(
                y, "arima", deadline_s=1.0,
                retry=BackoffPolicy(max_retries=1, base_delay_s=5.0), **kw)
    torch.cuda.synchronize()
    assert (hung.stats["deadline_expired"], hung.stats["recovered"],
            hung.stats["dead_chunks"]) == (1, 1, 0)
    assert _same_lanes(hung.models, plain.models)


def test_engine_warmup_on_cuda(cuda):
    """The warm-up builds and launches each family's kernel once per new
    key on the card; a fit after it is bitwise a fresh engine's."""
    y = _panel(np.random.default_rng(7), 4096, 128).astype(np.float32)
    cold = FitEngine().fit(y, "arima", device=cuda)
    eng = FitEngine()
    before = (arma_ne.fit_css_lm.launches, hw_sse.box_fit.launches)
    rep = eng.warmup(("arima", "holt_winters"), [(4096, 128)], device=cuda)
    assert rep["platform"] == "cuda"
    assert [(r["family"], r["variant"]) for r in rep["built"]] == [
        ("arima", "dense"), ("arima", "ragged"), ("holt_winters", "dense")]
    assert (arma_ne.fit_css_lm.launches - before[0],
            hw_sse.box_fit.launches - before[1]) == (2, 1)
    again = eng.warmup(("arima",), [(4096, 128)], device=cuda)
    assert again["cache_hits"] == rep["cache_hits"] + 2
    assert arma_ne.fit_css_lm.launches - before[0] == 2
    warm = eng.fit(y, "arima", device=cuda)
    for a, b in ((warm.coefficients, cold.coefficients),
                 (warm.diagnostics.n_iter, cold.diagnostics.n_iter)):
        assert torch.equal(a, b)


def test_warm_build_directory_runs_no_nvcc(cuda, tmp_path):
    """A fresh process pointed at a directory that holds the current
    builds (``--cache-dir``, the kernel build cache) loads them: the
    engine CLI's report counts no build and a cache hit."""
    import json
    import os
    import shutil
    import subprocess
    import sys

    from spark_timeseries_tpu_torch import _build

    _build.build_all()
    cache = str(tmp_path / "kernels")
    shutil.copytree(_build.BUILD_DIR, cache)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {k: v for k, v in os.environ.items() if k != "STS_COMPILE_CACHE"}
    out = subprocess.run(
        [sys.executable, "-m", "spark_timeseries_tpu_torch.engine",
         "--families", "arima", "--shapes", "1024x64", "--cache-dir",
         cache], capture_output=True, text=True, timeout=600, cwd=repo,
        env=env)
    assert out.returncode == 0, out.stderr[-2000:]
    kern = json.loads(out.stdout)["kernels"]
    assert kern["builds"] == 0 and kern["cache_hits"] == 1
    assert kern["launches"]["arma_lm_fit"] == 2
