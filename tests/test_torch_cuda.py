"""The port on an NVIDIA card: the CUDA kernels (ARMA normal equations,
CSS cost, Holt-Winters SSE value and gradient) against their plain
versions, and the fits and the streaming engine on CUDA against the same
calls on the CPU.

Every test here needs a card and skips without one.  The file imports
neither ``jax`` nor the JAX package, so a machine without JAX runs it
(``tests/conftest.py`` imports JAX, hence ``--noconftest``)::

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q
"""

import numpy as np
import pytest
import torch

from spark_timeseries_tpu_torch.engine import FitEngine
from spark_timeseries_tpu_torch.models import arima, holt_winters
from spark_timeseries_tpu_torch.ops import arma_ne, hw_sse

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
    with pytest.raises(ValueError, match="p, q <= 3"):
        arma_ne.normal_equations(params.new_zeros((S, icpt + 5)), y, 4, 1,
                                 icpt)


def test_fit_on_cuda_matches_cpu(cuda):
    rng = np.random.default_rng(5)
    y = np.cumsum(_panel(rng, 2048, 96), axis=1).astype(np.float32)
    before = arma_ne.normal_equations.launches
    got = arima.fit(2, 1, 2, y, warn=False, device=cuda)
    launches = arma_ne.normal_equations.launches - before
    # once before the LM loop, once per iteration
    assert launches == int(got.diagnostics.n_iter.max()) + 1
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
    before = hw_sse.value_and_grad.launches
    got = holt_winters.fit(y, 12, device=cuda, stats=stats)
    assert hw_sse.value_and_grad.launches - before == stats["calls"]
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
    with pytest.raises(ValueError, match="float32"):
        hw_sse.value_and_grad(torch.full((8, 3), 0.3, dtype=torch.float64,
                                         device=cuda), yt, 4, "additive")
