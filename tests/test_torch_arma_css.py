"""The port's cost-only ARMA pass against the JAX package.

``css_cost_plain`` (the cost-only kernel's plain twin) against the JAX
residuals and the archived Pallas ``_css_kernel`` in interpret mode, and
``ARIMAModel.log_likelihood_css`` routed through ``css_cost``.  The CUDA
kernels themselves run only on a card (``tests/test_torch_cuda.py``).
"""

import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spark_timeseries_tpu.models import arima as jarima
from spark_timeseries_tpu_torch.models.arima import ARIMAModel
from spark_timeseries_tpu_torch.ops import arma_ne

torch.set_num_threads(1)


def _panel(rng, S, n, phi=(0.25, 0.35), theta=(0.3, 0.1)):
    e = rng.normal(size=(S, n + 16))
    y = np.zeros_like(e)
    for t in range(2, e.shape[1]):
        y[:, t] = 1.0 + phi[0] * y[:, t - 1] + phi[1] * y[:, t - 2] \
            + e[:, t] + theta[0] * e[:, t - 1] + theta[1] * e[:, t - 2]
    return y[:, 16:]


def _load_arma_pallas():
    path = Path(__file__).resolve().parents[1] / "docs" / "experiments" \
        / "arma_pallas.py"
    spec = importlib.util.spec_from_file_location("_arma_pallas", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("p,q,icpt,ragged", [(2, 2, 1, False),
                                             (2, 2, 1, True),
                                             (5, 0, 1, False),
                                             (1, 5, 0, True),
                                             (4, 2, 1, True),
                                             (5, 3, 0, False),
                                             (7, 1, 1, True)])
def test_css_cost_plain_matches_jax_residuals(p, q, icpt, ragged):
    rng = np.random.default_rng(5)
    S, n = 40, 64
    y = _panel(rng, S, n)
    k = icpt + p + q
    params = 0.1 * rng.normal(size=(S, k))
    nv = rng.integers(20, n + 1, size=S) if ragged else None
    if ragged:
        y = np.where(np.arange(n)[None, :] < nv[:, None], y, 0.0)
    got = arma_ne.css_cost_plain(
        torch.from_numpy(params), torch.from_numpy(y), p, q, icpt,
        n_valid=None if nv is None else torch.from_numpy(nv))
    err = np.asarray(jax.vmap(
        lambda prm, yy: jarima._one_step_errors(prm, yy, p, q, icpt)[1])(
            jnp.asarray(params), jnp.asarray(y)))
    if ragged:
        err = err * (np.arange(max(p, q), n)[None, :] < nv[:, None])
    # float64, the same recurrence summed in another order
    np.testing.assert_allclose(got.numpy(), (err * err).sum(axis=1),
                               rtol=1e-11)
    before = arma_ne.css_cost.launches
    assert torch.equal(arma_ne.css_cost(
        torch.from_numpy(params), torch.from_numpy(y), p, q, icpt,
        n_valid=None if nv is None else torch.from_numpy(nv)), got)
    assert arma_ne.css_cost.launches == before      # no kernel here
    if p <= 3 and q <= 3:
        # the cost mode is the normal equations' sse, op for op
        _, _, sse = arma_ne.normal_equations_plain(
            torch.from_numpy(params), torch.from_numpy(y), p, q, icpt,
            n_valid=None if nv is None else torch.from_numpy(nv))
        assert torch.equal(sse, got)


def test_css_pallas_interpret_matches_plain():
    # the archived Pallas _css_kernel: its cost mode against css_cost_plain
    # and its gradient mode against the ported normal equations
    pallas = _load_arma_pallas()
    rng = np.random.default_rng(6)
    S, n, p, q, icpt = 200, 50, 2, 2, 1
    y = _panel(rng, S, n).astype(np.float32)
    params = (0.1 * rng.normal(size=(S, 5))).astype(np.float32)
    cost = pallas.css_cost(jnp.asarray(params), jnp.asarray(y), p, q, icpt,
                           interpret=True)
    jtj, jtr, cost_g = pallas.css_normal_equations(
        jnp.asarray(params), jnp.asarray(y), p, q, icpt, interpret=True)
    tp, ty = torch.from_numpy(params), torch.from_numpy(y)
    got = arma_ne.css_cost_plain(tp, ty, p, q, icpt)
    got_ne = arma_ne.normal_equations_plain(tp, ty, p, q, icpt)
    # float32 sums over 48 steps in two summation orders
    np.testing.assert_allclose(got.numpy(), np.asarray(cost), rtol=1e-5)
    for g, w in zip(got_ne, (jtj, jtr, cost_g)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4,
                                   atol=1e-3)


def test_log_likelihood_css_routes_through_css_cost(monkeypatch):
    rng = np.random.default_rng(7)
    y = np.cumsum(_panel(rng, 6, 50), axis=1)
    calls = []
    real = arma_ne.css_cost_plain

    def counted(*args, **kw):
        calls.append(args[2:5])
        return real(*args, **kw)
    monkeypatch.setattr(arma_ne, "css_cost_plain", counted)
    coefs = 0.1 * rng.normal(size=(6, 5))
    model = ARIMAModel(2, 1, 2, torch.from_numpy(coefs))
    got = model.log_likelihood_css(torch.from_numpy(y))
    want = jax.vmap(lambda c, s: jarima.ARIMAModel(2, 1, 2, c)
                    .log_likelihood_css(s))(jnp.asarray(coefs),
                                            jnp.asarray(y))
    assert calls == [(2, 2, 1)]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-11)
