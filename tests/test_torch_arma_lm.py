"""The port's LM fit of the ARMA normal equations against the JAX
package.

``fit_css_lm`` against the Pallas LM solver and the XLA LM route, over
every order the LM-fit kernel instantiates; ``fit_css_lm_plain`` (the
LM-fit kernel's plain twin) lane by lane, since the kernel runs each lane
alone; the route against the plain loop on the CPU; and the shape and
order checks.  The one-pass and cost-only cases are in
``test_torch_arma_ne.py`` and ``test_torch_arma_css.py``; the CUDA
kernels themselves run only on a card (``tests/test_torch_cuda.py``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spark_timeseries_tpu.models import arima as jarima
from spark_timeseries_tpu.ops import pallas_arma
from spark_timeseries_tpu.ops.optimize import minimize_least_squares
from spark_timeseries_tpu_torch.models.arima import (ARIMAModel,
                                                      hannan_rissanen_init)
from spark_timeseries_tpu_torch.ops import arma_ne

torch.set_num_threads(1)


def _panel(rng, S, n, phi=(0.25, 0.35), theta=(0.3, 0.1)):
    e = rng.normal(size=(S, n + 16))
    y = np.zeros_like(e)
    for t in range(2, e.shape[1]):
        y[:, t] = 1.0 + phi[0] * y[:, t - 1] + phi[1] * y[:, t - 2] \
            + e[:, t] + theta[0] * e[:, t - 1] + theta[1] * e[:, t - 2]
    return y[:, 16:]


def test_fit_css_lm_matches_pallas_solver_and_xla_route():
    rng = np.random.default_rng(2)
    S, n, p, q = 64, 96, 2, 2
    y = _panel(rng, S, n)
    init = np.asarray(jarima.hannan_rissanen_init(p, q, jnp.asarray(y),
                                                  True))

    # float32: the port's solver against the Pallas solver (interpret)
    x32, f32, done32, it32 = arma_ne.fit_css_lm(
        torch.from_numpy(init.astype(np.float32)),
        torch.from_numpy(y.astype(np.float32)), p, q, 1)
    x_pl, f_pl, done_pl, it_pl = pallas_arma.fit_css_lm(
        jnp.asarray(init, jnp.float32), jnp.asarray(y, jnp.float32), p, q,
        1, interpret=True)
    # the same state machine on float32 accumulators summed in another
    # order: rounding may flip an accept/reject on the flat CSS ridges, so
    # the contract is the JAX package's own between its two solvers
    conv = done32.numpy() & np.asarray(done_pl) \
        & np.isfinite(f32.numpy()) & np.isfinite(np.asarray(f_pl))
    assert conv.mean() > 0.8
    dx = np.abs(x32.numpy() - np.asarray(x_pl)).max(axis=1)[conv]
    assert np.median(dx) < 2e-3 and np.mean(dx < 5e-3) >= 0.9
    rel = np.abs(f32.numpy()[conv] - np.asarray(f_pl)[conv]) \
        / np.asarray(f_pl)[conv]
    assert np.mean(rel < 1e-3) >= 0.95

    # float64: against the XLA LM route arima.fit takes on the CPU
    _check_f64_lm_against_xla(init, y, p, q, 1)


def _check_f64_lm_against_xla(init, y, p, q, icpt):
    """The port's LM (on the CPU: the plain loop) against the JAX
    package's LM over ``_arma_normal_eqs``, both in float64."""
    x64, f64, done64, it64 = arma_ne.fit_css_lm(
        torch.from_numpy(init), torch.from_numpy(y), p, q, icpt, tol=1e-10)
    res = minimize_least_squares(
        None, jnp.asarray(init), jnp.asarray(y), max_iter=50,
        normal_eqs_fn=lambda prm, yy: jarima._arma_normal_eqs(
            prm, yy, p, q, icpt))
    # identical decisions at float64 (the solvers differ only in which x
    # the step-size exit is scaled by, a 1e-10-relative test)
    assert np.mean(done64.numpy() == np.asarray(res.converged)) >= 0.95
    assert np.mean(it64.numpy() == np.asarray(res.n_iter)) >= 0.95
    same = (done64.numpy() == np.asarray(res.converged)) \
        & (it64.numpy() == np.asarray(res.n_iter))
    np.testing.assert_allclose(x64.numpy()[same], np.asarray(res.x)[same],
                               rtol=1e-7, atol=1e-8)
    # the objective is compared where the MA part is invertible: a lane
    # that runs off to a non-invertible point reaches SSEs of 1e100+,
    # where a 1e-8 move of x changes the SSE by orders of magnitude
    sane = same & ARIMAModel(p, 0, q, x64, bool(icpt)).is_invertible()
    assert sane.mean() > 0.3
    np.testing.assert_allclose(f64.numpy()[sane], np.asarray(res.fun)[sane],
                               rtol=1e-9)


def _arma_panel(rng, S, n, phi, theta, c):
    """ARMA(len(phi), len(theta)) draws with intercept ``c``."""
    e = rng.normal(size=(S, n + 16))
    y = np.zeros_like(e)
    for t in range(3, e.shape[1]):
        y[:, t] = c + e[:, t]
        for j, ph in enumerate(phi):
            y[:, t] += ph * y[:, t - j - 1]
        for m, th in enumerate(theta):
            y[:, t] += th * e[:, t - m - 1]
    return y[:, 16:]


@pytest.mark.parametrize("p,q,icpt,phi,theta", [
    (1, 1, 0, (0.5,), (0.3,)),
    (0, 3, 1, (), (0.4, 0.2, 0.1)),
    (3, 0, 1, (0.3, 0.2, 0.1), ()),
    (3, 3, 1, (0.6, -0.4, 0.25), (-0.5, 0.35, 0.3))])
def test_fit_css_lm_matches_xla_lm_over_orders(p, q, icpt, phi, theta):
    rng = np.random.default_rng(9)
    y = _arma_panel(rng, 64, 96, phi, theta, float(icpt))
    init = np.asarray(jarima.hannan_rissanen_init(p, q, jnp.asarray(y),
                                                  bool(icpt)))
    _check_f64_lm_against_xla(init, y, p, q, icpt)


def _lm_case(mode, dtype):
    """A small panel in ``mode`` whose lanes stop at different iterations
    (starts ever further from the Hannan-Rissanen init; some reach the
    cap of 40): x0, y, mask, n_valid."""
    rng = np.random.default_rng(10)
    S, n = 8, 48
    y = _panel(rng, S, n)
    mask = nv = None
    if mode == "ragged":
        nv = rng.integers(20, n + 1, size=S)
        y = np.where(np.arange(n)[None, :] < nv[:, None], y, 0.0)
        nv = torch.from_numpy(nv)
    if mode == "masked":
        mask = torch.from_numpy(
            (rng.uniform(size=(S, 5)) > 0.3).astype(np.float64)).to(dtype)
    y = torch.from_numpy(y).to(dtype)
    x0 = hannan_rissanen_init(2, 2, y, True, n_valid=nv) + torch.from_numpy(
        rng.normal(size=(S, 5)) * np.linspace(0, 0.6, S)[:, None]).to(dtype)
    return x0, y, mask, nv


@pytest.mark.parametrize("mode", ["dense", "ragged", "masked"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_fit_css_lm_plain_lanes_are_independent(dtype, mode):
    # the LM-fit kernel runs each lane's fit alone, which computes the
    # batched loop's function only if a lane's result does not depend on
    # the others: it must not, bit for bit
    x0, y, mask, nv = _lm_case(mode, dtype)
    tol = 1e-10 if dtype == torch.float64 else 1e-6
    kw = dict(tol=tol, max_iter=40)
    full = arma_ne.fit_css_lm_plain(x0, y, 2, 2, 1, mask=mask, n_valid=nv,
                                    **kw)
    assert len(set(full[3].tolist())) > 3           # lanes part early
    for s in range(y.shape[0]):
        one = slice(s, s + 1)
        alone = arma_ne.fit_css_lm_plain(
            x0[one], y[one], 2, 2, 1, mask=None if mask is None
            else mask[one], n_valid=None if nv is None else nv[one], **kw)
        for got, want in zip(alone, full):
            assert torch.equal(got, want[one])


def test_fit_css_lm_route_equals_plain_on_cpu():
    x0, y, _, nv = _lm_case("ragged", torch.float32)
    before = (arma_ne.fit_css_lm.launches,
              arma_ne.normal_equations.launches)
    plain = arma_ne.fit_css_lm_plain(x0, y, 2, 2, 1, n_valid=nv)
    route = arma_ne.fit_css_lm_route(x0, y, 2, 2, 1, n_valid=nv)
    got = arma_ne.fit_css_lm(x0, y, 2, 2, 1, n_valid=nv)
    # no kernel here
    assert (arma_ne.fit_css_lm.launches,
            arma_ne.normal_equations.launches) == before
    for a, b, c in zip(route, got, plain):
        assert torch.equal(a, c) and torch.equal(b, c)
    with pytest.raises(ValueError, match="lanes"):
        arma_ne.fit_css_lm(x0[:3], y, 2, 2, 1)


@pytest.mark.parametrize("bad", ["x0 narrow", "x0 wide", "mask", "n_valid"])
def test_fit_css_lm_rejects_mismatched_shapes(bad):
    # the same checks guard the LM-fit kernel, which would read past a
    # buffer of the wrong shape
    x0, y, _, nv = _lm_case("ragged", torch.float32)
    kw = dict(n_valid=nv)
    if bad == "x0 narrow":
        x0 = x0[:, :4]
    if bad == "x0 wide":
        x0 = torch.cat([x0, x0[:, :1]], dim=1)
    if bad == "mask":
        kw["mask"] = torch.ones_like(x0[:, :4])
    if bad == "n_valid":
        kw["n_valid"] = nv[:5]
    for fit in (arma_ne.fit_css_lm, arma_ne.fit_css_lm_route):
        with pytest.raises(ValueError, match="shape mismatch"):
            fit(x0, y, 2, 2, 1, **kw)


def test_kernel_order_check():
    arma_ne.check_kernel_order(3, 3, 1)
    arma_ne.check_kernel_order(5, 5, 1)
    arma_ne.check_kernel_order(4, 5, 0)
    arma_ne.check_kernel_order(0, 0, 1)
    with pytest.raises(ValueError, match="p, q <= 5"):
        arma_ne.check_kernel_order(6, 1, 1)
    with pytest.raises(ValueError, match="p, q <= 5"):
        arma_ne.check_kernel_order(1, 6, 0)
    with pytest.raises(ValueError, match="at least one"):
        arma_ne.check_kernel_order(0, 0, 0)
