"""The port's log-depth scans (``ops.scan_parallel``) against the JAX
package's ``lax.associative_scan`` versions, on the CPU in float64.

The port doubles over the time axis where XLA runs its own associative
scan, so the combine order differs and the two agree to rounding: every
case holds them to 1e-12 relative (the products of up to n contraction
factors round differently, a few ulps a level).  The gradient through
``garch_variance`` (which the GARCH Newton fit's Hessian rides on) is
held against ``jax.grad`` of the same scalar.  Each JAX reference runs
as one compiled program (``jax.jit``) rather than an operation at a
time: the same arithmetic, compiled once instead of per operation."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spark_timeseries_tpu.ops import scan_parallel as jsp
from spark_timeseries_tpu_torch.ops import scan_parallel as sp

RTOL = 1e-12


def _jit(fn, *args, **kw):
    """The JAX package's ``fn(*args, **kw)`` as one compiled program
    (keywords and non-array arguments closed over)."""
    return jax.jit(lambda *a: fn(*a, **kw))(*args)


def _t(x):
    return torch.as_tensor(np.asarray(x, dtype=np.float64))


@pytest.mark.parametrize("n", [1, 2, 3, 7, 64, 129, 1024])
def test_linear_recurrence_matches_jax(n):
    rng = np.random.default_rng(n)
    a = rng.uniform(-0.95, 0.95, (5, n))
    b = rng.normal(size=(5, n))
    want = np.asarray(_jit(jsp.linear_recurrence, a, b))
    np.testing.assert_allclose(sp.linear_recurrence(_t(a), _t(b)).numpy(),
                               want, rtol=RTOL, atol=1e-14)


def test_linear_recurrence_other_axis_and_broadcast():
    rng = np.random.default_rng(1)
    a = rng.uniform(-0.9, 0.9, (33, 1))
    b = rng.normal(size=(33, 4))
    want = np.asarray(_jit(jsp.linear_recurrence, a, b, axis=0))
    np.testing.assert_allclose(
        sp.linear_recurrence(_t(a), _t(b), axis=0).numpy(), want,
        rtol=RTOL, atol=1e-14)


@pytest.mark.parametrize("seeded", [False, True])
def test_affine_recurrence_matches_jax(seeded):
    rng = np.random.default_rng(2)
    A = 0.45 * rng.normal(size=(40, 3, 2, 2))
    b = rng.normal(size=(40, 3, 2))
    x0 = rng.normal(size=(3, 2)) if seeded else None
    want = np.asarray(_jit(jsp.affine_recurrence, A, b, x0))
    got = sp.affine_recurrence(_t(A), _t(b),
                               None if x0 is None else _t(x0)).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=1e-13)


def test_ewma_smooth_and_ar1_filter_match_jax():
    rng = np.random.default_rng(3)
    x = rng.normal(size=(6, 200)).cumsum(axis=1)
    alpha = rng.uniform(0.05, 0.95, 6)
    np.testing.assert_allclose(
        sp.ewma_smooth(_t(x), _t(alpha)).numpy(),
        np.asarray(_jit(jsp.ewma_smooth, x, alpha)), rtol=RTOL)
    np.testing.assert_allclose(
        sp.ewma_smooth(_t(x), 0.3).numpy(),
        np.asarray(_jit(jsp.ewma_smooth, x, 0.3)), rtol=RTOL)
    c, phi = rng.normal(size=6), rng.uniform(-0.9, 0.9, 6)
    np.testing.assert_allclose(
        sp.ar1_filter(_t(x), _t(c), _t(phi)).numpy(),
        np.asarray(_jit(jsp.ar1_filter, x, c, phi)), rtol=RTOL,
        atol=1e-13)


@pytest.mark.parametrize("h0", [None, "per_lane"])
def test_garch_variance_matches_jax(h0):
    rng = np.random.default_rng(4)
    e = rng.standard_t(5, size=(6, 300)) * 0.4
    w, a, b = (rng.uniform(0.01, 0.1, 6), rng.uniform(0.03, 0.2, 6),
               rng.uniform(0.5, 0.78, 6))
    seed = rng.uniform(0.5, 2.0, 6) if h0 else None
    want = np.asarray(_jit(jsp.garch_variance, e, w, a, b, h0=seed))
    got = sp.garch_variance(_t(e), _t(w), _t(a), _t(b),
                            h0=None if seed is None else _t(seed))
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL)


def test_grad_through_garch_variance_matches_jax():
    rng = np.random.default_rng(5)
    e = rng.standard_t(5, size=(4, 256)) * 0.4
    prm = np.c_[rng.uniform(0.01, 0.1, 4), rng.uniform(0.03, 0.2, 4),
                rng.uniform(0.5, 0.78, 4)]

    def j_obj(p):
        h = jsp.garch_variance(e, p[:, 0], p[:, 1], p[:, 2])
        return jnp.sum(jnp.log(h) + e * e / h)

    want = np.asarray(jax.jit(jax.grad(j_obj))(jnp.asarray(prm)))
    p = _t(prm).requires_grad_(True)
    h = sp.garch_variance(_t(e), p[:, 0], p[:, 1], p[:, 2])
    got, = torch.autograd.grad((torch.log(h) + _t(e) ** 2 / h).sum(), p)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-10)
