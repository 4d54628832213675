"""The port's in-memory long-series ARIMA (``models.arima.fit_long``,
``segment_fit_outputs``) against the JAX package's, on the CPU in
float64, and the forward second-order recursion of its segment Hessians
(``ARIMAModel.coefficient_precision``, ``arima._css_hessian``) against
the JAX package's autodiff Hessian of the same likelihood.

Tolerances: ``fit_long`` coefficients within 1e-8 (both sides run the
same float64 LM to its 1e-10 relative stopping rule, then weight by the
same exact Hessian; sums in other orders); the Hessian recursion within
1e-10 of each lane's largest entry (the same derivatives summed along
log-depth scans instead of the step loop: rounding only)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spark_timeseries_tpu.models import arima as jarima
from spark_timeseries_tpu_torch.models import arima

pytestmark = pytest.mark.long


def _long_arma(n, batch, seed=0, phi=(0.5, -0.2), theta=(0.4,), c=0.3):
    rng = np.random.default_rng(seed)
    eps = rng.normal(size=(batch, n + 2))
    y = np.zeros((batch, n))
    for t in range(2, n):
        y[:, t] = (c + phi[0] * y[:, t - 1] + phi[1] * y[:, t - 2]
                   + eps[:, t + 2] + theta[0] * eps[:, t + 1])
    return y


PANEL = np.cumsum(_long_arma(2048, 2, seed=3), axis=1)     # I(1), 2 x 2048


@pytest.fixture(scope="module")
def jax_fit():
    """The JAX package's ``fit_long`` as one compiled program (as
    ``bench_suite.py`` runs it): its eager call compiles each operation
    of the segment fit and the autodiff Hessian on its own."""
    def run(v):
        m = jarima.fit_long(1, 1, 1, v, segment_len=512, warn=False)
        return (m.coefficients, m.diagnostics.converged,
                m.diagnostics.n_iter, m.diagnostics.fun)

    return tuple(np.asarray(x) for x in jax.jit(run)(jnp.asarray(PANEL)))


def test_fit_long_matches_jax(jax_fit):
    st = {}
    m = arima.fit_long(1, 1, 1, PANEL, segment_len=512, warn=False,
                       device="cpu", stats=st)
    coefs, conv, n_iter, fun = jax_fit
    assert (m.p, m.d, m.q) == (1, 1, 1)
    np.testing.assert_allclose(m.coefficients.numpy(), coefs, rtol=0,
                               atol=1e-8)
    np.testing.assert_array_equal(m.diagnostics.converged.numpy(), conv)
    np.testing.assert_array_equal(m.diagnostics.n_iter.numpy(), n_iter)
    np.testing.assert_allclose(m.diagnostics.fun.numpy(), fun, rtol=1e-9)
    assert st["lm_fit_launches"] == 0 and st["precision_s"] >= 0.0


def test_single_series_is_its_row_of_the_batch():
    m2 = arima.fit_long(2, 1, 1, PANEL, segment_len=512, warn=False,
                        device="cpu")
    m1 = arima.fit_long(2, 1, 1, torch.from_numpy(PANEL[1]),
                        segment_len=512, warn=False, device="cpu")
    assert m1.coefficients.shape == (4,)
    np.testing.assert_allclose(m1.coefficients.numpy(),
                               m2.coefficients[1].numpy(), rtol=0,
                               atol=1e-12)
    assert bool(m1.diagnostics.converged) \
        == bool(m2.diagnostics.converged[1])


def test_segment_fit_outputs_matches_jax():
    # fit_long's own segments of PANEL: 3 of 512 a series
    segs = np.diff(PANEL, axis=1)[:, -1536:].reshape(6, 512)
    coefs, conv = arima.segment_fit_outputs(1, 1, torch.from_numpy(segs),
                                            device="cpu")
    # the fused path's fit, under the jit it is written for
    want_c, want_v = jax.jit(lambda v: jarima.segment_fit_outputs(
        1, 1, v))(jnp.asarray(segs))
    assert coefs.shape == (6, 3) and conv.shape == (6,)
    np.testing.assert_allclose(coefs.numpy(), np.asarray(want_c), rtol=0,
                               atol=1e-8)
    np.testing.assert_array_equal(conv.numpy(), np.asarray(want_v))
    # the fit it stands for, with the CPU's launch count
    st = {}
    m = arima.fit(1, 0, 1, torch.from_numpy(segs), warn=False,
                  device="cpu", stats=st)
    np.testing.assert_array_equal(coefs.numpy(), m.coefficients.numpy())
    assert st["lm_fit_launches"] == 0


@pytest.mark.parametrize("p,q,icpt", [(2, 2, 1), (1, 1, 1), (1, 0, 1),
                                      (0, 1, 0), (3, 3, 1), (2, 1, 0)])
def test_css_hessian_matches_autograd(p, q, icpt):
    rng = np.random.default_rng(10 * p + q)
    y = torch.from_numpy(np.diff(_long_arma(301, 5, seed=p + q), axis=1))
    params = torch.from_numpy(0.2 * rng.normal(size=(5, icpt + p + q)))
    m = arima.ARIMAModel(p, 0, q, params, bool(icpt))
    got = m.coefficient_precision(y, assume_differenced=True)
    jm = jarima.ARIMAModel(p, 0, q, jnp.asarray(params.numpy()),
                           bool(icpt))
    want = torch.from_numpy(np.array(jax.jit(
        lambda v: jm.coefficient_precision(v, assume_differenced=True))(
            jnp.asarray(y.numpy()))))
    assert got.shape == want.shape == (5, icpt + p + q, icpt + p + q)
    scale = want.abs().amax(dim=(-2, -1), keepdim=True)
    assert float(((got - want).abs() / scale).max()) < 1e-10
    np.testing.assert_array_equal(
        got.numpy(), arima._css_hessian(params, y, p, q, icpt).numpy())


def test_fit_long_downweights_poisoned_and_falls_back_finite():
    """A NaN segment quarantines to weight 0: the combination is the one
    of the other segments alone, bit for bit; with every segment dead,
    finite coefficients and ``converged`` False (the JAX package's
    rules)."""
    y = _long_arma(1536, 1, seed=6)[0]
    bad = y.copy()
    bad[:512] = np.nan                  # the oldest segment unusable
    with pytest.warns(UserWarning, match="shorter than"):
        m = arima.fit_long(2, 0, 1, bad, segment_len=512, warn=False,
                           device="cpu")
    clean = arima.fit_long(2, 0, 1, y[512:], segment_len=512,
                           warn=False, device="cpu")
    np.testing.assert_array_equal(m.coefficients.numpy(),
                                  clean.coefficients.numpy())
    assert bool(m.diagnostics.converged)
    with pytest.warns(UserWarning, match="shorter than"):
        dead = arima.fit_long(2, 0, 1, np.full(2048, np.nan),
                              segment_len=512, warn=False, device="cpu")
    assert not bool(dead.diagnostics.converged)
    assert torch.isfinite(dead.coefficients).all()


def test_fit_long_rejects_short_series():
    y = _long_arma(1024, 1)[0]
    with pytest.raises(ValueError, match="too short") as got:
        arima.fit_long(1, 0, 1, y, segment_len=1024, device="cpu")
    with pytest.raises(ValueError) as want:
        jarima.fit_long(1, 0, 1, y, segment_len=1024)
    assert str(got.value) == str(want.value)
