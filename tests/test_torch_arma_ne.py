"""The port's one-pass ARMA normal equations against the JAX package.

``normal_equations_plain`` (the CUDA kernel's plain twin, what a CPU
tensor runs) is held against ``arima._arma_normal_eqs`` at float64 and
against the Pallas kernel in interpret mode at float32, and the wrapper's
routing on the CPU.  The LM fit's cases are in ``test_torch_arma_lm.py``
and the cost-only pass's in ``test_torch_arma_css.py``; the CUDA kernels
themselves run only on a card (``tests/test_torch_cuda.py``).
"""


import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spark_timeseries_tpu.models import arima as jarima
from spark_timeseries_tpu.ops import pallas_arma
from spark_timeseries_tpu_torch.ops import arma_ne

torch.set_num_threads(1)


def _panel(rng, S, n, phi=(0.25, 0.35), theta=(0.3, 0.1)):
    e = rng.normal(size=(S, n + 16))
    y = np.zeros_like(e)
    for t in range(2, e.shape[1]):
        y[:, t] = 1.0 + phi[0] * y[:, t - 1] + phi[1] * y[:, t - 2] \
            + e[:, t] + theta[0] * e[:, t - 1] + theta[1] * e[:, t - 2]
    return y[:, 16:]


def _xla_ne(params, y, p, q, icpt, mask=None, nv=None):
    def one(prm, yy, *extra):
        m = extra[0] if mask is not None else None
        v = extra[-1] if nv is not None else None
        return jarima._arma_normal_eqs(prm, yy, p, q, icpt, mask=m,
                                       n_valid=v)
    extra = ([] if mask is None else [jnp.asarray(mask)]) \
        + ([] if nv is None else [jnp.asarray(nv)])
    return jax.vmap(one)(jnp.asarray(params), jnp.asarray(y), *extra)


@pytest.mark.parametrize("mode", ["dense", "masked", "ragged"])
@pytest.mark.parametrize("p,q,icpt", [(2, 2, 1), (0, 2, 1), (2, 0, 1),
                                      (3, 2, 0)])
def test_plain_matches_xla_normal_eqs(p, q, icpt, mode):
    rng = np.random.default_rng(0)
    S, n = 40, 64
    y = _panel(rng, S, n)
    k = icpt + p + q
    params = 0.1 * rng.normal(size=(S, k))
    mask = nv = None
    if mode == "masked":
        mask = (rng.uniform(size=(S, k)) > 0.3).astype(np.float64)
    if mode == "ragged":
        nv = rng.integers(20, n + 1, size=S)
        y = np.where(np.arange(n)[None, :] < nv[:, None], y, 0.0)
    got = arma_ne.normal_equations_plain(
        torch.from_numpy(params), torch.from_numpy(y), p, q, icpt,
        mask=None if mask is None else torch.from_numpy(mask),
        n_valid=None if nv is None else torch.from_numpy(nv))
    want = _xla_ne(params, y, p, q, icpt, mask, nv)
    # float64 both sides, the same recurrence summed in another order
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-10,
                                   atol=1e-10)


@pytest.mark.parametrize("S,n,ragged", [(160, 96, False), (130, 57, True)])
def test_plain_f32_matches_pallas_interpret(S, n, ragged):
    # (130, 57): n_obs - max_lag is not a multiple of the Pallas kernel's
    # 16-step chunk, so its static tail path runs
    rng = np.random.default_rng(1)
    y = _panel(rng, S, n).astype(np.float32)
    params = (0.1 * rng.normal(size=(S, 5))).astype(np.float32)
    nv = rng.integers(20, n + 1, size=S) if ragged else None
    got = arma_ne.normal_equations_plain(
        torch.from_numpy(params), torch.from_numpy(y), 2, 2, 1,
        n_valid=None if nv is None else torch.from_numpy(nv))
    want = pallas_arma.normal_equations(
        jnp.asarray(params), jnp.asarray(y), 2, 2, 1,
        n_valid=None if nv is None else jnp.asarray(nv), interpret=True)
    # float32 sums over ~100 steps in two summation orders
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4,
                                   atol=1e-3)


# orders the LM-fit kernel instantiates beyond (2, 2) with intercept: the
# smallest, pure MA and pure AR of the largest order, the largest.  The
# (3, 3) draws have AR and MA roots far apart (no near-common factor), so
# the fit is identified and the float64 decisions stay away from the
# step-size exit, where the two solvers differ


def test_cpu_tensor_runs_the_plain_version():
    rng = np.random.default_rng(3)
    y = torch.from_numpy(_panel(rng, 12, 40))
    params = torch.from_numpy(0.1 * rng.normal(size=(12, 5)))
    before = arma_ne.normal_equations.launches
    got = arma_ne.normal_equations(params, y, 2, 2, 1)
    want = arma_ne.normal_equations_plain(params, y, 2, 2, 1)
    assert arma_ne.normal_equations.launches == before   # no kernel here
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    with pytest.raises(ValueError, match="too short"):
        arma_ne.normal_equations(params, y[:, :2], 2, 2, 1)


@pytest.mark.parametrize("cost", [False, True])
def test_series_major_launch_takes_the_operands_as_given(monkeypatch, cost):
    """The wrappers' launch of the series-major kernels: the caller's
    float32 tensors go to the kernel as they are (their own pointers: no
    transpose or copy), the outputs are what the wrapper returns, shaped
    and contiguous, and each launch adds one to the count and to the
    widths histogram at its power-of-two bucket.  (The launch itself is
    recorded, not run: the kernels run only on a card.)"""
    calls = []
    monkeypatch.setattr(arma_ne, "_rows_fns",
                        lambda: ("tile", "ne", "css"))
    monkeypatch.setattr(arma_ne._build, "launch",
                        lambda fn, dev, *args, what: calls.append(
                            (fn, args)))
    rng = np.random.default_rng(5)
    p, q, icpt = 2, 1, 1
    k = icpt + p + q
    wrapper = arma_ne.css_cost if cost else arma_ne.normal_equations
    monkeypatch.setattr(wrapper, "launches", 0)
    monkeypatch.setattr(wrapper, "widths", {})
    for S in (1, 33, 33, 4097):
        y = torch.from_numpy(_panel(rng, S, 40).astype(np.float32))
        prm = torch.from_numpy(
            (0.1 * rng.normal(size=(S, k))).astype(np.float32))
        nv = torch.full((S,), 30.0)
        mask = torch.ones((S, k))
        if cost:
            out = arma_ne._css_rows(prm, y, nv, p, q, icpt)
            assert out.shape == (S,) and out.is_contiguous()
            fn, args = calls[-1]
            assert fn == "css"
            outs = (out,)
        else:
            out = arma_ne._ne_rows(prm, y, nv, mask, p, q, icpt)
            assert [tuple(t.shape) for t in out] == [(S, k, k), (S, k),
                                                     (S,)]
            assert all(t.is_contiguous() and t.dtype == torch.float32
                       for t in out)
            fn, args = calls[-1]
            assert fn == "ne" and args[3] == mask.data_ptr()
            outs = out
        n_in = 3 if cost else 4
        assert args[:3] == (prm.data_ptr(), y.data_ptr(), nv.data_ptr())
        assert args[n_in:n_in + len(outs)] \
            == tuple(t.data_ptr() for t in outs)
        assert args[n_in + len(outs):] == (S, 40, p, q, icpt, 0)
    assert wrapper.launches == 4
    assert wrapper.widths == {1: 1, 64: 2, 8192: 1}
    assert [arma_ne.width_bucket(S) for S in (1, 2, 3, 4096, 4097)] \
        == [1, 2, 4, 4096, 8192]
    # what the kernels do not take raises before any launch
    with pytest.raises(ValueError, match="contiguous"):
        (arma_ne._css_rows if cost else arma_ne._ne_rows)(
            *((prm.T.contiguous().T, y, None) + (() if cost else (None,))),
            p, q, icpt)
    with pytest.raises(ValueError, match="float32"):
        (arma_ne._css_rows if cost else arma_ne._ne_rows)(
            *((prm.double(), y.double(), None)
              + (() if cost else (None,))), p, q, icpt)
    assert wrapper.launches == 4


def test_time_major_comparisons_run_on_a_card_only():
    y = torch.zeros((4, 20))
    prm = torch.zeros((4, 3))
    with pytest.raises(ValueError, match="CUDA"):
        arma_ne.normal_equations_time_major(prm, y, 1, 1, 1)
    with pytest.raises(ValueError, match="CUDA"):
        arma_ne.css_cost_time_major(prm, y, 1, 1, 1)


# (4, 2, 1) and (5, 3, 0): AR orders the cost-only kernel holds in
# registers beyond the normal equations' p <= 3; (7, 1, 1): past them, its
# runtime-p form
