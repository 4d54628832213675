"""The port's Holt-Winters slice against the JAX package, on the CPU.

``ops.hw_sse.value_and_grad_plain`` (what a CPU tensor runs, and what the
CUDA kernel ``csrc/hw_sse.cu`` is held against on a card) is compared with
the vmapped JAX pass ``_hw_sse_value_and_grad`` at float64 and with the
archived Pallas kernel in interpret mode at float32; ``minimize_box``
and the plain box fit against their JAX twins.  The fits, the model
surface, the engine family and R's ``stats::HoltWinters`` oracles are in
``test_torch_holt_winters_fit.py``.
"""

import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spark_timeseries_tpu.models import holt_winters as jhw
from spark_timeseries_tpu.ops import pallas_arma
from spark_timeseries_tpu.ops.optimize import minimize_box as jminimize_box
from spark_timeseries_tpu_torch.ops import hw_sse
from spark_timeseries_tpu_torch.ops.optimize import minimize_box

torch.set_num_threads(1)


def _panel(rng, S, n, m):
    """The bench recipe ``100 + 0.5 t + 10 sin(2πt/m) + N(0, 2²)``."""
    t = np.arange(n)
    return 100.0 + 0.5 * t + 10.0 * np.sin(2 * np.pi * t / m) \
        + rng.normal(0.0, 2.0, size=(S, n))


def _ragged(rng, y, m):
    """Left-aligned, zero-tailed lanes and their valid lengths (>= 2m+1)."""
    S, n = y.shape
    nv = rng.integers(2 * m + 1, n + 1, size=S)
    return np.where(np.arange(n)[None, :] < nv[:, None], y, 0.0), nv


def _jax_pass(params, y, m, model_type, nv=None):
    def one(p, s, *v):
        return jhw._hw_sse_value_and_grad(p, s, m, model_type,
                                          n_valid=v[0] if v else None)
    extra = () if nv is None else (jnp.asarray(nv),)
    return jax.vmap(one)(jnp.asarray(params), jnp.asarray(y), *extra)


def _grad_err(g, ref, sse):
    """Gradient error per entry, relative to the larger of the lane's
    largest entry and its SSE (the gradient's natural scale over the unit
    box, where the gradient happens to be small)."""
    scale = np.maximum(np.abs(ref).max(axis=1), np.abs(sse))[:, None]
    return (np.abs(g - ref) / scale).max()


@pytest.mark.parametrize("model_type,m", [("additive", 4),
                                          ("multiplicative", 5)])
@pytest.mark.parametrize("ragged", [False, True])
def test_plain_matches_jax_pass(model_type, m, ragged):
    rng = np.random.default_rng(0)
    y = _panel(rng, 48, 40, m)
    nv = None
    if ragged:
        y, nv = _ragged(rng, y, m)
    params = rng.uniform(0.05, 0.95, size=(48, 3))
    f, g = hw_sse.value_and_grad_plain(
        torch.from_numpy(params), torch.from_numpy(y), m, model_type,
        n_valid=None if nv is None else torch.from_numpy(nv))
    jf, jg = _jax_pass(params, y, m, model_type, nv)
    # float64 both sides; the tangent rows add their unit-vector term in
    # another order than the JAX pass
    np.testing.assert_allclose(f.numpy(), np.asarray(jf), rtol=1e-12)
    assert _grad_err(g.numpy(), np.asarray(jg), np.asarray(jf)) < 1e-12


def test_plain_takes_a_trial_dimension():
    rng = np.random.default_rng(1)
    y, nv = _ragged(rng, _panel(rng, 16, 30, 4), 4)
    inp = hw_sse.prepare(torch.from_numpy(y), 4, "multiplicative",
                         torch.from_numpy(nv))
    x = torch.from_numpy(rng.uniform(0.05, 0.95, size=(3, 16, 3)))
    fs, gs = hw_sse.evaluator(inp)(x)
    for k in range(3):
        f, g = hw_sse.evaluator(inp)(x[k])
        # the same elementwise arithmetic, broadcast over the trial dim
        assert torch.equal(fs[k], f) and torch.equal(gs[k], g)


def _load_hw_pallas():
    path = Path(__file__).resolve().parents[1] / "docs" / "experiments" \
        / "hw_pallas.py"
    spec = importlib.util.spec_from_file_location("_hw_pallas", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("model_type", ["additive", "multiplicative"])
def test_plain_f32_matches_pallas_interpret(model_type):
    # n - m = 37 steps: two 16-step chunks and the kernel's static tail
    rng = np.random.default_rng(2)
    S, n, m = 64, 41, 4
    y = _panel(rng, S, n, m).astype(np.float32)
    params = rng.uniform(0.05, 0.95, size=(S, 3)).astype(np.float32)
    additive = model_type == "additive"
    level0, trend0, season0 = jhw.HoltWintersModel(
        model_type, m, 0.0, 0.0, 0.0)._init_components(jnp.asarray(y))
    init = jnp.concatenate([level0[:, None], trend0[:, None], season0],
                           axis=-1).astype(jnp.float32)
    rows = pallas_arma._block_rows(S)
    y_b, n_blocks = pallas_arma._blocked(jnp.asarray(y[:, m:]), S, rows)
    init_b, _ = pallas_arma._blocked(init, S, rows)
    jf, jg = _load_hw_pallas().sse_value_and_grad(
        jnp.asarray(params), y_b, init_b, S, rows, n_blocks, m, additive,
        n - m, interpret=True)
    f, g = hw_sse.value_and_grad_plain(torch.from_numpy(params),
                                       torch.from_numpy(y), m, model_type)
    # float32 recurrences over 37 steps from initial components that the
    # two packages compute in float32 in other summation orders
    np.testing.assert_allclose(f.numpy(), np.asarray(jf), rtol=1e-4)
    assert _grad_err(g.numpy(), np.asarray(jg), np.asarray(jf)) < 1e-3


@pytest.mark.parametrize("trials_per_call", [1, 8])
def test_minimize_box_matches_jax(trials_per_call):
    rng = np.random.default_rng(3)
    S, n, m = 12, 32, 4
    y = _panel(rng, S, n, m)
    x0 = np.tile([0.3, 0.1, 0.1], (S, 1))
    # an out-of-box start: projected before the first evaluation
    x0[0] = [1.4, -0.2, 0.5]

    def vag(p, s):
        return jhw._hw_sse_value_and_grad(p, s, m, "additive")

    want = jminimize_box(lambda p, s: vag(p, s)[0], jnp.asarray(x0), 0.0,
                         1.0, jnp.asarray(y), tol=1e-10, max_iter=80,
                         value_and_grad_fn=vag)
    inp = hw_sse.prepare(torch.from_numpy(y), m, "additive")
    stats = {}
    got = minimize_box(hw_sse.evaluator(inp), torch.from_numpy(x0), 0.0,
                       1.0, tol=1e-10, max_iter=80,
                       trials_per_call=trials_per_call, stats=stats)
    # the same per-lane state machine on passes that agree to 1e-15
    np.testing.assert_array_equal(got.n_iter.numpy(),
                                  np.asarray(want.n_iter))
    np.testing.assert_array_equal(got.converged.numpy(),
                                  np.asarray(want.converged))
    np.testing.assert_allclose(got.x.numpy(), np.asarray(want.x),
                               rtol=1e-9, atol=1e-9)
    np.testing.assert_allclose(got.fun.numpy(), np.asarray(want.fun),
                               rtol=1e-9)
    assert stats["iterations"] == int(np.asarray(want.n_iter).max())
    assert stats["calls"] >= 1 + stats["iterations"]
    # restarts re-solve gathered lanes: without their evaluator it raises
    with pytest.raises(ValueError, match="evaluator_for"):
        minimize_box(hw_sse.evaluator(inp), torch.from_numpy(x0), 0.0, 1.0,
                     restarts=2)


def _lanes(inp, idx):
    """Lanes ``idx`` of a prepared panel."""
    return inp._replace(
        y=inp.y[:, idx].contiguous(), init=inp.init[:, idx].contiguous(),
        n_valid=None if inp.n_valid is None
        else inp.n_valid[idx].contiguous())


@pytest.mark.parametrize("ragged", [False, True])
def test_box_fit_plain_matches_jax(ragged):
    rng = np.random.default_rng(9)
    S, n, m = 16, 36, 4
    model_type = "multiplicative" if ragged else "additive"
    y = _panel(rng, S, n, m)
    nv = None
    if ragged:
        y, nv = _ragged(rng, y, m)
    x0 = np.tile([0.3, 0.1, 0.1], (S, 1))
    x0[1] = [0.9, 1.3, -0.1]               # out of the box: projected first

    def vag(p, s, *v):
        return jhw._hw_sse_value_and_grad(p, s, m, model_type,
                                          n_valid=v[0] if v else None)

    args = (jnp.asarray(y),) + (() if nv is None else (jnp.asarray(nv),))
    want = jminimize_box(lambda p, *a: vag(p, *a)[0], jnp.asarray(x0), 0.0,
                         1.0, *args, tol=1e-10, max_iter=120,
                         value_and_grad_fn=vag)
    inp = hw_sse.prepare(torch.from_numpy(y), m, model_type,
                         None if nv is None else torch.from_numpy(nv))
    stats = {}
    got, evaluations = hw_sse.box_fit_plain(inp, torch.from_numpy(x0),
                                            tol=1e-10, max_iter=120,
                                            stats=stats)
    # the JAX state machine per lane, on float64 passes that agree to 1e-12
    np.testing.assert_array_equal(got.n_iter.numpy(),
                                  np.asarray(want.n_iter))
    np.testing.assert_array_equal(got.converged.numpy(),
                                  np.asarray(want.converged))
    np.testing.assert_allclose(got.x.numpy(), np.asarray(want.x), rtol=0,
                               atol=1e-8)
    np.testing.assert_allclose(got.fun.numpy(), np.asarray(want.fun),
                               rtol=1e-9)
    assert torch.equal(stats["evaluations"], evaluations)
    # an evaluation for the start, then from one to K = 40 trials a call
    assert (evaluations >= 1 + got.n_iter).all()
    assert (evaluations <= 1 + 40 * (stats["calls"] - 1)).all()


def test_box_fit_lanes_are_independent():
    # the property the card's per-lane kernel rests on: a lane's result
    # depends on that lane alone, not on its batch or its place in it
    rng = np.random.default_rng(10)
    S, n, m = 12, 30, 4
    y, nv = _ragged(rng, _panel(rng, S, n, m), m)
    y[:3] += rng.normal(0.0, 15.0, size=(3, n))      # hard, long fits
    inp = hw_sse.prepare(torch.from_numpy(y), m, "multiplicative",
                         torch.from_numpy(nv))
    x0 = torch.from_numpy(rng.uniform(0.0, 1.0, size=(S, 3)))
    kw = dict(tol=1e-10, max_iter=60)
    batch, b_evals = hw_sse.box_fit_plain(inp, x0, **kw)
    assert len(set(batch.n_iter.tolist())) > 2      # lanes of unlike length
    perm = torch.from_numpy(rng.permutation(S))
    permuted, p_evals = hw_sse.box_fit_plain(_lanes(inp, perm), x0[perm],
                                             **kw)
    for got, want in zip((*permuted[:4], p_evals), (*batch[:4], b_evals)):
        assert torch.equal(got, want[perm])
    assert permuted.attempts is None and batch.attempts is None
    for lane in (0, 5):
        alone, a_evals = hw_sse.box_fit_plain(_lanes(inp, [lane]),
                                              x0[lane:lane + 1], **kw)
        for got, want in zip((*alone[:4], a_evals), (*batch[:4], b_evals)):
            assert torch.equal(got[0], want[lane])


def test_box_fit_counts_each_lanes_evaluations():
    # a lane's evaluations in a batch (several trials per call) are the
    # value-and-grad calls the solver makes when it fits that lane alone,
    # one trial per call
    rng = np.random.default_rng(11)
    S, n, m = 8, 24, 4
    y = _panel(rng, S, n, m)
    y[0] += rng.normal(0.0, 10.0, size=n)
    inp = hw_sse.prepare(torch.from_numpy(y), m, "additive")
    x0 = torch.full((S, 3), 0.2, dtype=torch.float64)
    _, evaluations = hw_sse.box_fit_plain(inp, x0, max_iter=40)
    for lane in (0, 3):
        stats = {}
        minimize_box(hw_sse.evaluator(_lanes(inp, [lane]),
                                      hw_sse._packed_plain),
                     x0[lane:lane + 1], 0.0, 1.0, tol=1e-10, max_iter=40,
                     trials_per_call=1, stats=stats)
        assert int(evaluations[lane]) == stats["calls"]
        assert torch.equal(stats["evaluations"],
                           torch.tensor([stats["calls"]], dtype=torch.int32))

