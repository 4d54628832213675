"""The port's multi-start restart loop (``ops.optimize.
solve_with_restarts``, under ``minimize_least_squares``, ``minimize_box``
and ``arima.fit(retry=...)``) against the JAX package's ``_with_restarts``,
on the CPU in float64.

The JAX package draws its restart jitter from per-lane threefry keys
(``ops.optimize._lane_keys`` + ``fold_in``), which torch cannot make; the
tests compute those draws with JAX and hand them to the port
(``jitter_draws``), so that both restart from the same points.  Given the
same draws the two run the same per-lane state machines: attempts,
convergence and iteration counts equal, parameters to rounding."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spark_timeseries_tpu.models import arima as j_arima
from spark_timeseries_tpu.ops import optimize as j_opt
from spark_timeseries_tpu.utils import resilience as j_res
from spark_timeseries_tpu_torch.models import arima
from spark_timeseries_tpu_torch.ops import optimize
from spark_timeseries_tpu_torch.utils import resilience

torch.set_num_threads(1)


def jax_draws(seed, S, k, restarts):
    """The JAX restart loop's draws ``(restarts, S, k)``: lane ``s``'s
    key split from ``PRNGKey(seed)``, folded with the attempt."""
    keys = jax.random.split(jax.random.PRNGKey(seed), S)
    return np.stack([
        np.asarray(jax.vmap(lambda kk, a=a: jax.random.normal(
            jax.random.fold_in(kk, a), (k,), jnp.float64))(keys))
        for a in range(1, restarts + 1)])


def _arima_rows(rng, S, n):
    e = rng.normal(size=(S, n + 16))
    y = np.zeros_like(e)
    for t in range(2, e.shape[1]):
        y[:, t] = 1.0 + 0.25 * y[:, t - 1] + 0.35 * y[:, t - 2] + e[:, t] \
            + 0.3 * e[:, t - 1] + 0.1 * e[:, t - 2]
    return np.cumsum(y[:, 16:], axis=1)


def _rosen_residual(x, a):
    return torch.stack([10.0 * (x[1] - x[0] * x[0]), a - x[0]])


def _j_rosen_residual(x, a):
    return jnp.stack([10.0 * (x[1] - x[0] * x[0]), a - x[0]])


def test_minimize_least_squares_restarts_match_jax():
    rng = np.random.default_rng(3)
    S = 24
    x0 = rng.normal(scale=2.0, size=(S, 2))
    a = rng.uniform(0.5, 2.0, size=S)
    draws = jax_draws(5, S, 2, 2)
    want = j_opt.minimize_least_squares(
        _j_rosen_residual, jnp.asarray(x0), jnp.asarray(a), max_iter=8,
        restarts=2, restart_key=jax.random.PRNGKey(5))
    stats = {}
    got = optimize.minimize_least_squares(
        _rosen_residual, torch.from_numpy(x0), torch.from_numpy(a),
        max_iter=8, restarts=2, jitter_draws=torch.from_numpy(draws),
        stats=stats)
    att = np.asarray(want.attempts)
    # an 8-iteration budget leaves lanes to every attempt count
    assert set(att.tolist()) == {1, 2, 3}
    np.testing.assert_array_equal(got.attempts.numpy(), att)
    np.testing.assert_array_equal(got.converged.numpy(),
                                  np.asarray(want.converged))
    np.testing.assert_array_equal(got.n_iter.numpy(),
                                  np.asarray(want.n_iter))
    np.testing.assert_allclose(got.x.numpy(), np.asarray(want.x), rtol=1e-12,
                               atol=1e-12)
    # the converged lanes' residuals vanish (fun 1e-30 to 1e-8), where
    # the last bits of x set fun's leading digits: an absolute floor
    np.testing.assert_allclose(got.fun.numpy(), np.asarray(want.fun),
                               rtol=1e-12, atol=1e-15)
    # attempt a re-solves only the lanes still failing
    assert stats["solves"] == 3
    assert stats["restart_lanes"] == [int((att >= 2).sum()),
                                      int((att >= 3).sum())]
    plain = optimize.minimize_least_squares(
        _rosen_residual, torch.from_numpy(x0), torch.from_numpy(a),
        max_iter=8)
    assert plain.attempts is None
    first = att == 1
    np.testing.assert_array_equal(plain.x.numpy()[first],
                                  got.x.numpy()[first])


def test_restart_loop_keeps_the_best_finite_attempt_and_x0():
    """A lane whose every attempt is non-finite holds x0 with fun inf; a
    lane that never converges keeps its lowest finite attempt."""
    x0 = torch.tensor([[1.0], [2.0], [3.0]], dtype=torch.float64)
    draws = torch.tensor([[[0.5], [0.5], [0.5]], [[-0.5], [-0.5], [-0.5]]],
                         dtype=torch.float64)
    calls = []

    def solve(xs, lanes):
        calls.append(None if lanes is None else lanes.tolist())
        idx = torch.arange(3) if lanes is None else lanes
        fun = torch.where(idx == 0, torch.tensor(float("nan"),
                                                 dtype=torch.float64),
                          xs[:, 0] ** 2)
        conv = idx == 2
        return xs * 1.0, fun, conv & (len(calls) > 1), \
            torch.full((len(idx),), len(calls), dtype=torch.int32)

    res = optimize.solve_with_restarts(solve, x0, 2, 1.0,
                                       jitter_draws=draws)
    assert calls == [None, [0, 1, 2], [0, 1]]
    assert res.attempts.tolist() == [3, 3, 2]
    assert res.converged.tolist() == [False, False, True]
    assert res.x[0, 0].item() == 1.0 and math.isinf(res.fun[0].item())
    # lane 1: 2.0, then 2 + 0.5·3, then 2 - 0.5·3: the last is best
    assert res.x[1, 0].item() == 0.5 and res.n_iter[1].item() == 3
    assert res.x[2, 0].item() == 5.0 and res.n_iter[2].item() == 2


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_restart_draws_do_not_depend_on_trailing_lanes(dtype):
    """A lane's draws are fixed by the seed and its index: every prefix
    of a panel, across draw blocks and at lane counts that are no
    multiple of anything, sees the same draws as the whole."""
    full = optimize.restart_draws(2, 2600, 5, dtype, "cpu", seed=4)
    assert full.shape == (2, 2600, 5) and full.dtype == dtype
    for s in (1, 7, 15, 17, 40, 131, 1023, 1025, 2049, 2599):
        part = optimize.restart_draws(2, s, 5, dtype, "cpu", seed=4)
        assert part.shape == (2, s, 5)
        assert torch.equal(part, full[:, :s]), s
    assert optimize.restart_draws(2, 0, 5, dtype, "cpu").shape == (2, 0, 5)
    # the seed, the attempt and each block draw apart
    other = optimize.restart_draws(2, 2600, 5, dtype, "cpu", seed=5)
    assert not torch.equal(full[:, :40], other[:, :40])
    assert not torch.equal(full[0], full[1])
    b = optimize.DRAW_BLOCK
    assert not torch.equal(full[:, :40], full[:, b:b + 40])


def test_force_nonconverge_retries_every_lane_like_jax():
    y = _arima_rows(np.random.default_rng(11), 16, 64)
    draws = jax_draws(0, 16, 5, 2)
    with j_res.fault_injection("force_nonconverge", n_attempts=1):
        want = j_arima.fit(2, 1, 2, jnp.asarray(y), warn=False, max_iter=20,
                           retry=j_res.RetryPolicy())
    with resilience.fault_injection("force_nonconverge", n_attempts=1):
        assert resilience.forced_optimizer_failures() == 1
        got = arima.fit(2, 1, 2, y, warn=False, device="cpu", max_iter=20,
                        retry=resilience.RetryPolicy(), _restart_draws=draws)
    assert resilience.forced_optimizer_failures() == 0
    att = got.diagnostics.attempts.numpy()
    assert (att >= 2).all()                 # attempt 0 failed everywhere
    np.testing.assert_array_equal(att, np.asarray(want.diagnostics.attempts))
    np.testing.assert_array_equal(got.diagnostics.converged.numpy(),
                                  np.asarray(want.diagnostics.converged))
    np.testing.assert_allclose(got.coefficients.numpy(),
                               np.asarray(want.coefficients), atol=1e-7)


def test_minimize_box_restarts_match_jax():
    """The box solver's multi-start path: the JAX package's draws handed
    in, each restart over the gathered failing lanes."""
    rng = np.random.default_rng(12)
    S = 16
    x0 = rng.uniform(-1.5, 1.5, size=(S, 2))
    a = rng.uniform(0.5, 1.5, size=S)

    def j_fn(x, aa):
        return (aa - x[0]) ** 2 + 5.0 * (x[1] - x[0] ** 2) ** 2

    def vag(x, aa):
        f = (aa - x[:, 0]) ** 2 + 5.0 * (x[:, 1] - x[:, 0] ** 2) ** 2
        g0 = -2.0 * (aa - x[:, 0]) - 20.0 * x[:, 0] * (x[:, 1] - x[:, 0] ** 2)
        g1 = 10.0 * (x[:, 1] - x[:, 0] ** 2)
        return f, torch.stack([g0, g1], dim=-1)

    draws = jax_draws(4, S, 2, 2)
    want = j_opt.minimize_box(j_fn, jnp.asarray(x0), -2.0, 2.0,
                              jnp.asarray(a), tol=1e-10, max_iter=15,
                              restarts=2, restart_key=jax.random.PRNGKey(4))
    at = torch.from_numpy(a)
    got = optimize.minimize_box(
        lambda x: vag(x, at), torch.from_numpy(x0), -2.0, 2.0, tol=1e-10,
        max_iter=15, restarts=2, jitter_draws=torch.from_numpy(draws),
        evaluator_for=lambda idx: (lambda x: vag(x, at.index_select(0,
                                                                    idx))))
    att = np.asarray(want.attempts)
    assert att.max() > 1
    np.testing.assert_array_equal(got.attempts.numpy(), att)
    np.testing.assert_array_equal(got.converged.numpy(),
                                  np.asarray(want.converged))
    np.testing.assert_array_equal(got.n_iter.numpy(),
                                  np.asarray(want.n_iter))
    np.testing.assert_allclose(got.x.numpy(), np.asarray(want.x), rtol=1e-9,
                               atol=1e-12)
