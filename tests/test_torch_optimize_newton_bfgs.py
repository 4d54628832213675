"""The port's batched damped Newton and BFGS (``ops.optimize.
minimize_newton`` / ``minimize_bfgs``) against the JAX package's, on
smooth per-lane objectives, on the CPU in float64.

Both port solvers run every lane's state machine of the JAX single-lane
solver (BFGS: the algorithm of ``jax.scipy.optimize.minimize(method=
"BFGS")`` with its strong-Wolfe line search) over the whole batch.  The
port's line search leaves out two of jax's faults (a zoom on a reversed
bracket fails at once; a NaN trial value doubles the step), so the BFGS
is held to jax's with those two lines changed
(``torch_jax_line_search.without_line_search_faults``), and to jax's own
BFGS on the lanes where its line search did not fail.  The objectives'
arithmetic is the same, their derivatives are autodiff on both sides, so
parameters agree to 1e-8 and iteration counts on at least 0.9 of the
lanes.  A lane's count can differ where its exit is decided
by rounding: Newton's exits at the default float64 tolerance (1e-10)
compare objective drops of a few ulps at the optimum, so the iteration
counts are held at the GARCH fit's tolerance (1e-6), and only parameters
and convergence at the default.  Restarts run from the JAX package's own
draws (computed here and handed in)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spark_timeseries_tpu.ops import optimize as jopt
from spark_timeseries_tpu_torch.ops import optimize as opt
from torch_jax_line_search import without_line_search_faults

torch.set_num_threads(1)

S = 64


def _problem(seed=0):
    rng = np.random.default_rng(seed)
    a = rng.uniform(0.5, 2.0, S)
    b = rng.uniform(1.0, 20.0, S)
    x0 = 1.5 * rng.normal(size=(S, 3))
    return a, b, x0


def j_obj(x, a, b):
    return (a - x[0]) ** 2 + b * (x[1] - x[0] ** 2) ** 2 \
        + 0.5 * (x[2] - x[1]) ** 2 + 0.1 * x[2] ** 4


def t_obj(x, a, b):
    return (a - x[:, 0]) ** 2 + b * (x[:, 1] - x[:, 0] ** 2) ** 2 \
        + 0.5 * (x[:, 2] - x[:, 1]) ** 2 + 0.1 * x[:, 2] ** 4


def jax_draws(seed, n, k, restarts):
    """The JAX restart loop's draws ``(restarts, n, k)``."""
    keys = jax.random.split(jax.random.PRNGKey(seed), n)
    return np.stack([
        np.asarray(jax.vmap(lambda kk, a=a: jax.random.normal(
            jax.random.fold_in(kk, a), (k,), jnp.float64))(keys))
        for a in range(1, restarts + 1)])


# the restart tests' JAX keywords: 2 restarts from seed 7's key
_RESTART_KW = dict(max_iter=4, restarts=2,
                   restart_key=jax.random.PRNGKey(7))


def _t(*xs):
    return tuple(torch.as_tensor(x) for x in xs)


def _compare(got, want, x_tol=1e-8, iter_share=0.9):
    wx = np.asarray(want.x)
    np.testing.assert_array_equal(got.converged.numpy(),
                                  np.asarray(want.converged))
    close = np.abs(got.x.numpy() - wx).max(axis=-1) <= x_tol \
        * (1.0 + np.abs(wx).max(axis=-1))
    assert close.all(), np.flatnonzero(~close)
    same = got.n_iter.numpy() == np.asarray(want.n_iter)
    assert same.mean() >= iter_share, same.mean()
    return same


@pytest.fixture(scope="module")
def fixed_bfgs():
    """The JAX BFGS runs held with the port's line search, all in one
    ``without_line_search_faults`` block (which clears jax's compile
    caches on entry and exit): ``max_iter`` 200 and 6 on problem 0, and
    the restart loop on problem 4."""
    a, b, x0 = _problem(0)
    a4, b4, x04 = _problem(4)
    with without_line_search_faults():
        out = {m: jopt.minimize_bfgs(j_obj, jnp.asarray(x0), jnp.asarray(a),
                                     jnp.asarray(b), max_iter=m)
               for m in (200, 6)}
        out["restarts"] = jopt.minimize_bfgs(
            j_obj, jnp.asarray(x04), jnp.asarray(a4), jnp.asarray(b4),
            **_RESTART_KW)
    return out


@pytest.mark.parametrize("max_iter", [200, 6])
def test_bfgs_matches_jax(fixed_bfgs, max_iter):
    a, b, x0 = _problem(0)
    want = fixed_bfgs[max_iter]
    vag, ev_for = opt.value_and_grad_of(t_obj, *_t(a, b))
    stats = {}
    got = opt.minimize_bfgs(vag, torch.as_tensor(x0), max_iter=max_iter,
                            evaluator_for=ev_for, stats=stats)
    _compare(got, want)
    # the objective at parameters that agree to 1e-8
    np.testing.assert_allclose(got.fun.numpy(), np.asarray(want.fun),
                               rtol=1e-8, atol=1e-14)
    # every round evaluates the lanes that need a trial: the calls are the
    # most evaluations a lane needs, at least one a BFGS iteration
    assert stats["calls"] >= int(got.n_iter.max()) + 1
    if max_iter == 200:
        assert got.converged.float().mean() > 0.5


def test_bfgs_departs_from_jax_only_where_its_line_search_fails():
    """Against jax's own BFGS: a lane that converged there or ran out of
    iterations never met a line-search fault, and the port ends where it
    does; a lane whose line search failed there (stopped short, not
    converged) goes on in the port to an objective no higher."""
    a, b, x0 = _problem(0)
    want = jopt.minimize_bfgs(j_obj, jnp.asarray(x0), jnp.asarray(a),
                              jnp.asarray(b), max_iter=200)
    vag, ev_for = opt.value_and_grad_of(t_obj, *_t(a, b))
    got = opt.minimize_bfgs(vag, torch.as_tensor(x0), evaluator_for=ev_for)
    cw = np.asarray(want.converged)
    faulted = ~cw & (np.asarray(want.n_iter) < 200)
    assert faulted.sum() >= 4        # the faults are common on this problem
    wx = np.asarray(want.x)[~faulted]
    np.testing.assert_array_equal(got.converged.numpy()[~faulted],
                                  cw[~faulted])
    assert (np.abs(got.x.numpy()[~faulted] - wx).max(axis=-1)
            <= 1e-8 * (1.0 + np.abs(wx).max(axis=-1))).all()
    assert (got.fun.numpy()[faulted]
            <= np.asarray(want.fun)[faulted] * (1 + 1e-12)).all()
    assert got.converged.numpy()[faulted].all()


def test_bfgs_drops_tol_and_runs_without_gathering():
    """``tol`` is dropped as jax.scipy.optimize.minimize drops it; without
    ``evaluator_for`` every round evaluates the whole batch, same result."""
    a, b, x0 = _problem(1)
    vag, ev_for = opt.value_and_grad_of(t_obj, *_t(a, b))
    base = opt.minimize_bfgs(vag, torch.as_tensor(x0), evaluator_for=ev_for)
    for kw in ({"tol": 1e-2}, {"tol": 1e-14, "evaluator_for": None}):
        kw.setdefault("evaluator_for", ev_for)
        other = opt.minimize_bfgs(vag, torch.as_tensor(x0), **kw)
        for f in ("x", "fun", "converged", "n_iter"):
            assert torch.equal(getattr(other, f), getattr(base, f))
    with pytest.raises(ValueError, match="evaluator_for"):
        opt.minimize_bfgs(vag, torch.as_tensor(x0), restarts=1)


def test_newton_matches_jax():
    a, b, x0 = _problem(2)
    args = (jnp.asarray(a), jnp.asarray(b))
    # the GARCH fit's tolerance: every exit is a real decrease
    want = jopt.minimize_newton(j_obj, jnp.asarray(x0), *args, tol=1e-6)
    got = opt.minimize_newton(t_obj, torch.as_tensor(x0), *_t(a, b),
                              tol=1e-6)
    same = _compare(got, want)
    assert same.all()
    # the dtype default: exits at rounding level, parameters still agree
    want = jopt.minimize_newton(j_obj, jnp.asarray(x0), *args)
    got = opt.minimize_newton(t_obj, torch.as_tensor(x0), *_t(a, b))
    _compare(got, want, iter_share=0.5)


def test_newton_fused_hessian_is_autograds():
    """``value_grad_hess_fn`` replaces autograd; with the exact derivatives
    written out the solve is the autograd one's."""
    a, b, x0 = _problem(3)
    at, bt = _t(a, b)

    def fgh(x, a_, b_):
        x0_, x1, x2 = x.unbind(-1)
        r1 = x1 - x0_ ** 2
        f = t_obj(x, a_, b_)
        g = torch.stack([-2 * (a_ - x0_) - 4 * b_ * r1 * x0_,
                         2 * b_ * r1 - (x2 - x1),
                         (x2 - x1) + 0.4 * x2 ** 3], dim=-1)
        z = torch.zeros_like(x0_)
        H = torch.stack([
            torch.stack([2 - 4 * b_ * r1 + 8 * b_ * x0_ ** 2,
                         -4 * b_ * x0_, z], -1),
            torch.stack([-4 * b_ * x0_, 2 * b_ + 1, -torch.ones_like(z)],
                        -1),
            torch.stack([z, -torch.ones_like(z), 1 + 1.2 * x2 ** 2], -1)],
            dim=-2)
        return f, g, H

    auto = opt.minimize_newton(t_obj, torch.as_tensor(x0), at, bt, tol=1e-6)
    fused = opt.minimize_newton(None, torch.as_tensor(x0), at, bt, tol=1e-6,
                                value_grad_hess_fn=fgh)
    np.testing.assert_allclose(fused.x.numpy(), auto.x.numpy(), atol=1e-9)
    assert (fused.n_iter == auto.n_iter).float().mean() >= 0.9


@pytest.mark.parametrize("solver", ["bfgs", "newton"])
def test_restarts_match_jax_given_its_draws(fixed_bfgs, solver):
    a, b, x0 = _problem(4)
    restarts, seed = 2, 7
    draws = jax_draws(seed, S, 3, restarts)
    args = (jnp.asarray(a), jnp.asarray(b))
    kw = _RESTART_KW
    if solver == "bfgs":
        want = fixed_bfgs["restarts"]
        vag, ev_for = opt.value_and_grad_of(t_obj, *_t(a, b))
        stats = {}
        got = opt.minimize_bfgs(vag, torch.as_tensor(x0), max_iter=4,
                                evaluator_for=ev_for, restarts=restarts,
                                jitter_draws=torch.as_tensor(draws),
                                stats=stats)
    else:
        want = jopt.minimize_newton(j_obj, jnp.asarray(x0), *args, tol=1e-6,
                                    **kw)
        stats = {}
        got = opt.minimize_newton(t_obj, torch.as_tensor(x0), *_t(a, b),
                                  tol=1e-6, max_iter=4, restarts=restarts,
                                  jitter_draws=torch.as_tensor(draws),
                                  stats=stats)
    np.testing.assert_array_equal(got.attempts.numpy(),
                                  np.asarray(want.attempts))
    assert (got.attempts > 1).any()            # the restarts really ran
    assert stats["restart_lanes"][0] == int((got.attempts > 1).sum())
    _compare(got, want)
