"""Batched solvers (counterpart of ``spark_timeseries_tpu/ops/optimize.py``).

Ported: the result type; the multi-start restart loop
(:func:`solve_with_restarts`, the JAX package's ``_with_restarts`` /
``_solve_with_policy`` run on the host over shrinking gathered lane
sets); the batched Levenberg-Marquardt :func:`minimize_least_squares`
(its state machine also drives ``ops.arma_ne.fit_css_lm``'s plain
version); and :func:`minimize_box`, the batched projected gradient on a
box.  ``minimize_bfgs`` and ``minimize_newton`` wait for the model
families that run them (ROADMAP Queue A item 3).
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from .linalg import spd_solve


class MinimizeResult(NamedTuple):
    """Batched optimization artifacts (leading dims ``...`` = batch).

    ``attempts`` is the per-lane solve count of the multi-start retry
    path (``restarts > 0`` or a ``force_nonconverge`` fault); None on the
    single-start path."""
    x: torch.Tensor          # (..., p) optimal parameters
    fun: torch.Tensor        # (...,)   objective at optimum
    converged: torch.Tensor  # (...,)   bool per-lane convergence mask
    n_iter: torch.Tensor     # (...,)   iterations taken
    attempts: Optional[torch.Tensor] = None  # (...,) multi-start solves


def _project(x: torch.Tensor, lower, upper) -> torch.Tensor:
    return torch.clamp(x, lower, upper)


def _forced_failures() -> int:
    """Attempts an active ``force_nonconverge`` fault makes the solvers
    report non-converged (0 normally); read at call time."""
    from ..utils import resilience as _resilience
    return _resilience.forced_optimizer_failures()


DRAW_BLOCK = 1024     # lanes per restart-draw generator


def restart_draws(restarts: int, S: int, k: int, dtype, device,
                  seed: int = 0) -> torch.Tensor:
    """The restart jitter's standard-normal draws, ``(restarts, S, k)``,
    drawn up front on the CPU (the same draws for a CPU and a CUDA fit)
    and then moved to ``device``.  Lanes come in blocks of
    ``DRAW_BLOCK``; block ``b`` draws all its lanes, ``(DRAW_BLOCK,
    restarts, k)``, from its own ``torch.Generator`` seeded with
    ``(seed, b)``.  So a lane's draws are fixed by the seed and its
    index alone: a panel padded with extra lanes keeps its lanes'
    restart points.  Draw ``a - 1`` jitters attempt ``a``."""
    blocks = []
    for b in range(-(-S // DRAW_BLOCK)):
        # the CPU generator keeps 32 bits of its seed: mix (seed, b) in
        g = torch.Generator().manual_seed(int(
            np.random.SeedSequence([int(seed) % 2**64, b]).generate_state(1)[0]))
        blocks.append(torch.randn((DRAW_BLOCK, int(restarts), k),
                                  generator=g, dtype=dtype))
    draws = torch.cat(blocks) if blocks else torch.empty(
        (0, int(restarts), k), dtype=dtype)
    return draws[:S].transpose(0, 1).to(device)


def solve_with_restarts(solve: Callable, x0: torch.Tensor, restarts: int,
                        restart_scale: float = 0.25, restart_seed: int = 0,
                        fail_first: int = 0,
                        jitter_draws: Optional[torch.Tensor] = None,
                        stats: Optional[dict] = None) -> MinimizeResult:
    """The multi-start retry loop over a batched solver.

    ``solve(x_start (L, k), lanes)`` solves ``L`` lanes and returns
    ``(x, fun, converged, n_iter)``; ``lanes`` is None for every lane of
    ``x0 (S, k)``, else the ``(L,)`` int64 lane indices whose data the
    solver gathers.  Per lane this is the JAX package's
    ``_with_restarts``: attempt 0 solves every lane from ``x0``; attempt
    ``a = 1..restarts`` re-solves only the lanes not yet converged, from
    ``x0 + restart_scale · (1 + |x0|) · draws[a - 1]``.  An attempt counts
    when it converged with finite ``fun`` and ``x``; otherwise the best
    finite attempt so far is kept (``better = ok | (finite & fun <
    best)``), and while no attempt was finite the lane holds ``x0`` with
    ``fun = inf``; ``n_iter`` is the kept attempt's.  ``attempts`` counts
    the solves a lane ran: 1 for a lane converged at once, ``restarts +
    1`` for one that never converges.  ``fail_first`` (a
    ``force_nonconverge`` fault) makes attempts ``< fail_first`` report
    non-convergence.

    ``jitter_draws (restarts, S, k)`` replaces the draws of
    :func:`restart_draws` (``restart_seed``), so that tests can hand in
    the JAX package's.  ``stats`` (a dict) receives ``solves`` (calls of
    ``solve``) and ``restart_lanes`` (lanes re-solved at each attempt)."""
    S, k = x0.shape
    dev = x0.device
    draws = jitter_draws
    if restarts and draws is None:
        draws = restart_draws(restarts, S, k, x0.dtype, dev, restart_seed)
    elif draws is not None:
        draws = torch.as_tensor(draws, dtype=x0.dtype, device=dev)
        if draws.shape != (restarts, S, k):
            raise ValueError(
                f"restart draws of shape {tuple(draws.shape)}; expected "
                f"{(restarts, S, k)}")
    inf = torch.full((), float("inf"), dtype=x0.dtype, device=dev)

    def attempt(a: int, xs: torch.Tensor, lanes):
        x, fun, conv, n_it = solve(xs, lanes)
        if fail_first:
            conv = conv & (a >= fail_first)
        fin = torch.isfinite(fun) & torch.isfinite(x).all(dim=-1)
        return x, fun, conv & fin, n_it, fin

    r_x, r_fun, ok, r_it, fin = attempt(0, x0, None)
    x = torch.where(fin[:, None], r_x, x0)
    fun = torch.where(fin, r_fun, inf)
    converged = ok
    n_iter = r_it
    att = torch.ones((S,), dtype=torch.int32, device=dev)
    solves, restart_lanes = 1, []
    for a in range(1, restarts + 1):
        lanes = torch.nonzero(~converged).flatten()
        if lanes.numel() == 0:
            break
        x0_l = x0.index_select(0, lanes)
        start = x0_l + draws[a - 1].index_select(0, lanes) \
            * (restart_scale * (1.0 + torch.abs(x0_l)))
        r_x, r_fun, ok, r_it, fin = attempt(a, start, lanes)
        solves += 1
        restart_lanes.append(int(lanes.numel()))
        better = ok | (fin & (r_fun < fun.index_select(0, lanes)))
        x[lanes] = torch.where(better[:, None], r_x, x.index_select(0, lanes))
        fun[lanes] = torch.where(better, r_fun, fun.index_select(0, lanes))
        n_iter[lanes] = torch.where(better, r_it.to(n_iter.dtype),
                                    n_iter.index_select(0, lanes))
        converged[lanes] = ok
        att[lanes] += 1
    if stats is not None:
        stats.update(solves=solves, restart_lanes=restart_lanes)
    return MinimizeResult(x, fun, converged, n_iter, att)


def lm_state_machine(ne: Callable, x0: torch.Tensor, tol: float,
                     max_iter: int):
    """Batched Levenberg-Marquardt from the normal equations ``ne(x (S,
    k)) -> (JᵀJ (S, k, k), Jᵀr (S, k), sse (S,))``: per lane the JAX
    package's ``_minimize_lm_one`` (Marquardt-scaled damping, the trial
    point's normal equations kept on accept, the pinned exit testing the
    pre-update λ, finished lanes frozen, at most ``max_iter``
    iterations), with one host read a iteration for the loop test.
    Returns ``(x, fun, converged, n_iter)``."""
    S, k = x0.shape
    eye = torch.eye(k, dtype=x0.dtype, device=x0.device)
    x = x0
    jtj, jtr, f = ne(x0)
    lam = torch.full((S,), 1e-3, dtype=x0.dtype, device=x0.device)
    it_lanes = torch.zeros((S,), dtype=torch.int32, device=x0.device)
    done = torch.zeros((S,), dtype=torch.bool, device=x0.device)
    it = 0
    while it < max_iter and not bool(done.all()):
        active = ~done
        damp = lam[:, None] * torch.diagonal(jtj, dim1=-2, dim2=-1) + 1e-12
        delta = spd_solve(jtj + damp[..., None] * eye, jtr)
        x_new = x - delta
        jtj_new, jtr_new, f_new = ne(x_new)
        ok = torch.isfinite(jtj_new).all(dim=-1).all(dim=-1) \
            & torch.isfinite(jtr_new).all(dim=-1)
        improved = (f_new < f) & torch.isfinite(f_new) & ok
        take = improved & active
        x = torch.where(take[:, None], x_new, x)
        f_keep = torch.where(take, f_new, f)
        jtj = torch.where(take[:, None, None], jtj_new, jtj)
        jtr = torch.where(take[:, None], jtr_new, jtr)
        # the pinned-at-minimum exit tests the PRE-update lambda, so a
        # rejection at lam = 1e8 still raises lam and only the next
        # rejection marks the lane done
        rel_drop = (f - f_new) <= tol * (torch.abs(f) + tol)
        step_small = torch.abs(delta).amax(dim=-1) <= tol * (
            torch.abs(x).amax(dim=-1) + tol)
        newly = (improved & (rel_drop | step_small)) \
            | (~improved & (lam > 1e8))
        lam = torch.where(active, torch.where(improved, lam * 0.1,
                                              lam * 10.0), lam)
        f = f_keep
        it_lanes = it_lanes + active.to(torch.int32)
        done = done | (newly & active)
        it += 1
    return x, f, done, it_lanes


def _gather_args(args, lanes):
    return args if lanes is None else tuple(
        a.index_select(0, lanes) if isinstance(a, torch.Tensor) else a
        for a in args)


def _autodiff_normal_eqs(residual_fn: Callable) -> Callable:
    """``(JᵀJ, Jᵀr, sse)`` of ``residual_fn(x (k,), *args_i) -> (m,)``,
    batched over lanes: the Jacobian by forward-mode ``torch.func``."""
    from torch.func import jacfwd, vmap

    def ne(x, *args):
        r = vmap(residual_fn)(x, *args)                     # (S, m)
        J = vmap(jacfwd(residual_fn))(x, *args)             # (S, m, k)
        return (torch.einsum("smk,sml->skl", J, J),
                torch.einsum("smk,sm->sk", J, r), (r * r).sum(dim=-1))

    return ne


def minimize_least_squares(residual_fn: Optional[Callable],
                           x0: torch.Tensor, *args,
                           tol: Optional[float] = None, max_iter: int = 100,
                           normal_eqs_fn: Optional[Callable] = None,
                           restarts: int = 0, restart_scale: float = 0.25,
                           restart_seed: int = 0,
                           jitter_draws: Optional[torch.Tensor] = None,
                           stats: Optional[dict] = None) -> MinimizeResult:
    """Batched Levenberg-Marquardt for residual objectives (minimizes
    ``sum(residual_fn(x)**2)``): the JAX package's
    ``minimize_least_squares``, its per-lane state machine run for all
    lanes at once (:func:`lm_state_machine`).

    ``x0 (..., k)``; every ``args`` entry carries the same leading dims.
    ``normal_eqs_fn(x (S, k), *args) -> (JᵀJ, Jᵀr, sse)``, batched over
    the flattened lanes, replaces the autodiff pass; otherwise
    ``residual_fn(x (k,), *args_i) -> (m,)`` is one lane's residual, its
    Jacobian from ``torch.func``.  ``tol`` defaults to 1e-10 for float64
    and 1e-6 otherwise.  ``restarts`` / ``restart_scale`` /
    ``restart_seed`` (or the draws themselves, ``jitter_draws``) run
    the multi-start path of :func:`solve_with_restarts` over gathered
    lanes; ``restarts=0`` without a fault is the single-start solve."""
    if tol is None:
        tol = 1e-10 if x0.dtype == torch.float64 else 1e-6
    lead, k = x0.shape[:-1], x0.shape[-1]
    flat = x0.reshape(-1, k)
    args = tuple(a.reshape(flat.shape[0], *a.shape[len(lead):])
                 if isinstance(a, torch.Tensor) else a for a in args)
    ne_fn = normal_eqs_fn if normal_eqs_fn is not None \
        else _autodiff_normal_eqs(residual_fn)

    def solve(xs, lanes):
        a = _gather_args(args, lanes)
        return lm_state_machine(lambda x: ne_fn(x, *a), xs, tol, max_iter)

    return _reshape(_solve_with_policy(solve, flat, restarts, restart_scale,
                                       restart_seed, jitter_draws, stats),
                    lead, k)


def _solve_with_policy(solve, x0, restarts, restart_scale, restart_seed,
                       jitter_draws, stats) -> MinimizeResult:
    """The restart loop when a budget or a fault asks for it, else
    one plain solve (``attempts`` None)."""
    fail_first = _forced_failures()
    if restarts or fail_first:
        return solve_with_restarts(solve, x0, restarts, restart_scale,
                                   restart_seed, fail_first,
                                   jitter_draws, stats)
    if stats is not None:
        stats.update(solves=1, restart_lanes=[])
    return MinimizeResult(*solve(x0, None))


def _reshape(res: MinimizeResult, lead, k: int) -> MinimizeResult:
    return MinimizeResult(
        res.x.reshape(*lead, k), res.fun.reshape(lead),
        res.converged.reshape(lead), res.n_iter.reshape(lead),
        None if res.attempts is None else res.attempts.reshape(lead))


def minimize_box(value_and_grad_fn: Callable, x0: torch.Tensor,
                 lower: float, upper: float, *, tol: float = 1e-10,
                 max_iter: int = 500, max_backtracks: int = 40,
                 trials_per_call: int = 1, restarts: int = 0,
                 restart_scale: float = 0.25, restart_seed: int = 0,
                 jitter_draws: Optional[torch.Tensor] = None,
                 evaluator_for: Optional[Callable] = None,
                 stats: Optional[dict] = None) -> MinimizeResult:
    """Batched box-constrained minimization by projected gradient with
    Armijo backtracking: per lane, the state machine of the JAX package's
    ``_minimize_box_one``, run for all lanes at once.

    ``value_and_grad_fn(x (S, p)) -> (f (S,), g (S, p))`` evaluates the
    whole batch; ``x0 (S, p)``; ``lower``/``upper`` are scalars.  ``x0`` is
    projected before the first evaluation.  Each outer iteration restarts
    the line search at ``t = 1`` and halves ``t`` on the lanes that have
    not yet accepted; a trial is accepted when
    ``f_new <= f - 1e-4 g·(x - x_new)`` and ``f_new`` is finite.  A lane is
    done when its step is at most ``tol``, its objective stalls
    (``|f_new - f| <= tol (|f| + tol)``) or no trial was accepted;
    finished lanes hold ``x``, ``f`` and ``g``, and ``n_iter`` counts the
    iterations a lane was active in.

    ``trials_per_call = K > 1`` evaluates the next K steps ``t, t/2, ...``
    of every lane in one call, ``value_and_grad_fn(x (K, S, p)) ->
    (f (K, S), g (K, S, p))``, and each lane takes its first accepted
    trial: the same result in fewer, larger calls, for evaluators whose
    cost is per call rather than per lane.

    The loop reads the device twice: ``all(done)`` once per iteration and
    ``any(pending)`` once per call.  ``stats`` (a dict, optional) receives
    ``calls`` (value-and-grad calls), ``iterations``, ``trials`` and
    ``evaluations``, the ``(S,)`` int32 value-and-grad passes each lane
    needed: 1 plus its trials up to and including each accepted one, as
    if it ran alone with ``trials_per_call = 1`` (whatever K is).

    ``restarts`` / ``restart_scale`` / ``restart_seed`` (or
    ``jitter_draws``), or an active ``force_nonconverge`` fault, run
    the multi-start path of :func:`solve_with_restarts`: its attempts
    re-solve gathered lanes through ``evaluator_for(lanes)``, the
    value-and-grad function over those lanes alone (jittered starts are
    projected into the box like any ``x0``); ``stats`` then receives the
    loop's counts.
    """
    if restarts or _forced_failures():
        if evaluator_for is None:
            raise ValueError(
                "the multi-start path re-solves gathered lanes: pass "
                "evaluator_for(lanes) -> value_and_grad_fn over them")

        def solve(xs, lanes):
            vag = value_and_grad_fn if lanes is None else evaluator_for(lanes)
            return _box_solve(vag, xs, lower, upper, tol, max_iter,
                              max_backtracks, trials_per_call, None)

        return _solve_with_policy(solve, x0, restarts, restart_scale,
                                  restart_seed, jitter_draws, stats)
    return MinimizeResult(*_box_solve(value_and_grad_fn, x0, lower, upper,
                                      tol, max_iter, max_backtracks,
                                      trials_per_call, stats))


def _box_solve(value_and_grad_fn, x0, lower, upper, tol, max_iter,
               max_backtracks, trials_per_call, stats):
    """One projected-gradient solve of every lane: ``(x, f, done,
    n_iter)``."""
    S = x0.shape[0]
    dev = x0.device
    lanes = torch.arange(S, device=dev)
    K = max(1, min(int(trials_per_call), max_backtracks))
    halvings = 0.5 ** torch.arange(K, dtype=x0.dtype, device=dev)
    x = _project(x0, lower, upper)
    f, g = value_and_grad_fn(x)
    calls, trials = 1, 0
    evaluations = torch.ones((S,), dtype=torch.int32, device=dev)
    it_lanes = torch.zeros((S,), dtype=torch.int32, device=dev)
    done = torch.zeros((S,), dtype=torch.bool, device=dev)
    it = 0
    while it < max_iter and not bool(done.all()):
        active = ~done
        accepted = torch.zeros((S,), dtype=torch.bool, device=dev)
        xb, fb, gb = x, f, g
        pending = active

        def armijo(f_new, x_new):
            decrease = (g * (x - x_new)).sum(dim=-1)
            return (f_new <= f - 1e-4 * decrease) & torch.isfinite(f_new)

        # every pending lane has made k trials, so its step is t = 2^-k
        k = 0
        while k < max_backtracks and bool(pending.any()):
            kk = min(K, max_backtracks - k)
            if kk == 1:
                x_trial = _project(x - (0.5 ** k) * g, lower, upper)
                f_t, g_t = value_and_grad_fn(x_trial)
                ok = armijo(f_t, x_trial)
                used = 1
            else:
                steps = (0.5 ** k) * halvings[:kk, None, None]
                xs = _project(x - steps * g, lower, upper)
                fs, gs = value_and_grad_fn(xs)
                oks = armijo(fs, xs)
                first = oks.to(torch.uint8).argmax(dim=0)   # first accepted
                ok = oks.any(dim=0)
                x_trial, f_t, g_t = (v[first, lanes] for v in (xs, fs, gs))
                # a lane that accepts stops counting at its first success
                used = torch.where(ok, first.to(torch.int32) + 1, kk)
            evaluations += torch.where(pending, used, 0).to(torch.int32)
            calls += 1
            k += kk
            newly = ok & pending
            xb = torch.where(newly[:, None], x_trial, xb)
            fb = torch.where(newly, f_t, fb)
            gb = torch.where(newly[:, None], g_t, gb)
            accepted = accepted | newly
            pending = pending & ~newly
        trials += k
        step_norm = (xb - x).abs().amax(dim=-1)
        f_stall = (fb - f).abs() <= tol * (f.abs() + tol)
        newly_done = (step_norm <= tol) | f_stall | ~accepted
        take = accepted & active
        x = torch.where(take[:, None], xb, x)
        f = torch.where(take, fb, f)
        g = torch.where(take[:, None], gb, g)
        it_lanes = it_lanes + active.to(torch.int32)
        done = done | (newly_done & active)
        it += 1
    if stats is not None:
        stats.update(calls=calls, iterations=it, trials=trials,
                     evaluations=evaluations)
    return x, f, done, it_lanes
