"""Batched solvers (counterpart of ``spark_timeseries_tpu/ops/optimize.py``).

Ported: the result type; the multi-start restart loop
(:func:`solve_with_restarts`, the JAX package's ``_with_restarts`` /
``_solve_with_policy`` run on the host over shrinking gathered lane
sets); the batched Levenberg-Marquardt :func:`minimize_least_squares`
(its state machine also drives ``ops.arma_ne.fit_css_lm``'s plain
version); :func:`minimize_box`, the batched projected gradient on a box;
:func:`minimize_newton`, the batched damped Newton on the exact autograd
Hessian; and :func:`minimize_bfgs`, the batched BFGS with the strong-Wolfe
line search that ``jax.scipy.optimize.minimize(method="BFGS")`` runs.

Every solver here is one host-driven loop over the whole lane batch: a
lane's state machine is the JAX package's single-lane one, finished lanes
are frozen, and the loop reads the device once an iteration for its exit
test.  Newton and BFGS gather the lanes still running out of the batch
once at most half of it is left, so an evaluation costs what the active
lanes cost.
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
                     max_iter: int, change: Optional[Callable] = None):
    """Batched Levenberg-Marquardt from the normal equations ``ne(x (S,
    k)) -> (JᵀJ (S, k, k), Jᵀr (S, k), sse (S,), *carry)``: per lane the
    JAX package's ``_minimize_lm_one`` (Marquardt-scaled damping, the
    trial point's normal equations kept on accept, the pinned exit
    testing the pre-update λ, finished lanes frozen, at most ``max_iter``
    iterations), with one host read a iteration for the loop test.

    The accept test and the objective-drop exit read ``sse_new - sse``;
    ``change(cur, x, x_new) -> (S,)`` replaces it with a change computed
    from the current point's pass ``cur`` (all of ``ne``'s outputs, the
    ``carry`` tensors kept on accept like the rest), for objectives whose
    difference of two rounded sse values is coarser than the change.
    Returns ``(x, fun, converged, n_iter)``."""
    S, k = x0.shape
    eye = torch.eye(k, dtype=x0.dtype, device=x0.device)
    x = x0
    cur = tuple(ne(x0))
    lam = torch.full((S,), 1e-3, dtype=x0.dtype, device=x0.device)
    it_lanes = torch.zeros((S,), dtype=torch.int32, device=x0.device)
    done = torch.zeros((S,), dtype=torch.bool, device=x0.device)
    it = 0
    while it < max_iter and not bool(done.all()):
        active = ~done
        jtj, jtr, f = cur[:3]
        damp = lam[:, None] * torch.diagonal(jtj, dim1=-2, dim2=-1) + 1e-12
        delta = spd_solve(jtj + damp[..., None] * eye, jtr)
        x_new = x - delta
        new = tuple(ne(x_new))
        jtj_new, jtr_new, f_new = new[:3]
        ok = torch.isfinite(jtj_new).all(dim=-1).all(dim=-1) \
            & torch.isfinite(jtr_new).all(dim=-1)
        if change is None:
            drop = f - f_new
            improved = (f_new < f) & torch.isfinite(f_new) & ok
        else:
            dch = change(cur, x, x_new)
            drop = -dch
            improved = (dch < 0) & torch.isfinite(f_new) \
                & torch.isfinite(dch) & ok
        take = improved & active
        x = torch.where(take[:, None], x_new, x)
        cur = tuple(torch.where(take.reshape(-1, *[1] * (v.ndim - 1)), nv, v)
                    for v, nv in zip(cur, new))
        # the pinned-at-minimum exit tests the PRE-update lambda, so a
        # rejection at lam = 1e8 still raises lam and only the next
        # rejection marks the lane done
        rel_drop = drop <= tol * (torch.abs(f) + tol)
        step_small = torch.abs(delta).amax(dim=-1) <= tol * (
            torch.abs(x).amax(dim=-1) + tol)
        newly = (improved & (rel_drop | step_small)) \
            | (~improved & (lam > 1e8))
        lam = torch.where(active, torch.where(improved, lam * 0.1,
                                              lam * 10.0), lam)
        it_lanes = it_lanes + active.to(torch.int32)
        done = done | (newly & active)
        it += 1
    return x, cur[2], done, it_lanes


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


# ---------------------------------------------------------------------------
# objectives as batched evaluators
# ---------------------------------------------------------------------------

def value_and_grad_of(fn: Callable, *args):
    """A batched scalar objective ``fn(x (S, k), *args) -> (S,)`` (lanes
    independent; every ``args`` entry with the same leading ``S``) as the
    ``(value_and_grad_fn, evaluator_for)`` pair that :func:`minimize_box`
    and :func:`minimize_bfgs` take: ``x (L, k) -> (f (L,), g (L, k))``
    over every lane, and ``evaluator_for(lanes)`` over the given lanes
    alone.  The gradient is one backward of ``Σ f``, exact per lane
    because the lanes are independent."""
    def for_lanes(lanes):
        a = _gather_args(args, lanes)

        def vag(x):
            with torch.enable_grad():
                xr = x.detach().requires_grad_(True)
                f = fn(xr, *a)
                g, = torch.autograd.grad(f.sum(), xr, allow_unused=True)
            return f.detach(), torch.zeros_like(x) if g is None else g
        return vag

    return for_lanes(None), for_lanes


def _value_grad_hess(fn: Callable, x: torch.Tensor, args):
    """``(f (S,), g (S, k), H (S, k, k))`` of a batched objective: the
    gradient by one backward of ``Σ f`` with its graph kept, then row j
    of every lane's Hessian by one more backward of ``Σ g[:, j]`` (exact,
    not Gauss-Newton: the lanes are independent)."""
    k = x.shape[-1]
    with torch.enable_grad():
        xr = x.detach().requires_grad_(True)
        f = fn(xr, *args)
        g, = torch.autograd.grad(f.sum(), xr, create_graph=True,
                                 allow_unused=True)
        if g is None:
            g = torch.zeros_like(xr)
        rows = []
        for j in range(k):
            if g.requires_grad:
                h, = torch.autograd.grad(g[:, j].sum(), xr,
                                         retain_graph=j < k - 1,
                                         allow_unused=True)
            else:
                h = None
            rows.append(torch.zeros_like(x) if h is None else h)
    return f.detach(), g.detach(), torch.stack(rows, dim=-2).detach()


def _compact(active: torch.Tensor, work: torch.Tensor, n_active: int):
    """The working lanes after a round: the still-active ones once at
    most half the working set is left (then ``True``), else unchanged."""
    if 0 < n_active <= work.numel() // 2:
        return work.index_select(0, torch.nonzero(
            active.index_select(0, work)).flatten()), True
    return work, False


# ---------------------------------------------------------------------------
# damped Newton
# ---------------------------------------------------------------------------

def _newton_solve(fgh, x0, args, tol, max_iter, stats=None):
    """One damped-Newton solve of every lane: ``(x, f, done, n_iter)``.

    Per lane the JAX package's ``_minimize_newton_one``: damp by ``λ
    (|diag H| + 1e-8)``, solve with the unrolled Cholesky, evaluate f, g,
    H at the trial point, accept on a finite decrease (λ ÷ 10) or reject
    (λ × 10), done on an accepted step whose objective drop or step is
    relatively below ``tol``, or on a rejection once λ passed 1e10.
    Finished lanes hold their state; the running ones are gathered out
    (:func:`_compact`), and ``args`` with them.  ``fgh(x, *args) -> (f,
    g, H)``."""
    S, k = x0.shape
    dev = x0.device
    eye = torch.eye(k, dtype=x0.dtype, device=dev)
    f, g, h = fgh(x0, *args)
    x = x0.clone()
    lam = torch.full((S,), 1e-3, dtype=x0.dtype, device=dev)
    it_lanes = torch.zeros((S,), dtype=torch.int32, device=dev)
    done = torch.zeros((S,), dtype=torch.bool, device=dev)
    work = torch.arange(S, device=dev)
    wargs = args
    evaluations = 1
    it = 0
    while it < max_iter:
        n_active = int((~done).sum())
        if n_active == 0:
            break
        work, moved = _compact(~done, work, n_active)
        if moved:
            wargs = _gather_args(args, work)
        xs, fs, gs, hs, ls = (v.index_select(0, work)
                              for v in (x, f, g, h, lam))
        act = ~done.index_select(0, work)
        damp = ls[:, None] * (torch.abs(torch.diagonal(hs, dim1=-2,
                                                       dim2=-1)) + 1e-8)
        delta = spd_solve(hs + damp[..., None] * eye, gs)
        x_new = xs - delta
        f_new, g_new, h_new = fgh(x_new, *wargs)
        evaluations += 1
        ok = torch.isfinite(f_new) & torch.isfinite(g_new).all(dim=-1) \
            & torch.isfinite(h_new).flatten(1).all(dim=-1) \
            & torch.isfinite(delta).all(dim=-1)
        improved = (f_new < fs) & ok
        take = improved & act
        rel_drop = (fs - f_new) <= tol * (torch.abs(fs) + tol)
        step_small = torch.abs(delta).amax(dim=-1) <= tol * (
            torch.abs(xs).amax(dim=-1) + tol)
        newly = (improved & (rel_drop | step_small)) \
            | (~improved & (ls > 1e10))
        x[work] = torch.where(take[:, None], x_new, xs)
        f[work] = torch.where(take, f_new, fs)
        g[work] = torch.where(take[:, None], g_new, gs)
        h[work] = torch.where(take[:, None, None], h_new, hs)
        lam[work] = torch.where(act, torch.where(improved, ls * 0.1,
                                                 ls * 10.0), ls)
        it_lanes[work] += act.to(torch.int32)
        done[work] = done.index_select(0, work) | (newly & act)
        it += 1
    if stats is not None:
        stats.update(iterations=it, evaluations=evaluations)
    return x, f, done, it_lanes


def minimize_newton(fn: Callable, x0: torch.Tensor, *args,
                    tol: Optional[float] = None, max_iter: int = 100,
                    restarts: int = 0, restart_scale: float = 0.25,
                    restart_seed: int = 0,
                    jitter_draws: Optional[torch.Tensor] = None,
                    value_grad_hess_fn: Optional[Callable] = None,
                    stats: Optional[dict] = None) -> MinimizeResult:
    """Batched damped Newton for smooth scalar objectives with few
    parameters (the JAX package's ``minimize_newton``).

    ``fn(x (S, k), *args) -> (S,)`` evaluates every lane at once (lanes
    independent; each ``args`` entry carries the leading ``S``); ``x0
    (..., k)``, leading dims flattened.  The gradient and the exact
    Hessian come from autograd (:func:`_value_grad_hess`), the damped
    step from ``ops.linalg.spd_solve``.  ``value_grad_hess_fn(x, *args)
    -> (f, g, H)`` replaces autograd for an objective with an exact fused
    pass (``fn`` is then unused and may be None).  ``tol`` defaults to 1e-10 for
    float64 and 1e-6 otherwise.  ``restarts`` / ``restart_scale`` /
    ``restart_seed`` (or ``jitter_draws``) run the multi-start path of
    :func:`solve_with_restarts`.  ``stats`` receives ``solves``,
    ``restart_lanes`` and, on the single-start path, ``iterations`` and
    ``evaluations`` (f, g, H passes over the working lanes)."""
    if tol is None:
        tol = 1e-10 if x0.dtype == torch.float64 else 1e-6
    lead, k = x0.shape[:-1], x0.shape[-1]
    flat = x0.reshape(-1, k)
    args = tuple(a.reshape(flat.shape[0], *a.shape[len(lead):])
                 if isinstance(a, torch.Tensor) else a for a in args)

    fgh = value_grad_hess_fn if value_grad_hess_fn is not None \
        else (lambda x, *a: _value_grad_hess(fn, x, a))

    def solve(xs, lanes):
        return _newton_solve(fgh, xs, _gather_args(args, lanes), tol,
                             max_iter, stats if lanes is None else None)

    return _reshape(_solve_with_policy(solve, flat, restarts, restart_scale,
                                       restart_seed, jitter_draws, stats),
                    lead, k)


# ---------------------------------------------------------------------------
# BFGS with the strong-Wolfe line search of jax.scipy.optimize
# ---------------------------------------------------------------------------

_C1, _C2 = 1e-4, 0.9          # Wolfe constants of jax's line_search
_ZOOM_DELTA1, _ZOOM_DELTA2 = 0.2, 0.1
_ZOOM_MAX = 30                # zoom iterations before it gives up

# lane phases of the batched BFGS (_REPORT: a failed line search's lane
# evaluating the point it returns)
_BRACKET, _ZOOM, _FINISHED, _REPORT = 0, 1, 2, 3


def _cubicmin(a, fa, fpa, b, fb, c, fc):
    """Minimizer of the cubic through ``(a, fa, fpa)``, ``(b, fb)`` and
    ``(c, fc)`` (jax's ``_cubicmin``; NaN where it has none)."""
    C = fpa
    db = b - a
    dc = c - a
    denom = (db * dc) ** 2 * (db - dc)
    d2_0 = fb - fa - C * db
    d2_1 = fc - fa - C * dc
    A = (dc ** 2 * d2_0 + (-db ** 2) * d2_1) / denom
    B = ((-dc ** 3) * d2_0 + db ** 3 * d2_1) / denom
    radical = B * B - 3.0 * A * C
    return a + (-B + torch.sqrt(radical)) / (3.0 * A)


def _quadmin(a, fa, fpa, b, fb):
    """Minimizer of the quadratic through ``(a, fa, fpa)`` and ``(b,
    fb)`` (jax's ``_quadmin``)."""
    db = b - a
    B = (fb - fa - fpa * db) / (db ** 2)
    return a - fpa / (2.0 * B)


class _Lanes:
    """Named per-lane tensors updated under masks."""

    def __init__(self, **fields):
        self.__dict__.update(fields)

    def put(self, mask, **vals):
        for name, v in vals.items():
            cur = getattr(self, name)
            m = mask.reshape(mask.shape + (1,) * (cur.ndim - mask.ndim))
            setattr(self, name, torch.where(m, v, cur))


def _bfgs_solve(evaluator_for, x0, max_iter, gtol, ls_maxiter,
                compact=True, stats=None):
    """One BFGS solve of every lane: ``(x, f, success, n_iter)``.

    Per lane the algorithm of ``jax.scipy.optimize.minimize(method=
    "BFGS")`` (jax's ``bfgs.py`` and ``line_search.py``): inverse-Hessian
    updates, the strong-Wolfe line search (c1 = 1e-4, c2 = 0.9, at most
    ``ls_maxiter`` bracketing steps, the cubic / quadratic / bisection
    zoom of at most 30 steps), its quirks kept — a failed zoom still
    moves the lane by its last step, and a line search that fails stops
    the lane with ``failed``.  Three of jax's line-search faults are not
    kept: its zoom reads the bracket's width as the signed ``a_hi -
    a_lo``, so a zoom on a reversed bracket fails at once (here the width
    is ``|a_hi - a_lo|``, in the failure test and the interpolation
    safeguards); a NaN trial value passes none of its tests (here, from a
    finite start, it counts as no decrease); and a failed zoom reports
    the value at its bracket's low end while the lane moves by the full
    step (here the lane evaluates the point it moves to, one more round,
    and reports that value, so ``f`` is always the objective at ``x``).
    Lanes advance in rounds: every round each
    running lane needs one value-and-gradient at its next trial step
    (bracketing or zoom), one call over the working lanes; so the calls
    are the most evaluations any lane needs.  With ``compact`` the
    running lanes are gathered out once at most half the working set is
    left.  ``success`` is
    ``converged & ~failed`` and ``n_iter`` the BFGS iterations, as jax
    reports them."""
    S, k = x0.shape
    dev, dt = x0.device, x0.dtype
    f32 = dt != torch.float64
    zthresh = 1e-5 if f32 else 1e-10
    eye = torch.eye(k, dtype=dt, device=dev)
    zf = torch.zeros((S,), dtype=dt, device=dev)
    zi = torch.zeros((S,), dtype=torch.int64, device=dev)
    zb = torch.zeros((S,), dtype=torch.bool, device=dev)
    f0, g0 = evaluator_for(None)(x0)
    calls = 1
    s = _Lanes(
        x=x0.clone(), f=f0, g=g0, H=eye.expand(S, k, k).clone(),
        oof=f0 + torch.linalg.vector_norm(g0, dim=-1) / 2,
        k=zi.clone(), converged=torch.abs(g0).amax(dim=-1) < gtol,
        failed=zb.clone(), ls_status=zi.clone(),
        phase=torch.full((S,), _FINISHED, dtype=torch.int64, device=dev),
        # the line search
        p=torch.zeros_like(x0), phi0=zf, dphi0=zf, start=zf, i=zi,
        a1=zf, phi1=zf, dphi1=zf, ast=zf, phist=zf, dphist=zf,
        gst=torch.zeros_like(x0), ls_done=zb, ls_failed=zb,
        # the bracketing trial a zoom is working from
        ai=zf, phii=zf, dphii=zf,
        # the zoom
        zdone=zb, zfailed=zb, zj=zi, alo=zf, philo=zf, dphilo=zf,
        ahi=zf, phihi=zf, dphihi=zf, arec=zf, phirec=zf, zast=zf,
        zphist=zf, zdphist=zf, zgst=torch.zeros_like(x0))

    def start_line_search(m):
        """jax's ``body_fun`` head and ``line_search`` setup on lanes
        ``m``: direction, start step, bracketing state."""
        p = -(s.H @ s.g[..., None])[..., 0]
        dphi0 = (s.g * p).sum(dim=-1)
        cand = 1.01 * 2 * (s.f - s.oof) / dphi0
        s.put(m, p=p, phi0=s.f, dphi0=dphi0,
              start=torch.where(cand > 1, torch.ones_like(cand), cand),
              i=torch.ones_like(s.i), a1=zf, phi1=s.f, dphi1=dphi0,
              ast=zf, phist=s.f, dphist=dphi0, gst=s.g, ls_done=zb,
              ls_failed=zb, phase=torch.full_like(s.phase, _BRACKET))

    def bfgs_cond():
        return ~s.converged & ~s.failed & (s.k < max_iter)

    def step_length():
        """The line search's step as jax's returns it: under float64 its
        a_star, else floored at 1e-8 in magnitude."""
        alpha = s.ast
        if f32:
            alpha = torch.where(torch.abs(alpha) < 1e-8,
                                torch.sign(alpha) * 1e-8, alpha)
        return alpha

    start_line_search(bfgs_cond())

    def wolfe_one(a, phi):          # the negation of the sufficient decrease
        return phi > s.phi0 + _C1 * a * s.dphi0

    def wolfe_two(dphi):
        return torch.abs(dphi) <= -_C2 * s.dphi0

    def end_bracket_step(m):
        """The bracketing loop's tail on lanes ``m``: advance the trial
        and, where the loop ends, finish the line search and the BFGS
        iteration, then start the next line search or stop the lane."""
        s.put(m, i=s.i + 1, a1=s.ai, phi1=s.phii, dphi1=s.dphii)
        more = m & ~s.ls_done & (s.i <= ls_maxiter) & ~s.ls_failed
        fin = m & ~more
        status = torch.where(s.ls_failed, torch.ones_like(s.i),
                             torch.where(s.i > ls_maxiter,
                                         torch.full_like(s.i, 3),
                                         torch.zeros_like(s.i)))
        step = step_length()[:, None] * s.p
        g_new = s.gst
        y = g_new - s.g
        rho = 1.0 / (y * step).sum(dim=-1)
        w = eye - rho[:, None, None] * (step[:, :, None] * y[:, None, :])
        H_new = w @ s.H @ w.transpose(-1, -2) \
            + rho[:, None, None] * (step[:, :, None] * step[:, None, :])
        H_new = torch.where(torch.isfinite(rho)[:, None, None], H_new, s.H)
        s.put(fin, failed=s.ls_failed | ~s.ls_done, ls_status=status,
              x=s.x + step, oof=s.f, f=s.phist, g=g_new, H=H_new,
              converged=torch.abs(g_new).amax(dim=-1) < gtol, k=s.k + 1)
        again = fin & bfgs_cond()
        start_line_search(again)
        s.put(fin & ~again, phase=torch.full_like(s.phase, _FINISHED))

    rounds = 0
    work = torch.arange(S, device=dev)
    ev = evaluator_for(None)
    while True:
        running = s.phase != _FINISHED
        n_run = int(running.sum())
        if n_run == 0:
            break
        if compact:
            work, moved = _compact(running, work, n_run)
            if moved:
                ev = evaluator_for(work)
        bracket = s.phase == _BRACKET
        zoom = s.phase == _ZOOM
        report = s.phase == _REPORT
        # the zoom body's head: its failure test and next trial step.  The
        # bracket's width is |a_hi - a_lo|: jax uses the signed difference,
        # so every zoom entered with a_hi < a_lo (each one a bracketing
        # trial with dphi >= 0 starts) fails at once
        lo = torch.minimum(s.ahi, s.alo)
        hi = torch.maximum(s.ahi, s.alo)
        width = hi - lo
        s.put(zoom, zfailed=s.zfailed | (width <= zthresh))
        a_cubic = _cubicmin(s.alo, s.philo, s.dphilo, s.ahi, s.phihi,
                            s.arec, s.phirec)
        use_cubic = (s.zj > 0) & (a_cubic > lo + _ZOOM_DELTA1 * width) \
            & (a_cubic < hi - _ZOOM_DELTA1 * width)
        a_quad = _quadmin(s.alo, s.philo, s.dphilo, s.ahi, s.phihi)
        use_quad = ~use_cubic & (a_quad > lo + _ZOOM_DELTA2 * width) \
            & (a_quad < hi - _ZOOM_DELTA2 * width)
        a_zoom = torch.where(use_cubic, a_cubic, s.arec)
        a_zoom = torch.where(use_quad, a_quad, a_zoom)
        a_zoom = torch.where(~use_cubic & ~use_quad, (s.alo + s.ahi) / 2.0,
                             a_zoom)
        a_bracket = torch.where(s.i == 1, s.start, s.a1 * 2.0)
        t = torch.where(zoom, a_zoom, torch.where(
            bracket, a_bracket, torch.where(report, step_length(), zf)))
        xt = s.x + t[:, None] * s.p
        fw, gw = ev(xt.index_select(0, work))
        calls += 1
        rounds += 1
        phi = torch.full((S,), float("nan"), dtype=dt, device=dev)
        g_t = torch.zeros_like(x0)
        phi[work] = fw.to(dt)
        g_t[work] = gw.to(dt)
        # the value a failed line search reports: the objective at the
        # point its lane moves to
        s.put(report, phist=phi)
        # from a finite start, a trial whose value is NaN (a recursion that
        # overflowed) counts as no decrease, so the search backs off from
        # it; jax's tests are all false on NaN and it doubles the step on
        # into the overflow
        phi = torch.where(torch.isnan(phi) & torch.isfinite(s.phi0),
                          float("inf"), phi)
        dphi = (g_t * s.p).sum(dim=-1)

        # -- bracketing lanes: jax's line_search body after its trial
        to_z1 = wolfe_one(t, phi) | ((phi >= s.phi1) & (s.i > 1))
        to_i = wolfe_two(dphi) & ~to_z1
        to_z2 = (dphi >= 0.0) & ~to_z1 & ~to_i
        b_i = bracket & to_i
        s.put(bracket, ai=t, phii=phi, dphii=dphi)
        s.put(b_i, ls_done=torch.ones_like(s.ls_done), ast=t, phist=phi,
              dphist=dphi, gst=g_t)
        z1, z2 = bracket & to_z1, bracket & to_z2
        zstart = z1 | z2
        s.put(z1, alo=s.a1, philo=s.phi1, dphilo=s.dphi1, ahi=t, phihi=phi,
              dphihi=dphi)
        s.put(z2, alo=t, philo=phi, dphilo=dphi, ahi=s.a1, phihi=s.phi1,
              dphihi=s.dphi1)
        s.put(zstart, arec=(s.alo + s.ahi) / 2.0,
              phirec=(s.philo + s.phihi) / 2.0,
              zast=torch.ones_like(zf), zphist=s.philo, zdphist=s.dphilo,
              zgst=s.g, zdone=zb, zfailed=zb, zj=zi,
              phase=torch.full_like(s.phase, _ZOOM))

        # -- zoom lanes: the zoom body after its trial
        hi_to_j = wolfe_one(t, phi) | (phi >= s.philo)
        star_to_j = wolfe_two(dphi) & ~hi_to_j
        hi_to_lo = (dphi * (s.ahi - s.alo) >= 0.0) & ~hi_to_j & ~star_to_j
        lo_to_j = ~hi_to_j & ~star_to_j
        s.put(zoom & hi_to_j, ahi=t, phihi=phi, dphihi=dphi, arec=s.ahi,
              phirec=s.phihi)
        s.put(zoom & star_to_j, zdone=torch.ones_like(s.zdone), zast=t,
              zphist=phi, zdphist=dphi, zgst=g_t)
        s.put(zoom & hi_to_lo, ahi=s.alo, phihi=s.philo, dphihi=s.dphilo,
              arec=s.ahi, phirec=s.phihi)
        s.put(zoom & lo_to_j & ~hi_to_lo, arec=s.alo, phirec=s.philo)
        s.put(zoom & lo_to_j, alo=t, philo=phi, dphilo=dphi)
        s.put(zoom, zj=s.zj + 1)
        s.put(zoom, zfailed=s.zfailed | (s.zj >= _ZOOM_MAX))
        zend = zoom & (s.zdone | s.zfailed)
        # a finished zoom ends the line search, successful or not; a
        # failed one first evaluates the point it returns (next round)
        s.put(zend, ls_done=torch.ones_like(s.ls_done),
              ls_failed=s.ls_failed | s.zfailed, ast=s.zast,
              phist=s.zphist, dphist=s.zdphist, gst=s.zgst)
        to_report = zend & s.zfailed
        s.put(to_report, phase=torch.full_like(s.phase, _REPORT))
        end_bracket_step((bracket & ~zstart) | (zend & ~to_report) | report)
    if stats is not None:
        stats.update(calls=calls, rounds=rounds)
    return s.x, s.f, s.converged & ~s.failed, s.k.to(torch.int32)


def minimize_bfgs(value_and_grad_fn: Callable, x0: torch.Tensor, *,
                  tol: float = 1e-8, max_iter: int = 200,
                  evaluator_for: Optional[Callable] = None,
                  restarts: int = 0, restart_scale: float = 0.25,
                  restart_seed: int = 0,
                  jitter_draws: Optional[torch.Tensor] = None,
                  stats: Optional[dict] = None) -> MinimizeResult:
    """Batched BFGS for smooth unconstrained objectives: per lane what the
    JAX package's ``minimize_bfgs`` runs, ``jax.scipy.optimize.minimize
    (method="BFGS", options={"maxiter": max_iter})`` (:func:`_bfgs_solve`).

    ``value_and_grad_fn(x (S, k)) -> (f (S,), g (S, k))`` evaluates the
    whole batch; ``evaluator_for(lanes)`` the same over the given lanes
    alone (gathered), which the loop calls once most lanes are done and
    the restarts call for their lanes (:func:`value_and_grad_of` builds
    both from a scalar objective).  ``tol`` is taken and dropped, as
    ``jax.scipy.optimize.minimize`` drops it for BFGS: every lane stops
    when the ∞-norm of its gradient falls under 1e-5, whatever ``tol``.

    ``restarts`` / ``restart_scale`` / ``restart_seed`` (or
    ``jitter_draws``) run the multi-start path of
    :func:`solve_with_restarts`.  ``stats`` receives ``solves``,
    ``restart_lanes`` and ``calls`` (value-and-grad calls over every
    attempt)."""
    del tol           # jax.scipy.optimize.minimize passes only options
    compact = evaluator_for is not None
    if restarts or _forced_failures():
        if not compact:
            raise ValueError(
                "the multi-start path re-solves gathered lanes: pass "
                "evaluator_for(lanes) -> value_and_grad_fn over them")
    calls = [0]

    def solve(xs, lanes):
        def ev_for(sub):
            if sub is None:
                return value_and_grad_fn if lanes is None \
                    else evaluator_for(lanes)
            return evaluator_for(sub if lanes is None
                                 else lanes.index_select(0, sub))
        st: dict = {}
        out = _bfgs_solve(ev_for, xs, max_iter, 1e-5, 10, compact, st)
        calls[0] += st["calls"]
        return out

    res = _solve_with_policy(solve, x0, restarts, restart_scale,
                             restart_seed, jitter_draws, stats)
    if stats is not None:
        stats["calls"] = calls[0]
    return res
