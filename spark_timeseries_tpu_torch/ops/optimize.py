"""Batched solvers (counterpart of ``spark_timeseries_tpu/ops/optimize.py``).

Ported so far: the result type, and :func:`minimize_box`, the batched
projected gradient on a box that the Holt-Winters fit runs.  The ARIMA
fit's Levenberg-Marquardt solver is ``ops.arma_ne.fit_css_lm``.  The
multi-start ``restarts`` path (which fills the ``attempts`` field,
None until then) waits for the retry slice.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch


class MinimizeResult(NamedTuple):
    """Batched optimization artifacts (leading dims ``...`` = batch).

    ``attempts`` is the per-lane solve count of the multi-start retry
    path, which the port does not have yet: None on every path."""
    x: torch.Tensor          # (..., p) optimal parameters
    fun: torch.Tensor        # (...,)   objective at optimum
    converged: torch.Tensor  # (...,)   bool per-lane convergence mask
    n_iter: torch.Tensor     # (...,)   iterations taken
    attempts: Optional[torch.Tensor] = None  # (...,) multi-start solves


def _project(x: torch.Tensor, lower, upper) -> torch.Tensor:
    return torch.clamp(x, lower, upper)


def minimize_box(value_and_grad_fn: Callable, x0: torch.Tensor,
                 lower: float, upper: float, *, tol: float = 1e-10,
                 max_iter: int = 500, max_backtracks: int = 40,
                 trials_per_call: int = 1, restarts: int = 0,
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
    """
    if restarts:
        raise NotImplementedError(
            "restarts (the multi-start retry path) is not ported yet; it "
            "comes with the resilient-fit slice")
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
    return MinimizeResult(x, f, done, it_lanes)
