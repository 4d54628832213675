"""The reference of the port's BFGS parity tests: ``jax.scipy.optimize``'s
BFGS with the three line-search faults that the port's ``minimize_bfgs``
does not copy taken out.

jax's strong-Wolfe line search (``jax/_src/scipy/optimize/
line_search.py``) has three faults the port parts from:

- its zoom reads the bracket's width as the signed ``a_hi - a_lo``, so
  every zoom entered with ``a_hi < a_lo`` fails at its first step (each
  zoom that a bracketing trial with ``dphi >= 0`` starts), and its
  interpolation safeguards would reach outside such a bracket;
- a NaN trial value passes none of its tests, so the bracketing doubles
  the step on into the region whose recursion overflowed;
- a failed zoom returns the step 1 with the value at its bracket's low
  end, so BFGS moves the lane by the full step and reports a value that
  is not the objective at the point it returns.

:func:`without_line_search_faults` rebuilds ``_zoom`` and ``line_search``
from jax's own source with those lines changed (the width
``|a_hi - a_lo|`` in the failure test and the safeguards; from a finite
start, a NaN value read as ``+inf``, no decrease; a failed line search's
value the objective at the step it returns) and puts
them in place for the duration of a ``with`` block, clearing jax's
compile caches on entry and exit so no trace of the other version is
reused.  Every other line of jax's BFGS runs unchanged, so the port is
held to it lane for lane."""

from __future__ import annotations

import contextlib
import inspect

import jax
from jax._src.scipy.optimize import bfgs as _bfgs
from jax._src.scipy.optimize import line_search as _ls

_EDITS = {
    "_zoom": [
        ("cchk = delta1 * dalpha", "cchk = delta1 * jnp.abs(dalpha)"),
        ("qchk = delta2 * dalpha", "qchk = delta2 * jnp.abs(dalpha)"),
        ("failed=state.failed | (dalpha <= threshold)",
         "failed=state.failed | (jnp.abs(dalpha) <= threshold)")],
    # phi_0 is the line search's start value; BFGS always passes it in
    # (old_fval), so it is bound before the first trial
    "line_search": [(
        "    phi, g = api.value_and_grad(f)(xk + t * pk)\n",
        "    phi, g = api.value_and_grad(f)(xk + t * pk)\n"
        "    phi = jnp.where(jnp.isnan(phi) & jnp.isfinite(phi_0), jnp.inf,"
        " phi)\n"), (
        # the objective at the point BFGS moves to, as f computes it
        "      f_k=state.phi_star,\n",
        "      f_k=jnp.where(state.failed, f(xk + alpha_k * pk),"
        " state.phi_star),\n")],
}


def _rebuilt(name: str):
    """jax's ``line_search.<name>`` compiled from its source with
    ``_EDITS[name]`` applied, its globals the module's own."""
    src = inspect.getsource(getattr(_ls, name))
    for old, new in _EDITS[name]:
        if src.count(old) != 1:
            raise RuntimeError(
                f"jax's line_search.{name} no longer holds {old.strip()!r}")
        src = src.replace(old, new)
    local: dict = {}
    exec(compile(src, _ls.__file__, "exec"), _ls.__dict__, local)
    return local[name]


@contextlib.contextmanager
def without_line_search_faults():
    """Run jax's BFGS with the port's line search inside the block."""
    zoom, search = _rebuilt("_zoom"), _rebuilt("line_search")
    saved = _ls._zoom, _ls.line_search, _bfgs.line_search
    jax.clear_caches()
    _ls._zoom, _ls.line_search, _bfgs.line_search = zoom, search, search
    try:
        yield
    finally:
        _ls._zoom, _ls.line_search, _bfgs.line_search = saved
        jax.clear_caches()
