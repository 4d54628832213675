"""Per-series failure isolation for batched fits (counterpart of
``spark_timeseries_tpu/utils/resilience.py``): health classification,
retry policies, fallback chains, and the fault injection that acts on
fits.

A batched fit has no per-series exception boundary: one all-NaN,
constant, too-short or diverging lane shares the launch with a million
healthy ones, so isolation is built from masks and per-lane status codes.

- **health classification** (:func:`classify_series`): one vectorized
  pass on the panel's device labels every lane ok / all-NaN / constant /
  too-short / has-inf / interior-gap before any optimizer runs;
  unfittable lanes are skipped with a status, never raised on;
- **multi-start retry** (:class:`RetryPolicy`, consumed by the solvers'
  restart loop ``ops.optimize.solve_with_restarts``): lanes that did
  not converge re-solve from jittered starts, gathered, one solve over
  the failing lanes per attempt; the per-lane attempt count comes back
  in ``diagnostics.attempts``.  The jitter is drawn from a
  ``torch.Generator`` seeded with ``RetryPolicy.seed``, so one seed
  gives other restart points than the JAX package's per-lane keys;
- **fallback chains** (:func:`resilient_fit`, surfaced per family as
  ``fit_resilient`` and on ``Panel.fit_resilient``): progressively
  simpler fits run only on the still-failing lanes, gathered and
  scattered on the device.  A stage that fails on a kernel or on the
  card (``_device.is_device_fault``: a kernel that does not build or
  launch, the card out of memory) is not isolated: it raises, so no
  fallback stands in for the device.

The panel, the classification, the gathers and scatters stay on the
panel's device; :class:`FitOutcome`'s fields are host numpy, as in the
JAX package.  Dispositions are counted under ``resilience.*`` in
``utils.metrics``.

:func:`fault_injection` corrupts inputs, forces optimizer
non-convergence, or corrupts a serving session's ticks and state
(:func:`serving_fault`).  The engine and fleet fault hooks and the
``STS_FAULT_INJECT`` environment arm wait for their slices and raise
``NotImplementedError``.
"""

from __future__ import annotations

import contextlib
import itertools
import os
from typing import (Any, Callable, Dict, List, NamedTuple, Optional,
                    Sequence, Tuple)

import numpy as np
import torch

from . import metrics as _metrics
from .._device import is_device_fault

__all__ = [
    "HEALTH_OK", "HEALTH_ALL_NAN", "HEALTH_CONSTANT", "HEALTH_TOO_SHORT",
    "HEALTH_HAS_INF", "HEALTH_INTERIOR_GAP", "HEALTH_NAMES",
    "STATUS_OK", "STATUS_RETRIED", "STATUS_FALLBACK", "STATUS_SKIPPED",
    "STATUS_ABANDONED", "STATUS_NAMES",
    "classify_series", "unfittable_mask",
    "FitOutcome", "RetryPolicy", "retry_kwargs", "override_kwargs",
    "StageResult", "FaultSpec", "InjectedOOM", "InjectedPumpCrash",
    "fault_injection", "fault_scope_token", "fault_spec", "chunk_fault",
    "serving_fault", "fleet_fault", "forced_optimizer_failures",
    "corrupt_values", "resilient_fit",
]

# ---------------------------------------------------------------------------
# health classification
# ---------------------------------------------------------------------------

HEALTH_OK = 0            # contiguous finite window, long enough, non-constant
HEALTH_ALL_NAN = 1       # no finite observation at all
HEALTH_CONSTANT = 2      # finite but a single repeated value (fittable by a
#                          mean/drift fallback; degenerate for most solvers)
HEALTH_TOO_SHORT = 3     # valid window shorter than the fit's requirement
HEALTH_HAS_INF = 4       # an infinity anywhere: bad data, never padding
HEALTH_INTERIOR_GAP = 5  # NaN strictly inside the observed window

HEALTH_NAMES = {
    HEALTH_OK: "ok", HEALTH_ALL_NAN: "all_nan",
    HEALTH_CONSTANT: "constant", HEALTH_TOO_SHORT: "too_short",
    HEALTH_HAS_INF: "has_inf", HEALTH_INTERIOR_GAP: "interior_gap",
}

# health codes no fit stage can do anything with: skipped up front.
# CONSTANT is not here: a constant lane fits a mean/drift fallback.
_UNFITTABLE = (HEALTH_ALL_NAN, HEALTH_TOO_SHORT, HEALTH_HAS_INF,
               HEALTH_INTERIOR_GAP)


def classify_series(values, min_len: int = 3) -> torch.Tensor:
    """Per-lane health codes in one vectorized pass on the values'
    device: ``values (..., n)`` -> int32 ``(...)``.

    The valid window spans the first to the last non-NaN observation
    (leading/trailing NaN is padding, the ``ops.ragged`` convention);
    ``min_len`` is the fit's minimum window length.  Priority when
    several conditions hold: all-NaN > has-inf > interior-gap >
    too-short > constant > ok."""
    v = values if isinstance(values, torch.Tensor) \
        else torch.as_tensor(np.asarray(values))
    n = v.shape[-1]
    if n == 0:
        return torch.full(v.shape[:-1], HEALTH_TOO_SHORT, dtype=torch.int32,
                          device=v.device)
    finite = torch.isfinite(v)
    obs = ~torch.isnan(v)                         # inf counts as observed
    obs_i = obs.to(torch.uint8)
    n_obs = obs.sum(dim=-1)
    any_obs = n_obs > 0
    start = torch.argmax(obs_i, dim=-1)
    last = n - 1 - torch.argmax(obs_i.flip(-1), dim=-1)
    window = torch.where(any_obs, last - start + 1, torch.zeros_like(start))

    has_inf = torch.isinf(v).any(dim=-1)
    inf = torch.full((), float("inf"), dtype=v.dtype, device=v.device)
    vmax = torch.where(finite, v, -inf).amax(dim=-1)
    vmin = torch.where(finite, v, inf).amin(dim=-1)
    constant = any_obs & (vmax == vmin)

    status = torch.full(v.shape[:-1], HEALTH_OK, dtype=torch.int32,
                        device=v.device)

    def code(c):
        return torch.full((), c, dtype=torch.int32, device=v.device)

    status = torch.where(constant, code(HEALTH_CONSTANT), status)
    status = torch.where(window < min_len, code(HEALTH_TOO_SHORT), status)
    status = torch.where(n_obs != window, code(HEALTH_INTERIOR_GAP), status)
    status = torch.where(has_inf, code(HEALTH_HAS_INF), status)
    return torch.where(~any_obs, code(HEALTH_ALL_NAN), status)


def unfittable_mask(health) -> np.ndarray:
    """Boolean mask of lanes no fit stage can attempt (skipped with a
    status instead of poisoning the batch)."""
    if isinstance(health, torch.Tensor):
        health = health.cpu().numpy()
    return np.isin(np.asarray(health), _UNFITTABLE)


# ---------------------------------------------------------------------------
# outcome / policy structures
# ---------------------------------------------------------------------------

STATUS_OK = 0          # primary fit converged on the first attempt
STATUS_RETRIED = 1     # primary fit converged after >= 1 multi-start restart
STATUS_FALLBACK = 2    # a fallback stage produced the lane's parameters
STATUS_SKIPPED = 3     # unfittable (see classify_series); params are NaN
STATUS_ABANDONED = 4   # every stage failed; params are the best-effort
#                        primary result (quarantined init or cap-hit point)

STATUS_NAMES = {
    STATUS_OK: "ok", STATUS_RETRIED: "retried",
    STATUS_FALLBACK: "fallback", STATUS_SKIPPED: "skipped",
    STATUS_ABANDONED: "abandoned",
}


class FitOutcome(NamedTuple):
    """Per-series disposition of a resilient batched fit, host numpy.

    ``params (n_series, k)`` is the final flattened parameter view (every
    per-lane float field of the merged model, trailing dims flattened and
    concatenated; NaN for skipped lanes); ``status`` / ``health`` are the
    ``STATUS_*`` / ``HEALTH_*`` codes; ``attempts`` counts optimizer
    starts plus fallback stages run for the lane (0 for skipped);
    ``fallback_used`` is the index into the fit chain that produced the
    lane's parameters (-1 = the primary fit, or no stage at all).
    ``orders (n_series, 3)`` is the effective (p, d, q) of each lane's
    parameters for families with an order ((-1, -1, -1) where no stage
    produced the lane), else None."""
    params: Optional[np.ndarray]
    status: np.ndarray
    attempts: np.ndarray
    fallback_used: np.ndarray
    health: np.ndarray
    orders: Optional[np.ndarray] = None

    def counts(self) -> Dict[str, int]:
        """``{status_name: lane count}`` (nonzero entries only)."""
        s = np.asarray(self.status)
        return {name: int(np.sum(s == code))
                for code, name in STATUS_NAMES.items()
                if int(np.sum(s == code))}


class StageResult(NamedTuple):
    """A fallback stage's rich return: the fitted model plus per-lane
    ``lane_orders (n_sub, 3)``, the (p, d, q) each gathered lane's
    parameters were selected at (the ``auto_order`` stage's contract;
    plain stages return the model and the chain's static order applies).
    Told apart by type: models are NamedTuples too."""
    model: Any
    lane_orders: Optional[np.ndarray] = None


class RetryPolicy(NamedTuple):
    """Multi-start retry settings, from ``fit_resilient`` down to the
    solvers.

    ``max_restarts`` extra solves from jittered starts for lanes whose
    first solve did not converge or went non-finite; ``perturb_scale``
    scales the Gaussian jitter (relative: ``scale * (1 + |x0|)``), drawn
    from a ``torch.Generator`` seeded with ``seed``; ``max_iter``
    overrides the fit's per-attempt iteration budget when set."""
    max_restarts: int = 2
    perturb_scale: float = 0.25
    seed: int = 0
    max_iter: Optional[int] = None


def retry_kwargs(retry: Optional[RetryPolicy]) -> Dict[str, Any]:
    """The ``restarts`` / ``restart_scale`` / ``restart_seed`` keywords a
    :class:`RetryPolicy` expands to for the ``ops.optimize`` solvers.
    Empty when ``retry`` is None or has no restart budget: a
    zero-restart policy leaves the single-start path untouched."""
    if retry is None or retry.max_restarts <= 0:
        return {}
    return {"restarts": int(retry.max_restarts),
            "restart_scale": float(retry.perturb_scale),
            "restart_seed": int(retry.seed)}


def override_kwargs(kwargs: Dict[str, Any], **pinned) -> Dict[str, Any]:
    """A fallback stage's pinned arguments over user pass-through kwargs
    (the pin wins)."""
    out = dict(kwargs)
    out.update(pinned)
    return out


# ---------------------------------------------------------------------------
# fault injection
# ---------------------------------------------------------------------------

class FaultSpec(NamedTuple):
    """One active fault.  The port acts on the modes that touch fits:

    - ``"force_nonconverge"``: every solver reports its first
      ``n_attempts`` solve attempts as non-converged (parameters intact);
    - ``"corrupt_nan"``: every ``lane_stride``-th lane of a resilient
      fit's input panel becomes all-NaN before classification;
    - ``"corrupt_inf"``: every ``lane_stride``-th lane gets one interior
      ``inf`` observation.

    Serving-tier modes, read host-side by
    ``statespace.serving.ServingSession.update`` through
    :func:`serving_fault`:

    - ``"tick_corrupt_nan"``: every ``lane_stride``-th lane's incoming
      tick becomes NaN (a dropped observation) for the scope's duration;
    - ``"tick_corrupt_inf"``: the same lanes get an ``inf`` tick, which
      the filter must degrade to a missed tick;
    - ``"state_poison"``: every ``lane_stride``-th lane's filter state
      mean is overwritten with a huge finite value once per scope per
      session, the diverged lane the health monitor must quarantine and
      ``heal()`` must recover.

    The JAX package's streaming-chunk and fleet modes are valid names
    here, but entering them raises ``NotImplementedError``."""
    mode: str
    n_attempts: int = 1
    lane_stride: int = 2
    chunk_index: int = 0
    hang_s: float = 3600.0


def _waits(what: str, item: str):
    raise NotImplementedError(
        f"{what} is not ported yet (ROADMAP Queue A item {item})")


class InjectedOOM(RuntimeError):
    """The ``oom_chunk`` fault's synthetic allocation failure: waits for
    the engine's durability tier."""

    def __init__(self, *args):
        _waits("InjectedOOM (the engine's oom_chunk fault)", "8")


class InjectedPumpCrash(RuntimeError):
    """The ``pump_crash`` fault's synthetic pump death: waits for the
    fleet runtime."""

    def __init__(self, *args):
        _waits("InjectedPumpCrash (the fleet runtime's pump_crash fault)",
               "7")


_FIT_MODES = ("force_nonconverge", "corrupt_nan", "corrupt_inf")
_SERVING_MODES = ("tick_corrupt_nan", "tick_corrupt_inf", "state_poison")
# the JAX package's other modes, with the ROADMAP item each waits for
_WAITING_MODES = {
    "hang_chunk": "8", "oom_chunk": "8", "kill_after_chunk": "8",
    "corrupt_journal": "8",
    "tenant_flood": "7", "coalesce_straggler": "7",
    "drop_tenant_process": "7", "pump_crash": "7", "pump_hang": "7",
    "checkpoint_torn": "7",
}
_active_fault: List[FaultSpec] = []
# one never-reused id per fault_injection scope entry (unlike id(spec),
# which a freed FaultSpec can hand to the next scope): what the
# once-per-scope consumers (state_poison) remember
_scope_serial = itertools.count(1)
_active_scope_tokens: List[int] = []


def fault_scope_token() -> Optional[int]:
    """Unique token of the innermost active :func:`fault_injection`
    scope (None outside any scope)."""
    return _active_scope_tokens[-1] if _active_scope_tokens else None


def fault_spec() -> Optional[FaultSpec]:
    """The innermost active fault, or None."""
    return _active_fault[-1] if _active_fault else None


def chunk_fault(mode: str, chunk_index: int):
    """The engine's streaming-chunk fault hook: waits for item 8."""
    _waits("chunk_fault (the engine's streaming-chunk faults)", "8")


def serving_fault(mode: str) -> Optional[FaultSpec]:
    """The active fault spec when it is a serving-tier fault of the given
    ``mode``, else None.  Read host-side by
    ``statespace.serving.ServingSession.update``."""
    if mode not in _SERVING_MODES:
        raise ValueError(
            f"unknown serving fault mode {mode!r}; expected one of "
            f"{_SERVING_MODES}")
    spec = fault_spec()
    if spec is not None and spec.mode == mode:
        return spec
    return None


def fleet_fault(mode: str):
    """The fleet tier's fault hook: waits for item 7."""
    _waits("fleet_fault (the fleet tier's faults)", "7")


def forced_optimizer_failures() -> int:
    """Attempts the solvers must report non-converged (0 when no
    ``force_nonconverge`` fault is active); read at call time."""
    spec = fault_spec()
    if spec is not None and spec.mode == "force_nonconverge":
        return int(spec.n_attempts)
    return 0


@contextlib.contextmanager
def fault_injection(mode: str, n_attempts: int = 1, lane_stride: int = 2,
                    chunk_index: int = 0, hang_s: float = 3600.0):
    """Inject one fault for the scope's duration (innermost wins)::

        with resilience.fault_injection("force_nonconverge"):
            model = arima.fit(2, 1, 2, panel,
                              retry=resilience.RetryPolicy())

    Eager PyTorch has no compiled executables to keep apart, so entering
    and leaving the scope flushes nothing."""
    if mode in _WAITING_MODES:
        _waits(f"fault mode {mode!r}", _WAITING_MODES[mode])
    if mode not in _FIT_MODES + _SERVING_MODES:
        raise ValueError(
            f"unknown fault mode {mode!r}; expected one of "
            f"{_FIT_MODES + _SERVING_MODES + tuple(_WAITING_MODES)}")
    if n_attempts < 1 or lane_stride < 1:
        raise ValueError("n_attempts and lane_stride must be >= 1")
    if chunk_index < 0 or hang_s <= 0:
        raise ValueError("chunk_index must be >= 0 and hang_s > 0")
    spec = FaultSpec(mode, int(n_attempts), int(lane_stride),
                     int(chunk_index), float(hang_s))
    _active_fault.append(spec)
    _active_scope_tokens.append(next(_scope_serial))
    try:
        yield spec
    finally:
        _active_fault.pop()
        _active_scope_tokens.pop()


def corrupt_values(values: torch.Tensor, spec: FaultSpec) -> torch.Tensor:
    """Apply a corruption-mode fault to a copy of the panel (every
    ``lane_stride``-th lane from lane 0); other modes return the input."""
    if spec.mode not in ("corrupt_nan", "corrupt_inf"):
        return values
    out = values.clone()
    lanes = torch.arange(out.shape[0], device=out.device) \
        % spec.lane_stride == 0
    if spec.mode == "corrupt_nan":
        out[lanes] = float("nan")
    else:
        out[lanes, out.shape[1] // 2] = float("inf")
    return out


# ---------------------------------------------------------------------------
# placeholder rows + lane surgery on model NamedTuples
# ---------------------------------------------------------------------------

def _placeholder_rows(n_obs: int, dtype) -> np.ndarray:
    """A benign stand-in series for unfittable lanes (their results are
    discarded and NaN-ed, but NaN inputs would trip the ragged-gap check
    and constants would singularize the shared OLS stages): the JAX
    package's deterministic standard-normal draws."""
    rng = np.random.default_rng(0)
    return rng.standard_normal(n_obs).astype(dtype, copy=False)


def _is_tuple(obj: Any) -> bool:
    return isinstance(obj, tuple) and hasattr(obj, "_fields")


def _tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """Map ``fn`` over the leaves of nested NamedTuples (None stays)."""
    if _is_tuple(tree):
        return type(tree)(*(_tree_map(fn, *leaves)
                            for leaves in zip(tree, *rest)))
    if tree is None:
        return None
    return fn(tree, *rest)


def _tree_leaves(tree: Any) -> List[Any]:
    if _is_tuple(tree):
        return [leaf for v in tree for leaf in _tree_leaves(v)]
    return [] if tree is None else [tree]


def _lane_leaf(leaf: Any, n: int) -> bool:
    return isinstance(leaf, torch.Tensor) and leaf.ndim >= 1 \
        and leaf.shape[0] == n


def _strip_attempts(model: Any):
    """``diagnostics.attempts`` -> None, so stages with and without
    multi-start retry share one layout (attempts are tracked by the chain
    and re-attached at the end)."""
    diag = getattr(model, "diagnostics", None)
    if diag is not None and getattr(diag, "attempts", None) is not None:
        return model._replace(diagnostics=diag._replace(attempts=None))
    return model


def _merge_lanes(model: Any, sub: Any, rows: torch.Tensor, n_series: int):
    """Scatter ``sub``'s per-lane fields (fitted on a gathered subset)
    into ``model`` at panel rows ``rows``; fields without a leading
    ``n_series`` dim (static orders, flags) come from ``model``."""
    def merge(orig, new):
        if not _lane_leaf(orig, n_series):
            return orig
        out = orig.clone()
        out[rows] = new[:rows.numel()].to(orig.dtype)
        return out

    return _tree_map(merge, model, sub)


def _nan_lanes(model: Any, rows: torch.Tensor, n_series: int):
    """NaN out the float fields of the given lanes (skipped series read
    as absent, not as placeholder fits)."""
    if rows.numel() == 0:
        return model

    def blank(leaf):
        if not (_lane_leaf(leaf, n_series) and leaf.is_floating_point()):
            return leaf
        out = leaf.clone()
        out[rows] = float("nan")
        return out

    return _tree_map(blank, model)


def _stack_params(model: Any, n_series: int) -> Optional[np.ndarray]:
    """Every per-lane float field (diagnostics excluded) flattened into
    one ``(n_series, k)`` host matrix for :class:`FitOutcome`."""
    core = model._replace(diagnostics=None) \
        if hasattr(model, "_replace") and hasattr(model, "diagnostics") \
        else model
    cols = [leaf.detach().cpu().numpy().reshape(n_series, -1)
            for leaf in _tree_leaves(core)
            if _lane_leaf(leaf, n_series) and leaf.is_floating_point()]
    return np.concatenate(cols, axis=1) if cols else None


def _host(t) -> np.ndarray:
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t)


# ---------------------------------------------------------------------------
# the chain
# ---------------------------------------------------------------------------

def resilient_fit(values, fits: Sequence[Tuple[str, Callable]], *,
                  min_len: int = 3, family: str = "model",
                  registry: Optional["_metrics.MetricsRegistry"] = None,
                  suspect_fn: Optional[Callable[[Any], np.ndarray]] = None
                  ) -> Tuple[Any, FitOutcome]:
    """Run a fallback chain of batched fits with per-lane failure
    isolation (the JAX package's ``resilient_fit``, on the panel's device).

    ``values (n_series, n)`` is the raw panel (a tensor, or an array the
    chain then holds on the CPU; NaN padding allowed); ``fits`` is the
    chain ``[(name, fit_fn), ...]``: every ``fit_fn(values) -> model``
    returns the same NamedTuple layout with a ``diagnostics.converged``
    entry per lane, or a :class:`StageResult` that also reports each
    lane's (p, d, q) (the ``auto_order`` stage).

    Flow: classify lane health on the device -> replace unfittable lanes
    by the placeholder row (their results are NaN-ed afterwards; healthy
    lanes are untouched, so their results are the plain fit's) -> run
    the primary fit -> for each fallback stage, gather the still-failing
    lanes (``index_select``), fit just those, and scatter back the lanes
    the stage converged.  A stage that raises is recorded and skipped.

    ``suspect_fn(base_model) -> bool (n_series,)`` flags lanes whose
    primary fit converged but plateaued: they are offered to the chain
    like failed lanes but keep their primary parameters and OK/RETRIED
    status unless an ``auto``-named stage converges them.

    Returns ``(model, outcome)``.  Counts land in the registry as
    ``resilience.<family>.*`` and ``resilience.*`` counters, with
    ``frac_recovered`` / ``frac_fallback`` / ``frac_abandoned`` gauges."""
    if not fits:
        raise ValueError("resilient_fit needs at least one fit stage")
    if os.environ.get("STS_FAULT_INJECT") == "1":
        _waits("the STS_FAULT_INJECT environment fault arm", "8")
    reg = registry if registry is not None else _metrics._default_registry
    v = values if isinstance(values, torch.Tensor) \
        else torch.as_tensor(np.asarray(values))
    if v.ndim != 2:
        raise ValueError(
            f"resilient_fit needs a (n_series, n) panel, got "
            f"{tuple(v.shape)}")
    n_series, n_obs = v.shape
    dev = v.device

    with _metrics.span(f"resilience.fit.{family}"):
        spec = fault_spec()
        if spec is not None:
            v = corrupt_values(v, spec)

        health = classify_series(v, min_len=min_len).cpu().numpy()
        skipped = unfittable_mask(health)
        safe = v
        if skipped.any():
            place = torch.as_tensor(
                _placeholder_rows(n_obs, _host(v[:0]).dtype), device=dev)
            safe = torch.where(torch.as_tensor(skipped, device=dev)[:, None],
                               place[None], v)

        errors: List[str] = []
        model = None
        base_idx = 0
        orders: Optional[np.ndarray] = None

        def _set_orders(rows_idx: np.ndarray, lane_orders) -> None:
            nonlocal orders
            if orders is None:
                orders = np.full((n_series, 3), -1, np.int32)
            orders[rows_idx] = np.asarray(lane_orders,
                                          np.int32)[:rows_idx.size]

        def _stage_error(name: str, e: Exception) -> None:
            errors.append(f"{name}: {type(e).__name__}: {e}")
            reg.inc(f"resilience.{family}.stage_errors")
            _metrics.trace_instant(f"resilience.{family}.stage_error",
                                   {"stage": name,
                                    "error": type(e).__name__})

        # the first stage that returns is the base model; earlier stages
        # that raise are recorded
        for i, (name, fn) in enumerate(fits):
            try:
                model = fn(safe)
                base_idx = i
                break
            except Exception as e:  # noqa: BLE001 — stage isolation
                if is_device_fault(e):
                    raise
                _stage_error(name, e)
        if model is None:
            raise RuntimeError(
                f"resilient_fit({family}): every fit stage raised — "
                + "; ".join(errors))
        if isinstance(model, StageResult):
            if model.lane_orders is not None:
                _set_orders(np.arange(n_series), model.lane_orders)
            model = model.model

        diag = getattr(model, "diagnostics", None)
        if diag is None:
            raise ValueError(
                f"resilient_fit({family}): stage {fits[base_idx][0]!r} "
                "returned a model without diagnostics")
        conv = _host(diag.converged).reshape(-1).astype(bool)
        d_att = getattr(diag, "attempts", None)
        attempts = (_host(d_att).reshape(-1).astype(np.int64)
                    if d_att is not None else np.ones(n_series, np.int64))
        model = _strip_attempts(model)

        status = np.full(n_series, STATUS_ABANDONED, np.int32)
        fallback_used = np.full(n_series, -1, np.int32)
        if base_idx == 0:
            status[conv & (attempts <= 1)] = STATUS_OK
            status[conv & (attempts > 1)] = STATUS_RETRIED
        else:
            status[conv] = STATUS_FALLBACK
            fallback_used[conv] = base_idx
        status[skipped] = STATUS_SKIPPED
        attempts[skipped] = 0

        suspect = np.zeros(n_series, bool)
        if suspect_fn is not None:
            try:
                suspect = np.asarray(suspect_fn(model)) \
                    .reshape(-1).astype(bool)
            except Exception as e:  # noqa: BLE001 — detection is advisory
                if is_device_fault(e):
                    raise
                errors.append(f"suspect_fn: {type(e).__name__}: {e}")
                reg.inc(f"resilience.{family}.stage_errors")
            suspect &= conv & ~skipped
            if suspect.any():
                reg.inc(f"resilience.{family}.suspect", int(suspect.sum()))
                _metrics.trace_instant(f"resilience.{family}.suspect",
                                       {"lanes": int(suspect.sum())})

        auto_seen = np.zeros(n_series, bool)
        pending = (~conv | suspect) & ~skipped
        for j in range(base_idx + 1, len(fits)):
            if not pending.any():
                break
            name, fn = fits[j]
            rows = np.flatnonzero(pending)
            rows_t = torch.as_tensor(rows, device=dev)
            _metrics.trace_instant(
                f"resilience.{family}.fallback",
                {"stage": name, "pending_lanes": int(rows.size)})
            try:
                sub = fn(safe.index_select(0, rows_t))
            except Exception as e:  # noqa: BLE001 — see above
                if is_device_fault(e):
                    raise
                _stage_error(name, e)
                if name.startswith("auto"):
                    # past the order search, suspect lanes keep their
                    # primary fit: simpler fallbacks never replace it
                    pending &= ~suspect
                continue
            sub_orders = None
            if isinstance(sub, StageResult):
                sub_orders = sub.lane_orders
                sub = sub.model
            if name.startswith("auto"):
                auto_seen[rows] = True
            sub_diag = getattr(sub, "diagnostics", None)
            if sub_diag is None:
                errors.append(f"{name}: returned model without diagnostics")
                reg.inc(f"resilience.{family}.stage_errors")
                continue
            sub_conv = _host(sub_diag.converged).reshape(-1).astype(bool)
            sub = _strip_attempts(sub)
            attempts[rows] += 1
            took = rows[sub_conv]
            if took.size:
                # scatter only the lanes this stage fixed
                idx = torch.as_tensor(np.flatnonzero(sub_conv), device=dev)
                n_sub = rows.size
                sub_took = _tree_map(
                    lambda leaf: leaf.index_select(0, idx)
                    if _lane_leaf(leaf, n_sub) else leaf, sub)
                model = _merge_lanes(model, sub_took,
                                     torch.as_tensor(took, device=dev),
                                     n_series)
                status[took] = STATUS_FALLBACK
                fallback_used[took] = j
                pending[took] = False
                if sub_orders is not None:
                    _set_orders(took, np.asarray(sub_orders)[sub_conv])
            if name.startswith("auto"):
                pending &= ~suspect

        model = _nan_lanes(model, torch.as_tensor(np.flatnonzero(skipped),
                                                  device=dev), n_series)

        ok_mask = np.isin(status,
                          (STATUS_OK, STATUS_RETRIED, STATUS_FALLBACK))
        diag = model.diagnostics
        mdev = diag.fun.device if isinstance(diag.fun, torch.Tensor) else dev
        fields = (torch.as_tensor(ok_mask, device=mdev), diag.n_iter,
                  diag.fun)
        if "attempts" in getattr(type(diag), "_fields", ()):
            fields += (torch.as_tensor(attempts, device=mdev),)
        model = model._replace(diagnostics=type(diag)(*fields))

        outcome = FitOutcome(_stack_params(model, n_series), status,
                             attempts, fallback_used, health, orders)

        if auto_seen.any():
            # auto-order lanes nothing rescued (suspect lanes that kept
            # their primary result still converged)
            n_auto_dead = int(np.sum(auto_seen
                                     & (status == STATUS_ABANDONED)))
            for prefix in (f"resilience.{family}", "resilience"):
                reg.inc(f"{prefix}.auto_fallback", int(auto_seen.sum()))
                if n_auto_dead:
                    reg.inc(f"{prefix}.auto_fallback_dead", n_auto_dead)
            if n_auto_dead:
                _metrics.trace_instant(
                    f"resilience.{family}.auto_fallback_dead",
                    {"lanes": n_auto_dead})

        n_skip = int(skipped.sum())
        n_retr = int(np.sum(status == STATUS_RETRIED))
        n_fb = int(np.sum(status == STATUS_FALLBACK))
        n_aband = int(np.sum(status == STATUS_ABANDONED))
        for prefix in (f"resilience.{family}", "resilience"):
            reg.inc(f"{prefix}.series", n_series)
            reg.inc(f"{prefix}.skipped", n_skip)
            reg.inc(f"{prefix}.retried", n_retr)
            reg.inc(f"{prefix}.fallback", n_fb)
            reg.inc(f"{prefix}.abandoned", n_aband)
        if n_series:
            reg.set_gauge(f"resilience.{family}.frac_recovered",
                          (n_retr + n_fb) / n_series)
            reg.set_gauge(f"resilience.{family}.frac_fallback",
                          n_fb / n_series)
            reg.set_gauge(f"resilience.{family}.frac_abandoned",
                          n_aband / n_series)
        return model, outcome
