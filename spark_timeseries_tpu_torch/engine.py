"""Streaming fit engine (counterpart of ``spark_timeseries_tpu/engine.py``).

:meth:`FitEngine.stream_fit` fits a panel larger than device memory in
chunks of ``chunk_size`` series — the JAX engine's chunk boundaries — and
isolates per-chunk failures (recorded in ``chunk_failures``, never
raised), except a kernel that does not build or launch and a card out of
memory (``_device.is_device_fault``), which raise.  On CUDA each host chunk is staged through a pinned buffer and
copied on a side stream while the previous chunk fits, so the copy of
chunk i+1 overlaps the fit of chunk i.  The tail chunk pads to its own
:func:`series_bucket` like the JAX engine's (zero lanes for a dense
chunk, all-NaN lanes for a ragged one); padding lanes quarantine
themselves per lane and are sliced off.  :meth:`FitEngine.fit` fits one
panel directly: eager PyTorch has no compile cache for bucketing to
serve.

The resilient tier is here: :meth:`FitEngine.fit_resilient` pads the
series axis with all-NaN lanes, which health classification skips, and
``stream_fit(resilient=True)`` runs every chunk through the family's
fail-soft chain.

What only JAX needs does not come across: the AOT executable cache,
donation, the compile-cache directory, journals, deadlines, degradation
and telemetry.  Their ``stream_fit`` keywords raise
``NotImplementedError``.  ``retry`` here is a
``utils.resilience.RetryPolicy`` for the fits (the JAX engine's chunk
re-dispatch policy of the same name belongs to its durability tier).
"""

from __future__ import annotations

import time
import traceback as _traceback
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ._device import (as_tensor, check_dtype, is_device_fault,
                      resolve_device)
from .ops.ragged import ragged_view

__all__ = ["SERIES_BUCKET_FLOOR", "OBS_BUCKET_MULTIPLE", "pad_bucket",
           "series_bucket", "FitEngine", "StreamResult"]

SERIES_BUCKET_FLOOR = 8
OBS_BUCKET_MULTIPLE = 32

# stream_fit keywords of the JAX engine with no counterpart here
_NOT_PORTED = ("prefetch", "donate", "journal", "job_meta", "deadline_s",
               "degrade", "degrade_floor", "fused", "on_progress",
               "job_label")


def series_bucket(n_series: int) -> int:
    """Series-axis bucket: next power of two, floor 8."""
    s = SERIES_BUCKET_FLOOR
    while s < n_series:
        s *= 2
    return s


def pad_bucket(n_series: int, n_obs: int) -> Tuple[int, int]:
    """Canonical padded shape of a raw panel shape: series to the next
    power of two (floor 8), observations to the next multiple of 32
    (floor 32) — the JAX engine's bucket policy."""
    t = max(OBS_BUCKET_MULTIPLE,
            -(-n_obs // OBS_BUCKET_MULTIPLE) * OBS_BUCKET_MULTIPLE)
    return series_bucket(n_series), t


_STATICS_BUILDERS = {
    "arima": lambda p=2, d=1, q=2, include_intercept=True,
    method="css-lm", max_iter=None, retry=None:
        (int(p), int(d), int(q), bool(include_intercept), str(method),
         max_iter, retry),
    "ar": lambda max_lag=2, no_intercept=False:
        (int(max_lag), bool(no_intercept)),
    "ewma": lambda: (),
    "garch": lambda: (),
    "argarch": lambda: (),
    "egarch": lambda: (),
    "holt_winters": lambda period=12, model_type="additive":
        (int(period), str(model_type)),
}

# families fitted by an iterative solver whose per-lane iterations
# stream_fit reports as solver_iterations
_SOLVER_FAMILIES = ("ewma", "garch", "argarch", "egarch")

# families with a ragged engine path: a NaN chunk of any other family is a
# data failure in stream_fit, as in the JAX engine
RAGGED_FAMILIES = ("arima", "ar")


def _statics(family: str, kwargs) -> tuple:
    builder = _STATICS_BUILDERS.get(family)
    if builder is None:
        raise NotImplementedError(
            f"engine family {family!r} is not ported yet; the port fits "
            f"{sorted(_STATICS_BUILDERS)}")
    return builder(**kwargs)


def _fit_values(family: str, statics: tuple, values: torch.Tensor,
                warn: bool = False, stats: Optional[dict] = None):
    """One batched fit of ``values`` on its own device.  NaN-padded lanes
    are left-aligned and fitted against their valid windows; NaN inside a
    window raises.  ``stats`` receives the solver's counts."""
    from .models import arima, autoregression, ewma, garch, holt_winters

    if family == "holt_winters":
        # the direct fit left-aligns its ragged lanes itself
        period, model_type = statics
        return holt_winters.fit(values, period, model_type,
                                device=values.device, stats=stats)
    if family in _SOLVER_FAMILIES:
        fit_fn = {"ewma": ewma.fit, "garch": garch.fit,
                  "argarch": garch.fit_ar_garch,
                  "egarch": garch.fit_egarch}[family]
        return fit_fn(values, device=values.device, stats=stats)
    values, n_valid = ragged_view(values)

    if family == "arima":
        p, d, q, icpt, method, max_iter, retry = statics
        return arima.fit(p, d, q, values, include_intercept=icpt,
                         method=method, max_iter=max_iter, retry=retry,
                         warn=warn, n_valid=n_valid, device=values.device,
                         stats=stats)
    max_lag, no_icpt = statics
    return autoregression.fit(values, max_lag, no_intercept=no_icpt,
                              n_valid=n_valid)


def _interior_gap_count(host: np.ndarray) -> int:
    """Lanes with NaN strictly inside their observed window."""
    obs = ~np.isnan(host)
    n = host.shape[-1]
    any_obs = obs.any(axis=-1)
    start = obs.argmax(axis=-1)
    last = n - 1 - obs[:, ::-1].argmax(axis=-1)
    window = np.where(any_obs, last - start + 1, 0)
    return int(np.sum(obs.sum(axis=-1) != window))


def _map_tensors(obj, fn):
    """Apply ``fn`` to every tensor field of a (nested) NamedTuple."""
    if isinstance(obj, torch.Tensor):
        return fn(obj)
    if isinstance(obj, tuple) and hasattr(obj, "_fields"):
        return type(obj)(*(_map_tensors(v, fn) for v in obj))
    return obj


class _ChunkDataError(ValueError):
    """A chunk violates the data contract (interior gaps): deterministic,
    so it is recorded, never retried."""


def _failure_record(start: int, stop: int, bucket: int,
                    e: Exception) -> Dict[str, Any]:
    """A ``chunk_failures`` entry: the row range, bucket, kind (``data``
    for a data-contract violation), exception and truncated
    traceback."""
    tb = "".join(_traceback.format_exception(type(e), e, e.__traceback__))
    return {"chunk_start": int(start), "chunk_stop": int(stop),
            "n_series": int(stop - start), "bucket": int(bucket),
            "kind": "data" if isinstance(e, _ChunkDataError) else "error",
            "error_type": type(e).__name__,
            "error": f"{type(e).__name__}: {e}",
            "traceback": tb[-2000:], "attempts": 1}


class StreamResult(NamedTuple):
    """Outcome of one :meth:`FitEngine.stream_fit` pass.

    ``models`` is None unless ``collect=True`` (then per-chunk host models
    in series order, padding lanes sliced off).  ``stats`` holds
    ``chunk_size``, per fitted arima chunk that runs the LM fit
    ``lm_iterations`` (the most iterations of a lane) and
    ``lm_fit_launches`` (launches of the LM-fit kernel: 1 on CUDA, 0 on
    the CPU), for holt_winters per fitted chunk ``box_iterations`` (the
    chunk's most iterations of a lane), ``lane_evaluations`` (the value-and-grad passes
    its lanes needed, summed) and ``box_fit_launches`` (1 per chunk on
    CUDA, 0 on the CPU), and on the CPU ``value_and_grad_calls`` (the
    plain solver's calls; the card's fit makes none), for ewma, garch,
    argarch and egarch per fitted chunk ``solver_iterations`` (the
    chunk's most iterations of a lane), then ``collected_ranges`` with ``collect=True``, ``input_d2h_s`` (the
    seconds of the input's copy to the host: a tensor on a card) and
    ``device``."""
    n_series: int
    n_fitted: int
    n_converged: int
    wall_s: float
    n_chunks: int
    chunk_failures: List[Dict[str, Any]]
    models: Optional[List[Any]]
    stats: Dict[str, Any]

    @property
    def rate(self) -> float:
        """Fitted series per second (0 when nothing completed)."""
        return self.n_fitted / self.wall_s if self.wall_s > 0 else 0.0


class _ChunkFeed:
    """Two staging slots for host chunks.  On CUDA a slot is a pinned host
    buffer plus a device buffer filled on a side stream; the consumer's
    stream waits on the slot's copy event, and a slot is refilled only
    after the work that read it was enqueued.  On the CPU a slot is a
    plain host buffer."""

    def __init__(self, rows: int, n_obs: int, dtype: torch.dtype,
                 device: torch.device):
        self.cuda = device.type == "cuda"
        shape = (rows, n_obs)
        self.host = [torch.empty(shape, dtype=dtype, pin_memory=self.cuda)
                     for _ in range(2)]
        if self.cuda:
            self.dev = [torch.empty(shape, dtype=dtype, device=device)
                        for _ in range(2)]
            self.stream = torch.cuda.Stream(device)
            self.copied = [torch.cuda.Event() for _ in range(2)]
            self.released: List[Optional[torch.cuda.Event]] = [None, None]
        else:
            self.dev = self.host

    def put(self, slot: int, part: np.ndarray) -> None:
        rows = part.shape[0]
        if self.cuda:
            self.copied[slot].synchronize()  # last copy out of this buffer
        self.host[slot][:rows].numpy()[...] = part
        if self.cuda:
            with torch.cuda.stream(self.stream):
                if self.released[slot] is not None:
                    self.stream.wait_event(self.released[slot])
                self.dev[slot][:rows].copy_(self.host[slot][:rows],
                                            non_blocking=True)
                self.copied[slot].record(self.stream)

    def take(self, slot: int, rows: int) -> torch.Tensor:
        if self.cuda:
            torch.cuda.current_stream().wait_event(self.copied[slot])
        return self.dev[slot][:rows]

    def release(self, slot: int) -> None:
        if self.cuda:
            ev = torch.cuda.Event()
            ev.record()
            self.released[slot] = ev


class FitEngine:
    """Batched fits of whole panels (:meth:`fit`) and streamed chunked
    fits of panels larger than device memory (:meth:`stream_fit`)."""

    def fit(self, values, family: str = "arima", *, device=None,
            warn: bool = False, **kwargs):
        """Fit one ``(n_series, n_obs)`` panel on ``device`` (``None`` means
        CUDA).  ``kwargs`` are the family's fit parameters (arima:
        ``p``/``d``/``q``/``include_intercept``/``method``/``max_iter``/
        ``retry``; ar: ``max_lag``/``no_intercept``; holt_winters:
        ``period``/``model_type``; ewma, garch, argarch and egarch take
        none).  NaN-padded lanes of arima and ar fit their valid windows
        (holt_winters left-aligns its own); NaN inside a window raises."""
        statics = _statics(family, kwargs)
        dev = resolve_device(device)
        v = as_tensor(values, dev)
        if v.ndim != 2:
            raise ValueError(
                f"FitEngine.fit needs a (n_series, n_obs) panel, got "
                f"{tuple(v.shape)}")
        return _fit_values(family, statics, v, warn)

    # -- resilient tier (the Panel.fit_resilient front-end) -----------------

    @staticmethod
    def resilient_dispatch(family: str) -> Callable:
        """The family's ``fit_resilient`` (the direct, unbucketed
        chain)."""
        from .models import (arima, arimax, autoregression, autoregression_x,
                             ewma, garch, holt_winters, regression_arima)
        dispatch = {"arima": arima.fit_resilient,
                    "arimax": arimax.fit_resilient,
                    "ar": autoregression.fit_resilient,
                    "arx": autoregression_x.fit_resilient,
                    "ewma": ewma.fit_resilient,
                    "garch": garch.fit_resilient,
                    "argarch": garch.fit_ar_garch_resilient,
                    "egarch": garch.fit_egarch_resilient,
                    "holt_winters": holt_winters.fit_resilient,
                    "regression_arima": regression_arima.fit_resilient}
        if family not in dispatch:
            raise ValueError(f"unknown model family {family!r}; expected "
                             f"one of {sorted(dispatch)}")
        return dispatch[family]

    def fit_resilient(self, values, family: str, *args, device=None,
                      **kwargs):
        """Pad the series axis to its :func:`series_bucket` with all-NaN
        lanes, run the family's ``fit_resilient`` chain on ``device``
        (``None`` means CUDA), and slice the padding back off.  Padding
        lanes classify as unfittable, so every stage skips them: the real
        lanes are the unbucketed chain's results bit for bit.  Only the
        series axis pads: the exogenous families' shared ``(n_obs, k)``
        designs (``arimax``, ``arx``, ``regression_arima``, passed in
        ``args``) keep their rows.  Returns ``(model, FitOutcome)`` for
        the real lanes."""
        fit_fn = self.resilient_dispatch(family)
        dev = resolve_device(device)
        v = as_tensor(values, dev)
        if v.ndim != 2:
            return fit_fn(v, *args, device=dev, **kwargs)
        n_series, n_obs = v.shape
        bs = series_bucket(n_series)
        if bs == n_series:
            return fit_fn(v, *args, device=dev, **kwargs)
        padded = torch.full((bs, n_obs), float("nan"), dtype=v.dtype,
                            device=dev)
        padded[:n_series] = v
        model, outcome = fit_fn(padded, *args, device=dev, **kwargs)
        model = _map_tensors(model, lambda t: t[:n_series]
                             if t.ndim >= 1 and t.shape[0] == bs else t)
        outcome = type(outcome)(
            None if outcome.params is None else outcome.params[:n_series],
            outcome.status[:n_series], outcome.attempts[:n_series],
            outcome.fallback_used[:n_series], outcome.health[:n_series],
            None if outcome.orders is None
            else outcome.orders[:n_series])
        return model, outcome

    def _stream_resilient(self, host: np.ndarray, family: str,
                          chunk_size: int, collect: bool,
                          dev: torch.device, input_d2h_s: float,
                          kwargs) -> StreamResult:
        """``stream_fit(resilient=True)``: each chunk's fail-soft chain in
        turn (the chain gathers and scatters on the host's orders, so
        there is no fit to overlap a copy with)."""
        from .utils.resilience import (STATUS_FALLBACK, STATUS_OK,
                                       STATUS_RETRIED)
        check_dtype(torch.from_numpy(host[:0, :0]).dtype, dev)
        n_series = host.shape[0]
        chunk = max(1, min(int(chunk_size), n_series))
        partition = [(s, min(s + chunk, n_series))
                     for s in range(0, n_series, chunk)]
        conv = 0
        dead_series = 0
        failures: List[Dict[str, Any]] = []
        models: List[Any] = []
        ranges: List[List[int]] = []
        statuses: Dict[str, int] = {}
        attempts: Dict[int, int] = {}
        launches: List[int] = []
        by_stage: List[Dict[str, int]] = []
        restart_lanes: List[List[int]] = []
        # the kernel whose launches each chunk's chain counts
        kernel = {"arima": "lm_fit", "holt_winters": "box_fit"}.get(family)
        t0 = time.perf_counter()
        for start, stop in partition:
            try:
                part = torch.from_numpy(host[start:stop]).to(dev)
                st: Dict[str, Any] = {}
                kw = dict(kwargs, stats=st) if kernel else kwargs
                model, outcome = self.fit_resilient(part, family, device=dev,
                                                    **kw)
                ok = np.isin(outcome.status,
                             (STATUS_OK, STATUS_RETRIED, STATUS_FALLBACK))
                conv += int(ok.sum())
                for name, count in outcome.counts().items():
                    statuses[name] = statuses.get(name, 0) + count
                vals, counts = np.unique(outcome.attempts, return_counts=True)
                for a, c in zip(vals.tolist(), counts.tolist()):
                    attempts[a] = attempts.get(a, 0) + c
                launches.append(st.get(f"{kernel}_launches", 0))
                by_stage.append(st.get(f"{kernel}_launches_by_stage", {}))
                restart_lanes.append(st.get("restart_lanes", []))
                if collect:
                    models.append(_map_tensors(model, lambda t: t.cpu()))
                    ranges.append([start, stop])
            except Exception as e:  # noqa: BLE001 — chunk isolation
                if is_device_fault(e):
                    raise
                dead_series += stop - start
                failures.append(_failure_record(
                    start, stop, series_bucket(stop - start), e))
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        wall = time.perf_counter() - t0
        stats: Dict[str, Any] = {
            "chunk_size": chunk, "resilient": True,
            "resilient_statuses": statuses,
            "resilient_attempts": dict(sorted(attempts.items())),
            "restart_lanes": restart_lanes,
            "input_d2h_s": input_d2h_s, "device": str(dev)}
        if kernel:
            stats[f"{kernel}_launches"] = launches
            stats[f"{kernel}_launches_by_stage"] = by_stage
        if collect:
            stats["collected_ranges"] = ranges
        return StreamResult(n_series, max(n_series - dead_series, 0), conv,
                            wall, len(partition), failures,
                            models if collect else None, stats)

    def stream_fit(self, values, family: str = "arima", *,
                   chunk_size: int = 131072, collect: bool = False,
                   device=None, resilient: bool = False,
                   **kwargs) -> StreamResult:
        """Fit a panel ``(n_series, n_obs)`` in chunks on ``device``.
        ``values`` is an array or a tensor; chunks are staged from the
        host, so a tensor on a card is first copied to the host once
        (its seconds in ``stats["input_d2h_s"]``, not in ``wall_s``).

        Each chunk's fit is isolated: a chunk that raises (or violates the
        data contract) lands in ``chunk_failures`` with its row range,
        bucket, exception type and a truncated traceback, and the stream
        goes on; a kernel or card fault raises.  ``n_converged`` counts converged real lanes; ``wall_s``
        covers staging through the last chunk's results on the host.

        ``resilient=True`` runs every chunk through the family's fail-soft
        chain (:meth:`fit_resilient`: health masking, ``retry=``
        multi-start restarts, the fallback stages and arima's
        ``auto_order=``, all passed through ``kwargs``), one chunk after
        the other; ``n_converged`` then counts lanes whose status is
        ok / retried / fallback, ``stats["resilient_statuses"]`` the
        statuses, ``stats["resilient_attempts"]`` the attempts histogram,
        per chunk ``restart_lanes`` (the primary's restarts) and, for
        arima, ``lm_fit_launches`` (every stage's; on the CPU 0) and
        ``lm_fit_launches_by_stage``, for holt_winters ``box_fit_launches``
        and ``box_fit_launches_by_stage``."""
        not_ported = sorted(set(kwargs) & set(_NOT_PORTED))
        if not_ported:
            raise NotImplementedError(
                f"stream_fit keywords {not_ported} belong to the JAX "
                f"engine's durability and compile tiers, which the port "
                f"does not have")
        if resilient:
            self.resilient_dispatch(family)
        else:
            statics = _statics(family, kwargs)
        dev = resolve_device(device)
        t0 = time.perf_counter()
        # chunks are staged from the host: a tensor on a card comes to
        # the host once, as the JAX engine's np.asarray of a device array
        host = values.cpu().numpy() if isinstance(values, torch.Tensor) \
            else np.asarray(values)
        input_d2h_s = time.perf_counter() - t0
        if host.ndim != 2:
            raise ValueError(
                f"stream_fit needs a (n_series, n_obs) panel, got "
                f"{host.shape}")
        if resilient:
            return self._stream_resilient(host, family, chunk_size, collect,
                                          dev, input_d2h_s, kwargs)
        dtype = torch.from_numpy(host[:0, :0]).dtype
        check_dtype(dtype, dev)
        n_series, n_obs = host.shape
        chunk = max(1, min(int(chunk_size), n_series))
        partition = [(s, min(s + chunk, n_series))
                     for s in range(0, n_series, chunk)]

        def bucket(n_real: int) -> int:
            return chunk if n_real == chunk \
                else min(series_bucket(n_real), chunk)

        def stage(idx: int):
            """Host-side prep of chunk ``idx`` into its slot: the data
            contract check, tail padding, then the (async) copy."""
            start, stop = partition[idx]
            part = host[start:stop]
            n_real = stop - start
            ragged = bool(np.isnan(part).any())
            if ragged and family not in RAGGED_FAMILIES:
                raise _ChunkDataError(
                    f"NaN input needs a ragged engine path; family "
                    f"{family!r} has none (only {RAGGED_FAMILIES})")
            if ragged:
                gaps = _interior_gap_count(part)
                if gaps:
                    raise _ChunkDataError(
                        f"{gaps} lane(s) have NaN strictly inside their "
                        f"observed window; impute interior gaps first")
            bs = bucket(n_real)
            if bs != n_real:
                padded = np.full((bs, n_obs), np.nan if ragged else 0.0,
                                 part.dtype)
                padded[:n_real] = part
                part = padded
            feed.put(idx % 2, part)
            return bs

        conv = 0
        dead_series = 0
        failures: List[Dict[str, Any]] = []
        collected: Dict[int, Tuple[int, Any]] = {}
        lm_iterations: List[int] = []
        lm_fit_launches: List[int] = []
        solver_iterations: List[int] = []
        hw_stats: Dict[str, List[int]] = {
            "box_iterations": [], "lane_evaluations": [],
            "box_fit_launches": []}
        if dev.type != "cuda":
            hw_stats["value_and_grad_calls"] = []

        def record_failure(start: int, stop: int, e: Exception) -> None:
            nonlocal dead_series
            dead_series += stop - start
            failures.append(_failure_record(start, stop,
                                            bucket(stop - start), e))

        # does an arima chunk run the LM loop (not the AR fast path)?
        lm_path = False
        if family == "arima":
            p, _, q, icpt = statics[:4]
            lm_path = not (p > 0 and q == 0) and p + q + icpt > 0
        t0 = time.perf_counter()
        feed = _ChunkFeed(chunk, n_obs, dtype, dev)

        def try_stage(idx: int):
            try:
                return stage(idx)
            except Exception as e:  # noqa: BLE001 — chunk isolation
                if is_device_fault(e):
                    raise
                return e

        staged = try_stage(0)
        for idx, (start, stop) in enumerate(partition):
            cur = staged
            if idx + 1 < len(partition):
                staged = try_stage(idx + 1)
            if isinstance(cur, Exception):
                record_failure(start, stop, cur)
                continue
            bs = cur
            n_real = stop - start
            try:
                values_dev = feed.take(idx % 2, bs)
                solver: Dict[str, int] = {}
                try:
                    model = _fit_values(family, statics, values_dev,
                                        stats=solver)
                finally:
                    # even a failed fit may have enqueued reads of the slot
                    feed.release(idx % 2)
                diag = model.diagnostics
                # the chunk's one host sync: every count it reports
                reads = [diag.converged[:n_real].sum()]
                if lm_path or family == "holt_winters" \
                        or family in _SOLVER_FAMILIES:
                    reads.append(diag.n_iter.max().long())
                if family == "holt_winters":
                    reads.append(solver["evaluations"].sum())
                counts = torch.stack(reads).tolist()
                conv += counts[0]
                if lm_path:
                    lm_iterations.append(counts[1])
                    lm_fit_launches.append(solver.get("lm_fit_launches", 0))
                if family in _SOLVER_FAMILIES:
                    solver_iterations.append(counts[1])
                if family == "holt_winters":
                    hw_stats["box_iterations"].append(counts[1])
                    hw_stats["lane_evaluations"].append(counts[2])
                    hw_stats["box_fit_launches"].append(
                        solver.get("box_fit_launches", 0))
                    if "value_and_grad_calls" in hw_stats:
                        hw_stats["value_and_grad_calls"].append(
                            solver["calls"])
                if collect:
                    collected[start] = (stop, _map_tensors(
                        model, lambda t: (t[:n_real] if t.ndim >= 1
                                          and t.shape[0] == bs
                                          else t).cpu()))
            except Exception as e:  # noqa: BLE001 — chunk isolation
                if is_device_fault(e):
                    raise
                record_failure(start, stop, e)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        wall = time.perf_counter() - t0

        stats: Dict[str, Any] = {"chunk_size": chunk,
                                 "lm_iterations": lm_iterations,
                                 "lm_fit_launches": lm_fit_launches,
                                 "input_d2h_s": input_d2h_s,
                                 "device": str(dev)}
        if family == "holt_winters":
            stats.update(hw_stats)
        if family in _SOLVER_FAMILIES:
            stats["solver_iterations"] = solver_iterations
        models = None
        if collect:
            keys = sorted(collected)
            models = [collected[k][1] for k in keys]
            stats["collected_ranges"] = [[int(k), int(collected[k][0])]
                                         for k in keys]
        return StreamResult(n_series, max(n_series - dead_series, 0), conv,
                            wall, len(partition), failures, models, stats)
