"""Streaming fit engine (counterpart of ``spark_timeseries_tpu/engine.py``).

:meth:`FitEngine.stream_fit` fits a panel larger than device memory in
chunks of ``chunk_size`` series — the JAX engine's chunk boundaries — and
isolates per-chunk failures (recorded in ``chunk_failures``, never
raised), except a kernel that does not build or launch and a card fault
(``_device.is_device_fault`` other than an allocation failure), which
raise.  On CUDA each host chunk is staged through a pinned buffer and
copied on a side stream while the previous chunk fits, so the copy of
chunk i+1 overlaps the fit of chunk i (``prefetch`` chunks staged ahead).
The tail chunk pads to its own :func:`series_bucket` like the JAX
engine's (zero lanes for a dense chunk, all-NaN lanes for a ragged one);
padding lanes quarantine themselves per lane and are sliced off.
:meth:`FitEngine.fit` fits one panel directly: eager PyTorch has no
compile cache for bucketing to serve (its ``bucket_obs`` is taken and
changes nothing), and keywords that are not one of the family's static
fit parameters (arima's ``user_init_params``) go to the family's own fit,
as the JAX engine's direct bypass sends them.

The resilient tier is here: :meth:`FitEngine.fit_resilient` pads the
series axis with all-NaN lanes, which health classification skips, and
``stream_fit(resilient=True)`` runs every chunk through the family's
fail-soft chain.

So is the JAX engine's durability tier (``utils.durability``), all on
the host: a crash-consistent chunk journal with validated resume
(``journal=``, ``job_meta=``; the spec also hashes the device type, since
a CPU chunk and a card chunk of one panel differ in their last bits), a
per-chunk deadline watchdog (``deadline_s=`` / ``STS_CHUNK_DEADLINE_S``),
end-of-stream quarantine retries with deterministic backoff (``retry=``
an int or a ``BackoffPolicy``; a ``utils.resilience.RetryPolicy`` keeps
its meaning of the fits' restarts), OOM-adaptive chunk halving
(``degrade=``, ``degrade_floor=``: a ``torch.cuda.OutOfMemoryError`` in a
chunk halves it), a ``telemetry.JobProgress`` per run (``on_progress=``,
``job_label=``) and flight-recorder incidents under ``STS_INCIDENT_DIR``.
What only XLA needs does not come across: the AOT executable cache, its
compile-cache directory and buffer donation; ``donate=`` and ``fused=``
are taken and change nothing (one publish path, no donation).
"""

from __future__ import annotations

import contextlib
import json
import os
import signal
import threading
import time
import traceback as _traceback
from collections import deque
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ._device import (as_tensor, check_dtype, is_device_fault,
                      resolve_device)
from .ops.ragged import ragged_view
from .utils import durability as _durability
from .utils import flightrec as _flightrec
from .utils import metrics as _metrics
from .utils import resilience as _resilience
from .utils import telemetry as _telemetry
from .utils.durability import (BackoffPolicy, ChunkDeadlineExceeded,
                               JournalSpecMismatch)

__all__ = ["SERIES_BUCKET_FLOOR", "OBS_BUCKET_MULTIPLE", "pad_bucket",
           "series_bucket", "FitEngine", "StreamResult", "default_engine",
           "RAGGED_FAMILIES", "BackoffPolicy", "ChunkDeadlineExceeded",
           "JournalSpecMismatch"]

SERIES_BUCKET_FLOOR = 8
OBS_BUCKET_MULTIPLE = 32


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
    method="css-lm", max_iter=None, retry=None, objective="css":
        (int(p), int(d), int(q), bool(include_intercept), str(method),
         max_iter, retry, str(objective)),
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


def _unknown_family(family: str) -> ValueError:
    return ValueError(f"unknown engine family {family!r}; expected one of "
                      f"{sorted(_STATICS_BUILDERS)}")


def _statics(family: str, kwargs) -> tuple:
    builder = _STATICS_BUILDERS.get(family)
    if builder is None:
        raise _unknown_family(family)
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
        p, d, q, icpt, method, max_iter, retry, objective = statics
        return arima.fit(p, d, q, values, include_intercept=icpt,
                         method=method, max_iter=max_iter, retry=retry,
                         warn=warn, n_valid=n_valid, objective=objective,
                         device=values.device, stats=stats)
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


def _numpy_to_tensors(obj):
    """A journal-restored model (array leaves as numpy) with its arrays
    as CPU tensors, the form ``collect`` hands back."""
    if isinstance(obj, np.ndarray):
        return torch.from_numpy(obj)
    if isinstance(obj, tuple) and hasattr(obj, "_fields"):
        return type(obj)(*(_numpy_to_tensors(v) for v in obj))
    if isinstance(obj, (tuple, list)):
        return type(obj)(_numpy_to_tensors(v) for v in obj)
    return obj


class _ChunkDataError(ValueError):
    """A chunk violates the data contract (NaN for a family without a
    ragged path, interior gaps): deterministic, so it is recorded, never
    retried."""


def _detach(e: BaseException) -> BaseException:
    """Keep ``e``'s traceback as text (``e.sts_traceback``) and drop its
    frames: a failed chunk's frames hold its tensors, and an OOM halving
    or a quarantine entry must not keep them alive."""
    if getattr(e, "sts_traceback", None) is None:
        tb = e.__traceback__
        e.sts_traceback = "".join(_traceback.format_exception(
            type(e), e, tb))
        if tb is not None:
            _traceback.clear_frames(tb)
        e.__traceback__ = None
    return e


def _failure_record(start: int, stop: int, bucket: int, e: Exception,
                    kind: str, attempts: int) -> Dict[str, Any]:
    """A ``chunk_failures`` entry: the row range, bucket, kind (``data``
    for a data-contract violation, ``deadline``, ``oom`` or ``error``),
    exception, truncated traceback and attempts."""
    tb = _detach(e).sts_traceback
    return {"chunk_start": int(start), "chunk_stop": int(stop),
            "n_series": int(stop - start), "bucket": int(bucket),
            "kind": kind, "error_type": type(e).__name__,
            "error": f"{type(e).__name__}: {e}",
            "traceback": tb[-2000:], "attempts": int(attempts)}


def _failure_kind(e: BaseException) -> str:
    if isinstance(e, _ChunkDataError):
        return "data"
    if isinstance(e, ChunkDeadlineExceeded):
        return "deadline"
    if _durability.is_oom(e):
        return "oom"
    return "error"


def _chunk_deadline(deadline_s: Optional[float]) -> Optional[float]:
    if deadline_s is None:
        env = os.environ.get("STS_CHUNK_DEADLINE_S")
        try:
            deadline = float(env) if env else None
        except ValueError:
            raise ValueError(
                f"STS_CHUNK_DEADLINE_S must be a number of seconds, "
                f"got {env!r}") from None
    else:
        deadline = float(deadline_s)
    return deadline if deadline is not None and deadline > 0 else None


class StreamResult(NamedTuple):
    """Outcome of one :meth:`FitEngine.stream_fit` pass.

    ``n_fitted`` counts the series whose chunks completed (``n_series``
    minus dead-chunk lanes); ``models`` is None unless ``collect=True``
    (then per-chunk host models in series order, padding lanes sliced
    off; a chunk halved under memory pressure contributes one model per
    sub-chunk, a journal-restored chunk one per committed entry).
    ``stats`` holds ``chunk_size``, per fitted arima chunk that runs the
    LM fit ``lm_iterations`` (the most iterations of a lane) and
    ``lm_fit_launches`` (launches of the LM-fit kernel: 1 on CUDA, 0 on
    the CPU), for holt_winters per fitted chunk ``box_iterations``,
    ``lane_evaluations`` and ``box_fit_launches`` (and on the CPU
    ``value_and_grad_calls``), for ewma, garch, argarch and egarch
    ``solver_iterations``; the durability counters ``journal_hits``,
    ``journal_commits``, ``journal_corrupt``, ``degraded_chunks``,
    ``quarantined``, ``retry_attempts``, ``recovered``, ``dead_chunks``,
    ``abandoned_workers`` and ``deadline_expired``; ``prefetch``,
    ``deadline_s``, ``retries``, ``job_id``, with a journal
    ``journal_path``, ``digest_s`` (hashing the panel) and ``commit_s``
    (the commits); ``collected_ranges`` with ``collect=True``,
    ``input_d2h_s`` (the seconds of the input's copy to the host: a
    tensor on a card) and ``device``."""
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


class _Slot:
    """One staging slot: a host buffer (pinned on CUDA), its device
    buffer, the event of the last copy into it and of the last work
    that read it."""
    __slots__ = ("host", "dev", "copied", "released")

    def __init__(self, host, dev, copied):
        self.host = host
        self.dev = dev
        self.copied = copied
        self.released = None


class _ChunkFeed:
    """``n_slots`` staging slots for host chunks.  On CUDA a slot is a
    pinned host buffer plus a device buffer filled on a side stream; the
    consumer's stream waits on the slot's copy event, and a slot is
    refilled only after the work that read it was enqueued.  On the CPU
    a slot is a plain host buffer.  A slot whose worker was abandoned by
    the deadline watchdog is retired (:meth:`retire`): it stays the
    worker's, and a fresh one takes its place."""

    def __init__(self, n_slots: int, rows: int, n_obs: int,
                 dtype: torch.dtype, device: torch.device):
        self.cuda = device.type == "cuda"
        self.shape = (rows, n_obs)
        self.dtype = dtype
        self.device = device
        self.stream = torch.cuda.Stream(device) if self.cuda else None
        self.slots = [self._new_slot() for _ in range(n_slots)]
        self._next = 0

    def _new_slot(self) -> _Slot:
        host = torch.empty(self.shape, dtype=self.dtype,
                           pin_memory=self.cuda)
        if not self.cuda:
            return _Slot(host, host, None)
        return _Slot(host, torch.empty(self.shape, dtype=self.dtype,
                                       device=self.device),
                     torch.cuda.Event())

    def put(self, part: np.ndarray) -> _Slot:
        """Stage ``part`` into the next slot in turn (its copy is
        asynchronous on CUDA); returns the slot."""
        slot = self.slots[self._next]
        self._next = (self._next + 1) % len(self.slots)
        rows = part.shape[0]
        if self.cuda:
            slot.copied.synchronize()  # the last copy out of this buffer
        slot.host[:rows].numpy()[...] = part
        if self.cuda:
            with torch.cuda.stream(self.stream):
                if slot.released is not None:
                    self.stream.wait_event(slot.released)
                slot.dev[:rows].copy_(slot.host[:rows], non_blocking=True)
                slot.copied.record(self.stream)
        return slot

    @staticmethod
    def take(slot: _Slot, rows: int) -> torch.Tensor:
        if slot.copied is not None:
            torch.cuda.current_stream().wait_event(slot.copied)
        return slot.dev[:rows]

    @staticmethod
    def release(slot: _Slot) -> None:
        if slot.copied is not None:
            ev = torch.cuda.Event()
            ev.record()
            slot.released = ev

    def retire(self, slot: _Slot) -> None:
        """Leave ``slot`` to the abandoned worker that holds it."""
        for i, s in enumerate(self.slots):
            if s is slot:
                self.slots[i] = self._new_slot()


class FitEngine:
    """Batched fits of whole panels (:meth:`fit`) and streamed chunked
    fits of panels larger than device memory (:meth:`stream_fit`).

    ``registry`` is the metrics registry the engine's counters land in
    (default the process registry); ``prefetch`` how many chunks
    :meth:`stream_fit` stages ahead of the one fitting (1: the double
    buffer); ``donate`` is the JAX engine's buffer-donation switch,
    taken and inert (no executable to donate to)."""

    def __init__(self, *, registry: Optional[Any] = None,
                 prefetch: int = 1, donate: Optional[bool] = None):
        self._reg = registry if registry is not None \
            else _metrics.get_registry()
        self.prefetch = max(1, int(prefetch))
        self._donate = donate

    def fit(self, values, family: str = "arima", *, bucket_obs: bool = True,
            device=None, warn: bool = False, **kwargs):
        """Fit one ``(n_series, n_obs)`` panel on ``device`` (``None`` means
        CUDA).  ``kwargs`` are the family's fit parameters (arima:
        ``p``/``d``/``q``/``include_intercept``/``method``/``max_iter``/
        ``retry``/``objective``; ar: ``max_lag``/``no_intercept``;
        holt_winters: ``period``/``model_type``; ewma, garch, argarch and
        egarch take none).  NaN-padded lanes of arima and ar fit their
        valid windows (holt_winters left-aligns its own); NaN inside a
        window raises.

        ``bucket_obs`` is the JAX engine's (whether to pad the observation
        axis to its bucket); the port fits every panel at its own shape,
        so it changes nothing.  As the JAX engine's direct bypass does,
        a panel that is not 2-D, or keywords the family's statics builder
        rejects (arima's ``user_init_params``), go to the family's own fit
        (:meth:`_direct`); a family the engine does not fit raises
        ``ValueError``."""
        del bucket_obs
        dev = resolve_device(device)
        v = as_tensor(values, dev)
        builder = _STATICS_BUILDERS.get(family)
        if builder is None or v.ndim != 2:
            return self._direct(v, family, warn, kwargs)
        try:
            statics = builder(**kwargs)
        except TypeError:
            return self._direct(v, family, warn, kwargs)
        return _fit_values(family, statics, v, warn)

    @staticmethod
    def _direct(values: torch.Tensor, family: str, warn: bool, kwargs):
        """The family's own fit of ``values`` (on their device) with the
        keywords as given: the JAX engine's bypass."""
        from .models import arima, autoregression, ewma, garch, holt_winters

        dev = values.device
        if family == "arima":
            kw = dict(kwargs)
            p, d, q = kw.pop("p", 2), kw.pop("d", 1), kw.pop("q", 2)
            return arima.fit(p, d, q, values, warn=warn, device=dev, **kw)
        if family == "ar":
            return autoregression.fit(values, **kwargs)
        table = {"ewma": ewma.fit, "garch": garch.fit,
                 "argarch": garch.fit_ar_garch, "egarch": garch.fit_egarch,
                 "holt_winters": holt_winters.fit}
        if family not in table:
            raise _unknown_family(family)
        return table[family](values, device=dev, **kwargs)

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

    def stream_fit(self, values, family: str = "arima", *,
                   chunk_size: int = 131072,
                   prefetch: Optional[int] = None,
                   donate: Optional[bool] = None,
                   collect: bool = False,
                   journal: Optional[str] = None,
                   job_meta: Optional[Dict[str, Any]] = None,
                   deadline_s: Optional[float] = None,
                   retry=None,
                   degrade: bool = True,
                   degrade_floor: Optional[int] = None,
                   resilient: bool = False,
                   fused: Optional[bool] = None,
                   on_progress: Optional[Callable[[Any], None]] = None,
                   job_label: Optional[str] = None,
                   device=None, **kwargs) -> StreamResult:
        """Fit a panel ``(n_series, n_obs)`` in chunks on ``device``
        (``None`` means CUDA).  ``values`` is an array or a tensor;
        chunks are staged from the host, so a tensor on a card is first
        copied to the host once (its seconds in ``stats["input_d2h_s"]``,
        not in ``wall_s``).  ``prefetch`` chunks are staged ahead of the
        one fitting (default the engine's).

        Each chunk's fit is isolated: a chunk that raises (or violates
        the data contract) lands in ``chunk_failures`` with its row
        range, bucket, kind, exception type, a truncated traceback and
        its attempts, and the stream goes on; a kernel or card fault
        other than an allocation failure raises.  ``n_converged`` counts
        converged real lanes; ``wall_s`` covers staging through the last
        chunk's results on the host.

        Durability tier (the JAX engine's, host-side):

        - ``journal=path``: every completed chunk's host model commits
          atomically (:class:`~spark_timeseries_tpu_torch.utils.
          durability.ChunkJournal`: payload tmp+rename, then the ``.ok``
          marker as the commit point); a rerun with the same path
          restores committed chunks through a validated load
          (``journal_hits``) and fits only the rest, bitwise the
          uninterrupted run.  The journal's spec hashes the family, its
          statics, the dtype, the device type, the bucket policy, the
          chunk partition, the panel's bytes and ``job_meta`` (any
          JSON-serializable dict); another spec raises
          :class:`JournalSpecMismatch`.  A corrupt entry moves to
          ``quarantine/`` and its chunk refits.
        - ``deadline_s`` (default ``STS_CHUNK_DEADLINE_S``, unset = off):
          each chunk's fit runs in a daemon worker thread (on the
          caller's CUDA stream) and the caller waits at most that long;
          on expiry the worker is abandoned with its staging slot, and
          the chunk fails with :class:`ChunkDeadlineExceeded`.
        - ``retry``: ``None`` (``STS_CHUNK_RETRIES``, default 0), an int
          or a :class:`BackoffPolicy` — failed chunks are retried at the
          end of the stream with deterministic backoff before they are
          declared dead (``dead_chunks``); a retry of a chunk whose
          abandoned worker still runs waits for it and, while it lives,
          consumes the attempt without a fit.  A
          ``utils.resilience.RetryPolicy`` is instead the fits'
          multi-start restart policy and passes to the family's fit.
        - ``degrade`` (default True): a chunk that runs out of device
          memory (``torch.cuda.OutOfMemoryError``, the ``oom_chunk``
          fault) is halved and each half fitted on its own, down to
          ``degrade_floor`` (default :data:`SERIES_BUCKET_FLOOR`) lanes
          (``degraded_chunks``); at the floor, or with ``degrade=False``,
          the OOM is a chunk failure.
        - ``on_progress`` receives the run's
          :class:`~spark_timeseries_tpu_torch.utils.telemetry.
          JobProgress` after every chunk (dropped after its first raise);
          ``job_label`` names the job.  With ``STS_INCIDENT_DIR`` set,
          chunk deaths, deadline expiries, OOM at the floor,
          ``kill_after_chunk`` and any exception escaping the call leave
          an incident bundle (``utils.flightrec``).
        - ``donate`` and ``fused`` are the JAX engine's, taken and inert.

        ``resilient=True`` runs every chunk through the family's
        fail-soft chain (:meth:`fit_resilient`: health masking, ``retry=
        RetryPolicy()`` restarts, the fallback stages and arima's
        ``auto_order=``, all passed through ``kwargs``), one chunk after
        the other, with the same durability scaffolding;
        ``n_converged`` then counts lanes whose status is ok / retried /
        fallback, ``stats["resilient_statuses"]`` the statuses,
        ``stats["resilient_attempts"]`` the attempts histogram, per
        chunk ``restart_lanes`` and, for arima, ``lm_fit_launches`` and
        ``lm_fit_launches_by_stage``, for holt_winters
        ``box_fit_launches`` and ``box_fit_launches_by_stage``."""
        del donate, fused
        if isinstance(retry, _resilience.RetryPolicy):
            kwargs["retry"] = retry
            retry = None
        if resilient:
            # the resilient tier's own (wider) family table; its kwargs
            # pass to the chain, so the journal spec hashes their reprs
            self.resilient_dispatch(family)
            statics = ("resilient",
                       tuple(sorted((k, repr(v))
                                    for k, v in kwargs.items())))
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
        check_dtype(torch.from_numpy(host[:0, :0]).dtype, dev)
        deadline = _chunk_deadline(deadline_s)
        policy = _durability.as_backoff(retry)
        if job_meta is not None:
            try:
                json.dumps(job_meta)
            except (TypeError, ValueError) as e:
                raise ValueError(
                    f"job_meta must be JSON-serializable (it is content-"
                    f"hashed into the journal spec): {e}") from None
        return _StreamRun(
            self, host, family, statics, kwargs, dev,
            chunk_size=chunk_size,
            depth=self.prefetch if prefetch is None
            else max(1, int(prefetch)),
            collect=collect, journal=journal, job_meta=job_meta,
            deadline=deadline, policy=policy, degrade=degrade,
            floor=SERIES_BUCKET_FLOOR if degrade_floor is None
            else max(1, int(degrade_floor)),
            resilient=resilient, on_progress=on_progress,
            job_label=job_label, input_d2h_s=input_d2h_s).run()


def _fatal(e: BaseException) -> bool:
    """A kernel or card fault that no isolation may hide (an allocation
    failure is not one: it halves the chunk or fails it)."""
    return is_device_fault(e) and not _durability.is_oom(e)


class _StreamRun:
    """One :meth:`FitEngine.stream_fit` pass: the chunk loop, the
    durability scaffolding around each chunk and the accounting."""

    def __init__(self, engine: FitEngine, host: np.ndarray, family: str,
                 statics: tuple, kwargs: Dict[str, Any],
                 dev: torch.device, *, chunk_size: int, depth: int,
                 collect: bool, journal: Optional[str],
                 job_meta: Optional[Dict[str, Any]],
                 deadline: Optional[float], policy: BackoffPolicy,
                 degrade: bool, floor: int, resilient: bool,
                 on_progress: Optional[Callable[[Any], None]],
                 job_label: Optional[str], input_d2h_s: float):
        self.eng = engine
        self.reg = engine._reg
        self.host = host
        self.family = family
        self.statics = statics
        self.kwargs = kwargs
        self.dev = dev
        self.n_series, self.n_obs = host.shape
        self.chunk = max(1, min(int(chunk_size), self.n_series))
        self.partition = [(s, min(s + self.chunk, self.n_series))
                          for s in range(0, self.n_series, self.chunk)]
        # OOM-halved sub-ranges must not count as whole chunks
        self.partition_set = set(self.partition)
        self.depth = depth
        self.collect = collect
        self.deadline = deadline
        self.policy = policy
        self.degrade = bool(degrade)
        self.floor = floor
        self.resilient = resilient
        self.on_progress = on_progress
        self.label = str(job_label) if job_label else family
        self.input_d2h_s = input_d2h_s
        # the caller's stream: a deadline worker thread enqueues there
        self.stream = torch.cuda.current_stream(dev) \
            if dev.type == "cuda" else None
        self.feed: Optional[_ChunkFeed] = None
        self.progress: Optional[_telemetry.JobProgress] = None

        self.jr = None
        self.digest_s = 0.0
        if journal:
            t0 = time.perf_counter()
            digest = _durability.array_digest(host)
            self.digest_s = time.perf_counter() - t0
            spec = {"format": 1, "family": family,
                    "statics": repr(statics),
                    "dtype": str(np.dtype(host.dtype)),
                    "device": dev.type,
                    "n_series": int(self.n_series),
                    "n_obs": int(self.n_obs),
                    "chunk_size": int(self.chunk),
                    "bucket_policy": [SERIES_BUCKET_FLOOR,
                                      OBS_BUCKET_MULTIPLE],
                    "data_sha256": digest}
            if job_meta is not None:
                spec["job"] = job_meta
            self.jr = _durability.ChunkJournal.open(journal, spec)
        # a journal commits each chunk's model, so it comes to the host
        self.keep_models = collect or self.jr is not None

        self.conv = 0
        self.dead_series = 0
        self.commit_s = 0.0
        self.failures: List[Dict[str, Any]] = []
        self.collected: Dict[int, Tuple[int, Any]] = {}
        self.quarantine: List[Dict[str, Any]] = []
        self.durex = {"journal_hits": 0, "journal_commits": 0,
                      "journal_corrupt": 0, "degraded_chunks": 0,
                      "quarantined": 0, "retry_attempts": 0,
                      "recovered": 0, "dead_chunks": 0,
                      "abandoned_workers": 0, "deadline_expired": 0}
        self.lm_iterations: List[int] = []
        self.lm_fit_launches: List[int] = []
        self.solver_iterations: List[int] = []
        self.hw_stats: Dict[str, List[int]] = {
            "box_iterations": [], "lane_evaluations": [],
            "box_fit_launches": []}
        if dev.type != "cuda":
            self.hw_stats["value_and_grad_calls"] = []
        self.res_statuses: Dict[str, int] = {}
        self.res_attempts: Dict[int, int] = {}
        self.res_launches: List[int] = []
        self.res_by_stage: List[Dict[str, int]] = []
        self.res_restart_lanes: List[Any] = []
        # the kernel whose launches each resilient chunk's chain counts
        self.kernel = {"arima": "lm_fit",
                       "holt_winters": "box_fit"}.get(family)
        # does an arima chunk run the LM loop (not the AR fast path)?
        self.lm_path = False
        if family == "arima" and not resilient:
            p, _, q, icpt = statics[:4]
            self.lm_path = not (p > 0 and q == 0) and p + q + icpt > 0

    # -- the run -------------------------------------------------------------

    def run(self) -> StreamResult:
        self.progress = _telemetry.JobProgress(
            _telemetry.new_job_id(self.label), self.label, self.n_series,
            len(self.partition), self.chunk,
            journal_path=self.jr.path if self.jr is not None else None,
            resilient=self.resilient)
        _telemetry.register_job(self.progress, self.reg)
        t0 = time.perf_counter()
        try:
            with _metrics.span("engine.stream", self.reg):
                if self.resilient:
                    self._loop_sync()
                else:
                    self._loop_staged()
                self._retry_quarantined()
            if self.dev.type == "cuda":
                torch.cuda.synchronize(self.dev)
        except BaseException as e:
            # chunk failures are isolated, so anything escaping is an
            # unmodeled failure: the flight recorder's bundle lands
            # before the caller sees it
            _flightrec.record_incident(
                "stream_exception", exc=e, job=self.progress,
                journal_path=self._jpath(), registry=self.reg)
            _telemetry.finish_job(self.progress, "failed",
                                  error=f"{type(e).__name__}: {e}",
                                  registry=self.reg)
            raise
        wall = time.perf_counter() - t0
        _telemetry.finish_job(self.progress, "done", registry=self.reg)
        return self._result(wall)

    def _jpath(self) -> Optional[str]:
        return self.jr.path if self.jr is not None else None

    def _loop_staged(self) -> None:
        """The pipelined loop: up to ``depth`` chunks staged (their copy
        in flight on the side stream) ahead of the one fitting; a chunk
        the journal restores takes no slot."""
        dtype = torch.from_numpy(self.host[:0, :0]).dtype
        self.feed = _ChunkFeed(self.depth + 1, self.chunk, self.n_obs,
                               dtype, self.dev)
        ahead: deque = deque()
        nxt = 0
        n = len(self.partition)
        for idx in range(n):
            while nxt < n and sum(isinstance(it, tuple) for it in ahead) \
                    <= self.depth:
                ahead.append(self._prepare(nxt))
                nxt += 1
            item = ahead.popleft()
            if item is None:                 # restored from the journal
                continue
            start, stop = self.partition[idx]
            if isinstance(item, Exception):
                self._route_failure(idx, start, stop, item)
                continue
            try:
                self._attempt(idx, start, stop, staged=item)
            except Exception as e:  # noqa: BLE001 — chunk isolation
                if _fatal(e):
                    raise
                self._route_failure(idx, start, stop, e)

    def _loop_sync(self) -> None:
        """The resilient loop: each chunk's chain in turn (the chain
        gathers and scatters on the host's orders, so there is no fit to
        overlap a copy with)."""
        for idx, (start, stop) in enumerate(self.partition):
            if self.jr is not None and self._resume(start, stop):
                continue
            try:
                self._run_sync(idx, start, stop)
            except Exception as e:  # noqa: BLE001 — chunk isolation
                if _fatal(e):
                    raise
                self._route_failure(idx, start, stop, e)

    def _prepare(self, idx: int):
        """Chunk ``idx`` ahead of its fit: None when the journal restores
        it, else ``(bucket, variant, slot)`` with its copy started, or
        the exception its staging raised."""
        start, stop = self.partition[idx]
        if self.jr is not None and self._resume(start, stop):
            return None
        try:
            part, bs, variant = self._prep(start, stop)
            return bs, variant, self.feed.put(part)
        except Exception as e:  # noqa: BLE001 — chunk isolation
            if _fatal(e):
                raise
            return e

    def _bucket(self, n_real: int) -> int:
        return self.chunk if n_real == self.chunk \
            else min(series_bucket(n_real), self.chunk)

    def _prep(self, start: int, stop: int):
        """Host-side prep of one row range: the data contract check and
        the tail's padding to its bucket."""
        part = self.host[start:stop]
        n_real = stop - start
        ragged = bool(np.isnan(part).any())
        if ragged and self.family not in RAGGED_FAMILIES:
            raise _ChunkDataError(
                f"NaN input needs a ragged engine path; family "
                f"{self.family!r} has none (only {RAGGED_FAMILIES})")
        if ragged:
            gaps = _interior_gap_count(part)
            if gaps:
                raise _ChunkDataError(
                    f"{gaps} lane(s) have NaN strictly inside their "
                    f"observed window; impute interior gaps first")
        bs = self._bucket(n_real)
        if bs != n_real:
            padded = np.full((bs, self.n_obs), np.nan if ragged else 0.0,
                             part.dtype)
            padded[:n_real] = part
            part = padded
        return part, bs, "ragged" if ragged else "dense"

    @contextlib.contextmanager
    def _on_stream(self):
        """The caller's device and stream (PyTorch's current stream is
        per thread, and a deadline worker is another thread)."""
        if self.stream is None:
            yield
            return
        with torch.cuda.device(self.dev), torch.cuda.stream(self.stream):
            yield

    def _with_deadline(self, fn: Callable[[threading.Event], Any],
                       stage: str, start: int, stop: int,
                       on_abandon: Optional[Callable[[], None]] = None):
        """Run ``fn(abandoned)`` under the watchdog: in a daemon thread
        the caller waits at most ``deadline`` seconds for.  On expiry the
        worker is abandoned (``abandoned`` set, ``on_abandon`` called,
        its eventual result discarded) and the chunk fails."""
        abandoned = threading.Event()
        if self.deadline is None:
            return fn(abandoned)
        box: Dict[str, Any] = {}
        done = threading.Event()

        def _run():
            try:
                box["value"] = fn(abandoned)
            except BaseException as e:  # noqa: BLE001 — relayed below
                box["error"] = e
            finally:
                done.set()

        worker = threading.Thread(target=_run, daemon=True,
                                  name=f"sts-chunk-{start}-{stage}")
        worker.start()
        if not done.wait(self.deadline):
            abandoned.set()
            if on_abandon is not None:
                on_abandon()
            self.durex["abandoned_workers"] += 1
            self.durex["deadline_expired"] += 1
            self.reg.inc("engine.deadline_expired")
            self.reg.inc("engine.abandoned_workers")
            _metrics.trace_instant(
                "engine.deadline_expired",
                {"chunk_start": int(start), "chunk_stop": int(stop),
                 "stage": stage, "deadline_s": self.deadline})
            err = ChunkDeadlineExceeded(
                f"chunk [{start}, {stop}) exceeded the {self.deadline:g}s "
                f"per-chunk deadline during {stage} (deadline_s= / "
                f"STS_CHUNK_DEADLINE_S); the worker thread is abandoned "
                f"and the stream continues")
            _flightrec.record_incident(
                "deadline_expired", exc=err, job=self.progress,
                journal_path=self._jpath(),
                extra={"chunk": [int(start), int(stop)], "stage": stage,
                       "deadline_s": self.deadline},
                registry=self.reg)
            # the retry loop gates on this: while the abandoned worker
            # lives it may still run kernels of this range
            err.worker = worker
            raise err
        if "error" in box:
            raise box["error"]
        return box["value"]

    # -- one attempt at a row range ------------------------------------------

    def _check_oom_fault(self, idx: int, start: int, stop: int) -> None:
        # fires at the full chunk size only, so its halves run clean
        if (start, stop) == self.partition[idx] \
                and _resilience.chunk_fault("oom_chunk", idx) is not None:
            raise _resilience.InjectedOOM(
                "RESOURCE_EXHAUSTED: injected oom_chunk fault")

    @staticmethod
    def _hang(idx: int, retrying: bool, abandoned: threading.Event) -> bool:
        """The ``hang_chunk`` fault at a chunk's first attempt (a retry
        runs clean); True when the worker was abandoned meanwhile and
        must not fit."""
        hang = None if retrying \
            else _resilience.chunk_fault("hang_chunk", idx)
        if hang is None:
            return False
        time.sleep(hang.hang_s)
        return abandoned.is_set()

    def _attempt(self, idx: int, start: int, stop: int, staged=None,
                 retrying: bool = False) -> None:
        """Fit exactly ``[start, stop)`` once and publish it; raises on
        failure.  ``staged`` is the ``(bucket, variant, slot)`` the
        pipelined loop prepared; without it the range is prepped and
        copied here."""
        n_real = stop - start
        if staged is None:
            part, bs, variant = self._prep(start, stop)
            slot = None
        else:
            bs, variant, slot = staged
        self._check_oom_fault(idx, start, stop)

        def work(abandoned):
            if self._hang(idx, retrying, abandoned):
                return None
            with self._on_stream():
                if slot is None:
                    values = torch.from_numpy(part).to(self.dev, copy=True)
                else:
                    values = self.feed.take(slot, bs)
                solver: Dict[str, Any] = {}
                try:
                    model = _fit_values(self.family, self.statics, values,
                                        stats=solver)
                finally:
                    # even a failed fit may have enqueued reads of the slot
                    if slot is not None:
                        self.feed.release(slot)
                diag = model.diagnostics
                # the chunk's one host sync: every count it reports
                reads = [diag.converged[:n_real].sum()]
                if self.lm_path or self.family == "holt_winters" \
                        or self.family in _SOLVER_FAMILIES:
                    reads.append(diag.n_iter.max().long())
                if self.family == "holt_winters":
                    reads.append(solver["evaluations"].sum())
                counts = torch.stack(reads).tolist()
                host_model = None
                if self.keep_models:
                    host_model = _map_tensors(
                        model, lambda t: (t[:n_real] if t.ndim >= 1
                                          and t.shape[0] == bs
                                          else t).cpu())
            return counts, solver, host_model

        self.progress.heartbeat("fit", chunk=(start, stop))
        retire = None if slot is None else (lambda: self.feed.retire(slot))
        counts, solver, model = self._with_deadline(work, "fit", start,
                                                    stop, retire)
        self.conv += counts[0]
        if self.lm_path:
            self.lm_iterations.append(counts[1])
            self.lm_fit_launches.append(solver.get("lm_fit_launches", 0))
        if self.family in _SOLVER_FAMILIES:
            self.solver_iterations.append(counts[1])
        if self.family == "holt_winters":
            self.hw_stats["box_iterations"].append(counts[1])
            self.hw_stats["lane_evaluations"].append(counts[2])
            self.hw_stats["box_fit_launches"].append(
                solver.get("box_fit_launches", 0))
            if "value_and_grad_calls" in self.hw_stats:
                self.hw_stats["value_and_grad_calls"].append(
                    solver["calls"])
        self._publish(idx, start, stop, model,
                      {"n_real": int(n_real), "n_conv": int(counts[0]),
                       "bucket": [int(bs), int(self.n_obs)],
                       "variant": variant})

    def _attempt_resilient(self, idx: int, start: int, stop: int,
                           retrying: bool = False) -> None:
        """One resilient chain over exactly ``[start, stop)``."""
        self._check_oom_fault(idx, start, stop)

        def work(abandoned):
            if self._hang(idx, retrying, abandoned):
                return None
            with self._on_stream():
                part = torch.from_numpy(self.host[start:stop]).to(self.dev)
                st: Dict[str, Any] = {}
                kw = dict(self.kwargs, stats=st) if self.kernel \
                    else self.kwargs
                model, outcome = self.eng.fit_resilient(
                    part, self.family, device=self.dev, **kw)
                if self.keep_models:
                    model = _map_tensors(model, lambda t: t.cpu())
            return model if self.keep_models else None, outcome, st

        self.progress.heartbeat("resilient_fit", chunk=(start, stop))
        model, outcome, st = self._with_deadline(work, "resilient_fit",
                                                 start, stop)
        ok = np.isin(outcome.status,
                     (_resilience.STATUS_OK, _resilience.STATUS_RETRIED,
                      _resilience.STATUS_FALLBACK))
        n_ok = int(ok.sum())
        self.conv += n_ok
        counts = outcome.counts()
        for name, count in counts.items():
            self.res_statuses[name] = self.res_statuses.get(name, 0) + count
        vals, hist = np.unique(outcome.attempts, return_counts=True)
        for a, c in zip(vals.tolist(), hist.tolist()):
            self.res_attempts[a] = self.res_attempts.get(a, 0) + c
        self.res_launches.append(st.get(f"{self.kernel}_launches", 0))
        self.res_by_stage.append(
            st.get(f"{self.kernel}_launches_by_stage", {}))
        self.res_restart_lanes.append(st.get("restart_lanes", []))
        self._publish(idx, start, stop, model,
                      {"n_real": int(stop - start), "n_conv": n_ok,
                       "resilient": True, "statuses": counts})

    def _publish(self, idx: int, start: int, stop: int, model,
                 meta: Dict[str, Any]) -> None:
        """A fitted range's journal commit (and the faults that act on
        it), collection and progress."""
        self.reg.inc("engine.chunks")
        if self.jr is not None:
            t0 = time.perf_counter()
            self.jr.commit(start, stop, model, meta)
            self.commit_s += time.perf_counter() - t0
            self.durex["journal_commits"] += 1
            self.reg.inc("engine.journal_commits")
            self.progress.note(journal_commits=1)
            full = (start, stop) == self.partition[idx]
            if full and _resilience.chunk_fault(
                    "kill_after_chunk", idx) is not None:
                # SIGKILL runs no handler: the bundle is written first
                _flightrec.record_incident(
                    "kill_after_chunk", job=self.progress,
                    journal_path=self._jpath(),
                    extra={"chunk": [int(start), int(stop)],
                           "chunk_index": int(idx),
                           "note": "injected SIGKILL after journal "
                                   "commit"},
                    registry=self.reg)
                os.kill(os.getpid(), signal.SIGKILL)
            if full and _resilience.chunk_fault(
                    "corrupt_journal", idx) is not None:
                self.jr.corrupt_entry(start, stop)
        if self.collect:
            self.collected[start] = (stop, model)
        if (start, stop) in self.partition_set:
            self.progress.note_chunk_done()
        else:
            self.progress.note(subchunks_done=1)
        self._publish_progress()

    def _publish_progress(self) -> None:
        """``engine.job.*`` gauges and the caller's ``on_progress``
        callback, dropped after its first raise: observability must
        never kill the stream it observes."""
        p = self.progress
        eta = p.eta_s
        self.reg.set_gauge("engine.job.chunks_done", p.chunks_done)
        self.reg.set_gauge("engine.job.chunks_total", p.n_chunks)
        self.reg.set_gauge("engine.job.chunks_failed", p.chunks_failed)
        self.reg.set_gauge("engine.job.eta_s",
                           eta if eta is not None else -1.0)
        if p.ew_chunk_s is not None:
            self.reg.set_gauge("engine.job.chunk_s_ew", p.ew_chunk_s)
        if self.on_progress is not None:
            try:
                self.on_progress(p)
            except Exception:  # noqa: BLE001 — see docstring
                self.on_progress = None
                self.reg.inc("engine.progress_cb_errors")

    # -- failure routing -----------------------------------------------------

    def _can_split(self, e: BaseException, start: int, stop: int) -> bool:
        return _durability.is_oom(e) and self.degrade \
            and (stop - start) > self.floor

    def _run_sync(self, idx: int, start: int, stop: int,
                  retrying: bool = False) -> None:
        """One synchronous attempt at exactly ``[start, stop)``; raises
        on failure.  An OOM that can still split degrades instead (each
        half then succeeds or routes itself), which counts as this
        attempt succeeding."""
        try:
            if self.resilient:
                self._attempt_resilient(idx, start, stop, retrying)
            else:
                self._attempt(idx, start, stop, retrying=retrying)
            return
        except Exception as e:  # noqa: BLE001 — classified below
            if not self._can_split(e, start, stop):
                raise
            # the failed attempt's frames hold its tensors
            _detach(e)
        self._split(idx, start, stop)

    def _split(self, idx: int, start: int, stop: int) -> None:
        """OOM degradation: halve the range and run each half."""
        self.durex["degraded_chunks"] += 1
        self.reg.inc("engine.degraded_chunks")
        self.progress.note(degraded=1)
        mid = start + (stop - start) // 2
        _metrics.trace_instant(
            "engine.degrade_split",
            {"chunk_start": int(start), "chunk_stop": int(stop),
             "mid": int(mid)})
        for a, b in ((start, mid), (mid, stop)):
            try:
                self._run_sync(idx, a, b)
            except Exception as e:  # noqa: BLE001 — chunk isolation
                if _fatal(e):
                    raise
                kind = _failure_kind(e)
                if kind == "data":
                    self._record_terminal(a, b, e, kind, 1)
                else:
                    self._quarantine(idx, a, b, e, kind)

    def _route_failure(self, idx: int, start: int, stop: int,
                       e: Exception) -> None:
        _detach(e)
        kind = _failure_kind(e)
        if kind == "data":
            self._record_terminal(start, stop, e, kind, 1)
        elif self._can_split(e, start, stop):
            self._split(idx, start, stop)
        else:
            self._quarantine(idx, start, stop, e, kind)

    def _quarantine(self, idx: int, start: int, stop: int, e: Exception,
                    kind: str) -> None:
        self.durex["quarantined"] += 1
        self.reg.inc("engine.quarantined")
        self.progress.note(quarantined=1)
        _metrics.trace_instant(
            "engine.quarantine",
            {"chunk_start": int(start), "chunk_stop": int(stop),
             "kind": kind, "error": type(e).__name__})
        if kind == "oom":
            # only an OOM that can no longer split gets here
            _flightrec.record_incident(
                "oom_at_floor", exc=e, job=self.progress,
                journal_path=self._jpath(),
                extra={"chunk": [int(start), int(stop)],
                       "degrade_floor": int(self.floor),
                       "degrade": self.degrade},
                registry=self.reg)
        self.quarantine.append({"idx": idx, "start": start, "stop": stop,
                                "error": _detach(e), "kind": kind})

    def _record_terminal(self, start: int, stop: int, e: Exception,
                         kind: str, attempts: int) -> None:
        """Declare one row range dead.  ``engine.dead_chunks`` counts
        quarantine exhaustion, not deterministic data rejections."""
        self.dead_series += stop - start
        record = _failure_record(start, stop, self._bucket(stop - start),
                                 e, kind, attempts)
        self.failures.append(record)
        self.reg.inc("engine.chunk_failures")
        if (start, stop) in self.partition_set:
            self.progress.note(failed=1)
        else:
            self.progress.note(subchunks_failed=1)
        if kind != "data":
            self.durex["dead_chunks"] += 1
            self.reg.inc("engine.dead_chunks")
            _flightrec.record_incident(
                "chunk_dead", exc=e, job=self.progress,
                journal_path=self._jpath(), extra={"failure": record},
                registry=self.reg)
        _metrics.trace_instant(
            "engine.chunk_failure",
            {"chunk_start": int(start), "chunk_stop": int(stop),
             "kind": kind, "error": type(e).__name__})
        self._publish_progress()

    def _retry_quarantined(self) -> None:
        """End-of-stream quarantine: bounded deterministic backoff
        retries, then the range is dead.  Index-based walk: a retry that
        halves under OOM can quarantine fresh sub-ranges, which get their
        own retries."""
        qi = 0
        while qi < len(self.quarantine):
            q = self.quarantine[qi]
            qi += 1
            recovered = False
            last_err = q["error"]
            attempts = 1
            for attempt in range(1, self.policy.max_retries + 1):
                delay = self.policy.delay(attempt)
                self.durex["retry_attempts"] += 1
                self.reg.inc("engine.retry_attempts")
                self.progress.heartbeat("retry",
                                        chunk=(q["start"], q["stop"]))
                _metrics.trace_instant(
                    "engine.retry_attempt",
                    {"chunk_start": int(q["start"]),
                     "chunk_stop": int(q["stop"]), "attempt": attempt,
                     "delay_s": delay})
                attempts += 1
                hung = getattr(last_err, "worker", None)
                if hung is not None and hung.is_alive():
                    # a deadline-abandoned worker may still run this
                    # range's fit: the backoff doubles as a grace join,
                    # and while it lives no duplicate fit races it
                    hung.join(delay)
                    if hung.is_alive():
                        continue
                elif delay > 0:
                    time.sleep(delay)
                try:
                    self._run_sync(q["idx"], q["start"], q["stop"],
                                   retrying=True)
                    recovered = True
                    break
                except Exception as e:  # noqa: BLE001 — retried
                    if _fatal(e):
                        raise
                    last_err = _detach(e)
            if recovered:
                self.durex["recovered"] += 1
                self.reg.inc("engine.quarantine_recovered")
            else:
                self._record_terminal(q["start"], q["stop"], last_err,
                                      _failure_kind(last_err), attempts)

    # -- resume --------------------------------------------------------------

    def _resume(self, start: int, stop: int) -> bool:
        """True when ``[start, stop)`` was fully committed by an earlier
        run and every entry restores cleanly; a corrupt entry is
        quarantined journal-side and the chunk refits."""
        cover = self.jr.covering(start, stop)
        if cover is None:
            return False
        loaded = []
        for meta in cover:
            try:
                model, pmeta = self.jr.load(meta)
            except Exception as e:  # noqa: BLE001 — any corruption
                # (CRC, a mismatched sidecar, garbled JSON): the entry
                # cannot be trusted, so it moves aside and the chunk refits
                self.jr.quarantine(meta)
                self.durex["journal_corrupt"] += 1
                self.reg.inc("engine.journal_corrupt")
                _metrics.trace_instant(
                    "engine.journal_corrupt",
                    {"chunk_start": int(meta.get("start", -1)),
                     "chunk_stop": int(meta.get("stop", -1)),
                     "error": type(e).__name__})
                return False
            loaded.append((pmeta, model))
        for pmeta, model in loaded:
            self.conv += int(pmeta.get("n_conv", 0))
            for name, count in (pmeta.get("statuses") or {}).items():
                self.res_statuses[name] = self.res_statuses.get(name, 0) \
                    + int(count)
            if self.collect:
                self.collected[int(pmeta["start"])] = (
                    int(pmeta["stop"]), _numpy_to_tensors(model))
        # one hit per restored CHUNK (a halved chunk's sub-entries are
        # still one chunk skipped)
        self.durex["journal_hits"] += 1
        self.reg.inc("engine.journal_hits")
        self.progress.note_chunk_done(restored=True)
        self._publish_progress()
        return True

    # -- the result ----------------------------------------------------------

    def _result(self, wall: float) -> StreamResult:
        stats: Dict[str, Any] = {
            "chunk_size": self.chunk, "prefetch": self.depth,
            "deadline_s": self.deadline,
            "retries": self.policy.max_retries,
            "job_id": self.progress.job_id, **self.durex}
        if self.resilient:
            stats.update(resilient=True,
                         resilient_statuses=dict(self.res_statuses),
                         resilient_attempts=dict(sorted(
                             self.res_attempts.items())),
                         restart_lanes=self.res_restart_lanes)
            if self.kernel:
                stats[f"{self.kernel}_launches"] = self.res_launches
                stats[f"{self.kernel}_launches_by_stage"] = \
                    self.res_by_stage
        else:
            stats.update(lm_iterations=self.lm_iterations,
                         lm_fit_launches=self.lm_fit_launches)
            if self.family == "holt_winters":
                stats.update(self.hw_stats)
            if self.family in _SOLVER_FAMILIES:
                stats["solver_iterations"] = self.solver_iterations
        if self.jr is not None:
            stats.update(journal_path=self.jr.path,
                         digest_s=self.digest_s, commit_s=self.commit_s)
        stats.update(input_d2h_s=self.input_d2h_s, device=str(self.dev))
        models = None
        if self.collect:
            keys = sorted(self.collected)
            models = [self.collected[k][1] for k in keys]
            stats["collected_ranges"] = [
                [int(k), int(self.collected[k][0])] for k in keys]
        return StreamResult(self.n_series,
                            max(self.n_series - self.dead_series, 0),
                            self.conv, wall, len(self.partition),
                            self.failures, models, stats)


# ---------------------------------------------------------------------------
# default engine
# ---------------------------------------------------------------------------

_default_engine: Optional[FitEngine] = None
_default_lock = threading.Lock()


def default_engine() -> FitEngine:
    """The process-wide engine (lazily created) that the entry points
    which are not handed one route through (``ServingSession.heal``)."""
    global _default_engine
    with _default_lock:
        if _default_engine is None:
            _default_engine = FitEngine()
        return _default_engine
