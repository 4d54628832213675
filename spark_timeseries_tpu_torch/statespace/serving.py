"""Online serving sessions: O(1) per-tick ingest and forecasts off warm
state (counterpart of ``spark_timeseries_tpu/statespace/serving.py``).

A :class:`ServingSession` holds each series' state-space filter state
(``statespace.ssm``: O(m²) numbers a series, in series-bucketed tensors
on the session's device) and makes ingest one health-monitored Kalman
step over the whole panel:

- :meth:`update`: one tick for every series, :func:`_update_impl` (the
  filter step, the lane health monitor of :mod:`.health` and, when
  ``quality=QualityPolicy()`` arms it, the forecast-quality step of
  :mod:`.quality`), eager PyTorch, no fit and no optimizer anywhere on
  the path.  The JAX package compiles this function once per
  ``update_key``; here there is nothing to compile, and :meth:`warmup`
  runs one tick whose result is thrown away so that the first tick's
  allocations and caches happen before traffic;
- :meth:`heal`: refit the quarantined (and, with ``drifted=True``,
  drift-flagged) lanes from the bounded per-lane history ring through
  ``engine.fit_resilient`` on the session's device (ARIMA: the LM-fit
  kernel, plus its grid mode when the auto-order stage runs; additive
  Holt-Winters: the box-fit kernel) and splice the re-bootstrapped lanes
  back in;
- :meth:`forecast`: h-step point forecasts off the filtered state;
- :meth:`checkpoint` / :meth:`restore`: the whole session through
  ``utils.checkpoint``, restore validating the geometry and raising
  :class:`ServingRestoreMismatch` with the differing fields.

Metrics (the JAX package's names): ``serving.sessions`` /
``serving.ticks`` / ``serving.updates`` / ``serving.forecasts`` /
``serving.diverged`` / ``serving.quarantined`` / ``serving.healed``
counters, ``serving.update`` / ``serving.forecast`` / ``serving.heal``
spans, the ``serving.state_bytes`` and ``serving.quarantined_lanes``
gauges and the per-session ``serving.session.<label>.*`` latency, SLO
and quality gauges.
"""

from __future__ import annotations

import itertools
import time
from collections import deque
from typing import Any, Dict, NamedTuple, Optional

import numpy as np
import torch

from .._device import as_tensor, is_device_fault, resolve_device
from ..engine import _map_tensors, default_engine, series_bucket
from ..utils import checkpoint as _checkpoint
from ..utils import metrics as _metrics
from ..utils import resilience as _resilience
from ..utils import telemetry as _telemetry
from .convert import Bootstrapped, bootstrap
from .health import (LANE_DIVERGED, LANE_DRIFTED, LANE_NAMES, LANE_OK,
                     HealthPolicy, LaneHealth, initial_health,
                     monitored_step)
from .kalman import forecast_mean
from .quality import (QualityPolicy, QualityState, forecast_half_widths,
                      initial_quality, naive_scale, quality_step)
from .ssm import FilterState, SSMeta, StateSpace, state_nbytes

__all__ = ["ServingSession", "TickResult", "start_session",
           "warmup_update", "WARMUP_FAMILIES", "ServingRestoreMismatch",
           "DEFAULT_HISTORY_RING", "TICK_LATENCY_WINDOW", "check_label"]

# format 2 = lane health + history ring + heal route; format-1
# checkpoints predate the health machinery and cannot be resumed
_CHECKPOINT_FORMAT = 2

# per-lane raw-tick history kept for heal() refits (a bounded ring)
DEFAULT_HISTORY_RING = 512

# the huge-but-finite state corruption the state_poison fault writes:
# representable in float32, at once far out of the χ² band
_POISON_VALUE = 1e30

# families warmup_update can build a state-space form for without a
# fitted model (the serving-capable engine families)
WARMUP_FAMILIES = ("arima", "ar", "arx", "ewma", "holt_winters")

# rolling per-session tick-latency window behind the
# serving.session.<label>.tick_p50_ms / tick_p95_ms gauges
TICK_LATENCY_WINDOW = 256

_session_seq = itertools.count(1)


def _serving_slo_ms() -> Optional[float]:
    """The per-tick latency SLO (``STS_SERVING_SLO_MS``, milliseconds);
    unset means no SLO accounting, junk raises a named error."""
    return _telemetry.env_positive("STS_SERVING_SLO_MS", float, None)


def check_label(label: str) -> str:
    """The label contract for serving-plane names: non-empty
    ``[A-Za-z0-9_-]`` (labels name metrics and checkpoint files)."""
    if not label or not all(ch.isalnum() or ch in "_-" for ch in label):
        raise ValueError(
            f"session label must be non-empty [A-Za-z0-9_-] (it names "
            f"the serving.session.<label>.* metrics), got {label!r}")
    return label


class ServingRestoreMismatch(ValueError):
    """A serving checkpoint disagrees with the restoring process' engine
    policy or with its own geometry (bucket size against
    ``engine.series_bucket``, ``SSMeta`` against the stored shapes)."""


class TickResult(NamedTuple):
    """One :meth:`ServingSession.update`'s per-series outcome (real lanes
    only, host numpy): the innovations ``v`` (NaN where the tick was
    missing or the lane is quarantined), their variances ``F``, the
    log-likelihood increment, the lane ``status`` (``health.LANE_*``),
    the signed standardized innovation ``anomaly = ν/√F`` and its EW
    aggregate ``anomaly_ew`` (the health band's EW mean of ``ν²/F``)."""
    innovations: np.ndarray
    variances: np.ndarray
    loglik_inc: np.ndarray
    status: np.ndarray
    anomaly: np.ndarray
    anomaly_ew: np.ndarray


# ---------------------------------------------------------------------------
# the tick and the forecast, as plain functions of tensors
# ---------------------------------------------------------------------------

def _update_impl(meta: SSMeta, policy: HealthPolicy,
                 quality: Optional[QualityPolicy], ssm: StateSpace,
                 state: FilterState, health: LaneHealth,
                 qstate: Optional[QualityState], y: torch.Tensor,
                 offset: torch.Tensor):
    """The whole per-tick program: one health-monitored Kalman step
    (``health.monitored_step``), the anomaly score, and, when
    ``quality`` is given, the forecast-quality step
    (``quality.quality_step``).  Pure: every operation is out of place.
    Returns ``(state', health', qstate', v, F, ll_inc, anomaly)``."""
    state2, health2, (v, f) = monitored_step(ssm, state, health, y, offset,
                                             meta, policy)
    ll_inc = state2.loglik - state.loglik
    anom = v / torch.sqrt(f)
    if quality is not None:
        health2, qstate = quality_step(quality, meta, ssm, state2, health2,
                                       qstate, y, offset, v, f)
    return state2, health2, qstate, v, f, ll_inc, anom


def _forecast_impl(meta: SSMeta, horizon: int, policy: HealthPolicy,
                   ssm: StateSpace, state: FilterState, health: LaneHealth,
                   offsets: torch.Tensor) -> torch.Tensor:
    """h-step point forecasts from the predicted state
    (``kalman.forecast_mean``); quarantined lanes report NaN
    (``forecast_policy="nan"``) or propagate from their last
    pre-divergence state (``"last_good"``)."""
    quarantined = health.status == LANE_DIVERGED
    if policy.forecast_policy == "last_good":
        a = torch.where(quarantined[:, None], health.good_a, state.a)
        ring = torch.where(quarantined[:, None], health.good_ring,
                           state.ring) if meta.d_order else state.ring
        return forecast_mean(meta, horizon, ssm, a, ring, offsets)
    fc = forecast_mean(meta, horizon, ssm, state.a, state.ring, offsets)
    return torch.where(quarantined[:, None],
                       torch.full((), float("nan"), dtype=fc.dtype,
                                  device=fc.device), fc)


def _pad_lanes(tree, bucket: int, n_real: int):
    """Pad every lane tensor of a NamedTuple to the series bucket by
    replicating lane 0 (finite and harmless: pad lanes only ever see NaN
    ticks, which the filter skips)."""
    pad = bucket - n_real
    if pad == 0:
        return tree
    return type(tree)(*(torch.cat([leaf, leaf[:1].expand(pad,
                                                          *leaf.shape[1:])])
                        for leaf in tree))


def _np_dtype(dtype: torch.dtype) -> np.dtype:
    return torch.empty((), dtype=dtype).numpy().dtype


def _heal_spec_for(model) -> Optional[Dict[str, Any]]:
    """The batch-refit route ``heal()`` takes for this model family,
    JSON-plain so that it checkpoints; None where no ring-history refit
    exists (ARX: the exogenous offsets are not ring-buffered)."""
    name = type(model).__name__
    if name == "ARIMAModel":
        return {"family": "arima", "p": int(model.p), "d": int(model.d),
                "q": int(model.q),
                "include_intercept": bool(model.has_intercept)}
    if name == "ARModel":
        return {"family": "ar", "max_lag": int(model.coefficients.shape[-1])}
    if name == "EWMAModel":
        return {"family": "ewma"}
    if name == "HoltWintersModel":
        return {"family": "holt_winters", "period": int(model.period)}
    return None


class ServingSession:
    """Warm per-series filter state, per-lane health monitoring,
    divergence quarantine and :meth:`heal`-able lanes, on one device.

    Build one with :meth:`start` (a fitted model and its training
    history) or :meth:`restore` (a checkpoint).  Not thread-safe per
    instance: one session is one logical stream."""

    def __init__(self, ssm: StateSpace, meta: SSMeta, state: FilterState,
                 n_series: int, *, ticks_seen: int = 0,
                 registry=None, policy: Optional[HealthPolicy] = None,
                 health: Optional[LaneHealth] = None,
                 heal_spec: Optional[Dict[str, Any]] = None,
                 history_ring: int = DEFAULT_HISTORY_RING,
                 history_tail=None, _hist_state=None,
                 quality: Optional[QualityPolicy] = None,
                 _qstate: Optional[QualityState] = None,
                 label: Optional[str] = None):
        self._reg = registry if registry is not None \
            else _metrics.get_registry()
        self.meta = meta
        self.policy = (policy if policy is not None
                       else HealthPolicy()).validate()
        self.n_series = int(n_series)
        self._bucket = series_bucket(self.n_series)
        self.ticks_seen = int(ticks_seen)
        if ssm.n_series == self._bucket:       # already bucketed (restore)
            self._ssm, self._state = ssm, state
        else:
            self._ssm = _pad_lanes(ssm, self._bucket, ssm.n_series)
            self._state = _pad_lanes(state, self._bucket, state.a.shape[0])
        self._device = self._ssm.T.device
        self._tdtype = self._ssm.T.dtype
        self._dtype = _np_dtype(self._tdtype)
        self._health = initial_health(self._state) if health is None \
            else health
        self._heal_spec = heal_spec
        self._status_host = self._health.status[:self.n_series].cpu() \
            .numpy().copy()
        self._poisoned_specs: set = set()

        # bounded per-lane raw-tick ring (real lanes only): heal()'s
        # refit history, O(ring) memory however long the stream runs.
        # Held time-major, (ring, n_series), so that a tick's push writes
        # one contiguous row (a column of the series-major layout that
        # checkpoints carry costs ~5 ms of cache misses at 131072 series)
        if _hist_state is not None:
            hist, self._hist_pos, self._hist_fill = _hist_state
            self._hist = np.array(np.asarray(hist).T, order="C")
            self._hist_len = self._hist.shape[0]
        else:
            self._hist_len = max(8, int(history_ring))
            self._hist = np.full((self._hist_len, self.n_series),
                                 np.nan, self._dtype)
            self._hist_pos = 0
            self._hist_fill = 0
            if history_tail is not None:
                tail = np.asarray(history_tail, self._dtype)
                tail = tail[:, -self._hist_len:]
                k = tail.shape[1]
                self._hist[:k] = tail.T
                self._hist_pos = k % self._hist_len
                self._hist_fill = k
        self.label = check_label(label) if label is not None \
            else f"s{next(_session_seq)}"
        self._tick_lat: deque = deque(maxlen=TICK_LATENCY_WINDOW)
        self._slo_ms = _serving_slo_ms()
        self._slo_burns = 0
        self._quality = quality.validate() if quality is not None \
            else None
        self._drift_alarms = 0
        self._q_host: Optional[Dict[str, np.ndarray]] = None
        if _qstate is not None:
            self._qstate: Optional[QualityState] = _qstate
        elif self._quality is not None:
            self._qstate = self._initial_qstate()
        else:
            self._qstate = None
        _telemetry.register_session(self)
        _telemetry.ensure_started_from_env()
        self._reg.inc("serving.sessions")
        self._reg.set_gauge("serving.state_bytes", self.state_bytes)

    def _initial_qstate(self) -> QualityState:
        """A cold bucket-width quality state: MASE scale from the seeded
        history ring (NaN, never scoring, without history), coverage
        half-widths from the calibrated ssm's ψ weights; pad lanes
        replicate lane 0."""
        q = self._quality
        hist = self._ring_history()
        if hist.shape[1] >= 2:
            scale = naive_scale(hist)
        else:
            scale = np.full((self.n_series,), np.nan)
        half = forecast_half_widths(self._ssm, self.meta, q.horizon,
                                    q.coverage)
        scale_b = np.full((self._bucket,), np.nan, np.float64)
        scale_b[:self.n_series] = scale
        scale_b[self.n_series:] = scale[0] if scale.size else np.nan
        return initial_quality(self._bucket, q, self._tdtype, scale_b, half,
                               device=self._device)

    # -- construction -------------------------------------------------------

    @classmethod
    def start(cls, model, history, *, offsets=None, registry=None,
              policy: Optional[HealthPolicy] = None,
              history_ring: int = DEFAULT_HISTORY_RING,
              quality: Optional[QualityPolicy] = None,
              label: Optional[str] = None, device=None) -> "ServingSession":
        """Open a session on ``device`` (``None`` means CUDA) from a fitted
        model and the history it was fitted on: converts to state-space
        form, filters the history to a warm state, calibrates σ² and
        buckets the per-series tensors.  ``history (n_series, n_obs)``
        (NaNs are missing ticks); ``offsets`` carries ARX's per-tick
        exogenous observation offsets; ``policy`` tunes the health
        monitor; ``history_ring`` bounds the per-lane ring :meth:`heal`
        refits from; ``quality=QualityPolicy()`` arms the
        forecast-quality plane."""
        dev = resolve_device(device)
        history = as_tensor(history, dev)
        if history.ndim == 1:
            history = history[None]
        model = _map_tensors(model, lambda t: t.to(dev))
        boot: Bootstrapped = bootstrap(model, history, offsets=offsets)
        return cls(boot.ssm, boot.meta, boot.state, history.shape[0],
                   ticks_seen=int(history.shape[1]), registry=registry,
                   policy=policy, heal_spec=_heal_spec_for(model),
                   history_ring=history_ring, quality=quality,
                   history_tail=history.cpu().numpy(), label=label)

    # -- serving ------------------------------------------------------------

    @property
    def update_key(self):
        """``(bucket, dtype, SSMeta, HealthPolicy, QualityPolicy-or-None)``:
        sessions with equal keys run the same tick program on tensors of
        the same shapes (the JAX package's executable key; the fleet
        coalesces same-key ticks into one wider call)."""
        return (self._bucket, str(self._dtype), self.meta, self.policy,
                self._quality)

    def _prepare_tick(self, ticks, offset=None):
        """Validate and pad one tick into the bucket-shaped host buffers
        the tick consumes, applying the serving-tier fault hooks.
        Returns ``(host (n_series,), y (bucket,), off (bucket,))``."""
        if isinstance(ticks, torch.Tensor):
            ticks = ticks.cpu().numpy()
        host = np.asarray(ticks, self._dtype).reshape(-1)
        if host.shape[0] != self.n_series:
            raise ValueError(
                f"update expects one tick per series ({self.n_series}), "
                f"got {host.shape[0]}")
        host = self._apply_faults(host)
        y = np.full((self._bucket,), np.nan, self._dtype)
        y[:self.n_series] = host
        off = np.zeros((self._bucket,), self._dtype)
        if offset is not None:
            if isinstance(offset, torch.Tensor):
                offset = offset.cpu().numpy()
            off_host = np.asarray(offset, self._dtype).reshape(-1)
            if off_host.shape[0] != self.n_series:
                raise ValueError(
                    f"update expects one exogenous offset per series "
                    f"({self.n_series}), got {off_host.shape[0]}")
            off[:self.n_series] = off_host
        return host, y, off

    def _tick_result(self, v, f, ll_inc, health2, anom) -> TickResult:
        """The real lanes' results on the host, in one device-to-host
        copy (the status codes ride as floats: 0..3 exactly)."""
        n = self.n_series
        both = torch.stack([v[:n], f[:n], ll_inc[:n], anom[:n],
                            health2.ew[:n],
                            health2.status[:n].to(v.dtype)]).cpu().numpy()
        return TickResult(both[0], both[1], both[2],
                          both[5].astype(np.int32), both[3], both[4])

    def _absorb_tick(self, host, state2, health2, out: TickResult,
                     dt_s: float, qstate2=None, lineage=None) -> TickResult:
        """Commit one tick's outputs into the session: state, health and
        quality swap, transition and latency accounting, history-ring
        push.  The other half of :meth:`_prepare_tick`; the fleet calls
        the pair around its coalesced tick, passing each member its
        slice of the group's outputs.  ``lineage`` (the fleet's per-tick
        trace record) closes its ``scatter`` segment once the commit is
        visible."""
        self._state = state2
        self._health = health2
        if self._quality is not None and qstate2 is not None:
            self._qstate = qstate2
        self._note_transitions(out.status)
        self._note_tick_latency(dt_s)
        if self._quality is not None:
            self._note_quality(out)
        # the ring stores non-finite arrivals as NaN (an inf would poison
        # heal()'s refit window for a ring's length of ticks)
        self._hist[self._hist_pos] = np.where(np.isfinite(host), host,
                                              np.nan)
        self._hist_pos = (self._hist_pos + 1) % self._hist_len
        self._hist_fill = min(self._hist_fill + 1, self._hist_len)
        self.ticks_seen += 1
        self._reg.inc("serving.updates")
        self._reg.inc("serving.ticks", self.n_series)
        if lineage is not None:
            lineage.stage_end("scatter")
        return out

    def _device_tick(self, y: np.ndarray, off: np.ndarray):
        """One tick of the session's buffers: ``(state', health',
        qstate', v, F, ll_inc, anomaly)``."""
        return _update_impl(
            self.meta, self.policy, self._quality, self._ssm, self._state,
            self._health, self._qstate,
            torch.from_numpy(y).to(self._device),
            torch.from_numpy(off).to(self._device))

    def update(self, ticks, offset=None) -> TickResult:
        """Ingest one tick per series: one health-monitored Kalman step,
        O(1) work a tick a series.

        ``ticks (n_series,)`` raw observations (NaN is missing: the lane
        predicts forward and adds no likelihood; an inf tick degrades to
        missing the same way); ``offset (n_series,)`` the ARX exogenous
        offsets of this tick.  Quarantined lanes are predict-only.  The
        time of a tick, the copy of its :class:`TickResult` to the host
        included, is the ``serving.update`` span and the session's
        latency window."""
        host, y, off = self._prepare_tick(ticks, offset)
        t0 = time.perf_counter()
        with _metrics.span("serving.update"):
            state2, health2, qstate2, v, f, ll_inc, anom = \
                self._device_tick(y, off)
            out = self._tick_result(v, f, ll_inc, health2, anom)
        return self._absorb_tick(host, state2, health2, out,
                                 time.perf_counter() - t0, qstate2)

    def update_batch(self, ticks, offsets=None) -> TickResult:
        """Catch-up ingest: ``ticks (n_series, k)`` chronological columns,
        each through :meth:`update`, so bitwise the ``k`` single updates.
        Returns the last tick's :class:`TickResult`."""
        if isinstance(ticks, torch.Tensor):
            ticks = ticks.cpu().numpy()
        batch = np.asarray(ticks, self._dtype)
        if batch.ndim != 2 or batch.shape[0] != self.n_series:
            raise ValueError(
                f"update_batch expects a (n_series, k) = "
                f"({self.n_series}, k) chronological tick panel for "
                f"this session (bucket {self._bucket}), got shape "
                f"{batch.shape}; transpose a (k, n_series) stream, or "
                f"route a different-width panel to its own session")
        if batch.shape[1] == 0:
            raise ValueError("update_batch needs at least one tick "
                             "column")
        offs = None
        if offsets is not None:
            if isinstance(offsets, torch.Tensor):
                offsets = offsets.cpu().numpy()
            offs = np.asarray(offsets, self._dtype)
            if offs.shape != batch.shape:
                raise ValueError(
                    f"update_batch offsets must match the tick panel "
                    f"shape {batch.shape}, got {offs.shape}")
        out = None
        for t in range(batch.shape[1]):
            out = self.update(batch[:, t],
                              offs[:, t] if offs is not None else None)
        return out

    def _apply_faults(self, host: np.ndarray) -> np.ndarray:
        """Serving-tier fault injection (``utils.resilience``): corrupt
        incoming ticks, or poison the filter state of every
        ``lane_stride``-th lane once per fault scope."""
        spec = _resilience.serving_fault("tick_corrupt_nan")
        if spec is None:
            spec = _resilience.serving_fault("tick_corrupt_inf")
        if spec is not None:
            host = host.copy()
            host[::spec.lane_stride] = np.nan \
                if spec.mode == "tick_corrupt_nan" else np.inf
        spec = _resilience.serving_fault("state_poison")
        token = _resilience.fault_scope_token()
        if spec is not None and token not in self._poisoned_specs:
            # once per scope per session: a poisoned state stays poisoned
            # on its own
            self._poisoned_specs.add(token)
            rows = np.arange(self.n_series)[::spec.lane_stride]
            a = self._state.a.clone()
            a[torch.from_numpy(rows).to(self._device)] = _POISON_VALUE
            self._state = self._state._replace(a=a)
            _metrics.trace_instant("serving.fault.state_poison",
                                   {"lanes": int(rows.size)})
        return host

    def _note_transitions(self, status: np.ndarray) -> None:
        newly = (status == LANE_DIVERGED) \
            & (self._status_host != LANE_DIVERGED)
        n_new = int(newly.sum())
        if n_new:
            # divergence is quarantine: the tick that flags the lane also
            # masks it predict-only
            self._reg.inc("serving.diverged", n_new)
            self._reg.inc("serving.quarantined", n_new)
            _metrics.trace_instant(
                "serving.lane_diverged",
                {"lanes": n_new, "tick": int(self.ticks_seen)})
        if n_new or (self._status_host == LANE_DIVERGED).any():
            self._reg.set_gauge(
                "serving.quarantined_lanes",
                int(np.sum(status == LANE_DIVERGED)))
        newly_dr = (status == LANE_DRIFTED) \
            & (self._status_host != LANE_DRIFTED)
        n_dr = int(newly_dr.sum())
        if n_dr:
            self._drift_alarms += n_dr
            self._reg.inc("serving.drift_alarms", n_dr)
            _metrics.trace_instant(
                "serving.lane_drifted",
                {"lanes": n_dr, "tick": int(self.ticks_seen)})
        self._status_host = status.copy()

    def _note_tick_latency(self, dt_s: float) -> None:
        """Fold one tick's wall latency into the rolling window and
        publish ``serving.session.<label>.tick_p50_ms`` / ``tick_p95_ms``,
        the SLO burn counter against ``STS_SERVING_SLO_MS`` and the
        session's quarantined-lanes gauge."""
        self._tick_lat.append(float(dt_s))
        pre = f"serving.session.{self.label}"
        ms = dt_s * 1e3
        if self._slo_ms is not None and ms > self._slo_ms:
            self._slo_burns += 1
            self._reg.inc(f"{pre}.slo_burns")
            self._reg.inc("serving.slo_burns")
            _metrics.trace_instant(
                "serving.slo_burn",
                {"session": self.label, "tick_ms": round(ms, 3),
                 "slo_ms": self._slo_ms})
        arr = np.fromiter(self._tick_lat, dtype=np.float64)
        self._reg.set_gauge(f"{pre}.tick_p50_ms",
                            float(np.percentile(arr, 50)) * 1e3)
        self._reg.set_gauge(f"{pre}.tick_p95_ms",
                            float(np.percentile(arr, 95)) * 1e3)
        self._reg.set_gauge(
            f"{pre}.quarantined_lanes",
            int(np.sum(self._status_host == LANE_DIVERGED)))

    def _quality_host(self, q: Optional[QualityState] = None
                      ) -> Dict[str, np.ndarray]:
        """The real lanes' EW online metrics of ``q`` (the session's when
        None) on the host, in one copy."""
        q = self._qstate if q is None else q
        n = self.n_series
        both = torch.stack([q.ew_smape[:n], q.ew_mase[:n], q.ew_cover[:n],
                            q.n_scored[:n].to(q.ew_smape.dtype)]) \
            .cpu().numpy()
        return {"ew_smape": both[0], "ew_mase": both[1],
                "ew_cover": both[2], "n_scored": both[3].astype(np.int32)}

    def _note_quality(self, out: TickResult) -> None:
        """Publish the per-tick quality gauges
        (``serving.session.<label>.live_smape`` / ``.anomaly_p95`` /
        ``.drift_alarms`` / ``.drifted_lanes``) and the host snapshot
        :meth:`quality_summary` reads."""
        self._q_host = dict(self._quality_host(),
                            anomaly_ew=out.anomaly_ew)
        pre = f"serving.session.{self.label}"
        # quarantined lanes are left out: their EW metrics froze at the
        # pre-divergence error
        scored = (self._q_host["n_scored"] > 0) \
            & (out.status != LANE_DIVERGED)
        if scored.any():
            self._reg.set_gauge(
                f"{pre}.live_smape",
                float(self._q_host["ew_smape"][scored].mean()))
        fin = np.isfinite(out.anomaly_ew) & (out.status != LANE_DIVERGED)
        if fin.any():
            self._reg.set_gauge(
                f"{pre}.anomaly_p95",
                float(np.percentile(out.anomaly_ew[fin], 95)))
        self._reg.set_gauge(f"{pre}.drift_alarms", self._drift_alarms)
        self._reg.set_gauge(f"{pre}.drifted_lanes",
                            int(np.sum(out.status == LANE_DRIFTED)))

    def quality_summary(self) -> Optional[Dict[str, Any]]:
        """The forecast-quality panel of this session (None when quality
        tracking is off): EW online accuracy over the scored live lanes,
        the lane-anomaly p95 and the drift state."""
        if self._quality is None:
            return None
        qh = self._q_host
        if qh is None:          # no tick yet
            qh = dict(self._quality_host(), anomaly_ew=self._health
                      .ew[:self.n_series].cpu().numpy())
        scored = (qh["n_scored"] > 0) \
            & (self._status_host != LANE_DIVERGED)
        ew = qh["anomaly_ew"]
        fin = np.isfinite(ew) & (self._status_host != LANE_DIVERGED)
        # lanes with no valid MASE scale never fold their ew_mase
        scale = self._qstate.scale[:self.n_series].cpu().numpy()
        mase_ok = scored & np.isfinite(scale) & (scale > 0)

        def _mean(key, m=None):
            m = scored if m is None else m
            return round(float(qh[key][m].mean()), 4) \
                if m.any() else None

        return {
            "horizon": int(self._quality.horizon),
            "scored_lanes": int(scored.sum()),
            "scored_ticks": int(qh["n_scored"].sum()),
            "live_smape": _mean("ew_smape"),
            "live_mase": _mean("ew_mase", mase_ok),
            "live_coverage": _mean("ew_cover"),
            "anomaly_p95": round(float(np.percentile(ew[fin], 95)), 4)
            if fin.any() else None,
            "drifted_lanes":
                int(np.sum(self._status_host == LANE_DRIFTED)),
            "drift_alarms": int(self._drift_alarms),
        }

    def tick_latency_stats(self) -> Dict[str, Any]:
        """The rolling window's latency summary (ms)."""
        if not self._tick_lat:
            return {"window": 0}
        arr = np.fromiter(self._tick_lat, dtype=np.float64) * 1e3
        return {
            "window": int(arr.size),
            "tick_p50_ms": round(float(np.percentile(arr, 50)), 4),
            "tick_p95_ms": round(float(np.percentile(arr, 95)), 4),
            "tick_max_ms": round(float(arr.max()), 4),
            "slo_ms": self._slo_ms,
            "slo_burns": self._slo_burns,
        }

    def telemetry_summary(self) -> Dict[str, Any]:
        """One summary dict of the session (the JAX package's
        ``/snapshot.json`` entry); ``quality`` only when it is armed."""
        doc = {
            "label": self.label,
            **self.describe(),
            "health": self.health_counts(),
            "quarantined_lanes":
                int(np.sum(self._status_host == LANE_DIVERGED)),
            **self.tick_latency_stats(),
        }
        if self._quality is not None:
            doc["quality"] = self.quality_summary()
        return doc

    def forecast(self, horizon: int, offsets=None) -> np.ndarray:
        """``(n_series, horizon)`` point forecasts from the current
        filtered state (zero future innovations, integrated through the
        difference ring for d > 0); quarantined lanes report NaN or
        last-good per ``policy.forecast_policy``; ``offsets (n_series,
        horizon)`` adds known future exogenous contributions (ARX)."""
        horizon = int(horizon)
        if horizon < 1:
            raise ValueError("forecast needs horizon >= 1")
        offs = np.zeros((self._bucket, horizon), self._dtype)
        if offsets is not None:
            if isinstance(offsets, torch.Tensor):
                offsets = offsets.cpu().numpy()
            offs[:self.n_series] = np.asarray(offsets, self._dtype)
        with _metrics.span("serving.forecast"):
            out = _forecast_impl(
                self.meta, horizon, self.policy, self._ssm, self._state,
                self._health, torch.from_numpy(offs).to(self._device))
            out = out[:self.n_series].cpu().numpy()
        self._reg.inc("serving.forecasts")
        return out

    def warmup(self) -> None:
        """Run one all-missing tick and throw its result away, so that the
        first real tick's allocations (the caching allocator's blocks)
        and one-time library set-up happen before traffic.  The tick is
        pure, so the session's state is untouched."""
        y = np.full((self._bucket,), np.nan, self._dtype)
        off = np.zeros((self._bucket,), self._dtype)
        with _metrics.span("serving.warmup"):
            _, health2, q2, v, f, ll, anom = self._device_tick(y, off)
            self._tick_result(v, f, ll, health2, anom)
            if self._quality is not None:
                self._quality_host(q2)

    # -- health + healing ---------------------------------------------------

    @property
    def lane_status(self) -> np.ndarray:
        """Per-series health codes (``health.LANE_*``) after the last
        tick."""
        return self._health.status[:self.n_series].cpu().numpy()

    def health_counts(self) -> Dict[str, int]:
        """``{status_name: lane count}`` (nonzero entries only)."""
        s = self.lane_status
        return {name: int(np.sum(s == code))
                for code, name in LANE_NAMES.items()
                if int(np.sum(s == code))}

    def _ring_history(self) -> np.ndarray:
        """The ring's ticks in chronological order, ``(n_series, k)``."""
        if self._hist_fill < self._hist_len:
            return self._hist[:self._hist_fill].T
        return np.roll(self._hist, -self._hist_pos, axis=0).T

    @staticmethod
    def _gapfree_suffix(hist: np.ndarray) -> np.ndarray:
        """Per lane, NaN out everything up to and including the last
        non-finite tick: the longest gap-free suffix as a leading-NaN
        (ragged) window, which the batch resilient path fits directly
        (one missing tick would otherwise make the lane unhealable)."""
        bad = ~np.isfinite(hist)
        out = np.where(bad, np.nan, hist)
        any_bad = bad.any(axis=1)
        if any_bad.any():
            n = hist.shape[1]
            last_bad = n - 1 - np.argmax(bad[:, ::-1], axis=1)
            cols = np.arange(n)
            out[any_bad[:, None]
                & (cols[None, :] <= last_bad[:, None])] = np.nan
        return out

    def heal(self, *, auto_order: bool = True, engine=None,
             drifted: bool = False,
             stats: Optional[dict] = None) -> Dict[str, Any]:
        """Refit every quarantined lane (and, with ``drifted=True``, every
        drift-flagged one) from the bounded history ring through the
        batch resilient path on the session's device, and splice the
        re-bootstrapped lanes back into the live session.

        The refit is the family's fail-soft chain (health masking,
        multi-start retry, fallbacks and, ``auto_order=True`` for arima,
        the searched-order stage).  Healed lanes get a fresh bootstrap
        on their ring history and their monitor resets to OK; lanes whose
        refit still fails stay quarantined.  A refit that fails on a
        kernel or the card raises; any other refit error leaves the
        session serving with the lanes quarantined and is reported.
        ``stats`` (a dict) receives the refit's own (arima and
        holt_winters: its kernel launches).  Returns ``{"quarantined",
        "healed", "dead", ...}``."""
        status = self.lane_status
        mask = status == LANE_DIVERGED
        n_quarantined = int(mask.sum())
        report: Dict[str, Any] = {"quarantined": n_quarantined,
                                  "healed": 0, "dead": 0}
        if drifted:
            mask = mask | (status == LANE_DRIFTED)
            report["drifted"] = int(np.sum(status == LANE_DRIFTED))
        rows = np.flatnonzero(mask)
        report["dead"] = int(rows.size)
        if rows.size == 0:
            return report
        if self._heal_spec is None:
            raise NotImplementedError(
                f"heal() has no batch refit route for family "
                f"{self.meta.family!r} (its exogenous offsets are not "
                f"ring-buffered); restart the session from a fresh fit")
        hist = self._ring_history()
        with _metrics.span("serving.heal"):
            # refit (and re-bootstrap) from each lane's longest gap-free
            # recent window, as leading-NaN ragged lanes
            sub = self._gapfree_suffix(hist[rows])
            try:
                model, outcome = self._heal_refit(sub, auto_order, engine,
                                                  stats)
            except Exception as e:  # noqa: BLE001 — quarantine already
                # contains the damage; a heal that cannot refit leaves
                # the session serving, unless the device itself failed
                if is_device_fault(e):
                    raise
                self._reg.inc("serving.heal_errors")
                _metrics.trace_instant(
                    "serving.heal_error", {"error": type(e).__name__})
                report["error"] = f"{type(e).__name__}: {e}"
                return report
            ok = np.isin(outcome.status,
                         (_resilience.STATUS_OK,
                          _resilience.STATUS_RETRIED,
                          _resilience.STATUS_FALLBACK))
            healed_rows = rows[ok]
            if healed_rows.size:
                ok_idx = torch.from_numpy(np.flatnonzero(ok)).to(
                    self._device)
                sub_model = _map_tensors(
                    model, lambda t: t[ok_idx]
                    if t.ndim >= 1 and t.shape[0] == rows.size else t)
                boot = bootstrap(sub_model,
                                 torch.from_numpy(sub[ok]).to(self._device))
                if boot.meta != self.meta:
                    raise ServingRestoreMismatch(
                        f"heal refit produced meta {boot.meta}, session "
                        f"serves {self.meta} — the heal route drifted "
                        f"from the session's family/order")
                self._splice(healed_rows, boot)
                if self._quality is not None:
                    self._reset_quality_lanes(healed_rows, boot, sub[ok])
            n_healed = int(healed_rows.size)
            n_dead = int(rows.size - n_healed)
            self._reg.inc("serving.healed", n_healed)
            if n_dead:
                self._reg.inc("serving.heal_failed", n_dead)
            self._reg.set_gauge("serving.quarantined_lanes",
                                int(np.sum(self.lane_status
                                           == LANE_DIVERGED)))
            _metrics.trace_instant(
                "serving.heal", {"quarantined": int(rows.size),
                                 "healed": n_healed, "dead": n_dead})
        report.update(healed=n_healed, dead=n_dead)
        if outcome.orders is not None:
            report["orders"] = np.asarray(outcome.orders)[ok].tolist()
        return report

    def _heal_refit(self, values: np.ndarray, auto_order: bool, engine,
                    stats: Optional[dict] = None):
        """Batch-resilient refit of the gathered lanes on the session's
        device, routed per family."""
        eng = engine if engine is not None else default_engine()
        spec = dict(self._heal_spec)
        family = spec.pop("family")
        v = torch.from_numpy(np.ascontiguousarray(values)).to(self._device)
        dev = self._device
        extra = {} if stats is None else {"stats": stats}
        if family == "arima":
            icpt = spec["include_intercept"]
            auto = bool(auto_order) and icpt \
                and (spec["p"] > 0 or spec["q"] > 0)
            return eng.fit_resilient(v, "arima", spec["p"], spec["d"],
                                     spec["q"], include_intercept=icpt,
                                     auto_order=auto, device=dev, **extra)
        if family == "ar":
            return eng.fit_resilient(v, "ar", spec["max_lag"], device=dev)
        if family == "ewma":
            return eng.fit_resilient(v, "ewma", device=dev)
        if family == "holt_winters":
            return eng.fit_resilient(v, "holt_winters", spec["period"],
                                     device=dev, **extra)
        raise NotImplementedError(
            f"no heal refit route for family {family!r}")

    def _splice(self, rows: np.ndarray, boot: Bootstrapped) -> None:
        """Scatter the re-bootstrapped lanes into copies of the live
        tensors and reset their monitor state (off the tick path; the
        other lanes are untouched, bit for bit)."""
        idx = torch.from_numpy(rows).to(self._device)

        def scatter(full, sub):
            out = full.clone()
            out[idx] = sub.to(full.dtype)
            return out

        self._ssm = StateSpace(*map(scatter, self._ssm, boot.ssm))
        self._state = FilterState(*map(scatter, self._state, boot.state))
        h = self._health
        self._health = LaneHealth(
            ew=scatter(h.ew, torch.ones((rows.size,), dtype=h.ew.dtype,
                                        device=self._device)),
            status=scatter(h.status, torch.full(
                (rows.size,), LANE_OK, dtype=torch.int32,
                device=self._device)),
            good_a=scatter(h.good_a, boot.state.a),
            good_ring=scatter(h.good_ring, boot.state.ring)
            if self.meta.d_order else h.good_ring)
        self._status_host[rows] = LANE_OK
        self._reg.set_gauge("serving.state_bytes", self.state_bytes)

    def _reset_quality_lanes(self, rows: np.ndarray, boot: Bootstrapped,
                             hist_rows: np.ndarray) -> None:
        """Re-baseline the quality state of healed lanes: the forecast
        ring empties, the EW metrics and drift statistic restart, and the
        MASE scale and coverage half-width come from the refit's ring
        history and calibrated ssm."""
        q = self._qstate
        pol = self._quality
        idx = torch.from_numpy(rows).to(self._device)
        k = rows.size

        def put(full, sub):
            out = full.clone()
            out[idx] = torch.as_tensor(sub).to(full.device, full.dtype)
            return out

        fzero = torch.zeros((k,), dtype=q.ew_smape.dtype,
                            device=self._device)
        izero = torch.zeros((k,), dtype=torch.int32, device=self._device)
        self._qstate = QualityState(
            fc_ring=put(q.fc_ring, torch.full((k, q.fc_ring.shape[1]),
                                              float("nan"))),
            pos=put(q.pos, izero), warm=put(q.warm, izero),
            scale=put(q.scale, naive_scale(hist_rows)),
            half=put(q.half, forecast_half_widths(
                boot.ssm, self.meta, pol.horizon, pol.coverage)),
            ew_smape=put(q.ew_smape, fzero), ew_mase=put(q.ew_mase, fzero),
            ew_cover=put(q.ew_cover, fzero),
            n_scored=put(q.n_scored, izero), ph=put(q.ph, fzero),
            drifted=put(q.drifted, torch.zeros((k,), dtype=torch.bool)))
        self._q_host = None

    # -- introspection ------------------------------------------------------

    @property
    def loglik(self) -> np.ndarray:
        """Running exact log-likelihood per series (history + ticks)."""
        return self._state.loglik[:self.n_series].cpu().numpy()

    @property
    def state_bytes(self) -> int:
        return state_nbytes((self._state, self._health, self._qstate))

    def describe(self) -> dict:
        return {"family": self.meta.family, "mode": self.meta.mode,
                "n_series": self.n_series, "bucket": self._bucket,
                "state_dim": self.meta.m, "d_order": self.meta.d_order,
                "ticks_seen": self.ticks_seen,
                "state_bytes": self.state_bytes,
                "history_ring": self._hist_len,
                "quality_horizon": int(self._quality.horizon)
                if self._quality is not None else None,
                "dtype": str(self._dtype)}

    # -- persistence --------------------------------------------------------

    def checkpoint_blob(self) -> Dict[str, Any]:
        """The session's whole persistent state as one checkpointable
        dict (SSM, filter state, lane health, history ring, heal route,
        meta, tick counters, the quality plane or None):
        :meth:`checkpoint` writes exactly this."""
        return {
            "format": _CHECKPOINT_FORMAT,
            "meta": self.meta,
            "policy": self.policy,
            "n_series": self.n_series,
            "ticks_seen": self.ticks_seen,
            "bucket": self._bucket,
            "ssm": self._ssm,
            "state": self._state,
            "health": self._health,
            "heal_spec": self._heal_spec,
            "hist": self._hist.T,           # (n_series, ring)
            "hist_pos": self._hist_pos,
            "hist_fill": self._hist_fill,
            "quality_policy": self._quality,
            "qstate": self._qstate,
        }

    def checkpoint(self, path: str) -> None:
        """Atomically persist the whole session
        (``utils.checkpoint.save_pytree_atomic``); :meth:`restore`
        resumes serving and healing exactly here."""
        _checkpoint.save_pytree_atomic(path, self.checkpoint_blob())
        self._reg.inc("serving.checkpoints")

    @classmethod
    def restore(cls, path: str, *, registry=None,
                label: Optional[str] = None,
                device=None) -> "ServingSession":
        """Rebuild a session from :meth:`checkpoint` output on ``device``
        (``None`` means CUDA).  ``utils.checkpoint`` rejects torn files;
        then the geometry is checked (:meth:`from_blob`)."""
        blob = _checkpoint.load_pytree(path)
        return cls.from_blob(blob, source=path, registry=registry,
                             label=label, device=device)

    @classmethod
    def from_blob(cls, blob: Dict[str, Any], *, source: str = "<blob>",
                  registry=None, label: Optional[str] = None,
                  device=None) -> "ServingSession":
        """:meth:`restore`'s validation and construction over a
        :meth:`checkpoint_blob` dict (leaves as tensors or numpy), on
        ``device`` (``None`` means CUDA).  The saved bucket must equal
        ``engine.series_bucket(n_series)`` and ``SSMeta`` must describe
        the stored tensors; any disagreement raises
        :class:`ServingRestoreMismatch` naming the fields."""
        fmt = blob.get("format")
        if fmt != _CHECKPOINT_FORMAT:
            raise ValueError(
                f"serving checkpoint format {fmt!r} is not supported "
                f"(expected {_CHECKPOINT_FORMAT}; format-1 checkpoints "
                f"predate lane-health monitoring — restart those "
                f"sessions from a fresh fit)")
        dev = resolve_device(device)

        def leaves(cls_, tree):
            return cls_(*(torch.as_tensor(leaf).to(dev) for leaf in tree))

        ssm = leaves(StateSpace, blob["ssm"])
        state = leaves(FilterState, blob["state"])
        health = leaves(LaneHealth, blob["health"])
        meta = blob["meta"]
        n_series = int(blob["n_series"])
        saved_bucket = int(blob["bucket"])
        hist = np.asarray(blob["hist"])

        diffs = []

        def check(field, saved, expected):
            if saved != expected:
                diffs.append(f"  {field}: checkpoint={saved!r} vs "
                             f"restoring-process={expected!r}")

        check("bucket(series_bucket policy)", saved_bucket,
              series_bucket(n_series))
        check("meta.m(state dim)", int(meta.m), int(ssm.state_dim))
        check("meta.d_order(ring width)", int(meta.d_order),
              int(state.ring.shape[1]))
        check("ssm.n_series", int(ssm.n_series), saved_bucket)
        check("state.rows", int(state.a.shape[0]), saved_bucket)
        check("health.rows", int(health.status.shape[0]), saved_bucket)
        check("hist.rows", int(hist.shape[0]), n_series)
        if meta.family not in WARMUP_FAMILIES:
            diffs.append(f"  meta.family: checkpoint={meta.family!r} vs "
                         f"restoring-process={WARMUP_FAMILIES}")
        if meta.mode not in ("exact", "innovations"):
            diffs.append(f"  meta.mode: checkpoint={meta.mode!r} vs "
                         f"restoring-process=('exact', 'innovations')")
        quality = blob.get("quality_policy")
        qstate = blob.get("qstate")
        if quality is not None and qstate is not None:
            qstate = leaves(QualityState, qstate)
            if int(qstate.fc_ring.shape[0]) != saved_bucket:
                diffs.append(
                    f"  qstate.rows: checkpoint="
                    f"{int(qstate.fc_ring.shape[0])} vs "
                    f"restoring-process={saved_bucket}")
            if int(qstate.fc_ring.shape[1]) != int(quality.horizon):
                diffs.append(
                    f"  qstate.ring(horizon): checkpoint="
                    f"{int(qstate.fc_ring.shape[1])} vs "
                    f"restoring-process={int(quality.horizon)}")
        else:
            quality, qstate = None, None
        if diffs:
            raise ServingRestoreMismatch(
                f"serving checkpoint at {source!r} disagrees with the "
                f"restoring session's engine policy / its own geometry; "
                f"differing fields:\n" + "\n".join(diffs))
        return cls(ssm, meta, state, n_series,
                   ticks_seen=int(blob["ticks_seen"]), registry=registry,
                   policy=blob["policy"], health=health,
                   heal_spec=blob.get("heal_spec"),
                   quality=quality, _qstate=qstate,
                   _hist_state=(hist, int(blob["hist_pos"]),
                                int(blob["hist_fill"])), label=label)


def start_session(model, history, **kwargs) -> ServingSession:
    """Module-level convenience for :meth:`ServingSession.start`."""
    return ServingSession.start(model, history, **kwargs)


def _warmup_meta(family: str, p: int, d: int, q: int,
                 period: int) -> SSMeta:
    """The :class:`SSMeta` a session of the given family and order
    carries (the static half of ``update_key``)."""
    if family == "arima":
        return SSMeta("arima", "exact", int(d), max(p, q + 1))
    if family in ("ar", "arx"):
        return SSMeta(family, "exact", 0, max(int(p), 1))
    if family == "ewma":
        return SSMeta("ewma", "innovations", 0, 1)
    if family == "holt_winters":
        return SSMeta("holt_winters", "innovations", 0, 2 + int(period))
    raise ValueError(f"no serving form for family {family!r}; expected "
                     f"one of {WARMUP_FAMILIES}")


def warmup_update(family: str = "arima", n_series: int = 1024, *,
                  dtype=None, p: int = 2, d: int = 1, q: int = 2,
                  period: int = 12,
                  policy: Optional[HealthPolicy] = None,
                  quality: Optional[QualityPolicy] = None,
                  device=None) -> dict:
    """Run the per-tick program of a family and shape once on ``device``
    (``None`` means CUDA) before any session exists, on a zeros-valued
    state-space form of the right shape, and throw the result away: the
    first real tick's allocations then come from warm caches.  Returns a
    summary dict."""
    dev = resolve_device(device)
    if dtype is None:
        dtype = torch.float32
    meta = _warmup_meta(family, p, d, q, period)
    pol = (policy if policy is not None else HealthPolicy()).validate()
    bucket = series_bucket(int(n_series))
    m = meta.m

    def zeros(*shape, dt=dtype):
        return torch.zeros(shape, dtype=dt, device=dev)

    ssm = StateSpace(T=zeros(bucket, m, m), Z=zeros(bucket, m),
                     c=zeros(bucket, m), d=zeros(bucket),
                     H=torch.ones((bucket,), dtype=dtype, device=dev),
                     Q=zeros(bucket, m, m), gain=zeros(bucket, m))
    state = FilterState(a=zeros(bucket, m), P=zeros(bucket, m, m),
                        ring=zeros(bucket, meta.d_order),
                        loglik=zeros(bucket), ssq=zeros(bucket),
                        sumlogf=zeros(bucket),
                        n_obs=zeros(bucket, dt=torch.int32))
    health = initial_health(state)
    qual = quality.validate() if quality is not None else None
    qstate = None
    if qual is not None:
        ones = torch.ones((bucket,), dtype=dtype, device=dev)
        qstate = initial_quality(bucket, qual, dtype, ones, ones)
    y = torch.full((bucket,), float("nan"), dtype=dtype, device=dev)
    with _metrics.span("serving.warmup"):
        _update_impl(meta, pol, qual, ssm, state, health, qstate, y,
                     zeros(bucket))
    return {"family": family, "bucket": bucket, "state_dim": m,
            "mode": meta.mode, "d_order": meta.d_order,
            "quality": qual is not None,
            "dtype": str(_np_dtype(dtype))}
