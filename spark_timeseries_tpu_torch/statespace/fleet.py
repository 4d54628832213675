"""Fleet scheduler: many labeled serving tenants multiplexed onto shared
coalesced ticks (counterpart of ``spark_timeseries_tpu/statespace/
fleet.py``).

A :class:`FleetScheduler` holds many :class:`~.serving.ServingSession`
tenants and stays correct and responsive under overload and failure:

- **admission control and backpressure**: every tenant owns a bounded
  ingress queue; :class:`AdmissionPolicy` decides what saturation means
  (``"reject"`` raises :class:`FleetSaturated`; ``"drop_oldest"`` evicts
  the stalest queued tick; ``"degrade"`` sheds the tenant onto the
  cached-forecast lane).  Counters ``fleet.admitted`` /
  ``fleet.rejected`` / ``fleet.queued``; the ``tenant_flood`` fault
  amplifies ingress to drive all three.
- **tick coalescing**: tenants whose sessions share an update key
  (``ServingSession.update_key``: bucket, dtype, ``SSMeta``, health and
  quality policies) form one *coalescing group*.  Their pending ticks
  gather into one wider call of the very function a session's tick runs
  (``serving._update_impl``: the group's NamedTuples concatenated
  lane-wise, every operation per lane), and each member's slice goes
  back through the session's own ``_prepare_tick`` / ``_absorb_tick``
  pair, so N tenants cost one tick's launches instead of N, and the
  results are bitwise the per-session ticks.  A group flushes when every
  live tenant has a tick queued, or when the oldest queued tick outlives
  ``AdmissionPolicy.coalesce_window_s`` (a ``coalesce_straggler`` delays
  only itself).  Group width is padded to a power-of-two slot count.
- **SLO-aware shedding**: every coalesced dispatch's wall time feeds a
  rolling window; while its p95 burns the ``STS_SERVING_SLO_MS`` budget,
  tenants shed one per pump in health order (``health.shed_priority``).
  A shed tenant's ticks buffer in a bounded catch-up ring and its reads
  serve the periodicity-aware forecast cache (the last live forecast
  path, shifted by the ticks that arrived since, within a staleness
  bound).  When the burn clears for ``shed_cooldown`` pumps, tenants
  restore newest-shed first and replay their buffered ticks.
- **checkpoint-based migration**: :meth:`FleetScheduler.drain` writes one
  atomic tenant bundle (the session's ``checkpoint_blob`` plus the
  still-queued ticks) and :meth:`FleetScheduler.adopt` restores it in
  another scheduler or process, bitwise; a bundle that disagrees with
  the adopting process raises :class:`FleetRestoreMismatch` naming the
  differing fields.

Every admitted tick carries a lineage record (``utils.lineage``) through
admit, queue, gather, dispatch, scatter and deliver, finalised exactly
once.  A scheduler is one logical serving plane on one device (``None``
means CUDA) and is not thread-safe: ``statespace.runtime.FleetRuntime``
serialises access to it.

The JAX package compiles one executable per ``(update key, slots)``;
eager PyTorch has nothing to compile, so :meth:`FleetScheduler.warmup`
runs each width once for the caching allocator and library set-up.

Metrics (the JAX package's names): ``fleet.admitted/rejected/queued/
dropped_ticks``, ``fleet.coalesced_dispatches/coalesced_ticks`` and the
``fleet.coalesced_step`` span, ``fleet.slo_burns``, ``fleet.shed_lanes``,
``fleet.shed_tenants`` gauge, ``fleet.restored_tenants``,
``fleet.cache_serves``, ``fleet.cache_stale``, ``fleet.drained`` /
``fleet.adopted``.
"""

from __future__ import annotations

import itertools
import os
import signal
import time
from collections import deque
from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from .._device import resolve_device
from ..utils import checkpoint as _checkpoint
from ..utils import lineage as _lineage
from ..utils import metrics as _metrics
from ..utils import resilience as _resilience
from ..utils import telemetry as _telemetry
from .health import LaneHealth, shed_priority
from .quality import QualityState
from .serving import ServingSession, TickResult, _update_impl, check_label
from .ssm import FilterState

__all__ = ["AdmissionPolicy", "FleetScheduler", "FleetSaturated",
           "FleetRestoreMismatch", "TENANT_LIVE", "TENANT_SHED",
           "DEFAULT_QUEUE_DEPTH"]

# tenant bundle format written by drain() and read by adopt()
_BUNDLE_FORMAT = 1

DEFAULT_QUEUE_DEPTH = 8

# tenant serving modes
TENANT_LIVE = "live"    # ticks coalesce onto the device
TENANT_SHED = "shed"    # ticks buffer; reads serve the forecast cache

_fleet_seq = itertools.count(1)


class FleetSaturated(RuntimeError):
    """A tenant's bounded ingress queue is full under the ``"reject"``
    admission policy: the caller sees which tenant saturated at what
    depth."""


class FleetRestoreMismatch(ValueError):
    """A tenant bundle disagrees with the adopting scheduler or process
    (format, label, tick geometry, or, chained underneath, the session
    half's own ``ServingRestoreMismatch``)."""


class AdmissionPolicy(NamedTuple):
    """Static knobs of one scheduler's overload behavior.

    ``queue_depth`` bounds every tenant's ingress queue; ``on_full`` is
    what saturation does (``"reject"``, ``"drop_oldest"``,
    ``"degrade"``); ``coalesce_window_s`` is the longest a queued tick
    waits for its group to fill (0 = never wait); ``slo_window`` the
    rolling dispatch-latency sample count behind the fleet p95;
    ``shed_cooldown`` the consecutive clear pumps before shed tenants
    restore; ``cache_staleness`` the most elapsed ticks a cached forecast
    path may be shifted by; ``catchup_ring`` how many ticks a shed tenant
    buffers for replay (older ones drop)."""
    queue_depth: int = DEFAULT_QUEUE_DEPTH
    on_full: str = "reject"
    coalesce_window_s: float = 0.05
    slo_window: int = 64
    shed_cooldown: int = 4
    cache_staleness: int = 32
    catchup_ring: int = 64

    def validate(self) -> "AdmissionPolicy":
        if self.queue_depth < 1:
            raise ValueError(
                f"queue_depth must be >= 1, got {self.queue_depth}")
        if self.on_full not in ("reject", "drop_oldest", "degrade"):
            raise ValueError(
                f"on_full must be 'reject', 'drop_oldest', or "
                f"'degrade', got {self.on_full!r}")
        if self.coalesce_window_s < 0:
            raise ValueError(
                f"coalesce_window_s must be >= 0, "
                f"got {self.coalesce_window_s}")
        if self.slo_window < 4:
            raise ValueError(
                f"slo_window must be >= 4, got {self.slo_window}")
        if self.shed_cooldown < 1:
            raise ValueError(
                f"shed_cooldown must be >= 1, got {self.shed_cooldown}")
        if self.cache_staleness < 1:
            raise ValueError(
                f"cache_staleness must be >= 1, "
                f"got {self.cache_staleness}")
        if self.catchup_ring < 1:
            raise ValueError(
                f"catchup_ring must be >= 1, got {self.catchup_ring}")
        return self


def _slots_for(n: int) -> int:
    """Group slot count: next power of two >= n (floor 1)."""
    s = 1
    while s < n:
        s *= 2
    return s


def _gather(trees, slots: int):
    """Lane-wise concatenation of same-type NamedTuples of tensors,
    vacant slots padded by repeating member 0's leaves (finite and
    harmless: their ticks are NaN and their results are never
    scattered back)."""
    pad = slots - len(trees)
    return type(trees[0])(*(torch.cat(list(leaves) + [leaves[0]] * pad)
                            for leaves in zip(*trees)))


def _take(tree, lo: int, hi: int):
    return type(tree)(*(leaf[lo:hi] for leaf in tree))


def _host_array(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


class _Tenant:
    """One logical tenant: its session plus the scheduler-side state
    (ingress queue, serving mode, catch-up ring, forecast cache,
    per-tenant counters)."""

    def __init__(self, session: ServingSession, policy: AdmissionPolicy):
        self.session = session
        self.label = session.label
        self.queue: deque = deque()   # (tick, offset, t_arrival, lineage)
        self.mode = TENANT_LIVE
        self.shed_reason: Optional[str] = None
        # (tick, offset, lineage): the bounded shed-lane replay buffer
        self.catchup: deque = deque(maxlen=policy.catchup_ring)
        self.cache_fc: Optional[np.ndarray] = None   # (n_series, H)
        self.cache_stamp = 0                 # `arrived` at cache time
        self.admitted = 0
        self.rejected = 0
        self.dropped = 0
        self.cache_serves = 0
        self.ticks_dispatched = 0
        # ticks that ever arrived (queued or buffered): the forecast
        # cache's phase runs on this clock, not on ring or queue sizes,
        # which a bounded ring would freeze
        self.arrived = 0
        self.arrived_prev_pump = 0           # ingress-quiescence probe

    @property
    def n_series(self) -> int:
        return self.session.n_series

    def elapsed_since_cache(self) -> int:
        """Stream ticks that arrived since the cached forecast path was
        taken: the phase shift a cache read applies."""
        return self.arrived - self.cache_stamp

    def summary(self) -> Dict[str, Any]:
        return {
            "tenant": self.label,
            "mode": self.mode,
            "shed_reason": self.shed_reason,
            "n_series": self.n_series,
            "queued": len(self.queue),
            "catchup": len(self.catchup),
            "admitted": self.admitted,
            "rejected": self.rejected,
            "dropped": self.dropped,
            "cache_serves": self.cache_serves,
            "ticks_dispatched": self.ticks_dispatched,
            "health": self.session.health_counts(),
        }


class FleetScheduler:
    """Multiplex many labeled :class:`ServingSession` tenants onto shared
    coalesced ticks, with admission control, SLO-aware shedding and
    checkpoint-based migration (module docstring for the contract).

    Build one on ``device`` (``None`` means CUDA; every attached session
    must live there), :meth:`attach` (or :meth:`open_tenant`) tenants,
    :meth:`warmup`, then :meth:`submit` ticks: dispatch is automatic
    (``auto_pump``) or explicit through :meth:`pump`.  Reads go through
    :meth:`forecast`, which serves shed tenants from the cache."""

    def __init__(self, policy: Optional[AdmissionPolicy] = None, *,
                 registry=None, label: Optional[str] = None,
                 auto_pump: bool = True, device=None):
        self.policy = (policy if policy is not None
                       else AdmissionPolicy()).validate()
        dev = resolve_device(device)
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        self.device = dev
        self._reg = registry if registry is not None \
            else _metrics.get_registry()
        self.label = check_label(label) if label is not None \
            else f"fleet{next(_fleet_seq)}"
        self.auto_pump = bool(auto_pump)
        self._tenants: Dict[str, _Tenant] = {}
        self._groups: Dict[Any, List[str]] = {}   # update_key -> labels
        self._lat: deque = deque(maxlen=self.policy.slo_window)
        self._slo_ms = _telemetry.env_positive("STS_SERVING_SLO_MS",
                                               float, None)
        self._slo_burns = 0
        self._burning = False
        self._clear_pumps = 0
        self._shed_order: List[str] = []     # labels in shed order
        # gathered-SSM reuse: the SSM is static between heals, so the
        # group's concatenation is kept per (group key, participants,
        # slots) with the member SSM objects it was built from; a heal
        # swaps in new tensors (a new object), which misses and gathers
        # again
        self._gather_cache: Dict[Any, Tuple[list, Any]] = {}
        # set by statespace.runtime.FleetRuntime when it supervises this
        # scheduler: a zero-argument callable returning the pump's
        # liveness block, folded into telemetry_summary()
        self._runtime_info = None
        _telemetry.register_fleet(self)
        _telemetry.ensure_started_from_env()
        self._reg.inc("fleet.schedulers")

    # -- tenant lifecycle ---------------------------------------------------

    def attach(self, session: ServingSession) -> str:
        """Register a session as a tenant (its label is the tenant id,
        unique per scheduler).  Sessions with equal ``update_key``
        coalesce into one group."""
        label = check_label(session.label)
        if label in self._tenants:
            raise ValueError(
                f"tenant label {label!r} is already attached to "
                f"{self.label!r}; labels identify tenants — give the "
                f"session a distinct label=")
        if session._device != self.device:
            raise ValueError(
                f"session {label!r} lives on {session._device}, scheduler "
                f"{self.label!r} on {self.device}; restore the session on "
                f"the scheduler's device")
        t = _Tenant(session, self.policy)
        self._tenants[label] = t
        self._groups.setdefault(session.update_key, []).append(label)
        self._reg.inc("fleet.tenants_attached")
        self._reg.set_gauge("fleet.tenants", len(self._tenants))
        return label

    def open_tenant(self, model, history, *, label: Optional[str] = None,
                    **kwargs) -> str:
        """Convenience: :meth:`ServingSession.start` on the scheduler's
        device + :meth:`attach`."""
        sess = ServingSession.start(model, history, label=label,
                                    registry=self._reg, device=self.device,
                                    **kwargs)
        return self.attach(sess)

    def detach(self, label: str) -> ServingSession:
        """Remove a tenant (undispatched ticks are dropped and counted);
        returns its session, still live and servable standalone."""
        t = self._pop_tenant(label)
        if t.queue or t.catchup:
            self._reg.inc("fleet.dropped_ticks",
                          len(t.queue) + len(t.catchup))
            for entry in t.queue:
                _lineage.complete(entry[3], self._reg, outcome="dropped")
            for entry in t.catchup:
                _lineage.complete(entry[2], self._reg, outcome="dropped")
        return t.session

    def _pop_tenant(self, label: str) -> _Tenant:
        t = self._tenants.pop(label, None)
        if t is None:
            raise KeyError(
                f"no tenant {label!r} in scheduler {self.label!r} "
                f"(tenants: {sorted(self._tenants) or 'none'})")
        key = t.session.update_key
        self._groups[key].remove(label)
        if not self._groups[key]:
            del self._groups[key]
        if label in self._shed_order:
            self._shed_order.remove(label)
        # a member's state is a slice of its group's last tick outputs:
        # a session that leaves takes copies, so that it does not keep
        # the whole group's tensors alive
        sess = t.session
        sess._state = FilterState(*(x.clone() for x in sess._state))
        sess._health = LaneHealth(*(x.clone() for x in sess._health))
        if sess._qstate is not None:
            sess._qstate = QualityState(*(x.clone() for x in sess._qstate))
        self._reg.set_gauge("fleet.tenants", len(self._tenants))
        return t

    @property
    def tenants(self) -> List[str]:
        return sorted(self._tenants)

    @property
    def n_groups(self) -> int:
        return len(self._groups)

    def session(self, label: str) -> ServingSession:
        return self._require(label).session

    def _require(self, label: str) -> _Tenant:
        t = self._tenants.get(label)
        if t is None:
            raise KeyError(
                f"no tenant {label!r} in scheduler {self.label!r} "
                f"(tenants: {sorted(self._tenants) or 'none'})")
        return t

    # -- admission ----------------------------------------------------------

    def submit(self, label: str, tick, offset=None) -> None:
        """Admit one tick for one tenant through the bounded ingress
        queue; dispatch happens on the next :meth:`pump` (automatic by
        default).  Only the ``"reject"`` policy raises, and it raises
        :class:`FleetSaturated`."""
        t = self._require(label)
        flood = _resilience.fleet_fault("tenant_flood")
        copies = max(1, int(flood.n_attempts)) if flood is not None else 1
        for _ in range(copies):
            self._admit_one(t, tick, offset)
        if self.auto_pump:
            self.pump()

    def _admit_one(self, t: _Tenant, tick, offset, lin=None) -> None:
        # the width is checked here, at the admission boundary: a
        # malformed tick found inside a coalesced dispatch would already
        # have dequeued its peers' ticks
        if lin is None:
            # one record per admitted tick: the "degrade" branch
            # re-enters with the same record
            lin = _lineage.begin(t.label)
        tick = _host_array(tick).reshape(-1)
        if tick.shape[0] != t.n_series:
            raise ValueError(
                f"tenant {t.label!r} expects one tick per series "
                f"({t.n_series}), got {tick.shape[0]}")
        if offset is not None:
            offset = _host_array(offset).reshape(-1)
            if offset.shape[0] != t.n_series:
                raise ValueError(
                    f"tenant {t.label!r} expects one exogenous offset "
                    f"per series ({t.n_series}), got {offset.shape[0]}")
        if t.mode == TENANT_SHED:
            # shed lane: ticks buffer for replay on restore; the bounded
            # ring evicts the oldest
            if len(t.catchup) == t.catchup.maxlen:
                t.dropped += 1
                self._reg.inc("fleet.dropped_ticks")
                _lineage.complete(t.catchup[0][2], self._reg,
                                  outcome="dropped")
            if lin is not None:
                lin.detour("shed")
                lin.stage_end("admit")
            t.catchup.append((np.array(tick, copy=True),
                              None if offset is None
                              else np.array(offset, copy=True), lin))
            t.admitted += 1
            t.arrived += 1
            self._reg.inc("fleet.admitted")
            return
        if len(t.queue) >= self.policy.queue_depth:
            mode = self.policy.on_full
            if mode == "reject":
                t.rejected += 1
                self._reg.inc("fleet.rejected")
                _lineage.complete(lin, self._reg, outcome="rejected")
                raise FleetSaturated(
                    f"tenant {t.label!r} ingress queue is full "
                    f"({self.policy.queue_depth} ticks) and the "
                    f"admission policy is 'reject'; pump() the "
                    f"scheduler, slow the producer, or use "
                    f"on_full='drop_oldest'/'degrade'")
            if mode == "drop_oldest":
                evicted = t.queue.popleft()
                t.dropped += 1
                self._reg.inc("fleet.dropped_ticks")
                _lineage.complete(evicted[3], self._reg, outcome="dropped")
            else:                     # degrade: shed onto the cache lane
                self._shed(t, reason="admission")
                self._admit_one(t, tick, offset, lin)
                return
        if lin is not None:
            lin.stage_end("admit")
        t.queue.append((tick, offset, time.monotonic(), lin))
        t.admitted += 1
        t.arrived += 1
        self._reg.inc("fleet.admitted")
        self._reg.inc("fleet.queued")

    # -- coalesced dispatch -------------------------------------------------

    def pump(self, force: bool = False) -> List[Dict[str, Any]]:
        """Dispatch every ready coalescing group (``force=True``: every
        group with pending ticks) and run the shed/restore ladder.
        Returns one report dict per dispatched group."""
        reports = []
        strag = _resilience.fleet_fault("coalesce_straggler")
        for key in list(self._groups):
            labels = self._groups.get(key)
            if not labels:
                continue
            members = [self._tenants[la] for la in labels]
            live = [m for m in members if m.mode == TENANT_LIVE]
            stragglers = set()
            if strag is not None:
                stragglers = {m.label for i, m in enumerate(live)
                              if i % max(1, strag.lane_stride) == 0}
            ready_pool = [m for m in live if m.label not in stragglers]
            with_ticks = [m for m in ready_pool if m.queue]
            if not with_ticks:
                continue
            all_present = len(with_ticks) == len(ready_pool)
            oldest = min(m.queue[0][2] for m in with_ticks)
            expired = self.policy.coalesce_window_s == 0.0 or \
                (time.monotonic() - oldest) >= self.policy.coalesce_window_s
            if not (force or all_present or expired):
                continue
            # a window-deadline flush with members missing is the
            # straggler-pays-alone path; the lineage records mark it
            reports.append(self._dispatch_group(
                key, with_ticks,
                deadline_flush=expired and not all_present))
        self._shed_restore_step()
        return reports

    def _dispatch_group(self, key, members: List[_Tenant],
                        deadline_flush: bool = False) -> Dict[str, Any]:
        """One coalesced tick: pop one queued tick per member,
        concatenate the group's NamedTuples lane-wise, run the tick a
        session runs solo (``serving._update_impl``) once over all of
        them, bring its results to the host in one copy, and commit each
        member's slice through its session's absorb path."""
        bucket, _dtype, meta, policy, quality = key
        G = len(members)
        slots = _slots_for(G)
        prepped = []
        lins = []
        for m in members:
            tick, offset, _, lin = m.queue.popleft()
            if lin is not None:
                lin.stage_end("queue")
                if deadline_flush:
                    lin.detour("window_deadline")
            lins.append(lin)
            host, y, off = m.session._prepare_tick(tick, offset)
            prepped.append((m, host, y, off))
        sessions = [p[0].session for p in prepped]
        dev = sessions[0]._device

        ckey = (key, tuple(p[0].label for p in prepped), slots)
        member_ssms = [s._ssm for s in sessions]
        cached = self._gather_cache.get(ckey)
        if cached is not None and len(cached[0]) == G and all(
                a is b for a, b in zip(cached[0], member_ssms)):
            ssm = cached[1]
        else:
            ssm = _gather(member_ssms, slots)
            if len(self._gather_cache) > 64:   # participation churn
                self._gather_cache.clear()
            self._gather_cache[ckey] = (member_ssms, ssm)
        state = _gather([s._state for s in sessions], slots)
        health = _gather([s._health for s in sessions], slots)
        qstate = _gather([s._qstate for s in sessions], slots) \
            if quality is not None else None
        y_all = np.full((slots * bucket,), np.nan, sessions[0]._dtype)
        off_all = np.zeros_like(y_all)
        for i, (_, _, y, off) in enumerate(prepped):
            y_all[i * bucket:(i + 1) * bucket] = y
            off_all[i * bucket:(i + 1) * bucket] = off
        for lin in lins:
            if lin is not None:
                lin.stage_end("gather")
        t0 = time.perf_counter()
        with _metrics.span("fleet.coalesced_step"):
            state2, health2, qstate2, v, f, ll_inc, anom = _update_impl(
                meta, policy, quality, ssm, state, health, qstate,
                torch.from_numpy(y_all).to(dev),
                torch.from_numpy(off_all).to(dev))
            # one device-to-host copy of every output (the status codes
            # ride as floats: 0..3 exactly), sliced per tenant on the
            # host; inside the span, so that the latency covers the tick
            both = torch.stack([v, f, ll_inc, anom, health2.ew,
                                health2.status.to(v.dtype)]).cpu().numpy()
            status = both[5].astype(np.int32)
            outs = []
            for i, m in enumerate(p[0] for p in prepped):
                lo, hi = i * bucket, i * bucket + m.n_series
                outs.append(TickResult(both[0, lo:hi], both[1, lo:hi],
                                       both[2, lo:hi], status[lo:hi],
                                       both[3, lo:hi], both[4, lo:hi]))
        dt = time.perf_counter() - t0
        for lin in lins:
            if lin is not None:
                lin.stage_end("dispatch")
        for i, (m, host, _, _) in enumerate(prepped):
            lo, hi = i * bucket, (i + 1) * bucket
            m.session._absorb_tick(
                host, _take(state2, lo, hi), _take(health2, lo, hi),
                outs[i], dt,
                _take(qstate2, lo, hi) if quality is not None else None,
                lineage=lins[i])
            m.ticks_dispatched += 1
        self._reg.inc("fleet.coalesced_dispatches")
        self._reg.inc("fleet.coalesced_ticks", G)
        self._note_latency(dt)
        # delivery: the results are committed and visible to readers
        for lin in lins:
            if lin is not None:
                lin.stage_end("deliver")
                _lineage.complete(lin, self._reg)
        return {"key": (bucket, meta.family, meta.m), "tenants": G,
                "slots": slots, "wall_ms": round(dt * 1e3, 3),
                "dtype": _dtype}

    def warmup(self) -> None:
        """Run every path a pump can take at the current membership once,
        on all-missing ticks whose results are thrown away: each group's
        coalesced tick at every power-of-two slot width up to the whole
        group (partial flushes dispatch at the narrower ones) with its
        stacked host copy's operands, and each group's solo tick (the
        catch-up and migration replays).  Eager PyTorch compiles
        nothing, so what this front-loads is the caching allocator's
        blocks and one-time library set-up; every tick is pure, so no
        session's state, counters or lineage move.  One synchronize at
        the end."""
        pending = []
        with _metrics.span("fleet.warmup"):
            for key, labels in self._groups.items():
                bucket, _dtype, meta, policy, quality = key
                members = [self._tenants[la] for la in labels]
                members[0].session.warmup()     # the replay-lane tick
                sizes = {len(members)}
                w = 1
                while w < len(members):
                    sizes.add(w)
                    w *= 2
                for G in sorted(sizes):
                    slots = _slots_for(G)
                    srcs = [m.session for m in members[:G]]
                    qs = _gather([s._qstate for s in srcs], slots) \
                        if quality is not None else None
                    y = torch.full((slots * bucket,), float("nan"),
                                   dtype=srcs[0]._tdtype,
                                   device=self.device)
                    _, h2, _, v, f, ll, anom = _update_impl(
                        meta, policy, quality,
                        _gather([s._ssm for s in srcs], slots),
                        _gather([s._state for s in srcs], slots),
                        _gather([s._health for s in srcs], slots), qs,
                        y, torch.zeros_like(y))
                    pending.append(torch.stack(
                        [v, f, ll, anom, h2.ew, h2.status.to(v.dtype)]))
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
        del pending

    # -- SLO shedding -------------------------------------------------------

    def _note_latency(self, dt_s: float) -> None:
        self._lat.append(float(dt_s))
        ms = dt_s * 1e3
        if self._slo_ms is not None and ms > self._slo_ms:
            self._slo_burns += 1
            self._reg.inc("fleet.slo_burns")

    def _p95_ms(self) -> Optional[float]:
        if len(self._lat) < 4:
            return None
        arr = np.fromiter(self._lat, dtype=np.float64) * 1e3
        return float(np.percentile(arr, 95))

    def _burn_active(self) -> bool:
        if self._slo_ms is None:
            return False
        p95 = self._p95_ms()
        return p95 is not None and p95 > self._slo_ms

    def _shed_restore_step(self) -> None:
        """The shed ladder, one rung per pump: while the p95 window burns
        the SLO budget, shed the worst-health live tenant; once the burn
        stays clear for ``shed_cooldown`` pumps, restore shed tenants
        (newest shed first) with catch-up replay."""
        burning = self._burn_active()
        if burning:
            self._burning = True
            self._clear_pumps = 0
            live = [t for t in self._tenants.values()
                    if t.mode == TENANT_LIVE]
            if live:
                worst = max(
                    live, key=lambda t: (
                        shed_priority(t.session.lane_status), t.label))
                self._shed(worst, reason="slo")
            return
        if not self._burning and not self._shed_order:
            return
        self._clear_pumps += 1
        if self._clear_pumps < self.policy.shed_cooldown:
            return
        restored = None
        for label in reversed(self._shed_order):
            t = self._tenants.get(label)
            if t is not None and t.shed_reason != "admission":
                restored = t
                break
        if restored is None:
            # only admission-shed tenants remain: they restore once their
            # own ingress is quiet (no arrival since the previous pump),
            # or a sustained flood would oscillate shed/replay/shed
            for label in reversed(self._shed_order):
                t = self._tenants.get(label)
                if t is not None and t.arrived == t.arrived_prev_pump:
                    restored = t
                    break
        for t in self._tenants.values():
            t.arrived_prev_pump = t.arrived
        if restored is not None:
            self._restore(restored)
        if not self._shed_order:
            self._burning = False

    def _shed(self, t: _Tenant, reason: str) -> None:
        if t.mode == TENANT_SHED:
            return
        t.mode = TENANT_SHED
        t.shed_reason = reason
        self._shed_order.append(t.label)
        self._burning = True
        # a fresh measurement epoch: the p95 that justified this shed is
        # pre-shed load
        self._lat.clear()
        self._clear_pumps = 0
        # undispatched queued ticks roll into the catch-up ring in order
        while t.queue:
            tick, offset, _, lin = t.queue.popleft()
            if len(t.catchup) == t.catchup.maxlen:
                t.dropped += 1
                self._reg.inc("fleet.dropped_ticks")
                _lineage.complete(t.catchup[0][2], self._reg,
                                  outcome="dropped")
            if lin is not None:
                lin.detour("shed")
            t.catchup.append((np.array(tick, copy=True),
                              None if offset is None
                              else np.array(offset, copy=True), lin))
        self._reg.inc("fleet.shed_lanes", t.n_series)
        self._reg.inc("fleet.shed_events")
        self._reg.set_gauge("fleet.shed_tenants", len(self._shed_order))
        _metrics.trace_instant(
            "fleet.tenant_shed",
            {"tenant": t.label, "reason": reason, "lanes": t.n_series,
             "p95_ms": self._p95_ms()})

    def _restore(self, t: _Tenant) -> None:
        """Bring a shed tenant back to the live lane: replay its buffered
        ticks through the session's own tick, then clear the shed mark.
        Ticks the bounded ring evicted stay lost, counted."""
        replayed = 0
        while t.catchup:
            tick, offset, lin = t.catchup.popleft()
            if lin is not None:
                lin.stage_end("queue")
                lin.via = "replay"
                lin.detour("catchup_replay")
            t.session.update(tick, offset)
            if lin is not None:
                lin.stage_end("replay")
                _lineage.complete(lin, self._reg)
            replayed += 1
        t.mode = TENANT_LIVE
        t.shed_reason = None
        if t.label in self._shed_order:
            self._shed_order.remove(t.label)
        self._reg.inc("fleet.restored_tenants")
        self._reg.set_gauge("fleet.shed_tenants", len(self._shed_order))
        _metrics.trace_instant("fleet.tenant_restored",
                               {"tenant": t.label, "replayed": replayed})

    # -- reads --------------------------------------------------------------

    def forecast(self, label: str, horizon: int,
                 offsets=None) -> np.ndarray:
        """h-step forecasts for one tenant.  Live tenants forecast off
        their filtered state and refresh the tenant's cache; shed tenants
        serve the cached path shifted by the ticks that arrived since it
        was taken, within the staleness bound, else a forecast off the
        frozen state (re-cached).  ``offsets (n_series, horizon)``
        (ARX) is request-specific: it passes to the session and never
        enters the cache."""
        t = self._require(label)
        horizon = int(horizon)
        if horizon < 1:
            raise ValueError("forecast needs horizon >= 1")
        if offsets is not None:
            return t.session.forecast(horizon, offsets=offsets)
        if t.mode == TENANT_LIVE:
            fc = t.session.forecast(horizon)
            t.cache_fc = np.array(fc, copy=True)
            # stamped at the state's own position on the arrival clock:
            # queued ticks have arrived but are not absorbed yet
            t.cache_stamp = t.arrived - len(t.queue)
            return fc
        # a cache serve is a request with a latency: it gets a lineage
        lin = _lineage.begin(t.label, via="cache")
        shift = t.elapsed_since_cache()
        if t.cache_fc is not None and shift <= self.policy.cache_staleness \
                and shift + horizon <= t.cache_fc.shape[1]:
            t.cache_serves += 1
            self._reg.inc("fleet.cache_serves")
            out = t.cache_fc[:, shift:shift + horizon]
            if lin is not None:
                lin.stage_end("cache")
                _lineage.complete(lin, self._reg)
            return out
        # stale (or too short) cache: a forecast off the frozen state,
        # cached far enough ahead to serve through the bound
        if lin is not None:
            lin.detour("cache_stale")
        self._reg.inc("fleet.cache_stale")
        depth = horizon + self.policy.cache_staleness
        fc = t.session.forecast(depth)
        t.cache_fc = np.array(fc, copy=True)
        t.cache_stamp = t.arrived
        if lin is not None:
            lin.stage_end("cache")
            _lineage.complete(lin, self._reg)
        return fc[:, :horizon]

    def last_status(self, label: str) -> np.ndarray:
        return self._require(label).session.lane_status

    # -- migration ----------------------------------------------------------

    def _pack_bundle(self, t: _Tenant) -> Dict[str, Any]:
        """The migration / checkpoint bundle of one tenant: the session's
        ``checkpoint_blob`` plus every queued and buffered tick with its
        exogenous offsets (:meth:`drain` and :meth:`checkpoint_tenant`
        write the same format)."""
        dtype, n = t.session._dtype, t.session.n_series

        def pack(ticks, offsets):
            rows = [np.asarray(x, dtype) for x in ticks]
            stacked = np.stack(rows) if rows else np.zeros((0, n), dtype)
            if not any(o is not None for o in offsets):
                return stacked, None
            return stacked, np.stack([
                np.asarray(o, dtype) if o is not None
                else np.zeros(n, dtype) for o in offsets])

        pending, pending_offs = pack([q[0] for q in t.queue],
                                     [q[1] for q in t.queue])
        catchup, catchup_offs = pack([c[0] for c in t.catchup],
                                     [c[1] for c in t.catchup])
        return {
            "format": _BUNDLE_FORMAT,
            "label": t.label,
            "mode": t.mode,
            "n_series": n,
            "pending": pending,
            "pending_offsets": pending_offs,
            "catchup": catchup,
            "catchup_offsets": catchup_offs,
            "session": t.session.checkpoint_blob(),
        }

    def checkpoint_tenant(self, label: str, path: str) -> Dict[str, Any]:
        """Crash-only snapshot of one tenant: the :meth:`drain` bundle,
        written atomically, while the tenant stays attached and keeps
        serving."""
        t = self._require(label)
        bundle = self._pack_bundle(t)
        _checkpoint.save_pytree_atomic(path, bundle)
        self._reg.inc("fleet.tenant_checkpoints")
        return {"tenant": label, "path": path,
                "pending": int(bundle["pending"].shape[0]),
                "catchup": int(bundle["catchup"].shape[0])}

    def drain(self, label: str, path: str) -> Dict[str, Any]:
        """Move a tenant out of this scheduler: the bundle carries the
        session's ``checkpoint_blob`` plus every queued and buffered
        tick and lands atomically, so a ``kill -9`` right after it
        returns leaves a bundle another process adopts bitwise.  The
        tenant is detached on success.  The ``drop_tenant_process``
        fault SIGKILLs right after the commit (forensics bundle
        first)."""
        t = self._require(label)
        bundle = self._pack_bundle(t)
        pending, catchup = bundle["pending"], bundle["catchup"]
        _checkpoint.save_pytree_atomic(path, bundle)
        self._reg.inc("fleet.drained")
        # the bundle is committed: the queued ticks' journeys end here
        # (the adopting scheduler mints fresh records), before the
        # injectable SIGKILL below
        for entry in t.queue:
            if entry[3] is not None:
                entry[3].detour("drain")
                _lineage.complete(entry[3], self._reg, outcome="migrated")
        for entry in t.catchup:
            if entry[2] is not None:
                entry[2].detour("drain")
                _lineage.complete(entry[2], self._reg, outcome="migrated")
        _metrics.trace_instant(
            "fleet.tenant_drained",
            {"tenant": t.label, "pending": int(pending.shape[0]),
             "catchup": int(catchup.shape[0])})
        if _resilience.fleet_fault("drop_tenant_process") is not None:
            # a real SIGKILL runs no handlers: forensics first
            from ..utils import flightrec as _flightrec
            _flightrec.record_incident(
                "drop_tenant_process",
                extra={"tenant": t.label, "bundle": path,
                       "note": "injected SIGKILL after drain commit"},
                registry=self._reg)
            os.kill(os.getpid(), signal.SIGKILL)
        self._pop_tenant(label)
        return {"tenant": label, "path": path,
                "pending": int(pending.shape[0]),
                "catchup": int(catchup.shape[0])}

    def adopt(self, path: str, *, replay: bool = True) -> str:
        """Restore a drained tenant bundle into this scheduler, on its
        device.

        The bundle's own fields are checked first
        (:class:`FleetRestoreMismatch` lists every disagreement), then
        the session half goes through ``ServingSession.from_blob``'s
        validation, whose ``ServingRestoreMismatch`` is chained under a
        :class:`FleetRestoreMismatch`.  ``replay=True`` replays the
        bundle's undispatched ticks through the session at once (bitwise
        where the drained tenant would have been); ``replay=False`` puts
        them at the front of the live queue in stream order."""
        try:
            bundle = _checkpoint.load_pytree(path)
        except Exception as e:
            raise FleetRestoreMismatch(
                f"tenant bundle at {path!r} cannot be read: "
                f"{type(e).__name__}: {e}") from e
        diffs = []
        fmt = bundle.get("format")
        if fmt != _BUNDLE_FORMAT:
            diffs.append(f"  format: bundle={fmt!r} vs "
                         f"adopting-process={_BUNDLE_FORMAT}")
        label = bundle.get("label")
        try:
            check_label(label if isinstance(label, str) else "")
        except ValueError:
            diffs.append(f"  label: bundle={label!r} vs "
                         f"adopting-process=[A-Za-z0-9_-]+")
        n_series = bundle.get("n_series")
        pending = np.asarray(bundle.get("pending"))
        for name, arr in (("pending", pending),
                          ("catchup", np.asarray(bundle.get("catchup")))):
            if arr.ndim != 2 or (n_series is not None
                                 and arr.shape[1] != n_series):
                diffs.append(
                    f"  {name}: bundle shape={tuple(arr.shape)} vs "
                    f"adopting-process=(k, {n_series})")
        if diffs:
            raise FleetRestoreMismatch(
                f"tenant bundle at {path!r} disagrees with the adopting "
                f"scheduler; differing fields:\n" + "\n".join(diffs))
        if isinstance(label, str) and label in self._tenants:
            raise FleetRestoreMismatch(
                f"tenant bundle at {path!r} names label {label!r}, "
                f"which is already attached to {self.label!r} — a "
                f"tenant must live in exactly one scheduler")
        try:
            sess = ServingSession.from_blob(
                bundle["session"], source=path, registry=self._reg,
                label=label, device=self.device)
        except ValueError as e:
            raise FleetRestoreMismatch(
                f"tenant bundle at {path!r}: the session half refuses "
                f"this process ({e})") from e
        self.attach(sess)
        t = self._tenants[label]
        self._reg.inc("fleet.adopted")
        # stream order: the catch-up ring (buffered while shed) first,
        # then the still-queued ticks, each with its saved offsets
        catchup = np.asarray(bundle.get("catchup"))
        c_offs = bundle.get("catchup_offsets")
        p_offs = bundle.get("pending_offsets")
        if replay:
            if len(catchup):
                sess.update_batch(catchup.T, offsets=None
                                  if c_offs is None else c_offs.T)
            if len(pending):
                sess.update_batch(pending.T, offsets=None
                                  if p_offs is None else p_offs.T)
        else:
            # deferred ingest at the front of the live queue, in stream
            # order, past queue_depth: migrated ticks are committed data
            now = time.monotonic()

            def _migrated_lin():
                # fresh records: trace ids never cross a process; the
                # origin finalised its records as "migrated"
                lin = _lineage.begin(label)
                if lin is not None:
                    lin.detour("adopt_migration")
                    lin.stage_end("admit")
                return lin

            deferred = [(np.array(row, copy=True),
                         None if c_offs is None else c_offs[i], now,
                         _migrated_lin())
                        for i, row in enumerate(catchup)]
            deferred += [(np.array(row, copy=True),
                          None if p_offs is None else p_offs[i], now,
                          _migrated_lin())
                         for i, row in enumerate(pending)]
            t.queue.extendleft(reversed(deferred))
            # the deferred ticks are arrivals on the cache's clock
            t.arrived += len(deferred)
        _metrics.trace_instant(
            "fleet.tenant_adopted",
            {"tenant": label, "replayed": int(replay)
             and (len(pending) + len(catchup))})
        return label

    # -- introspection ------------------------------------------------------

    def stats(self) -> Dict[str, Any]:
        qd = sum(len(t.queue) for t in self._tenants.values())
        return {
            "label": self.label,
            "tenants": len(self._tenants),
            "groups": len(self._groups),
            "queued": qd,
            "queue_depth": self.policy.queue_depth,
            "shed_tenants": len(self._shed_order),
            "slo_ms": self._slo_ms,
            "slo_burns": self._slo_burns,
            "p95_ms": self._p95_ms(),
            "window": len(self._lat),
        }

    def telemetry_summary(self) -> Dict[str, Any]:
        """The fleet panel (``utils.telemetry.fleet_summaries``): the
        aggregate, one row per tenant, and, when a
        :class:`~.runtime.FleetRuntime` supervises this scheduler, its
        pump liveness block."""
        out = {**self.stats(),
               "tenant_rows": [t.summary() for t in
                               sorted(self._tenants.values(),
                                      key=lambda t: t.label)]}
        info = self._runtime_info
        if info is not None:
            try:
                out["pump"] = info()
            except Exception as e:  # noqa: BLE001 — scrape isolation
                out["pump"] = {"error": f"{type(e).__name__}: {e}"}
        return out
