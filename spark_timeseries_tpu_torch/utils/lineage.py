"""Tick lineage: per-request end-to-end tracing across the fleet path
(a copy of ``spark_timeseries_tpu/utils/lineage.py``, which imports
nothing of JAX).

A fleet's ``submit()`` returns before the tick is dispatched, so the
latency a *caller* experiences is a journey of several stages that no
single span measures.  This module is the request-scoped plane:

- Every admitted tick gets a cheap monotonic **trace id** and a compact
  host-side :class:`TickLineage` record that rides the tenant queue and
  accumulates contiguous stage segments: ``admit`` (validation plus any
  backpressure park time) -> ``queue`` (residency until the coalescer
  pops it) -> ``gather`` (host-side batch assembly) -> ``dispatch`` (the
  one coalesced tick plus the copy of its results to the host) ->
  ``scatter`` (per-member state commit) -> ``deliver`` (result fan-out
  until the lineage completes).  Shed->cache serves record ``cache``;
  catch-up replay records ``replay``.  Stages are contiguous on one
  ``perf_counter`` timeline, so their sum reconstructs the
  submit->delivery wall time.
- **Detour markers** flag the interesting journeys: ``backpressure``
  (the submit call parked on the runtime condvar), ``shed`` (rolled from
  the live queue into the catch-up ring), ``window_deadline`` (dispatched
  by coalesce-window expiry with stragglers missing), ``catchup_replay``,
  ``cache_stale``, ``drain`` / ``adopt_migration`` (cross-process
  migration), and ``pump_restart_redelivery`` (the tick survived a pump
  crash and was re-swept by the next generation).
- Completed lineages land in a bounded per-process **ring** (overwrite
  oldest, count ``ring_dropped``: overflow is never silent), which
  flight-recorder bundles and :func:`lineage_summary` read.
- Per-tenant rolling windows drive ``fleet.e2e.<tenant>.p50_ms`` /
  ``.p95_ms`` gauges plus stage-decomposed rollups, so an SLO burn
  attributes to a *stage*, not just a number.  The N slowest delivered
  ticks per window keep their full stage timeline (exemplars).

Exactly-once contract: every ``begin()`` is finalised by exactly one
``complete()`` with a terminal outcome: ``delivered`` (histogrammed),
or ``rejected`` / ``dropped`` / ``migrated`` (counted, ring-recorded,
never histogrammed).  Queue entries carry their record across pump
generations (a crashed pump's queue survives intact), so supervision
restarts redeliver the *same* record rather than minting a duplicate;
``duplicate_completions`` and ``open_records()`` make any violation
countable.

Lock discipline: the module lock ``_lock`` is a **leaf**: it guards
only the ring, counters, and per-tenant windows, and is never held
across a registry call (gauges are set after release) or any other
lock.  Record mutation (``stage_end`` / ``detour``) is lock-free: a
record has exactly one owner at a time (the admitting thread, then the
pump thread that popped it), with hand-off through the tenant queue
under the runtime lock.  Everything here is host-side Python;
``STS_LINEAGE=0`` disarms the plane (one attribute read per submit).
"""
from __future__ import annotations

import itertools
import os
import threading
import time
from typing import Any, Dict, List, Optional

import numpy as np

from .telemetry import env_positive

__all__ = [
    "TickLineage", "begin", "complete", "arm", "armed", "reset",
    "submit_entry", "submit_parked", "submit_abandon",
    "records", "set_capacity", "open_records", "lineage_summary",
    "trace_events", "incident_block",
    "LINEAGE_CAPACITY", "LINEAGE_WINDOW", "LINEAGE_EXEMPLARS", "STAGES",
]

# Stage vocabulary, in journey order.  ``cache`` and ``replay`` are the
# detour terminals (shed->cache serve, catch-up replay); the rest is the
# pumped dispatch path.
STAGES = ("admit", "queue", "gather", "dispatch", "scatter", "deliver",
          "cache", "replay")

OUTCOMES = ("delivered", "rejected", "dropped", "migrated")

#: Completed-record ring capacity (override: ``STS_LINEAGE_CAPACITY``).
LINEAGE_CAPACITY = 4096
#: Per-tenant rolling e2e window length (override: ``STS_LINEAGE_WINDOW``).
LINEAGE_WINDOW = 256
#: Slowest-tick exemplars kept per window (override: ``STS_LINEAGE_EXEMPLARS``).
LINEAGE_EXEMPLARS = 4
#: Per-tenant stat maps are bounded too — labels are caller-supplied
#: strings, so an adversarial (or merely enthusiastic) tenant churn must
#: not grow host memory without bound.  Beyond the cap, completions
#: still ring-record but skip per-tenant windows (counted, not silent).
MAX_TENANTS = 1024

# Chrome-trace lane ids for lineage events.  Kept far above real thread
# ids and *integers* (to_chrome_trace sorts tids to emit thread_name
# metadata; mixed types would break the sort).
_LINEAGE_TID_BASE = 1 << 20
_LINEAGE_LANES = 4


class TickLineage:
    """One tick's journey: contiguous stage segments on a shared
    ``perf_counter`` timeline plus detour markers.  Mutated lock-free by
    its single owner; handed off through the tenant queue."""

    __slots__ = ("trace_id", "tenant", "via", "t0", "t_last",
                 "segs", "detours", "done")

    def __init__(self, trace_id: int, tenant: str, t0: float,
                 via: str = "dispatch"):
        self.trace_id = trace_id
        self.tenant = tenant
        self.via = via              # "dispatch" | "cache" | "replay"
        self.t0 = t0                # journey start (perf_counter seconds)
        self.t_last = t0            # end of the last closed segment
        self.segs: List[tuple] = []          # (stage, t_start, dur_s)
        self.detours: List[str] = []
        self.done = False

    def stage_end(self, stage: str) -> None:
        """Close the current segment as ``stage`` ([t_last, now])."""
        now = time.perf_counter()
        self.segs.append((stage, self.t_last, now - self.t_last))
        self.t_last = now

    def detour(self, marker: str) -> None:
        """Flag a detour (idempotent — redelivery may mark repeatedly)."""
        if marker not in self.detours:
            self.detours.append(marker)


# ---------------------------------------------------------------------------
# module state (all mutation under _lock; _lock is a leaf)

_lock = threading.Lock()
_trace_seq = itertools.count(1)

_armed = os.environ.get("STS_LINEAGE", "1") != "0"

_cap = env_positive("STS_LINEAGE_CAPACITY", int, LINEAGE_CAPACITY)
_window = env_positive("STS_LINEAGE_WINDOW", int, LINEAGE_WINDOW)
_n_exemplars = env_positive("STS_LINEAGE_EXEMPLARS", int, LINEAGE_EXEMPLARS)

_ring: List[dict] = []
_head = 0                   # next overwrite slot once full
_ring_dropped = 0

_started = 0
_outcomes: Dict[str, int] = {}
_duplicates = 0
_tenant_overflow = 0
_stage_ms: Dict[str, float] = {}        # delivered-stage rollup (ms)
# label -> {"e2e": [ms...], "stage_ms": {stage: ms}, "n": int, "cache": int}
_tenants: Dict[str, dict] = {}
_exemplars: List[dict] = []             # slowest delivered, current window
_exem_seen = 0                          # completions in current window

# Submit-side context: FleetRuntime.submit stamps entry/park here so the
# record minted later inside FleetScheduler._admit_one starts its clock
# *before* any backpressure wait.  Thread-local — no lock needed.
_tls = threading.local()


def arm(on: bool = True) -> bool:
    """(Dis)arm the plane; returns the previous state.  Disarmed,
    ``begin()`` returns ``None`` and every instrumentation site reduces
    to one ``is None`` check."""
    global _armed
    prev = _armed
    _armed = bool(on)
    return prev


def armed() -> bool:
    return _armed


def submit_entry() -> None:
    """Mark the start of a (possibly blocking) runtime submit on this
    thread.  Consumed by the next ``begin()`` so admission's stage
    includes backpressure park time."""
    if _armed:
        _tls.t0 = time.perf_counter()
        _tls.parked = False


def submit_parked() -> None:
    """The submitting thread is about to park on the backpressure
    condvar — the eventual record gets a ``backpressure`` detour."""
    if _armed and getattr(_tls, "t0", None) is not None:
        _tls.parked = True


def submit_abandon() -> None:
    """The submit failed terminally (e.g. backpressure timeout) without
    admitting a tick — drop the pending context so it cannot leak into
    an unrelated later admission on this thread."""
    _tls.t0 = None
    _tls.parked = False


def _consume_submit_ctx():
    t0 = getattr(_tls, "t0", None)
    parked = getattr(_tls, "parked", False)
    _tls.t0 = None
    _tls.parked = False
    return t0, parked


def begin(tenant: str, via: str = "dispatch") -> Optional[TickLineage]:
    """Mint a lineage record at admission; ``None`` when disarmed."""
    global _started
    if not _armed:
        return None
    t0, parked = _consume_submit_ctx()
    now = time.perf_counter()
    lin = TickLineage(next(_trace_seq), str(tenant),
                      now if t0 is None else t0, via=via)
    if parked:
        lin.detours.append("backpressure")
    with _lock:
        _started += 1
    return lin


def complete(lin: Optional[TickLineage], registry=None, *,
             outcome: str = "delivered") -> None:
    """Finalise a record exactly once: ring-append it, fold delivered
    outcomes into the per-tenant windows / stage rollups / exemplars,
    then (outside the lineage lock) publish the tenant's e2e gauges."""
    global _head, _ring_dropped, _duplicates, _tenant_overflow, _exem_seen
    if lin is None:
        return
    if lin.done:
        with _lock:
            _duplicates += 1
        if registry is not None:
            registry.inc("fleet.e2e.duplicate_completions")
        return
    lin.done = True
    e2e_ms = (time.perf_counter() - lin.t0) * 1e3
    stage_ms: Dict[str, float] = {}
    for stage, _, dur in lin.segs:
        stage_ms[stage] = stage_ms.get(stage, 0.0) + dur * 1e3
    rec = {
        "trace_id": lin.trace_id,
        "tenant": lin.tenant,
        "via": lin.via,
        "outcome": outcome,
        "e2e_ms": e2e_ms,
        "t0": lin.t0,
        "stages": stage_ms,
        "segs": [(s, ts, dur) for (s, ts, dur) in lin.segs],
        "detours": list(lin.detours),
    }
    delivered = outcome == "delivered"
    e2e_window: Optional[list] = None
    with _lock:
        _outcomes[outcome] = _outcomes.get(outcome, 0) + 1
        if len(_ring) < _cap:
            _ring.append(rec)
        else:
            _ring[_head] = rec
            _head = (_head + 1) % _cap
            _ring_dropped += 1
        if delivered:
            for stage, ms in stage_ms.items():
                _stage_ms[stage] = _stage_ms.get(stage, 0.0) + ms
            st = _tenants.get(lin.tenant)
            if st is None:
                if len(_tenants) >= MAX_TENANTS:
                    _tenant_overflow += 1
                else:
                    st = _tenants[lin.tenant] = {
                        "e2e": [], "stage_ms": {}, "n": 0, "cache": 0}
            if st is not None:
                st["n"] += 1
                if lin.via == "cache":
                    st["cache"] += 1
                st["e2e"].append(e2e_ms)
                if len(st["e2e"]) > _window:
                    del st["e2e"][:len(st["e2e"]) - _window]
                for stage, ms in stage_ms.items():
                    st["stage_ms"][stage] = st["stage_ms"].get(stage, 0.0) + ms
                e2e_window = list(st["e2e"])
            # exemplars: keep the N slowest full timelines per window
            _exem_seen += 1
            if _exem_seen > _window:
                _exem_seen = 1
                del _exemplars[:]
            _exemplars.append(rec)
            _exemplars.sort(key=lambda r: r["e2e_ms"], reverse=True)
            del _exemplars[_n_exemplars:]
    if registry is not None:
        registry.inc(f"fleet.e2e.{outcome}")
        if e2e_window:
            arr = np.asarray(e2e_window, dtype=np.float64)
            registry.set_gauge(f"fleet.e2e.{lin.tenant}.p50_ms",
                               float(np.percentile(arr, 50)))
            registry.set_gauge(f"fleet.e2e.{lin.tenant}.p95_ms",
                               float(np.percentile(arr, 95)))


def records() -> List[dict]:
    """Copy of the completed-record ring, oldest first."""
    with _lock:
        return _ring[_head:] + _ring[:_head]


def set_capacity(capacity: int) -> None:
    """Resize the ring, keeping the newest records that still fit."""
    global _ring, _head, _cap
    capacity = int(capacity)
    if capacity < 1:
        raise ValueError(f"lineage capacity must be >= 1, got {capacity}")
    with _lock:
        ordered = _ring[_head:] + _ring[:_head]
        _ring = ordered[-capacity:]
        _head = 0
        _cap = capacity


def open_records() -> int:
    """Records begun but not yet finalised (should be 0 at quiesce —
    any residue is an orphan and an exactly-once violation)."""
    with _lock:
        return _started - sum(_outcomes.values())


def reset() -> None:
    """Clear all completed state and counters (capacity and armed state
    survive).  In-flight records still complete afterwards; they simply
    land in the fresh window.  Test/bench isolation hook."""
    global _ring, _head, _ring_dropped, _started, _duplicates
    global _tenant_overflow, _exem_seen
    with _lock:
        _ring = []
        _head = 0
        _ring_dropped = 0
        _started = 0
        _duplicates = 0
        _tenant_overflow = 0
        _exem_seen = 0
        _outcomes.clear()
        _stage_ms.clear()
        _tenants.clear()
        del _exemplars[:]


def _pcts(vals: list) -> Dict[str, Optional[float]]:
    if not vals:
        return {"n": 0, "p50_ms": None, "p95_ms": None}
    arr = np.asarray(vals, dtype=np.float64)
    return {"n": len(vals),
            "p50_ms": round(float(np.percentile(arr, 50)), 3),
            "p95_ms": round(float(np.percentile(arr, 95)), 3)}


def _worst_stage(stage_ms: Dict[str, float]):
    total = sum(stage_ms.values())
    if total <= 0.0:
        return None, None
    stage = max(stage_ms, key=lambda s: stage_ms[s])
    return stage, round(stage_ms[stage] / total, 4)


def _exemplar_doc(rec: dict) -> dict:
    return {
        "trace_id": rec["trace_id"],
        "tenant": rec["tenant"],
        "via": rec["via"],
        "e2e_ms": round(rec["e2e_ms"], 3),
        "stages": {s: round(ms, 3) for s, ms in rec["stages"].items()},
        "detours": rec["detours"],
    }


def lineage_summary() -> Dict[str, Any]:
    """JSON-able roll-up for ``/snapshot.json`` / bench / sts_top."""
    with _lock:
        tenants = {label: {"e2e": list(st["e2e"]),
                           "stage_ms": dict(st["stage_ms"]),
                           "n": st["n"], "cache": st["cache"]}
                   for label, st in _tenants.items()}
        doc: Dict[str, Any] = {
            "armed": _armed,
            "started": _started,
            "outcomes": dict(_outcomes),
            "open": _started - sum(_outcomes.values()),
            "duplicate_completions": _duplicates,
            "tenant_overflow": _tenant_overflow,
            "ring": {"len": len(_ring), "capacity": _cap,
                     "dropped": _ring_dropped},
            "stage_totals_ms": {s: round(ms, 3)
                                for s, ms in _stage_ms.items()},
            "exemplars": [_exemplar_doc(r) for r in _exemplars],
        }
    pooled: List[float] = []
    tdocs: Dict[str, Any] = {}
    for label, st in tenants.items():
        pooled.extend(st["e2e"])
        stage, share = _worst_stage(st["stage_ms"])
        tdocs[label] = {**_pcts(st["e2e"]),
                        "delivered": st["n"],
                        "cache_serves": st["cache"],
                        "worst_stage": stage,
                        "worst_stage_share": share}
    doc["e2e"] = _pcts(pooled)
    stage, share = _worst_stage(doc["stage_totals_ms"])
    doc["worst_stage"] = stage
    doc["worst_stage_share"] = share
    doc["tenants"] = tdocs
    return doc


def trace_events(limit: Optional[int] = None) -> List[dict]:
    """Completed lineage stages as timeline events in the JAX package's
    Chrome-trace input shape (``span`` dicts on the shared
    ``perf_counter`` clock; the tracing plane that exports them is not
    ported yet, ROADMAP Queue A item 5).  Records are striped over a few
    synthetic integer lanes to keep concurrent ticks visually
    separable."""
    recs = records()
    if limit is not None and limit >= 0:
        recs = recs[-limit:]
    events: List[dict] = []
    for rec in recs:
        lane = rec["trace_id"] % _LINEAGE_LANES
        tid = _LINEAGE_TID_BASE + lane
        tname = f"lineage-{lane}"
        for stage, ts, dur in rec["segs"]:
            events.append({
                "kind": "span",
                "name": f"lineage.{stage}",
                "ts": ts,
                "dur": dur,
                "tid": tid,
                "tname": tname,
                "args": {"trace_id": rec["trace_id"],
                         "tenant": rec["tenant"],
                         "via": rec["via"],
                         "outcome": rec["outcome"]},
            })
    return events


def incident_block(limit: int = 64) -> Dict[str, Any]:
    """Newest lineage records + counters for flight-recorder bundles,
    so a crashed pump's recent ticks are forensically reconstructible."""
    recs = records()[-max(int(limit), 0):]
    with _lock:
        counters = {
            "armed": _armed,
            "started": _started,
            "outcomes": dict(_outcomes),
            "open": _started - sum(_outcomes.values()),
            "duplicate_completions": _duplicates,
            "ring_dropped": _ring_dropped,
        }
    return {**counters,
            "records": [{**r, "e2e_ms": round(r["e2e_ms"], 3),
                         "stages": {s: round(ms, 3)
                                    for s, ms in r["stages"].items()},
                         "segs": [(s, round(ts, 6), round(d, 6))
                                  for s, ts, d in r["segs"]]}
                        for r in recs]}
