"""The host-side pieces of the telemetry plane that the serving and
fleet tiers call (counterpart of ``spark_timeseries_tpu/utils/
telemetry.py``): the shared parser of positive numeric ``STS_*`` knobs,
:func:`json_safe`, job heartbeats (:class:`JobProgress`: the fleet
runtime's pump publishes one) and the registry of active jobs, and the
weak registries of live serving sessions, fleet schedulers and fleet
runtimes, which the exporter will read.

The scrape exporter itself (``/snapshot.json``, ``/healthz``,
``/trace.json``) is not ported yet (ROADMAP Queue A item 5): with
``STS_TELEMETRY_PORT`` unset :func:`ensure_started_from_env` does
nothing, and with it set it raises.
"""

from __future__ import annotations

import itertools
import math
import os
import threading
import time
import weakref
from typing import Any, Dict, List, Optional

from . import metrics as _metrics

__all__ = ["env_positive", "json_safe", "JobProgress", "new_job_id",
           "register_job", "finish_job", "active_jobs", "register_session",
           "register_fleet", "register_fleet_runtime",
           "ensure_started_from_env", "DEFAULT_STALE_FACTOR",
           "DEFAULT_EXPECTED_CHUNK_S"]

# EW smoothing factor for the chunk-completion cadence
EW_ALPHA = 0.3

# heartbeat staleness = age > factor * expected chunk cadence
DEFAULT_STALE_FACTOR = 5.0

# cadence assumed for a job whose first chunk has not completed yet
DEFAULT_EXPECTED_CHUNK_S = 60.0


def json_safe(obj: Any) -> Any:
    """Recursively replace non-finite floats with None — strict JSON has
    no Infinity/NaN, and a scrape endpoint must never emit a payload the
    scraper's parser rejects."""
    if isinstance(obj, float):
        return obj if math.isfinite(obj) else None
    if isinstance(obj, dict):
        return {k: json_safe(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [json_safe(v) for v in obj]
    return obj


def env_positive(name: str, cast: type = float, default: Any = None):
    """Parse a positive numeric environment knob: unset (or empty)
    returns ``default``; junk or a non-positive value raises a named
    ValueError."""
    env = os.environ.get(name)
    if not env:
        return default
    try:
        v = cast(env)
        if v <= 0:
            raise ValueError
        return v
    except ValueError:
        kind = "integer" if cast is int else "number"
        raise ValueError(
            f"{name} must be a positive {kind}, got {env!r}") from None


def _stale_factor() -> float:
    return env_positive("STS_TELEMETRY_STALE_FACTOR", float,
                        DEFAULT_STALE_FACTOR)


# ---------------------------------------------------------------------------
# JobProgress: the structured heartbeat one streaming job publishes
# ---------------------------------------------------------------------------

_job_seq = itertools.count(1)


def new_job_id(family: str = "job") -> str:
    """Process-unique, human-scannable job id (``<family>-<pid>-<n>``)."""
    return f"{family}-{os.getpid()}-{next(_job_seq)}"


class JobProgress:
    """Mutable, lock-protected progress/heartbeat record for one
    long-running job (the JAX package's ``engine.stream_fit`` runs; here
    the fleet runtime's pump).

    The job stamps :meth:`heartbeat` as it works (so a hung job shows a
    growing heartbeat age) and :meth:`note_chunk_done` on every
    completed chunk, which feeds the EW-smoothed cadence behind
    :attr:`eta_s`.  Everything is host wall-clock (``time.time``)."""

    def __init__(self, job_id: str, family: str, n_series: int,
                 n_chunks: int, chunk_size: int, *,
                 journal_path: Optional[str] = None,
                 resilient: bool = False):
        self._lock = threading.Lock()
        self.job_id = str(job_id)
        self.family = str(family)
        self.n_series = int(n_series)
        self.n_chunks = int(n_chunks)
        self.chunk_size = int(chunk_size)
        self.journal_path = journal_path
        self.resilient = bool(resilient)
        now = time.time()
        self.started_unix = now
        self.finished_unix: Optional[float] = None
        self.last_heartbeat_unix = now
        self.heartbeat_stage = "submitted"
        self.heartbeat_chunk: Optional[List[int]] = None
        self.status = "running"           # running | done | failed
        self.error: Optional[str] = None
        self.chunks_done = 0
        self.chunks_restored = 0          # journal resume hits
        self.chunks_failed = 0            # declared dead (incl. data)
        self.chunks_quarantined = 0
        self.chunks_degraded = 0
        # OOM-degraded sub-ranges complete/die separately from their
        # parent chunk; counting them into chunks_done/failed would
        # push done past n_chunks and collapse the ETA — they get their
        # own counters (a split chunk whose halves partly die stays in
        # chunks_remaining: honest, slightly pessimistic ETA)
        self.subchunks_done = 0
        self.subchunks_failed = 0
        self.journal_commits = 0
        self.ew_chunk_s: Optional[float] = None
        self._last_done_t: Optional[float] = None

    # -- engine-side mutation -----------------------------------------------

    def heartbeat(self, stage: str,
                  chunk: Optional[tuple] = None) -> None:
        with self._lock:
            self.last_heartbeat_unix = time.time()
            self.heartbeat_stage = str(stage)
            if chunk is not None:
                self.heartbeat_chunk = [int(chunk[0]), int(chunk[1])]

    def note_chunk_done(self, *, restored: bool = False) -> None:
        """One chunk completed (fit or journal-restored): advance the
        done count and fold the completion-to-completion interval into
        the EW cadence (restored chunks are near-instant and would fake
        an optimistic cadence, so they only count, never smooth)."""
        now = time.time()
        with self._lock:
            self.last_heartbeat_unix = now
            self.chunks_done += 1
            if restored:
                self.chunks_restored += 1
                self.heartbeat_stage = "journal_restore"
            else:
                self.heartbeat_stage = "chunk_done"
                prev = self._last_done_t if self._last_done_t is not None \
                    else self.started_unix
                dt = max(now - prev, 0.0)
                self.ew_chunk_s = dt if self.ew_chunk_s is None \
                    else EW_ALPHA * dt + (1.0 - EW_ALPHA) * self.ew_chunk_s
                self._last_done_t = now

    def note(self, *, failed: int = 0, quarantined: int = 0,
             degraded: int = 0, journal_commits: int = 0,
             subchunks_done: int = 0, subchunks_failed: int = 0) -> None:
        with self._lock:
            self.chunks_failed += failed
            self.chunks_quarantined += quarantined
            self.chunks_degraded += degraded
            self.journal_commits += journal_commits
            self.subchunks_done += subchunks_done
            self.subchunks_failed += subchunks_failed
            if subchunks_done or subchunks_failed:
                self.last_heartbeat_unix = time.time()

    def finish(self, status: str, error: Optional[str] = None) -> None:
        with self._lock:
            self.status = status
            self.error = error
            self.finished_unix = time.time()
            self.last_heartbeat_unix = self.finished_unix
            self.heartbeat_stage = status

    # -- derived views ------------------------------------------------------

    @property
    def chunks_remaining(self) -> int:
        return max(self.n_chunks - self.chunks_done - self.chunks_failed, 0)

    @property
    def eta_s(self) -> Optional[float]:
        """Seconds until the stream drains at the EW cadence (None until
        the first non-restored chunk completes)."""
        if self.status != "running" or self.ew_chunk_s is None:
            return None
        return self.ew_chunk_s * self.chunks_remaining

    @property
    def throughput_series_per_s(self) -> Optional[float]:
        if self.ew_chunk_s is None or self.ew_chunk_s <= 0:
            return None
        return self.chunk_size / self.ew_chunk_s

    def heartbeat_age_s(self) -> float:
        return max(time.time() - self.last_heartbeat_unix, 0.0)

    def stale_after_s(self, factor: Optional[float] = None) -> float:
        """The heartbeat-age threshold past which this job reports
        unhealthy: ``factor``x the expected chunk cadence (the EW
        estimate, or :data:`DEFAULT_EXPECTED_CHUNK_S` before the first
        chunk completes)."""
        f = _stale_factor() if factor is None else float(factor)
        cadence = self.ew_chunk_s if self.ew_chunk_s \
            else DEFAULT_EXPECTED_CHUNK_S
        return f * max(cadence, 1.0)

    def is_stale(self, factor: Optional[float] = None) -> bool:
        return self.status == "running" \
            and self.heartbeat_age_s() > self.stale_after_s(factor)

    def to_dict(self) -> Dict[str, Any]:
        with self._lock:
            eta = self.eta_s
            d = {
                "job_id": self.job_id,
                "family": self.family,
                "status": self.status,
                "resilient": self.resilient,
                "n_series": self.n_series,
                "chunk_size": self.chunk_size,
                "chunks_total": self.n_chunks,
                "chunks_done": self.chunks_done,
                "chunks_restored": self.chunks_restored,
                "chunks_failed": self.chunks_failed,
                "chunks_quarantined": self.chunks_quarantined,
                "chunks_degraded": self.chunks_degraded,
                "subchunks_done": self.subchunks_done,
                "subchunks_failed": self.subchunks_failed,
                "journal_commits": self.journal_commits,
                "journal_path": self.journal_path,
                "started_unix": self.started_unix,
                "finished_unix": self.finished_unix,
                "elapsed_s": round((self.finished_unix or time.time())
                                   - self.started_unix, 3),
                "heartbeat_stage": self.heartbeat_stage,
                "heartbeat_chunk": self.heartbeat_chunk,
                "heartbeat_age_s": round(self.heartbeat_age_s(), 3),
                "stale_after_s": round(self.stale_after_s(), 3),
                "ew_chunk_s": self.ew_chunk_s,
                "eta_s": round(eta, 3) if eta is not None else None,
                "throughput_series_per_s": self.throughput_series_per_s,
                "error": self.error,
            }
        return json_safe(d)


# ---------------------------------------------------------------------------
# job / session registries (what the exporter walks)
# ---------------------------------------------------------------------------

_jobs_lock = threading.Lock()
_active_jobs: Dict[str, JobProgress] = {}


def register_job(progress: JobProgress,
                 registry: Optional[Any] = None) -> JobProgress:
    reg = registry if registry is not None else _metrics.get_registry()
    with _jobs_lock:
        _active_jobs[progress.job_id] = progress
        n = len(_active_jobs)
    reg.set_gauge("engine.jobs_active", n)
    return progress


def finish_job(progress: JobProgress, status: str,
               error: Optional[str] = None,
               registry: Optional[Any] = None) -> None:
    reg = registry if registry is not None else _metrics.get_registry()
    progress.finish(status, error)
    with _jobs_lock:
        _active_jobs.pop(progress.job_id, None)
        n = len(_active_jobs)
    reg.set_gauge("engine.jobs_active", n)


def active_jobs() -> List[JobProgress]:
    with _jobs_lock:
        return list(_active_jobs.values())


# live ServingSessions, weakly referenced (the registry must never keep
# a session and its device buffers alive), for the exporter's session
# summaries when it is ported
_sessions_lock = threading.Lock()
_sessions: "weakref.WeakSet" = weakref.WeakSet()


def register_session(session: Any) -> None:
    with _sessions_lock:
        _sessions.add(session)


# live FleetSchedulers, weakly referenced like the sessions (the
# exporter must never pin a scheduler and its tenants' device buffers)
_fleets_lock = threading.Lock()
_fleets: "weakref.WeakSet" = weakref.WeakSet()

# live FleetRuntimes (statespace.runtime), whose pump heartbeats the
# exporter's health route reads; weakly referenced like the fleets
_runtimes_lock = threading.Lock()
_runtimes: "weakref.WeakSet" = weakref.WeakSet()


def register_fleet(fleet: Any) -> None:
    with _fleets_lock:
        _fleets.add(fleet)


def register_fleet_runtime(runtime: Any) -> None:
    with _runtimes_lock:
        _runtimes.add(runtime)


def ensure_started_from_env() -> None:
    """The ``STS_TELEMETRY_PORT`` opt-in, called at serving session
    construction: unset is a no-op; set, it raises, because the exporter
    that would serve on that port is not ported yet."""
    env = os.environ.get("STS_TELEMETRY_PORT")
    if not env:
        return None
    raise NotImplementedError(
        f"STS_TELEMETRY_PORT={env!r} asks for the telemetry exporter, which "
        f"is not ported yet (ROADMAP Queue A item 5); unset it")
