"""Live telemetry plane: an HTTP scrape endpoint over the running process
(counterpart of ``spark_timeseries_tpu/utils/telemetry.py``).

- a **scrape server** (:func:`start` / ``STS_TELEMETRY_PORT``): a stdlib
  ``http.server`` daemon thread serving

  ===================  ====================================================
  route                payload
  ===================  ====================================================
  ``/metrics``         Prometheus text (``metrics.to_prometheus``)
  ``/snapshot.json``   registry snapshot + active job progress + serving
                       session and fleet summaries + recent incident index
                       + kernel builds and launches
  ``/trace.json``      the trace ring as Chrome trace JSON
                       (``?limit=N`` keeps the newest N events)
  ``/healthz``         liveness + per-job heartbeat staleness (HTTP 503
                       when any active job's or fleet pump's heartbeat is
                       stale)
  ===================  ====================================================

  No thread runs until :func:`start` is called, or a job or session
  entry point (``engine.stream_fit``, ``ServingSession``,
  ``FleetScheduler``) sees ``STS_TELEMETRY_PORT`` in the environment
  (:func:`ensure_started_from_env`).  Strictly host-side: the exporter
  reads registries and host-side progress structs, never a tensor, and
  a scrape never initialises CUDA or builds a kernel.

- **job heartbeats** (:class:`JobProgress`): ``engine.stream_fit``
  registers one per run and stamps it as each chunk is fitted, so a hung
  chunk is visible (heartbeat age grows) before its deadline fires.
  Chunk completions feed an EW-smoothed chunk cadence, which yields the
  ETA in ``/snapshot.json``.  Staleness (``/healthz``): a heartbeat older
  than ``STS_TELEMETRY_STALE_FACTOR`` (default 5) times the expected
  chunk cadence (the EW estimate once a chunk has completed,
  :data:`DEFAULT_EXPECTED_CHUNK_S` before that) reports the job, and the
  process, unhealthy.

- **serving session, fleet and fleet runtime registries**: weakly
  tracked, summarized into ``/snapshot.json`` (and the runtimes' pump
  heartbeats into ``/healthz``); they vanish when garbage-collected,
  never pinned.

``/snapshot.json`` carries the JAX document's keys, with ``kernels``
(:func:`kernel_stats`: kernel builds, build-cache hits and the kernel
wrappers' launch counts) in place of its ``jax`` block of XLA compile
counters, which eager PyTorch has no counterpart of.  The incident index
comes from :mod:`~spark_timeseries_tpu_torch.utils.flightrec` (imported
at call time: the two modules reference each other).
"""

from __future__ import annotations

import itertools
import json
import math
import os
import sys
import threading
import time
import weakref
from collections import deque
from typing import Any, Dict, List, Optional

from . import metrics as _metrics

__all__ = [
    "JobProgress", "TelemetryAlreadyStarted", "TelemetryServer",
    "start", "stop", "server", "ensure_started_from_env",
    "new_job_id", "register_job", "finish_job", "active_jobs",
    "recent_jobs", "register_session", "live_sessions",
    "session_summaries", "register_fleet", "live_fleets",
    "fleet_summaries", "register_fleet_runtime", "live_fleet_runtimes",
    "fleet_runtime_rows",
    "snapshot_doc", "healthz_doc", "kernel_stats", "json_safe",
    "env_positive",
    "DEFAULT_STALE_FACTOR", "DEFAULT_EXPECTED_CHUNK_S", "RECENT_JOBS_KEPT",
]

# EW smoothing factor for the chunk-completion cadence (higher = more
# reactive ETA, noisier under jittery chunk times).
EW_ALPHA = 0.3

# heartbeat staleness = age > factor * expected chunk cadence
DEFAULT_STALE_FACTOR = 5.0

# cadence assumed for a job whose first chunk hasn't completed yet (a
# first chunk may pay the kernels' build, so the pre-cadence grace must
# be generous; 5x60s = 5 minutes by default)
DEFAULT_EXPECTED_CHUNK_S = 60.0

# finished jobs kept for /snapshot.json context (bounded)
RECENT_JOBS_KEPT = 16


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
    ValueError.  The one implementation behind every ``STS_*`` numeric
    knob the telemetry plane reads (staleness factor, serving SLO,
    incident retention/trace budget), so the error contract cannot
    drift between them."""
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
    long-running job (an ``engine.stream_fit`` run, a fleet runtime's
    pump).

    The engine stamps :meth:`heartbeat` as each chunk is fitted (so a
    hung chunk shows a growing heartbeat age while the watchdog counts
    down) and calls :meth:`note_chunk_done` on every completion, which
    feeds the EW-smoothed chunk cadence behind :attr:`eta_s`.
    Everything is host wall-clock (``time.time``).
    """

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
# job / session registries (what /snapshot.json walks)
# ---------------------------------------------------------------------------

_jobs_lock = threading.Lock()
_active_jobs: Dict[str, JobProgress] = {}
_recent_jobs: deque = deque(maxlen=RECENT_JOBS_KEPT)


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
        _recent_jobs.append(progress)
        n = len(_active_jobs)
    reg.set_gauge("engine.jobs_active", n)


def active_jobs() -> List[JobProgress]:
    with _jobs_lock:
        return list(_active_jobs.values())


def recent_jobs() -> List[JobProgress]:
    with _jobs_lock:
        return list(_recent_jobs)


# live ServingSessions, weakly referenced: the telemetry plane must
# never keep a session (and its device buffers) alive.  The lock
# serializes registration against the exporter thread's copy — a bare
# WeakSet.add racing list(set) raises "Set changed size during
# iteration", which would turn /snapshot.json and /healthz scrapes
# into spurious 500s (GC-driven removals are deferred internally by
# WeakSet's own iteration guard; only add needs the lock).
_sessions_lock = threading.Lock()
_sessions: "weakref.WeakSet" = weakref.WeakSet()


def register_session(session: Any) -> None:
    with _sessions_lock:
        _sessions.add(session)


def live_sessions() -> List[Any]:
    with _sessions_lock:
        return list(_sessions)


def session_summaries() -> List[Dict[str, Any]]:
    """One summary dict per live session (``telemetry_summary()``),
    defensively: a session mid-mutation must degrade to an error entry,
    never take the scrape down."""
    out = []
    for sess in live_sessions():
        try:
            out.append(json_safe(sess.telemetry_summary()))
        except Exception as e:  # noqa: BLE001 — scrape isolation
            out.append({"error": f"{type(e).__name__}: {e}"})
    return out


# live FleetSchedulers, weakly referenced like the sessions (the
# exporter must never pin a scheduler and its tenants' device buffers)
_fleets_lock = threading.Lock()
_fleets: "weakref.WeakSet" = weakref.WeakSet()

# live FleetRuntimes (statespace.runtime): the /healthz route consults
# their pump heartbeats — a stale pump answers 503 so an external
# supervisor can restart the process.  Same weak-reference + lock
# discipline as the fleets above.
_runtimes_lock = threading.Lock()
_runtimes: "weakref.WeakSet" = weakref.WeakSet()


def register_fleet(fleet: Any) -> None:
    with _fleets_lock:
        _fleets.add(fleet)


def live_fleets() -> List[Any]:
    with _fleets_lock:
        return list(_fleets)


def register_fleet_runtime(runtime: Any) -> None:
    with _runtimes_lock:
        _runtimes.add(runtime)


def live_fleet_runtimes() -> List[Any]:
    with _runtimes_lock:
        return list(_runtimes)


def fleet_runtime_rows() -> List[Dict[str, Any]]:
    """One ``pump_health()`` row per live runtime for ``/healthz`` —
    scrape isolation as everywhere else."""
    out = []
    for rt in live_fleet_runtimes():
        try:
            out.append(json_safe(rt.pump_health()))
        except Exception as e:  # noqa: BLE001 — scrape isolation
            out.append({"error": f"{type(e).__name__}: {e}"})
    return out


def fleet_summaries() -> List[Dict[str, Any]]:
    """One per-fleet panel (``telemetry_summary()``: aggregate p95/SLO/
    shed state + per-tenant rows) for ``/snapshot.json`` — scrape
    isolation as for sessions."""
    out = []
    for fl in live_fleets():
        try:
            out.append(json_safe(fl.telemetry_summary()))
        except Exception as e:  # noqa: BLE001 — scrape isolation
            out.append({"error": f"{type(e).__name__}: {e}"})
    return out


# ---------------------------------------------------------------------------
# payload builders (route handlers call these; tests call them directly)
# ---------------------------------------------------------------------------

_started_unix = time.time()


def kernel_stats(registry: Optional[Any] = None) -> Dict[str, Any]:
    """The kernel block of ``/snapshot.json`` and of the engine CLI's
    report: CUDA libraries built (nvcc) and found built on disk in this
    process (``kernels.builds`` / ``kernels.cache_hits``), the build
    directory, torch's version and each kernel wrapper's launch count.  Reads modules
    already imported and imports none (a scrape must not build or load
    a kernel): a wrapper whose module is not loaded has launched 0."""
    reg = registry if registry is not None else _metrics.get_registry()
    counters = reg.snapshot()["counters"]
    pkg = __name__.rsplit(".", 2)[0]
    build = sys.modules.get(f"{pkg}._build")
    ne = sys.modules.get(f"{pkg}.ops.arma_ne")
    hw = sys.modules.get(f"{pkg}.ops.hw_sse")
    wrappers = {
        "arma_lm_fit": (ne, "fit_css_lm"),
        "arma_ne": (ne, "normal_equations"),
        "arma_css": (ne, "css_cost"),
        "hw_box_fit": (hw, "box_fit"),
        "hw_sse": (hw, "value_and_grad"),
    }
    torch = sys.modules.get("torch")
    return {
        "builds": int(counters.get("kernels.builds", 0)),
        "cache_hits": int(counters.get("kernels.cache_hits", 0)),
        "build_dir": str(build.BUILD_DIR) if build is not None else None,
        "torch_version": getattr(torch, "__version__", None),
        "launches": {name: int(getattr(getattr(mod, fn, None),
                                       "launches", 0))
                     for name, (mod, fn) in wrappers.items()},
    }


def snapshot_doc(registry: Optional[Any] = None) -> Dict[str, Any]:
    """The ``/snapshot.json`` payload: registry snapshot, kernel builds
    and launches, jobs (active + recent), serving session and fleet
    summaries, recent incident index, and process identity."""
    reg = registry if registry is not None else _metrics.get_registry()
    snap = reg.snapshot()
    doc: Dict[str, Any] = {
        "format": 1,
        "pid": os.getpid(),
        "time_unix": time.time(),
        "uptime_s": round(time.time() - _started_unix, 3),
        "registry": json_safe(snap),
        "kernels": kernel_stats(reg),
        "jobs": [p.to_dict() for p in active_jobs()],
        "recent_jobs": [p.to_dict() for p in recent_jobs()],
        "serving_sessions": session_summaries(),
        "fleets": fleet_summaries(),
    }
    # performance attribution: exclusive span self-times with
    # per-subsystem rollups from the process trace ring, plus the
    # streaming engine's host-overhead / bubble gauges where recorded
    try:
        from . import tracing as _tracing
        gauges = snap.get("gauges", {})
        doc["attribution"] = {
            "self_times": _tracing.self_time_report(8),
            "engine": {k: gauges[k]
                       for k in ("engine.host_overhead_frac",
                                 "engine.bubble_ms_total")
                       if k in gauges},
        }
    except Exception as e:  # noqa: BLE001 — scrape isolation
        doc["attribution"] = {"error": f"{type(e).__name__}: {e}"}
    # tick lineage: per-tenant end-to-end latency with stage
    # decomposition and slowest-tick exemplars
    try:
        from . import lineage as _lineage
        doc["lineage"] = json_safe(_lineage.lineage_summary())
    except Exception as e:  # noqa: BLE001 — scrape isolation
        doc["lineage"] = {"error": f"{type(e).__name__}: {e}"}
    try:
        from . import flightrec as _flightrec
        doc["incident_dir"] = _flightrec.incident_dir()
        doc["incidents"] = _flightrec.list_incidents(limit=8)
    except Exception as e:  # noqa: BLE001 — scrape isolation
        doc["incidents"] = [{"error": f"{type(e).__name__}: {e}"}]
    return doc


def healthz_doc(registry: Optional[Any] = None) -> Dict[str, Any]:
    """The ``/healthz`` payload.  ``status`` is ``"ok"`` unless any
    active job's heartbeat is stale (older than the staleness threshold
    — see :meth:`JobProgress.stale_after_s`) or any fleet runtime's
    pump heartbeat is stale (same ``STS_TELEMETRY_STALE_FACTOR``
    contract; see ``FleetRuntime.stale_after_s``), in which case it is
    ``"stale"`` and the HTTP route answers 503 — the signal an external
    supervisor restarts the process on."""
    jobs = []
    any_stale = False
    for p in active_jobs():
        stale = p.is_stale()
        any_stale = any_stale or stale
        jobs.append({
            "job_id": p.job_id,
            "stage": p.heartbeat_stage,
            "heartbeat_age_s": round(p.heartbeat_age_s(), 3),
            "stale_after_s": round(p.stale_after_s(), 3),
            "stale": stale,
        })
    pumps = fleet_runtime_rows()
    for row in pumps:
        any_stale = any_stale or bool(row.get("stale"))
    return {
        "status": "stale" if any_stale else "ok",
        "pid": os.getpid(),
        "time_unix": time.time(),
        "uptime_s": round(time.time() - _started_unix, 3),
        "n_active_jobs": len(jobs),
        "n_serving_sessions": len(live_sessions()),
        "n_fleet_pumps": len(pumps),
        "jobs": jobs,
        "fleet_pumps": pumps,
    }


# ---------------------------------------------------------------------------
# the scrape server
# ---------------------------------------------------------------------------

class TelemetryAlreadyStarted(RuntimeError):
    """:func:`start` was called while an exporter is already serving.
    One process gets one scrape endpoint; :func:`stop` the old one
    first (double-binding would split scrapes across two ports)."""


def _trace_limit(query: str) -> Optional[int]:
    """``?limit=N`` for ``/trace.json``; a malformed value raises (the
    route answers 400) rather than silently serving the unbounded
    ~10 MB ring the limit exists to prevent."""
    for part in query.split("&"):
        if part.startswith("limit="):
            raw = part[len("limit="):]
            try:
                return max(1, int(raw))
            except ValueError:
                raise ValueError(
                    f"limit must be an integer, got {raw!r}") from None
    return None


class TelemetryServer:
    """A running scrape endpoint: stdlib ``ThreadingHTTPServer`` on a
    daemon thread.  Build via :func:`start`; :meth:`stop` shuts the
    socket down and joins the thread (bounded)."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 registry: Optional[Any] = None):
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

        reg = registry if registry is not None else _metrics.get_registry()
        self._reg = reg
        outer = self

        class Handler(BaseHTTPRequestHandler):
            server_version = "sts-telemetry/1"

            def log_message(self, *args):  # silence stderr access logs
                pass

            def do_GET(self):
                t0 = time.perf_counter()
                raw = self.path.split("?", 1)
                route = raw[0]
                query = raw[1] if len(raw) > 1 else ""
                status = 200
                ctype = "application/json"
                try:
                    if route == "/metrics":
                        body = outer._reg.to_prometheus().encode()
                        ctype = ("text/plain; version=0.0.4; "
                                 "charset=utf-8")
                    elif route == "/snapshot.json":
                        body = json.dumps(
                            snapshot_doc(outer._reg)).encode()
                    elif route == "/trace.json":
                        from . import tracing as _tracing
                        try:
                            limit = _trace_limit(query)
                        except ValueError as e:
                            status = 400
                            body = json.dumps({"error": str(e)}).encode()
                        else:
                            body = json.dumps(_tracing.to_chrome_trace(
                                limit=limit)).encode()
                    elif route in ("/healthz", "/health"):
                        doc = healthz_doc(outer._reg)
                        status = 200 if doc["status"] == "ok" else 503
                        body = json.dumps(doc).encode()
                    elif route == "/":
                        body = json.dumps({
                            "routes": ["/metrics", "/snapshot.json",
                                       "/trace.json", "/healthz"],
                            "pid": os.getpid()}).encode()
                    else:
                        status = 404
                        body = json.dumps(
                            {"error": f"no route {route!r}"}).encode()
                except Exception as e:  # noqa: BLE001 — a scrape bug
                    # must answer 500, never kill the server thread
                    status = 500
                    body = json.dumps(
                        {"error": f"{type(e).__name__}: {e}"}).encode()
                    outer._reg.inc("telemetry.scrape_errors")
                self.send_response(status)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                try:
                    self.wfile.write(body)
                finally:
                    outer._reg.inc("telemetry.scrapes")
                    outer._reg.record("telemetry.scrape_s",
                                      time.perf_counter() - t0)

        self._httpd = ThreadingHTTPServer((host, int(port)), Handler)
        self._httpd.daemon_threads = True
        self._thread = threading.Thread(
            target=self._httpd.serve_forever,
            kwargs={"poll_interval": 0.1},
            name="sts-telemetry", daemon=True)
        self._thread.start()
        reg.set_gauge("telemetry.port", self.port)

    @property
    def port(self) -> int:
        return int(self._httpd.server_address[1])

    @property
    def url(self) -> str:
        host = self._httpd.server_address[0]
        return f"http://{host}:{self.port}"

    @property
    def alive(self) -> bool:
        return self._thread.is_alive()

    def stop(self, timeout: float = 5.0) -> bool:
        """Shut down and join the server thread; True when the thread
        exited within ``timeout`` (no dangling thread)."""
        self._httpd.shutdown()
        self._httpd.server_close()
        self._thread.join(timeout)
        self._reg.set_gauge("telemetry.port", 0.0)
        return not self._thread.is_alive()


_server_lock = threading.Lock()
_server: Optional[TelemetryServer] = None


def server() -> Optional[TelemetryServer]:
    """The process' running exporter, or None."""
    return _server


def start(port: int = 0, host: str = "127.0.0.1",
          registry: Optional[Any] = None) -> TelemetryServer:
    """Start the process' scrape endpoint (``port=0`` picks a free
    port; read it back from ``.port``/``.url``).  Raises
    :class:`TelemetryAlreadyStarted` when one is already serving."""
    global _server
    with _server_lock:
        if _server is not None and _server.alive:
            raise TelemetryAlreadyStarted(
                f"telemetry exporter already serving at {_server.url}; "
                f"telemetry.stop() it before starting another")
        srv = TelemetryServer(host=host, port=port, registry=registry)
        _server = srv
    return srv


def stop(timeout: float = 5.0) -> bool:
    """Stop the module-level exporter (no-op → True when none runs)."""
    global _server
    with _server_lock:
        srv, _server = _server, None
    if srv is None:
        return True
    return srv.stop(timeout)


def ensure_started_from_env() -> Optional[TelemetryServer]:
    """The ``STS_TELEMETRY_PORT`` opt-in: called by the library's
    long-running entry points (``engine.stream_fit``, serving session
    construction).  Unset or already-started is a no-op; a junk value
    raises a named ValueError; a bind failure (port taken) is counted
    (``telemetry.start_errors``) and swallowed — observability must not
    take the job down."""
    env = os.environ.get("STS_TELEMETRY_PORT")
    if not env:
        return None
    if _server is not None and _server.alive:
        return _server
    try:
        port = int(env)
        if port < 0 or port > 65535:
            raise ValueError
    except ValueError:
        raise ValueError(
            f"STS_TELEMETRY_PORT must be a port number in [0, 65535] "
            f"(0 = pick a free port), got {env!r}") from None
    try:
        return start(port=port)
    except TelemetryAlreadyStarted:
        return _server
    except OSError:
        _metrics.inc("telemetry.start_errors")
        return None
