"""Flight recorder: a forensic incident bundle for every failure
(counterpart of ``spark_timeseries_tpu/utils/flightrec.py``).

On every incident the process writes one self-contained JSON bundle to
``STS_INCIDENT_DIR`` with what an operator needs for triage: the metrics
registry snapshot, the trace ring as Chrome trace JSON (the newest
``STS_INCIDENT_TRACE_EVENTS`` events, default 4096: load the bundle's
``trace`` member in Perfetto to see what ran before the failure), the
failing job's ``JobProgress`` and every other active job, the exception
(type, message, truncated traceback), the manifest and committed ranges
of a chunk journal when one is named, the newest tick-lineage records,
and the process identity (Python, torch and its CUDA build, the card's
name and compute capability when CUDA is initialised, ``STS_*``
environment).

Bundles are written with the tmp + fsync + rename discipline of
:func:`~spark_timeseries_tpu_torch.utils.durability.atomic_write_json`
into a bounded directory: the newest ``STS_INCIDENT_KEEP`` (default 20)
are kept, older ones pruned.  ``incidents.written`` counts written
bundles, ``incidents.errors`` recorder failures (the recorder never
raises into the code it observes).  Off (nothing written) unless
``STS_INCIDENT_DIR`` is set or :func:`configure` names a directory.
"""

from __future__ import annotations

import json
import os
import platform as _platform
import sys
import time
import traceback as _traceback
from typing import Any, Dict, List, Optional

from . import durability as _durability
from . import metrics as _metrics
from . import telemetry as _telemetry

__all__ = ["INCIDENT_FORMAT", "DEFAULT_KEEP", "REQUIRED_KEYS", "configure",
           "incident_dir", "enabled", "record_incident", "list_incidents",
           "load_incident", "validate_bundle"]

INCIDENT_FORMAT = 1

# newest-K retention (STS_INCIDENT_KEEP overrides)
DEFAULT_KEEP = 20

# newest trace-ring events embedded per bundle (STS_INCIDENT_TRACE_EVENTS
# overrides); the full 65536-event ring would make every bundle ~10 MB
DEFAULT_TRACE_EVENTS = 4096

# newest completed tick-lineage records embedded per bundle
# (STS_INCIDENT_LINEAGE_RECORDS overrides)
DEFAULT_LINEAGE_RECORDS = 64

# top-level keys every schema-valid bundle carries
REQUIRED_KEYS = ("format", "kind", "time_unix", "time_iso", "pid",
                 "exception", "job", "jobs", "journal", "registry",
                 "trace", "config")

_PREFIX = "incident_"
_configured_dir: Optional[str] = None


def configure(path: Optional[str]) -> Optional[str]:
    """Set (or with None, clear) the incident directory in-process,
    overriding ``STS_INCIDENT_DIR``.  Returns the effective directory."""
    global _configured_dir
    _configured_dir = path
    return incident_dir()


def incident_dir() -> Optional[str]:
    """The armed incident directory (:func:`configure`, else
    ``STS_INCIDENT_DIR``), or None (recorder off)."""
    if _configured_dir:
        return _configured_dir
    return os.environ.get("STS_INCIDENT_DIR") or None


def enabled() -> bool:
    return incident_dir() is not None


def _keep() -> int:
    return _telemetry.env_positive("STS_INCIDENT_KEEP", int, DEFAULT_KEEP)


def _sanitize_kind(kind: str) -> str:
    return "".join(ch if ch.isalnum() or ch in "_-" else "_"
                   for ch in str(kind)) or "incident"


def _exception_block(exc: Optional[BaseException]) -> Optional[dict]:
    if exc is None:
        return None
    tb = "".join(_traceback.format_exception(type(exc), exc,
                                             exc.__traceback__))
    return {"type": type(exc).__name__, "message": str(exc)[:2000],
            "traceback": tb[-8000:]}


def _journal_block(journal_path: Optional[str]) -> Optional[dict]:
    """Read-only view of a chunk journal: manifest and committed ranges
    (the recorder never writes inside the journal directory)."""
    if not journal_path or not os.path.isdir(journal_path):
        return None
    block: Dict[str, Any] = {"path": journal_path}
    try:
        mpath = os.path.join(journal_path,
                             _durability.CHUNK_JOURNAL_MANIFEST)
        if os.path.exists(mpath):
            with open(mpath) as f:
                block["manifest"] = json.load(f)
        ranges = [name[len("chunk_"):-len(".ok")]
                  for name in sorted(os.listdir(journal_path))
                  if name.endswith(".ok")]
        block["n_committed"] = len(ranges)
        block["committed"] = ranges[:64]
    except Exception as e:  # noqa: BLE001 — a half-readable journal
        # still yields a partial block, never a recorder failure
        block["read_error"] = f"{type(e).__name__}: {e}"
    return block


def _config_block() -> dict:
    cfg: Dict[str, Any] = {
        "python": sys.version.split()[0],
        "platform": _platform.platform(),
        "argv": sys.argv[:8],
        "env": {k: v for k, v in sorted(os.environ.items())
                if k.startswith(("STS_", "CUDA_VISIBLE_DEVICES"))},
    }
    torch = sys.modules.get("torch")
    if torch is not None:
        cfg["torch_version"] = getattr(torch, "__version__", None)
        cfg["torch_cuda"] = getattr(torch.version, "cuda", None)
        try:
            # only a card CUDA already initialised: the recorder must not
            # be the call that creates a context
            if torch.cuda.is_initialized():
                i = torch.cuda.current_device()
                cfg["cuda_device"] = {
                    "index": i, "name": torch.cuda.get_device_name(i),
                    "capability": list(torch.cuda.get_device_capability(i))}
        except Exception:  # noqa: BLE001 — identity is best effort
            pass
    return cfg


def _trace_block() -> dict:
    from . import tracing as _tracing

    # junk raises (the env_positive contract): caught by
    # record_incident's guard and counted as incidents.errors
    limit = _telemetry.env_positive("STS_INCIDENT_TRACE_EVENTS", int,
                                    DEFAULT_TRACE_EVENTS)
    return _tracing.to_chrome_trace(limit=limit)


def _lineage_block() -> dict:
    from . import lineage as _lineage

    limit = _telemetry.env_positive("STS_INCIDENT_LINEAGE_RECORDS", int,
                                    DEFAULT_LINEAGE_RECORDS)
    return _lineage.incident_block(limit=limit)


def record_incident(kind: str, *, exc: Optional[BaseException] = None,
                    job: Optional[Any] = None,
                    journal_path: Optional[str] = None,
                    extra: Optional[Dict[str, Any]] = None,
                    registry: Optional[Any] = None) -> Optional[str]:
    """Write one incident bundle; returns its path, or None when the
    recorder is off or the write failed (counted, never raised).

    ``job`` is the failing ``telemetry.JobProgress`` (every other active
    job is bundled too); ``extra`` is a JSON-able dict merged under the
    bundle's ``"extra"`` key."""
    directory = incident_dir()
    if not directory:
        return None
    reg = registry if registry is not None else _metrics.get_registry()
    try:
        # parse retention up front: a misconfigured STS_INCIDENT_KEEP
        # must not leave a bundle the prune pass then cannot bound
        keep = _keep()
        now = time.time()
        bundle: Dict[str, Any] = {
            "format": INCIDENT_FORMAT,
            "kind": str(kind),
            "time_unix": now,
            "time_iso": time.strftime("%Y-%m-%dT%H:%M:%SZ",
                                      time.gmtime(now)),
            "pid": os.getpid(),
            "exception": _exception_block(exc),
            "job": job.to_dict() if job is not None else None,
            "jobs": [p.to_dict() for p in _telemetry.active_jobs()],
            "journal": _journal_block(journal_path),
            "registry": _telemetry.json_safe(reg.snapshot()),
            "trace": _trace_block(),
            "lineage": _lineage_block(),
            "config": _config_block(),
        }
        if extra is not None:
            bundle["extra"] = _telemetry.json_safe(extra)
        os.makedirs(directory, exist_ok=True)
        name = (f"{_PREFIX}{time.time_ns():020d}_{os.getpid()}_"
                f"{_sanitize_kind(kind)}.json")
        path = os.path.join(directory, name)
        _durability.atomic_write_json(path, bundle)
        reg.inc("incidents.written")
        _metrics.trace_instant("flightrec.incident",
                               {"kind": str(kind), "file": name})
        _prune(directory, keep)
        return path
    except Exception:  # noqa: BLE001 — see docstring
        try:
            reg.inc("incidents.errors")
        except Exception:  # noqa: BLE001 — truly last resort
            pass
        return None


def _prune(directory: str, keep: int) -> None:
    names = sorted(n for n in os.listdir(directory)
                   if n.startswith(_PREFIX) and n.endswith(".json"))
    for name in names[:-keep] if len(names) > keep else []:
        try:
            os.remove(os.path.join(directory, name))
        except OSError:
            pass


def list_incidents(directory: Optional[str] = None,
                   limit: Optional[int] = None) -> List[Dict[str, Any]]:
    """Newest-first index of bundles in the incident directory:
    filename-derived metadata only (kind, written-at, size), cheap
    enough for every ``/snapshot.json`` scrape."""
    d = directory or incident_dir()
    if not d or not os.path.isdir(d):
        return []
    names = sorted((n for n in os.listdir(d)
                    if n.startswith(_PREFIX) and n.endswith(".json")),
                   reverse=True)
    if limit is not None:
        names = names[:limit]
    out = []
    for name in names:
        parts = name[len(_PREFIX):-len(".json")].split("_", 2)
        entry: Dict[str, Any] = {"file": name,
                                 "path": os.path.join(d, name)}
        try:
            entry["time_unix"] = int(parts[0]) / 1e9
            entry["pid"] = int(parts[1])
            entry["kind"] = parts[2]
            entry["bytes"] = os.path.getsize(entry["path"])
        except (IndexError, ValueError, OSError):
            pass
        out.append(entry)
    return out


def load_incident(path: str) -> Dict[str, Any]:
    with open(path) as f:
        return json.load(f)


def validate_bundle(bundle: Dict[str, Any]) -> List[str]:
    """Schema check: the list of violations (empty = schema-valid)."""
    problems = []
    if not isinstance(bundle, dict):
        return ["bundle is not a JSON object"]
    for key in REQUIRED_KEYS:
        if key not in bundle:
            problems.append(f"missing key {key!r}")
    if bundle.get("format") != INCIDENT_FORMAT:
        problems.append(f"format {bundle.get('format')!r} != "
                        f"{INCIDENT_FORMAT}")
    if not isinstance(bundle.get("kind"), str) or not bundle.get("kind"):
        problems.append("kind must be a non-empty string")
    if not isinstance(bundle.get("time_unix"), (int, float)):
        problems.append("time_unix must be a number")
    exc = bundle.get("exception")
    if exc is not None and (not isinstance(exc, dict)
                            or "type" not in exc
                            or "traceback" not in exc):
        problems.append("exception must be null or carry type/traceback")
    reg = bundle.get("registry")
    if not isinstance(reg, dict) or "counters" not in reg:
        problems.append("registry must be a snapshot dict with counters")
    tr = bundle.get("trace")
    if not isinstance(tr, dict) or "traceEvents" not in tr:
        problems.append("trace must be a Chrome trace object")
    if not isinstance(bundle.get("config"), dict):
        problems.append("config must be a dict")
    if not isinstance(bundle.get("jobs"), list):
        problems.append("jobs must be a list")
    lin = bundle.get("lineage")
    if lin is not None and (not isinstance(lin, dict)
                            or "records" not in lin):
        problems.append("lineage, when present, must carry records")
    return problems
