"""Durability layer for streaming fit jobs (counterpart of
``spark_timeseries_tpu/utils/durability.py``): the crash-consistent
chunk journal, resume validation, the deterministic retry backoff and
the failure taxonomy the engine's watchdog and degradation route on.
Everything here is host-side; the engine's
``stream_fit(..., journal=...)`` builds on it, and the fleet runtime and
the flight recorder use the backoff and the JSON writer.

- :class:`ChunkJournal` — a directory of per-chunk result commits.  Each
  committed chunk is a :mod:`~spark_timeseries_tpu_torch.utils.checkpoint`
  pytree pair (``.npz`` + ``.tree.json``, each written tmp-file+rename)
  plus a ``.ok`` commit marker whose atomic rename IS the commit point:
  a chunk exists iff its marker does, so a kill -9 at any instant leaves
  either a fully committed chunk or no chunk.  ``MANIFEST.json`` records
  a content hash of the job spec; opening the same path under another
  spec refuses with :class:`JournalSpecMismatch`.  Restores go through
  ``checkpoint.load_pytree``'s shape/dtype-validated path, so a garbled
  or swapped ``.npz`` surfaces as a detected corruption (the entry moves
  to ``quarantine/`` and the chunk refits), never as wrong numbers.  The
  on-disk layout is the JAX package's.
- :class:`BackoffPolicy` — bounded exponential backoff, a closed form of
  the attempt number.
- :class:`ChunkDeadlineExceeded` / :func:`is_oom` — the failure taxonomy.
"""

from __future__ import annotations

import hashlib
import json
import os
from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from . import checkpoint as _checkpoint

__all__ = [
    "BackoffPolicy", "as_backoff",
    "ChunkDeadlineExceeded", "JournalSpecMismatch",
    "is_oom", "spec_digest", "array_digest", "atomic_write_json",
    "ChunkJournal", "CHUNK_JOURNAL_MANIFEST",
]

# the journal's manifest file name (the flight recorder reads it too)
CHUNK_JOURNAL_MANIFEST = "MANIFEST.json"


class JournalSpecMismatch(ValueError):
    """A chunk journal was written by a different job spec (family,
    statics, dtype, device, bucket policy, chunk partition or data) than
    the one now trying to resume from it.  Raised when the journal is
    opened: resuming would silently mix results of two jobs."""


class ChunkDeadlineExceeded(RuntimeError):
    """A streaming chunk's fit outlived the armed per-chunk deadline
    (``STS_CHUNK_DEADLINE_S`` or ``stream_fit(..., deadline_s=)``).  The
    watchdog abandons the worker thread and the stream continues; the
    chunk is quarantined for end-of-stream retry like any other
    failure."""


class BackoffPolicy(NamedTuple):
    """Bounded exponential backoff.

    ``max_retries`` attempts after the original failure (0 = declare the
    chunk dead at once); :meth:`delay` for attempt ``k`` (1-based) is
    ``min(base_delay_s * multiplier**(k-1), max_delay_s)``, a closed
    form of the attempt number, so schedules are deterministic."""
    max_retries: int = 2
    base_delay_s: float = 0.05
    multiplier: float = 2.0
    max_delay_s: float = 2.0

    def delay(self, attempt: int) -> float:
        """Seconds to back off before retry ``attempt`` (1-based)."""
        if attempt < 1:
            raise ValueError(f"attempt is 1-based, got {attempt}")
        d = self.base_delay_s * self.multiplier ** (attempt - 1)
        return float(min(d, self.max_delay_s))


def as_backoff(retry: Any) -> BackoffPolicy:
    """Coerce a ``retry=`` argument to a policy: ``None`` reads
    ``STS_CHUNK_RETRIES`` (default 0), an int is a retry count with the
    default curve, a :class:`BackoffPolicy` passes through."""
    if retry is None:
        env = os.environ.get("STS_CHUNK_RETRIES")
        try:
            return BackoffPolicy(max_retries=max(0, int(env)) if env else 0)
        except ValueError:
            raise ValueError(
                f"STS_CHUNK_RETRIES must be an integer, got {env!r}"
            ) from None
    if isinstance(retry, BackoffPolicy):
        return retry
    if isinstance(retry, bool):
        raise TypeError("retry must be None, an int, or a BackoffPolicy")
    if isinstance(retry, int):
        return BackoffPolicy(max_retries=max(0, retry))
    raise TypeError(f"retry must be None, an int, or a BackoffPolicy, "
                    f"got {type(retry).__name__}")


def is_oom(e: BaseException) -> bool:
    """Is this a device allocation failure?  True for
    ``torch.cuda.OutOfMemoryError``, for the ``oom_chunk`` fault's
    ``InjectedOOM`` and for the allocation-failure texts the JAX
    package's classifier keys on (``RESOURCE_EXHAUSTED``, ``out of
    memory``, ``OutOfMemory``); the engine's degradation halves a chunk
    on it instead of killing the stream."""
    from .resilience import InjectedOOM

    if isinstance(e, (torch.cuda.OutOfMemoryError, InjectedOOM)):
        return True
    text = f"{type(e).__name__}: {e}"
    return ("RESOURCE_EXHAUSTED" in text
            or "out of memory" in text.lower()
            or "OutOfMemory" in text)


def spec_digest(spec: Dict[str, Any]) -> str:
    """Content hash of a job spec dict (order-insensitive JSON)."""
    blob = json.dumps(spec, sort_keys=True, default=str).encode()
    return hashlib.sha256(blob).hexdigest()[:16]


def array_digest(arr) -> str:
    """Content hash of a host array's raw bytes (a tensor is read on the
    host): the job-spec field that refuses a resume when the panel's
    data changed under the same geometry.  Zero-copy over a contiguous
    array's buffer."""
    if isinstance(arr, torch.Tensor):
        arr = arr.detach().cpu().numpy()
    a = np.ascontiguousarray(arr)
    h = hashlib.sha256()
    h.update(memoryview(a).cast("B"))
    return h.hexdigest()[:16]


def atomic_write_json(path: str, obj: Any) -> None:
    """tmp-file + fsync + rename: the file either has its full contents
    or does not exist (the rename is the visibility point).  The journal
    commit marker and the flight recorder's bundles share it."""
    tmp = f"{path}.tmp-{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump(obj, f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


class ChunkJournal:
    """Crash-consistent per-chunk result journal for one streaming job.

    Directory layout::

        <path>/MANIFEST.json                   job-spec hash (format 1)
        <path>/chunk_<start>_<stop>.npz        array leaves (checkpoint)
        <path>/chunk_<start>_<stop>.tree.json  structure sidecar
        <path>/chunk_<start>_<stop>.ok         commit marker (atomic)
        <path>/quarantine/...                  corrupt entries, moved aside

    Payload files land first, then the ``.ok`` marker is renamed into
    place: the marker is the commit point.  Entries are keyed by their
    half-open row range ``[start, stop)``; a chunk halved under memory
    pressure commits each sub-range, and :meth:`covering` recognizes an
    exact tiling of the chunk's range on resume."""

    MANIFEST = CHUNK_JOURNAL_MANIFEST
    QUARANTINE_DIR = "quarantine"

    def __init__(self, path: str, spec: Dict[str, Any], digest: str):
        self.path = path
        self.spec = spec
        self.digest = digest
        self._index: Dict[Tuple[int, int], Dict[str, Any]] = {}
        self._scan()

    @classmethod
    def open(cls, path: str, spec: Dict[str, Any]) -> "ChunkJournal":
        """Create or resume the journal at ``path`` for job ``spec``: a
        fresh directory gets a manifest of the spec and its hash; an
        existing one is validated against it
        (:class:`JournalSpecMismatch` names the differing fields)."""
        os.makedirs(path, exist_ok=True)
        digest = spec_digest(spec)
        mpath = os.path.join(path, cls.MANIFEST)
        if os.path.exists(mpath):
            with open(mpath) as f:
                manifest = json.load(f)
            if manifest.get("digest") != digest:
                old = manifest.get("spec") or {}
                diffs = [f"  {k}: journal={old.get(k)!r} vs job={v!r}"
                         for k, v in sorted(spec.items())
                         if old.get(k) != v]
                raise JournalSpecMismatch(
                    f"journal at {path!r} belongs to a different job spec "
                    f"and cannot resume this one; differing fields:\n"
                    + ("\n".join(diffs)
                       or "  (fields match but recorded hash differs)")
                    + "\nuse a fresh journal path for a different job")
        else:
            atomic_write_json(mpath, {"format": 1, "digest": digest,
                                      "spec": spec})
        return cls(path, spec, digest)

    def _scan(self) -> None:
        self._index.clear()
        for name in sorted(os.listdir(self.path)):
            if not name.endswith(".ok"):
                continue
            try:
                with open(os.path.join(self.path, name)) as f:
                    meta = json.load(f)
                key = (int(meta["start"]), int(meta["stop"]))
            except (OSError, ValueError, KeyError, TypeError):
                continue        # torn or garbled marker: not committed
            self._index[key] = meta

    def _prefix(self, start: int, stop: int) -> str:
        return os.path.join(self.path, f"chunk_{start:010d}_{stop:010d}")

    @property
    def n_committed(self) -> int:
        return len(self._index)

    def committed_ranges(self) -> List[Tuple[int, int]]:
        return sorted(self._index)

    def covering(self, start: int, stop: int
                 ) -> Optional[List[Dict[str, Any]]]:
        """Committed entry metas exactly tiling ``[start, stop)`` in
        order, or None when the range is not fully committed (a partial
        cover refits the whole chunk)."""
        inside = sorted(k for k in self._index
                        if start <= k[0] and k[1] <= stop)
        if not inside:
            return None
        cursor = start
        out = []
        for k in inside:
            if k[0] != cursor:
                return None
            out.append(self._index[k])
            cursor = k[1]
        return out if cursor == stop else None

    def load(self, meta: Dict[str, Any]) -> Tuple[Any, Dict[str, Any]]:
        """Validated restore of one committed entry: the chunk's model
        (array leaves as numpy) plus the payload meta.  Raises on any
        corruption; callers quarantine the entry and refit the chunk."""
        start, stop = int(meta["start"]), int(meta["stop"])
        payload = _checkpoint.load_pytree(self._prefix(start, stop))
        pmeta = payload["meta"]
        if (int(pmeta.get("start", -1)), int(pmeta.get("stop", -1))) \
                != (start, stop):
            raise _checkpoint.CheckpointMismatchError(
                f"journal entry [{start}, {stop}) payload claims range "
                f"[{pmeta.get('start')}, {pmeta.get('stop')}) — the files "
                f"do not belong to this commit marker")
        return payload["model"], pmeta

    def commit(self, start: int, stop: int, model: Any,
               meta: Dict[str, Any]) -> None:
        """Atomically commit one chunk's fitted model: payload files
        tmp+rename first, then the ``.ok`` marker (the commit point).
        Committed entries strictly inside ``[start, stop)`` are
        superseded, their markers dropped before the new marker lands (a
        crash in between leaves the range uncommitted: a refit, never a
        mixed cover)."""
        start, stop = int(start), int(stop)
        meta = dict(meta, start=start, stop=stop)
        prefix = self._prefix(start, stop)
        _checkpoint.save_pytree_atomic(prefix, {"model": model,
                                                "meta": meta})
        for k in [k for k in self._index
                  if k != (start, stop)
                  and start <= k[0] and k[1] <= stop]:
            sub = self._prefix(*k)
            for suffix in (".ok", ".npz", ".tree.json"):
                if os.path.exists(sub + suffix):
                    os.remove(sub + suffix)
            del self._index[k]
        atomic_write_json(prefix + ".ok", meta)
        self._index[(start, stop)] = meta

    def quarantine(self, meta: Dict[str, Any]) -> str:
        """Move a corrupt entry's files into ``quarantine/`` so the entry
        is never trusted again.  Returns the quarantine directory."""
        start, stop = int(meta["start"]), int(meta["stop"])
        qdir = os.path.join(self.path, self.QUARANTINE_DIR)
        os.makedirs(qdir, exist_ok=True)
        prefix = self._prefix(start, stop)
        base = os.path.basename(prefix)
        for suffix in (".ok", ".npz", ".tree.json"):
            src = prefix + suffix
            if os.path.exists(src):
                os.replace(src, os.path.join(qdir, base + suffix))
        self._index.pop((start, stop), None)
        return qdir

    def corrupt_entry(self, start: int, stop: int) -> None:
        """Garble a committed entry's array payload in place, leaving the
        marker intact: the ``corrupt_journal`` fault's hook."""
        npz = self._prefix(int(start), int(stop)) + ".npz"
        size = os.path.getsize(npz)
        with open(npz, "r+b") as f:
            f.seek(size // 2)
            f.write(b"\x00CORRUPTED\x00")
