"""The pieces of the durability layer that the fleet runtime and the
flight recorder call (counterpart of
``spark_timeseries_tpu/utils/durability.py``): the deterministic
restart backoff and the crash-consistent JSON writer.

The engine's chunk journal (``ChunkJournal``), resume validation and the
failure taxonomy of its watchdog are the engine's durability tier, not
ported yet (ROADMAP Queue A item 5).  The flight recorder reads a
journal's manifest by name only, :data:`CHUNK_JOURNAL_MANIFEST`.
"""

from __future__ import annotations

import json
import os
from typing import Any, NamedTuple

__all__ = ["BackoffPolicy", "as_backoff", "atomic_write_json",
           "CHUNK_JOURNAL_MANIFEST"]

# the manifest file name of the JAX package's ChunkJournal
CHUNK_JOURNAL_MANIFEST = "MANIFEST.json"


class BackoffPolicy(NamedTuple):
    """Bounded exponential backoff.

    ``max_retries`` attempts after the original failure; :meth:`delay`
    for attempt ``k`` (1-based) is ``min(base_delay_s *
    multiplier**(k-1), max_delay_s)``, a closed form of the attempt
    number, so schedules are deterministic."""
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


def atomic_write_json(path: str, obj: Any) -> None:
    """tmp-file + fsync + rename: the file either has its full contents
    or does not exist (the rename is the visibility point)."""
    tmp = f"{path}.tmp-{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump(obj, f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
