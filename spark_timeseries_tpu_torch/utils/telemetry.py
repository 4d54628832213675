"""The host-side pieces of the telemetry plane that the serving tier
calls (counterpart of ``spark_timeseries_tpu/utils/telemetry.py``):
the shared parser of positive numeric ``STS_*`` knobs, the weak registry
of live serving sessions, and the ``STS_TELEMETRY_PORT`` opt-in.

The scrape exporter itself (``/snapshot.json``, ``/healthz``,
``/trace.json``) is not ported yet (ROADMAP Queue A item 5): with
``STS_TELEMETRY_PORT`` unset :func:`ensure_started_from_env` does
nothing, and with it set it raises.
"""

from __future__ import annotations

import os
import threading
import weakref
from typing import Any

__all__ = ["env_positive", "register_session", "ensure_started_from_env"]


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


# live ServingSessions, weakly referenced (the registry must never keep
# a session and its device buffers alive), for the exporter's session
# summaries when it is ported
_sessions_lock = threading.Lock()
_sessions: "weakref.WeakSet" = weakref.WeakSet()


def register_session(session: Any) -> None:
    with _sessions_lock:
        _sessions.add(session)


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
