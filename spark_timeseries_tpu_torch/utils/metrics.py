"""Host-side counters, gauges, wall-time spans and instant events (the
part of ``spark_timeseries_tpu/utils/metrics.py`` that the panel, io and
resilience tiers call).

A process-local :class:`MetricsRegistry` holds named integer counters
(``panel.h2d_bytes``, ``panel.d2h_bytes``, ``io.csv_series_loaded``,
``resilience.*``, ...: the JAX package's names), last-write-wins float
gauges (``resilience.<family>.frac_recovered``, ...), one wall-time
record per span path and the newest :func:`trace_instant` markers.
:func:`span` nests (paths join with ``/``) and marks its scope with
``torch.profiler.record_function``, so the same names show in a
``torch.profiler`` trace, as the JAX module's spans show in
``jax.profiler`` traces.  The JAX module's histograms, trace export,
telemetry and JAX hooks are not here.
"""

from __future__ import annotations

import collections
import contextlib
import functools
import threading
import time
from typing import Any, Callable, Dict, Iterator, List, Optional

import torch

__all__ = ["Counter", "MetricsRegistry", "counter", "get_registry", "inc",
           "set_gauge", "snapshot", "reset", "span", "instrumented",
           "trace_instant", "events"]

# instant events kept, newest last (the JAX module's trace ring holds spans
# too; here only the markers)
EVENTS_KEPT = 4096


class Counter:
    """Monotonically increasing integer, mutated under its registry's
    lock."""

    __slots__ = ("value", "_lock")

    def __init__(self, lock: threading.RLock):
        self.value = 0
        self._lock = lock

    def inc(self, n: int = 1) -> None:
        if n < 0:
            raise ValueError(f"counter increment must be >= 0, got {n}")
        with self._lock:
            self.value += int(n)


class MetricsRegistry:
    """Named counters, gauges, span wall times and instant events behind
    one reentrant lock."""

    def __init__(self):
        self._lock = threading.RLock()
        self._counters: Dict[str, Counter] = {}
        self._gauges: Dict[str, float] = {}
        self._events: collections.deque = collections.deque(
            maxlen=EVENTS_KEPT)
        # span path -> [count, total_s, min_s, max_s]
        self._spans: Dict[str, list] = {}

    def counter(self, name: str) -> Counter:
        with self._lock:
            c = self._counters.get(name)
            if c is None:
                c = self._counters[name] = Counter(self._lock)
            return c

    def inc(self, name: str, n: int = 1) -> None:
        self.counter(name).inc(n)

    def set_gauge(self, name: str, v: float) -> None:
        with self._lock:
            self._gauges[name] = float(v)

    def instant(self, name: str, args: Optional[Dict[str, Any]]) -> None:
        ev = {"kind": "instant", "name": name, "ts": time.perf_counter()}
        if args:
            ev["args"] = dict(args)
        with self._lock:
            self._events.append(ev)

    def events(self) -> List[Dict[str, Any]]:
        with self._lock:
            return list(self._events)

    def record_span(self, path: str, seconds: float) -> None:
        with self._lock:
            rec = self._spans.get(path)
            if rec is None:
                self._spans[path] = [1, seconds, seconds, seconds]
            else:
                rec[0] += 1
                rec[1] += seconds
                rec[2] = min(rec[2], seconds)
                rec[3] = max(rec[3], seconds)

    def snapshot(self) -> Dict[str, Any]:
        """``{"counters": {name: int}, "gauges": {name: float}, "spans":
        {path: {count, total_s, mean_s, min_s, max_s}}}``, the JAX
        module's keys for all three."""
        with self._lock:
            counters = {k: c.value for k, c in sorted(self._counters.items())}
            gauges = dict(sorted(self._gauges.items()))
            spans = {k: list(v) for k, v in sorted(self._spans.items())}
        return {"counters": counters, "gauges": gauges,
                "spans": {k: {"count": n, "total_s": tot, "mean_s": tot / n,
                              "min_s": mn, "max_s": mx}
                          for k, (n, tot, mn, mx) in spans.items()}}

    def reset(self) -> None:
        with self._lock:
            self._counters.clear()
            self._gauges.clear()
            self._spans.clear()
            self._events.clear()


_default_registry = MetricsRegistry()
_span_state = threading.local()


def get_registry() -> MetricsRegistry:
    """The process-wide default registry (the module-level functions'
    and every entry point's that is not handed one)."""
    return _default_registry


def counter(name: str) -> Counter:
    return _default_registry.counter(name)


def inc(name: str, n: int = 1) -> None:
    _default_registry.inc(name, n)


def set_gauge(name: str, v: float) -> None:
    _default_registry.set_gauge(name, v)


def snapshot() -> Dict[str, Any]:
    return _default_registry.snapshot()


def trace_instant(name: str, args: Optional[Dict[str, Any]] = None) -> None:
    """Record a zero-duration marker (the resilience chain's fallback
    stages, stage errors, suspect lanes) with its host-clock time; the
    newest :data:`EVENTS_KEPT` are kept (:func:`events`)."""
    _default_registry.instant(name, args)


def events() -> List[Dict[str, Any]]:
    """The kept :func:`trace_instant` markers, oldest first:
    ``{"kind": "instant", "name", "ts"[, "args"]}``."""
    return _default_registry.events()


def reset() -> None:
    _default_registry.reset()


@contextlib.contextmanager
def span(name: str, registry: Optional[MetricsRegistry] = None
         ) -> Iterator[None]:
    """Named wall-time scope.  Nesting joins paths with ``/``; each path
    accumulates its count and seconds in ``registry`` (the default one
    when None), and the scope is a ``torch.profiler.record_function``
    range of the same name.  Host clock: work a scope enqueues on a card
    and does not wait for is not in its time."""
    reg = registry if registry is not None else _default_registry
    stack = getattr(_span_state, "stack", None)
    if stack is None:
        stack = _span_state.stack = []
    stack.append(name)
    path = "/".join(stack)
    t0 = time.perf_counter()
    try:
        with torch.profiler.record_function(path):
            yield
    finally:
        stack.pop()
        reg.record_span(path, time.perf_counter() - t0)


def instrumented(span_name: str) -> Callable:
    """Decorator: run the function inside :func:`span` ``(span_name)``."""

    def deco(fn: Callable) -> Callable:
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            with span(span_name):
                return fn(*args, **kwargs)

        return wrapper

    return deco
