"""Structured runtime metrics: registry, spans and the trace ring
(counterpart of ``spark_timeseries_tpu/utils/metrics.py``).

- A process-local **registry** of counters, gauges and histograms with
  explicit :meth:`MetricsRegistry.record` / :meth:`MetricsRegistry.snapshot`
  / :meth:`MetricsRegistry.reset` and JSON and Prometheus-text export
  (the names and the text are the JAX module's).
- A **span** API (``with metrics.span("arima.fit_panel"): ...``) that
  nests (paths join with ``/``), records wall-time histograms and marks
  its scope with ``torch.profiler.record_function``, so the same names
  show in a ``torch.profiler`` trace as the JAX module's spans show in
  ``jax.profiler`` traces.  Host clock: work a scope enqueues on a card
  and does not wait for is not in its time.
- A bounded **trace ring** of span and instant events (most recent
  ``STS_TRACE_CAPACITY``, default 65536) that ``utils.tracing`` exports
  as a Chrome trace (``STS_TRACE=/path.json`` dumps it at exit), and
  span-exit listeners.
- Fit recording (:func:`record_fit`, :func:`record_fit_report`,
  :func:`observe_minimize`, :func:`instrument_fit`): counter bundles off
  a fitted model's diagnostics, read to the host.

``STS_METRICS=0`` disables all recording (spans still mark the
profiler); :func:`set_enabled` overrides at run time.

Not here: the JAX module's ``install_jax_hooks``, ``jax_hooks_installed``
and ``jax_stats``.  They listen to ``jax.monitoring`` for XLA compiles,
compilation-cache events and transfers, and eager PyTorch emits no such
events: it compiles nothing per call, and its kernels are built once a
process (``_build``: ``kernels.builds`` / ``kernels.cache_hits``).  A
path's kernel launches are counted by each kernel wrapper's
``launches``, and host crossings by the tiers' own byte counters.
"""

from __future__ import annotations

import contextlib
import functools
import json
import os
import threading
import time
from typing import Any, Callable, Dict, Iterator, Optional

import numpy as np
import torch

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry",
    "counter", "gauge", "histogram", "inc", "set_gauge", "record",
    "snapshot", "reset", "to_json", "to_prometheus",
    "span", "current_span_path",
    "TraceBuffer", "trace_buffer", "trace_events", "trace_instant",
    "clear_trace", "set_trace_capacity", "add_span_listener",
    "remove_span_listener",
    "record_fit", "record_fit_report", "observe_minimize",
    "instrument_fit", "instrumented", "enabled", "set_enabled",
    "get_registry", "events",
]

# Percentile sample cap per histogram: count/sum/min/max stay exact past
# it; p50/p95 come from a deterministic ring of the most recent samples.
MAX_SAMPLES = 4096


def _fmt(v) -> str:
    """Deterministic number formatting shared by the text exports."""
    if isinstance(v, bool):
        return str(int(v))
    if isinstance(v, int):
        return str(v)
    f = float(v)
    if f == int(f) and abs(f) < 1e15:
        return str(int(f))
    return format(f, ".10g")


class Counter:
    """Monotonically increasing integer.  Mutations hold the owning
    registry's lock (standalone construction gets its own), so handles
    obtained via ``registry.counter(name)`` increment safely across
    threads."""

    __slots__ = ("value", "_lock")

    def __init__(self, lock: Optional[threading.RLock] = None):
        self.value = 0
        self._lock = lock if lock is not None else threading.RLock()

    def inc(self, n: int = 1) -> None:
        if n < 0:
            raise ValueError(f"counter increment must be >= 0, got {n}")
        with self._lock:
            self.value += int(n)


class Gauge:
    """Last-write-wins float."""

    __slots__ = ("value", "_lock")

    def __init__(self, lock: Optional[threading.RLock] = None):
        self.value = 0.0
        self._lock = lock if lock is not None else threading.RLock()

    def set(self, v: float) -> None:
        with self._lock:
            self.value = float(v)


class Histogram:
    """Streaming count/sum/min/max plus a bounded sample ring for
    percentiles (deterministic: the ring keeps the most recent
    ``max_samples`` observations, overwritten in arrival order).
    ``record`` holds the owning registry's lock so concurrent recorders
    never tear the count/sum/ring triple."""

    __slots__ = ("count", "sum", "min", "max", "_samples", "_cap", "_lock")

    def __init__(self, max_samples: int = MAX_SAMPLES,
                 lock: Optional[threading.RLock] = None):
        self.count = 0
        self.sum = 0.0
        self.min = float("inf")
        self.max = float("-inf")
        self._samples: list = []
        self._cap = max_samples
        self._lock = lock if lock is not None else threading.RLock()

    def record(self, v: float) -> None:
        v = float(v)
        with self._lock:
            if len(self._samples) < self._cap:
                self._samples.append(v)
            else:
                self._samples[self.count % self._cap] = v
            self.count += 1
            self.sum += v
            self.min = min(self.min, v)
            self.max = max(self.max, v)

    def raw(self) -> tuple:
        """Consistent ``(count, sum, min, max, samples-copy)`` under one
        lock acquisition — the snapshot tier's raw material.  Percentile
        math happens on the copy *outside* the lock, so a scrape never
        stalls concurrent ``record()`` calls for the numpy work."""
        with self._lock:
            return (self.count, self.sum, self.min, self.max,
                    list(self._samples))

    def percentile(self, q: float) -> float:
        _, _, _, _, samples = self.raw()
        if not samples:
            return float("nan")
        return float(np.percentile(np.asarray(samples), q))

    def stats(self) -> Dict[str, float]:
        return _hist_stats(*self.raw())


def _hist_stats(count: int, total: float, mn: float, mx: float,
                samples: list) -> Dict[str, float]:
    """Histogram summary off one consistent :meth:`Histogram.raw` read
    (lock already released — see snapshot hardening note there)."""
    if count == 0:
        return {"count": 0, "sum": 0.0}
    s = np.asarray(samples)
    return {
        "count": count,
        "sum": total,
        "min": mn,
        "max": mx,
        "mean": total / count,
        "p50": float(np.percentile(s, 50)),
        "p95": float(np.percentile(s, 95)),
    }


class MetricsRegistry:
    """Process-local named metrics.  One reentrant lock is shared by the
    registry and every metric object it creates, so both registry-level
    calls (``inc``/``record``/``snapshot``) and direct handle mutations
    (``registry.counter(n).inc()``) are safe across concurrent host
    threads (e.g. a double-buffered pipeline's puller)."""

    def __init__(self, max_samples: int = MAX_SAMPLES):
        self._lock = threading.RLock()
        self._max_samples = max_samples
        self._counters: Dict[str, Counter] = {}
        self._gauges: Dict[str, Gauge] = {}
        self._histograms: Dict[str, Histogram] = {}
        self._spans: Dict[str, Histogram] = {}
        self.enabled = os.environ.get("STS_METRICS", "1") != "0"

    # -- get-or-create accessors -------------------------------------------

    def counter(self, name: str) -> Counter:
        with self._lock:
            c = self._counters.get(name)
            if c is None:
                c = self._counters[name] = Counter(self._lock)
            return c

    def gauge(self, name: str) -> Gauge:
        with self._lock:
            g = self._gauges.get(name)
            if g is None:
                g = self._gauges[name] = Gauge(self._lock)
            return g

    def histogram(self, name: str) -> Histogram:
        with self._lock:
            h = self._histograms.get(name)
            if h is None:
                h = self._histograms[name] = Histogram(self._max_samples,
                                                       self._lock)
            return h

    # -- explicit record / snapshot / reset --------------------------------

    def inc(self, name: str, n: int = 1) -> None:
        if self.enabled:
            self.counter(name).inc(n)

    def set_gauge(self, name: str, v: float) -> None:
        if self.enabled:
            self.gauge(name).set(v)

    def record(self, name: str, value: float) -> None:
        """Record one observation into the named histogram."""
        if self.enabled:
            self.histogram(name).record(value)

    def record_span(self, path: str, seconds: float) -> None:
        if not self.enabled:
            return
        with self._lock:
            h = self._spans.get(path)
            if h is None:
                h = self._spans[path] = Histogram(self._max_samples,
                                                  self._lock)
        h.record(seconds)

    def snapshot(self) -> Dict[str, Any]:
        """JSON-able view of every metric.  Span stats carry ``_s``
        suffixes to make the unit unambiguous in bench artifacts.

        Concurrency-hardened for the telemetry exporter (the first
        consumer that snapshots from a *different* thread while worker
        threads mutate): the registry lock is held only long enough to
        copy scalar values and histogram sample rings, so a scrape can
        never observe a torn count/sum/ring triple — and the numpy
        percentile work runs on the copies *after* the lock drops, so
        scraping never stalls the instrumented hot paths either."""
        with self._lock:
            counters = {k: v.value for k, v in sorted(self._counters.items())}
            gauges = {k: v.value for k, v in sorted(self._gauges.items())}
            hist_raw = {k: v.raw()
                        for k, v in sorted(self._histograms.items())}
            span_raw = {k: v.raw() for k, v in sorted(self._spans.items())}
        hists = {k: _hist_stats(*r) for k, r in hist_raw.items()}
        spans = {}
        for k, (count, total, mn, mx, samples) in span_raw.items():
            if count:
                s = np.asarray(samples)
                p50, p95 = (float(np.percentile(s, q)) for q in (50, 95))
            else:
                p50 = p95 = 0.0
            spans[k] = {
                "count": count,
                "total_s": total,
                "mean_s": total / count if count else 0.0,
                "min_s": mn if count else 0.0,
                "max_s": mx if count else 0.0,
                "p50_s": p50,
                "p95_s": p95,
            }
        return {"counters": counters, "gauges": gauges,
                "histograms": hists, "spans": spans}

    def reset(self) -> None:
        with self._lock:
            self._counters.clear()
            self._gauges.clear()
            self._histograms.clear()
            self._spans.clear()

    # -- export -------------------------------------------------------------

    def to_json(self, indent: Optional[int] = None) -> str:
        return json.dumps(self.snapshot(), indent=indent, sort_keys=True)

    def to_prometheus(self, prefix: str = "sts") -> str:
        """Prometheus text exposition (format 0.0.4 — what a real
        scraper parses off the telemetry exporter's ``/metrics``).

        Conformance notes: every metric family gets a ``# HELP`` line
        (help text escapes ``\\`` and newlines per the exposition
        grammar) followed by its ``# TYPE``; histograms and spans export
        as ``summary`` families whose ``{quantile=...}`` samples are
        always accompanied by the ``_sum``/``_count`` samples the
        summary type *requires* (quantile samples alone are rejected or
        misread by real scrapers); metric names are sanitized to
        ``[a-zA-Z0-9_]`` with the given prefix; an empty registry
        exports as an empty string (a lone blank line is not valid
        exposition text)."""

        def sanitize(name: str) -> str:
            return prefix + "_" + "".join(
                ch if ch.isalnum() or ch == "_" else "_" for ch in name)

        def esc_help(text: str) -> str:
            return text.replace("\\", "\\\\").replace("\n", "\\n")

        snap = self.snapshot()
        lines = []
        for name, value in snap["counters"].items():
            m = sanitize(name)
            lines.append(f"# HELP {m} {esc_help(name)} (counter)")
            lines.append(f"# TYPE {m} counter")
            lines.append(f"{m} {_fmt(value)}")
        for name, value in snap["gauges"].items():
            m = sanitize(name)
            lines.append(f"# HELP {m} {esc_help(name)} (gauge)")
            lines.append(f"# TYPE {m} gauge")
            lines.append(f"{m} {_fmt(value)}")
        for section, unit, kind in (("histograms", "", "histogram"),
                                    ("spans", "_seconds", "span")):
            for name, st in snap[section].items():
                m = sanitize(name) + unit
                lines.append(f"# HELP {m} {esc_help(name)} ({kind})")
                lines.append(f"# TYPE {m} summary")
                if st["count"]:
                    p50 = st.get("p50", st.get("p50_s"))
                    p95 = st.get("p95", st.get("p95_s"))
                    lines.append(f'{m}{{quantile="0.5"}} {_fmt(p50)}')
                    lines.append(f'{m}{{quantile="0.95"}} {_fmt(p95)}')
                total = st.get("sum", st.get("total_s", 0.0))
                lines.append(f"{m}_sum {_fmt(total)}")
                lines.append(f"{m}_count {_fmt(st['count'])}")
        return "\n".join(lines) + "\n" if lines else ""


# ---------------------------------------------------------------------------
# Default registry + module-level convenience API
# ---------------------------------------------------------------------------

_default_registry = MetricsRegistry()


def get_registry() -> MetricsRegistry:
    return _default_registry


def enabled() -> bool:
    return _default_registry.enabled


def set_enabled(on: bool) -> None:
    _default_registry.enabled = bool(on)


def counter(name: str) -> Counter:
    return _default_registry.counter(name)


def gauge(name: str) -> Gauge:
    return _default_registry.gauge(name)


def histogram(name: str) -> Histogram:
    return _default_registry.histogram(name)


def inc(name: str, n: int = 1) -> None:
    _default_registry.inc(name, n)


def set_gauge(name: str, v: float) -> None:
    _default_registry.set_gauge(name, v)


def record(name: str, value: float) -> None:
    _default_registry.record(name, value)


def snapshot() -> Dict[str, Any]:
    return _default_registry.snapshot()


def reset() -> None:
    _default_registry.reset()


def to_json(indent: Optional[int] = None) -> str:
    return _default_registry.to_json(indent)


def to_prometheus(prefix: str = "sts") -> str:
    return _default_registry.to_prometheus(prefix)


# ---------------------------------------------------------------------------
# Trace timeline: bounded ring buffer of span / instant events
# ---------------------------------------------------------------------------

# Default event capacity; overridable via STS_TRACE_CAPACITY or
# set_trace_capacity().  Each event is a small dict (~100 bytes), so the
# default ring tops out around ~6 MB — cheap enough to leave always-on.
TRACE_CAPACITY = 65536

# perf_counter <-> wall-clock anchor taken at import, so the exporter can
# stamp the trace with an absolute start time without every event paying
# for a time.time() call.
_TRACE_EPOCH = (time.time(), time.perf_counter())


class TraceBuffer:
    """Bounded ring of timeline events (most recent ``capacity`` kept).

    Two event kinds, both JSON-able dicts:

    - ``span``: one per completed :func:`span` scope — ``name`` is the
      nested ``/``-joined path, ``ts`` the scope's *begin* on the
      ``perf_counter`` clock (seconds), ``dur`` its duration (seconds),
      ``tid``/``tname`` the recording thread.  Begin + duration is the
      begin/end pair in one record (Chrome trace "complete" events).
    - ``instant``: a zero-duration marker (recompiles, resilience
      fallback stages) with optional ``args``.

    Appends hold a private lock (never the registry's: an event append
    must not contend with snapshot walks); overwrite order is arrival
    order, exactly like :class:`Histogram`'s sample ring.
    """

    def __init__(self, capacity: int = TRACE_CAPACITY):
        self._lock = threading.Lock()
        self._cap = int(capacity)
        self._events: list = []
        self._head = 0          # next overwrite slot once full
        self.dropped = 0        # events overwritten since last clear

    def append(self, event: Dict[str, Any]) -> None:
        with self._lock:
            if len(self._events) < self._cap:
                self._events.append(event)
            else:
                self._events[self._head] = event
                self._head = (self._head + 1) % self._cap
                self.dropped += 1

    def events(self) -> list:
        """Copy of the buffered events, oldest first."""
        with self._lock:
            return self._events[self._head:] + self._events[:self._head]

    def clear(self) -> None:
        with self._lock:
            self._events = []
            self._head = 0
            self.dropped = 0

    def set_capacity(self, capacity: int) -> None:
        """Resize, keeping the newest events that still fit."""
        capacity = int(capacity)
        if capacity < 1:
            raise ValueError(f"trace capacity must be >= 1, got {capacity}")
        with self._lock:
            ordered = self._events[self._head:] + self._events[:self._head]
            self._events = ordered[-capacity:]
            self._head = 0
            self._cap = capacity

    def __len__(self) -> int:
        with self._lock:
            return len(self._events)

    @property
    def capacity(self) -> int:
        return self._cap


_trace_buffer = TraceBuffer(
    int(os.environ.get("STS_TRACE_CAPACITY", str(TRACE_CAPACITY))))


def trace_buffer() -> TraceBuffer:
    return _trace_buffer


def trace_events() -> list:
    """Buffered timeline events, oldest first.  Note spans land at scope
    *exit*, so a nested child precedes its parent here; sort by ``ts``
    for begin-time order (``utils.tracing`` does)."""
    return _trace_buffer.events()


def clear_trace() -> None:
    _trace_buffer.clear()


def set_trace_capacity(capacity: int) -> None:
    _trace_buffer.set_capacity(capacity)


def _thread_ids():
    t = threading.current_thread()
    return t.ident or 0, t.name


def trace_instant(name: str, args: Optional[Dict[str, Any]] = None) -> None:
    """Record a zero-duration timeline marker (shown as an instant arrow
    in Perfetto).  Used for the resilience chain's fallback stages and
    the engine's chunk events; library code is free to add its own."""
    if not _default_registry.enabled:
        return
    tid, tname = _thread_ids()
    ev = {"kind": "instant", "name": name, "ts": time.perf_counter(),
          "tid": tid, "tname": tname}
    if args:
        ev["args"] = args
    _trace_buffer.append(ev)


def events() -> list:
    """The buffered :func:`trace_instant` markers, oldest first:
    ``{"kind": "instant", "name", "ts", "tid", "tname"[, "args"]}``."""
    return [e for e in _trace_buffer.events() if e["kind"] == "instant"]


def _trace_span_event(reg: "MetricsRegistry", path: str, t0: float,
                      dur: float) -> None:
    # the ring is the DEFAULT registry's timeline: spans recorded against
    # a private registry (test isolation) must not leak phantom events
    # into STS_TRACE dumps or bench slowest-spans blocks
    if reg is not _default_registry or not reg.enabled:
        return
    tid, tname = _thread_ids()
    _trace_buffer.append({"kind": "span", "name": path, "ts": t0,
                          "dur": dur, "tid": tid, "tname": tname})


# Span-exit listeners: callables ``fn(path, seconds)`` invoked after each
# scope records.
# A listener that raises is dropped — observability must never take the
# instrumented code down with it.
_span_listeners: list = []


def add_span_listener(fn: Callable[[str, float], None]) -> None:
    if fn not in _span_listeners:
        _span_listeners.append(fn)


def remove_span_listener(fn: Callable[[str, float], None]) -> None:
    if fn in _span_listeners:
        _span_listeners.remove(fn)


def _notify_span_listeners(path: str, dt: float) -> None:
    for fn in list(_span_listeners):
        try:
            fn(path, dt)
        except Exception:       # noqa: BLE001 — see note above
            remove_span_listener(fn)


# STS_TRACE=/path.json: dump the Chrome trace at interpreter exit.  The
# tracing module imports this one, so the import happens lazily inside
# the handler (registered here because metrics is the module everything
# else already pulls in).
if os.environ.get("STS_TRACE"):
    import atexit

    def _dump_trace_atexit(_path=os.environ["STS_TRACE"]) -> None:
        try:
            from . import tracing
            tracing.write_trace(_path)
        except Exception:       # noqa: BLE001 — exit paths must not raise
            pass

    atexit.register(_dump_trace_atexit)


# ---------------------------------------------------------------------------
# Spans
# ---------------------------------------------------------------------------

_span_state = threading.local()


def current_span_path() -> str:
    """``/``-joined path of the active span stack ("" at top level)."""
    return "/".join(getattr(_span_state, "stack", []))


@contextlib.contextmanager
def span(name: str, registry: Optional[MetricsRegistry] = None
         ) -> Iterator[None]:
    """Named wall-time scope.  Nesting joins paths with ``/``
    (``arima.fit_panel/arima.fit``); each distinct path accumulates its
    own wall-time histogram in ``registry`` (the default one when None),
    and the scope is a ``torch.profiler.record_function`` range of the
    same name.

    Host clock: work a scope enqueues on a card and does not wait for is
    not in its time.

    Each completed scope additionally lands one timeline event in the
    trace ring buffer (begin + duration — the Perfetto export's raw
    material) and fires the registered span-exit listeners.
    """
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
        dt = time.perf_counter() - t0
        stack.pop()
        reg.record_span(path, dt)
        _trace_span_event(reg, path, t0, dt)
        _notify_span_listeners(path, dt)


# ---------------------------------------------------------------------------
# Instrumentation helpers for the library's choke points
# ---------------------------------------------------------------------------

def _host(x) -> np.ndarray:
    """A diagnostic leaf (tensor on any device, array or number) as a
    flat host array; reading a CUDA tensor waits for its fit."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x).reshape(-1)


def record_fit(family: str, model,
               registry: Optional[MetricsRegistry] = None) -> None:
    """One fit-report counter bundle off a fitted model's diagnostics
    (the JAX module's ``fit.<family>.*`` names).

    Cost note: reading a card fit's diagnostics to the host waits until
    the fit's device work finishes, trading launch overlap for exact
    counters; ``STS_METRICS=0`` removes the reads.  Diagnostics that
    cannot come to the host (meta tensors) count ``fit.<family>.traced``,
    the JAX module's key for fits it cannot read.
    """
    reg = registry if registry is not None else _default_registry
    if not reg.enabled:
        return
    reg.counter(f"fit.{family}.calls").inc()
    diag = getattr(model, "diagnostics", None)
    if diag is None:
        return
    try:
        conv = _host(diag.converged)
        n_iter = _host(diag.n_iter)
        fun = _host(diag.fun)
    except (RuntimeError, TypeError, NotImplementedError):
        reg.counter(f"fit.{family}.traced").inc()
        return
    reg.counter(f"fit.{family}.series").inc(int(conv.size))
    reg.counter(f"fit.{family}.converged").inc(int(np.sum(conv)))
    reg.counter(f"fit.{family}.diverged").inc(int(np.sum(~np.isfinite(fun))))
    if n_iter.size:
        reg.histogram(f"fit.{family}.iters_mean").record(
            float(np.mean(n_iter)))
        reg.histogram(f"fit.{family}.iters_max").record(
            float(np.max(n_iter)))


def record_fit_report(family: str, report: Dict[str, Any],
                      registry: Optional[MetricsRegistry] = None) -> None:
    """Accumulate an ``observability.fit_report`` dict as a counter bundle
    (``fit_report.<family>.*``), so repeated fits add up across a workload.
    Kept in a separate namespace from :func:`record_fit`'s automatic
    ``fit.<family>.*`` bundle — a user calling ``fit_report`` on an
    already-instrumented model must not double-count the automatic one."""
    reg = registry if registry is not None else _default_registry
    if not reg.enabled:
        return
    pre = f"fit_report.{family}"
    reg.counter(f"{pre}.reports").inc()
    reg.counter(f"{pre}.n_series").inc(int(report.get("n_series", 0)))
    reg.counter(f"{pre}.n_converged").inc(int(report.get("n_converged", 0)))
    reg.counter(f"{pre}.n_diverged").inc(int(report.get("n_diverged", 0)))
    if report.get("n_series"):
        reg.histogram(f"{pre}.iters_mean").record(
            float(report.get("iters_mean", 0.0)))
        reg.histogram(f"{pre}.frac_converged").record(
            float(report.get("frac_converged", 0.0)))


def observe_minimize(solver: str, result,
                     registry: Optional[MetricsRegistry] = None):
    """Per-call iteration and convergence histograms off a
    ``MinimizeResult`` (``optimize.<solver>.*``).  A result that cannot
    come to the host counts ``optimize.<solver>.traced_calls``.  Returns
    the result so call sites can tail-call it."""
    reg = registry if registry is not None else _default_registry
    if not reg.enabled:
        return result
    pre = f"optimize.{solver}"
    reg.counter(f"{pre}.calls").inc()
    try:
        conv = _host(result.converged)
        n_iter = _host(result.n_iter)
    except (RuntimeError, TypeError, NotImplementedError):
        reg.counter(f"{pre}.traced_calls").inc()
        return result
    reg.counter(f"{pre}.lanes").inc(int(conv.size))
    reg.counter(f"{pre}.lanes_converged").inc(int(np.sum(conv)))
    if n_iter.size:
        reg.histogram(f"{pre}.iters_mean").record(float(np.mean(n_iter)))
        reg.histogram(f"{pre}.iters_max").record(float(np.max(n_iter)))
    return result


def instrumented(span_name: str) -> Callable:
    """Span-only decorator for non-fit choke points (io load/save paths,
    panel conversions): wall-time histogram and profiler range, nothing
    recorded off the return value."""

    def deco(fn: Callable) -> Callable:
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            with span(span_name):
                return fn(*args, **kwargs)

        return wrapper

    return deco


def instrument_fit(family: str, record: bool = True,
                   name: Optional[str] = None) -> Callable:
    """Decorator for model fit entry points: one span
    (``<family>.<fn name>``, nesting under any active span) plus, when
    ``record`` is True, one :func:`record_fit` counter bundle off the
    returned model.  ``record=False`` is for wrappers (``fit_panel``,
    ``auto_fit_panel``) whose inner ``fit`` already records — the wrapper
    still gets its span so the nesting shows where panel time goes."""

    def deco(fn: Callable) -> Callable:
        span_name = name or f"{family}.{fn.__name__}"

        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            # record INSIDE the span: on a card fit the recorder's host
            # read is what waits for the device work, so recording
            # outside would attribute the compute to no span at all
            with span(span_name):
                out = fn(*args, **kwargs)
                if record:
                    record_fit(family, out)
            return out

        return wrapper

    return deco
