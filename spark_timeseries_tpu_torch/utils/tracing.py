"""Chrome trace-event export: the span timeline as a Perfetto file
(a copy of ``spark_timeseries_tpu/utils/tracing.py``, which needs no JAX).

``utils.metrics`` aggregates span wall time into histograms, but an
aggregate cannot show *when*: which fits overlapped, where a chunk's
staging sat against its fit, which fallback stage the resilient path
took.  This module exports the trace ring (``metrics.trace_events()``)
in the Chrome trace-event JSON format, loadable in Perfetto
(https://ui.perfetto.dev) or ``chrome://tracing``:

- each completed span scope is a **complete event** (``"ph": "X"``)
  whose name is the nested ``/``-joined path, laid out per thread;
- the engine's chunk events and resilience fallback stages are
  **instant events** (``"ph": "i"``);
- process and thread **metadata events** (``"ph": "M"``) label the rows.

Two entry points:

- ``STS_TRACE=/path.json`` (environment) dumps the buffer at interpreter
  exit (registered by ``utils.metrics`` at import, so any entry point
  that touches the package gets it);
- :func:`write_trace` / :func:`to_chrome_trace` for explicit dumps, and
  :func:`span_events` / :func:`slowest_spans` for the top-N slowest
  scopes.

Self-time attribution: inclusive span durations answer "how long did
this scope take" but not "which scope *itself* took the time".
:func:`self_times` computes each buffered span's **exclusive** self-time
(inclusive duration minus the durations of its enclosed children, per
thread, from the ring's begin + duration intervals), and
:func:`self_time_report` aggregates it by span name with per-subsystem
rollups (``engine`` / ``statespace`` / ``backtest`` / ``models`` /
``utils``).

Timestamps ride the ``perf_counter`` clock (µs in the export, as the
format requires); the absolute wall-clock anchor of the trace is carried
in ``otherData.trace_start_walltime``.  Spans are host-clock scopes:
card work a scope enqueued and did not wait for lands in the scope that
waits for it.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, List, Optional

from . import metrics as _metrics

__all__ = ["to_chrome_trace", "write_trace", "span_events",
           "slowest_spans", "self_times", "self_time_report",
           "span_subsystem"]

_S_TO_US = 1e6

# containment slack for self-time interval nesting: a child's exit
# timestamp is read by a separate perf_counter call than its parent's,
# so a nominally-enclosed child can arithmetically overhang by clock
# quantization — never by more than microseconds
_NEST_EPS = 1e-6

# leaf-prefix → subsystem rollup (the five attribution buckets).  The
# leaf segment of a nested path owns the time ("bench.fit/engine.stream"
# is engine time); prefixes not listed (bench.*, telemetry.*, io.*, ...)
# roll into "utils" — harness and observability glue, not model math.
SUBSYSTEMS = ("engine", "statespace", "backtest", "models", "utils")
_SUBSYSTEM_BY_PREFIX = {
    "engine": "engine",
    "serving": "statespace",
    "kalman": "statespace",
    "statespace": "statespace",
    "fleet": "statespace",
    "lineage": "statespace",
    "quality": "statespace",
    "backtest": "backtest",
    "arima": "models",
    "garch": "models",
    "hw": "models",
    "holtwinters": "models",
    "ar": "models",
    "ma": "models",
    "arma": "models",
    "ewma": "models",
    "rw": "models",
    "fit": "models",
    "optimize": "models",
    "resilience": "models",
    "longseries": "models",
}


def span_subsystem(path: str) -> str:
    """The attribution bucket owning a span path: decided by the *leaf*
    segment's dotted prefix (``"bench.fit_panel/arima.fit"`` → the
    ``arima`` leaf → ``"models"``); unknown prefixes are ``"utils"``."""
    leaf = path.rsplit("/", 1)[-1]
    head = leaf.split(".", 1)[0]
    return _SUBSYSTEM_BY_PREFIX.get(head, "utils")


def span_events(events: Optional[List[Dict[str, Any]]] = None
                ) -> List[Dict[str, Any]]:
    """The buffered span events (kind ``"span"``), begin-time order.

    The ring appends at scope *exit* (a nested child precedes its parent
    in arrival order); sorting by ``ts`` restores begin-time order, which
    is what both the exporter and a "what ran when" reader want."""
    if events is None:
        events = _metrics.trace_events()
    spans = [e for e in events if e.get("kind") == "span"]
    spans.sort(key=lambda e: e["ts"])
    return spans


def self_times(events: Optional[List[Dict[str, Any]]] = None
               ) -> List[Dict[str, Any]]:
    """Every buffered span with its **exclusive** self-time: inclusive
    duration minus the durations of its strictly-enclosed children,
    computed per thread from the ring's begin+duration intervals.

    ``span()`` scopes are well-nested per thread (a child records at
    exit, strictly inside its parent's window), so a single stack pass
    over begin-ordered events suffices: an event starting after the
    stack top's end closes that scope; an event whose window sits inside
    the top's subtracts from the top's self-time (immediate parent only
    — a grandchild already subtracted from its own parent).  A window
    that *partially* overlaps the top (impossible from ``span()``, but
    representable in a hand-built event list) is treated as a sibling:
    nothing is subtracted, so inclusive totals are never over-attributed.
    Self-times are clamped at 0 against clock quantization."""
    spans = span_events(events)
    rows: List[Dict[str, Any]] = []
    by_tid: Dict[Any, List[Dict[str, Any]]] = {}
    for e in spans:
        by_tid.setdefault(e.get("tid", 0), []).append(e)
    for evs in by_tid.values():
        # same begin → the longer window is the parent
        evs.sort(key=lambda e: (e["ts"], -e["dur"]))
        # stack entries: [event, self_dur, end]
        stack: List[list] = []
        done: List[list] = []
        for e in evs:
            end = e["ts"] + e["dur"]
            while stack and stack[-1][2] <= e["ts"] + _NEST_EPS:
                done.append(stack.pop())
            if stack and end <= stack[-1][2] + _NEST_EPS:
                stack[-1][1] -= e["dur"]
            stack.append([e, e["dur"], end])
        done.extend(stack)
        for e, self_dur, _end in done:
            rows.append({"name": e["name"], "ts": e["ts"],
                         "dur": e["dur"], "self": max(0.0, self_dur),
                         "tid": e.get("tid", 0),
                         "tname": e.get("tname", "")})
    rows.sort(key=lambda r: r["ts"])
    return rows


def slowest_spans(n: int = 10,
                  events: Optional[List[Dict[str, Any]]] = None
                  ) -> List[Dict[str, Any]]:
    """Top-``n`` slowest span scopes still in the buffer, as compact
    JSON-able rows ("where did this run's time go").  Each row carries both the inclusive duration and the exclusive
    self-time; ties on duration order by name so equal-duration spans
    don't reorder between runs."""
    rows = self_times(events)
    rows.sort(key=lambda r: (-r["dur"], r["name"]))
    return [{"name": r["name"], "dur_s": round(r["dur"], 6),
             "self_s": round(r["self"], 6),
             "thread": r.get("tname", "")} for r in rows[:n]]


def self_time_report(n: int = 10,
                     events: Optional[List[Dict[str, Any]]] = None
                     ) -> Dict[str, Any]:
    """The per-round self-time attribution block: spans aggregated by
    name (summed across occurrences and threads), top-``n`` by total
    self-time (name-stable on ties), plus the per-subsystem rollup over
    *all* buffered spans.  Every subsystem bucket is always present — a
    0 is a measured "this tier spent nothing", so runs that exercised
    different tiers still compare key for key."""
    agg: Dict[str, Dict[str, Any]] = {}
    for r in self_times(events):
        a = agg.setdefault(r["name"], {"name": r["name"], "count": 0,
                                       "dur_s": 0.0, "self_s": 0.0})
        a["count"] += 1
        a["dur_s"] += r["dur"]
        a["self_s"] += r["self"]
    subsystems = {sub: {"self_s": 0.0, "spans": 0} for sub in SUBSYSTEMS}
    total = 0.0
    for a in agg.values():
        sub = subsystems[span_subsystem(a["name"])]
        sub["self_s"] += a["self_s"]
        sub["spans"] += 1
        total += a["self_s"]
    top = sorted(agg.values(), key=lambda a: (-a["self_s"], a["name"]))
    return {
        "spans": [{"name": a["name"], "count": a["count"],
                   "dur_s": round(a["dur_s"], 6),
                   "self_s": round(a["self_s"], 6)} for a in top[:n]],
        "subsystems": {k: {"self_s": round(v["self_s"], 6),
                           "spans": v["spans"]}
                       for k, v in subsystems.items()},
        "total_self_s": round(total, 6),
    }


def to_chrome_trace(events: Optional[List[Dict[str, Any]]] = None,
                    limit: Optional[int] = None) -> Dict[str, Any]:
    """Render the trace buffer as a Chrome trace-event JSON object.

    Uses the object form (``{"traceEvents": [...]}``) so the file can
    carry ``otherData``; the array inside follows the trace-event spec:
    ``X`` (complete) events for spans with ``ts``/``dur`` in µs, ``i``
    (instant, thread scope) events for markers, and ``M`` metadata
    events naming the process and each thread row.

    ``limit`` keeps only the newest N events (by begin time) — the
    payload bound the telemetry exporter's ``/trace.json?limit=`` and
    the flight recorder's embedded trace use (a full 65536-event ring
    renders to ~10 MB, too heavy for a scrape or an incident bundle).

    When ``events`` is None the export also interleaves completed tick
    lineage stages (``utils.lineage``) as spans on synthetic
    ``lineage-*`` thread rows — the per-request journeys render right
    next to the engine spans they contain, which is the whole point of
    a trace: *this* tick's queue wait sits beside *that* dispatch.
    Only the export merges them — :func:`self_times` /
    :func:`self_time_report` keep reading the span ring alone, so
    attribution totals are unchanged by the lineage plane."""
    if events is None:
        events = _metrics.trace_events()
        try:
            from . import lineage as _lineage
            events = events + _lineage.trace_events()
        except Exception:  # noqa: BLE001 — the trace must render even
            pass           # if the lineage plane is broken mid-scrape
    if limit is not None and len(events) > limit:
        events = sorted(events, key=lambda e: e["ts"])[-int(limit):]
    pid = os.getpid()
    out: List[Dict[str, Any]] = [{
        "name": "process_name", "ph": "M", "pid": pid, "tid": 0,
        "args": {"name": "spark_timeseries_tpu_torch"},
    }]
    threads: Dict[int, str] = {}
    body: List[Dict[str, Any]] = []
    for e in sorted(events, key=lambda e: e["ts"]):
        tid = e.get("tid", 0)
        if tid not in threads:
            threads[tid] = e.get("tname", str(tid))
        ev: Dict[str, Any] = {
            "name": e["name"],
            "cat": e["kind"],
            "pid": pid,
            "tid": tid,
            "ts": e["ts"] * _S_TO_US,
        }
        if e["kind"] == "span":
            ev["ph"] = "X"
            ev["dur"] = e["dur"] * _S_TO_US
        else:
            ev["ph"] = "i"
            ev["s"] = "t"
        if e.get("args"):
            ev["args"] = e["args"]
        body.append(ev)
    for tid, tname in sorted(threads.items()):
        out.append({"name": "thread_name", "ph": "M", "pid": pid,
                    "tid": tid, "args": {"name": tname}})
    out.extend(body)
    wall0, perf0 = _metrics._TRACE_EPOCH
    buf = _metrics.trace_buffer()
    return {
        "traceEvents": out,
        "displayTimeUnit": "ms",
        "otherData": {
            "trace_start_walltime": wall0,
            "perf_counter_at_start": perf0,
            "events_dropped": buf.dropped,
            "events_exported": len(events),
            "capacity": buf.capacity,
        },
    }


def write_trace(path: str,
                events: Optional[List[Dict[str, Any]]] = None) -> str:
    """Write the Chrome trace JSON to ``path`` (parent dirs created);
    returns the path.  Load the file in https://ui.perfetto.dev or
    ``chrome://tracing``."""
    doc = to_chrome_trace(events)
    parent = os.path.dirname(os.path.abspath(path))
    os.makedirs(parent, exist_ok=True)
    with open(path, "w") as f:
        json.dump(doc, f)
    return path
