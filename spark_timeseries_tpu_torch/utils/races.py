"""Runtime concurrency sanitizer: instrumented locks, a recorded
lock-acquisition-order graph, and a deterministic adversarial scheduler
(a copy of ``spark_timeseries_tpu/utils/races.py``, which needs no JAX).

Under :func:`instrument`, every lock the library touches is wrapped so
acquire/release (and thread spawns) are recorded, which yields

- the **acquisition-order graph actually exercised** by a workload
  (:meth:`RaceHarness.order_graph` / :meth:`RaceHarness.assert_acyclic`):
  no lock-order cycle is *executed* on the driven paths;
- a **deterministic adversarial scheduler** (``instrument(seed=...)``):
  threads spawned through :meth:`RaceHarness.spawn` are serialized and,
  at every instrumented boundary (lock acquire/release and explicit
  :func:`yield_point` calls), the next runnable thread is chosen by a
  seeded RNG — same seed, same thread programs ⇒ the **same
  interleaving**, recorded in :attr:`RaceHarness.schedule_trace`.  An
  adversarial permutation of yield points is how a check-then-act race
  is *provably* tripped in a test instead of flaking once a month in
  production.

Instrumentation model (all host-side):

- ``threading.Lock`` / ``threading.RLock`` factories are patched for
  the duration of the context manager, so every lock *created* inside
  it (a fresh ``FitEngine``, a ``JobProgress``, a serving session's
  registry handles) is traced;
- the module-level locks that already exist at import time (the default
  engine's lock, the telemetry registries, the kernel build lock, the
  lineage ring — :data:`KNOWN_LOCKS`) are rebound to traced wrappers and
  restored on exit;
- the default metrics registry's shared ``RLock`` is wrapped in place
  (the registry and every live metric handle share one lock object, so
  the wrapper is pushed into each);
- ``threading.Thread.start`` is patched to record spawns.

The scheduler serializes only threads spawned via
:meth:`RaceHarness.spawn`; foreign threads (the telemetry exporter, a
watchdog) still run free but their lock events are recorded.  The
known-hot pairs: concurrent scrape vs ``inc()``, watchdog expiry vs a
chunk's fit, fleet pump vs scrape, journal commit vs flight-recorder
read (``tests/test_torch_races.py``).
"""

from __future__ import annotations

import contextlib
import importlib
import os
import random
import sys
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Set, Tuple

__all__ = ["instrument", "yield_point", "active", "RaceHarness",
           "TracedLock", "AdversarialScheduler", "SchedulerStall",
           "KNOWN_LOCKS", "MAX_EVENTS"]

# real primitives captured at import time — the harness's own internals
# must never run through its own instrumentation
_REAL_LOCK = threading.Lock
_REAL_RLOCK = threading.RLock
_REAL_CONDITION = threading.Condition
_REAL_THREAD_START = threading.Thread.start

# module-level locks that exist before any instrument() call can patch
# the factories; rebound (and restored) by name
KNOWN_LOCKS: Tuple[Tuple[str, str], ...] = (
    ("spark_timeseries_tpu_torch.engine", "_default_lock"),
    ("spark_timeseries_tpu_torch.utils.telemetry", "_jobs_lock"),
    ("spark_timeseries_tpu_torch.utils.telemetry", "_sessions_lock"),
    ("spark_timeseries_tpu_torch.utils.telemetry", "_fleets_lock"),
    ("spark_timeseries_tpu_torch.utils.telemetry", "_runtimes_lock"),
    ("spark_timeseries_tpu_torch.utils.telemetry", "_server_lock"),
    ("spark_timeseries_tpu_torch.utils.lineage", "_lock"),
    ("spark_timeseries_tpu_torch._build", "_lock"),
)

MAX_EVENTS = 200_000          # bounded event ring: recording never OOMs

# default for how long a scheduler boundary may wait before declaring
# the run wedged (a real deadlock among scheduled threads, or a
# scheduled thread blocked on something the scheduler cannot see);
# override per run with ``instrument(stall_timeout_s=...)`` — e.g. when
# a scheduled thread legitimately builds a kernel library
STALL_TIMEOUT_S = 30.0


class SchedulerStall(RuntimeError):
    """The adversarial scheduler waited :data:`STALL_TIMEOUT_S` without
    any scheduled thread making progress — a real deadlock among the
    scheduled threads, or one of them is blocked outside instrumented
    boundaries."""


class TracedLock:
    """A lock wrapper recording acquire/release into the harness.

    Supports the context-manager protocol, ``acquire``/``release``, and
    delegates anything else (``Condition`` integration's
    ``_is_owned``/``_release_save``/``_acquire_restore``) to the inner
    lock.  When the harness is closed (the ``instrument`` block exited)
    the wrapper degrades to a transparent passthrough, so objects that
    outlive the block keep working.
    """

    def __init__(self, inner: Any, name: str, harness: "RaceHarness"):
        self._inner = inner
        self._name = name
        self._harness = harness

    # -- lock protocol ------------------------------------------------------

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        h = self._harness
        if not h.active:
            return self._inner.acquire(blocking, timeout)
        sched = h.scheduler
        if sched is not None and blocking and sched.participating():
            # never hold the scheduler turn while blocked on a real
            # lock: spin try-acquire, parking at a boundary per miss
            while True:
                if self._inner.acquire(False):
                    h.record("acquire", self._name)
                    try:
                        sched.boundary(f"acquire:{self._name}")
                    except BaseException:
                        # a SchedulerStall here must not leak the real
                        # lock we just took: the wrapper is later
                        # unwound and the still-held inner lock would
                        # deadlock the whole process, masking the
                        # named stall with a silent hang
                        h.record("release", self._name)
                        self._inner.release()
                        raise
                    return True
                sched.boundary(f"acquire_wait:{self._name}")
        ok = self._inner.acquire(blocking, timeout)
        if ok:
            h.record("acquire", self._name)
        return ok

    def release(self) -> None:
        h = self._harness
        if h.active:
            h.record("release", self._name)
            sched = h.scheduler
            self._inner.release()
            if sched is not None and sched.participating():
                sched.boundary(f"release:{self._name}")
            return
        self._inner.release()

    def __enter__(self) -> "TracedLock":
        self.acquire()
        return self

    def __exit__(self, *exc) -> bool:
        self.release()
        return False

    def locked(self) -> bool:
        return self._inner.locked()

    def __getattr__(self, name: str) -> Any:
        return getattr(self._inner, name)

    def __repr__(self) -> str:
        return f"TracedLock({self._name!r})"


class AdversarialScheduler:
    """Seeded deterministic thread serializer.

    Threads pre-registered via :meth:`register` (done by
    :meth:`RaceHarness.spawn` *before* the thread starts, so the live
    set never depends on OS start timing) run one at a time: each
    instrumented boundary parks the calling thread; when every live
    scheduled thread is parked, the seeded RNG picks which one proceeds.
    The decision sequence (:attr:`trace`) is a pure function of the seed
    and the thread programs — the determinism ``tests/test_races.py``
    pins.
    """

    def __init__(self, seed: int, stall_timeout_s: Optional[float] = None):
        self.seed = int(seed)
        self.stall_timeout_s = float(stall_timeout_s) \
            if stall_timeout_s is not None else STALL_TIMEOUT_S
        self._rng = random.Random(self.seed)
        self._cv = _REAL_CONDITION(_REAL_LOCK())
        self._live: Set[str] = set()
        self._waiting: Dict[str, str] = {}    # parked label -> boundary
        self._chosen: Optional[str] = None
        self._labels: Dict[int, str] = {}     # thread ident -> label
        # the decision sequence: (chosen label, the boundary it was
        # parked at).  Appended only at choice time — when every live
        # thread is parked — so it is a pure function of seed + thread
        # programs (boundary *arrival* order is OS timing and is
        # deliberately not recorded here)
        self.trace: List[Tuple[str, str]] = []

    # -- registration -------------------------------------------------------

    def register(self, label: str) -> None:
        with self._cv:
            if label in self._live:
                raise ValueError(f"duplicate scheduled label {label!r}")
            self._live.add(label)
            self._cv.notify_all()

    def bind(self, label: str) -> None:
        """Called on the spawned thread's first instruction: maps its
        ident to the pre-registered label."""
        with self._cv:
            self._labels[threading.get_ident()] = label
            self._cv.notify_all()

    def unregister(self, label: str) -> None:
        with self._cv:
            self._live.discard(label)
            self._waiting.pop(label, None)
            self._labels.pop(threading.get_ident(), None)
            if self._chosen == label:
                self._chosen = None
            # a shrinking live set can complete the everyone-is-parked
            # condition: re-evaluate so parked peers are not stranded
            self._maybe_choose()
            self._cv.notify_all()

    def participating(self) -> bool:
        return threading.get_ident() in self._labels

    # -- the serializing boundary ------------------------------------------

    def boundary(self, what: str) -> None:
        me = self._labels.get(threading.get_ident())
        if me is None:
            return
        with self._cv:
            self._waiting[me] = what
            self._maybe_choose()
            # wall-clock deadline (not iteration-counted: notify_all
            # wakes waiters early, which would over-count a loop budget)
            deadline = time.monotonic() + self.stall_timeout_s
            while self._chosen != me:
                self._maybe_choose()
                if self._chosen == me:
                    break
                self._cv.wait(0.02)
                if time.monotonic() > deadline:
                    raise SchedulerStall(
                        f"no progress for {self.stall_timeout_s:g}s: "
                        f"live={sorted(self._live)} "
                        f"waiting={sorted(self._waiting)} "
                        f"chosen={self._chosen!r} — a scheduled thread "
                        f"is blocked outside instrumented boundaries "
                        f"(raise instrument(stall_timeout_s=...) if its "
                        f"work is legitimately slow), or the threads "
                        f"genuinely deadlock")
            self._chosen = None
            self._waiting.pop(me, None)

    def _maybe_choose(self) -> None:
        # choose only when every live scheduled thread is parked — the
        # one condition that makes the pick order independent of OS
        # timing (threads not yet at a boundary could otherwise race
        # the choice)
        if self._chosen is None and self._waiting \
                and set(self._waiting) >= self._live:
            pick = self._rng.choice(sorted(self._waiting))
            self._chosen = pick
            self.trace.append((pick, self._waiting[pick]))
            self._cv.notify_all()


class RaceHarness:
    """One ``instrument()`` block's recording + scheduling state."""

    def __init__(self, seed: Optional[int] = None,
                 stall_timeout_s: Optional[float] = None):
        self.active = True
        self.scheduler = AdversarialScheduler(seed, stall_timeout_s) \
            if seed is not None else None
        self.events: List[Tuple[str, str, str]] = []
        self.errors: List[BaseException] = []
        self._edges: Dict[Tuple[str, str], str] = {}
        self._held: Dict[int, List[str]] = {}
        self._ilock = _REAL_LOCK()
        self._site_counts: Dict[str, int] = {}
        self._threads: List[threading.Thread] = []
        self._pending: List[threading.Thread] = []
        # ident -> display name.  The recording path must NEVER call
        # threading.current_thread(): on a foreign thread it constructs
        # a _DummyThread whose internal Event uses the (patched) lock
        # factory — infinite recursion through record()
        self._names: Dict[int, str] = {threading.get_ident(): "main"}

    # -- recording ----------------------------------------------------------

    def record(self, op: str, name: str) -> None:
        ident = threading.get_ident()
        with self._ilock:
            tname = self._names.get(ident) or f"t{ident}"
            if len(self.events) < MAX_EVENTS:
                self.events.append((tname, op, name))
            held = self._held.setdefault(ident, [])
            if op == "acquire":
                for a in held:
                    if a != name:
                        self._edges.setdefault((a, name), tname)
                held.append(name)
            elif op == "release":
                # remove the innermost matching acquisition (reentrant
                # RLocks release in LIFO order)
                for i in range(len(held) - 1, -1, -1):
                    if held[i] == name:
                        del held[i]
                        break

    def site_name(self, site: str) -> str:
        """Disambiguate several locks minted at one source site
        (``a, b = Lock(), Lock()``): the first keeps the plain site
        name, later ones get ``#2``, ``#3``... — per-site creation
        order is (same-thread) deterministic where overall creation
        order is not."""
        with self._ilock:
            n = self._site_counts.get(site, 0) + 1
            self._site_counts[site] = n
            return site if n == 1 else f"{site}#{n}"

    # -- the runtime lock-order graph ---------------------------------------

    def order_graph(self) -> Dict[str, Set[str]]:
        """``lock -> {locks acquired while holding it}`` as exercised."""
        with self._ilock:
            pairs = list(self._edges)
        graph: Dict[str, Set[str]] = {}
        for a, b in pairs:
            graph.setdefault(a, set()).add(b)
            graph.setdefault(b, set())
        return graph

    def cycles(self) -> List[List[str]]:
        """SCCs of size > 1 in the exercised acquisition-order graph
        (Tarjan)."""
        graph = self.order_graph()
        index: Dict[str, int] = {}
        low: Dict[str, int] = {}
        on_stack: Set[str] = set()
        stack: List[str] = []
        out: List[List[str]] = []
        counter = [0]

        def strong(v: str) -> None:
            index[v] = low[v] = counter[0]
            counter[0] += 1
            stack.append(v)
            on_stack.add(v)
            for w in sorted(graph[v]):
                if w not in index:
                    strong(w)
                    low[v] = min(low[v], low[w])
                elif w in on_stack:
                    low[v] = min(low[v], index[w])
            if low[v] == index[v]:
                comp = []
                while True:
                    w = stack.pop()
                    on_stack.discard(w)
                    comp.append(w)
                    if w == v:
                        break
                if len(comp) > 1:
                    out.append(sorted(comp))

        for v in sorted(graph):
            if v not in index:
                strong(v)
        return sorted(out)

    def assert_acyclic(self) -> None:
        cyc = self.cycles()
        if cyc:
            raise AssertionError(
                f"lock-acquisition-order cycle(s) exercised at runtime: "
                f"{cyc}; edges={sorted(self._edges)}")

    @property
    def schedule_trace(self) -> List[Tuple[str, str]]:
        """The scheduler's decision/boundary sequence (empty without a
        seed) — the object the same-seed determinism test compares."""
        return list(self.scheduler.trace) if self.scheduler else []

    # -- scheduled thread spawning ------------------------------------------

    def spawn(self, fn: Callable[[], Any], *,
              label: Optional[str] = None) -> threading.Thread:
        """Create a daemon worker with exception capture into
        :attr:`errors`.  Without a scheduler it starts immediately.
        With one armed, the worker is registered now but *started* by
        :meth:`start_all` / :meth:`join_all` — the full participant set
        must be fixed before the first scheduling decision, or the
        schedule would depend on how fast each spawn call raced the
        chooser."""
        name = label or f"worker-{len(self._threads)}"
        sched = self.scheduler
        if sched is not None:
            sched.register(name)

        def _runner() -> None:
            try:
                with self._ilock:
                    self._names[threading.get_ident()] = name
                if sched is not None:
                    sched.bind(name)
                    sched.boundary("start")
                fn()
            except BaseException as e:  # noqa: BLE001 — surfaced via
                # .errors: a worker must never die silently
                with self._ilock:
                    self.errors.append(e)
            finally:
                if sched is not None:
                    sched.unregister(name)

        t = threading.Thread(target=_runner, name=name, daemon=True)
        self._threads.append(t)
        if sched is None:
            t.start()
        else:
            self._pending.append(t)
        return t

    def start_all(self) -> None:
        """Start every scheduler-deferred worker (the participant set
        is now complete; the seeded chooser takes over from here)."""
        pending, self._pending = self._pending, []
        for t in pending:
            t.start()

    def join_all(self, timeout: float = 60.0) -> None:
        self.start_all()
        for t in self._threads:
            t.join(timeout)
        alive = [t.name for t in self._threads if t.is_alive()]
        if alive:
            raise AssertionError(f"workers still alive after "
                                 f"{timeout:g}s: {alive}")

    def raise_errors(self) -> None:
        if self.errors:
            raise self.errors[0]

    def wrap(self, name: str, lock: Any) -> "TracedLock":
        """Wrap an arbitrary pre-existing lock object (an engine
        instance's cache lock, a fixture's own lock); the caller rebinds
        the returned wrapper wherever the lock lives."""
        if isinstance(lock, TracedLock):
            return lock
        return TracedLock(lock, name, self)


_active: Optional[RaceHarness] = None


def active() -> Optional[RaceHarness]:
    """The harness of the enclosing ``instrument()`` block, if any."""
    return _active


def yield_point() -> None:
    """An explicit scheduling boundary: free when uninstrumented, a
    deterministic preemption point under ``instrument(seed=...)``.
    Sprinkle into check-then-act windows you want the adversarial
    scheduler to be able to split."""
    h = _active
    if h is not None and h.scheduler is not None:
        h.scheduler.boundary("yield")


def _wrap_registry(harness: RaceHarness, registry) -> List[Tuple[Any,
                                                                 str, Any]]:
    """Wrap the metrics registry's shared RLock in place: the registry
    and every live metric handle hold the SAME lock object, so each
    holder's ``_lock`` attribute is rebound to one shared wrapper."""
    restores: List[Tuple[Any, str, Any]] = []
    inner = registry._lock
    wrapper = TracedLock(inner, "metrics.registry", harness)
    holders = [registry]
    for table in (registry._counters, registry._gauges,
                  registry._histograms, registry._spans):
        holders.extend(table.values())
    for holder in holders:
        if getattr(holder, "_lock", None) is inner:
            restores.append((holder, "_lock", inner))
            holder._lock = wrapper
    return restores


@contextlib.contextmanager
def instrument(seed: Optional[int] = None, *, wrap_known: bool = True,
               wrap_registry: bool = True,
               stall_timeout_s: Optional[float] = None):
    """Arm the sanitizer for the dynamic extent of the block.

    ``seed=None`` records only (lock events, spawns, the order graph);
    an integer seed additionally arms the deterministic adversarial
    scheduler for threads spawned via :meth:`RaceHarness.spawn`
    (``stall_timeout_s`` overrides the :data:`STALL_TIMEOUT_S` wedge
    deadline — raise it when a scheduled thread legitimately does slow
    uninstrumented work, e.g. a first kernel build).  Pre-existing
    instance locks are wrapped via :meth:`RaceHarness.wrap`.  Nesting
    is rejected — one harness owns the factories at a time.
    """
    global _active
    if _active is not None:
        raise RuntimeError("races.instrument() blocks do not nest")
    harness = RaceHarness(seed, stall_timeout_s)
    restores: List[Tuple[Any, str, Any]] = []

    def _site_name(kind: str) -> str:
        # name by creation SITE, not creation order: the same program
        # must produce the same lock names run over run (the
        # determinism pin compares schedule traces containing them),
        # and import-time lock creation would otherwise shift a
        # counter between first and later runs
        frame = sys._getframe(2)
        return (f"{kind}@{os.path.basename(frame.f_code.co_filename)}"
                f":{frame.f_lineno}")

    def traced_lock_factory():
        return TracedLock(_REAL_LOCK(),
                          harness.site_name(_site_name("lock")), harness)

    def traced_rlock_factory():
        return TracedLock(_REAL_RLOCK(),
                          harness.site_name(_site_name("rlock")),
                          harness)

    def traced_start(thread, *a, **kw):
        harness.record("spawn", thread.name)
        return _REAL_THREAD_START(thread, *a, **kw)

    try:
        # import the known-lock owners BEFORE patching the factories,
        # so a first-ever import doesn't mint its module locks through
        # the traced path (names and counts must not depend on import
        # history)
        known_mods = []
        if wrap_known:
            for mod_name, attr in KNOWN_LOCKS:
                try:
                    known_mods.append(
                        (importlib.import_module(mod_name), mod_name,
                         attr))
                except Exception:  # noqa: BLE001 — a tier that cannot
                    continue       # import is simply not instrumented
        threading.Lock = traced_lock_factory        # type: ignore
        threading.RLock = traced_rlock_factory      # type: ignore
        threading.Thread.start = traced_start       # type: ignore
        restores.append((threading, "Lock", _REAL_LOCK))
        restores.append((threading, "RLock", _REAL_RLOCK))
        restores.append((threading.Thread, "start", _REAL_THREAD_START))
        for mod, mod_name, attr in known_mods:
            inner = getattr(mod, attr, None)
            if inner is None or isinstance(inner, TracedLock):
                continue
            short = f"{mod_name.rsplit('.', 1)[-1]}.{attr}"
            restores.append((mod, attr, inner))
            setattr(mod, attr, TracedLock(inner, short, harness))
        if wrap_registry:
            from . import metrics as _metrics
            restores.extend(_wrap_registry(harness,
                                           _metrics.get_registry()))
        _active = harness
        yield harness
    finally:
        _active = None
        harness.active = False
        for owner, attr, value in reversed(restores):
            try:
                setattr(owner, attr, value)
            except Exception:  # noqa: BLE001 — restoration must finish
                pass
