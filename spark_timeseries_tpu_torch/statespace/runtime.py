"""Supervised fleet runtime: the hands-off layer around
:class:`~.fleet.FleetScheduler` (counterpart of
``spark_timeseries_tpu/statespace/runtime.py``).

``FleetScheduler`` is synchronous and single-threaded: callers
``submit()`` and ``pump()``.  :class:`FleetRuntime` runs the pump for
them:

- **Supervised pump.**  One daemon thread sweeps every shard scheduler's
  :meth:`~.fleet.FleetScheduler.pump` under the runtime lock, stamping a
  heartbeat into a ``fleet-pump`` ``JobProgress``.  A watchdog thread
  finds a dead pump (the thread exited on an exception; a forensics
  bundle is recorded first) or a wedged one (heartbeat older than
  ``RuntimePolicy.stall_after_s``) and restarts it with bounded
  exponential backoff (``durability.BackoffPolicy``), counting
  ``fleet.pump_restarts``.  A wedged thread is abandoned through a
  generation token.  A fault of a kernel or of the card
  (``_device.is_device_fault``) is not restarted: the runtime records
  the incident, stops, and raises the fault from the next
  :meth:`FleetRuntime.submit`, :meth:`~FleetRuntime.quiesce` or
  :meth:`~FleetRuntime.stop`.
- **Backpressure.**  :meth:`FleetRuntime.submit` with ``block=True``
  waits on a condition variable for queue space instead of raising
  :class:`~.fleet.FleetSaturated`; past its deadline it raises
  :class:`FleetBackpressureTimeout`.  The tick's lineage clock starts
  before any wait; ticks still queued when the watchdog replaces a
  crashed pump are marked ``pump_restart_redelivery`` by the next
  generation's first sweep (the same record, never a duplicate).
- **Crash-only auto-checkpoint.**  Interval- and dirty-tick-driven
  snapshots of every tenant in the drain bundle format
  (``FleetScheduler.checkpoint_tenant``), one generation directory per
  pass, committed by the fsynced rename of ``MANIFEST.json`` after every
  bundle.  A ``kill -9`` at any instant leaves a committed generation or
  debris that :meth:`FleetRuntime.restore_latest` never sees.
- **Rebalance.**  With several shard schedulers, a placement pass
  consolidates the fragments of one coalescing group toward its largest
  fragment, then moves the busiest shard's lightest whole-group tenant
  past ``RuntimePolicy.rebalance_imbalance``; every move is a ``drain``
  then ``adopt(replay=True)``, bitwise.

Fault modes ``pump_crash`` / ``pump_hang`` / ``checkpoint_torn``
(``utils.resilience``) target exactly these paths.
"""

from __future__ import annotations

import itertools
import json
import os
import shutil
import signal
import threading
import time
from typing import Any, Dict, List, NamedTuple, Optional, Tuple

from .._device import is_device_fault
from ..utils import lineage as _lineage
from ..utils import metrics as _metrics
from ..utils import resilience as _resilience
from ..utils import telemetry as _telemetry
from ..utils.durability import BackoffPolicy
from .fleet import TENANT_LIVE, FleetSaturated, FleetScheduler
from .serving import check_label

__all__ = ["RuntimePolicy", "FleetRuntime", "FleetBackpressureTimeout"]

_runtime_seq = itertools.count(1)

# generation directory and manifest names under checkpoint_dir
_GEN_PREFIX = "gen-"
_MANIFEST = "MANIFEST.json"
_MANIFEST_FORMAT = 1


class FleetBackpressureTimeout(RuntimeError):
    """A blocking :meth:`FleetRuntime.submit` waited out its deadline
    for queue space: the caller sees which tenant stayed saturated for
    how long."""


class RuntimePolicy(NamedTuple):
    """Knobs of one :class:`FleetRuntime`.

    - ``pump_interval_s``: idle sleep between pump sweeps (a submit
      wakes the pump at once);
    - ``watchdog_interval_s``: supervision poll cadence;
    - ``stall_after_s``: heartbeat age past which the watchdog declares
      the pump wedged and abandons it;
    - ``backoff``: restart backoff (None: ``BackoffPolicy()``); restarts
      themselves are unbounded;
    - ``checkpoint_dir``: root of the auto-checkpoint generations (None
      disables them and :meth:`FleetRuntime.checkpoint`);
    - ``checkpoint_interval_s`` / ``checkpoint_dirty_ticks``: a pass runs
      when this much wall time has passed or this many ticks were
      admitted since the last committed generation (0 disables each);
    - ``keep_generations``: committed generations kept on disk;
    - ``rebalance_interval_s``: placement-pass cadence (0: only
      :meth:`FleetRuntime.rebalance`);
    - ``rebalance_imbalance``: busiest / lightest shard load ratio that
      triggers a load-spreading move;
    - ``max_moves_per_cycle``: migrations per placement pass."""

    pump_interval_s: float = 0.005
    watchdog_interval_s: float = 0.05
    stall_after_s: float = 5.0
    backoff: Optional[BackoffPolicy] = None
    checkpoint_dir: Optional[str] = None
    checkpoint_interval_s: float = 0.0
    checkpoint_dirty_ticks: int = 0
    keep_generations: int = 2
    rebalance_interval_s: float = 0.0
    rebalance_imbalance: float = 2.0
    max_moves_per_cycle: int = 1

    def validate(self) -> "RuntimePolicy":
        if self.pump_interval_s <= 0 or self.watchdog_interval_s <= 0:
            raise ValueError(
                "pump_interval_s and watchdog_interval_s must be > 0")
        if self.stall_after_s <= 0:
            raise ValueError("stall_after_s must be > 0")
        if self.checkpoint_interval_s < 0 or self.checkpoint_dirty_ticks < 0:
            raise ValueError("checkpoint_interval_s and "
                             "checkpoint_dirty_ticks must be >= 0")
        if self.keep_generations < 1:
            raise ValueError("keep_generations must be >= 1")
        if self.rebalance_interval_s < 0:
            raise ValueError("rebalance_interval_s must be >= 0")
        if self.rebalance_imbalance < 1.0:
            raise ValueError("rebalance_imbalance must be >= 1.0")
        if self.max_moves_per_cycle < 1:
            raise ValueError("max_moves_per_cycle must be >= 1")
        if (self.checkpoint_interval_s > 0 or self.checkpoint_dirty_ticks
                > 0) and not self.checkpoint_dir:
            raise ValueError(
                "auto-checkpoint triggers need checkpoint_dir set")
        return self


def _fsync_write_json(path: str, doc: Dict[str, Any]) -> None:
    """tmp + fsync + rename + directory fsync: the manifest is the
    generation's commit point."""
    tmp = f"{path}.tmp-{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump(doc, f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    dfd = os.open(os.path.dirname(path) or ".", os.O_RDONLY)
    try:
        os.fsync(dfd)
    finally:
        os.close(dfd)


class FleetRuntime:
    """Supervise one or more shard :class:`~.fleet.FleetScheduler`\\ s:
    background pump and watchdog, blocking admission, auto-checkpoint
    and rebalancing (module docstring for the contract).

    Build it over the shard(s), :meth:`start` it (or use it as a context
    manager), then :meth:`submit` from any number of producer threads.
    Every touch of a scheduler (sweeps, submits, checkpoints,
    migrations, :meth:`forecast`) holds one runtime lock."""

    def __init__(self, schedulers, *, policy: Optional[RuntimePolicy] = None,
                 registry=None, label: Optional[str] = None):
        if isinstance(schedulers, FleetScheduler):
            schedulers = [schedulers]
        self.shards: List[FleetScheduler] = list(schedulers)
        if not self.shards:
            raise ValueError("FleetRuntime needs at least one scheduler")
        seen: Dict[str, str] = {}
        for sh in self.shards:
            for la in sh.tenants:
                if la in seen:
                    raise ValueError(
                        f"tenant label {la!r} appears in shards "
                        f"{seen[la]!r} and {sh.label!r}; the runtime "
                        f"routes by label — labels must be unique "
                        f"across its shards")
                seen[la] = sh.label
        self.policy = (policy if policy is not None
                       else RuntimePolicy()).validate()
        self._backoff = self.policy.backoff if self.policy.backoff \
            is not None else BackoffPolicy()
        self._reg = registry if registry is not None \
            else _metrics.get_registry()
        self.label = check_label(label) if label is not None \
            else f"runtime{next(_runtime_seq)}"
        # the runtime lock guards every scheduler; the condition variable
        # shares it (the pump notifies blocked submits and quiesce after
        # every sweep)
        self._lock = threading.Lock()
        self._cv = threading.Condition(self._lock)
        # management state (generation token, restart bookkeeping) has a
        # small lock of its own, always taken after the runtime lock,
        # never before: the watchdog takes only this one, so it can
        # declare a wedged pump dead while that pump holds the runtime
        # lock
        self._mgmt_lock = threading.Lock()
        self._wake = threading.Event()
        self._stop = threading.Event()
        self._gen = 0                    # pump-thread generation token
        # set by the watchdog on every restart; the next generation's
        # first sweep marks the still-queued ticks as redelivered
        self._redeliver = False
        self._pump_thread: Optional[threading.Thread] = None
        self._watchdog_thread: Optional[threading.Thread] = None
        self._started = False
        self._pump_count = 0
        self._restarts = 0
        self._consec_failures = 0
        self._waiters = 0
        self._dirty = 0                  # ticks since the last generation
        self._last_error: Optional[str] = None
        # a kernel or card fault of the pump: the runtime stopped on it
        # and raises it to the caller
        self._fatal: Optional[BaseException] = None
        self._hang_tokens: set = set()   # pump_hang: once per fault scope
        self._ckpt_failures = 0
        self._ckpt_gen = 0
        self._last_ckpt_t = time.monotonic()
        self._last_ckpt_unix: Optional[float] = None
        self._last_rebalance_t = time.monotonic()
        self._migrations = 0
        ckdir = self.policy.checkpoint_dir
        if ckdir:
            os.makedirs(ckdir, exist_ok=True)
            # number past every existing generation directory, committed
            # or torn, so that a crashed generation's number is never
            # reused
            self._ckpt_gen = max(
                [g for g, _ in self._scan_generations(ckdir,
                                                      committed_only=False)]
                or [0])
        self._job = _telemetry.JobProgress(
            _telemetry.new_job_id("fleet-pump"), family="fleet-pump",
            n_series=sum(len(sh.tenants) for sh in self.shards),
            n_chunks=0, chunk_size=0)
        for sh in self.shards:
            sh.auto_pump = False         # the runtime owns pumping
            sh._runtime_info = self.pump_summary
        _telemetry.register_fleet_runtime(self)
        self._reg.inc("fleet.runtimes")

    # -- lifecycle ----------------------------------------------------------

    def start(self) -> "FleetRuntime":
        """Spawn the pump and watchdog daemons and register the pump's
        heartbeat job.  A runtime starts once: a stopped one is done
        (build a new one over the same schedulers)."""
        with self._mgmt_lock:
            if self._started:
                raise RuntimeError(f"runtime {self.label!r} is already "
                                   f"started")
            if self._job.status != "running":
                raise RuntimeError(
                    f"runtime {self.label!r} was stopped; a runtime "
                    f"runs once — build a new FleetRuntime over the "
                    f"same schedulers")
            self._started = True
            self._stop.clear()
            _telemetry.register_job(self._job, self._reg)
            self._job.heartbeat("pump_start")
            self._spawn_pump_mgmt_locked()
            self._watchdog_thread = threading.Thread(
                target=self._watchdog_main, daemon=True,
                name=f"sts-{self.label}-watchdog")
            self._watchdog_thread.start()
        return self

    def stop(self, *, checkpoint: bool = True) -> None:
        """Stop supervision (idempotent).  ``checkpoint=True`` commits one
        final generation first when a ``checkpoint_dir`` is set.  After a
        device fault of the pump no generation is written (the card's
        state cannot be trusted) and the fault is raised once the
        threads are down."""
        with self._mgmt_lock:
            if not self._started:
                return
            self._stop.set()
            self._gen += 1               # abandon the pump loop
            pump, dog = self._pump_thread, self._watchdog_thread
        self._wake.set()
        with self._cv:
            self._cv.notify_all()
        for th in (pump, dog):
            if th is not None and th.is_alive():
                th.join(timeout=10.0)
        fatal = self._fatal
        if checkpoint and self.policy.checkpoint_dir and fatal is None:
            with self._lock:
                self._checkpoint_locked()
        with self._mgmt_lock:
            self._started = False
        _telemetry.finish_job(
            self._job, "done" if fatal is None else "failed",
            None if fatal is None else self._last_error, registry=self._reg)
        if fatal is not None:
            raise fatal

    def __enter__(self) -> "FleetRuntime":
        return self.start()

    def __exit__(self, exc_type, exc, tb) -> None:
        try:
            self.stop()
        except BaseException as e:
            if e is not exc:             # the fault already on its way
                raise

    @property
    def running(self) -> bool:
        with self._mgmt_lock:
            return self._started

    def _raise_if_fatal(self) -> None:
        fatal = self._fatal
        if fatal is not None:
            raise fatal

    # -- tenant routing ------------------------------------------------------

    def _find(self, label: str) -> Tuple[FleetScheduler, Any]:
        for sh in self.shards:
            t = sh._tenants.get(label)
            if t is not None:
                return sh, t
        raise KeyError(
            f"no tenant {label!r} in runtime {self.label!r} "
            f"(shards: {[sh.label for sh in self.shards]})")

    def attach(self, session, *, shard: Optional[str] = None) -> str:
        """Attach a session to a shard (named, or the least loaded by
        tenant count) under the runtime lock."""
        with self._lock:
            if shard is not None:
                targets = [sh for sh in self.shards if sh.label == shard]
                if not targets:
                    raise KeyError(
                        f"no shard {shard!r} in runtime {self.label!r}")
                target = targets[0]
            else:
                target = min(self.shards, key=lambda sh: len(sh._tenants))
            for sh in self.shards:
                if session.label in sh._tenants:
                    raise ValueError(
                        f"tenant label {session.label!r} is already "
                        f"attached to shard {sh.label!r}")
            return target.attach(session)

    def warmup(self) -> None:
        """Every shard's :meth:`~.fleet.FleetScheduler.warmup`."""
        with self._lock:
            for sh in self.shards:
                sh.warmup()

    def forecast(self, label: str, horizon: int, offsets=None):
        with self._lock:
            sh, _ = self._find(label)
            return sh.forecast(label, horizon, offsets=offsets)

    # -- admission with backpressure ----------------------------------------

    def submit(self, label: str, tick, offset=None, *, block: bool = True,
               timeout: Optional[float] = None) -> None:
        """Admit one tick.  ``block=True`` (default) waits for queue
        space while the pump drains instead of raising
        :class:`~.fleet.FleetSaturated`; past ``timeout`` seconds it
        raises :class:`FleetBackpressureTimeout`.  ``block=False`` is
        the raw admission policy.  On a runtime that is not started the
        call does not block (nothing would drain the queue).  After a
        device fault of the pump it raises that fault."""
        self._raise_if_fatal()
        deadline = None if timeout is None \
            else time.monotonic() + float(timeout)
        # the lineage clock starts before any backpressure wait: the
        # record minted at admission carries the wait in "admit"
        _lineage.submit_entry()
        with self._cv:
            waited = False
            while True:
                if self._fatal is not None:
                    _lineage.submit_abandon()
                    raise self._fatal
                sh, t = self._find(label)   # after each wait: the tenant
                #                             may have been rebalanced
                blocking = block and self.running \
                    and t.mode == TENANT_LIVE
                if not (blocking and len(t.queue)
                        >= sh.policy.queue_depth):
                    try:
                        sh.submit(label, tick, offset)
                        self._dirty += 1
                        break
                    except FleetSaturated:
                        # raced an admission transition under 'reject': a
                        # blocking producer waits instead
                        if not blocking:
                            raise
                remaining = None if deadline is None \
                    else deadline - time.monotonic()
                if remaining is not None and remaining <= 0:
                    self._reg.inc("fleet.backpressure_timeouts")
                    # nothing was admitted: drop the pending lineage
                    # context so that it cannot leak into a later submit
                    _lineage.submit_abandon()
                    raise FleetBackpressureTimeout(
                        f"tenant {label!r} ingress queue stayed full "
                        f"({sh.policy.queue_depth} ticks) for "
                        f"{float(timeout):g}s; the pump is not keeping "
                        f"up — shed load upstream or raise the "
                        f"timeout/queue depth")
                self._waiters += 1
                self._wake.set()         # kick the pump to drain
                _lineage.submit_parked()
                try:
                    self._cv.wait(remaining)
                finally:
                    self._waiters -= 1
                waited = True
            if waited:
                self._reg.inc("fleet.backpressure_waits")
        self._wake.set()

    def quiesce(self, timeout: Optional[float] = None) -> bool:
        """Wait until every tenant's ingress queue is empty (the pump has
        dispatched everything admitted so far).  Returns False on
        timeout or when the runtime is not running; raises the pump's
        device fault."""
        deadline = None if timeout is None \
            else time.monotonic() + float(timeout)
        with self._cv:
            while True:
                self._raise_if_fatal()
                if not any(len(t.queue) for sh in self.shards
                           for t in sh._tenants.values()):
                    return True
                if not self.running:
                    return False
                remaining = 0.25 if deadline is None \
                    else min(0.25, deadline - time.monotonic())
                if remaining <= 0:
                    return False
                self._wake.set()
                self._cv.wait(remaining)

    # -- the supervised pump -------------------------------------------------

    def _current_gen(self) -> int:
        with self._mgmt_lock:
            return self._gen

    def _spawn_pump_mgmt_locked(self) -> None:
        gen = self._gen
        th = threading.Thread(target=self._pump_main, args=(gen,),
                              daemon=True,
                              name=f"sts-{self.label}-pump-g{gen}")
        self._pump_thread = th
        th.start()

    def _pump_main(self, gen: int) -> None:
        try:
            while not self._stop.is_set() and self._current_gen() == gen:
                self._pump_sweep(gen)
                if self._wake.wait(self.policy.pump_interval_s):
                    self._wake.clear()
        except BaseException as e:  # noqa: BLE001 — the supervisor's job
            if self._stop.is_set():
                return
            if is_device_fault(e):
                self._note_device_fault(e)
            else:
                self._note_pump_death(e)

    def _maybe_hang(self) -> None:
        # pump_hang: one sweep per fault scope sleeps outside the runtime
        # lock (the waitable kind of wedge)
        spec = _resilience.fleet_fault("pump_hang")
        if spec is None:
            return
        tok = _resilience.fault_scope_token()
        if tok in self._hang_tokens:
            return
        self._hang_tokens.add(tok)
        time.sleep(spec.hang_s)

    def _pump_sweep(self, gen: int) -> int:
        """One supervised sweep: heartbeat, fault hooks, every shard's
        pump, due auto-checkpoint and rebalance, waiters notified."""
        self._maybe_hang()
        with self._lock:
            if self._stop.is_set() or self._current_gen() != gen:
                return 0
            self._pump_count += 1
            self._job.heartbeat("pump")
            crash = _resilience.fleet_fault("pump_crash")
            if crash is not None and \
                    self._pump_count % max(1, int(crash.n_attempts)) == 0:
                raise _resilience.InjectedPumpCrash(
                    f"injected pump crash at sweep {self._pump_count} "
                    f"(every {max(1, int(crash.n_attempts))} sweeps)")
            try:
                n = self._sweep_locked()
            except BaseException as e:
                if is_device_fault(e):
                    # set before the lock is released: no waiter may take
                    # the queues the failed tick emptied for delivered
                    self._fatal = e
                raise
            self._job.heartbeat("idle")
            with self._mgmt_lock:
                self._consec_failures = 0
            return n

    def pump_once(self) -> int:
        """One manual sweep (dispatch and due checkpoint / rebalance)
        under the runtime lock, for runtimes that are not started and
        for deterministic tests; the background pump runs the same."""
        with self._lock:
            self._pump_count += 1
            self._job.heartbeat("pump")
            return self._sweep_locked()

    def _sweep_locked(self) -> int:
        self._mark_redelivery_locked()
        n = 0
        for sh in self.shards:
            n += len(sh.pump())
        now = time.monotonic()
        # due checkpoints and rebalances run inside the sweep's lock: the
        # generation snapshots a quiescent scheduler
        self._maybe_checkpoint_locked(now)
        self._maybe_rebalance_locked(now)
        self._cv.notify_all()
        return n

    def _mark_redelivery_locked(self) -> None:
        """Consume the watchdog's restart flag: every tick still queued
        across the pump generation change keeps its original lineage
        record and gets a ``pump_restart_redelivery`` detour."""
        with self._mgmt_lock:
            redeliver = self._redeliver
            self._redeliver = False
        if not redeliver:
            return
        for sh in self.shards:
            for t in sh._tenants.values():
                for entry in t.queue:
                    if entry[3] is not None:
                        entry[3].detour("pump_restart_redelivery")

    def _note_pump_death(self, exc: BaseException) -> None:
        from ..utils import flightrec as _flightrec
        with self._mgmt_lock:
            self._last_error = f"{type(exc).__name__}: {exc}"
            pump_count, restarts = self._pump_count, self._restarts
        self._reg.inc("fleet.pump_deaths")
        self._job.heartbeat("pump_dead")
        _flightrec.record_incident(
            "fleet_pump_death", exc=exc,
            extra={"runtime": self.label, "pump_count": pump_count,
                   "restarts_so_far": restarts},
            registry=self._reg)

    def _note_device_fault(self, exc: BaseException) -> None:
        """A kernel or card fault in the pump: no quiet restart.  Record
        the incident, stop supervision, and wake every waiter, which
        raises the fault."""
        from ..utils import flightrec as _flightrec
        with self._mgmt_lock:
            self._last_error = f"{type(exc).__name__}: {exc}"
            self._fatal = exc
            self._stop.set()
            self._gen += 1
            pump_count = self._pump_count
        self._reg.inc("fleet.pump_device_faults")
        self._job.heartbeat("pump_device_fault")
        _flightrec.record_incident(
            "fleet_pump_device_fault", exc=exc,
            extra={"runtime": self.label, "pump_count": pump_count},
            registry=self._reg)
        with self._cv:
            self._cv.notify_all()

    # -- the watchdog --------------------------------------------------------

    def _watchdog_main(self) -> None:
        while not self._stop.wait(self.policy.watchdog_interval_s):
            with self._mgmt_lock:
                if self._stop.is_set():
                    return
                th = self._pump_thread
                dead = th is None or not th.is_alive()
                wedged = (not dead) and (self._job.heartbeat_age_s()
                                         > self.policy.stall_after_s)
                if not (dead or wedged):
                    continue
                self._consec_failures += 1
                self._restarts += 1
                self._gen += 1           # abandon the old pump thread
                self._redeliver = True   # the next sweep marks survivors
                attempt = min(self._consec_failures, 16)
            self._reg.inc("fleet.pump_restarts")
            if wedged:
                from ..utils import flightrec as _flightrec
                with self._mgmt_lock:
                    self._last_error = (
                        f"pump wedged: heartbeat "
                        f"{self._job.heartbeat_age_s():.3f}s old "
                        f"(> stall_after_s="
                        f"{self.policy.stall_after_s:g})")
                _flightrec.record_incident(
                    "fleet_pump_stall",
                    extra={"runtime": self.label,
                           "heartbeat_age_s": self._job.heartbeat_age_s(),
                           "stall_after_s": self.policy.stall_after_s},
                    registry=self._reg)
            # bounded exponential backoff; it resets as soon as a sweep
            # completes (_consec_failures)
            if self._stop.wait(self._backoff.delay(attempt)):
                return
            with self._mgmt_lock:
                if self._stop.is_set():
                    return
                self._job.heartbeat("pump_restart")
                self._spawn_pump_mgmt_locked()

    # -- auto-checkpoint -----------------------------------------------------

    @staticmethod
    def _scan_generations(ckdir: str, *, committed_only: bool = True
                          ) -> List[Tuple[int, str]]:
        """(generation, dir) pairs under ``ckdir``, ascending;
        ``committed_only`` keeps those whose manifest landed."""
        out = []
        try:
            names = os.listdir(ckdir)
        except OSError:
            return out
        for name in names:
            if not name.startswith(_GEN_PREFIX):
                continue
            try:
                g = int(name[len(_GEN_PREFIX):])
            except ValueError:
                continue
            gdir = os.path.join(ckdir, name)
            if committed_only and not os.path.exists(
                    os.path.join(gdir, _MANIFEST)):
                continue
            out.append((g, gdir))
        out.sort()
        return out

    @classmethod
    def latest_generation(cls, ckdir: str
                          ) -> Optional[Tuple[int, str, Dict[str, Any]]]:
        """The newest committed generation under ``ckdir`` as
        ``(generation, dir, manifest)``, or None.  Torn generations
        (bundles without a manifest) are invisible here."""
        for g, gdir in reversed(cls._scan_generations(ckdir)):
            try:
                with open(os.path.join(gdir, _MANIFEST)) as f:
                    manifest = json.load(f)
            except (OSError, ValueError):
                continue
            if manifest.get("format") == _MANIFEST_FORMAT:
                return g, gdir, manifest
        return None

    def checkpoint(self) -> Optional[Dict[str, Any]]:
        """Commit one generation now (every tenant of every shard).
        Returns the commit report, or None when the pass failed (counted
        in ``fleet.checkpoint_failures``; the torn generation is
        invisible to restore)."""
        if not self.policy.checkpoint_dir:
            raise RuntimeError(
                f"runtime {self.label!r} has no checkpoint_dir "
                f"configured (RuntimePolicy.checkpoint_dir)")
        with self._lock:
            return self._checkpoint_locked()

    def _maybe_checkpoint_locked(self, now: float) -> None:
        p = self.policy
        if not p.checkpoint_dir:
            return
        due = (p.checkpoint_interval_s > 0
               and now - self._last_ckpt_t >= p.checkpoint_interval_s) or \
              (p.checkpoint_dirty_ticks > 0
               and self._dirty >= p.checkpoint_dirty_ticks)
        if due:
            self._checkpoint_locked()

    def _checkpoint_locked(self) -> Optional[Dict[str, Any]]:
        ckdir = self.policy.checkpoint_dir
        gen = self._ckpt_gen + 1
        gdir = os.path.join(ckdir, f"{_GEN_PREFIX}{gen:08d}")
        torn = _resilience.fleet_fault("checkpoint_torn")
        written: List[Dict[str, Any]] = []
        try:
            os.makedirs(gdir, exist_ok=True)
            for idx, sh in enumerate(self.shards):
                for label in sh.tenants:
                    if torn is not None and \
                            len(written) >= max(0, int(torn.n_attempts)):
                        # killed mid-checkpoint: forensics first, then die
                        # before the manifest, so this generation never
                        # commits
                        from ..utils import flightrec as _flightrec
                        _flightrec.record_incident(
                            "checkpoint_torn",
                            extra={"runtime": self.label,
                                   "generation": gen, "dir": gdir,
                                   "bundles_written": len(written)},
                            registry=self._reg)
                        os.kill(os.getpid(), signal.SIGKILL)
                    rep = sh.checkpoint_tenant(
                        label, os.path.join(gdir, label))
                    written.append({"tenant": label, "shard": idx,
                                    "pending": rep["pending"],
                                    "catchup": rep["catchup"]})
        except Exception as e:  # noqa: BLE001 — crash-only: a failed
            # pass never takes the pump down; the previous generation
            # keeps ruling
            if is_device_fault(e):
                raise
            with self._mgmt_lock:
                self._ckpt_failures += 1
            self._reg.inc("fleet.checkpoint_failures")
            from ..utils import flightrec as _flightrec
            _flightrec.record_incident(
                "fleet_checkpoint_failure", exc=e,
                extra={"runtime": self.label, "generation": gen,
                       "dir": gdir, "bundles_written": len(written)},
                registry=self._reg)
            return None
        manifest = {"format": _MANIFEST_FORMAT, "generation": gen,
                    "runtime": self.label, "time_unix": time.time(),
                    "n_shards": len(self.shards), "tenants": written}
        _fsync_write_json(os.path.join(gdir, _MANIFEST), manifest)
        self._ckpt_gen = gen
        self._last_ckpt_t = time.monotonic()
        self._last_ckpt_unix = time.time()
        self._dirty = 0
        self._reg.inc("fleet.checkpoints")
        _metrics.trace_instant(
            "fleet.checkpoint_committed",
            {"runtime": self.label, "generation": gen,
             "tenants": len(written)})
        self._prune_locked(ckdir)
        return {"generation": gen, "dir": gdir, "tenants": len(written)}

    def _prune_locked(self, ckdir: str) -> None:
        committed = self._scan_generations(ckdir)
        for _g, gdir in committed[:-self.policy.keep_generations]:
            shutil.rmtree(gdir, ignore_errors=True)

    def restore_latest(self, *, replay: bool = True) -> List[str]:
        """Adopt every tenant of the newest committed generation into
        this runtime's shards (by the manifest's shard index, modulo the
        shard count) and replay their buffered ticks.  Returns the
        adopted labels (empty without a committed generation)."""
        if not self.policy.checkpoint_dir:
            raise RuntimeError(
                f"runtime {self.label!r} has no checkpoint_dir "
                f"configured (RuntimePolicy.checkpoint_dir)")
        with self._lock:
            # under the lock, so that a checkpoint pass cannot prune the
            # generation mid-adopt
            found = self.latest_generation(self.policy.checkpoint_dir)
            if found is None:
                return []
            gen, gdir, manifest = found
            adopted = []
            for row in manifest["tenants"]:
                sh = self.shards[int(row.get("shard", 0))
                                 % len(self.shards)]
                adopted.append(sh.adopt(
                    os.path.join(gdir, row["tenant"]), replay=replay))
            self._reg.inc("fleet.restored_tenants", len(adopted))
            _metrics.trace_instant(
                "fleet.generation_restored",
                {"runtime": self.label, "generation": gen,
                 "tenants": len(adopted)})
            return adopted

    # -- rebalance -----------------------------------------------------------

    def rebalance(self) -> List[Dict[str, Any]]:
        """Run one placement pass now; returns the executed moves."""
        with self._lock:
            return self._rebalance_locked()

    def _maybe_rebalance_locked(self, now: float) -> None:
        p = self.policy
        if p.rebalance_interval_s <= 0 or len(self.shards) < 2:
            return
        if now - self._last_rebalance_t >= p.rebalance_interval_s:
            self._last_rebalance_t = now
            self._rebalance_locked()

    def _shard_load(self, sh: FleetScheduler) -> int:
        # each tenant costs one gather slot per sweep plus its backlog
        return sum(1 + len(t.queue) for t in sh._tenants.values())

    def _plan_moves(self) -> List[Tuple[str, int, int]]:
        """(label, source shard, destination shard) picks, deterministic:
        first consolidate the fragments of each coalescing group toward
        its largest fragment; failing that, when the busiest shard's
        load exceeds ``rebalance_imbalance`` times the lightest's, move
        the busiest shard's lightest tenant whose group stays whole."""
        moves: List[Tuple[str, int, int]] = []
        frags: Dict[Any, List[Tuple[int, List[str]]]] = {}
        for i, sh in enumerate(self.shards):
            for key, labels in sh._groups.items():
                if labels:
                    frags.setdefault(key, []).append((i, sorted(labels)))
        for key in frags:
            parts = frags[key]
            if len(parts) < 2:
                continue
            # stable largest-fragment winner: size desc, shard index asc
            parts = sorted(parts, key=lambda p: (-len(p[1]), p[0]))
            dst = parts[0][0]
            for src, labels in parts[1:]:
                for label in labels:
                    moves.append((label, src, dst))
        if not moves and len(self.shards) >= 2:
            loads = [self._shard_load(sh) for sh in self.shards]
            busiest = max(range(len(loads)), key=lambda i: loads[i])
            lightest = min(range(len(loads)), key=lambda i: loads[i])
            if busiest != lightest and loads[busiest] > max(
                    1, loads[lightest]) * self.policy.rebalance_imbalance:
                src_sh = self.shards[busiest]
                # spreading never undoes consolidation: only a tenant
                # that is its group's sole member on this shard moves
                movable = [
                    la for la in src_sh.tenants
                    if len(src_sh._groups.get(
                        src_sh._tenants[la].session.update_key, ())) == 1]
                if movable:
                    label = min(
                        movable,
                        key=lambda la: len(src_sh._tenants[la].queue))
                    moves.append((label, busiest, lightest))
        return moves

    def _migrate_dir(self) -> str:
        base = self.policy.checkpoint_dir
        if base is None:
            import tempfile
            base = os.path.join(tempfile.gettempdir(),
                                f"sts-{self.label}-migrations")
        d = os.path.join(base, "migrations")
        os.makedirs(d, exist_ok=True)
        return d

    def _rebalance_locked(self) -> List[Dict[str, Any]]:
        if len(self.shards) < 2:
            return []
        done: List[Dict[str, Any]] = []
        for label, src_i, dst_i in \
                self._plan_moves()[:self.policy.max_moves_per_cycle]:
            src, dst = self.shards[src_i], self.shards[dst_i]
            path = os.path.join(self._migrate_dir(),
                                f"migrate-{self._migrations}-{label}")
            self._migrations += 1
            # the checkpoint path is the migration path: zero tick loss,
            # bitwise
            src.drain(label, path)
            dst.adopt(path, replay=True)
            self._reg.inc("fleet.rebalanced_tenants")
            _metrics.trace_instant(
                "fleet.tenant_rebalanced",
                {"runtime": self.label, "tenant": label,
                 "from": src.label, "to": dst.label})
            done.append({"tenant": label, "from": src.label,
                         "to": dst.label, "path": path})
        return done

    # -- introspection -------------------------------------------------------

    def heartbeat_age_s(self) -> float:
        return self._job.heartbeat_age_s()

    def stale_after_s(self, factor: Optional[float] = None) -> float:
        """Staleness threshold of the pump heartbeat: the jobs'
        ``STS_TELEMETRY_STALE_FACTOR`` contract with the pump interval
        as the cadence (floored at 1 s)."""
        f = _telemetry._stale_factor() if factor is None else float(factor)
        return f * max(self.policy.pump_interval_s, 1.0)

    def is_stale(self, factor: Optional[float] = None) -> bool:
        return self.running and \
            self.heartbeat_age_s() > self.stale_after_s(factor)

    def pump_summary(self) -> Dict[str, Any]:
        """Lock-free liveness block (folded into each shard's
        ``telemetry_summary()``): racy counter reads are fine here, and
        taking the runtime lock would make a scrape wait on a
        dispatch."""
        return {
            "runtime": self.label,
            "running": self._started,
            "pumps": self._pump_count,
            "restarts": self._restarts,
            "heartbeat_age_s": round(self._job.heartbeat_age_s(), 3),
            "stale_after_s": round(self.stale_after_s(), 3),
            "stalled": self.is_stale(),
            "backpressure_waiters": self._waiters,
            "checkpoint_generation": self._ckpt_gen,
            "checkpoint_failures": self._ckpt_failures,
            "last_checkpoint_unix": self._last_ckpt_unix,
            "last_error": self._last_error,
            "device_fault": self._fatal is not None,
        }

    def pump_health(self) -> Dict[str, Any]:
        """The health row of the pump: stale iff running with a
        heartbeat older than the jobs' staleness contract allows."""
        return {
            "runtime": self.label,
            "shards": [sh.label for sh in self.shards],
            "running": self._started,
            "restarts": self._restarts,
            "heartbeat_age_s": round(self._job.heartbeat_age_s(), 3),
            "stale_after_s": round(self.stale_after_s(), 3),
            "stale": self.is_stale(),
        }
