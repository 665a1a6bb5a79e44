"""Live task ledger + stall watchdog — the flight recorder's "what is
this process doing RIGHT NOW" surface.

Two populations share one ledger:

  - **Background daemons** register a :class:`Heartbeat` and beat it
    once per loop iteration.  The ledger keeps (job, thread ident,
    last beat, beat count, interval hint); entries whose thread has
    exited are pruned lazily.
  - **In-flight queries** register a :class:`QueryTask` for the
    duration of ``query_range`` — phase, tenant, trace id, device
    tier, elapsed — with a cooperative cancel flag the engine polls
    at its existing deadline checkpoints.

The :class:`Watchdog` is a tiny daemon that walks the heartbeat table
on an interval: any beat older than its deadline transitions the
entry to *stalled*, increments ``m3_watchdog_stalled_total{job}``
once per transition, and logs the stalled thread's current stack
(grabbed from ``sys._current_frames`` — the same trick as
``/debug/threads``).  A later beat clears the flag and logs recovery.

Everything takes an injectable ``clock`` so tests drive stall
detection with fake time instead of sleeping.
"""

from __future__ import annotations

import sys
import threading
import time
import traceback
from typing import Callable, Dict, List, Optional

from ..utils import instrument

log = instrument.logger("observe.tasks")


class QueryCancelled(Exception):
    """Raised inside the engine when an operator cancels an in-flight
    query via the task ledger (cooperative: checked at the same
    checkpoints as the query deadline)."""


class Heartbeat:
    """Handle held by a background daemon; call :meth:`beat` once per
    loop iteration and :meth:`close` on clean exit."""

    __slots__ = ("job", "ident", "thread_name", "interval_hint_s",
                 "deadline_s", "started", "last_beat", "beats",
                 "stalled", "_ledger", "_closed", "_key")

    def __init__(self, ledger: "TaskLedger", job: str,
                 interval_hint_s: Optional[float],
                 deadline_s: Optional[float]):
        self.job = job
        self.ident = threading.get_ident()
        self.thread_name = threading.current_thread().name
        self.interval_hint_s = interval_hint_s
        self.deadline_s = deadline_s
        now = ledger._clock()
        self.started = now
        self.last_beat = now
        self.beats = 0
        self.stalled = False
        self._ledger = ledger
        self._closed = False

    def beat(self) -> None:
        self.last_beat = self._ledger._clock()
        self.beats += 1
        if self.stalled:
            self.stalled = False
            log.info("watchdog: job recovered", job=self.job,
                     thread=self.thread_name)

    def close(self) -> None:
        if not self._closed:
            self._closed = True
            self._ledger._remove_daemon(self)

    # Context-manager sugar so targets can `with ledger.register_daemon(...)`.
    def __enter__(self) -> "Heartbeat":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


class QueryTask:
    """One in-flight query's ledger entry.  The engine sets ``phase``
    as it moves through parse/fetch/device/eval and polls
    :meth:`check_cancelled` at its deadline checkpoints."""

    __slots__ = ("task_id", "query", "tenant", "trace_id", "namespace",
                 "device_tier", "phase", "batch", "started", "_cancel",
                 "_ledger", "_done")

    def __init__(self, ledger: "TaskLedger", task_id: int, query: str,
                 tenant: str, trace_id: str, namespace: str):
        self.task_id = task_id
        self.query = query
        self.tenant = tenant
        self.trace_id = trace_id
        self.namespace = namespace
        self.device_tier = ""
        self.phase = "queued"
        # set by the serving batcher when this query rides a shared
        # cross-query dispatch: {"size": N, "wait_s": admission wait}
        self.batch = None
        self.started = ledger._clock()
        self._cancel = threading.Event()
        self._ledger = ledger
        self._done = False

    def set_phase(self, phase: str) -> None:
        self.phase = phase

    def cancel(self) -> None:
        self._cancel.set()

    @property
    def cancelled(self) -> bool:
        return self._cancel.is_set()

    def check_cancelled(self) -> None:
        if self._cancel.is_set():
            raise QueryCancelled(
                f"query cancelled by operator (task {self.task_id})")

    def finish(self) -> None:
        if not self._done:
            self._done = True
            self._ledger._remove_query(self)

    def __enter__(self) -> "QueryTask":
        return self

    def __exit__(self, *exc) -> None:
        self.finish()


class TaskLedger:
    """Process-global registry of daemons + in-flight queries.

    Cheap enough to be always-on: registration is a dict insert under
    one lock, a beat is two attribute writes (no lock — single writer
    per handle, and the watchdog tolerates torn reads of a float)."""

    def __init__(self, clock: Callable[[], float] = time.monotonic):
        self._clock = clock
        self._lock = threading.Lock()
        self._daemons: Dict[int, Heartbeat] = {}
        self._queries: Dict[int, QueryTask] = {}
        self._next_task = 0
        self._next_hb = 0

    # -- daemons ---------------------------------------------------

    def register_daemon(self, job: str,
                        interval_hint_s: Optional[float] = None,
                        deadline_s: Optional[float] = None) -> Heartbeat:
        hb = Heartbeat(self, job, interval_hint_s, deadline_s)
        with self._lock:
            hb._key = self._next_hb
            self._next_hb += 1
            self._daemons[hb._key] = hb
        return hb

    def _remove_daemon(self, hb: Heartbeat) -> None:
        with self._lock:
            key = getattr(hb, "_key", None)
            if key is not None:
                self._daemons.pop(key, None)

    def _prune_dead(self) -> None:
        """Drop entries whose thread no longer exists (a daemon that
        died without close() — e.g. killed by an uncaught exception)."""
        live = sys._current_frames()
        with self._lock:
            dead = [k for k, hb in self._daemons.items()
                    if hb.ident not in live]
            for k in dead:
                self._daemons.pop(k, None)

    def daemons(self) -> List[Heartbeat]:
        with self._lock:
            return list(self._daemons.values())

    # -- queries ---------------------------------------------------

    def begin_query(self, query: str, tenant: str = "",
                    trace_id: str = "", namespace: str = "") -> QueryTask:
        with self._lock:
            task_id = self._next_task
            self._next_task += 1
        qt = QueryTask(self, task_id, query, tenant, trace_id, namespace)
        with self._lock:
            self._queries[task_id] = qt
        return qt

    def _remove_query(self, qt: QueryTask) -> None:
        with self._lock:
            self._queries.pop(qt.task_id, None)

    def cancel(self, task_id: int) -> bool:
        with self._lock:
            qt = self._queries.get(task_id)
        if qt is None:
            return False
        qt.cancel()
        log.info("query cancelled via task ledger", task_id=task_id,
                 query=qt.query[:200])
        return True

    def queries(self) -> List[QueryTask]:
        with self._lock:
            return list(self._queries.values())

    # -- views -----------------------------------------------------

    def view(self) -> dict:
        """JSON-ready snapshot for /debug/tasks."""
        self._prune_dead()
        now = self._clock()
        daemons = []
        for hb in self.daemons():
            daemons.append({
                "job": hb.job,
                "thread": hb.thread_name,
                "ident": hb.ident,
                "beats": hb.beats,
                "since_beat_s": round(now - hb.last_beat, 3),
                "interval_hint_s": hb.interval_hint_s,
                "stalled": hb.stalled,
            })
        daemons.sort(key=lambda d: (d["job"], d["ident"]))
        queries = []
        for qt in self.queries():
            queries.append({
                "task_id": qt.task_id,
                "query": qt.query[:500],
                "tenant": qt.tenant,
                "trace_id": qt.trace_id,
                "namespace": qt.namespace,
                "phase": qt.phase,
                "device_tier": qt.device_tier,
                "elapsed_s": round(now - qt.started, 3),
                "cancelled": qt.cancelled,
                "batch": qt.batch,
            })
        queries.sort(key=lambda q: q["task_id"])
        return {"queries": queries, "daemons": daemons}


class Watchdog:
    """Walks the heartbeat table; flags beats quiet past deadline.

    Per-entry deadline: explicit ``deadline_s`` on the heartbeat, else
    ``max(default_deadline_s, 3 * interval_hint)`` so a slow-ticking
    daemon (e.g. a 60s flush loop) isn't flagged by a 30s default."""

    def __init__(self, ledger: TaskLedger, interval_s: float = 1.0,
                 default_deadline_s: float = 30.0,
                 clock: Callable[[], float] = time.monotonic):
        self.ledger = ledger
        self.interval_s = interval_s
        self.default_deadline_s = default_deadline_s
        self._clock = clock
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._stalls = instrument.bounded_counter(
            "m3_watchdog_stalled_total", cap=64)
        self._stalled_gauge = instrument.gauge_fn(
            "m3_watchdog_stalled_jobs", self._count_stalled)
        # Cumulative sweep seconds — same role as the recorder's
        # walk_s_total: the observable CPU this thread charges the
        # process, for the bench overhead accounting.
        self.sweep_s_total = 0.0

    def _count_stalled(self) -> float:
        return float(sum(1 for hb in self.ledger.daemons() if hb.stalled))

    def _deadline_for(self, hb: Heartbeat) -> float:
        if hb.deadline_s is not None:
            return hb.deadline_s
        if hb.interval_hint_s:
            return max(self.default_deadline_s, 3.0 * hb.interval_hint_s)
        return self.default_deadline_s

    def check_once(self, now: Optional[float] = None) -> List[Heartbeat]:
        """One sweep; returns heartbeats that newly transitioned to
        stalled (exposed for fake-clock tests)."""
        if now is None:
            now = self._clock()
        self.ledger._prune_dead()
        newly = []
        frames = sys._current_frames()
        for hb in self.ledger.daemons():
            quiet = now - hb.last_beat
            if quiet <= self._deadline_for(hb):
                continue
            if hb.stalled:
                continue
            hb.stalled = True
            newly.append(hb)
            self._stalls.labels(job=hb.job).inc()
            frame = frames.get(hb.ident)
            stack = ("".join(traceback.format_stack(frame)).rstrip()
                     if frame is not None else "<thread gone>")
            log.warn("watchdog: job stalled", job=hb.job,
                     thread=hb.thread_name, quiet_s=round(quiet, 1),
                     stack=stack)
        return newly

    # -- daemon plumbing -------------------------------------------

    def start(self) -> None:
        if self._thread is not None:
            return
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._loop, name="m3-watchdog", daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=5.0)
        self._thread = None

    def _loop(self) -> None:
        # The watchdog watches the watchers; it registers its own
        # heartbeat so /debug/tasks shows it alive (it is exempt from
        # being flagged only by virtue of beating every tick).
        hb = self.ledger.register_daemon(
            "watchdog", interval_hint_s=self.interval_s)
        try:
            while not self._stop.wait(self.interval_s):
                hb.beat()
                t0 = self._clock()
                try:
                    self.check_once()
                except Exception:
                    log.warn("watchdog sweep failed",
                             exc=traceback.format_exc())
                self.sweep_s_total += self._clock() - t0
        finally:
            hb.close()
