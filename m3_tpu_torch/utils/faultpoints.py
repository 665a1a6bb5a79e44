"""Deterministic fault-injection seam for crash-consistency sweeps.

The reference proves its flush/snapshot/WAL interleavings with TLA+
specs — `DoesNotLoseData` (specs/dbnode/flush/FlushVersion.tla:247) and
`AllAckedWritesAreBootstrappable`
(specs/dbnode/snapshots/SnapshotsSpec.tla:219).  Here the same
invariants are enforced empirically: storage code calls
``faultpoints.check("<boundary>")`` at every state-machine boundary of
seal -> flush -> checkpoint -> snapshot -> WAL-truncate, and the
kill-point sweep (tests/test_killpoints.py) crashes at EACH boundary in
turn, then proves recovery loses no acknowledged write and loads no
torn state.

Production cost: one early-return function call per boundary — the
module is a no-op unless a test arms it.  (Same role as Go failpoints /
the reference's dtest fault schedule.)
"""

from __future__ import annotations

import os
import time


class SimulatedCrash(Exception):
    """Raised at the armed kill point; tests treat it as process death
    (the Database object is abandoned, never closed)."""


# REAL-process kill point for dtests: when the environment names a
# boundary, the first ``check()`` hit of that name hard-exits the
# process (os._exit — no teardown, no atexit, exactly a crash).  The
# in-process sweeps cover every seam deterministically; this hook lets
# multi-process suites crash a real dbnode at a named seam (e.g.
# mid-drain during a rolling restart).  Read once at import: services
# inherit it from the harness's spawn env.
_exit_at = os.environ.get("M3_TPU_EXIT_AT_POINT", "")


_armed = False
_crash_at = -1  # 1-based hit index that raises; <=0 counts only
_count = 0
_trace: list[str] = []
# name -> seconds: check(name) sleeps before returning (degraded-mode
# tests inject a slow replica without touching the transport)
_delays: dict[str, float] = {}


def check(name: str) -> None:
    """Mark a crash boundary.  No-op unless a test armed the module."""
    global _count
    if _exit_at and name == _exit_at:
        os._exit(137)  # real-process crash: no flush, no teardown
    if _delays:
        d = _delays.get(name)
        if d:
            time.sleep(d)
    if not _armed:
        return
    _trace.append(name)
    _count += 1
    if _count == _crash_at:
        raise SimulatedCrash(name)


def arm(crash_at: int) -> None:
    """Arm: the ``crash_at``-th boundary hit raises SimulatedCrash.
    ``crash_at <= 0`` only records the trace (used to discover the
    sweep's size)."""
    global _armed, _crash_at, _count
    _armed, _crash_at, _count = True, crash_at, 0
    _trace.clear()


def disarm() -> list[str]:
    """Disarm and return the boundary names hit while armed."""
    global _armed
    _armed = False
    return list(_trace)


def arm_delay(name: str, seconds: float) -> None:
    """Every ``check(name)`` hit sleeps ``seconds`` until cleared —
    the degraded-serving tests' slow-replica injection."""
    _delays[name] = seconds


def clear_delays() -> None:
    _delays.clear()
