"""Time units and block-time math.

Ref: src/x/time/unit.go:30-42 (unit enum wire values), src/dbnode/retention
(block sizing).  Unit wire values must match the reference exactly because
they are written as raw bytes into M3TSZ streams on a time-unit-change
marker (ref: src/dbnode/encoding/m3tsz/timestamp_encoder.go:117).
"""

from __future__ import annotations

import enum


class Unit(enum.IntEnum):
    """Time unit wire enum (ref: src/x/time/unit.go:33-41)."""

    NONE = 0
    SECOND = 1
    MILLISECOND = 2
    MICROSECOND = 3
    NANOSECOND = 4
    MINUTE = 5
    HOUR = 6
    DAY = 7
    YEAR = 8

    @property
    def nanos(self) -> int:
        return _UNIT_NANOS[self]

    def is_valid(self) -> bool:
        return self in _UNIT_NANOS


_UNIT_NANOS = {
    Unit.SECOND: 1_000_000_000,
    Unit.MILLISECOND: 1_000_000,
    Unit.MICROSECOND: 1_000,
    Unit.NANOSECOND: 1,
    Unit.MINUTE: 60 * 1_000_000_000,
    Unit.HOUR: 3600 * 1_000_000_000,
    Unit.DAY: 24 * 3600 * 1_000_000_000,
    Unit.YEAR: 365 * 24 * 3600 * 1_000_000_000,
}

SECOND = 1_000_000_000
MINUTE = 60 * SECOND
HOUR = 3600 * SECOND


def initial_time_unit(start_nanos: int, default_unit: Unit) -> Unit:
    """Unit used for the head of a stream (ref: m3tsz/timestamp_encoder.go:215-226).

    The default unit only applies if the stream start is an exact multiple
    of it; otherwise the stream starts with no unit and the encoder emits a
    time-unit-change marker before the first delta.
    """
    if not default_unit.is_valid():
        return Unit.NONE
    if start_nanos % default_unit.nanos == 0:
        return default_unit
    return Unit.NONE


def block_start(ts_nanos: int, block_size_nanos: int) -> int:
    """Truncate a timestamp to its containing block start."""
    return ts_nanos - (ts_nanos % block_size_nanos)


# -- monotonic wall stamps ----------------------------------------------------

_stamp_lock = __import__("threading").Lock()
_stamp_last = 0


def stamp_ns() -> int:
    """Process-wide monotonic wall-clock stamp: never decreases even if
    the wall clock steps backward (NTP).  Durability ordering (commit
    log chunk stamps vs block seal times) must compare stamps from ONE
    authority — two raw time.time_ns() calls are not ordered under
    clock steps."""
    import time
    global _stamp_last
    with _stamp_lock:
        _stamp_last = max(_stamp_last + 1, time.time_ns())
        return _stamp_last
