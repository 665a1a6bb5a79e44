"""Storage policies and aggregation-type sets.

(ref: src/metrics/policy/storage_policy.go — ``resolution:retention``
string form like ``10s:2d`` or ``1m:40d``; policy/resolution.go;
aggregation/type.go AggregationID is a fixed-size bitset over the
aggregation-type enum.)

``AggregationType`` itself lives with the kernels
(m3_tpu_torch/ops/downsample.py) — the wire enum and the reductions are one
thing on TPU.
"""

from __future__ import annotations

import re
from dataclasses import dataclass

from m3_tpu_torch.ops.downsample import AggregationType
from m3_tpu_torch.utils import xtime

_DUR_RE = re.compile(r"^(\d+)(ns|us|ms|s|m|h|d)$")
_UNITS = {"ns": 1, "us": 10**3, "ms": 10**6, "s": xtime.SECOND,
          "m": 60 * xtime.SECOND, "h": 3600 * xtime.SECOND,
          "d": 86400 * xtime.SECOND}


def parse_duration(s: str) -> int:
    m = _DUR_RE.match(s)
    if not m:
        raise ValueError(f"bad duration {s!r}")
    return int(m.group(1)) * _UNITS[m.group(2)]


def format_duration(nanos: int) -> str:
    for unit in ("d", "h", "m", "s", "ms", "us", "ns"):
        size = _UNITS[unit]
        if nanos >= size and nanos % size == 0:
            return f"{nanos // size}{unit}"
    return f"{nanos}ns"


@dataclass(frozen=True, order=True)
class Resolution:
    window_nanos: int

    def __str__(self):
        return format_duration(self.window_nanos)


@dataclass(frozen=True, order=True)
class Retention:
    period_nanos: int

    def __str__(self):
        return format_duration(self.period_nanos)


@dataclass(frozen=True, order=True)
class StoragePolicy:
    """``10s:2d`` == keep 10s-resolution aggregates for 2 days."""

    resolution: Resolution
    retention: Retention

    @staticmethod
    def parse(s: str) -> "StoragePolicy":
        res, _, ret = s.partition(":")
        if not ret:
            raise ValueError(f"bad storage policy {s!r}")
        return StoragePolicy(Resolution(parse_duration(res)),
                             Retention(parse_duration(ret)))

    def __str__(self):
        return f"{self.resolution}:{self.retention}"


class AggregationID:
    """Immutable set of aggregation types, bitset-encoded
    (ref: src/metrics/aggregation/id.go)."""

    def __init__(self, types=()):
        self._bits = 0
        for t in types:
            self._bits |= 1 << int(t)

    @staticmethod
    def default() -> "AggregationID":
        return AggregationID()

    @property
    def is_default(self) -> bool:
        return self._bits == 0

    def types(self) -> list[AggregationType]:
        return [t for t in AggregationType if self._bits & (1 << int(t))]

    def contains(self, t: AggregationType) -> bool:
        return bool(self._bits & (1 << int(t)))

    def merge(self, other: "AggregationID") -> "AggregationID":
        out = AggregationID()
        out._bits = self._bits | other._bits
        return out

    def __eq__(self, other):
        return isinstance(other, AggregationID) and self._bits == other._bits

    def __hash__(self):
        return hash(self._bits)

    def __repr__(self):
        if self.is_default:
            return "AggregationID(default)"
        return f"AggregationID({[t.name for t in self.types()]})"
