"""Space-saving heavy-hitter sketch (Metwally et al., "Efficient
Computation of Frequent and Top-k Elements in Data Streams").

The attribution layer needs top-k views over unbounded key domains —
query fingerprints, tenant ids, label names — without unbounded
memory.  A :class:`SpaceSaving` sketch of capacity ``m`` keeps exactly
``m`` (key, count, error) entries and guarantees, for a stream of
total weight ``N``:

- every key with true count > ``N / m`` is present in the sketch
  (no false negatives among heavy hitters), and
- for any tracked key, ``count - error <= true <= count``, with
  ``error <= N / m`` — i.e. the estimate only ever OVER-counts, by at
  most ``N / m``.

Merging dumps from ``k`` nodes sums counts and errors per key and
keeps the top ``m``; the merged bound degrades to ``sum_i N_i / m``
(a key evicted on some node under-reports by at most that node's
``N_i / m``, which the summed error term absorbs).  That is the bound
/debug/heavyhitters documents and tests/test_attribution.py checks.

Offers are per-request / per-query (never per-sample), so the O(m)
min-scan on eviction is off any per-sample path.
"""

from __future__ import annotations

import threading


class SpaceSaving:
    """Bounded top-k counter: at most ``capacity`` tracked keys."""

    __slots__ = ("capacity", "_counts", "_errors", "_total", "_lock")

    def __init__(self, capacity: int = 64):
        if capacity < 1:
            raise ValueError("capacity must be >= 1")
        self.capacity = int(capacity)
        self._counts: dict[str, float] = {}
        self._errors: dict[str, float] = {}
        self._total = 0.0
        self._lock = threading.Lock()

    def offer(self, key: str, count: float = 1.0) -> None:
        """Add ``count`` weight to ``key`` (evicting the current
        minimum when the sketch is full and ``key`` is untracked)."""
        if count <= 0:
            return
        with self._lock:
            self._total += count
            counts = self._counts
            if key in counts:
                counts[key] += count
                return
            if len(counts) < self.capacity:
                counts[key] = count
                self._errors[key] = 0.0
                return
            # evict the minimum; the newcomer inherits its count as
            # error (the classic space-saving replacement rule)
            victim = min(counts, key=counts.__getitem__)
            floor = counts.pop(victim)
            self._errors.pop(victim, None)
            counts[key] = floor + count
            self._errors[key] = floor

    @property
    def total(self) -> float:
        return self._total

    def top(self, k: int | None = None) -> list[dict]:
        """Entries sorted by estimated count descending."""
        with self._lock:
            items = sorted(self._counts.items(), key=lambda kv: -kv[1])
            if k is not None:
                items = items[:k]
            return [{"key": key, "count": cnt,
                     "error": self._errors.get(key, 0.0)}
                    for key, cnt in items]

    def dump(self) -> dict:
        """Mergeable snapshot: ``{"total": N, "entries": [...]}``."""
        with self._lock:
            return {
                "total": self._total,
                "capacity": self.capacity,
                "entries": [
                    {"key": key, "count": cnt,
                     "error": self._errors.get(key, 0.0)}
                    for key, cnt in self._counts.items()],
            }

    def reset(self) -> None:
        with self._lock:
            self._counts.clear()
            self._errors.clear()
            self._total = 0.0


def merge_dumps(dumps: list[dict], capacity: int | None = None) -> dict:
    """Merge per-node :meth:`SpaceSaving.dump` snapshots.

    Counts and errors sum per key; the result keeps the top
    ``capacity`` entries (default: max of the input capacities).  The
    merged estimate for any key deviates from the exact global count
    by at most ``sum_i N_i / m`` (see module docstring).
    """
    counts: dict[str, float] = {}
    errors: dict[str, float] = {}
    total = 0.0
    cap = capacity or 0
    for d in dumps:
        if not d:
            continue
        total += float(d.get("total", 0.0))
        cap = max(cap, int(d.get("capacity", 0)))
        for e in d.get("entries", ()):
            key = str(e.get("key"))
            counts[key] = counts.get(key, 0.0) + float(e.get("count", 0.0))
            errors[key] = errors.get(key, 0.0) + float(e.get("error", 0.0))
    cap = cap or 64
    top = sorted(counts.items(), key=lambda kv: -kv[1])[:cap]
    return {
        "total": total,
        "capacity": cap,
        "entries": [{"key": key, "count": cnt, "error": errors[key]}
                    for key, cnt in top],
    }
