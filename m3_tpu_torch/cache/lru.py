"""LRU primitives shared by every read-path cache.

Two shapes live here:

- :class:`LRUCache` — the subsystem workhorse: thread-safe, bounded by
  entry count and/or a byte budget, optional per-entry TTL and
  pinning, instrumented with the ``m3_cache_*`` metric family
  (ref: the reference's postings-list cache + WiredList both reduce
  to "bounded LRU with metrics", src/dbnode/storage/index/
  postings_list_cache.go, storage/block/wired_list.go).

- :class:`SmallOrderedLRU` — an order-indexable LRU over small
  capacities for the struct codec's dictionary compression, whose
  wire format encodes an entry's POSITION counting from the oldest
  entry.  Membership is one hash lookup instead of the O(n) byte-wise
  ``list.index``/``remove`` scans it replaces.

Metrics: hit/miss/eviction/invalidation counters are shared per cache
NAME (several Database instances may coexist in one process — tests,
embedded coordinator + dbnode); occupancy gauges aggregate over every
live instance of a name via a weak registry, so the gauge survives
instance churn without unbounded per-instance series.
"""

from __future__ import annotations

import threading
import time
import weakref
from collections import OrderedDict

from m3_tpu_torch.cache import stats
from m3_tpu_torch.utils import instrument

# live instances per cache name, feeding the aggregate occupancy
# gauges; gauge_fn rebinding on re-register makes double registration
# harmless, the guard just avoids the churn
_instances: dict[str, "weakref.WeakSet[LRUCache]"] = {}
_instances_lock = threading.Lock()


def _register_instance(cache: "LRUCache") -> None:
    name = cache.name
    with _instances_lock:
        known = name in _instances
        _instances.setdefault(name, weakref.WeakSet()).add(cache)
    if not known:
        instrument.gauge_fn(
            "m3_cache_entries",
            lambda n=name: sum(len(c) for c in _instances.get(n, ())),
            cache=name)
        instrument.gauge_fn(
            "m3_cache_bytes",
            lambda n=name: sum(c.bytes for c in _instances.get(n, ())),
            cache=name)


class LRUCache:
    """Thread-safe LRU bounded by entries and/or bytes.

    ``capacity`` / ``max_bytes`` of 0 mean "unbounded on that axis"
    (a cache must bound at least one axis unless every entry is
    pinned by policy).  ``ttl_nanos`` > 0 expires entries that have
    not been READ within the window (sampled lazily on access and
    during eviction).  ``pinned`` entries are exempt from budget
    eviction — only explicit invalidation removes them (the "all"
    series cache policy).  ``on_evict(key, value)`` fires under the
    cache lock for every removal (eviction, expiry, invalidation),
    letting owners maintain secondary indexes.
    """

    def __init__(self, name: str, capacity: int = 0, max_bytes: int = 0,
                 ttl_nanos: int = 0, on_evict=None):
        self.name = name
        self.capacity = int(capacity)
        self.max_bytes = int(max_bytes)
        self.ttl_nanos = int(ttl_nanos)
        self._on_evict = on_evict
        self._lock = threading.RLock()
        # key -> [value, nbytes, pinned, expires_at_monotonic_nanos]
        self._od: "OrderedDict[object, list]" = OrderedDict()
        self._bytes = 0
        # instance-level tallies for bench/tests; the process-wide
        # m3_cache_* counters aggregate across same-named instances
        self.hits = 0
        self.misses = 0
        self._m_hits = instrument.counter("m3_cache_hits_total",
                                          cache=name)
        self._m_misses = instrument.counter("m3_cache_misses_total",
                                            cache=name)
        self._m_evict = instrument.counter("m3_cache_evictions_total",
                                           cache=name)
        self._m_inval = instrument.counter(
            "m3_cache_invalidations_total", cache=name)
        _register_instance(self)

    def __len__(self) -> int:
        return len(self._od)

    @property
    def bytes(self) -> int:
        return self._bytes

    def _expires_at(self, ttl_nanos: int | None) -> int:
        ttl = self.ttl_nanos if ttl_nanos is None else ttl_nanos
        return time.monotonic_ns() + ttl if ttl > 0 else 0

    def _drop(self, key, counter) -> None:
        value, nbytes, _pinned, _exp = self._od.pop(key)
        self._bytes -= nbytes
        counter.inc()
        if self._on_evict is not None:
            self._on_evict(key, value)

    def get(self, key, default=None):
        """Value for ``key`` (marking it most-recently-used), or
        ``default`` on miss/expiry."""
        with self._lock:
            entry = self._od.get(key)
            if entry is not None and entry[3] and \
                    time.monotonic_ns() >= entry[3]:
                self._drop(key, self._m_evict)
                entry = None
            if entry is None:
                self.misses += 1
                self._m_misses.inc()
                stats.note(self.name, hit=False)
                return default
            self._od.move_to_end(key)
            if entry[3]:
                entry[3] = self._expires_at(None)
            self.hits += 1
            self._m_hits.inc()
            stats.note(self.name, hit=True, nbytes=entry[1])
            return entry[0]

    def put(self, key, value, nbytes: int = 0, pinned: bool = False,
            ttl_nanos: int | None = None) -> None:
        """Insert/replace ``key`` as most-recently-used, then evict
        oldest unpinned entries until budgets hold."""
        with self._lock:
            old = self._od.pop(key, None)
            if old is not None:
                self._bytes -= old[1]
            self._od[key] = [value, int(nbytes), bool(pinned),
                             self._expires_at(ttl_nanos)]
            self._bytes += int(nbytes)
            self._evict_over_budget()
        # bytes this query materialized into the cache = its miss cost
        # (no-op unless a query scoreboard is armed on this thread)
        stats.note_fill(self.name, nbytes)

    # dict-flavored aliases so an LRUCache is a drop-in for the plain
    # dict memos it replaces (downsample series memo)
    __setitem__ = put

    def __contains__(self, key) -> bool:
        with self._lock:
            return key in self._od

    def _evict_over_budget(self) -> None:
        over = (lambda: (self.capacity and len(self._od) > self.capacity)
                or (self.max_bytes and self._bytes > self.max_bytes))
        if not over():
            return
        now = time.monotonic_ns()
        # expired entries go first regardless of recency
        for key in [k for k, e in self._od.items()
                    if e[3] and now >= e[3]]:
            self._drop(key, self._m_evict)
        # then oldest-first, skipping pinned; if only pinned entries
        # remain over budget, stop — "all" policy means never evict
        for key in list(self._od):
            if not over():
                return
            if not self._od[key][2]:
                self._drop(key, self._m_evict)

    def get_or_compute(self, key, compute):
        """Read-through helper: miss runs ``compute()`` outside any
        recency bookkeeping and inserts the result (nbytes from the
        result's ``nbytes`` attribute when present)."""
        hit = self.get(key, _SENTINEL)
        if hit is not _SENTINEL:
            return hit
        out = compute()
        self.put(key, out, nbytes=int(getattr(out, "nbytes", 0)))
        return out

    def invalidate(self, key) -> bool:
        with self._lock:
            if key in self._od:
                self._drop(key, self._m_inval)
                return True
            return False

    def invalidate_where(self, pred) -> int:
        """Drop every entry whose key satisfies ``pred`` (O(n) scan —
        owners with hot invalidation paths keep their own key index
        and call :meth:`invalidate` per key)."""
        with self._lock:
            doomed = [k for k in self._od if pred(k)]
            for k in doomed:
                self._drop(k, self._m_inval)
            return len(doomed)

    def clear(self) -> int:
        with self._lock:
            n = len(self._od)
            if n:
                self._m_inval.inc(n)
                if self._on_evict is not None:
                    for k, e in list(self._od.items()):
                        self._on_evict(k, e[0])
            self._od.clear()
            self._bytes = 0
            return n

    def values(self):
        with self._lock:
            return [e[0] for e in self._od.values()]


_SENTINEL = object()


class SmallOrderedLRU:
    """Order-indexable bounded LRU: positions count from the OLDEST
    entry (position 0) to the newest.  This is exactly the structure
    the struct codec's LRU dictionary compression serializes — a hit
    encodes the entry's current position, then promotes it to newest;
    a miss appends as newest and evicts position 0 when full — so the
    emitted control bytes are byte-identical to the historical
    ``list``-backed implementation.

    The position map turns the per-element O(n) byte-string
    ``in``/``index``/``remove`` scans into one hash lookup; the O(n)
    position renumber on promotion/eviction is integer bookkeeping
    over at most ``capacity`` (< 255, the codec's control-byte range)
    entries.
    """

    __slots__ = ("capacity", "_order", "_pos")

    def __init__(self, capacity: int):
        self.capacity = int(capacity)
        self._order: list = []  # oldest .. newest
        self._pos: dict = {}    # value -> position in _order

    def __len__(self) -> int:
        return len(self._order)

    def index(self, value) -> int | None:
        """Current position of ``value`` (0 = oldest), or None."""
        return self._pos.get(value)

    def at(self, position: int):
        return self._order[position]

    def promote(self, position: int):
        """Move the entry at ``position`` to newest; returns it."""
        order, pos = self._order, self._pos
        value = order.pop(position)
        for v in order[position:]:
            pos[v] -= 1
        order.append(value)
        pos[value] = len(order) - 1
        return value

    def push(self, value) -> None:
        """Append ``value`` as newest; evict the oldest when full.
        Caller guarantees ``value`` is absent (checked via index())."""
        order, pos = self._order, self._pos
        order.append(value)
        pos[value] = len(order) - 1
        if len(order) > self.capacity:
            del pos[order[0]]
            del order[0]
            for v in order:
                pos[v] -= 1
