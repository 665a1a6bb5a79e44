"""Seek manager: bounded, TTL'd pool of open fileset readers.

(ref: src/dbnode/persist/fs/seek_manager.go — the seeker manager
owns every open fileset seeker, bounds them, and recycles idle ones;
it replaced ad-hoc per-call opens exactly as this replaces the
ad-hoc OrderedDict reader cache that used to live inline in
``storage/database.py``.)

A reader entry is (ns, shard, block_start, volume) -> FilesetReader;
the volume rides in the key so a superseded fileset's reader can
never be served after an unseal-merge re-flush bumps the version.
Policies (``CacheOptions.seek_policy``):
``lru`` (bounded), ``all`` (never evict), ``none`` (open per read).
"""

from __future__ import annotations

from m3_tpu_torch.cache.lru import LRUCache

POLICIES = ("none", "lru", "all")


class SeekManager:
    def __init__(self, policy: str = "lru", capacity: int = 128,
                 ttl_nanos: int = 0):
        if policy not in POLICIES:
            raise ValueError(f"unknown seek cache policy {policy!r} "
                             f"(choose from {POLICIES})")
        self.policy = policy
        self._lru = LRUCache(
            "seek",
            capacity=(capacity if policy == "lru" else 0),
            ttl_nanos=ttl_nanos)

    def __len__(self) -> int:
        return len(self._lru)

    @property
    def hits(self) -> int:
        return self._lru.hits

    @property
    def misses(self) -> int:
        return self._lru.misses

    def acquire(self, key: tuple, opener):
        """Pooled reader for ``key``, opening via ``opener()`` on
        miss.  ``none`` policy opens fresh per call (and still counts
        the miss, so hit-ratio dashboards expose the policy cost)."""
        if self.policy == "none":
            self._lru.misses += 1
            self._lru._m_misses.inc()
            return opener()
        reader = self._lru.get(key)
        if reader is None:
            reader = opener()
            self._lru.put(key, reader,
                          pinned=(self.policy == "all"))
        return reader

    def invalidate_where(self, pred) -> int:
        return self._lru.invalidate_where(pred)

    def clear(self) -> int:
        return self._lru.clear()
