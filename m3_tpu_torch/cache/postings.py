"""Postings-list cache for the inverted index's frozen segments.

(ref: src/dbnode/storage/index/postings_list_cache.go — an LRU in
front of segment postings keyed by (segment UUID, field, pattern,
query kind); here the segment axis is the index GENERATION, which
bumps on every postings seal/compaction, so results computed over a
superseded frozen-segment set can never be served stale.)

Only frozen-segment unions are cached — the mutable tail is merged
fresh on every query by the index itself (the reference caches
per-immutable-segment postings for the same reason: mutable segments
change under the cache's feet).
"""

from __future__ import annotations

import numpy as np

from m3_tpu_torch.cache.lru import LRUCache


class PostingsListCache:
    """LRU of frozen-postings query results.

    Keys are ``(kind, field, pattern..., generation)`` tuples built by
    the index (kind in {"term", "re", "field", "absent"}); values are
    the sorted ordinal arrays its queries union with the mutable
    tail.  Byte accounting uses the arrays' nbytes so the occupancy
    gauge reflects real heap held by cached postings.
    """

    def __init__(self, capacity: int = 1024):
        self._lru = LRUCache("postings", capacity=capacity)

    def __len__(self) -> int:
        return len(self._lru)

    @property
    def hits(self) -> int:
        return self._lru.hits

    @property
    def misses(self) -> int:
        return self._lru.misses

    def get_or_compute(self, key: tuple, compute) -> np.ndarray:
        return self._lru.get_or_compute(key, compute)

    def clear(self) -> int:
        """Generation bump (seal/compaction): every cached result was
        computed over a now-superseded frozen-segment set."""
        return self._lru.clear()
