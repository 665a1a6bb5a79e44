"""Read-path caching subsystem.

One home for every cache the hot read path leans on, mirroring the
reference's trio (src/dbnode/storage/index/postings_list_cache.go,
storage/block/wired_list.go + series cache policies,
persist/fs/seek_manager.go):

- :class:`PostingsListCache` — frozen-segment postings results,
  invalidated by index generation bump on seal/compaction.
- :class:`DecodedBlockCache` — byte-budgeted decoded block arrays
  under per-namespace series cache policies (none / recently_read /
  lru / all), invalidated on flush-version bump and open-block
  writes.
- :class:`SeekManager` — bounded, TTL'd pool of open fileset readers.
- :class:`LRUCache` / :class:`SmallOrderedLRU` — the primitives the
  above (and satellite call sites: downsample series memo, struct
  codec dictionary) are built from.

Everything reports through the ``m3_cache_*`` metric family
(hits/misses/evictions/invalidations counters; entries/bytes
occupancy via callback gauges) and per-query hit counts via
:mod:`m3_tpu_torch.cache.stats` into the slow-query log.

Import stays light (stdlib + numpy + instrument): storage modules
import this at module load; the batched decoder is imported lazily
inside the decoded-block fill path.
"""

from __future__ import annotations

import dataclasses

from m3_tpu_torch.cache.blocks import DecodedBlockCache
from m3_tpu_torch.cache.lru import LRUCache, SmallOrderedLRU
from m3_tpu_torch.cache.postings import PostingsListCache
from m3_tpu_torch.cache.seek import SeekManager


@dataclasses.dataclass(frozen=True)
class CacheOptions:
    """Resolved cache settings handed to storage (the config-file
    shape lives in services/config.py as ``CacheConfig``; this one is
    import-light so ``storage/`` never depends on the config stack).
    """

    # postings-list cache: entries per namespace index
    postings_capacity: int = 1024
    # decoded-block cache: one byte budget per database
    decoded_max_bytes: int = 256 * 1024 * 1024
    # default series cache policy + per-namespace overrides
    decoded_policy: str = "none"
    decoded_policies: dict = dataclasses.field(default_factory=dict)
    # recently_read: entries expire unread after this window
    recently_read_ttl: int = 10 * 60 * 10**9
    # seek manager (fileset reader pool)
    seek_policy: str = "lru"
    seek_capacity: int = 128
    seek_ttl: int = 0  # 0 = readers never expire by idleness

__all__ = [
    "CacheOptions",
    "DecodedBlockCache",
    "LRUCache",
    "PostingsListCache",
    "SeekManager",
    "SmallOrderedLRU",
]
