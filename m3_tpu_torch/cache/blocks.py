"""Decoded-block cache with per-namespace series cache policies.

(ref: src/dbnode/storage/block/wired_list.go — one global
capacity-bounded list of wired (decoded, mmap-anchored) blocks;
storage/series/policy.go:37-52 — per-namespace series cache policies
none | all | recently_read | lru governing which reads admit blocks.)

Entries are the batched device-ready decoded form — one
``(times int64[n], values float64[n])`` pair per (series, block) —
keyed by ``(ns, shard, block_start, volume, series_id)``:

- **volume** is the flush version: unseal/merge re-flushes bump it
  (``Shard.unseal``, ``Database._unseal_for_load``), so a superseded
  fileset's entries are unreachable by key the instant the bump
  lands; the database additionally invalidates them eagerly to
  release the byte budget.
- **open-block writes** route the block to an in-memory buffer which
  SHADOWS the fileset on the read path, so a stale decoded entry
  cannot be served; the database still invalidates touched blocks on
  write so the budget never holds dead arrays.

A warm read returns cached arrays straight into the engine's
decoded-parts path — zero M3TSZ decode work.  Cold reads under a
caching policy batch-decode every missed stream of a fileset in one
vectorized pass and admit the results per policy.

Port note: that pass is ``ops/m3tsz_decode.decode_streams_adaptive`` on
the cache's ``device`` (K3 on ``cuda``, its plain version on ``cpu``).
"""

from __future__ import annotations

import threading

import numpy as np

from m3_tpu_torch.cache.lru import LRUCache

POLICIES = ("none", "recently_read", "lru", "all")


class DecodedBlockCache:
    """Byte-budgeted LRU of decoded block arrays, global across the
    namespaces/shards of one database (the WiredList is likewise one
    list per database with namespaces competing for it)."""

    def __init__(self, max_bytes: int = 256 * 1024 * 1024,
                 default_policy: str = "none",
                 policies: dict[str, str] | None = None,
                 recently_read_ttl_nanos: int = 10 * 60 * 10**9,
                 device=None):
        for p in [default_policy, *(policies or {}).values()]:
            if p not in POLICIES:
                raise ValueError(
                    f"unknown series cache policy {p!r} "
                    f"(choose from {POLICIES})")
        self._default_policy = default_policy
        self._policies = dict(policies or {})
        self._rr_ttl = int(recently_read_ttl_nanos)
        # where missed streams decode (None = the decoder's default, cuda)
        self.device = device
        # (ns, shard, block_start) -> set of full cache keys, so
        # write/flush invalidation is O(touched blocks) instead of a
        # full-cache scan; maintained by the eviction hook
        self._by_block: dict[tuple, set] = {}
        self._block_lock = threading.Lock()
        self._lru = LRUCache("decoded_blocks", max_bytes=max_bytes,
                             on_evict=self._forget)

    # --- policy ---

    def policy_for(self, ns: str) -> str:
        return self._policies.get(ns, self._default_policy)

    # --- bookkeeping ---

    def _forget(self, key, _value) -> None:
        # runs under the LRU lock; never call back into the LRU here
        with self._block_lock:
            keys = self._by_block.get(key[:3])
            if keys is not None:
                keys.discard(key)
                if not keys:
                    del self._by_block[key[:3]]

    def __len__(self) -> int:
        return len(self._lru)

    @property
    def bytes(self) -> int:
        return self._lru.bytes

    @property
    def hits(self) -> int:
        return self._lru.hits

    @property
    def misses(self) -> int:
        return self._lru.misses

    # --- read path ---

    def get_or_decode(self, ns: str, shard_id: int, bs: int, vol: int,
                      policy: str, sids, blobs, counts):
        """Serve one fileset's bulk read through the cache.

        ``blobs[i]`` is the compressed stream for ``sids[i]`` (falsy =
        series absent from this fileset); ``counts[i]`` the stored dp
        count or None.  Returns ``decoded`` aligned with ``sids``:
        ``(times, values)`` arrays for present series, None for absent
        ones.  Missed streams are decoded in ONE batched pass and
        admitted per ``policy``.
        """
        block = (ns, shard_id, bs)
        decoded: list = [None] * len(sids)
        miss_idx: list[int] = []
        for i, (sid, blob) in enumerate(zip(sids, blobs)):
            if not blob:
                continue
            hit = self._lru.get((*block, vol, sid))
            if hit is not None:
                decoded[i] = hit
            else:
                miss_idx.append(i)
        if not miss_idx:
            return decoded
        from m3_tpu_torch.ops.m3tsz_decode import decode_streams_adaptive

        streams = [blobs[i] for i in miss_idx]
        known = [counts[i] for i in miss_idx]
        ts, vs, valid = decode_streams_adaptive(
            streams,
            counts=(None if any(c is None for c in known)
                    else np.asarray(known, dtype=np.int64)),
            device=self.device)
        pinned = policy == "all"
        ttl = self._rr_ttl if policy == "recently_read" else None
        for row, i in enumerate(miss_idx):
            sel = np.asarray(valid[row])
            t = np.ascontiguousarray(np.asarray(ts[row])[sel])
            v = np.ascontiguousarray(np.asarray(vs[row])[sel])
            decoded[i] = (t, v)
            key = (*block, vol, sids[i])
            with self._block_lock:
                self._by_block.setdefault(block, set()).add(key)
            self._lru.put(key, (t, v), nbytes=t.nbytes + v.nbytes,
                          pinned=pinned, ttl_nanos=ttl)
        return decoded

    # --- invalidation ---

    def invalidate_block(self, ns: str, shard_id: int, bs: int) -> int:
        """Drop every entry (all volumes, all series) for one block —
        called on open-block writes and flush-version bumps.  Key-based
        volume versioning already guarantees correctness; the eager
        drop releases the byte budget and makes staleness provable."""
        with self._block_lock:
            keys = list(self._by_block.get((ns, shard_id, bs), ()))
        n = 0
        for key in keys:
            n += bool(self._lru.invalidate(key))
        return n

    def clear(self) -> int:
        return self._lru.clear()
