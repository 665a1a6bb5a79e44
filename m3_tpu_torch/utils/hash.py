"""Murmur3-32 — shard routing hash, exact-compatible with the reference.

The reference routes series to virtual shards with murmur3 32-bit mod
2^N (ref: src/dbnode/sharding/shardset.go:149 DefaultHashFn); matching
it exactly means a migrated cluster keeps its placement.  Scalar path
for single IDs plus a vectorized numpy path for batch routing.
"""

from __future__ import annotations

import numpy as np

_C1 = 0xCC9E2D51
_C2 = 0x1B873593
_M32 = 0xFFFFFFFF


def _rotl32(x: int, r: int) -> int:
    return ((x << r) | (x >> (32 - r))) & _M32


def murmur3_32(data: bytes, seed: int = 0) -> int:
    """Scalar murmur3 x86 32-bit."""
    h = seed & _M32
    n = len(data)
    nblocks = n // 4
    for i in range(nblocks):
        k = int.from_bytes(data[i * 4 : i * 4 + 4], "little")
        k = (k * _C1) & _M32
        k = _rotl32(k, 15)
        k = (k * _C2) & _M32
        h ^= k
        h = _rotl32(h, 13)
        h = (h * 5 + 0xE6546B64) & _M32
    k = 0
    tail = data[nblocks * 4 :]
    if len(tail) >= 3:
        k ^= tail[2] << 16
    if len(tail) >= 2:
        k ^= tail[1] << 8
    if len(tail) >= 1:
        k ^= tail[0]
        k = (k * _C1) & _M32
        k = _rotl32(k, 15)
        k = (k * _C2) & _M32
        h ^= k
    h ^= n
    h ^= h >> 16
    h = (h * 0x85EBCA6B) & _M32
    h ^= h >> 13
    h = (h * 0xC2B2AE35) & _M32
    h ^= h >> 16
    return h


def shard_for(series_id: bytes, num_shards: int, seed: int = 0) -> int:
    """Ref: sharding/shardset.go:149 — murmur3_32(id) % num_shards."""
    return murmur3_32(series_id, seed) % num_shards


def bloom_hashes(series_id: bytes, k: int, m: int) -> list[int]:
    """k bloom-filter bit positions via double hashing."""
    h1 = murmur3_32(series_id, 0)
    h2 = murmur3_32(series_id, h1) | 1
    return [((h1 + i * h2) & 0xFFFFFFFFFFFF) % m for i in range(k)]


class BloomFilter:
    """Simple bitset bloom filter for fileset id membership
    (ref: src/dbnode/persist/fs bloomfilter file; x/bloom)."""

    def __init__(self, n_expected: int, bits_per_entry: int = 10, k: int = 7):
        self.m = max(64, n_expected * bits_per_entry)
        self.k = k
        self.bits = np.zeros((self.m + 63) // 64, dtype=np.uint64)

    def add(self, series_id: bytes) -> None:
        for pos in bloom_hashes(series_id, self.k, self.m):
            self.bits[pos >> 6] |= np.uint64(1 << (pos & 63))

    def may_contain(self, series_id: bytes) -> bool:
        return all(
            self.bits[pos >> 6] & np.uint64(1 << (pos & 63))
            for pos in bloom_hashes(series_id, self.k, self.m)
        )

    def to_bytes(self) -> bytes:
        return self.bits.tobytes()

    @classmethod
    def from_bytes(cls, data: bytes, m: int, k: int) -> "BloomFilter":
        bf = cls.__new__(cls)
        bf.m = m
        bf.k = k
        bf.bits = np.frombuffer(data, dtype=np.uint64).copy()
        return bf
