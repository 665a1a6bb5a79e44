"""Per-query cache-hit accounting.

The slow-query log records how much of each query was served from
cache (ref: the reference's per-query index/block cache stats on
query result metadata).  Queries execute synchronously on the calling
thread all the way through the storage fan-in, so a thread-local
scoreboard armed at query start and harvested at cost-record time
attributes every cache touch to the right query without any shared
mutable state.

Caches call :func:`note` unconditionally; it is a no-op unless the
current thread armed a scoreboard with :func:`begin` — background
work (mediator flushes, self-scrape) costs one attribute read.

Scoreboard entries (key = ``<name>_hits`` / ``<name>_misses``):

- ``postings`` / ``decoded_block`` — the read-path caches.
- ``device_bridge`` — whole-query fusion's leaf sourcing: a *hit*
  means the leaf fed the fused pipeline straight from
  DecodedBlockCache-warm arrays (no on-device decode stage compiled
  in); a *miss* means the leaf shipped packed compressed words and
  decoded on device.  Either way the query stays on the fused path —
  this entry tells an operator whether warming the decoded-block
  cache would shrink the fused program.
"""

from __future__ import annotations

import threading

_tls = threading.local()


def begin() -> None:
    """Arm the calling thread's scoreboard (zeroing any prior one)."""
    _tls.counts = {}


def note(cache_name: str, hit: bool, nbytes: int = 0) -> None:
    """Record one lookup against the armed scoreboard, if any.

    ``nbytes`` (optional) additionally accumulates byte-weighted
    entries (``<name>_hit_bytes`` / ``<name>_miss_bytes``) — the
    workload-attribution input: hit bytes are payload served warm,
    miss bytes are payload materialized into the cache on behalf of
    this query (accounted at fill time, when the size is known)."""
    counts = getattr(_tls, "counts", None)
    if counts is None:
        return
    key = cache_name + ("_hits" if hit else "_misses")
    counts[key] = counts.get(key, 0) + 1
    if nbytes:
        bkey = cache_name + ("_hit_bytes" if hit else "_miss_bytes")
        counts[bkey] = counts.get(bkey, 0) + int(nbytes)


def note_fill(cache_name: str, nbytes: int) -> None:
    """Record bytes materialized INTO a cache by the armed query (the
    miss-bytes complement: at miss time the payload size is unknown;
    the fill that follows knows it)."""
    counts = getattr(_tls, "counts", None)
    if counts is None or not nbytes:
        return
    bkey = cache_name + "_miss_bytes"
    counts[bkey] = counts.get(bkey, 0) + int(nbytes)


def snapshot() -> dict[str, int]:
    """The armed scoreboard's counts (empty dict when not armed)."""
    return dict(getattr(_tls, "counts", None) or {})


def end() -> None:
    """Disarm the scoreboard so later non-query work is not counted."""
    _tls.counts = None
