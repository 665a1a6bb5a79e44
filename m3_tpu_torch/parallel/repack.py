"""The shard-even layout of a packed query batch (host only).

Port of ``m3_tpu/query/engine.py:1052 Engine._shard_repack`` (with
``_bucket:935``), which the engine runs before a series-sharded query.  The
engine itself is not ported yet; the tests and ``chip_smoke.py`` use this to
feed the JAX and the port's sharded pipelines the same inputs.
"""

from __future__ import annotations

import numpy as np


def bucket(n: int, q: int) -> int:
    """Round up to a multiple of q (at least q)."""
    return max(q, ((n + q - 1) // q) * q)


def shard_repack(pk: dict, n_shards: int) -> dict:
    """Re-lay a packed batch for the sharded pipelines: equal lanes and equal
    stream rows per shard.  ``pk`` holds ``words``, ``nbits``, ``slots``,
    ``tiers`` (or None), ``n_streams`` (the real rows, slot-grouped
    ascending) and ``lanes_pad``.  Lanes partition into contiguous ranges
    (shard = lane // local_lanes, local_lanes a multiple of 8), so each
    shard's stream rows are a contiguous range of the packed array.  Padding
    rows (nbits 0, decode to no sample) park on each shard's last local lane;
    ``real_rows`` marks the original streams for the error-flag check.
    Slots come back LOCAL to their shard."""
    m = pk["n_streams"]
    words, nbits = pk["words"][:m], pk["nbits"][:m]
    slots = pk["slots"][:m]
    tiers = None if pk["tiers"] is None else pk["tiers"][:m]
    local_lanes = bucket(-(-pk["lanes_pad"] // n_shards), 8)
    lanes_pad = local_lanes * n_shards
    shard_ids = slots // local_lanes
    counts = np.bincount(shard_ids, minlength=n_shards)
    per_m = bucket(max(int(counts.max()), 1), 8)
    words_s = np.zeros((n_shards * per_m, words.shape[1]), dtype=words.dtype)
    nbits_s = np.zeros(n_shards * per_m, dtype=nbits.dtype)
    slots_s = np.full(n_shards * per_m, local_lanes - 1, dtype=np.int64)
    tiers_s = None if tiers is None else np.zeros(n_shards * per_m, dtype=np.int64)
    real = np.zeros(n_shards * per_m, dtype=bool)
    start = 0
    for k in range(n_shards):
        c = int(counts[k])
        src = slice(start, start + c)
        dst = slice(k * per_m, k * per_m + c)
        words_s[dst] = words[src]
        nbits_s[dst] = nbits[src]
        slots_s[dst] = slots[src] - k * local_lanes
        if tiers_s is not None:
            tiers_s[dst] = tiers[src]
        real[dst] = True
        start += c
    return {**pk, "words": words_s, "nbits": nbits_s, "slots": slots_s,
            "lanes_pad": lanes_pad, "tiers": tiers_s, "real_rows": real}
