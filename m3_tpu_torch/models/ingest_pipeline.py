"""Distributed ingest pipeline: sharded M3TSZ encode + rollup collectives.

Port of ``m3_tpu/models/ingest_pipeline.py``, the write-path mirror of the
sharded read pipeline: a node seals blocks by encoding its lanes while the
embedded aggregator rolls the raw samples up into coarser windows.  Lanes
split over both axes of a (series x window) mesh (``parallel/mesh.py``);
the fleet-level results ride the mesh's collectives:

- the fleet rollup: each shard's sum of its lanes' windowed means (QK4), a
  ``psum`` over the series axis, then ``consolidate_windows`` over the
  window axis (MK1; the scatter schedule on the card and the CPU);
- the ingest accounting (bytes sealed): each shard's ``sum((nbits + 7) //
  8)`` in int64, then a ``psum`` over the whole mesh (MK1's exact integer
  form).

The encode is kernel E1 (``ops/m3tsz_encode.pack_encode``) in one launch
over the rank's lanes.  The rolled values are NaN-free by construction, as
in the reference (the port's per-shard sum skips a NaN cell where the
reference's would propagate it).
"""

from __future__ import annotations

import threading

import numpy as np
import torch

from m3_tpu_torch.ops.m3tsz_encode import pack_encode
from m3_tpu_torch.parallel.mesh import (SERIES_AXIS, WINDOW_AXIS, Mesh, consolidate_windows,
                                        psum, series_sharding, shard_reduce,
                                        supports_f64_reduce_scatter)

# built-step memo: one step function per (mesh, n_dp, window), as
# the reference memoizes its jitted shard_map (a few keys per process)
_BUILD_LOCK = threading.Lock()
_BUILD_CACHE: dict = {}


def encode_rollup_sharded(mesh: Mesh, n_dp: int, window: int):
    """Build (or fetch the memoized) distributed ingest step for ``mesh``.

    Returns ``step(ts [L,T], start [L], n_valid [L], ctl_bits, ctl_n,
    pay_bits, pay_n [L,T], values [L,T]) -> (words u32[L,W], nbits i32[L],
    rolled f64[L, T//window] windowed means, fleet f64[T//window] the
    fleet-wide rollup sum, total_bytes i64[] the sealed bytes of the whole
    mesh)``, with L the rank's lanes (``shard_ingest_inputs``); ``fleet``
    and ``total_bytes`` are replicated."""
    key = (mesh, n_dp, window)
    with _BUILD_LOCK:
        cached = _BUILD_CACHE.get(key)
    if cached is not None:
        return cached
    n_windows = n_dp // window
    use_scatter = supports_f64_reduce_scatter(mesh)

    def step(ts, start, n_valid, cb, cn, pb, pn, values):
        words, nbits = pack_encode(ts, start, n_valid, cb, cn, pb, pn)
        # the ingest-side rollup: the windowed mean per lane (glue)
        rolled = values.reshape(values.shape[0], n_windows, window).mean(dim=2)
        partial = psum(mesh, shard_reduce(mesh, rolled), SERIES_AXIS)
        fleet = consolidate_windows(mesh, partial, WINDOW_AXIS, use_scatter)[0]
        sealed = ((nbits.to(torch.int64) + 7) // 8).reshape(mesh.shards_per_rank, -1).sum(1)
        total_bytes = psum(mesh, sealed, (SERIES_AXIS, WINDOW_AXIS))[0]
        return words, nbits, rolled, fleet, total_bytes

    with _BUILD_LOCK:
        _BUILD_CACHE[key] = step
    return step


def shard_ingest_inputs(mesh: Mesh, *arrays):
    """The rank's lanes of host (or device) arrays on the mesh's device,
    lanes split evenly over every shard of the mesh; uint64 bit fields move
    as int64 bit patterns."""
    return tuple(series_sharding(mesh, a.view(np.int64) if isinstance(a, np.ndarray)
                                 and a.dtype == np.uint64 else a) for a in arrays)
