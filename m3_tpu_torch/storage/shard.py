"""A shard's block seal: batch-encode a block's columnar points into streams.

Port of ``encode_block_scalar`` and ``encode_block_device`` of
``m3_tpu/storage/shard.py`` (ref: src/dbnode/storage/shard.go:704 Tick
seals expired blocks by encoding every series' stream).  The ``Shard``
class (buffer, commit log, filesets) waits for ROADMAP.md's queue 1
item 8.

The reference chooses its branch by JAX's default backend and falls back
to another encoder when one fails; the port takes a ``device``: on
``cuda`` the seal runs kernel E1 (``ops/m3tsz_encode.py``), on ``cpu`` its
plain version, and a failure raises.
"""

from __future__ import annotations

import numpy as np

from m3_tpu_torch.ops import m3tsz_scalar
from m3_tpu_torch.ops.m3tsz_encode import encode_to_streams
from m3_tpu_torch.utils import xtime
from m3_tpu_torch.utils.device import resolve_device


def encode_block_scalar(
    block_start: int, lanes, times, values, n_lanes: int
) -> list[bytes]:
    """Batch-encode consolidated columnar triples (lanes sorted) into
    per-lane streams with the scalar encoder."""
    streams = [b""] * n_lanes
    bounds = np.searchsorted(lanes, np.arange(n_lanes + 1))
    for lane in range(n_lanes):
        lo, hi = bounds[lane], bounds[lane + 1]
        if lo == hi:
            continue
        streams[lane] = m3tsz_scalar.encode_series(
            times[lo:hi].tolist(), values[lo:hi].tolist(), block_start
        )
    return streams


def _pow2_at_least(n: int, floor: int) -> int:
    p = floor
    while p < n:
        p *= 2
    return p


def encode_block_device(
    block_start: int, lanes, times, values, n_lanes: int, device=None
) -> list[bytes]:
    """Seal one block: batched M3TSZ encode of all series lanes.

    Columnar (lanes, times, values), lanes sorted, is scattered into
    padded [L, T] matrices and encoded by ``encode_to_streams`` on
    ``device`` (default ``cuda``).  Lanes are bucketed by padded length,
    T and L rounded up to powers of two, as in the reference, so one dense
    series does not inflate the whole block to O(L x T_max).  Streams with
    sub-second timestamps take the scalar encoder (the batched grammar
    covers the fixed-unit production shape).
    """
    dev = resolve_device(device)
    sec = xtime.SECOND
    if n_lanes == 0:
        return []
    if len(times) == 0:
        return [b""] * n_lanes
    if block_start % sec or (np.asarray(times) % sec).any():
        return encode_block_scalar(block_start, lanes, times, values, n_lanes)

    lanes = np.asarray(lanes)
    times = np.asarray(times)
    values = np.asarray(values)
    bounds = np.searchsorted(lanes, np.arange(n_lanes + 1))
    counts = np.diff(bounds).astype(np.int32)

    t_bucket = np.maximum(
        8, 1 << np.ceil(np.log2(np.maximum(counts, 1))).astype(np.int64))
    streams: list[bytes] = [b""] * n_lanes
    col_of_point = np.arange(len(times)) - bounds[lanes]
    for T in np.unique(t_bucket[counts > 0]):
        members = np.flatnonzero((t_bucket == T) & (counts > 0))
        L = _pow2_at_least(len(members), 8)
        tsm = np.full((L, int(T)), block_start, dtype=np.int64)
        vsm = np.zeros((L, int(T)), dtype=np.float64)
        n_valid = np.zeros((L,), dtype=np.int32)
        n_valid[: len(members)] = counts[members]
        # one vectorized scatter for the whole bucket: every point whose
        # lane is a member lands at (row of its lane, its offset in the lane)
        row_of_lane = np.full(n_lanes, -1, dtype=np.int64)
        row_of_lane[members] = np.arange(len(members))
        pmask = row_of_lane[lanes] >= 0
        rows = row_of_lane[lanes[pmask]]
        cols = col_of_point[pmask]
        tsm[rows, cols] = times[pmask]
        vsm[rows, cols] = values[pmask]
        starts = np.full((L,), block_start, dtype=np.int64)
        encoded = encode_to_streams(tsm, vsm, starts, n_valid, device=dev)
        for row, lane in enumerate(members):
            streams[int(lane)] = encoded[row]
    return streams
