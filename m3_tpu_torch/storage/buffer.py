"""Shard write buffers — the mutable head of each block.

The reference buffers writes per series in per-block encoder chains
(ref: src/dbnode/storage/series/buffer.go:221,290) and coalesces
concurrent writers through async insert queues
(ref: src/dbnode/storage/shard_insert_queue.go:63).  TPU-first, the
buffer is columnar: writes arrive as batches of (lane, timestamp,
value) triples appended to chunk lists, and out-of-order data is
resolved once, by sort, at seal time (SURVEY.md §7.3) instead of via
multi-encoder merges.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class BlockBuffer:
    """Columnar append buffer for one (shard, block_start)."""

    block_start: int
    _lanes: list[np.ndarray] = dataclasses.field(default_factory=list)
    _times: list[np.ndarray] = dataclasses.field(default_factory=list)
    _values: list[np.ndarray] = dataclasses.field(default_factory=list)
    _total: int = 0

    def write_batch(
        self, lanes: np.ndarray, times_nanos: np.ndarray, values: np.ndarray
    ) -> None:
        self._lanes.append(np.asarray(lanes, dtype=np.int64))
        self._times.append(np.asarray(times_nanos, dtype=np.int64))
        self._values.append(np.asarray(values, dtype=np.float64))
        self._total += len(lanes)

    @property
    def num_datapoints(self) -> int:
        return self._total

    def consolidated(self) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(lanes, times, values) sorted by (lane, time); duplicate
        (lane, time) pairs keep the LAST write, matching the reference's
        upsert on datapoint rewrite."""
        if not self._total:
            z = np.zeros(0, dtype=np.int64)
            return z, z.copy(), np.zeros(0, dtype=np.float64)
        lanes = np.concatenate(self._lanes)
        times = np.concatenate(self._times)
        values = np.concatenate(self._values)
        # one stable lexsort (lane primary, time secondary) instead of
        # two argsort+gather rounds; later writes for the same
        # (lane, time) keep their insertion order, so LAST still wins
        order = np.lexsort((times, lanes))
        lanes, times, values = lanes[order], times[order], values[order]
        # drop all but the last duplicate of each (lane, time)
        if len(lanes) > 1:
            same = (lanes[:-1] == lanes[1:]) & (times[:-1] == times[1:])
            keep = np.concatenate([~same, [True]])
            lanes, times, values = lanes[keep], times[keep], values[keep]
        return lanes, times, values

    def read_lane(self, lane: int) -> tuple[np.ndarray, np.ndarray]:
        """(times, values) for one series, consolidated, for reads that
        hit the open block."""
        ts_parts = []
        vs_parts = []
        for ls, ts, vs in zip(self._lanes, self._times, self._values):  # lint: allow-per-sample-loop (per-CHUNK arrays, read path)
            sel = ls == lane
            if sel.any():
                ts_parts.append(ts[sel])
                vs_parts.append(vs[sel])
        if not ts_parts:
            return np.zeros(0, dtype=np.int64), np.zeros(0, dtype=np.float64)
        ts = np.concatenate(ts_parts)
        vs = np.concatenate(vs_parts)
        order = np.argsort(ts, kind="stable")
        ts, vs = ts[order], vs[order]
        if len(ts) > 1:
            keep = np.concatenate([ts[:-1] != ts[1:], [True]])
            ts, vs = ts[keep], vs[keep]
        return ts, vs
