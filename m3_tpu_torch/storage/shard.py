"""One shard: open block buffers + sealed blocks + filesets.

Port of ``m3_tpu/storage/shard.py``: ``Shard`` (ref:
src/dbnode/storage/shard.go:910 writeAndIndex, :704 Tick), with the series
hot path columnar: writes land in a per-block columnar buffer; ``tick``
seals expired blocks by sorting the buffer and encoding every series'
stream in one batch; ``flush`` writes the sealed block as an immutable
fileset.

The reference chooses its seal encoder by JAX's default backend and falls
back to another encoder when one fails; the port takes a ``device``: on
``cuda`` the seal runs kernel E1 (``ops/m3tsz_encode.py``), on ``cpu`` its
plain version, and a failure raises.
"""

from __future__ import annotations

import dataclasses
import functools
import time
from typing import Callable

import numpy as np

from m3_tpu_torch.ops import m3tsz_scalar
from m3_tpu_torch.ops.m3tsz_encode import encode_to_streams
from m3_tpu_torch.storage.buffer import BlockBuffer
from m3_tpu_torch.storage.fileset import FilesetWriter
from m3_tpu_torch.storage.namespace import NamespaceOptions
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


@dataclasses.dataclass
class SealedBlock:
    block_start: int
    ids: list[bytes]
    streams: list[bytes]
    # wall-clock seal time: the fileset written from this block covers
    # every WAL entry stamped at/before it (bootstrap's skip rule)
    sealed_at: int = 0
    # datapoints per stream (known at seal time); rides into the
    # fileset index (v2) so batch readers size decode grids exactly
    counts: list[int] | None = None


class Shard:
    def __init__(
        self,
        shard_id: int,
        opts: NamespaceOptions,
        fileset_root: str | None = None,
        encode_fn: Callable | None = None,
        device=None,
    ):
        self.shard_id = shard_id
        self.opts = opts
        # the seal's encoder: by default E1 on `device` (cuda unless the
        # caller asks for the CPU, where E1's plain version runs)
        self.device = resolve_device(device)
        self.encode_fn = encode_fn or functools.partial(
            encode_block_device, device=self.device)
        self.fileset_root = fileset_root
        self._buffers: dict[int, BlockBuffer] = {}
        self._sealed: dict[int, SealedBlock] = {}
        self._flushed: set[int] = set()
        # next fileset volume per block start; bumped when a flushed
        # block is unsealed for a merge (repair / peer loads), so the
        # re-flush writes a NEW volume and readers pick the latest
        self._volume: dict[int, int] = {}
        from m3_tpu_torch.utils import instrument
        # wall-clock distance of the newest accepted sample from now:
        # a rising value means writers are falling behind real time
        self._m_lag = instrument.gauge(
            "m3_ingest_lag_seconds", ns=opts.name, shard=str(shard_id))

    # --- write path ---

    def write_batch(self, lanes, times_nanos, values) -> None:
        """Route a columnar batch into per-block buffers."""
        times_nanos = np.asarray(times_nanos, dtype=np.int64)
        lanes = np.asarray(lanes, dtype=np.int64)
        values = np.asarray(values, dtype=np.float64)
        if len(times_nanos):
            self._m_lag.set(
                (time.time_ns() - int(times_nanos.max())) / 1e9)
        starts = times_nanos - (times_nanos % self.opts.retention.block_size)
        uniq = np.unique(starts)
        if len(uniq) == 1:
            # steady-state ingest lands every sample in the live block:
            # hand the columns over whole, no mask/gather round
            bs = int(uniq[0])
            buf = self._buffers.get(bs)
            if buf is None:
                buf = self._buffers[bs] = BlockBuffer(bs)
            buf.write_batch(lanes, times_nanos, values)
            return
        for bs in uniq:
            sel = starts == bs
            buf = self._buffers.get(int(bs))
            if buf is None:
                buf = self._buffers[int(bs)] = BlockBuffer(int(bs))
            buf.write_batch(lanes[sel], times_nanos[sel], values[sel])

    # --- lifecycle ---

    def seal(self, block_start: int, ids: list[bytes]) -> SealedBlock | None:
        """Sort + encode one block's buffer into immutable streams.
        `ids` maps lane ordinal -> series id (from the shard's index).

        Re-seal of a block that was already sealed (a cold write landed
        after the first seal) MERGES the prior sealed content instead
        of overwriting it — otherwise the new sealed block would hold
        only the cold points while shadowing the on-disk fileset, and
        flush would skip it as already-flushed: the flushed points
        vanish from reads and the cold points never persist (found by
        the round-5 concurrency-stress tier).  The merge rides
        ``unseal``, which also bumps the fileset volume so the next
        flush writes a superseding volume (the reference's cold-flush
        merger, ref: persist/fs/merger.go)."""
        if block_start in self._sealed and block_start in self._buffers:
            # merge order matters: the old sealed chunks must sort
            # BEFORE the cold-write chunks so consolidated()'s
            # keep-LAST-duplicate rule lets the newer write win a
            # rewritten (lane, time) — the same winner read_series and
            # snapshot_pending produce (shard.go upsert semantics)
            cold = self._buffers.pop(block_start)
            sid_lane = {sid: i for i, sid in enumerate(ids)}
            self.unseal(block_start, lambda sid: sid_lane[sid])
            merged = self._buffers.get(block_start)
            if merged is None:
                self._buffers[block_start] = cold
            else:
                merged._lanes.extend(cold._lanes)
                merged._times.extend(cold._times)
                merged._values.extend(cold._values)
                merged._total += cold._total
        buf = self._buffers.pop(block_start, None)
        if buf is None or buf.num_datapoints == 0:
            return None
        lanes, times, values = buf.consolidated()
        streams = self.encode_fn(block_start, lanes, times, values, len(ids))
        present = [i for i, s in enumerate(streams) if s]
        # per-lane datapoint counts (lanes are sorted): stored in the
        # fileset index so batch readers skip the count pass
        lane_counts = np.bincount(lanes, minlength=len(ids))
        sealed = SealedBlock(
            block_start=block_start,
            ids=[ids[i] for i in present],
            streams=[streams[i] for i in present],
            # same stamp authority as commit-log chunks (clock-step-
            # safe ordering for bootstrap's covered-entry test)
            sealed_at=xtime.stamp_ns(),
            counts=[int(lane_counts[i]) for i in present],
        )
        self._sealed[block_start] = sealed
        return sealed

    def unseal(self, block_start: int, lane_of) -> bool:
        """Decode a sealed block back into an open buffer so late data
        (repair, peer loads) can merge; the next tick re-seals and the
        next flush writes a new fileset volume.  The reference's
        equivalent is the cold-flush merger rewriting a block's fileset
        with merged data (ref: persist/fs/merger.go)."""
        blk = self._sealed.pop(block_start, None)
        if blk is None:
            return False
        tsz = m3tsz_scalar

        lanes, times, values = [], [], []
        for sid, stream in zip(blk.ids, blk.streams):
            t, v = tsz.decode_series(stream)
            lane = lane_of(sid)
            lanes.extend([lane] * len(t))
            times.extend(t)
            values.extend(v)
        if lanes:
            self.write_batch(lanes, times, values)
        if block_start in self._flushed:
            self._flushed.discard(block_start)
            self._volume[block_start] = self._volume.get(block_start, 0) + 1
        return True

    def tick(self, now_nanos: int, ids: list[bytes]) -> list[int]:
        """Seal every buffer whose block can no longer take writes
        (block end + buffer_past elapsed) — the reference's tick/merge
        (ref: shard.go:704)."""
        ret = self.opts.retention
        sealed = []
        for bs in sorted(self._buffers):
            if bs + ret.block_size + ret.buffer_past <= now_nanos:
                if self.seal(bs, ids):
                    sealed.append(bs)
        return sealed

    def snapshot_pending(self, ids, lane_of) -> dict[int, tuple[list[bytes], list[bytes]]]:
        """{block_start: (ids, streams)} for every block whose ONLY
        durability is the WAL: open buffers and sealed-unflushed
        blocks.  A block with BOTH (a cold write after seal) merges
        them — the cold write must not be dropped from the snapshot
        (the covering WAL files get deleted afterwards)."""
        out: dict[int, tuple[list[bytes], list[bytes]]] = {}
        unflushed_sealed = {
            bs: blk for bs, blk in self._sealed.items()
            if bs not in self._flushed
        }
        for bs in sorted(set(self._buffers) | set(unflushed_sealed)):
            buf = self._buffers.get(bs)
            blk = unflushed_sealed.get(bs)
            if buf is None or buf.num_datapoints == 0:
                if blk is not None:
                    out[bs] = (list(blk.ids), list(blk.streams))
                continue
            if blk is None:
                lanes, times, values = buf.consolidated()
            else:
                tsz = m3tsz_scalar

                merged = BlockBuffer(bs)
                for sid, stream in zip(blk.ids, blk.streams):
                    t, v = tsz.decode_series(stream)
                    merged.write_batch([lane_of(sid)] * len(t), t, v)
                # buffer writes later: they win duplicate timestamps
                b_lanes, b_times, b_values = buf.consolidated()
                merged.write_batch(b_lanes, b_times, b_values)
                lanes, times, values = merged.consolidated()
            if not len(lanes):
                continue
            streams = self.encode_fn(bs, lanes, times, values, len(ids))
            present = [i for i, s in enumerate(streams) if s]
            out[bs] = ([ids[i] for i in present],
                       [streams[i] for i in present])
        return out

    def flush(self, writer: FilesetWriter, ns: str, tags_of=None) -> list[int]:
        """Persist sealed blocks not yet on disk (warm flush,
        ref: storage/flush.go:120).  tags_of(id) supplies series metadata
        for the on-disk index."""
        flushed = []
        for bs, blk in sorted(self._sealed.items()):
            if bs in self._flushed:
                continue
            writer.write(
                ns,
                self.shard_id,
                bs,
                blk.ids,
                blk.streams,
                block_size=self.opts.retention.block_size,
                tags=[tags_of(sid) for sid in blk.ids] if tags_of else None,
                volume=self._volume.get(bs, 0),
                covers_until=blk.sealed_at,
                counts=blk.counts,
            )
            self._flushed.add(bs)
            flushed.append(bs)
        return flushed

    # --- read path ---

    def read_series(
        self, series_id: bytes, lane: int, start_nanos: int, end_nanos: int,
        with_counts: bool = False,
    ) -> list[tuple]:
        """In-memory data for [start, end): (block_start, payload) pairs,
        payload either (times, values) arrays from an open buffer or a
        compressed stream from a sealed block.  Flushed filesets are read
        at the Database level (it owns the namespace paths).

        ``with_counts=True`` emits (block_start, payload, n_dp_or_None)
        triples — the count is produced HERE, alongside the payload it
        describes (a sealed stream's dp count), never re-derived by a
        caller from separate state."""
        ret = self.opts.retention
        out: list[tuple[int, object]] = []
        first = start_nanos - (start_nanos % ret.block_size)
        # iterate only block starts that hold data — walking the whole
        # [start, end) range block-by-block is O(range/block_size) and
        # an open-ended query (end = +inf sentinel) would spin through
        # millions of empty 2h steps
        candidates = sorted(
            bs for bs in set(self._sealed) | set(self._buffers)
            if first <= bs < end_nanos
        )
        for bs in candidates:
            sealed_stream = sealed_count = None
            if bs in self._sealed:
                blk = self._sealed[bs]
                try:
                    idx = blk.ids.index(series_id)
                    sealed_stream = blk.streams[idx]
                    if blk.counts is not None:
                        sealed_count = blk.counts[idx]
                except ValueError:
                    pass
            buf_ts = buf_vs = None
            if bs in self._buffers:
                # a cold write after seal lands in a fresh buffer
                # alongside the sealed block — reads must see both
                # (ref: buffer bucket versions, buffer.go:221)
                ts, vs = self._buffers[bs].read_lane(lane)
                if len(ts):
                    buf_ts, buf_vs = ts, vs
            if sealed_stream is not None and buf_ts is not None:
                # read-time merge: duplicate timestamps resolve to the
                # buffer (newer write) — the reference's bucket-version
                # merge; without it a rewrite-after-seal would surface
                # two values at one timestamp
                tsz = m3tsz_scalar

                st, sv = tsz.decode_series(sealed_stream)
                mt = np.concatenate([np.asarray(st, np.int64), buf_ts])
                mv = np.concatenate([np.asarray(sv, np.float64), buf_vs])
                order = np.argsort(mt, kind="stable")
                mt, mv = mt[order], mv[order]
                if len(mt) > 1:
                    keep = np.concatenate([mt[:-1] != mt[1:], [True]])
                    mt, mv = mt[keep], mv[keep]
                out.append((bs, (mt, mv), None) if with_counts
                           else (bs, (mt, mv)))
            elif sealed_stream is not None:
                out.append((bs, sealed_stream, sealed_count)
                           if with_counts else (bs, sealed_stream))
            elif buf_ts is not None:
                out.append((bs, (buf_ts, buf_vs), None) if with_counts
                           else (bs, (buf_ts, buf_vs)))
        return out

    def open_block_starts(self) -> list[int]:
        return sorted(self._buffers)

    def sealed_block_starts(self) -> list[int]:
        return sorted(self._sealed)
