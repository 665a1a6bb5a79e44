"""AggregateTiles: source namespace blocks -> rolled-up tiles.

Port of ``m3_tpu/storage/tiles.py`` (ref: src/dbnode/storage/database.go:1277
AggregateTiles -> shard.go:2659, which reads each shard's flushed source
blocks and writes tile aggregates to a target namespace).  A block's
sealed or flushed streams are packed into one batch and reduced by T1
(``ops/tiles.py``) on the database's device; the tiles land in the target
namespace through ``Database.load_batch`` at tile-end timestamps, suffixed
per aggregation type like the streaming downsampler's output.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from m3_tpu_torch.aggregator.aggregator import (MetricKind, apply_suffix,
                                                suffix_for)
from m3_tpu_torch.ops import tiles as tiles_ops
from m3_tpu_torch.ops.bitstream import pack_streams
from m3_tpu_torch.ops.downsample import (QUANTILE_OF_TYPE, AggregationType,
                                         value_of)


@dataclass
class AggregateTilesOptions:
    tile_nanos: int
    agg_types: tuple[AggregationType, ...] = (AggregationType.MEAN,)
    # decode bound: max datapoints per series per source block
    max_points: int = 512


@dataclass
class AggregateTilesResult:
    n_series: int = 0
    n_blocks: int = 0
    n_tiles_written: int = 0
    n_errors: int = 0


class TileAggregator:
    def __init__(self, db):
        self._db = db

    def aggregate_tiles(self, source_ns: str, target_ns: str,
                        start_nanos: int, end_nanos: int,
                        opts: AggregateTilesOptions
                        ) -> AggregateTilesResult:
        """Roll every sealed/flushed source block in [start, end) into
        tiles in the target namespace."""
        for t in opts.agg_types:
            if t in QUANTILE_OF_TYPE:
                raise ValueError(
                    "tile quantiles need raw streams; use the query "
                    "path or streaming downsampler for quantiles")
        res = AggregateTilesResult()
        retention = self._db.namespace_options(source_ns).retention
        block_size = retention.block_size
        if block_size % opts.tile_nanos:
            raise ValueError("tile size must divide the block size")
        target_res = self._db.namespace_options(
            target_ns).aggregation_resolution
        if target_res and target_res != opts.tile_nanos:
            # a tile grid finer or coarser than the namespace's declared
            # resolution would be unreadable at the resolution the
            # namespace advertises to the planner
            raise ValueError(
                f"tile size {opts.tile_nanos} does not match target "
                f"namespace {target_ns!r} aggregation_resolution "
                f"{target_res}")
        n_tiles = block_size // opts.tile_nanos
        bs = retention.block_start(start_nanos)
        while bs < end_nanos:
            self._one_block(source_ns, target_ns, bs, n_tiles, opts, res)
            bs += block_size
        return res

    def _one_block(self, source_ns, target_ns, block_start, n_tiles,
                   opts, res):
        # every series' compressed stream for the block (one locked pass;
        # open buffers are skipped: tiles read only sealed/flushed data)
        gathered = self._db.series_streams_for_block(source_ns, block_start)
        if not gathered:
            return
        # a payload that is not bytes costs ONE series, not the whole
        # batch; empty streams are "no data", skipped without an error
        sids, tags_l, streams = [], [], []
        for sid, tags, stream in gathered:
            if not isinstance(stream, (bytes, bytearray)):
                res.n_errors += 1
                res.n_series += 1
                continue
            if not stream:
                continue
            sids.append(sid)
            tags_l.append(tags)
            streams.append(bytes(stream))
        if not sids:
            res.n_blocks += 1
            return
        words, nbits = pack_streams(streams)
        dev = self._db.device
        words = torch.from_numpy(words).to(dev)
        nbits = torch.from_numpy(nbits).to(dev)
        # the tile grid is anchored to the target resolution's absolute
        # grid, not the source block start: a block start off the grid
        # straddles one more tile
        grid_start = block_start - block_start % opts.tile_nanos
        if grid_start != block_start:
            n_tiles += 1
        # decode bound: grow until no lane saturates (a lane whose count
        # reaches n_steps may have been TRUNCATED)
        n_steps = opts.max_points
        block_size = self._db.namespace_options(
            source_ns).retention.block_size
        # +1: at exactly cap points, decoded_count == n_steps is complete,
        # not truncated; only beyond the cap is it ambiguous
        cap = max(n_steps, block_size // 1_000_000_000 + 1)
        while True:
            agg, decoded_count, error = tiles_ops.aggregate_tiles(
                words, nbits, n_steps=n_steps, n_tiles=n_tiles,
                tile_nanos=opts.tile_nanos, block_start=grid_start)
            error = error.cpu().numpy()
            saturated = decoded_count.cpu().numpy() >= n_steps
            if not saturated.any() or n_steps >= cap:
                # lanes still saturated at the cap are errors, not
                # silently truncated tiles
                error = error | saturated
                break
            n_steps = min(2 * n_steps, cap)
        res.n_errors += int(error.sum())
        res.n_series += len(sids)
        res.n_blocks += 1
        out_ids, out_tags, out_ts, out_vs = [], [], [], []
        has = (agg.count > 0).cpu().numpy()  # [L, n_tiles]
        values = {t: value_of(agg, t).cpu().numpy() for t in opts.agg_types}
        for lane, sid in enumerate(sids):
            if error[lane]:
                continue
            for w in np.nonzero(has[lane])[0]:
                t_end = grid_start + (int(w) + 1) * opts.tile_nanos
                for at in opts.agg_types:
                    oid = apply_suffix(sid, suffix_for(MetricKind.GAUGE, at))
                    out_ids.append(oid)
                    out_tags.append(tags_l[lane])
                    out_ts.append(t_end)
                    out_vs.append(float(values[at][lane, w]))
        if out_ids:
            self._db.load_batch(target_ns, out_ids, out_tags, out_ts, out_vs)
            res.n_tiles_written += len(out_ids)
