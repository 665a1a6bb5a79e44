"""Stream corpora the read path is driven and checked with.

- ``walk_streams``: the north-star workload's integer gauges — a seed-42
  random walk at 10s, the generator of the reference's ``bench.py``.
- ``probe_streams``: one stream per grammar corner and failure mode the
  decoders must agree on: NaN, +-Inf and -0.0 values; backward and
  duplicate timestamps; every timestamp bucket; mode switches, decimal
  multipliers and repeats; annotation and time-unit markers (error lanes
  that fall back to the scalar oracle); truncated and garbage streams;
  streams shorter than the decode grid.

- ``fanout_corpus``: BASELINE config 4, the m3query fan-out read —
  series x hours of 10s data in 2h blocks, one stream per (series,
  block), rate(m[5m]) at 60s steps, ``arange(lanes) % 100`` groups.
- ``query_probe_corpus``: small query-path batches with one lane per
  corner the serving pipelines must agree on: counter resets, NaN/+-Inf
  samples, sparse lanes (empty and one-sample windows), signed zeros,
  an unsorted lane, lane overflow past ``n_cap``, truncation at ``n_dp``,
  a two-tier stitch, and padding streams (``nbits == 0``) parked on the
  last lane.
- ``long_lanes``: merged lanes of tens of thousands of samples, the
  length of a raw query over days, one lane per probe kind.

The fused expression interpreter:
- ``ExprPlanBuilder``: hand-built plans in the grammar of the reference's
  ``device_expr_pipeline`` with the padding contracts of
  ``m3_tpu/query/plan.py`` (power-of-two buckets, padding lanes NaN,
  topk's trash group, histogram buckets padded by repeating the top row,
  steps padded by repeating the last one), with their numpy leaves and
  params; ``stack_queries`` stacks Q of them for the batched pipeline;
- ``expr_inputs_from_numpy`` (re-exported from ``query_pipeline``): those
  numpy inputs as the port's tensors;
- ``select_probes``, ``minmax_probe_lanes``, ``histogram_probes``: the
  corners of the four kernels of the interpreter's slice;
  ``temporal_probe_lanes``: those of the rest of the temporal family
  (stddev/stdvar, changes/resets, deriv/predict_linear, holt_winters,
  quantile_over_time);
- ``graphite_labels``: graphite paths as labels (``__name__`` and one
  ``__g<i>__`` per component) for the builder's ``gsel``/``gagg``/``gcall``
  nodes; ``graphite_probe_matrix``: the graphite kernels' probe corners;
- ``expr_fleet``: BASELINE config 4's width for the expression plans
  (http_requests / http_limit counters, histogram buckets, gauges);
  ``megabatch_queries``: the reference's 16-query dashboard fleet.

The write side:
- ``encode_probe_series`` / ``encode_batch``: one lane per case of the
  reference's batched-encoder tests (every delta-of-delta bucket and its
  edges, float mode and XOR, int<->float flips, decimal multipliers,
  sig-bit hysteresis, repeats, negative and huge values, NaN, +-Inf,
  ragged and empty lanes, the fuzz mix) plus the golden fixture's points.
- ``elem_probe_batches``: ingest batches for the aggregator's slot
  kernels (many samples per slot, ties at the greatest time, samples at a
  slot's resident time, epoch overwrites, stale samples, +-0.0, NaN,
  +-Inf, all-NaN windows); ``quantile_probes``: padded weighted
  quantile matrices (NaN, real +inf against the padding, ties, weights
  1-64, rows of total 0, K = 1).
- ``rollup_rounds``, ``timer_windows`` and ``config2_batches``: the
  write-side chip phases' inputs (BASELINE configs 2-3).

Storage and tiles:
- ``tile_probe_streams``: the AggregateTiles kernel's corners (duplicate
  timestamps at a tile's greatest time, timestamps going back across
  tiles, NaN / +-Inf / +-0.0 in one tile, points at the grid's edges and
  1 ns around them for a block start off the second grid, a sum whose
  value depends on its order).

The mesh paths (the cases of the reference's own mesh tests):
- ``sharded_query_streams``: lanes of ``blocks_per`` blocks of counter
  samples, slot-grouped (``tests/test_query_pipeline_device.py:24``; 16
  lanes, 2 blocks of 30 for 8 shards); ``sharded_read_batch``: integer walk
  lanes (``tests/test_read_pipeline.py:23``); ``ingest_grid``: the sharded
  encoder's grids (``tests/test_ingest_pipeline.py:22``);
  ``mesh_expr_plan``: one interpreter plan per collective site of the
  sharded interpreter over a small labelled fleet, its words leaves laid
  out shard-even (``ExprPlanBuilder.shard_even``); ``global_slots`` undoes
  the local slots for the unsharded interpreter.

Everything is built from a seed with the scalar encoder, so the same
bytes feed the JAX package and the port.
"""

from __future__ import annotations

import math
import random
from typing import NamedTuple

import numpy as np
import torch

from m3_tpu_torch.models.query_pipeline import expr_inputs_from_numpy  # noqa: F401
from m3_tpu_torch.ops import m3tsz_scalar as tsz
from m3_tpu_torch.ops.bitstream import pack_streams
from m3_tpu_torch.parallel.repack import shard_repack
from m3_tpu_torch.utils import xtime

SEC = xtime.SECOND
MS = 1_000_000
START = 1_600_000_000 * SEC


def walk_streams(n: int, n_dp: int, seed: int = 42, start: int = START) -> list[bytes]:
    """``n`` integer-gauge walks of ``n_dp`` points at 10s."""
    rng = random.Random(seed)
    streams = []
    for _ in range(n):
        t, v = start, float(rng.randint(0, 1000))
        enc = tsz.Encoder(start)
        for _ in range(n_dp):
            t += 10 * SEC
            v = max(0.0, v + rng.choice([-2.0, -1.0, 0.0, 0.0, 1.0, 2.0]))
            enc.encode(t, v)
        streams.append(enc.finalize())
    return streams


def _series(values, step=10 * SEC, start=START):
    return [start + (i + 1) * step for i in range(len(values))], list(values)


def probe_streams(n_dp: int = 36, int_optimized: bool = True, seed: int = 7) -> list[bytes]:
    """One stream per probe, second unit, for the given value grammar."""
    rng = random.Random(seed)

    def enc(ts, vs, start=START):
        return tsz.encode_series(ts, vs, start, int_optimized=int_optimized)

    out = []
    out.append(enc(*_series([1.0, math.nan, math.inf, -math.inf, -0.0, 2.0,
                             0.0, -0.0, math.nan, 3.5])))
    out.append(enc(*_series([-0.0] * 4 + [0.0, -0.0])))
    # backward and duplicate timestamps (negative and zero delta-of-delta)
    ts = [START + d * SEC for d in (10, 20, 20, 15, 5, 30, 30, 30, 100)]
    out.append(enc(ts, [float(i) for i in range(len(ts))]))
    # every timestamp bucket, incl. the 32-bit default
    ts = [START]
    for d in (10, 10, 70, 3, 500, 500, 2000, 100000, 1, 10, 10):
        ts.append(ts[-1] + d * SEC)
    out.append(enc(ts[1:], [float(i) for i in range(len(ts) - 1)]))
    # mode switches int <-> float, decimal multipliers, repeats, negatives
    out.append(enc(*_series([1.0, 2.0, math.pi, math.pi, math.e, 5.0, 5.0, 6.5,
                             7.0, math.sqrt(2), 9.0, 9.0])))
    out.append(enc(*_series([round(1.5 + 0.001 * i, 3) for i in range(n_dp)])))
    out.append(enc(*_series([(-1.0) ** i * i * 100 for i in range(20)])))
    out.append(enc(*_series([42.0] * n_dp)))
    out.append(enc(*_series([math.sin(i / 7.0) * 100 for i in range(n_dp)])))
    out.append(enc(*_series([float(rng.randint(0, 10**9)) for _ in range(n_dp)])))
    # large values that do not fit the int grammar, and tiny ones
    out.append(enc(*_series([1e300, -1e-300, 2.0**63, 5e-324, 1.0])))
    # shorter than the decode grid; a single point; no point at all
    out.append(enc(*_series([float(i) for i in range(n_dp // 3)])))
    out.append(enc(*_series([7.0])))
    out.append(tsz.Encoder(START, int_optimized=int_optimized).finalize())
    # longer than the decode grid
    out.append(enc(*_series([float(i % 5) for i in range(n_dp + 5)])))
    # annotation marker -> error lane (scalar-oracle fallback)
    e = tsz.Encoder(START, int_optimized=int_optimized)
    e.encode(START + 10 * SEC, 1.0, annotation=b"schema")
    e.encode(START + 20 * SEC, 2.0)
    out.append(e.finalize())
    # sub-second stamps: the encoder writes a time-unit marker -> error lane
    out.append(enc(*_series([1.0, 2.0, 3.0], step=250 * MS)))
    # unaligned stream start -> time-unit marker first -> error lane
    start = START + 123
    out.append(enc([start + 1 + i * 10 * SEC for i in range(5)],
                   [float(i) for i in range(5)], start=start))
    # truncated streams (clean prefix then running off the end)
    full = enc(*_series([float(rng.randint(0, 50)) for _ in range(n_dp)]))
    out.append(full[: len(full) // 3])
    out.append(full[:-1])
    out.append(full[:9])
    # garbage: random bytes, and all-ones (an unending 32-bit dod run)
    g = np.random.default_rng(seed)
    for n in (12, 40, 90):
        out.append(g.integers(0, 256, n, dtype=np.uint8).tobytes())
    out.append(b"\xff" * 48)
    out.append(b"")
    return out


def golden_streams() -> list[bytes]:
    """The reference's float-mode wire fixtures (encoder_test.go:204-363,
    start 1427162400s): without and with annotations / time units."""
    return [
        bytes([0x13, 0xCE, 0x4C, 0xA4, 0x30, 0xCB, 0x40, 0x0, 0x9F, 0x20, 0x14, 0x0,
               0x0, 0x0, 0x0, 0x0, 0x0, 0x5F, 0x8C, 0xB0, 0x3A, 0x0, 0xE1, 0x0, 0x78,
               0x0, 0x0, 0x40, 0x6, 0x58, 0x76, 0x8E, 0x0, 0x0]),
        bytes([0x13, 0xCE, 0x4C, 0xA4, 0x30, 0xCB, 0x40, 0x0, 0x80, 0x20, 0x1, 0x53,
               0xE4, 0x2, 0x80, 0x0, 0x0, 0x0, 0x0, 0x0, 0xB, 0xF1, 0x96, 0x7, 0x40,
               0x10, 0x4, 0x8, 0x4, 0xB, 0x84, 0x1, 0xE0, 0x0, 0x1, 0x0, 0x19, 0x61,
               0xDA, 0x38, 0x0]),
        bytes([0x13, 0xCE, 0x4C, 0xA4, 0x30, 0xCB, 0x40, 0x0, 0x9F, 0x20, 0x14, 0x0,
               0x0, 0x0, 0x0, 0x0, 0x0, 0x5F, 0x8C, 0xB0, 0x3A, 0x0, 0xE1, 0x0, 0x40,
               0x20, 0x4F, 0xFF, 0xFF, 0xFF, 0x22, 0x58, 0x60, 0xD0, 0xC, 0xB0, 0xEE,
               0x1, 0x1, 0x0, 0x0, 0x0, 0x1, 0xA4, 0x36, 0x76, 0x80, 0x47, 0x0, 0x80,
               0x7F, 0xFF, 0xFF, 0xFF, 0x7F, 0xD9, 0x9A, 0x80, 0x11, 0x44, 0x0]),
        bytes([0x13, 0xCE, 0x4C, 0xA4, 0x30, 0xCB, 0x40, 0x0, 0x80, 0x20, 0x1, 0x53,
               0xE4, 0x2, 0x80, 0x0, 0x0, 0x0, 0x0, 0x0, 0xB, 0xF1, 0x96, 0x6, 0x0,
               0x81, 0x0, 0x81, 0x68, 0x2, 0x1, 0x1, 0x0, 0x0, 0x0, 0x1D, 0xCD, 0x65,
               0x0, 0x0, 0x20, 0x8, 0x20, 0x18, 0x20, 0x2F, 0xF, 0xA6, 0x58, 0x77, 0x0,
               0x80, 0x40, 0x0, 0x0, 0x0, 0xE, 0xE6, 0xB2, 0x80, 0x23, 0x80, 0x0]),
    ]


def ms_streams(n: int, n_dp: int, seed: int = 3) -> list[bytes]:
    """Integer gauges at 250ms, encoded with the millisecond default unit
    (decoded with ``unit_nanos=1_000_000``)."""
    rng = random.Random(seed)
    out = []
    for _ in range(n):
        ts = [START + (i + 1) * 250 * MS + rng.choice([0, 0, 1, -1]) * MS
              for i in range(n_dp)]
        vs = [float(rng.randint(0, 100)) for _ in range(n_dp)]
        out.append(tsz.encode_series(ts, vs, START, unit=xtime.Unit.MILLISECOND))
    return out


def tile_probe_streams(tile: int = 60 * SEC, n_tiles: int = 12, start: int = START) -> list[bytes]:
    """Streams for T1 with block_start ``start`` (or ``start + 100s + 1ns``,
    the off-grid probe) and ``n_tiles`` tiles of ``tile`` nanos."""
    inf, nan = math.inf, math.nan

    def enc(ts, vs):
        return tsz.encode_series([start + t for t in ts], vs, start)

    end = n_tiles * tile
    out = []
    # ties at a tile's greatest time: the last one in stream order wins
    out.append(enc([10 * SEC, 30 * SEC, 30 * SEC, 20 * SEC, 30 * SEC, 70 * SEC, 70 * SEC],
                   [1.0, 2.0, 3.0, 4.0, 5.0, 6.0, nan]))
    # back across tiles, and back again inside the first tile revisited
    out.append(enc([5 * SEC, 130 * SEC, 65 * SEC, 10 * SEC, 200 * SEC, 7 * SEC, 125 * SEC,
                    10 * SEC, 600 * SEC, 59 * SEC],
                   [float(i) for i in range(10)]))
    # NaN, +-Inf and +-0.0 in one tile, and tiles of each alone (the int
    # grammar writes -0.0 as +0.0: float-mode streams carry the sign)
    out.append(enc([s * SEC for s in range(1, 13)] + [61 * SEC, 62 * SEC, 121 * SEC, 181 * SEC,
                                                      182 * SEC, 241 * SEC],
                   [0.0, -0.0, nan, 2.0, -0.0, inf, -inf, 0.0, nan, 1e308, 1e308, -3.5,
                    -0.0, 0.0, nan, inf, inf, -inf]))
    # the grid's edges: before it, its first and last second, its end
    out.append(enc([-SEC, 0, 99 * SEC, 100 * SEC, 101 * SEC, end - SEC, end, end + 100 * SEC,
                    end + 101 * SEC],
                   [float(i) for i in range(9)]))
    # order-sensitive sums within a tile
    out.append(enc([1 * SEC, 2 * SEC, 3 * SEC], [0.1, 0.2, 0.3]))
    return out


# T1's CUDA kernel writes its tiles through per-warp staged groups of 4:
# tile counts around them (1, kT - 1, kT, kT + 1, 2kT + 1, and 17: five
# groups) and lane counts around a warp
TILE_GROUP_NTILES = (1, 3, 4, 5, 9, 17)
TILE_GROUP_LANES = (1, 31, 33, 129)


def tile_group_probe_streams(n_lanes: int = 129, tile: int = 60 * SEC,
                             last_tiles=tuple(n - 1 for n in TILE_GROUP_NTILES),
                             start: int = START, seed: int = 41) -> list[bytes]:
    """Streams for T1's staged tile groups, block start ``start``: lane i
    walks from tile ``i % 13`` (offsets, spacings of 10-90 s that skip
    tiles, gaps of 9-20 tiles longer than a group, 5-70 points: lanes end in
    every group, some past the grid, some past 64 steps), except the probes
    at fixed lanes: a lane whose only point is in tile k for each k of
    ``last_tiles`` (the last tile of each tile count), duplicate timestamps
    on every tile boundary, gaps over whole groups, the index going
    backwards inside the first group and after one and two groups have been
    written, NaN / +-Inf / -0.0 on a group boundary, no point in range, an
    empty stream and a stream cut short (an error lane)."""
    rng = random.Random(seed)

    def enc(ts, vs):
        return tsz.encode_series([start + t for t in ts], vs, start)

    def at(tiles_secs):  # (tile, second in it) -> offset nanos
        return [k * tile + s * SEC for k, s in tiles_secs]

    nan, inf = math.nan, math.inf
    special = {}
    for i, k in zip((1, 5, 9, 30, 64, 70, 71, 72), last_tiles):
        special[i] = enc([k * tile + 30 * SEC], [float(k)])
    # duplicate timestamps on each side of every tile boundary: a tile's
    # first two points and its last two (the later of those wins `last`)
    ts, vs = [], []
    for k in range(1, 19):
        ts += [k * tile - 10 * SEC, k * tile - 10 * SEC, k * tile, k * tile]
        vs += [float(k), k + 0.25, float(10 * k), float(10 * k + 1)]
    special[2] = enc(ts, vs)
    # gaps over whole groups, from a group's first tile and from its middle
    special[14] = enc(at([(0, 5), (1, 5), (11, 5), (12, 5), (30, 5)]), [1.0, 2.0, 3.0, 4.0, 5.0])
    special[20] = enc(at([(3, 1), (3, 2), (13, 1), (16, 59), (26, 0)]), [1.0, -2.0, 3.0, 4.0, 5.0])
    # backwards inside the first group
    special[26] = enc(at([(0, 1), (1, 1), (2, 1), (1, 30), (3, 1), (5, 1)]),
                      [1.0, 2.0, 3.0, 4.0, 5.0, 6.0])
    # backwards after groups of tiles have been written
    special[31] = enc(at([(k, 20) for k in range(11)] + [(2, 40), (12, 1), (16, 1)]),
                      [float(k) for k in range(14)])
    special[32] = enc(at([(k, 50) for k in range(17)] + [(9, 10), (16, 55)]),
                      [float(k) for k in range(19)])
    # NaN, +-Inf and -0.0 on either side of a group boundary
    special[40] = enc(at([(7, 10), (7, 20), (7, 59), (8, 0), (8, 1), (8, 2), (9, 0)]),
                      [nan, inf, -0.0, -inf, nan, 2.0, 0.0])
    # nothing in range; an empty stream; a stream cut short
    special[96] = enc([-300 * SEC, -200 * SEC], [1.0, 2.0])
    special[100] = tsz.Encoder(start).finalize()
    cut = enc(at([(k // 4, 15 * (k % 4)) for k in range(40)]), [float(k) for k in range(40)])
    special[128] = cut[: len(cut) // 2]
    out = []
    for i in range(n_lanes):
        if i in special:
            out.append(special[i])
            continue
        t = (i % 13) * tile + rng.randrange(60) * SEC
        v = float(rng.randint(0, 1000))
        ts, vs = [], []
        for j in range(rng.randint(5, 70)):
            ts.append(t)
            vs.append(v)
            t += rng.choice((10, 10, 15, 20, 40, 90)) * SEC
            if i % 5 == 0 and j == 6:
                t += rng.randint(9, 20) * tile
            v = max(0.0, v + rng.choice((-2.0, -1.0, 0.0, 1.0, 2.0)))
        out.append(enc(ts, vs))
    return out


# K2's CUDA kernel writes its windows through per-warp staged groups of 4
# (8 with full_agg): (n_steps, window) around them, n_win of 1, kW - 1, kW,
# kW + 1 for both widths, window 1 and window = n_steps, and errors in the
# middle of a window of 4 and of 36
K2_WINDOW_CASES = ((1, 1), (3, 1), (4, 1), (5, 1), (7, 1), (8, 1), (9, 1), (36, 4), (36, 36))


def k2_window_probe_streams(n_dp: int = 36) -> list[bytes]:
    """Streams for K2's staged windows: the decoder's probe streams (error
    lanes, truncation, garbage), a walk cut at 24 lengths (the decoder
    stops in error at steps all through the grid) and 11 walks: 61 lanes."""
    (full,) = walk_streams(1, n_dp + 4, seed=8)
    cuts = [full[: 9 + (len(full) - 9) * k // 24] for k in range(24)]
    return probe_streams(n_dp) + cuts + walk_streams(11, n_dp, seed=9)


# --- the query path -------------------------------------------------------


def gen_grids(n_unique: int, n_dp: int, start: int = START):
    """[n_unique, n_dp] timestamp/value grids of seed-42 integer-gauge
    walks at 10s (the generator of the reference's ``bench.py``; every
    call restarts the seed)."""
    rng = random.Random(42)
    ts = np.zeros((n_unique, n_dp), dtype=np.int64)
    vs = np.zeros((n_unique, n_dp), dtype=np.float64)
    for u in range(n_unique):
        t, v = start, float(rng.randint(0, 1000))
        for i in range(n_dp):
            t += 10 * SEC
            v = max(0.0, v + rng.choice([-2.0, -1.0, 0.0, 0.0, 1.0, 2.0]))
            ts[u, i] = t
            vs[u, i] = v
    return ts, vs


class QueryBatch(NamedTuple):
    """A packed fan-out read: stream rows grouped by output lane."""

    words: np.ndarray  # u32[M, W]
    nbits: np.ndarray  # i32[M]
    slots: np.ndarray  # i64[M] output lane per stream, ascending
    tiers: np.ndarray | None  # i64[M] dense tier rank per stream (0 finest)
    n_tiers: int
    steps: np.ndarray  # i64[S]
    groups: np.ndarray  # i64[n_lanes]
    n_lanes: int
    n_groups: int
    n_cap: int  # samples per lane
    n_dp: int  # samples per stream
    range_nanos: int


class FanoutCorpus(NamedTuple):
    batch: QueryBatch
    n_unique: int
    grids: list  # per block: (ts i64[n_unique, n_dp], vs f64[n_unique, n_dp])


def fanout_corpus(n_series: int) -> FanoutCorpus:
    """BASELINE config 4 (m3query fan-out read, the reference's
    ``bench.py:bench_fanout_read_device``): ``n_series`` series x 6h of
    10s data in 2h blocks.  The 2,000 seed-42 walks of each block (fewer
    if there are fewer series) are encoded once (stream start = block
    start) and tiled to the lanes: lane l reads unique ``l % 2000`` of
    every block.  Steps every 60s from start+5min to start+6h-10s, range
    5m, groups ``lane % 100``."""
    hours, n_groups = 6, 100
    block = 2 * xtime.HOUR
    n_dp = int(block // (10 * SEC))
    n_blocks = int(hours * xtime.HOUR // block)
    n_unique = min(2000, n_series)
    streams, grids = [], []
    for b in range(n_blocks):
        bs = START + b * block
        ts_u, vs_u = gen_grids(n_unique, n_dp, start=bs - 10 * SEC)
        for u in range(n_unique):
            enc = tsz.Encoder(bs)
            for t, v in zip(ts_u[u].tolist(), vs_u[u].tolist()):
                enc.encode(t, v)
            streams.append(enc.finalize())
        grids.append((ts_u, vs_u))
    uniq_words, uniq_nbits = pack_streams(streams)  # [n_blocks * n_unique, W]
    lane_u = np.arange(n_series, dtype=np.int64) % n_unique
    flat = (np.repeat(lane_u, n_blocks)
            + np.tile(np.arange(n_blocks, dtype=np.int64) * n_unique, n_series))
    steps = np.arange(START + 5 * xtime.MINUTE, START + n_blocks * block - 10 * SEC + 1,
                      60 * SEC, dtype=np.int64)
    batch = QueryBatch(
        words=uniq_words[flat], nbits=uniq_nbits[flat],
        slots=np.repeat(np.arange(n_series, dtype=np.int64), n_blocks), tiers=None,
        n_tiers=1, steps=steps, groups=np.arange(n_series, dtype=np.int64) % n_groups,
        n_lanes=n_series, n_groups=n_groups, n_cap=n_blocks * n_dp, n_dp=n_dp,
        range_nanos=5 * xtime.MINUTE)
    return FanoutCorpus(batch, n_unique, grids)


def _probe_values(kind: int, n: int, rng: np.random.Generator) -> np.ndarray:
    """One block of a probe lane's values."""
    if kind == 0:  # counter with resets
        v = np.cumsum(rng.random(n) * 3)
        for r in rng.choice(n, 2, replace=False):
            v[r:] -= v[r] - rng.random()
        return np.round(v, 3)
    if kind == 1:  # gauge with NaN and +-Inf samples
        v = np.round(rng.standard_normal(n) * 10, 2)
        pick = rng.random(n)
        v[pick < 0.1] = np.nan
        v[(pick >= 0.1) & (pick < 0.13)] = np.inf
        v[(pick >= 0.13) & (pick < 0.15)] = -np.inf
        return v
    if kind == 2:  # signed zeros and small integers
        v = rng.integers(-2, 3, n).astype(np.float64)
        v[v == 0] = np.where(rng.random(int((v == 0).sum())) < 0.5, -0.0, 0.0)
        return v
    if kind == 3:  # counter at 1e9 magnitudes
        return 1e9 + np.cumsum(rng.integers(0, 1000, n)).astype(np.float64)
    if kind == 4:  # all-NaN block
        return np.full(n, np.nan)
    return np.round(np.cumsum(rng.standard_normal(n)), 2)  # float walk


def query_probe_corpus(n_real: int = 11, n_lanes: int = 14, seed: int = 11,
                       tiered: bool = False) -> QueryBatch:
    """A small query batch with one lane per probe (see the module note).

    Lanes ``[0, n_real)`` carry three blocks of 40 samples at 10s,
    ``[n_real, n_lanes)`` are padding lanes: three empty streams park on
    the last lane.  ``n_cap = 120`` (plus the 11 coarse samples the cut
    keeps when tiered), ``n_dp = 40``, range 5m, 4 groups.  Lane 1 steps back in time at its
    second block (unsorted), lane 2 has an extra block (overflow), lane 4
    a stream longer than ``dp`` (truncation), lane 5 keeps three samples
    per block (sparse).  With ``tiered`` every third lane also reads a
    coarser tier (rank 1, 60s samples reaching back before and into the
    fine data; its row comes first), stitched by the tier cut."""
    n_blocks, dp, n_pad_streams, n_groups = 3, 40, 3, 4
    rng = np.random.default_rng(seed)
    rows = []  # (slot, tier, ts list, vs list, stream start)
    for lane in range(n_real):
        kind = lane % 6
        if tiered and lane % 3 == 0:
            t = START + np.arange(-10, 10, dtype=np.int64) * 60 * SEC
            rows.append((lane, 1, t, np.round(rng.random(len(t)) * 50, 1), int(t[0])))
        for b in range(n_blocks + (lane == 2)):
            base = START + b * dp * 10 * SEC
            if lane == 1 and b == 1:
                base -= 25 * 10 * SEC  # block 1 starts before block 0 ends
            n = dp + 2 if (lane == 4 and b == 0) else dp
            t = base + (np.arange(n, dtype=np.int64) + 1) * 10 * SEC
            v = _probe_values(kind, n, rng)
            if lane == 5:
                keep = np.sort(rng.choice(n, 3, replace=False))
                t, v = t[keep], v[keep]
            rows.append((lane, 0, t, v, int(base)))
    for _ in range(n_pad_streams):
        rows.append((n_lanes - 1, 0, None, None, START))
    streams = [b"" if t is None else tsz.encode_series(t.tolist(), v.tolist(), start)
               for _, _, t, v, start in rows]
    words, nbits = pack_streams(streams)
    span = n_blocks * dp * 10 * SEC
    steps = START + np.arange(-1, span // (60 * SEC) + 3, dtype=np.int64) * 60 * SEC
    groups = np.arange(n_lanes, dtype=np.int64) % n_groups
    groups[n_real:] = 0  # padding lanes parked on group 0
    return QueryBatch(
        words=words, nbits=nbits, slots=np.asarray([r[0] for r in rows], dtype=np.int64),
        tiers=np.asarray([r[1] for r in rows], dtype=np.int64) if tiered else None,
        n_tiers=2 if tiered else 1, steps=steps, groups=groups, n_lanes=n_lanes,
        n_groups=n_groups, n_cap=n_blocks * dp + (11 if tiered else 0), n_dp=dp,
        range_nanos=5 * xtime.MINUTE)


def long_lanes(n_cap: int = 32768, seed: int = 13):
    """Merged lanes of ``n_cap`` samples at 10s (32768 is the power of two
    the query engine rounds a raw 10s lane of more than 2.2 days up to):
    ``(times i64[6, n_cap], values f64[6, n_cap], steps i64[S])``.

    Integer values, as the fan-out corpus's walks are, so every running
    sum is exact and any summation order gives the same prefix sums (with
    fractional values two orders differ by an ulp of the running sum,
    which the prefix-difference form turns into a relative error that
    grows with the lane; ROADMAP.md queue 3).  Lanes: an integer walk, a
    counter with resets, a counter at 1e9, the walk with NaN holes and
    +-Inf samples, an all-NaN lane, and the walk filling half of
    ``n_cap`` (INT64_MAX / NaN tail).  Steps every 60s from before the
    first sample to after the last."""
    rng = np.random.default_rng(seed)
    n_lanes = 6
    times = np.full((n_lanes, n_cap), np.iinfo(np.int64).max, dtype=np.int64)
    values = np.full((n_lanes, n_cap), np.nan)
    walk = np.maximum(0, 500 + np.cumsum(rng.integers(-2, 3, n_cap))).astype(np.float64)
    counter = np.cumsum(rng.integers(0, 100, n_cap)).astype(np.float64)
    for r in rng.choice(n_cap, 3, replace=False):
        counter[r:] -= counter[r] - rng.integers(0, 10)
    holes = walk.copy()
    pick = rng.random(n_cap)
    holes[pick < 0.1] = np.nan
    holes[(pick >= 0.1) & (pick < 0.1005)] = np.inf
    holes[(pick >= 0.1005) & (pick < 0.101)] = -np.inf
    half = n_cap // 2
    rows = (walk, counter, 1e9 + np.cumsum(rng.integers(0, 1000, n_cap)), holes,
            np.full(n_cap, np.nan), walk[:half])
    for lane, v in enumerate(rows):
        times[lane, :len(v)] = START + (np.arange(len(v), dtype=np.int64) + 1) * 10 * SEC
        values[lane, :len(v)] = v
    steps = START + np.arange(-1, n_cap // 6 + 3, dtype=np.int64) * 60 * SEC
    return times, values, steps


# --- the write side -------------------------------------------------------


def _reg(n: int, step: int = 10 * SEC, start: int = START) -> list[int]:
    return [start + (i + 1) * step for i in range(n)]


def _from_dods(dods, start: int = START) -> list[int]:
    """Timestamps (seconds) whose delta-of-delta sequence is ``dods``."""
    ts, t, delta = [], start, 0
    for d in dods:
        delta += d
        t += delta * SEC
        ts.append(t)
    return ts


def encode_probe_series() -> list[tuple[list[int], list[float], int]]:
    """(timestamps, values, stream start) per lane: the cases of the
    reference's tests/test_m3tsz_encode_batched.py, each delta-of-delta
    bucket edge, and the points of the golden no-annotation fixture
    (encoder_test.go:204, its backward timestamps included)."""
    out = []
    out.append((_reg(50), [float(x) for x in [5, 5, 6, 7, 7, 100, 3, 0, 1] * 5 + [2.0] * 5]))
    ts, t = [], START
    for d in [10, 10, 12, 80, 80, 400, 400, 3000, 3000, 90000, 10, 10]:
        t += d * SEC
        ts.append(t)
    out.append((ts, [1.0] * len(ts)))
    # every bucket edge: 0, +-(7-bit), +-(9-bit), +-(12-bit) and the default
    edges = [10, 0, 63, -63, 64, -64, -64, 64, -65, 65, 255, -255, 256, -256, -256, 256, -257,
             257, 2047, -2047, 2048, -2048, -2048, 2048, -2049, 2049, 1 << 20, -(1 << 20),
             (1 << 31) - 1, -((1 << 31) - 1)]
    out.append((_from_dods(edges), [float(i % 7) for i in range(len(edges))]))
    rng = random.Random(7)
    out.append((_reg(40), [rng.uniform(0, 1) for _ in range(40)]))
    out.append((_reg(12), [1.0, 2.0, 0.5, 0.5, 3.0, 3.25, 4.0, 4.0, 1e-8, 7.0, 7.0, 0.1]))
    out.append((_reg(10), [1.5, 2.5, 3.25, 10.125, 0.5, 0.05, 0.005, 1.0, 2.0, 0.123]))
    vs, v = [], 0.0
    for i in range(30):
        v += 1000.0 if i < 5 else (1.0 if i < 20 else 5000.0)
        vs.append(v)
    out.append((_reg(30), vs))
    out.append((_reg(20), [42.0] * 20))
    out.append((_reg(12), [-5.0, -5.0, -100.0, 1e12, 1e12 + 1, -1e12, 0.0, 2.0**52, -(2.0**52),
                           1.0, -1.0, 0.0]))
    out.append((_reg(6), [1.0, math.nan, 2.0, math.nan, math.nan, 3.0]))
    inf = math.inf
    for vs in ([-inf, 1.0, inf, 2.0], [inf, -inf, inf, inf], [1.0, 2.0, -inf, 3.0]):
        out.append((_reg(len(vs)), vs))
    out.append((_reg(8), [1e14, 1e14 + 2, 5e15, 1e30, 1e14, 2.0, 2.0, 3.0]))
    out.append((_reg(7), [-0.0, 0.0, -0.0, 1.0, -0.0, 0.5, -0.0]))
    rng = random.Random(3)
    for n in [1, 2, 5, 17, 40]:
        out.append((_reg(n), [float(rng.randint(-50, 50)) for _ in range(n)]))
    out.append(([], []))
    for seed in range(3):
        rng = random.Random(seed)
        for _ in range(16):
            n = rng.randint(1, 60)
            t, ts = START, []
            for _ in range(n):
                t += rng.choice([1, 10, 10, 10, 60, 3600, 100000]) * SEC
                ts.append(t)
            kind = rng.random()
            if kind < 0.4:
                v, vs = float(rng.randint(0, 100)), []
                for _ in range(n):
                    v += rng.choice([-3, -1, 0, 0, 1, 3, 1000])
                    vs.append(float(v))
            elif kind < 0.7:
                vs = [round(rng.uniform(-10, 10), rng.randint(0, 6)) for _ in range(n)]
            else:
                vs = [rng.choice([rng.uniform(-1e9, 1e9), math.pi * rng.random(), 0.0, 1e-12])
                      for _ in range(n)]
            out.append((ts, vs))
    golden_start, t0 = 1427162400 * SEC, 1427162462 * SEC
    out = [(ts, vs, START) for ts, vs in out]
    out.append(([t0 + d * SEC for d in (0, 60, 120, -76, -16, 2092, 4200)],
                [12.0, 12.0, 24.0, 24.0, 24.0, 15.0, 12.0], golden_start))
    return out


# deltas-of-delta (seconds) on each side of every time-field bucket edge
PACK_EDGE_DODS = (0, 1, -1, 63, -63, 64, -64, -65, 255, -255, 256, -256, -257, 2047, -2047,
                  2048, -2048, -2049, 1 << 20, -(1 << 20), (1 << 31) - 1, -((1 << 31) - 1))
PACK_EDGE_STEPS = (1, 31, 32, 33, 65)  # around E1's 32-step chunks


def pack_edge_fields(n_steps: int, n_lanes: int = 24, seed: int = 13):
    """``pack_encode``'s arguments as numpy arrays (ts i64[L, T], start
    i64[L], n_valid i32[L], ctl_bits and pay_bits as int64 bit patterns,
    ctl_n and pay_n i32[L, T]) around the kernel's edges: lane 0 has no
    valid point, lane 1 one, lane 2 all; the others a random count.  Each
    lane's deltas-of-delta cycle through ``PACK_EDGE_DODS`` from its own
    offset, a few with a sub-second part (the unit division truncates);
    control fields of 0-17 bits, payloads of 0-64 bits with 64 and 0
    common, and random bits above each width."""
    rng = np.random.default_rng((seed, n_steps))
    L, T = n_lanes, n_steps
    dods = np.asarray(PACK_EDGE_DODS, dtype=np.int64)
    pick = (np.arange(T)[None, :] + rng.integers(0, len(dods), (L, 1))) % len(dods)
    dod = dods[pick] * SEC
    frac = rng.random((L, T)) < 0.1
    dod[frac] += rng.integers(-SEC + 1, SEC, int(frac.sum()))
    delta = np.cumsum(dod, axis=1) + 10 * SEC
    start = START + rng.integers(0, 100, L).astype(np.int64) * SEC
    ts = start[:, None] + np.cumsum(delta, axis=1)
    n_valid = rng.integers(0, T + 1, L).astype(np.int32)
    n_valid[:3] = (0, min(1, T), T)
    ctl_n = rng.integers(0, 18, (L, T)).astype(np.int32)
    pay_n = np.where(rng.random((L, T)) < 0.3, 64,
                     np.where(rng.random((L, T)) < 0.2, 0, rng.integers(1, 65, (L, T))))
    bits = lambda: rng.integers(np.iinfo(np.int64).min, np.iinfo(np.int64).max, (L, T),  # noqa: E731
                                dtype=np.int64, endpoint=True)
    return ts, start, n_valid, bits(), ctl_n, bits(), pay_n.astype(np.int32)


def encode_batch(series):
    """Left-aligned [L, T] batch of (timestamps, values, start) lanes, as
    the reference's tests pad it (with the lane's last timestamp):
    (ts i64[L, T], vs f64[L, T], start i64[L], n_valid i32[L])."""
    L = len(series)
    T = max(1, max(len(s[0]) for s in series))
    ts = np.zeros((L, T), dtype=np.int64)
    vs = np.zeros((L, T), dtype=np.float64)
    start = np.zeros(L, dtype=np.int64)
    n_valid = np.zeros(L, dtype=np.int32)
    for i, (t, v, st) in enumerate(series):
        ts[i, :len(t)] = t
        vs[i, :len(v)] = v
        ts[i, len(t):] = t[-1] if t else st
        start[i], n_valid[i] = st, len(t)
    return ts, vs, start, n_valid


def ragged_block(n_lanes: int, max_count: int, seed: int = 11):
    """A sealed block's columnar points, lanes sorted: lane l holds 1 to
    ``max_count`` points at 10s or 30s steps (integer values 70% of the
    time, decimals otherwise).  Returns (lanes i64, times i64, values f64)."""
    rng = np.random.default_rng(seed)
    counts = rng.integers(1, max_count + 1, n_lanes)
    lanes = np.repeat(np.arange(n_lanes, dtype=np.int64), counts)
    steps = rng.choice(np.asarray([10, 10, 30], dtype=np.int64), len(lanes)) * SEC
    first = np.concatenate(([0], np.cumsum(counts)[:-1]))
    csum = np.cumsum(steps)
    times = START + csum - np.repeat(csum[first] - steps[first], counts)
    values = np.where(rng.random(len(lanes)) < 0.7, rng.integers(-20, 21, len(lanes)),
                      np.round(rng.random(len(lanes)) * 5, 3)).astype(np.float64)
    return lanes, times, values


_ELEM_SPECIALS = np.asarray([np.nan, np.inf, -np.inf, 0.0, -0.0])


def elem_probe_batches(n_slots: int = 64, n: int = 256, n_batches: int = 6, seed: int = 5,
                       resolution: int = 10 * SEC):
    """Ingest batches for the slot kernels over ``n_slots`` slots:
    [(flat i64[n], start i64[n], times i64[n], values f64[n])].  Batch k
    writes windows k-1, k and k+1 (stale samples and epoch overwrites),
    times at one of three seconds of the window (ties at the greatest
    time, and samples at the time a slot already holds), small integers
    with NaN/+-Inf/+-0.0 mixed in, and the last four slots all NaN."""
    rng = np.random.default_rng(seed)
    out = []
    for k in range(n_batches):
        flat = rng.integers(0, n_slots, n)
        window = k + rng.choice(np.asarray([-1, 0, 0, 0, 1]), n)
        start = START + window * resolution
        times = start + rng.integers(0, 3, n) * SEC
        values = np.round(rng.standard_normal(n) * 4)
        pick = rng.random(n) < 0.3
        values[pick] = rng.choice(_ELEM_SPECIALS, int(pick.sum()))
        values[flat >= n_slots - 4] = np.nan
        out.append((flat.astype(np.int64), start.astype(np.int64), times.astype(np.int64),
                    values))
    return out


def quantile_probes(seed: int = 9) -> list[tuple[np.ndarray, np.ndarray]]:
    """Padded (values, weights) matrices for ``padded_quantiles``: rows of
    1 to K real points padded with +inf (weight 0), NaN and real +inf
    (weight > 0) samples, ties, +-0.0, power-of-two weights 1 to 64, rows
    of total 0; [24, 12] and [5, 1] (K = 1)."""
    rng = np.random.default_rng(seed)
    out = []
    for F, K in ((24, 12), (5, 1)):
        v = np.round(rng.standard_normal((F, K)) * 3)
        pick = rng.random((F, K))
        v[pick < 0.1] = np.nan
        v[(pick >= 0.1) & (pick < 0.15)] = np.inf
        v[(pick >= 0.15) & (pick < 0.2)] = -np.inf
        v[(pick >= 0.2) & (pick < 0.35)] = -0.0
        w = 2.0 ** rng.integers(0, 7, (F, K))
        n_real = rng.integers(1, K + 1, F)
        for r in range(F):
            v[r, n_real[r]:] = np.inf
            w[r, n_real[r]:] = 0.0
        w[0] = 0.0  # total 0
        if F > 1:
            w[1, 1:] = 0.0  # one weighted point and zero-weight real ones
        out.append((v, w))
    return out


def long_quantile_rows(rows: int, k: int, seed: int = 10):
    """``rows`` fully populated rows of ``k`` weighted points (weights 1 to
    64, ties from rounding, a NaN and a +inf per row): the hot timer
    slots of a compacted reservoir."""
    rng = np.random.default_rng(seed)
    v = np.round(rng.lognormal(3, 1, (rows, k)), 1)
    v[:, 0] = np.nan
    v[:, 1] = np.inf
    return v, 2.0 ** rng.integers(0, 7, (rows, k))


QUANTILE_TIER_KS = (1, 2, 16, 17, 32, 33, 8193)  # A1c's tier edges; 8,193 sorts in global scratch


def quantile_tier_probes(seed: int = 12) -> list[tuple[np.ndarray, np.ndarray]]:
    """(values, weights) of ``padded_quantiles`` at each K of
    ``QUANTILE_TIER_KS`` (8 rows a shape, 3 for the longest): ties,
    -0.0 and +0.0, NaN and real +-inf with weight, power-of-two weights
    1 to 64 (exact running sums), rows of 1 to K real points padded with
    +inf of weight 0; row 0 is all padding and row 1 has total 0."""
    rng = np.random.default_rng(seed)
    out = []
    for K in QUANTILE_TIER_KS:
        F = 3 if K > 1000 else 8
        v = np.round(rng.standard_normal((F, K)) * 4)
        pick = rng.random((F, K))
        v[pick < 0.08] = np.nan
        v[(pick >= 0.08) & (pick < 0.12)] = np.inf
        v[(pick >= 0.12) & (pick < 0.16)] = -np.inf
        v[(pick >= 0.16) & (pick < 0.3)] = -0.0
        v[(pick >= 0.3) & (pick < 0.4)] = 0.0
        w = 2.0 ** rng.integers(0, 7, (F, K))
        n_real = rng.integers(1, K + 1, F)
        n_real[2] = K
        for r in range(F):
            v[r, n_real[r]:] = np.inf
            w[r, n_real[r]:] = 0.0
        v[0], w[0] = np.inf, 0.0
        w[1] = 0.0
        out.append((v, w))
    return out


def rollup_rounds(n_lanes: int, n_rounds: int, seed: int = 42):
    """The values of the reference's ``bench.py:bench_rollup_flush``: one
    ``rng.random(n_lanes) * 100`` per round, from ``default_rng(seed)``."""
    rng = np.random.default_rng(seed)
    return [rng.random(n_lanes) * 100 for _ in range(n_rounds)]


def timer_windows(n_windows: int, per_window: int, seed: int = 21):
    """Timer samples: ``per_window`` samples evenly spaced in the 10s
    window at START (1s apart for 10) of each of ``n_windows`` lanes,
    lognormal latencies in ms.  Returns (lanes i64, times i64, values
    f64), window-major."""
    rng = np.random.default_rng(seed)
    lanes = np.repeat(np.arange(n_windows, dtype=np.int64), per_window)
    step = 10 * SEC // per_window
    times = START + np.tile(np.arange(per_window, dtype=np.int64), n_windows) * step
    return lanes, times, np.round(rng.lognormal(3, 1, n_windows * per_window), 3)


CONFIG2_START = START - START % xtime.MINUTE  # the minute START falls in


def config2_batch(n_series: int, window: int, batch: int, seed: int = 2):
    """One 10s ingest batch of BASELINE config 2 ("m3aggregator 100k
    counter+gauge series, 10s -> 1m mean/sum rollup flush"): series
    2i are counters (``counter.<i>``, integer increments), series 2i+1
    gauges (``gauge.<i>``, decimals), one sample each at
    CONFIG2_START + window*60s + batch*10s + 5s.  Returns (kinds i64
    1=counter, 3=gauge; ids list[bytes]; values f64; time)."""
    rng = np.random.default_rng((seed, window, batch))
    kinds = np.where(np.arange(n_series) % 2 == 0, 1, 3)
    ids = [(b"counter.%d" if i % 2 == 0 else b"gauge.%d") % (i // 2) for i in range(n_series)]
    values = np.where(kinds == 1, rng.integers(0, 100, n_series),
                      np.round(rng.random(n_series) * 100, 2)).astype(np.float64)
    return kinds, ids, values, CONFIG2_START + window * 60 * SEC + batch * 10 * SEC + 5 * SEC


# --- the fused expression interpreter ---------------------------------------

INT64_MAX = np.iinfo(np.int64).max


def bucket_pow2(n: int, floor: int) -> int:
    """The planner's power-of-two shape quantizer (``m3_tpu/query/plan.py:
    _bucket_pow2``): the smallest power of two >= max(n, floor)."""
    n = max(int(n), int(floor))
    return 1 << (n - 1).bit_length()


class PlanNode(NamedTuple):
    plan: tuple  # the node in the reference's plan grammar
    labels: list  # one label dict per real row
    rows_pad: int  # rows of the node's matrix, padding included


def _key(labels: dict, by) -> tuple:
    return tuple((k, labels.get(k)) for k in by)


class ExprPlanBuilder:
    """Builds one query's plan with its numpy ``leaves`` and ``params``,
    as ``m3_tpu/query/plan.py:run_sym`` lays them out, but by hand: the
    caller names the nodes and their label matching.  ``steps`` is the
    real step grid; it is padded to ``bucket_pow2(S, 64)`` steps with the
    last one repeated.  Leaves carry no offset, so each leaf's steps are
    the outer ones (inside ``subq``, the subquery's inner grid).
    ``inputs()`` returns (leaves, params, steps)."""

    def __init__(self, steps):
        steps = np.asarray(steps, dtype=np.int64)
        self.n_steps = len(steps)
        self.s_pad = bucket_pow2(len(steps), 64)
        self.steps = np.full(self.s_pad, steps[-1], dtype=np.int64)
        self.steps[:len(steps)] = steps
        self.leaves: list[dict] = []
        self.params: list[tuple] = []
        self._statics: list[tuple] = []
        self._labels: list[list] = []

    def _param(self, p: tuple) -> int:
        self.params.append(p)
        return len(self.params) - 1

    def words_leaf(self, words, nbits, slots, labels, n_dp: int, n_cap: int, rng: int,
                   m_pad: int | None = None) -> int:
        """A compressed leaf: streams (rows of ``words``/``nbits``) grouped
        by output lane ``slots``, one label dict per lane, lanes padded to
        the planner's ``bucket_pow2(n_lanes, 64)``; ``m_pad`` streams
        (default: as many as there are) with the padding streams (nbits 0)
        parked on the last lane, given a spare lane if needed."""
        n_lanes, M = len(labels), len(nbits)
        lanes_pad = bucket_pow2(n_lanes, 64)
        m_pad = M if m_pad is None else m_pad
        if m_pad > M and lanes_pad == n_lanes:
            lanes_pad = bucket_pow2(n_lanes + 1, 64)
        words_p = np.zeros((m_pad, words.shape[1]), dtype=np.uint32)
        words_p[:M] = words
        nbits_p = np.zeros(m_pad, dtype=np.int32)
        nbits_p[:M] = nbits
        slots_p = np.full(m_pad, lanes_pad - 1, dtype=np.int64)
        slots_p[:M] = slots
        self.leaves.append({
            "words": words_p, "nbits": nbits_p, "slots": slots_p,
            "tiers": np.zeros(m_pad, dtype=np.int64), "steps": self.steps.copy(),
            "rng": np.int64(rng), "valid": np.arange(lanes_pad) < n_lanes})
        self._statics.append(("words", (lanes_pad, n_cap, n_dp, 1, m_pad, words.shape[1],
                                        self.s_pad)))
        self._labels.append(list(labels))
        return len(self.leaves) - 1

    def words_leaf_from_series(self, series, labels, rng: int,
                               block: int = 30 * xtime.MINUTE) -> int:
        """``words_leaf`` of (times, values) per lane, encoded in blocks of
        ``block`` (one stream per non-empty block); n_dp, n_cap and the
        stream count are the planner's buckets (powers of two, at least
        128, 128 and 64)."""
        streams, slots, counts = [], [], []
        per_lane = np.zeros(len(series), dtype=np.int64)
        for lane, (t, v) in enumerate(series):
            t, v = np.asarray(t, dtype=np.int64), np.asarray(v, dtype=np.float64)
            starts = t - t % block
            for bs in np.unique(starts):
                m = starts == bs
                streams.append(tsz.encode_series(t[m].tolist(), v[m].tolist(), int(bs)))
                slots.append(lane)
                counts.append(int(m.sum()))
            per_lane[lane] = len(t)
        words, nbits = pack_streams(streams)
        return self.words_leaf(words, nbits, np.asarray(slots, dtype=np.int64), labels,
                               bucket_pow2(max(counts), 128), bucket_pow2(per_lane.max(), 128),
                               rng, m_pad=bucket_pow2(len(streams), 64))

    def arrays_leaf(self, times, values, labels, rng: int) -> int:
        """A decoded leaf (the decoded-block cache's bridge): merged lanes
        ``times i64[n, n_cap]`` (INT64_MAX-padded) and ``values`` of the n
        labelled lanes, padded to ``bucket_pow2(n, 64)`` lanes.  Tensors
        that already hold the padded lanes (a decode's output) are kept as
        they are."""
        n_lanes, n_cap = len(labels), times.shape[1]
        lanes_pad = bucket_pow2(n_lanes, 64)
        if isinstance(times, torch.Tensor):
            if times.shape[0] != lanes_pad or values.shape != times.shape:
                raise ValueError(f"tensor lanes must come padded to {lanes_pad} rows")
            t, v = times, values
        else:
            t = np.full((lanes_pad, n_cap), INT64_MAX, dtype=np.int64)
            v = np.full((lanes_pad, n_cap), np.nan)
            t[:n_lanes], v[:n_lanes] = times, values
        self.leaves.append({"times": t, "values": v, "steps": self.steps.copy(),
                            "rng": np.int64(rng), "valid": np.arange(lanes_pad) < n_lanes})
        self._statics.append(("arrays", (lanes_pad, n_cap, 0, 1, 0, 0, self.s_pad)))
        self._labels.append(list(labels))
        return len(self.leaves) - 1

    def leaf(self, idx: int, fn: str, horizon: float = 0.0, phi: float = 0.5,
             hw_sf: float = 0.5, hw_tf: float = 0.5) -> PlanNode:
        kind, statics = self._statics[idx]
        pidx = self._param((np.float64(horizon), np.float64(phi)))
        plan = ("leaf", idx, pidx, kind, fn) + statics + (hw_sf, hw_tf)
        return PlanNode(plan, self._labels[idx], statics[0])

    def agg(self, op: str, child: PlanNode, by=(), phi: float = 0.5) -> PlanNode:
        """``op by (by) (child)``: groups sorted by key, g_pad =
        bucket_pow2(groups, 8), padding rows parked on group 0."""
        keys = [_key(ls, by) for ls in child.labels]
        uniq = sorted(set(keys))
        group_of = {k: i for i, k in enumerate(uniq)}
        g_pad = bucket_pow2(max(len(uniq), 1), 8)
        groups = np.zeros(child.rows_pad, dtype=np.int64)
        groups[:len(keys)] = [group_of[k] for k in keys]
        pidx = self._param((groups, np.arange(g_pad) < len(uniq), np.float64(phi)))
        return PlanNode(("agg", op, g_pad, pidx, child.plan), [dict(k) for k in uniq], g_pad)

    def call(self, fn: str, child: PlanNode, extras=()) -> PlanNode:
        pidx = self._param(tuple(np.float64(e) for e in extras))
        return PlanNode(("call", fn, pidx, child.plan), child.labels, child.rows_pad)

    def vs(self, op: str, child: PlanNode, scalar: float, bool_mod: bool = False,
           mat_on_left: bool = True) -> PlanNode:
        pidx = self._param((np.float64(scalar),))
        return PlanNode(("vs", op, bool_mod, mat_on_left, pidx, child.plan), child.labels,
                        child.rows_pad)

    def vv(self, op: str, lhs: PlanNode, rhs: PlanNode, on=None, group_left: bool = False,
           bool_mod: bool = False) -> PlanNode:
        """``lhs op on(on) rhs`` (``on`` None: all labels), one-to-one, or
        many-to-one with ``group_left``; output rows in lhs order."""
        def key(ls):
            return tuple(sorted(ls.items())) if on is None else _key(ls, on)
        right = {}
        for j, ls in enumerate(rhs.labels):
            right.setdefault(key(ls), j)
        pairs = [(i, right[key(ls)]) for i, ls in enumerate(lhs.labels) if key(ls) in right]
        if not group_left:
            seen = [key(lhs.labels[i]) for i, _ in pairs]
            if len(set(seen)) != len(seen):
                raise ValueError("many-to-one match needs group_left")
        n_out = len(pairs)
        out_pad = bucket_pow2(max(n_out, 1), 8)
        lidx = np.zeros(out_pad, dtype=np.int64)
        ridx = np.zeros(out_pad, dtype=np.int64)
        lidx[:n_out] = [i for i, _ in pairs]
        ridx[:n_out] = [j for _, j in pairs]
        pidx = self._param((lidx, ridx, np.arange(out_pad) < n_out))
        labels = [lhs.labels[i] for i, _ in pairs]
        return PlanNode(("vv", op, bool_mod, out_pad, pidx, lhs.plan, rhs.plan), labels,
                        out_pad)

    def topk(self, op: str, k: int, child: PlanNode, by=()) -> PlanNode:
        """topk/bottomk: padding rows on a trash group of their own, the
        last of g_pad = bucket_pow2(groups + 1, 8)."""
        keys = [_key(ls, by) for ls in child.labels]
        uniq = sorted(set(keys))
        group_of = {k: i for i, k in enumerate(uniq)}
        g_pad = bucket_pow2(len(uniq) + 1, 8)
        groups = np.full(child.rows_pad, g_pad - 1, dtype=np.int64)
        groups[:len(keys)] = [group_of[kk] for kk in keys]
        pidx = self._param((groups,))
        return PlanNode(("topk", op, k, g_pad, pidx, child.plan), child.labels, child.rows_pad)

    def hq(self, phi: float, child: PlanNode) -> PlanNode:
        """histogram_quantile(phi, child): rows grouped on their labels
        other than ``le``, buckets sorted by (upper bound, row); groups of
        fewer than 2 buckets or without a +Inf top are skipped; the bucket
        axis is padded by repeating the top row; caps = the highest finite
        bound."""
        groups: dict = {}
        for i, ls in enumerate(child.labels):
            if "le" in ls:
                gkey = tuple(sorted((k, v) for k, v in ls.items() if k != "le"))
                groups.setdefault(gkey, []).append((float(ls["le"]), i))
        out_labels, rows_g, ubs_g = [], [], []
        for gkey, buckets in sorted(groups.items()):
            buckets.sort()
            ubs = [b[0] for b in buckets]
            if len(ubs) < 2 or not math.isinf(ubs[-1]):
                continue
            out_labels.append(dict(gkey))
            rows_g.append([b[1] for b in buckets])
            ubs_g.append(ubs)
        g_pad = bucket_pow2(len(out_labels), 8)
        b_pad = bucket_pow2(max(len(r) for r in rows_g), 8)
        rows_idx = np.zeros((g_pad, b_pad), dtype=np.int64)
        ubs_p = np.full((g_pad, b_pad), np.inf)
        caps = np.zeros(g_pad)
        for g, (rows, ubs) in enumerate(zip(rows_g, ubs_g)):
            rows_idx[g, :len(rows)] = rows
            rows_idx[g, len(rows):] = rows[-1]
            ubs_p[g, :len(ubs)] = ubs
            caps[g] = ubs[-2]
        pidx = self._param((rows_idx, ubs_p, caps, np.arange(g_pad) < len(out_labels),
                            np.float64(phi)))
        return PlanNode(("hq", g_pad, b_pad, pidx, child.plan), out_labels, g_pad)

    def subq(self, fn: str, child, sub_step: int, rng: int, horizon: float = 0.0,
             hw_sf: float = 0.5, hw_tf: float = 0.5) -> PlanNode:
        """``fn(<child>[rng:sub_step])`` at the outer steps, the grid laid
        out as ``m3_tpu/query/plan.py:832-865`` does (no offset): inner
        steps at the multiples of ``sub_step`` in [first step - rng, last
        step], padded to ``bucket_pow2(n, 64)`` with the last one (padding
        invalid).  ``child`` is a callable that builds the inner expression
        on this builder; the leaves it adds take the inner grid as their
        steps."""
        shifted = self.steps[:self.n_steps]
        lo, hi = int(shifted[0]) - rng, int(shifted[-1])
        first = lo - lo % sub_step + (sub_step if lo % sub_step else 0)
        sub_times = np.arange(first, hi + 1, sub_step, dtype=np.int64)
        if len(sub_times) == 0:
            sub_times = np.asarray([hi], dtype=np.int64)
        s_in_pad = bucket_pow2(len(sub_times), 64)
        sub_p = np.full(s_in_pad, sub_times[-1], dtype=np.int64)
        sub_p[:len(sub_times)] = sub_times
        steps_out = np.full(self.s_pad, shifted[-1], dtype=np.int64)
        steps_out[:len(shifted)] = shifted
        outer = self.steps, self.s_pad
        self.steps, self.s_pad = sub_p, s_in_pad
        try:
            inner = child(self)
        finally:
            self.steps, self.s_pad = outer
        pidx = self._param((sub_p, np.arange(s_in_pad) < len(sub_times), steps_out,
                            np.int64(rng), np.float64(horizon)))
        return PlanNode(("subq", fn, s_in_pad, hw_sf, hw_tf, pidx, inner.plan), inner.labels,
                        inner.rows_pad)

    def absent(self, child: PlanNode) -> PlanNode:
        avalid = np.zeros(8, dtype=bool)
        avalid[0] = True
        return PlanNode(("absent", self._param((avalid,)), child.plan), [{}], 8)

    # The graphite nodes, laid out as m3_tpu/query/plan.py:864-922 does; the
    # caller computes the selection and grouping from the labels, as the
    # lowering's select_fn / group_fn do.

    def gsel(self, child: PlanNode, keep, labels=None) -> PlanNode:
        """Rows ``keep`` of ``child`` in that order (a graphite path-depth
        filter, sort, limit, exclude or grep), out_pad = bucket_pow2(n, 8);
        ``labels`` default to the kept rows' own."""
        keep = [int(i) for i in keep]
        out_pad = bucket_pow2(max(len(keep), 1), 8)
        idx = np.zeros(out_pad, dtype=np.int64)
        idx[:len(keep)] = keep
        pidx = self._param((idx, np.arange(out_pad) < len(keep)))
        labels = [child.labels[i] for i in keep] if labels is None else list(labels)
        return PlanNode(("gsel", out_pad, pidx, child.plan), labels, out_pad)

    def gagg(self, op: str, child: PlanNode, groups, labels, extra=(),
             tval: float = 0.0) -> PlanNode:
        """A graphite combiner or grouped aggregate: ``groups`` gives each
        real row's group id, ``labels`` one dict per group; g_pad =
        bucket_pow2(groups, 8), padding rows parked on group 0; ``extra``
        the static per-op tuple (percentile's q), ``tval`` countSeries'
        constant."""
        n_groups = len(labels)
        g_pad = bucket_pow2(max(n_groups, 1), 8)
        groups_p = np.zeros(child.rows_pad, dtype=np.int64)
        groups_p[:len(groups)] = groups
        pidx = self._param((groups_p, np.arange(g_pad) < n_groups, np.float64(tval)))
        return PlanNode(("gagg", op, tuple(extra), g_pad, pidx, child.plan), list(labels),
                        g_pad)

    def gcall(self, fn: str, child: PlanNode, statics=(), fparams=(), labels=None) -> PlanNode:
        """A graphite per-series transform: the plan's statics are
        (real steps,) + ``statics`` (window widths, bucket sizes, summarize's
        func, percentile's q, delay's k); ``fparams`` the numpy scalars the
        call reads at run time (float64, timeSlice's int64 bounds)."""
        pidx = self._param(tuple(fparams))
        return PlanNode(("gcall", fn, (self.n_steps,) + tuple(statics), pidx, child.plan),
                        child.labels if labels is None else list(labels), child.rows_pad)

    def shard_even(self, idx: int, n_shards: int) -> None:
        """Re-lay words leaf ``idx`` shard-even for a series-sharded run, as
        the reference's engine does (``parallel/repack.shard_repack``: equal
        lanes and stream rows a shard, slots LOCAL to their shard); the
        plan nodes built from it afterwards take the new lane and row
        counts."""
        lf = self.leaves[idx]
        kind, statics = self._statics[idx]
        n_real = int((lf["slots"] < lf["valid"].sum()).sum())
        pk = shard_repack({"words": lf["words"], "nbits": lf["nbits"], "slots": lf["slots"],
                           "tiers": lf["tiers"], "n_streams": n_real,
                           "lanes_pad": statics[0]}, n_shards)
        lanes_pad = pk["lanes_pad"]
        self.leaves[idx] = {**lf, "words": pk["words"], "nbits": pk["nbits"],
                            "slots": pk["slots"], "tiers": pk["tiers"],
                            "valid": np.arange(lanes_pad) < int(lf["valid"].sum())}
        self._statics[idx] = (kind, (lanes_pad, statics[1], statics[2], 1, len(pk["nbits"]),
                                     pk["words"].shape[1], statics[6]))

    def inputs(self):
        return self.leaves, tuple(self.params), self.steps


def graphite_labels(paths) -> list[dict]:
    """Graphite series labels as the coordinator stores them: ``__name__``
    the dotted path and ``__g<i>__`` its i-th component (bytes, as the
    reference's graphite tier keys them)."""
    out = []
    for path in paths:
        ls = {b"__name__": path.encode()}
        ls.update({b"__g%d__" % i: c.encode() for i, c in enumerate(path.split("."))})
        out.append(ls)
    return out


def stack_queries(queries):
    """Q queries' (leaves, params, steps) of one plan, stacked on a
    leading [Q] axis as the reference's megabatch scheduler stacks them."""
    leaves = [{k: np.stack([q[0][i][k] for q in queries]) for k in queries[0][0][i]}
              for i in range(len(queries[0][0]))]
    params = tuple(tuple(np.stack([q[1][p][j] for q in queries])
                         for j in range(len(queries[0][1][p])))
                   for p in range(len(queries[0][1])))
    return leaves, params, np.stack([q[2] for q in queries])


def minmax_probe_lanes(n_cap: int = 192, seed: int = 17):
    """Merged lanes for min/max_over_time: ``(times i64[8, n_cap], values,
    steps i64[S])`` at 10s.  Lanes: a walk; the walk with NaN holes and
    +-Inf samples; random +-0.0 with NaN holes (windows holding both
    zeros, inside one 32-sample block at a 93s range and across blocks at
    10m); only -0.0; negatives with -0.0; an all-NaN lane; a sparse lane
    (empty and one-sample windows); a short lane (INT64_MAX / NaN tail).
    Steps every 60s from before the first sample to after the last."""
    rng = np.random.default_rng(seed)
    n_lanes = 8
    times = np.full((n_lanes, n_cap), INT64_MAX, dtype=np.int64)
    values = np.full((n_lanes, n_cap), np.nan)
    walk = np.round(np.cumsum(rng.standard_normal(n_cap)) * 3, 1)
    holes = walk.copy()
    pick = rng.random(n_cap)
    holes[pick < 0.15] = np.nan
    holes[(pick >= 0.15) & (pick < 0.2)] = np.inf
    holes[(pick >= 0.2) & (pick < 0.25)] = -np.inf
    zeros = np.where(rng.random(n_cap) < 0.5, -0.0, 0.0)
    zeros[rng.random(n_cap) < 0.1] = np.nan
    negs = -rng.integers(0, 3, n_cap).astype(np.float64)
    negs[negs == 0] = -0.0
    rows = (walk, holes, zeros, np.full(n_cap, -0.0), negs, np.full(n_cap, np.nan))
    for lane, v in enumerate(rows):
        times[lane] = START + (np.arange(n_cap, dtype=np.int64) + 1) * 10 * SEC
        values[lane] = v
    keep = np.sort(rng.choice(n_cap, n_cap // 12, replace=False))
    times[6, :len(keep)] = START + (keep + 1) * 10 * SEC
    values[6, :len(keep)] = walk[keep]
    half = n_cap // 2
    times[7, :half] = START + (np.arange(half, dtype=np.int64) + 1) * 10 * SEC
    values[7, :half] = zeros[:half]
    steps = START + np.arange(-1, n_cap // 6 + 3, dtype=np.int64) * 60 * SEC
    return times, values, steps


def temporal_probe_lanes(n_cap: int = 192, seed: int = 37):
    """Merged lanes for stddev/stdvar, changes/resets, deriv/predict_linear,
    holt_winters and quantile_over_time: ``(times i64[8, n_cap], values,
    steps i64[S])`` at 10s.  Lanes: a walk with 30% NaN holes; an all-NaN
    lane; a sparse lane (6% of the samples: windows at the 2-sample edge);
    1.5e9 + N(0, 1) rounded to 1e-3 (the cancellation canary of the
    reference's ``tests/test_query_pipeline_device.py:325``); the walk with
    NaN, +Inf and -Inf samples; -1, -0.0, +0.0 and 1 with runs of repeats;
    a counter with resets; a short lane (INT64_MAX / NaN tail).  Steps
    every 60s from before the first sample to after the last."""
    rng = np.random.default_rng(seed)
    n_lanes = 8
    times = np.full((n_lanes, n_cap), INT64_MAX, dtype=np.int64)
    values = np.full((n_lanes, n_cap), np.nan)
    walk = np.round(np.cumsum(rng.standard_normal(n_cap)) * 3, 2)
    holes = np.where(rng.random(n_cap) < 0.3, np.nan, walk)
    sparse = np.where(rng.random(n_cap) < 0.06, walk, np.nan)
    canary = 1.5e9 + np.round(rng.standard_normal(n_cap), 3)
    infs = walk.copy()
    pick = rng.random(n_cap)
    infs[pick < 0.1] = np.nan
    infs[(pick >= 0.1) & (pick < 0.13)] = np.inf
    infs[(pick >= 0.13) & (pick < 0.16)] = -np.inf
    zeros = np.repeat(rng.choice([-1.0, -0.0, 0.0, 1.0], n_cap), rng.integers(1, 4, n_cap))[:n_cap]
    counter = np.cumsum(rng.integers(0, 50, n_cap)).astype(np.float64)
    for r in rng.choice(n_cap, 3, replace=False):
        counter[r:] -= counter[r] - rng.integers(0, 10)
    rows = (holes, np.full(n_cap, np.nan), sparse, canary, infs, zeros, counter)
    for lane, v in enumerate(rows):
        times[lane] = START + (np.arange(n_cap, dtype=np.int64) + 1) * 10 * SEC
        values[lane] = v
    half = n_cap // 2
    times[7, :half] = START + (np.arange(half, dtype=np.int64) + 1) * 10 * SEC
    values[7, :half] = walk[:half]
    steps = START + np.arange(-1, n_cap // 6 + 3, dtype=np.int64) * 60 * SEC
    return times, values, steps


# Windows of quantile_width_lanes: samples every 10s and steps on sample
# times, so a range of w * 10s - 1ns holds w samples (a window takes both of
# its ends).
QUANTILE_WIDTHS = (1, 31, 32, 33, 64, 300)


def quantile_width_range(width: int) -> int:
    """The range whose windows hold ``width`` samples of
    ``quantile_width_lanes``."""
    return width * 10 * SEC - 1


def quantile_width_lanes(seed: int = 47):
    """Lanes for quantile_over_time at the window widths ``QUANTILE_WIDTHS``:
    ``(times i64[6, 420], values, steps i64[S])`` at 10s.  Lanes: +-0.0 and
    +-1 in runs (ties at the selected ranks), an all-NaN lane, a walk with
    NaN holes and +-Inf, integers -2..2 with +-0.0, values a few ulps
    apart, and a short lane (INT64_MAX / NaN tail); steps every 60s from
    before the first sample to past the last window of the widest range,
    so windows are empty at both ends."""
    rng = np.random.default_rng(seed)
    n = 420
    t = np.full((6, n), INT64_MAX, dtype=np.int64)
    v = np.full((6, n), np.nan)
    grid = START + (np.arange(n, dtype=np.int64) + 1) * 10 * SEC
    zeros = np.repeat(rng.choice([-1.0, -0.0, 0.0, 1.0], n), rng.integers(1, 6, n))[:n]
    walk = np.round(np.cumsum(rng.standard_normal(n)) * 3, 2)
    pick = rng.random(n)
    walk[pick < 0.3] = np.nan
    walk[(pick >= 0.3) & (pick < 0.33)] = np.inf
    walk[(pick >= 0.33) & (pick < 0.36)] = -np.inf
    ints = rng.integers(-2, 3, n).astype(np.float64)
    ints[ints == 0] = np.where(rng.random(int((ints == 0).sum())) < 0.5, -0.0, 0.0)
    ulps = 1.0 + rng.integers(0, 4, n) * 2.0**-52
    for lane, row in enumerate((zeros, np.full(n, np.nan), walk, ints, ulps)):
        t[lane], v[lane] = grid, row
    t[5, :n // 2], v[5, :n // 2] = grid[:n // 2], walk[:n // 2]
    steps = START + np.arange(-2, n // 6 + 55, dtype=np.int64) * 60 * SEC
    return t, v, steps


def select_probes(n_steps: int = 64, seed: int = 23):
    """A served [64, S] matrix for the grouped quantile and topk/bottomk:
    ``(values f64[64, S], groups i64[64], n_groups)``.  Rows 0-47 are real
    lanes in five groups of 1, 2, 5, 15 and 25 lanes (sizes below and
    above k, interleaved lane order), rows 48-63 all-NaN padding on the
    last group (the planner's topk trash group; an empty group for the
    quantile).  Cells: small integers (ties), +-0.0, NaN (~20%), +-Inf,
    a step where one group is all NaN and a step where every cell is
    NaN."""
    rng = np.random.default_rng(seed)
    L, n_real, n_groups = 64, 48, 6
    v = rng.integers(-3, 4, (L, n_steps)).astype(np.float64)
    zero = v == 0
    v[zero] = np.where(rng.random(int(zero.sum())) < 0.5, -0.0, 0.0)
    pick = rng.random((L, n_steps))
    v[pick < 0.2] = np.nan
    v[(pick >= 0.2) & (pick < 0.24)] = np.inf
    v[(pick >= 0.24) & (pick < 0.28)] = -np.inf
    sizes = (1, 2, 5, 15, 25)
    groups = np.full(L, n_groups - 1, dtype=np.int64)
    groups[:n_real] = rng.permutation(np.repeat(np.arange(5), sizes))
    v[groups == 3, 5] = np.nan
    v[:, 9] = np.nan
    v[n_real:] = np.nan
    return v, groups, n_groups


def graphite_probe_matrix(n_rows: int = 16, s_pad: int = 64, real_S: int = 41, seed: int = 31):
    """A served [n_rows, s_pad] matrix for the graphite kernels (QK4, GK2, GK3):
    ``(values f64[n_rows, s_pad], groups i64[n_rows], n_groups)``.  Columns
    past ``real_S`` repeat the last real one, as a leaf's padding steps do.
    Rows: 0 a walk with NaN holes; 1 the walk with +-Inf samples; 2 random
    +-0.0 and NaN; 3 all NaN; 4 one present sample; 5 a constant (range 0);
    6 only -0.0; 7 small integers (ties); 8 -Inf and +Inf only; then
    uniform values with ~25% NaN; the last two rows all-NaN padding.  Column
    3 is NaN in every row, column 7 NaN in all but row 4's one sample.
    Groups: 1, 2, 3 and 5 lanes interleaved, one-lane groups, the padding
    rows parked on group 0 as the planner parks them."""
    rng = np.random.default_rng(seed)
    L, S = n_rows, s_pad
    v = np.round(rng.uniform(-50, 50, (L, S)), 2)
    v[rng.random((L, S)) < 0.25] = np.nan
    v[0] = np.cumsum(rng.integers(-3, 4, S)).astype(np.float64)
    v[0, rng.random(S) < 0.15] = np.nan
    v[1] = v[0]
    v[1, rng.random(S) < 0.1] = np.inf
    v[1, rng.random(S) < 0.1] = -np.inf
    v[2] = np.where(rng.random(S) < 0.5, -0.0, 0.0)
    v[2, rng.random(S) < 0.2] = np.nan
    v[3] = np.nan
    v[4] = np.nan
    v[4, 7] = 12.5
    v[5] = 4.0
    v[6] = -0.0
    v[7] = rng.integers(-2, 3, S).astype(np.float64)
    v[8] = np.where(rng.random(S) < 0.5, -np.inf, np.inf)
    v[:, 3] = np.nan
    v[np.arange(L) != 4, 7] = np.nan
    v[L - 2:] = np.nan
    v[:, real_S:] = v[:, real_S - 1:real_S]
    n_real = L - 2
    sizes = [1, 2, 3, 5] + [1] * (n_real - 11)
    groups = np.zeros(L, dtype=np.int64)
    groups[:n_real] = rng.permutation(np.repeat(np.arange(len(sizes)), sizes))
    return v, groups, len(sizes)


def histogram_probes(n_steps: int = 64, seed: int = 29):
    """Bucket rows for histogram_quantile: ``(cv f64[R, S], rows_idx
    i64[8, 8], ubs f64[8, 8], caps f64[8])`` in the planner's layout.
    Groups: cumulative counters (DefBuckets-like bounds); one whose +Inf
    count falls below a finite bucket's at some steps (the cummax fix-up);
    negative and zero upper bounds (the first-bucket rule); all-zero
    counts (total 0); NaN and +-Inf counts; two buckets only; and two
    padding groups (all rows 0, bounds +Inf).  Padding buckets repeat the
    top row."""
    rng = np.random.default_rng(seed)
    bounds = [
        [0.005, 0.05, 0.25, 1.0, 5.0, np.inf],
        [0.1, 0.5, 1.0, np.inf],
        [-2.0, -1.0, 0.0, 1.0, np.inf],
        [0.5, 1.0, np.inf],
        [1.0, 2.0, 4.0, 8.0, 16.0, 32.0, 64.0, np.inf],
        [1.0, np.inf],
    ]
    rows, rows_idx, ubs, caps = [], np.zeros((8, 8), dtype=np.int64), np.full((8, 8), np.inf), \
        np.zeros(8)
    for g, ub in enumerate(bounds):
        inc = rng.integers(0, 20, (len(ub), n_steps)).astype(np.float64)
        c = np.cumsum(np.cumsum(inc, axis=1), axis=0)  # cumulative in le, counters in time
        if g == 1:
            c[-1, ::3] = c[1, ::3] - 5  # +Inf below a finite bucket
        if g == 3:
            c[:] = 0.0
            c[:, ::2] = np.cumsum(inc[:, ::2], axis=0)
        if g == 4:
            pick = rng.random(c.shape)
            c[pick < 0.1] = np.nan
            c[(pick >= 0.1) & (pick < 0.13)] = np.inf
            c[(pick >= 0.13) & (pick < 0.15)] = -np.inf
        base = len(rows)
        rows.extend(c)
        rows_idx[g, :len(ub)] = base + np.arange(len(ub))
        rows_idx[g, len(ub):] = base + len(ub) - 1
        ubs[g, :len(ub)] = ub
        caps[g] = ub[-2]
    return np.asarray(rows), rows_idx, ubs, caps


# client_golang's DefBuckets: 11 finite upper bounds and +Inf
DEF_BUCKETS = ("0.005", "0.01", "0.025", "0.05", "0.1", "0.25", "0.5", "1", "2.5", "5", "10",
               "+Inf")


class HistogramFleet(NamedTuple):
    words: np.ndarray  # u32[M, W]
    nbits: np.ndarray  # i32[M]
    slots: np.ndarray  # i64[M]
    labels: list  # per lane: {"job", "hist", "le"}
    n_dp: int
    n_cap: int


def histogram_fleet(n_hist: int, n_jobs: int = 100, n_unique: int = 167,
                    fc: FanoutCorpus | None = None) -> HistogramFleet:
    """``http_request_duration_seconds_bucket`` at BASELINE config 4's
    shape: ``n_hist`` histograms x the 12 DefBuckets, each bucket a
    series of 6h at 10s in 2h blocks.  Bucket b of unique histogram u is
    ``round(walk_u * (b + 1) / 12)`` of the fan-out corpus's seed-42 walks
    (cumulative in ``le``; +Inf is the walk itself); histogram h reads
    unique ``h % n_unique`` and belongs to job ``h % n_jobs``.  Lane
    ``12 h + b``; one stream per (lane, block)."""
    fc = fc if fc is not None else fanout_corpus(2000)
    n_b = len(DEF_BUCKETS)
    block_starts = [START + b * 2 * xtime.HOUR for b in range(len(fc.grids))]
    streams = []
    for (ts_u, vs_u), bs in zip(fc.grids, block_starts):
        for u in range(n_unique):
            for b in range(n_b):
                v = np.round(vs_u[u] * (b + 1) / n_b)
                enc = tsz.Encoder(bs)
                for t, x in zip(ts_u[u].tolist(), v.tolist()):
                    enc.encode(t, x)
                streams.append(enc.finalize())
    uniq_words, uniq_nbits = pack_streams(streams)  # [n_blocks * n_unique * n_b, W]
    n_blocks = len(fc.grids)
    lanes = np.arange(n_hist * n_b, dtype=np.int64)
    uniq_lane = (lanes // n_b % n_unique) * n_b + lanes % n_b
    flat = (np.repeat(uniq_lane, n_blocks)
            + np.tile(np.arange(n_blocks, dtype=np.int64) * n_unique * n_b, len(lanes)))
    labels = [{"job": "j%03d" % (h % n_jobs), "hist": "h%05d" % h, "le": le}
              for h in range(n_hist) for le in DEF_BUCKETS]
    return HistogramFleet(uniq_words[flat], uniq_nbits[flat], np.repeat(lanes, n_blocks),
                          labels, fc.batch.n_dp, fc.batch.n_cap)


MEGABATCH_STEPS = 41  # 40 minutes at 60s (bench.py:3291-3320)


def megabatch_query(seed: int, n_jobs: int = 8, n_inst: int = 64):
    """One query of the reference's dashboard megabatch
    (``bench.py:3325 bench_query_batching``):
    ``sum by (job)(sum_over_time(mem_use[5m])) / sum by
    (job)(count_over_time(mem_use[5m]))`` on arrays-kind leaves (the
    decoded-block cache's bridge) over ``n_jobs x n_inst`` gauges, uniform
    in [-50, 50) every 20s for an hour, 40 minutes at 60s steps.  Each
    seed is a tenant of its own (its data and its window); every query
    has the same plan.  Returns (plan, (leaves, params, steps))."""
    rng = np.random.default_rng(seed)
    t0 = START - START % (2 * xtime.HOUR) + seed * xtime.HOUR
    ts = np.arange(t0 + SEC, t0 + 3600 * SEC, 20 * SEC, dtype=np.int64)
    labels = [{"job": f"job{j}", "inst": f"i{i}"} for j in range(n_jobs) for i in range(n_inst)]
    times = np.tile(ts, (len(labels), 1))
    values = rng.uniform(-50, 50, times.shape)
    b = ExprPlanBuilder(t0 + 10 * xtime.MINUTE + np.arange(MEGABATCH_STEPS) * xtime.MINUTE)
    lf = b.arrays_leaf(times, values, labels, 5 * xtime.MINUTE)
    root = b.vv("/", b.agg("sum", b.leaf(lf, "sum_over_time"), ("job",)),
                b.agg("sum", b.leaf(lf, "count_over_time"), ("job",)))
    return root.plan, b.inputs()


# --- the mesh paths' small corpora -----------------------------------------


def sharded_query_streams(n_lanes: int, blocks_per: int, dp: int, seed: int = 9):
    """``blocks_per`` streams of ``dp`` cumulative-sum counter samples at
    10s per lane, in lane order (the reference's ``_mk_streams``).  Returns
    (streams, slots i64[M], fragments [(lane, times, values)])."""
    rng = np.random.default_rng(seed)
    streams, slots, frags = [], [], []
    for lane in range(n_lanes):
        for b in range(blocks_per):
            base = START + b * dp * 10 * SEC
            t = base + (np.arange(dp) + 1) * 10 * SEC
            v = np.cumsum(rng.random(dp) * 3)
            enc = tsz.Encoder(base)
            for ti, vi in zip(t, v):
                enc.encode(int(ti), float(vi))
            streams.append(enc.finalize())
            slots.append(lane)
            frags.append((lane, t, v))
    return streams, np.asarray(slots, dtype=np.int64), frags


def sharded_read_batch(n_lanes: int, n_dp: int = 36, seed: int = 0):
    """Integer random-walk lanes at 10s (the reference read tests'
    ``make_batch``).  Returns (words, nbits, values f64[n_lanes, n_dp])."""
    rng = random.Random(seed)
    streams, grids = [], []
    for _ in range(n_lanes):
        t, v = START, float(rng.randint(0, 100))
        ts, vs = [], []
        for _ in range(n_dp):
            t += 10 * SEC
            v = max(0.0, v + rng.choice([-1.0, 0.0, 1.0]))
            ts.append(t)
            vs.append(v)
        streams.append(tsz.encode_series(ts, vs, START))
        grids.append(vs)
    words, nbits = pack_streams(streams)
    return words, nbits, np.asarray(grids)


def ingest_grid(n_lanes: int, n_dp: int, seed: int = 3):
    """The sharded encoder's inputs (the reference ingest tests' ``_inputs``):
    (ts i64[L, T] at 10s, starts i64[L], n_valid i32[L], values f64[L, T] of
    whole numbers below 40)."""
    rng = np.random.default_rng(seed)
    vs = np.round(rng.random((n_lanes, n_dp)) * 40)
    ts = START + 10 * SEC * (1 + np.arange(n_dp, dtype=np.int64))[None, :]
    ts = np.broadcast_to(ts, (n_lanes, n_dp)).copy()
    starts = np.full(n_lanes, START, dtype=np.int64)
    nv = np.full(n_lanes, n_dp, dtype=np.int32)
    return ts, starts, nv, vs


MESH_PLANS = ("sum_by", "stddev_by", "quantile_by", "topk", "histogram_quantile", "absent",
              "ratio", "arrays_max_by")


def _mesh_fleet(n_dp: int = 60):
    """Two counters (16 series each, jobs a..d, one with a gap of NaN) and
    three histograms of four buckets: (labels, series) per metric."""
    rng = np.random.default_rng(23)
    t = START + (np.arange(n_dp) + 1) * 10 * SEC
    out = {}
    for metric in ("req", "lim"):
        labels, series = [], []
        for i in range(16):
            v = np.round(np.cumsum(rng.random(n_dp) * 3), 2)
            if metric == "req" and i == 3:
                v[10:30] = np.nan
            labels.append({"job": "abcd"[i % 4], "i": str(i)})
            series.append((t, v))
        out[metric] = (labels, series)
    labels, series = [], []
    for h in range(3):
        base = np.round(np.cumsum(rng.random(n_dp) * 4), 2)
        for j, le in enumerate(("0.5", "1", "5", "+Inf")):
            labels.append({"job": "h%d" % h, "le": le})
            series.append((t, np.round(base * (j + 1) / 4, 2)))
    out["bucket"] = (labels, series)
    return out


def mesh_expr_plan(name: str, n_shards: int = 8):
    """One plan of ``MESH_PLANS`` over rate(..[5m]) of a small fleet, words
    leaves shard-even over ``n_shards``: sum / stddev / quantile(0.9) by
    job, topk(3), histogram_quantile(0.9), absent(rate > 1e9), the ratio
    req / on(i) lim (a vector-vector match over sharded children), and max
    by job of max_over_time over an arrays-kind leaf (decoded lanes, 64 of
    them: a multiple of the shard count).  Returns (plan, leaves, params,
    steps)."""
    steps = np.arange(START + 10 * xtime.MINUTE, START + 20 * xtime.MINUTE + 1, xtime.MINUTE,
                      dtype=np.int64)
    b = ExprPlanBuilder(steps)
    fleet = _mesh_fleet()

    def leaf(metric):  # every leaf of the inputs is read by the plan
        labels, series = fleet[metric]
        idx = b.words_leaf_from_series(series, labels, 5 * xtime.MINUTE)
        b.shard_even(idx, n_shards)
        return b.leaf(idx, "rate")

    if name == "arrays_max_by":
        labels, series = fleet["lim"]
        times = np.stack([t for t, _ in series])
        values = np.stack([v for _, v in series])
        root = b.agg("max", b.leaf(b.arrays_leaf(times, values, labels, 5 * xtime.MINUTE),
                                   "max_over_time"), by=("job",))
        leaves, params, st = b.inputs()
        return root.plan, leaves, params, st
    req = None if name == "histogram_quantile" else leaf("req")
    if name == "sum_by":
        root = b.agg("sum", req, by=("job",))
    elif name == "stddev_by":
        root = b.agg("stddev", req, by=("job",))
    elif name == "quantile_by":
        root = b.agg("quantile", req, by=("job",), phi=0.9)
    elif name == "topk":
        root = b.topk("topk", 3, req)
    elif name == "histogram_quantile":
        root = b.hq(0.9, leaf("bucket"))
    elif name == "absent":
        root = b.absent(b.vs(">", req, 1e9))
    elif name == "ratio":
        root = b.vv("/", req, leaf("lim"), on=("i",))
    else:
        raise ValueError(f"no mesh plan {name!r}")
    leaves, params, st = b.inputs()
    return root.plan, leaves, params, st


def global_slots(leaves, n_shards: int):
    """Shard-even words leaves with their LOCAL slots made global again (the
    same lanes and rows), for the unsharded interpreter."""
    out = []
    for lf in leaves:
        lf = dict(lf)
        if "words" in lf:
            local = len(lf["valid"]) // n_shards
            per_m = len(lf["slots"]) // n_shards
            lf["slots"] = lf["slots"] + (np.arange(len(lf["slots"])) // per_m) * local
        out.append(lf)
    return out
