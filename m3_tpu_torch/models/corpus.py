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

Everything is built from a seed with the scalar encoder, so the same
bytes feed the JAX package and the port.
"""

from __future__ import annotations

import math
import random
from typing import NamedTuple

import numpy as np

from m3_tpu_torch.ops import m3tsz_scalar as tsz
from m3_tpu_torch.ops.bitstream import pack_streams
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
