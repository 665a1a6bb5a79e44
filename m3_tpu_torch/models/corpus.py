"""Stream corpora the read path is driven and checked with.

- ``walk_streams``: the north-star workload's integer gauges — a seed-42
  random walk at 10s, the generator of the reference's ``bench.py``.
- ``probe_streams``: one stream per grammar corner and failure mode the
  decoders must agree on: NaN, +-Inf and -0.0 values; backward and
  duplicate timestamps; every timestamp bucket; mode switches, decimal
  multipliers and repeats; annotation and time-unit markers (error lanes
  that fall back to the scalar oracle); truncated and garbage streams;
  streams shorter than the decode grid.

Everything is built from a seed with the scalar encoder, so the same
bytes feed the JAX package and the port.
"""

from __future__ import annotations

import math
import random

import numpy as np

from m3_tpu_torch.ops import m3tsz_scalar as tsz
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
