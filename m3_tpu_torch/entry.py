"""Port-side entry point: the flagship read step on the CUDA device.

``entry()`` mirrors the reference's ``__graft_entry__.entry()``: it
returns ``(fn, args)`` where ``fn(*args)`` runs one fused M3TSZ decode +
windowed downsample over a small example batch and returns the
``[64, 6]`` per-window means.
"""

from __future__ import annotations

import random

from m3_tpu_torch.models.read_pipeline import decode_downsample, inputs_from_numpy
from m3_tpu_torch.ops import m3tsz_scalar as tsz
from m3_tpu_torch.ops.bitstream import pack_streams
from m3_tpu_torch.utils import xtime

_SEC = xtime.SECOND
_START = 1_600_000_000 * _SEC


def example_batch(n_lanes: int, n_dp: int, seed: int = 0):
    """Packed numpy ``(words, nbits)`` of ``n_lanes`` integer gauge walks
    at 10s (the reference entry's ``_example_batch`` data)."""
    rng = random.Random(seed)
    streams = []
    for _ in range(n_lanes):
        t, v = _START, float(rng.randint(0, 100))
        ts, vs = [], []
        for _ in range(n_dp):
            t += 10 * _SEC
            v = max(0.0, v + rng.choice([-1.0, 0.0, 1.0]))
            ts.append(t)
            vs.append(v)
        streams.append(tsz.encode_series(ts, vs, _START))
    return pack_streams(streams)


def entry(device=None):
    """(fn, example_args): the single-device forward step, on ``device``
    (default: the CUDA device)."""
    n_dp, window = 36, 6
    words, nbits = inputs_from_numpy(*example_batch(n_lanes=64, n_dp=n_dp),
                                     device=device)

    def forward(words, nbits):
        out, count, error = decode_downsample(words, nbits, n_dp, window)
        return out

    return forward, (words, nbits)
