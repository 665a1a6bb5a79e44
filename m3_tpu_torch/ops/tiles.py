"""AggregateTiles kernel (T1): decode + time-bucketed reduction per tile.

Port of ``m3_tpu/ops/tiles.py:aggregate_tiles_kernel``.  Each lane's M3TSZ
stream is decoded up to ``n_steps`` points; point ``t`` goes into tile
``(t - block_start) // tile_nanos`` (floor division), and points outside
``[0, n_tiles)`` are dropped.  Per (lane, tile): ``count`` counts every
in-range point, NaN values included; ``sum``, ``sum_sq``, ``min`` and
``max`` skip NaN values (0.0 sums on an empty tile); a ``min`` or ``max``
that is +-Inf comes out NaN; ``last`` is the value at the greatest
timestamp, the last such point in stream order on a tie, NaN included.
These are the reference's scatters as XLA:CPU runs them: sequential adds in
stream order, ``min``/``max`` with -0.0 below +0.0, a ``.set`` that keeps
the last of duplicate indices.

- On a CUDA tensor, ``aggregate_tiles`` launches T1 of
  ``csrc/m3tsz_decode.cu``: one thread per lane decodes with K1's
  ``__device__`` step and keeps the current tile's accumulators in
  registers, never writing the [L, n_steps] grid.
- On a CPU tensor it runs ``aggregate_tiles_plain``: ``decode_batched_plain``,
  then one vectorised update of every lane's tile cell per step, which is
  the kernel's order exactly (no ``index_add_`` ordering is relied on).
"""

from __future__ import annotations

import torch

from m3_tpu_torch.ops import _build
from m3_tpu_torch.ops.downsample import WindowedAgg
from m3_tpu_torch.ops.m3tsz_decode import (
    BOOL,
    F64,
    I32,
    I64,
    MULT_DIVISORS,
    _check_inputs,
    _max_ieee,
    _min_ieee,
    _ptr,
    decode_batched_plain,
)
from m3_tpu_torch.utils import xtime

_I64_MIN = -(2**63)

_TILES_SIGNATURES = {
    "m3_aggregate_tiles": [
        _build.P, _build.P, _build.I, _build.I, _build.I, _build.I, _build.LL,
        _build.LL, _build.I, _build.LL, _build.P, _build.P, _build.P,
        _build.P, _build.P, _build.P, _build.P, _build.P, _build.P, _build.P],
}


def tile_index(ts: torch.Tensor, block_start: int, tile_nanos: int) -> torch.Tensor:
    """``(ts - block_start) // tile_nanos`` on wrapping int64, floored."""
    return torch.div(ts - block_start, tile_nanos, rounding_mode="floor")


def aggregate_tiles_plain(words, nbits, n_steps: int, n_tiles: int,
                          tile_nanos: int, block_start: int,
                          unit_nanos: int = xtime.SECOND,
                          int_optimized: bool = True):
    """Plain PyTorch version of ``aggregate_tiles`` (same arguments)."""
    ts, vs, valid, decoded, error = decode_batched_plain(
        words, nbits, n_steps, int_optimized, unit_nanos)
    L, dev = ts.shape[0], ts.device
    cols = n_tiles + 1  # the last column takes the dropped points

    def grid(fill, dtype):
        return torch.full((L, cols), fill, dtype=dtype, device=dev)

    s, ssq, mn, mx = grid(0.0, F64), grid(0.0, F64), grid(torch.inf, F64), grid(-torch.inf, F64)
    count, last_t, last = grid(0, I64), grid(_I64_MIN, I64), grid(torch.nan, F64)
    rows = torch.arange(L, device=dev)
    for j in range(n_steps):
        t, v = ts[:, j], vs[:, j]
        k = tile_index(t, block_start, tile_nanos)
        inr = valid[:, j] & (k >= 0) & (k < n_tiles)
        col = torch.where(inr, k, n_tiles)
        contrib = inr & ~torch.isnan(v)
        vz = torch.where(contrib, v, 0.0)
        count[rows, col] += inr.to(I64)
        s[rows, col] = torch.where(contrib, s[rows, col] + vz, s[rows, col])
        ssq[rows, col] = torch.where(contrib, ssq[rows, col] + vz * vz, ssq[rows, col])
        mn[rows, col] = torch.where(contrib, _min_ieee(mn[rows, col], v), mn[rows, col])
        mx[rows, col] = torch.where(contrib, _max_ieee(mx[rows, col], v), mx[rows, col])
        win = inr & (t >= last_t[rows, col])
        last_t[rows, col] = torch.where(win, t, last_t[rows, col])
        last[rows, col] = torch.where(win, v, last[rows, col])
    mn, mx = mn[:, :n_tiles], mx[:, :n_tiles]
    agg = WindowedAgg(
        sum=s[:, :n_tiles].contiguous(),
        sum_sq=ssq[:, :n_tiles].contiguous(),
        count=count[:, :n_tiles].contiguous(),
        min=torch.where(torch.isinf(mn), torch.nan, mn),
        max=torch.where(torch.isinf(mx), torch.nan, mx),
        last=last[:, :n_tiles].contiguous(),
    )
    return agg, decoded, error


def aggregate_tiles(words: torch.Tensor, nbits: torch.Tensor, n_steps: int,
                    n_tiles: int, tile_nanos: int, block_start: int,
                    unit_nanos: int = xtime.SECOND, int_optimized: bool = True):
    """[L] compressed streams -> per-(lane, tile) aggregates.

    Returns (WindowedAgg with [L, n_tiles] fields, decoded_count i32[L],
    error bool[L]).  A lane whose decoded_count equals n_steps may be
    TRUNCATED: callers re-run with a larger bound.  Points outside
    ``[block_start, block_start + n_tiles * tile_nanos)`` are dropped.
    """
    if tile_nanos <= 0 or n_tiles < 0 or n_steps < 0:
        raise ValueError(f"need tile_nanos > 0, n_tiles >= 0, n_steps >= 0; got "
                         f"{tile_nanos}, {n_tiles}, {n_steps}")
    words, nbits = _check_inputs(words, nbits, unit_nanos)
    if not words.is_cuda:
        return aggregate_tiles_plain(words, nbits, n_steps, n_tiles, tile_nanos,
                                     block_start, unit_nanos, int_optimized)
    L, W = words.shape
    dev = words.device

    def grid(dtype):
        return torch.empty((L, n_tiles), dtype=dtype, device=dev)

    s, ssq, count, mn, mx, last = grid(F64), grid(F64), grid(I64), grid(F64), grid(F64), grid(F64)
    decoded = torch.empty((L,), dtype=I32, device=dev)
    error = torch.empty((L,), dtype=BOOL, device=dev)
    if L:
        lib = _build.library("m3tsz_decode", _TILES_SIGNATURES)
        rc = lib.m3_aggregate_tiles(
            _ptr(words), _ptr(nbits), L, W, n_steps, n_tiles, tile_nanos,
            block_start, int(int_optimized), unit_nanos, MULT_DIVISORS.ctypes.data,
            _ptr(s), _ptr(ssq), _ptr(count), _ptr(mn), _ptr(mx), _ptr(last),
            _ptr(decoded), _ptr(error), torch.cuda.current_stream(dev).cuda_stream)
        _build.check(lib, rc, "aggregate_tiles")
        _build.count_launch("aggregate_tiles")
    agg = WindowedAgg(sum=s, sum_sq=ssq, count=count, min=mn, max=mx, last=last)
    return agg, decoded, error
