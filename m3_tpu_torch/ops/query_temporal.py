"""Windowed PromQL temporal functions over merged lanes: the CUDA kernels
QK2 (rate family) and QK3 (prefix-sum reducers) and their plain PyTorch
versions.

Port of ``m3_tpu/models/query_pipeline.py``: ``_window_bounds_device``,
``_rate_device``, ``_instant_device`` (QK2) and the prefix-sum half of
``_reduce_device`` (QK3: sum, avg, count, present and last over time).

- On a CUDA tensor ``rate``, ``instant`` and ``reduce_window`` launch
  ``csrc/query_temporal.cu`` (a few blocks per SM, each taking lanes in
  turn; a lane's prefix sums in the block's slice of a global scratch
  buffer, so lanes have no length limit; one thread per step) or raise.
- On a CPU tensor they run the plain versions below, which follow the
  reference line for line: the same bisection (a fixed number of levels,
  as ``jnp.searchsorted`` runs it, so unsorted lanes get the reference's
  bounds too), the same prefix sums and the same f64 order of operations.

Lanes are ``times i64[L, N]`` (ascending, INT64_MAX-padded) and
``values f64[L, N]`` (NaN-padded); ``steps`` is ``i64[S]``; ``range_nanos``
is a plain integer argument of the kernel, never part of its build.
"""

from __future__ import annotations

import math

import torch

from m3_tpu_torch.ops import _build

I64 = torch.int64
F64 = torch.float64

RATE_FNS = ("rate", "increase", "delta")
INSTANT_FNS = ("irate", "idelta")
REDUCERS = ("sum_over_time", "avg_over_time", "count_over_time", "present_over_time",
            "last_over_time")
_OP_RATE, _OP_INSTANT = 0, 1
_OP_OF_REDUCER = {name: 2 + i for i, name in enumerate(REDUCERS)}  # enum Op of the kernel
# The reference divides nanoseconds by 1e9; XLA compiles a division by a
# constant as a multiplication by its reciprocal, so the reference's bits
# are those of x * 1e-9, and the port computes that.
NANO = 1e-9


def search_levels(n: int) -> int:
    """Bisection levels ``jnp.searchsorted`` runs over n sorted elements."""
    return math.ceil(math.log2(n + 1)) if n else 0


# --- plain versions ------------------------------------------------------


def search_right_plain(times: torch.Tensor, queries: torch.Tensor) -> torch.Tensor:
    """Per-lane ``searchsorted(times[l], queries, side="right")`` -> i64[L, S],
    by the reference's fixed-level bisection."""
    L, N = times.shape
    shape = (L, queries.shape[0])
    low = torch.zeros(shape, dtype=I64, device=times.device)
    high = torch.full(shape, N, dtype=I64, device=times.device)
    q = queries[None, :]
    for _ in range(search_levels(N)):
        mid = (low + high) // 2
        go_left = q < torch.gather(times, 1, mid)
        low = torch.where(go_left, low, mid)
        high = torch.where(go_left, mid, high)
    return high


def window_bounds_plain(times, steps, range_nanos: int):
    """(starts_excl i64[S], left, right i64[L, S]) of the inclusive
    ``[t - range, t]`` windows."""
    starts_excl = steps - range_nanos - 1
    return (starts_excl, search_right_plain(times, starts_excl),
            search_right_plain(times, steps))


def _take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    return torch.gather(x, 1, idx)


def _minimum(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """jnp.minimum: NaN propagates, -0.0 orders below +0.0."""
    m = torch.where(a < b, a, torch.where(b < a, b, torch.where(torch.signbit(a), a, b)))
    return torch.where(torch.isnan(a) | torch.isnan(b), torch.nan, m)


def rate_plain(times, values, steps, range_nanos: int, is_counter: bool, is_rate: bool):
    """Plain version of ``rate``: upstream extrapolatedRate (>= 2 samples,
    counter-reset prefix sums, 1.1x average-spacing extrapolation caps,
    counter zero floor)."""
    L, N = values.shape
    starts_excl, left, right = window_bounds_plain(times, steps, range_nanos)
    has2 = (right - left) >= 2
    i_first = left.clamp(0, N - 1)
    i_last = (right - 1).clamp(0, N - 1)
    t_first, t_last = _take(times, i_first), _take(times, i_last)
    v_first, v_last = _take(values, i_first), _take(values, i_last)
    if is_counter and N > 1:
        prev, curr = values[:, :-1], values[:, 1:]
        resets = torch.where(curr < prev, prev, 0.0)
        cum = torch.cat([torch.zeros((L, 1), dtype=F64, device=values.device),
                         torch.cumsum(resets, dim=1)], dim=1)
        corr = _take(cum, i_last) - _take(cum, i_first)
        corr = torch.where(has2, corr, 0.0)
    else:
        corr = torch.zeros_like(v_last)
    result = v_last - v_first + corr
    sampled = (t_last - t_first).to(F64)
    n_samples = (right - left).to(F64)
    avg_dur = torch.where(has2, sampled / torch.clamp(n_samples - 1, min=1.0), 0.0)
    dur_start = (t_first - starts_excl[None, :]).to(F64)
    dur_end = (steps[None, :] - t_last).to(F64)
    threshold = avg_dur * 1.1
    if is_counter:
        dur_to_zero = torch.where((result > 0) & (v_first >= 0),
                                  sampled * v_first / torch.where(result > 0, result, 1.0),
                                  torch.inf)
        dur_start = _minimum(dur_start, dur_to_zero)
    extrap_start = torch.where(dur_start < threshold, dur_start, avg_dur / 2)
    extrap_end = torch.where(dur_end < threshold, dur_end, avg_dur / 2)
    interval = sampled + extrap_start + extrap_end
    out = result * (interval / torch.clamp(sampled, min=1.0))
    if is_rate:
        out = out / (range_nanos * NANO)
    return torch.where(has2 & (sampled > 0), out, torch.nan)


def instant_plain(times, values, steps, range_nanos: int, is_rate: bool):
    """Plain version of ``instant``: irate/idelta from the window's last two
    samples (irate: a drop means a counter restart, delta = the new value)."""
    N = values.shape[1]
    _, left, right = window_bounds_plain(times, steps, range_nanos)
    has2 = (right - left) >= 2
    i_last = (right - 1).clamp(0, N - 1)
    i_prev = (right - 2).clamp(0, N - 1)
    v_last = _take(values, i_last)
    dv = v_last - _take(values, i_prev)
    if is_rate:
        dv = torch.where(dv < 0, v_last, dv)
    dt = (_take(times, i_last) - _take(times, i_prev)).to(F64) * NANO
    out = dv / torch.clamp(dt, min=1e-9) if is_rate else dv
    return torch.where(has2, out, torch.nan)


def reduce_plain(times, values, steps, range_nanos: int, reducer: str):
    """Plain version of ``reduce_window``: NaN-masked prefix sums, window
    value = csum[right] - csum[left]; an empty window is NaN, an all-NaN
    one gives sum/avg 0.0, count 0 and present NaN."""
    _check_reducer(reducer)
    L, N = values.shape
    _, left, right = window_bounds_plain(times, steps, range_nanos)
    empty = right == left
    if reducer == "last_over_time":
        picked = _take(values, (right - 1).clamp(0, N - 1))
        return torch.where(empty, torch.nan, picked)
    w = ~torch.isnan(values)
    v0 = torch.where(w, values, 0.0)
    zero = torch.zeros((L, 1), dtype=F64, device=values.device)
    csum = torch.cat([zero, torch.cumsum(v0, dim=1)], dim=1)
    ccnt = torch.cat([zero, torch.cumsum(w, dim=1).to(F64)], dim=1)
    s = _take(csum, right) - _take(csum, left)
    n = _take(ccnt, right) - _take(ccnt, left)
    if reducer == "sum_over_time":
        out = s
    elif reducer == "avg_over_time":
        out = s / torch.clamp(n, min=1.0)
    elif reducer == "count_over_time":
        out = n
    else:
        out = torch.where(n > 0, torch.ones_like(n), torch.nan)
    return torch.where(empty, torch.nan, out)


def _check_reducer(reducer: str) -> None:
    if reducer not in REDUCERS:
        raise ValueError(f"no prefix-sum form for {reducer}")


# --- wrappers: CUDA tensor -> kernel, CPU tensor -> plain version --------

_SIGNATURES = {
    "m3_query_temporal": [_build.P, _build.P, _build.P, _build.LL, _build.LL, _build.I, _build.I,
                          _build.LL, _build.I, _build.I, _build.I, _build.P, _build.P, _build.P,
                          _build.P, _build.P, _build.I, _build.P],
}
BLOCKS_PER_SM = 8  # 128-thread blocks per SM; each block's prefix scratch is [N + 1]


def _launch(times, values, steps, range_nanos: int, op: int, is_counter: bool, is_rate: bool,
            kernel: str, with_bounds: bool):
    if times.dim() != 2 or values.shape != times.shape:
        raise ValueError("times and values must be [L, N] of one shape")
    if steps.dim() != 1 or steps.device != times.device or values.device != times.device:
        raise ValueError("steps must be [S] on the device of times")
    L, N = times.shape
    S = steps.shape[0]
    if N < 1:
        raise ValueError("lanes need at least one sample slot (n_cap >= 1)")
    dev = times.device
    t = times.to(I64).contiguous()
    v = values.to(F64).contiguous()
    st = steps.to(I64).contiguous()
    out = torch.empty((L, S), dtype=F64, device=dev)
    left = right = None
    if with_bounds:
        left = torch.empty((L, S), dtype=I64, device=dev)
        right = torch.empty((L, S), dtype=I64, device=dev)
    if L and S:
        lib = _build.library("query_temporal", _SIGNATURES)
        n_blocks = min(L, torch.cuda.get_device_properties(dev).multi_processor_count
                       * BLOCKS_PER_SM)
        prefix = torch.empty((n_blocks, N + 1), dtype=F64, device=dev)
        prefix_counts = torch.empty((n_blocks, N + 1), dtype=torch.int32, device=dev)
        rc = lib.m3_query_temporal(
            t.data_ptr(), v.data_ptr(), st.data_ptr(), L, N, S, search_levels(N),
            int(range_nanos), op, int(is_counter), int(is_rate), out.data_ptr(),
            None if left is None else left.data_ptr(),
            None if right is None else right.data_ptr(),
            prefix.data_ptr(), prefix_counts.data_ptr(), n_blocks,
            torch.cuda.current_stream(dev).cuda_stream)
        _build.check(lib, rc, kernel)
        _build.count_launch(kernel)
    return (out, left, right) if with_bounds else out


def _plain_bounds(out, times, steps, range_nanos, with_bounds):
    if not with_bounds:
        return out
    _, left, right = window_bounds_plain(times, steps, range_nanos)
    return out, left, right


def _device_of(times: torch.Tensor) -> str:
    if times.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {times.device}")
    return times.device.type


def rate(times, values, steps, range_nanos: int, is_counter: bool = True,
         is_rate: bool = True, with_bounds: bool = False):
    """rate (counter, per second), increase (counter) or delta (gauge) per
    (lane, step) -> f64[L, S]; with ``with_bounds`` also the window bounds
    (left, right i64[L, S])."""
    if _device_of(times) == "cpu":
        out = rate_plain(times, values, steps, range_nanos, is_counter, is_rate)
        return _plain_bounds(out, times, steps, range_nanos, with_bounds)
    return _launch(times, values, steps, range_nanos, _OP_RATE, is_counter, is_rate,
                   "query_rate", with_bounds)


def instant(times, values, steps, range_nanos: int, is_rate: bool = True,
            with_bounds: bool = False):
    """irate (``is_rate``) or idelta per (lane, step) -> f64[L, S]."""
    if _device_of(times) == "cpu":
        out = instant_plain(times, values, steps, range_nanos, is_rate)
        return _plain_bounds(out, times, steps, range_nanos, with_bounds)
    return _launch(times, values, steps, range_nanos, _OP_INSTANT, False, is_rate,
                   "query_rate", with_bounds)


def reduce_window(times, values, steps, range_nanos: int, reducer: str,
                  with_bounds: bool = False):
    """``reducer`` (one of REDUCERS) over each [t - range, t] window -> f64[L, S]."""
    _check_reducer(reducer)
    if _device_of(times) == "cpu":
        out = reduce_plain(times, values, steps, range_nanos, reducer)
        return _plain_bounds(out, times, steps, range_nanos, with_bounds)
    return _launch(times, values, steps, range_nanos, _OP_OF_REDUCER[reducer], False, False,
                   "query_reduce", with_bounds)
