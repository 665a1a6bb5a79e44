"""Windowed downsampling aggregations: the quantile kernel and plain glue.

Port of ``m3_tpu/ops/downsample.py``.  ``window_quantiles`` is a kernel
(``csrc/window_quantiles.cu``) on a CUDA tensor and its plain PyTorch
version on a CPU tensor; everything else is plain PyTorch glue over
``[lanes, time]`` and ``[lanes, windows]`` tensors.

Semantics parity (verified against the reference):
- stdev = sqrt((n*sumSq - sum^2) / (n*(n-1))), 0 when n < 2
  (ref: aggregation/common.go:29-36)
- gauge: NaN values excluded from sum/min/max but still counted; `last`
  is the value with the greatest timestamp (ref: gauge.go:53-80)
- timer: gauge stats + quantiles at rank ceil(q*n) (nearest-rank, the
  target the CM stream approximates — ref: quantile/cm/stream.go:160)
- mean = 0 for empty windows (ref: counter.go:91, gauge.go:100)

Where the reference picks one element of a window with a one-hot masked
sum, the port gathers it and reproduces the sum's one visible effect: a
picked -0.0 becomes +0.0 when the window holds more than one element.
Min and max follow XLA's IEEE-754 minimum/maximum (-0.0 below +0.0).

Transformations for rollup pipelines (ref: src/metrics/transformation/
{unary.go,binary.go,unary_multi.go}): absolute, add, increase,
persecond, reset.  Binary transforms emit NaN ("empty") for
non-monotonic input, matching the reference.
"""

from __future__ import annotations

import enum
from typing import NamedTuple

import numpy as np
import torch

from m3_tpu_torch.ops import _build

F64 = torch.float64
I64 = torch.int64
I32 = torch.int32


class AggregationType(enum.IntEnum):
    """Wire enum parity with ref: src/metrics/aggregation/type.go:32-55."""

    UNKNOWN = 0
    LAST = 1
    MIN = 2
    MAX = 3
    MEAN = 4
    MEDIAN = 5
    COUNT = 6
    SUM = 7
    SUMSQ = 8
    STDEV = 9
    P10 = 10
    P20 = 11
    P30 = 12
    P40 = 13
    P50 = 14
    P60 = 15
    P70 = 16
    P80 = 17
    P90 = 18
    P95 = 19
    P99 = 20
    P999 = 21
    P9999 = 22


QUANTILE_OF_TYPE = {
    AggregationType.MEDIAN: 0.5,
    AggregationType.P10: 0.1,
    AggregationType.P20: 0.2,
    AggregationType.P30: 0.3,
    AggregationType.P40: 0.4,
    AggregationType.P50: 0.5,
    AggregationType.P60: 0.6,
    AggregationType.P70: 0.7,
    AggregationType.P80: 0.8,
    AggregationType.P90: 0.9,
    AggregationType.P95: 0.95,
    AggregationType.P99: 0.99,
    AggregationType.P999: 0.999,
    AggregationType.P9999: 0.9999,
}

# Default aggregation sets per metric kind
# (ref: src/metrics/aggregation/types.go DefaultTypesFor* — counters sum,
# timers a quantile battery, gauges last).
DEFAULT_COUNTER_TYPES = (AggregationType.SUM,)
DEFAULT_GAUGE_TYPES = (AggregationType.LAST,)
DEFAULT_TIMER_TYPES = (
    AggregationType.SUM,
    AggregationType.SUMSQ,
    AggregationType.MEAN,
    AggregationType.MIN,
    AggregationType.MAX,
    AggregationType.COUNT,
    AggregationType.STDEV,
    AggregationType.MEDIAN,
    AggregationType.P50,
    AggregationType.P95,
    AggregationType.P99,
)


class WindowedAgg(NamedTuple):
    """Per-(lane, window) aggregate state; float64 carriers.

    `last` is NaN for windows with no datapoints; `min`/`max` are NaN for
    empty gauge windows (reference inits them to NaN — gauge.go:45-46).
    """

    sum: torch.Tensor  # [L, W]
    sum_sq: torch.Tensor  # [L, W]
    count: torch.Tensor  # [L, W] int64
    min: torch.Tensor  # [L, W]
    max: torch.Tensor  # [L, W]
    last: torch.Tensor  # [L, W]


def stdev(count: torch.Tensor, sum_sq: torch.Tensor, sum_: torch.Tensor) -> torch.Tensor:
    """Sample standard deviation from moments (ref: common.go:29-36)."""
    div = count * (count - 1)
    num = count.to(F64) * sum_sq - sum_ * sum_
    safe = torch.where(div > 0, div, 1).to(F64)
    return torch.where(div > 0, torch.sqrt(num.clamp(min=0.0) / safe), 0.0)


def _reshape_windows(x: torch.Tensor, k: int) -> torch.Tensor:
    L, T = x.shape
    if T % k:
        raise ValueError(f"time axis {T} not divisible by window {k}")
    return x.reshape(L, T // k, k)


def _fold_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis, element by element in index order from
    +0.0 (a length-1 axis is returned as it is, as XLA's reduce does)."""
    if x.shape[-1] == 1:
        return x[..., 0]
    acc = torch.zeros(x.shape[:-1], dtype=x.dtype, device=x.device)
    for i in range(x.shape[-1]):
        acc = acc + x[..., i]
    return acc


def _min_ieee(x: torch.Tensor) -> torch.Tensor:
    """IEEE-754 minimum over the last axis of NaN-free x: -0.0 < +0.0."""
    r = x.amin(dim=-1)
    neg_zero = ((x == 0) & torch.signbit(x)).any(dim=-1)
    return torch.where(r == 0, torch.where(neg_zero, -0.0, 0.0), r)


def _max_ieee(x: torch.Tensor) -> torch.Tensor:
    """IEEE-754 maximum over the last axis of NaN-free x: +0.0 > -0.0."""
    r = x.amax(dim=-1)
    pos_zero = ((x == 0) & ~torch.signbit(x)).any(dim=-1)
    return torch.where(r == 0, torch.where(pos_zero, 0.0, -0.0), r)


def _pick(x: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """x[..., pos] (pos clamped into range) as the reference's one-hot sum
    computes it: a picked -0.0 comes out +0.0 when the axis is longer than 1."""
    k = x.shape[-1]
    p = torch.gather(x, -1, pos.clamp(0, k - 1).to(I64)[..., None])[..., 0]
    return torch.where(p == 0, 0.0, p) if k > 1 else p


def window_aggregate(
    values: torch.Tensor, mask: torch.Tensor, k: int, skip_nan: bool = True
) -> WindowedAgg:
    """Reduce a regular [L, T] grid into [L, T//k] windows.

    `mask` marks datapoints that exist; with skip_nan (gauge/timer
    semantics) NaN values are additionally excluded from sum/min/max but
    kept in `count` (ref: gauge.go:62-66 counts before the NaN check).
    """
    v = _reshape_windows(values.to(F64), k)
    m = _reshape_windows(mask, k)
    count = m.sum(dim=2, dtype=I64)
    contrib = m & ~torch.isnan(v) if skip_nan else m
    vz = torch.where(contrib, v, 0.0)
    s = _fold_sum(vz)
    ssq = _fold_sum(vz * vz)
    any_contrib = contrib.any(dim=2)
    vmin = torch.where(any_contrib, _min_ieee(torch.where(contrib, v, torch.inf)),
                       torch.nan)
    vmax = torch.where(any_contrib, _max_ieee(torch.where(contrib, v, -torch.inf)),
                       torch.nan)
    # `last` = rightmost datapoint present in the window (the grid is
    # time-ordered, so the highest index is the latest timestamp).
    idx = torch.arange(k, device=v.device)[None, None, :]
    last_pos = torch.where(m, idx, -1).amax(dim=2)
    last = torch.where(last_pos >= 0, _pick(v, last_pos), torch.nan)
    return WindowedAgg(sum=s, sum_sq=ssq, count=count, min=vmin, max=vmax, last=last)


def _check_quantiles(quantiles) -> None:
    for q in quantiles:
        if not 0.0 <= q <= 1.0:
            raise ValueError(f"quantile {q} out of range")


def window_quantiles_plain(
    values: torch.Tensor, mask: torch.Tensor, k: int, quantiles: tuple[float, ...]
) -> torch.Tensor:
    """Plain PyTorch version of ``window_quantiles`` (same arguments)."""
    _check_quantiles(quantiles)
    v = _reshape_windows(values.to(F64), k)
    m = _reshape_windows(mask, k) & ~torch.isnan(v)
    n = m.sum(dim=2, dtype=I32)  # [L, W]
    vs = torch.sort(torch.where(m, v, torch.inf), dim=2, stable=True).values
    outs = []
    for q in quantiles:
        rank = torch.ceil(q * n.to(F64)).to(I32)
        rank = torch.minimum(rank.clamp(min=1), n.clamp(min=1)) - 1  # 0-indexed
        outs.append(torch.where(n > 0, _pick(vs, rank), 0.0))
    if not outs:
        return torch.zeros(v.shape[:2] + (0,), dtype=F64, device=v.device)
    return torch.stack(outs, dim=-1)


_QUANTILE_SIGNATURES = {
    "m3_window_quantiles": [_build.P, _build.P, _build.LL, _build.I, _build.P,
                            _build.I, _build.P, _build.P],
}
MAX_QUANTILES = 32  # kMaxQ of csrc/window_quantiles.cu


def window_quantiles(
    values: torch.Tensor, mask: torch.Tensor, k: int, quantiles: tuple[float, ...]
) -> torch.Tensor:
    """Exact nearest-rank quantiles per window: [L, T//k, Q].

    rank = ceil(q * n) (1-indexed), the target the reference's CM sample
    stream approximates within eps (ref: cm/stream.go:141-175); invalid
    and NaN entries are excluded, and a window with none left yields 0.0.
    """
    if values.device.type == "cpu":
        return window_quantiles_plain(values, mask, k, quantiles)
    if not values.is_cuda:
        raise ValueError(f"unsupported device {values.device}")
    _check_quantiles(quantiles)
    if len(quantiles) > MAX_QUANTILES:
        raise ValueError(f"at most {MAX_QUANTILES} quantiles per call")
    if mask.shape != values.shape or mask.device != values.device:
        raise ValueError("mask must match values in shape and device")
    L, T = values.shape
    if T % k:
        raise ValueError(f"time axis {T} not divisible by window {k}")
    v = values.to(F64).contiguous()
    m = mask.to(torch.bool).contiguous()
    n_windows = L * (T // k)
    out = torch.empty((L, T // k, len(quantiles)), dtype=F64, device=v.device)
    if n_windows and quantiles:
        qs = np.asarray(quantiles, dtype=np.float64)
        lib = _build.library("window_quantiles", _QUANTILE_SIGNATURES)
        rc = lib.m3_window_quantiles(
            v.data_ptr(), m.data_ptr(), n_windows, k, qs.ctypes.data,
            len(quantiles), out.data_ptr(),
            torch.cuda.current_stream(v.device).cuda_stream)
        _build.check(lib, rc, "window_quantiles")
        _build.count_launch("window_quantiles")
    return out


def value_of(
    agg: WindowedAgg,
    agg_type: AggregationType,
    quantile_values: torch.Tensor | None = None,
    quantile_order: tuple[float, ...] = (),
) -> torch.Tensor:
    """ValueOf dispatch (ref: counter.go:107-128, gauge.go:112-137)."""
    t = AggregationType(agg_type)
    if t == AggregationType.LAST:
        return agg.last
    if t == AggregationType.MIN:
        return agg.min
    if t == AggregationType.MAX:
        return agg.max
    if t == AggregationType.MEAN:
        return torch.where(agg.count > 0, agg.sum / agg.count.clamp(min=1), 0.0)
    if t == AggregationType.COUNT:
        return agg.count.to(F64)
    if t == AggregationType.SUM:
        return agg.sum
    if t == AggregationType.SUMSQ:
        return agg.sum_sq
    if t == AggregationType.STDEV:
        return stdev(agg.count, agg.sum_sq, agg.sum)
    if t in QUANTILE_OF_TYPE:
        if quantile_values is None:
            raise ValueError(f"{t.name} requires quantile_values")
        q = QUANTILE_OF_TYPE[t]
        return quantile_values[:, :, quantile_order.index(q)]
    raise ValueError(f"unsupported aggregation type {t}")


def rollup(agg: WindowedAgg, k: int) -> WindowedAgg:
    """Merge adjacent windows k:1 — multi-resolution rollups (10s -> 1m ->
    5m -> 1h) reuse finer windows instead of re-reducing raw samples,
    mirroring multi-stage pipelines (ref: aggregator forwarded_writer.go)."""
    L, W = agg.sum.shape
    if W % k:
        raise ValueError(f"window axis {W} not divisible by {k}")

    def r3(x):
        return x.reshape(L, W // k, k)

    count = r3(agg.count).sum(dim=2)
    nn_min = torch.where(torch.isnan(r3(agg.min)), torch.inf, r3(agg.min))
    nn_max = torch.where(torch.isnan(r3(agg.max)), -torch.inf, r3(agg.max))
    has = (~torch.isnan(r3(agg.min))).any(dim=2)
    # last = rightmost sub-window holding any datapoint; count (not
    # NaN-ness) decides presence because a window's last value may be a
    # real NaN datapoint (gauge semantics keep it).
    sub = r3(agg.last)
    idx = torch.arange(k, device=sub.device)[None, None, :]
    pos = torch.where(r3(agg.count) > 0, idx, -1).amax(dim=2)
    last = _pick(torch.nan_to_num(sub), pos)
    # restore a true-NaN last value for the chosen sub-window
    chosen_nan = torch.gather(torch.isnan(sub), 2,
                              pos.clamp(0, k - 1)[..., None])[..., 0]
    last = torch.where(chosen_nan, torch.nan, last)
    return WindowedAgg(
        sum=_fold_sum(r3(agg.sum)),
        sum_sq=_fold_sum(r3(agg.sum_sq)),
        count=count,
        min=torch.where(has, _min_ieee(nn_min), torch.nan),
        max=torch.where(has, _max_ieee(nn_max), torch.nan),
        last=torch.where(pos >= 0, last, torch.nan),
    )


# --- transformations (ref: src/metrics/transformation/) ---


def transform_absolute(values: torch.Tensor) -> torch.Tensor:
    return torch.abs(values)


def transform_add(values: torch.Tensor) -> torch.Tensor:
    """Running sum along time, NaNs contribute 0 but emit the running
    value (ref: unary.go:46-54)."""
    return torch.cumsum(torch.nan_to_num(values), dim=-1)


def _binary_guard(prev_v, curr_v, prev_t, curr_t):
    ok = (prev_t < curr_t) & ~torch.isnan(prev_v) & ~torch.isnan(curr_v)
    diff = curr_v - prev_v
    return torch.where(ok & (diff >= 0), diff, torch.nan)


def transform_increase(values: torch.Tensor, times: torch.Tensor) -> torch.Tensor:
    """Per-step non-negative difference; first step and any non-monotonic
    or NaN step emit NaN/"empty" (ref: binary.go:71-80)."""
    diff = _binary_guard(values[..., :-1], values[..., 1:], times[..., :-1], times[..., 1:])
    first = torch.full(values.shape[:-1] + (1,), torch.nan, dtype=values.dtype,
                       device=values.device)
    return torch.cat([first, diff], dim=-1)


def transform_persecond(values: torch.Tensor, times: torch.Tensor) -> torch.Tensor:
    """Non-negative rate per second (ref: binary.go:49-59)."""
    diff = _binary_guard(values[..., :-1], values[..., 1:], times[..., :-1], times[..., 1:])
    dt = (times[..., 1:] - times[..., :-1]).to(F64) / 1e9
    rate = diff / torch.where(dt > 0, dt, 1.0)
    first = torch.full(values.shape[:-1] + (1,), torch.nan, dtype=values.dtype,
                       device=values.device)
    return torch.cat([first, rate], dim=-1)


def transform_reset(values: torch.Tensor, times: torch.Tensor):
    """Each datapoint followed by a zero one second later
    (ref: unary_multi.go:43-47).  Returns (values2, times2) with the time
    axis doubled."""
    zeros = torch.zeros_like(values)
    t2 = times + 1_000_000_000
    v = torch.stack([values, zeros], dim=-1).reshape(*values.shape[:-1], -1)
    t = torch.stack([times, t2], dim=-1).reshape(*times.shape[:-1], -1)
    return v, t


TRANSFORM_UNARY = {"absolute": transform_absolute, "add": transform_add}
TRANSFORM_BINARY = {"increase": transform_increase, "persecond": transform_persecond}


class Transformation(enum.IntEnum):
    """Wire enum parity with ref: src/metrics/transformation/type.go:31
    (Absolute/PerSecond/Increase/Add/Reset)."""

    UNKNOWN = 0
    ABSOLUTE = 1
    PERSECOND = 2
    INCREASE = 3
    ADD = 4
    RESET = 5


TRANSFORM_KERNELS = {
    Transformation.ABSOLUTE: ("unary", transform_absolute),
    Transformation.ADD: ("unary", transform_add),
    Transformation.INCREASE: ("binary", transform_increase),
    Transformation.PERSECOND: ("binary", transform_persecond),
    Transformation.RESET: ("unary_multi", transform_reset),
}
