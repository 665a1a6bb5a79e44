"""Device-resident PromQL read pipeline: decode -> merge -> rate/reduce
-> group-by, with only the [series or groups, steps] result leaving the
card.

Port of the per-node serving pipelines of
``m3_tpu/models/query_pipeline.py`` (single device):
``device_rate_pipeline``, ``device_reduce_pipeline`` and
``device_grouped_pipeline``, with the same arguments and the same
result tuples.  Each stage is a hand-written CUDA kernel on the card:

- decode: ``ops/m3tsz_decode.decode_batched`` (K3) at stream width with
  truncation flagged;
- tier cut + merge into ``[n_lanes, n_cap]`` lanes: ``ops/query_merge``
  (QK1);
- the windowed function: ``ops/query_temporal`` (QK2 rate family, QK3
  prefix-sum reducers);
- the group-by and the fleet sum: ``ops/query_grouped`` (QK4).

On CPU tensors (``device="cpu"``) every stage runs its plain PyTorch
version.  Functions whose device form is not ported yet raise
``NotImplementedError`` naming the kernel row that will bring them; they
never route to another form.

Error contract (``_decode_merge``): a stream is flagged when its decode
failed, it did not reach its end within ``n_dp`` records, its lane
overflowed ``n_cap``, or its merged lane is not time-ascending.  Padding
streams have ``nbits == 0`` and park on the last lane; padding lanes
decode all-NaN and are inert in every aggregation.
"""

from __future__ import annotations

import torch

from m3_tpu_torch.models.read_pipeline import inputs_from_numpy
from m3_tpu_torch.ops import query_grouped, query_merge, query_temporal
from m3_tpu_torch.ops.m3tsz_decode import decode_batched
from m3_tpu_torch.utils import xtime
from m3_tpu_torch.utils.device import resolve_device

I64 = torch.int64

# The device forms of the reference's temporal family that later kernel
# rows bring (PERF.md's table); each raises until then.
UNPORTED_TEMPORAL = {
    "min_over_time": "Q3b _minmax_device",
    "max_over_time": "Q3b _minmax_device",
    "stddev_over_time": "Q3c _stdvar_device",
    "stdvar_over_time": "Q3c _stdvar_device",
    "changes": "Q3d _changes_device",
    "resets": "Q3d _changes_device",
    "deriv": "Q3d _linreg_device",
    "predict_linear": "Q3d _linreg_device",
    "holt_winters": "Q4 _holt_winters_device",
    "quantile_over_time": "Q4 _quantile_window_device",
}
TEMPORAL_FNS = (query_temporal.RATE_FNS + query_temporal.INSTANT_FNS
                + query_temporal.REDUCERS)
GROUP_AGGS = query_grouped.AGGS


def _decode_merge(words, nbits, slots, n_lanes: int, n_cap: int, n_dp: int | None,
                  unit_nanos: int, tiers=None, n_tiers: int = 1):
    """Shared front half of every pipeline: batched decode at stream width
    (``n_dp or n_cap``) with truncation flagged, the tier cut when
    ``n_tiers > 1``, the merge into lanes, and the error contract.
    Returns (times i64[n_lanes, n_cap], values f64[n_lanes, n_cap],
    error bool[M])."""
    T = n_cap if n_dp is None else n_dp
    ts, vs, valid, _count, error = decode_batched(
        words, nbits, T, int_optimized=True, unit_nanos=unit_nanos, flag_truncation=True)
    times, values, counts, unsorted = query_merge.lane_merge(
        ts, vs, valid, slots, n_lanes, n_cap, tiers, n_tiers)
    error = error | ((counts > n_cap) | unsorted)[slots]
    return times, values, error


def _temporal_eval(fn: str, times, values, steps, range_nanos: int, horizon=0.0,
                   hw_sf: float = 0.5, hw_tf: float = 0.5, phi=0.5):
    """One dispatch for the windowed temporal family (the reference's
    signature; ``horizon``/``hw_*``/``phi`` belong to unported forms)."""
    _check_fn(fn)
    if fn in query_temporal.RATE_FNS:
        return query_temporal.rate(times, values, steps, range_nanos,
                                   is_counter=fn != "delta", is_rate=fn == "rate")
    if fn in query_temporal.INSTANT_FNS:
        return query_temporal.instant(times, values, steps, range_nanos, is_rate=fn == "irate")
    return query_temporal.reduce_window(times, values, steps, range_nanos, fn)


def _grouped_reduce(out, groups, n_groups: int, agg: str, phi=0.5, csr=None):
    """Group-by of a served [L, S] matrix (the reference's signature)."""
    _check_agg(agg)
    return query_grouped.grouped_reduce(out, groups, n_groups, agg, csr)


def _check_fn(fn: str) -> None:
    if fn in UNPORTED_TEMPORAL:
        raise NotImplementedError(
            f"{fn} has no device form in the port yet: it comes with kernel row "
            f"{UNPORTED_TEMPORAL[fn]}")
    if fn not in TEMPORAL_FNS:
        raise ValueError(f"no device form for {fn}")


def _check_agg(agg: str) -> None:
    if agg == "quantile":
        raise NotImplementedError(
            "quantile has no device form in the port yet: it comes with kernel row "
            "Q5b _grouped_quantile")
    if agg not in GROUP_AGGS:
        raise ValueError(f"no device form for aggregation {agg}")


def _inputs(words, nbits, slots, steps, tiers, device):
    """Everything on one device: the words' own if they are tensors, else
    ``device`` (default the CUDA device)."""
    dev = resolve_device(device, like=words)
    if not isinstance(words, torch.Tensor):
        words, nbits = inputs_from_numpy(words, nbits, dev)
    words, nbits = words.to(dev), nbits.to(dev)

    def i64(x):
        return None if x is None else torch.as_tensor(x, dtype=I64).to(dev)

    return words, nbits, i64(slots), i64(steps), i64(tiers)


def device_reduce_pipeline(words, nbits, slots, steps, n_lanes: int, n_cap: int,
                           range_nanos: int, reducer: str = "sum_over_time",
                           unit_nanos: int = xtime.SECOND, n_dp: int | None = None,
                           tiers=None, n_tiers: int = 1, horizon=0.0, hw_sf: float = 0.5,
                           hw_tf: float = 0.5, phi=0.5, device=None):
    """Compressed blocks -> ``reducer(x[range])`` per (lane, step).
    Returns (out f64[n_lanes, S], error bool[M])."""
    _check_fn(reducer)
    words, nbits, slots, steps, tiers = _inputs(words, nbits, slots, steps, tiers, device)
    times, values, error = _decode_merge(words, nbits, slots, n_lanes, n_cap, n_dp,
                                         unit_nanos, tiers, n_tiers)
    out = _temporal_eval(reducer, times, values, steps, int(range_nanos), horizon, hw_sf,
                         hw_tf, phi)
    return out, error


def device_rate_pipeline(words, nbits, slots, steps, n_lanes: int, n_cap: int,
                         range_nanos: int, is_counter: bool = True, is_rate: bool = True,
                         unit_nanos: int = xtime.SECOND, n_dp: int | None = None, tiers=None,
                         n_tiers: int = 1, device=None):
    """Compressed blocks -> per-series windowed rate.  Returns
    (rate f64[n_lanes, S], fleet_sum f64[S], error bool[M]).

    ``n_dp`` bounds one stream (one sealed block), ``n_cap`` one output
    lane (all of a series' blocks); ``range_nanos`` is a runtime argument
    of the kernels."""
    words, nbits, slots, steps, tiers = _inputs(words, nbits, slots, steps, tiers, device)
    times, values, error = _decode_merge(words, nbits, slots, n_lanes, n_cap, n_dp,
                                         unit_nanos, tiers, n_tiers)
    rate = query_temporal.rate(times, values, steps, int(range_nanos), is_counter, is_rate)
    fleet = query_grouped.fleet_nansum(rate)
    return rate, fleet, error


def device_grouped_pipeline(words, nbits, slots, steps, groups, n_lanes: int, n_groups: int,
                            n_cap: int, range_nanos: int, fn: str = "rate", agg: str = "sum",
                            unit_nanos: int = xtime.SECOND, n_dp: int | None = None,
                            tiers=None, n_tiers: int = 1, phi=0.5, device=None):
    """Compressed blocks -> ``agg by (g) (fn(x[range]))``.  Returns
    (out f64[n_groups, S], error bool[M])."""
    if fn in ("predict_linear", "holt_winters", "quantile_over_time"):
        raise ValueError(f"no grouped device form for {fn}")
    _check_fn(fn)
    _check_agg(agg)
    words, nbits, slots, steps, tiers = _inputs(words, nbits, slots, steps, tiers, device)
    # the group CSR is host glue: build it before the kernels are queued
    csr = query_grouped.group_csr(groups, n_groups) if words.is_cuda else None
    times, values, error = _decode_merge(words, nbits, slots, n_lanes, n_cap, n_dp,
                                         unit_nanos, tiers, n_tiers)
    out = _temporal_eval(fn, times, values, steps, int(range_nanos))
    return _grouped_reduce(out, groups, n_groups, agg, phi, csr), error
