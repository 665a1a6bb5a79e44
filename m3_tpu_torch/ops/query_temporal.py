"""Windowed PromQL temporal functions over merged lanes: the CUDA kernels
QK2 (rate family), QK3 (prefix-sum reducers, changes/resets,
deriv/predict_linear), QK5 (min/max over time), QK9 (stddev/stdvar over
time), QK10 (holt_winters) and QK11 (quantile over time), and their plain
PyTorch versions.

Port of ``m3_tpu/models/query_pipeline.py``: ``_window_bounds_device``,
``_rate_device``, ``_instant_device`` (QK2), the prefix-sum half of
``_reduce_device`` (QK3: sum, avg, count, present and last over time),
``_changes_device`` and ``_linreg_device`` (QK3's further op codes),
``_minmax_device`` (QK5), ``_stdvar_device`` (QK9),
``_holt_winters_device`` (QK10) and ``_quantile_window_device`` (QK11).

- On a CUDA tensor ``rate``, ``instant``, ``reduce_window``,
  ``changes_window``, ``linreg_window``, ``minmax_window``,
  ``stdvar_window`` and ``holt_winters_window`` launch
  ``csrc/query_temporal.cu``: QK2 (rate, instant) a few blocks per SM, each
  taking lanes in turn, a counter's prefix sums in the block's slice of a
  global scratch buffer, one thread per step; QK3 (the reducers, changes,
  the fit) one block a lane, its times and values staged in shared memory
  (up to ``PREFIX_STAGED_MAX_N`` samples; longer lanes read in place), the
  prefix sums scanned in one pass over chunks and kept as chunk totals, not
  rows; QK5, QK9 and QK10 walk each window directly.  ``quantile_window``
  launches QK11 in
  ``csrc/query_select.cu`` (a warp per (lane, 32-step tile) stages the run
  of samples its windows cover; a window of at most 32 samples is sorted
  in its thread's registers, longer ones through one sort of the run), or
  raise.
- On a CPU tensor they run the plain versions below, which follow the
  reference line for line: the same bisection (a fixed number of levels,
  as ``jnp.searchsorted`` runs it, so unsorted lanes get the reference's
  bounds too), the same prefix sums and the same f64 order of operations.

Lanes are ``times i64[L, N]`` (ascending, INT64_MAX-padded) and
``values f64[L, N]`` (NaN-padded); ``steps`` is ``i64[S]``; ``range_nanos``
is a plain integer argument of the kernel, never part of its build.
"""

from __future__ import annotations

import ctypes
import math

import torch

from m3_tpu_torch.ops import _build, ieee

I64 = torch.int64
F64 = torch.float64
INT64_MAX = torch.iinfo(torch.int64).max

RATE_FNS = ("rate", "increase", "delta")
INSTANT_FNS = ("irate", "idelta")
REDUCERS = ("sum_over_time", "avg_over_time", "count_over_time", "present_over_time",
            "last_over_time")
MINMAX_FNS = ("min_over_time", "max_over_time")
CHANGES_FNS = ("changes", "resets")
LINREG_FNS = ("deriv", "predict_linear")
STDVAR_FNS = ("stddev_over_time", "stdvar_over_time")
# the windowed functions with a kernel of their own (QK10, QK11)
WINDOW_FNS = ("holt_winters", "quantile_over_time")
_OP_RATE, _OP_INSTANT = 0, 1
_OP_OF_REDUCER = {name: 2 + i for i, name in enumerate(REDUCERS)}  # enum Op of the kernel
_OP_CHANGES, _OP_RESETS, _OP_DERIV, _OP_PREDICT = 7, 8, 9, 10
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
        dur_start = ieee.minimum(dur_start, dur_to_zero)
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


def minmax_plain(times, values, steps, range_nanos: int, is_max: bool):
    """Plain version of ``minmax_window``: the windows' bounds, then one
    pass per window offset (as many as the longest window), keeping the
    IEEE max of the present samples (min as -max(-v), as the reference
    computes it); a window with no present sample is NaN.  The longest
    window is read back to the host: this version is a yardstick, not a
    serving path."""
    _, left, right = window_bounds_plain(times, steps, range_nanos)
    N = values.shape[1]
    vm = values if is_max else -values
    acc = torch.full(left.shape, -torch.inf, dtype=F64, device=values.device)
    n = torch.zeros(left.shape, dtype=I64, device=values.device)
    width = int((right - left).max()) if left.numel() else 0
    for o in range(width):
        idx = left + o
        x = _take(vm, idx.clamp(0, N - 1))
        take = (idx < right) & ~torch.isnan(x)
        acc = torch.where(take, ieee.maximum(acc, x), acc)
        n = n + take.to(I64)
    return torch.where(n > 0, acc if is_max else -acc, torch.nan)


def changes_plain(times, values, steps, range_nanos: int, resets_only: bool):
    """Plain version of ``changes``: prefix sums of the pair flags
    ``curr != prev`` (resets: ``curr < prev``; a NaN on either side gives
    0), a pair (i, i + 1) counted when left <= i and i + 1 < right; an
    empty window is NaN."""
    L, N = values.shape
    _, left, right = window_bounds_plain(times, steps, range_nanos)
    prev, curr = values[:, :-1], values[:, 1:]
    flags = (curr < prev) if resets_only else (curr != prev)
    flags = flags & ~(torch.isnan(prev) | torch.isnan(curr))
    zero = torch.zeros((L, 1), dtype=I64, device=values.device)
    cum = torch.cat([zero, torch.cumsum(flags, dim=1)], dim=1)
    out = (_take(cum, (right - 1).clamp(0, N - 1)) - _take(cum, left.clamp(0, N - 1))).to(F64)
    return torch.where(right > left, out, torch.nan)


def linreg_plain(times, values, steps, range_nanos: int):
    """Plain version of the least-squares fit of ``deriv`` and
    ``predict_linear``: five windowed prefix sums (n, sum v, sum t, sum tv,
    sum tt; t in seconds from ``steps[0] - range``, NaN samples absent,
    +-Inf as +-DBL_MAX), recentred on each step in closed form.  Returns
    (slope, intercept at the step), NaN where n < 2 or |denom| <= 1e-30."""
    L, N = values.shape
    _, left, right = window_bounds_plain(times, steps, range_nanos)
    vz = torch.nan_to_num(values)
    ok = (~torch.isnan(values)).to(F64)
    origin = steps[0] - range_nanos
    tsec = (torch.where(times == INT64_MAX, origin, times) - origin).to(F64) * NANO
    zero = torch.zeros((L, 1), dtype=F64, device=values.device)

    def wsum(x):
        cum = torch.cat([zero, torch.cumsum(x, dim=1)], dim=1)
        return _take(cum, right) - _take(cum, left)

    n = wsum(ok)
    sv = wsum(vz * ok)
    st = wsum(tsec * ok)
    stv = wsum(tsec * vz * ok)
    stt = wsum(tsec * tsec * ok)
    step_sec = (steps - origin).to(F64)[None, :] * NANO
    st_ = st - n * step_sec
    stv_ = stv - step_sec * sv
    stt_ = stt - 2 * step_sec * st + n * step_sec * step_sec
    denom = n * stt_ - st_ * st_
    slope = (n * stv_ - st_ * sv) / denom
    nn = torch.clamp(n, min=1.0)
    intercept = sv / nn - slope * (st_ / nn)
    valid = (n >= 2) & (denom.abs() > 1e-30)
    return torch.where(valid, slope, torch.nan), torch.where(valid, intercept, torch.nan)


def linreg_conditioning(times, values, steps, range_nanos: int) -> torch.Tensor:
    """f64[L, S]: the first-order error of ``linreg_plain``'s slope when
    each of its prefix sums (sum v, t, t*v, t*t) carries one rounding of
    its magnitude (eps/2 times the sum of |terms| up to the window's end),
    carried through the recentring and the closed form.  Two summation
    orders of the prefix sums (XLA's, a sequential one, the kernel's tiles)
    give slopes that differ on this scale: large on 1e9-offset lanes, where
    the sums of 1e9 * t terms cancel (ROADMAP queue 3)."""
    L, N = values.shape
    _, left, right = window_bounds_plain(times, steps, range_nanos)
    ok = ~torch.isnan(values)
    vz = torch.nan_to_num(values)
    origin = steps[0] - range_nanos
    tsec = (torch.where(times == INT64_MAX, origin, times) - origin).to(F64) * NANO
    zero = torch.zeros((L, 1), dtype=F64, device=values.device)

    def cum(x):
        return torch.cat([zero, torch.cumsum(torch.where(ok, x, 0.0), dim=1)], dim=1)

    def wsum(x):
        c = cum(x)
        return _take(c, right) - _take(c, left)

    def mag(x):
        return torch.finfo(F64).eps / 2 * _take(cum(x.abs()), right)

    n, sv, st = wsum(torch.ones_like(vz)), wsum(vz), wsum(tsec)
    step_sec = (steps - origin).to(F64)[None, :] * NANO
    st_ = st - n * step_sec
    stv_ = wsum(tsec * vz) - step_sec * sv
    stt_ = wsum(tsec * tsec) - 2 * step_sec * st + n * step_sec * step_sec
    denom = n * stt_ - st_ * st_
    slope = (n * stv_ - st_ * sv) / denom
    d_sv, d_st = mag(vz), mag(tsec)
    d_stv = mag(tsec * vz) + step_sec.abs() * d_sv
    d_stt = mag(tsec * tsec) + 2 * step_sec.abs() * d_st
    num = n * d_stv + sv.abs() * d_st + st_.abs() * d_sv
    den = n * d_stt + 2 * st_.abs() * d_st
    return torch.nan_to_num((num + slope.abs() * den) / denom.abs(), nan=0.0)


def _longest_window(left, right):
    """The longest window (read back to the host: the loop versions below
    are yardsticks, not serving paths)."""
    return int((right - left).max()) if left.numel() else 0


def stdvar_plain(times, values, steps, range_nanos: int, is_stddev: bool):
    """Plain version of ``stdvar_window``: the population variance of each
    window's present samples by a direct two-pass (the mean, then the sum
    of squared deviations, both in sample order); an empty window is NaN,
    a window of only NaN samples 0.0; stddev = sqrt(max(var, 0))."""
    _, left, right = window_bounds_plain(times, steps, range_nanos)
    N = values.shape[1]
    width = _longest_window(left, right)
    zero = torch.zeros(left.shape, dtype=F64, device=values.device)
    s, n, m2 = zero, zero, zero
    cells = []
    for o in range(width):
        idx = left + o
        x = _take(values, idx.clamp(0, N - 1))
        take = (idx < right) & ~torch.isnan(x)
        cells.append((x, take))
        s = torch.where(take, s + x, s)
        n = torch.where(take, n + 1.0, n)
    nn = torch.clamp(n, min=1.0)
    mean = s / nn
    for x, take in cells:
        d = x - mean
        m2 = torch.where(take, m2 + d * d, m2)
    var = m2 / nn
    if is_stddev:
        var = torch.sqrt(torch.clamp(var, min=0.0))
    return torch.where(right > left, var, torch.nan)


def holt_winters_plain(times, values, steps, range_nanos: int, sf: float, tf: float):
    """Plain version of ``holt_winters_window``: per window, level = the
    first present sample, trend = second - first, then from the second
    present sample on level' = sf*x + (1-sf)*(level+trend), trend' =
    tf*(level'-level) + (1-tf)*trend; fewer than 2 present samples: NaN."""
    _, left, right = window_bounds_plain(times, steps, range_nanos)
    N = values.shape[1]
    sf, tf = float(sf), float(tf)
    zero = torch.zeros(left.shape, dtype=F64, device=values.device)
    level, trend = zero, zero
    seen = torch.zeros(left.shape, dtype=I64, device=values.device)
    for o in range(_longest_window(left, right)):
        idx = left + o
        x = _take(values, idx.clamp(0, N - 1))
        take = (idx < right) & ~torch.isnan(x)
        first, second = take & (seen == 0), take & (seen == 1)
        trend = torch.where(second, x - level, trend)
        nl = sf * x + (1.0 - sf) * (level + trend)
        nt = tf * (nl - level) + (1.0 - tf) * trend
        upd = take & (seen >= 1)
        level = torch.where(first, x, torch.where(upd, nl, level))
        trend = torch.where(upd, nt, trend)
        seen = seen + take.to(I64)
    return torch.where(seen >= 2, level, torch.nan)


def check_phi(phi) -> float:
    phi = float(phi)
    if not 0.0 <= phi <= 1.0:
        raise ValueError(f"quantile_over_time's phi must lie in [0, 1], got {phi}")
    return phi


QUANTILE_CHUNK = 1 << 26  # window-grid cells per chunk of lanes of the plain version


def quantile_window_plain(times, values, steps, range_nanos: int, phi):
    """Plain version of ``quantile_window``, the reference's formulation
    over a window grid as wide as the longest window (in chunks of lanes):
    the window's samples keyed +inf where absent, a sort along the window,
    and v_lo + (v_hi - v_lo) * frac at h = phi * max(n - 1, 0) between the
    floor(h)-th and ceil(h)-th sorted keys; no present sample: NaN."""
    phi = check_phi(phi)
    _, left, right = window_bounds_plain(times, steps, range_nanos)
    L, N = values.shape
    S = left.shape[1]
    W = max(_longest_window(left, right), 1)
    out = torch.empty((L, S), dtype=F64, device=values.device)
    off = torch.arange(W, device=values.device)
    step = max(1, QUANTILE_CHUNK // max(S * W, 1))
    for lo in range(0, L, step):
        hi = min(L, lo + step)
        idx = left[lo:hi, :, None] + off
        inw = idx < right[lo:hi, :, None]
        v = torch.gather(values[lo:hi, None, :].expand(hi - lo, S, N), 2, idx.clamp(0, N - 1))
        pres = inw & ~torch.isnan(v)
        vs = torch.sort(torch.where(pres, v, torch.inf), dim=2, stable=True).values
        n = pres.sum(dim=2).to(F64)
        h = phi * torch.clamp(n - 1.0, min=0.0)
        fl = torch.floor(h)
        frac = h - fl
        v_lo = torch.gather(vs, 2, fl.to(I64).clamp(0, W - 1)[:, :, None])[:, :, 0]
        v_hi = torch.gather(vs, 2, torch.ceil(h).to(I64).clamp(0, W - 1)[:, :, None])[:, :, 0]
        out[lo:hi] = torch.where(n > 0, v_lo + (v_hi - v_lo) * frac, torch.nan)
    return out


def _check_reducer(reducer: str) -> None:
    if reducer not in REDUCERS:
        raise ValueError(f"no prefix-sum form for {reducer}")


# --- wrappers: CUDA tensor -> kernel, CPU tensor -> plain version --------

_LANES = [_build.P, _build.P, _build.P, _build.LL, _build.LL, _build.I, _build.I, _build.LL]
_SIGNATURES = {
    "m3_query_temporal": _LANES + [_build.I, _build.I, _build.I, _build.P, _build.P, _build.P,
                                   _build.P, _build.I, _build.P],
    "m3_query_prefix": _LANES + [_build.I, _build.D, _build.P, _build.P, _build.P, _build.P],
    "m3_query_prefix_layout": [_build.I, _build.LL, _build.P],
    "m3_query_minmax": _LANES + [_build.I, _build.P, _build.I, _build.P],
    "m3_query_stdvar": _LANES + [_build.I, _build.P, _build.I, _build.P],
    "m3_query_holt_winters": _LANES + [_build.D, _build.D, _build.P, _build.I, _build.P],
}
_QUANTILE_SIGNATURES = {
    "m3_quantile_window": _LANES + [_build.D, _build.P, _build.P, _build.LL, _build.P,
                                    _build.P, _build.P, _build.I, _build.I, _build.P],
}
# 128-thread blocks per SM of QK2 (and QK5, QK9, QK10); each QK2 block's
# prefix scratch is [N + 1]
BLOCKS_PER_SM = 8
# QK3 stages a lane's times and values in shared memory up to this many
# samples (csrc/query_temporal.cu: kStagedMaxN) and reads longer lanes in place
PREFIX_STAGED_MAX_N = 6144


def _check_lanes(times, values, steps):
    if times.dim() != 2 or values.shape != times.shape:
        raise ValueError("times and values must be [L, N] of one shape")
    if steps.dim() != 1 or steps.device != times.device or values.device != times.device:
        raise ValueError("steps must be [S] on the device of times")
    if times.shape[1] < 1:
        raise ValueError("lanes need at least one sample slot (n_cap >= 1)")
    return times.to(I64).contiguous(), values.to(F64).contiguous(), steps.to(I64).contiguous()


def _n_blocks(L: int, dev, per_sm: int = BLOCKS_PER_SM) -> int:
    return min(L, torch.cuda.get_device_properties(dev).multi_processor_count * per_sm)


def _launch(times, values, steps, range_nanos: int, op: int, is_counter: bool, is_rate: bool,
            kernel: str, with_bounds: bool, horizon: float = 0.0):
    """One launch of QK2 (op codes 0-1, ``temporal_kernel``) or QK3 (op
    codes 2-10, ``prefix_kernel``: one block a lane, no scratch)."""
    t, v, st = _check_lanes(times, values, steps)
    L, N = t.shape
    S = st.shape[0]
    dev = t.device
    out = torch.empty((L, S), dtype=F64, device=dev)
    left = right = None
    if with_bounds:
        left = torch.empty((L, S), dtype=I64, device=dev)
        right = torch.empty((L, S), dtype=I64, device=dev)
    if L and S:
        lib = _build.library("query_temporal", _SIGNATURES)
        stream = torch.cuda.current_stream(dev).cuda_stream
        bounds = (None if left is None else left.data_ptr(),
                  None if right is None else right.data_ptr())
        lanes = (t.data_ptr(), v.data_ptr(), st.data_ptr(), L, N, S, search_levels(N),
                 int(range_nanos), op)
        if op in (_OP_RATE, _OP_INSTANT):
            n_blocks = _n_blocks(L, dev)
            prefix = torch.empty((n_blocks, N + 1), dtype=F64, device=dev)
            rc = lib.m3_query_temporal(*lanes, int(is_counter), int(is_rate), out.data_ptr(),
                                       *bounds, prefix.data_ptr(), n_blocks, stream)
        else:
            rc = lib.m3_query_prefix(*lanes, float(horizon), out.data_ptr(), *bounds, stream)
        _build.check(lib, rc, kernel)
        _build.count_launch(kernel)
    return (out, left, right) if with_bounds else out


def prefix_layout(op: int, n: int) -> dict[str, int]:
    """How QK3's kernel for op code ``op`` sits on the current CUDA card on
    lanes of ``n`` samples: staged (1) or read in place (0), dynamic shared
    bytes a block, resident blocks per SM, registers a thread and threads a
    block.  Builds the library if needed; needs a card."""
    lib = _build.library("query_temporal", _SIGNATURES)
    buf = (ctypes.c_int * 5)()
    _build.check(lib, lib.m3_query_prefix_layout(op, n, buf), "query_prefix layout")
    return dict(zip(("staged", "smem_bytes", "blocks_per_sm", "registers", "threads"), buf))


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


def minmax_window(times, values, steps, range_nanos: int, is_max: bool) -> torch.Tensor:
    """max_over_time (``is_max``) or min_over_time per (lane, step) -> f64[L, S]."""
    if _device_of(times) == "cpu":
        return minmax_plain(times, values, steps, range_nanos, is_max)
    return _launch_window("m3_query_minmax", "query_minmax", times, values, steps, range_nanos,
                          int(is_max))


def _launch_window(entry: str, kernel: str, times, values, steps, range_nanos: int,
                   *args) -> torch.Tensor:
    """One launch of a window-walking kernel of ``csrc/query_temporal.cu``
    (QK5, QK9, QK10: a block per lane in turn, a thread per step);
    ``args`` are the entry's own arguments before ``out``."""
    t, v, st = _check_lanes(times, values, steps)
    L, N = t.shape
    S = st.shape[0]
    out = torch.empty((L, S), dtype=F64, device=t.device)
    if L and S:
        lib = _build.library("query_temporal", _SIGNATURES)
        rc = getattr(lib, entry)(
            t.data_ptr(), v.data_ptr(), st.data_ptr(), L, N, S, search_levels(N),
            int(range_nanos), *args, out.data_ptr(), _n_blocks(L, t.device),
            torch.cuda.current_stream(t.device).cuda_stream)
        _build.check(lib, rc, kernel)
        _build.count_launch(kernel)
    return out


def changes_window(times, values, steps, range_nanos: int, resets_only: bool) -> torch.Tensor:
    """resets (``resets_only``) or changes per (lane, step) -> f64[L, S]."""
    if _device_of(times) == "cpu":
        return changes_plain(times, values, steps, range_nanos, resets_only)
    return _launch(times, values, steps, range_nanos, _OP_RESETS if resets_only else _OP_CHANGES,
                   False, False, "query_changes", False)


def linreg_window(times, values, steps, range_nanos: int, predict: bool,
                  horizon: float = 0.0) -> torch.Tensor:
    """deriv, or predict_linear ``horizon`` seconds ahead (``predict``), per
    (lane, step) -> f64[L, S]; ``horizon`` is a kernel argument."""
    if _device_of(times) == "cpu":
        slope, intercept = linreg_plain(times, values, steps, range_nanos)
        return intercept + slope * float(horizon) if predict else slope
    return _launch(times, values, steps, range_nanos, _OP_PREDICT if predict else _OP_DERIV,
                   False, False, "query_linreg", False, horizon)


def stdvar_window(times, values, steps, range_nanos: int, is_stddev: bool) -> torch.Tensor:
    """stddev_over_time (``is_stddev``) or stdvar_over_time per (lane,
    step) -> f64[L, S]."""
    if _device_of(times) == "cpu":
        return stdvar_plain(times, values, steps, range_nanos, is_stddev)
    return _launch_window("m3_query_stdvar", "query_stdvar", times, values, steps, range_nanos,
                          int(is_stddev))


def holt_winters_window(times, values, steps, range_nanos: int, sf: float,
                        tf: float) -> torch.Tensor:
    """holt_winters(x[range], sf, tf) per (lane, step) -> f64[L, S]; the
    factors are kernel arguments."""
    if _device_of(times) == "cpu":
        return holt_winters_plain(times, values, steps, range_nanos, sf, tf)
    return _launch_window("m3_query_holt_winters", "query_holt_winters", times, values, steps,
                          range_nanos, float(sf), float(tf))


# QK11's two launches (csrc/query_select.cu): the short-run kernel, 8 warps a
# block (as many blocks as the card holds at once), each unit a (lane,
# 32-step tile) whose windows lie in a run of at most QUANTILE_REGION
# samples; the long-run kernel, QUANTILE_LONG_WARPS warps a block, the units
# it lists (runs of at most QUANTILE_LONG_REGION samples, longer ones a
# window at a time, past QUANTILE_LONG_REGION samples in a global scratch of
# the padded lane length a warp)
QUANTILE_WARPS, QUANTILE_LONG_WARPS = 8, 4
QUANTILE_LONG_BLOCKS_PER_SM = 2  # 104 KB of shared memory a block
QUANTILE_REGION, QUANTILE_LONG_REGION = 256, 1024


def quantile_window(times, values, steps, range_nanos: int, phi) -> torch.Tensor:
    """quantile_over_time(phi, x[range]) per (lane, step) -> f64[L, S];
    ``phi`` is a kernel argument in [0, 1] (others raise)."""
    phi = check_phi(phi)
    if _device_of(times) == "cpu":
        return quantile_window_plain(times, values, steps, range_nanos, phi)
    return _launch_quantile(times, values, steps, range_nanos, phi)


def _launch_quantile(times, values, steps, range_nanos: int, phi: float) -> torch.Tensor:
    t, v, st = _check_lanes(times, values, steps)
    L, N = t.shape
    S = st.shape[0]
    dev = t.device
    out = torch.empty((L, S), dtype=F64, device=dev)
    if L and S:
        n_units = L * -(-S // 32)
        grid = -(-n_units // QUANTILE_WARPS)  # the entry caps it at one wave
        long_grid = (torch.cuda.get_device_properties(dev).multi_processor_count
                     * QUANTILE_LONG_BLOCKS_PER_SM)
        listed = torch.empty((n_units,), dtype=I64, device=dev)
        n_listed = torch.empty((1,), dtype=I64, device=dev)
        # a window never holds more than the lane's N samples: windows past
        # QUANTILE_LONG_REGION sort in the warp's slice of a global scratch
        p_lane = 1 << max(N - 1, 0).bit_length()
        p_scratch = p_lane if p_lane > QUANTILE_LONG_REGION else 0
        warps = long_grid * QUANTILE_LONG_WARPS
        keys = torch.empty((warps * p_scratch,), dtype=I64, device=dev)
        pos = torch.empty((warps * p_scratch,), dtype=torch.int32, device=dev)
        lib = _build.library("query_select", _QUANTILE_SIGNATURES)
        rc = lib.m3_quantile_window(
            t.data_ptr(), v.data_ptr(), st.data_ptr(), L, N, S, search_levels(N),
            int(range_nanos), phi, listed.data_ptr(), n_listed.data_ptr(), p_scratch,
            keys.data_ptr() if p_scratch else None, pos.data_ptr() if p_scratch else None,
            out.data_ptr(), grid, long_grid, torch.cuda.current_stream(dev).cuda_stream)
        _build.check(lib, rc, "query_quantile_window")
        _build.count_launch("query_quantile_window")
    return out
