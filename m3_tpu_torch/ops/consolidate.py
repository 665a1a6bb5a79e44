"""Step consolidation + temporal window functions over sample batches:
the numpy host tier of the query path.

Copy of ``m3_tpu/ops/consolidate.py`` (the functions the query slice
needs: packing and merging, window bounds, step consolidation,
``extrapolated_rate``, ``window_reduce``, and the rest of the temporal
family: ``window_quantile``, ``window_changes`` with
``_pair_window_count``, ``window_linreg`` and ``window_holt_winters``), in
its numpy formulation only.  The reference routes large
batches through its native C++ kernels (``m3_tpu.utils.native``); those
branches are left out here until the port carries a copied loader, so
this module is the readable reference and the host oracle that
``chip_smoke.py`` holds the device pipelines against.

Read-path semantics mirror the reference's query engine:

- step consolidation: for each step time t, the LAST datapoint in
  [t - lookback, t] (ref: src/query/ts/m3db/consolidators/
  step_consolidator.go:118 ConsolidateAndMoveToNext; default lookback
  5m, ts/m3db/options.go).
- temporal functions (rate/increase/delta/...): Prometheus-compatible
  extrapolated rate over the raw samples in [t - range, t]
  (ref: src/query/functions/temporal/rate.go, which vendors upstream
  Prometheus semantics).

Batch layout: ragged sample sets padded to [L, N] — times +inf-padded
ascending, values NaN-padded, per-lane counts.
"""

from __future__ import annotations

import numpy as np

DEFAULT_LOOKBACK = 5 * 60 * 1_000_000_000
_INF = np.iinfo(np.int64).max


def pack_valid(ts: np.ndarray, vs: np.ndarray, valid: np.ndarray):
    """Left-justify valid samples: [L, T] grids -> (times [L, N] +inf-pad,
    values [L, N], counts [L]) with N = max per-lane count."""
    ts, vs, valid = np.asarray(ts), np.asarray(vs), np.asarray(valid)
    counts = valid.sum(axis=1)
    n = max(int(counts.max()), 1) if counts.size else 1
    order = np.argsort(~valid, axis=1, kind="stable")
    ts_p = np.take_along_axis(ts, order, axis=1)[:, :n].copy()
    vs_p = np.take_along_axis(vs, order, axis=1)[:, :n].copy()
    idx = np.arange(n)[None, :]
    pad = idx >= counts[:, None]
    ts_p[pad] = _INF
    vs_p[pad] = np.nan
    return ts_p, vs_p, counts


def pad_grid(ts: np.ndarray, vs: np.ndarray, n_lanes: int, n_cap: int):
    """Pad a packed [L, N] sample batch to the bucketed [n_lanes, n_cap]
    shape the device pipelines take (+inf/NaN padding, same fill
    contract as merge_packed): padding lanes are all-NaN by
    construction."""
    L, N = ts.shape
    ts_p = np.full((n_lanes, n_cap), _INF, dtype=np.int64)
    vs_p = np.full((n_lanes, n_cap), np.nan)
    ts_p[:L, :N] = ts
    vs_p[:L, :N] = vs
    return ts_p, vs_p


def merge_packed(parts: list[tuple[np.ndarray, np.ndarray]], n_lanes: int):
    """Merge per-block (lane, times, values) fragments for each lane into
    one packed batch (fragments are time-ordered and disjoint).

    Vectorized: one global (lane, time) lexsort + one scatter."""
    if not parts or not n_lanes:
        counts = np.zeros(n_lanes, dtype=np.int64)
        return (np.full((n_lanes, 1), _INF, dtype=np.int64),
                np.full((n_lanes, 1), np.nan), counts)
    frag_lens = np.asarray([len(t) for _, t, _ in parts], dtype=np.int64)
    lanes = np.repeat(
        np.asarray([lane for lane, _, _ in parts], dtype=np.int64),
        frag_lens)
    t_all = np.concatenate([t for _, t, _ in parts])
    v_all = np.concatenate([v for _, _, v in parts])
    order = np.lexsort((t_all, lanes))  # stable: fragment order kept
    lanes_s, t_s, v_s = lanes[order], t_all[order], v_all[order]
    counts = np.bincount(lanes, minlength=n_lanes).astype(np.int64)
    n = max(int(counts.max()), 1)
    lane_starts = np.concatenate(([0], np.cumsum(counts)[:-1]))
    pos = np.arange(len(t_s)) - np.repeat(lane_starts, counts)
    ts = np.full((n_lanes, n), _INF, dtype=np.int64)
    vs = np.full((n_lanes, n), np.nan)
    ts[lanes_s, pos] = t_s
    vs[lanes_s, pos] = v_s
    return ts, vs, counts


def merge_grids(slots: np.ndarray, ts: np.ndarray, vs: np.ndarray,
                valid: np.ndarray, n_lanes: int,
                t_min_excl: int | None = None,
                t_max_incl: int | None = None):
    """Merge decoded per-(series, block) grids straight into the packed
    [n_lanes, N] batch: slots[m] is the output lane of grid row m.

    One flat mask + one scatter — no global sort in the common case
    (rows grouped by slot in block-time order, timestamps ascending
    within a row, which is how the read path emits them; violations are
    detected and handled with one lexsort).  The optional time clamp
    folds the query-range filter into the same pass.  Returns
    (times [L, N] +inf-pad, values [L, N], counts [L])."""
    valid = np.asarray(valid)
    mask = valid
    if t_min_excl is not None:
        mask = mask & (ts > t_min_excl)
    if t_max_incl is not None:
        mask = mask & (ts <= t_max_incl)
    flat = mask.ravel()
    t_flat = ts.ravel()[flat]
    v_flat = vs.ravel()[flat]
    row_counts = mask.sum(axis=1)
    slot_flat = np.repeat(np.asarray(slots, dtype=np.int64), row_counts)
    total = len(t_flat)
    if total:
        grouped = bool(np.all(slot_flat[1:] >= slot_flat[:-1]))
        in_order = grouped and bool(np.all(
            (t_flat[1:] > t_flat[:-1])
            | (slot_flat[1:] != slot_flat[:-1])))
        if not in_order:
            order = np.lexsort((t_flat, slot_flat))
            slot_flat, t_flat, v_flat = (slot_flat[order], t_flat[order],
                                         v_flat[order])
    counts = np.bincount(slot_flat, minlength=n_lanes).astype(np.int64)
    n = max(int(counts.max()), 1) if n_lanes else 1
    lane_starts = np.concatenate(([0], np.cumsum(counts)[:-1]))
    pos = np.arange(total) - np.repeat(lane_starts, counts)
    out_t = np.full((n_lanes, n), _INF, dtype=np.int64)
    out_v = np.full((n_lanes, n), np.nan)
    out_t[slot_flat, pos] = t_flat
    out_v[slot_flat, pos] = v_flat
    return out_t, out_v, counts


def _window_bounds(times: np.ndarray, starts_excl: np.ndarray, ends_incl: np.ndarray):
    """Per (lane, step) index bounds [left, right) of samples in
    (start, end].  times: [L, N] ascending (+inf pad)."""
    # Inverted search: each SAMPLE binary-searches the (small) sorted
    # step arrays instead of each (lane, step) query searching the
    # (large) sample matrix; a per-(lane, bin) bincount + a row cumsum
    # yields all bounds in O(M log S + L*S).
    L, N = times.shape
    S = len(ends_incl)
    if L == 0 or N == 0 or S == 0:
        z = np.zeros((L, S), dtype=np.int64)
        return z, z.copy()
    starts_excl = np.asarray(starts_excl, dtype=np.int64)
    ends_incl = np.asarray(ends_incl, dtype=np.int64)
    # shared-grid fast path: when every lane carries the same timestamps
    # (regular scrape intervals), one 1D search answers all lanes
    if L > 1 and times[0, 0] == times[-1, 0] and times[0, -1] == times[-1, -1] \
            and bool((times == times[0]).all()):
        t0 = times[0]
        left1 = np.searchsorted(t0, starts_excl, side="right")
        right1 = np.searchsorted(t0, ends_incl, side="right")
        return (np.broadcast_to(left1, (L, S)),
                np.broadcast_to(right1, (L, S)))
    if (np.all(starts_excl[1:] >= starts_excl[:-1])
            and np.all(ends_incl[1:] >= ends_incl[:-1])):
        flat_t = times.ravel()  # +inf pads land in bin S (never counted)
        key = np.repeat(
            np.arange(L, dtype=np.int64) * (S + 1), N)

        def bounds(edges):
            a = np.searchsorted(edges, flat_t, side="left")
            a += key
            b = np.bincount(a, minlength=L * (S + 1)).reshape(L, S + 1)
            return np.cumsum(b[:, :S], axis=1)

        return bounds(starts_excl), bounds(ends_incl)
    # non-monotone step times (never produced by the engine): per-lane
    left = np.empty((L, S), dtype=np.int64)
    right = np.empty((L, S), dtype=np.int64)
    for lane in range(L):
        t = times[lane]
        left[lane] = np.searchsorted(t, starts_excl, side="right")
        right[lane] = np.searchsorted(t, ends_incl, side="right")
    return left, right


def _range_left(step_times: np.ndarray, range_nanos: int) -> np.ndarray:
    """Left bound for range-vector windows: [t - range, t] INCLUSIVE on
    both ends (a sample exactly `range` old participates; _window_bounds
    treats its start as exclusive, hence the -1ns)."""
    return step_times - range_nanos - 1


def step_consolidate(
    times: np.ndarray,
    values: np.ndarray,
    step_times: np.ndarray,
    lookback_nanos: int = DEFAULT_LOOKBACK,
) -> np.ndarray:
    """[L, S] instant values: last sample in [t - lookback, t] per step
    (left-INCLUSIVE, like the range selectors — see _range_left)."""
    step_times = np.asarray(step_times, dtype=np.int64)
    left, right = _window_bounds(
        times, step_times - lookback_nanos - 1, step_times)
    has = right > left
    idx = np.clip(right - 1, 0, times.shape[1] - 1)
    picked = np.take_along_axis(values, idx, axis=1)
    return np.where(has, picked, np.nan)


def _window_firstlast(times, values, left, right):
    has2 = right - left >= 2
    has1 = right - left >= 1
    i_first = np.clip(left, 0, times.shape[1] - 1)
    i_last = np.clip(right - 1, 0, times.shape[1] - 1)
    t_first = np.take_along_axis(times, i_first, axis=1)
    t_last = np.take_along_axis(times, i_last, axis=1)
    v_first = np.take_along_axis(values, i_first, axis=1)
    v_last = np.take_along_axis(values, i_last, axis=1)
    return has1, has2, t_first, t_last, v_first, v_last


def extrapolated_rate(
    times: np.ndarray,
    values: np.ndarray,
    step_times: np.ndarray,
    range_nanos: int,
    is_counter: bool,
    is_rate: bool,
) -> np.ndarray:
    """Prometheus extrapolatedRate (rate/increase/delta) at each step.

    Upstream semantics: needs >= 2 samples in the window, counter reset
    correction, extrapolation to window boundaries capped at 1.1x the
    average sample spacing (and half of it otherwise), zero-floor
    extrapolation for counters."""
    step_times = np.asarray(step_times, dtype=np.int64)
    range_starts = _range_left(step_times, range_nanos)
    left, right = _window_bounds(times, range_starts, step_times)
    has1, has2, t_first, t_last, v_first, v_last = _window_firstlast(
        times, values, left, right
    )

    # counter reset corrections via prefix sums over adjacent-pair resets
    L, N = values.shape
    if is_counter and N > 1:
        prev = values[:, :-1]
        curr = values[:, 1:]
        # NaN comparisons are False, so curr < prev already excludes
        # NaN pairs
        resets = np.where(curr < prev, prev, 0.0)
        cum = np.empty((L, N))  # cum[i] = resets among pairs ending <= i
        cum[:, 0] = 0.0
        np.cumsum(resets, axis=1, out=cum[:, 1:])
        corr = np.take_along_axis(cum, np.clip(right - 1, 0, N - 1), axis=1) - \
            np.take_along_axis(cum, np.clip(left, 0, N - 1), axis=1)
        corr = np.where(has2, corr, 0.0)
    else:
        corr = 0.0

    result = v_last - v_first + corr

    sampled = (t_last - t_first).astype(np.float64)
    n_samples = (right - left).astype(np.float64)
    avg_dur = np.where(has2, sampled / np.maximum(n_samples - 1, 1), 0.0)
    dur_start = (t_first - range_starts[None, :]).astype(np.float64)
    dur_end = (step_times[None, :] - t_last).astype(np.float64)
    threshold = avg_dur * 1.1

    if is_counter:
        # a counter cannot extrapolate below zero: the zero-cutoff caps
        # durationToStart BEFORE the threshold decision (upstream
        # extrapolatedRate ordering)
        with np.errstate(divide="ignore", invalid="ignore"):
            dur_to_zero = np.where(
                (result > 0) & (v_first >= 0),
                sampled * v_first / np.where(result > 0, result, 1.0),
                np.inf)
        dur_start = np.minimum(dur_start, dur_to_zero)
    extrap_start = np.where(dur_start < threshold, dur_start, avg_dur / 2)
    extrap_end = np.where(dur_end < threshold, dur_end, avg_dur / 2)
    interval = sampled + extrap_start + extrap_end

    with np.errstate(divide="ignore", invalid="ignore"):
        out = result * (interval / np.maximum(sampled, 1.0))
        if is_rate:
            out = out / (range_nanos / 1e9)
    return np.where(has2 & (sampled > 0), out, np.nan)


def _stdvar(v, m):
    # two-pass (mean-shifted) variance: the naive E[x^2]-E[x]^2 form
    # cancels for large-magnitude samples
    n = np.maximum(m.sum(-1), 1)
    mean = _masked(np.sum, v, m) / n
    d = np.where(m, v - mean[..., None], 0.0)
    return (d * d).sum(-1) / n


def _masked(fn, v, m):
    # no nan_to_num: the mask already excludes NaN cells, and clamping
    # would turn a legitimate +-Inf sample into +-1.8e308
    return fn(np.where(m, v, 0.0), axis=-1)


def _masked_minmax(fn, v, m, fill):
    out = fn(np.where(m, v, fill), axis=-1)
    return np.where(m.any(-1), out, np.nan)


_REDUCERS = {
    "avg_over_time": lambda v, m: _masked(np.sum, v, m) / np.maximum(m.sum(-1), 1),
    "sum_over_time": lambda v, m: _masked(np.sum, v, m),
    "min_over_time": lambda v, m: _masked_minmax(np.min, v, m, np.inf),
    "max_over_time": lambda v, m: _masked_minmax(np.max, v, m, -np.inf),
    "count_over_time": lambda v, m: m.sum(-1).astype(np.float64),
    "stddev_over_time": lambda v, m: np.sqrt(_stdvar(v, m)),
    "stdvar_over_time": _stdvar,
    "present_over_time": lambda v, m: np.where(m.any(-1), 1.0, np.nan),
    "last_over_time": None,  # handled by step_consolidate shape
}


def window_reduce(
    times: np.ndarray,
    values: np.ndarray,
    step_times: np.ndarray,
    range_nanos: int,
    reducer: str,
) -> np.ndarray:
    """*_over_time reductions on raw samples in [t - range, t]."""
    step_times = np.asarray(step_times, dtype=np.int64)
    left, right = _window_bounds(times, _range_left(step_times, range_nanos), step_times)
    L, N = values.shape
    S = len(step_times)
    idx = np.arange(N)
    # mask[l, s, i] = left[l,s] <= i < right[l,s]
    out = np.empty((L, S))
    chunk = max(1, (1 << 23) // max(N, 1))
    fn = _REDUCERS[reducer]
    for lo in range(0, L, chunk):
        hi = min(L, lo + chunk)
        m = (idx[None, None, :] >= left[lo:hi][:, :, None]) & (
            idx[None, None, :] < right[lo:hi][:, :, None]
        )
        m &= ~np.isnan(values[lo:hi])[:, None, :]
        out[lo:hi] = fn(values[lo:hi][:, None, :], m)
    empty = right == left
    return np.where(empty, np.nan, out)


def window_quantile(
    times: np.ndarray,
    values: np.ndarray,
    step_times: np.ndarray,
    range_nanos: int,
    phi: float,
) -> np.ndarray:
    """quantile_over_time: linear-interpolated quantile of the samples
    in each window (upstream promql quantile semantics); out-of-range phi
    yields +/-Inf where the window has samples."""
    step_times = np.asarray(step_times, dtype=np.int64)
    left, right = _window_bounds(times, _range_left(step_times, range_nanos), step_times)
    L, N = values.shape
    S = len(step_times)
    out = np.full((L, S), np.nan)
    idx = np.arange(N)
    chunk = max(1, (1 << 23) // max(N, 1))
    oob = np.inf if phi > 1 else (-np.inf if phi < 0 else None)
    with np.errstate(invalid="ignore"):
        for lo in range(0, L, chunk):
            hi = min(L, lo + chunk)
            m = (idx[None, None, :] >= left[lo:hi][:, :, None]) & (
                idx[None, None, :] < right[lo:hi][:, :, None]
            )
            v = np.where(m, values[lo:hi][:, None, :], np.nan)
            any_m = m.any(-1) & ~np.isnan(v).all(-1)
            if oob is not None:
                # upstream promql: out-of-range phi yields +/-Inf
                out[lo:hi] = np.where(any_m, oob, np.nan)
                continue
            q = np.nanquantile(
                np.where(any_m[..., None], v, 0.0), phi, axis=-1
            )
            out[lo:hi] = np.where(any_m, q, np.nan)
    return out


def _pair_window_count(flags: np.ndarray, left: np.ndarray, right: np.ndarray):
    """Count adjacent-pair events fully inside each window.  flags[l, i]
    marks the pair (i, i+1); pair counted when left <= i and i+1 < right."""
    L, P = flags.shape
    cum = np.concatenate([np.zeros((L, 1)), np.cumsum(flags, axis=1)], axis=1)
    hi = np.clip(right - 1, 0, P)
    lo = np.clip(left, 0, P)
    return np.take_along_axis(cum, hi, axis=1) - np.take_along_axis(cum, lo, axis=1)


def window_changes(times, values, step_times, range_nanos, resets_only: bool):
    """changes()/resets(): adjacent-pair event counts per window
    (ref upstream promql; src/query/functions/temporal/functions.go)."""
    step_times = np.asarray(step_times, dtype=np.int64)
    left, right = _window_bounds(times, _range_left(step_times, range_nanos), step_times)
    L, N = values.shape
    if N < 2:
        return np.where(right > left, 0.0, np.nan)
    prev, curr = values[:, :-1], values[:, 1:]
    if resets_only:
        flags = (curr < prev).astype(np.float64)
    else:
        flags = (curr != prev).astype(np.float64)
    flags = np.where(np.isnan(prev) | np.isnan(curr), 0.0, flags)
    out = _pair_window_count(flags, left, right)
    return np.where(right > left, out, np.nan)


def window_linreg(times, values, step_times, range_nanos):
    """Least-squares fit per window, t relative to the step time in
    seconds.  Returns (slope, intercept_at_step, n_samples) — deriv is
    the slope; predict_linear is intercept + slope * horizon
    (ref: src/query/functions/temporal/linear_regression.go)."""
    step_times = np.asarray(step_times, dtype=np.int64)
    left, right = _window_bounds(times, _range_left(step_times, range_nanos), step_times)
    L, N = values.shape
    vz = np.nan_to_num(values)
    ok = (~np.isnan(values)).astype(np.float64)
    # epoch-seconds squared destroy f64 precision in the sums; work
    # relative to the query start (magnitudes ~ the query span)
    origin = int(step_times[0]) - range_nanos
    tsec = (np.where(times == _INF, origin, times) - origin).astype(
        np.float64
    ) / 1e9

    def wsum(x):
        cum = np.concatenate([np.zeros((L, 1)), np.cumsum(x, axis=1)], axis=1)
        return np.take_along_axis(cum, right, axis=1) - np.take_along_axis(
            cum, left, axis=1
        )

    n = wsum(ok)
    sv = wsum(vz * ok)
    st = wsum(tsec * ok)
    stv = wsum(tsec * vz * ok)
    stt = wsum(tsec * tsec * ok)
    # shift t origin to the step time for numerical stability:
    # t' = t - step;  sums transform in closed form
    step_sec = (step_times - origin).astype(np.float64)[None, :] / 1e9
    st_ = st - n * step_sec
    stv_ = stv - step_sec * sv
    stt_ = stt - 2 * step_sec * st + n * step_sec * step_sec
    denom = n * stt_ - st_ * st_
    with np.errstate(divide="ignore", invalid="ignore"):
        slope = (n * stv_ - st_ * sv) / denom
        intercept = sv / np.maximum(n, 1) - slope * (st_ / np.maximum(n, 1))
    valid = (n >= 2) & (np.abs(denom) > 1e-30)
    return (
        np.where(valid, slope, np.nan),
        np.where(valid, intercept, np.nan),
        n,
    )


def window_holt_winters(times, values, step_times, range_nanos,
                        sf: float, tf: float):
    """Double exponential smoothing over each window's samples
    (ref: src/query/functions/temporal/holt_winters.go; upstream
    double_exponential_smoothing).  An O(S * N) loop of numpy steps: the
    reference formulation."""
    step_times = np.asarray(step_times, dtype=np.int64)
    left, right = _window_bounds(times, _range_left(step_times, range_nanos), step_times)
    L, N = values.shape
    S = len(step_times)
    out = np.full((L, S), np.nan)
    if N < 2:
        # the recurrence needs >= 2 samples in a window; a merged batch
        # narrower than 2 columns cannot satisfy that
        return out
    idx = np.arange(N)
    for s in range(S):
        m = (idx[None, :] >= left[:, s, None]) & (idx[None, :] < right[:, s, None])
        m &= ~np.isnan(values)
        cnt = m.sum(1)
        # positions of 1st/2nd samples per lane
        order = np.argsort(~m, axis=1, kind="stable")
        v = np.take_along_axis(np.where(m, values, 0.0), order, axis=1)
        level = v[:, 0]
        trend = np.where(cnt >= 2, v[:, 1] - v[:, 0], 0.0)
        active = np.arange(N)[None, :] < cnt[:, None]
        for i in range(1, N):
            a = active[:, i]
            x = v[:, i]
            new_level = sf * x + (1 - sf) * (level + trend)
            new_trend = tf * (new_level - level) + (1 - tf) * trend
            level = np.where(a, new_level, level)
            trend = np.where(a, new_trend, trend)
        out[:, s] = np.where(cnt >= 2, level, np.nan)
    return out
