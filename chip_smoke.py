"""Chip smoke test: the PyTorch/CUDA port's read and query paths on one NVIDIA GPU.

Run from the root of a checkout, on a machine with a CUDA device:

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:

1. card   — the device's name and power limit (nvidia-smi);
2. build  — compiles every kernel of ``m3_tpu_torch/csrc`` with nvcc;
3. parity — every kernel against its plain PyTorch version on the card,
   bit for bit, on seed-42 walks plus probe streams (error lanes, float
   mode, millisecond unit, NaN/+-Inf/-0.0, truncated and garbage streams,
   odd lane counts) and a quantile grid of NaNs, ties and signed zeros;
4. query parity — the query slice's kernels (merge QK1, rate family QK2,
   prefix-sum reducers QK3, group-by QK4) against their plain versions on
   the card, on probe batches: counter resets, NaN/+-Inf samples, empty,
   one-sample and all-NaN windows, lane overflow past n_cap, truncation at
   n_dp, an unsorted lane, a two-tier stitch, padding streams parked on a
   spare lane, 14 and 67 lanes, lanes of 32,768 samples (QK2/QK3), ranges
   of 93s and 5m.  Integer results and copies bit for bit, sums at rtol
   1e-12, stddev/stdvar at rtol 1e-9; NaN patterns always equal; every
   kernel gives the same bits twice;
5. main   — the north-star read path: 1,000,000 series x 360 datapoints
   at 10s, window 6 (10s -> 1min), through ``decode_downsample`` for
   MEAN, STDEV and P99.  Launch counts are reset just before each
   aggregate is driven and read just after; every lane is checked
   against its unique lane, the unique lanes against the plain versions
   and a few against the scalar oracle.  Then each kernel is timed with
   CUDA events at these shapes beside its plain version, its bound and,
   for the quantile kernel, ``torch.sort``;
6. query main — BASELINE config 4, the m3query fan-out read: 50,000
   series x 6h of 10s data in 2h blocks (150,000 streams, n_dp 720,
   n_cap 2160, 355 steps at 60s, range 5m) through
   ``device_rate_pipeline`` (rate(m[5m]) of every series),
   ``device_grouped_pipeline`` (sum by (g) (rate(m[5m])), 100 groups) and
   ``device_reduce_pipeline`` (avg_over_time(m[5m])).  Launch counts are
   reset just before each query and read just after; every lane is checked
   against its unique lane, a few against the host tier
   (``ops/consolidate.py``) at rtol 1e-9, the grouped result against the
   per-lane one summed on the host.  Each query is timed (CUDA events,
   median of 7, and wall time with the result's ``.cpu()``), then each
   query kernel beside its plain version, its bound and, where one exists,
   a PyTorch call (``torch.searchsorted``, ``index_add_``);
7. report — one JSON line listing the kernels, then the result line.

The script imports nothing of JAX.  It exits non-zero without a result
when no CUDA device is present.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from m3_tpu_torch.models import corpus
from m3_tpu_torch.models import query_pipeline as qp
from m3_tpu_torch.models.read_pipeline import _SIMPLE_AGGS, decode_downsample, inputs_from_numpy
from m3_tpu_torch.ops import _build, m3tsz_scalar, query_grouped, query_merge, query_temporal
from m3_tpu_torch.ops import consolidate as cons
from m3_tpu_torch.ops import downsample as ds
from m3_tpu_torch.ops import m3tsz_decode as dec
from m3_tpu_torch.ops.bitstream import pack_streams

N_SERIES = 1_000_000
N_UNIQUE = 2000
N_DP = 360  # 1h at 10s
WINDOW = 6  # 10s -> 1min
MS = 1_000_000
QUANTILES = tuple(sorted(set(ds.QUANTILE_OF_TYPE.values()))) + (0.0, 1.0)

# Peak rates of one H100 SXM (NVIDIA's data sheet, at 700 W).  The integer
# rate is not in the data sheet's table: Hopper executes 64 INT32 operations
# per clock per SM against 128 FP32 lanes, so it is a quarter of the FP32
# 67 TFLOP/s (which counts an FMA as 2): 16.75e12 INT32 op/s.  FP64
# compares run at the same 64 lanes per clock per SM.
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 67e12 / 4
FP64_CMP_PER_S = 67e12 / 4
# 64-bit integer operations csrc/m3tsz_decode.cu's decode_step needs per
# datapoint on the walk streams, counted from the code: 128-bit window from
# five words (4 pair shifts/ors + 6 unaligned shifts/ors), marker test (4),
# clz of ~hi (2), bucket sign-extension (2), dod * unit and two adds (3),
# control window shift (1), three opcode bit tests (6), mid-window shifts
# (3), take_top (1), int apply (2), cursor advance and bound test (4), lane
# state selects (6): 44.  Each 64-bit operation is at least two INT32 ones.
INT32_OPS_PER_DATAPOINT = 2 * 44


def log(msg: str) -> None:
    print(msg, flush=True)


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def max_abs_err(a: torch.Tensor, b: torch.Tensor) -> float:
    if not a.dtype.is_floating_point:
        return float((a.to(torch.float64) - b.to(torch.float64)).abs().max()) if a.numel() else 0.0
    diff = torch.where(a == b, 0.0, (a.to(torch.float64) - b.to(torch.float64)).abs())
    diff = torch.where(torch.isnan(a) & torch.isnan(b), 0.0, diff)
    return float(diff.max()) if diff.numel() else 0.0


def same_bits(a: torch.Tensor, b: torch.Tensor, what: str) -> float:
    """Raise unless a and b agree bit for bit (floats: NaN positions equal,
    every other element the same bit pattern).  Returns max |a - b|."""
    check(a.shape == b.shape and a.dtype == b.dtype,
          f"{what}: {a.dtype}{tuple(a.shape)} vs {b.dtype}{tuple(b.shape)}")
    if a.dtype.is_floating_point:
        an, bn = torch.isnan(a), torch.isnan(b)
        ok = torch.equal(an, bn) and bool(((a.view(torch.int64) == b.view(torch.int64)) | an).all())
    else:
        ok = torch.equal(a, b)
    err = max_abs_err(a, b)
    check(ok, f"{what}: kernel and plain version differ (max abs err {err})")
    return err


def time_ms(fn, reps: int, warmup: int = 1) -> float:
    """Median over `reps` runs of fn, timed with CUDA events (ms)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


# --- phase 3: kernel vs plain version on the card -------------------------

ERRORS: dict[str, float] = {}


def _record(kernel: str, err: float) -> None:
    ERRORS[kernel] = max(ERRORS.get(kernel, 0.0), err)


def compare_decoders(streams, tag: str, int_optimized=True, unit=10**9, n_steps=N_DP,
                     window=WINDOW):
    dev = torch.device("cuda")
    words, nbits = inputs_from_numpy(*pack_streams(streams), device=dev)
    for full in (False, True):
        k = dec.decode_downsample_fused(words, nbits, n_steps, window, int_optimized,
                                        unit, full_agg=full)
        p = dec.decode_downsample_fused_plain(words, nbits, n_steps, window,
                                              int_optimized, unit, full_agg=full)
        name = "decode_downsample_fused" + ("[full_agg]" if full else "")
        for field, kt, pt in zip(k[0]._fields, k[0], p[0]):
            _record(name, same_bits(kt, pt, f"{tag} {name}.{field}"))
        same_bits(k[1], p[1], f"{tag} {name}.count")
        same_bits(k[2], p[2], f"{tag} {name}.error")
    for flag in (False, True):
        k = dec.decode_batched(words, nbits, n_steps, int_optimized, unit, flag)
        p = dec.decode_batched_plain(words, nbits, n_steps, int_optimized, unit, flag)
        for field, kt, pt in zip(("ts", "vs", "valid", "count", "error"), k, p):
            _record("decode_batched", same_bits(kt, pt, f"{tag} decode_batched.{field}"))
    _, vs, valid, _, err = k
    kq = ds.window_quantiles(vs, valid, window, QUANTILES)
    pq = ds.window_quantiles_plain(vs, valid, window, QUANTILES)
    _record("window_quantiles", same_bits(kq, pq, f"{tag} window_quantiles"))
    torch.cuda.synchronize()
    log(f"parity {tag}: {len(streams)} lanes, {int(err.sum())} error lanes: bit for bit")


def compare_quantile_grid():
    rng = np.random.default_rng(42)
    v = np.round(rng.standard_normal((257, 72)) * 100, 1)
    v[:, ::5] = np.round(v[:, ::5])
    pick = rng.random(v.shape)
    v[pick < 0.1] = np.nan
    v[(pick >= 0.1) & (pick < 0.13)] = np.inf
    v[(pick >= 0.13) & (pick < 0.15)] = -np.inf
    v[(pick >= 0.15) & (pick < 0.25)] = -0.0
    v[(pick >= 0.25) & (pick < 0.3)] = 0.0
    m = rng.random(v.shape) < 0.8
    m[:, :12] = False
    tv, tm = torch.from_numpy(v).cuda(), torch.from_numpy(m).cuda()
    for k in (1, 6, 36, 72):
        kq = ds.window_quantiles(tv, tm, k, QUANTILES)
        pq = ds.window_quantiles_plain(tv, tm, k, QUANTILES)
        _record("window_quantiles", same_bits(kq, pq, f"quantile grid k={k}"))
    torch.cuda.synchronize()
    log("parity quantile grid (NaN, +-Inf, ties, signed zeros; k=1,6,36,72): bit for bit")


# --- phase 5: the read path at full size -----------------------------------


def plain_pipeline(words, nbits, agg_type):
    """read_pipeline.decode_downsample's routing over the plain versions."""
    if agg_type in ds.QUANTILE_OF_TYPE:
        _, vs, valid, count, error = dec.decode_batched_plain(words, nbits, N_DP)
        qv = ds.window_quantiles_plain(vs, valid, WINDOW, (ds.QUANTILE_OF_TYPE[agg_type],))
        return qv[:, :, 0], count, error
    agg, count, error = dec.decode_downsample_fused_plain(
        words, nbits, N_DP, WINDOW, full_agg=agg_type not in _SIMPLE_AGGS)
    return ds.value_of(agg, agg_type), count, error


def oracle_means(stream: bytes) -> np.ndarray:
    """Per-window means of one stream from the scalar oracle, summed in order."""
    _, vs = m3tsz_scalar.decode_series(stream)
    out = []
    for w in range(N_DP // WINDOW):
        s = 0.0
        for v in vs[w * WINDOW:(w + 1) * WINDOW]:
            s = s + v
        out.append(s / WINDOW)
    return np.asarray(out)


def main_path(walks):
    dev = torch.device("cuda")
    reps = N_SERIES // N_UNIQUE
    uw, un = pack_streams(walks)
    words, nbits = inputs_from_numpy(np.tile(uw, (reps, 1)), np.tile(un, reps), device=dev)
    L, W = words.shape
    n_win = N_DP // WINDOW
    log(f"main path: {L} series x {N_DP} dp, window {WINDOW}; words u32[{L}, {W}] = "
        f"{words.numel() * 4} B, nbits {nbits.numel() * 4} B")
    results = {}
    for agg_type in (ds.AggregationType.MEAN, ds.AggregationType.STDEV, ds.AggregationType.P99):
        _build.reset_launches()
        out, count, error = decode_downsample(words, nbits, N_DP, WINDOW, agg_type)
        torch.cuda.synchronize()
        launches = dict(_build.LAUNCHES)
        want = (["window_quantiles", "decode_batched"] if agg_type in ds.QUANTILE_OF_TYPE
                else ["decode_downsample_fused"])
        for kernel in want:
            check(launches.get(kernel, 0) > 0, f"{agg_type.name}: {kernel} not launched")
        check(tuple(out.shape) == (L, n_win), f"{agg_type.name} shape {tuple(out.shape)}")
        check(bool(torch.isfinite(out).all()), f"{agg_type.name}: non-finite output")
        check(bool((count == N_DP).all()) and not bool(error.any()),
              f"{agg_type.name}: counts/errors")
        # every lane equals its unique lane (the batch is the unique set tiled)
        tiled = out.view(reps, N_UNIQUE, n_win)
        same_bits(tiled, out[:N_UNIQUE].expand(reps, N_UNIQUE, n_win).contiguous(),
                  f"{agg_type.name}: tiled lanes")
        # the unique lanes equal the plain versions
        p_out, p_count, p_err = plain_pipeline(words[:N_UNIQUE], nbits[:N_UNIQUE], agg_type)
        same_bits(out[:N_UNIQUE], p_out, f"{agg_type.name}: kernel path vs plain")
        same_bits(count[:N_UNIQUE], p_count, f"{agg_type.name}: count")
        same_bits(error[:N_UNIQUE], p_err, f"{agg_type.name}: error")
        if agg_type == ds.AggregationType.MEAN:
            host = out[:8].cpu().numpy()
            for lane in range(8):
                check(np.array_equal(host[lane], oracle_means(walks[lane])),
                      f"MEAN lane {lane} vs the scalar oracle")
        e2e = time_ms(lambda: decode_downsample(words, nbits, N_DP, WINDOW, agg_type), reps=7)
        results[agg_type.name] = {"launches": launches, "ms": e2e,
                                  "datapoints": int(count.sum())}
        log(f"main {agg_type.name}: launches {launches}; {e2e:.3f} ms median of 7 = "
            f"{L / (e2e / 1e3):.0f} series/s; checks passed")
        del out, count, error
    torch.cuda.synchronize()
    log(f"peak device memory so far: {torch.cuda.max_memory_allocated()} B")
    return words, nbits, results


def kernel_times(words, nbits, datapoints: int):
    """Each kernel at the main path's shapes: its time, its plain version's
    time (and output, held against it), its bound, and torch.sort for K4.
    `datapoints` is what this run's data holds (the decoders' total count)."""
    L, W = words.shape
    n_win = N_DP // WINDOW
    decode_ops_ms = datapoints * INT32_OPS_PER_DATAPOINT / INT32_OPS_PER_S * 1e3
    in_bytes = words.numel() * 4 + nbits.numel() * 4
    rows = {}

    def row(name, ms, plain_ms, bytes_, ops_ms, library_ms=None):
        bytes_ms = bytes_ / HBM_BYTES_PER_S * 1e3
        rows[name] = {"ms": ms, "plain_ms": plain_ms,
                      "bound_ms": max(bytes_ms, ops_ms),
                      "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
                      "library_ms": library_ms}
        log(f"time {name}: kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, bound "
            f"{rows[name]['bound_ms']:.3f} ms by {rows[name]['bound_by']} "
            f"(bytes {bytes_ms:.3f} ms, operations {ops_ms:.3f} ms)"
            + (f", torch.sort {library_ms:.3f} ms" if library_ms is not None else ""))

    for full in (False, True):
        name = "decode_downsample_fused" + ("[full_agg]" if full else "")
        k = dec.decode_downsample_fused(words, nbits, N_DP, WINDOW, full_agg=full)
        p = dec.decode_downsample_fused_plain(words, nbits, N_DP, WINDOW, full_agg=full)
        for field, kt, pt in zip(k[0]._fields, k[0], p[0]):
            _record(name, same_bits(kt, pt, f"main {name}.{field}"))
        same_bits(k[1], p[1], f"main {name}.count")
        del k, p
        ms = time_ms(lambda: dec.decode_downsample_fused(words, nbits, N_DP, WINDOW,
                                                         full_agg=full), reps=7)
        plain_ms = time_ms(lambda: dec.decode_downsample_fused_plain(
            words, nbits, N_DP, WINDOW, full_agg=full), reps=3, warmup=0)
        out_bytes = L * n_win * (8 + 8 + (32 if full else 0)) + L * 5
        row(name, ms, plain_ms, in_bytes + out_bytes, decode_ops_ms)
    torch.cuda.empty_cache()

    k = dec.decode_batched(words, nbits, N_DP)
    p = dec.decode_batched_plain(words, nbits, N_DP)
    for field, kt, pt in zip(("ts", "vs", "valid", "count", "error"), k, p):
        _record("decode_batched", same_bits(kt, pt, f"main decode_batched.{field}"))
    del p
    torch.cuda.empty_cache()
    ms = time_ms(lambda: dec.decode_batched(words, nbits, N_DP), reps=5)
    plain_ms = time_ms(lambda: dec.decode_batched_plain(words, nbits, N_DP), reps=3, warmup=0)
    row("decode_batched", ms, plain_ms, in_bytes + L * N_DP * 17 + L * 5, decode_ops_ms)

    _, vs, valid, _, _ = k
    del k
    q = (ds.QUANTILE_OF_TYPE[ds.AggregationType.P99],)
    kq = ds.window_quantiles(vs, valid, WINDOW, q)
    pq = ds.window_quantiles_plain(vs, valid, WINDOW, q)
    _record("window_quantiles", same_bits(kq, pq, "main window_quantiles"))
    ms = time_ms(lambda: ds.window_quantiles(vs, valid, WINDOW, q), reps=7)
    plain_ms = time_ms(lambda: ds.window_quantiles_plain(vs, valid, WINDOW, q), reps=5)
    keys = torch.where(valid & ~torch.isnan(vs), vs, torch.inf).view(L, n_win, WINDOW)
    library_ms = time_ms(lambda: torch.sort(keys, dim=2), reps=7)
    q_bytes = L * N_DP * 9 + L * n_win * 8 * len(q)
    q_ops_ms = L * n_win * 2 * WINDOW * WINDOW / FP64_CMP_PER_S * 1e3
    row("window_quantiles", ms, plain_ms, q_bytes, q_ops_ms, library_ms)
    del vs, valid, keys, kq, pq
    torch.cuda.empty_cache()
    return rows


# --- phase 4: the query kernels vs their plain versions ------------------

SEC = 1_000_000_000
Q_RANGES = (93 * SEC, 300 * SEC)
Q_SERIES = 50_000
DEVICE = torch.device("cuda")
RATE_MODES = {"rate": (True, True), "increase": (True, False), "delta": (False, False)}
FP64_OPS_PER_S = 67e12 / 4  # non-tensor FP64 adds/multiplies: 64 lanes per SM per clock
BIT_EXACT_REDUCERS = ("count_over_time", "present_over_time", "last_over_time")
BIT_EXACT_AGGS = ("count", "min", "max", "group")


def close(a: torch.Tensor, b: torch.Tensor, rtol: float, what: str, atol: float = 1e-12) -> float:
    """Raise unless a and b have the same NaN pattern, the same infinities
    and |a - b| <= atol + rtol * |b| elsewhere.  Returns max |a - b|."""
    check(a.shape == b.shape and a.dtype == b.dtype,
          f"{what}: {a.dtype}{tuple(a.shape)} vs {b.dtype}{tuple(b.shape)}")
    an, bn = torch.isnan(a), torch.isnan(b)
    check(torch.equal(an, bn), f"{what}: NaN patterns differ")
    fin = torch.isfinite(b)
    inf = ~fin & ~bn
    check(torch.equal(a[inf], b[inf]), f"{what}: infinities differ")
    err = (a[fin] - b[fin]).abs()
    e = float(err.max()) if err.numel() else 0.0
    check(bool((err <= atol + rtol * b[fin].abs()).all()),
          f"{what}: the two differ beyond rtol {rtol}, atol {atol} (max abs err {e})")
    return e


def twice(fn, what: str):
    """fn() run twice; the two results must be the same bits."""
    a, b = fn(), fn()
    for x, y in zip(a if isinstance(a, tuple) else (a,), b if isinstance(b, tuple) else (b,)):
        same_bits(x, y, f"{what}: second run")
    return a


def compare_query(b: corpus.QueryBatch, tag: str):
    """QK1-QK4 against their plain versions on one probe batch."""
    dev = DEVICE
    words, nbits, slots, steps, tiers = qp._inputs(b.words, b.nbits, b.slots, b.steps, b.tiers,
                                                   dev)
    ts, vs, valid, _, _ = dec.decode_batched(words, nbits, b.n_dp, flag_truncation=True)
    k = twice(lambda: query_merge.lane_merge(ts, vs, valid, slots, b.n_lanes, b.n_cap, tiers,
                                             b.n_tiers), f"{tag} query_merge")
    p = query_merge.lane_merge_plain(ts, vs, valid, slots, b.n_lanes, b.n_cap, tiers, b.n_tiers)
    for field, kt, pt in zip(("times", "values", "counts", "unsorted"), k, p):
        _record("query_merge", same_bits(kt, pt, f"{tag} query_merge.{field}"))
    check(bool(k[3].any()) and bool((k[2] > b.n_cap).any()),
          f"{tag}: the unsorted and overflow probes did not fire")
    times, values = k[0], k[1]
    served = []
    for r in Q_RANGES:
        _, left, right = query_temporal.window_bounds_plain(times, steps, r)
        for fn, (counter, per_s) in RATE_MODES.items():
            out, kl, kr = twice(lambda: query_temporal.rate(
                times, values, steps, r, counter, per_s, with_bounds=True), f"{tag} {fn}")
            same_bits(kl, left, f"{tag} {fn} left bounds")
            same_bits(kr, right, f"{tag} {fn} right bounds")
            want = query_temporal.rate_plain(times, values, steps, r, counter, per_s)
            _record("query_rate", close(out, want, 1e-12, f"{tag} {fn} {r // SEC}s"))
            served.append(out)
        for fn in query_temporal.INSTANT_FNS:
            out = twice(lambda: query_temporal.instant(times, values, steps, r, fn == "irate"),
                        f"{tag} {fn}")
            want = query_temporal.instant_plain(times, values, steps, r, fn == "irate")
            _record("query_rate", same_bits(out, want, f"{tag} {fn} {r // SEC}s"))
        for red in query_temporal.REDUCERS:
            out, kl, kr = twice(lambda: query_temporal.reduce_window(
                times, values, steps, r, red, with_bounds=True), f"{tag} {red}")
            same_bits(kl, left, f"{tag} {red} left bounds")
            same_bits(kr, right, f"{tag} {red} right bounds")
            want = query_temporal.reduce_plain(times, values, steps, r, red)
            if red in BIT_EXACT_REDUCERS:
                _record("query_reduce", same_bits(out, want, f"{tag} {red} {r // SEC}s"))
            else:
                _record("query_reduce", close(out, want, 1e-12, f"{tag} {red} {r // SEC}s"))
            served.append(out)
    mat = torch.cat(served)  # NaN/+-Inf cells, signed zeros, all-NaN padding lanes
    groups = torch.arange(mat.shape[0], device=dev) % 5
    for agg in query_grouped.AGGS:
        out = twice(lambda: query_grouped.grouped_reduce(mat, groups, 5, agg), f"{tag} {agg}")
        want = query_grouped.grouped_reduce_plain(mat, groups, 5, agg)
        if agg in BIT_EXACT_AGGS:
            _record("query_grouped", same_bits(out, want, f"{tag} {agg}"))
        else:
            rtol = 1e-9 if agg in ("stddev", "stdvar") else 1e-12
            _record("query_grouped", close(out, want, rtol, f"{tag} {agg}"))
    out = twice(lambda: query_grouped.fleet_nansum(mat), f"{tag} fleet")
    _record("query_grouped", close(out, query_grouped.fleet_nansum_plain(mat), 1e-12,
                                   f"{tag} fleet"))
    torch.cuda.synchronize()
    log(f"query parity {tag}: {b.n_lanes} lanes, {len(b.slots)} streams, "
        f"{int(k[3].sum())} unsorted and {int((k[2] > b.n_cap).sum())} overflowing lanes: "
        f"QK1 bit for bit, QK2/QK3 bounds bit for bit, every kernel repeatable")


def compare_long_lanes(n_cap: int = 32768):
    """QK2/QK3 against their plain versions on lanes of n_cap samples (the
    engine's cap for a raw 10s lane of more than 2.2 days)."""
    t, v, st = (torch.from_numpy(x).to(DEVICE) for x in corpus.long_lanes(n_cap))
    for r in Q_RANGES:
        for fn, (counter, per_s) in RATE_MODES.items():
            out = twice(lambda: query_temporal.rate(t, v, st, r, counter, per_s), f"long {fn}")
            _record("query_rate", close(out, query_temporal.rate_plain(t, v, st, r, counter,
                                                                       per_s), 1e-12, f"long {fn}"))
        for fn in query_temporal.INSTANT_FNS:
            out = twice(lambda: query_temporal.instant(t, v, st, r, fn == "irate"), f"long {fn}")
            _record("query_rate", same_bits(out, query_temporal.instant_plain(
                t, v, st, r, fn == "irate"), f"long {fn}"))
        for red in query_temporal.REDUCERS:
            out = twice(lambda: query_temporal.reduce_window(t, v, st, r, red), f"long {red}")
            want = query_temporal.reduce_plain(t, v, st, r, red)
            if red in BIT_EXACT_REDUCERS:
                _record("query_reduce", same_bits(out, want, f"long {red}"))
            else:
                _record("query_reduce", close(out, want, 1e-12, f"long {red}"))
    torch.cuda.synchronize()
    log(f"query parity long lanes: {t.shape[0]} lanes x {n_cap} samples, {st.shape[0]} steps: "
        f"QK2/QK3 match their plain versions and repeat")


# --- phase 6: the query path at full size ---------------------------------


def host_lanes(fc: corpus.FanoutCorpus, lanes):
    """The host tier's merged (times, values) of some fan-out lanes."""
    frags = [(i, ts_u[lane % fc.n_unique], vs_u[lane % fc.n_unique])
             for i, lane in enumerate(lanes) for ts_u, vs_u in fc.grids]
    t, v, _ = cons.merge_packed(frags, len(lanes))
    return t, v


def wall_ms(fn, reps: int = 7) -> float:
    """Median host time of fn() with its first result brought to the host."""
    fn()[0].cpu()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()[0].cpu()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def query_main(n_series: int):
    t0 = time.time()
    fc = corpus.fanout_corpus(n_series)
    b = fc.batch
    log(f"query data: {n_series} series x 6h at 10s in 2h blocks, {len(b.slots)} streams of "
        f"<= {b.n_dp} dp, words u32{tuple(b.words.shape)}, n_cap {b.n_cap}, {len(b.steps)} "
        f"steps, range {b.range_nanos // SEC}s; encoded in {time.time() - t0:.1f} s")
    check(n_series % fc.n_unique == 0, "series must tile the unique walks")
    dev = DEVICE
    words, nbits, slots, steps, _ = qp._inputs(b.words, b.nbits, b.slots, b.steps, None, dev)
    kw = dict(n_lanes=b.n_lanes, n_cap=b.n_cap, range_nanos=b.range_nanos, n_dp=b.n_dp)
    front = ["decode_batched", "query_merge"]
    queries = {
        "rate": (lambda: qp.device_rate_pipeline(words, nbits, slots, steps, **kw),
                 front + ["query_rate", "query_grouped"]),
        "sum_by_rate": (lambda: qp.device_grouped_pipeline(
            words, nbits, slots, steps, b.groups, n_groups=b.n_groups, fn="rate", agg="sum",
            **kw), front + ["query_rate", "query_grouped"]),
        "avg_over_time": (lambda: qp.device_reduce_pipeline(
            words, nbits, slots, steps, reducer="avg_over_time", **kw),
            front + ["query_reduce"]),
    }
    reps, S = n_series // fc.n_unique, len(b.steps)
    oracle_lanes = [0, 1, min(n_series - 1, fc.n_unique + 2)]
    t_ref, v_ref = host_lanes(fc, oracle_lanes)
    results = {}
    for name, (fn, want) in queries.items():
        _build.reset_launches()
        res = fn()
        torch.cuda.synchronize()
        launches = dict(_build.LAUNCHES)
        for kernel in want:
            check(launches.get(kernel, 0) > 0, f"query {name}: {kernel} not launched")
        out, err = res[0], res[-1]
        check(not bool(err.any()), f"query {name}: error flags")
        rows = b.n_groups if name == "sum_by_rate" else n_series
        check(tuple(out.shape) == (rows, S), f"query {name}: shape {tuple(out.shape)}")
        live = out[:min(rows, n_series)]  # groups lane % 100 with no lane are NaN
        check(bool(torch.isfinite(live).all()), f"query {name}: non-finite output")
        if name != "sum_by_rate":
            # every lane equals its unique lane (the lanes tile the unique walks)
            same_bits(out.view(reps, fc.n_unique, S),
                      out[:fc.n_unique].expand(reps, fc.n_unique, S).contiguous(),
                      f"query {name}: tiled lanes")
            if name == "rate":
                want_host = cons.extrapolated_rate(t_ref, v_ref, b.steps, b.range_nanos,
                                                   True, True)
            else:
                want_host = cons.window_reduce(t_ref, v_ref, b.steps, b.range_nanos, name)
            close(out[oracle_lanes].cpu(), torch.from_numpy(want_host), 1e-9,
                  f"query {name} vs the host tier")
        if name == "rate":
            fleet = res[1]
            _record("query_grouped", close(fleet, query_grouped.fleet_nansum_plain(out), 1e-12,
                                           "fleet sum at full size"))
            rate_np = out.cpu().numpy()
        ms = time_ms(fn, reps=7)
        wall = wall_ms(fn)
        results[name] = {"launches": launches, "ms": ms, "wall_ms": wall,
                         "series_per_s": n_series / (ms / 1e3),
                         "series_per_s_wall": n_series / (wall / 1e3)}
        log(f"query {name}: launches {launches}; {ms:.3f} ms device (median of 7) = "
            f"{n_series / (ms / 1e3):.0f} series/s; {wall:.3f} ms with the result's .cpu(); "
            f"checks passed")
        if name == "sum_by_rate":
            g = out.cpu().numpy()
            want_g = np.zeros((b.n_groups, S))
            cnt_g = np.zeros((b.n_groups, S))
            np.add.at(want_g, b.groups, np.nan_to_num(rate_np))
            np.add.at(cnt_g, b.groups, ~np.isnan(rate_np))
            want_g = np.where(cnt_g == 0, np.nan, want_g)
            close(torch.from_numpy(g), torch.from_numpy(want_g), 1e-9,
                  "sum by (g) vs the per-lane rates summed on the host", atol=1e-9)
        del res, out, err
    torch.cuda.synchronize()
    return b, (words, nbits, slots, steps), results


def query_kernel_times(b: corpus.QueryBatch, inputs):
    """Each query kernel at the fan-out read's shapes: its time, its plain
    version's (held against it), its bound, and a PyTorch call where one
    computes the same function."""
    words, nbits, slots, steps = inputs
    dev = words.device
    rows = {}

    def row(name, ms, plain_ms, bytes_, ops_ms, library_ms=None, library=""):
        bytes_ms = bytes_ / HBM_BYTES_PER_S * 1e3
        rows[name] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": max(bytes_ms, ops_ms),
                      "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
                      "library_ms": library_ms}
        log(f"time {name}: kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, bound "
            f"{rows[name]['bound_ms']:.3f} ms by {rows[name]['bound_by']} (bytes "
            f"{bytes_ms:.3f} ms, operations {ops_ms:.3f} ms)"
            + (f", {library} {library_ms:.3f} ms" if library_ms is not None else ""))

    M, T, L, N, S = len(b.slots), b.n_dp, b.n_lanes, b.n_cap, len(b.steps)
    in_bytes = words.numel() * 4 + nbits.numel() * 4
    k = dec.decode_batched(words, nbits, T, flag_truncation=True)
    p = dec.decode_batched_plain(words, nbits, T, flag_truncation=True)
    for field, kt, pt in zip(("ts", "vs", "valid", "count", "error"), k, p):
        _record("decode_batched", same_bits(kt, pt, f"query decode_batched.{field}"))
    del p
    datapoints = int(k[3].sum())
    ms = time_ms(lambda: dec.decode_batched(words, nbits, T, flag_truncation=True), reps=5)
    plain_ms = time_ms(lambda: dec.decode_batched_plain(words, nbits, T, flag_truncation=True),
                       reps=3, warmup=0)
    row("decode_batched[flag_truncation]", ms, plain_ms, in_bytes + M * T * 17 + M * 5,
        datapoints * INT32_OPS_PER_DATAPOINT / INT32_OPS_PER_S * 1e3)

    ts, vs, valid, _, _ = k
    del k
    merge = lambda: query_merge.lane_merge(ts, vs, valid, slots, L, N)  # noqa: E731
    km = merge()
    pm = query_merge.lane_merge_plain(ts, vs, valid, slots, L, N)
    for field, kt, pt in zip(("times", "values", "counts", "unsorted"), km, pm):
        _record("query_merge", same_bits(kt, pt, f"main query_merge.{field}"))
    del pm
    torch.cuda.empty_cache()
    row("query_merge", time_ms(merge, reps=7),
        time_ms(lambda: query_merge.lane_merge_plain(ts, vs, valid, slots, L, N), reps=3),
        M * T * 17 + M * 8 + L * N * 16 + L * 9, 0.0)
    times, values = km[0], km[1]
    del ts, vs, valid, km
    torch.cuda.empty_cache()

    r = b.range_nanos
    lane_bytes = L * N * 16 + S * 8 + L * S * 8
    levels = query_temporal.search_levels(N)
    # per (lane, step): two bisections of `levels` 64-bit compare/select
    # steps (4 INT32 operations each) and some 30 FP64 operations
    rate_ops_ms = L * S * (2 * levels * 4 / INT32_OPS_PER_S + 30 / FP64_OPS_PER_S) * 1e3
    fn = lambda: query_temporal.rate(times, values, steps, r, True, True)  # noqa: E731
    rate = fn()
    _record("query_rate", close(rate, query_temporal.rate_plain(times, values, steps, r, True,
                                                                True), 1e-12, "main rate"))
    queries = torch.cat([steps - r - 1, steps]).expand(L, 2 * S).contiguous()
    row("query_rate", time_ms(fn, reps=7),
        time_ms(lambda: query_temporal.rate_plain(times, values, steps, r, True, True), reps=3),
        lane_bytes, rate_ops_ms,
        time_ms(lambda: torch.searchsorted(times, queries, right=True), reps=7),
        "torch.searchsorted (the bounds alone)")
    del queries

    fn = lambda: query_temporal.reduce_window(times, values, steps, r, "avg_over_time")  # noqa
    _record("query_reduce", close(fn(), query_temporal.reduce_plain(
        times, values, steps, r, "avg_over_time"), 1e-12, "main avg_over_time"))
    row("query_reduce", time_ms(fn, reps=7),
        time_ms(lambda: query_temporal.reduce_plain(times, values, steps, r, "avg_over_time"),
                reps=3), lane_bytes + L * 8, L * S * 2 * levels * 4 / INT32_OPS_PER_S * 1e3)
    del times, values
    torch.cuda.empty_cache()

    G = b.n_groups
    groups = torch.from_numpy(b.groups).to(dev)
    csr = query_grouped.group_csr(b.groups, G)
    fn = lambda: query_grouped.grouped_reduce(rate, groups, G, "sum", csr)  # noqa: E731
    _record("query_grouped", close(fn(), query_grouped.grouped_reduce_plain(
        rate, groups, G, "sum"), 1e-12, "main sum by (g)"))
    vz = torch.nan_to_num(rate, nan=0.0)
    row("query_grouped", time_ms(fn, reps=7),
        time_ms(lambda: query_grouped.grouped_reduce_plain(rate, groups, G, "sum"), reps=3),
        L * S * 8 + L * 8 + G * S * 8, L * S / FP64_OPS_PER_S * 1e3,
        time_ms(lambda: torch.zeros((G, S), dtype=torch.float64, device=dev).index_add_(
            0, groups, vz), reps=7), "index_add_")
    fleet_ms = time_ms(lambda: query_grouped.fleet_nansum(rate), reps=7)
    log(f"time fleet sum (QK4, one group of {L} lanes): {fleet_ms:.3f} ms")
    del rate, vz
    torch.cuda.empty_cache()
    return rows


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the card",
              file=sys.stderr)
        return 1
    t_start = time.time()
    name_power = card()
    log(name_power)
    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, cuda {torch.version.cuda}, "
        f"device {torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}")

    t0 = time.time()
    built = _build.build_all()
    log(f"build: {len(built)} libraries in {time.time() - t0:.1f} s")
    for name, text in _build.BUILD_LOGS.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  ptxas {name}: {line.strip()}")

    t0 = time.time()
    walks = corpus.walk_streams(N_UNIQUE, N_DP)
    log(f"data: {N_UNIQUE} seed-42 walk streams in {time.time() - t0:.1f} s")
    compare_decoders(walks + corpus.probe_streams(N_DP), "walks+probes")
    compare_decoders(corpus.probe_streams(N_DP, int_optimized=False)
                     + corpus.golden_streams(), "float mode", int_optimized=False)
    compare_decoders(corpus.ms_streams(256, N_DP), "millisecond unit", unit=MS)
    probes = corpus.probe_streams(N_DP)
    for lanes in (1, 7, 129):
        compare_decoders((probes + walks)[:lanes], f"{lanes} lanes")
    compare_quantile_grid()
    compare_query(corpus.query_probe_corpus(), "probes")
    compare_query(corpus.query_probe_corpus(tiered=True), "two-tier")
    compare_query(corpus.query_probe_corpus(n_real=61, n_lanes=67, seed=5), "67 lanes")
    compare_long_lanes()
    log(f"parity phases done at {time.time() - t_start:.1f} s")

    words, nbits, results = main_path(walks)
    rows = kernel_times(words, nbits, results["MEAN"]["datapoints"])
    del words, nbits
    torch.cuda.empty_cache()
    log(f"read main phase done at {time.time() - t_start:.1f} s; peak device memory "
        f"{torch.cuda.max_memory_allocated()} B")
    qb, q_inputs, q_results = query_main(Q_SERIES)
    rows_q = query_kernel_times(qb, q_inputs)
    del q_inputs
    log(f"query main phase done at {time.time() - t_start:.1f} s; peak device memory "
        f"{torch.cuda.max_memory_allocated()} B")
    q_launch = {}
    for r in q_results.values():
        for kernel, n in r["launches"].items():
            q_launch[kernel] = q_launch.get(kernel, 0) + n
    e2e_q = {name: {k: r[k] for k in ("ms", "wall_ms", "series_per_s", "series_per_s_wall")}
             for name, r in q_results.items()}
    log(json.dumps({"query_end_to_end": e2e_q, "card": name_power}))

    k2 = results["MEAN"]["launches"].get("decode_downsample_fused", 0)
    k2f = results["STDEV"]["launches"].get("decode_downsample_fused", 0)
    k3 = results["P99"]["launches"].get("decode_batched", 0)
    k4 = results["P99"]["launches"].get("window_quantiles", 0)
    k3q = q_launch.get("decode_batched", 0)
    src = "m3_tpu_torch/csrc/"
    qsrc = "m3_tpu/models/query_pipeline.py:"
    kernels = [
        # K1 is the __device__ step inside K2 and K3: it launches with them,
        # and its time is that of K2 in the MEAN configuration (decode only).
        dict(name="decode_step", source=src + "m3tsz_decode.cu",
             replaces="m3_tpu/ops/m3tsz_decode.py:405", launches=k2 + k2f + k3 + k3q,
             max_abs_err=max(ERRORS["decode_downsample_fused"], ERRORS["decode_batched"]),
             **rows["decode_downsample_fused"]),
        dict(name="decode_downsample_fused", source=src + "m3tsz_decode.cu",
             replaces="m3_tpu/ops/m3tsz_decode.py:488", launches=k2,
             max_abs_err=ERRORS["decode_downsample_fused"], **rows["decode_downsample_fused"]),
        dict(name="decode_downsample_fused[full_agg]", source=src + "m3tsz_decode.cu",
             replaces="m3_tpu/ops/m3tsz_decode.py:488", launches=k2f,
             max_abs_err=ERRORS["decode_downsample_fused[full_agg]"],
             **rows["decode_downsample_fused[full_agg]"]),
        dict(name="decode_batched", source=src + "m3tsz_decode.cu",
             replaces="m3_tpu/ops/m3tsz_decode.py:440", launches=k3,
             max_abs_err=ERRORS["decode_batched"], **rows["decode_batched"]),
        # K3 again, on the query path: [150,000 streams, 720 + 1 steps]
        dict(name="decode_batched[flag_truncation]", source=src + "m3tsz_decode.cu",
             replaces="m3_tpu/ops/m3tsz_decode.py:440", launches=k3q,
             max_abs_err=ERRORS["decode_batched"], **rows_q["decode_batched[flag_truncation]"]),
        dict(name="window_quantiles", source=src + "window_quantiles.cu",
             replaces="m3_tpu/ops/downsample.py:166", launches=k4,
             max_abs_err=ERRORS["window_quantiles"], **rows["window_quantiles"]),
        dict(name="query_merge", source=src + "query_merge.cu", replaces=qsrc + "175",
             launches=q_launch.get("query_merge", 0), max_abs_err=ERRORS["query_merge"],
             **rows_q["query_merge"]),
        dict(name="query_rate", source=src + "query_temporal.cu", replaces=qsrc + "98",
             launches=q_launch.get("query_rate", 0), max_abs_err=ERRORS["query_rate"],
             **rows_q["query_rate"]),
        dict(name="query_reduce", source=src + "query_temporal.cu", replaces=qsrc + "474",
             launches=q_launch.get("query_reduce", 0), max_abs_err=ERRORS["query_reduce"],
             **rows_q["query_reduce"]),
        dict(name="query_grouped", source=src + "query_grouped.cu", replaces=qsrc + "915",
             launches=q_launch.get("query_grouped", 0), max_abs_err=ERRORS["query_grouped"],
             **rows_q["query_grouped"]),
    ]
    for k in kernels:
        k["route"] = "cuda"
        check(k["launches"] > 0, f"{k['name']} was not launched on the main path")
    e2e = {agg: {"ms": r["ms"], "series_per_s": N_SERIES / (r["ms"] / 1e3)}
           for agg, r in results.items()}
    log(json.dumps({"end_to_end": e2e, "card": name_power}))
    log(f"total {time.time() - t_start:.1f} s")
    log(name_power)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
