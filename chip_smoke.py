"""Chip smoke test: the PyTorch/CUDA port's read, query (PromQL and Graphite),
write and storage paths, and their series-sharded forms, on one NVIDIA GPU.

Run from the root of a checkout, on a machine with a CUDA device:

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:

1. card   — the device's name and power limit (nvidia-smi);
2. build  — compiles every kernel of ``m3_tpu_torch/csrc`` with nvcc;
3. parity — every kernel against its plain PyTorch version on the card,
   bit for bit, on seed-42 walks plus probe streams (error lanes, float
   mode, millisecond unit, NaN/+-Inf/-0.0, truncated and garbage streams,
   odd lane counts; K3 also at 1, 31 and 33 steps on 71 lanes, around its
   staged 16-step tiles) and a quantile grid of NaNs, ties and signed zeros;
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
   and a few against the scalar oracle.  Then K2 is held against its plain
   version, twice, on its window probes (n_win 1, 3, 4, 5, 7, 8, 9 around
   its staged groups of 4 windows, 8 with full_agg; window 1 and window =
   n_steps; lanes in error inside a window) and at the main shape; each
   kernel is timed with CUDA events at these shapes beside its plain
   version, its bound and, for the quantile kernel, ``torch.sort``; and a
   ``layout`` line per staged kernel (K2, K2 full_agg, K3, T1) gives its
   staged width, shared memory, registers and resident blocks per SM;
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
7. expr parity (run with the parity phases, before phase 5) — the
   expression interpreter's kernels (min/max over time
   QK5, grouped quantile QK6, topk/bottomk QK7, histogram_quantile QK8)
   against their plain versions on the card, bit for bit, twice, on the
   CPU tests' probes (NaN, +-Inf, +-0.0 windows inside and across 32-sample
   blocks, ties, groups below k, padding on the trash group, total-0 and
   non-monotone histograms, phi 0, 1, -0.5, 1.5, NaN) and on groups of up to
   15,000 lanes; QK6 also on groups of 1, 255, 256, 257, 2,049 and 65,536
   lanes (one-chunk groups and groups of several chunks; padding on group 0,
   runs of +-0.0, all-NaN steps, phi 0, 0.5, 0.9, 1), and through the
   sharded quantile (``_grouped_reduce_sharded`` on an 8-shard mesh); then
   the rest of the range
   functions (QK3's changes/resets and deriv/predict_linear op codes, QK9
   stddev/stdvar, QK10 holt_winters, QK11 quantile_over_time) on the CPU
   tests' probe lanes, QK11 also on windows of 1-300 samples, and on lanes
   of 32,768 samples at 5m and 1h, and the subquery pack (QK12) against a
   stable sort; bit for bit but the fit's sums (rtol 1e-9 and
   ``linreg_atol``), twice; then the graphite kernels (QK4's grouped
   NaN-reductions, GK2 percentiles in both forms, GK3 per-lane scans,
   buckets and windows) on their probes, twice, bit for bit but QK4's sums
   (rtol 1e-12);
8. expr main — BASELINE config 4's width through ``device_expr_pipeline``:
   the grouped-rate ratio of ``bench.py:1768`` (25,000 + 25,000 series,
   32 jobs), histogram_quantile(0.99, sum by (job, le)(rate(..))) over
   4,166 histograms x 12 DefBuckets, topk(10, rate(..)) and quantile by
   (job)(0.9, rate(..)) over 50,000 lanes, max by (job)(max_over_time(..))
   and min_over_time(..), (rate(..) > 0.5) * 60, and the 16-query megabatch
   of ``bench.py:3325`` through ``device_expr_pipeline_batched``.  Launch
   counts are reset just before each query and read just after; each
   result is checked at full size against something independent of its new
   kernel (per-node pipelines, numpy, the host tier, the solo calls), then
   timed (CUDA events, median of 7, and wall time with the root's
   ``.cpu()``); then QK5-QK8 are timed beside their plain versions, their
   bounds and ``torch.sort`` along the lanes (QK6, QK7); then the same data
   through one plan per further range function (stddev/stdvar_over_time
   5m, changes/resets 15m, deriv 15m, predict_linear 1h 4h ahead,
   holt_winters 1h (0.3, 0.1), quantile_over_time 0.99 5m), the subquery
   max_over_time(rate(m[5m])[30m:1m]) (384 inner steps) and
   quantile_over_time through ``device_reduce_pipeline``, each checked
   (tiled rows bit for bit, unique rows against the host tier or, for the
   subquery, numpy over the per-node rate on the inner grid) and timed;
   then QK3's new ops and QK9-QK12 beside their plain versions, bounds and
   ``torch.sort`` (along the window grid for QK11, of the packing key for
   QK12; QK11 at phi 0.99 and 0.5), and QK11 again over 1h windows;
9. graphite — the same 50,000 series as Graphite paths
   ``servers.host<i>.cpu.load`` through ``device_expr_pipeline`` with the
   graphite nodes: the reference bench's target
   movingAverage(groupByNode(servers.*.cpu.load, 1, 'sum'), 5) on
   words-kind leaves, then sumSeries, stddevSeries, percentileOfSeries(..,
   95), nPercentile(.., 95), summarize(integral(..), '5min', 'max') and
   keepLastValue(.., 3) on one arrays-kind leaf decoded once; each checked
   against a numpy oracle over the host tier's fetch (rtol 1e-9, NaN
   positions exact; per-lane results tiled bit for bit) and timed; then
   QK4 (one group and 50,000 one-lane groups), GK2 and GK3 (movingAverage
   also over 60 and 400 steps) beside their plain versions, bounds and
   ``torch.nansum``, ``torch.nanquantile``, ``torch.cumsum`` and
   ``unfold(..).sum``;
10. the write side (rollup flush, timer quantiles, BASELINE config 2, the
   encode and a block seal), as its phases' docstrings say;
11. tiles parity (run with the parity phases) — T1 against its plain
   version on the card, bit for bit, twice (``compare_tiles``'s probes,
   with the tile-group probes: 1, 3, 4, 5, 9 and 17 tiles around its
   staged groups of 4, on 1, 31, 33 and 129 lanes);
12. storage — BASELINE config 4's series (cut to 40,000) through a ``Database`` on
   the card: one 2h block of 10s data written, sealed (E1), flushed,
   aggregated into 5m tiles (T1, twice; both calls then rerun twice and
   held against the plain version), the tiles sealed and flushed, a
   restart, and every tile read back through the decoded-block cache (K3)
   and checked against numpy (``storage_main``); then T1 alone at
   1,000,000 lanes x 720 points, 1m and 5m tiles, twice, beside its plain
   version, its bound and K3 + ``index_add_``/``scatter_reduce_``;
13. mesh — the series-sharded paths on one card with 8 virtual shards
   (MK1, its batched form and QK4's sqdev against their plain versions
   with the parity phases, bit for bit, twice): the north-star read on a
   4x2 mesh through
   ``decode_downsample_sharded`` (MEAN; per_lane against
   ``decode_downsample`` bit for bit, the fleet against numpy at rtol
   1e-12, both consolidation schedules the same bits), after the read main;
   BASELINE config 4 repacked over 8 shards (``shard_repack``) through
   ``device_rate_sharded``, ``device_grouped_sharded`` (sum, stddev, min,
   quantile(0.9)) and ``device_expr_pipeline_sharded`` (the grouped-rate
   ratio, topk(10, ..), histogram_quantile(0.99, ..)), each against the
   unsharded pipeline on the same data, then the ratio and the grouped sum
   again over an NCCL group of world size 1 (the same bits), then MK1 and
   sqdev timed (MK1's time split between the device and the host, its host
   time a call beside ``torch.sum``'s, its batched form beside two single
   launches), after the graphite phase; the encode configuration through
   ``encode_rollup_sharded`` on 8x1 and 4x2 (words/nbits against
   ``encode_batched`` bit for bit, total_bytes exact), after the encode;
14. report — one JSON line listing the kernels, then the result line.

The script imports nothing of JAX.  It exits non-zero without a result
when no CUDA device is present.
"""

from __future__ import annotations

import contextlib
import datetime
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
import torch.distributed as dist

from m3_tpu_torch import metrics
from m3_tpu_torch.aggregator import Aggregator, ElemPool, elems
from m3_tpu_torch.models import corpus
from m3_tpu_torch.models import ingest_pipeline as ing
from m3_tpu_torch.models import query_pipeline as qp
from m3_tpu_torch.models import read_pipeline as rp
from m3_tpu_torch.models.read_pipeline import _SIMPLE_AGGS, decode_downsample, inputs_from_numpy
from m3_tpu_torch.ops import _build, graphite, histo_quantile, lane_topk, m3tsz_scalar, tiles
from m3_tpu_torch.ops import mesh_reduce, query_grouped
from m3_tpu_torch.ops import query_merge, query_temporal
from m3_tpu_torch.ops import consolidate as cons
from m3_tpu_torch.ops import downsample as ds
from m3_tpu_torch.ops import m3tsz_decode as dec
from m3_tpu_torch.ops import m3tsz_encode as enc
from m3_tpu_torch.ops.bitstream import pack_streams, unpack_stream
from m3_tpu_torch.parallel import mesh as pmesh
from m3_tpu_torch.parallel.repack import shard_repack
from m3_tpu_torch.storage import shard
from m3_tpu_torch.utils import native

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


def time_once(fn):
    """(fn(), its time in ms) from one run timed with CUDA events."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return out, start.elapsed_time(end)


def device_ms(fn, reps: int = 7) -> float:
    """Median device time of fn alone (ms): the stream is kept busy by
    ``torch.cuda._sleep`` while the host enqueues the start event, fn's
    launches and the end event, so the events time the device's work and
    not the host's."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(2_000_000)  # ~1 ms of cycles ahead of the events
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def host_us(fn, calls: int = 2000) -> float:
    """Host time of one call of fn (us), over `calls` calls in a row: what
    the caller's thread spends enqueueing, the device keeping up."""
    for _ in range(20):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    elapsed = time.perf_counter() - t0
    torch.cuda.synchronize()
    return elapsed / calls * 1e6


def _split_line(name: str, ms: float, fn) -> None:
    """Log the split of a timed call between the device and the host: ``ms``
    (CUDA events on an idle stream, the host's work inside the window) and
    ``device_ms(fn)``."""
    dev = device_ms(fn)
    log(f"time {name} split: {ms:.4f} ms between events on an idle stream, {dev:.4f} ms on the "
        f"device with the stream busy ahead, so {ms - dev:.4f} ms is the host's (the wrapper "
        f"and the launch)")


def card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def host_speed() -> str:
    """The host's cores and the median time of a fixed Python loop (7
    runs): host-bound times of two runs compare through it."""
    times = []
    for _ in range(7):
        t0 = time.perf_counter()
        sum(i * i for i in range(200_000))
        times.append((time.perf_counter() - t0) * 1e3)
    return f"{os.cpu_count()} cores; a fixed Python loop {statistics.median(times):.3f} ms"


def row(name, rows, ms, plain_ms, bytes_, ops_ms, library_ms=None, library=""):
    """Record and print one kernel's time beside its plain version's, its
    bound (the larger of the bytes over the memory rate and the operations
    over their rate) and, where one exists, a PyTorch call's time."""
    bytes_ms = bytes_ / HBM_BYTES_PER_S * 1e3
    rows[name] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": max(bytes_ms, ops_ms),
                  "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
                  "library_ms": library_ms}
    log(f"time {name}: kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, bound "
        f"{rows[name]['bound_ms']:.3f} ms by {rows[name]['bound_by']} (bytes {bytes_ms:.3f} ms, "
        f"operations {ops_ms:.3f} ms)"
        + (f", {library} {library_ms:.3f} ms" if library_ms is not None else ""))


# --- phase 3: kernel vs plain version on the card -------------------------

ERRORS: dict[str, float] = {}


def _record(kernel: str, err: float) -> None:
    ERRORS[kernel] = max(ERRORS.get(kernel, 0.0), err)


K2_FIELDS = ("sum", "sum_sq", "count", "min", "max", "last", "total", "error")


def _k2_flat(out):
    agg, total, error = out
    return (*agg, total, error)


def compare_k2(words, nbits, n_steps: int, window: int, full: bool, tag: str,
               int_optimized=True, unit=10**9):
    """K2 twice (the same bits) and against its plain version, bit for bit."""
    args = (words, nbits, n_steps, window, int_optimized, unit)
    name = "decode_downsample_fused" + ("[full_agg]" if full else "")
    k = twice(lambda: _k2_flat(dec.decode_downsample_fused(*args, full_agg=full)),
              f"{tag} {name}")
    p = _k2_flat(dec.decode_downsample_fused_plain(*args, full_agg=full))
    for field, kt, pt in zip(K2_FIELDS, k, p):
        _record(name, same_bits(kt, pt, f"{tag} {name}.{field}"))


def compare_k2_windows(walks):
    """K2 in both modes around its staged groups of windows (4; 8 with
    full_agg), on ``corpus.k2_window_probe_streams`` (61 lanes; lanes
    stopping in error inside windows): n_win 1, 3, 4, 5, 7, 8, 9 (window
    1), 9 windows of 4 and one of 36, then 1, 31, 33 and 129 lanes (with
    walks) at 9 windows of 4."""
    streams = corpus.k2_window_probe_streams()
    words, nbits = inputs_from_numpy(*pack_streams(streams), device=DEVICE)
    for n_steps, window in corpus.K2_WINDOW_CASES:
        for full in (False, True):
            compare_k2(words, nbits, n_steps, window, full, f"K2 windows ({n_steps}, {window})")
    for lanes in (1, 31, 33, 129):
        w, n = inputs_from_numpy(*pack_streams((streams + walks)[:lanes]), device=DEVICE)
        for full in (False, True):
            compare_k2(w, n, 36, 4, full, f"K2 windows, {lanes} lanes")
    torch.cuda.synchronize()
    log(f"parity K2 windows: {len(streams)} lanes at (n_steps, window) "
        f"{corpus.K2_WINDOW_CASES}, and 1, 31, 33, 129 lanes; both modes, twice: bit for bit")


def compare_decoders(streams, tag: str, int_optimized=True, unit=10**9, n_steps=N_DP,
                     window=WINDOW):
    dev = torch.device("cuda")
    words, nbits = inputs_from_numpy(*pack_streams(streams), device=dev)
    for full in (False, True):
        compare_k2(words, nbits, n_steps, window, full, tag, int_optimized, unit)
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


def compare_k3_steps(walks):
    """K3 against its plain version at 1, 31 and 33 steps (inside one staged
    tile of 16 steps, and past two), with and without flag_truncation, on
    the probe streams (lanes ending early and in error) and 45 walks: 71
    lanes, not a multiple of 32; all five outputs bit for bit."""
    streams = corpus.probe_streams(N_DP) + walks[:45]
    words, nbits = inputs_from_numpy(*pack_streams(streams), device=DEVICE)
    for n_steps in (1, 31, 33):
        for flag in (False, True):
            k = dec.decode_batched(words, nbits, n_steps, flag_truncation=flag)
            p = dec.decode_batched_plain(words, nbits, n_steps, flag_truncation=flag)
            for field, kt, pt in zip(("ts", "vs", "valid", "count", "error"), k, p):
                _record("decode_batched", same_bits(
                    kt, pt, f"K3 steps {n_steps} flag {flag} decode_batched.{field}"))
    torch.cuda.synchronize()
    log(f"parity K3 steps: {len(streams)} lanes at 1, 31 and 33 steps, with and without "
        f"truncation: ts, vs, valid, count, error bit for bit")


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


def kernel_times(words, nbits, datapoints: int, walks):
    """Each kernel at the main path's shapes: its time, its plain version's
    time (and output, held against it; K2 in both modes also twice, and
    first on its window probes, ``compare_k2_windows``), its bound, and
    torch.sort for K4, then the staged kernels' layouts.  `datapoints` is
    what this run's data holds (the decoders' total count)."""
    L, W = words.shape
    n_win = N_DP // WINDOW
    decode_ops_ms = datapoints * INT32_OPS_PER_DATAPOINT / INT32_OPS_PER_S * 1e3
    in_bytes = words.numel() * 4 + nbits.numel() * 4
    rows = {}

    compare_k2_windows(walks)
    for full in (False, True):
        name = "decode_downsample_fused" + ("[full_agg]" if full else "")
        compare_k2(words, nbits, N_DP, WINDOW, full, "main")
        torch.cuda.empty_cache()
        ms = time_ms(lambda: dec.decode_downsample_fused(words, nbits, N_DP, WINDOW,
                                                         full_agg=full), reps=7)
        plain_ms = time_ms(lambda: dec.decode_downsample_fused_plain(
            words, nbits, N_DP, WINDOW, full_agg=full), reps=3, warmup=0)
        out_bytes = L * n_win * (8 + 8 + (32 if full else 0)) + L * 5
        row(name, rows, ms, plain_ms, in_bytes + out_bytes, decode_ops_ms)
    torch.cuda.empty_cache()

    k = dec.decode_batched(words, nbits, N_DP)
    p = dec.decode_batched_plain(words, nbits, N_DP)
    for field, kt, pt in zip(("ts", "vs", "valid", "count", "error"), k, p):
        _record("decode_batched", same_bits(kt, pt, f"main decode_batched.{field}"))
    del p
    torch.cuda.empty_cache()
    ms = time_ms(lambda: dec.decode_batched(words, nbits, N_DP), reps=5)
    plain_ms = time_ms(lambda: dec.decode_batched_plain(words, nbits, N_DP), reps=3, warmup=0)
    row("decode_batched", rows, ms, plain_ms, in_bytes + L * N_DP * 17 + L * 5, decode_ops_ms)

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
    row("window_quantiles", rows, ms, plain_ms, q_bytes, q_ops_ms, library_ms, "torch.sort")
    del vs, valid, keys, kq, pq
    torch.cuda.empty_cache()
    log_layouts()
    return rows


def log_layouts() -> None:
    """One line per staged kernel of csrc/m3tsz_decode.cu: its staged width
    a lane, static shared memory a block, registers a thread and the blocks
    an SM holds (cudaOccupancyMaxActiveBlocksPerMultiprocessor)."""
    unit = {"decode_batched": "steps", "aggregate_tiles": "tiles"}
    for name, lay in dec.kernel_layout().items():
        log(f"layout {name}: {lay['staged']} {unit.get(name, 'windows')} staged a lane, "
            f"{lay['smem_bytes']} B shared a block of {lay['threads']} threads, "
            f"{lay['registers']} registers a thread, {lay['blocks_per_sm']} blocks per SM "
            f"({lay['blocks_per_sm'] * lay['threads'] // 32} warps)")


# --- phase 4: the query kernels vs their plain versions ------------------

SEC = 1_000_000_000
Q_RANGES = (93 * SEC, 300 * SEC)
Q_SERIES = 50_000
DEVICE = torch.device("cuda")
RATE_MODES = {"rate": (True, True), "increase": (True, False), "delta": (False, False)}
FP64_OPS_PER_S = 67e12 / 4  # non-tensor FP64 adds/multiplies: 64 lanes per SM per clock
BIT_EXACT_REDUCERS = ("count_over_time", "present_over_time", "last_over_time")
BIT_EXACT_AGGS = ("count", "min", "max", "group")


def close(a: torch.Tensor, b: torch.Tensor, rtol: float, what: str, atol=1e-12) -> float:
    """Raise unless a and b have the same NaN pattern, the same infinities
    and |a - b| <= atol + rtol * |b| elsewhere (``atol`` a number or a
    tensor of b's shape).  Returns max |a - b|."""
    check(a.shape == b.shape and a.dtype == b.dtype,
          f"{what}: {a.dtype}{tuple(a.shape)} vs {b.dtype}{tuple(b.shape)}")
    an, bn = torch.isnan(a), torch.isnan(b)
    check(torch.equal(an, bn), f"{what}: NaN patterns differ")
    fin = torch.isfinite(b)
    inf = ~fin & ~bn
    check(torch.equal(a[inf], b[inf]), f"{what}: infinities differ")
    err = (a[fin] - b[fin]).abs()
    e = float(err.max()) if err.numel() else 0.0
    per_cell = isinstance(atol, torch.Tensor)
    check(bool((err <= (atol[fin] if per_cell else atol) + rtol * b[fin].abs()).all()),
          f"{what}: the two differ beyond rtol {rtol}, atol {'per cell' if per_cell else atol} "
          f"(max abs err {e})")
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


def _chunk_probe(sizes, S: int, seed: int):
    """A matrix of the lanes of groups of `sizes` lanes (shuffled), with
    NaN holes, +-Inf, +-0.0 and ties, and 7 all-NaN padding lanes parked on
    group 0; and a near-one form that keeps the zeros, NaN and infinities
    and puts the other cells near 1.  multiply runs on both: on the first
    the products of large groups overflow and then meet a zero or an
    infinity, so their NaN, +-0.0 and +-inf cells depend on the order; on
    the second every order rounds differently."""
    rng = np.random.default_rng(seed)
    groups = np.repeat(np.arange(len(sizes)), sizes)
    rng.shuffle(groups)
    x = rng.integers(-40, 40, (len(groups), S)).astype(np.float64) * 0.25
    x[rng.random(x.shape) < 0.15] = np.nan
    x[rng.random(x.shape) < 0.01] = np.inf
    x[rng.random(x.shape) < 0.01] = -np.inf
    x[x == 0] = -0.0
    x[rng.random(x.shape) < 0.05] = 0.0
    x = np.concatenate([x, np.full((7, S), np.nan)])
    groups = np.concatenate([groups, np.zeros(7, dtype=np.int64)])
    near_one = np.where(np.isfinite(x) & (x != 0), 1.0 + x / 400.0, x)
    return torch.from_numpy(x).to(DEVICE), torch.from_numpy(near_one).to(DEVICE), groups


def compare_grouped_chunks():
    """QK4 against its plain version on groups across its chunk boundaries
    (CHUNK - 1, CHUNK and CHUNK + 1 lanes), groups of several chunks, one-
    lane and empty groups: every op code, twice.  count/min/max/group/range
    /last bit for bit; the sums at rtol 1e-12 (the plain version's
    `index_add_` adds with atomics on the card), stddev/stdvar 1e-9."""
    C = query_grouped.CHUNK
    n = 0
    for sizes, S, seed in (([1, 3, 0, C - 1, C, C + 1, 3 * C + 17, 40], 70, 1),
                           ([1] * 300 + [0] * 20 + [2 * C + 5], 33, 2),
                           ([8 * C], 512, 3)):
        x, near_one, groups = _chunk_probe(sizes, S, seed)
        G = len(sizes)
        gt = torch.from_numpy(groups).to(DEVICE)
        index = query_grouped.group_index(groups, G, DEVICE)
        center = torch.from_numpy(np.random.default_rng(seed).normal(size=(3, S))).to(DEVICE)
        for agg, v in [(agg, x) for agg in query_grouped.OPS] + [("multiply", near_one)]:
            empty = 0.0 if agg == "sqdev" else float("nan")
            c = center if agg == "sqdev" else None
            tag = f"chunks {sizes[:8]} S={S} {agg}{' near one' if v is near_one else ''}"
            out = twice(lambda: query_grouped.grouped_reduce(v, groups, G, agg, index, empty, c),
                        tag)
            want = query_grouped.grouped_reduce_plain(v, gt, G, agg, empty, c)
            kernel = "query_sqdev" if agg == "sqdev" else "query_grouped"
            if agg in BIT_EXACT_AGGS + ("range", "last", "multiply"):
                _record(kernel, same_bits(out, want, tag))
            else:
                rtol = 1e-9 if agg in ("stddev", "stdvar") else 1e-12
                _record(kernel, close(out, want, rtol, tag))
            n += 1
    torch.cuda.synchronize()
    log(f"query parity QK4 chunks: {n} cases (every op code; groups of 1, 3, {C - 1}, {C}, "
        f"{C + 1}, {2 * C + 5}, {3 * C + 17} and {8 * C} lanes, empty groups, padding on group 0; "
        f"NaN, +-Inf, +-0.0; multiply overflowing and near one): count/min/max/group/range/last/"
        f"multiply bit for bit, sums within rtol 1e-12, stddev/stdvar 1e-9, each twice bit for "
        f"bit")


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
    return fc, (words, nbits, slots, steps), results


def query_kernel_times(b: corpus.QueryBatch, inputs):
    """Each query kernel at the fan-out read's shapes: its time, its plain
    version's (held against it), its bound, and a PyTorch call where one
    computes the same function."""
    words, nbits, slots, steps = inputs
    dev = words.device
    rows = {}

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
    row("decode_batched[flag_truncation]", rows, ms, plain_ms, in_bytes + M * T * 17 + M * 5,
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
    row("query_merge", rows, time_ms(merge, reps=7),
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
    row("query_rate", rows, time_ms(fn, reps=7),
        time_ms(lambda: query_temporal.rate_plain(times, values, steps, r, True, True), reps=3),
        lane_bytes, rate_ops_ms,
        time_ms(lambda: torch.searchsorted(times, queries, right=True), reps=7),
        "torch.searchsorted (the bounds alone)")
    del queries

    fn = lambda: query_temporal.reduce_window(times, values, steps, r, "avg_over_time")  # noqa
    _record("query_reduce", close(fn(), query_temporal.reduce_plain(
        times, values, steps, r, "avg_over_time"), 1e-12, "main avg_over_time"))
    row("query_reduce", rows, time_ms(fn, reps=7),
        time_ms(lambda: query_temporal.reduce_plain(times, values, steps, r, "avg_over_time"),
                reps=3), lane_bytes + L * 8, L * S * 2 * levels * 4 / INT32_OPS_PER_S * 1e3)
    del times, values
    torch.cuda.empty_cache()

    G = b.n_groups
    groups = torch.from_numpy(b.groups).to(dev)
    index = query_grouped.group_index(b.groups, G, dev)
    fn = lambda: query_grouped.grouped_reduce(rate, groups, G, "sum", index)  # noqa: E731
    _record("query_grouped", close(fn(), query_grouped.grouped_reduce_plain(
        rate, groups, G, "sum"), 1e-12, "main sum by (g)"))
    vz = torch.nan_to_num(rate, nan=0.0)
    row("query_grouped", rows, time_ms(fn, reps=7),
        time_ms(lambda: query_grouped.grouped_reduce_plain(rate, groups, G, "sum"), reps=3),
        L * S * 8 + L * 8 + G * S * 8, L * S / FP64_OPS_PER_S * 1e3,
        time_ms(lambda: torch.zeros((G, S), dtype=torch.float64, device=dev).index_add_(
            0, groups, vz), reps=7), "index_add_")
    fleet_ms = time_ms(lambda: query_grouped.fleet_nansum(rate), reps=7)
    log(f"time fleet sum (QK4, one group of {L} lanes): {fleet_ms:.3f} ms")
    del rate, vz
    torch.cuda.empty_cache()
    return rows


# --- phase 8: the expression interpreter's kernels vs their plain versions --

EXPR_RANGES = (93 * SEC, 600 * SEC)
SELECT_PHIS = (0.0, 0.25, 0.5, 0.9, 1.0)
# k up to query_grouped.K_MAX (32) runs QK7's selection, a larger k its sort
TOPK_CASES = ((1, False), (3, False), (3, True), (10, True), (30, False), (32, True),
              (32, False), (33, False), (40, True))
HQ_PHIS = (0.0, 0.5, 0.9, 0.99, 1.0, -0.5, 1.5, float("nan"))


def _compare_select(x: torch.Tensor, groups: np.ndarray, n_groups: int, tag: str):
    gt = torch.from_numpy(groups).to(DEVICE)
    for phi in SELECT_PHIS:
        out = twice(lambda: query_grouped.grouped_quantile(x, groups, n_groups, phi),
                    f"{tag} quantile {phi}")
        _record("query_quantile", same_bits(out, query_grouped.grouped_quantile_plain(
            x, gt, n_groups, phi), f"{tag} quantile {phi}"))
    for k, bottom in TOPK_CASES:
        got = twice(lambda: lane_topk.masked_topk(x, groups, n_groups, k, bottom),
                    f"{tag} topk {k} {bottom}")
        want = lane_topk.masked_topk_plain(x, gt, n_groups, k, bottom)
        for field, kt, pt in zip(("out", "present", "rank"), got, want):
            _record("query_topk", same_bits(kt, pt, f"{tag} topk {k} {bottom} {field}"))


QK6_SIZES = (2049, 1, 255, 256, 257, 65_536)  # group 0 also takes the padding
QK6_PHIS = (0.0, 0.5, 0.9, 1.0)


def _quantile_probe(kind: str, S: int, seed: int):
    """Lanes of groups of QK6_SIZES lanes (shuffled) and 301 all-NaN padding
    lanes on group 0, 10% NaN cells and every seventh step all NaN: "ints"
    (a few values, long runs of ties, +-Inf), "zeros" (runs of +-0.0 at the
    middle and end ranks) or "wide" (magnitudes 1e-3 to 1e3, both signs)."""
    rng = np.random.default_rng(seed)
    groups = np.repeat(np.arange(len(QK6_SIZES)), QK6_SIZES)
    rng.shuffle(groups)
    shape = (len(groups), S)
    if kind == "ints":
        x = rng.integers(-6, 7, shape).astype(np.float64)
        x[rng.random(shape) < 0.01] = np.inf
        x[rng.random(shape) < 0.01] = -np.inf
    elif kind == "zeros":
        x = rng.choice([-1.0, -0.0, 0.0, 1.0], size=shape, p=[0.1, 0.4, 0.4, 0.1])
        x[:, ::3] = np.abs(x[:, ::3])  # no negatives: phi 0 reads a zero
    else:
        x = rng.standard_normal(shape) * 10.0 ** rng.integers(-3, 4, shape)
    x[rng.random(shape) < 0.1] = np.nan
    x[:, ::7] = np.nan
    x = np.concatenate([x, np.full((301, S), np.nan)])
    return torch.from_numpy(x).to(DEVICE), np.concatenate([groups, np.zeros(301, dtype=np.int64)])


def compare_quantile_chunks():
    """QK6 against its plain version on groups of one chunk and of several
    (QK6_SIZES), bit for bit, twice, and the sharded quantile on the same
    lanes (an 8-shard mesh on this card, the lanes gathered then QK6)."""
    G = len(QK6_SIZES)
    mesh = pmesh.make_mesh(8, device=DEVICE)
    n = 0
    for kind, S, seed in (("ints", 40, 1), ("zeros", 33, 2), ("wide", 64, 3)):
        x, groups = _quantile_probe(kind, S, seed)
        gt = torch.from_numpy(groups).to(DEVICE)
        for phi in QK6_PHIS:
            tag = f"QK6 {kind} S={S} phi {phi}"
            got = twice(lambda: query_grouped.grouped_quantile(x, groups, G, phi), tag)
            want = query_grouped.grouped_quantile_plain(x, gt, G, phi)
            _record("query_quantile", same_bits(got, want, tag))
            n += 1
        sharded = twice(lambda: qp._grouped_reduce_sharded(mesh, x, groups, G, "quantile", 0.9),
                        f"QK6 {kind} sharded")
        _record("query_quantile", same_bits(sharded, query_grouped.grouped_quantile_plain(
            x, gt, G, 0.9), f"QK6 {kind} sharded quantile 0.9"))
        n += 1
    torch.cuda.synchronize()
    log(f"expr parity quantile by (QK6 chunks): {n} cases (groups of {QK6_SIZES[1:]} lanes and "
        f"{QK6_SIZES[0]} + 301 padding lanes on group 0; ties, +-Inf, runs of +-0.0, magnitudes "
        f"1e-3 to 1e3, all-NaN steps; phi {QK6_PHIS}; the sharded quantile at 0.9): bit for bit, "
        f"twice")


def compare_expr_kernels():
    """QK5-QK8 against their plain versions on the card, on the CPU tests'
    probes (and groups past the shared-memory size), bit for bit, twice."""
    t, v, st = (torch.from_numpy(x).to(DEVICE) for x in corpus.minmax_probe_lanes())
    for r in EXPR_RANGES:
        for is_max in (False, True):
            out = twice(lambda: query_temporal.minmax_window(t, v, st, r, is_max),
                        f"minmax {r} {is_max}")
            _record("query_minmax", same_bits(out, query_temporal.minmax_plain(
                t, v, st, r, is_max), f"min/max_over_time {r // SEC}s"))
    tl, vl, sl = (torch.from_numpy(x).to(DEVICE) for x in corpus.long_lanes())
    for is_max in (False, True):
        out = twice(lambda: query_temporal.minmax_window(tl, vl, sl, 300 * SEC, is_max),
                    "minmax long")
        _record("query_minmax", same_bits(out, query_temporal.minmax_plain(
            tl, vl, sl, 300 * SEC, is_max), "min/max_over_time long lanes"))
    torch.cuda.synchronize()
    log("expr parity min/max_over_time (QK5): probe lanes (NaN, +-Inf, +-0.0 inside and "
        "across 32-sample blocks, empty windows) at 93s and 10m, 6 lanes x 32,768 at 5m: "
        "bit for bit, twice")
    sv, groups, n_groups = corpus.select_probes()
    _compare_select(torch.from_numpy(sv).to(DEVICE), groups, n_groups, "probes")
    rng = np.random.default_rng(31)
    big = rng.integers(-50, 50, (20_000, 6)).astype(np.float64)
    big[rng.random(big.shape) < 0.1] = np.nan
    big[big == 0] = -0.0
    gb = np.zeros(len(big), dtype=np.int64)
    gb[:3], gb[3:5000] = 2, 1  # groups of 15,000 (global scratch), 4,997 and 3 lanes
    _compare_select(torch.from_numpy(big).to(DEVICE), gb, 3, "large groups")
    # QK7's chunks: ties whose equal keys fall in different chunks (a group of
    # 2 * CHUNK + 3 lanes of 7 distinct values), a group with fewer than k
    # present lanes, groups of exactly 10 and 32 lanes (k = the group's size)
    C = query_grouped.CHUNK
    sizes = [2 * C + 3, 50, 10, 32, C + 1, 1]
    tg = np.repeat(np.arange(len(sizes)), sizes)
    rng.shuffle(tg)
    tv = rng.integers(-3, 4, (len(tg), 40)).astype(np.float64)
    tv[tv == 0] = -0.0
    tv[rng.random(tv.shape) < 0.05] = 0.0
    tv[rng.random(tv.shape) < 0.1] = np.nan
    tv[rng.random(tv.shape) < 0.02] = np.inf
    tv[(tg == 1)[:, None] & (rng.random(tv.shape) < 0.9)] = np.nan
    tv = np.concatenate([tv, np.full((40, 40), np.nan)])  # the trash group's padding
    tg = np.concatenate([tg, np.full(40, len(sizes))])
    _compare_select(torch.from_numpy(tv).to(DEVICE), tg, len(sizes) + 1, "chunk ties")
    torch.cuda.synchronize()
    log("expr parity quantile/topk/bottomk (QK6/QK7): probe groups of 1-25 lanes (ties, "
        "+-0.0, NaN, +-Inf, padding on the trash group), groups of 3, 4,997 and 15,000 "
        "lanes (QK6's groups of several chunks; the k > 32 sort's shared memory and global "
        "scratch) and chunk ties (groups of "
        f"{2 * C + 3} and {C + 1} lanes of 7 values, one of 50 lanes with 90% NaN, groups of "
        "10 and 32 lanes), phi 0-1, k 1-32 (the selection) and 33-40 (the sort): out, "
        "present and rank bit for bit, twice")
    cv, ri, ubs, caps = corpus.histogram_probes()
    cvd = torch.from_numpy(cv).to(DEVICE)
    rid, ubd, capd = (torch.from_numpy(x).to(DEVICE) for x in (ri, ubs, caps))
    for phi in HQ_PHIS:
        out = twice(lambda: histo_quantile.bucket_quantile(cvd, rid, ubd, capd, phi),
                    f"hq {phi}")
        _record("histo_quantile", same_bits(out, histo_quantile.bucket_quantile_plain(
            cvd, rid, ubd, capd, phi), f"histogram_quantile {phi}"))
    torch.cuda.synchronize()
    log("expr parity histogram_quantile (QK8): cumulative, +Inf below a finite bucket, "
        "negative bounds, total 0, NaN/+-Inf counts, padding; phi 0, 0.5, 0.9, 0.99, 1, "
        "-0.5, 1.5, NaN: bit for bit, twice")


# --- phase 7b: the rest of the temporal family and the subquery pack -------

FAMILY_PHIS = (0.0, 0.25, 0.5, 0.9, 0.99, 1.0)
FAMILY_HW = ((0.5, 0.5), (0.3, 0.1), (0.8, 0.6))
FAMILY_HORIZONS = (0.0, 600.0, 14400.0)


def linreg_atol(times, values, steps, r: int, horizon=None) -> torch.Tensor:
    """deriv/predict_linear's per-cell atol: 1e-9, and on lanes that reach
    1e8 (the 1e9-offset ones) 16 times the conditioning of the prefix form
    (``query_temporal.linreg_conditioning``; for predict_linear scaled by 1
    + |horizon| + range): two summation orders of the prefix sums differ on
    that scale there (ROADMAP queue 3)."""
    S = steps.shape[0]
    atol = torch.full((times.shape[0], S), 1e-9, dtype=torch.float64, device=times.device)
    big = (torch.nan_to_num(values).abs() >= 1e8).any(dim=1)
    if bool(big.any()):
        scale = 1.0 if horizon is None else 1.0 + abs(horizon) + r * 1e-9
        kappa = query_temporal.linreg_conditioning(times, values, steps, r)
        atol = torch.where(big[:, None], torch.maximum(atol, 16 * kappa * scale), atol)
    return atol


def compare_family(t, v, st, ranges, tag: str, phis=FAMILY_PHIS, hw=FAMILY_HW):
    """QK3's further ops and QK9-QK11 against their plain versions on one
    set of lanes, twice each: bit for bit but deriv/predict_linear (rtol
    1e-9 and ``linreg_atol``: the plain version's prefix sums are
    torch.cumsum's, the kernel's its own tiles')."""
    qt = query_temporal
    for r in ranges:
        for resets in (False, True):
            out = twice(lambda: qt.changes_window(t, v, st, r, resets), f"{tag} changes")
            _record("query_changes", same_bits(out, qt.changes_plain(t, v, st, r, resets),
                                               f"{tag} {'resets' if resets else 'changes'}"))
        slope, intercept = qt.linreg_plain(t, v, st, r)
        out = twice(lambda: qt.linreg_window(t, v, st, r, False), f"{tag} deriv")
        _record("query_linreg", close(out, slope, 1e-9, f"{tag} deriv {r // SEC}s",
                                      linreg_atol(t, v, st, r)))
        for h in FAMILY_HORIZONS:
            out = twice(lambda: qt.linreg_window(t, v, st, r, True, h), f"{tag} predict")
            _record("query_linreg", close(out, intercept + slope * h, 1e-9,
                                          f"{tag} predict_linear {h} {r // SEC}s",
                                          linreg_atol(t, v, st, r, h)))
        for sd in (False, True):
            out = twice(lambda: qt.stdvar_window(t, v, st, r, sd), f"{tag} stdvar")
            _record("query_stdvar", same_bits(out, qt.stdvar_plain(t, v, st, r, sd),
                                              f"{tag} stdvar {sd} {r // SEC}s"))
        for sf, tf in hw:
            out = twice(lambda: qt.holt_winters_window(t, v, st, r, sf, tf), f"{tag} hw")
            _record("query_holt_winters", same_bits(out, qt.holt_winters_plain(
                t, v, st, r, sf, tf), f"{tag} holt_winters {sf} {tf} {r // SEC}s"))
        for phi in phis:
            out = twice(lambda: qt.quantile_window(t, v, st, r, phi), f"{tag} qot")
            _record("query_quantile_window", same_bits(out, qt.quantile_window_plain(
                t, v, st, r, phi), f"{tag} quantile_over_time {phi} {r // SEC}s"))


def _subq_cells(rows: int, S: int, n_valid: int, seed: int):
    """A child matrix for QK12 (NaN, +-Inf, -0.0 cells, a row with no
    survivor) and its inner grid: (cv on the card, sub_times and sub_valid
    on the host)."""
    rng = np.random.default_rng(seed)
    cv = np.round(rng.standard_normal((rows, S)) * 5, 1)
    pick = rng.random(cv.shape)
    cv[pick < 0.3] = np.nan
    cv[(pick >= 0.3) & (pick < 0.33)] = np.inf
    cv[(pick >= 0.33) & (pick < 0.36)] = -np.inf
    cv[(pick >= 0.36) & (pick < 0.4)] = -0.0
    cv[min(1, rows - 1)] = np.nan
    sub = np.full(S, corpus.START + (n_valid - 1) * 60 * SEC, dtype=np.int64)
    sub[:n_valid] = corpus.START + np.arange(n_valid, dtype=np.int64) * 60 * SEC
    return (torch.from_numpy(cv).to(DEVICE), torch.from_numpy(sub),
            torch.from_numpy(np.arange(S) < n_valid))


def compare_family_kernels():
    """QK3's further ops (changes/resets, deriv/predict_linear), QK9
    (stddev/stdvar), QK10 (holt_winters), QK11 (quantile_over_time) and
    QK12 (the subquery pack) against their plain versions on the card,
    twice, on the CPU tests' probe lanes and on lanes of 32,768 samples
    (QK11's global-scratch sort at a 1h range)."""
    lanes = [("probes", corpus.temporal_probe_lanes()), ("minmax probes",
                                                        corpus.minmax_probe_lanes())]
    for tag, arrays in lanes:
        t, v, st = (torch.from_numpy(x).to(DEVICE) for x in arrays)
        compare_family(t, v, st, EXPR_RANGES, tag)
    # QK11 at the CPU test's window widths (1, 31, 32, 33, 64, 300 samples):
    # windows in registers up to 32, a sorted run past that, a long run at
    # 300; phi at the end buffers and in the network
    t, v, st = (torch.from_numpy(x).to(DEVICE) for x in corpus.quantile_width_lanes())
    for width in corpus.QUANTILE_WIDTHS:
        r = corpus.quantile_width_range(width)
        for phi in (0.0, 0.1, 0.5, 0.9, 0.99, 1.0):
            tag = f"width probe quantile_over_time {phi} over {width} samples"
            out = twice(lambda: query_temporal.quantile_window(t, v, st, r, phi), tag)
            _record("query_quantile_window", same_bits(out, query_temporal.quantile_window_plain(
                t, v, st, r, phi), tag))
    t, v, st = (torch.from_numpy(x).to(DEVICE) for x in corpus.long_lanes())
    compare_family(t, v, st, (300 * SEC,), "long lanes", phis=(0.5, 0.99), hw=((0.3, 0.1),))
    compare_family(t, v, st[::8].contiguous(), (3600 * SEC,), "long lanes 1h", phis=(0.0, 0.99),
                   hw=((0.3, 0.1),))
    torch.cuda.synchronize()
    log("expr parity changes/resets, deriv/predict_linear (QK3), stddev/stdvar (QK9), "
        "holt_winters (QK10), quantile_over_time (QK11): probe lanes (NaN holes, all-NaN, "
        "sparse, the 1.5e9 canary, +-Inf, +-0.0 ties, counter resets, short lanes) at 93s and "
        "10m, QK11 on windows of 1, 31, 32, 33, 64 and 300 samples (+-0.0 ties at the "
        "selected ranks, all-NaN and empty windows), 6 lanes x 32,768 at 5m and 1h (QK11's "
        "global scratch), horizons 0-14400, "
        "(sf, tf) 3 pairs, phi 0-1: bit for bit but the fit's sums (rtol 1e-9, linreg_atol), "
        "twice")
    for rows, S, n_valid in ((6, 64, 41), (3, 64, 1), (5000, 512, 385)):
        cv, sub, valid = _subq_cells(rows, S, n_valid, rows)
        got = twice(lambda: query_merge.subq_pack(cv, sub, valid), "subq_pack")
        want = query_merge.subq_pack_plain(cv, sub, valid)
        for field, g, w in zip(("times", "values"), got, want):
            _record("subq_pack", same_bits(g, w, f"subq_pack {rows}x{S} {field}"))
    torch.cuda.synchronize()
    log("expr parity subquery pack (QK12): 6x64, 3x64 (one valid step), 5,000x512 (385 "
        "valid) with NaN, +-Inf, -0.0 cells and an empty row vs the stable sort: bit for bit, "
        "twice")


# --- phase 9: the expression interpreter at full size -----------------------

N_JOBS_RATIO = 32  # bench.py:1730-1741
N_JOBS = 100
N_HIST = 4166  # x 12 DefBuckets = 49,992 series
HIST_UNIQUE = 167  # unique histograms encoded, tiled to N_HIST


def np_bucket_quantile(cv: np.ndarray, rows_idx, ubs, caps, phi: float) -> np.ndarray:
    """numpy histogram_quantile over gathered bucket rows (upstream
    bucketQuantile, as ops/histo_quantile.py states it), for phi in [0, 1]."""
    c = np.maximum.accumulate(np.nan_to_num(cv[rows_idx]), axis=1)  # [G, B, S]
    total = c[:, -1, :]
    rank = phi * total
    idx = np.minimum((c < rank[:, None, :]).sum(axis=1), c.shape[1] - 1)
    hi_ub = np.take_along_axis(ubs, idx, axis=1)
    lo_ub = np.where(idx > 0, np.take_along_axis(ubs, np.maximum(idx - 1, 0), axis=1), 0.0)
    hi_c = np.take_along_axis(c, idx[:, None, :], axis=1)[:, 0]
    lo_c = np.where(idx > 0, np.take_along_axis(c, np.maximum(idx - 1, 0)[:, None, :],
                                                axis=1)[:, 0], 0.0)
    with np.errstate(invalid="ignore", divide="ignore"):
        frac = np.clip((rank - lo_c) / np.maximum(hi_c - lo_c, 1e-12), 0.0, 1.0)
        val = lo_ub + (hi_ub - lo_ub) * frac
    val = np.where((idx == 0) & (hi_ub <= 0), hi_ub, val)
    val = np.where(np.isposinf(hi_ub), caps[:, None], val)
    return np.where(total > 0, val, np.nan)


def np_quantile(rows: np.ndarray, phi: float) -> np.ndarray:
    """numpy quantile of each column's present cells (linear interpolation
    at phi * (n - 1)); NaN where a column has none."""
    out = np.full(rows.shape[1], np.nan)
    for s in range(rows.shape[1]):
        x = np.sort(rows[~np.isnan(rows[:, s]), s])
        if len(x):
            h = phi * (len(x) - 1)
            lo, hi = x[int(np.floor(h))], x[int(np.ceil(h))]
            out[s] = lo + (hi - lo) * (h - np.floor(h))
    return out


def np_topk(values: np.ndarray, groups: np.ndarray, k: int):
    """numpy topk per (group, step): a stable argsort of -value (NaN last)
    within each group; returns (out, present, rank) as masked_topk does."""
    key = -np.where(np.isnan(values), -np.inf, values)
    pos = np.empty(values.shape, dtype=np.int64)
    for g in np.unique(groups):
        lanes = np.flatnonzero(groups == g)
        order = np.argsort(key[lanes], axis=0, kind="stable")
        inv = np.empty_like(order)
        np.put_along_axis(inv, order, np.broadcast_to(np.arange(len(lanes))[:, None],
                                                      order.shape), axis=0)
        pos[lanes] = inv
    kept = pos < k
    return (np.where(kept, values, np.nan), kept.any(axis=1),
            np.where(kept[:, -1], pos[:, -1], lane_topk._NO_RANK))


def _words_slice(b: corpus.QueryBatch, lo: int, hi: int):
    """The streams of lanes [lo, hi) of a fan-out batch, lanes renumbered."""
    rows = (b.slots >= lo) & (b.slots < hi)
    return b.words[rows], b.nbits[rows], b.slots[rows] - lo


def _expr_query(name: str, eb: corpus.ExprPlanBuilder, root, want: list[str]):
    inputs = corpus.expr_inputs_from_numpy(*eb.inputs(), DEVICE)
    return name, root.plan, inputs, want


def _drive(plan, inputs, want, name: str, batched: bool = False):
    run = qp.device_expr_pipeline_batched if batched else qp.device_expr_pipeline
    _build.reset_launches()
    res = run(plan, *inputs)
    torch.cuda.synchronize()
    launches = dict(_build.LAUNCHES)
    for kernel in want:
        check(launches.get(kernel, 0) > 0, f"expr {name}: {kernel} not launched")
    for err in res[2]:
        check(not bool(err.any()), f"expr {name}: error flags")
    return res, launches


def _time_expr(name: str, plan, inputs, launches, rows: int, checked: str, results: dict,
               batched: bool = False):
    run = qp.device_expr_pipeline_batched if batched else qp.device_expr_pipeline
    fn = lambda: run(plan, *inputs)  # noqa: E731
    ms = time_ms(fn, reps=7)
    wall = wall_ms(fn)
    results[name] = {"launches": launches, "ms": ms, "wall_ms": wall, "rows": rows}
    log(f"expr {name}: launches {launches}; {ms:.3f} ms device (median of 7); {wall:.3f} ms "
        f"with the root's .cpu(); {checked}")


def expr_main(fc: corpus.FanoutCorpus):
    """BASELINE config 4's width through device_expr_pipeline(_batched):
    seven queries, each driven once with the launch counts reset just
    before and read just after, checked at full size against something
    independent of its new kernel, then timed."""
    b = fc.batch
    n = b.n_lanes
    S = len(b.steps)
    r = b.range_nanos
    results = {}
    front = ["decode_batched", "query_merge"]
    kw = dict(n_cap=b.n_cap, range_nanos=r, n_dp=b.n_dp, device=DEVICE)

    # 1. the grouped-rate ratio of bench.py:1768, 25,000 + 25,000 series, 32 jobs
    eb = corpus.ExprPlanBuilder(b.steps)
    half = n // 2
    leaves = []
    for lo in (0, half):
        w, nb, sl = _words_slice(b, lo, lo + half)
        labels = [{"job": "j%02d" % (i % N_JOBS_RATIO), "host": "h%06d" % i} for i in range(half)]
        leaves.append((eb.words_leaf(w, nb, sl, labels, b.n_dp, b.n_cap, r), w, nb, sl))
    aggs = [eb.agg("sum", eb.leaf(lf, "rate"), ("job",)) for lf, *_ in leaves]
    root = eb.vv("/", *aggs, on=("job",))
    name, plan, inputs, want = _expr_query(
        "sum by (job)(rate(http_requests[5m])) / on(job) sum by (job)(rate(http_limit[5m]))",
        eb, root, front + ["query_rate", "query_grouped"])
    (out, _, _), launches = _drive(plan, inputs, want, name)
    steps_p = inputs[2]
    per = []
    for (lf, w, nb, sl), agg in zip(leaves, aggs):
        groups = eb.params[agg.plan[3]][0]
        g, _ = qp.device_grouped_pipeline(w, nb, sl, steps_p, groups, n_lanes=len(groups),
                                          n_groups=agg.rows_pad, **kw)
        per.append(g.cpu().numpy())
    with np.errstate(invalid="ignore", divide="ignore"):
        want_np = per[0][:N_JOBS_RATIO] / per[1][:N_JOBS_RATIO]
    got = out.cpu()
    check(tuple(got.shape) == (N_JOBS_RATIO, 512), f"expr ratio: shape {tuple(got.shape)}")
    err = close(got[:N_JOBS_RATIO], torch.from_numpy(want_np), 1e-12,
                "ratio vs two device_grouped_pipeline calls divided on the host")
    check(bool(torch.isfinite(got[:N_JOBS_RATIO, :S]).all()), "expr ratio: non-finite")
    _time_expr("ratio", plan, inputs, launches, N_JOBS_RATIO,
               f"vs two device_grouped_pipeline calls divided on the host: max abs err {err} "
               f"(rtol 1e-12)", results)
    del out, inputs, per

    # 2. histogram_quantile(0.99, sum by (job, le)(rate(..._bucket[5m])))
    t0 = time.time()
    hf = corpus.histogram_fleet(N_HIST, N_JOBS, HIST_UNIQUE, fc=fc)
    log(f"expr data: {N_HIST} histograms x {len(corpus.DEF_BUCKETS)} buckets = {len(hf.labels)} "
        f"series, {len(hf.nbits)} streams, words u32{hf.words.shape}; encoded in "
        f"{time.time() - t0:.1f} s")
    eb = corpus.ExprPlanBuilder(b.steps)
    lf = eb.words_leaf(hf.words, hf.nbits, hf.slots, hf.labels, hf.n_dp, hf.n_cap, r)
    agg = eb.agg("sum", eb.leaf(lf, "rate"), ("job", "le"))
    root = eb.hq(0.99, agg)
    log(f"expr hq plan: agg g_pad {agg.rows_pad}, hq g_pad {root.rows_pad}, b_pad "
        f"{root.plan[2]}, lanes_pad {eb.leaves[lf]['valid'].shape[0]}")
    name, plan, inputs, want = _expr_query(
        "histogram_quantile(0.99, sum by (job, le)(rate(http_request_duration_seconds_bucket"
        "[5m])))", eb, root, front + ["query_rate", "query_grouped", "histo_quantile"])
    (out, _, _), launches = _drive(plan, inputs, want, name)
    groups = eb.params[agg.plan[3]][0]
    cv, _ = qp.device_grouped_pipeline(hf.words, hf.nbits, hf.slots, inputs[2], groups,
                                       n_lanes=len(groups), n_groups=agg.rows_pad, **kw)
    rows_idx, ubs, caps, _, _ = eb.params[root.plan[3]]
    want_np = np_bucket_quantile(cv.cpu().numpy(), rows_idx[:N_JOBS], ubs[:N_JOBS],
                                 caps[:N_JOBS], 0.99)
    got = out.cpu()
    err = close(got[:N_JOBS], torch.from_numpy(want_np), 1e-12,
                "histogram_quantile vs numpy on the grouped bucket rates")
    check(bool(torch.isnan(got[N_JOBS:]).all()) and bool(torch.isfinite(got[:N_JOBS]).any()),
          "expr hq: padding rows / no finite quantile")
    _time_expr("histogram_quantile", plan, inputs, launches, N_JOBS,
               f"vs numpy on device_grouped_pipeline's bucket rates: max abs err {err} "
               f"(rtol 1e-12)", results)
    shapes = {"hq": (cv, rows_idx, ubs, caps)}
    del out, inputs, hf

    # 3-6 read the whole fan-out batch: one leaf of 50,000 lanes (65,536 padded)
    words, nbits, slots = b.words, b.nbits, b.slots
    job_labels = [{"job": "j%03d" % (i % N_JOBS), "instance": "i%06d" % i} for i in range(n)]
    rate, _, _ = qp.device_rate_pipeline(words, nbits, slots, corpus.ExprPlanBuilder(
        b.steps).steps, n_lanes=corpus.bucket_pow2(n, 64), **kw)
    rate_np = rate.cpu().numpy()
    shapes["rate"] = rate
    lanes_pad = rate.shape[0]

    # 3. topk(10, rate(http_requests[5m]))
    eb = corpus.ExprPlanBuilder(b.steps)
    lf = eb.words_leaf(words, nbits, slots, job_labels, b.n_dp, b.n_cap, r)
    root = eb.topk("topk", 10, eb.leaf(lf, "rate"))
    name, plan, inputs, want = _expr_query("topk(10, rate(http_requests[5m]))", eb, root,
                                           front + ["query_rate", "query_topk"])
    (out, aux, _), launches = _drive(plan, inputs, want, name)
    tgroups = eb.params[root.plan[4]][0]
    w_out, w_present, w_rank = np_topk(rate_np, tgroups, 10)
    same_bits(out.cpu(), torch.from_numpy(w_out), "topk vs numpy (stable argsort)")
    same_bits(aux[0].cpu(), torch.from_numpy(w_present), "topk present vs numpy")
    same_bits(aux[1].cpu(), torch.from_numpy(w_rank), "topk rank vs numpy")
    check(int(aux[0][:n].sum()) >= 10, "topk: fewer than k lanes kept")
    _time_expr("topk", plan, inputs, launches, lanes_pad,
               "out, present and rank vs numpy's stable argsort of device_rate_pipeline's "
               "rates: bit for bit", results)
    shapes["topk_groups"] = (tgroups, root.plan[3])
    del out, aux, inputs

    # 4. quantile by (job)(0.9, rate(http_requests[5m]))
    eb = corpus.ExprPlanBuilder(b.steps)
    lf = eb.words_leaf(words, nbits, slots, job_labels, b.n_dp, b.n_cap, r)
    agg = eb.agg("quantile", eb.leaf(lf, "rate"), ("job",), phi=0.9)
    name, plan, inputs, want = _expr_query("quantile by (job)(0.9, rate(http_requests[5m]))",
                                           eb, agg, front + ["query_rate", "query_quantile"])
    (out, _, _), launches = _drive(plan, inputs, want, name)
    qgroups = eb.params[agg.plan[3]][0]
    got = out.cpu().numpy()
    sample = (0, 1, 37, 99)
    err = 0.0
    for j in sample:
        w_q = np_quantile(rate_np[:n][qgroups[:n] == j], 0.9)
        err = max(err, close(torch.from_numpy(got[j]), torch.from_numpy(w_q), 1e-12,
                             f"quantile job {j} vs numpy"))
    check(bool(np.isnan(got[N_JOBS:]).all()), "expr quantile: padding rows")
    _time_expr("quantile", plan, inputs, launches, N_JOBS,
               f"jobs {sample} vs numpy (sort, interpolation): max abs err {err} (rtol 1e-12)",
               results)
    shapes["quantile_groups"] = (qgroups, agg.rows_pad)
    del out, inputs

    # 5. max by (job)(max_over_time(mem_use[5m])) and min_over_time(mem_use[5m])
    eb = corpus.ExprPlanBuilder(b.steps)
    lf = eb.words_leaf(words, nbits, slots, job_labels, b.n_dp, b.n_cap, r)
    root = eb.agg("max", eb.leaf(lf, "max_over_time"), ("job",))
    name, plan, inputs, want = _expr_query("max by (job)(max_over_time(mem_use[5m]))", eb, root,
                                           front + ["query_minmax", "query_grouped"])
    (out, _, _), launches = _drive(plan, inputs, want, name)
    got = out.cpu().numpy()
    jobs = (0, 57)
    uniq = [u for u in range(fc.n_unique) if u % N_JOBS in jobs]
    t_h, v_h = host_lanes(fc, uniq)
    host_max = cons.window_reduce(t_h, v_h, b.steps, r, "max_over_time")
    for j in jobs:
        want_j = np.fmax.reduce(host_max[[i for i, u in enumerate(uniq) if u % N_JOBS == j]],
                                axis=0)
        same_bits(torch.from_numpy(got[j, :S]), torch.from_numpy(want_j),
                  f"max by (job) job {j} vs the host tier's window_reduce")
    _time_expr("max_by_max_over_time", plan, inputs, launches, N_JOBS,
               f"jobs {jobs} vs the host tier's window_reduce over their "
               f"{len(uniq)} unique lanes: bit for bit", results)
    del out, inputs
    eb = corpus.ExprPlanBuilder(b.steps)
    lf = eb.words_leaf(words, nbits, slots, job_labels, b.n_dp, b.n_cap, r)
    root = eb.leaf(lf, "min_over_time")
    name, plan, inputs, want = _expr_query("min_over_time(mem_use[5m])", eb, root,
                                           front + ["query_minmax"])
    (out, _, _), launches = _drive(plan, inputs, want, name)
    reps = n // fc.n_unique
    same_bits(out[:n].view(reps, fc.n_unique, -1),
              out[:fc.n_unique].expand(reps, fc.n_unique, out.shape[1]).contiguous(),
              "min_over_time: tiled lanes")
    oracle = [0, 1, fc.n_unique - 1]
    t_h, v_h = host_lanes(fc, oracle)
    same_bits(out[oracle, :S].cpu(), torch.from_numpy(
        cons.window_reduce(t_h, v_h, b.steps, r, "min_over_time")),
        "min_over_time vs the host tier's window_reduce")
    check(bool(torch.isnan(out[n:]).all()), "min_over_time: padding rows")
    _time_expr("min_over_time", plan, inputs, launches, lanes_pad,
               f"tiled lanes equal, lanes {oracle} vs the host tier's window_reduce: bit for "
               "bit", results)
    shapes["lanes"] = inputs
    del out

    # 6. (rate(http_requests[5m]) > 0.5) * 60
    eb = corpus.ExprPlanBuilder(b.steps)
    lf = eb.words_leaf(words, nbits, slots, job_labels, b.n_dp, b.n_cap, r)
    root = eb.vs("*", eb.vs(">", eb.leaf(lf, "rate"), 0.5), 60.0)
    name, plan, inputs, want = _expr_query("(rate(http_requests[5m]) > 0.5) * 60", eb, root,
                                           front + ["query_rate"])
    (out, _, _), launches = _drive(plan, inputs, want, name)
    with np.errstate(invalid="ignore"):
        want_np = np.where(rate_np > 0.5, rate_np * 60.0, np.nan)
    same_bits(out.cpu(), torch.from_numpy(want_np), "(rate > 0.5) * 60 vs numpy on the rates")
    kept = int((~torch.isnan(out)).sum())
    check(0 < kept < n * out.shape[1], f"(rate > 0.5) * 60: {kept} cells kept")
    _time_expr("rate_filter", plan, inputs, launches, lanes_pad,
               f"vs numpy on device_rate_pipeline's rates: bit for bit ({kept} cells kept)",
               results)
    del out, inputs

    # 7. the megabatch: 16 dashboard queries through device_expr_pipeline_batched
    queries = [corpus.megabatch_query(seed) for seed in range(16)]
    plan = queries[0][0]
    check(all(q[0] == plan for q in queries), "megabatch: plans differ")
    inputs = corpus.expr_inputs_from_numpy(*corpus.stack_queries([q[1] for q in queries]),
                                           DEVICE)
    name = ("16 x sum by (job)(sum_over_time(mem_use[5m])) / "
            "sum by (job)(count_over_time(mem_use[5m]))")
    (out, _, _), launches = _drive(plan, inputs, ["query_reduce", "query_grouped"], name,
                                   batched=True)
    solo_launches = None
    for q, (_, qin) in enumerate(queries):
        _build.reset_launches()
        solo = qp.device_expr_pipeline(plan, *corpus.expr_inputs_from_numpy(*qin, DEVICE))[0]
        solo_launches = dict(_build.LAUNCHES)
        same_bits(out[q], solo, f"megabatch slice {q} vs its solo call")
    check(bool(torch.isfinite(out[:, :8, :corpus.MEGABATCH_STEPS]).all()), "megabatch: values")
    _time_expr("megabatch", plan, inputs, launches, 16 * 8,
               f"each of the 16 slices vs its solo call: bit for bit (a solo call launches "
               f"{solo_launches})", results, batched=True)
    del out, inputs
    torch.cuda.synchronize()
    return shapes, results


def expr_kernel_times(b: corpus.QueryBatch, shapes: dict):
    """QK5-QK8 at the expression queries' shapes: each kernel's time, its
    plain version's (held against it), its bound, and a PyTorch call where
    one computes the same function (torch.sort along the lanes for QK6 and
    QK7; none for QK5 and QK8)."""
    rows = {}
    leaves, _, steps = shapes["lanes"]
    lf = leaves[0]
    L = lf["valid"].shape[0]
    times, values, _ = qp._decode_merge(lf["words"], lf["nbits"], lf["slots"], L, b.n_cap,
                                        b.n_dp, SEC)
    r = b.range_nanos
    N, S = times.shape[1], steps.shape[0]
    fn = lambda: query_temporal.minmax_window(times, values, steps, r, True)  # noqa: E731
    _record("query_minmax", same_bits(fn(), query_temporal.minmax_plain(
        times, values, steps, r, True), "main max_over_time"))
    _, left, right = query_temporal.window_bounds_plain(times, steps, r)
    samples = int((right - left).sum())
    levels = query_temporal.search_levels(N)
    # two bisections of `levels` 64-bit compare/selects per (lane, step) and
    # an isnan test + IEEE max (3 FP64 operations) per windowed sample
    ops_ms = (L * S * 2 * levels * 4 / INT32_OPS_PER_S + samples * 3 / FP64_OPS_PER_S) * 1e3
    row("query_minmax", rows, time_ms(fn, reps=7),
        time_ms(lambda: query_temporal.minmax_plain(times, values, steps, r, True), reps=3),
        L * N * 16 + S * 8 + L * S * 8, ops_ms)
    del times, values, left, right
    torch.cuda.empty_cache()

    rate = shapes["rate"]
    L, S = rate.shape
    for kernel, (groups, n_groups) in (("query_quantile", shapes["quantile_groups"]),
                                       ("query_topk", shapes["topk_groups"])):
        quantile = kernel == "query_quantile"
        index = query_grouped.group_index(groups, n_groups, DEVICE)
        gt = torch.from_numpy(groups).to(DEVICE)
        sizes = index.sizes
        if quantile:
            fn = lambda: query_grouped.launch_quantile(rate, index, 0.9)  # noqa: E731
            plain = lambda: query_grouped.grouped_quantile_plain(rate, gt, n_groups, 0.9)  # noqa
            _record(kernel, same_bits(fn(), plain(), "main quantile by (job)"))
            out_bytes = n_groups * S * 8
        else:
            mode = query_grouped.SELECT_TOPK
            fn = lambda: query_grouped.launch_topk(rate, index, mode, 10)  # noqa: E731
            plain = lambda: lane_topk.masked_topk_plain(rate, gt, n_groups, 10, False)  # noqa
            sort = lambda: query_grouped.launch_select(rate, index, mode, k=10)  # noqa: E731
            want = plain()
            for kt, st, pt in zip(fn(), sort(), want):
                _record(kernel, same_bits(kt, pt, "main topk"))
                same_bits(st, pt, "main topk, the sort path")
            del want
            out_bytes = L * S * 8 + L * 9
        # what the function needs, not the kernel's sort network: a linear
        # selection per (group, step), one 64-bit compare (two INT32
        # operations) per lane for each order statistic sought (quantile's
        # floor(h) and ceil(h); topk's k-th key)
        ops_ms = int(sizes.sum()) * S * 2 * (2 if quantile else 1) / INT32_OPS_PER_S * 1e3
        sort_ms = time_ms(lambda: torch.sort(rate, dim=0, stable=True), reps=5)
        if quantile:
            lib_ms, lib = sort_ms, "torch.sort along the lanes"
        else:
            lib_ms, lib = (time_ms(lambda: torch.topk(rate, 10, dim=0), reps=5),
                           "torch.topk(k=10) along the lanes")
        row(kernel, rows, time_ms(fn, reps=5), time_ms(plain, reps=3),
            L * S * 8 + L * 8 + out_bytes, ops_ms, lib_ms, lib)
        if not quantile:
            log(f"time query_topk beside the sort: torch.sort along the lanes {sort_ms:.3f} ms; "
                f"the select kernel's bitonic sort at the same k=10 (the path of k > "
                f"{query_grouped.K_MAX}) {time_ms(sort, reps=5):.3f} ms")

    cv, rows_idx, ubs, caps = shapes["hq"]
    G, B = rows_idx.shape
    rid, ubd, capd = (torch.from_numpy(x).to(DEVICE) for x in (rows_idx, ubs, caps))
    fn = lambda: histo_quantile.bucket_quantile(cv, rid, ubd, capd, 0.99)  # noqa: E731
    _record("histo_quantile", same_bits(fn(), histo_quantile.bucket_quantile_plain(
        cv, rid, ubd, capd, 0.99), "main histogram_quantile"))
    # the gathered cells read once, the index/bound arrays, one f64 out per cell;
    # ~20 FP64 operations per bucket per (group, step) over three walks
    row("histo_quantile", rows, time_ms(fn, reps=7),
        time_ms(lambda: histo_quantile.bucket_quantile_plain(cv, rid, ubd, capd, 0.99), reps=3),
        G * B * S * 8 + G * B * 16 + G * 8 + G * S * 8, G * B * S * 20 / FP64_OPS_PER_S * 1e3)
    torch.cuda.synchronize()
    return rows


# --- phase 9b: the rest of the range functions and the subquery at full width

MIN = 60 * SEC
FAMILY_ORACLE_ROWS = 16  # unique rows held against the host tier in each plan


def _tiled_rows(out: torch.Tensor, n: int, n_unique: int, what: str):
    """Every real row equals its unique row bit for bit (lane l reads unique
    l % n_unique), every padding row is NaN."""
    reps = n // n_unique
    same_bits(out[:n].view(reps, n_unique, -1),
              out[:n_unique].expand(reps, n_unique, out.shape[1]).contiguous(),
              f"{what}: tiled lanes")
    check(bool(torch.isnan(out[n:]).all()), f"{what}: padding rows")


def _host_family(fn: str, t, v, steps, r: int, kw: dict) -> np.ndarray:
    """The host tier (ops/consolidate.py) of one function on merged lanes."""
    with np.errstate(all="ignore"):
        if fn in query_temporal.CHANGES_FNS:
            return cons.window_changes(t, v, steps, r, fn == "resets")
        if fn in query_temporal.LINREG_FNS:
            slope, intercept, _ = cons.window_linreg(t, v, steps, r)
            return slope if fn == "deriv" else intercept + slope * kw["horizon"]
        if fn == "holt_winters":
            return cons.window_holt_winters(t, v, steps, r, kw["hw_sf"], kw["hw_tf"])
        if fn == "quantile_over_time":
            return cons.window_quantile(t, v, steps, r, kw["phi"])
        return cons.window_reduce(t, v, steps, r, fn)


FAMILY_PLANS = (  # (query, fn, range, parameters, its kernel)
    ("stddev_over_time(m[5m])", "stddev_over_time", 5 * MIN, {}, "query_stdvar"),
    ("stdvar_over_time(m[5m])", "stdvar_over_time", 5 * MIN, {}, "query_stdvar"),
    ("changes(m[15m])", "changes", 15 * MIN, {}, "query_changes"),
    ("resets(m[15m])", "resets", 15 * MIN, {}, "query_changes"),
    ("deriv(m[15m])", "deriv", 15 * MIN, {}, "query_linreg"),
    ("predict_linear(m[1h], 14400)", "predict_linear", 60 * MIN, {"horizon": 14400.0},
     "query_linreg"),
    ("holt_winters(m[1h], 0.3, 0.1)", "holt_winters", 60 * MIN, {"hw_sf": 0.3, "hw_tf": 0.1},
     "query_holt_winters"),
    ("quantile_over_time(0.99, m[5m])", "quantile_over_time", 5 * MIN, {"phi": 0.99},
     "query_quantile_window"),
)


def family_main(fc: corpus.FanoutCorpus):
    """BASELINE config 4's data (50,000 series, 65,536 lanes padded, n_cap
    2,160, 355 steps padded to 512) through device_expr_pipeline: one plan
    per new range function, the subquery max_over_time(rate(m[5m])[30m:1m])
    and quantile_over_time through device_reduce_pipeline.  Each is driven
    once with the launch counts reset just before and read just after;
    every real row must equal its unique row bit for bit and padding rows
    be NaN; then some unique rows are held against the host tier
    (ops/consolidate.py; the subquery against the per-node rate pipeline on
    the inner grid and a numpy max), and the query is timed."""
    b = fc.batch
    n, S = b.n_lanes, len(b.steps)
    words, nbits, slots = b.words, b.nbits, b.slots
    job_labels = [{"job": "j%03d" % (i % N_JOBS), "instance": "i%06d" % i} for i in range(n)]
    front = ["decode_batched", "query_merge"]
    results = {}
    oracle = list(range(0, fc.n_unique, fc.n_unique // FAMILY_ORACLE_ROWS))[:FAMILY_ORACLE_ROWS]
    t_h, v_h = host_lanes(fc, oracle)
    lanes_pad = corpus.bucket_pow2(n, 64)
    for name, fn, r, kw, kernel in FAMILY_PLANS:
        eb = corpus.ExprPlanBuilder(b.steps)
        lf = eb.words_leaf(words, nbits, slots, job_labels, b.n_dp, b.n_cap, r)
        root = eb.leaf(lf, fn, **kw)
        name, plan, inputs, want = _expr_query(name, eb, root, front + [kernel])
        (out, _, _), launches = _drive(plan, inputs, want, name)
        _tiled_rows(out, n, fc.n_unique, name)
        t0 = time.time()
        host = torch.from_numpy(_host_family(fn, t_h, v_h, b.steps, r, kw))
        got = out[oracle, :S].cpu()
        if fn in query_temporal.CHANGES_FNS:
            err = same_bits(got, host, f"{name} vs the host tier")
            tol = "bit for bit"
        else:
            err = close(got, host, 1e-9, f"{name} vs the host tier", 1e-9)
            tol = f"max abs err {err} (rtol 1e-9, atol 1e-9)"
        check(bool(torch.isfinite(got).any()), f"{name}: no finite cell")
        _time_expr(fn, plan, inputs, launches, lanes_pad,
                   f"tiled lanes equal, padding NaN; unique rows {oracle[:3]}... "
                   f"({len(oracle)}) vs the host tier ({time.time() - t0:.1f} s): {tol}", results)
        del out, inputs

    # the subquery: max_over_time(rate(m[5m])[30m:1m]), 385 inner steps -> 512
    eb = corpus.ExprPlanBuilder(b.steps)
    root = eb.subq("max_over_time", lambda bb: bb.leaf(bb.words_leaf(
        words, nbits, slots, job_labels, b.n_dp, b.n_cap, 5 * MIN), "rate"), MIN, 30 * MIN)
    sub_p, sub_valid, steps_out, _, _ = eb.params[root.plan[5]]
    name, plan, inputs, want = _expr_query(
        "max_over_time(rate(m[5m])[30m:1m])", eb, root,
        front + ["query_rate", "subq_pack", "query_minmax"])
    (out, _, _), launches = _drive(plan, inputs, want, name)
    _tiled_rows(out, n, fc.n_unique, "subquery")
    inner, _, _ = qp.device_rate_pipeline(words, nbits, slots, sub_p, n_lanes=lanes_pad,
                                          n_cap=b.n_cap, range_nanos=5 * MIN, n_dp=b.n_dp,
                                          device=DEVICE)
    ir = inner[:fc.n_unique].cpu().numpy()
    n_in = int(sub_valid.sum())
    want_np = np.full((fc.n_unique, S), np.nan)
    for j in range(S):
        m = (sub_p[:n_in] >= steps_out[j] - 30 * MIN) & (sub_p[:n_in] <= steps_out[j])
        cells = ir[:, :n_in][:, m]
        has = (~np.isnan(cells)).any(axis=1)
        want_np[has, j] = np.nanmax(cells[has], axis=1)
    err = close(out[:fc.n_unique, :S].cpu(), torch.from_numpy(want_np), 0.0,
                "subquery vs numpy over device_rate_pipeline on the inner grid", 0.0)
    check(bool(np.isfinite(want_np).any()), "subquery: no finite cell")
    _time_expr("subquery", plan, inputs, launches, lanes_pad,
               f"tiled lanes equal, padding NaN; the 2,000 unique rows vs numpy's max over "
               f"device_rate_pipeline on the {n_in} inner steps: equal (max abs err {err})",
               results)
    shapes = {"subq": (inner, torch.from_numpy(sub_p), torch.from_numpy(sub_valid))}
    del out, inputs

    # quantile_over_time through the per-node entry point
    dwords, dnbits, dslots, dsteps, _ = qp._inputs(words, nbits, slots, b.steps, None, DEVICE)
    fn = lambda: qp.device_reduce_pipeline(  # noqa: E731
        dwords, dnbits, dslots, dsteps, n_lanes=n, n_cap=b.n_cap, range_nanos=5 * MIN,
        reducer="quantile_over_time", n_dp=b.n_dp, phi=0.9)
    _build.reset_launches()
    out, err_flags = fn()
    torch.cuda.synchronize()
    launches = dict(_build.LAUNCHES)
    for kernel in front + ["query_quantile_window"]:
        check(launches.get(kernel, 0) > 0, f"reduce pipeline: {kernel} not launched")
    check(not bool(err_flags.any()), "reduce pipeline: error flags")
    _tiled_rows(out, n, fc.n_unique, "reduce pipeline")
    err = close(out[oracle].cpu(), torch.from_numpy(_host_family(
        "quantile_over_time", t_h, v_h, b.steps, 5 * MIN, {"phi": 0.9})), 1e-9,
        "device_reduce_pipeline quantile_over_time vs the host tier", 1e-9)
    ms, wall = time_ms(fn, reps=7), wall_ms(fn)
    results["reduce_pipeline_quantile_over_time"] = {"launches": launches, "ms": ms,
                                                     "wall_ms": wall, "rows": n}
    log(f"expr reduce_pipeline_quantile_over_time: launches {launches}; {ms:.3f} ms device "
        f"(median of 7); {wall:.3f} ms with the result's .cpu(); tiled lanes equal, unique "
        f"rows vs the host tier: max abs err {err} (rtol 1e-9, atol 1e-9)")
    del out, dwords
    torch.cuda.synchronize()
    return shapes, results


def family_kernel_times(fc: corpus.FanoutCorpus, shapes: dict):
    """QK3's further ops, QK9-QK12 at the full-width plans' shapes: each
    kernel's time, its plain version's (held against it), its bound, and
    torch.sort (along the window for QK11, of the packing key for QK12)
    where no single call computes the function (none for the others)."""
    b = fc.batch
    rows = {}
    L = corpus.bucket_pow2(b.n_lanes, 64)
    steps = torch.from_numpy(corpus.ExprPlanBuilder(b.steps).steps).to(DEVICE)
    w, nb, sl, _, _ = qp._inputs(b.words, b.nbits, b.slots, b.steps, None, DEVICE)
    times, values, _ = qp._decode_merge(w, nb, sl, L, b.n_cap, b.n_dp, SEC)
    del w, nb, sl
    torch.cuda.empty_cache()
    N, S = times.shape[1], steps.shape[0]
    qt = query_temporal
    lane_bytes = L * N * 16 + S * 8 + L * S * 8
    levels = qt.search_levels(N)
    search_ms = L * S * 2 * levels * 4 / INT32_OPS_PER_S * 1e3

    def windowed(r):  # samples in the (lane, step) windows of range r
        _, left, right = qt.window_bounds_plain(times, steps, r)
        return int((right - left).clamp(min=0).sum())

    r = 15 * MIN
    fn = lambda: qt.changes_window(times, values, steps, r, False)  # noqa: E731
    _record("query_changes", same_bits(fn(), qt.changes_plain(times, values, steps, r, False),
                                       "main changes"))
    # the pair flags (4 operations a sample) and the bisections
    row("query_changes", rows, time_ms(fn, reps=7),
        time_ms(lambda: qt.changes_plain(times, values, steps, r, False), reps=3), lane_bytes,
        search_ms + L * N * 4 / INT32_OPS_PER_S * 1e3)

    fn = lambda: qt.linreg_window(times, values, steps, r, False)  # noqa: E731
    _record("query_linreg", close(fn(), qt.linreg_plain(times, values, steps, r)[0], 1e-9,
                                  "main deriv", linreg_atol(times, values, steps, r)))
    # ~10 FP64 operations a sample for the five sums, ~30 a (lane, step)
    row("query_linreg", rows, time_ms(fn, reps=7),
        time_ms(lambda: qt.linreg_plain(times, values, steps, r), reps=3), lane_bytes,
        search_ms + (L * N * 10 + L * S * 30) / FP64_OPS_PER_S * 1e3)

    r = 5 * MIN
    fn = lambda: qt.stdvar_window(times, values, steps, r, True)  # noqa: E731
    _record("query_stdvar", same_bits(fn(), qt.stdvar_plain(times, values, steps, r, True),
                                      "main stddev_over_time"))
    # two passes over each window: ~6 FP64 operations a windowed sample
    row("query_stdvar", rows, time_ms(fn, reps=7),
        time_ms(lambda: qt.stdvar_plain(times, values, steps, r, True), reps=3), lane_bytes,
        search_ms + windowed(r) * 6 / FP64_OPS_PER_S * 1e3)

    r = 60 * MIN
    fn = lambda: qt.holt_winters_window(times, values, steps, r, 0.3, 0.1)  # noqa: E731
    _record("query_holt_winters", same_bits(fn(), qt.holt_winters_plain(
        times, values, steps, r, 0.3, 0.1), "main holt_winters"))
    # the recurrence: ~9 FP64 operations a windowed sample
    row("query_holt_winters", rows, time_ms(fn, reps=5),
        time_ms(lambda: qt.holt_winters_plain(times, values, steps, r, 0.3, 0.1), reps=1),
        lane_bytes, search_ms + windowed(r) * 9 / FP64_OPS_PER_S * 1e3)

    r = 5 * MIN
    _, left, right = qt.window_bounds_plain(times, steps, r)
    width = int((right - left).max())
    idx = (left[:, :, None] + torch.arange(width, device=DEVICE)).clamp(max=N - 1)
    grid = torch.gather(values[:, None, :].expand(L, S, N), 2, idx)
    grid = torch.where(idx < right[:, :, None], grid, torch.inf)
    del idx, left, right
    torch.cuda.empty_cache()
    sort_ms = time_ms(lambda: torch.sort(grid, dim=2), reps=5)
    del grid
    # what the function needs: a selection of two order statistics, one
    # 64-bit compare (two INT32 operations) per windowed sample for each
    samples = windowed(r)
    # phi 0.99 takes the ranks near the window's end (the end buffers),
    # phi 0.5 the median (the comparator network)
    for phi, name in ((0.99, "query_quantile_window"),
                      (0.5, "query_quantile_window[phi 0.5]")):
        fn = lambda: qt.quantile_window(times, values, steps, r, phi)  # noqa: E731
        _record("query_quantile_window", same_bits(fn(), qt.quantile_window_plain(
            times, values, steps, r, phi), f"main quantile_over_time phi {phi}"))
        row(name, rows, time_ms(fn, reps=7),
            time_ms(lambda: qt.quantile_window_plain(times, values, steps, r, phi), reps=3),
            lane_bytes, search_ms + samples * 2 * 2 / INT32_OPS_PER_S * 1e3, sort_ms,
            f"torch.sort along the window grid [{L}, {S}, {width}]")
    torch.cuda.empty_cache()
    # 1h windows (~360 samples): the second launch's runs of up to 1,024
    # samples; no torch.sort of that window grid fits (~96 GB)
    r = 60 * MIN
    fn = lambda: qt.quantile_window(times, values, steps, r, 0.99)  # noqa: E731
    plain, plain_ms = time_once(lambda: qt.quantile_window_plain(times, values, steps, r, 0.99))
    _record("query_quantile_window", same_bits(fn(), plain, "main quantile_over_time[1h]"))
    del plain
    samples = windowed(r)
    row("query_quantile_window[1h]", rows, time_ms(fn, reps=3), plain_ms, lane_bytes,
        search_ms + samples * 2 * 2 / INT32_OPS_PER_S * 1e3)
    del times, values
    torch.cuda.empty_cache()

    inner, sub_p, sub_valid = shapes["subq"]
    rows_, Si = inner.shape
    fn = lambda: query_merge.subq_pack(inner, sub_p, sub_valid)  # noqa: E731
    for g, want in zip(fn(), query_merge.subq_pack_plain(inner, sub_p, sub_valid)):
        _record("subq_pack", same_bits(g, want, "main subquery pack"))
    tkey = torch.where(sub_valid.to(DEVICE)[None, :] & ~torch.isnan(inner),
                       sub_p.to(DEVICE)[None, :], query_merge.INT64_MAX)
    row("subq_pack", rows, time_ms(fn, reps=7),
        time_ms(lambda: query_merge.subq_pack_plain(inner, sub_p, sub_valid), reps=3),
        rows_ * Si * 8 + Si * 9 + rows_ * Si * 16, 0.0,
        time_ms(lambda: torch.sort(tkey, dim=1, stable=True), reps=7),
        "torch.sort(stable=True) of the packing key")
    del tkey
    torch.cuda.synchronize()
    return rows


# --- phase 10: Graphite rendering (QK4's graphite ops, GK2, GK3) -------------

GRAPHITE_STEP = 60 * SEC
GRAPHITE_QS = (-0.2, 0.0, 0.2, 0.5, 0.95, 1.0, 1.5)  # fractions for the column form
# (fraction, midpoint) of the column form: the percentiles, then the median
GRAPHITE_COLUMN_CASES = tuple((q, False) for q in GRAPHITE_QS) + ((0.5, True),)
# independent of order, or (multiply) in lane order on both sides
GRAPHITE_BIT_EXACT_OPS = ("count", "min", "max", "range", "last", "multiply")


def _graphite_probes():
    """(tag, values f64[L, S], groups, real_S, kernels): the CPU tests'
    probe matrix (NaN holes, +-Inf, +-0.0, all-NaN rows and columns,
    one-lane groups, 21 real steps of 64), 5,000 lanes in three groups, 5
    rows of 1,500 steps with 1,300 real (the row sort in global scratch past
    512), 300 lanes in groupByNode's layout, 70,000 lanes (GK2's column
    selection over many chunks and buckets) and 64 rows of 1,024 steps
    (GK3's staged tiles and window blocks).  `kernels`: those the probe
    drives (QK4 on all of them: multiplySeries over 14,000 and 70,000 lanes
    of values up to +-1,000 overflows and then meets a zero, and QK4 and its
    plain version both multiply in lane order)."""
    ALL = {"QK4", "GK2 columns", "GK2 rows", "GK3"}
    v, groups, _ = corpus.graphite_probe_matrix(real_S=21)
    yield "probes", v, groups, 21, ALL
    rng = np.random.default_rng(3)
    big = np.round(rng.uniform(-5, 5, (5000, 9)), 1)  # ties
    big[rng.random(big.shape) < 0.2] = np.nan
    big[:, 2] = np.where(rng.random(5000) < 0.5, -0.0, 0.0)
    big[7, 4], big[9, 4], big[:, 6] = np.inf, -np.inf, np.nan
    yield "5,000 lanes", big, rng.integers(0, 3, 5000), 7, ALL
    long = rng.uniform(-5, 5, (5, 1500))
    long[rng.random(long.shape) < 0.1] = np.nan
    long[1, ::7] = -0.0
    yield "long rows", long, np.asarray([0, 1, 1, 2, 0]), 1300, ALL
    # groupByNode's layout: one-lane groups, the padding lanes parked on
    # group 0 (QK4 launches the large group and the small ones apart)
    parked = np.round(rng.uniform(-5, 5, (300, 40)), 1)
    parked[rng.random(parked.shape) < 0.2] = np.nan
    parked[200:] = np.nan
    yield "parked padding", parked, np.where(np.arange(300) < 200, np.arange(300), 0), 33, ALL
    # GK2's selection past one chunk and across many buckets: 70,000 lanes
    # (274 chunks of 256), heavy ties, ranks inside runs of mixed +-0.0
    # (medians of columns 2 and 3), all-equal and all-NaN columns, +inf
    # mixed with NaN, and keys that tie on their first 56 bits (the median of
    # column 7 between two runs of 35,000 that differ in the last bit)
    wide = np.round(rng.uniform(-1000, 1000, (70_000, 8)), 0)
    wide[rng.random(wide.shape) < 0.1] = np.nan
    wide[:, 1] = 7.25
    wide[:, 2] = np.where(rng.random(70_000) < 0.5, -0.0, 0.0)
    wide[:20_000, 2] = -1.0
    wide[50_000:, 2] = 1.0
    wide[:, 3] = np.where(rng.random(70_000) < 0.3, np.nan, -0.0)
    wide[::5, 3] = 0.0
    wide[:, 4] = np.nan
    wide[:, 5] = np.where(rng.random(70_000) < 0.5, np.nan, np.inf)
    wide[:100, 5] = -2.0
    wide[:, 6] = 1.0 + rng.integers(0, 3, 70_000) * 2.0**-52
    wide[:, 7] = np.where(np.arange(70_000) < 35_000, 1.0, np.nextafter(1.0, 2.0))
    yield "70,000 lanes", wide, rng.integers(0, 5, 70_000), 8, {"QK4", "GK2 columns"}
    # GK3's tiles and window blocks: 64 rows of 1,024 steps, 901 real; NaN
    # holes, +-Inf entering and leaving windows, runs of -0.0, a constant row
    rows = np.round(rng.uniform(-50, 50, (64, 1024)), 2)
    rows[rng.random(rows.shape) < 0.15] = np.nan
    rows[1, rng.random(1024) < 0.02] = np.inf
    rows[1, rng.random(1024) < 0.02] = -np.inf
    rows[2, 300:340] = -0.0
    rows[3] = 4.0
    rows[4] = np.nan
    rows[5, 17::33] = 1e9
    yield "tiled rows", rows, np.arange(64) % 7, 901, {"QK4", "GK3"}


def compare_graphite_kernels():
    """GK2, GK3 and QK4's graphite ops against their plain versions on the
    card, twice: every op code, summarize func and percentile form, on the
    probes above, windows and buckets of 1, 3 and 7 steps and wider than
    the real steps (k not dividing them), gap limits 0, 2 and +inf,
    percentiles -20 to 150.  Bit for bit, but for QK4's sums, whose plain
    version on the card sums with atomics (rtol 1e-12; stddev 1e-9, as QK4's
    PromQL ops)."""
    g = graphite
    n = 0
    for tag, v, groups, real_S, kernels in _graphite_probes():
        x = torch.from_numpy(v).to(DEVICE)
        L, S = x.shape
        g_pad = corpus.bucket_pow2(int(groups.max()) + 1, 8)
        zeros = np.zeros(L, dtype=np.int64)
        for op in g.GROUP_OPS if "QK4" in kernels else ():
            grp, gp = (zeros, 8) if op in g.SINGLE_GROUP_OPS else (groups, g_pad)
            out = twice(lambda: g.grouped_reduce(x, grp, gp, op), f"graphite {tag} {op}")
            want = query_grouped.grouped_reduce_plain(x, torch.from_numpy(grp), gp, op,
                                                      g.GROUP_EMPTY.get(op, float("nan")))
            if op in GRAPHITE_BIT_EXACT_OPS:
                _record("query_grouped[graphite]", same_bits(out, want, f"graphite {tag} {op}"))
            else:  # the plain version's sums are index_add_'s atomics
                rtol = 1e-9 if op == "stddev" else 1e-12
                _record("query_grouped[graphite]", close(out, want, rtol, f"graphite {tag} {op}"))
            n += 1
        for qf, mid in GRAPHITE_COLUMN_CASES if "GK2 columns" in kernels else ():
            out = twice(lambda: g.percentile_columns(x, qf, mid), f"graphite {tag} column {qf}")
            _record("graphite_percentile", same_bits(out, g.percentile_columns_plain(x, qf, mid),
                                                     f"graphite {tag} column {qf} midpoint={mid}"))
            n += 1
        for fn in g.PERCENTILE_FNS if "GK2 rows" in kernels else ():
            for q in (-20.0, 0.0, 37.0, 90.0, 100.0, 150.0):
                out = twice(lambda: g.percentile_rows(x, q, real_S, fn), f"graphite {tag} {fn}")
                _record("graphite_percentile_rows", same_bits(
                    out, g.percentile_rows_plain(x, q, real_S, fn), f"graphite {tag} {fn} {q}"))
                n += 1
        for fn in g.ROW_FNS if "GK3" in kernels else ():
            ks = (1,) if fn in ("integral", "keepLastValue", "offsetToZero", "minMax") else (
                1, 3, 7, S + 5)
            if tag == "tiled rows" and len(ks) > 1:  # across a tile and GK3's window blocks
                ks = ((1, 5, 15, 16, 17, 31, 32, 33, 60, 400, S + 5) if fn.startswith("moving")
                      else (1, 15, 17, 33, S + 5))
            funcs = g.SUMMARIZE_FUNCS if fn == "summarize" else ("sum",)
            limits = (0.0, 2.0, float("inf")) if fn == "keepLastValue" else (float("inf"),)
            for k in ks:
                for func in funcs:
                    for lim in limits:
                        out = twice(lambda: g.row_transform(x, fn, real_S, k, func, lim),
                                    f"graphite {tag} {fn}")
                        _record("graphite_row", same_bits(
                            out, g.row_transform_plain(x, fn, real_S, k, func, lim),
                            f"graphite {tag} {fn} k={k} {func} limit={lim}"))
                        n += 1
    torch.cuda.synchronize()
    log(f"graphite parity QK4 graphite ops, GK2, GK3: {n} cases (every op code, summarize "
        "func and percentile form; NaN, +-Inf, +-0.0, all-NaN rows and columns, one-lane "
        "groups, real steps < padded steps, k not dividing them, windows wider than them, "
        "5,000- and 70,000-lane columns (ties, ranks in +-0.0 runs, all-equal, all-NaN, "
        "+inf with NaN), 1,300-step rows in global scratch, windows and buckets of 1-400 "
        "steps across 16-step tiles; QK4 on all of them, multiply overflowing): bit for bit "
        "(QK4's count/min/max/range/last/multiply, GK2, GK3; QK4's sum/avg/diff within rtol "
        "1e-12, stddev 1e-9), each kernel twice bit for bit")


def _np_moving_average(x: np.ndarray, w: int) -> np.ndarray:
    """movingAverage over w cells up to each column, NaN skipped; NaN where
    none is present."""
    m = ~np.isnan(x)
    xz = np.where(m, x, 0.0)
    sums, cnts = np.zeros_like(x), np.zeros_like(x)
    for d in range(w):
        sums[:, d:] += xz[:, :x.shape[1] - d]
        cnts[:, d:] += m[:, :x.shape[1] - d]
    with np.errstate(invalid="ignore"):
        return np.where(cnts == 0, np.nan, sums / np.maximum(cnts, 1))


def _np_keep_last(x: np.ndarray, limit: float) -> np.ndarray:
    out = x.copy()
    last_v = np.full(x.shape[0], np.nan)
    last_c = np.full(x.shape[0], -1)
    for c in range(x.shape[1]):
        m = ~np.isnan(x[:, c])
        last_v[m], last_c[m] = x[m, c], c
        fill = ~m & (last_c >= 0) & (c - last_c <= limit)
        out[fill, c] = last_v[fill]
    return out


def graphite_main(fc: corpus.FanoutCorpus):
    """BASELINE config 4's data as Graphite paths ``servers.host{i:05d}.
    cpu.load`` (50,000 series, 65,536 lanes padded, 355 steps padded to
    512) through device_expr_pipeline.  The leaf is last_over_time with the
    60s step as its range, under the path-depth gsel, as the reference
    lowers a fetch; the plans come from ExprPlanBuilder's graphite nodes.
    movingAverage(groupByNode(servers.*.cpu.load, 1, 'sum'), 5) (the
    reference bench's target, bench.py:3196) runs on the words-kind leaf;
    the rest on one arrays-kind leaf decoded once: sumSeries, stddevSeries,
    percentileOfSeries(.., 95), nPercentile(.., 95),
    summarize(integral(..), '5min', 'max') and keepLastValue(.., 3).  Each
    is driven once with the launch counts reset just before and read just
    after, checked against a numpy oracle over the host tier's fetch
    (ops/consolidate.py:step_consolidate, the last sample of each step, on
    the merged lanes) at rtol 1e-9 with NaN
    positions exact, per-lane results also tiled bit for bit, and timed."""
    b = fc.batch
    n, S, nu = b.n_lanes, len(b.steps), fc.n_unique
    reps = n // nu
    paths = [f"servers.host{i:05d}.cpu.load" for i in range(n)]
    labels = corpus.graphite_labels(paths)
    names = [{b"__name__": p.encode()} for p in paths]
    results = {}
    t0 = time.time()
    t_h, v_h = host_lanes(fc, range(nu))
    leaf_np = cons.step_consolidate(t_h, v_h, b.steps, GRAPHITE_STEP)
    log(f"graphite oracle leaf: the host tier's step consolidation on the {nu} unique lanes "
        f"({time.time() - t0:.1f} s)")
    s_pad = corpus.bucket_pow2(S, 64)
    padded = np.full((nu, s_pad), np.nan)
    padded[:, :S] = leaf_np  # the leaf after a call's normalization
    front = ["query_reduce"]

    def fetch(eb, lf):  # the fetch: the leaf under the depth filter (every path has 4 parts)
        return eb.gsel(eb.leaf(lf, "last_over_time"), range(n), names)

    # 1. the bench target on words-kind leaves
    eb = corpus.ExprPlanBuilder(b.steps)
    lf = eb.words_leaf(b.words, b.nbits, b.slots, labels, b.n_dp, b.n_cap, GRAPHITE_STEP)
    hosts = [{b"__name__": f"host{i:05d}".encode()} for i in range(n)]
    root = eb.gcall("movingAverage", eb.gagg("sum", fetch(eb, lf), np.arange(n), hosts), (5,))
    name, plan, inputs, want = _expr_query(
        "movingAverage(groupByNode(servers.*.cpu.load, 1, 'sum'), 5)", eb, root,
        ["decode_batched", "query_merge"] + front + ["query_grouped", "graphite_row"])
    (out, _, _), launches = _drive(plan, inputs, want, name)
    check(tuple(out.shape) == (corpus.bucket_pow2(n, 8), s_pad),
          f"{name}: shape {tuple(out.shape)}")
    _tiled_rows(out, n, nu, name)
    sums = np.where(np.isnan(padded), 0.0, padded)
    sums[:, S:] = np.nan  # the group sums' padding steps, normalized by the call
    err = close(out[:nu].cpu(), torch.from_numpy(_np_moving_average(sums, 5)), 1e-9,
                f"{name} vs numpy", 1e-9)
    _time_expr("graphite_moving_average_group_by_node", plan, inputs, launches, n,
               f"tiled rows bit for bit; the {nu} unique rows vs numpy over the host tier's "
               f"leaf: max abs err {err} (rtol 1e-9, atol 1e-9)", results)
    del out, inputs

    # the arrays-kind leaf, decoded once
    w, nb, sl, _, _ = qp._inputs(b.words, b.nbits, b.slots, b.steps, None, DEVICE)
    times, values, _ = qp._decode_merge(w, nb, sl, corpus.bucket_pow2(n, 64), b.n_cap,
                                        b.n_dp, SEC)
    del w, nb, sl
    torch.cuda.empty_cache()
    tiled = np.tile(leaf_np, (reps, 1))
    with np.errstate(invalid="ignore"):
        col_oracle = {"sum": np.nansum(tiled, axis=0), "stddev": np.nanstd(tiled, axis=0),
                      "percentile": np.nanpercentile(tiled, 95, axis=0)}
    integ = np.cumsum(np.where(np.isnan(padded), 0.0, padded), axis=1)
    summ = np.full((nu, s_pad), np.nan)
    for b0 in range(0, S, 5):
        summ[:, b0:b0 + 5] = integ[:, b0:b0 + 5].max(axis=1, keepdims=True)
    summ[:, S:] = np.nan
    npct = np.full((nu, s_pad), np.nan)
    npct[:, :S] = np.nanpercentile(leaf_np, 95, axis=1, keepdims=True)
    arrays_plans = (  # (name, build, its kernel, per-lane oracle or None, column op)
        ("sumSeries(servers.*.cpu.load)", lambda eb, x: eb.gagg(
            "sum", x, np.zeros(n, dtype=np.int64), [{}]), "query_grouped", None, "sum"),
        ("stddevSeries(servers.*.cpu.load)", lambda eb, x: eb.gagg(
            "stddev", x, np.zeros(n, dtype=np.int64), [{}]), "query_grouped", None, "stddev"),
        ("percentileOfSeries(servers.*.cpu.load, 95)", lambda eb, x: eb.gagg(
            "percentile", x, np.zeros(n, dtype=np.int64), [{}], (95.0,)),
         "graphite_percentile", None, "percentile"),
        ("nPercentile(servers.*.cpu.load, 95)", lambda eb, x: eb.gcall(
            "nPercentile", x, (95.0,)), "graphite_percentile_rows", npct, None),
        ("summarize(integral(servers.*.cpu.load), '5min', 'max')", lambda eb, x: eb.gcall(
            "summarize", eb.gcall("integral", x), (5, "max")), "graphite_row", summ, None),
        ("keepLastValue(servers.*.cpu.load, 3)", lambda eb, x: eb.gcall(
            "keepLastValue", x, (), (np.float64(3.0),)), "graphite_row",
         _np_keep_last(padded, 3.0), None),
    )
    shapes = {}
    for name, build, kernel, lane_oracle, col_op in arrays_plans:
        eb = corpus.ExprPlanBuilder(b.steps)
        root = build(eb, fetch(eb, eb.arrays_leaf(times, values, labels, GRAPHITE_STEP)))
        name, plan, inputs, want = _expr_query(name, eb, root, front + [kernel])
        (out, _, _), launches = _drive(plan, inputs, want, name)
        if lane_oracle is not None:
            _tiled_rows(out, n, nu, name)
            err = close(out[:nu].cpu(), torch.from_numpy(lane_oracle), 1e-9,
                        f"{name} vs numpy", 1e-9)
            what = (f"tiled rows bit for bit; the {nu} unique rows vs numpy over the host "
                    f"tier's leaf: max abs err {err} (rtol 1e-9, atol 1e-9)")
        else:
            check(tuple(out.shape) == (8, s_pad) and bool(torch.isnan(out[1:]).all()),
                  f"{name}: one row")
            err = close(out[0, :S].cpu(), torch.from_numpy(col_oracle[col_op]), 1e-9,
                        f"{name} vs numpy", 1e-9)
            np_fn = {"sum": "nansum", "stddev": "nanstd", "percentile": "nanpercentile"}[col_op]
            what = (f"row 0 vs numpy's {np_fn} over the {n} host-tier rows: max abs "
                    f"err {err} (rtol 1e-9, atol 1e-9)")
        check(bool(torch.isfinite(out[0, :S]).all()), f"{name}: non-finite real steps")
        _time_expr(name, plan, inputs, launches, int(out.shape[0]), what, results)
        del out, inputs
    # the leaf's values as the graphite nodes see them, for the kernel times
    shapes["x"] = qp._temporal_eval("last_over_time", times, values,
                                    torch.from_numpy(corpus.ExprPlanBuilder(b.steps).steps).to(
                                        DEVICE), GRAPHITE_STEP)
    shapes["x"][n:] = torch.nan
    shapes["real_S"] = S
    del times, values
    torch.cuda.synchronize()
    return shapes, results


def graphite_kernel_times(shapes: dict):
    """QK4, GK2 and GK3 at the full-width plans' shapes ([65,536, 512], 355
    real steps): each kernel's time, its plain version's (held against
    it), its bound, and one PyTorch call computing the same function where
    there is one.  QK4 at sumSeries' one group of every lane (sum and
    multiply) and at groupByNode's 50,000 one-lane groups (of 65,536, the padding lanes
    parked on group 0); GK3's integral, movingSum over 5 steps,
    keepLastValue and movingAverage at the dashboards' wide windows, 60
    steps (an hour at 60 s) and 400 (wider than the 355 real steps), each
    in a row of its own beside its PyTorch call."""
    g = graphite
    x, real_S = shapes["x"], shapes["real_S"]
    L, S = x.shape
    rows = {}
    cell_bytes = L * S * 8
    real_bytes = L * real_S * 8  # GK3 reads a lane's real steps and writes every step
    one = np.zeros(L, dtype=np.int64)
    index = query_grouped.group_index(one, 8, DEVICE)
    fn = lambda: g.grouped_reduce(x, one, 8, "sum", index=index)  # noqa: E731
    one_t = torch.from_numpy(one)
    plain = lambda: query_grouped.grouped_reduce_plain(x, one_t, 8, "sum", 0.0)  # noqa: E731
    _record("query_grouped[graphite]", close(fn(), plain(), 1e-12, "main sumSeries"))
    row("query_grouped[graphite]", rows, time_ms(fn, reps=7), time_ms(plain, reps=3),
        cell_bytes + L * 8 + 8 * S * 8, L * S / FP64_OPS_PER_S * 1e3,
        time_ms(lambda: torch.nansum(x, dim=0), reps=7), "torch.nansum along the lanes")
    # multiplySeries over the same group: the product in lane order (QK4's
    # product_kernel past one chunk); the plain version's loop over the
    # 65,536 lanes runs once, timed and checked
    fn = lambda: g.grouped_reduce(x, one, 8, "multiply", index=index)  # noqa: E731
    want, plain_ms = time_once(
        lambda: query_grouped.grouped_reduce_plain(x, one_t, 8, "multiply", 1.0))
    _record("query_grouped[graphite]", same_bits(fn(), want, "main multiplySeries"))
    x1 = torch.nan_to_num(x, nan=1.0)
    row("query_grouped[multiply]", rows, time_ms(fn, reps=7), plain_ms,
        cell_bytes + L * 8 + 8 * S * 8, L * S / FP64_OPS_PER_S * 1e3,
        time_ms(lambda: torch.prod(x1, dim=0), reps=7),
        "torch.prod along the lanes (of nan_to_num(x, 1.0) computed ahead; its own order)")
    del want, x1
    n = int((~torch.isnan(x).all(dim=1)).nonzero().max()) + 1  # the real lanes
    ids = np.where(np.arange(L) < n, np.arange(L), 0)  # padding parked on group 0
    index = query_grouped.group_index(ids, L, DEVICE)
    fn = lambda: g.grouped_reduce(x, ids, L, "sum", index=index)  # noqa: E731
    plain = lambda: query_grouped.grouped_reduce_plain(  # noqa: E731
        x, torch.from_numpy(ids), L, "sum", 0.0)
    _record("query_grouped[graphite]", same_bits(fn(), plain(), "main groupByNode sum"))
    log(f"groupByNode: {n} one-lane groups of {L}, the padding lanes on group 0")
    ids_t = torch.from_numpy(ids).to(DEVICE)
    vz = torch.nan_to_num(x, nan=0.0)
    row("query_grouped[groupByNode]", rows, time_ms(fn, reps=7), time_ms(plain, reps=3),
        2 * cell_bytes + L * 16, L * S / FP64_OPS_PER_S * 1e3,
        time_ms(lambda: torch.zeros((L, S), dtype=torch.float64, device=DEVICE).index_add_(
            0, ids_t, vz), reps=7), "index_add_ (of nan_to_num(x) computed ahead)")
    del vz

    qf = g.percentile_fraction(95.0)
    fn = lambda: g.percentile_columns(x, qf)  # noqa: E731
    plain = lambda: g.percentile_columns_plain(x, qf)  # noqa: E731
    _record("graphite_percentile", same_bits(fn(), plain(), "main percentileOfSeries"))
    # a selection of two order statistics per step: one 64-bit compare (two
    # INT32 operations) per lane for each
    row("graphite_percentile", rows, time_ms(fn, reps=5), time_ms(plain, reps=3),
        cell_bytes + S * 8, L * S * 2 * 2 / INT32_OPS_PER_S * 1e3,
        time_ms(lambda: torch.nanquantile(x, qf, dim=0, interpolation="linear"), reps=5),
        'torch.nanquantile(dim=0, interpolation="linear")')
    xr = x[:, :real_S]
    fn = lambda: g.percentile_rows(x, 95.0, real_S, "nPercentile")  # noqa: E731
    plain = lambda: g.percentile_rows_plain(x, 95.0, real_S, "nPercentile")  # noqa: E731
    _record("graphite_percentile_rows", same_bits(fn(), plain(), "main nPercentile"))
    row("graphite_percentile_rows", rows, time_ms(fn, reps=7), time_ms(plain, reps=3),
        L * real_S * 8 + cell_bytes, L * real_S * 2 * 2 / INT32_OPS_PER_S * 1e3,
        time_ms(lambda: torch.nanquantile(xr, qf, dim=1, interpolation="linear"), reps=5),
        'torch.nanquantile(dim=1, interpolation="linear") over the real steps')

    # GK3: each form beside its PyTorch call; the bound is the bytes (each
    # real cell read once, each cell written once)
    gk3_bytes = real_bytes + cell_bytes
    gk3 = (("integral", 1, lambda: torch.cumsum(x, dim=1), "torch.cumsum along the steps"),
           ("movingSum", 5, lambda: x.unfold(1, 5, 1).sum(dim=2), "unfold(1, 5, 1).sum"),
           ("keepLastValue", 1, lambda: torch.cummax(x, dim=1), "torch.cummax along the steps"),
           ("movingAverage", 60, lambda: x.unfold(1, 60, 1).mean(dim=2),
            "unfold(1, 60, 1).mean"),
           ("movingAverage", 400, lambda: x.unfold(1, 400, 1).mean(dim=2),
            "unfold(1, 400, 1).mean"))
    for fn_name, k, lib, lib_name in gk3:
        fn = lambda: g.row_transform(x, fn_name, real_S, k, limit=3.0)  # noqa: E731
        got = fn()
        want, plain_ms = time_once(lambda: g.row_transform_plain(x, fn_name, real_S, k,
                                                                 limit=3.0))
        _record("graphite_row", same_bits(got, want, f"main {fn_name} k={k}"))
        del got, want
        name = "graphite_row" + (f"[{fn_name}, w={k}]" if fn_name.startswith("moving") else
                                 ("" if fn_name == "integral" else f"[{fn_name}]"))
        row(name, rows, time_ms(fn, reps=7), plain_ms, gk3_bytes, L * S / FP64_OPS_PER_S * 1e3,
            time_ms(lib, reps=7), lib_name)
    w60 = rows["graphite_row[movingAverage, w=60]"]
    w400 = rows["graphite_row[movingAverage, w=400]"]
    log(f"graphite_row movingAverage w=400 / w=60: {w400['ms'] / w60['ms']:.3f} "
        "(the block-wise windows' cost does not grow with w)")
    torch.cuda.synchronize()
    return rows

# --- phase 7: the write side's kernels vs their plain versions -------------

ENC_SERIES = 250_000  # the reference's bench_encode shape (bench.py:323, side_leg_specs)
ROLLUP_LANES = 1_000_000  # bench.py:652 bench_rollup_flush at its side-leg size
ROLLUP_WARMUP, ROLLUP_ROUNDS = 2, 12
ROLLUP_SAMPLE = 10_000  # lanes also run through the plain ElemPool on the card
ROLLUP_SLO_MS = 1000.0  # the reference's p99 flush SLO (bench.py:692), printed, not a gate
TIMER_WINDOWS, TIMER_PER_WINDOW = 100_000, 10
TIMER_HOT = (64, 4096)  # hot windows x points (2 x the default timer_summary_size)
TIMER_QS = (0.5, 0.9, 0.95, 0.99, 0.999)
CONFIG2_SERIES, CONFIG2_CPU_SERIES = 100_000, 5_000
CONFIG2_WINDOWS, CONFIG2_BATCHES = 5, 6
SEAL_LANES = 10_000
# INT32 operations csrc/m3tsz_encode.cu spends per step, counted from the
# code (the unit division left out): in 64 bits the delta-of-delta (2), its
# bucket (8) and three fields of ~6 each (align, shift, two halves, spill):
# 28, two INT32 each; in 32 bits the width scan (10), the offsets (3), the
# three atomicOr and a store: 17.
ENC_INT32_OPS_PER_STEP = 2 * 28 + 17


def _encode_args(ts, vs, start, n_valid):
    """pack_encode's arguments on the card, the value fields from the
    native value grammar (as encode_batched computes them)."""
    cb, cn, pb, pn = native.prepare_value_fields_native(vs, n_valid)
    host = (ts, start, n_valid, cb.view(np.int64), cn, pb.view(np.int64), pn)
    return tuple(torch.from_numpy(np.ascontiguousarray(x)).to(DEVICE) for x in host)


def _words_bits(words: torch.Tensor) -> torch.Tensor:
    return words.view(torch.int32)


def compare_encode(series, tag: str):
    """E1 against its plain version on one batch, twice; every lane's
    stream against the scalar encoder's."""
    args = _encode_args(*corpus.encode_batch(series))
    k = twice(lambda: tuple(enc.pack_encode(*args)), f"{tag} pack_encode")
    p = enc.pack_encode_plain(*args)
    _record("pack_encode", same_bits(_words_bits(k[0]), _words_bits(p[0]),
                                     f"{tag} pack_encode words"))
    same_bits(k[1], p[1], f"{tag} pack_encode nbits")
    words, nbits = k[0].cpu().numpy(), k[1].cpu().numpy()
    for lane, (t, v, st) in enumerate(series):
        want = m3tsz_scalar.encode_series(t, v, st) if t else b""
        got = unpack_stream(words[lane], ((int(nbits[lane]) + 7) // 8) * 8)
        check(got == want, f"{tag} lane {lane}: E1's stream differs from the scalar encoder's")
    torch.cuda.synchronize()
    log(f"write parity encode {tag}: {len(series)} lanes x {k[0].shape[1]} words: E1 bit for bit "
        f"with its plain version and twice, every stream byte for byte with the scalar encoder")


def compare_pack_edges():
    """E1 against its plain version, twice, on ``corpus.pack_edge_fields``
    at 1, 31, 32, 33 and 65 steps (around its 32-step chunks): lanes of 0,
    1 and all valid points, every time-field bucket edge, payloads of up to
    64 bits with bits set above each width."""
    for T in corpus.PACK_EDGE_STEPS:
        args = tuple(torch.from_numpy(x).to(DEVICE) for x in corpus.pack_edge_fields(T))
        k = twice(lambda: tuple(enc.pack_encode(*args)), f"pack_encode edges T={T}")
        p = enc.pack_encode_plain(*args)
        _record("pack_encode", same_bits(_words_bits(k[0]), _words_bits(p[0]),
                                         f"pack_encode edges T={T} words"))
        same_bits(k[1], p[1], f"pack_encode edges T={T} nbits")
    log(f"write parity encode edges: T = {', '.join(map(str, corpus.PACK_EDGE_STEPS))}: E1 "
        f"bit for bit with its plain version and twice")


def compare_elems(batches, tag: str, n_slots: int = 64):
    """A1a and A1b against their plain versions on a run of ingest batches
    (each kernel also re-run from the same state for the same bits)."""
    st_k = elems.init_state(n_slots // 8, 8, DEVICE)
    st_p = elems.ElemState(*(x.clone() for x in st_k))
    rng = np.random.default_rng(17)
    dropped = 0
    for b, host in enumerate(batches):
        batch = [torch.from_numpy(x).to(DEVICE) for x in host]
        again = elems.ElemState(*(x.clone() for x in st_k))
        dk = elems.scatter_update(st_k, *batch)
        d2 = elems.scatter_update(again, *batch)
        dp = elems.scatter_update_plain(st_p, *batch)
        check(int(dk) == int(dp) == int(d2), f"{tag} batch {b}: stale counts {int(dk)}, "
              f"{int(d2)}, plain {int(dp)}")
        dropped += int(dk)
        for name, x, y, z in zip(elems.ElemState._fields, st_k, again, st_p):
            same_bits(x, y, f"{tag} batch {b} scatter_update.{name}: second run")
            _record("scatter_update", same_bits(x, z, f"{tag} batch {b} scatter_update.{name}"))
        flats = torch.from_numpy(np.sort(rng.choice(n_slots, 20, replace=False))).to(DEVICE)
        again = elems.ElemState(*(x.clone() for x in st_k))
        ok = elems.gather_reset(st_k, flats)
        o2 = elems.gather_reset(again, flats)
        op = elems.gather_reset_plain(st_p, flats)
        for name, x, y, z in zip(elems.ElemState._fields, ok, o2, op):
            same_bits(x, y, f"{tag} batch {b} gather_reset.{name}: second run")
            _record("gather_reset", same_bits(x, z, f"{tag} batch {b} gather_reset.{name}"))
        for name, x, z in zip(elems.ElemState._fields, st_k, st_p):
            _record("gather_reset", same_bits(x, z, f"{tag} batch {b} reset state.{name}"))
    check(dropped > 0, f"{tag}: no stale sample was dropped")
    torch.cuda.synchronize()
    log(f"write parity slots {tag}: {len(batches)} batches of {len(batches[0][0])} samples over "
        f"{n_slots} slots ({dropped} stale): A1a and A1b bit for bit with their plain versions "
        f"and twice")


def compare_padded_quantiles():
    """A1c against its plain version, twice: the probe matrices, rows at
    each tier edge (``corpus.quantile_tier_probes``) and long rows of every
    tier."""
    cases = corpus.quantile_probes() + corpus.quantile_tier_probes() + [
        corpus.long_quantile_rows(*TIMER_HOT), corpus.long_quantile_rows(3, 5000),
        corpus.long_quantile_rows(1, 65536)]
    qs = TIMER_QS + (0.0, 1.0)
    for v, w in cases:
        F, K = v.shape
        tv, tw = torch.from_numpy(v).to(DEVICE), torch.from_numpy(w).to(DEVICE)
        k = twice(lambda: elems.padded_quantiles(tv, tw, qs), f"padded_quantiles {F}x{K}")
        _record("padded_quantiles", same_bits(k, elems.padded_quantiles_plain(tv, tw, qs),
                                              f"padded_quantiles {F}x{K}"))
        P = 1 << (K - 1).bit_length()
        tier = ("a warp's registers" if K <= elems.WARP_K else
                "shared memory" if P <= elems.SMEM_MAX_P else "global scratch")
        log(f"write parity quantiles {F}x{K}: sorted in {tier}, A1c bit for bit with its plain "
            f"version and twice")


# --- phase 8: the rollup flush at full size (BASELINE configs 2-3) ----------


@contextlib.contextmanager
def plain_elem_kernels():
    """ElemPool with the slot kernels' plain versions (on whatever device
    its state lies): the yardstick of the rollup check.  Clears the launch
    counts and fails if a kernel was launched inside."""
    saved = elems.scatter_update, elems.gather_reset, elems.padded_quantiles
    elems.scatter_update, elems.gather_reset, elems.padded_quantiles = (
        elems.scatter_update_plain, elems.gather_reset_plain, elems.padded_quantiles_plain)
    _build.reset_launches()
    try:
        yield
    finally:
        elems.scatter_update, elems.gather_reset, elems.padded_quantiles = saved
    check(not _build.LAUNCHES, f"the plain pool launched kernels: {dict(_build.LAUNCHES)}")


def _check_single_sample_windows(fw, vals, t, n, what):
    check(fw is not None and fw.lanes.size == n, f"{what}: {n} windows expected")
    check(np.array_equal(fw.lanes, np.arange(n)) and bool((fw.starts == t).all()),
          f"{what}: lanes/starts")
    check(bool((fw.count == 1).all()), f"{what}: counts")
    for name in ("sum", "min", "max", "last"):
        check(np.array_equal(getattr(fw, name).view(np.int64), vals.view(np.int64)),
              f"{what}: {name} != the sample")
    check(np.array_equal(fw.sum_sq.view(np.int64), (vals * vals).view(np.int64)),
          f"{what}: sum_sq != value^2")


def rollup_main():
    """bench.py:652 bench_rollup_flush on the card: ElemPool(10s,
    capacity=1M, windows=8), one sample per lane per window at t + 5s,
    2 warm-up rounds, then 12 rounds of update + flush_before."""
    n, res = ROLLUP_LANES, 10 * SEC
    t0 = time.time()
    pool = ElemPool(res, capacity=n, windows=8, device=DEVICE)
    for _ in range(n):
        pool.alloc_lane()
    with plain_elem_kernels():
        ref = ElemPool(res, capacity=ROLLUP_SAMPLE, windows=8, device=DEVICE)
        for _ in range(ROLLUP_SAMPLE):
            ref.alloc_lane()
    lanes = np.arange(n, dtype=np.int64)
    rounds = corpus.rollup_rounds(n, ROLLUP_WARMUP + ROLLUP_ROUNDS)
    log(f"rollup data: {n} lanes x 8 windows ({8 * n} slots, 8 x {8 * n * 8} B of state), "
        f"{len(rounds)} rounds of seed-42 values; set up in {time.time() - t0:.1f} s")
    t = corpus.START
    upd, lat, windows, launches = [], [], 0, {}
    for i, vals in enumerate(rounds):
        times = np.full(n, t + 5 * SEC, dtype=np.int64)
        _build.reset_launches()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        pool.update(lanes, times, vals)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        fw = pool.flush_before(t + res)
        t3 = time.perf_counter()
        got = dict(_build.LAUNCHES)
        for kernel in ("scatter_update", "gather_reset"):
            check(got.get(kernel, 0) > 0, f"rollup round {i}: {kernel} not launched")
        _check_single_sample_windows(fw, vals, t, n, f"rollup round {i}")
        with plain_elem_kernels():
            ref.update(lanes[:ROLLUP_SAMPLE], times[:ROLLUP_SAMPLE], vals[:ROLLUP_SAMPLE])
            fr = ref.flush_before(t + res)
        for name, x, y in zip(fw._fields, fw, fr):
            check(np.array_equal(np.asarray(x[:ROLLUP_SAMPLE]).view(np.int64),
                                 np.asarray(y).view(np.int64)),
                  f"rollup round {i}: {name} of the first {ROLLUP_SAMPLE} lanes vs the plain pool")
        if i >= ROLLUP_WARMUP:
            upd.append((t2 - t1) * 1e3)
            lat.append((t3 - t2) * 1e3)
            windows += fw.lanes.size
            for kernel, c in got.items():
                launches[kernel] = launches.get(kernel, 0) + c
        t += res
    lat_a = np.asarray(lat)
    res_ = {"update_ms_p50": float(np.median(upd)), "flush_ms_p50": float(np.quantile(lat_a, 0.5)),
            "flush_ms_p99": float(np.quantile(lat_a, 0.99)),
            "windows_per_s": windows / (lat_a.sum() / 1e3), "launches": launches}
    log(f"rollup main: {ROLLUP_ROUNDS} rounds of {n} lanes; launches {launches}; update "
        f"{res_['update_ms_p50']:.3f} ms (median); flush p50 {res_['flush_ms_p50']:.3f} ms, p99 "
        f"{res_['flush_ms_p99']:.3f} ms (host clock, as bench.py; the reference's SLO is p99 <= "
        f"{ROLLUP_SLO_MS:.0f} ms, not a gate here); {res_['windows_per_s']:.0f} windows/s; every "
        f"window has its sample's moments, the first {ROLLUP_SAMPLE} lanes equal the plain pool's")
    res_["stages_ms"] = flush_stages(pool, lanes, rounds[-1], t)
    t += res
    res_["device"] = profile_round(pool, lanes, rounds[-1], t)
    t += res
    flat = torch.from_numpy(pool._flat(lanes, np.full(n, t, dtype=np.int64))).to(DEVICE)
    batch = (flat, torch.full((n,), t, dtype=torch.int64, device=DEVICE),
             torch.full((n,), t + 5 * SEC, dtype=torch.int64, device=DEVICE),
             torch.from_numpy(rounds[-1]).to(DEVICE))
    return pool, batch, res_


def flush_stages(pool, lanes, vals, t):
    """One more round with ElemPool.flush_before's steps timed one by one
    (host clock, each ending in a sync): where the flush latency goes."""
    pool.update(lanes, np.full(lanes.size, t + 5 * SEC, dtype=np.int64), vals)
    torch.cuda.synchronize()
    stages = {}
    t0 = time.perf_counter()
    ws = pool._state.win_start.cpu().numpy()
    stages[f"win_start to host ({ws.nbytes} B)"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    flats = np.nonzero((ws != elems.EMPTY) & (ws + pool.resolution <= t + pool.resolution))[0]
    flats = flats[np.argsort(ws[flats], kind="stable")]
    stages["nonzero + stable argsort"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out = elems.gather_reset(pool._state, torch.from_numpy(flats).to(DEVICE))
    torch.cuda.synchronize()
    stages["flats to card + gather_reset"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out = elems.ElemState(*(x.cpu().numpy() for x in out))
    stages["8 fields to host"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    np.where(np.isinf(out.min), np.nan, out.min), np.where(np.isinf(out.max), np.nan, out.max)
    stages["NaN fill of min/max"] = time.perf_counter() - t0
    _check_single_sample_windows(elems.FlushedWindows(flats // pool.windows, *out[:6], out.last),
                                 vals, t, lanes.size, "staged flush")
    ms = {k: v * 1e3 for k, v in stages.items()}
    log("rollup flush stages (host clock, ms): " + ", ".join(f"{k} {v:.3f}" for k, v in ms.items())
        + f"; total {sum(ms.values()):.3f}")
    return ms


def profile_round(pool, lanes, vals, t):
    """One update + flush round under torch.profiler: the device's kernel
    and copy time against the round's wall time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    times = np.full(lanes.size, t + 5 * SEC, dtype=np.int64)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        pool.update(lanes, times, vals)
        pool.flush_before(t + pool.resolution)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    kernel_us = copy_us = 0.0
    for ev in prof.key_averages():
        if ev.device_type != DeviceType.CUDA:  # a host op: its kernels are counted on their own
            continue
        dev_us = ev.self_device_time_total
        if ev.key.startswith(("Memcpy", "Memset")):
            copy_us += dev_us
        else:
            kernel_us += dev_us
    res = {"wall_ms": wall, "kernel_ms": kernel_us / 1e3, "copy_ms": copy_us / 1e3}
    if kernel_us + copy_us == 0:
        log(f"rollup round under torch.profiler: {wall:.3f} ms wall; the profiler saw no device "
            f"activity, so the device's busy share is not measured")
    else:
        res["busy_share"] = (kernel_us + copy_us) / 1e3 / wall
        log(f"rollup round under torch.profiler: {wall:.3f} ms wall (profiled), device kernels "
            f"{res['kernel_ms']:.3f} ms, copies {res['copy_ms']:.3f} ms: the device is busy "
            f"{100 * res['busy_share']:.1f}% of the round (kernels "
            f"{100 * res['kernel_ms'] / wall:.2f}%)")
    return res


def slot_kernel_times(pool, batch, rows):
    """A1a (and its grouping glue) and A1b at the rollup's shapes: 1M
    samples into 1M of 8M slots, and a flush of those 1M slots."""
    state = pool._state
    n = batch[0].numel()
    a = elems.ElemState(*(x.clone() for x in state))
    b = elems.ElemState(*(x.clone() for x in state))
    dk = elems.scatter_update(a, *batch)
    dp = elems.scatter_update_plain(b, *batch)
    check(int(dk) == int(dp), "full-size scatter_update stale counts")
    for name, x, y in zip(elems.ElemState._fields, a, b):
        _record("scatter_update", same_bits(x, y, f"full-size scatter_update.{name}"))
    order, slots, offsets = elems.group_by_slot(batch[0])
    dropped = torch.zeros((), dtype=torch.int64, device=DEVICE)
    glue_ms = time_ms(lambda: elems.group_by_slot(batch[0]), reps=7)
    ms = time_ms(lambda: elems._scatter_kernel(a, order, slots, offsets, *batch[1:], dropped),
                 reps=7)
    plain_ms = time_ms(lambda: elems.scatter_update_plain(b, *batch), reps=3)
    S = slots.numel()
    # the function's batch is 32 B a sample (the kernel reads the order in
    # flat's place); the touched slots' eight fields are read and written once
    row("scatter_update", rows, ms, plain_ms, n * 32 + S * 8 * 8 * 2,
        n * 20 / FP64_OPS_PER_S * 1e3)
    log(f"time scatter_update grouping glue (stable torch.sort + unique_consecutive + cumsum, "
        f"{n} samples): {glue_ms:.3f} ms")

    flats = slots
    # the timing runs above added into a and b unequally: flush equal copies
    b = elems.ElemState(*(x.clone() for x in a))
    ok = elems.gather_reset(a, flats)
    op = elems.gather_reset_plain(b, flats)
    for name, x, y in zip(elems.ElemState._fields, ok, op):
        _record("gather_reset", same_bits(x, y, f"full-size gather_reset.{name}"))
    for name, x, y in zip(elems.ElemState._fields, a, b):
        _record("gather_reset", same_bits(x, y, f"full-size reset state.{name}"))
    F = flats.numel()
    row("gather_reset", rows, time_ms(lambda: elems.gather_reset(a, flats), reps=7),
        time_ms(lambda: elems.gather_reset_plain(b, flats), reps=3), F * 8 + F * 8 * 8 * 3, 0.0)
    del a, b, ok, op
    torch.cuda.empty_cache()


# --- phase 9: timer quantiles through the pool ------------------------------


def _select_ops_ms(F: int, K: int, n_q: int) -> float:
    """A1c's operations as the function needs them, not the kernel's sort
    network: a linear weighted selection per quantile, one 64-bit compare
    (two INT32 operations) per sample and quantile, and the weights'
    running sum and the target compares in FP64."""
    return (F * K * 2 * n_q / INT32_OPS_PER_S + F * K * (1 + n_q) / FP64_OPS_PER_S) * 1e3


def timer_main(rows):
    """ElemPool.timer_quantiles on 100,000 windows x 10 samples and on 64
    hot windows of 4,096 points; A1c's row of the table at the first."""
    results = {}
    for tag, (n_win, per) in (("timer", (TIMER_WINDOWS, TIMER_PER_WINDOW)), ("hot", TIMER_HOT)):
        lanes, times, values = corpus.timer_windows(n_win, per)
        pool = ElemPool(10 * SEC, capacity=n_win, windows=8, device=DEVICE)
        for _ in range(n_win):
            pool.alloc_lane()
        pool.update(lanes, times, values, timer_mask=np.ones(lanes.size, dtype=bool))
        fw = pool.flush_before(corpus.START + 10 * SEC)
        saved = list(pool._timer_chunks), pool._timer_rows, pool._compact_at
        _build.reset_launches()
        t0 = time.perf_counter()
        q = pool.timer_quantiles(fw, TIMER_QS)
        wall = (time.perf_counter() - t0) * 1e3
        launches = dict(_build.LAUNCHES)
        check(launches.get("padded_quantiles", 0) > 0, f"{tag}: padded_quantiles not launched")
        pool._timer_chunks, pool._timer_rows, pool._compact_at = saved
        v, w = pool.timer_padded(fw)
        check(v.shape == (n_win, per), f"{tag}: padded shape {v.shape}")
        tv, tw = torch.from_numpy(v).to(DEVICE), torch.from_numpy(w).to(DEVICE)
        k = elems.padded_quantiles(tv, tw, TIMER_QS)
        _record("padded_quantiles", same_bits(k, elems.padded_quantiles_plain(tv, tw, TIMER_QS),
                                              f"{tag} padded_quantiles"))
        same_bits(torch.from_numpy(q), k.cpu(), f"{tag}: timer_quantiles vs the kernel")
        # unit weights: the nearest rank ceil(q*n) of each window, from numpy
        srt = np.sort(values.reshape(n_win, per), axis=1)
        for j, qq in enumerate(TIMER_QS):
            r = min(max(int(np.ceil(qq * per)), 1), per) - 1
            check(np.array_equal(q[:, j], srt[:, r]), f"{tag}: q={qq} vs the sorted windows")
        results[tag] = {"launches": launches, "wall_ms": wall}
        log(f"timer {tag}: {n_win} windows x {per} samples; launches {launches}; "
            f"timer_quantiles {wall:.3f} ms (host clock, padding included); nearest ranks "
            f"match the sorted windows")
        library_ms = time_ms(lambda: (lambda o: (torch.gather(tv, 1, o), torch.cumsum(
            torch.gather(tw, 1, o), dim=1)))(torch.sort(tv, dim=1, stable=True).indices),
            reps=7)
        kernel = lambda: elems.padded_quantiles(tv, tw, TIMER_QS)  # noqa: E731
        if tag == "timer":
            row("padded_quantiles", rows, time_ms(kernel, reps=7),
                time_ms(lambda: elems.padded_quantiles_plain(tv, tw, TIMER_QS), reps=5),
                n_win * per * 16 + n_win * len(TIMER_QS) * 8,
                _select_ops_ms(n_win, per, len(TIMER_QS)), library_ms,
                "torch.sort(stable) + cumsum + gather")
            _split_line(f"padded_quantiles[{n_win}x{per}]", rows["padded_quantiles"]["ms"], kernel)
        else:
            ms = time_ms(kernel, reps=7)
            bytes_ms = (n_win * per * 16 + n_win * len(TIMER_QS) * 8) / HBM_BYTES_PER_S * 1e3
            ops_ms = _select_ops_ms(n_win, per, len(TIMER_QS))
            log(f"time padded_quantiles[{n_win}x{per}]: kernel {ms:.3f} ms, bound "
                f"{max(bytes_ms, ops_ms):.3f} ms (bytes {bytes_ms:.3f} ms, operations "
                f"{ops_ms:.3f} ms), torch.sort(stable) + cumsum + gather {library_ms:.3f} ms")
            _split_line(f"padded_quantiles[{n_win}x{per}]", ms, kernel)
        del pool, tv, tw, k
    return results


# --- phase 10: the aggregator through its entry point (BASELINE config 2) ---


def _config2_metas():
    def staged(t):
        return (metrics.StagedMetadata(0, (metrics.PipelineMetadata(
            aggregation_id=metrics.AggregationID((t,)),
            storage_policies=(metrics.StoragePolicy.parse("1m:40d"),)),)),)
    return {1: staged(ds.AggregationType.SUM), 3: staged(ds.AggregationType.MEAN)}


def aggregator_main():
    """100,000 series (50,000 counters: SUM, 50,000 gauges: MEAN) at
    1m:40d, six 10s batches per window, flush_before each minute, 5
    windows; the first 5,000 series also through the plain versions on
    the CPU, bit for bit; every window's values against numpy."""
    n, metas = CONFIG2_SERIES, _config2_metas()
    agg = Aggregator(device=DEVICE)
    cpu = Aggregator(device="cpu")
    _build.reset_launches()
    add_ms, flush_ms = [], []
    for w in range(CONFIG2_WINDOWS):
        acc = np.zeros(n)
        for b in range(CONFIG2_BATCHES):
            kinds, ids, values, t = corpus.config2_batch(n, w, b)
            entries = [(k, i, v, t, metas[k]) for k, i, v in zip(kinds.tolist(), ids,
                                                                   values.tolist())]
            acc = acc + values
            t0 = time.perf_counter()
            agg.add_untimed_batch(entries)
            torch.cuda.synchronize()
            add_ms.append((time.perf_counter() - t0) * 1e3)
            cpu.add_untimed_batch(entries[:CONFIG2_CPU_SERIES])
        cutoff = corpus.CONFIG2_START + (w + 1) * 60 * SEC
        t0 = time.perf_counter()
        out = agg.flush_before(cutoff)
        flush_ms.append((time.perf_counter() - t0) * 1e3)
        cout = cpu.flush_before(cutoff)
        check(len(out) == n, f"config 2 window {w}: {len(out)} metrics, {n} expected")
        check(len(cout) == CONFIG2_CPU_SERIES, f"config 2 window {w}: CPU run size")
        for j, (m, c) in enumerate(zip(out, cout)):
            check((m.id, m.time_nanos, m.agg_type) == (c.id, c.time_nanos, c.agg_type)
                  and np.float64(m.value).view(np.int64) == np.float64(c.value).view(np.int64),
                  f"config 2 window {w} metric {j}: card {m} != CPU {c}")
        got = np.asarray([m.value for m in out])
        want = np.where(kinds == 1, acc, acc / CONFIG2_BATCHES)
        check(np.array_equal(got.view(np.int64), want.view(np.int64)),
              f"config 2 window {w}: SUM/MEAN vs numpy")
        check(all(m.time_nanos == cutoff for m in out), f"config 2 window {w}: timestamps")
    launches = dict(_build.LAUNCHES)
    for kernel in ("scatter_update", "gather_reset"):
        check(launches.get(kernel, 0) > 0, f"config 2: {kernel} not launched")
    res = {"launches": launches, "add_ms_p50": float(np.median(add_ms)),
           "flush_ms_p50": float(np.median(flush_ms)), "flush_ms_max": float(max(flush_ms))}
    log(f"aggregator config 2: {n} series x {CONFIG2_WINDOWS} windows x {CONFIG2_BATCHES} batches; "
        f"launches {launches}; add_untimed_batch {res['add_ms_p50']:.3f} ms per 10s batch "
        f"(median), flush_before {res['flush_ms_p50']:.3f} ms (median; max "
        f"{res['flush_ms_max']:.3f}) (host clock); the first {CONFIG2_CPU_SERIES} series equal "
        f"the CPU run bit for bit, every value equals numpy's")
    return res


# --- phase 11: the seal's batched encode at full size ------------------------


def encode_main(rows):
    """bench.py:323 bench_encode on the card: 250,000 series x 360 points
    at 10s (2,000 seed-42 walks tiled), encode_batched (native value
    grammar + E1) and E1 alone; checks: tiled lanes, the unique streams
    against the scalar encoder, a round trip of every lane through K3."""
    t0 = time.time()
    ts_u, vs_u = corpus.gen_grids(N_UNIQUE, N_DP)
    reps = ENC_SERIES // N_UNIQUE
    ts, vs = np.tile(ts_u, (reps, 1)), np.tile(vs_u, (reps, 1))
    start = np.full(ENC_SERIES, corpus.START, dtype=np.int64)
    n_valid = np.full(ENC_SERIES, N_DP, dtype=np.int32)
    log(f"encode data: {ENC_SERIES} series x {N_DP} dp ({N_UNIQUE} walks tiled) in "
        f"{time.time() - t0:.1f} s")
    _build.reset_launches()
    words, nbits = enc.encode_batched(ts, vs, start, n_valid, device=DEVICE)
    torch.cuda.synchronize()
    launches = dict(_build.LAUNCHES)
    check(launches.get("pack_encode", 0) > 0, "encode main: pack_encode not launched")
    L, W = words.shape
    check(W == enc.n_words_for(N_DP), f"encode main: {W} words per lane")
    wb = _words_bits(words)
    same_bits(wb.view(reps, N_UNIQUE, W), wb[:N_UNIQUE].expand(reps, N_UNIQUE, W).contiguous(),
              "encode main: tiled lanes")
    same_bits(nbits.view(reps, N_UNIQUE), nbits[:N_UNIQUE].expand(reps, N_UNIQUE).contiguous(),
              "encode main: tiled bit lengths")
    host_w, host_n = words[:N_UNIQUE].cpu().numpy(), nbits[:N_UNIQUE].cpu().numpy()
    for u in range(N_UNIQUE):
        want = m3tsz_scalar.encode_series(ts_u[u].tolist(), vs_u[u].tolist(), corpus.START)
        check(unpack_stream(host_w[u], ((int(host_n[u]) + 7) // 8) * 8) == want,
              f"encode main: unique lane {u} differs from the scalar encoder")
    dts, dvs, valid, count, err = dec.decode_batched(words, nbits, N_DP)
    check(bool(valid.all()) and bool((count == N_DP).all()) and not bool(err.any()),
          "encode main: round trip valid/count/error")
    check(torch.equal(dts, torch.from_numpy(ts).to(DEVICE)), "encode main: round-trip times")
    check(torch.equal(dvs.view(torch.int64), torch.from_numpy(vs).to(DEVICE).view(torch.int64)),
          "encode main: round-trip values")
    del dts, dvs, valid, count, err
    ms_e2e = time_ms(lambda: enc.encode_batched(ts, vs, start, n_valid, device=DEVICE), reps=7)
    args = _encode_args(ts, vs, start, n_valid)
    k = enc.pack_encode(*args)
    same_bits(_words_bits(k[0]), wb, "encode main: E1 on the staged fields")
    chunk = 25_000

    def plain_all(compare: bool):
        for lo in range(0, L, chunk):
            part = tuple(x[lo:lo + chunk] for x in args)
            pw, pn = enc.pack_encode_plain(*part)
            if compare:
                _record("pack_encode", same_bits(_words_bits(pw), wb[lo:lo + chunk],
                                                 f"encode main words [{lo}:]"))
                same_bits(pn, nbits[lo:lo + chunk], f"encode main nbits [{lo}:]")
            del pw, pn

    plain_all(True)
    ms = time_ms(lambda: enc.pack_encode(*args), reps=7)
    plain_ms = time_ms(lambda: plain_all(False), reps=1, warmup=0)
    row("pack_encode", rows, ms, plain_ms, L * N_DP * 32 + L * 12 + L * W * 4 + L * 4,
        L * N_DP * ENC_INT32_OPS_PER_STEP / INT32_OPS_PER_S * 1e3)
    _split_line("pack_encode", ms, lambda: enc.pack_encode(*args))
    res = {"launches": launches, "ms_e2e": ms_e2e, "ms_kernel": ms,
           "series_per_s": L / (ms_e2e / 1e3), "series_per_s_kernel": L / (ms / 1e3)}
    log(f"encode main: {L} series; launches {launches}; encode_batched {ms_e2e:.3f} ms median of "
        f"7 (CUDA events; native value grammar, transfers, E1) = {res['series_per_s']:.0f} "
        f"series/s; E1 alone {ms:.3f} ms = {res['series_per_s_kernel']:.0f} series/s; tiled "
        f"lanes, {N_UNIQUE} streams byte for byte with the scalar encoder, a K3 round trip of "
        f"every lane: checks passed")
    del words, nbits, wb, args, k
    torch.cuda.empty_cache()

    lanes, times, values = corpus.ragged_block(SEAL_LANES, N_DP)
    t0 = time.time()
    want = shard.encode_block_scalar(corpus.START, lanes, times, values, SEAL_LANES)
    t_scalar = time.time() - t0
    _build.reset_launches()
    t0 = time.time()
    got = shard.encode_block_device(corpus.START, lanes, times, values, SEAL_LANES, device=DEVICE)
    t_dev = time.time() - t0
    seal = dict(_build.LAUNCHES)
    check(seal.get("pack_encode", 0) > 0, "block seal: pack_encode not launched")
    check(got == want, "block seal: encode_block_device differs from encode_block_scalar")
    res["seal_launches"] = seal
    log(f"block seal: {SEAL_LANES} lanes x 1-{N_DP} points ({len(times)} points); launches "
        f"{seal}; encode_block_device {t_dev * 1e3:.1f} ms, the scalar encoder {t_scalar:.1f} s "
        f"(host clock); byte for byte equal")
    return res


# --- phase 12: the AggregateTiles kernel (T1) vs its plain version ---------

TILE_FIELDS = ("sum", "sum_sq", "count", "min", "max", "last", "decoded_count", "error")


def _tiles_flat(out):
    agg, decoded, error = out
    return (*agg, decoded, error)


def compare_tiles_case(streams, tag: str, n_steps: int, n_tiles: int, tile: int, bs: int,
                       unit: int = SEC, int_optimized: bool = True):
    """T1 twice (the same bits) and against its plain version, bit for bit."""
    words, nbits = inputs_from_numpy(*pack_streams(streams), device=DEVICE)
    args = (words, nbits, n_steps, n_tiles, tile, bs, unit, int_optimized)
    k = twice(lambda: _tiles_flat(tiles.aggregate_tiles(*args)), f"{tag} aggregate_tiles")
    p = _tiles_flat(tiles.aggregate_tiles_plain(*args))
    for field, kt, pt in zip(TILE_FIELDS, k, p):
        _record("aggregate_tiles", same_bits(kt, pt, f"{tag} aggregate_tiles.{field}"))
    return k


def compare_tiles(walks):
    """T1's probes: seed-42 walks (and truncated at n_steps), the decoder's
    probe streams (error lanes, truncation, garbage), float mode (NaN,
    +-Inf, +-0.0), a millisecond unit, duplicate timestamps and timestamps
    going back across tiles, points 1 ns before the block start and at the
    grid's end, a block start off the tile grid, 1, 7 and 129 lanes; then
    ``corpus.tile_group_probe_streams`` around T1's staged groups of 4
    tiles: 1, 3, 4, 5, 9 and 17 tiles on 1, 31, 33 and 129 lanes (lanes going
    backwards inside the first group and after groups were written, so the
    tile-by-tile walk runs after the warp's staged stores)."""
    probes = corpus.probe_streams(N_DP)
    tp = corpus.tile_probe_streams(MIN, 12)
    cases = [
        (walks + probes, "walks+probes, 1m", N_DP, 60, MIN, corpus.START, SEC, True),
        (walks[:512], "walks truncated at 300, 5m", 300, 12, 5 * MIN, corpus.START, SEC, True),
        (walks[:512], "block start off the tile grid", N_DP, 61, MIN, corpus.START + 37 * SEC,
         SEC, True),
        (corpus.probe_streams(N_DP, int_optimized=False) + corpus.golden_streams(),
         "float mode", N_DP, 60, MIN, corpus.START, SEC, False),
        (corpus.ms_streams(256, N_DP), "millisecond unit", N_DP, 100, SEC, corpus.START, MS,
         True),
        (tp, "tile probes", 64, 12, MIN, corpus.START, SEC, True),
        (tp, "tile probes, block start 1 ns past a second", 64, 12, MIN,
         corpus.START + 100 * SEC + 1, SEC, True),
    ] + [((tp + probes + walks)[:lanes], f"{lanes} lanes", 64, 12, MIN, corpus.START, SEC, True)
         for lanes in (1, 7, 129)]
    groups = corpus.tile_group_probe_streams()
    cases += [(groups[:lanes], f"tile groups, {n_tiles} tiles, {lanes} lanes", 64, n_tiles, MIN,
               corpus.START, SEC, True)
              for n_tiles in corpus.TILE_GROUP_NTILES for lanes in corpus.TILE_GROUP_LANES]
    for streams, tag, *args in cases:
        compare_tiles_case(streams, tag, *args)
    torch.cuda.synchronize()
    log(f"tiles parity (T1): {len(cases)} probe sets bit for bit with the plain version, twice "
        f"(the tile-group probes at {corpus.TILE_GROUP_NTILES} tiles x "
        f"{corpus.TILE_GROUP_LANES} lanes)")


# --- phase 13: the storage node, write -> seal -> flush -> AggregateTiles -> read

# BASELINE config 4's 50,000 series cut to 40,000: the phase is host-bound by
# the reference's design and took 195 s at 50,000 on the H100's host (PERF.md)
STORE_SERIES = 40_000
STORE_SHARDS = 64
STORE_DP = 720  # one 2h block of 10s data
STORE_BLOCK = 2 * 3600 * SEC
STORE_TILE = 5 * MIN  # BASELINE config 3's middle resolution: 24 tiles a block
STORE_AGGS = (ds.AggregationType.MEAN, ds.AggregationType.MAX, ds.AggregationType.LAST)


def _busy(fn):
    """fn() under torch.profiler: (its result, wall ms, device kernel ms,
    device copy ms); the device times are None when the profiler saw no
    device activity (then they are not measured)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    kernel_us = copy_us = 0.0
    for ev in prof.key_averages():
        if ev.device_type != DeviceType.CUDA:
            continue
        if ev.key.startswith(("Memcpy", "Memset")):
            copy_us += ev.self_device_time_total
        else:
            kernel_us += ev.self_device_time_total
    if kernel_us + copy_us == 0:
        return out, wall, None, None
    return out, wall, kernel_us / 1e3, copy_us / 1e3


def storage_main(n_series: int = STORE_SERIES):
    """A port ``Database`` on the card through the storage node's path
    (the reference's large_tiles_test.go flow): ``write_columns`` of one 2h
    block of 10s data (the 2,000 seed-42 walks tiled), ``tick`` past the
    block (E1 seals every shard), ``flush`` to filesets,
    ``TileAggregator.aggregate_tiles`` at 5m tiles with MEAN, MAX and LAST
    (T1, twice: the decode bound grows 512 -> 1024; both calls are then run
    again, twice, and held against the plain version), a tick and flush of
    the tiles, then a restart (a new ``Database`` on the same directory,
    ``bootstrap``) and ``fetch_tagged`` of every tile through the
    decoded-block cache (K3 via ``decode_streams_adaptive``), cold and
    warm.  Launch counts are reset before each stage and read after it;
    every tile read back is checked against numpy over the written samples
    (mean at rtol 1e-12, max and last bit for bit)."""
    import shutil
    import tempfile

    from m3_tpu_torch.aggregator.aggregator import MetricKind, apply_suffix, suffix_for
    from m3_tpu_torch.cache import CacheOptions
    from m3_tpu_torch.storage.database import Database, DatabaseOptions
    from m3_tpu_torch.storage.namespace import NamespaceOptions
    from m3_tpu_torch.storage.tiles import AggregateTilesOptions, TileAggregator

    b0 = corpus.START - corpus.START % STORE_BLOCK
    n_tiles = STORE_BLOCK // STORE_TILE
    t0 = time.time()
    ts_u, vs_u = corpus.gen_grids(N_UNIQUE, STORE_DP, start=b0 - 10 * SEC)
    reps = n_series // N_UNIQUE
    check(n_series % N_UNIQUE == 0, "storage: series must tile the unique walks")
    ids = [b"cpu_load{host=h%06d}" % i for i in range(n_series)]
    tags = [{b"__name__": b"cpu_load", b"host": b"h%06d" % i, b"dc": b"dc%d" % (i % 4)}
            for i in range(n_series)]
    times = np.tile(ts_u, (reps, 1)).reshape(-1)
    values = np.tile(vs_u, (reps, 1)).reshape(-1)
    uniq_idx = np.repeat(np.arange(n_series, dtype=np.int64), STORE_DP)
    log(f"storage data: {n_series} series x {STORE_DP} points ({times.size} samples, "
        f"{N_UNIQUE} walks tiled) in {time.time() - t0:.1f} s")
    root = _build.BUILD_DIR.parent / "storage_smoke"
    root.mkdir(parents=True, exist_ok=True)
    path = tempfile.mkdtemp(dir=root)
    opts = DatabaseOptions(path=path, num_shards=STORE_SHARDS, commit_log_enabled=False,
                           cache=CacheOptions(decoded_policy="lru",
                                              decoded_max_bytes=4 << 30))
    stages = {}

    def stage(name, fn):
        _build.reset_launches()
        out, wall, kernel_ms, copy_ms = _busy(fn)
        stages[name] = {"wall_ms": wall, "kernel_ms": kernel_ms, "copy_ms": copy_ms,
                        "launches": dict(_build.LAUNCHES)}
        dev = ("device not measured" if kernel_ms is None
               else f"device kernels {kernel_ms:.3f} ms, copies {copy_ms:.3f} ms")
        log(f"storage {name}: {wall:.1f} ms wall; {dev}; launches {dict(_build.LAUNCHES)}")
        return out

    def open_db():
        db = Database(opts, device=DEVICE)
        db.create_namespace(NamespaceOptions(name="raw"))
        db.create_namespace(NamespaceOptions(name="tiles_5m", aggregated=True,
                                             aggregation_resolution=STORE_TILE))
        return db

    try:
        db = open_db()
        stage("write_columns", lambda: db.write_columns("raw", ids, tags, times, values,
                                                        uniq_idx))
        sealed = stage("tick (seal)", lambda: db.tick(now_nanos=b0 + STORE_BLOCK + 11 * MIN))
        check(sorted(sealed["raw"]) == [b0] * STORE_SHARDS, f"storage: sealed {sealed}")
        check(stages["tick (seal)"]["launches"].get("pack_encode", 0) >= STORE_SHARDS,
              "storage: the seal did not launch pack_encode on every shard")
        flushed = stage("flush", lambda: db.flush())
        check(len(flushed["raw"]) == STORE_SHARDS, f"storage: flushed {flushed}")
        src = db.series_streams_for_block("raw", b0)
        check(len(src) == n_series, f"storage: {len(src)} sealed streams")
        by_id = {sid: stream for sid, _, stream in src}
        for u in range(0, N_UNIQUE, 97):  # a sample of the sealed streams, by the scalar encoder
            want = m3tsz_scalar.encode_series(ts_u[u].tolist(), vs_u[u].tolist(), b0)
            check(by_id[ids[u]] == want, f"storage: sealed stream {u} differs from the encoder")
        unique_streams = [by_id[ids[u]] for u in range(N_UNIQUE)]
        del src, by_id
        t1_calls, t1_real = [], tiles.aggregate_tiles

        def t1_recorded(*a, **kw):  # T1's arguments, kept to hold it against its plain version
            t1_calls.append((a, kw))
            return t1_real(*a, **kw)

        tiles.aggregate_tiles = t1_recorded
        try:
            res = stage("aggregate_tiles", lambda: TileAggregator(db).aggregate_tiles(
                "raw", "tiles_5m", b0, b0 + STORE_BLOCK,
                AggregateTilesOptions(tile_nanos=STORE_TILE, agg_types=STORE_AGGS)))
        finally:
            tiles.aggregate_tiles = t1_real
        check((res.n_series, res.n_blocks, res.n_errors, res.n_tiles_written)
              == (n_series, 1, 0, n_series * n_tiles * len(STORE_AGGS)),
              f"storage: aggregate_tiles result {res}")
        check(stages["aggregate_tiles"]["launches"].get("aggregate_tiles", 0) == 2,
              "storage: T1 must run twice (decode bound 512, then 1024)")
        for a, kw in t1_calls:  # the stage's two calls again, twice, and the plain version
            what = f"storage T1 at {kw.get('n_steps')} steps"
            k = twice(lambda: _tiles_flat(tiles.aggregate_tiles(*a, **kw)), what)
            for field, kt, pt in zip(TILE_FIELDS, k, _tiles_flat(
                    tiles.aggregate_tiles_plain(*a, **kw))):
                _record("aggregate_tiles", same_bits(kt, pt, f"{what}: {field}"))
        log(f"storage parity (T1): the stage's {len(t1_calls)} calls ({len(t1_calls[0][0][0])} "
            f"lanes) twice the same bits and bit for bit with the plain version")
        del t1_calls
        stage("tick+flush (tiles)", lambda: (db.tick(now_nanos=b0 + 3 * STORE_BLOCK),
                                             db.flush()))
        db.close()
        db = stage("restart (bootstrap)", lambda: (lambda d: (d.bootstrap(), d)[1])(open_db()))
        matchers = [("eq", b"__name__", b"cpu_load")]
        cold = stage("fetch_tagged (cold)", lambda: db.fetch_tagged(
            "tiles_5m", matchers, b0, b0 + 2 * STORE_BLOCK, with_counts=True))
        check(stages["fetch_tagged (cold)"]["launches"].get("decode_batched", 0) > 0,
              "storage: the cold fetch did not decode with K3")
        warm = stage("fetch_tagged (warm)", lambda: db.fetch_tagged(
            "tiles_5m", matchers, b0, b0 + 2 * STORE_BLOCK, with_counts=True))
        check(not stages["fetch_tagged (warm)"]["launches"],
              "storage: the warm fetch decoded again")
        check(len(cold) == n_series * len(STORE_AGGS), f"storage: fetched {len(cold)} series")
        # every tile against numpy over the written samples
        grid = vs_u.reshape(N_UNIQUE, n_tiles, STORE_DP // n_tiles)
        want = {ds.AggregationType.MEAN: grid.sum(axis=2) / grid.shape[2],
                ds.AggregationType.MAX: grid.max(axis=2),
                ds.AggregationType.LAST: grid[:, :, -1]}
        suffix = {at: suffix_for(MetricKind.GAUGE, at) for at in STORE_AGGS}
        t_end = b0 + (np.arange(n_tiles, dtype=np.int64) + 1) * STORE_TILE
        checked = 0
        for at, w in want.items():
            oids = [apply_suffix(sid, suffix[at]) for sid in ids]
            t = np.stack([np.concatenate([e[1][0] for e in cold[o]]) for o in oids])
            v = np.stack([np.concatenate([e[1][1] for e in cold[o]]) for o in oids])
            v_warm = np.stack([np.concatenate([e[1][1] for e in warm[o]]) for o in oids])
            check(t.shape == (n_series, n_tiles) and bool((t == t_end).all()),
                  f"storage: {at.name} tile times")
            check(np.array_equal(v.view(np.int64), v_warm.view(np.int64)),
                  f"storage: {at.name} warm reads differ from cold")
            ref = w[np.arange(n_series) % N_UNIQUE]
            if at == ds.AggregationType.MEAN:
                ok = bool(np.all(np.abs(v - ref) <= 1e-12 * np.abs(ref)))
            else:
                ok = np.array_equal(v.view(np.int64), ref.view(np.int64))
            check(ok, f"storage: {at.name} tiles differ from numpy")
            checked += v.size
        log(f"storage checks: {checked} tiles of {len(cold)} series against numpy over the "
            f"written samples (mean rtol 1e-12, max and last bit for bit): passed")
        db.close()
    finally:
        shutil.rmtree(path, ignore_errors=True)
    launches = {}
    for st in stages.values():
        for kernel, n in st["launches"].items():
            launches[kernel] = launches.get(kernel, 0) + n
    return {"stages": stages, "launches": launches, "n_series": n_series}, unique_streams, b0


def _library_tiles(words, nbits, n_steps, n_tiles, tile, bs):
    """The same function from PyTorch calls on K3's decoded grid:
    ``index_add_`` for sum, sum_sq and count, ``scatter_reduce_`` for min,
    max and the greatest time, ``scatter_`` for last.  (No PyTorch call
    decodes M3TSZ.)  The points are compacted first, so the scatters see
    only in-range points and no cell collects the padding."""
    ts, vs, valid, decoded, error = dec.decode_batched(words, nbits, n_steps)
    L = ts.shape[0]
    n = L * n_tiles
    k = tiles.tile_index(ts, bs, tile)
    inr = (valid & (k >= 0) & (k < n_tiles)).view(-1)
    lane = torch.arange(L, device=ts.device)[:, None] * n_tiles
    seg = (lane + k).view(-1)[inr]
    tv = ts.view(-1)[inr]
    vv = vs.view(-1)[inr]
    num = ~torch.isnan(vv)
    segc, vc = seg[num], vv[num]
    f64 = dict(dtype=torch.float64, device=ts.device)
    s = torch.zeros(n, **f64).index_add_(0, segc, vc)
    ssq = torch.zeros(n, **f64).index_add_(0, segc, vc * vc)
    cnt = torch.zeros(n, dtype=torch.int64, device=ts.device).index_add_(
        0, seg, torch.ones_like(seg))
    mn = torch.full((n,), torch.inf, **f64).scatter_reduce_(0, segc, vc, "amin")
    mx = torch.full((n,), -torch.inf, **f64).scatter_reduce_(0, segc, vc, "amax")
    lt = torch.full((n,), torch.iinfo(torch.int64).min, dtype=torch.int64,
                    device=ts.device).scatter_reduce_(0, seg, tv, "amax")
    win = tv == lt[seg]
    last = torch.full((n,), torch.nan, **f64).scatter_(0, seg[win], vv[win])
    return s, ssq, cnt, mn, mx, last, decoded, error


TILES_LANES = 1_000_000  # the read main's width
TILES_STEPS = 1024  # TileAggregator's decode bound for a 2h block of 10s data, grown
TILES_CHUNK = 250_000  # lanes per call of the plain and library versions (device memory)


def tiles_kernel_times(unique_streams, b0: int, rows):
    """T1 alone at full width: 1,000,000 lanes (the storage phase's 2,000
    unique sealed streams tiled) x 720 points, at 1m (120) and 5m (24)
    tiles, run twice (the same bits); beside its plain version (held
    against the kernel bit for bit),
    its bound and K3 + index_add_/scatter_reduce_ over the decoded grid."""
    uw, un = pack_streams(unique_streams)
    reps = TILES_LANES // len(unique_streams)
    words, nbits = inputs_from_numpy(np.tile(uw, (reps, 1)), np.tile(un, reps), device=DEVICE)
    L, W = words.shape
    for tile in (MIN, 5 * MIN):
        n_tiles = STORE_BLOCK // tile
        args = (TILES_STEPS, n_tiles, tile, b0)
        k = twice(lambda: _tiles_flat(tiles.aggregate_tiles(words, nbits, *args)),
                  f"T1 {n_tiles} tiles")
        check(bool((k[6] == STORE_DP).all()) and not bool(k[7].any()),
              f"T1 {n_tiles} tiles: decoded counts / errors")
        check(bool((k[2].sum(dim=1) == STORE_DP).all()), f"T1 {n_tiles} tiles: counts")
        plain_out = []

        def plain_all():
            plain_out.clear()
            for lo in range(0, L, TILES_CHUNK):
                plain_out.append(_tiles_flat(tiles.aggregate_tiles_plain(
                    words[lo:lo + TILES_CHUNK], nbits[lo:lo + TILES_CHUNK], *args)))

        _, plain_ms = time_once(plain_all)
        for c, part in enumerate(plain_out):
            lo = c * TILES_CHUNK
            for field, kt, pt in zip(TILE_FIELDS, k, part):
                _record("aggregate_tiles", same_bits(kt[lo:lo + TILES_CHUNK], pt,
                                                     f"T1 {n_tiles} tiles [{lo}:] {field}"))
        # the yardstick computes the same function: count, max and last of
        # its first call are T1's (every tile holds points, no time ties)
        lib = _library_tiles(words[:TILES_CHUNK], nbits[:TILES_CHUNK], *args)
        for field, i in (("count", 2), ("max", 4), ("last", 5)):
            same_bits(lib[i].view(-1, n_tiles), k[i][:TILES_CHUNK],
                      f"T1 {n_tiles} tiles: library {field}")
        datapoints = int(k[6].sum())
        del k, lib, plain_out[:]
        torch.cuda.empty_cache()
        ms = time_ms(lambda: tiles.aggregate_tiles(words, nbits, *args), reps=5)

        def library_all():
            for lo in range(0, L, TILES_CHUNK):
                _library_tiles(words[lo:lo + TILES_CHUNK], nbits[lo:lo + TILES_CHUNK], *args)

        library_ms = time_ms(library_all, reps=3)
        torch.cuda.empty_cache()
        bytes_ = words.numel() * 4 + nbits.numel() * 4 + L * n_tiles * 48 + L * 5
        row(f"aggregate_tiles[{tile // MIN}m]", rows, ms, plain_ms, bytes_,
            datapoints * INT32_OPS_PER_DATAPOINT / INT32_OPS_PER_S * 1e3, library_ms,
            f"K3 + index_add_/scatter_reduce_ ({L // TILES_CHUNK} calls)")
    del words, nbits
    torch.cuda.empty_cache()


# --- phase 14: the mesh paths (series-sharded read, ingest and query) -------

MESH_SHARDS = 8  # virtual shards on the one card


def _mesh_probe_stack(n_shards: int, n: int, seed: int) -> torch.Tensor:
    """[n_shards, n] partials of NaN, +-Inf, +-0.0, +-DBL_MAX-scale and plain
    values, with columns of alternating signed zeros, all NaN and all -0.0."""
    rng = np.random.default_rng(seed)
    pool = np.asarray([np.nan, np.inf, -np.inf, 0.0, -0.0, 1.5, -2.25, 1e308, -1e308, 3.0, 1e-3])
    x = pool[rng.integers(0, len(pool), (n_shards, n))]
    x[:, 0] = np.where(np.arange(n_shards) % 2, -0.0, 0.0)
    x[:, 1] = np.where(np.arange(n_shards) % 2, 0.0, -0.0)
    x[:, 2] = np.nan
    x[:, 3] = -0.0
    return torch.from_numpy(x).to(DEVICE)


def _sqdev_probes():
    """(matrix, segments, n_segments, center) cases for QK4's sqdev: probe
    matrices with NaN cells, all-NaN lanes, +-Inf and +-0.0, split over 1-8
    shards into segments of at most 32 lanes (folded in lane order, so bit
    for bit), a lane outside every group; and the served rate of the query
    probe corpus split over 2 shards."""
    rng = np.random.default_rng(77)
    cases = []
    for L, S, n_groups, spr in ((32, 24, 3, 4), (64, 40, 5, 8), (56, 355, 2, 7), (16, 7, 1, 1)):
        out = rng.standard_normal((L, S)) * 10
        out[rng.random(out.shape) < 0.3] = np.nan
        out[3] = np.nan
        out[5, :4] = [np.inf, -np.inf, 0.0, -0.0]
        groups = rng.integers(0, n_groups, L)
        groups[7] = n_groups  # no group
        cases.append((out, groups, n_groups, spr, rng.standard_normal((n_groups, S))))
    b = corpus.query_probe_corpus()
    rate, _, _ = qp.device_rate_pipeline(b.words, b.nbits, b.slots, b.steps, b.n_lanes, b.n_cap,
                                         b.range_nanos, n_dp=b.n_dp, device="cpu")
    rate = rate.numpy()
    L = rate.shape[0] - rate.shape[0] % 2
    cases.append((rate[:L], np.arange(L) % 3, 3, 2, rng.standard_normal((3, rate.shape[1]))))
    for out, groups, n_groups, spr, center in cases:
        L = out.shape[0]
        seg = np.where(groups < n_groups, (np.arange(L) // (L // spr)) * n_groups + groups, -1)
        yield (torch.from_numpy(out).to(DEVICE), seg, spr * n_groups,
               torch.from_numpy(center).to(DEVICE))


def compare_mesh_kernels():
    """MK1 (sum, min and max; f64 and i64; at 1, 7 and 8 shards; with and
    without an owned range) and QK4's sqdev against their plain versions on
    the card, bit for bit, twice."""
    n_mk1 = 0
    for n_shards in (1, 7, 8):
        for n in (60, 4097):
            x = _mesh_probe_stack(n_shards, n, seed=31 * n_shards + n)
            xi = torch.from_numpy(np.random.default_rng(n).integers(
                -2**60, 2**60, (n_shards, n))).to(DEVICE)
            for op in mesh_reduce.OPS:
                for lo, hi in ((None, None), (n // 3, n // 3 + n // 2)):
                    for t in (x, xi):
                        tag = f"mesh parity MK1 {op} {t.dtype} {n_shards}x{n} [{lo}, {hi})"
                        got = twice(lambda: mesh_reduce.mesh_reduce(t, op, lo, hi), tag)
                        _record("mesh_reduce", same_bits(
                            got, mesh_reduce.mesh_reduce_plain(t, op, lo, hi), tag))
                        n_mk1 += 1
    n_batch = 0
    for n_shards in (1, 8):
        for n in (60, 4097):
            ops = ("sum", "min", "max", "sum", "min")
            joint = torch.stack([_mesh_probe_stack(n_shards, n, seed=7 * i + n)
                                 for i in range(len(ops))], dim=1)
            stacks = [joint[:, i] for i in range(len(ops))]  # views of one gather
            ints = [torch.from_numpy(np.random.default_rng(n + i).integers(
                -2**60, 2**60, (n_shards, n))).to(DEVICE) for i in range(3)]
            # rows that are not contiguous: transposed views, each copied
            trans = [_mesh_probe_stack(n_shards, n, seed=11 * i + n).T.contiguous().T
                     for i in range(2)]
            whole = (None, None)
            for batch, bops, (lo, hi) in ((stacks, ops, whole), (stacks[:2], ops[:2], whole),
                                          (ints, ops[:3], whole), (trans, ops[1:3], whole),
                                          (trans, ops[1:3], (n // 3, n // 3 + n // 2))):
                tag = (f"mesh parity MK1 batch {bops} {batch[0].dtype} {n_shards}x{n} "
                       f"strides {batch[0].stride()} [{lo}, {hi})")
                got = twice(lambda: torch.stack(mesh_reduce.mesh_reduce_batch(batch, bops, lo, hi)),
                            tag)
                want = torch.stack([mesh_reduce.mesh_reduce_plain(b, op, lo, hi)
                                    for b, op in zip(batch, bops)])
                _record("mesh_reduce", same_bits(got, want, tag))
                n_batch += 1
    n_sq = 0
    for out, seg, n_seg, center in _sqdev_probes():
        tag = f"mesh parity sqdev {tuple(out.shape)} over {n_seg} segments"
        got = twice(lambda: query_grouped.grouped_reduce(out, seg, n_seg, "sqdev", None, 0.0,
                                                         center), tag)
        _record("query_sqdev", same_bits(got, query_grouped.grouped_reduce_plain(
            out, torch.from_numpy(seg).to(DEVICE), n_seg, "sqdev", 0.0, center), tag))
        n_sq += 1
    torch.cuda.synchronize()
    log(f"mesh parity: MK1 bit for bit on {n_mk1} cases and its batched form on {n_batch} "
        f"batches (views of one stack, transposed views, an owned range, mixed ops, f64 and "
        f"i64), QK4 sqdev on {n_sq} probe sets "
        f"(segments of <= 32 lanes), twice each")


def _drive_mesh(name: str, fn, want):
    """fn() with the launch counts reset just before and read just after."""
    _build.reset_launches()
    res = fn()
    torch.cuda.synchronize()
    launches = dict(_build.LAUNCHES)
    for kernel in want:
        check(launches.get(kernel, 0) > 0, f"mesh {name}: {kernel} not launched")
    return res, launches


def _mesh_timed(name: str, sharded, unsharded, launches, checked: str, results: dict):
    ms = time_ms(sharded, reps=7)
    ms_u = time_ms(unsharded, reps=7)
    results[name] = {"launches": launches, "ms": ms, "unsharded_ms": ms_u}
    log(f"mesh {name}: launches {launches}; {ms:.3f} ms device sharded over {MESH_SHARDS} "
        f"shards vs {ms_u:.3f} ms unsharded (medians of 7); {checked}")


def mesh_read_main(walks, results: dict):
    """The north-star read (1,000,000 series x 360 points, window 6) on a
    4x2 mesh through decode_downsample_sharded for MEAN: per_lane against
    decode_downsample bit for bit, the fleet against a float64 numpy sum of
    nan_to_num(per_lane) at rtol 1e-12, the two schedules bit for bit."""
    reps = N_SERIES // N_UNIQUE
    uw, un = pack_streams(walks)
    mesh = pmesh.make_mesh(4, 2, device=DEVICE)
    check(pmesh.supports_f64_reduce_scatter(mesh), "the card takes the scatter schedule")
    words, nbits = rp.shard_inputs(mesh, np.tile(uw, (reps, 1)), np.tile(un, reps))
    agg = ds.AggregationType.MEAN
    step = rp.decode_downsample_sharded(mesh, N_DP, WINDOW, agg)
    (per_lane, fleet), launches = _drive_mesh(
        "read", lambda: step(words, nbits),
        ["decode_downsample_fused", "query_grouped", "mesh_reduce"])
    single, _, _ = decode_downsample(words, nbits, N_DP, WINDOW, agg)
    same_bits(per_lane, single, "mesh read: per_lane vs decode_downsample")
    want = np.nan_to_num(single.cpu().numpy()).sum(axis=0)
    err = close(fleet.cpu(), torch.from_numpy(want), 1e-12, "mesh read: fleet vs numpy")
    # the step's scatter schedule against the all-reduce one on the same partials
    local = pmesh.shard_reduce(mesh, torch.nan_to_num(per_lane))
    partial = pmesh.psum(mesh, local, pmesh.SERIES_AXIS)
    same_bits(fleet, pmesh.consolidate_windows(mesh, partial, pmesh.WINDOW_AXIS, False)[0],
              "mesh read: scatter vs all-reduce schedule")
    _mesh_timed("read", lambda: step(words, nbits),
                lambda: decode_downsample(words, nbits, N_DP, WINDOW, agg), launches,
                f"per_lane bit for bit, fleet vs numpy max abs err {err} (rtol 1e-12), "
                f"both schedules the same bits", results)
    for name, fn in (
            ("per-shard sums (QK4)", lambda: pmesh.shard_reduce(mesh, per_lane)),
            ("scatter schedule (MK1)", lambda: pmesh.consolidate_windows(
                mesh, partial, pmesh.WINDOW_AXIS, True)),
            ("all-reduce schedule (MK1)", lambda: pmesh.consolidate_windows(
                mesh, partial, pmesh.WINDOW_AXIS, False))):
        results["read"][name] = time_ms(fn, reps=7)
        log(f"time mesh read's {name}: {results['read'][name]:.3f} ms")


def mesh_ingest_main(results: dict):
    """The encode configuration (250,000 series x 360 points, window 6)
    through encode_rollup_sharded on 8x1 and 4x2: words/nbits against
    encode_batched's bit for bit, total_bytes exact, rolled and the fleet
    against numpy at rtol 1e-12."""
    ts_u, vs_u = corpus.gen_grids(N_UNIQUE, N_DP)
    reps = ENC_SERIES // N_UNIQUE
    ts, vs = np.tile(ts_u, (reps, 1)), np.tile(vs_u, (reps, 1))
    start = np.full(ENC_SERIES, corpus.START, dtype=np.int64)
    n_valid = np.full(ENC_SERIES, N_DP, dtype=np.int32)
    cb, cn, pb, pn = native.prepare_value_fields_native(vs, n_valid)
    ref_words, ref_nbits = enc.encode_batched(ts, vs, start, n_valid, device=DEVICE)
    want_total = int(((ref_nbits.cpu().numpy().astype(np.int64) + 7) // 8).sum())
    rolled_np = vs.reshape(ENC_SERIES, N_DP // WINDOW, WINDOW).mean(axis=2)
    for shape in ((8, 1), (4, 2)):
        mesh = pmesh.make_mesh(*shape, device=DEVICE)
        step = ing.encode_rollup_sharded(mesh, N_DP, WINDOW)
        args = ing.shard_ingest_inputs(mesh, ts, start, n_valid, cb, cn, pb, pn, vs)
        (words, nbits, rolled, fleet, total), launches = _drive_mesh(
            f"ingest {shape}", lambda: step(*args), ["pack_encode", "query_grouped", "mesh_reduce"])
        same_bits(_words_bits(words), _words_bits(ref_words), f"mesh ingest {shape}: words")
        same_bits(nbits, ref_nbits, f"mesh ingest {shape}: nbits")
        check(total.dtype == torch.int64 and int(total) == want_total,
              f"mesh ingest {shape}: total_bytes {int(total)} != {want_total}")
        close(rolled.cpu(), torch.from_numpy(rolled_np), 1e-12, f"mesh ingest {shape}: rolled")
        err = close(fleet.cpu(), torch.from_numpy(rolled_np.sum(axis=0)), 1e-12,
                    f"mesh ingest {shape}: fleet")
        _mesh_timed(f"ingest {shape[0]}x{shape[1]}", lambda: step(*args),
                    lambda: enc.pack_encode(*args[:7]), launches,
                    f"words/nbits bit for bit with encode_batched, total_bytes {int(total)} "
                    f"exact, fleet max abs err {err} (rtol 1e-12); unsharded = E1 alone on the "
                    f"same fields", results)
        del words, nbits, rolled, args
    torch.cuda.empty_cache()


def _shard_even_leaf(eb: corpus.ExprPlanBuilder, idx: int) -> int:
    rows = len(eb.leaves[idx]["nbits"])
    eb.shard_even(idx, MESH_SHARDS)
    lf = eb.leaves[idx]
    log(f"mesh leaf {idx}: {rows} stream rows -> {len(lf['nbits'])} shard-even rows "
        f"({len(lf['nbits']) // MESH_SHARDS} a shard) over {len(lf['valid'])} lanes "
        f"({int(lf['valid'].sum())} real)")
    return idx


def mesh_query_main(fc: corpus.FanoutCorpus, results: dict, rows: dict):
    """BASELINE config 4 repacked into 8 shards (shard_repack): rate,
    grouped sum/stddev/min/quantile(0.9), and the ratio, topk(10) and
    histogram_quantile(0.99) plans through device_expr_pipeline_sharded,
    each against the unsharded pipeline on the same data; then the same
    ratio and grouped sum over an NCCL group of world size 1; then MK1 and
    sqdev timed at the group-by's shapes."""
    b = fc.batch
    n, S, r = b.n_lanes, len(b.steps), b.range_nanos
    mesh = pmesh.make_mesh(MESH_SHARDS, device=DEVICE)
    pk = shard_repack({"words": b.words, "nbits": b.nbits, "slots": b.slots, "tiers": None,
                       "n_streams": len(b.slots), "lanes_pad": n}, MESH_SHARDS)
    L = pk["lanes_pad"]
    log(f"mesh query data: {n} lanes repacked to {L} over {MESH_SHARDS} shards, "
        f"{len(pk['nbits'])} stream rows ({len(b.slots)} real)")
    w, nb, sl = (pmesh.series_sharding(mesh, pk[k]) for k in ("words", "nbits", "slots"))
    real = torch.from_numpy(pk["real_rows"]).to(DEVICE)
    steps = pmesh.replicated(mesh, b.steps)
    words, nbits, slots, _, _ = qp._inputs(b.words, b.nbits, b.slots, b.steps, None, DEVICE)
    kw = dict(n_cap=b.n_cap, range_nanos=r, n_dp=b.n_dp)
    front = ["decode_batched", "query_merge", "query_rate"]

    def sharded_rate():
        return qp.device_rate_sharded(mesh, w, nb, sl, steps, L, **kw)

    def unsharded_rate():
        return qp.device_rate_pipeline(words, nbits, slots, steps, n_lanes=n, **kw)

    (rate, fleet, err), launches = _drive_mesh("rate", sharded_rate,
                                               front + ["query_grouped", "mesh_reduce"])
    check(not bool(err[real].any()), "mesh rate: error flags on real streams")
    u_rate, u_fleet, _ = unsharded_rate()
    same_bits(rate[:n], u_rate, "mesh rate: per lane vs device_rate_pipeline")
    check(bool(torch.isnan(rate[n:]).all()), "mesh rate: padding lanes not NaN")
    e = close(fleet, u_fleet, 1e-12, "mesh rate: fleet vs device_rate_pipeline")
    _mesh_timed("rate", sharded_rate, unsharded_rate, launches,
                f"per lane bit for bit, fleet max abs err {e} (rtol 1e-12)", results)
    del u_rate

    groups = np.zeros(L, dtype=np.int64)  # padding lanes (all NaN) parked on group 0
    groups[:n] = b.groups
    grouped = {}
    for agg, rtol, want in (("sum", 1e-12, ["query_grouped", "mesh_reduce"]),
                            ("stddev", 1e-9, ["query_grouped", "query_sqdev", "mesh_reduce"]),
                            ("min", 0.0, ["query_grouped", "mesh_reduce"]),
                            ("max", 0.0, ["query_grouped", "mesh_reduce"]),
                            ("quantile", 0.0, ["query_quantile"])):
        def sharded(agg=agg):
            return qp.device_grouped_sharded(mesh, w, nb, sl, steps, groups, L, b.n_groups,
                                             fn="rate", agg=agg, phi=0.9, **kw)

        def unsharded(agg=agg):
            return qp.device_grouped_pipeline(words, nbits, slots, steps, b.groups, n_lanes=n,
                                              n_groups=b.n_groups, fn="rate", agg=agg, phi=0.9,
                                              **kw)

        (out, err), launches = _drive_mesh(f"{agg} by (g)", sharded, front + want)
        check(not bool(err[real].any()), f"mesh {agg}: error flags on real streams")
        u_out, _ = unsharded()
        if rtol:
            e = close(out, u_out, rtol, f"mesh {agg} by (g) vs device_grouped_pipeline")
            how = f"max abs err {e} (rtol {rtol})"
        else:
            same_bits(out, u_out, f"mesh {agg} by (g) vs device_grouped_pipeline")
            how = "bit for bit"
        grouped[agg] = out
        _mesh_timed(f"{agg}_by_rate" if agg != "quantile" else "quantile(0.9)_by_rate",
                    sharded, unsharded, launches,
                    f"vs device_grouped_pipeline {how}", results)

    # the interpreter: the ratio of bench.py:1768, topk(10, ..), histogram_quantile(0.99, ..)
    plans = {}
    eb = corpus.ExprPlanBuilder(b.steps)
    half = n // 2
    aggs = []
    for lo in (0, half):
        ws, nbs, sls = _words_slice(b, lo, lo + half)
        labels = [{"job": "j%02d" % (i % N_JOBS_RATIO), "host": "h%06d" % i} for i in range(half)]
        idx = _shard_even_leaf(eb, eb.words_leaf(ws, nbs, sls, labels, b.n_dp, b.n_cap, r))
        aggs.append(eb.agg("sum", eb.leaf(idx, "rate"), ("job",)))
    plans["ratio"] = (eb, eb.vv("/", *aggs, on=("job",)),
                      front + ["query_grouped", "mesh_reduce"], 1e-12)
    eb = corpus.ExprPlanBuilder(b.steps)
    job_labels = [{"job": "j%03d" % (i % N_JOBS), "instance": "i%06d" % i} for i in range(n)]
    idx = _shard_even_leaf(eb, eb.words_leaf(b.words, b.nbits, b.slots, job_labels, b.n_dp,
                                             b.n_cap, r))
    plans["topk"] = (eb, eb.topk("topk", 10, eb.leaf(idx, "rate")), front + ["query_topk"], 0.0)
    eb_orig = corpus.ExprPlanBuilder(b.steps)  # the same plan on the engine's unsharded layout
    root_orig = eb_orig.topk("topk", 10, eb_orig.leaf(eb_orig.words_leaf(
        b.words, b.nbits, b.slots, job_labels, b.n_dp, b.n_cap, r), "rate"))
    hf = corpus.histogram_fleet(N_HIST, N_JOBS, HIST_UNIQUE, fc=fc)
    eb = corpus.ExprPlanBuilder(b.steps)
    idx = _shard_even_leaf(eb, eb.words_leaf(hf.words, hf.nbits, hf.slots, hf.labels, hf.n_dp,
                                             hf.n_cap, r))
    plans["histogram_quantile"] = (
        eb, eb.hq(0.99, eb.agg("sum", eb.leaf(idx, "rate"), ("job", "le"))),
        front + ["query_grouped", "mesh_reduce", "histo_quantile"], 1e-12)
    del hf
    expr_inputs = {}
    for name, (eb, root, want, rtol) in plans.items():
        leaves, params, st = eb.inputs()
        s_in = qp.shard_expr_inputs(root.plan, mesh, leaves, params, st)
        u_in = corpus.expr_inputs_from_numpy(corpus.global_slots(leaves, MESH_SHARDS), params,
                                             st, DEVICE)
        expr_inputs[name] = (root.plan, s_in)

        def sharded(plan=root.plan, s_in=s_in):
            return qp.device_expr_pipeline_sharded(plan, mesh, *s_in)

        def unsharded(plan=root.plan, u_in=u_in):
            return qp.device_expr_pipeline(plan, *u_in)

        (out, aux, errs), launches = _drive_mesh(name, sharded, want)
        u_out, u_aux, u_errs = unsharded()
        for e_s, e_u in zip(errs, u_errs):
            same_bits(e_s, e_u, f"mesh {name}: error flags vs device_expr_pipeline")
        if rtol:
            e = close(out, u_out, rtol, f"mesh {name} vs device_expr_pipeline")
            how = f"max abs err {e} (rtol {rtol})"
        else:
            same_bits(out, u_out, f"mesh {name} vs device_expr_pipeline")
            for a_s, a_u in zip(aux, u_aux):
                same_bits(a_s, a_u, f"mesh {name}: aux vs device_expr_pipeline")
            how = "out and aux bit for bit"
        check(bool(torch.isfinite(out).any()), f"mesh {name}: no finite value")
        if name == "ratio":
            ratio_out = out
        if name == "topk":
            o_in = corpus.expr_inputs_from_numpy(*eb_orig.inputs(), DEVICE)
            same_bits(qp.device_expr_pipeline(root_orig.plan, *o_in)[0], out,
                      "mesh topk vs the unsharded layout")
            layout_ms = time_ms(lambda: qp.device_expr_pipeline(root_orig.plan, *o_in), reps=7)
            log(f"mesh topk on the unsharded layout (no repack): {layout_ms:.3f} ms device "
                f"(median of 7)")
            del o_in
        _mesh_timed(name, sharded, unsharded, launches, f"vs device_expr_pipeline {how}",
                    results)
        if name == "topk":
            results[name]["unsharded_layout_ms"] = layout_ms
        del u_in, u_out
    torch.cuda.empty_cache()

    # NCCL at world size 1: the same queries through a mesh on the group
    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    torch.cuda.set_device(DEVICE.index or 0)
    with tempfile.TemporaryDirectory() as tmp:
        store = dist.FileStore(os.path.join(tmp, "store"), 1)
        dist.init_process_group("nccl", store=store, rank=0, world_size=1,
                                timeout=datetime.timedelta(seconds=300))
        try:
            gmesh = pmesh.make_mesh(MESH_SHARDS, device=DEVICE, group=dist.group.WORLD)
            check(gmesh.world == 1 and gmesh.shards_per_rank == MESH_SHARDS, "NCCL mesh layout")
            plan, s_in = expr_inputs["ratio"]
            (g_ratio, _, _), launches = _drive_mesh(
                "ratio [nccl]", lambda: qp.device_expr_pipeline_sharded(plan, gmesh, *s_in),
                ["query_grouped", "mesh_reduce"])
            same_bits(g_ratio, ratio_out, "mesh ratio: NCCL group vs no group")
            ratio_ms = time_ms(lambda: qp.device_expr_pipeline_sharded(plan, gmesh, *s_in), 7)
            (g_sum, _), _ = _drive_mesh("sum by (g) [nccl]", lambda: qp.device_grouped_sharded(
                gmesh, w, nb, sl, steps, groups, L, b.n_groups, fn="rate", agg="sum", **kw),
                ["query_grouped", "mesh_reduce"])
            same_bits(g_sum, grouped["sum"], "mesh sum by (g): NCCL group vs no group")
            stack = torch.randn((MESH_SHARDS, b.n_groups * S), dtype=torch.float64, device=DEVICE)
            gather_ms = time_ms(lambda: gmesh.gather_rows(stack), reps=7)
            results["nccl"] = {"launches": launches, "ratio_ms": ratio_ms,
                               "all_gather_into_tensor_ms": gather_ms}
            log(f"mesh nccl (world size 1, FileStore): ratio and sum by (g) the same bits as "
                f"without a group; ratio {ratio_ms:.3f} ms device (median of 7); "
                f"all_gather_into_tensor of f64{tuple(stack.shape)} {gather_ms:.3f} ms "
                f"(no link crossed at world size 1)")
        finally:
            dist.destroy_process_group()

    # MK1 and sqdev at the group-by's shapes: each shard's partial sums of
    # sum by (g) (rate), [8, 100 * 355]; sqdev over the rate lanes
    seg = pmesh.shard_segments(mesh, L, groups, b.n_groups)
    n_seg = MESH_SHARDS * b.n_groups
    part = query_grouped.grouped_reduce(rate, seg, n_seg, "sum", None, 0.0).reshape(
        MESH_SHARDS, -1)
    N = part.shape[1]
    for op, lib_fn in (("sum", torch.sum), ("min", torch.amin), ("max", torch.amax)):
        fn = lambda: mesh_reduce.mesh_reduce(part, op)  # noqa: E731
        same_bits(fn(), mesh_reduce.mesh_reduce_plain(part, op), f"time MK1 {op}")
        row(f"mesh_reduce[{op}]", rows, time_ms(fn, reps=7),
            time_ms(lambda: mesh_reduce.mesh_reduce_plain(part, op), reps=7),
            (MESH_SHARDS + 1) * N * 8, MESH_SHARDS * N / FP64_OPS_PER_S * 1e3,
            time_ms(lambda: lib_fn(part, dim=0), reps=7), f"torch.{lib_fn.__name__} over dim 0")
        _split_line(f"mesh_reduce[{op}]", rows[f"mesh_reduce[{op}]"]["ms"], fn)
    count_part = query_grouped.grouped_reduce(rate, seg, n_seg, "count", None, 0.0).reshape(
        MESH_SHARDS, -1)
    pair = [count_part, part]
    host = {name: host_us(fn) for name, fn in (
        ("mesh_reduce", lambda: mesh_reduce.mesh_reduce(part, "sum")),
        ("torch.sum", lambda: torch.sum(part, dim=0)),
        ("batch", lambda: mesh_reduce.mesh_reduce_batch(pair, ["sum", "sum"])),
        ("two", lambda: [mesh_reduce.mesh_reduce(x, "sum") for x in pair]))}
    log(f"time mesh_reduce host: the wrapper {host['mesh_reduce']:.2f} us a call, torch.sum "
        f"{host['torch.sum']:.2f} us a call; a batch of two stacks {host['batch']:.2f} us, two "
        f"single calls {host['two']:.2f} us (host clock over 2,000 calls, the device keeping up)")
    fn = lambda: mesh_reduce.mesh_reduce_batch(pair, ["sum", "sum"])  # noqa: E731
    for got, stack in zip(fn(), pair):
        same_bits(got, mesh_reduce.mesh_reduce_plain(stack, "sum"), "time MK1 batch")
    batch_ms = time_ms(fn, reps=7)
    two_ms = time_ms(lambda: [mesh_reduce.mesh_reduce(x, "sum") for x in pair], reps=7)
    log(f"time mesh_reduce batch (the sharded sum by's counts and sums, 2 x [{MESH_SHARDS}, "
        f"{N}] f64): one launch {batch_ms:.3f} ms, two single launches {two_ms:.3f} ms")
    _split_line("mesh_reduce batch", batch_ms, fn)
    counts = mesh_reduce.mesh_reduce(count_part, "sum").reshape(-1, S)
    center = (mesh_reduce.mesh_reduce(part, "sum").reshape(-1, S)
              / torch.clamp(counts, min=1.0)).contiguous()
    seg_t = torch.from_numpy(seg).to(DEVICE)
    index = query_grouped.group_index(seg, n_seg, DEVICE)
    fn = lambda: query_grouped.grouped_reduce(rate, seg, n_seg, "sqdev", index, 0.0,  # noqa
                                              center)
    _record("query_sqdev", close(fn(), query_grouped.grouped_reduce_plain(
        rate, seg_t, n_seg, "sqdev", 0.0, center), 1e-12,
        "time sqdev (segments of ~63 lanes: warp chains)"))
    d = torch.where(torch.isnan(rate), 0.0, rate - center[seg_t.clamp(min=0) % b.n_groups])
    d2 = d * d
    row("query_sqdev", rows, time_ms(fn, reps=7),
        time_ms(lambda: query_grouped.grouped_reduce_plain(rate, seg_t, n_seg, "sqdev", 0.0,
                                                           center), reps=3),
        L * S * 8 + L * 8 + b.n_groups * S * 8 + n_seg * S * 8, L * S * 3 / FP64_OPS_PER_S * 1e3,
        time_ms(lambda: torch.zeros((n_seg, S), dtype=torch.float64, device=DEVICE).index_add_(
            0, seg_t, d2), reps=7), "index_add_ (of d * d computed ahead)")
    del rate, part, d, d2, w, nb, sl, words, nbits, slots
    torch.cuda.empty_cache()


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
    log(f"host: {host_speed()}")

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
    compare_k3_steps(walks)
    compare_quantile_grid()
    compare_query(corpus.query_probe_corpus(), "probes")
    compare_query(corpus.query_probe_corpus(tiered=True), "two-tier")
    compare_query(corpus.query_probe_corpus(n_real=61, n_lanes=67, seed=5), "67 lanes")
    compare_grouped_chunks()
    compare_long_lanes()
    compare_expr_kernels()
    compare_quantile_chunks()
    compare_family_kernels()
    compare_graphite_kernels()
    enc_probes = corpus.encode_probe_series()
    ts_w, vs_w = corpus.gen_grids(64, N_DP)
    walks_w = [(ts_w[i].tolist(), vs_w[i].tolist(), corpus.START) for i in range(64)]
    compare_encode(enc_probes, "probes")
    for lanes in (1, 7, 33, 129):
        compare_encode((enc_probes + walks_w)[:lanes], f"{lanes} lanes")
    compare_pack_edges()
    compare_elems(corpus.elem_probe_batches(), "probes")
    compare_elems(corpus.elem_probe_batches(n=4096, n_batches=3, seed=6), "dense")
    compare_padded_quantiles()
    compare_tiles(walks)
    compare_mesh_kernels()
    log(f"parity phases done at {time.time() - t_start:.1f} s")

    words, nbits, results = main_path(walks)
    rows = kernel_times(words, nbits, results["MEAN"]["datapoints"], walks)
    del words, nbits
    torch.cuda.empty_cache()
    log(f"read main phase done at {time.time() - t_start:.1f} s; peak device memory "
        f"{torch.cuda.max_memory_allocated()} B")
    m_results, rows_m = {}, {}
    mesh_read_main(walks, m_results)
    torch.cuda.empty_cache()
    log(f"mesh read phase done at {time.time() - t_start:.1f} s")
    fc, q_inputs, q_results = query_main(Q_SERIES)
    rows_q = query_kernel_times(fc.batch, q_inputs)
    del q_inputs
    torch.cuda.empty_cache()
    log(f"query main phase done at {time.time() - t_start:.1f} s; peak device memory "
        f"{torch.cuda.max_memory_allocated()} B")
    shapes, x_results = expr_main(fc)
    rows_q.update(expr_kernel_times(fc.batch, shapes))
    del shapes
    torch.cuda.empty_cache()
    f_shapes, f_results = family_main(fc)
    rows_q.update(family_kernel_times(fc, f_shapes))
    log(f"family phase done at {time.time() - t_start:.1f} s")
    x_results.update(f_results)
    del f_shapes
    torch.cuda.empty_cache()
    g_shapes, g_results = graphite_main(fc)
    rows_q.update(graphite_kernel_times(g_shapes))
    log(f"graphite phase done at {time.time() - t_start:.1f} s")
    g_launch = {}
    for r in g_results.values():
        for kernel, n in r["launches"].items():
            g_launch[kernel] = g_launch.get(kernel, 0) + n
    x_results.update(g_results)
    mesh_query_main(fc, m_results, rows_m)
    log(f"mesh query phase done at {time.time() - t_start:.1f} s; peak device memory "
        f"{torch.cuda.max_memory_allocated()} B")
    del g_shapes, fc
    torch.cuda.empty_cache()
    log(f"expr main phase done at {time.time() - t_start:.1f} s; peak device memory "
        f"{torch.cuda.max_memory_allocated()} B")
    x_launch = {}
    for r in x_results.values():
        for kernel, n in r["launches"].items():
            x_launch[kernel] = x_launch.get(kernel, 0) + n
    log(json.dumps({"expr_end_to_end": {name: {k: r[k] for k in ("ms", "wall_ms", "rows")}
                                        for name, r in x_results.items()},
                    "card": name_power}))
    q_launch = {}
    for r in q_results.values():
        for kernel, n in r["launches"].items():
            q_launch[kernel] = q_launch.get(kernel, 0) + n
    e2e_q = {name: {k: r[k] for k in ("ms", "wall_ms", "series_per_s", "series_per_s_wall")}
             for name, r in q_results.items()}
    log(json.dumps({"query_end_to_end": e2e_q, "card": name_power}))

    rows_w = {}
    pool, batch, r_rollup = rollup_main()
    slot_kernel_times(pool, batch, rows_w)
    del pool, batch
    torch.cuda.empty_cache()
    r_timer = timer_main(rows_w)
    r_agg = aggregator_main()
    r_enc = encode_main(rows_w)
    mesh_ingest_main(m_results)
    log(f"mesh ingest phase done at {time.time() - t_start:.1f} s")
    log(json.dumps({"mesh_end_to_end": {name: {k: v for k, v in r.items() if k != "launches"}
                                        for name, r in m_results.items()},
                    "card": name_power}))
    m_launch = {}
    for r in m_results.values():
        for kernel, n in r["launches"].items():
            m_launch[kernel] = m_launch.get(kernel, 0) + n
    log(f"write phases done at {time.time() - t_start:.1f} s; peak device memory "
        f"{torch.cuda.max_memory_allocated()} B")
    r_store, unique_streams, b0 = storage_main()
    tiles_kernel_times(unique_streams, b0, rows_w)
    log(f"storage phases done at {time.time() - t_start:.1f} s; peak device memory "
        f"{torch.cuda.max_memory_allocated()} B")
    log(json.dumps({"storage_end_to_end": {
        "n_series": r_store["n_series"],
        "stages": {k: {f: v[f] for f in ("wall_ms", "kernel_ms", "copy_ms")}
                   for k, v in r_store["stages"].items()}}, "card": name_power}))
    log(json.dumps({"write_end_to_end": {
        "rollup": {k: v for k, v in r_rollup.items() if k != "launches"},
        "config2": {k: v for k, v in r_agg.items() if k != "launches"},
        "timer_quantiles_wall_ms": {k: v["wall_ms"] for k, v in r_timer.items()},
        "encode": {k: v for k, v in r_enc.items() if "launches" not in k}},
        "card": name_power}))

    k2 = results["MEAN"]["launches"].get("decode_downsample_fused", 0)
    k2f = results["STDEV"]["launches"].get("decode_downsample_fused", 0)
    k3 = results["P99"]["launches"].get("decode_batched", 0)
    k4 = results["P99"]["launches"].get("window_quantiles", 0)
    k3q = q_launch.get("decode_batched", 0)
    k3s = r_store["launches"].get("decode_batched", 0)
    t1 = r_store["launches"].get("aggregate_tiles", 0)
    src = "m3_tpu_torch/csrc/"
    qsrc = "m3_tpu/models/query_pipeline.py:"
    kernels = [
        # K1 is the __device__ step inside K2 and K3: it launches with them,
        # and its time is that of K2 in the MEAN configuration (decode only).
        dict(name="decode_step", source=src + "m3tsz_decode.cu",
             replaces="m3_tpu/ops/m3tsz_decode.py:405", launches=k2 + k2f + k3 + k3q + k3s + t1,
             max_abs_err=max(ERRORS["decode_downsample_fused"], ERRORS["decode_batched"]),
             **rows["decode_downsample_fused"]),
        dict(name="decode_downsample_fused", source=src + "m3tsz_decode.cu",
             replaces="m3_tpu/ops/m3tsz_decode.py:488", launches=k2,
             max_abs_err=ERRORS["decode_downsample_fused"], **rows["decode_downsample_fused"]),
        dict(name="decode_downsample_fused[full_agg]", source=src + "m3tsz_decode.cu",
             replaces="m3_tpu/ops/m3tsz_decode.py:488", launches=k2f,
             max_abs_err=ERRORS["decode_downsample_fused[full_agg]"],
             **rows["decode_downsample_fused[full_agg]"]),
        # K3 on the read path's P99 and on the storage phase's cold fetch
        dict(name="decode_batched", source=src + "m3tsz_decode.cu",
             replaces="m3_tpu/ops/m3tsz_decode.py:440", launches=k3 + k3s,
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
        dict(name="query_minmax", source=src + "query_temporal.cu", replaces=qsrc + "205",
             launches=x_launch.get("query_minmax", 0), max_abs_err=ERRORS["query_minmax"],
             **rows_q["query_minmax"]),
        dict(name="query_quantile", source=src + "query_select.cu", replaces=qsrc + "871",
             launches=x_launch.get("query_quantile", 0), max_abs_err=ERRORS["query_quantile"],
             **rows_q["query_quantile"]),
        dict(name="query_topk", source=src + "query_select.cu",
             replaces="m3_tpu/ops/lane_topk.py:33", launches=x_launch.get("query_topk", 0),
             max_abs_err=ERRORS["query_topk"], **rows_q["query_topk"]),
        dict(name="histo_quantile", source=src + "histo_quantile.cu",
             replaces="m3_tpu/ops/histo_quantile.py:30",
             launches=x_launch.get("histo_quantile", 0), max_abs_err=ERRORS["histo_quantile"],
             **rows_q["histo_quantile"]),
        # QK3's further op codes: the same temporal_kernel, counted apart
        dict(name="query_changes", source=src + "query_temporal.cu", replaces=qsrc + "415",
             launches=x_launch.get("query_changes", 0), max_abs_err=ERRORS["query_changes"],
             **rows_q["query_changes"]),
        dict(name="query_linreg", source=src + "query_temporal.cu", replaces=qsrc + "437",
             launches=x_launch.get("query_linreg", 0), max_abs_err=ERRORS["query_linreg"],
             **rows_q["query_linreg"]),
        dict(name="query_stdvar", source=src + "query_temporal.cu", replaces=qsrc + "344",
             launches=x_launch.get("query_stdvar", 0), max_abs_err=ERRORS["query_stdvar"],
             **rows_q["query_stdvar"]),
        dict(name="query_holt_winters", source=src + "query_temporal.cu", replaces=qsrc + "540",
             launches=x_launch.get("query_holt_winters", 0),
             max_abs_err=ERRORS["query_holt_winters"], **rows_q["query_holt_winters"]),
        dict(name="query_quantile_window", source=src + "query_select.cu", replaces=qsrc + "648",
             launches=x_launch.get("query_quantile_window", 0),
             max_abs_err=ERRORS["query_quantile_window"], **rows_q["query_quantile_window"]),
        dict(name="subq_pack", source=src + "query_merge.cu", replaces=qsrc + "1604",
             launches=x_launch.get("subq_pack", 0), max_abs_err=ERRORS["subq_pack"],
             **rows_q["subq_pack"]),
        # QK4 again, on the graphite path: its NaN-reductions
        dict(name="query_grouped[graphite]", source=src + "query_grouped.cu",
             replaces=qsrc + "1216", launches=g_launch.get("query_grouped", 0),
             max_abs_err=ERRORS["query_grouped[graphite]"], **rows_q["query_grouped[graphite]"]),
        # GK2's two forms: one source, two kernels, counted apart
        dict(name="graphite_percentile", source=src + "query_select.cu", replaces=qsrc + "1280",
             launches=x_launch.get("graphite_percentile", 0),
             max_abs_err=ERRORS["graphite_percentile"], **rows_q["graphite_percentile"]),
        dict(name="graphite_percentile_rows", source=src + "query_select.cu",
             replaces=qsrc + "1434", launches=x_launch.get("graphite_percentile_rows", 0),
             max_abs_err=ERRORS["graphite_percentile_rows"],
             **rows_q["graphite_percentile_rows"]),
        dict(name="graphite_row", source=src + "graphite_call.cu", replaces=qsrc + "1289",
             launches=x_launch.get("graphite_row", 0), max_abs_err=ERRORS["graphite_row"],
             **rows_q["graphite_row"]),
        dict(name="pack_encode", source=src + "m3tsz_encode.cu",
             replaces="m3_tpu/ops/m3tsz_encode.py:443",
             launches=r_enc["launches"].get("pack_encode", 0)
             + r_enc["seal_launches"].get("pack_encode", 0)
             + r_store["launches"].get("pack_encode", 0),
             max_abs_err=ERRORS["pack_encode"], **rows_w["pack_encode"]),
        dict(name="scatter_update", source=src + "aggregator_elems.cu",
             replaces="m3_tpu/aggregator/elems.py:79",
             launches=r_rollup["launches"].get("scatter_update", 0)
             + r_agg["launches"].get("scatter_update", 0),
             max_abs_err=ERRORS["scatter_update"], **rows_w["scatter_update"]),
        dict(name="gather_reset", source=src + "aggregator_elems.cu",
             replaces="m3_tpu/aggregator/elems.py:112",
             launches=r_rollup["launches"].get("gather_reset", 0)
             + r_agg["launches"].get("gather_reset", 0),
             max_abs_err=ERRORS["gather_reset"], **rows_w["gather_reset"]),
        dict(name="padded_quantiles", source=src + "aggregator_elems.cu",
             replaces="m3_tpu/aggregator/elems.py:131",
             launches=sum(r["launches"].get("padded_quantiles", 0) for r in r_timer.values()),
             max_abs_err=ERRORS["padded_quantiles"], **rows_w["padded_quantiles"]),
        # T1 at the storage phase's 5m tiles (its 1m time is printed beside it)
        dict(name="aggregate_tiles", source=src + "m3tsz_decode.cu",
             replaces="m3_tpu/ops/tiles.py:34", launches=t1,
             max_abs_err=ERRORS["aggregate_tiles"], **rows_w["aggregate_tiles[5m]"]),
        # MK1 at the sharded group-by's sum stack (its min/max times are printed)
        dict(name="mesh_reduce", source=src + "mesh_reduce.cu",
             replaces="m3_tpu/parallel/mesh.py:72", launches=m_launch.get("mesh_reduce", 0),
             max_abs_err=ERRORS["mesh_reduce"], **rows_m["mesh_reduce[sum]"]),
        # QK4's sqdev op code: the sharded stddev/stdvar's second pass
        dict(name="query_sqdev", source=src + "query_grouped.cu", replaces=qsrc + "814",
             launches=m_launch.get("query_sqdev", 0), max_abs_err=ERRORS["query_sqdev"],
             **rows_m["query_sqdev"]),
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
