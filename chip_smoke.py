"""Chip smoke test: the PyTorch/CUDA port's read path on one NVIDIA GPU.

Run from the root of a checkout, on a machine with a CUDA device:

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:

1. card   — the device's name and power limit (nvidia-smi);
2. build  — compiles every kernel of ``m3_tpu_torch/csrc`` with nvcc;
3. parity — every kernel against its plain PyTorch version on the card,
   bit for bit, on seed-42 walks plus probe streams (error lanes, float
   mode, millisecond unit, NaN/+-Inf/-0.0, truncated and garbage streams,
   odd lane counts) and a quantile grid of NaNs, ties and signed zeros;
4. main   — the north-star read path: 1,000,000 series x 360 datapoints
   at 10s, window 6 (10s -> 1min), through ``decode_downsample`` for
   MEAN, STDEV and P99.  Launch counts are reset just before each
   aggregate is driven and read just after; every lane is checked
   against its unique lane, the unique lanes against the plain versions
   and a few against the scalar oracle.  Then each kernel is timed with
   CUDA events at these shapes beside its plain version, its bound and,
   for the quantile kernel, ``torch.sort``;
5. report — one JSON line listing the kernels, then the result line.

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
from m3_tpu_torch.models.read_pipeline import _SIMPLE_AGGS, decode_downsample, inputs_from_numpy
from m3_tpu_torch.ops import _build, m3tsz_scalar
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


# --- phase 4: the main path at full size -----------------------------------


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
    compare_decoders(corpus.probe_streams(N_DP, int_optimized=False) + corpus.golden_streams(),
                     "float mode", int_optimized=False)
    compare_decoders(corpus.ms_streams(256, N_DP), "millisecond unit", unit=MS)
    probes = corpus.probe_streams(N_DP)
    for lanes in (1, 7, 129):
        compare_decoders((probes + walks)[:lanes], f"{lanes} lanes")
    compare_quantile_grid()
    log(f"parity phase done at {time.time() - t_start:.1f} s")

    words, nbits, results = main_path(walks)
    rows = kernel_times(words, nbits, results["MEAN"]["datapoints"])
    log(f"main phase done at {time.time() - t_start:.1f} s; peak device memory "
        f"{torch.cuda.max_memory_allocated()} B")

    k2 = results["MEAN"]["launches"].get("decode_downsample_fused", 0)
    k2f = results["STDEV"]["launches"].get("decode_downsample_fused", 0)
    k3 = results["P99"]["launches"].get("decode_batched", 0)
    k4 = results["P99"]["launches"].get("window_quantiles", 0)
    src = "m3_tpu_torch/csrc/"
    kernels = [
        # K1 is the __device__ step inside K2 and K3: it launches with them,
        # and its time is that of K2 in the MEAN configuration (decode only).
        dict(name="decode_step", source=src + "m3tsz_decode.cu",
             replaces="m3_tpu/ops/m3tsz_decode.py:405", launches=k2 + k2f + k3,
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
        dict(name="window_quantiles", source=src + "window_quantiles.cu",
             replaces="m3_tpu/ops/downsample.py:166", launches=k4,
             max_abs_err=ERRORS["window_quantiles"], **rows["window_quantiles"]),
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
