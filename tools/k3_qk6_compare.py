"""Time the port's batched decode (K3, ``ops/m3tsz_decode.py:decode_batched``),
its quantile by (QK6, ``ops/query_grouped.py:grouped_quantile``), the
16-query megabatch and A1c (``aggregator/elems.py:padded_quantiles``) of one
or more checkouts on one CUDA card, one process a checkout, in the order
given.  Each checkout builds its kernels into its own ``build/``.

For each checkout, on data made from seeds:
- K3 at the read path's shape: 2,000 seed-42 walk streams of 360 points
  tiled to 1,000,000 lanes; K2 (``decode_downsample_fused``, MEAN: the same
  decode, few bytes written) beside it;
- K3 at the fan-out read's shape: 600 walk streams of 720 points tiled to
  150,000 lanes, with ``flag_truncation``;
- QK6 at the quantile-by shape: [65,536 lanes x 512 steps], 50,000 lanes
  of the 5m rates of integer counters (30 Poisson increments of a rate
  drawn per lane, over 300 s: multiples of 1/300, so long runs of ties;
  2% NaN) in 100 groups of interleaved lanes, 15,536 all-NaN padding lanes
  on group 0, phi 0.9; ``torch.sort`` along the lanes beside it, and the
  device time of each of one call's launches (``torch.profiler``);
- the megabatch: 16 x sum by (job)(sum_over_time(..)) / sum by
  (job)(count_over_time(..)) (``corpus.megabatch_query``) through
  ``device_expr_pipeline_batched``, each slice held against its solo call;
  beside its time, one call's wall time on the host clock and the sum of
  its launches' device times (``torch.profiler``);
- A1c on the timer windows' values (100,000 x 10, unit weights) and on
  64 hot rows of 4,096 weighted points;
- the host: its cores and the median time of a fixed Python loop.
Each kernel's outputs are held against the plain version's (K3 on the
unique lanes), bit for bit, before it is timed (CUDA events, median of 7).

    python3 tools/k3_qk6_compare.py ROOT [ROOT ...]

To compare two checkouts on one card, name them as parent, change, change,
parent.  Prints the card's name and power limit, then one JSON line a run.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

READ_UNIQUE, READ_LANES, READ_DP = 2000, 1_000_000, 360
QUERY_UNIQUE, QUERY_LANES, QUERY_DP = 600, 150_000, 720
Q_REAL, Q_LANES, Q_STEPS, Q_GROUPS, Q_PHI = 50_000, 65_536, 512, 100, 0.9
TIMER_WINDOWS, TIMER_PER_WINDOW, TIMER_HOT = 100_000, 10, (64, 4096)
TIMER_QS = (0.5, 0.9, 0.95, 0.99, 0.999)


def _time_ms(torch, fn, reps: int = 7) -> float:
    """Median CUDA-event time of fn (ms), after one warm-up call."""
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


def _same(torch, a, b, what: str) -> None:
    if a.dtype.is_floating_point:
        an, bn = torch.isnan(a), torch.isnan(b)
        ok = torch.equal(an, bn) and bool(((a.view(torch.int64) == b.view(torch.int64)) | an).all())
    else:
        ok = torch.equal(a, b)
    if not ok:
        raise RuntimeError(f"{what}: kernel and reference differ")


def _k3_inputs(np, torch, corpus, pack_streams, n_unique: int, n_lanes: int, n_dp: int):
    words, nbits = pack_streams(corpus.walk_streams(n_unique, n_dp))
    reps = -(-n_lanes // n_unique)
    words = torch.from_numpy(np.tile(words, (reps, 1))[:n_lanes]).view(torch.int32).cuda()
    nbits = torch.from_numpy(np.tile(nbits, reps)[:n_lanes]).to(torch.int32).cuda()
    return words, nbits


def _device_us(torch, fn) -> list[list]:
    """The device time (us) of each launch of one call of fn."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return [[e.name.replace("(anonymous namespace)::", "").split("(")[0].strip(),
             round(getattr(e, "device_time", None) or e.cuda_time, 1)]
            for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]


def _host_loop_ms() -> float:
    """Median time of a fixed Python loop (7 runs): the host's speed."""
    times = []
    for _ in range(7):
        t0 = time.perf_counter()
        sum(i * i for i in range(200_000))
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def child(root: str) -> dict:
    sys.path.insert(0, root)
    import numpy as np
    import torch

    from m3_tpu_torch.aggregator import elems
    from m3_tpu_torch.models import corpus
    from m3_tpu_torch.models import query_pipeline as qp
    from m3_tpu_torch.ops import query_grouped
    from m3_tpu_torch.ops import m3tsz_decode as dec
    from m3_tpu_torch.ops.bitstream import pack_streams

    if not Path(dec.__file__).resolve().is_relative_to(Path(root).resolve()):
        raise RuntimeError(f"imported {dec.__file__}, not from {root}")

    res = {"root": root, "host": {"cores": os.cpu_count(), "loop_ms": _host_loop_ms()}}

    def k3_case(name, n_unique, n_lanes, n_dp, flag):
        words, nbits = _k3_inputs(np, torch, corpus, pack_streams, n_unique, n_lanes, n_dp)
        fn = lambda: dec.decode_batched(words, nbits, n_dp, flag_truncation=flag)  # noqa: E731
        got = fn()
        want = dec.decode_batched_plain(words[:n_unique], nbits[:n_unique], n_dp,
                                        flag_truncation=flag)
        reps = n_lanes // n_unique
        for field, g, w in zip(("ts", "vs", "valid", "count", "error"), got, want):
            _same(torch, g[:n_unique], w, f"{name} K3.{field}")
            _same(torch, g[:reps * n_unique].view(reps, n_unique, *g.shape[1:]),
                  g[:n_unique].expand(reps, *g[:n_unique].shape), f"{name} K3.{field} tiled")
        del want
        out = {"ms": _time_ms(torch, fn), "datapoints": int(got[3].sum())}
        del got
        if name == "read":
            k2 = lambda: dec.decode_downsample_fused(words, nbits, n_dp, 6)  # noqa: E731
            out["k2_simple_ms"] = _time_ms(torch, k2)
        torch.cuda.empty_cache()
        return out

    res["k3_read"] = k3_case("read", READ_UNIQUE, READ_LANES, READ_DP, False)
    res["k3_query"] = k3_case("query", QUERY_UNIQUE, QUERY_LANES, QUERY_DP, True)

    rng = np.random.default_rng(7)
    x = np.full((Q_LANES, Q_STEPS), np.nan)
    lam = rng.gamma(2.0, 1.0, (Q_REAL, 1)) * 30
    x[:Q_REAL] = rng.poisson(lam, (Q_REAL, Q_STEPS)) / 300.0
    x[:Q_REAL][rng.random((Q_REAL, Q_STEPS)) < 0.02] = np.nan
    groups = np.zeros(Q_LANES, dtype=np.int64)
    groups[:Q_REAL] = np.arange(Q_REAL) % Q_GROUPS
    xt = torch.from_numpy(x).cuda()
    index = query_grouped.group_index(groups, Q_GROUPS, xt.device)
    fn = lambda: query_grouped.grouped_quantile(xt, groups, Q_GROUPS, Q_PHI, index)  # noqa: E731
    want = query_grouped.grouped_quantile_plain(xt, torch.from_numpy(groups).cuda(), Q_GROUPS,
                                                Q_PHI)
    _same(torch, fn(), want, "QK6")
    res["qk6"] = {"ms": _time_ms(torch, fn),
                  "sort_ms": _time_ms(torch, lambda: torch.sort(xt, dim=0, stable=True)),
                  "launches_us": _device_us(torch, fn)}
    del xt, want
    torch.cuda.empty_cache()

    queries = [corpus.megabatch_query(seed) for seed in range(16)]
    plan = queries[0][0]
    inputs = corpus.expr_inputs_from_numpy(*corpus.stack_queries([q[1] for q in queries]), "cuda")
    fn = lambda: qp.device_expr_pipeline_batched(plan, *inputs)  # noqa: E731
    got = fn()[0]
    for q, (_, qin) in enumerate(queries):
        solo = qp.device_expr_pipeline(plan, *corpus.expr_inputs_from_numpy(*qin, "cuda"))[0]
        _same(torch, got[q], solo, f"megabatch slice {q}")
    walls = []
    for _ in range(7):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    launches = _device_us(torch, fn)
    res["megabatch"] = {"ms": _time_ms(torch, fn), "wall_ms": statistics.median(walls),
                        "device_ms": sum(us for _, us in launches) / 1e3,
                        "launches": len(launches)}

    values = corpus.timer_windows(TIMER_WINDOWS, TIMER_PER_WINDOW)[2]
    for tag, (v, w) in (("a1c_timer", (values.reshape(TIMER_WINDOWS, TIMER_PER_WINDOW),
                                       np.ones((TIMER_WINDOWS, TIMER_PER_WINDOW)))),
                        ("a1c_hot", corpus.long_quantile_rows(*TIMER_HOT))):
        tv, tw = torch.from_numpy(v).cuda(), torch.from_numpy(w).cuda()
        fn = lambda: elems.padded_quantiles(tv, tw, TIMER_QS)  # noqa: E731
        _same(torch, fn(), elems.padded_quantiles_plain(tv, tw, TIMER_QS), tag)
        res[tag] = {"ms": _time_ms(torch, fn)}
    return res


def main(argv: list[str]) -> int:
    if len(argv) == 2 and argv[0] == "--child":
        print(json.dumps(child(argv[1])), flush=True)
        return 0
    if not argv:
        print(__doc__, file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print(card, flush=True)
    rc = 0
    for root in argv:
        out = subprocess.run([sys.executable, __file__, "--child", root],
                             capture_output=True, text=True, timeout=900)
        if out.returncode:
            print(f"{root}: exit {out.returncode}\n{out.stderr[-4000:]}", file=sys.stderr)
            rc = 1
        else:
            print(out.stdout.strip().splitlines()[-1], flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
