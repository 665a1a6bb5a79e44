"""Split A1a (``aggregator/elems.py:scatter_update``) and A1b
(``gather_reset``) of a checkout whose pool is lane-major (flat = lane * W +
slot) and whose A1a always groups its batch (``group_by_slot``), into their
parts on one CUDA card.

Shapes, one window of 8 (slot 3), one sample a lane, values from seed 16:
- rollup: 1,000,000 samples into a pool of 1,000,000 lanes x 8 windows,
  then a flush of those 1,000,000 slots;
- config 2: 100,000 samples into the 131,072 x 8 pool that ``Aggregator``
  grows to, then a flush of those 100,000 slots.

Variants, each on the checkout's own kernels (flat indices into eight
field arrays, or into one array through strided field pointers):
- lane-major (the parent's pool): flat = lane * 8 + slot;
- slot-major: flat = slot * capacity + lane;
- a 64-byte record a slot, records slot-major: one [capacity * 8, 8]
  array, the kernels handed field k's pointer at byte 8 k and flats scaled
  by 8;
- A1a without ``group_by_slot``: the grouping of a batch in slot order is
  the identity (order = arange, one segment a sample), so the kernel alone
  on that grouping is A1a with the sort taken away;
- the wrappers' host syncs alone: ``_check_slots`` (two reads), the
  gather's ``min``/``max`` and check, the pool's ``int(dropped)``, each on
  an idle card.
Times: kernels by device time alone (the stream kept busy ahead) and
between events, median of 7; the grouping glue and whole wrapper calls
between events (they sync); host syncs on the host clock. The config 2
pool's touched slots (6.4 MB) stay in the 50 MB L2 across repeats: warm.

    python3 tools/a1_split.py ROOT

ROOT is such a checkout (a ``git archive`` of the tree before the
slot-major pool). Prints the card's name and power limit, then one JSON
line.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

SHAPES = {"rollup": (1_000_000, 1_000_000), "config2": (131_072, 100_000)}
W, SLOT = 8, 3
SEC = 10**9
T = 1_700_000_000 * SEC  # a 10s-aligned window start


def _time_ms(torch, fn, reps: int = 7) -> float:
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def _device_ms(torch, fn, reps: int = 7) -> float:
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(4_000_000)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def _host_ms(torch, fn, reps: int = 7) -> float:
    times = []
    for _ in range(reps + 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times[1:])


def _kernel(torch, fn) -> dict:
    return {"device_ms": _device_ms(torch, fn), "ms": _time_ms(torch, fn)}


def split(root: str) -> dict:
    sys.path.insert(0, root)
    import numpy as np
    import torch

    from m3_tpu_torch.aggregator import elems

    if not Path(elems.__file__).resolve().is_relative_to(Path(root).resolve()):
        raise RuntimeError(f"imported {elems.__file__}, not from {root}")
    lib = elems._lib()
    I64, F64 = torch.int64, torch.float64

    def stream():
        return torch.cuda.current_stream().cuda_stream

    def fields(n):
        return elems.ElemState(*(torch.full((n,), e, dtype=dt, device="cuda")
                                 for (_, e), dt in zip(elems._EMPTY_OF, elems._DTYPES)))

    def record(n):
        rec = torch.empty((n, 8), dtype=I64, device="cuda")
        for k, ((_, e), dt) in enumerate(zip(elems._EMPTY_OF, elems._DTYPES)):
            rec[:, k] = int(e) if dt == I64 else int(torch.tensor(e, dtype=F64).view(I64))
        return rec

    out = {}
    for shape, (cap, n) in SHAPES.items():
        rng = np.random.default_rng(16)
        lanes = torch.arange(n, dtype=I64, device="cuda")
        start = torch.full((n,), T, dtype=I64, device="cuda")
        times = start + 5 * SEC
        values = torch.from_numpy(np.round(rng.random(n) * 100, 2)).cuda()
        res = {}
        layouts = {"lane-major": lanes * W + SLOT, "slot-major": SLOT * cap + lanes,
                   "record": 8 * (SLOT * cap + lanes)}
        for name, flat in layouts.items():
            if name == "record":
                rec = record(cap * W)
                ptrs = np.asarray([rec.data_ptr() + 8 * k for k in range(8)], dtype=np.uint64)
                state = None
            else:
                state = fields(cap * W)
                ptrs = elems._pointers(state)
            order, slots, offsets = elems.group_by_slot(flat)
            dropped = torch.zeros((), dtype=I64, device="cuda")

            def scatter():
                rc = lib.m3_scatter_update(ptrs.ctypes.data, slots.data_ptr(), offsets.data_ptr(),
                                           len(slots), order.data_ptr(), start.data_ptr(),
                                           times.data_ptr(), values.data_ptr(),
                                           dropped.data_ptr(), stream())
                if rc:
                    raise RuntimeError(f"scatter_update: {rc}")

            gout = fields(n)
            out_ptrs = elems._pointers(gout)

            def gather():
                rc = lib.m3_gather_reset(ptrs.ctypes.data, flat.data_ptr(), n, 1,
                                         out_ptrs.ctypes.data, stream())
                if rc:
                    raise RuntimeError(f"gather_reset: {rc}")

            scatter()
            gather()
            torch.cuda.synchronize()
            if not (torch.equal(gout.count, torch.ones_like(gout.count))
                    and torch.equal(gout.sum, values) and torch.equal(gout.win_start, start)):
                raise RuntimeError(f"{shape} {name}: the flush did not return the samples")
            r = {"scatter_kernel": _kernel(torch, scatter), "gather_kernel": _kernel(torch, gather)}
            if state is not None:
                r["glue_ms"] = _time_ms(torch, lambda: elems.group_by_slot(flat))
                r["scatter_call_ms"] = _time_ms(
                    torch, lambda: elems.scatter_update(state, flat, start, times, values))
                r["gather_call_ms"] = _time_ms(torch, lambda: elems.gather_reset(state, flat))
            res[name] = r
            del state, gout
            torch.cuda.empty_cache()
        state = fields(cap * W)
        flat = layouts["slot-major"]
        dropped = torch.zeros((), dtype=I64, device="cuda")
        res["host_syncs_ms"] = {
            "check_slots (2 reads)": _host_ms(
                torch, lambda: elems._check_slots(flat[0], flat[-1], state)),
            "gather min/max + check": _host_ms(
                torch, lambda: elems._check_slots(flat.min(), flat.max(), state)),
            "int(dropped)": _host_ms(torch, lambda: int(dropped)),
        }
        out[shape] = res
        del state
        torch.cuda.empty_cache()
    return out


def main(argv: list[str]) -> int:
    if len(argv) != 1:
        print(__doc__, file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print(card, flush=True)
    print(json.dumps({"root": argv[0], "card": card, **split(argv[0])}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
