"""Time the port's cross-shard reduce (MK1, ``m3_tpu_torch/ops/mesh_reduce.py``)
of one or more checkouts on one CUDA card, one process a checkout, in the
order given.

For each checkout, at the sharded group-by's stack (8 shards x 35,500 f64,
from a seed): the CUDA-event time of one call on an idle stream (the
wrapper's host work inside the window), the device time with the stream
kept busy ahead (the kernel alone), and the host time a call over 2,000
calls, for sum, min and max beside ``torch.sum``/``amin``/``amax``; and,
where the checkout has ``mesh_reduce_batch``, a batch of two stacks against
two single calls.  Each checkout builds its kernel into its own ``build/``.

    python3 tools/mk1_split.py ROOT [ROOT ...]

To compare two checkouts on one card, name them as parent, change, change,
parent.  Prints the card's name and power limit, then one JSON line a run.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

SHARDS, N, SEED = 8, 35_500, 11


def _time_ms(torch, fn, reps: int = 21) -> float:
    """Median CUDA-event time of fn on an idle stream (ms)."""
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


def _device_ms(torch, fn, reps: int = 21) -> float:
    """Median device time of fn (ms): ``torch.cuda._sleep`` keeps the stream
    busy while the host enqueues the events and fn's launches."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(2_000_000)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def _host_us(torch, fn, calls: int = 2000) -> float:
    """Host time of one call of fn (us) over `calls` calls in a row."""
    for _ in range(20):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    elapsed = time.perf_counter() - t0
    torch.cuda.synchronize()
    return elapsed / calls * 1e6


def child(root: str) -> dict:
    sys.path.insert(0, root)
    import torch

    from m3_tpu_torch.ops import mesh_reduce as mr

    if not Path(mr.__file__).resolve().is_relative_to(Path(root).resolve()):
        raise RuntimeError(f"imported {mr.__file__}, not from {root}")
    gen = torch.Generator().manual_seed(SEED)
    part = torch.randn((SHARDS, N), generator=gen, dtype=torch.float64).cuda()
    counts = torch.randint(0, 9, (SHARDS, N), generator=gen).to(torch.float64).cuda()
    res = {"root": root}
    for op, lib in (("sum", torch.sum), ("min", torch.amin), ("max", torch.amax)):
        fn = lambda: mr.mesh_reduce(part, op)  # noqa: E731
        if not torch.equal(fn(), mr.mesh_reduce_plain(part, op)):
            raise RuntimeError(f"MK1 {op} differs from its plain version")
        res[op] = {"ms": _time_ms(torch, fn), "device_ms": _device_ms(torch, fn),
                   "host_us": _host_us(torch, fn),
                   "library_ms": _time_ms(torch, lambda: lib(part, dim=0)),
                   "library_device_ms": _device_ms(torch, lambda: lib(part, dim=0)),
                   "library_host_us": _host_us(torch, lambda: lib(part, dim=0))}
    two = lambda: [mr.mesh_reduce(x, "sum") for x in (counts, part)]  # noqa: E731
    res["two_singles"] = {"ms": _time_ms(torch, two), "device_ms": _device_ms(torch, two),
                          "host_us": _host_us(torch, two)}
    if hasattr(mr, "mesh_reduce_batch"):
        batch = lambda: mr.mesh_reduce_batch((counts, part), ("sum", "sum"))  # noqa: E731
        res["batch_of_two"] = {"ms": _time_ms(torch, batch), "device_ms": _device_ms(torch, batch),
                               "host_us": _host_us(torch, batch)}
    return res


def main(argv: list[str]) -> int:
    if len(argv) > 1 and argv[0] == "--child":
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
        out = subprocess.run([sys.executable, __file__, "--child", root], capture_output=True,
                             text=True, timeout=600)
        if out.returncode:
            print(f"{root}: exit {out.returncode}\n{out.stderr[-4000:]}", file=sys.stderr)
            rc = 1
        else:
            print(out.stdout.strip().splitlines()[-1], flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
