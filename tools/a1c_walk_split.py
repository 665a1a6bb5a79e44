"""Split the time of A1c's first design into its sort and its walk.

That design (``csrc/aggregator_elems.cu`` up to the tiered rewrite) runs one
block a row: a bitonic sort of the row's (key, column) pairs, then thread 0
alone walks the sorted row.  This script copies ROOT's ``m3_tpu_torch`` to
``ROOT/build/a1c_walk_split/``, turns the walk off there (its condition gets
``&& F < 0``, which no launch meets, so the sort stays and nothing is
written), and times ``padded_quantiles`` in both at the timer shapes
(100,000 x 10 unit weights, 64 x 4,096 weighted), one process each, CUDA
events, median of 7.  The walk's time is the difference.  ROOT's result is
held against the plain version first; the copy's result is not read.

    python3 tools/a1c_walk_split.py ROOT

Prints the card's name and power limit, then one JSON line.  A ROOT whose
A1c has no such walk is refused.
"""

from __future__ import annotations

import json
import shutil
import subprocess
import sys
from pathlib import Path

WALK = "    if (tid == 0) {\n      double total = 0.0;"
SHAPES = (("timer", 100_000, 10), ("hot", 64, 4096))
QS = (0.5, 0.9, 0.95, 0.99, 0.999)


def child(root: str, check: bool) -> dict:
    sys.path.insert(0, root)
    import numpy as np
    import torch

    from m3_tpu_torch.aggregator import elems
    from m3_tpu_torch.models import corpus

    if not Path(elems.__file__).resolve().is_relative_to(Path(root).resolve()):
        raise RuntimeError(f"imported {elems.__file__}, not from {root}")
    out = {}
    for tag, rows, k in SHAPES:
        if tag == "timer":
            v = corpus.timer_windows(rows, k)[2].reshape(rows, k)
            w = np.ones((rows, k))
        else:
            v, w = corpus.long_quantile_rows(rows, k)
        tv, tw = torch.from_numpy(v).cuda(), torch.from_numpy(w).cuda()
        fn = lambda: elems.padded_quantiles(tv, tw, QS)  # noqa: E731
        got = fn()
        if check and not torch.equal(got.view(torch.int64),
                                     elems.padded_quantiles_plain(tv, tw, QS).view(torch.int64)):
            raise RuntimeError(f"{tag}: kernel and plain version differ")
        torch.cuda.synchronize()
        times = []
        for _ in range(7):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        out[tag] = sorted(times)[3]
    return out


def main(argv: list[str]) -> int:
    if len(argv) == 3 and argv[0] == "--child":
        print(json.dumps(child(argv[1], argv[2] == "check")), flush=True)
        return 0
    if len(argv) != 1:
        print(__doc__, file=sys.stderr)
        return 2
    root = Path(argv[0]).resolve()
    src = (root / "m3_tpu_torch/csrc/aggregator_elems.cu").read_text()
    if src.count(WALK) != 1:
        print(f"{root}: A1c has no single-thread walk to turn off", file=sys.stderr)
        return 2
    copy = root / "build" / "a1c_walk_split"
    shutil.rmtree(copy, ignore_errors=True)
    shutil.copytree(root / "m3_tpu_torch", copy / "m3_tpu_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    (copy / "m3_tpu_torch/csrc/aggregator_elems.cu").write_text(
        src.replace(WALK, WALK.replace("(tid == 0)", "(tid == 0 && F < 0)")))
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print(card, flush=True)
    res = {}
    for name, where, check in (("full", root, "check"), ("sort_only", copy, "none")):
        run = subprocess.run([sys.executable, __file__, "--child", str(where), check],
                             capture_output=True, text=True, timeout=600)
        if run.returncode:
            print(f"{where}: exit {run.returncode}\n{run.stderr[-4000:]}", file=sys.stderr)
            return 1
        res[name] = json.loads(run.stdout.strip().splitlines()[-1])
    res["walk"] = {tag: res["full"][tag] - res["sort_only"][tag] for tag, _, _ in SHAPES}
    print(json.dumps(res), flush=True)
    shutil.rmtree(copy, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
