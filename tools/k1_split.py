"""Split the time of K1, the M3TSZ decoder of ``csrc/m3tsz_decode.cu``, in
the design that loads five words a decoded point (``decode_step`` up to
its register bit reader).

This script copies ROOT's ``m3_tpu_torch`` to ``ROOT/build/k1_split/<variant>/``
once a variant and edits the copy's ``csrc/m3tsz_decode.cu`` only:

- ``words_in_registers``: the five words of the window stay in registers
  from one point to the next and are loaded again only when the cursor
  has crossed into another word (the same results; loads fall from 5 a
  point to 5 a word crossed, ~0.7 a point on the read path's walks);
- ``words_from_l1``: every lane decodes the stream of lane ``lane % 32``,
  so each warp decodes the first warp's 32 streams: the same five loads a
  point, all served from L1, with the same spread of streams in a warp
  (results differ, not read);
- ``mul_for_div``: the int streams' f64 division by 10^mult replaced by a
  multiplication (results differ, not read);
- ``k3_steps_8``: K3 stages 8 steps a lane instead of 16 (half the shared
  memory a block);
- ``blocks_12``: K2 and K3 compiled with ``__launch_bounds__(128, 12)``
  (registers capped for 12 blocks an SM) and K3 at 8 staged steps, so
  that its shared memory allows 12 blocks too.

It times K2 MEAN (``decode_downsample_fused``, window 6) and K3
(``decode_batched``) at the read path's shape (2,000 seed-42 walks of 360
points tiled to 1,000,000 lanes) in ROOT and in each copy, one process
each, by device time alone (the stream kept busy ahead, CUDA events,
median of 7), with each build's registers and blocks an SM
(``kernel_layout``) and its spill lines.  ROOT's results, and those of the
variants that keep them, are held bit for bit against the plain versions
first.

    python3 tools/k1_split.py ROOT

Prints the card's name and power limit, then one JSON line.  A ROOT whose
decoder is not the five-load design is refused.
"""

from __future__ import annotations

import json
import re
import shutil
import statistics
import subprocess
import sys
from pathlib import Path

N_UNIQUE, N_LANES, N_DP, WINDOW = 2000, 1_000_000, 360, 6

LOADS = ("  const uint64_t w01 = (load_word(row, W, base) << 32) | load_word(row, W, base + 1);\n"
         "  const uint64_t w23 = (load_word(row, W, base + 2) << 32) | load_word(row, W, base + 3);\n"
         "  const uint64_t w45 = load_word(row, W, base + 4) << 32;\n")
CACHED = ("  if (base != st.wbase) {\n"
          "    st.wbase = base;\n"
          "    st.w01 = (load_word(row, W, base) << 32) | load_word(row, W, base + 1);\n"
          "    st.w23 = (load_word(row, W, base + 2) << 32) | load_word(row, W, base + 3);\n"
          "    st.w45 = load_word(row, W, base + 4) << 32;\n"
          "  }\n"
          "  const uint64_t w01 = st.w01, w23 = st.w23, w45 = st.w45;\n")
STATE = "  int32_t sig, mult;\n};"
INIT = "  st.mult = 0;\n  return st;"
ROW = "const uint32_t* row = words + (size_t)(mine ? lane : first) * W;"
NBITS = "const int32_t nb = mine ? nbits[lane] : 0;"
DIV = "return (double)st.int_val / div.d[m];"
K3_STEPS = "constexpr int kK3Steps = 16;"
K2_BOUNDS = "__launch_bounds__(kThreads) decode_downsample_fused_kernel("
K3_BOUNDS = "__launch_bounds__(kThreads) decode_batched_kernel("

# variant -> (edits, results kept)
VARIANTS = {
    "words_in_registers": ([(LOADS, CACHED),
                            (STATE, "  int32_t sig, mult;\n  int32_t wbase;\n"
                                    "  uint64_t w01, w23, w45;\n};"),
                            (INIT, "  st.mult = 0;\n  st.wbase = -1;\n  st.w01 = st.w23 = "
                                   "st.w45 = 0;\n  return st;")], True),
    "words_from_l1": ([(ROW, "const uint32_t* row = words + (size_t)(mine ? lane % 32 : 0) * W;"),
                       (NBITS, "const int32_t nb = mine ? nbits[lane % 32] : 0;")], False),
    "mul_for_div": ([(DIV, "return (double)st.int_val * div.d[m];")], False),
    "k3_steps_8": ([(K3_STEPS, "constexpr int kK3Steps = 8;")], True),
    "blocks_12": ([(K3_STEPS, "constexpr int kK3Steps = 8;"),
                   (K2_BOUNDS, K2_BOUNDS.replace("(kThreads)", "(kThreads, 12)")),
                   (K3_BOUNDS, K3_BOUNDS.replace("(kThreads)", "(kThreads, 12)"))], True),
}
# how often each anchor appears in the five-load design
ANCHORS = {LOADS: 1, STATE: 1, INIT: 1, ROW: 3, NBITS: 3, DIV: 1, K3_STEPS: 1, K2_BOUNDS: 1,
           K3_BOUNDS: 1}


def _device_ms(torch, fn, reps: int = 7) -> float:
    """Median device time of fn alone (ms): ``torch.cuda._sleep`` keeps the
    stream busy while the host enqueues the events and fn's launch."""
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


def _same(torch, a, b, what: str) -> None:
    if a.dtype.is_floating_point:
        an, bn = torch.isnan(a), torch.isnan(b)
        ok = torch.equal(an, bn) and bool(((a.view(torch.int64) == b.view(torch.int64)) | an).all())
    else:
        ok = torch.equal(a, b)
    if not ok:
        raise RuntimeError(f"{what}: kernel and plain version differ")


def _spills(log: str) -> list[str]:
    """The ptxas lines of functions that spill, each after its name."""
    out, func = [], ""
    for ln in log.splitlines():
        if "Function properties for" in ln:
            func = ln.split("for", 1)[1].strip()
        nums = re.findall(r"(\d+) bytes spill", ln)
        if nums and any(int(n) for n in nums):
            out.append(f"{func}: {ln.strip()}")
    return out


def child(root: str, mode: str) -> dict:
    sys.path.insert(0, root)
    import numpy as np
    import torch

    from m3_tpu_torch.models import corpus
    from m3_tpu_torch.ops import _build
    from m3_tpu_torch.ops import m3tsz_decode as dec
    from m3_tpu_torch.ops.bitstream import pack_streams

    if not Path(dec.__file__).resolve().is_relative_to(Path(root).resolve()):
        raise RuntimeError(f"imported {dec.__file__}, not from {root}")
    _build.build_all(("m3tsz_decode",))
    if mode == "build":
        return {"spills": _spills(_build.BUILD_LOGS.get("m3tsz_decode", ""))}
    words, nbits = pack_streams(corpus.walk_streams(N_UNIQUE, N_DP))
    reps = -(-N_LANES // N_UNIQUE)
    tw = torch.from_numpy(np.tile(words, (reps, 1))[:N_LANES]).view(torch.int32).cuda()
    tn = torch.from_numpy(np.tile(nbits, reps)[:N_LANES]).to(torch.int32).cuda()
    k2 = lambda: dec.decode_downsample_fused(tw, tn, N_DP, WINDOW)  # noqa: E731
    k3 = lambda: dec.decode_batched(tw, tn, N_DP)  # noqa: E731
    if mode == "check":
        agg, total, error = k2()
        want = dec.decode_downsample_fused_plain(tw[:N_UNIQUE], tn[:N_UNIQUE], N_DP, WINDOW)
        for name, g, w in (("sum", agg.sum, want[0].sum), ("count", agg.count, want[0].count),
                           ("total", total, want[1]), ("error", error, want[2])):
            _same(torch, g[:N_UNIQUE], w, f"K2 {name}")
        got = k3()
        want = dec.decode_batched_plain(tw[:N_UNIQUE], tn[:N_UNIQUE], N_DP)
        for i, (g, w) in enumerate(zip(got, want)):
            _same(torch, g[:N_UNIQUE], w, f"K3 output {i}")
        del agg, total, error, got, want
        torch.cuda.empty_cache()
    layout = dec.kernel_layout()
    return {"k2_mean_ms": _device_ms(torch, k2), "k3_ms": _device_ms(torch, k3),
            "k2_mean_layout": layout["decode_downsample_fused"],
            "k3_layout": layout["decode_batched"]}


def _copy(root: Path, src: str, name: str) -> Path:
    edits, _ = VARIANTS[name]
    where = root / "build" / "k1_split" / name
    shutil.rmtree(where, ignore_errors=True)
    shutil.copytree(root / "m3_tpu_torch", where / "m3_tpu_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    for old, new in edits:
        src = src.replace(old, new)
    (where / "m3_tpu_torch/csrc/m3tsz_decode.cu").write_text(src)
    return where


def main(argv: list[str]) -> int:
    if len(argv) == 3 and argv[0] == "--child":
        print(json.dumps(child(argv[1], argv[2])), flush=True)
        return 0
    if len(argv) != 1:
        print(__doc__, file=sys.stderr)
        return 2
    root = Path(argv[0]).resolve()
    src = (root / "m3_tpu_torch/csrc/m3tsz_decode.cu").read_text()
    missing = [a.splitlines()[0] for a, n in ANCHORS.items() if src.count(a) != n]
    if missing:
        print(f"{root}: not the five-load decoder (anchors {missing})", file=sys.stderr)
        return 2
    runs = [("parent", root, "check")] + [(name, _copy(root, src, name),
                                           "check" if kept else "time")
                                          for name, (_, kept) in VARIANTS.items()]
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print(card, flush=True)
    # one nvcc a copy, all started together
    builds = [subprocess.Popen([sys.executable, __file__, "--child", str(where), "build"],
                               stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
              for _, where, _ in runs]
    res = {}
    for (name, _, _), proc in zip(runs, builds):
        out, err = proc.communicate(timeout=900)
        if proc.returncode:
            print(f"{name}: build exit {proc.returncode}\n{err[-4000:]}", file=sys.stderr)
            return 1
        res[name] = json.loads(out.strip().splitlines()[-1])
    for name, where, mode in runs:
        run = subprocess.run([sys.executable, __file__, "--child", str(where), mode],
                             capture_output=True, text=True, timeout=900)
        if run.returncode:
            print(f"{name}: exit {run.returncode}\n{run.stderr[-4000:]}", file=sys.stderr)
            return 1
        res[name].update(json.loads(run.stdout.strip().splitlines()[-1]))
    print(json.dumps(res), flush=True)
    shutil.rmtree(root / "build" / "k1_split", ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
