"""Time the decode kernels of one or more checkouts on one CUDA card: K3
(``decode_batched``) at the read path's and the fan-out read's shapes, K2
(``decode_downsample_fused``, window 6) in both modes at the read path's
shape and T1 (``aggregate_tiles``) at 1m and 5m tiles, with the shapes,
inputs and checks of ``tools/checkout_compare.py`` (the unique lanes held
bit for bit against the plain versions first), device time alone (the
stream kept busy ahead, CUDA events, median of 7).  Each checkout builds
its kernels into its own ``build/`` (all builds started together) and runs
in a process of its own, in the order given; each line also gives the
registers a thread and blocks an SM of K2, K3 and T1 (``kernel_layout``).
To time another width or form of a kernel, patch a copy of the package in
a directory of its own and name that directory as a checkout.

    python3 tools/decode_compare.py ROOT [ROOT ...]

Prints one JSON line a checkout.
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))
import checkout_compare as cc  # noqa: E402


def child(root: str) -> dict:
    sys.path.insert(0, root)
    import numpy as np
    import torch

    from m3_tpu_torch.models import corpus
    from m3_tpu_torch.ops import m3tsz_decode as dec
    from m3_tpu_torch.ops.bitstream import pack_streams

    if not Path(dec.__file__).resolve().is_relative_to(Path(root).resolve()):
        raise RuntimeError(f"imported {dec.__file__}, not from {root}")
    res = {"root": root, "layout": {k: (v["registers"], v["blocks_per_sm"])
                                    for k, v in dec.kernel_layout().items()}}
    words, nbits = cc._k3_inputs(np, torch, corpus, pack_streams, cc.READ_UNIQUE, cc.READ_LANES,
                                 cc.READ_DP)
    u = cc.READ_UNIQUE
    k3 = lambda: dec.decode_batched(words, nbits, cc.READ_DP)  # noqa: E731
    cc._same_tiled(torch, k3(), dec.decode_batched_plain(words[:u], nbits[:u], cc.READ_DP), u,
                   "K3")
    res["k3_read"] = cc._device_ms(torch, k3)
    for key, full in (("k2_mean", False), ("k2_full", True)):
        fn = lambda: dec.decode_downsample_fused(words, nbits, cc.READ_DP, 6,  # noqa: E731
                                                 full_agg=full)
        got = fn()
        want = dec.decode_downsample_fused_plain(words[:u], nbits[:u], cc.READ_DP, 6,
                                                 full_agg=full)
        cc._same_tiled(torch, (*got[0], *got[1:]), (*want[0], *want[1:]), u, key)
        del got, want
        res[key] = cc._device_ms(torch, fn)
    del words, nbits
    torch.cuda.empty_cache()
    words, nbits = cc._k3_inputs(np, torch, corpus, pack_streams, cc.QUERY_UNIQUE,
                                 cc.QUERY_LANES, cc.QUERY_DP)
    res["k3_query"] = cc._device_ms(torch, lambda: dec.decode_batched(
        words, nbits, cc.QUERY_DP, flag_truncation=True))
    del words, nbits
    torch.cuda.empty_cache()
    res.update({k: v["device_ms"] for k, v in cc._t1(np, torch, corpus).items()})
    return res


def main(argv: list[str]) -> int:
    if len(argv) == 2 and argv[0] == "--child":
        print(json.dumps(child(argv[1])), flush=True)
        return 0
    if not argv:
        print(__doc__, file=sys.stderr)
        return 2
    builds = [subprocess.Popen([sys.executable, "-c", "import sys; sys.path.insert(0, sys.argv[1]); "
                                "from m3_tpu_torch.ops import _build; "
                                "_build.build_all(('m3tsz_decode',))", root])
              for root in dict.fromkeys(argv)]
    if any(p.wait() for p in builds):
        print("a build failed", file=sys.stderr)
        return 1
    rc = 0
    for root in argv:
        out = subprocess.run([sys.executable, __file__, "--child", root], capture_output=True,
                             text=True, timeout=900)
        if out.returncode:
            print(f"{root}: exit {out.returncode}\n{out.stderr[-4000:]}", file=sys.stderr)
            rc = 1
        else:
            print(out.stdout.strip().splitlines()[-1], flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
