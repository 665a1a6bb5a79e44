"""Port: the mesh across processes, and the sharded modules' imports.

Two gloo ranks on the CPU (``torch.multiprocessing.spawn``, a ``FileStore``
under the test's temporary directory), each holding 4 of a mesh's 8 shards,
must give the same bits as one rank holding all 8: the read step's fleet sum
(``decode_downsample_sharded``, a 4x2 mesh), the ingest step's fleet and
sealed bytes (``encode_rollup_sharded``, 4x2), ``device_grouped_sharded``
for sum, stddev and quantile(0.9), and a topk plan through
``device_expr_pipeline_sharded``.  The collectives stack every shard's
partial in shard order and reduce it in a fixed order, so the split of the
shards over ranks cannot change a bit.  The ranks run under a deadline of
their own: a hung rendezvous fails the test instead of stalling the suite.

This file imports no JAX (the spawned ranks import it as their module).
"""

import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from m3_tpu_torch.models import corpus
from m3_tpu_torch.models import query_pipeline as tq
from m3_tpu_torch.models import read_pipeline as trp
from m3_tpu_torch.models.ingest_pipeline import encode_rollup_sharded, shard_ingest_inputs
from m3_tpu_torch.ops import downsample as tds
from m3_tpu_torch.ops.bitstream import pack_streams
from m3_tpu_torch.ops.m3tsz_encode import prepare_value_fields
from m3_tpu_torch.parallel import mesh as tmesh

from test_torch_m3tsz_decode import assert_same

REPO = Path(__file__).resolve().parents[1]
SEC = 1_000_000_000
STEPS = corpus.START + np.arange(7, dtype=np.int64) * 120 * SEC + 600 * SEC
DEADLINE_S = 240


def _results(group) -> dict:
    """Everything compared across layouts, on an 8-shard mesh over ``group``
    (None: one rank)."""
    out = {}
    read = tmesh.make_mesh(4, 2, device="cpu", group=group)
    words, nbits, _ = corpus.sharded_read_batch(32, 48, seed=2)
    step = trp.decode_downsample_sharded(read, 48, 12, tds.AggregationType.MEAN)
    per_lane, out["fleet"] = step(*trp.shard_inputs(read, words, nbits))
    partial = tmesh.psum(read, tmesh.shard_reduce(read, torch.nan_to_num(per_lane)),
                         tmesh.SERIES_AXIS)
    out["fleet[all-reduce]"] = tmesh.consolidate_windows(read, partial, tmesh.WINDOW_AXIS,
                                                         False)[0]
    ts, starts, nv, vs = corpus.ingest_grid(32, 24)
    fields = prepare_value_fields(vs, nv)
    _, _, _, out["ingest.fleet"], out["ingest.bytes"] = encode_rollup_sharded(read, 24, 2)(
        *shard_ingest_inputs(read, ts, starts, nv, *fields, vs))
    mesh = tmesh.make_mesh(8, device="cpu", group=group)
    streams, slots, _ = corpus.sharded_query_streams(16, 2, 30, seed=41)
    qw, qn = pack_streams(streams)
    rows = [tmesh.series_sharding(mesh, x) for x in (qw, qn, slots % 2)]
    groups = tmesh.series_sharding(mesh, np.arange(16, dtype=np.int64) % 4).numpy()
    for agg in ("sum", "stddev", "quantile"):
        out[agg] = tq.device_grouped_sharded(mesh, *rows, STEPS, groups, 16, 4, 60, 600 * SEC,
                                             agg=agg, phi=0.9)[0]
    plan, leaves, params, steps = corpus.mesh_expr_plan("topk")
    topk, aux, errors = tq.device_expr_pipeline_sharded(
        plan, mesh, *tq.shard_expr_inputs(plan, mesh, leaves, params, steps))
    out["topk"], out["topk.present"], out["topk.rank"] = topk, aux[0], aux[1]
    out["topk.errors"] = errors[0]
    return out


def _rank_main(rank: int, world: int, store_path: str, out_dir: str) -> None:
    store = dist.FileStore(store_path, world)
    dist.init_process_group("gloo", store=store, rank=rank, world_size=world)
    try:
        torch.save(_results(dist.group.WORLD), os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def test_two_gloo_ranks_match_one(tmp_path):
    ctx = mp.spawn(_rank_main, args=(2, str(tmp_path / "store"), str(tmp_path)), nprocs=2,
                   join=False)
    deadline = time.monotonic() + DEADLINE_S
    try:
        while not ctx.join(timeout=max(deadline - time.monotonic(), 0.1)):
            if time.monotonic() > deadline:
                raise AssertionError(f"the gloo ranks did not finish in {DEADLINE_S} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
                p.join(10)
    want = _results(None)
    for rank in range(2):
        got = torch.load(tmp_path / f"rank{rank}.pt")
        assert got.keys() == want.keys()
        for k, v in want.items():
            assert_same(got[k].contiguous(), v.contiguous().numpy(), f"rank {rank} {k}")
    assert_same(want["fleet"], want["fleet[all-reduce]"].numpy(), "the two schedules")


def test_sharded_modules_import_no_jax():
    code = (
        "import sys\n"
        "import m3_tpu_torch.parallel, m3_tpu_torch.parallel.mesh, m3_tpu_torch.parallel.repack\n"
        "import m3_tpu_torch.ops.mesh_reduce, m3_tpu_torch.models.corpus\n"
        "import m3_tpu_torch.models.read_pipeline, m3_tpu_torch.models.ingest_pipeline\n"
        "import m3_tpu_torch.models.query_pipeline\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'm3_tpu'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                       timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
