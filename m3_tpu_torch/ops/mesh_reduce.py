"""The ordered cross-shard reduce of the mesh collectives: kernel MK1 and its
plain PyTorch version.

Replaces the reduction inside ``jax.lax.psum`` / ``pmin`` / ``pmax`` /
``psum_scatter`` of the reference's sharded paths
(``m3_tpu/parallel/mesh.py:72 consolidate_windows`` and its callers).  The
caller stacks each shard's partial into a ``[n_shards, ...]`` tensor
(``parallel/mesh.py``); ``mesh_reduce`` folds the stack over its first axis
in ascending shard order, as XLA:CPU's all-reduce does on the reference's
virtual mesh:

- ``sum``: from 0.0, shard by shard (NaN propagates; -0.0 shards give +0.0);
- ``min`` / ``max``: from +inf / -inf, taking a shard's value only when it is
  strictly below / above (NaN is skipped; an all-NaN column gives +-inf; of
  -0.0 and +0.0 the earlier shard's wins);
- int64 stacks: the same folds, exact (the ingest's byte accounting).

``lo``/``hi`` keep only the columns ``[lo, hi)`` of the flattened trailing
axes: the range a shard owns under the scatter schedule.
``mesh_reduce_batch`` reduces several stacks of one shape, each with its own
op, in one launch; ``mesh_reduce`` is a batch of one.

On CUDA tensors ``mesh_reduce_batch`` launches ``csrc/mesh_reduce.cu`` or
raises; on CPU tensors it runs ``mesh_reduce_plain``, a Python loop over the
shards in the same order.
"""

from __future__ import annotations

import ctypes
import math
from collections.abc import Sequence

import torch

from m3_tpu_torch.ops import _build

OPS = ("sum", "min", "max")  # enum Op of csrc/mesh_reduce.cu
_DTYPES = {torch.float64: 0, torch.int64: 1}  # enum Dtype
MAX_STACKS = 8  # kMaxStacks: stacks of one launch


def _check(shape, dtype, ops, lo, hi) -> tuple[int, int]:
    for op in ops:
        if op not in OPS:
            raise ValueError(f"no mesh reduce for {op!r}")
    if dtype not in _DTYPES:
        raise ValueError(f"mesh reduce takes float64 or int64, got {dtype}")
    if not shape or shape[0] < 1:
        raise ValueError(f"expected a [n_shards, ...] stack, got {tuple(shape)}")
    n = math.prod(shape[1:])
    lo = 0 if lo is None else int(lo)
    hi = n if hi is None else int(hi)
    if not 0 <= lo <= hi <= n:
        raise ValueError(f"owned range [{lo}, {hi}) outside [0, {n})")
    return lo, hi


def mesh_reduce_plain(partials: torch.Tensor, op: str, lo: int | None = None,
                      hi: int | None = None) -> torch.Tensor:
    """Plain version of ``mesh_reduce`` (same arguments and result)."""
    lo_, hi_ = _check(partials.shape, partials.dtype, (op,), lo, hi)
    p = partials.reshape(partials.shape[0], -1)[:, lo_:hi_]
    if partials.dtype == torch.int64:
        init = {"sum": 0, "min": torch.iinfo(torch.int64).max,
                "max": torch.iinfo(torch.int64).min}[op]
    else:
        init = {"sum": 0.0, "min": torch.inf, "max": -torch.inf}[op]
    acc = torch.full((hi_ - lo_,), init, dtype=partials.dtype, device=partials.device)
    for k in range(p.shape[0]):
        v = p[k]
        if op == "sum":
            acc = acc + v
        elif op == "min":
            acc = torch.where(v < acc, v, acc)
        else:
            acc = torch.where(v > acc, v, acc)
    return acc.reshape(partials.shape[1:]) if lo is None and hi is None else acc


_SIGNATURES = {"m3_mesh_reduce": [_build.P, _build.I, _build.I, _build.LL, _build.LL, _build.P]}


def _rows(stack: torch.Tensor) -> torch.Tensor:
    """``stack`` as [n_shards, N] with each row contiguous and the rows
    apart, as the kernel reads it: a view where one exists, else a copy."""
    p = stack if stack.dim() == 2 else stack.reshape(stack.shape[0], -1)
    if p.stride(1) != 1 or (p.shape[0] > 1 and p.stride(0) < p.shape[1]):
        p = p.contiguous()
    return p


def mesh_reduce(partials: torch.Tensor, op: str, lo: int | None = None,
                hi: int | None = None) -> torch.Tensor:
    """``op`` (sum, min or max) of a ``[n_shards, ...]`` stack over its shard
    axis, in ascending shard order: -> ``[...]``, or ``[hi - lo]`` of the
    flattened trailing axes when an owned range is given."""
    return mesh_reduce_batch((partials,), (op,), lo, hi)[0]


def mesh_reduce_batch(stacks: Sequence[torch.Tensor], ops: Sequence[str],
                      lo: int | None = None, hi: int | None = None) -> tuple[torch.Tensor, ...]:
    """``ops[i]`` of ``stacks[i]`` over its shard axis for each i, as
    ``mesh_reduce`` each: stacks of one shape, dtype and device, reduced in
    one launch per ``MAX_STACKS``.  A stack may be any view (one stack of a
    gathered ``[n_shards, m, ...]`` tensor is read in place)."""
    if not stacks or len(stacks) != len(ops):
        raise ValueError(f"{len(stacks)} stacks for {len(ops)} ops")
    first = stacks[0]
    shape, dtype, device = first.shape, first.dtype, first.device
    if any(s.shape != shape or s.dtype != dtype or s.device != device for s in stacks):
        raise ValueError("a batch takes stacks of one shape, dtype and device")
    lo_, hi_ = _check(shape, dtype, ops, lo, hi)
    if device.type == "cpu":
        return tuple(mesh_reduce_plain(s, op, lo, hi) for s, op in zip(stacks, ops))
    if device.type != "cuda":
        raise ValueError(f"unsupported device {device}")
    n_out = hi_ - lo_
    outs = tuple(first.new_empty(tuple(shape[1:]) if lo is None and hi is None else (n_out,))
                 for _ in stacks)
    if n_out:
        # held until every launch is queued: a freed copy is reused only after them
        rows = [_rows(s) for s in stacks]
        lib = _build.library("mesh_reduce", _SIGNATURES)
        stream = torch.cuda.current_stream(device).cuda_stream
        shift = lo_ * first.element_size()
        for a in range(0, len(rows), MAX_STACKS):
            desc = []
            for i in range(a, min(a + MAX_STACKS, len(rows))):
                desc += (rows[i].data_ptr() + shift, rows[i].stride(0), OPS.index(ops[i]),
                         outs[i].data_ptr())
            rc = lib.m3_mesh_reduce((ctypes.c_longlong * len(desc))(*desc), len(desc) // 4,
                                    _DTYPES[dtype], shape[0], n_out, stream)
            _build.check(lib, rc, "mesh_reduce")
            _build.count_launch("mesh_reduce")
    return outs
