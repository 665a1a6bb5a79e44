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

On a CUDA tensor ``mesh_reduce`` launches ``csrc/mesh_reduce.cu`` or raises;
on a CPU tensor it runs ``mesh_reduce_plain``, a Python loop over the shards
in the same order.
"""

from __future__ import annotations

import torch

from m3_tpu_torch.ops import _build

OPS = ("sum", "min", "max")  # enum Op of csrc/mesh_reduce.cu
_DTYPES = {torch.float64: 0, torch.int64: 1}  # enum Dtype


def _check(partials: torch.Tensor, op: str, lo, hi) -> tuple[int, int]:
    if op not in OPS:
        raise ValueError(f"no mesh reduce for {op!r}")
    if partials.dtype not in _DTYPES:
        raise ValueError(f"mesh reduce takes float64 or int64, got {partials.dtype}")
    if partials.dim() < 1 or partials.shape[0] < 1:
        raise ValueError(f"expected a [n_shards, ...] stack, got {tuple(partials.shape)}")
    n = partials[0].numel()
    lo = 0 if lo is None else int(lo)
    hi = n if hi is None else int(hi)
    if not 0 <= lo <= hi <= n:
        raise ValueError(f"owned range [{lo}, {hi}) outside [0, {n})")
    return lo, hi


def _out_shape(partials: torch.Tensor, lo: int, hi: int, whole: bool):
    return tuple(partials.shape[1:]) if whole else (hi - lo,)


def mesh_reduce_plain(partials: torch.Tensor, op: str, lo: int | None = None,
                      hi: int | None = None) -> torch.Tensor:
    """Plain version of ``mesh_reduce`` (same arguments and result)."""
    lo_, hi_ = _check(partials, op, lo, hi)
    whole = lo is None and hi is None
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
    return acc.reshape(_out_shape(partials, lo_, hi_, whole))


_SIGNATURES = {
    "m3_mesh_reduce": [_build.P, _build.I, _build.LL, _build.LL, _build.LL, _build.LL, _build.I,
                       _build.P, _build.P],
}


def mesh_reduce(partials: torch.Tensor, op: str, lo: int | None = None,
                hi: int | None = None) -> torch.Tensor:
    """``op`` (sum, min or max) of a ``[n_shards, ...]`` stack over its shard
    axis, in ascending shard order: -> ``[...]``, or ``[hi - lo]`` of the
    flattened trailing axes when an owned range is given."""
    lo_, hi_ = _check(partials, op, lo, hi)
    if partials.device.type == "cpu":
        return mesh_reduce_plain(partials, op, lo, hi)
    if not partials.is_cuda:
        raise ValueError(f"unsupported device {partials.device}")
    whole = lo is None and hi is None
    p = partials.contiguous()
    n_shards, N = p.shape[0], p[0].numel()
    out = torch.empty((hi_ - lo_,), dtype=p.dtype, device=p.device)
    if hi_ > lo_:
        lib = _build.library("mesh_reduce", _SIGNATURES)
        rc = lib.m3_mesh_reduce(p.data_ptr(), _DTYPES[p.dtype], n_shards, N, lo_, hi_,
                                OPS.index(op), out.data_ptr(),
                                torch.cuda.current_stream(p.device).cuda_stream)
        _build.check(lib, rc, "mesh_reduce")
        _build.count_launch("mesh_reduce")
    return out.reshape(_out_shape(partials, lo_, hi_, whole))
