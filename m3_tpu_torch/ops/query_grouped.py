"""Group-by over a served ``[L, S]`` matrix: the CUDA kernels QK4 and QK6
and their plain PyTorch versions.

Port of ``m3_tpu/models/query_pipeline.py:_grouped_reduce`` (sum, avg,
count, min, max, group, stddev, stdvar; NaN cells are absent and a
group-step with no present cell is NaN), of the fleet sum
``jnp.nansum(rate, axis=0)`` of ``device_rate_pipeline`` (the one-group
case, 0.0 where nothing is present), of ``_graphite_grouped_reduce``'s
NaN-reductions (``ops/graphite.py`` calls ``grouped_reduce`` with the
further ops multiply, range, diff and last and with numpy's value over
nothing as ``empty_value``) and of ``_grouped_quantile`` (QK6,
``grouped_quantile``: the phi-quantile of each group's present cells, a
radix selection over the chunk table in ``csrc/query_select.cu``, which QK7
``ops/lane_topk.py`` shares).

- On a CUDA tensor ``grouped_reduce`` and ``fleet_nansum`` launch
  ``csrc/query_grouped.cu`` or raise.  The kernel takes a stable CSR of
  each group's lanes and a chunk table (``chunk_plan``: each group cut into
  chunks of at most ``CHUNK`` lanes), both built on the host from the group
  ids (glue): lanes with a group id outside ``[0, n_groups)`` belong to no
  group, as in the reference's segment ops.
- On a CPU tensor they run the plain versions (segment sums by
  ``index_add_``, as the reference's ``segment_sum``).

The op code ``sqdev`` is the second pass of the reference's sharded
stddev/stdvar (``_grouped_reduce_sharded:814``): the sum of ``(x -
center[seg % n_center])^2`` over each segment's present cells, 0.0 where
none is present (the caller's ``empty_value``).  ``parallel`` reduces each
shard's lanes into segments ``shard * n_groups + group`` and reads the global
mean as ``center``.

Lanes whose row is all NaN (padding lanes) contribute nothing to any
group, so callers may park them on any group id.  For the quantile they
count in their group's size but never in its present cells, as in the
reference.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from m3_tpu_torch.ops import _build, ieee

I64 = torch.int64
F64 = torch.float64

AGGS = ("sum", "avg", "count", "min", "max", "group", "stddev", "stdvar")  # PromQL's
# enum Agg of csrc/query_grouped.cu: PromQL's, then graphite's further ops
# (diff and last answer for a grouping whose lane 0 lies in group 0)
OPS = AGGS + ("multiply", "range", "diff", "last", "sqdev")
# Lanes per chunk of ``chunk_plan``: QK4 and QK7 give a warp one chunk for 32
# steps, and fold or merge a larger group's chunks in a second pass.
CHUNK = 256
# Largest k of the topk/bottomk selection (kKMax of csrc/query_select.cu);
# a larger k sorts each group (the select kernel).
K_MAX = 32
# Largest padded group (pairs) that the select kernel sorts in shared memory
# (48 KB); larger groups sort in a global scratch buffer.
SELECT_SMEM_MAX_P = 4096
SELECT_TOPK, SELECT_BOTTOMK = 1, 2  # enum Mode of csrc/query_select.cu
NO_RANK = 2**62  # the reference's rank of a lane not kept at the last step


def _check_agg(agg: str) -> None:
    if agg not in OPS:
        raise ValueError(f"no device form for aggregation {agg}")


def _check_center(agg: str, center, steps_shape) -> None:
    if agg != "sqdev":
        return
    if center is None or center.dim() != 2 or center.shape[0] < 1 \
            or tuple(center.shape[1:]) != tuple(steps_shape):
        raise ValueError(f"sqdev needs a [n_center >= 1, S] center, got "
                         f"{None if center is None else tuple(center.shape)}")


# --- plain versions ------------------------------------------------------


def _segment_sum(x: torch.Tensor, seg: torch.Tensor, n: int) -> torch.Tensor:
    out = torch.zeros((n,) + x.shape[1:], dtype=x.dtype, device=x.device)
    return out.index_add_(0, seg, x)


def _segment_extreme(x: torch.Tensor, seg: torch.Tensor, n: int, is_max: bool) -> torch.Tensor:
    """segment_min/max of non-NaN rows as XLA computes them: empty
    segments hold +inf (min) or -inf (max), and -0.0 orders below +0.0."""
    fill = -torch.inf if is_max else torch.inf
    out = torch.full((n,) + x.shape[1:], fill, dtype=x.dtype, device=x.device)
    idx = seg[:, None].expand_as(x)
    r = out.scatter_reduce(0, idx, x, "amax" if is_max else "amin", include_self=True)
    zero = x == 0
    # which zero wins a tie: max takes +0.0 if one is there, min -0.0
    want = zero & (torch.signbit(x) != is_max)
    has = _segment_sum(want.to(F64), seg, n) > 0
    signed = torch.where(has, 0.0 if is_max else -0.0, -0.0 if is_max else 0.0)
    return torch.where(r == 0, signed, r)


def _rank_runs(seg: torch.Tensor, n: int):
    """The rows of each rank within their segment (rank r: the segment's
    r-th row in ascending row order), as (rows ordered by (rank, row), the
    host list of each rank's start in it, and the end)."""
    order = torch.argsort(seg, stable=True)
    counts = torch.bincount(seg, minlength=n)
    starts = torch.cumsum(counts, 0) - counts
    rank = torch.empty_like(seg)
    rank[order] = torch.arange(seg.numel(), device=seg.device) - starts[seg[order]]
    by_rank = torch.argsort(rank, stable=True)
    bounds = torch.cumsum(torch.bincount(rank), 0).tolist()
    return by_rank, [0] + bounds[:-1], bounds


def _segment_fold(x: torch.Tensor, seg: torch.Tensor, n: int, multiply: bool = False):
    """Each segment's rows summed from 0.0 (``multiply``: multiplied from
    1.0) in ascending row order (the kernel's order for a segment of at most
    ``CHUNK`` rows, and QK4's product for any segment): one step per rank
    within the segment, so that no step has two rows of one segment and the
    order is the same on every device."""
    out = (torch.ones if multiply else torch.zeros)((n,) + x.shape[1:], dtype=x.dtype,
                                                     device=x.device)
    if not seg.numel():
        return out
    rows, starts, ends = _rank_runs(seg, n)
    for a, b in zip(starts, ends):
        sel = rows[a:b]
        at = seg[sel]
        if multiply:
            out.index_copy_(0, at, out[at] * x[sel])
        else:
            out.index_add_(0, at, x[sel])
    return out


def grouped_reduce_plain(out: torch.Tensor, groups: torch.Tensor, n_groups: int, agg: str,
                         empty_value: float = float("nan"),
                         center: torch.Tensor | None = None):
    """Plain version of ``grouped_reduce`` (same arguments)."""
    _check_agg(agg)
    _check_center(agg, center, out.shape[1:])
    groups = groups.to(out.device, I64)
    inside = (groups >= 0) & (groups < n_groups)
    seg, rows = groups[inside], out[inside]
    m = ~torch.isnan(rows)
    sums = _segment_sum(torch.where(m, rows, 0.0), seg, n_groups)
    counts = _segment_sum(m.to(F64), seg, n_groups)
    if agg == "sum":
        g = sums
    elif agg == "count":
        g = counts
    elif agg == "avg":
        g = sums / torch.clamp(counts, min=1.0)
    elif agg in ("min", "max"):
        fill = -torch.inf if agg == "max" else torch.inf
        g = _segment_extreme(torch.where(m, rows, fill), seg, n_groups, agg == "max")
    elif agg == "range":
        g = (_segment_extreme(torch.where(m, rows, -torch.inf), seg, n_groups, True)
             - _segment_extreme(torch.where(m, rows, torch.inf), seg, n_groups, False))
    elif agg == "multiply":  # NaN cells as 1.0, in lane order from 1.0
        g = _segment_fold(torch.where(m, rows, 1.0), seg, n_groups, multiply=True)
    elif agg == "diff":  # lane 0 is the minuend
        g = 2.0 * torch.where(torch.isnan(out[0]), 0.0, out[0].to(F64)) - sums
    elif agg == "last":  # the cell of the group's highest lane present at the step
        lane = torch.arange(out.shape[0], device=out.device)[inside]
        key = torch.where(m, lane[:, None], -1)
        top = torch.full(sums.shape, -1, dtype=I64, device=out.device).scatter_reduce(
            0, seg[:, None].expand_as(key), key, "amax")
        g = torch.gather(out.to(F64), 0, top.clamp(min=0))
    elif agg == "group":
        g = torch.ones_like(sums)
    elif agg == "sqdev":
        c = center.to(out.device, F64)[seg % center.shape[0]]
        d = torch.where(m, rows - c, 0.0)
        g = _segment_fold(d * d, seg, n_groups)
    else:
        mean = sums / torch.clamp(counts, min=1.0)
        d = torch.where(m, rows - mean[seg], 0.0)
        var = _segment_sum(d * d, seg, n_groups) / torch.clamp(counts, min=1.0)
        g = torch.sqrt(var) if agg == "stddev" else var
    return torch.where(counts == 0, empty_value, g)


def fleet_nansum_plain(x: torch.Tensor) -> torch.Tensor:
    """Plain version of ``fleet_nansum``."""
    return torch.nansum(x, dim=0)


def check_phi(phi: float) -> float:
    """The grouped quantile's contract, as the reference's callers keep
    it: 0 <= phi <= 1 (the engine answers other values on the host)."""
    phi = float(phi)
    if not 0.0 <= phi <= 1.0:
        raise ValueError(f"quantile's phi must lie in [0, 1], got {phi}")
    return phi


def host_ids(groups) -> np.ndarray:
    return (groups.cpu().numpy() if isinstance(groups, torch.Tensor)
            else np.asarray(groups)).astype(np.int64, copy=False)


def grouped_quantile_plain(out: torch.Tensor, groups: torch.Tensor, n_groups: int, phi):
    """Plain version of ``grouped_quantile``, the reference's formulation:
    per step, lanes sorted by (group, value with NaN as +inf), stable by
    lane; each group's run starts at the sum of the sizes before it, and
    the quantile interpolates between the run's floor(h)-th and ceil(h)-th
    sorted keys (a NaN lane tied with a real +inf reads as +inf)."""
    phi = check_phi(phi)
    L = out.shape[0]
    groups = groups.to(out.device, I64)
    if bool((groups < 0).any()):
        raise ValueError("group ids must not be negative")
    m = ~torch.isnan(out)
    key = torch.where(m, out, torch.inf)
    by_key = torch.sort(key, dim=0, stable=True).indices
    by_group = torch.sort(groups[by_key], dim=0, stable=True).indices
    sv = torch.gather(key, 0, torch.gather(by_key, 0, by_group))  # sorted keys: NaN -> inf
    inside = groups < n_groups
    npres = _segment_sum(m[inside].to(F64), groups[inside], n_groups)
    sizes = torch.bincount(groups[inside], minlength=n_groups)
    base = (torch.cumsum(sizes, 0) - sizes)[:, None]
    h = phi * ieee.maximum(npres - 1.0, 0.0)
    lo = torch.floor(h)
    frac = h - lo
    i_lo = (base + lo.to(I64)).clamp(0, L - 1)
    i_hi = (base + torch.ceil(h).to(I64)).clamp(0, L - 1)
    v_lo, v_hi = torch.gather(sv, 0, i_lo), torch.gather(sv, 0, i_hi)
    q = v_lo + (v_hi - v_lo) * frac
    return torch.where(npres > 0, q, torch.nan)


# --- wrappers: CUDA tensor -> kernel, CPU tensor -> plain version --------

_SIGNATURES = {
    "m3_query_grouped": [_build.P, _build.LL, _build.P, _build.P, _build.LL, _build.LL, _build.P,
                         _build.LL, _build.LL, _build.I, _build.D, _build.P, _build.LL, _build.P,
                         _build.P, _build.P],
}
_SELECT_SIGNATURES = {
    "m3_query_select": [_build.P, _build.LL, _build.P, _build.P, _build.LL, _build.I, _build.LL,
                        _build.I, _build.LL, _build.P, _build.P, _build.I, _build.I, _build.P,
                        _build.P, _build.P, _build.P],
    "m3_query_quantile": [_build.P, _build.LL, _build.P, _build.P, _build.LL, _build.LL, _build.P,
                          _build.LL, _build.D, _build.P, _build.LL, _build.P, _build.P],
    "m3_query_quantile_scratch": ([_build.LL, _build.LL, _build.LL], _build.LL),
    "m3_query_topk": [_build.P, _build.LL, _build.P, _build.P, _build.LL, _build.LL, _build.P,
                      _build.LL, _build.I, _build.I, _build.P, _build.P, _build.P, _build.P,
                      _build.P, _build.P, _build.P, _build.P],
}


def group_csr(groups, n_groups: int):
    """Host-built stable CSR of the lanes of each group: (members i64[K],
    lane ids ascending within each group; offsets i64[n_groups + 1]).
    Lanes whose id lies outside [0, n_groups) are left out."""
    g = host_ids(groups)
    lanes = np.flatnonzero((g >= 0) & (g < n_groups))
    members = lanes[np.argsort(g[lanes], kind="stable")]
    offsets = np.zeros(n_groups + 1, dtype=np.int64)
    np.cumsum(np.bincount(g[lanes], minlength=n_groups), out=offsets[1:])
    return members, offsets


def chunk_plan(offsets: np.ndarray, members: np.ndarray | None = None):
    """The kernels' chunk table of a grouping, from its CSR: each group cut
    into chunks of at most ``CHUNK`` consecutive members (an empty group is
    one empty chunk).  Returns (chunks i64[5, C]: rows lo, hi (CSR
    positions), group, fold index, the lane of member lo (0 for an empty
    chunk); folds i64[3, F]: rows group, first chunk, number of chunks).
    The chunks of the F groups of several come first, in group order, with
    their fold index; those of the groups of one follow, in group order,
    with fold index -1.  ``members`` None means lanes 0..offsets[-1]-1."""
    offsets = np.asarray(offsets, dtype=np.int64)
    sizes = np.diff(offsets)
    n = np.maximum(1, -(-sizes // CHUNK))
    multi, single = np.flatnonzero(n > 1), np.flatnonzero(n == 1)
    reps = n[multi]
    first = np.cumsum(reps) - reps
    grp = np.repeat(multi, reps)
    lo = offsets[grp] + (np.arange(len(grp)) - np.repeat(first, reps)) * CHUNK
    lo = np.concatenate([lo, offsets[single]])
    hi = np.concatenate([np.minimum(lo[:len(grp)] + CHUNK, offsets[grp + 1]),
                         offsets[single + 1]])
    lane = lo if members is None else np.where(hi > lo, np.append(members, 0)[lo], 0)
    chunks = np.stack([lo, hi, np.concatenate([grp, single]),
                       np.concatenate([np.repeat(np.arange(len(multi)), reps),
                                       np.full(len(single), -1)]), lane]).astype(np.int64)
    return chunks, np.stack([multi, first, reps]).astype(np.int64)


class GroupIndex(NamedTuple):
    """The kernels' view of a grouping: ``group_csr`` and ``chunk_plan`` on
    the device, and the group sizes on the host (the select kernel sizes
    its sorts from them).  ``members`` None means lanes 0..offsets[-1]-1 in
    order; the first ``n_partial`` chunks are those of groups of several."""

    members: torch.Tensor | None  # i64[K] on the device
    offsets: torch.Tensor  # i64[G + 1] on the device
    sizes: np.ndarray  # i64[G] on the host
    chunks: torch.Tensor  # i64[5, C] on the device
    folds: torch.Tensor  # i64[3, F] on the device
    n_partial: int


def _index(members: np.ndarray | None, offsets: np.ndarray, device) -> GroupIndex:
    """The index of a CSR moved to ``device`` (non-blocking copies: host
    glue that never waits on the card)."""
    chunks, folds = chunk_plan(offsets, members)
    up = lambda a: torch.from_numpy(a).to(device, non_blocking=True)  # noqa: E731
    return GroupIndex(None if members is None else up(members), up(offsets), np.diff(offsets),
                      up(chunks), up(folds), int(folds[2].sum()))


def group_index(groups, n_groups: int, device) -> GroupIndex:
    """``group_csr`` and its chunk table on ``device``."""
    members, offsets = group_csr(groups, n_groups)
    return _index(members, offsets, device)


@functools.lru_cache(maxsize=32)
def block_index(sizes: tuple[int, ...], device) -> GroupIndex:
    """The index of groups that are consecutive lane blocks of ``sizes``
    lanes, in order (lanes 0..sizes[0]-1 are group 0, and so on).  Built
    once per (sizes, device): its tensors are only read, and the callers
    (the fleet sum, a mesh's per-shard sums) repeat one shape per query."""
    offsets = np.zeros(len(sizes) + 1, dtype=np.int64)
    np.cumsum(sizes, out=offsets[1:])
    return _index(None, offsets, device)


def _ptr(t: torch.Tensor | None):
    return None if t is None or not t.numel() else t.data_ptr()


def _launch(x: torch.Tensor, index: GroupIndex, agg: str, empty_value: float,
            center: torch.Tensor | None = None):
    if x.dim() != 2:
        raise ValueError(f"expected an [L, S] matrix, got {tuple(x.shape)}")
    n_groups = len(index.sizes)
    dev = x.device
    S = x.shape[1]
    xc = x.to(F64).contiguous()
    out = torch.empty((n_groups, S), dtype=F64, device=dev)
    if not (n_groups and S):
        return out
    cc = None
    if agg == "sqdev":  # the sharded stddev's second pass, counted apart
        if empty_value != 0.0:
            raise ValueError("sqdev gives 0.0 where a segment has no present cell")
        cc = center.to(dev, F64).contiguous()
    partials = torch.empty((4, index.n_partial, S), dtype=F64, device=dev)
    lib = _build.library("query_grouped", _SIGNATURES)
    rc = lib.m3_query_grouped(
        xc.data_ptr(), S, _ptr(index.members), _ptr(index.chunks), index.chunks.shape[1],
        index.n_partial, _ptr(index.folds), index.folds.shape[1], n_groups, OPS.index(agg),
        float(empty_value), _ptr(cc), 0 if cc is None else cc.shape[0], _ptr(partials),
        out.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    kernel = "query_sqdev" if agg == "sqdev" else "query_grouped"
    _build.check(lib, rc, kernel)
    _build.count_launch(kernel)
    return out


def grouped_reduce(out: torch.Tensor, groups, n_groups: int, agg: str,
                   index: GroupIndex | None = None,
                   empty_value: float = float("nan"),
                   center: torch.Tensor | None = None) -> torch.Tensor:
    """``agg`` (one of ``OPS``) of each group's lanes per step: [L, S] ->
    f64[n_groups, S].  ``groups`` gives each lane's group id (tensor or
    numpy); ``index`` may pass ``group_index(groups, n_groups, out.device)``
    built ahead; a group-step with no present cell gets ``empty_value``;
    ``center`` [n_center, S] is sqdev's (on ``out``'s device)."""
    _check_agg(agg)
    _check_center(agg, center, out.shape[1:])
    if out.device.type == "cpu":
        groups = groups if isinstance(groups, torch.Tensor) else torch.from_numpy(
            np.asarray(groups, dtype=np.int64))
        return grouped_reduce_plain(out, groups, n_groups, agg, empty_value, center)
    if not out.is_cuda:
        raise ValueError(f"unsupported device {out.device}")
    index = index if index is not None else group_index(groups, n_groups, out.device)
    return _launch(out, index, agg, empty_value, center)


def fleet_nansum(x: torch.Tensor) -> torch.Tensor:
    """NaN-skipping sum over the lane axis: [L, S] -> f64[S]."""
    if x.device.type == "cpu":
        return fleet_nansum_plain(x)
    if not x.is_cuda:
        raise ValueError(f"unsupported device {x.device}")
    return _launch(x, block_index((x.shape[0],), x.device), "sum", 0.0)[0]


def pow2(n: int) -> int:
    """The smallest power of two >= n (1 for n <= 1)."""
    return 1 << max(int(n) - 1, 0).bit_length()


def launch_select(x: torch.Tensor, index: GroupIndex, mode: int, k: int):
    """One launch of ``csrc/query_select.cu``'s select kernel (QK7 for k >
    ``K_MAX``: a sort per (group, step)) over the groups of ``index`` on the
    CUDA matrix ``x`` [L, S]: topk/bottomk -> (f64[L, S], bool[L], i64[L])."""
    if x.dim() != 2:
        raise ValueError(f"expected an [L, S] matrix, got {tuple(x.shape)}")
    dev = x.device
    L, S = x.shape
    G = len(index.sizes)
    xc = x.to(F64).contiguous()
    padded = [pow2(n) for n in index.sizes if n > 0]
    p_smem = max((p for p in padded if p <= SELECT_SMEM_MAX_P), default=0)
    p_scratch = max((p for p in padded if p > SELECT_SMEM_MAX_P), default=0)
    threads = min(512, max(64, max(padded, default=1) // 2))
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    grid = max(1, min(G * S, sms * (2 if p_scratch else 8)))
    keys = torch.empty((grid, p_scratch) if p_scratch else (0,), dtype=I64, device=dev)
    pos = torch.empty((grid, p_scratch) if p_scratch else (0,), dtype=torch.int32, device=dev)
    out = torch.empty((L, S), dtype=F64, device=dev)
    present = torch.zeros((L,), dtype=torch.int32, device=dev)
    rank = torch.empty((L,), dtype=I64, device=dev)
    if G and S and L:
        lib = _build.library("query_select", _SELECT_SIGNATURES)
        rc = lib.m3_query_select(
            xc.data_ptr(), S, _ptr(index.members), index.offsets.data_ptr(), G, mode, int(k),
            p_smem, p_scratch, _ptr(keys), _ptr(pos), grid, threads, out.data_ptr(),
            _ptr(present), _ptr(rank), torch.cuda.current_stream(dev).cuda_stream)
        _build.check(lib, rc, "query_topk[sort]")
        _build.count_launch("query_topk[sort]")
    return out, present.bool(), rank


def launch_quantile(x: torch.Tensor, index: GroupIndex, phi: float) -> torch.Tensor:
    """One call of ``csrc/query_select.cu``'s quantile-by selection (QK6)
    over the groups of ``index`` on the CUDA matrix ``x`` [L, S] -> f64[G,
    S]; its scratch is sized by the chunk table's groups of several chunks."""
    if x.dim() != 2:
        raise ValueError(f"expected an [L, S] matrix, got {tuple(x.shape)}")
    dev = x.device
    S = x.shape[1]
    G = len(index.sizes)
    xc = x.to(F64).contiguous()
    out = torch.empty((G, S), dtype=F64, device=dev)
    if not (G and S):
        return out
    lib = _build.library("query_select", _SELECT_SIGNATURES)
    n_folds = index.folds.shape[1]
    n_bytes = int(lib.m3_query_quantile_scratch(n_folds, index.n_partial, S))
    scratch = torch.empty((n_bytes,), dtype=torch.uint8, device=dev)
    rc = lib.m3_query_quantile(
        xc.data_ptr(), S, _ptr(index.members), _ptr(index.chunks), index.chunks.shape[1],
        index.n_partial, _ptr(index.folds), n_folds, float(phi), _ptr(scratch), n_bytes,
        out.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, rc, "query_quantile")
    _build.count_launch("query_quantile")
    return out


def launch_topk(x: torch.Tensor, index: GroupIndex, mode: int, k: int):
    """One call of ``csrc/query_select.cu``'s topk/bottomk selection (k <=
    ``K_MAX``) over the groups of ``index`` on the CUDA matrix ``x`` [L, S]:
    -> (f64[L, S], bool[L], i64[L]) as ``launch_select``."""
    if x.dim() != 2:
        raise ValueError(f"expected an [L, S] matrix, got {tuple(x.shape)}")
    if not 1 <= k <= K_MAX:
        raise ValueError(f"the selection takes 1 <= k <= {K_MAX}, got {k}")
    dev = x.device
    L, S = x.shape
    xc = x.to(F64).contiguous()
    out = torch.empty((L, S), dtype=F64, device=dev)
    present = torch.zeros((L,), dtype=torch.int32, device=dev)
    rank = torch.full((L,), NO_RANK, dtype=I64, device=dev)
    n_folds = index.folds.shape[1]
    cand_keys = torch.empty((index.n_partial, k, S), dtype=I64, device=dev)
    cand_pos = torch.empty_like(cand_keys)
    thr_keys = torch.empty((n_folds, S), dtype=I64, device=dev)
    thr_pos = torch.empty_like(thr_keys)
    if len(index.sizes) and S and L:
        lib = _build.library("query_select", _SELECT_SIGNATURES)
        rc = lib.m3_query_topk(
            xc.data_ptr(), S, _ptr(index.members), _ptr(index.chunks),
            index.chunks.shape[1], index.n_partial, _ptr(index.folds), n_folds, mode, int(k),
            _ptr(cand_keys), _ptr(cand_pos), _ptr(thr_keys), _ptr(thr_pos), out.data_ptr(),
            present.data_ptr(), rank.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
        _build.check(lib, rc, "query_topk")
        _build.count_launch("query_topk")
    return out, present.bool(), rank


def grouped_quantile(out: torch.Tensor, groups, n_groups: int, phi,
                     index: GroupIndex | None = None) -> torch.Tensor:
    """``quantile by (g) (phi, x)``: [L, S] -> f64[n_groups, S].  ``groups``
    gives each lane's group id (tensor or numpy; ids >= n_groups belong to
    no group, negative ids are refused); ``phi`` is a runtime argument in
    [0, 1]; ``index`` may pass ``group_index(groups, n_groups, out.device)``
    built ahead."""
    phi = check_phi(phi)
    if out.device.type == "cpu":
        groups = groups if isinstance(groups, torch.Tensor) else torch.from_numpy(
            np.asarray(groups, dtype=np.int64))
        return grouped_quantile_plain(out, groups, n_groups, phi)
    if not out.is_cuda:
        raise ValueError(f"unsupported device {out.device}")
    ids = host_ids(groups)
    if (ids < 0).any():
        raise ValueError("group ids must not be negative")
    index = index if index is not None else group_index(ids, n_groups, out.device)
    return launch_quantile(out, index, phi)
