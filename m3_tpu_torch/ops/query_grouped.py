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
``grouped_quantile``: the phi-quantile of each group's present cells, in
``csrc/query_select.cu``, which QK7 ``ops/lane_topk.py`` shares).

- On a CUDA tensor ``grouped_reduce`` and ``fleet_nansum`` launch
  ``csrc/query_grouped.cu`` or raise.  The kernel takes a stable CSR of
  each group's lanes, built on the host from the group ids (glue): lanes
  with a group id outside ``[0, n_groups)`` belong to no group, as in the
  reference's segment ops.
- On a CPU tensor they run the plain versions (segment sums by
  ``index_add_``, as the reference's ``segment_sum``).

Lanes whose row is all NaN (padding lanes) contribute nothing to any
group, so callers may park them on any group id.  For the quantile they
count in their group's size but never in its present cells, as in the
reference.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from m3_tpu_torch.ops import _build, ieee

I64 = torch.int64
F64 = torch.float64

AGGS = ("sum", "avg", "count", "min", "max", "group", "stddev", "stdvar")  # PromQL's
# enum Agg of csrc/query_grouped.cu: PromQL's, then graphite's further ops
# (diff and last answer for a grouping whose lane 0 lies in group 0)
OPS = AGGS + ("multiply", "range", "diff", "last")
MAX_WARPS = 32  # kMaxWarps of the kernel
# Largest padded group (pairs) that csrc/query_select.cu sorts in shared
# memory (48 KB); larger groups sort in a global scratch buffer.
SELECT_SMEM_MAX_P = 4096
SELECT_QUANTILE, SELECT_TOPK, SELECT_BOTTOMK = 0, 1, 2  # enum Mode of the kernel


def _check_agg(agg: str) -> None:
    if agg not in OPS:
        raise ValueError(f"no device form for aggregation {agg}")


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


def grouped_reduce_plain(out: torch.Tensor, groups: torch.Tensor, n_groups: int, agg: str,
                         empty_value: float = float("nan")):
    """Plain version of ``grouped_reduce`` (same arguments)."""
    _check_agg(agg)
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
    elif agg == "multiply":
        idx = seg[:, None].expand_as(rows)
        g = torch.ones_like(sums).scatter_reduce(0, idx, torch.where(m, rows, 1.0), "prod")
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
    "m3_query_grouped": [_build.P, _build.LL, _build.P, _build.P, _build.P, _build.I,
                         _build.I, _build.D, _build.I, _build.P, _build.P],
}
_SELECT_SIGNATURES = {
    "m3_query_select": [_build.P, _build.LL, _build.P, _build.P, _build.LL, _build.I, _build.D,
                        _build.LL, _build.I, _build.LL, _build.P, _build.P, _build.I, _build.I,
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


class GroupIndex(NamedTuple):
    """The kernels' view of a grouping: ``group_csr`` on the device, and
    the group sizes on the host (the select kernel sizes its sorts from
    them).  ``members`` None means lanes 0..offsets[-1]-1 in order."""

    members: torch.Tensor | None  # i64[K] on the device
    offsets: torch.Tensor  # i64[G + 1] on the device
    sizes: np.ndarray  # i64[G] on the host


def group_index(groups, n_groups: int, device) -> GroupIndex:
    """``group_csr`` moved to ``device`` (non-blocking copies: host glue
    that never waits on the card)."""
    members, offsets = group_csr(groups, n_groups)
    return GroupIndex(torch.from_numpy(members).to(device, non_blocking=True),
                      torch.from_numpy(offsets).to(device, non_blocking=True), np.diff(offsets))


def _ptr(t: torch.Tensor | None):
    return None if t is None or not t.numel() else t.data_ptr()


def _launch(x: torch.Tensor, index: GroupIndex, agg: str, empty_value: float):
    if x.dim() != 2:
        raise ValueError(f"expected an [L, S] matrix, got {tuple(x.shape)}")
    n_groups = len(index.sizes)
    dev = x.device
    S = x.shape[1]
    xc = x.to(F64).contiguous()
    out = torch.empty((n_groups, S), dtype=F64, device=dev)
    if not (n_groups and S):
        return out
    # groups of more than 32 lanes with 32 warps a block; the others with as
    # many warps as the largest of them has lanes (one for one-lane groups);
    # empty groups go with the large ones when no other group is small
    large = index.sizes > MAX_WARPS
    if not (index.sizes[~large] > 0).any():
        large[:] = True
    small_warps = min(MAX_WARPS, pow2(int(index.sizes[~large].max(initial=1))))
    if large.all() or not large.any():
        launches = [(None, n_groups, MAX_WARPS if large.all() else small_warps)]
    else:
        launches = [(torch.from_numpy(np.flatnonzero(sel)).to(dev, non_blocking=True),
                     int(sel.sum()), w) for sel, w in ((~large, small_warps), (large, MAX_WARPS))]
    lib = _build.library("query_grouped", _SIGNATURES)
    for ids, n, warps in launches:
        rc = lib.m3_query_grouped(
            xc.data_ptr(), S, _ptr(index.members), index.offsets.data_ptr(), _ptr(ids), n,
            OPS.index(agg), float(empty_value), warps, out.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
        _build.check(lib, rc, "query_grouped")
        _build.count_launch("query_grouped")
    return out


def grouped_reduce(out: torch.Tensor, groups, n_groups: int, agg: str,
                   index: GroupIndex | None = None,
                   empty_value: float = float("nan")) -> torch.Tensor:
    """``agg`` (one of ``OPS``) of each group's lanes per step: [L, S] ->
    f64[n_groups, S].  ``groups`` gives each lane's group id (tensor or
    numpy); ``index`` may pass ``group_index(groups, n_groups, out.device)``
    built ahead; a group-step with no present cell gets ``empty_value``."""
    _check_agg(agg)
    if out.device.type == "cpu":
        groups = groups if isinstance(groups, torch.Tensor) else torch.from_numpy(
            np.asarray(groups, dtype=np.int64))
        return grouped_reduce_plain(out, groups, n_groups, agg, empty_value)
    if not out.is_cuda:
        raise ValueError(f"unsupported device {out.device}")
    index = index if index is not None else group_index(groups, n_groups, out.device)
    return _launch(out, index, agg, empty_value)


def fleet_nansum(x: torch.Tensor) -> torch.Tensor:
    """NaN-skipping sum over the lane axis: [L, S] -> f64[S]."""
    if x.device.type == "cpu":
        return fleet_nansum_plain(x)
    if not x.is_cuda:
        raise ValueError(f"unsupported device {x.device}")
    offsets = torch.tensor([0, x.shape[0]], dtype=I64).to(x.device, non_blocking=True)
    return _launch(x, GroupIndex(None, offsets, np.asarray([x.shape[0]])), "sum", 0.0)[0]


def pow2(n: int) -> int:
    """The smallest power of two >= n (1 for n <= 1)."""
    return 1 << max(int(n) - 1, 0).bit_length()


def launch_select(x: torch.Tensor, index: GroupIndex, mode: int, phi: float = 0.0, k: int = 0):
    """One launch of ``csrc/query_select.cu`` over the groups of ``index``
    on the CUDA matrix ``x`` [L, S]: quantile (-> f64[G, S]) or
    topk/bottomk (-> (f64[L, S], bool[L], i64[L]))."""
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
    quantile = mode == SELECT_QUANTILE
    out = torch.empty((G, S) if quantile else (L, S), dtype=F64, device=dev)
    present = torch.zeros((0,) if quantile else (L,), dtype=torch.int32, device=dev)
    rank = torch.empty((0,) if quantile else (L,), dtype=I64, device=dev)
    if G and S and L:
        lib = _build.library("query_select", _SELECT_SIGNATURES)
        rc = lib.m3_query_select(
            xc.data_ptr(), S, _ptr(index.members), index.offsets.data_ptr(), G, mode,
            float(phi), int(k), p_smem, p_scratch, _ptr(keys), _ptr(pos), grid, threads,
            out.data_ptr(), _ptr(present), _ptr(rank),
            torch.cuda.current_stream(dev).cuda_stream)
        kernel = "query_quantile" if quantile else "query_topk"
        _build.check(lib, rc, kernel)
        _build.count_launch(kernel)
    return out if quantile else (out, present.bool(), rank)


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
    return launch_select(out, index, SELECT_QUANTILE, phi=phi)
