"""Per-lane merge of decoded (series, block) grids: the CUDA kernel QK1
and its plain PyTorch version; and the subquery's packing of its inner
grid (QK12, ``subq_pack``).

Port of the front half of ``m3_tpu/models/query_pipeline.py``:
``_tier_cut`` (the cross-namespace stitch), ``_merge_device`` (the
rank-in-slot scatter into ``[n_lanes, n_cap]`` lanes) and the lane half
of ``_decode_merge``'s error contract (per-lane counts and the unsorted
flag).

- On a CUDA tensor ``lane_merge`` launches ``csrc/query_merge.cu`` (one
  block per output lane, tier cut and compaction fused) or raises.
- On a CPU tensor it runs ``lane_merge_plain``, the reference's
  formulation (a global running count of valid cells minus the slot's
  base, one scatter).

Contract, as the reference's: rows of a slot are contiguous and slots
ascend (the reference's segment ops are called with
``indices_are_sorted=True``); every slot lies in ``[0, n_lanes)``.

``subq_pack`` ports the row sort of the subquery node
(``query_pipeline.py:1604-1618``): on a CUDA tensor it launches
``csrc/query_merge.cu``'s compaction (a warp per row), on a CPU tensor it
runs ``subq_pack_plain``, the reference's stable sort.
"""

from __future__ import annotations

import torch

from m3_tpu_torch.ops import _build

I64 = torch.int64
F64 = torch.float64
INT64_MAX = torch.iinfo(torch.int64).max
MAX_TIERS = 16  # kMaxTiers of csrc/query_merge.cu


def _segment_min(x: torch.Tensor, seg: torch.Tensor, n: int) -> torch.Tensor:
    """jax.ops.segment_min of int64 ``x``: empty segments hold INT64_MAX."""
    out = torch.full((n,), INT64_MAX, dtype=I64, device=x.device)
    return out.scatter_reduce(0, seg, x, "amin", include_self=True)


def tier_cut_plain(ts, valid, slots, tiers, n_lanes: int, n_tiers: int):
    """Plain version of the tier cut: tier rank r keeps only samples
    strictly older than the earliest sample any finer tier (rank < r)
    keeps for the same slot.  Returns the new ``valid``."""
    cut = torch.full((n_lanes,), INT64_MAX, dtype=I64, device=ts.device)
    for t in range(n_tiers):
        in_tier = (tiers == t)[:, None]
        keep = valid & (ts < cut[slots][:, None]) & in_tier
        valid = torch.where(in_tier, keep, valid)
        if ts.shape[1]:
            row_min = torch.where(keep, ts, INT64_MAX).amin(dim=1)
        else:
            row_min = torch.full((ts.shape[0],), INT64_MAX, dtype=I64, device=ts.device)
        row_min = torch.where(in_tier[:, 0], row_min, INT64_MAX)
        cut = torch.minimum(cut, _segment_min(row_min, slots, n_lanes))
    return valid


def lane_merge_plain(ts, vs, valid, slots, n_lanes: int, n_cap: int, tiers=None,
                     n_tiers: int = 1):
    """Plain PyTorch version of ``lane_merge`` (same arguments and results)."""
    slots = slots.to(I64)
    if n_tiers > 1 and tiers is not None:
        valid = tier_cut_plain(ts, valid, slots, tiers.to(I64), n_lanes, n_tiers)
    M, T = ts.shape
    dev = ts.device
    flat_mask = valid.reshape(-1)
    flat_rank = torch.cumsum(flat_mask.to(I64), 0) - 1
    row_counts = valid.sum(dim=1, dtype=I64)
    row_base = torch.cumsum(row_counts, 0) - row_counts
    slot_base = _segment_min(row_base, slots, n_lanes)
    cell_slot = slots.repeat_interleave(T)
    rank = flat_rank - slot_base[cell_slot] if M * T else flat_rank
    keep = flat_mask & (rank < n_cap)
    dest = (cell_slot * n_cap + rank)[keep]
    out_t = torch.full((n_lanes * n_cap,), INT64_MAX, dtype=I64, device=dev)
    out_v = torch.full((n_lanes * n_cap,), torch.nan, dtype=F64, device=dev)
    out_t[dest] = ts.reshape(-1)[keep]
    out_v[dest] = vs.reshape(-1)[keep]
    counts = torch.zeros((n_lanes,), dtype=I64, device=dev).index_add_(0, slots, row_counts)
    times = out_t.view(n_lanes, n_cap)
    unsorted = ((times[:, 1:] - times[:, :-1]) < 0).any(dim=1)
    return times, out_v.view(n_lanes, n_cap), counts, unsorted


_SIGNATURES = {
    "m3_query_merge": [_build.P, _build.P, _build.P, _build.P, _build.P, _build.LL, _build.I,
                       _build.LL, _build.I, _build.I, _build.P, _build.P, _build.P, _build.P,
                       _build.P],
    "m3_subq_pack": [_build.P, _build.P, _build.P, _build.LL, _build.I, _build.P, _build.P,
                     _build.I, _build.P],
}
SUBQ_BLOCKS_PER_SM = 8  # 256-thread blocks of QK12, a warp per row in turn


def lane_merge(ts: torch.Tensor, vs: torch.Tensor, valid: torch.Tensor, slots: torch.Tensor,
               n_lanes: int, n_cap: int, tiers: torch.Tensor | None = None, n_tiers: int = 1):
    """Merge decoded grids ``ts i64/vs f64/valid bool [M, T]`` into lanes.

    ``slots[m]`` is the output lane of row m; with ``n_tiers > 1`` and
    ``tiers`` (dense ranks, 0 finest) the tier cut runs first.  Returns
    (times i64[n_lanes, n_cap] INT64_MAX-padded, values f64[n_lanes, n_cap]
    NaN-padded, counts i64[n_lanes] of every valid cell incl. those past
    n_cap, unsorted bool[n_lanes])."""
    if ts.device.type == "cpu":
        return lane_merge_plain(ts, vs, valid, slots, n_lanes, n_cap, tiers, n_tiers)
    if not ts.is_cuda:
        raise ValueError(f"unsupported device {ts.device}")
    if ts.dim() != 2 or vs.shape != ts.shape or valid.shape != ts.shape:
        raise ValueError("ts, vs and valid must be [M, T] of one shape")
    M, T = ts.shape
    if slots.shape != (M,) or any(x.device != ts.device for x in (vs, valid, slots)):
        raise ValueError("slots must be [M] on the device of ts")
    cut_tiers = n_tiers if (n_tiers > 1 and tiers is not None) else 0
    if cut_tiers > MAX_TIERS:
        raise ValueError(f"at most {MAX_TIERS} tiers")
    dev = ts.device
    ts_c = ts.to(I64).contiguous()
    vs_c = vs.to(F64).contiguous()
    valid_c = valid.to(torch.bool).contiguous()
    slots_c = slots.to(I64).contiguous()
    tiers_c = tiers.to(dev, I64).contiguous() if cut_tiers else None
    times = torch.empty((n_lanes, n_cap), dtype=I64, device=dev)
    values = torch.empty((n_lanes, n_cap), dtype=F64, device=dev)
    counts = torch.empty((n_lanes,), dtype=I64, device=dev)
    unsorted = torch.empty((n_lanes,), dtype=torch.bool, device=dev)
    if n_lanes:
        lib = _build.library("query_merge", _SIGNATURES)
        rc = lib.m3_query_merge(
            ts_c.data_ptr(), vs_c.data_ptr(), valid_c.data_ptr(), slots_c.data_ptr(),
            None if tiers_c is None else tiers_c.data_ptr(), M, T, n_lanes, n_cap, cut_tiers,
            times.data_ptr(), values.data_ptr(), counts.data_ptr(), unsorted.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
        _build.check(lib, rc, "query_merge")
        _build.count_launch("query_merge")
    return times, values, counts, unsorted


def subq_pack_plain(cv: torch.Tensor, sub_times: torch.Tensor, sub_valid: torch.Tensor):
    """Plain version of ``subq_pack``, the reference's form: each cell keyed
    by its inner step time where the step is real and the cell not NaN,
    INT64_MAX otherwise, each row sorted stably by the key, values riding
    along (NaN where dropped).  Returns (times i64[rows, S], values
    f64[rows, S])."""
    sub_times = sub_times.to(cv.device, I64)
    sub_valid = sub_valid.to(cv.device, torch.bool)
    tkey = torch.where(sub_valid[None, :] & ~torch.isnan(cv), sub_times[None, :], INT64_MAX)
    vm = torch.where(tkey == INT64_MAX, torch.nan, cv)
    order = torch.sort(tkey, dim=1, stable=True).indices
    return torch.gather(tkey, 1, order), torch.gather(vm, 1, order)


def check_subq_grid(sub_times: torch.Tensor, sub_valid: torch.Tensor) -> None:
    """The compaction equals the sort only on an ascending inner grid:
    ``sub_times`` non-decreasing and below INT64_MAX where ``sub_valid``
    (host tensors: plan-time data, so the check costs no device sync)."""
    if sub_times.device.type != "cpu" or sub_valid.device.type != "cpu":
        raise ValueError("sub_times and sub_valid must be host tensors")
    t = sub_times.to(I64)[sub_valid.to(torch.bool)]
    if bool((t == INT64_MAX).any()) or bool((t[1:] < t[:-1]).any()):
        raise ValueError("the subquery's inner grid must ascend where it is valid")


def subq_pack(cv: torch.Tensor, sub_times: torch.Tensor, sub_valid: torch.Tensor):
    """The subquery's inner grid packed as lanes: the cells of the child's
    ``cv f64[rows, S]`` at real inner steps (``sub_valid``) that are not NaN,
    left-justified in step order with their step times, then (INT64_MAX,
    NaN).  ``sub_times i64[S]`` / ``sub_valid bool[S]`` are host tensors.
    Returns (times i64[rows, S], values f64[rows, S])."""
    if cv.dim() != 2 or sub_times.shape != (cv.shape[1],) or sub_valid.shape != sub_times.shape:
        raise ValueError("cv must be [rows, S] and sub_times, sub_valid [S]")
    if cv.device.type == "cpu":
        return subq_pack_plain(cv, sub_times, sub_valid)
    if not cv.is_cuda:
        raise ValueError(f"unsupported device {cv.device}")
    return _launch_subq(cv, sub_times, sub_valid)


def _launch_subq(cv: torch.Tensor, sub_times: torch.Tensor, sub_valid: torch.Tensor):
    check_subq_grid(sub_times, sub_valid)
    dev = cv.device
    rows, S = cv.shape
    x = cv.to(F64).contiguous()
    st = sub_times.to(I64).to(dev, non_blocking=True)
    sv = sub_valid.to(torch.bool).to(dev, non_blocking=True)
    t_out = torch.empty((rows, S), dtype=I64, device=dev)
    v_out = torch.empty((rows, S), dtype=F64, device=dev)
    if rows and S:
        lib = _build.library("query_merge", _SIGNATURES)
        grid = max(1, min(-(-rows // 8),
                          torch.cuda.get_device_properties(dev).multi_processor_count
                          * SUBQ_BLOCKS_PER_SM))
        rc = lib.m3_subq_pack(x.data_ptr(), st.data_ptr(), sv.data_ptr(), rows, S,
                              t_out.data_ptr(), v_out.data_ptr(), grid,
                              torch.cuda.current_stream(dev).cuda_stream)
        _build.check(lib, rc, "subq_pack")
        _build.count_launch("subq_pack")
    return t_out, v_out
