"""Masked top-k / bottom-k over the lane axis: the CUDA kernel QK7 and its
plain PyTorch version.

Port of ``m3_tpu/ops/lane_topk.py:masked_topk``, the device form of the
engine's ``_eval_topk``: every (group, step) cell keeps its k best lanes
and NaNs the rest.  Grouping arrives as a host-built group id per lane
(the planner parks padding lanes on a trash group of their own, so they
never displace a real lane in an under-full group).

- NaN sorts away from the selected end (``-inf`` for topk, ``+inf`` for
  bottomk), but a NaN lane is still selected once the real values run out.
- Ties break by lane order (the reference's sort is stable); -0.0 and
  +0.0 tie.
- ``present[l]``: lane l was kept at any step; ``rank[l]``: its position
  in its group at the last step, ``_NO_RANK`` where it was not kept there
  (the host orders the root's rows by it).

- On a CUDA tensor ``masked_topk`` launches ``csrc/query_select.cu`` or
  raises: for k <= ``query_grouped.K_MAX`` its selection (each chunk's k
  best (key, member position) pairs per step, merged per (group, step),
  then a write against the k-th pair), for a larger k its select kernel's
  topk mode (one block per (group, step), a bitonic sort of the pairs).
  The group CSR and chunk table are host glue built from the host group
  ids.
- On a CPU tensor it runs ``masked_topk_plain``, the reference's
  formulation: one stable sort per step by (group, key), the inverse
  permutation, position in group < k.

Every group id must lie in ``[0, n_groups)``.
"""

from __future__ import annotations

import numpy as np
import torch

from m3_tpu_torch.ops import query_grouped

I64 = torch.int64
F64 = torch.float64
_NO_RANK = query_grouped.NO_RANK


def _check(groups: np.ndarray, n_groups: int, k: int) -> None:
    if k < 1:
        raise ValueError(f"k must be at least 1, got {k}")
    if groups.size and (groups.min() < 0 or groups.max() >= n_groups):
        raise ValueError(f"every group id must lie in [0, {n_groups})")


def masked_topk_plain(values: torch.Tensor, groups: torch.Tensor, n_groups: int, k: int,
                      bottom: bool):
    """Plain version of ``masked_topk`` (same arguments and results)."""
    L = values.shape[0]
    groups = groups.to(values.device, I64)
    _check(groups.cpu().numpy(), n_groups, k)
    sink = torch.inf if bottom else -torch.inf
    sortable = torch.where(torch.isnan(values), sink, values)
    key = sortable if bottom else -sortable
    # stable sort by (group, key): sort by key, then stably by group
    by_key = torch.sort(key, dim=0, stable=True).indices
    order = torch.gather(by_key, 0, torch.sort(groups[by_key], dim=0, stable=True).indices)
    lanes = torch.arange(L, device=values.device)[:, None].expand_as(order)
    inv = torch.empty_like(order).scatter_(0, order, lanes.contiguous())
    sizes = torch.bincount(groups, minlength=n_groups)
    base = torch.cumsum(sizes, 0) - sizes
    pos_in_group = inv - base[groups][:, None]
    selected = pos_in_group < k
    out = torch.where(selected, values, torch.nan)
    present = selected.any(dim=1)
    rank = torch.where(selected[:, -1], pos_in_group[:, -1], _NO_RANK)
    return out, present, rank


def masked_topk(values: torch.Tensor, groups, n_groups: int, k: int, bottom: bool):
    """Select the top (bottom) k lanes per (group, step) cell.

    values f64[L, S] (padding lanes all-NaN), groups i64[L] (tensor or
    numpy; padding lanes on a trash group), n_groups including the trash
    group, k >= 1.  Returns (out f64[L, S] with the cells not kept NaN,
    present bool[L], rank i64[L])."""
    if values.device.type == "cpu":
        groups = groups if isinstance(groups, torch.Tensor) else torch.from_numpy(
            np.asarray(groups, dtype=np.int64))
        return masked_topk_plain(values, groups, n_groups, k, bottom)
    if not values.is_cuda:
        raise ValueError(f"unsupported device {values.device}")
    ids = query_grouped.host_ids(groups)
    _check(ids, n_groups, k)
    return _launch(values, ids, n_groups, k, bottom)


def _launch(values: torch.Tensor, ids: np.ndarray, n_groups: int, k: int, bottom: bool):
    """The kernel for k: the selection up to ``query_grouped.K_MAX``, the
    select kernel's sort above it."""
    mode = query_grouped.SELECT_BOTTOMK if bottom else query_grouped.SELECT_TOPK
    index = query_grouped.group_index(ids, n_groups, values.device)
    if k <= query_grouped.K_MAX:
        return query_grouped.launch_topk(values, index, mode, k)
    return query_grouped.launch_select(values, index, mode, k=k)
