"""Group-by over a served ``[L, S]`` matrix: the CUDA kernel QK4 and its
plain PyTorch version.

Port of ``m3_tpu/models/query_pipeline.py:_grouped_reduce`` (sum, avg,
count, min, max, group, stddev, stdvar; NaN cells are absent and a
group-step with no present cell is NaN) and of the fleet sum
``jnp.nansum(rate, axis=0)`` of ``device_rate_pipeline`` (the one-group
case, 0.0 where nothing is present).

- On a CUDA tensor ``grouped_reduce`` and ``fleet_nansum`` launch
  ``csrc/query_grouped.cu`` or raise.  The kernel takes a stable CSR of
  each group's lanes, built on the host from the group ids (glue): lanes
  with a group id outside ``[0, n_groups)`` belong to no group, as in the
  reference's segment ops.
- On a CPU tensor they run the plain versions (segment sums by
  ``index_add_``, as the reference's ``segment_sum``).

Lanes whose row is all NaN (padding lanes) contribute nothing to any
group, so callers may park them on any group id.
"""

from __future__ import annotations

import numpy as np
import torch

from m3_tpu_torch.ops import _build

I64 = torch.int64
F64 = torch.float64

AGGS = ("sum", "avg", "count", "min", "max", "group", "stddev", "stdvar")  # enum Agg order
MAX_GROUPS = 65535  # the kernel's grid.y


def _check_agg(agg: str) -> None:
    if agg not in AGGS:
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


def grouped_reduce_plain(out: torch.Tensor, groups: torch.Tensor, n_groups: int, agg: str):
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
    elif agg == "group":
        g = torch.ones_like(sums)
    else:
        mean = sums / torch.clamp(counts, min=1.0)
        d = torch.where(m, rows - mean[seg], 0.0)
        var = _segment_sum(d * d, seg, n_groups) / torch.clamp(counts, min=1.0)
        g = torch.sqrt(var) if agg == "stddev" else var
    return torch.where(counts == 0, torch.nan, g)


def fleet_nansum_plain(x: torch.Tensor) -> torch.Tensor:
    """Plain version of ``fleet_nansum``."""
    return torch.nansum(x, dim=0)


# --- wrappers: CUDA tensor -> kernel, CPU tensor -> plain version --------

_SIGNATURES = {
    "m3_query_grouped": [_build.P, _build.LL, _build.P, _build.P, _build.I, _build.I,
                         _build.D, _build.P, _build.P],
}


def group_csr(groups, n_groups: int):
    """Host-built stable CSR of the lanes of each group: (members i64[K],
    lane ids ascending within each group; offsets i64[n_groups + 1]).
    Lanes whose id lies outside [0, n_groups) are left out."""
    g = (groups.cpu().numpy() if isinstance(groups, torch.Tensor)
         else np.asarray(groups)).astype(np.int64, copy=False)
    lanes = np.flatnonzero((g >= 0) & (g < n_groups))
    members = lanes[np.argsort(g[lanes], kind="stable")]
    offsets = np.zeros(n_groups + 1, dtype=np.int64)
    np.cumsum(np.bincount(g[lanes], minlength=n_groups), out=offsets[1:])
    return members, offsets


def _launch(x: torch.Tensor, members, offsets: np.ndarray, agg: str, empty_value: float):
    if x.dim() != 2:
        raise ValueError(f"expected an [L, S] matrix, got {tuple(x.shape)}")
    n_groups = len(offsets) - 1
    if n_groups > MAX_GROUPS:
        raise ValueError(f"at most {MAX_GROUPS} groups")
    dev = x.device
    S = x.shape[1]
    xc = x.to(F64).contiguous()
    off = torch.from_numpy(offsets).to(dev)
    mem = None if members is None else torch.from_numpy(members).to(dev)
    out = torch.empty((n_groups, S), dtype=F64, device=dev)
    if n_groups and S:
        lib = _build.library("query_grouped", _SIGNATURES)
        rc = lib.m3_query_grouped(
            xc.data_ptr(), S, None if mem is None or not mem.numel() else mem.data_ptr(),
            off.data_ptr(), n_groups, AGGS.index(agg), empty_value, out.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
        _build.check(lib, rc, "query_grouped")
        _build.count_launch("query_grouped")
    return out


def grouped_reduce(out: torch.Tensor, groups, n_groups: int, agg: str,
                   csr: tuple[np.ndarray, np.ndarray] | None = None) -> torch.Tensor:
    """``agg`` of each group's lanes per step: [L, S] -> f64[n_groups, S].
    ``groups`` gives each lane's group id (tensor or numpy); ``csr`` may
    pass ``group_csr(groups, n_groups)`` built ahead."""
    _check_agg(agg)
    if out.device.type == "cpu":
        groups = groups if isinstance(groups, torch.Tensor) else torch.from_numpy(
            np.asarray(groups, dtype=np.int64))
        return grouped_reduce_plain(out, groups, n_groups, agg)
    if not out.is_cuda:
        raise ValueError(f"unsupported device {out.device}")
    members, offsets = csr if csr is not None else group_csr(groups, n_groups)
    return _launch(out, members, offsets, agg, float("nan"))


def fleet_nansum(x: torch.Tensor) -> torch.Tensor:
    """NaN-skipping sum over the lane axis: [L, S] -> f64[S]."""
    if x.device.type == "cpu":
        return fleet_nansum_plain(x)
    if not x.is_cuda:
        raise ValueError(f"unsupported device {x.device}")
    offsets = np.asarray([0, x.shape[0]], dtype=np.int64)
    return _launch(x, None, offsets, "sum", 0.0)[0]
