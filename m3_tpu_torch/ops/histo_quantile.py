"""histogram_quantile's bucket interpolation: the CUDA kernel QK8 and its
plain PyTorch version.

Port of ``m3_tpu/ops/histo_quantile.py:bucket_quantile`` together with
the row gather in front of it in the fused interpreter
(``m3_tpu/models/query_pipeline.py``, ``counts = cv[rows_idx]``): the
host groups ``le`` buckets into a dense ``[groups, buckets]`` layout of
rows of the child matrix, sorted by upper bound; per (group, step) the
device takes the running max of the bucket counts (upstream
ensureMonotonic), finds the first bucket at or above ``phi * total`` and
interpolates linearly inside it.

Padding contract (the planner's): the bucket axis is padded by repeating
the +Inf top bucket's row, so a padded slot never becomes the target for
phi in [0, 1]; ``caps[g]`` is the highest finite upper bound; padding
groups are masked by the caller.  Out-of-range phi follows upstream:
phi < 0 gives -Inf, phi > 1 +Inf, NaN phi NaN.

- On a CUDA tensor ``bucket_quantile`` launches
  ``csrc/histo_quantile.cu`` (one thread per (group, step), reading the
  gathered rows in place) or raises.
- On a CPU tensor it runs ``bucket_quantile_plain``, the reference's
  formulation on the gathered ``[G, B, S]`` counts.
"""

from __future__ import annotations

import torch

from m3_tpu_torch.ops import _build, ieee

I64 = torch.int64
F64 = torch.float64
MAX_GROUPS = 65535  # the kernel's grid.y


def bucket_quantile_plain(cv: torch.Tensor, rows_idx: torch.Tensor, ubs: torch.Tensor,
                          caps: torch.Tensor, phi: float) -> torch.Tensor:
    """Plain version of ``bucket_quantile`` (same arguments)."""
    phi = float(phi)
    counts = torch.nan_to_num(cv[rows_idx.to(cv.device, I64)])  # [G, B, S]; +-Inf -> +-max
    B = counts.shape[1]
    c = counts.clone()
    for b in range(1, B):  # lax.cummax with jnp.maximum's signed zeros
        c[:, b] = ieee.maximum(c[:, b - 1], counts[:, b])
    total = c[:, -1, :]
    rank = phi * total
    idx = (c < rank[:, None, :]).sum(dim=1).clamp(0, B - 1)
    ubs = ubs.to(cv.device, F64)
    hi_ub = torch.gather(ubs, 1, idx)
    lo_ub = torch.where(idx > 0, torch.gather(ubs, 1, (idx - 1).clamp(min=0)), 0.0)
    hi_c = torch.gather(c, 1, idx[:, None, :])[:, 0, :]
    lo_c = torch.where(idx > 0, torch.gather(c, 1, (idx - 1).clamp(min=0)[:, None, :])[:, 0, :],
                       0.0)
    frac = (rank - lo_c) / ieee.maximum(hi_c - lo_c, 1e-12)
    val = lo_ub + (hi_ub - lo_ub) * ieee.minimum(1.0, ieee.maximum(0.0, frac))
    val = torch.where((idx == 0) & (hi_ub <= 0), hi_ub, val)
    val = torch.where(torch.isposinf(hi_ub), caps.to(cv.device, F64)[:, None], val)
    val = torch.where(total > 0, val, torch.nan)
    if phi < 0:
        return torch.full_like(val, -torch.inf)
    if phi > 1:
        return torch.full_like(val, torch.inf)
    return torch.full_like(val, torch.nan) if phi != phi else val


_SIGNATURES = {
    "m3_histo_quantile": [_build.P, _build.LL, _build.P, _build.P, _build.P, _build.LL, _build.I,
                          _build.D, _build.P, _build.P],
}


def bucket_quantile(cv: torch.Tensor, rows_idx, ubs, caps, phi) -> torch.Tensor:
    """The phi-quantile of each group's buckets per step.

    cv f64[R, S] (the child's rows), rows_idx i64[G, B] (rows of cv, one
    per bucket, ascending upper bound), ubs f64[G, B] (upper bounds,
    +Inf top, padding repeats it), caps f64[G] (highest finite bound), phi
    a runtime float.  Returns f64[G, S].  Index and bound arrays may be
    numpy or tensors; they are moved to cv's device."""
    rows_idx, ubs, caps = (torch.as_tensor(x) for x in (rows_idx, ubs, caps))
    if cv.device.type == "cpu":
        return bucket_quantile_plain(cv, rows_idx, ubs, caps, phi)
    if not cv.is_cuda:
        raise ValueError(f"unsupported device {cv.device}")
    return _launch(cv, rows_idx, ubs, caps, phi)


def _launch(cv: torch.Tensor, rows_idx, ubs, caps, phi) -> torch.Tensor:
    if cv.dim() != 2 or rows_idx.dim() != 2 or ubs.shape != rows_idx.shape \
            or caps.shape != rows_idx.shape[:1]:
        raise ValueError("expected cv [R, S], rows_idx and ubs [G, B], caps [G]")
    G, B = rows_idx.shape
    if G > MAX_GROUPS or B < 1:
        raise ValueError(f"at most {MAX_GROUPS} groups and at least one bucket")
    dev = cv.device
    S = cv.shape[1]
    x = cv.to(F64).contiguous()
    ri, ub, cp = (t.to(dev, dtype, non_blocking=True).contiguous()
                  for t, dtype in ((rows_idx, I64), (ubs, F64), (caps, F64)))
    out = torch.empty((G, S), dtype=F64, device=dev)
    if G and S:
        lib = _build.library("histo_quantile", _SIGNATURES)
        rc = lib.m3_histo_quantile(x.data_ptr(), S, ri.data_ptr(), ub.data_ptr(), cp.data_ptr(),
                                   G, B, float(phi), out.data_ptr(),
                                   torch.cuda.current_stream(dev).cuda_stream)
        _build.check(lib, rc, "histo_quantile")
        _build.count_launch("histo_quantile")
    return out
