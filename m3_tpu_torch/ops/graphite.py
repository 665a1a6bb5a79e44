"""Graphite's grouped reductions and per-series transforms: the CUDA kernels
GK2 and GK3 with their plain PyTorch versions, the group-by kernel QK4
they share with PromQL, and the plain-torch glue around them.

Port of ``m3_tpu/models/query_pipeline.py:_graphite_grouped_reduce`` (G1,
the ``gagg`` node) and ``_graphite_call`` (G2, the ``gcall`` node), the
device forms of the host Graphite library's numpy NaN-reductions.

- The grouped NaN-reductions (``GROUP_OPS``) are QK4,
  ``query_grouped.grouped_reduce`` (``csrc/query_grouped.cu``): per
  (group, step) the NaN-skipping sum (0.0 over nothing), count (0.0 over
  nothing), avg, min, max, multiply (1.0 over nothing), range, population
  stddev (two passes), and the single-group diff (``2 * row0 - sum``)
  and last (the highest non-NaN row).  Its sums and products are folded
  in lane order within each warp's stride of the group's lanes, then in
  warp order: the in-order ones that XLA:CPU's segment ops compute for a
  group of at most 32 lanes, within rounding of them above.
- GK2 ``percentile_columns`` / ``percentile_rows`` (in
  ``csrc/query_select.cu`` beside QK6): ``jnp.nanpercentile`` in its own
  arithmetic (``h = q * (n - 1)``, both indices clamped to ``[0, n-1]``,
  ``lo * (1 - w) + hi * w``) over the lanes of each step (medianSeries,
  percentileOfSeries) or over each lane's real steps (nPercentile,
  remove{Above,Below}Percentile), in the order of (key, position) with
  -0.0 equal to +0.0 and NaN last, as ``lax.sort`` compares.  The column
  form selects the two order statistics of each step (a radix select over
  the order key); the row form sorts each lane.
- GK3 ``row_transform`` (``csrc/graphite_call.cu``): a warp stages
  [32 lanes x ROW_TILE steps] tiles in shared memory and each thread walks
  its lane's steps: integral, integralByInterval, keepLastValue,
  summarize, offsetToZero, minMax and moving{Average,Sum,Max,Min} (the
  sums of a window wider than ROW_TILE block-wise, as
  ``_block_window_sums`` says).

On a CUDA tensor each wrapper launches its kernel or raises; on a CPU
tensor it runs the plain version, which repeats the kernel's arithmetic
in the same order.  Nothing falls back.  The elementwise and shift
families (``ELEMENTWISE_FNS``, ``SHIFT_FNS``) and ``count_series`` are
glue: the same torch code on the CPU and the card.

Every ``call`` first sets the columns past ``real_S = statics[0]`` to NaN
(the reference's array edge); ops that fill them (transformNull,
isNonNull, changed, minMax, integral, keepLastValue, the moving windows)
leave values there, as the reference does.
"""

from __future__ import annotations

import torch

from m3_tpu_torch.ops import _build, ieee, query_grouped

I64 = torch.int64
F64 = torch.float64
NAN = float("nan")
INF = float("inf")

GROUP_OPS = ("sum", "count", "avg", "min", "max", "multiply", "range", "stddev", "diff",
             "last")  # QK4's ops (query_grouped.OPS)
# numpy's nansum, count and nanprod over no present cell; the others give NaN
GROUP_EMPTY = {"sum": 0.0, "count": 0.0, "multiply": 1.0}
SINGLE_GROUP_OPS = ("diff", "median", "percentile", "last")
GAGG_OPS = GROUP_OPS + ("count_series", "median", "percentile")

ROW_FNS = ("integral", "integralByInterval", "keepLastValue", "summarize", "offsetToZero",
           "minMax", "movingAverage", "movingSum", "movingMax",
           "movingMin")  # enum Fn of csrc/graphite_call.cu
SUMMARIZE_FUNCS = ("sum", "avg", "max", "min", "count", "range",
                   "multiply")  # enum Func of csrc/graphite_call.cu
SUMMARIZE_ALIASES = {"total": "sum", "": "sum", "average": "avg", "rangeOf": "range"}
PERCENTILE_FNS = ("nPercentile", "removeAbovePercentile",
                  "removeBelowPercentile")  # row modes 1-3 of the percentile kernel
ELEMENTWISE_FNS = ("scale", "offset", "absolute", "invert", "logarithm", "pow", "squareRoot",
                   "transformNull", "removeAboveValue", "removeBelowValue", "isNonNull",
                   "timeSlice")
SHIFT_FNS = ("derivative", "nonNegativeDerivative", "perSecond", "changed", "delay")
CALL_FNS = ELEMENTWISE_FNS + SHIFT_FNS + ROW_FNS + PERCENTILE_FNS

# percentile kernel's row form: the padded row a warp sorts in shared memory
ROW_SMEM_P = 512
ROW_WARPS = 8  # warps per block of the row form (kRowWarps of csrc/query_select.cu)
# GK3: steps per staged tile and per block of a wide moving window (kT of
# csrc/graphite_call.cu)
ROW_TILE = 16


def _matrix(x: torch.Tensor) -> torch.Tensor:
    if x.dim() != 2:
        raise ValueError(f"expected an [L, S] matrix, got {tuple(x.shape)}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {x.device}")
    return x.to(F64).contiguous()


def _stream(dev):
    return torch.cuda.current_stream(dev).cuda_stream


def _check_single_group(groups) -> None:
    if (query_grouped.host_ids(groups) != 0).any():
        raise ValueError("diff, median, percentile and last reduce one group: every group "
                         "id must be 0")


def _finite(q) -> float:
    """A percentile argument: any finite number (outside [0, 100] jnp's
    clamped indices give the extreme value, as the reference serves it)."""
    q = float(q)
    if q != q or abs(q) == INF:
        raise ValueError(f"the percentile must be finite, got {q}")
    return q


def percentile_fraction(q: float) -> float:
    """``jnp.nanpercentile``'s ``q / 100`` (correctly rounded, as XLA folds
    the constant division)."""
    return float(q) / 100.0


# --- GK2: NaN-aware percentiles (linear; the median's midpoint) ------------


def nanpercentile_plain(x: torch.Tensor, qf: float, dim: int,
                       midpoint: bool = False) -> torch.Tensor:
    """``jnp.nanpercentile(x, 100 * qf, axis=dim, keepdims=True)`` in jnp's
    arithmetic, or with ``midpoint`` ``jnp.nanquantile``'s midpoint method,
    ``(lo + hi) * 0.5``, which ``jnp.nanmedian`` takes at 0.5.  The order is
    a stable sort of a key with -0.0 as +0.0 and NaN as +inf; a NaN lane
    tied with a real +inf reads as +inf (the values read always lie among
    the n present ones, which jnp sorts first)."""
    m = ~torch.isnan(x)
    count = m.sum(dim, keepdim=True).to(F64)
    sortable = torch.where(m, x, INF)
    key = torch.where(sortable == 0, 0.0, sortable)
    idx = torch.sort(key, dim=dim, stable=True).indices
    sv = torch.gather(sortable, dim, idx)
    h = qf * (count - 1.0)
    low, high = torch.floor(h), torch.ceil(h)
    hw = h - low
    lw = 1.0 - hw
    top = count - 1.0
    low = torch.clamp(torch.minimum(low, top), min=0.0).to(I64)
    high = torch.clamp(torch.minimum(high, top), min=0.0).to(I64)
    lo_v, hi_v = torch.gather(sv, dim, low), torch.gather(sv, dim, high)
    r = (lo_v + hi_v) * 0.5 if midpoint else lo_v * lw + hi_v * hw
    return torch.where(count == 0, NAN, r)


def percentile_columns_plain(cv: torch.Tensor, qf: float, midpoint: bool = False) -> torch.Tensor:
    """Plain version of ``percentile_columns``."""
    return nanpercentile_plain(_matrix(cv), float(qf), 0, midpoint)[0]


def normalize(cv: torch.Tensor, real_S: int) -> torch.Tensor:
    """The columns past ``real_S`` set to NaN (every call's first step)."""
    col = torch.arange(cv.shape[1], device=cv.device)
    return torch.where(col[None, :] < real_S, cv.to(F64), NAN)


def percentile_rows_plain(cv: torch.Tensor, q: float, real_S: int, fn: str) -> torch.Tensor:
    """Plain version of ``percentile_rows``."""
    x = normalize(_matrix(cv), real_S)
    p = nanpercentile_plain(x, percentile_fraction(q), 1)
    if fn == "nPercentile":
        col = torch.arange(x.shape[1], device=x.device)
        return torch.where(col[None, :] < real_S, p.expand_as(x), NAN)
    mask = x > p if fn == "removeAbovePercentile" else x < p
    return torch.where(mask, NAN, x)


_SELECT_SIGNATURES = {
    "m3_graphite_percentile": [_build.P, _build.LL, _build.LL, _build.I, _build.I, _build.D,
                               _build.I, _build.LL, _build.P, _build.P, _build.I, _build.P,
                               _build.P],
    "m3_graphite_percentile_scratch": ([_build.LL, _build.LL], _build.LL),
}


def _launch_percentile(x: torch.Tensor, mode: int, qf: float, real_S: int) -> torch.Tensor:
    dev = x.device
    L, S = x.shape
    lib = _build.library("query_select", _SELECT_SIGNATURES)
    if mode in (0, 4):  # the radix selection; its scratch carved by the C side
        out = torch.empty((S,), dtype=F64, device=dev)
        if not (L and S):
            return out.fill_(NAN)
        p_smem, grid, p_scratch = 0, 0, int(lib.m3_graphite_percentile_scratch(L, S))
        scratch = torch.empty((p_scratch,), dtype=torch.uint8, device=dev)
        keys_ptr, pos_ptr = scratch.data_ptr(), None
    else:  # a warp per lane over its real_S steps
        out = torch.empty((L, S), dtype=F64, device=dev)
        if not (L and S):
            return out
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        P = query_grouped.pow2(real_S)
        p_smem = min(P, ROW_SMEM_P)
        p_scratch = P if P > ROW_SMEM_P else 0
        grid = max(1, min(-(-L // ROW_WARPS), sms * 4))
        keys = torch.empty((grid * ROW_WARPS * p_scratch,), dtype=I64, device=dev)
        pos = torch.empty((grid * ROW_WARPS * p_scratch,), dtype=torch.int32, device=dev)
        keys_ptr, pos_ptr = (keys.data_ptr(), pos.data_ptr()) if p_scratch else (None, None)
    rc = lib.m3_graphite_percentile(x.data_ptr(), L, S, real_S, mode, qf, p_smem, p_scratch,
                                    keys_ptr, pos_ptr, grid, out.data_ptr(), _stream(dev))
    kernel = "graphite_percentile" if mode in (0, 4) else "graphite_percentile_rows"
    _build.check(lib, rc, kernel)
    _build.count_launch(kernel)
    return out


def percentile_columns(cv: torch.Tensor, qf: float, midpoint: bool = False) -> torch.Tensor:
    """GK2's column form: ``jnp.nanpercentile`` over the lanes of each step
    at the fraction ``qf`` (``percentile_fraction(q)``), [L, S] -> f64[S];
    with ``midpoint`` the two cells' midpoint, as ``jnp.nanmedian`` reads
    them at 0.5."""
    qf = _finite(qf)
    x = _matrix(cv)
    if x.device.type == "cpu":
        return percentile_columns_plain(x, qf, midpoint)
    return _launch_percentile(x, 4 if midpoint else 0, qf, x.shape[1])


def percentile_rows(cv: torch.Tensor, q: float, real_S: int, fn: str) -> torch.Tensor:
    """GK2's row form: each lane's ``jnp.nanpercentile`` at ``q`` (0-100)
    over its first ``real_S`` steps, then ``fn``: nPercentile (the
    percentile on every real step, NaN past them) or
    remove{Above,Below}Percentile (cells above / below it NaN).
    [L, S] -> f64[L, S]."""
    if fn not in PERCENTILE_FNS:
        raise ValueError(f"no percentile form for {fn}")
    _finite(q)
    x = _matrix(cv)
    real_S = min(int(real_S), x.shape[1])
    if x.device.type == "cpu":
        return percentile_rows_plain(x, q, real_S, fn)
    return _launch_percentile(x, 1 + PERCENTILE_FNS.index(fn), percentile_fraction(q), real_S)


# --- GK3: per-lane scans, buckets, row reductions, moving windows ---------


def _shift(x: torch.Tensor, d: int, fill: float) -> torch.Tensor:
    """x moved d columns right, ``fill`` in the d leading columns."""
    if d == 0:
        return x
    out = torch.full_like(x, fill)
    out[:, d:] = x[:, :-d]
    return out


def _row_extremes(x: torch.Tensor, m: torch.Tensor):
    """Each row's nanmin and nanmax (NaN over an all-NaN row), -0.0 below
    +0.0 as XLA's min/max order them."""
    lo = torch.full((x.shape[0],), INF, dtype=F64, device=x.device)
    hi = torch.full_like(lo, -INF)
    for c in range(x.shape[1]):
        lo = ieee.minimum(lo, torch.where(m[:, c], x[:, c], INF))
        hi = ieee.maximum(hi, torch.where(m[:, c], x[:, c], -INF))
    empty = ~m.any(dim=1)
    return torch.where(empty, NAN, lo)[:, None], torch.where(empty, NAN, hi)[:, None]


def _reduce_func(func: str, vals: list, ms: list):
    """summarize's ``func`` over the cells of a bucket, in order."""
    acc = torch.zeros_like(vals[0])
    cnt, prod = torch.zeros_like(acc), torch.ones_like(acc)
    lo, hi = torch.full_like(acc, INF), torch.full_like(acc, -INF)
    for v, m in zip(vals, ms):
        acc = acc + torch.where(m, v, 0.0)
        cnt = cnt + m.to(F64)
        prod = prod * torch.where(m, v, 1.0)
        lo = ieee.minimum(lo, torch.where(m, v, INF))
        hi = ieee.maximum(hi, torch.where(m, v, -INF))
    empty = cnt == 0
    if func == "sum":
        return acc
    if func == "avg":
        return torch.where(empty, NAN, acc / torch.clamp(cnt, min=1.0))
    if func == "max":
        return torch.where(empty, NAN, hi)
    if func == "min":
        return torch.where(empty, NAN, lo)
    if func == "count":
        return cnt
    if func == "range":
        return torch.where(empty, NAN, hi - lo)
    return prod  # multiply


def _block_window_sums(vz: torch.Tensor, w: int) -> torch.Tensor:
    """The sums of the windows of w > ROW_TILE cells up to each column, in
    the kernel's block-wise grouping: the columns cut into aligned blocks
    of ROW_TILE; for column c in block cb whose window starts at s (0 at
    the least) in block hb < cb, ``(head + mid) + part`` with head the fold
    of block hb from s to its end, right to left from 0.0, mid the in-order
    fold from 0.0 of the in-order sums of blocks hb+1..cb-1, and part the
    in-order fold of block cb up to c; a window inside block cb (only in
    block 0) is part alone."""
    T = ROW_TILE
    L, S = vz.shape
    nb = -(-S // T)
    v = torch.zeros((L, nb * T), dtype=F64, device=vz.device)
    v[:, :S] = vz
    v = v.view(L, nb, T)
    part, head = torch.empty_like(v), torch.empty_like(v)
    acc = torch.zeros((L, nb), dtype=F64, device=vz.device)
    for j in range(T):
        acc = acc + v[:, :, j]
        part[:, :, j] = acc
    sums = acc
    acc = torch.zeros_like(acc)
    for j in range(T - 1, -1, -1):
        acc = v[:, :, j] + acc
        head[:, :, j] = acc
    part, head = part.view(L, nb * T), head.view(L, nb * T)
    out = torch.empty_like(vz)
    cols: dict = {}  # (hb, cb) -> the columns and their window starts
    for c in range(S):
        s = max(0, c - w + 1)
        cols.setdefault((s // T, c // T), []).append((c, s))
    for (hb, cb), cs in cols.items():
        c = torch.tensor([c for c, _ in cs], device=vz.device)
        if hb == cb:
            out[:, c] = part[:, c]
            continue
        mid = torch.zeros(L, dtype=F64, device=vz.device)
        for b in range(hb + 1, cb):
            mid = mid + sums[:, b]
        s = torch.tensor([s for _, s in cs], device=vz.device)
        out[:, c] = (head[:, s] + mid[:, None]) + part[:, c]
    return out


def row_transform_plain(cv: torch.Tensor, fn: str, real_S: int, k: int = 1, func: str = "sum",
                        limit: float = INF) -> torch.Tensor:
    """Plain version of ``row_transform``: the kernel's walk along each
    lane, step by step for every lane at once."""
    x = normalize(_matrix(cv), real_S)
    L, S = x.shape
    m = ~torch.isnan(x)
    vz = torch.where(m, x, 0.0)
    out = torch.full_like(x, NAN)
    if fn == "integral":
        acc = torch.zeros(L, dtype=F64, device=x.device)
        for c in range(S):
            acc = acc + vz[:, c]
            out[:, c] = acc
        return out
    if fn == "integralByInterval":
        for c in range(real_S):
            acc = (0.0 if c % k == 0 else acc) + vz[:, c]
            out[:, c] = acc
        return out
    if fn == "keepLastValue":
        last_v = torch.full((L,), NAN, dtype=F64, device=x.device)
        last_c = torch.full((L,), -1, dtype=I64, device=x.device)
        for c in range(S):
            mc = m[:, c]
            last_v = torch.where(mc, x[:, c], last_v)
            last_c = torch.where(mc, c, last_c)
            fill = (last_c >= 0) & ((c - last_c).to(F64) <= limit)
            out[:, c] = torch.where(mc, x[:, c], torch.where(fill, last_v, NAN))
        return out
    if fn == "summarize":
        for b0 in range(0, real_S, k):
            cols = range(b0, min(b0 + k, real_S))
            val = _reduce_func(func, [x[:, c] for c in cols], [m[:, c] for c in cols])
            out[:, cols.start:cols.stop] = val[:, None]
        return out
    if fn == "offsetToZero":
        lo, _ = _row_extremes(x, m)
        return x - lo
    if fn == "minMax":
        lo, hi = _row_extremes(x, m)
        rng = hi - lo
        v = (x - lo) / torch.where(rng == 0, NAN, rng)
        return torch.where(torch.isfinite(v), v, 0.0)
    # the moving windows: the w cells up to each column, oldest first,
    # columns before the first absent; max, min and the counts do not depend
    # on the grouping, the sums of a window wider than ROW_TILE are
    # block-wise (_block_window_sums)
    w = k
    acc = torch.zeros_like(x)
    cnt, lo, hi = torch.zeros_like(x), torch.full_like(x, INF), torch.full_like(x, -INF)
    for d in range(min(w, S) - 1, -1, -1):
        if w <= ROW_TILE:
            acc = acc + _shift(vz, d, 0.0)
        mm = _shift(m.to(F64), d, 0.0)
        cnt = cnt + mm
        lo = ieee.minimum(lo, _shift(torch.where(m, x, INF), d, INF))
        hi = ieee.maximum(hi, _shift(torch.where(m, x, -INF), d, -INF))
    if w > ROW_TILE:
        acc = _block_window_sums(vz, w)
    empty = cnt == 0
    if fn == "movingSum":
        return acc
    if fn == "movingAverage":
        return torch.where(empty, NAN, acc / torch.clamp(cnt, min=1.0))
    if fn == "movingMax":
        return torch.where(empty, NAN, hi)
    return torch.where(empty, NAN, lo)  # movingMin


_ROW_SIGNATURES = {
    "m3_graphite_row": [_build.P, _build.LL, _build.LL, _build.I, _build.I, _build.LL, _build.I,
                        _build.D, _build.P, _build.LL, _build.P, _build.P],
}


def row_transform(cv: torch.Tensor, fn: str, real_S: int, k: int = 1, func: str = "sum",
                  limit: float = INF) -> torch.Tensor:
    """GK3: ``fn`` along each lane of [L, S] -> f64[L, S], the columns past
    ``real_S`` read as NaN.  ``k`` is the bucket size (integralByInterval,
    summarize) or the window width (moving*), ``func`` summarize's
    reducer (its aliases allowed), ``limit`` keepLastValue's gap limit
    (+inf for none)."""
    if fn not in ROW_FNS:
        raise ValueError(f"no device form for graphite function {fn}()")
    func = SUMMARIZE_ALIASES.get(func, func)
    if func not in SUMMARIZE_FUNCS:
        raise ValueError(f"no device form for summarize {func!r}")
    k = int(k)
    if k < 1:
        raise ValueError(f"bucket size or window width must be at least 1, got {k}")
    x = _matrix(cv)
    real_S = min(int(real_S), x.shape[1])
    if x.device.type == "cpu":
        return row_transform_plain(x, fn, real_S, k, func, float(limit))
    return _launch_row(x, fn, real_S, k, func, float(limit))


def _launch_row(x: torch.Tensor, fn: str, real_S: int, k: int, func: str,
                limit: float) -> torch.Tensor:
    dev = x.device
    L, S = x.shape
    out = torch.empty_like(x)
    if L and S:
        # a wide moving window's per-block folds (f64) and counts (i32)
        wide = fn.startswith("moving") and k > ROW_TILE
        scratch = torch.empty((-(-S // ROW_TILE) * L * 12,), dtype=torch.uint8,
                              device=dev) if wide else None
        lib = _build.library("graphite_call", _ROW_SIGNATURES)
        rc = lib.m3_graphite_row(x.data_ptr(), L, S, real_S, ROW_FNS.index(fn), k,
                                 SUMMARIZE_FUNCS.index(func), limit,
                                 scratch.data_ptr() if wide else None,
                                 scratch.numel() if wide else 0, out.data_ptr(), _stream(dev))
        _build.check(lib, rc, "graphite_row")
        _build.count_launch("graphite_row")
    return out


# --- the node forms ---------------------------------------------------------


def grouped_reduce(cv: torch.Tensor, groups, g_pad: int, op: str, extra=(), tval=0.0,
                   index: query_grouped.GroupIndex | None = None) -> torch.Tensor:
    """The ``gagg`` node's reduce (the reference's signature): [L, S] ->
    f64[g_pad, S].  ``extra`` holds percentile's q; ``tval`` is
    countSeries' constant.  median and percentile take one group over every
    lane and answer in row 0."""
    if op not in GAGG_OPS:
        raise ValueError(f"no device form for graphite reducer {op}")
    x = _matrix(cv)
    S = x.shape[1]
    if op == "count_series":
        return torch.full((g_pad, S), float(tval), dtype=F64, device=x.device)
    if op in ("median", "percentile"):
        _check_single_group(groups)
        col = (percentile_columns(x, 0.5, midpoint=True) if op == "median" else
               percentile_columns(x, percentile_fraction(extra[0])))
        row0 = torch.arange(g_pad, device=x.device)[:, None] == 0
        return torch.where(row0, col[None, :], NAN)
    if op in SINGLE_GROUP_OPS:
        _check_single_group(groups)
    return query_grouped.grouped_reduce(x, groups, g_pad, op, index, GROUP_EMPTY.get(op, NAN))


def _scalars(fparams) -> list[float]:
    return [float(p) for p in fparams]


def call(fn: str, cv: torch.Tensor, statics: tuple, fparams, steps: torch.Tensor) -> torch.Tensor:
    """The ``gcall`` node's transform (the reference's signature): ``statics``
    = (real_S, ...) from the plan, ``fparams`` its scalars (host tensors or
    numbers; timeSlice's two int64 bounds), ``steps`` the padded step grid.
    [L, S] -> f64[L, S]."""
    if fn not in CALL_FNS:
        raise ValueError(f"no device form for graphite function {fn}()")
    real_S = int(statics[0])
    if fn in ROW_FNS:
        if fn == "summarize":
            return row_transform(cv, fn, real_S, k=int(statics[1]), func=statics[2])
        if fn == "keepLastValue":
            return row_transform(cv, fn, real_S, limit=_scalars(fparams)[0])
        k = int(statics[1]) if len(statics) > 1 else 1
        return row_transform(cv, fn, real_S, k=k)
    if fn in PERCENTILE_FNS:
        return percentile_rows(cv, float(statics[1]), real_S, fn)
    x = normalize(_matrix(cv), real_S)
    m = ~torch.isnan(x)
    L, S = x.shape
    if fn == "timeSlice":
        lo, hi = (int(p) for p in fparams)  # int64 bounds against the int64 steps
        keep = (steps >= lo) & (steps <= hi)
        return torch.where(keep[None, :], x, NAN)
    p = _scalars(fparams)
    if fn == "scale":
        return x * p[0]
    if fn == "offset":
        return x + p[0]
    if fn == "absolute":
        return torch.abs(x)
    if fn == "invert":
        v = 1.0 / x
        return torch.where(torch.isinf(v), NAN, v)
    if fn == "logarithm":  # p[0] = ln(base), computed on the host
        v = torch.log(x) / p[0]
        return torch.where(torch.isfinite(v), v, NAN)
    if fn == "pow":
        return ieee.pow(x, p[0])
    if fn == "squareRoot":
        v = ieee.sqrt(x)
        return torch.where(torch.isfinite(v), v, NAN)
    if fn == "transformNull":
        return torch.where(m, x, p[0])
    if fn == "removeAboveValue":
        return torch.where(x > p[0], NAN, x)
    if fn == "removeBelowValue":
        return torch.where(x < p[0], NAN, x)
    if fn == "isNonNull":
        return m.to(F64)
    if fn == "changed":
        ch = (x[:, 1:] != x[:, :-1]) & m[:, 1:] & m[:, :-1]
        return torch.cat([torch.zeros((L, 1), dtype=F64, device=x.device), ch.to(F64)], dim=1)
    if fn == "delay":
        k = int(statics[1])
        kk = min(abs(k), S)
        pad = torch.full((L, kk), NAN, dtype=F64, device=x.device)
        if k >= 0:
            return torch.cat([pad, x[:, :S - kk]], dim=1)
        return torch.cat([x[:, kk:], pad], dim=1)
    # derivative, nonNegativeDerivative, perSecond (p[0] = step seconds)
    d = x[:, 1:] - x[:, :-1]
    if fn == "perSecond":
        d = d / p[0]
    if fn != "derivative":
        d = torch.where(d < 0, NAN, d)  # NaN < 0 is False: NaN stays
    return torch.cat([torch.full((L, 1), NAN, dtype=F64, device=x.device), d], dim=1)

