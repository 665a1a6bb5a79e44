"""Device-resident PromQL read pipeline: decode -> merge -> rate/reduce
-> group-by, with only the [series or groups, steps] result leaving the
card.

Port of the serving pipelines of ``m3_tpu/models/query_pipeline.py``,
with the same arguments and the same result tuples: the per-node
``device_rate_pipeline``, ``device_reduce_pipeline`` and
``device_grouped_pipeline``, and the fused expression interpreter
``device_expr_pipeline`` / ``device_expr_pipeline_batched`` for every
node form, PromQL's and Graphite's (see ``_expr_eval``); and their
series-sharded forms over a mesh (``parallel/mesh.py``):
``device_rate_sharded``, ``device_temporal_sharded``,
``device_grouped_sharded`` and ``device_expr_pipeline_sharded`` (see
"Series-sharded serving" below).  Each stage is a hand-written CUDA kernel
on the card:

- decode: ``ops/m3tsz_decode.decode_batched`` (K3) at stream width with
  truncation flagged;
- tier cut + merge into ``[n_lanes, n_cap]`` lanes: ``ops/query_merge``
  (QK1);
- the windowed function: ``ops/query_temporal`` (QK2 rate family, QK3
  prefix-sum reducers, changes/resets and deriv/predict_linear, QK5
  min/max over time, QK9 stddev/stdvar over time, QK10 holt_winters, QK11
  quantile over time);
- the group-by and the fleet sum: ``ops/query_grouped`` (QK4; QK6 for
  ``quantile``);
- the interpreter's selection nodes: ``ops/lane_topk`` (QK7, topk and
  bottomk) and ``ops/histo_quantile`` (QK8, histogram_quantile);
- the subquery node's packing of its inner grid: ``ops/query_merge``
  (QK12);
- the graphite nodes: ``ops/graphite`` (QK4's grouped NaN-reductions for
  ``gagg``, GK2 percentiles for ``gagg`` median/percentile and the
  ``gcall`` percentile family, GK3 per-lane scans, buckets and windows for
  the rest of ``gcall``).

The interpreter's elementwise glue (binary operators, comparisons,
scalar functions, padding re-masks, row gathers of vector matching and of
``gsel``, graphite's elementwise and shift functions) is plain PyTorch on
the card.

On CPU tensors (``device="cpu"``) every stage runs its plain PyTorch
version.

Series-sharded serving: lanes split into contiguous blocks over the
mesh's series shards (the mesh has one window shard), and so do their
stream rows (equal rows a shard, slots LOCAL to their shard, as
``parallel/repack.shard_repack`` lays them out).  Each entry point takes
the rank's rows (``parallel.mesh.series_sharding``; ``shard_expr_inputs``
for the interpreter) and runs the decode, the merge and the windowed
function in one launch each over the rank's lanes, the slots made
rank-global; per-lane results and error flags come back as the rank's rows.
Group ids stay GLOBAL: a grouped reduce (``_grouped_reduce_sharded``)
reduces each shard's lanes into segments ``shard * n_groups + group``
(QK4), then combines the shards with the mesh's ordered collectives (MK1);
the quantile gathers the lanes and runs QK6 on them, as the reference does.

Error contract (``_decode_merge``): a stream is flagged when its decode
failed, it did not reach its end within ``n_dp`` records, its lane
overflowed ``n_cap``, or its merged lane is not time-ascending.  Padding
streams have ``nbits == 0`` and park on the last lane; padding lanes
decode all-NaN and are inert in every aggregation.
"""

from __future__ import annotations

import numpy as np
import torch

from m3_tpu_torch.models.read_pipeline import inputs_from_numpy
from m3_tpu_torch.ops import graphite, histo_quantile, ieee, lane_topk, query_grouped
from m3_tpu_torch.ops import query_merge
from m3_tpu_torch.ops import query_temporal
from m3_tpu_torch.ops.m3tsz_decode import decode_batched
from m3_tpu_torch.parallel.mesh import (SERIES_AXIS, WINDOW_AXIS, Mesh, psum, reduce_many,
                                        shard_reduce, shard_segments)
from m3_tpu_torch.utils import xtime
from m3_tpu_torch.utils.device import resolve_device

I64 = torch.int64

TEMPORAL_FNS = (query_temporal.RATE_FNS + query_temporal.INSTANT_FNS
                + query_temporal.REDUCERS + query_temporal.MINMAX_FNS
                + query_temporal.CHANGES_FNS + query_temporal.LINREG_FNS
                + query_temporal.STDVAR_FNS + query_temporal.WINDOW_FNS)
GROUP_AGGS = query_grouped.AGGS + ("quantile",)


def _decode_merge(words, nbits, slots, n_lanes: int, n_cap: int, n_dp: int | None,
                  unit_nanos: int, tiers=None, n_tiers: int = 1):
    """Shared front half of every pipeline: batched decode at stream width
    (``n_dp or n_cap``) with truncation flagged, the tier cut when
    ``n_tiers > 1``, the merge into lanes, and the error contract.
    Returns (times i64[n_lanes, n_cap], values f64[n_lanes, n_cap],
    error bool[M])."""
    T = n_cap if n_dp is None else n_dp
    ts, vs, valid, _count, error = decode_batched(
        words, nbits, T, int_optimized=True, unit_nanos=unit_nanos, flag_truncation=True)
    times, values, counts, unsorted = query_merge.lane_merge(
        ts, vs, valid, slots, n_lanes, n_cap, tiers, n_tiers)
    error = error | ((counts > n_cap) | unsorted)[slots]
    return times, values, error


def _temporal_eval(fn: str, times, values, steps, range_nanos: int, horizon=0.0,
                   hw_sf: float = 0.5, hw_tf: float = 0.5, phi=0.5):
    """One dispatch for the whole windowed temporal family (the reference's
    signature): ``horizon`` is predict_linear's seconds ahead, ``hw_sf`` /
    ``hw_tf`` holt_winters' factors and ``phi`` quantile_over_time's, all
    kernel arguments."""
    _check_fn(fn)
    qt = query_temporal
    if fn in qt.RATE_FNS:
        return qt.rate(times, values, steps, range_nanos, is_counter=fn != "delta",
                       is_rate=fn == "rate")
    if fn in qt.INSTANT_FNS:
        return qt.instant(times, values, steps, range_nanos, is_rate=fn == "irate")
    if fn in qt.MINMAX_FNS:
        return qt.minmax_window(times, values, steps, range_nanos, is_max=fn == "max_over_time")
    if fn in qt.CHANGES_FNS:
        return qt.changes_window(times, values, steps, range_nanos, resets_only=fn == "resets")
    if fn in qt.LINREG_FNS:
        return qt.linreg_window(times, values, steps, range_nanos,
                                predict=fn == "predict_linear", horizon=float(horizon))
    if fn in qt.STDVAR_FNS:
        return qt.stdvar_window(times, values, steps, range_nanos,
                                is_stddev=fn == "stddev_over_time")
    if fn == "holt_winters":
        return qt.holt_winters_window(times, values, steps, range_nanos, hw_sf, hw_tf)
    if fn == "quantile_over_time":
        return qt.quantile_window(times, values, steps, range_nanos, float(phi))
    return qt.reduce_window(times, values, steps, range_nanos, fn)


def _grouped_reduce(out, groups, n_groups: int, agg: str, phi=0.5, index=None):
    """Group-by of a served [L, S] matrix (the reference's signature);
    ``groups`` on the host for a CUDA ``out`` (the kernels' group index is
    built from it unless ``index`` passes it built ahead)."""
    _check_agg(agg)
    if agg == "quantile":
        return query_grouped.grouped_quantile(out, groups, n_groups, phi, index)
    return query_grouped.grouped_reduce(out, groups, n_groups, agg, index)


def _check_fn(fn: str) -> None:
    if fn not in TEMPORAL_FNS:
        raise ValueError(f"no device form for {fn}")


def _check_agg(agg: str) -> None:
    if agg not in GROUP_AGGS:
        raise ValueError(f"no device form for aggregation {agg}")


def _inputs(words, nbits, slots, steps, tiers, device):
    """Everything on one device: the words' own if they are tensors, else
    ``device`` (default the CUDA device)."""
    dev = resolve_device(device, like=words)
    if not isinstance(words, torch.Tensor):
        words, nbits = inputs_from_numpy(words, nbits, dev)
    words, nbits = words.to(dev), nbits.to(dev)

    def i64(x):
        return None if x is None else torch.as_tensor(x, dtype=I64).to(dev)

    return words, nbits, i64(slots), i64(steps), i64(tiers)


def device_reduce_pipeline(words, nbits, slots, steps, n_lanes: int, n_cap: int,
                           range_nanos: int, reducer: str = "sum_over_time",
                           unit_nanos: int = xtime.SECOND, n_dp: int | None = None,
                           tiers=None, n_tiers: int = 1, horizon=0.0, hw_sf: float = 0.5,
                           hw_tf: float = 0.5, phi=0.5, device=None):
    """Compressed blocks -> ``reducer(x[range])`` per (lane, step).
    Returns (out f64[n_lanes, S], error bool[M])."""
    _check_fn(reducer)
    words, nbits, slots, steps, tiers = _inputs(words, nbits, slots, steps, tiers, device)
    times, values, error = _decode_merge(words, nbits, slots, n_lanes, n_cap, n_dp,
                                         unit_nanos, tiers, n_tiers)
    out = _temporal_eval(reducer, times, values, steps, int(range_nanos), horizon, hw_sf,
                         hw_tf, phi)
    return out, error


def device_rate_pipeline(words, nbits, slots, steps, n_lanes: int, n_cap: int,
                         range_nanos: int, is_counter: bool = True, is_rate: bool = True,
                         unit_nanos: int = xtime.SECOND, n_dp: int | None = None, tiers=None,
                         n_tiers: int = 1, device=None):
    """Compressed blocks -> per-series windowed rate.  Returns
    (rate f64[n_lanes, S], fleet_sum f64[S], error bool[M]).

    ``n_dp`` bounds one stream (one sealed block), ``n_cap`` one output
    lane (all of a series' blocks); ``range_nanos`` is a runtime argument
    of the kernels."""
    words, nbits, slots, steps, tiers = _inputs(words, nbits, slots, steps, tiers, device)
    times, values, error = _decode_merge(words, nbits, slots, n_lanes, n_cap, n_dp,
                                         unit_nanos, tiers, n_tiers)
    rate = query_temporal.rate(times, values, steps, int(range_nanos), is_counter, is_rate)
    fleet = query_grouped.fleet_nansum(rate)
    return rate, fleet, error


def device_grouped_pipeline(words, nbits, slots, steps, groups, n_lanes: int, n_groups: int,
                            n_cap: int, range_nanos: int, fn: str = "rate", agg: str = "sum",
                            unit_nanos: int = xtime.SECOND, n_dp: int | None = None,
                            tiers=None, n_tiers: int = 1, phi=0.5, device=None):
    """Compressed blocks -> ``agg by (g) (fn(x[range]))``.  Returns
    (out f64[n_groups, S], error bool[M])."""
    if fn in ("predict_linear", "holt_winters", "quantile_over_time"):
        raise ValueError(f"no grouped device form for {fn}")
    _check_fn(fn)
    _check_agg(agg)
    words, nbits, slots, steps, tiers = _inputs(words, nbits, slots, steps, tiers, device)
    # the group index is host glue: build it before the kernels are queued
    index = query_grouped.group_index(groups, n_groups, words.device) if words.is_cuda else None
    times, values, error = _decode_merge(words, nbits, slots, n_lanes, n_cap, n_dp,
                                         unit_nanos, tiers, n_tiers)
    out = _temporal_eval(fn, times, values, steps, int(range_nanos))
    return _grouped_reduce(out, groups, n_groups, agg, phi, index), error


# --- the fused expression interpreter ---------------------------------------

_EXPR_CMP = frozenset(("==", "!=", ">", "<", ">=", "<="))


def _expr_arith(op: str, a, b):
    """Elementwise arithmetic as the host tier's numpy forms: fmod for %,
    IEEE pow for ^.  One operand may be a Python float."""
    if op == "+":
        return a + b
    if op == "-":
        return a - b
    if op == "*":
        return a * b
    if op == "/":
        return a / b
    if op == "%":
        if not isinstance(a, torch.Tensor):
            a = torch.full_like(b, a)
        return torch.fmod(a, b)
    if op == "^":
        return torch.pow(a, b)
    raise ValueError(f"no device form for operator {op}")


def _expr_cmp(op: str, a, b):
    if op == "==":
        return a == b
    if op == "!=":
        return a != b
    if op == ">":
        return a > b
    if op == "<":
        return a < b
    if op == ">=":
        return a >= b
    if op == "<=":
        return a <= b
    raise ValueError(f"no device form for comparison {op}")


def _expr_scalar_fn(fn: str, v, extras, steps):
    """Elementwise scalar functions (the engine's elementwise family plus
    round/clamp*/timestamp); each maps NaN to NaN.  ``extras`` are the
    node's host scalars.  Signed zeros follow jnp: ceil/floor/abs as IEEE,
    sgn keeps the zero's sign, clamp* order -0.0 below +0.0."""
    if fn == "abs":
        return torch.abs(v)
    if fn == "ceil":
        return torch.ceil(v)
    if fn == "floor":
        return torch.floor(v)
    if fn == "exp":
        return torch.exp(v)
    if fn == "sqrt":
        return torch.sqrt(v)
    if fn == "sgn":
        return ieee.sign(v)
    if fn == "ln":
        return torch.log(v)
    if fn == "log2":
        return torch.log2(v)
    if fn == "log10":
        return torch.log10(v)
    if fn == "round":
        inv = extras[0]  # 1/to, computed on the host as the engine does
        return torch.floor(v * inv + 0.5) / inv
    if fn == "clamp_min":
        return ieee.maximum(v, extras[0])
    if fn == "clamp_max":
        return ieee.minimum(v, extras[0])
    if fn == "clamp":
        lo, hi = extras
        if not lo <= hi:  # the host: all NaN when lo > hi
            return torch.full_like(v, torch.nan)
        return ieee.minimum(hi, ieee.maximum(lo, v))
    if fn == "timestamp":
        # the reference's steps / 1e9, which XLA compiles as * 1e-9
        return torch.where(torch.isnan(v), torch.nan,
                           steps[None, :].to(torch.float64) * query_temporal.NANO)
    raise ValueError(f"no device form for function {fn}()")


def _host_scalars(p) -> tuple:
    return tuple(float(x) for x in p)


def _plan_sharded(node) -> bool:
    """Whether a plan node's output is still series-sharded under a mesh:
    leaves and the per-lane ops above them (call/vs/subq/gcall) stay
    sharded; a grouped reduce, topk, histogram_quantile, absent,
    vector-vector match or graphite row gather (gsel, gagg) gives a
    replicated result (a reduce or a lane gather at that node)."""
    tag = node[0]
    if tag == "leaf":
        return True
    if tag in ("call", "vs", "subq", "gcall"):
        return _plan_sharded(node[-1])
    return False


def _expr_eval(plan, leaves, params, steps, errors: dict, mesh: Mesh | None = None):
    """The fused-query interpreter body.  ``leaves`` hold device tensors
    (``expr_inputs_from_numpy``), ``params`` host tensors: index maps and
    bounds are moved to the device by the node that reads them
    (non-blocking copies), group ids stay on the host for the kernels' CSR.
    Returns (out, aux): aux is (present, rank) when the root is a topk node,
    else ().  Nothing is read back to the host.

    With ``mesh``, the leaves and params are the rank's (``shard_expr_inputs``):
    leaves decode the rank's ``lanes_pad // n_shards`` lanes a shard, and
    each replicating node over a sharded child inserts its collective: the
    grouped reduce over shards for ``agg``, a presence count over shards
    for ``absent``, a lane gather ahead of topk, histogram_quantile,
    vector-vector matches, ``gsel`` and ``gagg`` (their index maps are
    global)."""
    aux = ()
    dev = steps.device

    def on_dev(x):
        return x.to(dev, non_blocking=True)

    def gather(vals, valid, node):
        if mesh is not None and _plan_sharded(node):
            return mesh.gather_rows(vals), _gather_mask(mesh, valid)
        return vals, valid

    def ev(node, steps_cur):
        nonlocal aux
        tag = node[0]
        if tag == "leaf":
            (_, i, pidx, kind, fn, lanes_pad, n_cap, n_dp, n_tiers,
             _m_pad, _w_pad, _s_pad, hw_sf, hw_tf) = node
            lf = leaves[i]
            if kind == "words":
                slots, n_lanes = lf["slots"], lanes_pad
                if mesh is not None:
                    slots, n_lanes = _rank_slots(mesh, slots, lanes_pad)
                times, values, err = _decode_merge(
                    lf["words"], lf["nbits"], slots, n_lanes, n_cap, n_dp,
                    xtime.SECOND, lf["tiers"], n_tiers)
                errors[i] = err
            else:
                times, values = lf["times"], lf["values"]
            horizon, phi = _host_scalars(params[pidx])
            out = _temporal_eval(fn, times, values, lf["steps"], int(lf["rng"]),
                                 horizon=horizon, hw_sf=hw_sf, hw_tf=hw_tf, phi=phi)
            return torch.where(lf["valid"][:, None], out, torch.nan), lf["valid"]
        if tag == "agg":
            _, op, g_pad, pidx, child = node
            cv, _cvalid = ev(child, steps_cur)
            groups, gvalid, phi = params[pidx]
            if mesh is not None and _plan_sharded(child):
                out = _grouped_reduce_sharded(mesh, cv, groups, g_pad, op, float(phi))
            else:
                out = _grouped_reduce(cv, groups, g_pad, op, float(phi))
            gvalid = on_dev(gvalid)
            return torch.where(gvalid[:, None], out, torch.nan), gvalid
        if tag == "call":
            _, fn, pidx, child = node
            cv, cvalid = ev(child, steps_cur)
            out = _expr_scalar_fn(fn, cv, _host_scalars(params[pidx]), steps_cur)
            return torch.where(cvalid[:, None], out, torch.nan), cvalid
        if tag == "vs":
            _, op, bool_mod, mat_on_left, pidx, child = node
            cv, cvalid = ev(child, steps_cur)
            (s,) = _host_scalars(params[pidx])
            a, b = (cv, s) if mat_on_left else (s, cv)
            if op in _EXPR_CMP:
                # the host's matrix-scalar comparison: NaN cells never match
                keep = _expr_cmp(op, a, b) & ~torch.isnan(cv)
                if bool_mod:
                    out = torch.where(torch.isnan(cv), torch.nan,
                                      torch.where(keep, 1.0, 0.0).to(cv.dtype))
                else:
                    out = torch.where(keep, cv, torch.nan)
            else:
                # the host's matrix-scalar arithmetic does not mask NaN
                # (numpy: NaN^0 == 1 for real cells)
                out = _expr_arith(op, a, b)
            return torch.where(cvalid[:, None], out, torch.nan), cvalid
        if tag == "vv":
            _, op, bool_mod, _out_pad, pidx, lhs, rhs = node
            lv, _lvalid = gather(*ev(lhs, steps_cur), lhs)
            rv, _rvalid = gather(*ev(rhs, steps_cur), rhs)
            lidx, ridx, valid = (on_dev(x) for x in params[pidx])
            a, b = lv[lidx], rv[ridx]  # the matched operand rows
            nanmask = torch.isnan(a) | torch.isnan(b)
            if op in _EXPR_CMP:
                res = _expr_cmp(op, a, b)
                if bool_mod:
                    out = torch.where(nanmask, torch.nan, torch.where(res, 1.0, 0.0).to(a.dtype))
                else:
                    out = torch.where(res & ~nanmask, a, torch.nan)
            else:
                out = torch.where(nanmask, torch.nan, _expr_arith(op, a, b))
            return torch.where(valid[:, None], out, torch.nan), valid
        if tag == "topk":
            _, op, k, g_pad, pidx, child = node
            cv, cvalid = gather(*ev(child, steps_cur), child)
            (groups,) = params[pidx]
            out, present, rank = lane_topk.masked_topk(cv, groups, g_pad, k, op == "bottomk")
            aux = (present, rank)
            return torch.where(cvalid[:, None], out, torch.nan), cvalid
        if tag == "hq":
            _, _g_pad, _b_pad, pidx, child = node
            cv, _cvalid = gather(*ev(child, steps_cur), child)
            rows_idx, ubs, caps, gvalid, phi = params[pidx]
            out = histo_quantile.bucket_quantile(cv, rows_idx, ubs, caps, float(phi))
            gvalid = on_dev(gvalid)
            return torch.where(gvalid[:, None], out, torch.nan), gvalid
        if tag == "subq":
            _, fn, _s_in_pad, hw_sf, hw_tf, pidx, child = node
            sub_times, sub_valid, steps_out, rng, horizon = params[pidx]
            cv, cvalid = ev(child, on_dev(sub_times))
            # the child's cells at real inner steps, NaN dropped, packed
            # into lanes (the host's pack_valid): QK12
            t2, v2 = query_merge.subq_pack(cv, sub_times, sub_valid)
            # phi stays at its default, as the reference's subq node has it
            out = _temporal_eval(fn, t2, v2, on_dev(steps_out), int(rng), float(horizon),
                                 hw_sf, hw_tf)
            return torch.where(cvalid[:, None], out, torch.nan), cvalid
        if tag == "gsel":
            # graphite row selection: a gather by host-computed indices
            _, _out_pad, pidx, child = node
            cv, _cvalid = gather(*ev(child, steps_cur), child)
            idx, valid = (on_dev(x) for x in params[pidx])
            return torch.where(valid[:, None], cv[idx], torch.nan), valid
        if tag == "gagg":
            _, op, extra, g_pad, pidx, child = node
            cv, _cvalid = gather(*ev(child, steps_cur), child)
            groups, gvalid, tval = params[pidx]
            out = graphite.grouped_reduce(cv, groups, g_pad, op, extra, float(tval))
            gvalid = on_dev(gvalid)
            return torch.where(gvalid[:, None], out, torch.nan), gvalid
        if tag == "gcall":
            _, fn, statics, pidx, child = node
            cv, cvalid = ev(child, steps_cur)
            out = graphite.call(fn, cv, statics, params[pidx], steps_cur)
            return torch.where(cvalid[:, None], out, torch.nan), cvalid
        if tag == "absent":
            _, pidx, child = node
            cv, _cvalid = ev(child, steps_cur)
            avalid = on_dev(params[pidx][0])
            if mesh is not None and _plan_sharded(child):
                # presence is an OR across shards: each shard's count of
                # present cells (QK4), summed over the shards (MK1)
                counts = psum(mesh, shard_reduce(mesh, cv, "count"), SERIES_AXIS)[0]
                present = counts > 0
            else:
                present = (~torch.isnan(cv)).any(dim=0)
            row0 = torch.where(present, torch.nan, 1.0).to(cv.dtype)
            first = torch.arange(avalid.shape[0], device=dev)[:, None] == 0
            return torch.where(first, row0[None, :], torch.nan), avalid
        raise ValueError(f"unknown plan node {tag!r}")

    out, _valid = ev(plan, steps)
    return out, aux


def expr_inputs_from_numpy(leaves, params, steps, device=None):
    """The reference pipeline's numpy ``leaves``/``params``/``steps`` as the
    port's tensors: every leaf array and the step grid on ``device``
    (default the CUDA device; the words as uint32, moved as int32 bit
    patterns), each leaf's window ``rng`` a host int64 tensor, and the
    params host tensors (plan-time data: the nodes move index maps and
    bounds to the device themselves and build the kernels' group CSR from
    the host group ids).  Leaf arrays that are tensors already move as they
    are.  Works with or without the batched [Q] axis."""
    dev = resolve_device(device)

    def leaf(lf):
        out = {}
        for k, v in lf.items():
            if k == "words":
                out[k], out["nbits"] = inputs_from_numpy(v, lf["nbits"], dev)
            elif k == "rng":
                out[k] = torch.as_tensor(np.asarray(v, dtype=np.int64))
            elif isinstance(v, torch.Tensor):
                out[k] = v.to(dev)
            elif k != "nbits":
                out[k] = torch.from_numpy(np.ascontiguousarray(v)).to(dev)
        return out

    host = tuple(tuple(torch.as_tensor(np.asarray(x)) for x in p) for p in params)
    return ([leaf(lf) for lf in leaves], host,
            torch.from_numpy(np.ascontiguousarray(steps, dtype=np.int64)).to(dev))


def _to(x: torch.Tensor, dev: torch.device) -> torch.Tensor:
    if x.device == dev:
        return x
    if x.dtype == torch.uint32:  # moved as int32 bit patterns
        return x.view(torch.int32).to(dev).view(torch.uint32)
    return x.to(dev)


def _expr_inputs(leaves, params, steps, device):
    """Everything on one device: the step grid's own if it is a tensor,
    else ``device`` (default the CUDA device).  Numpy inputs go through
    ``expr_inputs_from_numpy``; tensor leaves move to the device, each
    leaf's ``rng`` and the params stay on the host."""
    dev = resolve_device(device, like=steps)
    if not isinstance(steps, torch.Tensor):
        return expr_inputs_from_numpy(leaves, params, steps, dev)
    leaves = [{k: v if k == "rng" else _to(v, dev) for k, v in lf.items()} for lf in leaves]
    return leaves, params, _to(steps, dev)


def device_expr_pipeline(plan, leaves, params, steps, device=None):
    """Whole-query fused execution of a lowered PromQL or Graphite op-tree: decode,
    step consolidation and the whole temporal / aggregation / operator /
    function tree, with only the root [rows, S] matrix, ``aux`` and the
    error flags returned (nothing is read back inside the call).

    ``plan`` is the reference's static node tree (``query/plan.py``'s
    grammar; see ``m3_tpu/models/query_pipeline.py:device_expr_pipeline``):
    ``leaf`` (kind ``words`` or ``arrays``), ``agg`` (quantile included),
    ``call``, ``vs``, ``vv``, ``topk``, ``hq``, ``absent``, ``subq`` and the
    graphite nodes ``gsel``, ``gagg`` and ``gcall``.  ``leaves`` /
    ``params`` / ``steps`` are the reference's numpy inputs, moved onto
    ``device`` (default the CUDA device) by ``expr_inputs_from_numpy``,
    or what that function returns (which run where they lie unless
    ``device`` says otherwise).
    Every node re-masks padding rows to NaN after its op (the reference's
    PADDED-LANES-ARE-NaN invariant).

    Returns (out f64[rows, s_pad], aux, errors): aux is (present bool[L],
    rank i64[L]) for a topk root, else (); errors holds the decode-error
    vectors of the words-kind leaves in ascending leaf order."""
    leaves, params, steps = _expr_inputs(leaves, params, steps, device)
    errors = {}
    out, aux = _expr_eval(plan, leaves, params, steps, errors)
    return out, aux, tuple(errors[i] for i in sorted(errors))


def device_expr_pipeline_batched(plan, leaves, params, steps, device=None):
    """Cross-query megabatch: Q queries of one static ``plan``, every leaf
    array, param and the step grid with a leading [Q] axis.  Returns the
    solo contract with a leading query axis: (out f64[Q, rows, s_pad],
    aux, errors of [Q, ...]).

    Each query slice runs the solo interpreter in turn (so every slice is
    the solo call's bits); fusing the slices into one launch per kernel
    is later work."""
    leaves, params, steps = _expr_inputs(leaves, params, steps, device)
    results = [device_expr_pipeline(plan, [{k: v[q] for k, v in lf.items()} for lf in leaves],
                                     tuple(tuple(x[q] for x in p) for p in params), steps[q])
               for q in range(steps.shape[0])]
    out = torch.stack([r[0] for r in results])
    aux = tuple(torch.stack(a) for a in zip(*(r[1] for r in results)))
    errors = tuple(torch.stack(e) for e in zip(*(r[2] for r in results)))
    return out, aux, errors


# --- series-sharded serving over a mesh --------------------------------------


def _local_lanes(mesh: Mesh, n_lanes: int) -> int:
    if mesh.shape[WINDOW_AXIS] != 1:
        raise ValueError("the query pipelines shard lanes over the series axis only: "
                         "build the mesh with n_window_shards=1")
    n_s = mesh.shape[SERIES_AXIS]
    if n_lanes % n_s:
        raise ValueError(f"{n_lanes} lanes do not split over {n_s} series shards")
    return n_lanes // n_s


def _rank_slots(mesh: Mesh, slots: torch.Tensor, n_lanes: int):
    """The rank's stream rows' LOCAL slots (equal rows a shard) made
    rank-global, and the rank's lane count, for ``n_lanes`` lanes in all."""
    local = _local_lanes(mesh, n_lanes)
    spr = mesh.shards_per_rank
    if slots.shape[0] % spr:
        raise ValueError(f"{slots.shape[0]} stream rows do not split over {spr} shards")
    per_m = max(slots.shape[0] // spr, 1)
    shard = torch.arange(slots.shape[0], device=slots.device) // per_m
    return slots + shard * local, local * spr


def _gather_mask(mesh: Mesh, m: torch.Tensor) -> torch.Tensor:
    """A bool vector of the rank's rows -> every rank's (as uint8 on a group)."""
    if mesh.group is None:
        return m
    return mesh.gather_rows(m.to(torch.uint8)).bool()


def _gather_ids(mesh: Mesh, groups) -> np.ndarray:
    """Host group ids of the rank's lanes -> every rank's."""
    ids = query_grouped.host_ids(groups)
    if mesh.group is None:
        return ids
    return mesh.gather_rows(torch.from_numpy(ids).to(mesh.device)).cpu().numpy()


def _grouped_reduce_sharded(mesh: Mesh, out, groups_l, n_groups: int, agg: str, phi=0.5):
    """Sharded counterpart of ``_grouped_reduce`` (the reference's
    ``_grouped_reduce_sharded:814``): ``out`` is the rank's [lanes, S],
    ``groups_l`` their GLOBAL group ids; the result [n_groups, S] is
    replicated.  Each shard's lanes reduce into segments ``shard * n_groups
    + group`` in one QK4 launch a statistic; the shards combine in MK1.
    Every agg takes the counts; sum/avg add the sums, min/max their own
    order statistic, reduced with the counts in one gather and one MK1
    launch; stddev/stdvar the sums and a second pass (the global mean, then
    each shard's sum of squared deviations from it, QK4's ``sqdev``).
    quantile gathers the lanes and runs QK6 on them.  NaN where a
    group-step has no present cell."""
    _check_agg(agg)
    if agg == "quantile":
        return query_grouped.grouped_quantile(mesh.gather_rows(out), _gather_ids(mesh, groups_l),
                                              n_groups, phi)
    spr = mesh.shards_per_rank
    S = out.shape[1]
    n_seg = spr * n_groups
    seg = shard_segments(mesh, out.shape[0], query_grouped.host_ids(groups_l), n_groups)
    index = query_grouped.group_index(seg, n_seg, out.device) if out.is_cuda else None

    def per_shard(op: str, empty: float, center=None) -> torch.Tensor:
        part = query_grouped.grouped_reduce(out, seg, n_seg, op, index, empty, center)
        return part.reshape(spr, n_groups * S)

    def whole(parts, ops) -> list[torch.Tensor]:  # one gather, one MK1 launch
        return [r[0].reshape(n_groups, S) for r in reduce_many(mesh, parts, ops, SERIES_AXIS)]

    # the statistic reduced beside the counts, and its value over no cell
    stat, empty = {"sum": ("sum", 0.0), "avg": ("sum", 0.0), "stddev": ("sum", 0.0),
                   "stdvar": ("sum", 0.0), "min": ("min", torch.inf),
                   "max": ("max", -torch.inf)}.get(agg, (None, None))
    if stat is None:
        (counts,) = whole([per_shard("count", 0.0)], ["sum"])
    else:
        counts, red = whole([per_shard("count", 0.0), per_shard(stat, empty)], ["sum", stat])
    denom = torch.clamp(counts, min=1.0)
    if agg in ("sum", "min", "max"):
        g = red
    elif agg == "count":
        g = counts
    elif agg == "avg":
        g = red / denom
    elif agg == "group":
        g = torch.ones_like(counts)
    else:  # stddev, stdvar: the sqdev stack needs the sums first
        (sq,) = whole([per_shard("sqdev", 0.0, center=red / denom)], ["sum"])
        var = sq / denom
        g = ieee.sqrt(var) if agg == "stddev" else var
    return torch.where(counts == 0, torch.nan, g)


def device_temporal_sharded(mesh: Mesh, words, nbits, slots, steps, n_lanes: int, n_cap: int,
                            range_nanos: int, fn: str = "rate", unit_nanos: int = xtime.SECOND,
                            n_dp: int | None = None, tiers=None, n_tiers: int = 1, horizon=0.0,
                            hw_sf: float = 0.5, hw_tf: float = 0.5, phi=0.5):
    """Any temporal function series-sharded over ``mesh``: the rank's stream
    rows (equal rows a shard, slots LOCAL) decode, merge and window in one
    launch each; no collective (per-series results are independent).
    ``n_lanes`` counts every shard's lanes.  Returns (out f64[rank lanes,
    S], error bool[rank rows])."""
    _check_fn(fn)
    words, nbits, slots, steps, tiers = _inputs(words, nbits, slots, steps, tiers, mesh.device)
    slots, rank_lanes = _rank_slots(mesh, slots, n_lanes)
    times, values, error = _decode_merge(words, nbits, slots, rank_lanes, n_cap, n_dp,
                                         unit_nanos, tiers, n_tiers)
    out = _temporal_eval(fn, times, values, steps, int(range_nanos), horizon, hw_sf, hw_tf, phi)
    return out, error


def device_grouped_sharded(mesh: Mesh, words, nbits, slots, steps, groups, n_lanes: int,
                           n_groups: int, n_cap: int, range_nanos: int, fn: str = "rate",
                           agg: str = "sum", unit_nanos: int = xtime.SECOND,
                           n_dp: int | None = None, tiers=None, n_tiers: int = 1, phi=0.5):
    """``agg by (g) (fn(x[range]))`` series-sharded over ``mesh``: the
    rank's stream rows as ``device_temporal_sharded``, ``groups`` the GLOBAL
    group ids of the rank's lanes (host), combined over the shards by
    ``_grouped_reduce_sharded``.  Returns (out f64[n_groups, S] replicated,
    error bool[rank rows])."""
    if fn in ("predict_linear", "holt_winters", "quantile_over_time"):
        raise ValueError(f"no grouped device form for {fn}")
    _check_agg(agg)
    out, error = device_temporal_sharded(mesh, words, nbits, slots, steps, n_lanes, n_cap,
                                         range_nanos, fn, unit_nanos, n_dp, tiers, n_tiers)
    return _grouped_reduce_sharded(mesh, out, groups, n_groups, agg, phi), error


def device_rate_sharded(mesh: Mesh, words, nbits, slots, steps, n_lanes: int, n_cap: int,
                        range_nanos: int, is_counter: bool = True, is_rate: bool = True,
                        unit_nanos: int = xtime.SECOND, n_dp: int | None = None):
    """``device_rate_pipeline`` series-sharded over ``mesh`` (inputs as
    ``device_temporal_sharded``'s): the fleet sum is each shard's
    NaN-skipping sum (QK4) summed over the shards (MK1).  Returns (rate
    f64[rank lanes, S], fleet f64[S] replicated, error bool[rank rows])."""
    words, nbits, slots, steps, _ = _inputs(words, nbits, slots, steps, None, mesh.device)
    slots, rank_lanes = _rank_slots(mesh, slots, n_lanes)
    times, values, error = _decode_merge(words, nbits, slots, rank_lanes, n_cap, n_dp,
                                         unit_nanos)
    rate = query_temporal.rate(times, values, steps, int(range_nanos), is_counter, is_rate)
    fleet = psum(mesh, shard_reduce(mesh, rate), SERIES_AXIS)[0]
    return rate, fleet, error


def _split_params(plan) -> set:
    """The params whose first entry splits with the lanes under a mesh: a
    grouped reduce's group ids over a still-sharded child.  Everything else
    replicates."""
    split = set()

    def walk(node):
        tag = node[0]
        if tag == "leaf":
            return
        if tag == "agg":
            if _plan_sharded(node[4]):
                split.add(node[3])
            walk(node[4])
        elif tag == "vv":
            walk(node[5])
            walk(node[6])
        else:  # the child is the last element of every other node
            walk(node[-1])

    walk(plan)
    return split


def shard_expr_inputs(plan, mesh: Mesh, leaves, params, steps):
    """The rank's part of a sharded query's inputs, on the mesh's device.
    The rule of the reference's ``_leaf_in_spec:1762`` and
    ``_sharded_param_specs:1773``: a leaf's words, nbits, slots and tiers
    split by stream row, its times, values and valid by lane; its steps and
    ``rng`` replicate; a grouped reduce's group ids over a sharded child
    split by lane; every other param replicates.  Words leaves come
    shard-even (``parallel/repack.shard_repack``); arrays leaves pad lanes to
    a multiple of the shard count."""
    split = _split_params(plan)

    def cut(x):
        return x[mesh.rows(len(x))]

    leaves = [{k: v if k in ("steps", "rng") else cut(v) for k, v in lf.items()}
              for lf in leaves]
    params = tuple(tuple(cut(x) if i in split and j == 0 else x for j, x in enumerate(p))
                   for i, p in enumerate(params))
    return _expr_inputs(leaves, params, steps, mesh.device)


def device_expr_pipeline_sharded(plan, mesh: Mesh, leaves, params, steps):
    """The fused expression interpreter series-sharded over ``mesh``:
    decode, stitch, consolidation and every per-lane subtree run over the
    rank's lanes; the only communication is the collective each replicating
    node inserts (``_expr_eval``).  ``leaves``/``params``/``steps`` are the
    rank's (``shard_expr_inputs``).  Returns the single-device contract
    (out, aux, errors): out and aux replicated (a still-sharded root is
    gathered), each error vector gathered back to global stream-row
    order."""
    leaves, params, steps = _expr_inputs(leaves, params, steps, mesh.device)
    errors = {}
    out, aux = _expr_eval(plan, leaves, params, steps, errors, mesh)
    if _plan_sharded(plan):
        out = mesh.gather_rows(out)
    return out, aux, tuple(_gather_mask(mesh, errors[i]) for i in sorted(errors))
