"""Device-resident PromQL read pipeline: decode -> merge -> rate/reduce
-> group-by, with only the [series or groups, steps] result leaving the
card.

Port of the serving pipelines of ``m3_tpu/models/query_pipeline.py``
(single device), with the same arguments and the same result tuples:
the per-node ``device_rate_pipeline``, ``device_reduce_pipeline`` and
``device_grouped_pipeline``, and the fused expression interpreter
``device_expr_pipeline`` / ``device_expr_pipeline_batched`` for the
PromQL node forms (see ``_expr_eval``).  Each stage is a hand-written
CUDA kernel on the card:

- decode: ``ops/m3tsz_decode.decode_batched`` (K3) at stream width with
  truncation flagged;
- tier cut + merge into ``[n_lanes, n_cap]`` lanes: ``ops/query_merge``
  (QK1);
- the windowed function: ``ops/query_temporal`` (QK2 rate family, QK3
  prefix-sum reducers, QK5 min/max over time);
- the group-by and the fleet sum: ``ops/query_grouped`` (QK4; QK6 for
  ``quantile``);
- the interpreter's selection nodes: ``ops/lane_topk`` (QK7, topk and
  bottomk) and ``ops/histo_quantile`` (QK8, histogram_quantile).

The interpreter's elementwise glue (binary operators, comparisons,
scalar functions, padding re-masks, row gathers of vector matching) is
plain PyTorch on the card.

On CPU tensors (``device="cpu"``) every stage runs its plain PyTorch
version.  Functions whose device form is not ported yet raise
``NotImplementedError`` naming the kernel row that will bring them; they
never route to another form.

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
from m3_tpu_torch.ops import histo_quantile, ieee, lane_topk, query_grouped, query_merge
from m3_tpu_torch.ops import query_temporal
from m3_tpu_torch.ops.m3tsz_decode import decode_batched
from m3_tpu_torch.utils import xtime
from m3_tpu_torch.utils.device import resolve_device

I64 = torch.int64

# The device forms of the reference's temporal family that later kernel
# rows bring (PERF.md's table); each raises until then.
UNPORTED_TEMPORAL = {
    "stddev_over_time": "Q3c _stdvar_device",
    "stdvar_over_time": "Q3c _stdvar_device",
    "changes": "Q3d _changes_device",
    "resets": "Q3d _changes_device",
    "deriv": "Q3d _linreg_device",
    "predict_linear": "Q3d _linreg_device",
    "holt_winters": "Q4 _holt_winters_device",
    "quantile_over_time": "Q4 _quantile_window_device",
}
TEMPORAL_FNS = (query_temporal.RATE_FNS + query_temporal.INSTANT_FNS
                + query_temporal.REDUCERS + query_temporal.MINMAX_FNS)
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
    """One dispatch for the windowed temporal family (the reference's
    signature; ``horizon``/``hw_*``/``phi`` belong to unported forms)."""
    _check_fn(fn)
    if fn in query_temporal.RATE_FNS:
        return query_temporal.rate(times, values, steps, range_nanos,
                                   is_counter=fn != "delta", is_rate=fn == "rate")
    if fn in query_temporal.INSTANT_FNS:
        return query_temporal.instant(times, values, steps, range_nanos, is_rate=fn == "irate")
    if fn in query_temporal.MINMAX_FNS:
        return query_temporal.minmax_window(times, values, steps, range_nanos,
                                            is_max=fn == "max_over_time")
    return query_temporal.reduce_window(times, values, steps, range_nanos, fn)


def _grouped_reduce(out, groups, n_groups: int, agg: str, phi=0.5, index=None):
    """Group-by of a served [L, S] matrix (the reference's signature);
    ``groups`` on the host for a CUDA ``out`` (the kernels' group index is
    built from it unless ``index`` passes it built ahead)."""
    _check_agg(agg)
    if agg == "quantile":
        return query_grouped.grouped_quantile(out, groups, n_groups, phi, index)
    return query_grouped.grouped_reduce(out, groups, n_groups, agg, index)


def _check_fn(fn: str) -> None:
    if fn in UNPORTED_TEMPORAL:
        raise NotImplementedError(
            f"{fn} has no device form in the port yet: it comes with kernel row "
            f"{UNPORTED_TEMPORAL[fn]}")
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

# The node forms whose device form comes with a later kernel row (PERF.md's
# table); each raises until then.
UNPORTED_NODES = {
    "subq": "Q7c (the subquery's row sort, query_pipeline.py:1604-1618)",
    "gsel": "G1 (the graphite slice: the row gather comes with _graphite_grouped_reduce)",
    "gagg": "G1 _graphite_grouped_reduce",
    "gcall": "G2 _graphite_call",
}


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


def _expr_eval(plan, leaves, params, steps, errors: dict):
    """The fused-query interpreter body (single device).  ``leaves`` hold
    device tensors (``expr_inputs_from_numpy``), ``params`` host
    tensors: index maps and bounds are moved to the device by the node
    that reads them (non-blocking copies), group ids stay on the host for
    the kernels' CSR.  Returns (out, aux): aux is (present, rank) when the
    root is a topk node, else ().  Nothing is read back to the host."""
    aux = ()
    dev = steps.device

    def on_dev(x):
        return x.to(dev, non_blocking=True)

    def ev(node, steps_cur):
        nonlocal aux
        tag = node[0]
        if tag in UNPORTED_NODES:
            raise NotImplementedError(
                f"plan node {tag!r} has no device form in the port yet: it comes with "
                f"kernel row {UNPORTED_NODES[tag]}")
        if tag == "leaf":
            (_, i, pidx, kind, fn, lanes_pad, n_cap, n_dp, n_tiers,
             _m_pad, _w_pad, _s_pad, hw_sf, hw_tf) = node
            lf = leaves[i]
            if kind == "words":
                times, values, err = _decode_merge(
                    lf["words"], lf["nbits"], lf["slots"], lanes_pad, n_cap, n_dp,
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
            lv, _lvalid = ev(lhs, steps_cur)
            rv, _rvalid = ev(rhs, steps_cur)
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
            cv, cvalid = ev(child, steps_cur)
            (groups,) = params[pidx]
            out, present, rank = lane_topk.masked_topk(cv, groups, g_pad, k, op == "bottomk")
            aux = (present, rank)
            return torch.where(cvalid[:, None], out, torch.nan), cvalid
        if tag == "hq":
            _, _g_pad, _b_pad, pidx, child = node
            cv, _cvalid = ev(child, steps_cur)
            rows_idx, ubs, caps, gvalid, phi = params[pidx]
            out = histo_quantile.bucket_quantile(cv, rows_idx, ubs, caps, float(phi))
            gvalid = on_dev(gvalid)
            return torch.where(gvalid[:, None], out, torch.nan), gvalid
        if tag == "absent":
            _, pidx, child = node
            cv, _cvalid = ev(child, steps_cur)
            avalid = on_dev(params[pidx][0])
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
    the host group ids).  Works with or without the batched [Q] axis."""
    dev = resolve_device(device)

    def leaf(lf):
        out = {}
        for k, v in lf.items():
            if k == "words":
                out[k], out["nbits"] = inputs_from_numpy(v, lf["nbits"], dev)
            elif k == "rng":
                out[k] = torch.as_tensor(np.asarray(v, dtype=np.int64))
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
    """Whole-query fused execution of a lowered PromQL op-tree: decode,
    step consolidation and the whole temporal / aggregation / operator /
    function tree, with only the root [rows, S] matrix, ``aux`` and the
    error flags returned (nothing is read back inside the call).

    ``plan`` is the reference's static node tree (``query/plan.py``'s
    grammar; see ``m3_tpu/models/query_pipeline.py:device_expr_pipeline``):
    ``leaf`` (kind ``words`` or ``arrays``), ``agg`` (quantile included),
    ``call``, ``vs``, ``vv``, ``topk``, ``hq`` and ``absent``; ``subq`` and
    the graphite nodes raise ``NotImplementedError``.  ``leaves`` /
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
