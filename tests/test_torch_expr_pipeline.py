"""Port parity: the fused PromQL expression interpreter
(``device_expr_pipeline`` and its batched form), plain PyTorch vs the JAX
package.

Plans are built by hand (``corpus.ExprPlanBuilder``) in the reference's
grammar over a small labelled fleet: counters ``http_req`` / ``http_lim``
with resets, gauges ``mem_use`` with NaN, +-Inf and +-0.0 samples and an
absent series, histogram buckets ``http_bucket`` (two well-formed groups
and one of a single bucket), and a ``sparse`` gauge with gaps longer than
the lookback.  Each expression runs on words-kind leaves (M3TSZ blocks
decoded on the device) and on arrays-kind leaves (merged lanes).  The
expressions are those of the reference's own fusion tests
(``tests/test_device_query_fusion.py``: ``EXACT_EXPRS``, ``RATE_EXPRS``,
the transcendental and loose families, ``sum(rate(..) ^ 0)``), the
grouped-rate ratio of ``bench.py:1768``, histogram_quantile, topk and
bottomk (with ``aux``), ``quantile by``, ``absent``, every scalar
function and operator form, the rest of the range functions (stddev/stdvar,
changes/resets, deriv/predict_linear, holt_winters, quantile_over_time)
and subqueries (``subq``: the child evaluated on the inner grid, packed by
QK12, then a range function), the example of Prometheus's querying
documentation ``max_over_time(rate(x[5m])[30m:1m])`` among them.  The range
functions whose reference device form departs from its host contract on
+-Inf samples (ROADMAP queue 3; tests/test_torch_temporal_family.py holds
the port there) run on the counters and the sparse gauge here.

Tolerances: bit for bit (NaN positions equal, f64 bit patterns) where the
plan's ops are exact; rtol 1e-12, atol 1e-12 with NaN positions equal for
the rate family (as in the per-node tests), exp/ln/log2/log10/^ (the
reference's own gate) and two products XLA:CPU contracts into an FMA
under jit (the grouped quantile's interpolation and histogram_quantile's
``phi * total - lo_c``; see tests/test_torch_query_select.py); rtol 1e-9,
atol 1e-9 (``FAMILY``, the reference's differential gate for them) for
stddev/stdvar, deriv/predict_linear, holt_winters and quantile_over_time,
in a leaf or after a subquery.

The JAX references of each leaf kind come from one compiled program that
evaluates every plan with ``_expr_eval``; the entry points themselves run
on a topk root and on the batched megabatch plan.
"""

import functools
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from m3_tpu.models import query_pipeline as jq
from m3_tpu_torch.models import corpus
from m3_tpu_torch.models import query_pipeline as tq

from test_torch_m3tsz_decode import assert_same
from test_torch_query_pipeline import assert_close

SEC = 1_000_000_000
MIN = 60 * SEC
T0 = corpus.START - corpus.START % (2 * 3600 * SEC)
STEPS = np.arange(T0 + 10 * MIN, T0 + 50 * MIN + 1, MIN, dtype=np.int64)  # 41 -> 64 padded
JOBS = ("api", "db", "web")
DCS = ("east", "west")
LES = ("0.1", "0.5", "1", "+Inf")
LOOSE = 1e-12
FAMILY = (1e-9, 1e-9)  # (rtol, atol)


def _series(rng: random.Random, kind: str):
    t, ts, vs, acc = T0 + rng.randrange(1, 30) * SEC, [], [], 0.0
    while t < T0 + 3600 * SEC:
        if kind == "counter":
            acc += rng.uniform(0, 5)
            if rng.random() < 0.03:
                acc = rng.uniform(0, 2)  # a counter reset
            vs.append(round(acc, 2))
        elif kind == "gauge":
            p = rng.random()
            vs.append(float("nan") if p < 0.05 else float("inf") if p < 0.07
                      else -float("inf") if p < 0.08 else -0.0 if p < 0.11
                      else 0.0 if p < 0.14 else round(rng.uniform(-50, 50), 2))
        else:  # sparse
            vs.append(round(rng.uniform(0, 10), 1))
        ts.append(t)
        gap = rng.choice([1, 1, 1, 2, 3])
        if rng.random() < (0.3 if kind == "sparse" else 0.04):
            gap = 40  # longer than the lookback: the series goes stale
        t += 10 * SEC * gap
    return np.asarray(ts, dtype=np.int64), np.asarray(vs)


@functools.lru_cache(maxsize=None)
def _fleet() -> dict:
    """metric -> (labels, per-series (times, values))."""
    rng = random.Random(20260805)
    fleet = {}
    for metric, kind in (("http_req", "counter"), ("http_lim", "counter"), ("mem_use", "gauge")):
        labels, series = [], []
        for job in JOBS:
            for dc in DCS:
                if metric == "mem_use" and (job, dc) == ("db", "west"):
                    continue  # an absent series: matching must cope
                labels.append({"job": job, "dc": dc})
                series.append(_series(rng, kind))
        fleet[metric] = (labels, series)
    labels, series = [], []
    for job in ("api", "db", "web"):
        les = LES if job != "web" else ("+Inf",)  # web: one bucket, skipped
        base = _series(rng, "counter")
        for i, le in enumerate(les):
            labels.append({"job": job, "le": le})
            scale = (i + 1) / len(les) if le != "+Inf" else 1.0
            v = np.round(base[1] * scale, 2)
            if job == "db" and le == "+Inf":
                v = v - 3.0  # the +Inf count below a finite bucket's
            series.append((base[0], v))
    fleet["http_bucket"] = (labels, series)
    fleet["sparse"] = ([{"job": "api"}], [_series(rng, "sparse")])
    return fleet


def _grid(series):
    n_cap = corpus.bucket_pow2(max(len(t) for t, _ in series), 128)
    times = np.full((len(series), n_cap), corpus.INT64_MAX, dtype=np.int64)
    values = np.full((len(series), n_cap), np.nan)
    for i, (t, v) in enumerate(series):
        times[i, :len(t)], values[i, :len(t)] = t, v
    return times, values


def _leaves(b: corpus.ExprPlanBuilder, kind: str) -> dict:
    """(metric, range) -> leaf index, for every selector the plans read."""
    out = {}
    for metric, (labels, series) in _fleet().items():
        for rng in (5 * MIN, 10 * MIN) if metric == "http_req" else (5 * MIN,):
            if kind == "words":
                out[metric, rng] = b.words_leaf_from_series(series, labels, rng)
            else:
                out[metric, rng] = b.arrays_leaf(*_grid(series), labels, rng)
    return out


def _leaf_of(b: corpus.ExprPlanBuilder, kind: str, metric: str, rng: int) -> int:
    """A new leaf of ``metric`` on the builder's current grid (a subquery's
    inner grid inside ``b.subq``)."""
    labels, series = _fleet()[metric]
    if kind == "words":
        return b.words_leaf_from_series(series, labels, rng)
    return b.arrays_leaf(*_grid(series), labels, rng)


def _plans(b: corpus.ExprPlanBuilder, kind: str) -> dict:
    """name -> (root PlanNode, tolerance); None = bit for bit."""
    lf = _leaves(b, kind)

    def sel(metric, fn, rng=5 * MIN, **kw):
        return b.leaf(lf[metric, rng], fn, **kw)

    def mem():  # the instant vector mem_use: last sample within the lookback
        return sel("mem_use", "last_over_time")

    def rate(metric="http_req", fn="rate"):
        return sel(metric, fn)

    p = {}
    # the reference's EXACT_EXPRS
    p["abs(delta(mem_use[5m])) + sqrt(abs(mem_use))"] = (b.vv(
        "+", b.call("abs", sel("mem_use", "delta")), b.call("sqrt", b.call("abs", mem()))), LOOSE)
    p["max by (dc)(max_over_time(mem_use[5m])) - min by (dc)(min_over_time(mem_use[5m]))"] = (
        b.vv("-", b.agg("max", sel("mem_use", "max_over_time"), ("dc",)),
             b.agg("min", sel("mem_use", "min_over_time"), ("dc",))), None)
    p["floor(mem_use) % 3 == bool 0"] = (b.vs("==", b.vs("%", b.call("floor", mem()), 3.0), 0.0,
                                              bool_mod=True), None)
    p["round(avg by (job)(mem_use), 0.5) + 0"] = (b.vs("+", b.call(
        "round", b.agg("avg", mem(), ("job",)), (1 / 0.5,)), 0.0), None)
    p["timestamp(mem_use) - 1600000000"] = (b.vs("-", b.call("timestamp", mem()), 1.6e9), None)
    p["sum(count_over_time(http_req[5m])) + count(mem_use)"] = (b.vv(
        "+", b.agg("sum", sel("http_req", "count_over_time")), b.agg("count", mem())), None)
    # the reference's RATE_EXPRS (the ratio by job is bench.py:1768's)
    p["sum by (dc)(rate(http_req[5m])) / sum by (dc)(rate(http_lim[5m]))"] = (b.vv(
        "/", b.agg("sum", rate(), ("dc",)), b.agg("sum", rate("http_lim"), ("dc",))), LOOSE)
    p["sum by (job)(rate(http_req[5m])) / on(job) sum by (job)(rate(http_lim[5m]))"] = (b.vv(
        "/", b.agg("sum", rate(), ("job",)), b.agg("sum", rate("http_lim"), ("job",)),
        on=("job",)), LOOSE)
    p["sum by (job, dc)(irate(http_req[5m])) - on(job) group_left "
      "sum by (job)(rate(http_lim[5m]))"] = (b.vv(
          "-", b.agg("sum", rate(fn="irate"), ("job", "dc")),
          b.agg("sum", rate("http_lim"), ("job",)), on=("job",), group_left=True), LOOSE)
    p["clamp(sum by (dc)(increase(http_req[10m])), 10, 1000)"] = (b.call(
        "clamp", b.agg("sum", sel("http_req", "increase", 10 * MIN), ("dc",)), (10.0, 1000.0)),
        LOOSE)
    p["(rate(http_req[5m]) > 0.1) * 60"] = (b.vs("*", b.vs(">", rate(), 0.1), 60.0), LOOSE)
    p["sum by (dc)(rate(http_req[5m]) >= bool 0.2)"] = (b.agg(
        "sum", b.vs(">=", rate(), 0.2, bool_mod=True), ("dc",)), LOOSE)
    # transcendental and loose families, the padding re-mask
    abs_mem = b.call("abs", mem())
    p["exp(ln(abs(mem_use) + 1)) - abs(mem_use)"] = (b.vv(
        "-", b.call("exp", b.call("ln", b.vs("+", b.call("abs", mem()), 1.0))), abs_mem), LOOSE)
    p["log2(abs(mem_use) + 2) + log10(abs(mem_use) + 2)"] = (b.vv(
        "+", b.call("log2", b.vs("+", b.call("abs", mem()), 2.0)),
        b.call("log10", b.vs("+", b.call("abs", mem()), 2.0))), LOOSE)
    p["sum by (dc)(rate(http_req[5m])) ^ 2"] = (b.vs("^", b.agg("sum", rate(), ("dc",)), 2.0),
                                                 LOOSE)
    p["stddev by (dc)(mem_use) + 0"] = (b.vs("+", b.agg("stddev", mem(), ("dc",)), 0.0), LOOSE)
    p["quantile(0.9, mem_use) * 1"] = (b.vs("*", b.agg("quantile", mem(), phi=0.9), 1.0), LOOSE)
    p["sum(rate(http_req[5m]) ^ 0)"] = (b.agg("sum", b.vs("^", rate(), 0.0)), None)
    # the new kernels' node forms
    p["quantile by (dc)(0.5, rate(http_req[5m]))"] = (b.agg("quantile", rate(), ("dc",), 0.5),
                                                     LOOSE)
    p["histogram_quantile(0.9, sum by (job, le)(rate(http_bucket[5m])))"] = (b.hq(
        0.9, b.agg("sum", rate("http_bucket"), ("job", "le"))), LOOSE)
    p["histogram_quantile(1.5, rate(http_bucket[5m]))"] = (b.hq(1.5, rate("http_bucket")), None)
    p["bottomk by (dc)(2, mem_use)"] = (b.topk("bottomk", 2, mem(), ("dc",)), None)
    p["absent(mem_use)"] = (b.absent(mem()), None)
    p["absent(max_over_time(sparse[5m]))"] = (b.absent(sel("sparse", "max_over_time")), None)
    # the remaining functions and operator forms
    p["sgn(mem_use) + ceil(mem_use)"] = (b.vv("+", b.call("sgn", mem()),
                                              b.call("ceil", mem())), None)
    p["clamp_min(mem_use, 0) - clamp_max(mem_use, -0)"] = (b.vv(
        "-", b.call("clamp_min", mem(), (0.0,)), b.call("clamp_max", mem(), (-0.0,))), None)
    p["clamp(mem_use, 5, -5)"] = (b.call("clamp", mem(), (5.0, -5.0)), None)
    p["100 - mem_use"] = (b.vs("-", mem(), 100.0, mat_on_left=False), None)
    p["7 % mem_use"] = (b.vs("%", mem(), 7.0, mat_on_left=False), None)
    p["2 ^ mem_use"] = (b.vs("^", mem(), 2.0, mat_on_left=False), LOOSE)
    p["1 < bool mem_use"] = (b.vs("<", mem(), 1.0, bool_mod=True, mat_on_left=False), None)
    p["mem_use != 0"] = (b.vs("!=", mem(), 0.0), None)
    p["rate(http_req[5m]) > bool rate(http_lim[5m])"] = (b.vv(
        ">", rate(), rate("http_lim"), bool_mod=True), LOOSE)
    p["http_req <= on(job, dc) mem_use"] = (b.vv(
        "<=", sel("http_req", "last_over_time"), mem(), on=("job", "dc")), None)
    p["mem_use / mem_use"] = (b.vv("/", mem(), mem()), None)
    # the rest of the range functions
    p["stddev_over_time(http_req[5m])"] = (sel("http_req", "stddev_over_time"), FAMILY)
    p["sum by (dc)(stdvar_over_time(http_lim[5m]))"] = (b.agg(
        "sum", sel("http_lim", "stdvar_over_time"), ("dc",)), FAMILY)
    p["changes(mem_use[5m])"] = (sel("mem_use", "changes"), None)
    p["resets(http_req[10m]) > bool 0"] = (b.vs(">", sel("http_req", "resets", 10 * MIN), 0.0,
                                                bool_mod=True), None)
    p["deriv(http_req[10m])"] = (sel("http_req", "deriv", 10 * MIN), FAMILY)
    p["predict_linear(http_req[10m], 3600)"] = (sel("http_req", "predict_linear", 10 * MIN,
                                                    horizon=3600.0), FAMILY)
    p["holt_winters(http_req[10m], 0.3, 0.1)"] = (sel("http_req", "holt_winters", 10 * MIN,
                                                      hw_sf=0.3, hw_tf=0.1), FAMILY)
    p["quantile_over_time(0.9, mem_use[5m])"] = (sel("mem_use", "quantile_over_time", phi=0.9),
                                                 FAMILY)
    p["max by (job)(quantile_over_time(0.25, sparse[5m]))"] = (b.agg(
        "max", sel("sparse", "quantile_over_time", phi=0.25), ("job",)), FAMILY)
    # subqueries
    p["max_over_time(rate(http_req[5m])[30m:1m])"] = (b.subq(
        "max_over_time", lambda bb: bb.leaf(_leaf_of(bb, kind, "http_req", 5 * MIN), "rate"),
        MIN, 30 * MIN), LOOSE)
    p["deriv(sum by (job)(rate(http_req[5m]))[10m:1m])"] = (b.subq(
        "deriv", lambda bb: bb.agg("sum", bb.leaf(_leaf_of(bb, kind, "http_req", 5 * MIN),
                                                   "rate"), ("job",)), MIN, 10 * MIN), FAMILY)
    p["holt_winters(http_req[20m:2m], 0.3, 0.1)"] = (b.subq(
        "holt_winters", lambda bb: bb.leaf(_leaf_of(bb, kind, "http_req", 5 * MIN),
                                           "last_over_time"), 2 * MIN, 20 * MIN, hw_sf=0.3,
        hw_tf=0.1), FAMILY)
    p["predict_linear(sum(http_lim)[15m:1m], 600)"] = (b.subq(
        "predict_linear", lambda bb: bb.agg("sum", bb.leaf(
            _leaf_of(bb, kind, "http_lim", 5 * MIN), "last_over_time")), MIN, 15 * MIN,
        horizon=600.0), FAMILY)
    p["changes(mem_use[15m:1m])"] = (b.subq(
        "changes", lambda bb: bb.leaf(_leaf_of(bb, kind, "mem_use", 5 * MIN),
                                      "last_over_time"), MIN, 15 * MIN), None)
    p["stddev_over_time(rate(http_lim[5m])[20m:1m]) * 60"] = (b.vs("*", b.subq(
        "stddev_over_time", lambda bb: bb.leaf(_leaf_of(bb, kind, "http_lim", 5 * MIN), "rate"),
        MIN, 20 * MIN), 60.0), FAMILY)
    p["quantile_over_time(0.5, timestamp(sparse)[20m:90s])"] = (b.subq(
        "quantile_over_time", lambda bb: bb.call("timestamp", bb.leaf(
            _leaf_of(bb, kind, "sparse", 5 * MIN), "last_over_time")), 90 * SEC, 20 * MIN),
        FAMILY)
    return p


TOPK = "topk(3, rate(http_req[5m]))"


def _topk_plan(b):
    lf = _leaves(b, "words")
    return b.topk("topk", 3, b.leaf(lf["http_req", 5 * MIN], "rate")).plan


@functools.lru_cache(maxsize=None)
def _case(kind: str):
    b = corpus.ExprPlanBuilder(STEPS)
    plans = _plans(b, kind)
    leaves, params, steps = b.inputs()
    return plans, leaves, params, steps


@functools.lru_cache(maxsize=None)
def _jax(kind: str) -> dict:
    """Every plan of a leaf kind through the reference interpreter, from
    one compiled program."""
    plans, leaves, params, steps = _case(kind)
    roots = {name: node.plan for name, (node, _) in plans.items()
             if kind == "arrays" or name in WORDS_PLANS}

    def run(leaves, params, steps):
        out = {}
        for name, plan in roots.items():
            errors = {}
            res, aux = jq._expr_eval(plan, leaves, params, steps, errors)
            out[name] = (res, aux, tuple(errors[i] for i in sorted(errors)))
        return out

    return jax.tree_util.tree_map(np.array, jax.jit(run)(leaves, params, steps))


def _port(kind: str, plan):
    _, leaves, params, steps = _case(kind)
    return tq.device_expr_pipeline(plan, *corpus.expr_inputs_from_numpy(leaves, params, steps,
                                                                        "cpu"))


def _check(got, want, tol, what):
    if tol is None:
        assert_same(got, want, what)
        return
    if isinstance(tol, tuple):
        np.testing.assert_allclose(got.numpy(), want, rtol=tol[0], atol=tol[1], equal_nan=True,
                                   err_msg=what)
    else:
        assert_close(got, want, tol, what)
    np.testing.assert_array_equal(got.numpy()[np.isinf(want)], want[np.isinf(want)],
                                  err_msg=what)


# the plans also run on words-kind leaves (the plain decoder on the CPU
# costs ~0.5 s a plan, so one plan per node form, not all of them)
WORDS_PLANS = (
    "abs(delta(mem_use[5m])) + sqrt(abs(mem_use))",
    "max by (dc)(max_over_time(mem_use[5m])) - min by (dc)(min_over_time(mem_use[5m]))",
    "sum by (job)(rate(http_req[5m])) / on(job) sum by (job)(rate(http_lim[5m]))",
    "(rate(http_req[5m]) > 0.1) * 60",
    "sum(rate(http_req[5m]) ^ 0)",
    "quantile by (dc)(0.5, rate(http_req[5m]))",
    "histogram_quantile(0.9, sum by (job, le)(rate(http_bucket[5m])))",
    "bottomk by (dc)(2, mem_use)",
    "absent(max_over_time(sparse[5m]))",
    "holt_winters(http_req[10m], 0.3, 0.1)",
    "max_over_time(rate(http_req[5m])[30m:1m])",
)
CASES = [(name, "arrays") for name in _plans(corpus.ExprPlanBuilder(STEPS), "arrays")] + [
    (name, "words") for name in WORDS_PLANS]


@pytest.mark.parametrize("name,kind", CASES)
def test_expr_plan_matches_jax(name, kind):
    plans = _case(kind)[0]
    node, tol = plans[name]
    out, aux, errors = _port(kind, node.plan)
    want_out, want_aux, want_errors = _jax(kind)[name]
    _check(out, want_out, tol, name)
    if node.plan[0] == "topk":
        assert_same(aux[0], want_aux[0], f"{name}: present")
        assert_same(aux[1], want_aux[1], f"{name}: rank")
    else:
        assert aux == () and len(want_aux) == 0
    assert len(errors) == len(want_errors) == (len({i for i in _leaf_ids(node.plan)})
                                               if kind == "words" else 0)
    for g, w in zip(errors, want_errors):
        assert_same(g, w, f"{name}: errors")
    assert (~np.isnan(want_out)).any() or name in ("absent(mem_use)", "clamp(mem_use, 5, -5)")


def _leaf_ids(plan):
    if plan[0] == "leaf":
        yield plan[1]
    for x in plan[1:]:
        if isinstance(x, tuple) and x and isinstance(x[0], str):
            yield from _leaf_ids(x)


def test_padding_rows_stay_nan_under_pow():
    """NaN^0 == 1: without the per-node re-mask the padding lanes of
    rate(..) ^ 0 would be 1.0 rows and sum() would count them."""
    plans, *_ = _case("arrays")
    node, _ = plans["sum(rate(http_req[5m]) ^ 0)"]
    got = _port("arrays", node.plan)[0]
    n_real = len(_fleet()["http_req"][0])
    assert float(np.nanmax(got.numpy()[0])) <= n_real
    rate = _port("arrays", plans["(rate(http_req[5m]) > 0.1) * 60"][0].plan)[0]
    assert torch.isnan(rate[n_real:]).all()


@functools.lru_cache(maxsize=None)
def _jax_topk():
    b = corpus.ExprPlanBuilder(STEPS)
    plan = _topk_plan(b)
    return plan, b.inputs(), jax.tree_util.tree_map(
        np.array, jq.device_expr_pipeline(plan, *b.inputs()))


def test_topk_root_matches_jax_with_aux():
    """The entry point on a topk root: the root matrix, (present, rank)
    and the words leaf's error flags."""
    plan, inputs, (want, want_aux, want_errors) = _jax_topk()
    out, aux, errors = tq.device_expr_pipeline(plan, *inputs, device="cpu")
    assert_close(out, want, LOOSE, TOPK)
    assert_same(aux[0], want_aux[0], "present")
    assert_same(aux[1], want_aux[1], "rank")
    assert len(errors) == 1
    assert_same(errors[0], want_errors[0], "errors")
    assert want_aux[0].sum() >= 3 and (want_aux[1] == 2**62).any()


MEGA = "sum by (job)(sum_over_time(mem_use[5m])) / sum by (job)(count_over_time(mem_use[5m]))"


def _mega_query(seed: int):
    """One query of the megabatch dashboard fleet (bench.py:3325), on
    arrays-kind leaves: 2 jobs x 5 instances of uniform gauges every 20s."""
    rng = np.random.default_rng(seed)
    ts = np.arange(T0 + SEC, T0 + 3600 * SEC, 20 * SEC, dtype=np.int64)
    labels = [{"job": f"job{j}", "inst": f"i{i}"} for j in range(2) for i in range(5)]
    times = np.tile(ts, (len(labels), 1))
    values = rng.uniform(-50, 50, times.shape)
    values[rng.random(times.shape) < 0.05] = np.nan
    b = corpus.ExprPlanBuilder(STEPS + seed * MIN)
    lf = b.arrays_leaf(times, values, labels, 5 * MIN)
    root = b.vv("/", b.agg("sum", b.leaf(lf, "sum_over_time"), ("job",)),
                b.agg("sum", b.leaf(lf, "count_over_time"), ("job",)))
    return root.plan, b.inputs()


def test_batched_matches_jax_and_solo():
    """Q = 3 queries of one plan through device_expr_pipeline_batched:
    against the reference's batched call, and each slice against the
    port's solo call, bit for bit."""
    queries = [_mega_query(s) for s in range(3)]
    plan = queries[0][0]
    assert all(q[0] == plan for q in queries)
    stacked = corpus.stack_queries([q[1] for q in queries])
    want = jax.tree_util.tree_map(np.array, jq.device_expr_pipeline_batched(plan, *stacked))
    out, aux, errors = tq.device_expr_pipeline_batched(plan, *stacked, device="cpu")
    assert out.shape == (3, 8, 64) and aux == () and errors == ()
    assert_close(out, want[0], LOOSE, MEGA)
    for q, (_, inputs) in enumerate(queries):
        solo = tq.device_expr_pipeline(plan, *inputs, device="cpu")[0]
        assert_same(out[q], solo.numpy(), f"slice {q} vs its solo call")
    assert not torch.equal(out[0], out[1])


def _subq_query(seed: int):
    """One query of a subquery dashboard on arrays-kind leaves (the
    megabatch fleet's gauges): sum by (job)(holt_winters(avg_over_time(
    mem_use[5m])[20m:1m], 0.3, 0.1)); each seed its own data and window."""
    rng = np.random.default_rng(seed)
    ts = np.arange(T0 + SEC, T0 + 3600 * SEC, 20 * SEC, dtype=np.int64)
    labels = [{"job": f"job{j}", "inst": f"i{i}"} for j in range(2) for i in range(5)]
    times = np.tile(ts, (len(labels), 1))
    values = rng.uniform(-50, 50, times.shape)
    values[rng.random(times.shape) < 0.05] = np.nan
    b = corpus.ExprPlanBuilder(STEPS + seed * MIN)
    root = b.agg("sum", b.subq("holt_winters", lambda bb: bb.leaf(
        bb.arrays_leaf(times, values, labels, 5 * MIN), "avg_over_time"), MIN, 20 * MIN,
        hw_sf=0.3, hw_tf=0.1), ("job",))
    return root.plan, b.inputs()


def test_batched_subq_matches_jax_and_solo():
    """Q = 3 subquery queries of one plan through
    device_expr_pipeline_batched: against the reference's batched call at
    the family's bound, and each slice against the port's solo call, bit
    for bit."""
    queries = [_subq_query(s) for s in range(3)]
    plan = queries[0][0]
    assert all(q[0] == plan for q in queries) and plan[4][0] == "subq"
    stacked = corpus.stack_queries([q[1] for q in queries])
    want = jax.tree_util.tree_map(np.array, jq.device_expr_pipeline_batched(plan, *stacked))
    out, aux, errors = tq.device_expr_pipeline_batched(plan, *stacked, device="cpu")
    assert out.shape == (3, 8, 64) and aux == () and errors == ()
    _check(out, want[0], FAMILY, "batched subquery")
    for q, (_, inputs) in enumerate(queries):
        solo = tq.device_expr_pipeline(plan, *inputs, device="cpu")[0]
        assert_same(out[q], solo.numpy(), f"slice {q} vs its solo call")
    assert np.isfinite(want[0][:, :2, :len(STEPS)]).all()


@pytest.mark.parametrize("tag,row", [("gsel", "G1"), ("gagg", "G1"), ("gcall", "G2")])
def test_unported_nodes_raise(tag, row):
    """Every node form of the grammar is ported (the graphite nodes with
    kernel rows G1 and G2): the graphite node evaluates, and a tag outside
    the grammar still raises ValueError."""
    b = corpus.ExprPlanBuilder(STEPS)
    lf = _leaves(b, "arrays")
    child = b.leaf(lf["mem_use", 5 * MIN], "last_over_time")
    node = {"gsel": lambda: b.gsel(child, [1, 0]),
            "gagg": lambda: b.gagg("sum", child, [0] * len(child.labels), [{}]),
            "gcall": lambda: b.gcall("integral", child)}[tag]()
    out = tq.device_expr_pipeline(node.plan, *b.inputs(), device="cpu")[0]
    assert out.shape == (node.rows_pad, b.s_pad) and bool(torch.isfinite(out[0]).any()), row
    with pytest.raises(ValueError, match="unknown plan node"):
        tq.device_expr_pipeline((tag + "_v2",) + node.plan[1:], *b.inputs(), device="cpu")


def test_expr_pipeline_never_falls_back_to_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    plan, inputs, _ = _jax_topk()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tq.device_expr_pipeline(plan, *inputs)


@pytest.mark.parametrize("batched", [False, True])
def test_expr_pipeline_tensors_follow_device(monkeypatch, batched):
    """Tensor inputs run where the caller's ``device`` says, as the
    per-node pipelines' inputs do: CPU tensors with device="cuda" ask for
    the card, and without one that raises instead of running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    if batched:
        queries = [_mega_query(s) for s in range(2)]
        plan, fn = queries[0][0], tq.device_expr_pipeline_batched
        inputs = corpus.expr_inputs_from_numpy(
            *corpus.stack_queries([q[1] for q in queries]), "cpu")
    else:
        b = corpus.ExprPlanBuilder(STEPS)
        plan, fn = _topk_plan(b), tq.device_expr_pipeline
        inputs = corpus.expr_inputs_from_numpy(*b.inputs(), "cpu")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        fn(plan, *inputs, device="cuda")
    assert fn(plan, *inputs, device="cpu")[0].device.type == "cpu"


def test_expr_inputs_move_tensor_leaves():
    """``_expr_inputs`` moves every leaf tensor and the step grid to an
    explicit device (uint32 words by their bit patterns); each leaf's
    ``rng`` and the params stay on the host."""
    _, leaves, params, steps = _case("words")
    lv, pv, sv = corpus.expr_inputs_from_numpy(leaves, params, steps, "cpu")
    ml, mp, ms = tq._expr_inputs(lv, pv, sv, "meta")
    assert ms.device.type == "meta" and mp is pv
    for before, after in zip(lv, ml):
        assert after.keys() == before.keys()
        assert after["rng"] is before["rng"]
        for k in before.keys() - {"rng"}:
            assert after[k].device.type == "meta" and after[k].dtype == before[k].dtype, k
    assert ml[0]["words"].dtype == torch.uint32
