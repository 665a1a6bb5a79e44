"""Port parity: Graphite render targets through the fused interpreter
(``device_expr_pipeline`` and its batched form with the ``gsel``, ``gagg``
and ``gcall`` nodes), plain PyTorch vs the JAX package.

The targets are every device-lowered target of the reference's Graphite
conformance corpus (``tests/test_graphite_conformance.py:89-171``; the
four host-split targets at its end are left out), copied here.  Each is
parsed with ``m3_tpu.query.graphite.parse`` and lowered with
``m3_tpu.query.graphite_device._lower``, the reference's own lowering; a
small walker (``_Walker``) turns the symbolic tree into a port plan through
``corpus.ExprPlanBuilder``: it applies the lowering's ``select_fn`` and
``group_fn`` to the labels as ``m3_tpu/query/plan.py:864-922`` does and
passes ``gname`` through.  The JAX side runs ``_expr_eval`` on the same
plan, leaves and params, one compiled program per leaf kind.

The data: ``servers.host{0..3}.cpu.load``, ``servers.host{0..2}.mem.used``
and ``servers.host0.cpu`` (a shallower path the depth filter must drop)
from 10 minutes to 50 at 60s steps, samples every 10-30s with gaps longer
than a step (NaN holes), and ``servers.host3.cpu.load`` carrying +-Inf
and +-0.0 samples for the percentile and minMax traps.

Tolerances, NaN positions always equal: bit for bit for the corpus's
tol-0 targets; rtol/atol 1e-12 for the summing families (sums, averages,
products, diff, integral, integralByInterval, the moving sums and
averages, summarize's sum and avg, hitcount) and for pow and logarithm
(XLA's own pow and log); rtol/atol 1e-9 for stddev and the percentiles
(XLA:CPU contracts jnp's percentile interpolation into an FMA; ROADMAP
queue 3).  The arrays-kind leaves run every target; the words-kind leaves
(M3TSZ blocks decoded on the device) run the bench's target
``movingAverage(groupByNode(..., 1, 'sum'), 3)``; the batched form runs it
over three queries.
"""

import functools
import random
import re

import jax
import numpy as np
import pytest
import torch

from m3_tpu.models import query_pipeline as jq
from m3_tpu.query import graphite as jgraphite
from m3_tpu.query import graphite_device
from m3_tpu_torch.models import corpus
from m3_tpu_torch.models import query_pipeline as tq

from test_torch_m3tsz_decode import assert_same

SEC = 1_000_000_000
STEP = 60 * SEC
T0 = corpus.START - corpus.START % (2 * 3600 * SEC)
STEPS = np.arange(T0 + 10 * 60 * SEC, T0 + 50 * 60 * SEC + 1, STEP, dtype=np.int64)
SUM = (1e-12, 1e-12)
STAT = (1e-9, 1e-9)

CPU = "servers.*.cpu.load"
MEM = "servers.*.mem.used"
BENCH = f"movingAverage(groupByNode({CPU}, 1, 'sum'), 3)"

# (target, tolerance): None = bit for bit.  The conformance corpus's targets
# in its order, with its 1e-9 family split by what it sums.
TARGETS = (
    (CPU, None), ("servers.*.*.*", None), ("servers.host0.cpu.load", None),
    (f"scale({CPU}, 2.5)", None), (f"scaleToSeconds({CPU}, 30)", None),
    (f"offset({MEM}, -7.5)", None), (f"absolute({MEM})", None), (f"invert({CPU})", None),
    (f"squareRoot(absolute({MEM}))", None), (f"derivative({CPU})", None),
    (f"nonNegativeDerivative({CPU})", None), (f"perSecond({CPU})", None),
    (f"keepLastValue({MEM}, 2)", None), (f"keepLastValue({MEM})", None),
    (f"transformNull(derivative({CPU}), 0)", None), (f"removeAboveValue({CPU}, 25)", None),
    (f"removeBelowValue({CPU}, 10)", None), (f"isNonNull({MEM})", None),
    (f"changed({CPU})", None), (f"delay({CPU}, 3)", None), (f"delay({CPU}, -2)", None),
    (f"timeSlice({CPU}, '-35m')", None), (f"offsetToZero({MEM})", None),
    (f"minMax({CPU})", None), (f"movingMax({CPU}, 4)", None), (f"movingMin({CPU}, '3m')", None),
    (f"logarithm(absolute({MEM}))", SUM), (f"pow({CPU}, 2)", SUM), (f"integral({CPU})", SUM),
    (f"movingAverage({CPU}, 3)", SUM), (f"movingSum({CPU}, '2m')", SUM),
    (f"summarize({CPU}, '5m', 'avg')", SUM), (f"summarize({CPU}, '5m', 'max')", None),
    (f"summarize({MEM}, '10m', 'count')", None), (f"hitcount({CPU}, '5m')", SUM),
    (f"integralByInterval({CPU}, '5m')", SUM), (f"nPercentile({CPU}, 90)", STAT),
    (f"removeAbovePercentile({CPU}, 80)", STAT), (f"removeBelowPercentile({CPU}, 20)", STAT),
    (f"sumSeries({CPU})", SUM), (f"averageSeries({CPU})", SUM), (f"minSeries({CPU})", None),
    (f"maxSeries({CPU})", None), ("multiplySeries(servers.host*.cpu.load)", SUM),
    (f"diffSeries({CPU})", SUM), (f"stddevSeries({CPU})", STAT),
    (f"rangeOfSeries({CPU})", None), (f"medianSeries({CPU})", STAT),
    (f"countSeries({CPU})", None), (f"aggregate({CPU}, 'last')", None),
    (f"aggregate({CPU}, 'sum')", SUM), (f"percentileOfSeries({CPU}, 75)", STAT),
    (f"groupByNode({CPU}, 1, 'sum')", SUM), ("groupByNode(servers.*.*.*, 2, 'max')", None),
    ("groupByNodes(servers.*.*.*, 'avg', 0, 2)", SUM),
    (f"sumSeriesWithWildcards({CPU}, 1)", SUM), (f"averageSeriesWithWildcards({CPU}, 1)", SUM),
    (f"aggregateWithWildcards({CPU}, 'min', 1)", None),
    (f"alias({CPU}, 'cpu')", None), (f"aliasByNode({CPU}, 1)", None),
    (f"aliasByMetric({MEM})", None), (f"aliasSub({CPU}, 'host(\\d+)', 'h\\1')", None),
    (f"consolidateBy({CPU}, 'max')", None), (f"substr({CPU}, 1, 3)", None),
    ("sortByName(servers.*.*.*)", None), (f"exclude({CPU}, 'host1')", None),
    (f"grep({CPU}, 'host[02]')", None), (f"limit(sortByName({CPU}), 2)", None),
    (f"averageSeries(scale({CPU}, 2))", SUM),
    (f"alias(sumSeries(nonNegativeDerivative({CPU})), 'rate')", SUM),
    (BENCH, SUM), (f"transformNull(summarize(sumSeries({CPU}), '5m', 'sum'), 0)", SUM),
)
TOL = dict(TARGETS)


@functools.lru_cache(maxsize=None)
def _fleet():
    """path -> (times, values), the conformance fixture's generator."""
    rng = random.Random(20260815)
    paths = [f"servers.host{i}.cpu.load" for i in range(4)]
    paths += [f"servers.host{i}.mem.used" for i in range(3)] + ["servers.host0.cpu"]
    fleet = {}
    for p in paths:
        ts, vs = [], []
        t = T0 + rng.randrange(1, 30) * SEC
        while t < T0 + 3600 * SEC:
            vs.append(round(rng.uniform(-5, 50), 2))
            ts.append(t)
            gap = rng.choice([1, 1, 1, 2, 3])
            if rng.random() < 0.04:
                gap = 40  # longer than a step: NaN holes on the render grid
            t += 10 * SEC * gap
        fleet[p] = (np.asarray(ts, dtype=np.int64), np.asarray(vs))
    # the percentile and minMax traps: +-Inf and +-0.0 in one lane
    ts, vs = fleet["servers.host3.cpu.load"]
    pick = np.random.default_rng(7).permutation(len(vs))
    vs[pick[:2]], vs[pick[2]] = np.inf, -np.inf
    vs[pick[3:9]] = [0.0, -0.0, -0.0, 0.0, -0.0, 0.0]
    return fleet


def _grid(series):
    n_cap = corpus.bucket_pow2(max(len(t) for t, _ in series), 128)
    times = np.full((len(series), n_cap), corpus.INT64_MAX, dtype=np.int64)
    values = np.full((len(series), n_cap), np.nan)
    for i, (t, v) in enumerate(series):
        times[i, :len(t)], values[i, :len(t)] = t, v
    return times, values


def _matches(labels: dict, matchers) -> bool:
    for kind, name, rx in matchers:
        assert kind == "re"
        if name not in labels or not re.fullmatch(rx, labels[name]):
            return False
    return True


class _Walker:
    """The lowering's symbolic tree as a port plan on one builder, with one
    leaf per selector (as run_sym shares them)."""

    def __init__(self, b: corpus.ExprPlanBuilder, kind: str, fleet: dict):
        self.b, self.kind, self.fleet, self.leaves = b, kind, fleet, {}

    def leaf(self, sel, rng: int) -> int:
        key = tuple(sel.matchers)
        if key not in self.leaves:
            paths = [p for p, ls in zip(self.fleet, corpus.graphite_labels(self.fleet))
                     if _matches(ls, sel.matchers)]
            labels = corpus.graphite_labels(paths)
            series = [self.fleet[p] for p in paths]
            if self.kind == "words":
                self.leaves[key] = self.b.words_leaf_from_series(series, labels, rng)
            else:
                self.leaves[key] = self.b.arrays_leaf(*_grid(series), labels, rng)
        return self.leaves[key]

    def build(self, sym) -> corpus.PlanNode:
        tag, b = sym[0], self.b
        if tag == "leaf":
            _, sel, fn, rng, _keep, horizon, hw_sf, hw_tf, phi = sym
            return b.leaf(self.leaf(sel, rng), fn, horizon, phi, hw_sf, hw_tf)
        child = self.build(sym[-1])
        if tag == "gsel":
            keep, labels = sym[1](child.labels)
            return b.gsel(child, keep, labels)
        if tag == "gname":
            return child._replace(labels=sym[1](child.labels))
        if tag == "gagg":
            _, op, extra, group_fn, _ = sym
            grouped = group_fn(child.labels)
            tval = grouped[2] if len(grouped) > 2 else 0.0
            return b.gagg(op, child, grouped[0], grouped[1], extra, tval)
        assert tag == "gcall", tag
        _, fn, statics, fparams, name_fn, _ = sym
        assert statics[0] == b.n_steps
        return b.gcall(fn, child, statics[1:], fparams, name_fn(child.labels))


def lower(target: str, steps=STEPS):
    sym, _covered = graphite_device._lower(jgraphite.parse(target), STEP, steps)
    return sym


@functools.lru_cache(maxsize=None)
def _case(kind: str):
    """Every target of a leaf kind on one builder: (plans, leaves, params,
    steps)."""
    b = corpus.ExprPlanBuilder(STEPS)
    w = _Walker(b, kind, _fleet())
    targets = [t for t, _ in TARGETS] if kind == "arrays" else [BENCH]
    plans = {t: w.build(lower(t)) for t in targets}
    return plans, *b.inputs()


@functools.lru_cache(maxsize=None)
def _jax(kind: str) -> dict:
    """Every plan of a leaf kind through the reference interpreter, from
    one compiled program."""
    plans, leaves, params, steps = _case(kind)

    def run(leaves, params, steps):
        out = {}
        for t, node in plans.items():
            errors = {}
            res, _aux = jq._expr_eval(node.plan, leaves, params, steps, errors)
            out[t] = (res, tuple(errors[i] for i in sorted(errors)))
        return out

    return jax.tree_util.tree_map(np.array, jax.jit(run)(leaves, params, steps))


def _check(got: torch.Tensor, want: np.ndarray, tol, what: str):
    if tol is None:
        assert_same(got, want, what)
        return
    g = got.numpy()
    np.testing.assert_array_equal(np.isnan(g), np.isnan(want), err_msg=f"{what}: NaN positions")
    np.testing.assert_allclose(g, want, rtol=tol[0], atol=tol[1], equal_nan=True, err_msg=what)
    np.testing.assert_array_equal(g[np.isinf(want)], want[np.isinf(want)], err_msg=what)


CASES = [(t, "arrays") for t, _ in TARGETS] + [(BENCH, "words")]


@pytest.mark.parametrize("target,kind", CASES)
def test_render_target_matches_jax(target, kind):
    plans, leaves, params, steps = _case(kind)
    node = plans[target]
    out, aux, errors = tq.device_expr_pipeline(
        node.plan, *corpus.expr_inputs_from_numpy(leaves, params, steps, "cpu"))
    want, want_errors = _jax(kind)[target]
    _check(out, want, TOL[target], target)
    assert aux == ()
    assert len(errors) == len(want_errors) == (1 if kind == "words" else 0)
    for g, w in zip(errors, want_errors):
        assert_same(g, w, f"{target}: errors")
        assert not w.any()
    n_real = len(node.labels)
    assert n_real > 0 and (~np.isnan(want[:n_real])).any(), target
    assert np.isnan(want[n_real:]).all(), target


def test_lowering_walk_matches_the_host_shapes():
    """The walker's plans have the reference's row layout: the exact-depth
    filter drops servers.host0.cpu, combiners give one row, groupByNode one
    per host, and every plan pads its rows and steps to the planner's
    buckets."""
    plans, *_ = _case("arrays")
    assert len(plans[CPU].labels) == 4 and len(plans["servers.*.*.*"].labels) == 7
    assert len(plans[f"sumSeries({CPU})"].labels) == 1
    assert [ls[b"__name__"] for ls in plans[f"groupByNode({CPU}, 1, 'sum')"].labels] == [
        b"host0", b"host1", b"host2", b"host3"]
    for t, node in plans.items():
        assert node.rows_pad == corpus.bucket_pow2(max(len(node.labels), 1), 8) or (
            node.plan[0] in ("leaf", "gcall")), t
    out, _ = _jax("arrays")[f"minMax({CPU})"]
    assert (out[:4, len(STEPS):] == 0.0).all()  # the padding steps carry minMax's 0.0


def _bench_query(seed: int):
    """One query of a batch of dashboards: the bench target over 16 hosts'
    cpu.load at 20s, each seed its own data and window."""
    rng = np.random.default_rng(seed)
    paths = [f"servers.host{i:02d}.cpu.load" for i in range(16)]
    ts = np.arange(T0 + SEC, T0 + 3600 * SEC, 20 * SEC, dtype=np.int64)
    values = np.round(rng.uniform(0, 100, (len(paths), len(ts))), 2)
    values[rng.random(values.shape) < 0.05] = np.nan
    steps = STEPS + seed * STEP
    b = corpus.ExprPlanBuilder(steps)
    w = _Walker(b, "arrays", {p: (ts, v) for p, v in zip(paths, values)})
    node = w.build(lower(BENCH, steps))
    return node.plan, b.inputs()


def test_batched_matches_jax_and_solo():
    """Q = 3 graphite queries of one plan through
    device_expr_pipeline_batched: against the reference's batched call at
    the summing tolerance, and each slice against the port's solo call, bit
    for bit."""
    queries = [_bench_query(s) for s in range(3)]
    plan = queries[0][0]
    assert all(q[0] == plan for q in queries) and plan[0] == "gcall"
    stacked = corpus.stack_queries([q[1] for q in queries])
    want = jax.tree_util.tree_map(np.array, jq.device_expr_pipeline_batched(plan, *stacked))
    out, aux, errors = tq.device_expr_pipeline_batched(plan, *stacked, device="cpu")
    assert out.shape == (3, 16, 64) and aux == () and errors == ()
    _check(out, want[0], SUM, "batched " + BENCH)
    for q, (_, inputs) in enumerate(queries):
        solo = tq.device_expr_pipeline(plan, *inputs, device="cpu")[0]
        assert_same(out[q], solo.numpy(), f"slice {q} vs its solo call")
    assert np.isfinite(want[0][:, :16, :len(STEPS)]).all()


def test_graphite_plan_never_falls_back_to_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    plans, leaves, params, steps = _case("arrays")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tq.device_expr_pipeline(plans[BENCH].plan, leaves, params, steps)
