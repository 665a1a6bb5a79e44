"""Port parity: the plain versions of the graphite kernels (QK4's graphite
ops in ``m3_tpu_torch/ops/query_grouped.py``, GK2 and GK3 in
``m3_tpu_torch/ops/graphite.py``) and the glue around them, against the
reference's ``_graphite_grouped_reduce`` and ``_graphite_call`` called
directly under ``jit``.

The probe is ``corpus.graphite_probe_matrix()`` ([16, 64], 41 real steps,
the padding steps repeating the last real one): NaN holes, +-Inf, +-0.0,
all-NaN rows and columns, a one-sample row, a constant row, ties, groups
of 1, 2, 3 and 5 lanes with the padding rows parked on group 0.  Every op
code of the grouped reduce runs, every ``_graphite_call`` function and
every summarize func; windows wider than the real steps, buckets that do
not divide them,
negative and over-long delays, gap limits 0, 2 and +inf, percentiles -20
to 150.  The reference's cases come from one compiled program (the call
parameters traced, as the interpreter traces them).

Tolerances, NaN positions and infinities always equal:
- bit for bit, but for
- multiplySeries is held bit for bit: QK4's product and its plain version
  multiply in lane order from 1.0, as XLA:CPU's ``segment_prod`` does; a
  probe of groups of 1 to 3,000 lanes whose products overflow and then
  meet a zero (``test_multiply_in_lane_order``) holds it past one chunk;
- rtol/atol 1e-12 (``SUM``): the in-order sums against XLA's grouping of
  ``jnp.cumsum`` and ``lax.reduce_window`` past 12 cells (integral,
  integralByInterval, the moving sums and averages, summarize's sum, avg
  and multiply), which also gives -0.0 for a window of one -0.0 cell where
  the in-order sum from 0.0 gives +0.0; ``pow`` and ``logarithm`` (XLA's
  own pow and log);
- rtol/atol 1e-9 (``STAT``): stddev and the percentiles (XLA:CPU contracts
  jnp's ``lo * (1 - w) + hi * w`` into an FMA; the port rounds twice, as
  QK6 does; ROADMAP queue 3).  The masks of remove{Above,Below}Percentile
  are NaN positions, so they stay exact.
"""

import functools

import jax
import numpy as np
import pytest
import torch

from m3_tpu.models import query_pipeline as jq
from m3_tpu_torch.models import corpus
from m3_tpu_torch.ops import _build, graphite, query_grouped

from test_torch_m3tsz_decode import assert_same

SUM = (1e-12, 1e-12)
STAT = (1e-9, 1e-9)
G_PAD = 8
REAL_S = 41


def _probe():
    v, groups, _ = corpus.graphite_probe_matrix(real_S=REAL_S)
    steps = (1_600_000_000 + 60 * np.arange(v.shape[1], dtype=np.int64)) * 10**9
    steps[REAL_S:] = steps[REAL_S - 1]
    return v, groups, steps


# (op, extra, tolerance) of _graphite_grouped_reduce; single-group ops run
# with every group id 0, as the lowering gives them
GROUPED = [("sum", (), SUM), ("count", (), None), ("avg", (), SUM), ("min", (), None),
           ("max", (), None), ("multiply", (), None), ("range", (), None), ("stddev", (), STAT),
           ("count_series", (), None)]
SINGLE = [("diff", (), SUM), ("last", (), None), ("median", (), STAT)] + [
    ("percentile", (q,), STAT) for q in (-20.0, 0.0, 20.0, 50.0, 75.0, 95.0, 100.0, 150.0)]


def _calls():
    """(fn, statics after real_S, fparams, tolerance) of _graphite_call."""
    _, _, steps = _probe()
    c = [("scale", (), (2.5,), None), ("offset", (), (-7.5,), None), ("absolute", (), (), None),
         ("invert", (), (), None), ("logarithm", (), (np.log(10.0),), SUM),
         ("pow", (), (2.0,), SUM), ("pow", (), (0.5,), SUM), ("pow", (), (-0.5,), SUM),
         ("squareRoot", (), (), None), ("transformNull", (), (0.0,), None),
         ("transformNull", (), (-1.5,), None), ("removeAboveValue", (), (25.0,), None),
         ("removeBelowValue", (), (10.0,), None), ("isNonNull", (), (), None),
         ("derivative", (), (), None), ("nonNegativeDerivative", (), (), None),
         ("perSecond", (), (60.0,), None), ("changed", (), (), None),
         ("timeSlice", (), (np.int64(steps[5]), np.int64(steps[30])), None),
         ("integral", (), (), SUM), ("offsetToZero", (), (), None), ("minMax", (), (), None)]
    c += [("keepLastValue", (), (limit,), None) for limit in (0.0, 2.0, np.inf)]
    c += [("delay", (k,), (), None) for k in (3, -2, 0, 100)]
    for fn in ("movingAverage", "movingSum", "movingMax", "movingMin"):
        tol = SUM if fn in ("movingAverage", "movingSum") else None
        c += [(fn, (w,), (), tol) for w in (1, 3, 50)]
    for func in ("sum", "total", "", "avg", "average", "max", "min", "count", "range",
                 "rangeOf", "multiply"):
        tol = SUM if func in ("sum", "total", "", "avg", "average", "multiply") else None
        c += [("summarize", (k, func), (), tol) for k in (5, 41, 50)]
    c += [("integralByInterval", (k,), (), SUM) for k in (1, 5, 7)]
    c += [("nPercentile", (q,), (), STAT) for q in (-20.0, 0.0, 50.0, 90.0, 100.0, 150.0)]
    c += [(fn, (q,), (), STAT) for fn in ("removeAbovePercentile", "removeBelowPercentile")
          for q in (20.0, 80.0)]
    return c


CALLS = _calls()


def _fparams(fp):
    return tuple(np.asarray(x, dtype=np.int64 if isinstance(x, np.integer) else np.float64)
                 for x in fp)


@functools.lru_cache(maxsize=None)
def _jax() -> list:
    """Every case through the reference, one compiled program."""
    v, groups, steps = _probe()

    def run(cv, grp, steps, fps):
        zeros = jax.numpy.zeros_like(grp)
        out = [jq._graphite_grouped_reduce(cv, grp, G_PAD, op, ex, 5.0) for op, ex, _ in GROUPED]
        out += [jq._graphite_grouped_reduce(cv, zeros, G_PAD, op, ex, 0.0) for op, ex, _ in SINGLE]
        out += [jq._graphite_call(fn, cv, (REAL_S,) + st, fp, steps)
                for (fn, st, _, _), fp in zip(CALLS, fps)]
        return out

    fps = [_fparams(fp) for _, _, fp, _ in CALLS]
    return [np.array(a) for a in jax.jit(run)(v, groups, steps, fps)]


def _check(got: torch.Tensor, want: np.ndarray, tol, what: str):
    if tol is None:
        assert_same(got, want, what)
        return
    g = got.numpy()
    np.testing.assert_array_equal(np.isnan(g), np.isnan(want), err_msg=f"{what}: NaN positions")
    np.testing.assert_allclose(g, want, rtol=tol[0], atol=tol[1], equal_nan=True, err_msg=what)
    np.testing.assert_array_equal(g[np.isinf(want)], want[np.isinf(want)], err_msg=what)


CASES = ([("grouped", i) for i in range(len(GROUPED))] + [("single", i) for i in range(len(SINGLE))]
         + [("call", i) for i in range(len(CALLS))])


def _case_id(case):
    kind, i = case
    if kind == "grouped":
        return f"gagg-{GROUPED[i][0]}"
    if kind == "single":
        return f"gagg-{SINGLE[i][0]}{list(SINGLE[i][1]) or ''}"
    fn, st, fp, _ = CALLS[i]
    return f"gcall-{fn}{list(st) or ''}{[float(x) for x in fp] or ''}"


@pytest.mark.parametrize("case", CASES, ids=[_case_id(c) for c in CASES])
def test_plain_matches_jax(case):
    v, groups, steps = _probe()
    kind, i = case
    cv = torch.from_numpy(v)
    if kind == "grouped":
        op, ex, tol = GROUPED[i]
        got = graphite.grouped_reduce(cv, groups, G_PAD, op, ex, 5.0)
        want = _jax()[i]
    elif kind == "single":
        op, ex, tol = SINGLE[i]
        got = graphite.grouped_reduce(cv, np.zeros_like(groups), G_PAD, op, ex, 0.0)
        want = _jax()[len(GROUPED) + i]
    else:
        fn, st, fp, tol = CALLS[i]
        got = graphite.call(fn, cv, (REAL_S,) + st,
                            tuple(torch.as_tensor(x) for x in _fparams(fp)),
                            torch.from_numpy(steps))
        want = _jax()[len(GROUPED) + len(SINGLE) + i]
    _check(got, want, tol, _case_id(case))
    assert got.device.type == "cpu" and got.dtype == torch.float64


def test_probe_reaches_the_corners():
    """The probe's cases reach what they are meant to: empty groups and
    all-NaN columns give the empty results, the percentile meets +-inf (a
    +inf neighbour at weight 0 gives NaN), the padding columns carry values
    where the reference leaves them."""
    v, _, _ = _probe()
    want = dict(zip([_case_id(c) for c in CASES], _jax()))
    assert (want["gagg-sum"][:, 3] == 0.0).all() and np.isnan(want["gagg-avg"][:, 3]).all()
    assert (want["gagg-multiply"][:, 3] == 1.0).all()
    top_inf = (v[:, :REAL_S] == np.inf).any(axis=0)
    assert top_inf.any() and np.isnan(want["gagg-percentile[100.0]"][0, :REAL_S][top_inf]).all()
    assert any(np.isinf(want[f"gagg-percentile[{q}]"][0]).any() for q in (20.0, 75.0, 95.0))
    assert (want["gcall-minMax"][:, REAL_S:] == 0.0).all()
    assert (want["gcall-transformNull[-1.5]"][:, REAL_S:] == -1.5).all()
    assert np.isfinite(want["gcall-integral"][0, REAL_S:]).all()
    signs = np.signbit(want["gcall-keepLastValue[inf]"][2][:REAL_S])
    assert signs.any() and not signs.all()


@pytest.mark.parametrize("op", ["diff", "median", "percentile", "last"])
def test_single_group_ops_refuse_groups(op):
    v, groups, _ = _probe()
    with pytest.raises(ValueError, match="one group"):
        graphite.grouped_reduce(torch.from_numpy(v), groups, G_PAD, op, (50.0,))


def test_unknown_forms_raise():
    v, groups, steps = _probe()
    cv, st = torch.from_numpy(v), torch.from_numpy(steps)
    with pytest.raises(ValueError, match="no device form"):
        graphite.grouped_reduce(cv, groups, G_PAD, "mode")
    with pytest.raises(ValueError, match="no device form"):
        graphite.call("sortByMaxima", cv, (REAL_S,), (), st)
    with pytest.raises(ValueError, match="no device form for summarize"):
        graphite.call("summarize", cv, (REAL_S, 5, "median"), (), st)
    with pytest.raises(ValueError, match="at least 1"):
        graphite.row_transform(cv, "movingSum", REAL_S, k=0)
    with pytest.raises(ValueError, match="finite"):
        graphite.percentile_rows(cv, np.nan, REAL_S, "nPercentile")
    with pytest.raises(ValueError, match="finite"):
        graphite.grouped_reduce(cv, np.zeros_like(groups), G_PAD, "percentile", (np.inf,))



# GK3's moving windows on a long probe: [8, 512] with 401 real steps, NaN
# holes, +-Inf entering and leaving windows (row 1; row 5's lone +Inf),
# runs of -0.0, an all-NaN row and 1e6 spikes; widths across the kernel's
# 16-step tiles and window blocks, an hour of 60 s steps, and wider than the
# real steps.  One compiled JAX program.
LONG_REAL_S = 401
LONG_WIDTHS = (1, 15, 16, 17, 31, 32, 33, 60, 400, 450)
MOVING = [(fn, w) for fn in ("movingSum", "movingAverage", "movingMax", "movingMin")
          for w in LONG_WIDTHS]


def _long_probe() -> np.ndarray:
    rng = np.random.default_rng(37)
    v = np.round(rng.uniform(-50, 50, (8, 512)), 2)
    v[rng.random(v.shape) < 0.2] = np.nan
    v[1, rng.random(512) < 0.03] = np.inf
    v[1, rng.random(512) < 0.03] = -np.inf
    v[2, 100:140] = -0.0
    v[2, 300:303] = -0.0
    v[3] = np.nan
    v[4, ::3] = 1e6
    v[5, 200] = np.inf
    v[:, LONG_REAL_S:] = v[:, LONG_REAL_S - 1:LONG_REAL_S]
    return v


@functools.lru_cache(maxsize=None)
def _jax_long() -> list:
    v = _long_probe()
    steps = np.arange(v.shape[1], dtype=np.int64)

    def run(cv):
        return [jq._graphite_call(fn, cv, (LONG_REAL_S, w), (), steps) for fn, w in MOVING]

    return [np.array(a) for a in jax.jit(run)(v)]


@pytest.mark.parametrize("i", range(len(MOVING)), ids=[f"{fn}[{w}]" for fn, w in MOVING])
def test_long_moving_windows_match_jax(i):
    """The plain moving windows (block-wise sums past 16 cells) against the
    reference's lax.reduce_window: sums and averages at ``SUM``, max and
    min bit for bit, NaN positions and infinities exact."""
    fn, w = MOVING[i]
    got = graphite.row_transform(torch.from_numpy(_long_probe()), fn, LONG_REAL_S, w)
    _check(got, _jax_long()[i], SUM if fn in ("movingSum", "movingAverage") else None,
           f"{fn}[{w}]")


def test_long_probe_reaches_the_corners():
    """An Inf that leaves a window leaves it finite (no running difference),
    the max of a window of -0.0 cells only is -0.0, and windows wider than
    the real steps cover them all."""
    want = dict(zip(MOVING, _jax_long()))
    for w in (17, 60, 400):
        s = want[("movingSum", w)][5]
        assert np.isinf(s[200:200 + w]).all() and np.isfinite(s[200 + w:LONG_REAL_S]).all()
    m = want[("movingMax", 33)][2, 132:140]
    assert (m == 0.0).all() and np.signbit(m).all()
    wide = want[("movingSum", 450)]  # every real step in the window up to column 449
    np.testing.assert_allclose(wide[:, LONG_REAL_S:450],
                               np.repeat(wide[:, LONG_REAL_S - 1:LONG_REAL_S], 49, axis=1),
                               rtol=SUM[0], atol=SUM[1])  # XLA regroups the sum per column


# GK2's column form on a wide probe: [5,000 x 8] of a column of ties with
# NaN holes, an all-equal column, an all-NaN column, a +-0.0 column whose
# middle ranks land among the zeros, +inf mixed with NaN, small integers,
# only +-0.0 and NaN, and two runs that differ in the last bit; percentiles
# -20 to 150.  One compiled JAX program.
WIDE_QS = (-20.0, 0.0, 10.0, 25.0, 50.0, 75.0, 90.0, 95.0, 100.0, 150.0)


def _wide_probe() -> np.ndarray:
    rng = np.random.default_rng(41)
    n = 5000
    v = np.round(rng.uniform(-100, 100, (n, 8)), 1)
    v[rng.random(n) < 0.15, 0] = np.nan
    v[:, 1] = 3.25
    v[:, 2] = np.nan
    v[:, 3] = np.where(rng.random(n) < 0.5, -0.0, 0.0)
    v[:1500, 3] = -2.0
    v[3500:, 3] = 2.0
    v[:, 4] = np.where(rng.random(n) < 0.5, np.nan, np.inf)
    v[:200, 4] = -1.0
    v[:, 5] = rng.integers(-3, 4, n).astype(np.float64)
    v[:, 6] = np.where(rng.random(n) < 0.4, np.nan, np.where(rng.random(n) < 0.5, -0.0, 0.0))
    v[:, 7] = np.where(np.arange(n) < n // 2, 1.0, np.nextafter(1.0, 2.0))
    return v


@functools.lru_cache(maxsize=None)
def _jax_wide() -> list:
    v = _wide_probe()
    zeros = np.zeros(v.shape[0], dtype=np.int64)

    def run(cv, grp):
        out = [jq._graphite_grouped_reduce(cv, grp, G_PAD, "percentile", (q,), 0.0)
               for q in WIDE_QS]
        return out + [jq._graphite_grouped_reduce(cv, grp, G_PAD, "median", (), 0.0)]

    return [np.array(a) for a in jax.jit(run)(v, zeros)]


@pytest.mark.parametrize("i", range(len(WIDE_QS) + 1),
                         ids=[f"percentile[{q}]" for q in WIDE_QS] + ["median"])
def test_wide_column_percentiles_match_jax(i):
    """GK2's column form (plain) against jnp.nanpercentile over the lanes at
    ``STAT``, NaN positions and infinities exact."""
    v = _wide_probe()
    zeros = np.zeros(v.shape[0], dtype=np.int64)
    op, ex = ("median", ()) if i == len(WIDE_QS) else ("percentile", (WIDE_QS[i],))
    got = graphite.grouped_reduce(torch.from_numpy(v), zeros, G_PAD, op, ex)
    _check(got, _jax_wide()[i], STAT, f"{op}{list(ex)}")


def test_wide_probe_reaches_the_corners():
    """The ranks land where the probe means them to: among mixed +-0.0 with
    both signs read, on +inf past the finite cells (where the median's
    midpoint gives +inf and a percentile's inf * 0 weight NaN), on either
    side of two runs one ulp apart."""
    want = dict(zip(WIDE_QS + ("median",), (w[0] for w in _jax_wide())))
    assert np.isnan(want[50.0][2]) and (want[-20.0][1] == 3.25) and (want[150.0][1] == 3.25)
    assert want[50.0][3] == 0.0 and want["median"][3] == 0.0
    assert {bool(np.signbit(want[q][6])) for q in WIDE_QS} == {False, True}
    assert want[0.0][4] == -1.0 and want["median"][4] == np.inf
    assert np.isnan([want[q][4] for q in WIDE_QS[2:]]).any()
    assert want[25.0][7] == 1.0 and want[75.0][7] == np.nextafter(1.0, 2.0)


# multiplySeries past one of QK4's chunks: groups of 1, CHUNK - 1, CHUNK,
# CHUNK + 1 and 3,000 lanes (interleaved), 7 all-NaN padding lanes on group
# 0, three empty groups.  "wide": uniform in +-1,000 with zeros, NaN holes
# and +-Inf, so products overflow and later meet a zero (column 0: no zero
# or infinity, so +-inf by overflow; column 1: a zero on each group's first
# member; column 2: on its last; column 3: every cell NaN); "near one":
# 1 +- 1e-3, where every order rounds differently.  One compiled program.
MULTIPLY_SIZES = (1, 255, 256, 257, 3000)


def _multiply_probe(kind: str):
    rng = np.random.default_rng(43 if kind == "wide" else 44)
    groups = rng.permutation(np.repeat(np.arange(len(MULTIPLY_SIZES)), MULTIPLY_SIZES))
    L, S = len(groups), 24
    if kind == "wide":
        v = rng.uniform(-1000, 1000, (L, S))
        pick = rng.random((L, S))
        v[pick < 0.01] = 0.0
        v[(pick >= 0.01) & (pick < 0.02)] = -0.0
        v[(pick >= 0.02) & (pick < 0.12)] = np.nan
        v[(pick >= 0.12) & (pick < 0.125)] = np.inf
        v[(pick >= 0.125) & (pick < 0.13)] = -np.inf
        v[:, :3] = rng.uniform(-1000, 1000, (L, 3))
        for g in range(len(MULTIPLY_SIZES)):
            lanes = np.flatnonzero(groups == g)
            v[lanes[0], 1] = -0.0 if g % 2 else 0.0
            v[lanes[-1], 2] = 0.0
        v[:, 3] = np.nan
    else:
        v = 1.0 + rng.uniform(-1e-3, 1e-3, (L, S))
        v[rng.random((L, S)) < 0.1] = np.nan
    v = np.concatenate([v, np.full((7, S), np.nan)])
    return v, np.concatenate([groups, np.zeros(7, dtype=np.int64)])


@functools.lru_cache(maxsize=None)
def _jax_multiply() -> dict:
    probes = {kind: _multiply_probe(kind) for kind in ("wide", "near one")}

    def run(cvs, grps):
        return [jq._graphite_grouped_reduce(cv, g, G_PAD, "multiply", (), 0.0)
                for cv, g in zip(cvs, grps)]

    outs = jax.jit(run)([p[0] for p in probes.values()], [p[1] for p in probes.values()])
    return {kind: np.array(o) for kind, o in zip(probes, outs)}


@pytest.mark.parametrize("kind", ["wide", "near one"])
def test_multiply_in_lane_order(kind):
    """multiplySeries (QK4's plain version) against the reference's
    ``segment_prod`` over groups past one chunk, bit for bit: NaN
    positions, signed zeros and infinities exact."""
    v, groups = _multiply_probe(kind)
    got = graphite.grouped_reduce(torch.from_numpy(v), groups, G_PAD, "multiply")
    assert_same(got, _jax_multiply()[kind], f"multiply {kind}")


def test_multiply_probe_reaches_the_corners():
    """The wide probe's products end +-inf, +-0.0 and NaN (inf * 0) in the
    large groups and 1.0 where every cell is NaN; a product folded chunk by
    chunk (CHUNK lanes, then the partials in order) gives other bits on
    both probes, so the test tells the orders apart."""
    want = _jax_multiply()
    wide = want["wide"]
    big = wide[4]  # the 3,000-lane group
    assert np.isinf(big[0]) and np.isnan(big).any()
    assert (wide[:5, 1] == 0.0).all() and {bool(np.signbit(x)) for x in wide[:5, 1]} == {
        False, True}
    assert np.isnan(wide[1:5, 2]).all() and (wide[:, 3] == 1.0).all()
    for kind in want:
        v, groups = _multiply_probe(kind)
        chunked = np.ones_like(want[kind])
        with np.errstate(over="ignore", invalid="ignore"):
            for g in range(len(MULTIPLY_SIZES)):
                lanes = np.flatnonzero(groups == g)
                cells = np.where(np.isnan(v[lanes]), 1.0, v[lanes])
                for c0 in range(0, len(lanes), query_grouped.CHUNK):
                    part = np.ones(v.shape[1])
                    for row in cells[c0:c0 + query_grouped.CHUNK]:
                        part = part * row
                    chunked[g] = chunked[g] * part
        assert (chunked.view(np.int64) != want[kind].view(np.int64)).any(), kind


class _FakeGrouped:
    """Stands in for QK4's library: records each call's chunk table, fold
    table and partial count (the wrapper's pointers are passed as the
    tensors themselves)."""

    def __init__(self):
        self.calls = []

    def m3_query_grouped(self, x, S, members, chunks, n_chunks, n_partial, folds, n_folds,
                         n_groups, agg, empty, center, n_center, partials, out, stream):
        assert chunks.shape == (5, n_chunks)
        assert (n_folds == 0 and folds is None) or folds.shape == (3, n_folds)
        assert partials is None if n_partial == 0 else partials.shape == (4, n_partial, S)
        self.calls.append((chunks.numpy(), n_partial,
                           [] if folds is None else folds.numpy().T.tolist()))
        return 0


C = query_grouped.CHUNK


@pytest.mark.parametrize("sizes,want", [
    ([1] * 6, (6, 0, [])),  # groupByNode's one-lane groups: one chunk each
    ([C - 1, C, C + 1], (4, 2, [[2, 0, 2]])),  # C + 1 lanes: two chunks, folded
    ([65_536] + [0] * 7, (263, 256, [[0, 0, 256]])),  # sumSeries and its empty padding groups
    ([0, 0], (2, 0, [])),  # an empty group is one empty chunk
    ([40, 1, 1, 0, 2], (5, 0, [])),  # padding parked on group 0
    ([2 * C + 5, 3, C + 1], (6, 5, [[0, 0, 3], [2, 3, 2]])),  # two groups of several
    ([C + 40, 1, 1, 1], (5, 2, [[0, 0, 2]])),  # the padding takes group 0 past a chunk
])
def test_grouped_launch_classes(monkeypatch, sizes, want):
    """QK4's host plan: one call whose chunk table cuts each group into runs
    of at most CHUNK consecutive members, the groups of several first (each
    with its fold: group, first chunk, chunks), so a group's fold order
    depends only on its own size."""
    fake = _FakeGrouped()
    monkeypatch.setattr(_build, "library", lambda name, sig: fake)
    monkeypatch.setattr(query_grouped, "_ptr", lambda t: None if t is None or not t.numel() else t)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda dev: type("S", (), {"cuda_stream": 0}))
    groups = np.repeat(np.arange(len(sizes)), sizes)
    index = query_grouped.group_index(groups, len(sizes), "cpu")
    x = torch.zeros((len(groups), 40), dtype=torch.float64)
    out = query_grouped._launch(x, index, "sum", 0.0)
    assert out.shape == (len(sizes), 40)
    assert len(fake.calls) == 1
    chunks, n_partial, folds = fake.calls[0]
    assert (chunks.shape[1], n_partial, folds) == want
    lo, hi, grp, fold, lane = chunks
    assert ((hi - lo) <= C).all() and (hi >= lo).all()
    members, _ = query_grouped.group_csr(groups, len(sizes))
    assert (lane[hi > lo] == members[lo[hi > lo]]).all() and (lane[hi == lo] == 0).all()
    assert (fold[:n_partial] >= 0).all() and (fold[n_partial:] == -1).all()
    offsets = np.concatenate([[0], np.cumsum(sizes)])
    for g in range(len(sizes)):  # each group's members exactly once, in order
        mine = np.flatnonzero(grp == g)
        assert len(mine) == max(1, -(-sizes[g] // C))
        assert lo[mine[0]] == offsets[g] and hi[mine[-1]] == offsets[g + 1]
        assert (lo[mine[1:]] == hi[mine[:-1]]).all()
