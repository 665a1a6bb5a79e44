"""Port parity: the rest of PromQL's range functions (stddev/stdvar,
changes/resets, deriv/predict_linear, holt_winters, quantile_over_time)
and the subquery's packing of its inner grid, plain PyTorch vs the JAX
package.

The same numpy lanes (``corpus.temporal_probe_lanes``: NaN holes, an
all-NaN lane, a sparse lane at the 2-sample edge, the 1.5e9 + N(0, 1)
cancellation canary, +-Inf samples, +-0.0 ties and repeats, a counter with
resets, a short lane) go through the jitted ``_temporal_eval`` of
``m3_tpu.models.query_pipeline`` and the port's plain versions, at ranges
of 93s and 10m, over sweeps of phi, (sf, tf) and the horizon.

Tolerances (``check_temporal``, shared with the per-node and interpreter
tests):
- changes/resets: bit for bit (integer counts);
- the others: rtol 1e-9, atol 1e-9 with NaN positions and infinities equal
  (the reference's differential gate for these functions,
  ``tests/test_promql_differential.py:327-348``), except:
  - stddev/stdvar on lanes that reach 1e8 (the 1e9-offset canary): rtol
    1e-5, the reference's own device-vs-host bound for it
    (``tests/test_query_pipeline_device.py:374-376``), with its O(1)
    asserts;
  - deriv/predict_linear on lanes that reach 1e8: 16 times the
    conditioning of the reference's prefix form
    (``query_temporal.linreg_conditioning``:
    one rounding of each prefix sum carried through the closed form;
    predict_linear scaled by 1 + |horizon| + range).  The closed form
    subtracts prefix sums of 1e9 * t terms whose rounding depends on the
    summation order: the reference's own host and device tiers differ by as
    much (ROADMAP queue 3);
  - cells where the reference's device form departs from its own host
    contract on +-Inf samples (``reference_deviates``; ROADMAP queue 3):
    there the port is held to the host oracle (``ops/consolidate.py``, held
    bit for bit against the reference's in tests/test_torch_consolidate.py)
    at the same tolerance, on time-sorted lanes.

The JAX references come from one compiled program over every function
and parameter (the range is traced).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from m3_tpu.models import query_pipeline as jq
from m3_tpu_torch.models import corpus
from m3_tpu_torch.models import query_pipeline as tq
from m3_tpu_torch.ops import consolidate as tcons
from m3_tpu_torch.ops import query_merge, query_temporal

from test_torch_m3tsz_decode import assert_same

SEC = 1_000_000_000
RANGES = (93 * SEC, 600 * SEC)
NEW_FNS = (query_temporal.CHANGES_FNS + query_temporal.LINREG_FNS + query_temporal.STDVAR_FNS
           + query_temporal.WINDOW_FNS)
INF_DEVIATING = query_temporal.LINREG_FNS + query_temporal.STDVAR_FNS + ("holt_winters",)
PHIS = (0.0, 0.25, 0.5, 0.9, 0.99, 1.0)
HW = ((0.5, 0.5), (0.3, 0.1), (0.8, 0.6))
HORIZONS = (0.0, 600.0, 14400.0)
BIG = 1e8  # lanes whose samples reach this are the 1e9-offset ones
REF_BLOCK = 32  # the reference's block of _stdvar_device (_MINMAX_BLOCK)


def reference_deviates(fn: str, times, values, steps, range_nanos: int) -> np.ndarray:
    """bool[L, S]: the cells where the reference's device form departs from
    its own host contract (ROADMAP queue 3).  deriv, predict_linear,
    holt_winters: windows holding a +-Inf sample (its prefix sums and
    affine maps meet inf - inf in another order than the host's).
    stddev/stdvar: windows whose 32-sample blocks hold one (its same-block
    pass multiplies the whole block by a 0/1 mask, and Inf * 0 is NaN)."""
    if fn not in INF_DEVIATING:
        return np.zeros((len(times), len(steps)), dtype=bool)
    _, left, right = query_temporal.window_bounds_plain(
        torch.from_numpy(times), torch.from_numpy(steps), range_nanos)
    left, right = left.numpy(), right.numpy()
    N = values.shape[1]
    cum = np.concatenate([np.zeros((len(values), 1), dtype=np.int64),
                          np.cumsum(np.isinf(values), axis=1)], axis=1)
    if fn in query_temporal.STDVAR_FNS:
        lo = np.clip(left, 0, N - 1) // REF_BLOCK * REF_BLOCK
        hi = np.minimum(N, (np.clip(right - 1, 0, N - 1) // REF_BLOCK + 1) * REF_BLOCK)
    else:
        lo, hi = left, np.maximum(right, left)
    return np.take_along_axis(cum, hi, axis=1) > np.take_along_axis(cum, lo, axis=1)


def host_oracle(fn: str, times, values, steps, range_nanos: int, horizon=0.0, sf=0.5, tf=0.5,
                phi=0.5) -> np.ndarray:
    """The copied host tier's value of ``fn`` (numpy)."""
    with np.errstate(all="ignore"):
        if fn in query_temporal.CHANGES_FNS:
            return tcons.window_changes(times, values, steps, range_nanos, fn == "resets")
        if fn in query_temporal.LINREG_FNS:
            slope, intercept, _ = tcons.window_linreg(times, values, steps, range_nanos)
            return slope if fn == "deriv" else intercept + slope * horizon
        if fn == "holt_winters":
            return tcons.window_holt_winters(times, values, steps, range_nanos, sf, tf)
        if fn == "quantile_over_time":
            return tcons.window_quantile(times, values, steps, range_nanos, phi)
        return tcons.window_reduce(times, values, steps, range_nanos, fn)


def _close_cells(got, want, rtol, atol, what):
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want), err_msg=f"{what}: NaN")
    inf = np.isinf(want)
    np.testing.assert_array_equal(got[inf], want[inf], err_msg=f"{what}: infinities")
    fin = np.isfinite(want)
    bad = ~(np.abs(got[fin] - want[fin]) <= atol[fin] + rtol[fin] * np.abs(want[fin]))
    assert not bad.any(), (f"{what}: {int(bad.sum())} cells beyond the bound, e.g. "
                           f"{got[fin][bad][:3]} vs {want[fin][bad][:3]}")


def check_temporal(fn: str, got, want, times, values, steps, range_nanos: int,
                   horizon=0.0, sf=0.5, tf=0.5, what: str = ""):
    """The port's ``fn`` (got) against the jitted reference (want) on the
    lanes (times, values) at the tolerances of the module note."""
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    what = what or fn
    if fn in query_temporal.CHANGES_FNS:
        assert_same(torch.from_numpy(got), want, what)
        return
    shape = want.shape
    big = np.broadcast_to((np.abs(np.nan_to_num(values)) >= BIG).any(axis=1)[:, None], shape)
    rtol = np.full(shape, 1e-9)
    atol = np.full(shape, 1e-9)
    if fn in query_temporal.STDVAR_FNS:
        rtol[big] = 1e-5
    if fn in query_temporal.LINREG_FNS and big.any():
        scale = 1.0 if fn == "deriv" else 1.0 + abs(horizon) + range_nanos * 1e-9
        kappa = query_temporal.linreg_conditioning(
            *(torch.from_numpy(x) for x in (times, values, steps)), range_nanos).numpy()
        atol[big] = np.maximum(atol[big], 16 * kappa[big] * scale)
    dev = reference_deviates(fn, times, values, steps, range_nanos)
    _close_cells(got[~dev], want[~dev], rtol[~dev], atol[~dev], f"{what} vs JAX")
    dev &= (np.diff(times, axis=1) >= 0).all(axis=1)[:, None]  # the host's bounds need order
    rows = np.flatnonzero(dev.any(axis=1))
    if fn in query_temporal.LINREG_FNS:  # the fit's origin is the first step's: every step
        blocks = [np.arange(shape[1])] if len(rows) else []
    else:  # one step at a time (the host's loops are O(S * N))
        blocks = [np.asarray([c]) for c in np.flatnonzero(dev.any(axis=0))]
    for cols in blocks:
        t, v = times[rows], values[rows]
        if fn not in query_temporal.LINREG_FNS:
            # these functions read only the window's samples: the host runs
            # over the span of the step's windows
            _, left, right = query_temporal.window_bounds_plain(
                torch.from_numpy(t), torch.from_numpy(steps[cols]), range_nanos)
            lo, hi = int(left.min()), max(int(right.max()), int(left.min()) + 2)
            t, v = t[:, lo:hi], v[:, lo:hi]
        host = host_oracle(fn, t, v, steps[cols], range_nanos, horizon, sf, tf)
        sub = np.ix_(rows, cols)
        m = dev[sub]
        _close_cells(got[sub][m], host[m], rtol[sub][m], atol[sub][m],
                     f"{what} vs the host where JAX departs")


def _cases():
    """(fn, kwargs of _temporal_eval) of every swept case."""
    out = []
    for fn in NEW_FNS:
        if fn == "predict_linear":
            out += [(fn, {"horizon": h}) for h in HORIZONS]
        elif fn == "holt_winters":
            out += [(fn, {"hw_sf": sf, "hw_tf": tf}) for sf, tf in HW]
        elif fn == "quantile_over_time":
            out += [(fn, {"phi": phi}) for phi in PHIS]
        else:
            out.append((fn, {}))
    return out


CASES = _cases()


def _case_id(fn, kw):
    return fn + "".join(f"-{v}" for v in kw.values())


@functools.lru_cache(maxsize=None)
def _lanes():
    return corpus.temporal_probe_lanes()


@functools.lru_cache(maxsize=None)
def _jax() -> dict:
    """Every case at both ranges through the jitted reference."""
    t, v, st = _lanes()

    def run(t, v, st, ranges):
        return {(_case_id(fn, kw), i): jq._temporal_eval(fn, t, v, st, ranges[i], **kw)
                for fn, kw in CASES for i in range(len(RANGES))}

    res = jax.jit(run)(jnp.asarray(t), jnp.asarray(v), jnp.asarray(st),
                       jnp.asarray(RANGES, dtype=jnp.int64))
    return {k: np.asarray(x) for k, x in res.items()}


@pytest.mark.parametrize("range_nanos", RANGES)
@pytest.mark.parametrize("fn,kw", CASES, ids=[_case_id(fn, kw) for fn, kw in CASES])
def test_family_matches_jax(fn, kw, range_nanos):
    t, v, st = _lanes()
    got = tq._temporal_eval(fn, *(torch.from_numpy(x) for x in (t, v, st)), range_nanos, **kw)
    want = _jax()[_case_id(fn, kw), RANGES.index(range_nanos)]
    check_temporal(fn, got, want, t, v, st, range_nanos, kw.get("horizon", 0.0),
                   kw.get("hw_sf", 0.5), kw.get("hw_tf", 0.5))
    assert np.isfinite(want).any() and np.isnan(want).any()


def test_family_corners():
    """The probe lanes hit the contract's corners: an all-NaN lane gives
    stddev 0.0 and changes 0 where its windows hold samples, the sparse lane
    windows of one sample (holt_winters NaN) and of two, and the canary an
    O(1) stddev and slope, never a 1e9-scale artifact."""
    t, v, st = (torch.from_numpy(x) for x in _lanes())
    r = RANGES[1]
    sd = query_temporal.stdvar_plain(t, v, st, r, True)
    _, left, right = query_temporal.window_bounds_plain(t, st, r)
    nonempty = right > left
    assert (sd[1][nonempty[1]] == 0.0).all() and nonempty[1].any()
    assert (query_temporal.changes_plain(t, v, st, r, False)[1][nonempty[1]] == 0.0).all()
    n_present = query_temporal.reduce_plain(t, v, st, r, "count_over_time")[2]
    hw = query_temporal.holt_winters_plain(t, v, st, r, 0.5, 0.5)[2]
    assert (n_present == 1).any() and (n_present == 2).any()
    assert torch.isnan(hw[n_present < 2]).all() and not torch.isnan(hw[n_present >= 2]).any()
    canary = sd[3][~torch.isnan(sd[3])]
    assert ((canary > 1e-3) & (canary < 10.0)).all()
    slope = query_temporal.linreg_plain(t, v, st, r)[0][3]
    assert (slope[~torch.isnan(slope)].abs() < 1.0).all()


@pytest.mark.parametrize("phi", [-0.5, 1.5, float("nan")])
def test_quantile_over_time_refuses_phi_outside_0_1(phi):
    t, v, st = (torch.from_numpy(x) for x in _lanes())
    with pytest.raises(ValueError, match="phi"):
        query_temporal.quantile_window(t, v, st, RANGES[0], phi)


# --- QK11 at the window widths its two paths split on -----------------------

# corpus.quantile_width_lanes: windows of 1, 31, 32 (a warp), 33, 64 and 300
# (past a tile's staged run) samples.
QOT_WIDTHS = corpus.QUANTILE_WIDTHS
QOT_PHIS = (0.0, 0.1, 0.5, 0.9, 0.99, 1.0)
_qot_range = corpus.quantile_width_range


@functools.lru_cache(maxsize=None)
def _qot_lanes():
    return corpus.quantile_width_lanes()


@functools.lru_cache(maxsize=None)
def _qot_jax() -> np.ndarray:
    """``_quantile_window_device`` at every (width, phi), one compiled
    program (range and phi traced, vmapped) -> [widths, phis, 6, S]."""
    t, v, st = (jnp.asarray(x) for x in _qot_lanes())
    ranges = jnp.asarray([_qot_range(w) for w in QOT_WIDTHS], dtype=jnp.int64)
    phis = jnp.asarray(QOT_PHIS)

    def run(r, p):
        return jq._quantile_window_device(t, v, st, r, p)

    grid = jax.vmap(lambda r: jax.vmap(lambda p: run(r, p))(phis))
    return np.asarray(jax.jit(grid)(ranges))


@pytest.mark.parametrize("width", QOT_WIDTHS)
def test_quantile_over_time_widths_match_jax(width):
    """quantile_over_time's plain version (QK11's) against the reference's
    ``_quantile_window_device`` on windows of ``width`` samples, phi 0, 0.1,
    0.5, 0.9, 0.99 and 1 (QK11 takes its end buffers at 0, 0.1, 0.9, 0.99
    and 1 and its network at 0.5), at the file's rtol 1e-9 rule; zero
    results exact in sign."""
    t, v, st = _qot_lanes()
    r = _qot_range(width)
    for j, phi in enumerate(QOT_PHIS):
        got = query_temporal.quantile_window(*(torch.from_numpy(x) for x in (t, v, st)), r, phi)
        want = _qot_jax()[QOT_WIDTHS.index(width), j]
        check_temporal("quantile_over_time", got, want, t, v, st, r,
                       what=f"quantile_over_time({phi}) over {width} samples")
        zero = want == 0.0
        assert_same(got[torch.from_numpy(zero)], want[zero], f"zeros at phi {phi}")


def test_quantile_over_time_widths_reach_the_corners():
    """The probe's windows hold exactly each width (full windows in the
    middle), are empty before and after the lanes, all-NaN on lane 1, and
    the selected ranks fall inside runs of mixed +-0.0 on lane 0."""
    t, v, st = (torch.from_numpy(x) for x in _qot_lanes())
    for width in QOT_WIDTHS:
        _, left, right = query_temporal.window_bounds_plain(t, st, _qot_range(width))
        n = right - left
        assert int(n.max()) == width and (n[:, 0] == 0).all() and (n[:, -1] == 0).all()
        assert np.isnan(_qot_jax()[QOT_WIDTHS.index(width), 1, 1]).all()
    _, left, right = query_temporal.window_bounds_plain(t, st, _qot_range(32))
    mixed = 0
    for s in range(st.shape[0]):
        w = v[0, int(left[0, s]):int(right[0, s])]
        if len(w) < 2:
            continue
        order = sorted(range(len(w)), key=lambda i: (float(w[i]), i))  # -0.0 == +0.0
        for h in (0.5 * (len(w) - 1), 0.99 * (len(w) - 1)):
            lo, hi = order[int(np.floor(h))], order[int(np.ceil(h))]
            zs = w[(w == 0.0)]
            if w[lo] == 0.0 and len({bool(x) for x in torch.signbit(zs)}) == 2:
                mixed += 1
    assert mixed > 0


# --- QK12: the subquery's packing of its inner grid --------------------------


def _subq_input(rows: int, S: int, n_valid: int, seed: int):
    rng = np.random.default_rng(seed)
    cv = np.round(rng.standard_normal((rows, S)) * 5, 1)
    pick = rng.random(cv.shape)
    cv[pick < 0.3] = np.nan
    cv[(pick >= 0.3) & (pick < 0.33)] = np.inf
    cv[(pick >= 0.33) & (pick < 0.36)] = -np.inf
    cv[(pick >= 0.36) & (pick < 0.4)] = -0.0
    cv[1] = np.nan  # a row with no survivor
    sub = np.full(S, corpus.START + (n_valid - 1) * 60 * SEC, dtype=np.int64)
    sub[:n_valid] = corpus.START + np.arange(n_valid, dtype=np.int64) * 60 * SEC
    return cv, sub, np.arange(S) < n_valid


@pytest.mark.parametrize("rows,S,n_valid", [(6, 64, 41), (9, 128, 128), (3, 64, 1)])
def test_subq_pack_matches_jax_sort(rows, S, n_valid):
    """The plain version against the reference's own lines
    (query_pipeline.py:1609-1613) on the same cells, bit for bit."""
    cv, sub, valid = _subq_input(rows, S, n_valid, seed=rows)
    tkey = jnp.where(valid[None, :] & ~jnp.isnan(cv), sub[None, :], jq._INF)
    vm = jnp.where(tkey == jq._INF, jnp.nan, cv)
    want = jax.lax.sort((tkey, vm), dimension=1, num_keys=1)
    got = query_merge.subq_pack(*(torch.from_numpy(x) for x in (cv, sub, valid)))
    assert_same(got[0], np.asarray(want[0]), "packed times")
    assert_same(got[1], np.asarray(want[1]), "packed values")
    kept = (~np.isnan(cv) & valid[None, :]).sum(axis=1)
    assert (got[0].numpy()[np.arange(S)[None, :] >= kept[:, None]] == jq._INF).all()


def test_subq_grid_check():
    cv, sub, valid = _subq_input(3, 64, 41, seed=1)
    query_merge.check_subq_grid(torch.from_numpy(sub), torch.from_numpy(valid))
    back = sub.copy()
    back[5] = back[4] - 1
    with pytest.raises(ValueError, match="ascend"):
        query_merge.check_subq_grid(torch.from_numpy(back), torch.from_numpy(valid))
    with pytest.raises(ValueError, match="host"):
        query_merge.check_subq_grid(torch.from_numpy(sub).to("meta"), torch.from_numpy(valid))


# --- QK3's prefix op codes at the lane lengths its kernel splits on ----------

# corpus.prefix_probe_lanes at lanes of 100 samples (under one term a chunk of
# the kernel's 256), 256 and 257 (one term a chunk), 6,144 (the last staged
# in shared memory) and 6,145 (read in place)
PREFIX_CAPS = corpus.PREFIX_PROBE_CAPS
PREFIX_CASES = ([(fn, {}) for fn in query_temporal.REDUCERS + query_temporal.CHANGES_FNS
                 + ("deriv",)] + [("predict_linear", {"horizon": h}) for h in HORIZONS])
BIT_EXACT_REDUCERS = ("count_over_time", "present_over_time", "last_over_time")


@functools.lru_cache(maxsize=None)
def _prefix_lanes(n_cap: int):
    return corpus.prefix_probe_lanes(n_cap)


@functools.lru_cache(maxsize=None)
def _prefix_jax(n_cap: int) -> dict:
    """Every prefix case at both ranges through the jitted reference, one
    compiled program a lane length."""
    t, v, st = _prefix_lanes(n_cap)

    def run(t, v, st, ranges):
        return {(_case_id(fn, kw), i): jq._temporal_eval(fn, t, v, st, ranges[i], **kw)
                for fn, kw in PREFIX_CASES for i in range(len(RANGES))}

    res = jax.jit(run)(jnp.asarray(t), jnp.asarray(v), jnp.asarray(st),
                       jnp.asarray(RANGES, dtype=jnp.int64))
    return {k: np.asarray(x) for k, x in res.items()}


@pytest.mark.parametrize("range_nanos", RANGES)
@pytest.mark.parametrize("fn,kw", PREFIX_CASES, ids=[_case_id(fn, kw) for fn, kw in PREFIX_CASES])
@pytest.mark.parametrize("n_cap", PREFIX_CAPS)
def test_prefix_probes_match_jax(n_cap, fn, kw, range_nanos):
    """QK3's op codes (plain versions) against the reference on
    ``corpus.prefix_probe_lanes``: counts, last and changes/resets bit for
    bit, sum and avg at rtol 1e-12 (atol 1e-12), the fit at rtol 1e-9 and
    atol 1e-9 or 16 times ``linreg_conditioning`` (scaled for
    predict_linear as ``check_temporal`` does), on every lane: the prefix
    sums of t * t over thousands of samples cancel in a short window as the
    1e9-offset lanes' do; cells where the reference departs from its own
    contract on +-Inf samples (``reference_deviates``) are left out, as in
    ``check_temporal``."""
    t, v, st = _prefix_lanes(n_cap)
    got = tq._temporal_eval(fn, *(torch.from_numpy(x) for x in (t, v, st)), range_nanos, **kw)
    want = _prefix_jax(n_cap)[_case_id(fn, kw), RANGES.index(range_nanos)]
    what = f"{fn} {kw} at {n_cap} samples, {range_nanos // SEC}s"
    if fn in BIT_EXACT_REDUCERS:
        assert_same(got, want, what)
    elif fn in query_temporal.REDUCERS:
        tol = np.full(want.shape, 1e-12)
        _close_cells(got.numpy(), want, tol, tol, what)
    else:  # the fit, on every lane: long lanes' t * t sums cancel as the canary's do
        h = kw.get("horizon", 0.0)
        scale = 1.0 if fn == "deriv" else 1.0 + abs(h) + range_nanos * 1e-9
        kappa = query_temporal.linreg_conditioning(
            *(torch.from_numpy(x) for x in (t, v, st)), range_nanos).numpy()
        atol = np.maximum(1e-9, 16 * kappa * scale)
        dev = reference_deviates(fn, t, v, st, range_nanos)
        _close_cells(got.numpy()[~dev], want[~dev], np.full(want.shape, 1e-9)[~dev], atol[~dev],
                     what)
    assert np.isfinite(want).any() and np.isnan(want).any()


@pytest.mark.parametrize("n_cap", PREFIX_CAPS)
def test_prefix_probes_reach_the_corners(n_cap):
    """The probe lanes hold what their docstring says at each length: lanes
    past and short of the kernel's tiers (n_cap itself), +-Inf samples, an
    all-NaN lane, an unsorted lane whose bisected bounds are not monotone,
    and the short lanes' empty windows."""
    t, v, st = _prefix_lanes(n_cap)
    assert t.shape[1] == n_cap and np.isinf(v[0]).any() and np.isnan(v[1]).all()
    assert (np.diff(t[4]) < 0).any()
    _, left, right = query_temporal.window_bounds_plain(
        torch.from_numpy(t), torch.from_numpy(st), RANGES[1])
    n = (right - left).numpy()
    assert (n[6] == 0).any() and (n[7] == 0).any() and (n[6] > 0).any()
    assert (n[0] > 2).any()
    if n_cap > 256:  # the long lanes' values are integers (the docstring's reason)
        fin = np.isfinite(v)
        assert (v[fin] == np.round(v[fin])).all()
