"""Port parity: the fused PromQL fan-out read (decode -> merge ->
rate/reduce -> group-by), plain PyTorch vs the JAX package.

The same numpy batches (``corpus.query_probe_corpus``: counter resets,
NaN/+-Inf samples, sparse and all-NaN lanes, signed zeros, an unsorted
lane, lane overflow, truncation at ``n_dp``, padding streams parked on the
last lane, and a two-tier stitch) go through
``m3_tpu.models.query_pipeline`` (JAX on the CPU) and
``m3_tpu_torch.models.query_pipeline`` with ``device="cpu"``, which runs
every kernel's plain version.  Each temporal function and aggregation is
compared on the reference's own merged lanes, at ranges of 93s and 5m.

Tolerances:
- bit for bit (f64 as int64 bit patterns, NaN positions equal): merged
  times and values, per-lane counts, every error flag, window bounds,
  last/count/present_over_time, irate, idelta, changes, resets, grouped
  count/min/max/group;
- stddev/stdvar_over_time, deriv, predict_linear, holt_winters and
  quantile_over_time: ``test_torch_temporal_family.check_temporal`` (rtol
  1e-9, atol 1e-9, with its stated exceptions on 1e9-offset lanes and on
  the +-Inf windows where the reference's device form departs from its
  host contract);
- rtol 1e-12, atol 1e-12: rate/increase/delta, sum/avg_over_time, grouped
  sum/avg and the fleet sum (XLA:CPU's cumsum and segment_sum group their
  additions otherwise than an in-order sum);
- rtol 1e-9, atol 1e-12: grouped stddev/stdvar (XLA:CPU may contract the
  sum of squares into fused multiply-adds).

The JAX references of a batch come from one compiled program, which runs
the entry points, ``_decode_merge``, the tier cut and merge on the decode
grid, every temporal function at both ranges (the range is traced) and
every aggregation; the long-lane case is a second program (without
quantile_over_time, whose [L, S, N] window grid would take gigabytes at
20,480 samples: the port is held there against the host tier's
``window_quantile`` on a subset of the steps).
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
from m3_tpu_torch.ops import m3tsz_decode as tdec
from m3_tpu_torch.ops import consolidate as tcons
from m3_tpu_torch.ops import query_grouped, query_merge, query_temporal

from test_torch_m3tsz_decode import assert_same
from test_torch_temporal_family import check_temporal

SEC = 1_000_000_000
RANGES = (93 * SEC, 300 * SEC)
BIT_EXACT_FNS = ("last_over_time", "count_over_time", "present_over_time", "irate", "idelta")
FAMILY_FNS = (query_temporal.CHANGES_FNS + query_temporal.LINREG_FNS + query_temporal.STDVAR_FNS
              + query_temporal.WINDOW_FNS)
LONG_FNS = tuple(fn for fn in tq.TEMPORAL_FNS if fn != "quantile_over_time")
# the per-node pipeline's parameters: predict_linear's horizon, holt_winters'
# factors, quantile_over_time's phi
REDUCE_PARAMS = {"predict_linear": {"horizon": 600.0}, "holt_winters": {"hw_sf": 0.3, "hw_tf": 0.1},
                 "quantile_over_time": {"phi": 0.9}}
BIT_EXACT_AGGS = ("count", "min", "max", "group")
REAL_LANES = 11  # the probe lanes of query_probe_corpus; the rest are padding
SERVED_GROUPS = 3
LONG_CAP = 20480  # samples per lane of the long-lane case


def assert_close(got: torch.Tensor, want, rtol: float, what: str):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=rtol, atol=1e-12,
                               equal_nan=True, err_msg=what)


@functools.lru_cache(maxsize=None)
def _batch(tiered: bool):
    return corpus.query_probe_corpus(tiered=tiered)


@functools.lru_cache(maxsize=None)
def _decode_grid(tiered: bool):
    """The decode grid of a batch, numpy (ts, vs, valid): the port's plain
    decoder, which tests/test_torch_m3tsz_decode.py holds bit for bit
    against the reference's."""
    b = _batch(tiered)
    ts, vs, valid, _, _ = tdec.decode_batched(torch.from_numpy(b.words),
                                              torch.from_numpy(b.nbits), b.n_dp,
                                              flag_truncation=True)
    return ts.numpy(), vs.numpy(), valid.numpy()


def _temporal_all(times, values, steps, range_nanos, fns=tq.TEMPORAL_FNS):
    out = {fn: jq._temporal_eval(fn, times, values, steps, range_nanos) for fn in fns}
    out["bounds"] = jq._window_bounds_device(times, steps, range_nanos)[1:]
    return out


@functools.lru_cache(maxsize=None)
def _jax(tiered: bool) -> dict:
    """Every JAX reference of a batch, numpy, from one compiled program."""
    b = _batch(tiered)

    def run(words, nbits, slots, steps, groups, tiers, ts, vs, valid, ranges):
        out = {}
        cut = valid
        if tiered:
            cut = out["tier_cut"] = jq._tier_cut(ts, valid, slots, tiers, b.n_lanes, b.n_tiers)
        out["merge"] = jq._merge_device(ts, vs, cut, slots, b.n_lanes, b.n_cap)
        out["decode_merge"] = jq._decode_merge(words, nbits, slots, b.n_lanes, b.n_cap, b.n_dp,
                                               SEC, tiers, b.n_tiers)
        kw = dict(n_lanes=b.n_lanes, n_cap=b.n_cap, range_nanos=b.range_nanos, n_dp=b.n_dp,
                  tiers=tiers, n_tiers=b.n_tiers)
        if tiered:
            out["reduce_pipeline"] = jq.device_reduce_pipeline(
                words, nbits, slots, steps, reducer="avg_over_time", **kw)
            return out
        out["reduce_params"] = {fn: jq.device_reduce_pipeline(
            words, nbits, slots, steps, reducer=fn, **p, **kw)
            for fn, p in REDUCE_PARAMS.items()}
        out["rate_pipeline"] = jq.device_rate_pipeline(words, nbits, slots, steps, **kw)
        out["grouped_pipeline"] = jq.device_grouped_pipeline(
            words, nbits, slots, steps, groups, n_groups=b.n_groups, fn="rate", agg="sum", **kw)
        times, values, _ = out["decode_merge"]
        out["temporal"] = [_temporal_all(times, values, steps, r) for r in ranges]
        # a served [L, S] matrix with NaN/+-Inf cells, signed zeros and
        # all-NaN lanes: last_over_time over the probe lanes stacked on rate
        t = out["temporal"][1]
        served = jnp.concatenate([t["last_over_time"][:REAL_LANES], t["rate"][:REAL_LANES]])
        served_groups = jnp.arange(served.shape[0]) % SERVED_GROUPS
        out["served"] = served, served_groups
        out["grouped"] = {agg: jq._grouped_reduce(served, served_groups, SERVED_GROUPS, agg)
                          for agg in tq.GROUP_AGGS}
        return out

    tiers = None if b.tiers is None else jnp.asarray(b.tiers)
    res = jax.jit(run)(*(jnp.asarray(x) for x in (b.words, b.nbits, b.slots, b.steps, b.groups)),
                       tiers, *(jnp.asarray(x) for x in _decode_grid(tiered)),
                       jnp.asarray(RANGES, dtype=jnp.int64))
    return jax.tree_util.tree_map(np.array, res)


def _jax_temporal(range_nanos: int) -> dict:
    """Every ported temporal function on the reference's merged lanes."""
    return _jax(False)["temporal"][RANGES.index(range_nanos)]


def _port_lanes():
    times, values, _ = _jax(False)["decode_merge"]
    return (torch.from_numpy(times), torch.from_numpy(values),
            torch.from_numpy(_batch(False).steps))


# --- QK1: tier cut and merge ------------------------------------------------


def test_tier_cut_matches_jax():
    b = _batch(True)
    ts, _, valid = _decode_grid(True)
    want = _jax(True)["tier_cut"]
    got = query_merge.tier_cut_plain(torch.from_numpy(ts), torch.from_numpy(valid),
                                     torch.from_numpy(b.slots), torch.from_numpy(b.tiers),
                                     b.n_lanes, b.n_tiers)
    assert_same(got, want, "valid after the tier cut")
    assert (want != valid).any()  # the cut dropped samples


@pytest.mark.parametrize("tiered", [False, True])
def test_merge_matches_jax(tiered):
    """The port's merge (tier cut included) on the decode grid against the
    reference's tier cut + merge of the same grid."""
    b = _batch(tiered)
    ts, vs, valid = _decode_grid(tiered)
    want = _jax(tiered)["merge"]
    got = query_merge.lane_merge(
        torch.from_numpy(ts), torch.from_numpy(vs), torch.from_numpy(valid),
        torch.from_numpy(b.slots), b.n_lanes, b.n_cap,
        None if b.tiers is None else torch.from_numpy(b.tiers), b.n_tiers)
    for name, g, w in zip(("times", "values", "counts"), got, want):
        assert_same(g, w, name)
    unsorted = np.any(np.diff(want[0], axis=1) < 0, axis=1)
    assert_same(got[3], unsorted, "unsorted")
    assert unsorted[1] and not unsorted[0]  # lane 1 steps back in time
    assert got[2][2] > b.n_cap  # lane 2 overflows


@pytest.mark.parametrize("tiered", [False, True])
def test_decode_merge_matches_jax(tiered):
    b = _batch(tiered)
    want = _jax(tiered)["decode_merge"]
    w, nb, slots, _, tiers = tq._inputs(b.words, b.nbits, b.slots, b.steps, b.tiers, "cpu")
    got = tq._decode_merge(w, nb, slots, b.n_lanes, b.n_cap, b.n_dp, SEC, tiers, b.n_tiers)
    for name, g, wv in zip(("times", "values", "error"), got, want):
        assert_same(g, wv, name)
    err = want[2]
    lane_rows = {lane: np.flatnonzero(b.slots == lane) for lane in range(b.n_lanes)}
    assert err[lane_rows[1]].all() and err[lane_rows[2]].all()  # unsorted, overflow
    assert err[lane_rows[4][0]] and not err[lane_rows[4][1:]].any()  # truncation
    assert not err[lane_rows[5]].any()  # a clean sparse lane
    # padding lanes decode all-NaN
    assert np.isnan(want[1][REAL_LANES:]).all()


# --- QK2/QK3: window bounds, the rate family, the prefix-sum reducers -------


@pytest.mark.parametrize("range_nanos", RANGES)
def test_window_bounds_match_jax(range_nanos):
    times, _, steps = _port_lanes()
    _, left, right = query_temporal.window_bounds_plain(times, steps, range_nanos)
    want_left, want_right = _jax_temporal(range_nanos)["bounds"]
    assert_same(left, want_left.astype(np.int64), "left")
    assert_same(right, want_right.astype(np.int64), "right")


@pytest.mark.parametrize("range_nanos", RANGES)
@pytest.mark.parametrize("fn", tq.TEMPORAL_FNS)
def test_temporal_matches_jax(fn, range_nanos):
    times, values, steps = _port_lanes()
    got = tq._temporal_eval(fn, times, values, steps, range_nanos)
    want = _jax_temporal(range_nanos)[fn]
    if fn in BIT_EXACT_FNS:
        assert_same(got, want, fn)
    elif fn in FAMILY_FNS:
        check_temporal(fn, got, want, times.numpy(), values.numpy(), steps.numpy(), range_nanos)
    else:
        assert_close(got, want, 1e-12, fn)
    assert np.isfinite(want).any() and np.isnan(want).any()  # windows of both kinds


@functools.lru_cache(maxsize=None)
def _jax_long() -> dict:
    """Every ported temporal function but quantile_over_time at 5m over
    corpus.long_lanes(LONG_CAP)."""
    t, v, st = corpus.long_lanes(LONG_CAP)
    res = jax.jit(functools.partial(_temporal_all, fns=LONG_FNS))(
        jnp.asarray(t), jnp.asarray(v), jnp.asarray(st), RANGES[1])
    return jax.tree_util.tree_map(np.array, res)


@pytest.mark.parametrize("fn", LONG_FNS)
def test_temporal_long_lanes_match_jax(fn):
    """Lanes of 20,480 samples: the prefix sums have no length limit."""
    tn, vn, stn = corpus.long_lanes(LONG_CAP)
    got = tq._temporal_eval(fn, *(torch.from_numpy(x) for x in (tn, vn, stn)), RANGES[1])
    want = _jax_long()[fn]
    if fn in BIT_EXACT_FNS:
        assert_same(got, want, fn)
    elif fn in FAMILY_FNS:
        check_temporal(fn, got, want, tn, vn, stn, RANGES[1])
    else:
        assert_close(got, want, 1e-12, fn)
    assert np.isfinite(want).any() and np.isnan(want).any()


@pytest.mark.parametrize("phi", [0.0, 0.5, 0.99, 1.0])
def test_quantile_over_time_long_lanes_match_host(phi):
    """quantile_over_time over lanes of 20,480 samples against the host
    tier's window_quantile (every 40th step: its window grid is [L, S,
    N]), rtol 1e-9 (numpy's interpolation rounds otherwise)."""
    tn, vn, stn = corpus.long_lanes(LONG_CAP)
    sub = stn[::40]
    got = tq._temporal_eval("quantile_over_time", *(torch.from_numpy(x) for x in (tn, vn, sub)),
                            RANGES[1], phi=phi)
    want = tcons.window_quantile(tn, vn, sub, RANGES[1], phi)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-9, atol=1e-9, equal_nan=True)
    np.testing.assert_array_equal(got.numpy()[np.isinf(want)], want[np.isinf(want)])
    assert np.isfinite(want).any() and np.isnan(want).any()


# --- QK4: group-by and the fleet sum ------------------------------------------


def _served():
    """The reference's served matrix and its groups (see ``_jax``)."""
    return _jax(False)["served"]


@pytest.mark.parametrize("agg", tq.GROUP_AGGS)
def test_grouped_reduce_matches_jax_padding_inert(agg):
    """Against the reference on the real lanes; the port's input adds 10
    all-NaN padding lanes parked on group 0, which must change nothing."""
    mat, groups = _served()
    pad = np.full((10, mat.shape[1]), np.nan)
    got = tq._grouped_reduce(torch.from_numpy(np.concatenate([mat, pad])),
                             torch.from_numpy(np.concatenate([groups, np.zeros(10, np.int64)])),
                             SERVED_GROUPS, agg)
    want = _jax(False)["grouped"][agg]
    if agg in BIT_EXACT_AGGS:
        assert_same(got, want, agg)
    else:
        assert_close(got, want, 1e-9 if agg in ("stddev", "stdvar") else 1e-12, agg)


def _past_a_chunk():
    """[2 * CHUNK + 37, 6]: a group of CHUNK + 1 lanes, one of 3 and one of
    the rest; NaN holes, +-Inf, +-0.0 and 1e9-offset values."""
    rng = np.random.default_rng(11)
    C = query_grouped.CHUNK
    n = 2 * C + 37
    mat = 1e9 + rng.normal(size=(n, 6)) * 50
    small = rng.random(mat.shape) < 0.3
    mat[small] = rng.normal(size=int(small.sum()))
    mat[rng.random(mat.shape) < 0.2] = np.nan
    mat[rng.random(mat.shape) < 0.01] = np.inf
    mat[rng.random(mat.shape) < 0.01] = -0.0
    groups = np.full(n, 2, dtype=np.int64)
    groups[rng.permutation(n)[:C + 1]] = 0
    groups[[4, 9, 100]] = 1
    return mat, groups, 3


@functools.lru_cache(maxsize=None)
def _jax_past_a_chunk() -> dict:
    mat, groups, n_groups = _past_a_chunk()
    run = jax.jit(lambda m, g: {agg: jq._grouped_reduce(m, g, n_groups, agg)
                                for agg in tq.GROUP_AGGS if agg != "quantile"})
    return jax.tree_util.tree_map(np.array, run(jnp.asarray(mat), jnp.asarray(groups)))


@pytest.mark.parametrize("agg", query_grouped.AGGS)
def test_grouped_reduce_matches_jax_past_a_chunk(agg):
    """Groups larger than QK4's chunk at a narrow S (the plain version the
    kernel is held to on the card)."""
    mat, groups, n_groups = _past_a_chunk()
    got = query_grouped.grouped_reduce(torch.from_numpy(mat), groups, n_groups, agg)
    want = _jax_past_a_chunk()[agg]
    if agg in BIT_EXACT_AGGS:
        assert_same(got, want, agg)
    else:
        assert_close(got, want, 1e-9 if agg in ("stddev", "stdvar") else 1e-12, agg)
    assert np.isfinite(want).any()


def test_fleet_nansum_matches_jax():
    mat, _ = _served()
    got = query_grouped.fleet_nansum(torch.from_numpy(mat))
    assert_close(got, np.asarray(jnp.nansum(jnp.asarray(mat), axis=0)), 1e-12, "fleet")
    assert_same(query_grouped.fleet_nansum(torch.full((3, 4), torch.nan, dtype=torch.float64)),
                np.zeros(4), "all-NaN columns sum to 0.0")


def test_group_csr_is_stable_and_drops_outside_ids():
    members, offsets = query_grouped.group_csr(np.asarray([2, 0, 2, 5, -1, 0, 1]), 3)
    np.testing.assert_array_equal(members, [1, 5, 6, 0, 2])
    np.testing.assert_array_equal(offsets, [0, 2, 3, 5])


# --- the three pipelines end to end ---------------------------------------


def _args(b):
    return (b.words, b.nbits, b.slots, b.steps)


def test_rate_pipeline_matches_jax():
    b = _batch(False)
    want = _jax(False)["rate_pipeline"]
    got = tq.device_rate_pipeline(*_args(b), n_lanes=b.n_lanes, n_cap=b.n_cap,
                                  range_nanos=b.range_nanos, n_dp=b.n_dp, tiers=b.tiers,
                                  n_tiers=b.n_tiers, device="cpu")
    assert_close(got[0], want[0], 1e-12, "rate")
    assert_close(got[1], want[1], 1e-12, "fleet")
    assert_same(got[2], want[2], "error")


def test_reduce_pipeline_matches_jax():
    """The two-tier batch: the tiers go through the entry point."""
    b = _batch(True)
    want = _jax(True)["reduce_pipeline"]
    got = tq.device_reduce_pipeline(*_args(b), n_lanes=b.n_lanes, n_cap=b.n_cap,
                                    range_nanos=b.range_nanos, reducer="avg_over_time",
                                    n_dp=b.n_dp, tiers=b.tiers, n_tiers=b.n_tiers,
                                    device="cpu")
    assert_close(got[0], want[0], 1e-12, "avg_over_time")
    assert_same(got[1], want[1], "error")


def test_grouped_pipeline_matches_jax():
    b = _batch(False)
    want = _jax(False)["grouped_pipeline"]
    got = tq.device_grouped_pipeline(*_args(b), b.groups, n_lanes=b.n_lanes,
                                     n_groups=b.n_groups, n_cap=b.n_cap,
                                     range_nanos=b.range_nanos, fn="rate", agg="sum",
                                     n_dp=b.n_dp, device="cpu")
    assert_close(got[0], want[0], 1e-12, "sum by (g) (rate)")
    assert_same(got[1], want[1], "error")


@pytest.mark.parametrize("fn", sorted(REDUCE_PARAMS))
def test_reduce_pipeline_params_match_jax(fn):
    """device_reduce_pipeline with predict_linear's horizon, holt_winters'
    factors and quantile_over_time's phi."""
    b = _batch(False)
    want = _jax(False)["reduce_params"][fn]
    got = tq.device_reduce_pipeline(*_args(b), n_lanes=b.n_lanes, n_cap=b.n_cap,
                                    range_nanos=b.range_nanos, reducer=fn, n_dp=b.n_dp,
                                    device="cpu", **REDUCE_PARAMS[fn])
    times, values, _ = _jax(False)["decode_merge"]
    p = REDUCE_PARAMS[fn]
    check_temporal(fn, got[0], want[0], times, values, b.steps, b.range_nanos,
                   p.get("horizon", 0.0), p.get("hw_sf", 0.5), p.get("hw_tf", 0.5))
    assert_same(got[1], want[1], "error")


# --- guards -------------------------------------------------------------------


def test_query_pipelines_never_fall_back_to_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    b = _batch(False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tq.device_rate_pipeline(*_args(b), n_lanes=b.n_lanes, n_cap=b.n_cap,
                                range_nanos=b.range_nanos, n_dp=b.n_dp)
