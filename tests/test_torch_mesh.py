"""Port parity: the series-sharded paths (``m3_tpu_torch/parallel``, the
``*_sharded`` pipelines) against the JAX package on the conftest's
8-device virtual CPU mesh.

Each case feeds the same numpy inputs, made from a seed, to the reference's
function under its mesh and to the port's on a CPU mesh of the same shape
(every shard on the one device): the ordered reduce MK1's and QK4
``sqdev``'s plain versions, ``consolidate_windows`` (both schedules), the
read step ``decode_downsample_sharded`` (4x2 and 8x1; MEAN, STDEV, P99,
with a lane of +-Inf samples for ``nan_to_num``), the ingest step
``encode_rollup_sharded`` (8x1, 4x2, 2x4), ``device_rate_sharded``,
``device_temporal_sharded``, ``device_grouped_sharded`` for every
aggregation with groups that span shards, the interpreter
``device_expr_pipeline_sharded`` on one plan per collective site, and the
host repack ``shard_repack`` against the reference engine's.

Tolerances: per-lane results bit for bit against the port's unsharded
pipelines, and against JAX as the unsharded parity tests hold them (bit for
bit but the rate family at rtol 1e-12 and STDEV at 1e-9); encoded words and
nbits bit for bit; sums rtol 1e-12; stddev, stdvar and quantiles rtol 1e-9
(the reference's gate, ``tests/test_query_pipeline_device.py:686-689``);
NaN patterns equal; ``total_bytes`` exact.  Each JAX program compiles once
(every aggregation in one program, one program per plan).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from m3_tpu.models import query_pipeline as jq
from m3_tpu.models.ingest_pipeline import encode_rollup_sharded as j_encode_rollup_sharded
from m3_tpu.models.ingest_pipeline import shard_ingest_inputs as j_shard_ingest_inputs
from m3_tpu.models.read_pipeline import decode_downsample_sharded as j_decode_downsample_sharded
from m3_tpu.models.read_pipeline import shard_inputs as j_shard_inputs
from m3_tpu.ops.m3tsz_encode import _pack_encode_jit, _prepare
from m3_tpu.parallel import mesh as jmesh
from m3_tpu.query.engine import Engine
from m3_tpu_torch.models import corpus
from m3_tpu_torch.models import query_pipeline as tq
from m3_tpu_torch.models import read_pipeline as trp
from m3_tpu_torch.models.ingest_pipeline import encode_rollup_sharded, shard_ingest_inputs
from m3_tpu_torch.ops import downsample as tds
from m3_tpu_torch.ops import m3tsz_scalar as tsz
from m3_tpu_torch.ops import query_grouped
from m3_tpu_torch.ops.bitstream import pack_streams
from m3_tpu_torch.ops.mesh_reduce import mesh_reduce, mesh_reduce_plain
from m3_tpu_torch.parallel import mesh as tmesh
from m3_tpu_torch.parallel.repack import shard_repack

from test_torch_m3tsz_decode import assert_same
from test_torch_query_pipeline import assert_close

SEC = 1_000_000_000
MIN = 60 * SEC
T0 = corpus.START
N_DP, WINDOW = 48, 12  # the nested-scan form: a short JAX compile a case
Q_STEPS = T0 + np.arange(7, dtype=np.int64) * 120 * SEC + 600 * SEC
Q_RANGE = 10 * MIN
Q_LANES, Q_BLOCKS, Q_DP = 16, 2, 30  # 2 lanes a shard on 8 shards
LOOSE = 1e-9


def _cpu_mesh(n_series: int, n_window: int = 1):
    return tmesh.make_mesh(n_series, n_window, device="cpu")


def _specials(n_shards: int, n: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    pool = np.asarray([np.nan, np.inf, -np.inf, 0.0, -0.0, 1.5, -2.25, 1e308, -1e308, 3.0])
    x = pool[rng.integers(0, len(pool), (n_shards, n))]
    x[:, 0] = np.where(np.arange(n_shards) % 2, -0.0, 0.0)  # +-0.0 alternating
    x[:, 1] = np.where(np.arange(n_shards) % 2, 0.0, -0.0)
    x[:, 2] = np.nan  # an all-NaN column
    x[:, 3] = -0.0  # all -0.0
    return x


def _numpy_fold(x: np.ndarray, op: str) -> np.ndarray:
    """Each column folded over the shards in ascending order, numpy scalars."""
    out = []
    with np.errstate(invalid="ignore", over="ignore"):
        for col in x.T:
            out.append(_fold_column(col, op))
    return np.asarray(out, dtype=np.float64)


def _fold_column(col: np.ndarray, op: str):
    acc = {"sum": 0.0, "min": np.inf, "max": -np.inf}[op]
    for v in col:
        if op == "sum":
            acc = acc + v
        elif (v < acc) if op == "min" else (v > acc):
            acc = v
    return acc


@functools.lru_cache(maxsize=None)
def _jax_collectives(n: int):
    """psum/pmin/pmax of an [8, n] stack over the reference's 8-device mesh."""
    mesh = jmesh.make_mesh(n_series_shards=8, n_window_shards=1)

    def body(x):
        return tuple(f(x, jmesh.SERIES_AXIS) for f in (jax.lax.psum, jax.lax.pmin, jax.lax.pmax))

    return jax.jit(jmesh.shard_map(body, mesh=mesh, in_specs=P(jmesh.SERIES_AXIS),
                                   out_specs=(P(jmesh.SERIES_AXIS),) * 3, check_vma=False))


@pytest.mark.parametrize("n_shards", [1, 7, 8])
def test_mesh_reduce_plain(n_shards):
    """MK1's plain version: NaN, +-Inf and +-0.0 folded in shard order, as
    numpy scalars fold them and (8 shards) as XLA's psum/pmin/pmax do; with
    and without an owned range; int64 sums exact."""
    x = _specials(n_shards, 40, seed=n_shards)
    for op in ("sum", "min", "max"):
        want = _numpy_fold(x, op)
        got = mesh_reduce(torch.from_numpy(x), op)
        assert_same(got, want, f"{op} over {n_shards}")
        assert_same(mesh_reduce_plain(torch.from_numpy(x), op, 5, 23), want[5:23],
                    f"{op} [5, 23)")
    if n_shards == 8:
        outs = _jax_collectives(40)(jnp.asarray(x))
        for op, o in zip(("sum", "min", "max"), outs):
            ref = np.asarray(o)[:1][0]
            assert_same(mesh_reduce(torch.from_numpy(x), op), ref, f"XLA {op}")
    big = np.random.default_rng(1).integers(-2**61, 2**61, (n_shards, 9))
    assert_same(mesh_reduce(torch.from_numpy(big), "sum"), big.sum(0), "int64 sum")
    two_d = torch.from_numpy(x.reshape(n_shards, 4, 10))
    assert tuple(mesh_reduce(two_d, "sum").shape) == (4, 10)
    with pytest.raises(ValueError):
        mesh_reduce(torch.from_numpy(x), "sum", 30, 50)


def test_sqdev_plain():
    """QK4 sqdev's plain version against the reference's second pass
    (``segment_sum(where(m, out - mean[g], 0) ** 2)``) on a probe matrix
    (NaN cells, an all-NaN lane, +-Inf, +-0.0, a lane outside every group)
    split over 4 shards: segments ``shard * n_groups + group``, the center
    read by global group id; bit for bit."""
    rng = np.random.default_rng(5)
    out = rng.standard_normal((32, 24)) * 10
    out[rng.random(out.shape) < 0.3] = np.nan
    out[3] = np.nan
    out[5, :4] = [np.inf, -np.inf, 0.0, -0.0]
    n_groups, n_shards = 3, 4
    groups = np.arange(32) % n_groups
    groups[7] = 5  # outside [0, n_groups): no segment
    seg = np.where(groups < n_groups, (np.arange(32) // 8) * n_groups + groups, -1)
    center = rng.standard_normal((n_groups, 24))
    m = ~np.isnan(out)
    keep = seg >= 0
    d = jnp.where(jnp.asarray(m[keep]), jnp.asarray(out[keep]) - jnp.asarray(center)[
        jnp.asarray(seg[keep] % n_groups)], 0.0)
    want = jax.ops.segment_sum(d * d, jnp.asarray(seg[keep]), num_segments=n_shards * n_groups)
    got = query_grouped.grouped_reduce(torch.from_numpy(out), seg, n_shards * n_groups, "sqdev",
                                       empty_value=0.0, center=torch.from_numpy(center))
    assert_same(got, np.asarray(want), "sqdev")


@pytest.mark.parametrize("use_scatter", [True, False])
def test_consolidate_windows(use_scatter):
    """psum over series, then consolidate_windows over window, on a 4x2 mesh:
    each shard's partial [16] with NaN-free values; sums rtol 1e-12, and the
    port's two schedules bit for bit."""
    rng = np.random.default_rng(7)
    parts = rng.standard_normal((8, 16)) * 1e3
    mesh = jmesh.make_mesh(n_series_shards=4, n_window_shards=2)
    axes = (jmesh.SERIES_AXIS, jmesh.WINDOW_AXIS)

    def body(x):
        partial = jax.lax.psum(x[0], jmesh.SERIES_AXIS)
        return jmesh.consolidate_windows(partial, jmesh.WINDOW_AXIS, use_scatter)[None]

    f = jax.jit(jmesh.shard_map(body, mesh=mesh, in_specs=P(axes), out_specs=P(axes),
                                check_vma=False))
    want = np.asarray(f(jnp.asarray(parts)))  # [8, 16]: every shard's result
    tm = _cpu_mesh(4, 2)
    local = torch.from_numpy(parts)
    got = tmesh.consolidate_windows(tm, tmesh.psum(tm, local, tmesh.SERIES_AXIS),
                                    tmesh.WINDOW_AXIS, use_scatter)
    other = tmesh.consolidate_windows(tm, tmesh.psum(tm, local, tmesh.SERIES_AXIS),
                                      tmesh.WINDOW_AXIS, not use_scatter)
    assert_close(got.contiguous(), want, 1e-12, "consolidate_windows")
    assert_same(got.contiguous(), other.numpy(), "the two schedules")
    assert tmesh.supports_f64_reduce_scatter(tm)


@functools.lru_cache(maxsize=None)
def _read_batch():
    """32 walk lanes, lane 5 replaced by +-Inf samples (+Inf in the first
    window, -Inf in the second) for the fleet's nan_to_num."""
    words, nbits, grid = corpus.sharded_read_batch(32, N_DP, seed=2)
    ts = [T0 + (i + 1) * 10 * SEC for i in range(N_DP)]
    vs = [float(i % 7) for i in range(N_DP)]
    vs[2], vs[14] = np.inf, -np.inf
    streams = [tsz.encode_series(ts, vs, T0)]
    w5, n5 = pack_streams(streams)
    width = max(words.shape[1], w5.shape[1])
    words = np.pad(words, ((0, 0), (0, width - words.shape[1])))
    words[5] = np.pad(w5[0], (0, width - w5.shape[1]))
    nbits = nbits.copy()
    nbits[5] = n5[0]
    return words, nbits


@pytest.mark.parametrize("agg", ["MEAN", "STDEV", "P99"])
@pytest.mark.parametrize("shape", [(4, 2), (8, 1)])
def test_decode_downsample_sharded(shape, agg):
    words, nbits = _read_batch()
    agg_type = tds.AggregationType[agg]
    mesh = jmesh.make_mesh(n_series_shards=shape[0], n_window_shards=shape[1])
    step = j_decode_downsample_sharded(mesh, N_DP, WINDOW, int(agg_type))
    j_lane, j_fleet = step(*j_shard_inputs(mesh, jnp.asarray(words), jnp.asarray(nbits)))
    tm = _cpu_mesh(*shape)
    per_lane, fleet = trp.decode_downsample_sharded(tm, N_DP, WINDOW, agg_type)(
        *trp.shard_inputs(tm, words, nbits))
    single, _, _ = trp.decode_downsample(words, nbits, N_DP, WINDOW, agg_type, device="cpu")
    assert_same(per_lane, single.numpy(), "per_lane vs unsharded")
    if agg == "STDEV":
        np.testing.assert_allclose(per_lane.numpy(), np.asarray(j_lane), rtol=1e-9, atol=1e-12,
                                   equal_nan=True)
        assert_close(fleet, np.asarray(j_fleet), 1e-9, "fleet")
    else:
        assert_same(per_lane, np.asarray(j_lane), "per_lane")
        assert_close(fleet, np.asarray(j_fleet), 1e-12, "fleet")
    assert np.isinf(np.asarray(single[5])).any() or agg == "STDEV"
    partial = tmesh.psum(tm, tmesh.shard_reduce(tm, torch.nan_to_num(per_lane)), tmesh.SERIES_AXIS)
    for use_scatter in (True, False):
        assert_same(tmesh.consolidate_windows(tm, partial, tmesh.WINDOW_AXIS, use_scatter)[0],
                    fleet.numpy(), f"the schedule use_scatter={use_scatter}")


@pytest.mark.parametrize("shape", [(8, 1), (4, 2), (2, 4)])
def test_encode_rollup_sharded(shape):
    n_lanes, n_dp, window = 32, 24, 2
    ts, starts, nv, vs = corpus.ingest_grid(n_lanes, n_dp)
    cb, cn, pb, pn = _prepare(vs, nv)
    mesh = jmesh.make_mesh(n_series_shards=shape[0], n_window_shards=shape[1])
    ingest = j_encode_rollup_sharded(mesh, n_dp, window)
    want = ingest(*j_shard_ingest_inputs(mesh, ts, starts, nv, cb, cn, pb, pn, vs))
    ref_words, ref_nbits = _pack_encode_jit(*(jnp.asarray(a) for a in
                                              (ts, starts, nv, cb, cn, pb, pn)))
    tm = _cpu_mesh(*shape)
    step = encode_rollup_sharded(tm, n_dp, window)
    assert encode_rollup_sharded(tm, n_dp, window) is step  # the build memo
    words, nbits, rolled, fleet, total = step(
        *shard_ingest_inputs(tm, ts, starts, nv, cb, cn, pb, pn, vs))
    assert_same(words.view(torch.int32), np.asarray(want[0]).view(np.int32), "words")
    assert_same(words.view(torch.int32), np.asarray(ref_words).view(np.int32),
                "words vs unsharded")
    assert_same(nbits, np.asarray(want[1]), "nbits")
    assert_same(nbits, np.asarray(ref_nbits), "nbits vs unsharded")
    assert_close(rolled, np.asarray(want[2]), 1e-12, "rolled")
    assert_close(fleet, np.asarray(want[3]), 1e-12, "fleet")
    assert total.dtype == torch.int64 and int(total) == int(want[4])
    assert int(total) == int(((np.asarray(ref_nbits) + 7) // 8).sum())


@functools.lru_cache(maxsize=None)
def _query_batch():
    streams, slots, _ = corpus.sharded_query_streams(Q_LANES, Q_BLOCKS, Q_DP, seed=41)
    words, nbits = pack_streams(streams)
    return words, nbits, slots % (Q_LANES // 8)  # slots LOCAL to their shard


def _slots_global():
    return np.repeat(np.arange(Q_LANES), Q_BLOCKS)


@functools.lru_cache(maxsize=None)
def _solo_lanes():
    """The unsharded decode + merge of the query batch: (times, values,
    error), as every unsharded pipeline computes it."""
    words, nbits, _ = _query_batch()
    w, nb, sl, _, _ = tq._inputs(words, nbits, _slots_global(), Q_STEPS, None, "cpu")
    return tq._decode_merge(w, nb, sl, Q_LANES, Q_BLOCKS * Q_DP, None, SEC)


def _jmesh8():
    return jmesh.make_mesh(n_series_shards=8, n_window_shards=1)


def _query_args():
    words, nbits, slots_local = _query_batch()
    return (jnp.asarray(words), jnp.asarray(nbits), jnp.asarray(slots_local),
            jnp.asarray(Q_STEPS))


def test_device_rate_and_temporal_sharded():
    words, nbits, slots_local = _query_batch()
    n_cap = Q_BLOCKS * Q_DP
    fns = ("avg_over_time", "stddev_over_time")

    @jax.jit
    def ref(w, nb, sl, st):
        rate = jq.device_rate_sharded(_jmesh8(), w, nb, sl, st, n_lanes=Q_LANES, n_cap=n_cap,
                                      range_nanos=Q_RANGE)
        temporal = tuple(jq.device_temporal_sharded(_jmesh8(), w, nb, sl, st, Q_LANES, n_cap,
                                                    Q_RANGE, fn=fn) for fn in fns)
        return rate, temporal

    (j_rate, j_fleet, j_err), j_temporal = ref(*_query_args())
    tm = _cpu_mesh(8)
    rate, fleet, err = tq.device_rate_sharded(tm, words, nbits, slots_local, Q_STEPS, Q_LANES,
                                              n_cap, Q_RANGE)
    single, s_fleet, _ = tq.device_rate_pipeline(words, nbits, _slots_global(), Q_STEPS,
                                                 Q_LANES, n_cap, Q_RANGE, device="cpu")
    assert_same(rate, single.numpy(), "rate vs unsharded")
    assert_close(rate, np.asarray(j_rate), 1e-12, "rate")
    assert_close(fleet, np.asarray(j_fleet), 1e-12, "fleet")
    assert_close(fleet, s_fleet.numpy(), 1e-12, "fleet vs unsharded")
    assert_same(err, np.asarray(j_err), "error")
    times, values, _ = _solo_lanes()
    for fn, (j_out, j_e) in zip(fns, j_temporal):
        out, e = tq.device_temporal_sharded(tm, words, nbits, slots_local, Q_STEPS, Q_LANES,
                                            n_cap, Q_RANGE, fn=fn)
        solo = tq._temporal_eval(fn, times, values, torch.from_numpy(Q_STEPS), Q_RANGE)
        assert_same(out, solo.numpy(), f"{fn} vs unsharded")
        assert_close(out, np.asarray(j_out), LOOSE if fn.startswith("stddev") else 1e-12, fn)
        assert_same(e, np.asarray(j_e), f"{fn} error")
    with pytest.raises(ValueError, match="series axis only"):
        tq.device_temporal_sharded(_cpu_mesh(4, 2), words, nbits, slots_local, Q_STEPS,
                                   Q_LANES, n_cap, Q_RANGE)


def test_device_grouped_sharded_every_agg():
    """Every aggregation of DEVICE_GROUP_AGGS over rate(), groups spanning
    shards (lane % 4 over 2 lanes a shard), one NaN lane; quantile at phi
    0.9."""
    words, nbits, slots_local = _query_batch()
    n_cap = Q_BLOCKS * Q_DP
    groups = np.arange(Q_LANES, dtype=np.int64) % 4
    aggs = jq.DEVICE_GROUP_AGGS

    @jax.jit
    def ref(w, nb, sl, st, g):
        return tuple(jq.device_grouped_sharded(_jmesh8(), w, nb, sl, st, g, n_lanes=Q_LANES,
                                               n_groups=4, n_cap=n_cap, range_nanos=Q_RANGE,
                                               fn="rate", agg=agg, phi=0.9)[0]
                     for agg in aggs)

    want = ref(*_query_args(), jnp.asarray(groups))
    tm = _cpu_mesh(8)
    times, values, _ = _solo_lanes()
    rate = tq._temporal_eval("rate", times, values, torch.from_numpy(Q_STEPS), Q_RANGE)
    for agg, w in zip(aggs, want):
        got, err = tq.device_grouped_sharded(tm, words, nbits, slots_local, Q_STEPS, groups,
                                             Q_LANES, 4, n_cap, Q_RANGE, agg=agg, phi=0.9)
        rtol = LOOSE if agg in ("stddev", "stdvar", "quantile") else 1e-12
        assert_close(got, np.asarray(w), rtol, agg)
        solo = tq._grouped_reduce(rate, groups, 4, agg, 0.9)  # device_grouped_pipeline's
        assert_close(got, solo.numpy(), rtol, f"{agg} vs unsharded")
        assert not err.any()
    for fn in ("predict_linear", "holt_winters", "quantile_over_time"):
        with pytest.raises(ValueError, match="no grouped device form"):
            tq.device_grouped_sharded(tm, words, nbits, slots_local, Q_STEPS, groups, Q_LANES,
                                      4, n_cap, Q_RANGE, fn=fn)


@pytest.mark.parametrize("name", corpus.MESH_PLANS)
def test_device_expr_pipeline_sharded(name):
    plan, leaves, params, steps = corpus.mesh_expr_plan(name)
    mesh = _jmesh8()
    run = jax.jit(jq.device_expr_pipeline_sharded, static_argnames=("plan", "mesh"))
    j_out, j_aux, j_err = run(plan, mesh, tuple(jax.tree_util.tree_map(jnp.asarray, leaves)),
                              jax.tree_util.tree_map(jnp.asarray, params), jnp.asarray(steps))
    tm = _cpu_mesh(8)
    out, aux, err = tq.device_expr_pipeline_sharded(
        plan, tm, *tq.shard_expr_inputs(plan, tm, leaves, params, steps))
    solo, solo_aux, solo_err = tq.device_expr_pipeline(plan, corpus.global_slots(leaves, 8), params,
                                                       steps, device="cpu")
    exact = name in ("topk", "absent", "arrays_max_by")
    rtol = LOOSE if name in ("stddev_by", "quantile_by") else 1e-12
    if exact:
        assert_same(out, np.asarray(j_out), name)
    else:
        assert_close(out, np.asarray(j_out), rtol, name)
    assert_close(out, solo.numpy(), rtol, f"{name} vs unsharded")
    for a, ja, sa in zip(aux, j_aux, solo_aux):
        assert_same(a, np.asarray(ja), f"{name} aux")
        assert_same(a, sa.numpy(), f"{name} aux vs unsharded")
    assert len(err) == len(j_err)
    for e, je, se in zip(err, j_err, solo_err):
        assert_same(e, np.asarray(je), f"{name} errors")
        assert_same(e, se.numpy(), f"{name} errors vs unsharded")


def test_shard_repack_matches_engine():
    words, nbits, _ = _query_batch()
    slots = np.repeat(np.arange(12), 2)[:20]
    pk = {"words": np.concatenate([words[:20], np.zeros((4, words.shape[1]), np.uint32)]),
          "nbits": np.concatenate([nbits[:20], np.zeros(4, np.int32)]),
          "slots": np.concatenate([slots, np.full(4, 15)]), "tiers": None, "n_streams": 20,
          "lanes_pad": 16}
    for n_shards in (1, 3, 8):
        want = Engine._shard_repack(Engine, pk, n_shards)
        got = shard_repack(pk, n_shards)
        assert got.keys() == want.keys()
        for k in ("words", "nbits", "slots", "real_rows"):
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        assert got["lanes_pad"] == want["lanes_pad"] and got["tiers"] is None
