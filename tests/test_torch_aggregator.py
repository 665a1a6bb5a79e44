"""Port parity: the aggregator's slot kernels (A1a-A1c' plain versions),
``ElemPool`` and ``Aggregator``, plain PyTorch vs the JAX package.

The same seeded numpy inputs go through ``m3_tpu.aggregator`` (JAX on the
CPU) and ``m3_tpu_torch.aggregator`` with ``device="cpu"``, which runs
every kernel's plain version.  Everything is held bit for bit (f64 as
int64 bit patterns, NaN positions equal): XLA:CPU applies a scatter's
duplicate updates in update order, which the plain versions reproduce,
and the quantile weights are powers of two, so their running sums are
exact.

Shapes are fixed so that each JAX function compiles once per shape:
ingest batches of 256 samples over 64 slots, flushes of 20 slots, and two
quantile matrices.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from m3_tpu.aggregator import aggregator as jagg
from m3_tpu.aggregator import elems as jel
from m3_tpu.metrics.pipeline import AppliedPipeline as JPipeline
from m3_tpu.metrics.pipeline import PipelineOp as JOp
from m3_tpu.metrics.policy import AggregationID as JAggID
from m3_tpu.metrics.policy import StoragePolicy as JPolicy
from m3_tpu.metrics.rules import PipelineMetadata as JPM
from m3_tpu.metrics.rules import StagedMetadata as JSM
from m3_tpu.ops.downsample import AggregationType as JType
from m3_tpu.ops.downsample import Transformation as JTf
from m3_tpu_torch import aggregator as tagg
from m3_tpu_torch import metrics as tmet
from m3_tpu_torch.aggregator import elems as tel
from m3_tpu_torch.models import corpus
from m3_tpu_torch.ops.downsample import AggregationType as TType
from m3_tpu_torch.ops.downsample import Transformation as TTf

from test_torch_m3tsz_decode import assert_same

SEC = 1_000_000_000
T0 = corpus.START
N_SLOTS = 64
N_FLUSH = 20
QS = (0.5, 0.9, 0.95, 0.99, 0.999, 0.0, 1.0)


def _same_array(got: np.ndarray, want: np.ndarray, what: str):
    assert_same(torch.from_numpy(np.ascontiguousarray(got)), np.asarray(want), what)


@functools.lru_cache(maxsize=None)
def _slot_runs():
    """Every probe batch through both sides: after each batch, the scatter
    results (state, dropped), then a flush of N_FLUSH slots (gathered
    fields, state after the reset)."""
    jstate = jel.init_state(N_SLOTS // 8, 8)
    tstate = tel.init_state(N_SLOTS // 8, 8, device="cpu")
    rng = np.random.default_rng(17)
    runs = []
    for flat, start, times, values in corpus.elem_probe_batches(N_SLOTS):
        jstate, jdrop = jel._scatter_update(jstate, *(jnp.asarray(x)
                                                      for x in (flat, start, times, values)))
        tdrop = tel.scatter_update(tstate, *(torch.from_numpy(x)
                                             for x in (flat, start, times, values)))
        scatter = ([np.asarray(x) for x in jstate], int(jdrop),
                   [x.clone() for x in tstate], int(tdrop))
        flats = np.sort(rng.choice(N_SLOTS, N_FLUSH, replace=False))
        jstate, jout = jel._gather_reset(jstate, jnp.asarray(flats), True)
        tout = tel.gather_reset(tstate, torch.from_numpy(flats))
        gather = ([np.asarray(x) for x in jout], [np.asarray(x) for x in jstate],
                  list(tout), [x.clone() for x in tstate])
        runs.append((scatter, gather))
    return runs


@pytest.mark.parametrize("kernel", ["scatter_update", "gather_reset"])
def test_slot_kernels_match_jax(kernel):
    for k, (scatter, gather) in enumerate(_slot_runs()):
        if kernel == "scatter_update":
            jstate, jdrop, tstate, tdrop = scatter
            assert tdrop == jdrop, f"batch {k}: dropped {tdrop} != {jdrop}"
            for name, t, j in zip(tel.ElemState._fields, tstate, jstate):
                assert_same(t, j, f"batch {k} state.{name}")
        else:
            jout, jstate, tout, tstate = gather
            for name, t, j in zip(tel.ElemState._fields, tout, jout):
                assert_same(t, j, f"batch {k} gathered {name}")
            for name, t, j in zip(tel.ElemState._fields, tstate, jstate):
                assert_same(t, j, f"batch {k} state.{name} after the reset")


def test_probe_batches_hit_their_corners():
    """The probe batches do exercise what they are for: stale samples,
    epoch overwrites, several samples per slot, ties at the last time,
    signed zeros in min/max and all-NaN windows."""
    dropped = [s[1] for s, _ in _slot_runs()]
    assert sum(dropped) > 0
    batches = corpus.elem_probe_batches(N_SLOTS)
    flat, start, times, values = batches[2]
    assert np.bincount(flat).max() >= 5
    tstate = tel.ElemState(*_slot_runs()[2][0][2])
    assert bool(torch.isnan(tstate.last[-4:]).any())
    assert bool((tstate.count[-4:] > 0).any()) and bool(torch.isinf(tstate.min[-4:]).any())
    zero = (tstate.min == 0) | (tstate.max == 0)
    assert bool(zero.any())


@functools.lru_cache(maxsize=None)
def _quantile_cases():
    return corpus.quantile_probes() + corpus.quantile_tier_probes()


@pytest.mark.parametrize("case", range(2 + len(corpus.QUANTILE_TIER_KS)),
                         ids=["24x12", "5x1"] + [f"tier K={k}" for k in corpus.QUANTILE_TIER_KS])
def test_padded_quantiles_match_jax(case):
    """The plain version against the reference, bit for bit: the probe
    matrices, then rows at each edge of the kernel's tiers (K of 1-32 in a
    warp's registers, 33 in a block's shared memory, 8,193 in global
    scratch)."""
    values, weights = _quantile_cases()[case]
    want = jel.padded_quantiles(jnp.asarray(values), jnp.asarray(weights), QS)
    got = tel.padded_quantiles(torch.from_numpy(values), torch.from_numpy(weights), QS)
    assert_same(got, want, "padded_quantiles")


def test_padded_quantiles_reference_cases():
    """The reference's own nearest-rank and weighted cases."""
    vals = np.full((2, 5), np.inf)
    vals[0, :5] = [1, 2, 3, 4, 5]
    vals[1, :2] = [10, 20]
    weights = np.zeros((2, 5))
    weights[0, :5] = 1.0
    weights[1, :2] = 1.0
    out = tel.padded_quantiles(torch.from_numpy(vals), torch.from_numpy(weights), (0.5, 0.95, 0.99))
    assert out.tolist() == [[3.0, 5.0, 5.0], [10.0, 20.0, 20.0]]
    out = tel.padded_quantiles(torch.tensor([[1.0, 2.0, 3.0]]), torch.tensor([[2.0, 3.0, 5.0]]),
                               (0.2, 0.5, 0.95))
    assert out.tolist() == [[1.0, 2.0, 3.0]]


def _pool_run(mod, **kw):
    """An ElemPool of 64 lanes through 10 rounds of 256-sample batches:
    ring growth (2 windows to start), 16 late samples a round (dropped on
    the host), a hot timer lane with a small reservoir (compactions), and
    a flush of 64 windows with quantiles after each round.  Round r writes
    windows r and r + 1, each lane at least once into window r."""
    pool = mod.ElemPool(10 * SEC, capacity=16, windows=2, timer_reservoir_cap=96,
                        timer_summary_size=8, **kw)
    for _ in range(64):
        pool.alloc_lane()
    rng = np.random.default_rng(31)
    out = []
    for r in range(10):
        t = T0 + r * 10 * SEC
        lanes = np.concatenate([np.full(48, 7), np.arange(64), rng.integers(0, 64, 144)])
        times = t + rng.integers(0, 20, 256) * SEC
        times[48:112] = t + rng.integers(0, 10, 64) * SEC
        if r:
            times[-16:] = t - 10 * SEC - rng.integers(1, 10, 16) * SEC  # late
        values = np.round(rng.lognormal(2, 1, 256), 1)
        values[rng.random(256) < 0.05] = np.nan
        pool.update(lanes, times, values, lanes % 4 == 3)
        fw = pool.flush_before(t + 10 * SEC)
        q = pool.timer_quantiles(fw, QS) if fw is not None else None
        pool.purge_timer_reservoir()
        out.append((fw, q, pool.dropped_stale, pool.windows))
    return out, pool.n_timer_compactions


@functools.lru_cache(maxsize=None)
def _pools():
    return _pool_run(jel), _pool_run(tel, device="cpu")


def test_elem_pool_matches_jax():
    (jout, jcomp), (tout, tcomp) = _pools()
    assert tcomp == jcomp and tcomp > 0, (tcomp, jcomp)
    for r, (j, t) in enumerate(zip(jout, tout)):
        assert (j[0] is None) == (t[0] is None), r
        assert t[2:] == j[2:], f"round {r}: dropped/windows {t[2:]} != {j[2:]}"
        if j[0] is None:
            continue
        for name, tv, jv in zip(tel.FlushedWindows._fields, t[0], j[0]):
            _same_array(tv, jv, f"round {r} {name}")
        _same_array(t[1], j[1], f"round {r} quantiles")


def _staged(mod, types=(), policies=(), pipeline=None):
    pol, aid, pm, sm, pipe = mod
    return (sm(0, (pm(aggregation_id=aid(types),
                      storage_policies=tuple(pol.parse(p) for p in policies),
                      pipeline=pipe if pipeline is None else pipeline),)),)


def _agg_run(side: str):
    """64 metrics: 24 counters, 24 gauges, 16 timers at 10s, 1m and 5m;
    counters 0-5 roll up into one id; gauges 0-5 run a persecond
    transform; 6 minutes of 10s batches, a flush every 30s.  The pools'
    timer reservoirs are shrunk so the hot timers compact."""
    if side == "jax":
        mod = (JPolicy, JAggID, JPM, JSM, JPipeline())
        A, kinds, T, Tf, Op, Pipe, AggID = (jagg, jagg.MetricKind, JType, JTf, JOp, JPipeline,
                                            JAggID)
        agg = jagg.Aggregator()
    else:
        mod = (tmet.StoragePolicy, tmet.AggregationID, tmet.PipelineMetadata,
               tmet.StagedMetadata, tmet.AppliedPipeline())
        A, kinds, T, Tf, Op, Pipe, AggID = (tagg, tagg.MetricKind, TType, TTf, tmet.PipelineOp,
                                            tmet.AppliedPipeline, tmet.AggregationID)
        agg = tagg.Aggregator(device="cpu")
    pols = ("10s:2d", "1m:40d", "5m:90d")
    rollup = Pipe((Op.rollup(b"rolled", (b"svc",), AggID((T.SUM,))),))
    persec = Pipe((Op.transform(Tf.PERSECOND),))
    metas = []
    for i in range(64):
        if i < 24:
            kind, m = kinds.COUNTER, _staged(mod, (T.SUM, T.MAX), pols,
                                             rollup if i < 6 else None)
        elif i < 48:
            kind, m = kinds.GAUGE, _staged(mod, (T.LAST, T.MEAN, T.MIN), pols,
                                           persec if i < 30 else None)
        else:
            kind, m = kinds.TIMER, _staged(mod, (), pols)
        metas.append((kind, b"m%d" % i, m))
    rng = np.random.default_rng(41)
    out = []
    t = T0
    for step in range(36):
        entries = []
        for kind, mid, m in metas:
            n = 48 if (kind == kinds.TIMER and mid in (b"m48", b"m49")) else 2
            vals = np.round(rng.lognormal(2, 1, n), 2).tolist()
            if kind != kinds.TIMER:
                vals = vals[:1]
            entries.append((kind, mid, vals if len(vals) > 1 else vals[0],
                            t + int(rng.integers(0, 10)) * SEC, m))
        agg.add_untimed_batch(entries)
        for lst in agg.lists.values():
            if lst.pool.timer_reservoir_cap != 128:
                lst.pool.timer_reservoir_cap = lst.pool._compact_at = 128
                lst.pool.timer_summary_size = 16
        t += 10 * SEC
        if step % 3 == 2:
            out.extend(agg.flush_before(t - 10 * SEC))
    out.extend(agg.flush_before(t + 600 * SEC))
    compactions = sum(lst.pool.n_timer_compactions for lst in agg.lists.values())
    return out, compactions


@functools.lru_cache(maxsize=None)
def _aggs():
    return _agg_run("jax"), _agg_run("port")


def test_aggregator_matches_jax():
    (jout, jcomp), (tout, tcomp) = _aggs()
    assert tcomp == jcomp and tcomp > 0, (tcomp, jcomp)
    assert len(tout) == len(jout) and len(tout) > 1000
    for k, (t, j) in enumerate(zip(tout, jout)):
        assert (t.id, t.time_nanos, str(t.policy), int(t.agg_type)) == (
            j.id, j.time_nanos, str(j.policy), int(j.agg_type)), k
        tv, jv = np.float64(t.value), np.float64(j.value)
        assert tv.view(np.int64) == jv.view(np.int64) or (np.isnan(tv) and np.isnan(jv)), (
            k, t, j)


def test_aggregator_output_covers_the_slice():
    """The whole-slice run exercises every resolution, rollup forwarding,
    the persecond transform and the timer quantiles."""
    (tout, _), = (_aggs()[1],)
    res = {t.policy.resolution.window_nanos for t in tout}
    assert res == {10 * SEC, 60 * SEC, 300 * SEC}
    ids = {t.id for t in tout}
    assert b"rolled" in ids and b"m24" in ids and b"m48.p99" in ids


def test_aggregator_entry_points_never_fall_back_to_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tagg.ElemPool(10 * SEC)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tagg.Aggregator()


def test_kernel_wrappers_check_devices():
    state = tel.init_state(2, 2, device="cpu")
    flat = torch.zeros(3, dtype=torch.int64)
    with pytest.raises(ValueError, match="ElemState fields"):
        tel.scatter_update(state._replace(sum=state.sum.float()), flat, flat, flat,
                           flat.double())
    with pytest.raises(ValueError, match="one \\[F, K\\] shape"):
        tel.padded_quantiles(torch.zeros(2, 3), torch.zeros(2, 4), (0.5,))
