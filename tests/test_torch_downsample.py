"""Port parity: window quantiles, window aggregates, rollups, transforms.

The same numpy grids (seeded: NaN, +-Inf, -0.0/+0.0, ties, invalid
entries and all-invalid windows) go through ``m3_tpu.ops.downsample`` and
``m3_tpu_torch.ops.downsample`` on CPU tensors.

Tolerances, each with its reason:
- bit for bit: quantiles, count, min, max, last, and sums over windows of
  up to 12 elements (both sides add in index order);
- sums over 36-element windows: rtol=1e-12 — XLA:CPU vectorizes a reduce
  that long into partial sums, another order of the same additions;
- sum of squares: rtol=1e-12, XLA:CPU's partial FMA contraction;
- STDEV: rtol=1e-9, atol=1e-12 (the bounds of
  tests/test_promql_differential.py), the FMA again inside n*sumSq - sum^2;
- transform ``add``: on finite input, |difference| <= 1e-12 x the running
  sum of |x| (a reordered sum's error bound scales with the magnitudes
  added, not with the result, which can cancel to near zero) —
  jnp.cumsum on XLA:CPU is a rewritten reduce_window that groups its
  additions otherwise than torch.cumsum's in-order scan.  With +-Inf input (nan_to_num makes it
  +-1.8e308) the grouping decides where a running sum overflows, so there
  the port is held bit for bit to the in-order running sum of the
  upstream transform (ref: unary.go:46-54) instead.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from m3_tpu.ops import downsample as jds
from m3_tpu_torch.ops import downsample as tds

from test_torch_m3tsz_decode import assert_same

L, T = 64, 36
QUANTILES = tuple(sorted(set(jds.QUANTILE_OF_TYPE.values()))) + (0.0, 1.0)

# The reference functions run jitted, as the reference's pipelines call them.
j_quantiles = jax.jit(jds.window_quantiles, static_argnums=(2, 3))
j_aggregate = jax.jit(jds.window_aggregate, static_argnums=(2, 3))
j_rollup = jax.jit(jds.rollup, static_argnums=(1,))


@functools.lru_cache(maxsize=None)
def _grid(seed=42):
    rng = np.random.default_rng(seed)
    v = np.round(rng.standard_normal((L, T)) * 100, rng.integers(0, 3))
    v[:, ::7] = np.round(v[:, ::7])  # ties
    pick = rng.random((L, T))
    v[pick < 0.08] = np.nan
    v[(pick >= 0.08) & (pick < 0.11)] = np.inf
    v[(pick >= 0.11) & (pick < 0.13)] = -np.inf
    v[(pick >= 0.13) & (pick < 0.18)] = -0.0
    v[(pick >= 0.18) & (pick < 0.22)] = 0.0
    v[5] = -0.0  # a lane of only -0.0
    v[6, ::2], v[6, 1::2] = 0.0, -0.0  # mixed signed zeros
    m = rng.random((L, T)) < 0.8
    m[:, 12:18] = False  # an all-invalid window at every k <= 6
    m[9] = False  # an all-invalid lane
    v[10, :] = np.nan  # a lane of valid NaNs
    m[10] = True
    t = np.cumsum(rng.integers(-2, 12, (L, T)), axis=1).astype(np.int64) * 10**9
    return v, m, t


@pytest.mark.parametrize("k", [1, 2, 6, 12, 36])
def test_window_quantiles_matches_jax(k):
    v, m, _ = _grid()
    want = j_quantiles(jnp.asarray(v), jnp.asarray(m), k, QUANTILES)
    got = tds.window_quantiles(torch.from_numpy(v), torch.from_numpy(m), k, QUANTILES)
    assert_same(got, want, f"quantiles k={k}")


@pytest.mark.parametrize("k", [1, 6])
def test_window_quantiles_negative_zero(k):
    """A picked -0.0 stays -0.0 for k == 1 and comes out +0.0 for k > 1,
    as the reference's one-hot masked sum computes it."""
    v = np.full((2, 6), -0.0)
    m = np.ones((2, 6), dtype=bool)
    want = j_quantiles(jnp.asarray(v), jnp.asarray(m), k, (0.5,))
    got = tds.window_quantiles(torch.from_numpy(v), torch.from_numpy(m), k, (0.5,))
    assert_same(got, want, "signed zero")
    assert bool(torch.signbit(got).all()) == (k == 1)


def test_window_quantiles_rejects_bad_quantile():
    v, m, _ = _grid()
    with pytest.raises(ValueError, match="out of range"):
        tds.window_quantiles(torch.from_numpy(v), torch.from_numpy(m), 6, (1.5,))
    with pytest.raises(ValueError, match="not divisible"):
        tds.window_quantiles(torch.from_numpy(v), torch.from_numpy(m), 7, (0.5,))


def _agg_close(got, want, k, what):
    for field in ("count", "min", "max", "last"):
        assert_same(getattr(got, field), getattr(want, field), f"{what}.{field}")
    if k <= 12:
        assert_same(got.sum, want.sum, f"{what}.sum")
    else:  # XLA's vectorized reduce order, see the module docstring
        np.testing.assert_allclose(got.sum.numpy(), np.asarray(want.sum),
                                   rtol=1e-12, atol=0, equal_nan=True)
    np.testing.assert_allclose(got.sum_sq.numpy(), np.asarray(want.sum_sq),
                               rtol=1e-12, atol=0, equal_nan=True)


@pytest.mark.parametrize("skip_nan", [True, False])
@pytest.mark.parametrize("k", [1, 6, 12, 36])
def test_window_aggregate_matches_jax(k, skip_nan):
    v, m, _ = _grid()
    want = j_aggregate(jnp.asarray(v), jnp.asarray(m), k, skip_nan)
    got = tds.window_aggregate(torch.from_numpy(v), torch.from_numpy(m), k,
                               skip_nan=skip_nan)
    _agg_close(got, want, k, f"window_aggregate k={k}")


@functools.lru_cache(maxsize=None)
def _reference_windows():
    v, m, _ = _grid()
    return (j_aggregate(jnp.asarray(v), jnp.asarray(m), 6, True),
            j_quantiles(jnp.asarray(v), jnp.asarray(m), 6, QUANTILES))


@pytest.mark.parametrize("agg_type", [t for t in tds.AggregationType
                                      if t != tds.AggregationType.UNKNOWN])
def test_value_of_matches_jax(agg_type):
    jagg, jq = _reference_windows()
    # both sides read the same aggregate, so only value_of itself is compared
    tagg = tds.WindowedAgg(*(torch.from_numpy(np.array(x)) for x in jagg))
    tq = torch.from_numpy(np.array(jq))
    want = jds.value_of(jagg, jds.AggregationType(int(agg_type)), jq, QUANTILES)
    got = tds.value_of(tagg, agg_type, tq, QUANTILES)
    if agg_type == tds.AggregationType.STDEV:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-9,
                                   atol=1e-12, equal_nan=True)
    else:
        assert_same(got, want, agg_type.name)


def test_value_of_rejects_unknown():
    v, m, _ = _grid()
    agg = tds.window_aggregate(torch.from_numpy(v), torch.from_numpy(m), 6)
    with pytest.raises(ValueError):
        tds.value_of(agg, tds.AggregationType.UNKNOWN)
    with pytest.raises(ValueError, match="requires quantile_values"):
        tds.value_of(agg, tds.AggregationType.P99)


@pytest.mark.parametrize("k", [2, 3])
def test_rollup_matches_jax(k):
    jagg, _ = _reference_windows()
    # an infinite `last` exercises nan_to_num's finite clamp in the pick
    last = np.asarray(jagg.last).copy()
    last[3, :2] = [np.inf, -np.inf]
    jagg = jagg._replace(last=jnp.asarray(last))
    want = j_rollup(jagg, k)
    got = tds.rollup(tds.WindowedAgg(*(torch.from_numpy(np.array(x)) for x in jagg)), k)
    for field in want._fields:
        assert_same(getattr(got, field), getattr(want, field), f"rollup.{field}")


def test_transforms_match_jax():
    v, _, t = _grid()
    jv, jt, tv, tt = jnp.asarray(v), jnp.asarray(t), torch.from_numpy(v), torch.from_numpy(t)
    assert_same(tds.transform_absolute(tv), jds.transform_absolute(jv), "absolute")
    finite = np.where(np.isinf(v), 1.0, v)  # NaN kept: it adds 0
    got = tds.transform_add(torch.from_numpy(finite)).numpy()
    want = np.asarray(jds.transform_add(jnp.asarray(finite)))
    bound = 1e-12 * np.cumsum(np.abs(np.nan_to_num(finite)), axis=1)
    assert (np.abs(got - want) <= bound).all()
    running = np.zeros_like(v)
    acc = np.zeros(v.shape[0])
    with np.errstate(invalid="ignore", over="ignore"):
        for i in range(v.shape[1]):
            acc = acc + np.nan_to_num(v[:, i])
            running[:, i] = acc
    assert_same(tds.transform_add(tv), running, "add, in order")
    assert_same(tds.transform_increase(tv, tt), jds.transform_increase(jv, jt), "increase")
    assert_same(tds.transform_persecond(tv, tt), jds.transform_persecond(jv, jt),
                "persecond")
    for g, w in zip(tds.transform_reset(tv, tt), jds.transform_reset(jv, jt)):
        assert_same(g, w, "reset")
    assert {int(k) for k in tds.TRANSFORM_KERNELS} == {int(k) for k in jds.TRANSFORM_KERNELS}
    for key, (kind, _fn) in tds.TRANSFORM_KERNELS.items():
        assert jds.TRANSFORM_KERNELS[jds.Transformation(int(key))][0] == kind


def test_enums_match():
    assert [(t.name, int(t)) for t in tds.AggregationType] == [
        (t.name, int(t)) for t in jds.AggregationType]
    assert {int(k): q for k, q in tds.QUANTILE_OF_TYPE.items()} == {
        int(k): q for k, q in jds.QUANTILE_OF_TYPE.items()}
    for name in ("DEFAULT_COUNTER_TYPES", "DEFAULT_GAUGE_TYPES", "DEFAULT_TIMER_TYPES"):
        assert [int(x) for x in getattr(tds, name)] == [int(x) for x in getattr(jds, name)]


def test_stdev_matches_jax():
    rng = np.random.default_rng(1)
    count = rng.integers(0, 5, (8, 6)).astype(np.int64)
    s = rng.standard_normal((8, 6)) * 10
    ssq = s * s + rng.random((8, 6))
    want = jds.stdev(jnp.asarray(count), jnp.asarray(ssq), jnp.asarray(s))
    got = tds.stdev(torch.from_numpy(count), torch.from_numpy(ssq), torch.from_numpy(s))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-9, atol=1e-12)
