"""Port parity: the four kernels of the fused interpreter's slice, plain
PyTorch vs the JAX package, bit for bit.

- QK5 ``query_temporal.minmax_window`` vs ``_minmax_device``: a walk, NaN
  holes and +-Inf samples, windows of +-0.0 inside one 32-sample block
  (93s) and across blocks (10m), only -0.0, negatives with -0.0, an
  all-NaN lane, empty and one-sample windows, a short lane;
- QK6 ``query_grouped.grouped_quantile`` vs ``_grouped_quantile`` and
  QK7 ``lane_topk.masked_topk`` vs ``m3_tpu/ops/lane_topk.masked_topk``:
  ties, +-0.0, NaN and +-Inf cells, groups of 1-25 lanes (below and above
  k), an all-NaN group-step, an all-NaN step, padding lanes on the last
  (trash / empty) group;
- QK8 ``histo_quantile.bucket_quantile`` vs the reference's row gather +
  ``bucket_quantile``: +Inf count below a finite bucket's, negative and
  zero bounds, total 0, NaN and +-Inf counts, two buckets, padding, and
  phi of 0, 1, -0.5, 1.5 and NaN.

Tolerances: bit for bit (f64 as int64 bit patterns, NaN positions equal),
except two products XLA:CPU contracts into a fused multiply-add under jit
(the same program run op by op gives the port's bits; the port never
contracts): QK6's ``v_lo + (v_hi - v_lo) * frac`` and QK8's
``phi * total - lo_c``.  Those two kernels are held at rtol 1e-12, atol
1e-12, with NaN positions and infinities equal.

Every JAX reference comes from one compiled program.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from m3_tpu.models import query_pipeline as jq
from m3_tpu.ops import histo_quantile as jhq
from m3_tpu.ops import lane_topk as jtopk
from m3_tpu_torch.models import corpus
from m3_tpu_torch.ops import histo_quantile, lane_topk, query_grouped, query_temporal

from test_torch_m3tsz_decode import assert_same
from test_torch_query_pipeline import assert_close

SEC = 1_000_000_000
RANGES = (93 * SEC, 600 * SEC)
QUANTILE_PHIS = (0.0, 0.25, 0.5, 0.9, 1.0)
TOPK_CASES = ((1, False), (3, False), (3, True), (10, True), (30, False))
HQ_PHIS = (0.0, 0.5, 0.9, 0.99, 1.0, -0.5, 1.5, float("nan"))


@functools.lru_cache(maxsize=None)
def _jax() -> dict:
    t, v, st = corpus.minmax_probe_lanes()
    sv, groups, n_groups = corpus.select_probes()
    cv, rows_idx, ubs, caps = corpus.histogram_probes()

    def run(t, v, st, ranges, sv, groups, phis, cv, rows_idx, ubs, caps, hq_phis):
        out = {}
        out["minmax"] = [[jq._minmax_device(t, v, st, ranges[i], is_max) for is_max in (False, True)]
                         for i in range(len(RANGES))]
        out["quantile"] = [jq._grouped_quantile(sv, groups, n_groups, phis[i])
                           for i in range(len(QUANTILE_PHIS))]
        out["topk"] = [jtopk.masked_topk(sv, groups, n_groups, k, bottom)
                       for k, bottom in TOPK_CASES]
        counts = cv[rows_idx]
        out["hq"] = [jhq.bucket_quantile(counts, ubs, caps, hq_phis[i])
                     for i in range(len(HQ_PHIS))]
        return out

    res = jax.jit(run)(*(jnp.asarray(x) for x in (t, v, st)), jnp.asarray(RANGES),
                       jnp.asarray(sv), jnp.asarray(groups), jnp.asarray(QUANTILE_PHIS),
                       *(jnp.asarray(x) for x in (cv, rows_idx, ubs, caps)),
                       jnp.asarray(HQ_PHIS))
    return jax.tree_util.tree_map(np.array, res)


# --- QK5 ---------------------------------------------------------------------


@pytest.mark.parametrize("is_max", [False, True])
@pytest.mark.parametrize("range_nanos", RANGES)
def test_minmax_matches_jax(range_nanos, is_max):
    t, v, st = (torch.from_numpy(x) for x in corpus.minmax_probe_lanes())
    got = query_temporal.minmax_window(t, v, st, range_nanos, is_max)
    want = _jax()["minmax"][RANGES.index(range_nanos)][int(is_max)]
    assert_same(got, want, f"{'max' if is_max else 'min'}_over_time")
    # the probes fire: empty windows, infinities, zero results
    assert np.isnan(want).any() and np.isinf(want).any() and (want == 0).any()


def test_minmax_signed_zero_windows():
    """A window of -0.0 and +0.0 gives +0.0 for max and -0.0 for min, as
    jnp.maximum orders them, at both window widths."""
    t, v, st = corpus.minmax_probe_lanes()
    for r in RANGES:
        mx, mn = (_jax()["minmax"][RANGES.index(r)][i][2] for i in (1, 0))
        both = (mx == 0) & (mn == 0)
        assert both.any()
        assert not np.signbit(mx[both]).any() and np.signbit(mn[both]).all()
    assert np.signbit(_jax()["minmax"][0][1][3][np.isfinite(_jax()["minmax"][0][1][3])]).all()


# --- QK6 ---------------------------------------------------------------------


@pytest.mark.parametrize("phi", QUANTILE_PHIS)
def test_grouped_quantile_matches_jax(phi):
    sv, groups, n_groups = corpus.select_probes()
    got = query_grouped.grouped_quantile(torch.from_numpy(sv), groups, n_groups, phi)
    want = _jax()["quantile"][QUANTILE_PHIS.index(phi)]
    # rtol: XLA:CPU contracts v_lo + (v_hi - v_lo) * frac into an FMA
    assert_close(got, want, 1e-12, f"quantile {phi}")
    np.testing.assert_array_equal(np.isinf(got.numpy()), np.isinf(want))
    assert np.isnan(want[:5]).any() and np.isfinite(want).any()


@pytest.mark.parametrize("phi", [-0.5, 1.5, float("nan")])
def test_grouped_quantile_refuses_phi_out_of_range(phi):
    sv, groups, n_groups = corpus.select_probes()
    with pytest.raises(ValueError, match="phi"):
        query_grouped.grouped_quantile(torch.from_numpy(sv), groups, n_groups, phi)


# --- QK7 ---------------------------------------------------------------------


@pytest.mark.parametrize("k,bottom", TOPK_CASES)
def test_masked_topk_matches_jax(k, bottom):
    sv, groups, n_groups = corpus.select_probes()
    got = lane_topk.masked_topk(torch.from_numpy(sv), groups, n_groups, k, bottom)
    want = _jax()["topk"][TOPK_CASES.index((k, bottom))]
    for name, g, w in zip(("out", "present", "rank"), got, want):
        assert_same(g, w, name)
    assert lane_topk._NO_RANK == int(jtopk._NO_RANK)
    # NaN lanes are kept once a group's real values run out
    assert (np.isnan(sv[:48]) & want[1][:48, None]).any()


def test_masked_topk_refuses_ids_outside_the_groups():
    sv, groups, n_groups = corpus.select_probes()
    with pytest.raises(ValueError, match="group id"):
        lane_topk.masked_topk(torch.from_numpy(sv), groups, n_groups - 1, 3, False)


# --- QK8 ---------------------------------------------------------------------


@pytest.mark.parametrize("phi", HQ_PHIS)
def test_bucket_quantile_matches_jax(phi):
    cv, rows_idx, ubs, caps = corpus.histogram_probes()
    got = histo_quantile.bucket_quantile(torch.from_numpy(cv), rows_idx, ubs, caps, phi)
    want = _jax()["hq"][HQ_PHIS.index(phi) if phi == phi else len(HQ_PHIS) - 1]
    # rtol: XLA:CPU contracts phi * total - lo_c into an FMA
    assert_close(got, want, 1e-12, f"histogram_quantile {phi}")
    np.testing.assert_array_equal(got.numpy()[np.isinf(want)], want[np.isinf(want)])
