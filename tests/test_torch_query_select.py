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
  (trash / empty) group; QK6 also on groups across the kernel's chunks
  (CHUNK - 1, CHUNK, CHUNK + 1 and 3 * CHUNK lanes) with NaN padding on
  group 0 and runs of +-0.0 at the chosen ranks;
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
from m3_tpu_torch.ops import _build, histo_quantile, lane_topk, query_grouped, query_temporal

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


def _quantile_chunks():
    """[4 * CHUNK + 37, 8]: groups of CHUNK - 1, CHUNK, CHUNK + 1 and 3 *
    CHUNK lanes (shuffled), 37 all-NaN padding lanes on group 0, 10% NaN,
    an all-NaN step (5); steps 0-2 put runs of +-0.0 at the chosen ranks
    (0: zeros and positives, so phi 0 reads a zero; 1: negatives and zeros,
    phi 1; 2: mostly zeros, phi 0.9), the others mix negatives, zeros and
    positives (no infinity: a group's -inf at phi 0 gives -inf + (-inf -
    -inf) * 0, NaN)."""
    rng = np.random.default_rng(12)
    C = query_grouped.CHUNK
    groups = np.repeat(np.arange(4), [C - 1, C, C + 1, 3 * C])
    rng.shuffle(groups)
    pick = lambda vals, p: rng.choice(vals, size=len(groups), p=p)  # noqa: E731
    cols = [pick([-0.0, 0.0, 1.0, 2.0], [0.3, 0.3, 0.2, 0.2]),
            pick([-2.0, -1.0, -0.0, 0.0], [0.2, 0.2, 0.3, 0.3]),
            pick([-1.0, -0.0, 0.0, 1.0], [0.02, 0.47, 0.47, 0.04])]
    cols += [pick([-2.0, -1.0, -0.0, 0.0, 1.0, 2.0], [0.1, 0.15, 0.25, 0.25, 0.15, 0.1])
             for _ in range(5)]
    sv = np.stack(cols, axis=1)
    sv[rng.random(sv.shape) < 0.1] = np.nan
    sv[:, 5] = np.nan
    sv = np.concatenate([sv, np.full((37, 8), np.nan)])
    return sv, np.concatenate([groups, np.zeros(37, dtype=np.int64)]), 4


CHUNK_PHIS = (0.0, 0.9, 1.0)


@functools.lru_cache(maxsize=None)
def _jax_quantile_chunks() -> list:
    sv, groups, n_groups = _quantile_chunks()
    run = jax.jit(lambda sv, g, phis: [jq._grouped_quantile(sv, g, n_groups, phis[i])
                                       for i in range(len(CHUNK_PHIS))])
    return [np.array(a) for a in run(jnp.asarray(sv), jnp.asarray(groups),
                                     jnp.asarray(CHUNK_PHIS))]


@pytest.mark.parametrize("phi", CHUNK_PHIS)
def test_grouped_quantile_matches_jax_past_a_chunk(phi):
    """Groups across the kernel's chunks, padding on group 0, +-0.0 ties
    at the chosen ranks and an all-NaN step: bit for bit at phi 0 and 1
    (frac 0: no product to contract), rtol 1e-12 at 0.9 (the FMA)."""
    sv, groups, n_groups = _quantile_chunks()
    got = query_grouped.grouped_quantile(torch.from_numpy(sv), groups, n_groups, phi)
    want = _jax_quantile_chunks()[CHUNK_PHIS.index(phi)]
    if phi in (0.0, 1.0):
        assert_same(got, want, f"quantile {phi}")
    else:
        assert_close(got, want, 1e-12, f"quantile {phi}")
        np.testing.assert_array_equal(np.isinf(got.numpy()), np.isinf(want))
    assert np.isnan(want[:, 5]).all() and not np.isnan(want[:, :5]).any()
    assert (want[:, :3] == 0).sum() >= 4  # the ranks land in the zero runs


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


def _past_a_chunk():
    """[2 * CHUNK + 37, 6] of ties, NaN, +-Inf and +-0.0: a group of CHUNK +
    1 lanes, one of 3, one of the rest and a trash group of padding."""
    rng = np.random.default_rng(9)
    C = query_grouped.CHUNK
    n = 2 * C + 37
    sv = rng.integers(-6, 6, (n, 6)).astype(np.float64)
    sv[rng.random(sv.shape) < 0.2] = np.nan
    sv[rng.random(sv.shape) < 0.02] = np.inf
    sv[sv == 0] = -0.0
    sv[rng.random(sv.shape) < 0.05] = 0.0
    sv[-9:] = np.nan
    groups = np.full(n, 2, dtype=np.int64)
    groups[rng.permutation(n - 9)[:C + 1]] = 0
    groups[[5, 7, 300]] = 1
    groups[-9:] = 3
    return sv, groups, 4


PAST_A_CHUNK = ((10, False), (query_grouped.K_MAX, True), (query_grouped.K_MAX + 1, False))


@functools.lru_cache(maxsize=None)
def _jax_past_a_chunk() -> list:
    sv, groups, n_groups = _past_a_chunk()
    run = jax.jit(lambda sv, g: [jtopk.masked_topk(sv, g, n_groups, k, bottom)
                                 for k, bottom in PAST_A_CHUNK])
    return jax.tree_util.tree_map(np.array, run(jnp.asarray(sv), jnp.asarray(groups)))


@pytest.mark.parametrize("k,bottom", PAST_A_CHUNK)
def test_masked_topk_matches_jax_past_a_chunk(k, bottom):
    """Groups larger than the kernels' chunk, at a narrow S, on both sides
    of the selection's largest k."""
    sv, groups, n_groups = _past_a_chunk()
    got = lane_topk.masked_topk(torch.from_numpy(sv), groups, n_groups, k, bottom)
    want = _jax_past_a_chunk()[PAST_A_CHUNK.index((k, bottom))]
    for name, g, w in zip(("out", "present", "rank"), got, want):
        assert_same(g, w, name)
    assert (want[2] < query_grouped.CHUNK).sum() > k  # kept lanes of several groups


class _FakeSelect:
    """Stands in for ``csrc/query_select.cu``: records which entry ran."""

    def __init__(self):
        self.entries = []

    def m3_query_topk(self, x, S, members, chunks, n_chunks, n_partial, folds, n_folds, mode,
                      k, cand_keys, cand_pos, thr_keys, thr_pos, out, present, rank, stream):
        assert cand_keys is None if n_partial == 0 else cand_keys.shape == (n_partial, k, S)
        assert thr_keys is None if n_folds == 0 else thr_keys.shape == (n_folds, S)
        self.entries.append(("m3_query_topk", k, n_partial, n_folds))
        return 0

    def m3_query_select(self, x, S, members, offsets, n_groups, mode, k, p_smem, p_scratch,
                        keys, pos, grid, threads, out, present, rank, stream):
        self.entries.append(("m3_query_select", k, p_smem, p_scratch))
        return 0

    @staticmethod
    def m3_query_quantile_scratch(n_folds, n_partial, S):
        return 1000 * n_folds + 10 * n_partial + S

    def m3_query_quantile(self, x, S, members, chunks, n_chunks, n_partial, folds, n_folds, phi,
                          scratch, scratch_bytes, out, stream):
        assert scratch.numel() == scratch_bytes == self.m3_query_quantile_scratch(
            n_folds, n_partial, S)
        self.entries.append(("m3_query_quantile", chunks, n_chunks, n_partial, folds, n_folds,
                             phi))
        return 0


@pytest.mark.parametrize("k,want", [
    (1, ("m3_query_topk", 1, 2, 1)),
    (10, ("m3_query_topk", 10, 2, 1)),
    (query_grouped.K_MAX, ("m3_query_topk", query_grouped.K_MAX, 2, 1)),
    (query_grouped.K_MAX + 1, ("m3_query_select", query_grouped.K_MAX + 1, 512, 0)),
    (100, ("m3_query_select", 100, 512, 0)),
])
def test_masked_topk_dispatch_by_k(monkeypatch, k, want):
    """QK7's host side: k <= K_MAX takes the selection entry, a larger k
    the select kernel's sort; a group past a chunk gives the selection its
    merge (two partial chunks, one fold)."""
    fake = _FakeSelect()
    monkeypatch.setattr(_build, "library", lambda name, sig: fake)
    monkeypatch.setattr(query_grouped, "_ptr", lambda t: None if t is None or not t.numel() else t)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda dev: type("S", (), {"cuda_stream": 0}))
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda dev: type("P", (), {"multi_processor_count": 132}))
    ids = np.zeros(query_grouped.CHUNK + 40, dtype=np.int64)
    ids[-3:] = 1
    out, present, rank = lane_topk._launch(torch.zeros((len(ids), 8), dtype=torch.float64), ids,
                                           2, k, False)
    assert fake.entries == [want]
    assert out.shape == (len(ids), 8) and present.shape == rank.shape == (len(ids),)


def test_grouped_quantile_dispatch(monkeypatch):
    """QK6's host side: the quantile takes the selection entry with the
    chunk table of the grouping and a scratch sized by its groups of several
    chunks (one group of CHUNK + 40 lanes: two chunks, one fold; one group
    of 3 lanes), and never the select kernel, which QK7 still reaches for
    k > K_MAX."""
    fake = _FakeSelect()
    monkeypatch.setattr(_build, "library", lambda name, sig: fake)
    monkeypatch.setattr(query_grouped, "_ptr", lambda t: None if t is None or not t.numel() else t)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda dev: type("S", (), {"cuda_stream": 0}))
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda dev: type("P", (), {"multi_processor_count": 132}))
    ids = np.zeros(query_grouped.CHUNK + 43, dtype=np.int64)
    ids[-3:] = 1
    x = torch.zeros((len(ids), 8), dtype=torch.float64)
    index = query_grouped.group_index(ids, 2, x.device)
    out = query_grouped.launch_quantile(x, index, 0.9)
    assert out.shape == (2, 8)
    (entry, chunks, n_chunks, n_partial, folds, n_folds, phi), = fake.entries
    assert (entry, n_chunks, n_partial, n_folds, phi) == ("m3_query_quantile", 3, 2, 1, 0.9)
    assert chunks is index.chunks and folds is index.folds
    lane_topk._launch(x, ids, 2, query_grouped.K_MAX + 1, False)
    assert fake.entries[1][0] == "m3_query_select"


# --- QK8 ---------------------------------------------------------------------


@pytest.mark.parametrize("phi", HQ_PHIS)
def test_bucket_quantile_matches_jax(phi):
    cv, rows_idx, ubs, caps = corpus.histogram_probes()
    got = histo_quantile.bucket_quantile(torch.from_numpy(cv), rows_idx, ubs, caps, phi)
    want = _jax()["hq"][HQ_PHIS.index(phi) if phi == phi else len(HQ_PHIS) - 1]
    # rtol: XLA:CPU contracts phi * total - lo_c into an FMA
    assert_close(got, want, 1e-12, f"histogram_quantile {phi}")
    np.testing.assert_array_equal(got.numpy()[np.isinf(want)], want[np.isinf(want)])
