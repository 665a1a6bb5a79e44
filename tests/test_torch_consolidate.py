"""Port parity: the copied numpy host tier of the query path
(``m3_tpu_torch.ops.consolidate``) against ``m3_tpu.ops.consolidate`` on
the same numpy inputs, bit for bit (NaN positions equal).

The reference routes batches of a million samples and more to its native
kernels; these inputs are far below that, so both sides run the same numpy
formulation.  Inputs: merged probe lanes (counter resets, NaN/+-Inf
samples, sparse and all-NaN lanes, signed zeros, an unsorted lane).
"""

import functools

import numpy as np
import pytest

from m3_tpu.ops import consolidate as jcons
from m3_tpu_torch.models import corpus
from m3_tpu_torch.ops import consolidate as tcons
from m3_tpu_torch.ops import m3tsz_scalar as tsz
from m3_tpu_torch.ops.bitstream import unpack_stream

SEC = 1_000_000_000
RANGES = (93 * SEC, 300 * SEC)


def assert_same(got, want, what):
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape, what
    if got.dtype.kind == "f":
        np.testing.assert_array_equal(np.isnan(got), np.isnan(want), err_msg=what)
        ok = np.isnan(got) | (got.view(np.int64) == want.view(np.int64))
        assert ok.all(), f"{what}: {got[~ok][:3]} != {want[~ok][:3]}"
    else:
        np.testing.assert_array_equal(got, want, err_msg=what)


@functools.lru_cache(maxsize=None)
def _grids():
    """Per-stream decode grids of the probe corpus (scalar oracle), padded
    to the stream width: (slots, ts, vs, valid, n_lanes)."""
    b = corpus.query_probe_corpus()
    M = len(b.slots)
    ts = np.zeros((M, b.n_dp + 2), dtype=np.int64)
    vs = np.full((M, b.n_dp + 2), np.nan)
    valid = np.zeros((M, b.n_dp + 2), dtype=bool)
    for m in range(M):
        if not b.nbits[m]:
            continue
        t, v = tsz.decode_series(unpack_stream(b.words[m], b.nbits[m]))
        ts[m, :len(t)], vs[m, :len(v)], valid[m, :len(t)] = t, v, True
    return b.slots, ts, vs, valid, b.n_lanes, b.steps


@functools.lru_cache(maxsize=None)
def _lanes():
    slots, ts, vs, valid, n_lanes, steps = _grids()
    times, values, _ = jcons.merge_grids(slots, ts, vs, valid, n_lanes, use_native=False)
    return times, values, steps


def test_pack_valid_and_pad_grid():
    _, ts, vs, valid, _, _ = _grids()
    got, want = tcons.pack_valid(ts, vs, valid), jcons.pack_valid(ts, vs, valid)
    for i, (g, w) in enumerate(zip(got, want)):
        assert_same(g, w, f"pack_valid[{i}]")
    for g, w in zip(tcons.pad_grid(got[0], got[1], 70, 50), jcons.pad_grid(want[0], want[1], 70, 50)):
        assert_same(g, w, "pad_grid")


@pytest.mark.parametrize("clamp", [None, (20, 900)])
def test_merge_grids_and_merge_packed(clamp):
    slots, ts, vs, valid, n_lanes, _ = _grids()
    lo = hi = None
    if clamp:
        lo, hi = corpus.START + clamp[0] * SEC, corpus.START + clamp[1] * SEC
    got = tcons.merge_grids(slots, ts, vs, valid, n_lanes, lo, hi)
    want = jcons.merge_grids(slots, ts, vs, valid, n_lanes, lo, hi, use_native=False)
    for i, (g, w) in enumerate(zip(got, want)):
        assert_same(g, w, f"merge_grids[{i}]")
    parts = [(int(s), ts[m][valid[m]], vs[m][valid[m]]) for m, s in enumerate(slots)]
    for i, (g, w) in enumerate(zip(tcons.merge_packed(parts, n_lanes),
                                   jcons.merge_packed(parts, n_lanes))):
        assert_same(g, w, f"merge_packed[{i}]")


@pytest.mark.parametrize("range_nanos", RANGES)
def test_window_bounds_and_step_consolidate(range_nanos):
    times, values, steps = _lanes()
    starts = tcons._range_left(steps, range_nanos)
    assert_same(starts, jcons._range_left(steps, range_nanos), "_range_left")
    for g, w in zip(tcons._window_bounds(times, starts, steps),
                    jcons._window_bounds(times, starts, steps)):
        assert_same(g, w, "_window_bounds")
    assert_same(tcons.step_consolidate(times, values, steps, range_nanos),
                jcons.step_consolidate(times, values, steps, range_nanos), "step_consolidate")


@pytest.mark.parametrize("range_nanos", RANGES)
@pytest.mark.parametrize("mode", [(True, True), (True, False), (False, False)])
def test_extrapolated_rate(mode, range_nanos):
    times, values, steps = _lanes()
    assert_same(tcons.extrapolated_rate(times, values, steps, range_nanos, *mode),
                jcons.extrapolated_rate(times, values, steps, range_nanos, *mode),
                f"extrapolated_rate{mode}")


@pytest.mark.parametrize("reducer", sorted(r for r in tcons._REDUCERS if r != "last_over_time"))
def test_window_reduce(reducer):
    times, values, steps = _lanes()
    for range_nanos in RANGES:
        assert_same(tcons.window_reduce(times, values, steps, range_nanos, reducer),
                    jcons.window_reduce(times, values, steps, range_nanos, reducer), reducer)


# --- the rest of the temporal family (host oracles of QK3's further ops,
# QK9-QK11): the probe corpus's lanes and corpus.temporal_probe_lanes ---------


@functools.lru_cache(maxsize=None)
def _family_lanes():
    return (_lanes(), corpus.temporal_probe_lanes())


@pytest.mark.parametrize("range_nanos", RANGES)
def test_window_changes_and_linreg(range_nanos):
    for times, values, steps in _family_lanes():
        for resets_only in (False, True):
            assert_same(tcons.window_changes(times, values, steps, range_nanos, resets_only),
                        jcons.window_changes(times, values, steps, range_nanos, resets_only),
                        f"window_changes({resets_only})")
        with np.errstate(all="ignore"):
            got = tcons.window_linreg(times, values, steps, range_nanos)
            want = jcons.window_linreg(times, values, steps, range_nanos)
        for i, (g, w) in enumerate(zip(got, want)):
            assert_same(g, w, f"window_linreg[{i}]")
    assert_same(tcons.window_changes(times[:, :1], values[:, :1], steps, range_nanos, False),
                jcons.window_changes(times[:, :1], values[:, :1], steps, range_nanos, False),
                "window_changes on one column")


@pytest.mark.parametrize("phi", [0.0, 0.5, 0.99, 1.0, -0.5, 1.5])
def test_window_quantile(phi):
    for times, values, steps in _family_lanes():
        for range_nanos in RANGES:
            assert_same(tcons.window_quantile(times, values, steps, range_nanos, phi),
                        jcons.window_quantile(times, values, steps, range_nanos, phi),
                        f"window_quantile({phi})")


@pytest.mark.parametrize("sf,tf", [(0.5, 0.5), (0.3, 0.1)])
def test_window_holt_winters(sf, tf):
    for times, values, steps in _family_lanes():
        assert times.size < 10_000  # below the reference's native threshold
        with np.errstate(all="ignore"):
            got = tcons.window_holt_winters(times, values, steps, RANGES[1], sf, tf)
            want = jcons.window_holt_winters(times, values, steps, RANGES[1], sf, tf)
        assert_same(got, want, f"window_holt_winters({sf}, {tf})")
    assert_same(tcons.window_holt_winters(times[:, :1], values[:, :1], steps, RANGES[1], sf, tf),
                np.full((len(times), len(steps)), np.nan), "one column")
