"""Port parity: batched M3TSZ decode, plain PyTorch vs the JAX package.

The same packed numpy batch goes through ``m3_tpu.ops.m3tsz_decode`` (JAX
on the CPU) and ``m3_tpu_torch.ops.m3tsz_decode`` on CPU tensors, which
runs the kernels' plain versions.

Tolerances:
- bit for bit (f64 compared as int64 bit patterns, NaN positions equal):
  ts, vs, valid, count, error and WindowedAgg.sum/count/min/max/last;
- ``sum_sq``: rtol=1e-12.  XLA:CPU contracts ``ssq + vz * vz`` into a
  fused multiply-add in some compiled shapes and not in others, so the
  reference itself is not one rounding sequence; the port (and its CUDA
  kernel, built with --fmad=false) multiplies then adds.

Every batch is padded to 64 lanes x 96 words (empty lanes, zero words:
neither changes what the other lanes decode) so the JAX programs compile
once per static configuration.
"""

import functools

import numpy as np
import pytest
import torch

from m3_tpu.ops import m3tsz_decode as jdec
from m3_tpu_torch.models import corpus
from m3_tpu_torch.ops import decode_counter
from m3_tpu_torch.ops import m3tsz_decode as tdec
from m3_tpu_torch.ops import m3tsz_scalar
from m3_tpu_torch.ops.bitstream import pack_streams

N_STEPS = 36
LANES = 64
WORDS = 96
MS = 1_000_000
SEC = 1_000_000_000


@functools.lru_cache(maxsize=None)
def _corpus(name):
    """(streams, int_optimized, unit_nanos) of a named input set."""
    if name == "walks":
        return corpus.walk_streams(LANES, N_STEPS), True, SEC
    if name == "probes":
        return corpus.probe_streams(N_STEPS), True, SEC
    if name == "float":
        return (corpus.probe_streams(N_STEPS, int_optimized=False)
                + corpus.golden_streams()), False, SEC
    if name == "ms":
        return corpus.ms_streams(24, N_STEPS) + corpus.walk_streams(8, N_STEPS), True, MS
    raise KeyError(name)


def _pack(streams, lanes=LANES):
    words, nbits = pack_streams(streams)
    assert words.shape[1] <= WORDS and len(streams) <= lanes
    words = np.pad(words, ((0, lanes - len(streams)), (0, WORDS - words.shape[1])))
    nbits = np.pad(nbits, (0, lanes - len(streams)))
    return words, nbits


def assert_same(got: torch.Tensor, want, what: str):
    """Bit-for-bit equality; for floats NaN positions must agree and every
    other element must have the same bit pattern (so -0.0 != +0.0)."""
    want = np.asarray(want)
    got = got.numpy()
    assert got.dtype == want.dtype, f"{what}: dtype {got.dtype} != {want.dtype}"
    assert got.shape == want.shape, f"{what}: shape {got.shape} != {want.shape}"
    if got.dtype.kind == "f":
        gn, wn = np.isnan(got), np.isnan(want)
        np.testing.assert_array_equal(gn, wn, err_msg=f"{what}: NaN positions")
        bad = (got.view(np.int64) != want.view(np.int64)) & ~gn
        assert not bad.any(), (
            f"{what}: {bad.sum()} elements differ, e.g. at {np.argwhere(bad)[:3]}: "
            f"{got[bad][:3]} != {want[bad][:3]}")
    else:
        np.testing.assert_array_equal(got, want, err_msg=what)


def _agg_same(got, want, full_agg: bool, what: str):
    for field in ("sum", "count", "min", "max", "last"):
        assert_same(getattr(got, field), getattr(want, field), f"{what}.{field}")
    gs, ws = got.sum_sq.numpy(), np.asarray(want.sum_sq)
    assert gs.dtype == ws.dtype and gs.shape == ws.shape
    if full_agg:  # XLA:CPU's partial FMA contraction, see the module docstring
        np.testing.assert_allclose(gs, ws, rtol=1e-12, atol=0, equal_nan=True)
    else:  # not computed: NaN everywhere in both
        assert np.isnan(gs).all() and np.isnan(ws).all()


@pytest.mark.parametrize("flag_truncation", [False, True])
@pytest.mark.parametrize("name", ["walks", "probes", "float", "ms"])
def test_decode_batched_matches_jax(name, flag_truncation):
    streams, int_opt, unit = _corpus(name)
    words, nbits = _pack(streams)
    want = jdec.decode_batched(words, nbits, N_STEPS, int_optimized=int_opt,
                               unit_nanos=unit, flag_truncation=flag_truncation)
    got = tdec.decode_batched(torch.from_numpy(words), torch.from_numpy(nbits),
                              N_STEPS, int_optimized=int_opt, unit_nanos=unit,
                              flag_truncation=flag_truncation)
    for field, g, w in zip(("ts", "vs", "valid", "count", "error"), got, want):
        assert_same(g, w, f"{name}.{field}")
    if name in ("probes", "float"):
        # the probe sets must reach the error contract and clean lanes alike
        assert got[4][: len(streams)].any() and not got[4][: len(streams)].all()


@pytest.mark.parametrize("flag_truncation", [False, True])
@pytest.mark.parametrize("n_steps", [1, 33])
def test_decode_batched_steps_match_jax(n_steps, flag_truncation):
    """K3's grids at step counts around the CUDA kernel's staged tiles (it
    writes 16 steps a lane at a time): one step, and 33 of the probes' 36
    records, so that most lanes are cut short (truncation flagged) and the
    error lanes stop early."""
    streams, _, _ = _corpus("probes")
    words, nbits = _pack(streams)
    want = jdec.decode_batched(words, nbits, n_steps, flag_truncation=flag_truncation)
    got = tdec.decode_batched(torch.from_numpy(words), torch.from_numpy(nbits), n_steps,
                              flag_truncation=flag_truncation)
    for field, g, w in zip(("ts", "vs", "valid", "count", "error"), got, want):
        assert_same(g, w, f"n_steps={n_steps}.{field}")
    assert got[4][: len(streams)].any()


@pytest.mark.parametrize(
    "name,window,full_agg",
    [("walks", 6, False), ("walks", 6, True), ("probes", 6, False),
     ("probes", 6, True)]
    + [(n, 12, f) for n in ("walks", "probes", "float", "ms") for f in (False, True)])
def test_decode_downsample_fused_matches_jax(name, window, full_agg):
    streams, int_opt, unit = _corpus(name)
    words, nbits = _pack(streams)
    want = jdec.decode_downsample_fused(words, nbits, N_STEPS, window,
                                        int_optimized=int_opt, unit_nanos=unit,
                                        full_agg=full_agg)
    got = tdec.decode_downsample_fused(torch.from_numpy(words),
                                       torch.from_numpy(nbits), N_STEPS, window,
                                       int_optimized=int_opt, unit_nanos=unit,
                                       full_agg=full_agg)
    _agg_same(got[0], want[0], full_agg, name)
    assert_same(got[1], want[1], f"{name}.count")
    assert_same(got[2], want[2], f"{name}.error")


@pytest.mark.parametrize("lanes", [1, 7, 129])
def test_odd_lane_counts_match_jax(lanes):
    streams = (corpus.probe_streams(N_STEPS) + corpus.walk_streams(lanes, N_STEPS))[:lanes]
    words, nbits = _pack(streams, lanes=lanes)
    tw, tn = torch.from_numpy(words), torch.from_numpy(nbits)
    want = jdec.decode_batched(words, nbits, N_STEPS, flag_truncation=True)
    got = tdec.decode_batched(tw, tn, N_STEPS, flag_truncation=True)
    for field, g, w in zip(("ts", "vs", "valid", "count", "error"), got, want):
        assert_same(g, w, f"L={lanes}.{field}")
    want = jdec.decode_downsample_fused(words, nbits, N_STEPS, 12, full_agg=True)
    got = tdec.decode_downsample_fused(tw, tn, N_STEPS, 12, full_agg=True)
    _agg_same(got[0], want[0], True, f"L={lanes}")
    assert_same(got[1], want[1], "count")
    assert_same(got[2], want[2], "error")


@functools.lru_cache(maxsize=None)
def _k2_window_jax(n_steps: int, window: int):
    """The reference's full_agg K2 on ``corpus.k2_window_probe_streams`` at
    (n_steps, window), numpy, the batch's 61 lanes.  Window 1 is read off
    one compiled program at 9 steps: its first n windows are the n-step
    windows, the total is their counts' sum, and a lane is in error after n
    steps iff it is at 9 and its decoder stopped (at its count of valid
    steps) within the first n: a decode step that sets the error is the
    first invalid one, and the flag stays."""
    streams = corpus.k2_window_probe_streams(N_STEPS)
    words, nbits = _pack(streams)
    n = len(streams)
    if window == 1 and n_steps < 9:
        agg, total, error = _k2_window_jax(9, 1)
        agg = type(agg)(*(f[:, :n_steps] for f in agg))
        return (agg, agg.count.sum(axis=1).astype(np.int32),
                error & (total < n_steps))
    agg, total, error = jdec.decode_downsample_fused(words, nbits, n_steps, window,
                                                     full_agg=True)
    return (type(agg)(*(np.asarray(f)[:n] for f in agg)), np.asarray(total)[:n],
            np.asarray(error)[:n])


@pytest.mark.parametrize("full_agg", [False, True])
@pytest.mark.parametrize("n_steps,window", corpus.K2_WINDOW_CASES)
def test_k2_window_edges_match_jax(n_steps, window, full_agg):
    """K2's plain version around the CUDA kernel's staged groups of 4
    windows (8 with full_agg): n_win 1, 3, 4, 5, 7, 8, 9; window 1 and
    window = n_steps; on lanes
    that stop in error in the middle of a window.  Without full_agg the
    sum and count are the reference's full_agg ones (computed alike in both
    modes) and the other fields NaN."""
    streams = corpus.k2_window_probe_streams(N_STEPS)
    words, nbits = pack_streams(streams)
    got = tdec.decode_downsample_fused(torch.from_numpy(words), torch.from_numpy(nbits),
                                       n_steps, window, full_agg=full_agg)
    want = _k2_window_jax(n_steps, window)
    what = f"K2 ({n_steps}, {window}) full_agg={full_agg}"
    if full_agg:
        _agg_same(got[0], want[0], True, what)
    else:
        for field in ("sum", "count"):
            assert_same(getattr(got[0], field), getattr(want[0], field), f"{what}.{field}")
        for field in ("sum_sq", "min", "max", "last"):
            assert np.isnan(getattr(got[0], field).numpy()).all(), f"{what}.{field}"
    assert_same(got[1], want[1], f"{what}.count")
    assert_same(got[2], want[2], f"{what}.error")
    assert got[0].count.shape == (len(streams), n_steps // window)
    err = got[2].numpy()
    if n_steps > 4:  # error lanes and clean lanes alike
        assert err.any() and not err.all()
    if window > 1:  # lanes stop in error inside a window
        assert ((got[1].numpy() % window != 0) & err).any()


@pytest.mark.parametrize("int_optimized", [True, False])
def test_decode_streams_matches_jax(int_optimized):
    streams = corpus.probe_streams(N_STEPS, int_optimized=int_optimized)
    if int_optimized:
        streams += corpus.walk_streams(4, N_STEPS)
    else:
        streams += corpus.golden_streams()
    before = decode_counter.value()
    got = tdec.decode_streams(streams, N_STEPS, int_optimized=int_optimized,
                              device="cpu")
    assert decode_counter.value() - before == len(streams)
    want = jdec.decode_streams(streams, N_STEPS, int_optimized=int_optimized,
                               prefer_native=False)
    for field, g, w in zip(("ts", "vs", "valid"), got, want):
        assert_same(torch.from_numpy(g), w, f"decode_streams.{field}")
    # the corpus reaches the scalar-oracle patching: it holds error lanes
    words, nbits = pack_streams(streams)
    _, _, _, _, err = tdec.decode_batched(torch.from_numpy(words),
                                          torch.from_numpy(nbits), N_STEPS,
                                          int_optimized=int_optimized)
    assert err.any()


def test_input_validation():
    words, nbits = _pack(corpus.walk_streams(2, 6), lanes=2)
    tw, tn = torch.from_numpy(words), torch.from_numpy(nbits)
    with pytest.raises(ValueError, match="second/millisecond"):
        tdec.decode_batched(tw, tn, 6, unit_nanos=1000)
    with pytest.raises(ValueError, match="not divisible"):
        tdec.decode_downsample_fused(tw, tn, 6, 4)
    with pytest.raises(ValueError, match="nbits"):
        tdec.decode_batched(tw, tn[:1], 6)
    with pytest.raises(ValueError, match="uint32"):
        tdec.decode_batched(tw.to(torch.int64), tn, 6)


# --- the decoder's word reader (K1) ------------------------------------------

K1_STEPS = 40  # past the longest probe stream's 37 points


@functools.lru_cache(maxsize=None)
def _k1_batch(int_optimized: bool):
    """``corpus.k1_probe_streams`` packed into [64, W] words, W the longest
    stream's words: no padding words, so the last records' 128-bit windows
    read past the row (zeros, as the reference's one-hot read gives) and
    the longest rows end at their ``nbits``."""
    streams = corpus.k1_probe_streams(int_optimized)
    words, nbits = pack_streams(streams)
    words = words[:, :int((nbits.max() + 31) // 32)]
    words = np.pad(words, ((0, LANES - len(streams)), (0, 0)))
    return words, np.pad(nbits, (0, LANES - len(streams))), len(streams)


@pytest.mark.parametrize("flag_truncation", [False, True])
@pytest.mark.parametrize("int_optimized", [True, False])
def test_k1_probes_decode_batched_match_jax(int_optimized, flag_truncation):
    """K3's plain version against the reference on the word reader's probes
    (a 36-bit delta-of-delta with a 64-bit float at every bit offset of a
    word, end-of-stream and annotation markers at a word's first and last
    bits, rows that end at their data): bit for bit."""
    words, nbits, _ = _k1_batch(int_optimized)
    want = jdec.decode_batched(words, nbits, K1_STEPS, int_optimized=int_optimized,
                               flag_truncation=flag_truncation)
    got = tdec.decode_batched(torch.from_numpy(words), torch.from_numpy(nbits), K1_STEPS,
                              int_optimized=int_optimized, flag_truncation=flag_truncation)
    for field, g, w in zip(("ts", "vs", "valid", "count", "error"), got, want):
        assert_same(g, w, f"K1 probes int_optimized={int_optimized}.{field}")


@pytest.mark.parametrize("full_agg", [False, True])
@pytest.mark.parametrize("int_optimized", [True, False])
def test_k1_probes_downsample_match_jax(int_optimized, full_agg):
    """K2's plain version against the reference on the word reader's probes,
    windows of 4 points (the fields and sum_sq as the module note says)."""
    words, nbits, _ = _k1_batch(int_optimized)
    want = jdec.decode_downsample_fused(words, nbits, K1_STEPS, 4, int_optimized=int_optimized,
                                        full_agg=True)
    got = tdec.decode_downsample_fused(torch.from_numpy(words), torch.from_numpy(nbits),
                                       K1_STEPS, 4, int_optimized=int_optimized,
                                       full_agg=full_agg)
    what = f"K1 probes K2 int_optimized={int_optimized} full_agg={full_agg}"
    if full_agg:
        _agg_same(got[0], want[0], True, what)
    else:
        for field in ("sum", "count"):
            assert_same(getattr(got[0], field), getattr(want[0], field), f"{what}.{field}")
    assert_same(got[1], want[1], f"{what}.count")
    assert_same(got[2], want[2], f"{what}.error")


@pytest.mark.parametrize("int_optimized", [True, False])
def test_k1_probes_reach_the_corners(int_optimized):
    """The probes decode (the scalar oracle agrees with the batched plain
    version on every clean lane), hold error lanes (the annotation markers)
    and clean ones, rows that end exactly at their nbits (the longest
    among them), and a 100,000 s gap in each of the first 44 lanes (the 32
    offsets' long records and the 12 mixed streams)."""
    words, nbits, n = _k1_batch(int_optimized)
    ts, vs, valid, count, error = tdec.decode_batched(
        torch.from_numpy(words), torch.from_numpy(nbits), K1_STEPS, int_optimized=int_optimized)
    error = error.numpy()[:n]
    assert error.any() and not error.all()
    assert (nbits[:n] == 32 * words.shape[1]).any() and (nbits[:n] % 32 == 0).sum() > 2
    gaps = np.diff(ts.numpy()[:44], axis=1)
    assert (gaps >= 100_000 * SEC).any(axis=1).all()
    streams = corpus.k1_probe_streams(int_optimized)
    for lane in np.flatnonzero(~error):
        got_t = ts.numpy()[lane][valid.numpy()[lane]]
        want_t = [p.t_nanos for p in m3tsz_scalar.Decoder(
            streams[lane], int_optimized=int_optimized)] if streams[lane] else []
        assert list(got_t) == want_t[:K1_STEPS], lane
