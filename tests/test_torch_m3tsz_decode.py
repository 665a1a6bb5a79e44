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
