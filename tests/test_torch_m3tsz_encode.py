"""Port parity: batched M3TSZ encode (value grammar + kernel E1's plain
version) and the block seal, plain PyTorch vs the JAX package.

The same numpy batch (``corpus.encode_probe_series``: every
delta-of-delta bucket and its edges, float mode and XOR, int<->float
flips, decimal multipliers, sig-bit hysteresis, repeats, negative and huge
values, NaN, +-Inf, +-0.0, ragged and empty lanes, the fuzz mix and the
golden fixture's points; 70 lanes) goes through ``m3_tpu.ops.m3tsz_encode``
(JAX on the CPU) and ``m3_tpu_torch.ops.m3tsz_encode`` on CPU tensors.

Everything is held bit for bit / byte for byte: words, bit lengths and
value fields are integers, and wire bytes must equal the scalar encoder's.
The JAX pack program compiles once, at the batch's shape.
"""

import functools
import random

import numpy as np
import pytest
import torch

from m3_tpu.ops import m3tsz_encode as jenc
from m3_tpu.ops import m3tsz_scalar as jtsz
from m3_tpu.storage import shard as jshard
from m3_tpu_torch.models import corpus
from m3_tpu_torch.ops import m3tsz_encode as tenc
from m3_tpu_torch.ops import m3tsz_scalar as ttsz
from m3_tpu_torch.storage import shard as tshard
from m3_tpu_torch.utils import native

from test_torch_m3tsz_decode import assert_same

SEC = 1_000_000_000


@functools.lru_cache(maxsize=None)
def _probes():
    series = corpus.encode_probe_series()
    return series, corpus.encode_batch(series)


@functools.lru_cache(maxsize=None)
def _fields():
    """The probe batch's value fields, from the reference's numpy grammar."""
    _, (ts, vs, start, n_valid) = _probes()
    return jenc.prepare_value_fields(vs, n_valid)


def _hostile(seed: int = 2, L: int = 200, T: int = 80):
    """The reference's hostile prepare workload (NaN, +-inf, -0.0, huge
    magnitudes, decimals, ragged lanes)."""
    rng = np.random.default_rng(seed)
    vs = np.where(rng.random((L, T)) < 0.4, rng.integers(0, 500, (L, T)).astype(np.float64),
                  np.round(rng.normal(100, 10, (L, T)), 2))
    vs[0] = rng.normal(size=T)
    vs[1] = 0.0
    vs[2, ::3] = np.nan
    vs[3, ::5] = np.inf
    vs[3, 1::5] = -np.inf
    vs[4] = -0.0
    vs[5] = rng.integers(-10**12, 10**12, T).astype(np.float64) * 1e6
    nv = rng.integers(0, T + 1, L).astype(np.int32)
    nv[:6] = T
    return vs, nv


@pytest.mark.parametrize("impl", ["numpy", "native"])
def test_prepare_value_fields_matches_reference(impl):
    vs, nv = _hostile()
    want = jenc.prepare_value_fields(vs, nv)
    fn = tenc.prepare_value_fields if impl == "numpy" else native.prepare_value_fields_native
    got = fn(vs, nv)
    for name, g, w in zip(("ctl_bits", "ctl_n", "pay_bits", "pay_n"), got, want):
        assert g.dtype == w.dtype, name
        np.testing.assert_array_equal(g, w, err_msg=name)


def test_pack_encode_matches_jax():
    _, (ts, vs, start, n_valid) = _probes()
    cb, cn, pb, pn = _fields()
    want_words, want_nbits = jenc._pack_encode_jit(ts, start, n_valid, cb, cn, pb, pn)
    args = [torch.from_numpy(x) for x in (ts, start, n_valid, cb.view(np.int64), cn,
                                          pb.view(np.int64), pn)]
    words, nbits = tenc.pack_encode(*args)
    assert words.shape == (len(n_valid), tenc.n_words_for(ts.shape[1]))
    assert_same(words, want_words, "words")
    assert_same(nbits, want_nbits, "nbits")
    assert int(nbits[n_valid == 0].abs().sum()) == 0  # an empty lane has no bits


@pytest.mark.parametrize("n_steps", corpus.PACK_EDGE_STEPS)
def test_pack_encode_matches_jax_at_edges(n_steps):
    """``corpus.pack_edge_fields`` (steps around E1's 32-step chunks, lanes
    of 0, 1 and all valid points, deltas-of-delta on each side of every
    time-field bucket edge and with sub-second parts, payloads of up to 64
    bits with bits set above each width) through both sides, bit for bit."""
    ts, start, n_valid, cb, cn, pb, pn = corpus.pack_edge_fields(n_steps)
    want_words, want_nbits = jenc._pack_encode_jit(ts, start, n_valid, cb.view(np.uint64), cn,
                                                   pb.view(np.uint64), pn)
    words, nbits = tenc.pack_encode(*(torch.from_numpy(x)
                                      for x in (ts, start, n_valid, cb, cn, pb, pn)))
    assert words.shape == (len(n_valid), tenc.n_words_for(n_steps))
    assert_same(words, want_words, "words")
    assert_same(nbits, want_nbits, "nbits")
    assert int(nbits[0]) == int(cn[0].sum() + pn[0].sum())  # no start, time fields or EOS


@pytest.mark.parametrize("oracle", ["reference scalar", "reference batched", "port scalar"])
def test_encode_to_streams_matches_scalar(oracle):
    series, (ts, vs, start, n_valid) = _probes()
    got = tenc.encode_to_streams(ts, vs, start, n_valid, device="cpu")
    if oracle == "reference batched":
        want = jenc.encode_to_streams(ts, vs, start, n_valid)
    else:
        enc = jtsz.encode_series if oracle == "reference scalar" else ttsz.encode_series
        want = [enc(t, v, st) if t else b"" for t, v, st in series]
    for lane, (g, w) in enumerate(zip(got, want)):
        assert g == w, f"lane {lane}: {g.hex()} != {w.hex()}"


def test_encoded_probes_round_trip():
    series, (ts, vs, start, n_valid) = _probes()
    got = tenc.encode_to_streams(ts, vs, start, n_valid, device="cpu")
    for lane, ((t, v, _), stream) in enumerate(zip(series, got)):
        rt_t, rt_v = ttsz.decode_series(stream) if t else ([], [])
        assert rt_t == list(t), lane
        # the int-optimized grammar writes -0.0 as the integer 0, as the
        # reference's does, so values compare by ==, NaN with NaN
        for a, b in zip(rt_v, v):
            assert a == b or (np.isnan(a) and np.isnan(b)), (lane, a, b)


@pytest.mark.parametrize("fixture", range(4))
def test_golden_fixture_points_seal_like_scalar(fixture):
    """Each golden fixture of tests/test_m3tsz_golden.py decodes to its
    points; sealed through encode_block_device (the time-unit fixtures'
    millisecond stamps take the scalar encoder) they equal the scalar
    encoder's bytes and decode back to the same points."""
    golden = corpus.golden_streams()[fixture]
    start = 1427162400 * SEC
    pts = list(ttsz.Decoder(golden, int_optimized=False))
    want_pts = list(jtsz.Decoder(golden, int_optimized=False))
    assert [(p.t_nanos, p.value) for p in pts] == [(p.t_nanos, p.value) for p in want_pts]
    times = np.asarray([p.t_nanos for p in pts], dtype=np.int64)
    values = np.asarray([p.value for p in pts])
    lanes = np.zeros(len(times), dtype=np.int64)
    got = tshard.encode_block_device(start, lanes, times, values, 1, device="cpu")
    assert got == jshard.encode_block_scalar(start, lanes, times, values, 1)
    rt_t, rt_v = ttsz.decode_series(got[0])
    assert rt_t == times.tolist() and rt_v == values.tolist()


def _seal_case():
    """The ragged block of the reference's test_device_seal_matches_scalar_seal."""
    rng = random.Random(11)
    lanes, times, values = [], [], []
    for lane in range(7):
        t = corpus.START
        for _ in range(rng.randint(0, 25)):
            t += rng.choice([10, 10, 30]) * SEC
            lanes.append(lane)
            times.append(t)
            values.append(float(rng.randint(-20, 20)) if rng.random() < 0.7 else rng.uniform(0, 5))
    return (np.asarray(lanes, dtype=np.int64), np.asarray(times, dtype=np.int64),
            np.asarray(values, dtype=np.float64))


@pytest.mark.parametrize("case", ["reference seal", "ragged 40 lanes", "sub-second"])
def test_encode_block_device_matches_scalar(case):
    if case == "reference seal":
        lanes, times, values = _seal_case()
        n_lanes = 7
    elif case == "ragged 40 lanes":
        lanes, times, values = corpus.ragged_block(40, 70)
        n_lanes = 41  # the last lane is empty
    else:
        lanes, times, values = _seal_case()
        times = times + 250_000_000 * (lanes == 3)  # one lane off the second grid
        n_lanes = 7
    want = jshard.encode_block_scalar(corpus.START, lanes, times, values, n_lanes)
    assert tshard.encode_block_scalar(corpus.START, lanes, times, values, n_lanes) == want
    assert tshard.encode_block_device(corpus.START, lanes, times, values, n_lanes,
                                      device="cpu") == want


def test_native_build_failure_raises(tmp_path, monkeypatch):
    (tmp_path / "broken.cc").write_text("int f( {\n")
    monkeypatch.setattr(native, "NATIVE_DIR", tmp_path)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed on native/broken.cc"):
        native.load("broken")


def test_encode_entry_points_never_fall_back_to_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, (ts, vs, start, n_valid) = _probes()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tenc.encode_batched(ts, vs, start, n_valid)
    lanes, times, values = _seal_case()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tshard.encode_block_device(corpus.START, lanes, times, values, 7)


def test_pack_encode_checks_shapes():
    t = torch.zeros((3, 4), dtype=torch.int64)
    with pytest.raises(ValueError, match="ctl_n must be"):
        tenc.pack_encode(t, t[:, 0], t[:, 0].int(), t, t[:2].int(), t, t.int())
