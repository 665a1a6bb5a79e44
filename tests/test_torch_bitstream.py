"""Port parity: bitstream packing and the 64-bit bit primitives.

The port holds 64-bit words as int64 bit patterns (PyTorch has no uint64
shifts on the CPU); these must give the reference's results bit for bit.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from m3_tpu.ops import bitstream as jbs
from m3_tpu_torch.models import corpus
from m3_tpu_torch.ops import bitstream as tbs


def _words_u64():
    rng = np.random.default_rng(42)
    x = rng.integers(0, 2**64, 512, dtype=np.uint64, endpoint=False)
    # single bits, low masks and high masks at every position
    single = np.uint64(1) << np.arange(64, dtype=np.uint64)
    low = single - np.uint64(1)
    edges = np.array([0, 1, 1 << 63, 2**64 - 1, (1 << 63) - 1, 1 << 32],
                     dtype=np.uint64)
    return np.concatenate([x, single, low, ~low, edges])


def test_pack_streams_identical():
    streams = (corpus.walk_streams(5, 36) + corpus.probe_streams()
               + corpus.golden_streams() + [b"", b"\x01"])
    jw, jn = jbs.pack_streams(streams)
    tw, tn = tbs.pack_streams(streams)
    assert jw.dtype == tw.dtype and jn.dtype == tn.dtype
    np.testing.assert_array_equal(tw, jw)
    np.testing.assert_array_equal(tn, jn)
    for lane in (0, 7, len(streams) - 1):
        assert tbs.unpack_stream(tw[lane], tn[lane]) == streams[lane]


@pytest.mark.parametrize("fn", ["clz64", "ctz64"])
def test_count_zeros_identical(fn):
    x = _words_u64()
    want = np.asarray(getattr(jbs, fn)(jnp.asarray(x)))
    got = getattr(tbs, fn)(torch.from_numpy(x.view(np.int64))).numpy()
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    assert int(tbs.clz64(torch.tensor([0]))[0]) == 64
    assert int(tbs.ctz64(torch.tensor([0]))[0]) == 0


def test_take_top_identical():
    x = _words_u64()
    n = np.arange(x.size) % 65  # every width 0..64
    want = np.asarray(jbs.take_top(jnp.asarray(x), jnp.asarray(n)))
    got = tbs.take_top(torch.from_numpy(x.view(np.int64)), torch.from_numpy(n))
    np.testing.assert_array_equal(got.numpy().view(np.uint64), want)


def test_srl_is_logical_shift():
    x = _words_u64()
    t = torch.from_numpy(x.view(np.int64))
    for n in (0, 1, 31, 32, 55, 63):
        np.testing.assert_array_equal(
            tbs.srl(t, n).numpy().view(np.uint64), x >> np.uint64(n))
    n = np.arange(x.size) % 64
    got = tbs.srl(t, torch.from_numpy(n)).numpy().view(np.uint64)
    np.testing.assert_array_equal(got, x >> n.astype(np.uint64))


def test_bitcast_i64():
    x = _words_u64()
    got = tbs.bitcast_i64(torch.from_numpy(x.view(np.int64)).view(torch.uint64))
    np.testing.assert_array_equal(got.numpy(), np.asarray(jbs.bitcast_i64(jnp.asarray(x))))
    w = np.array([0, 1, 2**31, 2**32 - 1], dtype=np.uint32)
    got = tbs.bitcast_i64(torch.from_numpy(w))
    np.testing.assert_array_equal(got.numpy(), np.asarray(jbs.bitcast_i64(jnp.asarray(w))))
