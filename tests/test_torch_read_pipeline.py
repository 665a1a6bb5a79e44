"""Port parity and guards for the flagship read pipeline.

- ``decode_downsample`` for every AggregationType against
  ``m3_tpu.models.decode_downsample`` on the same packed batch (seed-42
  walks plus the probe streams).  Bit for bit, except SUMSQ (rtol=1e-12)
  and STDEV (rtol=1e-9, atol=1e-12): XLA:CPU contracts parts of the
  sum-of-squares arithmetic into fused multiply-adds, the port does not.
- ``entry(device="cpu")`` against the reference's ``__graft_entry__``.
- Guards: the port imports neither ``jax`` nor ``m3_tpu``, and its entry
  points never fall back to the CPU when no CUDA device is present.
"""

import functools
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import __graft_entry__
from m3_tpu.models import decode_downsample as j_decode_downsample
from m3_tpu_torch import entry as port_entry
from m3_tpu_torch.models import corpus, read_pipeline
from m3_tpu_torch.ops import downsample as tds
from m3_tpu_torch.ops import m3tsz_decode as tdec

from test_torch_m3tsz_decode import N_STEPS, _pack, assert_same

REPO = Path(__file__).resolve().parents[1]
WINDOW = 12  # the nested-scan form: one short JAX compile per aggregation type


@functools.lru_cache(maxsize=None)
def _batch():
    return _pack(corpus.walk_streams(40, N_STEPS) + corpus.probe_streams(N_STEPS)[:24])


@pytest.mark.parametrize("agg_type", [t for t in tds.AggregationType
                                      if t != tds.AggregationType.UNKNOWN])
def test_decode_downsample_matches_jax(agg_type):
    words, nbits = _batch()
    want = j_decode_downsample(words, nbits, N_STEPS, WINDOW, int(agg_type))
    got = read_pipeline.decode_downsample(words, nbits, N_STEPS, WINDOW, agg_type,
                                          device="cpu")
    if agg_type == tds.AggregationType.SUMSQ:
        np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), rtol=1e-12,
                                   atol=0, equal_nan=True)
    elif agg_type == tds.AggregationType.STDEV:
        np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), rtol=1e-9,
                                   atol=1e-12, equal_nan=True)
    else:
        assert_same(got[0], want[0], agg_type.name)
    assert_same(got[1], want[1], "count")
    assert_same(got[2], want[2], "error")


def test_entry_matches_graft_entry():
    fn, args = __graft_entry__.entry()
    want = np.asarray(fn(*args))
    pfn, pargs = port_entry.entry(device="cpu")
    assert [a.device.type for a in pargs] == ["cpu", "cpu"]
    assert [tuple(a.shape) for a in pargs] == [tuple(a.shape) for a in args]
    assert_same(pfn(*pargs), want, "entry")


def test_tensor_inputs_run_where_they_lie():
    words, nbits = _batch()
    tw, tn = read_pipeline.inputs_from_numpy(words, nbits, device="cpu")
    assert tw.dtype == torch.uint32 and tn.dtype == torch.int32
    out, count, error = read_pipeline.decode_downsample(tw, tn, N_STEPS, WINDOW)
    assert out.device.type == "cpu"
    agg, _, _ = tdec.decode_downsample_fused(tw, tn, N_STEPS, WINDOW, full_agg=True)
    back = read_pipeline.agg_to_numpy(agg)
    assert all(isinstance(x, np.ndarray) for x in back)
    assert_same(torch.from_numpy(back.sum), agg.sum, "agg_to_numpy")


def test_port_imports_neither_jax_nor_reference():
    code = (
        "import importlib, pkgutil, sys\n"
        "import m3_tpu_torch\n"
        "for m in pkgutil.walk_packages(m3_tpu_torch.__path__, 'm3_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "import m3_tpu_torch.entry, chip_smoke\n"
        "import m3_tpu_torch.aggregator.aggregator, m3_tpu_torch.ops.m3tsz_encode\n"
        "import m3_tpu_torch.storage.shard, m3_tpu_torch.utils.native\n"
        "import m3_tpu_torch.storage.database, m3_tpu_torch.storage.tiles\n"
        "import m3_tpu_torch.cache, m3_tpu_torch.observe, m3_tpu_torch.ops.tiles\n"
        "bad = [m for m in sys.modules if m in ('jax', 'm3_tpu')\n"
        "       or m.startswith(('jax.', 'jaxlib', 'm3_tpu.'))]\n"
        "assert not bad, bad\n"
        "print(len([m for m in sys.modules if m.startswith('m3_tpu_torch')]))\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    # every module was imported: the read, query and write slices, storage
    assert int(res.stdout.strip()) >= 60


def test_default_device_never_falls_back_to_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    words, nbits = _batch()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        read_pipeline.decode_downsample(words, nbits, N_STEPS, WINDOW)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        read_pipeline.inputs_from_numpy(words, nbits)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tdec.decode_streams(corpus.walk_streams(2, 6), 6)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        port_entry.entry()
