"""Flagship read-path pipeline: compressed blocks -> decode -> downsample.

Port of ``m3_tpu/models/read_pipeline.py`` (single-device entry).  Simple
and moment-based aggregates ride the fused decode+downsample kernel (no
[L, n_steps] grid in device memory); quantile types decode the raw grid
and run the window-quantile kernel on it.

There are no weights: the data takes their place.  ``inputs_from_numpy``
takes the packed batch the reference package takes (``pack_streams``
output) and ``agg_to_numpy`` brings a ``WindowedAgg`` back to the host,
so the same numpy inputs can feed both packages.
"""

from __future__ import annotations

import numpy as np
import torch

from m3_tpu_torch.ops import downsample as ds
from m3_tpu_torch.ops.m3tsz_decode import decode_batched, decode_downsample_fused
from m3_tpu_torch.utils import xtime
from m3_tpu_torch.utils.device import resolve_device

_SIMPLE_AGGS = (
    ds.AggregationType.MEAN,
    ds.AggregationType.SUM,
    ds.AggregationType.COUNT,
)


def inputs_from_numpy(words: np.ndarray, nbits: np.ndarray, device=None):
    """Packed ``(u32[L, W] words, i32[L] nbits)`` as tensors on ``device``
    (default: the CUDA device)."""
    dev = resolve_device(device)
    # moved as int32 bit patterns, then viewed as uint32 (a metadata change)
    w = torch.from_numpy(np.ascontiguousarray(words, dtype=np.uint32).view(np.int32))
    nb = torch.from_numpy(np.ascontiguousarray(nbits, dtype=np.int32))
    return w.to(dev).view(torch.uint32), nb.to(dev)


def agg_to_numpy(agg: ds.WindowedAgg) -> ds.WindowedAgg:
    """A WindowedAgg of host numpy arrays."""
    return ds.WindowedAgg(*(x.cpu().numpy() for x in agg))


def decode_downsample(
    words,
    nbits,
    n_steps: int,
    window: int,
    agg_type: ds.AggregationType = ds.AggregationType.MEAN,
    unit_nanos: int = xtime.SECOND,
    device=None,
):
    """[L, W] compressed words -> [L, n_steps//window] aggregates.

    ``words``/``nbits`` are tensors (they run where they lie unless
    ``device`` says otherwise) or numpy arrays (moved to ``device``,
    default the CUDA device).  Returns (agg_values f64[L, n_windows],
    count i32[L], error bool[L]).
    """
    dev = resolve_device(device, like=words)
    if not isinstance(words, torch.Tensor):
        words, nbits = inputs_from_numpy(words, nbits, dev)
    words, nbits = words.to(dev), nbits.to(dev)
    agg_type = ds.AggregationType(agg_type)
    if agg_type in ds.QUANTILE_OF_TYPE:
        _, vs, valid, count, error = decode_batched(
            words, nbits, n_steps, int_optimized=True, unit_nanos=unit_nanos
        )
        q = ds.QUANTILE_OF_TYPE[agg_type]
        qv = ds.window_quantiles(vs, valid, window, (q,))
        return qv[:, :, 0], count, error
    agg, count, error = decode_downsample_fused(
        words,
        nbits,
        n_steps,
        window,
        unit_nanos=unit_nanos,
        full_agg=agg_type not in _SIMPLE_AGGS,
    )
    out = ds.value_of(agg, agg_type)
    return out, count, error
