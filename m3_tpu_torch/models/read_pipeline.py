"""Flagship read-path pipeline: compressed blocks -> decode -> downsample.

Port of ``m3_tpu/models/read_pipeline.py``: ``decode_downsample`` on one
device, and ``decode_downsample_sharded`` over a (series x window) mesh
(``parallel/mesh.py``) with the fleet-wide sum consolidated by the mesh's
collectives.  Simple
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
from m3_tpu_torch.parallel.mesh import (SERIES_AXIS, WINDOW_AXIS, Mesh, consolidate_windows,
                                        psum, series_sharding, shard_reduce,
                                        supports_f64_reduce_scatter)
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


def decode_downsample_sharded(
    mesh: Mesh,
    n_steps: int,
    window: int,
    agg_type: ds.AggregationType = ds.AggregationType.MEAN,
    unit_nanos: int = xtime.SECOND,
):
    """The distributed read step for ``mesh``.

    Returns ``step(words, nbits) -> (per_lane f64[lanes, n_windows],
    fleet f64[n_windows])``: ``words`` [lanes, W] / ``nbits`` [lanes] are
    the rank's lanes (``shard_inputs``), split evenly over its shards (lanes
    are sharded over BOTH mesh axes: every shard decodes a distinct slice);
    ``per_lane`` is ``decode_downsample`` of those lanes (one launch over
    all of them), ``fleet`` the fleet-wide sum, replicated: each shard's
    ``nan_to_num(per_lane).sum(0)`` (QK4), a ``psum`` over the series axis
    and ``consolidate_windows`` over the window axis (MK1), with the scatter
    schedule where ``supports_f64_reduce_scatter``."""
    use_scatter = supports_f64_reduce_scatter(mesh)
    n_windows = n_steps // window

    def step(words, nbits):
        per_lane, _, _ = decode_downsample(words, nbits, n_steps, window, agg_type, unit_nanos,
                                           device=mesh.device)
        # jnp.nan_to_num: NaN -> 0.0 and +-Inf -> +-DBL_MAX, then QK4's sum
        local_sum = shard_reduce(mesh, torch.nan_to_num(per_lane))
        partial = psum(mesh, local_sum, SERIES_AXIS)
        fleet = consolidate_windows(mesh, partial, WINDOW_AXIS, use_scatter)[0]
        if fleet.shape != (n_windows,):
            raise RuntimeError(f"fleet of shape {tuple(fleet.shape)}, want ({n_windows},)")
        return per_lane, fleet

    return step


def shard_inputs(mesh: Mesh, words, nbits):
    """The rank's lanes of host (or device) arrays on the mesh's device,
    lanes split evenly over every shard of the mesh in shard order."""
    return series_sharding(mesh, words), series_sharding(mesh, nbits)
