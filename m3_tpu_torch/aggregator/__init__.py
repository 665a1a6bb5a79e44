"""Aggregator: device-batched streaming aggregation (the write side).

Port of ``m3_tpu/aggregator/``: ``Aggregator`` with its per-resolution
``MetricList`` of ``ElemPool`` lanes, whose ingest, flush and timer
quantile kernels (A1a-A1c) run on the device.  ``FlushManager``, the
handlers and the transport wait for the aggregator service (ROADMAP.md).
"""

from m3_tpu_torch.aggregator.aggregator import (AggregatedMetric, AggregationKey,
                                                Aggregator, AggregatorOptions,
                                                ErrShardNotOwned, MetricKind, MetricList,
                                                suffix_for)
from m3_tpu_torch.aggregator.elems import ElemPool, FlushedWindows, padded_quantiles

__all__ = [
    "AggregatedMetric", "AggregationKey", "Aggregator", "AggregatorOptions",
    "ErrShardNotOwned", "MetricKind", "MetricList", "suffix_for", "ElemPool",
    "FlushedWindows", "padded_quantiles",
]
