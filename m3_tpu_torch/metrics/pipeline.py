"""Rollup pipelines: transformation + rollup op chains.

(ref: src/metrics/pipeline/ — a pipeline is a sequence of ops:
Aggregation, Transformation (absolute/persecond/increase/add/reset —
transformation/type.go:156-188), and Rollup (new name + group-by tags
+ aggregation); pipeline/applied/type.go is the matched, concrete
form shipped to the aggregator.)

The transformation kernels themselves are device code
(m3_tpu_torch/ops/downsample.py Transformation); these descriptors carry
which ones to run per pipeline stage.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field

from m3_tpu_torch.metrics.policy import AggregationID
from m3_tpu_torch.ops.downsample import AggregationType, Transformation


class PipelineOpType(enum.IntEnum):
    AGGREGATION = 1
    TRANSFORMATION = 2
    ROLLUP = 3


@dataclass(frozen=True)
class PipelineOp:
    type: PipelineOpType
    # AGGREGATION
    aggregation_type: AggregationType | None = None
    # TRANSFORMATION
    transformation: Transformation | None = None
    # ROLLUP (applied form: concrete rollup ID template)
    rollup_new_name: bytes = b""
    rollup_group_by: tuple[bytes, ...] = ()
    rollup_aggregation_id: AggregationID = field(
        default_factory=AggregationID)

    @staticmethod
    def aggregation(t: AggregationType) -> "PipelineOp":
        return PipelineOp(PipelineOpType.AGGREGATION, aggregation_type=t)

    @staticmethod
    def transform(t: Transformation) -> "PipelineOp":
        return PipelineOp(PipelineOpType.TRANSFORMATION, transformation=t)

    @staticmethod
    def rollup(new_name: bytes, group_by: tuple[bytes, ...],
               agg_id: AggregationID | None = None) -> "PipelineOp":
        return PipelineOp(PipelineOpType.ROLLUP,
                          rollup_new_name=new_name,
                          rollup_group_by=tuple(sorted(group_by)),
                          rollup_aggregation_id=agg_id or AggregationID())


@dataclass(frozen=True)
class AppliedPipeline:
    """Matched pipeline ops (ref: pipeline/applied/type.go)."""

    ops: tuple[PipelineOp, ...] = ()

    def is_empty(self) -> bool:
        return not self.ops

    def at(self, i: int) -> PipelineOp:
        return self.ops[i]

    def skip_first(self) -> "AppliedPipeline":
        return AppliedPipeline(self.ops[1:])
