"""Metrics domain model: IDs, policies, rules, pipelines (host-only).

Copies of ``m3_tpu/metrics/`` with their imports rewritten: metric IDs in
the m3 tag format, storage policies (resolution:retention),
aggregation-type sets, mapping/rollup rules with glob tag filters, the
active-ruleset forward match producing staged metadatas, and rollup
pipelines.  ``matcher.py``, ``wire.py`` and ``rules_codec.py`` are not
copied yet (ROADMAP.md, queue 1 item 8).
"""

from m3_tpu_torch.metrics.id import (
    decode_m3_id, encode_m3_id, new_rollup_id, is_rollup_id)
from m3_tpu_torch.metrics.policy import (
    AggregationID, Resolution, Retention, StoragePolicy)
from m3_tpu_torch.metrics.filters import TagFilter
from m3_tpu_torch.metrics.pipeline import (
    PipelineOp, PipelineOpType, AppliedPipeline)
from m3_tpu_torch.metrics.rules import (
    DropPolicy, MappingRule, MatchResult, PipelineMetadata, RollupRule, RollupTarget,
    RuleSet, StagedMetadata)

__all__ = [
    "encode_m3_id", "decode_m3_id", "new_rollup_id", "is_rollup_id",
    "Resolution", "Retention", "StoragePolicy", "AggregationID",
    "TagFilter", "PipelineOp", "PipelineOpType", "AppliedPipeline",
    "DropPolicy", "MappingRule", "RollupRule", "RollupTarget", "RuleSet",
    "StagedMetadata", "PipelineMetadata", "MatchResult",
]
