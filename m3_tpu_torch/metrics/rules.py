"""Mapping + rollup rules and the active-ruleset forward match.

(ref: src/metrics/rules/ruleset.go, rules/active_ruleset.go:119
ForwardMatch — match a metric's tags against every active rule at time
t, producing (a) staged metadatas for the existing ID: which
aggregations at which storage policies, whether to drop the
unaggregated stream; and (b) new rollup IDs with their own metadatas
for rollup targets.  Rule changes cut over at ``cutover_nanos``; the
match result records when it expires so callers re-match.)

Simplifications vs the reference, recorded explicitly: one rule version
is active at a time per rule (the reference keeps full per-rule history
snapshots); tombstoning is deletion.  The matching semantics —
filter -> union of policies, rollup-id construction, drop policies,
keep-original — follow the reference.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field

from m3_tpu_torch.metrics.filters import TagFilter
from m3_tpu_torch.metrics.id import new_rollup_id
from m3_tpu_torch.metrics.pipeline import AppliedPipeline, PipelineOp, PipelineOpType
from m3_tpu_torch.metrics.policy import AggregationID, StoragePolicy


class DropPolicy(enum.IntEnum):
    """(ref: src/metrics/policy/drop_policy.go)."""

    NONE = 0
    MUST = 1                 # drop the unaggregated metric
    EXCEPT_IF_MATCHED = 2    # drop unless another rule also matched


@dataclass(frozen=True)
class PipelineMetadata:
    """One matched pipeline for an ID
    (ref: src/metrics/metadata/metadata.go PipelineMetadata)."""

    aggregation_id: AggregationID = field(default_factory=AggregationID)
    storage_policies: tuple[StoragePolicy, ...] = ()
    pipeline: AppliedPipeline = field(default_factory=AppliedPipeline)
    drop_policy: DropPolicy = DropPolicy.NONE


@dataclass(frozen=True)
class StagedMetadata:
    """Metadatas effective from cutover_nanos
    (ref: metadata.go StagedMetadatas)."""

    cutover_nanos: int = 0
    pipelines: tuple[PipelineMetadata, ...] = ()

    @property
    def is_drop_policy_applied(self) -> bool:
        """The raw unaggregated stream should not be stored.  Matched
        aggregation pipelines still run — dropping the original and
        aggregating it are orthogonal (ref: metadata.go
        applyDropPolicies; downsample/metrics_appender.go)."""
        return any(p.drop_policy == DropPolicy.MUST for p in self.pipelines)


@dataclass(frozen=True)
class MatchResult:
    """(ref: rules/match.go MatchResult)."""

    version: int
    expire_at_nanos: int
    for_existing_id: StagedMetadata
    for_new_rollup_ids: tuple[tuple[bytes, StagedMetadata], ...] = ()
    keep_original: bool = False

    @property
    def dropped(self) -> bool:
        return self.for_existing_id.is_drop_policy_applied


@dataclass
class MappingRule:
    """(ref: rules/mapping.go): filter -> aggregations @ policies."""

    id: str
    name: str
    filter: TagFilter
    aggregation_id: AggregationID = field(default_factory=AggregationID)
    storage_policies: tuple[StoragePolicy, ...] = ()
    drop_policy: DropPolicy = DropPolicy.NONE
    cutover_nanos: int = 0


@dataclass
class RollupTarget:
    """(ref: rules/rollup_target.go): pipeline ending in a rollup op."""

    pipeline: tuple[PipelineOp, ...]
    storage_policies: tuple[StoragePolicy, ...]


@dataclass
class RollupRule:
    """(ref: rules/rollup.go): filter -> rollup targets."""

    id: str
    name: str
    filter: TagFilter
    targets: tuple[RollupTarget, ...]
    keep_original: bool = False
    cutover_nanos: int = 0


class RuleSet:
    """Active ruleset (ref: rules/ruleset.go activeRuleSet)."""

    def __init__(self, mapping_rules: list[MappingRule] | None = None,
                 rollup_rules: list[RollupRule] | None = None,
                 version: int = 1):
        self.mapping_rules = list(mapping_rules or [])
        self.rollup_rules = list(rollup_rules or [])
        self.version = version
        times = {r.cutover_nanos for r in self.mapping_rules}
        times |= {r.cutover_nanos for r in self.rollup_rules}
        self._cutovers = sorted(times)   # rulesets are immutable once built

    def cutover_times(self) -> list[int]:
        return self._cutovers

    def _expire_at(self, t_nanos: int) -> int:
        import bisect
        i = bisect.bisect_right(self._cutovers, t_nanos)
        return self._cutovers[i] if i < len(self._cutovers) else 2**63 - 1

    def forward_match(self, name: bytes, tags: dict[bytes, bytes],
                      t_nanos: int) -> MatchResult:
        """(ref: active_ruleset.go:119/:227 forwardMatchAt)."""
        all_tags = dict(tags)
        all_tags.setdefault(b"__name__", name)

        pipelines: list[PipelineMetadata] = []
        must_drop = False
        matched_non_drop = False
        matched_drop_except = False
        for rule in self.mapping_rules:
            if rule.cutover_nanos > t_nanos:
                continue
            if not rule.filter.matches(all_tags):
                continue
            if rule.drop_policy == DropPolicy.MUST:
                must_drop = True   # unconditional: drops the raw stream
                continue
            if rule.drop_policy == DropPolicy.EXCEPT_IF_MATCHED:
                matched_drop_except = True
                continue
            matched_non_drop = True
            pipelines.append(PipelineMetadata(
                aggregation_id=rule.aggregation_id,
                storage_policies=tuple(sorted(rule.storage_policies))))
        pipelines = _dedupe_pipelines(pipelines)
        if must_drop or (matched_drop_except and not matched_non_drop):
            pipelines.append(PipelineMetadata(drop_policy=DropPolicy.MUST))

        rollups: list[tuple[bytes, StagedMetadata]] = []
        keep_original = False
        for rule in self.rollup_rules:
            if rule.cutover_nanos > t_nanos:
                continue
            if not rule.filter.matches(all_tags):
                continue
            if rule.keep_original:
                keep_original = True
            for target in rule.targets:
                rid, meta = self._apply_rollup_target(
                    target, all_tags, t_nanos)
                if rid is not None:
                    rollups.append((rid, meta))

        return MatchResult(
            version=self.version,
            expire_at_nanos=self._expire_at(t_nanos),
            for_existing_id=StagedMetadata(t_nanos, tuple(pipelines)),
            for_new_rollup_ids=tuple(rollups),
            keep_original=keep_original)

    def _apply_rollup_target(self, target: RollupTarget,
                             tags: dict[bytes, bytes], t_nanos: int):
        """Build the concrete rollup ID: keep only group-by tags
        (ref: active_ruleset.go toRollupResults — matched rollup op
        produces the new ID from the target name + grouped tag pairs)."""
        rollup_op = None
        rollup_at = -1
        pre_ops: list[PipelineOp] = []
        for i, op in enumerate(target.pipeline):
            if op.type == PipelineOpType.ROLLUP:
                rollup_op, rollup_at = op, i
                break
            pre_ops.append(op)
        if rollup_op is None:
            return None, None

        def concrete_id(op: PipelineOp) -> bytes:
            grouped = {k: v for k, v in tags.items()
                       if k in op.rollup_group_by and k != b"__name__"}
            return new_rollup_id(op.rollup_new_name, grouped)

        rid = concrete_id(rollup_op)
        # keep the stages AFTER the first rollup (multi-stage pipelines,
        # ref: active_ruleset.go keeps the remainder in the applied
        # pipeline); later rollup ops get their IDs materialized now,
        # since only the matcher sees the source tags.
        post_ops: list[PipelineOp] = []
        for op in target.pipeline[rollup_at + 1:]:
            if op.type == PipelineOpType.ROLLUP:
                op = PipelineOp(
                    PipelineOpType.ROLLUP,
                    rollup_new_name=concrete_id(op),
                    rollup_group_by=op.rollup_group_by,
                    rollup_aggregation_id=op.rollup_aggregation_id)
            post_ops.append(op)
        meta = StagedMetadata(t_nanos, (PipelineMetadata(
            aggregation_id=rollup_op.rollup_aggregation_id,
            storage_policies=tuple(sorted(target.storage_policies)),
            pipeline=AppliedPipeline(tuple(pre_ops) + tuple(post_ops))),))
        return rid, meta


def _dedupe_pipelines(pipelines: list[PipelineMetadata]
                      ) -> list[PipelineMetadata]:
    seen, out = set(), []
    for p in pipelines:
        key = (p.aggregation_id, p.storage_policies, p.pipeline)
        if key not in seen:
            seen.add(key)
            out.append(p)
    return out
