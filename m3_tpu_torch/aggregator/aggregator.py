"""Aggregator: sharded streaming aggregation with rollup pipelines.

The reference's object graph — aggregator -> shard -> map -> Entry ->
elems with per-window lockedAggs
(ref: src/aggregator/aggregator/aggregator.go:156 Open :181 AddUntimed,
shard.go, map.go, entry.go:230 AddUntimed :360 addUntimed,
generic_elem.go:202 AddUnion :267 Consume, list.go:155/:296 Flush) —
becomes here:

- host-side lane resolution: (metric id, aggregation key) -> lane in a
  per-resolution `ElemPool` (m3_tpu_torch/aggregator/elems.py);
- one batched scatter kernel per resolution per ingest batch (the
  reference's per-entry mutexes + per-metric map lookups collapse into
  a dict lookup + one launch of kernel A1a on the pool's device);
- flush = gather expired window slots, ValueOf per aggregation type,
  apply pipeline transformations (with per-lane previous-window state,
  ref: generic_elem.go:460 processValueWithAggregationLock), then
  either emit (ref: list.go flush handler) or forward to the
  next-stage elem (ref: forwarded_writer.go, entry.go:279 AddForwarded).

Port of ``m3_tpu/aggregator/aggregator.py``; the pools live on the device
the caller names (default ``cuda``; ``device="cpu"`` runs the kernels'
plain versions).  The flush manager, the handlers and the transport wait
for the aggregator service (ROADMAP.md, queue 1 item 8).

Shard ownership follows the aggregator placement: metrics hash to
shards via murmur3 (ref: src/aggregator/sharding/shard_set.go) and an
instance only accepts metrics for shards it owns.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field

import numpy as np

from m3_tpu_torch.aggregator.elems import ElemPool, FlushedWindows
from m3_tpu_torch.metrics.pipeline import AppliedPipeline, PipelineOpType
from m3_tpu_torch.metrics.policy import StoragePolicy
from m3_tpu_torch.metrics.rules import DropPolicy, StagedMetadata
from m3_tpu_torch.ops.downsample import (DEFAULT_COUNTER_TYPES,
                                   DEFAULT_GAUGE_TYPES, DEFAULT_TIMER_TYPES,
                                   QUANTILE_OF_TYPE, AggregationType,
                                   Transformation)
from m3_tpu_torch.utils.device import resolve_device
from m3_tpu_torch.utils.hash import shard_for


class MetricKind(enum.IntEnum):
    """(ref: src/metrics/metric/types.go Type)."""

    COUNTER = 1
    TIMER = 2
    GAUGE = 3


DEFAULT_TYPES = {
    MetricKind.COUNTER: DEFAULT_COUNTER_TYPES,
    MetricKind.TIMER: DEFAULT_TIMER_TYPES,
    MetricKind.GAUGE: DEFAULT_GAUGE_TYPES,
}

# Suffix parity (ref: src/metrics/aggregation/type.go typeStringFor /
# default suffix rules): the kind's default single type gets no suffix.
_NO_SUFFIX = {
    (MetricKind.COUNTER, AggregationType.SUM),
    (MetricKind.GAUGE, AggregationType.LAST),
}


def suffix_for(kind: MetricKind, t: AggregationType) -> bytes:
    if (kind, t) in _NO_SUFFIX:
        return b""
    return b"." + t.name.lower().encode()


def apply_suffix(mid: bytes, suffix: bytes) -> bytes:
    """Append a type suffix to a metric ID.  For m3-format IDs
    (``m3+name+k=v,...``) the suffix goes on the NAME component so the
    ID still decodes into clean tags (ref: the coordinator appends
    aggregation-type suffixes to the name tag, downsample/
    metrics_appender.go + aggregation type suffixes in
    src/metrics/aggregation/type.go)."""
    if not suffix:
        return mid
    from m3_tpu_torch.metrics.id import M3_PREFIX
    if mid.startswith(M3_PREFIX):
        rest = mid[len(M3_PREFIX):]
        name, sep, pairs = rest.partition(b"+")
        return M3_PREFIX + name + suffix + sep + pairs
    return mid + suffix


@dataclass(frozen=True)
class AggregationKey:
    """One elem identity: where/now to aggregate one metric stream
    (ref: src/aggregator/aggregator/elem_base.go elemBase key)."""

    policy: StoragePolicy
    agg_types: tuple[AggregationType, ...]
    pipeline: AppliedPipeline = field(default_factory=AppliedPipeline)
    stage: int = 0  # numForwardedTimes (ref: applied pipeline metadata)


def _normalize_pipeline(types: tuple[AggregationType, ...],
                        pipeline: AppliedPipeline):
    """Fold a leading pipeline AGGREGATION op into the elem's own
    aggregation types (ref: generic_elem.go parsePipeline strips the
    leading aggregation op into the elem)."""
    ops = pipeline.ops
    while ops and ops[0].type == PipelineOpType.AGGREGATION:
        types = (ops[0].aggregation_type,)
        ops = tuple(ops[1:])
    return types, AppliedPipeline(ops)


@dataclass(frozen=True)
class AggregatedMetric:
    """Flush output record (ref: aggregated.MetricWithStoragePolicy)."""

    id: bytes
    time_nanos: int  # window END, the reference's flush timestamp
    value: float
    policy: StoragePolicy
    agg_type: AggregationType


class ErrShardNotOwned(Exception):
    pass


class _Lane:
    __slots__ = ("metric_id", "key", "kind", "tf_state")

    def __init__(self, metric_id: bytes, key: AggregationKey,
                 kind: MetricKind):
        self.metric_id = metric_id
        self.key = key
        self.kind = kind
        # per-pipeline-op transformation state across windows
        # (ref: generic_elem.go keeps prevValues per transformation)
        self.tf_state: dict[int, object] = {}


class MetricList:
    """All elems of one resolution (ref: list.go metricList)."""

    def __init__(self, resolution_nanos: int, device=None):
        self.resolution = resolution_nanos
        self.pool = ElemPool(resolution_nanos, device=device)
        self.lanes: dict[tuple[bytes, AggregationKey], int] = {}
        self.meta: list[_Lane] = []

    def lane_for(self, metric_id: bytes, key: AggregationKey,
                 kind: MetricKind) -> int:
        k = (metric_id, key)
        lane = self.lanes.get(k)
        if lane is None:
            lane = self.pool.alloc_lane()
            self.lanes[k] = lane
            self.meta.append(_Lane(metric_id, key, kind))
        return lane


@dataclass
class AggregatorOptions:
    num_shards: int = 64
    # windows are flushed once their end is <= now - buffer_past
    buffer_past_nanos: int = 0
    default_storage_policies: tuple[StoragePolicy, ...] = (
        StoragePolicy.parse("10s:2d"),)


class Aggregator:
    """(ref: aggregator.go:156). In-process, batched, device-backed."""

    def __init__(self, opts: AggregatorOptions | None = None,
                 owned_shards: set[int] | None = None,
                 forwarded_writer=None, device=None):
        self.opts = opts or AggregatorOptions()
        self.device = resolve_device(device)
        self.owned_shards = owned_shards  # None = own everything
        # routes rollup stage N+1 to the shard-owning instance
        # (ref: src/aggregator/aggregator/forwarded_writer.go); None
        # loops forwarded metrics back into this process
        self.forwarded_writer = forwarded_writer
        self.lists: dict[int, MetricList] = {}
        self._shard_memo: dict[bytes, int] = {}
        self.n_dropped_rules = 0
        self.n_invalid_pipelines = 0
        self.n_forwarded_remote = 0
        # pending forwarded adds generated during a flush pass
        self._fwd: list[tuple[MetricKind, bytes, float, int,
                              AggregationKey]] = []

    # -- ingest --------------------------------------------------------------

    def _shard_of(self, metric_id: bytes) -> int:
        # memoized: pure-Python murmur3 per sample would dominate hot
        # ingest (same fix as the storage ingest path).  Only OWNED ids
        # cache — they are bounded by the lanes map; caching rejected
        # (misrouted/sprayed) ids would grow without bound
        s = self._shard_memo.get(metric_id)
        if s is None:
            s = shard_for(metric_id, self.opts.num_shards)
            if self.owned_shards is None or s in self.owned_shards:
                self._shard_memo[metric_id] = s
        return s

    def _check_shard(self, metric_id: bytes):
        if self.owned_shards is None:
            return
        s = self._shard_of(metric_id)
        if s not in self.owned_shards:
            raise ErrShardNotOwned(f"shard {s} not owned")

    def _list(self, resolution: int) -> MetricList:
        lst = self.lists.get(resolution)
        if lst is None:
            lst = MetricList(resolution, self.device)
            self.lists[resolution] = lst
        return lst

    def add_untimed(self, kind: MetricKind, metric_id: bytes, value,
                    time_nanos: int,
                    metadatas: tuple[StagedMetadata, ...]) -> None:
        self.add_untimed_batch([(kind, metric_id, value, time_nanos,
                                 metadatas)])

    def add_untimed_batch(self, entries) -> None:
        """Batched ingest: resolve lanes host-side, one scatter kernel
        per touched resolution (replaces entry.go:360 addUntimed).

        entries: iterable of (kind, id, value-or-values, time_nanos,
        staged_metadatas)."""
        per_res: dict[int, tuple[list, list, list, list]] = {}
        for kind, metric_id, value, t, metadatas in entries:
            self._check_shard(metric_id)
            kind = MetricKind(kind)
            values = (value,) if isinstance(value, (int, float)) else value
            for staged in metadatas:
                for pm in staged.pipelines:
                    if pm.drop_policy == DropPolicy.MUST:
                        self.n_dropped_rules += len(values)
                        continue
                    types = (tuple(pm.aggregation_id.types())
                             if not pm.aggregation_id.is_default
                             else DEFAULT_TYPES[kind])
                    types, pipeline = _normalize_pipeline(types, pm.pipeline)
                    policies = (pm.storage_policies or
                                self.opts.default_storage_policies)
                    for pol in policies:
                        key = AggregationKey(pol, types, pipeline)
                        res = pol.resolution.window_nanos
                        lst = self._list(res)
                        lane = lst.lane_for(metric_id, key, kind)
                        # any quantile type needs the raw-sample
                        # reservoir (not just timers: rollup agg IDs may
                        # request quantiles on any kind)
                        needs_q = any(
                            t_ in QUANTILE_OF_TYPE for t_ in types)
                        b = per_res.setdefault(res, ([], [], [], []))
                        for v in values:
                            b[0].append(lane)
                            b[1].append(t)
                            b[2].append(float(v))
                            b[3].append(needs_q)
        for res, (lanes, times, vals, qmask) in per_res.items():
            self.lists[res].pool.update(
                np.asarray(lanes, dtype=np.int64),
                np.asarray(times, dtype=np.int64),
                np.asarray(vals, dtype=np.float64),
                np.asarray(qmask, dtype=bool))

    def add_forwarded(self, kind: MetricKind, metric_id: bytes,
                      value: float, window_start_nanos: int,
                      key: AggregationKey) -> None:
        """Next-stage ingest (ref: entry.go:279 AddForwarded). The value
        aggregates into the SAME aligned window as its source."""
        lst = self._list(key.policy.resolution.window_nanos)
        lane = lst.lane_for(metric_id, key, kind)
        needs_q = any(t in QUANTILE_OF_TYPE for t in key.agg_types)
        lst.pool.update(np.asarray([lane], dtype=np.int64),
                        np.asarray([window_start_nanos], dtype=np.int64),
                        np.asarray([value], dtype=np.float64),
                        timer_mask=np.asarray([needs_q]),
                        allow_late=True)

    # -- flush ---------------------------------------------------------------

    def flush_before(self, cutoff_nanos: int,
                     discard: bool = False) -> list[AggregatedMetric]:
        """Consume every window ending <= cutoff across all resolutions
        (ref: list.go:296 Flush -> :349 flushBefore).

        discard=True is the follower/takeover shadow pass: windows are
        consumed to keep state bounded but NOTHING leaves the process —
        in particular no remote forwarding (the leader already sent
        those; a follower double-send would double-count stage N+1)."""
        out: list[AggregatedMetric] = []
        for res in sorted(self.lists):
            out.extend(self._flush_list(self.lists[res], cutoff_nanos))
        # Forwarded metrics may land in already-swept lists; loop until
        # quiescent (multi-stage pipelines, bounded by pipeline depth).
        # Entries whose rollup id hashes to a shard this instance does
        # NOT own are routed to the owning instance instead
        # (ref: forwarded_writer.go, entry.go:279 AddForwarded).
        guard = 0
        while self._fwd and guard < 8:
            guard += 1
            pending, self._fwd = self._fwd, []
            # Locally-owned entries replay as ONE scatter per touched
            # resolution per pass (the add_untimed batching idiom) —
            # per-entry add_forwarded paid a device update per metric,
            # which dominated flush latency on deep rollup pipelines.
            per_res: dict[int, tuple[list, list, list, list]] = {}
            for kind, mid, val, start, key in pending:
                if discard or self._owns(mid) or self.forwarded_writer is None:
                    res = key.policy.resolution.window_nanos
                    lst = self._list(res)
                    lane = lst.lane_for(mid, key, kind)
                    needs_q = any(t in QUANTILE_OF_TYPE
                                  for t in key.agg_types)
                    b = per_res.setdefault(res, ([], [], [], []))
                    b[0].append(lane)
                    b[1].append(start)
                    b[2].append(float(val))
                    b[3].append(needs_q)
                else:
                    self.forwarded_writer.write(kind, mid, val, start, key)
                    self.n_forwarded_remote += 1
            for res, (lanes, times, vals, qmask) in per_res.items():
                self.lists[res].pool.update(
                    np.asarray(lanes, dtype=np.int64),
                    np.asarray(times, dtype=np.int64),
                    np.asarray(vals, dtype=np.float64),
                    timer_mask=np.asarray(qmask, dtype=bool),
                    allow_late=True)
            for res in sorted(self.lists):
                out.extend(self._flush_list(self.lists[res], cutoff_nanos))
        return out

    def _owns(self, metric_id: bytes) -> bool:
        if self.owned_shards is None:
            return True
        return self._shard_of(metric_id) in self.owned_shards

    def _flush_list(self, lst: MetricList,
                    cutoff: int) -> list[AggregatedMetric]:
        fw = lst.pool.flush_before(cutoff)
        if fw is None:
            return []
        # quantiles for timer lanes, one padded batch
        qorder: tuple[float, ...] = ()
        qvals = None
        needed = sorted({QUANTILE_OF_TYPE[t]
                         for i in fw.lanes
                         for t in lst.meta[i].key.agg_types
                         if t in QUANTILE_OF_TYPE})
        if needed:
            qorder = tuple(needed)
            qvals = lst.pool.timer_quantiles(fw, qorder)
        lst.pool.purge_timer_reservoir()
        out: list[AggregatedMetric] = []
        for row in range(fw.lanes.size):
            lane = int(fw.lanes[row])
            meta = lst.meta[lane]
            start = int(fw.starts[row])
            end = start + lst.resolution
            values = {
                t: self._value_of(fw, row, t, qvals, qorder)
                for t in meta.key.agg_types}
            ops = meta.key.pipeline.ops
            if not ops:
                for t, v in values.items():
                    out.append(AggregatedMetric(
                        apply_suffix(meta.metric_id,
                                     suffix_for(meta.kind, t)),
                        end, v, meta.key.policy, t))
                continue
            # pipeline: transformations then optional next-stage rollup
            points = [(end, values[meta.key.agg_types[0]])]
            i = 0
            while i < len(ops) and ops[i].type == PipelineOpType.TRANSFORMATION:
                points = self._transform(ops[i].transformation, meta, i,
                                         points)
                i += 1
            points = [(t, v) for t, v in points if not np.isnan(v)]
            if i < len(ops) and ops[i].type != PipelineOpType.ROLLUP:
                # malformed applied pipeline: never emit under a bogus id
                self.n_invalid_pipelines += 1
                continue
            if i < len(ops):  # ROLLUP -> forward to next stage
                op = ops[i]
                ntypes, npipe = _normalize_pipeline(
                    tuple(op.rollup_aggregation_id.types())
                    or (AggregationType.SUM,),
                    AppliedPipeline(tuple(ops[i + 1:])))
                nkey = AggregationKey(meta.key.policy, ntypes, npipe,
                                      meta.key.stage + 1)
                res = lst.resolution
                for t, v in points:
                    # boundary timestamps represent the *preceding*
                    # window; off-grid ones their containing window
                    ws = t - res if t % res == 0 else t - t % res
                    self._fwd.append((meta.kind, op.rollup_new_name, v,
                                      ws, nkey))
            else:
                for t, v in points:
                    out.append(AggregatedMetric(
                        meta.metric_id, t, v, meta.key.policy,
                        meta.key.agg_types[0]))
        return out

    @staticmethod
    def _value_of(fw: FlushedWindows, row: int, t: AggregationType,
                  qvals, qorder) -> float:
        """(ref: counter.go:107 ValueOf, gauge.go:112, timer.go:90)."""
        if t == AggregationType.LAST:
            return float(fw.last[row])
        if t == AggregationType.MIN:
            return float(fw.min[row])
        if t == AggregationType.MAX:
            return float(fw.max[row])
        if t == AggregationType.MEAN:
            c = fw.count[row]
            return float(fw.sum[row] / c) if c > 0 else 0.0
        if t == AggregationType.COUNT:
            return float(fw.count[row])
        if t == AggregationType.SUM:
            return float(fw.sum[row])
        if t == AggregationType.SUMSQ:
            return float(fw.sum_sq[row])
        if t == AggregationType.STDEV:
            n = fw.count[row]
            if n < 2:
                return 0.0
            var = (n * fw.sum_sq[row] - fw.sum[row] ** 2) / (n * (n - 1))
            return float(np.sqrt(max(var, 0.0)))
        if t in QUANTILE_OF_TYPE:
            if qvals is None:
                return 0.0
            return float(qvals[row, qorder.index(QUANTILE_OF_TYPE[t])])
        raise ValueError(f"unsupported aggregation type {t}")

    @staticmethod
    def _transform(tf: Transformation, meta: _Lane, op_idx: int,
                   points: list[tuple[int, float]]
                   ) -> list[tuple[int, float]]:
        """Streaming scalar mirrors of the device transforms
        (m3_tpu_torch/ops/downsample.py transform_*; ref:
        src/metrics/transformation/{unary,binary,unary_multi}.go).
        Binary transforms keep the previous *input* per op across
        windows (ref: generic_elem.go prevValues)."""
        st = meta.tf_state
        out: list[tuple[int, float]] = []
        for t, v in points:
            if tf == Transformation.ABSOLUTE:
                out.append((t, abs(v)))
            elif tf == Transformation.ADD:
                running = st.get(op_idx, 0.0) + (0.0 if np.isnan(v) else v)
                st[op_idx] = running
                out.append((t, running))
            elif tf in (Transformation.INCREASE, Transformation.PERSECOND):
                prev = st.get(op_idx)
                st[op_idx] = (v, t)
                if (prev is None or np.isnan(prev[0]) or np.isnan(v)
                        or prev[1] >= t or v < prev[0]):
                    out.append((t, np.nan))
                elif tf == Transformation.INCREASE:
                    out.append((t, v - prev[0]))
                else:
                    out.append((t, (v - prev[0]) /
                                ((t - prev[1]) / 1e9)))
            elif tf == Transformation.RESET:
                # value now, zero one second later (unary_multi.go:43-47)
                out.append((t, v))
                out.append((t + 1_000_000_000, 0.0))
            else:
                raise ValueError(f"unsupported transformation {tf}")
        return out
