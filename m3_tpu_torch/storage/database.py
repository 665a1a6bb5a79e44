"""Database: namespaces -> shards, write/fetch, tick/flush, bootstrap.

Port of ``m3_tpu/storage/database.py`` (``DatabaseOptions``, ``_Namespace``,
``Database``).  ``Database(opts, device=None)`` runs on ``cuda`` unless the
caller passes ``device="cpu"``: its shards seal blocks with E1 there and
its decoded-block cache decodes with K3 (their plain versions on the CPU).
These wait for later slices (ROADMAP.md queue 1 item 5), and ask for them
raises ``NotImplementedError``: the commit log (``commit_log_enabled``
must be False) with its WAL replay in ``bootstrap``, structured
namespaces (a ``NamespaceOptions.schema``), ``block_metadata`` (it needs
the peers module) and the ``Mediator`` background loop.

Mirrors storage.Database (ref: src/dbnode/storage/database.go:643 Write,
namespace.go:674, bootstrap chain SURVEY.md §3.1) minus the cluster
edge: shard routing is murmur3-exact with the reference
(ref: sharding/shardset.go:149), durability is snapshots + filesets
until the commit log is ported, and bootstrap replays filesets first
then snapshots — the fs bootstrapper of the reference's chain (ref:
src/dbnode/storage/bootstrap/bootstrapper/base.go:78).
"""

from __future__ import annotations

import dataclasses
import functools
import pathlib
import threading
import time
from collections import defaultdict

import numpy as np

from m3_tpu_torch import attribution
from m3_tpu_torch.cache import CacheOptions, DecodedBlockCache, SeekManager
from m3_tpu_torch.storage.fileset import (FilesetReader, FilesetWriter,
                                          list_fileset_volumes, list_filesets,
                                          remove_fileset)
from m3_tpu_torch.storage.index import IndexOptions, TagIndex
from m3_tpu_torch.storage.namespace import NamespaceOptions
from m3_tpu_torch.storage.shard import Shard
from m3_tpu_torch.utils import faultpoints, instrument, tracing
from m3_tpu_torch.utils.device import resolve_device
from m3_tpu_torch.utils.hash import shard_for

_log = instrument.logger("storage")

# m3_bootstrap_phase gauge codes (docs/observability.md): the restart
# state machine as plottable integers
_BOOTSTRAP_PHASES = {"idle": 0, "index": 1, "snapshots": 2,
                     "wal-replay": 3, "done": 4}


class ColdWriteError(ValueError):
    """Per-sample cold-write rejection (the reference's RWError analog,
    ingest/write.go BadRequestError): carries which batch indices were
    rejected and how many in-window samples were written, so callers can
    report partial success instead of blindly retrying the whole batch.
    Subclasses ValueError so existing 400-mapping handlers keep working.

    ``rejected_indices`` are positions in the ids/times/values lists of
    the ``write_batch`` call that raised — meaningful to DIRECT callers
    only.  Indirect paths that transform the batch first (the
    DownsamplerAndWriter's keep_raw filter, the insert queue's
    coalescing) would need their own index mapping; they should rely on
    the counts, not the indices."""

    def __init__(self, msg: str, rejected_indices, n_written: int):
        super().__init__(msg)
        self.rejected_indices = rejected_indices
        self.n_written = n_written


class ResourceExhaustedError(ValueError):
    """Transient server-side limit (new-series insert rate): the write
    may succeed on retry, so HTTP layers must map this to 429, never to
    400 (Prometheus drops batches on 4xx but honors 429 as retryable;
    the reference returns 429 for limit errors, x/net/http errors.go)."""


def _locked(fn):
    """Serialize a Database entry point on the instance lock."""
    @functools.wraps(fn)
    def wrapper(self, *args, **kwargs):
        with self._lock:
            return fn(self, *args, **kwargs)
    return wrapper


@dataclasses.dataclass(frozen=True)
class DatabaseOptions:
    # no default: two databases in one host must never share a directory
    path: str
    num_shards: int = 64
    # the reference's default; the port raises NotImplementedError on it
    # until the commit log is ported
    commit_log_enabled: bool = True
    # read-path cache settings (m3_tpu_torch.cache.CacheOptions): the
    # postings cache, the decoded-block cache (off by default) and the
    # seek manager's fileset reader pool (the WiredList analog — ref:
    # src/dbnode/storage/block/wired_list.go:77)
    cache: CacheOptions = dataclasses.field(default_factory=CacheOptions)
    # reverse-index tuning (storage.index.IndexOptions): background
    # segment compaction, segment-count bounds, daemon poll interval;
    # None takes the IndexOptions defaults (background compaction on)
    index: IndexOptions | None = None


class _Namespace:
    def __init__(self, opts: NamespaceOptions, db_opts: DatabaseOptions,
                 device):
        self.opts = opts
        self.index = TagIndex(
            postings_cache_capacity=db_opts.cache.postings_capacity,
            options=db_opts.index)
        self.shards = {
            s: Shard(s, opts, device=device)
            for s in range(db_opts.num_shards)
        }
        # lazily-built shard -> ordinals map, refreshed as the index
        # grows (avoids full-index scans per per-shard metadata call)
        self._shard_ordinals: dict[int, list[int]] = {}
        self._shard_ordinals_upto = 0
        # ordinal -> shard id memo, SPARSE: a dense list would force an
        # O(total-series) catch-up hash storm on the first write after
        # bootstrapping a large recovered index
        self._lane_shards: dict[int, int] = {}

    def shard_of(self, series_id: bytes) -> Shard:
        return self.shards[shard_for(series_id, len(self.shards))]

    def shard_of_lane(self, lane: int) -> int:
        """Shard id for an index ordinal, memoized — shard placement is
        a pure function of the series id, and the pure-Python murmur3
        dominates steady-state ingest when recomputed per sample."""
        s = self._lane_shards.get(lane)
        if s is None:
            s = self._lane_shards[lane] = shard_for(
                self.index.id_of(lane), len(self.shards))
        return s

    def ordinals_for_shard(self, shard_id: int) -> list[int]:
        n = len(self.index)
        while self._shard_ordinals_upto < n:
            o = self._shard_ordinals_upto
            # computed inline, NOT via shard_of_lane: this scan walks
            # every ordinal, and routing it through the memo would
            # densely materialize the dict the memo's sparseness exists
            # to avoid (its result already lives in _shard_ordinals)
            self._shard_ordinals.setdefault(
                shard_for(self.index.id_of(o), len(self.shards)),
                []).append(o)
            self._shard_ordinals_upto += 1
        return self._shard_ordinals.get(shard_id, [])


class Database:
    def __init__(self, opts: DatabaseOptions, device=None):
        self.opts = opts
        if self.opts.commit_log_enabled:
            raise NotImplementedError(
                "the commit log is not ported yet (ROADMAP.md queue 1 item "
                "5: it waits for test_wal_model_prop to be settled); pass "
                "DatabaseOptions(commit_log_enabled=False)")
        # shards seal (E1) and the decoded-block cache decodes (K3) here
        self.device = resolve_device(device)
        self.path = pathlib.Path(self.opts.path)
        self._namespaces: dict[str, _Namespace] = {}
        self._fileset_writer = FilesetWriter(self.path / "data")
        self._bootstrapping = False
        self._bootstrap_in_flight = False
        # graceful-restart drain flag: health surfaces report it so the
        # session/health layers stop routing before the process exits
        self._draining = False
        # bootstrap progress for /health + the rolling-restart gate
        self._bootstrap_progress: dict = {"phase": "idle",
                                          "entries_replayed": 0,
                                          "bytes_replayed": 0}
        self._open = True
        # serializes all state-touching entry points: serving threads
        # (DatabaseNode), background bootstrap/repair, flush loops
        # (the reference uses fine-grained per-shard locks; one RLock
        # is the honest equivalent for this structure)
        self._lock = threading.RLock()
        # read-path caches (m3_tpu_torch.cache): the seek manager pools open
        # fileset readers; the decoded-block cache serves warm reads
        # without M3TSZ decode under per-namespace series cache
        # policies.
        co = self.opts.cache
        self._seek = SeekManager(policy=co.seek_policy,
                                 capacity=co.seek_capacity,
                                 ttl_nanos=co.seek_ttl)
        self._decoded_cache = DecodedBlockCache(
            max_bytes=co.decoded_max_bytes,
            default_policy=co.decoded_policy,
            policies=co.decoded_policies,
            recently_read_ttl_nanos=co.recently_read_ttl,
            device=self.device)
        # per-subsystem counters (ref: x/instrument per-struct metrics);
        # tagged per instance — several Databases can share one process
        # (tests, embedded coordinator + dbnode) and must not clobber
        # each other's series
        db_tag = {"db": str(self.path)}
        self._m_samples = instrument.counter("m3_ingest_samples_total",
                                             **db_tag)
        self._m_series = instrument.gauge("m3_series_count", **db_tag)
        self._m_flush = instrument.counter("m3_flush_blocks_total", **db_tag)
        self._m_snapshot = instrument.counter("m3_snapshot_blocks_total",
                                              **db_tag)
        self._m_sealed = instrument.counter("m3_tick_sealed_blocks_total",
                                            **db_tag)
        # bootstrap/restart observability (warm-restart PR): phase is a
        # numeric code (see _BOOTSTRAP_PHASES) so dashboards can plot
        # the state machine; entries/bytes advance as WAL chunks replay
        self._m_bootstrap_phase = instrument.gauge("m3_bootstrap_phase",
                                                   **db_tag)
        self._m_bootstrap_entries = instrument.counter(
            "m3_bootstrap_entries_replayed_total", **db_tag)
        self._m_bootstrap_bytes = instrument.counter(
            "m3_bootstrap_bytes_replayed_total", **db_tag)
        self._m_bootstrap_seconds = instrument.histogram(
            "m3_bootstrap_seconds", **db_tag)

    # --- runtime options (hot-reloadable; ref: src/dbnode/runtime/
    #     runtime_options.go, kvconfig new-series insert limits) ---

    def set_runtime_options(self, opts) -> None:
        """Apply hot-reloaded options (RuntimeOptionsManager listener)."""
        self._runtime = opts
        rate = getattr(opts, "trace_sample_1_in", 0)
        if rate:
            tracing.set_sampling(rate)

    _runtime = None
    _new_series_sec = 0
    _new_series_count = 0

    def _check_new_series_limit(self, n_new: int) -> None:
        limit = getattr(self._runtime, "write_new_series_limit_per_sec", 0)
        if not limit or n_new == 0:
            return
        sec = time.monotonic_ns() // 1_000_000_000
        if sec != self._new_series_sec:
            self._new_series_sec = sec
            self._new_series_count = 0
        if self._new_series_count + n_new > limit:
            instrument.counter("m3_new_series_limited_total").inc(n_new)
            raise ResourceExhaustedError(
                f"new-series insert limit {limit}/s exceeded")
        self._new_series_count += n_new

    # --- admin ---

    @_locked
    def create_namespace(self, ns_opts: NamespaceOptions) -> None:
        if ns_opts.name in self._namespaces:
            raise ValueError(f"namespace {ns_opts.name} exists")
        if ns_opts.schema is not None:
            raise NotImplementedError(
                "structured namespaces are not ported yet (ROADMAP.md "
                "queue 1 item 5)")
        self._namespaces[ns_opts.name] = _Namespace(ns_opts, self.opts,
                                                    self.device)

    def namespaces(self) -> list[str]:
        return sorted(self._namespaces)

    def namespace_options(self, ns: str) -> NamespaceOptions:
        return self._ns(ns).opts

    def _ns(self, name: str) -> _Namespace:
        if name not in self._namespaces:
            raise KeyError(f"unknown namespace {name}")
        return self._namespaces[name]

    # --- write path (ref: database.go:643 -> namespace.go:674 ->
    #     shard.go:910) ---

    def write_batch(
        self,
        ns: str,
        ids: list[bytes],
        tags: list[dict[bytes, bytes]],
        times_nanos: list[int] | np.ndarray,
        values: list[float] | np.ndarray,
    ) -> None:
        """Row-wise write: one id/tags entry per sample.  Thin adapter
        over the columnar core (identity uniq mapping)."""
        self.write_columns(ns, ids, tags, times_nanos, values)

    @tracing.traced(tracing.DB_WRITE_BATCH)
    def write_columns(
        self,
        ns: str,
        uniq_ids: list[bytes],
        uniq_tags: list[dict[bytes, bytes]] | None,
        times_nanos: list[int] | np.ndarray,
        values: list[float] | np.ndarray,
        uniq_idx: np.ndarray | None = None,
    ) -> None:
        """Columnar write: ``uniq_ids``/``uniq_tags`` are per-SERIES
        tables; ``uniq_idx[i]`` names sample ``i``'s row (None =
        identity, one row per sample — the write_batch shape).  The
        caller hands over ownership of every argument: arrays and
        lists must not be mutated after the call."""
        self._write_columns_locked(
            ns, uniq_ids, uniq_tags, times_nanos, values, uniq_idx)

    @_locked
    def _write_columns_locked(
        self, ns, uniq_ids, uniq_tags, times_nanos, values, uniq_idx
    ) -> None:
        n = self._ns(ns)
        u = len(uniq_ids)
        # the O(batch) new-series scan only runs when a limit is SET
        # (a registered manager with default options must not tax the
        # hot ingest path)
        if (getattr(self._runtime, "write_new_series_limit_per_sec", 0)
                and not self._bootstrapping):
            n_new = sum(1 for sid in set(uniq_ids)
                        if n.index.ordinal(sid) is None)
            self._check_new_series_limit(n_new)
        times_nanos = np.asarray(times_nanos, dtype=np.int64)
        values = np.asarray(values, dtype=np.float64)
        if uniq_idx is not None:
            uniq_idx = np.asarray(uniq_idx, dtype=np.int64)
        bsize = n.opts.retention.block_size
        if (not n.opts.cold_writes_enabled and len(times_nanos)
                and not self._bootstrapping):
            # reference posture: without cold writes, a sample must land
            # inside [now - buffer_past, now + buffer_future] or the
            # currently-open block (namespace/types.go ColdWritesEnabled;
            # storage/shard.go write-window checks).  Rejection is
            # PER SAMPLE like the reference: in-window samples in the
            # same batch still land, then the caller gets the error.
            now = time.time_ns()
            ok = n.opts.retention.writable_mask(times_nanos, now)
            if not ok.all():
                n_bad = int((~ok).sum())
                bad = int(times_nanos[~ok][0])
                instrument.counter("m3_cold_writes_rejected_total").inc(
                    n_bad)
                n_written = 0
                if ok.any():
                    sel = np.flatnonzero(ok)
                    if uniq_idx is None:
                        keep = sel
                        sub_idx = None
                    else:
                        # compact the uniq table to surviving rows so a
                        # series whose every sample was rejected never
                        # enters the index (matches the row-wise path)
                        keep, sub_idx = np.unique(uniq_idx[sel],
                                                  return_inverse=True)
                        keep = keep.tolist()
                    self._write_columns_locked(
                        ns, [uniq_ids[i] for i in keep],
                        ([uniq_tags[i] for i in keep]
                         if uniq_tags is not None else None),
                        times_nanos[sel], values[sel], sub_idx)
                    n_written = len(sel)
                raise ColdWriteError(
                    f"cold write rejected (cold_writes_enabled=false): "
                    f"{n_bad} sample(s) outside the write window, e.g. "
                    f"t={bad} around now={now}; {n_written} in-window "
                    "sample(s) in this batch were written",
                    rejected_indices=np.flatnonzero(~ok).tolist(),
                    n_written=n_written)
        block_starts = times_nanos - times_nanos % bsize
        # per-UNIQUE-series Python (index insert + shard routing are
        # dict-backed and irreducibly per-object); everything per-sample
        # below this loop is numpy
        lanes_u = np.empty(u, dtype=np.int64)
        shards_u = np.empty(u, dtype=np.int64)
        insert = n.index.insert
        shard_of_lane = n.shard_of_lane
        idx_before = len(n.index)  # new-series delta for attribution
        if uniq_tags is None:
            for i, sid in enumerate(uniq_ids):
                lane = insert(sid, {})
                lanes_u[i] = lane
                shards_u[i] = shard_of_lane(lane)
        else:
            for i, (sid, tg) in enumerate(zip(uniq_ids, uniq_tags)):
                lane = insert(sid, tg)
                lanes_u[i] = lane
                shards_u[i] = shard_of_lane(lane)
        if uniq_idx is None:
            lanes, shard_ids = lanes_u, shards_u
        else:
            lanes, shard_ids = lanes_u[uniq_idx], shards_u[uniq_idx]
        n_samples = len(times_nanos)
        if n_samples:
            # activity marking per unique (lane, block) pair, not per
            # sample — same end state, batch-sized fewer dict probes
            pairs = np.unique(
                np.stack([lanes, block_starts], axis=1), axis=0)
            mark = n.index.mark_active
            for lane, bs in pairs.tolist():
                mark(lane, bs)
            # shard dispatch: one stable sort + group boundaries, so
            # each shard gets a single contiguous slice per batch
            order = np.argsort(shard_ids, kind="stable")
            s_sorted = shard_ids[order]
            l_sorted = lanes[order]
            t_sorted = times_nanos[order]
            v_sorted = values[order]
            bounds = np.flatnonzero(np.diff(s_sorted)) + 1
            grp_starts = np.concatenate(([0], bounds))
            grp_ends = np.concatenate((bounds, [n_samples]))
            for a, b in zip(grp_starts.tolist(), grp_ends.tolist()):
                n.shards[int(s_sorted[a])].write_batch(
                    l_sorted[a:b], t_sorted[a:b], v_sorted[a:b])
            if len(self._decoded_cache):
                # writes into an open block shadow the fileset copy on
                # the read path already (_overlapping_filesets);
                # dropping the decoded entries eagerly keeps the byte
                # budget honest and the staleness guarantee checkable
                inv = np.unique(
                    np.stack([shard_ids, block_starts], axis=1), axis=0)
                for s, bs in inv.tolist():
                    self._decoded_cache.invalidate_block(ns, s, bs)
        self._m_samples.inc(n_samples)
        self._m_series.set(sum(len(x.index) for x in
                               self._namespaces.values()))
        if attribution.enabled():
            # per-BATCH attribution: tenant rides the trace baggage
            # from the originating edge; namespace is the fallback
            # (e.g. the insert-queue drain thread)
            n_new = len(n.index) - idx_before
            tenant = tracing.current_tenant() or ns
            attribution.account_write(tenant, samples=n_samples,
                                      new_series=n_new)
            if n_new and uniq_tags is not None:
                # new lanes are assigned past the pre-insert ordinal
                # watermark; offer their label NAMES to the
                # cardinality-offender sketch
                for i in np.flatnonzero(lanes_u >= idx_before).tolist():
                    attribution.note_label_keys(uniq_tags[i].keys())

    def write(self, ns: str, series_id: bytes, tags, t_nanos: int, value: float):
        self.write_batch(ns, [series_id], [tags], [t_nanos], [value])

    # --- read path ---

    @_locked
    def query_ids(
        self,
        ns: str,
        matchers,
        start_nanos: int | None = None,
        end_nanos: int | None = None,
        limits=None,
        meta=None,
    ) -> list[bytes]:
        n = self._ns(ns)
        ords = n.index.query_conjunction(
            matchers, start_nanos, end_nanos, n.opts.retention.block_size,
            limits=limits, meta=meta,
        )
        return [n.index.id_of(o) for o in ords]

    @_locked
    def fetch_series(
        self, ns: str, series_id: bytes, start_nanos: int, end_nanos: int,
        _filesets: list[tuple[int, int]] | None = None,
    ) -> list[tuple[int, object]]:
        """All (block_start, payload) for one series: flushed filesets,
        sealed in-memory blocks, open buffers.  `_filesets` lets bulk
        callers (block_metadata) glob the shard directory once."""
        n = self._ns(ns)
        lane = n.index.ordinal(series_id)
        shard = n.shard_of(series_id)
        out: list[tuple[int, object]] = []
        # flushed filesets first (oldest data)
        for bs, reader in self._overlapping_filesets(
                ns, n, shard, start_nanos, end_nanos, _filesets):
            blob = reader.read(series_id)
            if blob:
                out.append((bs, blob))
        if lane is not None:
            out.extend(shard.read_series(series_id, lane, start_nanos, end_nanos))
        return sorted(out, key=lambda p: p[0])

    def _overlapping_filesets(self, ns: str, n, shard, start_nanos: int,
                              end_nanos: int, filesets=None):
        """Yield (block_start, reader) for flushed filesets overlapping
        [start, end) and not shadowed by an in-memory copy — the ONE
        implementation of the read path's block-selection rules, shared
        by single-series and fan-out fetches."""
        mem_blocks = (set(shard.sealed_block_starts())
                      | set(shard.open_block_starts()))
        if filesets is None:
            filesets = list_filesets(self.path / "data", ns,
                                     shard.shard_id)
        bsize = n.opts.retention.block_size
        for bs, vol in filesets:
            if not (start_nanos < bs + bsize and bs < end_nanos):
                continue
            if bs in mem_blocks:
                continue  # memory copy wins (not yet evicted)
            yield bs, self._cached_reader(ns, shard.shard_id, bs, vol)

    @property
    def _reader_cache(self):
        """The seek manager's pool (len()-compatible view kept for
        callers/tests that sized the pre-subsystem OrderedDict)."""
        return self._seek

    def _cached_reader(self, ns: str, shard_id: int, bs: int,
                       vol: int) -> FilesetReader:
        """Pooled fileset reader via the seek manager (ref: persist/
        fs/seek_manager.go): repeated reads skip digest validation +
        index parse.  Superseded volumes are unreachable by key (vol
        is part of it)."""
        return self._seek.acquire(
            (ns, shard_id, bs, vol),
            lambda: FilesetReader(self.path / "data", ns, shard_id,
                                  bs, vol))

    # NOTE: @traced sits OUTSIDE @_locked on both entry points so span
    # durations consistently include lock-wait (contention is exactly
    # what the tracepoints exist to expose).
    @tracing.traced(tracing.DB_FETCH_TAGGED)
    @_locked
    def fetch_tagged(
        self, ns: str, matchers, start_nanos: int, end_nanos: int,
        with_counts: bool = False, limits=None, meta=None,
    ) -> dict[bytes, list[tuple]]:
        """Index query + per-series block fetch — FetchTagged
        (ref: tchannelthrift/node/service.go:614).  The index query is
        time-pruned to blocks overlapping [start, end).

        ``with_counts=True`` (the engine's batch-decode path) emits
        (block_start, payload, n_dp_or_None) triples — v2 filesets
        carry per-stream datapoint counts, letting the reader size its
        decode grid without a count pass.  Default keeps the public
        2-tuple shape (TCP RPC / session compatibility).

        ``limits``/``meta`` (storage.limits) bound the fetch: time
        range clamped at admission, matched series truncated at the
        index lookup, and the block-fetch loop stops once the
        datapoint budget is spent — each either truncate-with-warning
        (recorded in ``meta``) or, under require-exhaustive, a
        QueryLimitExceeded abort.  The per-query deadline is checked
        between shards so a huge fan-out cannot overstay its budget
        while holding the fetch thread."""
        if limits is not None:
            start_nanos = limits.clamp_time_range(
                start_nanos, end_nanos, meta)
        sids = self.query_ids(ns, matchers, start_nanos, end_nanos,
                              limits=limits, meta=meta)
        limit = getattr(self._runtime, "max_fetch_series", 0)
        if limit and len(sids) > limit:
            raise ValueError(
                f"query matched {len(sids)} series > limit {limit}")
        if meta is not None:
            meta.fetched_series += len(sids)
        # batch by (shard, fileset): glob each shard's directory once
        # per query and bulk-read every matched series from a fileset in
        # one pass (dict-lookup seek index) — at 50k-series fan-outs the
        # per-series read stack (bloom + bisect + call overhead, ~60k
        # calls for a 6h query) dominated host-side fetch cost
        n = self._ns(ns)
        out: dict[bytes, list[tuple[int, object]]] = {
            sid: [] for sid in sids}
        by_shard: dict[int, list[tuple[bytes, int | None]]] = {}
        for sid in sids:
            # matched sids are indexed: route via the lane memo instead
            # of recomputing pure-Python murmur3 per sid; the lane rides
            # along so the buffer-read loop skips a second lookup
            lane = n.index.ordinal(sid)
            shard_id = (n.shard_of_lane(lane) if lane is not None
                        else n.shard_of(sid).shard_id)
            by_shard.setdefault(shard_id, []).append((sid, lane))
        def _ndp(entry) -> int:
            # (bs, payload[, n_dp]) -> datapoint count; blobs without a
            # stored count are estimated at ~2 bytes/sample (m3tsz
            # averages ~1.4B/sample, so this undercounts conservatively
            # rather than rejecting queries early)
            payload = entry[1]
            if len(entry) > 2 and entry[2] is not None:
                return int(entry[2])
            if isinstance(payload, (bytes, bytearray, memoryview)):
                return max(1, len(payload) // 2)
            return len(payload[0])

        dp_fetched = 0
        # series cache policy for this namespace: anything but "none"
        # routes v2 fileset reads through the decoded-block cache so a
        # warm repeat serves device-ready (times, values) arrays with
        # zero M3TSZ decode work
        dec_policy = self._decoded_cache.policy_for(ns)
        for shard_id, shard_sids in by_shard.items():
            if limits is not None:
                limits.check_deadline("block fetch")
                if limits.datapoints_exceeded(dp_fetched, meta):
                    break  # budget spent: remaining shards truncated
            shard = n.shards[shard_id]
            only_sids = [sid for sid, _lane in shard_sids]
            for bs, reader in self._overlapping_filesets(
                    ns, n, shard, start_nanos, end_nanos):
                if with_counts:
                    blobs, dps = reader.read_batch_with_counts(
                        only_sids, zero_copy=True)
                    if dec_policy != "none":
                        decoded = self._decoded_cache.get_or_decode(
                            ns, shard.shard_id, bs, reader.volume,
                            dec_policy, only_sids, blobs, dps)
                        for sid, dec in zip(only_sids, decoded):
                            if dec is not None:
                                out[sid].append((bs, dec, len(dec[0])))
                    else:
                        for sid, blob, n_dp in zip(only_sids, blobs,
                                                   dps):
                            if blob:
                                out[sid].append((bs, blob, n_dp))
                else:
                    for sid, blob in zip(only_sids,
                                         reader.read_batch(only_sids)):
                        if blob:
                            out[sid].append((bs, blob))
            for sid, lane in shard_sids:
                if lane is not None:
                    out[sid].extend(shard.read_series(
                        sid, lane, start_nanos, end_nanos,
                        with_counts=with_counts))
                out[sid].sort(key=lambda p: p[0])
            if limits is not None and limits.max_fetched_datapoints:
                # sids are partitioned by shard, so summing this
                # shard's sids counts each entry exactly once
                dp_fetched += sum(
                    _ndp(e) for sid, _lane in shard_sids
                    for e in out[sid])
        if meta is not None:
            meta.fetched_datapoints += dp_fetched
        if attribution.enabled():
            # per-QUERY attribution (one pass over the result table,
            # never per sample): datapoints scanned + bytes decoded,
            # credited to the propagated tenant (fan-out RPC work) or
            # the namespace
            dps = 0
            nbytes = 0
            for entries in out.values():
                for e in entries:
                    dps += _ndp(e)
                    p = e[1]
                    if isinstance(p, (bytes, bytearray, memoryview)):
                        nbytes += len(p)
                    else:  # decoded (times, values) array pair
                        nbytes += (getattr(p[0], "nbytes", 0)
                                   + getattr(p[1], "nbytes", 0))
            attribution.account_read(tracing.current_tenant() or ns,
                                     datapoints=dps,
                                     decoded_bytes=nbytes)
        return out

    # --- lifecycle (ref: storage/mediator.go tick+flush loops) ---

    @_locked
    def load_batch(self, ns: str, ids, tags, times_nanos, values) -> None:
        """Row-wise load: one id/tags entry per sample.  Thin adapter
        over :meth:`load_columns` (identity uniq mapping)."""
        self.load_columns(ns, ids, tags, times_nanos, values, None)

    @_locked
    def load_columns(self, ns: str, uniq_ids, uniq_tags, times_nanos,
                     values, uniq_idx=None) -> None:
        """Write without the commit log — peer-bootstrap / repair loads
        of already-replicated data (ref: bootstrap result loads skip
        the WAL, storage/bootstrap data accumulators).  Columnar shape
        matches :meth:`write_columns`: per-SERIES uniq tables plus a
        per-sample row index (None = identity).

        Loads that touch sealed or flushed blocks first UNSEAL them
        back into open buffers so the points merge instead of
        shadowing: the next tick re-seals and the next flush writes a
        new fileset volume (ref: the cold-flush merger rewriting
        merged block filesets, persist/fs/merger.go)."""
        n = self._ns(ns)
        bsize = n.opts.retention.block_size
        times_arr = np.asarray(times_nanos, dtype=np.int64)
        if len(times_arr):
            num_shards = len(n.shards)
            shards_u = np.fromiter(
                (shard_for(sid, num_shards) for sid in uniq_ids),
                dtype=np.int64, count=len(uniq_ids))  # per-series work
            shard_ids = (shards_u if uniq_idx is None
                         else shards_u[np.asarray(uniq_idx, np.int64)])
            bss = times_arr - times_arr % bsize
            pairs = np.unique(np.stack([shard_ids, bss], axis=1), axis=0)
            for s, bs in pairs.tolist():
                self._unseal_for_load(ns, n, n.shards[int(s)], int(bs))
        was = self._bootstrapping
        self._bootstrapping = True
        try:
            self.write_columns(ns, uniq_ids, uniq_tags, times_arr,
                               values, uniq_idx)
        finally:
            self._bootstrapping = was

    def _unseal_for_load(self, ns: str, n, shard, bs: int) -> None:
        lane_of = lambda sid: n.index.insert(sid, {})  # noqa: E731
        if shard.unseal(bs, lane_of):
            self._decoded_cache.invalidate_block(ns, shard.shard_id, bs)
            return
        if bs in shard.open_block_starts():
            return  # already an open buffer: merges naturally
        # flushed-on-disk only (e.g. after a restart): pull the fileset
        # contents into a buffer and supersede it with the next volume
        on_disk = dict(list_filesets(self.path / "data", ns,
                                     shard.shard_id))
        if bs not in on_disk:
            return
        vol = on_disk[bs]
        reader = FilesetReader(self.path / "data", ns, shard.shard_id,
                               bs, vol)
        self._load_reader_into_buffers(n, shard, reader, bs)
        shard._volume[bs] = vol + 1
        # flush-version bump: volume vol is superseded, its decoded
        # entries must never serve again
        self._decoded_cache.invalidate_block(ns, shard.shard_id, bs)

    def _load_reader_into_buffers(self, n, shard, reader, bs: int) -> int:
        """Decode every series of one fileset/snapshot reader into the
        shard's open buffer (indexing as it goes); returns rows loaded.

        Decodes ALL streams in one batched call on the database's
        device (K3, with a scalar fallback per flagged lane) — the
        per-series scalar decode this replaces made warm bootstrap
        O(samples) of Python and slower than cold WAL replay at scale."""
        from m3_tpu_torch.ops.m3tsz_decode import decode_streams_adaptive

        sids, tgs, blobs = [], [], []
        for sid, tg in zip(reader.ids, reader.tags):  # per-series
            blob = reader.read(sid)
            if not blob:
                continue
            sids.append(sid)
            tgs.append(tg)
            blobs.append(blob)
        if not sids:
            return 0
        ts, vs, valid = decode_streams_adaptive(blobs, device=self.device)
        lanes = n.index.insert_batch(sids, tgs)
        n.index.mark_active_batch(lanes, bs)
        counts = valid.sum(axis=1).astype(np.int64)
        # row-major masking keeps each lane's samples contiguous and
        # in stream order, matching the repeated lane column
        shard.write_batch(np.repeat(lanes, counts),
                          np.asarray(ts[valid], dtype=np.int64),
                          np.asarray(vs[valid], dtype=np.float64))
        return int(counts.sum())

    @_locked
    def series_streams_for_block(self, ns: str, block_start: int
                                 ) -> list[tuple[bytes, dict, bytes]]:
        """[(sid, tags, compressed_stream)] for every series with a
        sealed/flushed copy of the block — the AggregateTiles input
        gather (ref: shard.go:2659 reads flushed source blocks).  Runs
        under the database lock (the lazy shard-ordinal cache must not
        race serving writes) and globs each shard directory once."""
        n = self._ns(ns)
        out = []
        for shard_id in sorted(n.shards):
            filesets = list_filesets(self.path / "data", ns, shard_id)
            for ordinal in n.ordinals_for_shard(shard_id):
                sid = n.index.id_of(ordinal)
                for b, payload in self.fetch_series(
                        ns, sid, block_start, block_start + 1,
                        _filesets=filesets):
                    if b != block_start:
                        continue
                    if isinstance(payload, (bytes, bytearray)):
                        out.append((sid, n.index.tags_of(ordinal),
                                    bytes(payload)))
        return out

    @_locked
    def drop_shard(self, ns: str, shard_id: int) -> dict:
        """Free all local data for one shard — the donor's drain step
        after cutover (ref: the reference's shard cleanup once a
        LEAVING copy's receiver goes AVAILABLE).  Open buffers and
        sealed blocks are discarded, flushed filesets (and snapshots)
        are deleted, and the read caches are invalidated so a stale
        reader cannot serve the freed copy.  Index entries remain (the
        series may still live on other shards of other nodes; reads of
        the dropped shard simply find no blocks).

        Caveat: commit-log entries for the shard are NOT rewritten; a
        restart before the WAL rotates can resurrect the data, and the
        next placement pass will not re-drain it (the reconciler's
        held-shard tracking starts from the post-restart placement).
        Anti-entropy repair never re-spreads it — the shard is no
        longer in this node's placement entry.

        Returns ``{"blocks": freed_blocks, "bytes": freed_file_bytes}``.
        """
        n = self._ns(ns)
        shard = n.shards[shard_id]
        blocks = set(shard.sealed_block_starts()) | set(
            shard.open_block_starts())
        freed_bytes = 0
        for root in (self.path / "data", self.path / "snapshot"):
            for bs, vol in list_fileset_volumes(root, ns, shard_id):
                blocks.add(bs)
                d = pathlib.Path(root) / ns / str(shard_id)
                for f in d.glob(f"fileset-{bs}-{vol}-*.db"):
                    try:
                        freed_bytes += f.stat().st_size
                    except OSError:
                        pass
                remove_fileset(root, ns, shard_id, bs, vol)
        for bs in blocks:
            self._decoded_cache.invalidate_block(ns, shard_id, bs)
        self._seek.invalidate_where(
            lambda key: key[0] == ns and key[1] == shard_id)
        n.shards[shard_id] = Shard(shard_id, n.opts, device=self.device)
        return {"blocks": len(blocks), "bytes": freed_bytes}

    @_locked
    def tick(self, now_nanos: int | None = None) -> dict[str, list[int]]:
        now_nanos = now_nanos if now_nanos is not None else time.time_ns()
        sealed = defaultdict(list)
        for name, n in self._namespaces.items():
            ids = n.index._ids
            for shard in n.shards.values():
                sealed[name].extend(shard.tick(now_nanos, ids))
            # sealed blocks take no more writes: freeze their activity
            # sets; expire index time-slices past retention
            self._m_sealed.inc(len(sealed[name]))
            for bs in set(sealed[name]):
                n.index.freeze_block(bs)
            if n.opts.cleanup_enabled:
                n.index.drop_blocks_before(
                    now_nanos - n.opts.retention.retention_period,
                    n.opts.retention.block_size,
                )
        return dict(sealed)

    @_locked
    def flush(self) -> dict[str, list[int]]:
        faultpoints.check("flush.begin")
        flushed = defaultdict(list)
        for name, n in self._namespaces.items():
            if not n.opts.flush_enabled:
                continue

            def tags_of(sid, n=n):
                return n.index.tags_of(n.index.ordinal(sid))

            for shard in n.shards.values():
                flushed[name].extend(
                    shard.flush(self._fileset_writer, name, tags_of)
                )
            if flushed[name]:
                faultpoints.check("flush.index_persist")
                # persist the index snapshot alongside the filesets it
                # covers, so restart mmaps segments instead of
                # re-reading every fileset's metadata
                covered = [
                    [shard_id, bs, vol]
                    for shard_id in n.shards
                    for bs, vol in list_filesets(
                        self.path / "data", name, shard_id
                    )
                ]
                n.index.persist(self.path / "index" / name, covered)
        total = sum(len(v) for v in flushed.values())
        if total:
            self._m_flush.inc(total)
            _log.info("flushed blocks", blocks=total)
            faultpoints.check("flush.cleanup")
            # warm-flushed blocks obsolete their snapshots
            self._cleanup_filesets()
        return dict(flushed)

    @_locked
    def snapshot(self) -> dict[str, list[int]]:
        """Snapshot filesets: persist every block whose ONLY durability
        is the WAL (open buffers + sealed-unflushed blocks), then drop
        the WAL files the snapshot covers — crash recovery becomes
        snapshot load + WAL-tail replay instead of unbounded full
        replay (ref: src/dbnode/storage/flush.go:206 dataSnapshot,
        persist/fs/snapshot_metadata_write.go, storage/cleanup.go).

        Only namespaces with ``snapshot_enabled`` participate.  The
        port has no commit log yet, so there is no WAL to rotate or
        drop: a snapshot is the only durability of unflushed blocks.
        """
        faultpoints.check("snapshot.begin")
        writer = FilesetWriter(self.path / "snapshot")
        done = defaultdict(list)
        for name, n in self._namespaces.items():
            if not n.opts.snapshot_enabled:
                continue
            ids = n.index._ids
            lane_of = n.index.ordinal
            for shard in n.shards.values():
                volumes = dict(list_filesets(self.path / "snapshot", name,
                                             shard.shard_id))
                for bs, (sids, streams) in shard.snapshot_pending(
                        ids, lane_of).items():
                    writer.write(
                        name, shard.shard_id, bs, sids, streams,
                        volume=volumes.get(bs, -1) + 1,
                        block_size=n.opts.retention.block_size,
                        tags=[n.index.tags_of(n.index.ordinal(s))
                              for s in sids],
                    )
                    done[name].append(bs)
        faultpoints.check("snapshot.cleanup")
        self._cleanup_filesets()
        total = sum(len(v) for v in done.values())
        if total:
            self._m_snapshot.inc(total)
            _log.info("snapshot", blocks=total)
        return dict(done)

    def _cleanup_filesets(self) -> None:
        """Drop superseded snapshot/data volumes and snapshots of
        blocks whose state is on disk in a data fileset (the warm flush
        supersedes them) — ref: src/dbnode/storage/cleanup.go."""
        for name, n in self._namespaces.items():
            for shard in n.shards.values():
                flushed = dict(list_filesets(self.path / "data", name,
                                             shard.shard_id))
                latest = dict(list_filesets(self.path / "snapshot", name,
                                            shard.shard_id))
                # memory still holds WAL-only data for these blocks
                pending_mem = set(shard.open_block_starts()) | {
                    bs for bs in shard.sealed_block_starts()
                    if bs not in shard._flushed
                }
                for bs, vol in list_fileset_volumes(
                        self.path / "snapshot", name, shard.shard_id):
                    obsolete = vol < latest.get(bs, -1) or (
                        bs in flushed and bs not in pending_mem
                    )
                    if obsolete:
                        faultpoints.check("cleanup.remove_snapshot")
                        remove_fileset(self.path / "snapshot", name,
                                       shard.shard_id, bs, vol)
                # superseded data volumes (unseal-merge re-flushes)
                for bs, vol in list_fileset_volumes(
                        self.path / "data", name, shard.shard_id):
                    if vol < flushed.get(bs, -1):
                        faultpoints.check("cleanup.remove_data")
                        remove_fileset(self.path / "data", name,
                                       shard.shard_id, bs, vol)

    def bootstrap(self) -> int:
        """fs bootstrapper: flushed blocks stay on disk and are served from
        filesets; snapshots load into buffers.  Returns datapoints
        recovered.  (The commitlog bootstrapper's WAL replay waits for
        the commit log's port.)

        The readiness flag flips OUTSIDE the db lock so health probes
        (node ``health`` RPC, coordinator ``/health``) can report
        bootstrap-in-flight without blocking on the lock bootstrap
        holds — readiness surfaces answer 503 instead of hanging.
        """
        self._bootstrap_in_flight = True
        try:
            faultpoints.check("db.bootstrap")
            return self._bootstrap_locked()
        finally:
            self._bootstrap_in_flight = False

    @property
    def bootstrap_in_flight(self) -> bool:
        return self._bootstrap_in_flight

    @property
    def bootstrapped(self) -> bool:
        """False only while ``bootstrap()`` is in flight — a node
        serving a store it never needed to bootstrap is still ready."""
        return not self._bootstrap_in_flight

    @property
    def bootstrap_progress(self) -> dict:
        """{"phase", "entries_replayed", "bytes_replayed"} — read
        lock-free by health surfaces while bootstrap holds the db
        lock."""
        return dict(self._bootstrap_progress)

    def _set_bootstrap_phase(self, phase: str) -> None:
        self._bootstrap_progress["phase"] = phase
        self._m_bootstrap_phase.set(_BOOTSTRAP_PHASES.get(phase, 0))

    @_locked
    def _bootstrap_locked(self) -> int:
        t0 = time.perf_counter()
        self._bootstrap_progress.update(entries_replayed=0,
                                        bytes_replayed=0)
        self._set_bootstrap_phase("index")
        recovered = 0
        # index bootstrap: mmap the persisted index snapshot, then the
        # fs index pass reads ONLY filesets the snapshot doesn't cover
        # (the reference's fs bootstrapper index pass; with snapshots
        # a restart avoids the full metadata rebuild)
        for name, n in self._namespaces.items():
            covered = {
                tuple(c) for c in n.index.load(self.path / "index" / name)
            }
            for shard in n.shards.values():
                for bs, vol in list_filesets(self.path / "data", name, shard.shard_id):
                    if (shard.shard_id, bs, vol) in covered:
                        continue
                    reader = FilesetReader(
                        self.path / "data", name, shard.shard_id, bs, vol
                    )
                    if reader.ids:
                        lanes = n.index.insert_batch(reader.ids,
                                                     reader.tags)
                        n.index.mark_active_batch(lanes, bs)
        # snapshot pass: blocks whose only durability was a snapshot
        # load into buffers; blocks with BOTH a fileset and a newer
        # snapshot (late writes) merge via the unseal path so the next
        # flush writes a superseding volume (the cold-flush merge,
        # ref: persist/fs/merger.go)
        self._set_bootstrap_phase("snapshots")
        recovered += self._bootstrap_snapshots()
        self._set_bootstrap_phase("done")
        self._m_bootstrap_seconds.observe(time.perf_counter() - t0)
        return recovered

    def _bootstrap_snapshots(self) -> int:
        """Load snapshot filesets written by `snapshot()`.  Returns
        datapoints recovered."""
        recovered = 0
        snap_root = self.path / "snapshot"
        for name, n in self._namespaces.items():
            for shard in n.shards.values():
                on_disk = dict(list_filesets(self.path / "data", name,
                                             shard.shard_id))
                for bs, vol in list_filesets(snap_root, name, shard.shard_id):
                    try:
                        reader = FilesetReader(snap_root, name,
                                               shard.shard_id, bs, vol)
                    except (FileNotFoundError, ValueError):
                        continue
                    if bs in on_disk:
                        # block has BOTH a data fileset and a snapshot:
                        # merge, loading the OLDER artifact first so
                        # last-write-wins favors the newer one (a stale
                        # snapshot left by a crash mid-cleanup must not
                        # resurrect overwritten values; a post-flush
                        # cold-write snapshot must win)
                        data_reader = FilesetReader(
                            self.path / "data", name, shard.shard_id,
                            bs, on_disk[bs])
                        snap_at = reader.info.get("written_at", 0)
                        data_at = data_reader.info.get("written_at", 0)
                        if snap_at <= data_at:
                            # stale snapshot: load it first, newer
                            # fileset last (last-write-wins)
                            recovered += self._load_reader_into_buffers(
                                n, shard, reader, bs)
                            self._load_reader_into_buffers(
                                n, shard, data_reader, bs)
                            shard._volume[bs] = on_disk[bs] + 1
                            self._decoded_cache.invalidate_block(
                                name, shard.shard_id, bs)
                            continue
                        self._unseal_for_load(name, n, shard, bs)
                    recovered += self._load_reader_into_buffers(
                        n, shard, reader, bs)
        return recovered

    @property
    def draining(self) -> bool:
        """True once :meth:`prepare_shutdown` (or :meth:`begin_drain`)
        has run — health surfaces report it so routers stop sending
        work here before the process exits."""
        return self._draining

    def begin_drain(self) -> None:
        """Flip readiness to draining WITHOUT the database lock: health
        probes must see the flag even while a long snapshot holds the
        lock."""
        self._draining = True

    def prepare_shutdown(self) -> dict[str, list[int]]:
        """Graceful-restart seam (ref: the dbnode's deferred shutdown
        in server.go: drain, snapshot, then exit): flip to draining,
        then snapshot so the next bootstrap's replay window is
        the seconds since rotation instead of hours of WAL.  Wired to
        SIGTERM by services.run.  Crash-safe at every seam — the
        killpoint sweep crashes mid-drain/mid-snapshot and recovery
        still serves every acked write, because durability never
        depends on this path (the WAL already has everything)."""
        self.begin_drain()
        faultpoints.check("shutdown.drain")
        faultpoints.check("shutdown.snapshot")
        done = self.snapshot()
        faultpoints.check("shutdown.done")
        _log.info("prepare_shutdown",
                  snapshot_blocks=sum(len(v) for v in done.values()))
        return done

    def close(self) -> None:
        self._seek.clear()
        self._decoded_cache.clear()
        for n in self._namespaces.values():
            n.index.close()  # stop the background compaction daemon
        self._open = False

