"""Namespace + retention options (ref: src/dbnode/namespace/types.go:43-71,
src/dbnode/retention/types.go:28+, SURVEY.md §8.4)."""

from __future__ import annotations

import dataclasses

import numpy as np

from m3_tpu_torch.utils import xtime


@dataclasses.dataclass(frozen=True)
class RetentionOptions:
    """Ref: src/dbnode/retention/types.go:28."""

    retention_period: int = 48 * xtime.HOUR
    block_size: int = 2 * xtime.HOUR
    buffer_past: int = 10 * xtime.MINUTE
    buffer_future: int = 2 * xtime.MINUTE

    def block_start(self, t_nanos: int) -> int:
        return t_nanos - (t_nanos % self.block_size)

    def within_retention(self, t_nanos: int, now_nanos: int) -> bool:
        return t_nanos > now_nanos - self.retention_period

    def writable(self, t_nanos: int, now_nanos: int) -> bool:
        """A write is accepted inside [now - bufferPast, now + bufferFuture]
        plus anywhere in the currently-open block (cold writes land in
        past blocks via the merge path, see shard seal)."""
        return bool(self.writable_mask(
            np.asarray([t_nanos], dtype=np.int64), now_nanos)[0])

    def writable_mask(self, times_nanos, now_nanos: int):
        """Vectorized ``writable`` over int64 timestamps — the single
        source of the write-window-or-open-block predicate (used by the
        cold-write gate; keep scalar and batch semantics in lockstep)."""
        t = np.asarray(times_nanos, dtype=np.int64)
        in_window = ((t >= now_nanos - self.buffer_past)
                     & (t <= now_nanos + self.buffer_future))
        open_block = (t - t % self.block_size
                      == now_nanos - now_nanos % self.block_size)
        return in_window | open_block


@dataclasses.dataclass(frozen=True)
class NamespaceOptions:
    """Ref: src/dbnode/namespace/types.go:43-71."""

    name: str = "default"
    retention: RetentionOptions = dataclasses.field(default_factory=RetentionOptions)
    bootstrap_enabled: bool = True
    flush_enabled: bool = True
    snapshot_enabled: bool = True
    writes_to_commit_log: bool = True
    cleanup_enabled: bool = True
    repair_enabled: bool = False
    # False = writes outside [now - buffer_past, now + buffer_future]
    # (and outside the open block) are REJECTED, the reference's
    # default posture (namespace/types.go ColdWritesEnabled).
    # Deviation: default True here — this framework's load/backfill
    # flows (peer bootstrap, tiles, examples) write historical
    # timestamps as a matter of course, and the cold path is served by
    # the unseal-merge machinery rather than a separate buffer tier.
    cold_writes_enabled: bool = True
    index_enabled: bool = True
    index_block_size: int = 2 * xtime.HOUR
    aggregated: bool = False  # pre-aggregated namespace (downsample target)
    aggregation_resolution: int = 0  # nanos, when aggregated
    # structured (proto-value) namespaces: per-datapoint messages
    # compressed by ops.struct_codec instead of float64 samples
    # (ref: dbnode/encoding/proto + the namespace schema registry)
    schema: object = None  # the reference's ops.struct_codec.Schema; the port's
    # Database refuses it until structured namespaces are ported
