"""Per-tenant resource accounting (the workload-attribution core).

One process-global :class:`Accountant` aggregates, per tenant:

- write-path cost: samples, wire bytes, WAL bytes, new series
- read-path cost: datapoints scanned, bytes decoded, device execute
  seconds, device transfer bytes, cache hit/miss bytes
- three heavy-hitter sketches (``m3_tpu_torch.attribution.sketch``):
  expensive query fingerprints, series-churn tenants, and
  label-cardinality offenders (the ROADMAP-2 precursor)
- per-tenant inflight admission cost, reported observe-only as
  ``m3_admission_tenant_share`` (enforcement is a later PR)

Tenant resolution order (docs/observability.md "Workload
attribution"): explicit ``M3-Tenant`` header > tenant propagated on
the ``tc`` trace context (``;t=`` suffix) > namespace > ``default``.

Counters export as ``m3_tenant_*`` through the bounded-cardinality
registry API (``instrument.bounded_counter``), so a tenant-id
explosion folds into ``other`` instead of blowing up the registry,
and flow to ``_m3_internal`` via the existing self-scrape.

Every hook is request- or batch-scoped (never per-sample) and
early-returns when attribution is disabled (``M3_ATTRIBUTION=0`` or
``attribution.enabled: false`` in config), which is what the bench.py
``attribution`` side leg toggles to assert <= 3% overhead.
"""

from __future__ import annotations

import os
import threading

from m3_tpu_torch.attribution.sketch import SpaceSaving, merge_dumps
from m3_tpu_torch.utils import instrument

# tenant labels are sanitized to this charset (no ';' — it is the
# wire-suffix separator on traceparent — and no quotes/newlines)
_SAFE_CHARS = frozenset(
    "abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ"
    "0123456789_.:-")
_MAX_TENANT_LEN = 64
_MAX_FINGERPRINT_LEN = 200

DEFAULT_TENANT = "default"
TENANT_HEADER = "M3-Tenant"
# reserved scope for the cross-query batcher's shared device dispatch
# (the reference's m3_tpu/serving/): kernel telemetry skips its per-call device-seconds
# billing under it so the scheduler can split the measured time across
# the batched queries' real tenants by lane share instead
BATCH_TENANT = "_query_batch"

# write-path + read-path counter catalog: attr -> metric name
_COUNTERS = {
    "samples": "m3_tenant_samples_total",
    "wire_bytes": "m3_tenant_wire_bytes_total",
    "wal_bytes": "m3_tenant_wal_bytes_total",
    "new_series": "m3_tenant_new_series_total",
    "datapoints": "m3_tenant_datapoints_scanned_total",
    "decoded_bytes": "m3_tenant_decoded_bytes_total",
    "device_seconds": "m3_tenant_device_seconds_total",
    "transfer_bytes": "m3_tenant_transfer_bytes_total",
    "cache_hit_bytes": "m3_tenant_cache_hit_bytes_total",
    "cache_miss_bytes": "m3_tenant_cache_miss_bytes_total",
    "queries": "m3_tenant_queries_total",
}


def safe_tenant(tenant) -> str:
    """Sanitize an externally-supplied tenant id for use as a metric
    label and wire-suffix value."""
    if tenant is None:
        return DEFAULT_TENANT
    if isinstance(tenant, bytes):
        tenant = tenant.decode("utf-8", "replace")
    t = str(tenant).strip()[:_MAX_TENANT_LEN]
    if not t:
        return DEFAULT_TENANT
    if all(c in _SAFE_CHARS for c in t):
        return t
    return "".join(c if c in _SAFE_CHARS else "_" for c in t)


class Accountant:
    """Bounded per-tenant cost aggregation + heavy-hitter sketches."""

    def __init__(self, sketch_capacity: int = 64, tenant_cap: int = 64):
        self.enabled = os.environ.get(
            "M3_ATTRIBUTION", "1").lower() not in ("0", "false", "no")
        self.sketch_capacity = int(sketch_capacity)
        self.tenant_cap = int(tenant_cap)
        self.source_id = os.urandom(8).hex()
        self._lock = threading.Lock()
        # exact per-tenant totals served at /debug/tenants, bounded by
        # tenant_cap with overflow folded into "other"
        self._tenants: dict[str, dict[str, float]] = {}
        self._inflight: dict[str, float] = {}
        self.query_cost = SpaceSaving(self.sketch_capacity)
        self.series_churn = SpaceSaving(self.sketch_capacity)
        self.label_cardinality = SpaceSaving(self.sketch_capacity)
        self._families = {
            attr: instrument.bounded_counter(name, cap=self.tenant_cap)
            for attr, name in _COUNTERS.items()}
        self._share = instrument.bounded_gauge(
            "m3_admission_tenant_share", cap=self.tenant_cap)

    # -- config ----------------------------------------------------------

    def configure(self, enabled: bool | None = None,
                  sketch_capacity: int | None = None,
                  tenant_cap: int | None = None) -> None:
        if enabled is not None:
            self.enabled = bool(enabled)
        if sketch_capacity and sketch_capacity != self.sketch_capacity:
            self.sketch_capacity = int(sketch_capacity)
            self.query_cost = SpaceSaving(self.sketch_capacity)
            self.series_churn = SpaceSaving(self.sketch_capacity)
            self.label_cardinality = SpaceSaving(self.sketch_capacity)
        if tenant_cap:
            self.tenant_cap = int(tenant_cap)

    # -- accounting ------------------------------------------------------

    def _slot(self, tenant: str) -> dict[str, float]:
        # caller holds self._lock
        rec = self._tenants.get(tenant)
        if rec is None:
            if len(self._tenants) >= self.tenant_cap:
                tenant = "other"
                rec = self._tenants.get(tenant)
                if rec is not None:
                    return rec
            rec = self._tenants[tenant] = {}
        return rec

    def _add(self, tenant: str, **costs: float) -> None:
        with self._lock:
            rec = self._slot(tenant)
            for attr, v in costs.items():
                if v:
                    rec[attr] = rec.get(attr, 0.0) + v
        for attr, v in costs.items():
            if v:
                self._families[attr].labels(tenant=tenant).inc(v)

    def account_write(self, tenant, samples: int = 0,
                      wire_bytes: int = 0, wal_bytes: int = 0,
                      new_series: int = 0) -> None:
        if not self.enabled:
            return
        t = safe_tenant(tenant)
        self._add(t, samples=samples, wire_bytes=wire_bytes,
                  wal_bytes=wal_bytes, new_series=new_series)
        if new_series:
            self.series_churn.offer(t, new_series)

    def account_read(self, tenant, datapoints: int = 0,
                     decoded_bytes: int = 0, device_seconds: float = 0.0,
                     transfer_bytes: int = 0, cache_hit_bytes: int = 0,
                     cache_miss_bytes: int = 0) -> None:
        if not self.enabled:
            return
        self._add(safe_tenant(tenant), datapoints=datapoints,
                  decoded_bytes=decoded_bytes,
                  device_seconds=device_seconds,
                  transfer_bytes=transfer_bytes,
                  cache_hit_bytes=cache_hit_bytes,
                  cache_miss_bytes=cache_miss_bytes)

    def account_query(self, tenant, fingerprint: str,
                      cost: float) -> None:
        """One finished query: bumps the per-tenant query counter and
        offers (tenant|fingerprint, cost) to the query-cost sketch."""
        if not self.enabled:
            return
        t = safe_tenant(tenant)
        self._add(t, queries=1)
        fp = " ".join(str(fingerprint).split())[:_MAX_FINGERPRINT_LEN]
        self.query_cost.offer(f"{t}|{fp}", max(float(cost), 1.0))

    def note_label_keys(self, keys, count: float = 1.0) -> None:
        """Offer label NAMES of a newly-created series to the
        cardinality-offender sketch (churn-weighted: a label name
        scores each time a series carrying it is created, so names
        driving series churn dominate — the ROADMAP-2 precursor
        signal)."""
        if not self.enabled:
            return
        for k in keys:
            if isinstance(k, bytes):
                k = k.decode("utf-8", "replace")
            k = str(k)
            if k and not k.startswith("__"):
                self.label_cardinality.offer(k, count)

    # -- inflight admission share (observe-only) -------------------------

    def inflight_add(self, tenant, cost: float) -> None:
        if not self.enabled or cost <= 0:
            return
        t = safe_tenant(tenant)
        with self._lock:
            self._inflight[t] = self._inflight.get(t, 0.0) + cost
            self._publish_shares_locked()

    def inflight_sub(self, tenant, cost: float) -> None:
        if not self.enabled or cost <= 0:
            return
        t = safe_tenant(tenant)
        with self._lock:
            left = self._inflight.get(t, 0.0) - cost
            if left <= 0:
                self._inflight.pop(t, None)
            else:
                self._inflight[t] = left
            self._publish_shares_locked()

    def _publish_shares_locked(self) -> None:
        total = sum(self._inflight.values())
        for t, v in self._inflight.items():
            self._share.labels(tenant=t).set(v / total if total else 0.0)

    # -- views -----------------------------------------------------------

    def tenants_view(self) -> dict:
        """Exact per-tenant totals + inflight shares (served at
        /debug/tenants)."""
        with self._lock:
            tenants = {t: dict(rec) for t, rec in self._tenants.items()}
            inflight = dict(self._inflight)
        total = sum(inflight.values())
        return {
            "source_id": self.source_id,
            "enabled": self.enabled,
            "tenant_cap": self.tenant_cap,
            "tenants": tenants,
            "inflight": {
                t: {"cost": v, "share": v / total if total else 0.0}
                for t, v in inflight.items()},
        }

    def dump(self) -> dict:
        """Mergeable sketch snapshot (served over RPC as
        ``attribution_dump``; the coordinator merges per-node dumps,
        de-duplicating by ``source_id`` since in-process clusters
        share one accountant)."""
        return {
            "source_id": self.source_id,
            "enabled": self.enabled,
            "sketches": {
                "query_cost": self.query_cost.dump(),
                "series_churn": self.series_churn.dump(),
                "label_cardinality": self.label_cardinality.dump(),
            },
        }

    def reset(self) -> None:
        """Test hook: drop all accumulated state (sketches + tables).
        The exported ``m3_tenant_*`` counters are cumulative and are
        NOT reset (Prometheus counters never go backwards)."""
        with self._lock:
            self._tenants.clear()
            self._inflight.clear()
        self.query_cost.reset()
        self.series_churn.reset()
        self.label_cardinality.reset()


_GLOBAL = Accountant()


def accountant() -> Accountant:
    return _GLOBAL


def enabled() -> bool:
    return _GLOBAL.enabled


def configure(**kw) -> None:
    _GLOBAL.configure(**kw)


def account_write(tenant, **costs) -> None:
    _GLOBAL.account_write(tenant, **costs)


def account_read(tenant, **costs) -> None:
    _GLOBAL.account_read(tenant, **costs)


def account_query(tenant, fingerprint, cost) -> None:
    _GLOBAL.account_query(tenant, fingerprint, cost)


def note_label_keys(keys, count: float = 1.0) -> None:
    _GLOBAL.note_label_keys(keys, count)


def inflight_add(tenant, cost: float) -> None:
    _GLOBAL.inflight_add(tenant, cost)


def inflight_sub(tenant, cost: float) -> None:
    _GLOBAL.inflight_sub(tenant, cost)


def current_tenant(default=None):
    """Tenant propagated on the active trace context / baggage, or
    ``default`` (callers on the storage path pass the namespace)."""
    from m3_tpu_torch.utils import tracing
    return tracing.current_tenant() or default


def merge_attribution_dumps(dumps: list[dict]) -> dict:
    """Coordinator-side merge of per-node ``attribution_dump()``
    payloads.  Dumps are de-duplicated by ``source_id`` first: an
    in-process multi-node cluster shares one process-global
    accountant, and double-merging it would double every count."""
    seen: set[str] = set()
    uniq: list[dict] = []
    for d in dumps:
        if not isinstance(d, dict):
            continue
        sid = str(d.get("source_id") or id(d))
        if sid in seen:
            continue
        seen.add(sid)
        uniq.append(d)
    out: dict = {"sources": sorted(seen), "sketches": {}}
    for name in ("query_cost", "series_churn", "label_cardinality"):
        parts = [d.get("sketches", {}).get(name, {}) for d in uniq]
        merged = merge_dumps([p for p in parts if p])
        merged["entries"] = sorted(
            merged["entries"], key=lambda e: -e["count"])
        # the documented merged error bound: sum_i N_i / m
        cap = merged.get("capacity") or 1
        merged["error_bound"] = merged.get("total", 0.0) / cap
        out["sketches"][name] = merged
    return out
