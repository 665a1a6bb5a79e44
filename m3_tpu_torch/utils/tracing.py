"""Lightweight distributed tracing: spans, tracepoints, sampling,
cross-process context propagation.

Parity target: src/dbnode/tracepoint/tracepoint.go:32 (the stable
tracepoint-name catalog threaded through the read/write paths) and
src/x/opentracing/ (tracer setup).  The reference attaches OpenTracing
spans to RPC-scoped contexts; here a span is a context-manager around
the same hot-path seams, parented through a thread-local stack, with:

  - deterministic sampling (1-in-N by operation) so the hot write path
    does not pay per-sample span cost
  - a bounded ring of finished spans exposed via the debug dump
    (`/debug/dump` -> "traces"), the zipkin-lite this image can serve
    with zero egress
  - span tags + per-span wall duration; errors mark the span
  - Dapper-style cross-process propagation (Sigelman et al., 2010):
    a `TraceContext` rides the W3C ``traceparent`` header at the HTTP
    edge and a context field in the node-RPC / remote-query / m3msg
    wire frames, so a query fanning out coordinator -> storage
    replicas -> device kernels shares one trace_id.  ``activate()``
    adopts a remote or handed-off parent on the current thread — the
    explicit handoff for worker-thread pools (host queues, session
    fan-out executors).

The tracepoint catalog mirrors the reference's naming scheme
(`component.Method`) so a reader can map traces across systems.  The
observability lint (tools/lint_robustness.py) enforces that every
``tracing.span("...")`` string literal in the production tree comes
from this catalog.
"""

from __future__ import annotations

import os
import threading
import time
from collections import deque
from typing import NamedTuple

# ---------------------------------------------------------------- catalog
# Stable tracepoint names (ref: dbnode/tracepoint/tracepoint.go:32 — the
# catalog exists so span names never drift between emit and analysis).

DB_WRITE_BATCH = "db.WriteBatch"
DB_FETCH_TAGGED = "db.FetchTagged"
DB_QUERY_IDS = "db.QueryIDs"
NS_BOOTSTRAP = "namespace.Bootstrap"
SHARD_FLUSH = "shard.Flush"
SHARD_SNAPSHOT = "shard.Snapshot"
ENGINE_QUERY_RANGE = "engine.QueryRange"
ENGINE_FETCH_RAW = "engine.FetchRaw"
AGG_ADD_UNTIMED = "aggregator.AddUntimed"
AGG_FLUSH = "aggregator.Flush"
MSG_PUBLISH = "msg.Publish"
MSG_CONSUME = "msg.Consume"
REMOTE_FETCH = "remote.Fetch"
REMOTE_SERVE = "remote.Serve"
HTTP_REQUEST = "http.Request"
NODE_SERVE = "node.Serve"
SESSION_FETCH = "session.FetchTagged"
SESSION_FETCH_HOST = "session.FetchHost"
HOSTQ_WRITE_BATCH = "client.HostQueueWriteBatch"
DEVICE_KERNEL = "device.Kernel"


# --------------------------------------------------------------- context

class TraceContext(NamedTuple):
    """The cross-boundary identity of an active span: what rides wire
    frames and worker-pool handoffs (the role of the reference's
    RPC-scoped opentracing.SpanContext)."""

    trace_id: int
    span_id: int
    sampled: bool = True
    # workload-attribution baggage: the originating tenant, so fan-out
    # RPC work on dbnodes is attributed to the tenant that caused it
    # (rides the wire as a ";t=<tenant>" suffix on the tc field; the
    # bare traceparent header stays spec-clean)
    tenant: str | None = None

    def to_traceparent(self) -> str:
        """W3C trace-context header value (version 00)."""
        flags = "01" if self.sampled else "00"
        return f"00-{self.trace_id:032x}-{self.span_id:016x}-{flags}"


def parse_traceparent(value) -> TraceContext | None:
    """Parse a W3C ``traceparent`` header (or wire field).  Returns
    None for anything malformed — propagation is best-effort and a bad
    header must never fail the request it rides on.  A ``;t=<tenant>``
    suffix (this platform's attribution baggage on the RPC ``tc``
    field) is split off and carried on the returned context."""
    if not value:
        return None
    if isinstance(value, (bytes, bytearray)):
        try:
            value = bytes(value).decode("ascii")
        except UnicodeDecodeError:
            return None
    value, _, baggage = value.strip().partition(";")
    tenant = baggage[2:] if baggage.startswith("t=") else None
    parts = value.split("-")
    if len(parts) != 4:
        return None
    version, tid, sid, flags = parts
    if len(version) != 2 or len(tid) != 32 or len(sid) != 16:
        return None
    try:
        trace_id = int(tid, 16)
        span_id = int(sid, 16)
        sampled = bool(int(flags, 16) & 1)
    except ValueError:
        return None
    if version == "ff" or trace_id == 0 or span_id == 0:
        return None  # per spec: invalid version / all-zero ids
    return TraceContext(trace_id, span_id, sampled, tenant or None)


class Span:
    __slots__ = ("name", "trace_id", "span_id", "parent_id", "start",
                 "duration", "tags", "error")

    def __init__(self, name: str, trace_id: int, span_id: int,
                 parent_id: int | None, tags: dict):
        self.name = name
        self.trace_id = trace_id
        self.span_id = span_id
        self.parent_id = parent_id
        self.start = time.time()
        self.duration = 0.0
        self.tags = tags
        self.error = ""

    def to_dict(self) -> dict:
        return {
            "name": self.name,
            "trace_id": f"{self.trace_id:032x}",
            "span_id": f"{self.span_id:016x}",
            "parent_id": f"{self.parent_id:016x}" if self.parent_id else None,
            "start": self.start,
            "duration_ms": round(self.duration * 1e3, 3),
            "tags": {k: str(v) for k, v in self.tags.items()},
            "error": self.error or None,
        }


class Tracer:
    """Sampled span recorder with a bounded finished-span ring."""

    def __init__(self, sample_1_in: int = 100, max_spans: int = 2048):
        self.sample_1_in = max(1, int(sample_1_in))
        self._ring: deque[Span] = deque(maxlen=max_spans)
        self._tls = threading.local()
        self._counts: dict[str, int] = {}
        self._lock = threading.Lock()
        self._next_id = 1
        # ids must not collide ACROSS processes in a cluster (every
        # node contributes spans to one assembled trace), so the
        # sequential counter rides on a per-process random base
        self._id_base = int.from_bytes(os.urandom(4), "big")

    # -- internals --

    def _stack(self) -> list:
        st = getattr(self._tls, "stack", None)
        if st is None:
            st = self._tls.stack = []
        return st

    def _sampled(self, name: str, root: bool) -> bool:
        if not root:
            return True  # children follow their root's decision
        with self._lock:
            n = self._counts.get(name, 0)
            self._counts[name] = n + 1
        return n % self.sample_1_in == 0

    def _new_id(self) -> int:
        with self._lock:
            self._next_id += 1
            return (self._id_base << 32) | (self._next_id & 0xFFFFFFFF)

    def _new_trace_id(self) -> int:
        return int.from_bytes(os.urandom(16), "big") or 1

    # -- public --

    def span(self, name: str, **tags):
        """Context manager; no-ops (cheaply) when unsampled."""
        return _SpanCtx(self, name, tags)

    def current(self) -> TraceContext | None:
        """The context of the innermost live sampled span on this
        thread (what a wire injection or worker handoff should carry);
        None when nothing sampled is active."""
        for s in reversed(self._stack()):
            if s is None:
                continue
            if isinstance(s, TraceContext):
                return s
            return TraceContext(s.trace_id, s.span_id, True)
        return None

    def activate(self, ctx: TraceContext | None):
        """Adopt a remote/handed-off parent context on this thread.

        Spans opened inside the ``with`` block parent to ``ctx`` and
        inherit its trace_id — the explicit handoff for worker-thread
        pools and the extract side of wire propagation.  ``ctx=None``
        (nothing propagated) is a no-op: spans root normally under
        local sampling.  An unsampled context suppresses local spans,
        honoring the upstream decision."""
        return _ActivateCtx(self, ctx)

    def finished(self, limit: int = 0) -> list[dict]:
        """Last `limit` finished spans (0 = all).  Snapshot the Span
        refs under the lock, serialize outside it — record() on hot
        paths must never wait on a debug dump."""
        with self._lock:
            spans = list(self._ring)[-limit:] if limit else list(self._ring)
        return [s.to_dict() for s in spans]

    def export(self, trace_id: str | None = None,
               limit: int = 0) -> list[dict]:
        """Finished spans, optionally filtered to one trace — the
        per-node span-export surface."""
        spans = self.finished(limit=limit)
        if trace_id:
            want = trace_id.lower().lstrip("0") or "0"
            spans = [s for s in spans
                     if s["trace_id"].lstrip("0") == want]
        return spans

    def record(self, span: Span) -> None:
        with self._lock:
            self._ring.append(span)


class _SpanCtx:
    __slots__ = ("_tracer", "_name", "_tags", "_span")

    def __init__(self, tracer: Tracer, name: str, tags: dict):
        self._tracer = tracer
        self._name = name
        self._tags = tags
        self._span: Span | None = None

    def __enter__(self) -> Span | None:
        st = self._tracer._stack()
        root = not st
        if not self._tracer._sampled(self._name, root):
            st.append(None)  # unsampled marker keeps parenting honest
            return None
        parent = next((s for s in reversed(st) if s is not None), None)
        if parent is None and not root:
            # unsampled root: children stay unsampled
            st.append(None)
            return None
        span = Span(
            self._name,
            trace_id=(parent.trace_id if parent
                      else self._tracer._new_trace_id()),
            span_id=self._tracer._new_id(),
            parent_id=parent.span_id if parent else None,
            tags=self._tags,
        )
        st.append(span)
        self._span = span
        return span

    def __exit__(self, exc_type, exc, _tb) -> bool:
        st = self._tracer._stack()
        if st:
            st.pop()
        if self._span is not None:
            self._span.duration = time.time() - self._span.start
            if exc is not None:
                self._span.error = f"{type(exc).__name__}: {exc}"
            self._tracer.record(self._span)
        return False


class _ActivateCtx:
    __slots__ = ("_tracer", "_ctx", "_pushed", "_tenant_pushed",
                 "_prev_tenant")

    def __init__(self, tracer: Tracer, ctx: TraceContext | None):
        self._tracer = tracer
        self._ctx = ctx
        self._pushed = False
        self._tenant_pushed = False
        self._prev_tenant = None

    def __enter__(self):
        if self._ctx is not None:
            st = self._tracer._stack()
            # an unsampled upstream decision suppresses local children
            st.append(self._ctx if self._ctx.sampled else None)
            self._pushed = True
            tenant = getattr(self._ctx, "tenant", None)
            if tenant:
                # adopt propagated attribution baggage even for
                # unsampled contexts: accounting is not sampled
                self._prev_tenant = current_tenant()
                _TENANT_TLS.tenant = tenant
                self._tenant_pushed = True
        return self._ctx

    def __exit__(self, exc_type, exc, _tb) -> bool:
        if self._pushed:
            st = self._tracer._stack()
            if st:
                st.pop()
        if self._tenant_pushed:
            _TENANT_TLS.tenant = self._prev_tenant
        return False


# ------------------------------------------------- attribution baggage
# Thread-local tenant for workload attribution (m3_tpu_torch.attribution).
# Deliberately separate from the span stack: accounting must work even
# when the request's trace is unsampled.

_TENANT_TLS = threading.local()


def current_tenant() -> str | None:
    """The tenant attributed to work on this thread, or None."""
    return getattr(_TENANT_TLS, "tenant", None)


class _TenantScope:
    __slots__ = ("_tenant", "_prev")

    def __init__(self, tenant: str | None):
        self._tenant = tenant
        self._prev = None

    def __enter__(self):
        self._prev = current_tenant()
        if self._tenant:
            _TENANT_TLS.tenant = self._tenant
        return self._tenant

    def __exit__(self, exc_type, exc, _tb) -> bool:
        _TENANT_TLS.tenant = self._prev
        return False


def tenant_scope(tenant: str | None):
    """Attribute work in the ``with`` block to ``tenant`` (None keeps
    the current attribution — the scope is then a no-op)."""
    return _TenantScope(tenant)


# ------------------------------------------------------------- assembly

def assemble_trace(spans: list[dict], trace_id: str) -> dict:
    """Collected span dicts (local ring + peer exports) -> one nested
    trace tree keyed by trace_id: the coordinator/tools view of a
    cross-node query (ref: the reference's jaeger UI role).

    Spans whose parent is missing from the collected set (ring
    eviction, an unreachable peer) surface under "orphans" rather than
    disappearing — partial traces must stay diagnosable."""
    want = trace_id.lower().lstrip("0") or "0"
    by_id: dict[str, dict] = {}
    mine: list[dict] = []
    for s in spans:
        if str(s.get("trace_id", "")).lstrip("0") != want:
            continue
        if s["span_id"] in by_id:
            continue  # same span collected from several sources
            # (local ring + a peer export of the same process)
        s = dict(s)
        s["children"] = []
        by_id[s["span_id"]] = s
        mine.append(s)
    roots, orphans = [], []
    for s in mine:
        pid = s.get("parent_id")
        if pid is None:
            roots.append(s)
        elif pid in by_id:
            by_id[pid]["children"].append(s)
        else:
            orphans.append(s)
    for s in mine:
        s["children"].sort(key=lambda c: c.get("start", 0.0))
    roots.sort(key=lambda c: c.get("start", 0.0))
    orphans.sort(key=lambda c: c.get("start", 0.0))
    return {"trace_id": trace_id, "span_count": len(mine),
            "roots": roots, "orphans": orphans}


_GLOBAL = Tracer()


def tracer() -> Tracer:
    return _GLOBAL


def span(name: str, **tags):
    """Module-level convenience: ``with tracing.span(DB_WRITE_BATCH):``"""
    return _GLOBAL.span(name, **tags)


def current_context() -> TraceContext | None:
    """The active span's cross-boundary context on this thread."""
    return _GLOBAL.current()


def activate(ctx: TraceContext | None):
    """Module-level convenience for Tracer.activate."""
    return _GLOBAL.activate(ctx)


def wire_context() -> str | None:
    """Inject side of wire propagation: the current context as a
    traceparent string for a frame field / HTTP header, or None when
    nothing sampled is active (unsampled work propagates nothing — the
    downstream process makes its own root sampling decision).  When a
    tenant is active (attribution baggage) it rides as a ``;t=``
    suffix so fan-out work downstream is attributed correctly."""
    ctx = _GLOBAL.current()
    if ctx is None:
        return None
    tp = ctx.to_traceparent()
    tenant = current_tenant()
    return f"{tp};t={tenant}" if tenant else tp


def set_sampling(sample_1_in: int) -> None:
    """Hot-reloadable sampling rate (1 = trace everything)."""
    _GLOBAL.sample_1_in = max(1, int(sample_1_in))


def traced(name: str):
    """Decorator form for method-boundary tracepoints."""
    import functools

    def deco(fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            with _GLOBAL.span(name):
                return fn(*args, **kwargs)

        return wrapper

    return deco
