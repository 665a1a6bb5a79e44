"""Instrumentation: metrics registry + structured logging + debug dump.

The reference instruments everything with uber-go/tally scopes and
zap structured logs (ref: src/x/instrument/config.go, per-subsystem
metric structs e.g. commit_log.go:175, list.go:105) and serves a debug
dump zip (ref: src/x/debug/debug.go:75).  Here:

- a process-wide metrics registry of counters/gauges/histograms with
  static tags, rendered in Prometheus exposition format at /metrics;
- JSON-line structured logging (logger name + fields), stderr by
  default, level-gated via M3_TPU_LOG_LEVEL;
- `debug_dump()` — one JSON document with build info, metrics
  snapshot, thread stacks, and gc stats for the /debug/dump endpoint.
"""

from __future__ import annotations

import io
import json
import os
import sys
import threading
import time
import traceback

# ---------------------------------------------------------------------------
# metrics
# ---------------------------------------------------------------------------


def _escape_label(v: str) -> str:
    """Prometheus exposition label-value escaping: one bad value would
    make the whole scrape unparseable."""
    return (str(v).replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def _fmt_tags(tags: dict[str, str]) -> str:
    if not tags:
        return ""
    inner = ",".join(f'{k}="{_escape_label(v)}"'
                     for k, v in sorted(tags.items()))
    return "{" + inner + "}"


class Counter:
    __slots__ = ("_value", "_lock")

    def __init__(self):
        self._value = 0.0
        self._lock = threading.Lock()

    def inc(self, n: float = 1.0) -> None:
        with self._lock:
            self._value += n

    @property
    def value(self) -> float:
        return self._value


class Gauge:
    __slots__ = ("_value",)

    def __init__(self):
        self._value = 0.0

    def set(self, v: float) -> None:
        self._value = v

    @property
    def value(self) -> float:
        return self._value


class GaugeFn:
    """Callback gauge: the value is SAMPLED at scrape/collect time by
    calling the registered function, so queue depths / ring sizes /
    cache occupancy are current when read rather than only as fresh as
    the last mutation (ref: tally's CachedGauge / prometheus GaugeFunc).
    A failing callback reads as NaN — a scrape must never raise."""

    __slots__ = ("_fn",)

    def __init__(self, fn=None):
        self._fn = fn

    def set_fn(self, fn) -> None:
        self._fn = fn

    @property
    def value(self) -> float:
        fn = self._fn
        if fn is None:
            return float("nan")
        try:
            return float(fn())
        except Exception:  # noqa: BLE001 - scrapes must never raise
            return float("nan")


class MetricSample:
    """One flattened sample out of ``Registry.collect()``: histograms
    decompose into cumulative ``_bucket{le=...}`` / ``_sum`` /
    ``_count`` samples plus a ``_max`` gauge, exactly the exposition
    shape — so a consumer can write the samples into time-series
    storage and ``histogram_quantile`` works unchanged."""

    __slots__ = ("name", "tags", "kind", "value")

    def __init__(self, name: str, tags: dict, kind: str, value: float):
        self.name = name
        self.tags = tags
        self.kind = kind  # "counter" | "gauge"
        self.value = value

    def __repr__(self):  # pragma: no cover - debugging aid
        return (f"MetricSample({self.name!r}, {self.tags!r}, "
                f"{self.kind!r}, {self.value!r})")


class Histogram:
    """Compact latency summary: count/sum/max + coarse log buckets.

    When exemplar capture is on (``set_exemplars(True)``, config
    ``attribution.exemplars``) each bucket remembers the most recent
    observation made under an active trace as an OpenMetrics exemplar
    ``(trace_id, value, unix_ts)``, so a slow bucket on a dashboard
    links straight to /debug/traces."""

    BOUNDS = (0.001, 0.005, 0.01, 0.05, 0.1, 0.5, 1.0, 5.0, 30.0)

    def __init__(self):
        self._lock = threading.Lock()
        self.count = 0
        self.sum = 0.0
        self.max = 0.0
        self.buckets = [0] * (len(self.BOUNDS) + 1)
        self.exemplars: dict[int, tuple[str, float, float]] = {}

    def observe(self, v: float) -> None:
        # capture the exemplar OUTSIDE the lock: the tracing lookup is
        # thread-local but there is no reason to serialize it
        ex = _exemplar_for(v) if _EXEMPLARS else None
        with self._lock:
            self.count += 1
            self.sum += v
            self.max = max(self.max, v)
            idx = len(self.BOUNDS)
            for i, b in enumerate(self.BOUNDS):
                if v <= b:
                    idx = i
                    break
            self.buckets[idx] += 1
            if ex is not None:
                self.exemplars[idx] = ex


# OpenMetrics exemplar capture — off by default (exposition stays
# plain Prometheus text unless the operator opts in via config).
_EXEMPLARS = False


def set_exemplars(on: bool) -> None:
    """Toggle exemplar capture + exposition process-wide."""
    global _EXEMPLARS
    _EXEMPLARS = bool(on)


def exemplars_enabled() -> bool:
    return _EXEMPLARS


def _exemplar_for(v: float):
    """(trace_id_hex, value, ts) for the active trace, else None."""
    try:
        from m3_tpu_torch.utils import tracing  # cycle-free: tracing is stdlib-only

        ctx = tracing.current_context()
    except Exception:  # noqa: BLE001 - observation must never raise
        return None
    if ctx is None:
        return None
    return (f"{ctx.trace_id:032x}", float(v), time.time())


def _exemplar_suffix(ex) -> str:
    """OpenMetrics exemplar clause for a ``_bucket`` exposition line:
    ``# {trace_id="..."} value timestamp``."""
    if ex is None:
        return ""
    return f' # {{trace_id="{ex[0]}"}} {ex[1]} {round(ex[2], 3)}'


class BoundedFamily:
    """A metric family with a cap on distinct label sets.

    ``family.labels(tenant="acme").inc()`` resolves to a normal
    registry metric until ``cap`` distinct label sets exist for this
    metric name; further NEW label sets fold into one series with
    every dynamic label value replaced by ``"other"``, and each folded
    resolution bumps ``m3_instrument_dropped_labels_total{metric=...}``.
    This is the sanctioned path for tenant-/sid-derived labels
    (enforced by tools/lint_robustness.py rule 9): an unbounded label
    domain can degrade a dashboard, never blow up the registry."""

    __slots__ = ("_registry", "_kind_attr", "_name", "_cap", "_static",
                 "_seen", "_fold", "_lock", "_dropped")

    def __init__(self, registry: "Registry", kind_attr: str, name: str,
                 cap: int, static_tags: dict[str, str]):
        self._registry = registry
        self._kind_attr = kind_attr  # "counter" | "gauge" | "histogram"
        self._name = name
        self._cap = max(1, int(cap))
        self._static = dict(static_tags)
        self._seen: dict[tuple, object] = {}
        self._fold: dict[tuple, object] = {}
        self._lock = threading.Lock()
        self._dropped = registry.counter(
            "m3_instrument_dropped_labels_total", metric=name)

    @property
    def name(self) -> str:
        return self._name

    def labels(self, **tags: str):
        key = tuple(sorted(tags.items()))
        m = self._seen.get(key)
        if m is not None:
            return m
        factory = getattr(self._registry, self._kind_attr)
        with self._lock:
            m = self._seen.get(key)
            if m is not None:
                return m
            if len(self._seen) >= self._cap:
                self._dropped.inc()
                fold_key = tuple(sorted(tags))
                m = self._fold.get(fold_key)
                if m is None:
                    folded = {k: "other" for k in tags}
                    m = factory(self._name, **self._static, **folded)
                    self._fold[fold_key] = m
                return m
            m = factory(self._name, **self._static, **tags)
            self._seen[key] = m
            return m


class Registry:
    """All metrics of one process (the root tally scope)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: dict[tuple[str, tuple], object] = {}
        self._families: dict[tuple, BoundedFamily] = {}

    def _get(self, kind, name: str, tags: dict[str, str] | None):
        key = (name, tuple(sorted((tags or {}).items())))
        mismatch = None
        with self._lock:
            m = self._metrics.get(key)
            if m is None:
                m = self._metrics[key] = kind()
            elif type(m) is not kind:
                # same name+tags requested as a different kind: hand
                # back a detached instance so the caller's increments
                # don't corrupt the registered metric, and report the
                # bug.  invariant_violated() itself bumps a counter on
                # this registry, so it must run outside our lock.
                mismatch = type(m).__name__
                m = kind()
        if mismatch is not None:
            invariant_violated(
                "metric kind collision",
                name=name, tags=dict(tags or {}),
                registered=mismatch, requested=kind.__name__)
        return m

    def counter(self, name: str, **tags: str) -> Counter:
        return self._get(Counter, name, tags)

    def gauge(self, name: str, **tags: str) -> Gauge:
        return self._get(Gauge, name, tags)

    def histogram(self, name: str, **tags: str) -> Histogram:
        return self._get(Histogram, name, tags)

    def _bounded(self, kind_attr: str, name: str, cap: int,
                 tags: dict[str, str]) -> BoundedFamily:
        key = (kind_attr, name, tuple(sorted(tags.items())))
        with self._lock:
            fam = self._families.get(key)
        if fam is None:
            # constructed outside the lock: BoundedFamily.__init__
            # registers its dropped-labels counter, which re-enters it
            fam = BoundedFamily(self, kind_attr, name, cap, tags)
            with self._lock:
                fam = self._families.setdefault(key, fam)
        return fam

    def bounded_counter(self, name: str, cap: int = 64,
                        **tags: str) -> BoundedFamily:
        """Counter family with a bounded label-set domain (the
        sanctioned API for tenant-/sid-derived labels)."""
        return self._bounded("counter", name, cap, tags)

    def bounded_gauge(self, name: str, cap: int = 64,
                      **tags: str) -> BoundedFamily:
        return self._bounded("gauge", name, cap, tags)

    def bounded_histogram(self, name: str, cap: int = 64,
                          **tags: str) -> BoundedFamily:
        return self._bounded("histogram", name, cap, tags)

    def gauge_fn(self, name: str, fn, **tags: str) -> GaugeFn:
        """Register a callback gauge.  Re-registration with the same
        name+tags REBINDS the callback (components are recreated per
        process/test and the newest instance owns the series); a
        name+tags already registered as a different kind trips the
        same kind-collision invariant as ``_get``."""
        g = self._get(GaugeFn, name, tags)
        g.set_fn(fn)
        return g

    def collect(self):
        """Yield every metric as flattened ``MetricSample``s (the
        self-scrape input).  Callback gauges are sampled HERE, outside
        the registry lock — a slow or lock-taking callback must not
        stall concurrent counter registration."""
        with self._lock:
            items = list(self._metrics.items())
        for (name, tags), m in items:
            t = dict(tags)
            if isinstance(m, Counter):
                yield MetricSample(name, t, "counter", m.value)
            elif isinstance(m, (Gauge, GaugeFn)):
                yield MetricSample(name, t, "gauge", m.value)
            else:  # histogram -> exposition-shaped cumulative samples
                cum = 0
                for i, b in enumerate(m.BOUNDS):
                    cum += m.buckets[i]
                    yield MetricSample(name + "_bucket",
                                       dict(t, le=str(b)), "counter",
                                       float(cum))
                yield MetricSample(name + "_bucket",
                                   dict(t, le="+Inf"), "counter",
                                   float(m.count))
                yield MetricSample(name + "_sum", t, "counter",
                                   float(m.sum))
                yield MetricSample(name + "_count", t, "counter",
                                   float(m.count))
                yield MetricSample(name + "_max", t, "gauge",
                                   float(m.max))

    def snapshot(self) -> dict:
        out: dict = {}
        with self._lock:
            items = list(self._metrics.items())
        for (name, tags), m in items:
            k = name + _fmt_tags(dict(tags))
            if isinstance(m, Histogram):
                out[k] = {
                    "count": m.count, "sum": m.sum, "max": m.max,
                    "buckets": {
                        **{str(b): m.buckets[i]
                           for i, b in enumerate(m.BOUNDS)},
                        "+Inf": m.buckets[-1],
                    },
                }
            else:
                out[k] = m.value
        return out

    def render_prometheus(self) -> bytes:
        """Prometheus text exposition of every metric."""
        buf = io.StringIO()
        with self._lock:
            items = sorted(self._metrics.items())
        last_typed = None  # one TYPE line per metric NAME (parser req)
        for (name, tags), m in items:
            t = dict(tags)
            if isinstance(m, Counter):
                if name != last_typed:
                    buf.write(f"# TYPE {name} counter\n")
                buf.write(f"{name}{_fmt_tags(t)} {m.value}\n")
            elif isinstance(m, (Gauge, GaugeFn)):
                if name != last_typed:
                    buf.write(f"# TYPE {name} gauge\n")
                buf.write(f"{name}{_fmt_tags(t)} {m.value}\n")
            else:
                if name != last_typed:
                    buf.write(f"# TYPE {name} histogram\n")
                show_ex = _EXEMPLARS
                cum = 0
                for i, b in enumerate(m.BOUNDS):
                    cum += m.buckets[i]
                    bt = dict(t, le=str(b))
                    ex = _exemplar_suffix(
                        m.exemplars.get(i)) if show_ex else ""
                    buf.write(f"{name}_bucket{_fmt_tags(bt)} {cum}{ex}\n")
                bt = dict(t, le="+Inf")
                ex = _exemplar_suffix(
                    m.exemplars.get(len(m.BOUNDS))) if show_ex else ""
                buf.write(f"{name}_bucket{_fmt_tags(bt)} {m.count}{ex}\n")
                buf.write(f"{name}_sum{_fmt_tags(t)} {m.sum}\n")
                buf.write(f"{name}_count{_fmt_tags(t)} {m.count}\n")
                buf.write(f"{name}_max{_fmt_tags(t)} {m.max}\n")
            last_typed = name
        return buf.getvalue().encode()


_ROOT = Registry()


def counter(name: str, **tags: str) -> Counter:
    return _ROOT.counter(name, **tags)


def gauge(name: str, **tags: str) -> Gauge:
    return _ROOT.gauge(name, **tags)


def histogram(name: str, **tags: str) -> Histogram:
    return _ROOT.histogram(name, **tags)


def gauge_fn(name: str, fn, **tags: str) -> GaugeFn:
    return _ROOT.gauge_fn(name, fn, **tags)


def bounded_counter(name: str, cap: int = 64, **tags: str) -> BoundedFamily:
    return _ROOT.bounded_counter(name, cap=cap, **tags)


def bounded_gauge(name: str, cap: int = 64, **tags: str) -> BoundedFamily:
    return _ROOT.bounded_gauge(name, cap=cap, **tags)


def bounded_histogram(name: str, cap: int = 64,
                      **tags: str) -> BoundedFamily:
    return _ROOT.bounded_histogram(name, cap=cap, **tags)


def registry() -> Registry:
    return _ROOT


class InvariantError(AssertionError):
    """A violated internal invariant (test environments only)."""


def invariant_violated(msg: str, **fields) -> None:
    """Report a broken internal invariant.

    Production: count + log and keep serving (an invariant breach must
    not take the process down).  Test environments set
    ``M3_PANIC_ON_INVARIANT_VIOLATED=1`` to raise instead, so breaches
    fail the suite loudly (ref: src/x/instrument/invariant.go —
    identical env-gated behavior)."""
    _ROOT.counter("m3_invariant_violations_total").inc()
    logger("invariant").error(msg, **fields)
    if os.environ.get("M3_PANIC_ON_INVARIANT_VIOLATED") == "1":
        raise InvariantError(msg)


# ---------------------------------------------------------------------------
# structured logging
# ---------------------------------------------------------------------------

_LEVELS = {"debug": 10, "info": 20, "warn": 30, "error": 40, "off": 99}


class Logger:
    """JSON-line structured logger (the zap equivalent)."""

    def __init__(self, name: str, stream=None):
        self.name = name
        self._stream = stream

    def _emit(self, level: str, msg: str, fields: dict) -> None:
        if _LEVELS[level] < _min_level():
            return
        rec = {"ts": time.time(), "level": level, "logger": self.name,
               "msg": msg}
        for k, v in fields.items():
            rec[k] = v if isinstance(v, (int, float, str, bool, type(None))) \
                else str(v)
        line = json.dumps(rec, separators=(",", ":"))
        stream = self._stream or sys.stderr
        try:
            print(line, file=stream, flush=True)
        except (OSError, ValueError):
            pass

    def debug(self, msg: str, **fields) -> None:
        self._emit("debug", msg, fields)

    def info(self, msg: str, **fields) -> None:
        self._emit("info", msg, fields)

    def warn(self, msg: str, **fields) -> None:
        self._emit("warn", msg, fields)

    def error(self, msg: str, **fields) -> None:
        self._emit("error", msg, fields)


def _min_level() -> int:
    return _LEVELS.get(os.environ.get("M3_TPU_LOG_LEVEL", "info"), 20)


def logger(name: str) -> Logger:
    return Logger(name)


# ---------------------------------------------------------------------------
# debug dump (ref: src/x/debug/debug.go:75)
# ---------------------------------------------------------------------------


def debug_dump(extra: dict | None = None) -> dict:
    """One JSON document of process diagnostics: the reference's debug
    zip (goroutine/heap/namespace/placement dumps) as JSON sections."""
    import gc

    frames = sys._current_frames()
    threads = {}
    for t in threading.enumerate():
        frame = frames.get(t.ident)
        threads[f"{t.name}({t.ident})"] = (
            traceback.format_stack(frame) if frame is not None else [])
    out = {
        "pid": os.getpid(),
        "time": time.time(),
        "python": sys.version,
        "metrics": _ROOT.snapshot(),
        "threads": threads,
        "gc": {
            "counts": gc.get_count(),
            "objects": len(gc.get_objects()),
        },
    }
    try:
        from m3_tpu_torch.utils import tracing

        out["traces"] = tracing.tracer().finished(limit=256)
    except Exception:  # noqa: BLE001 - dump must not fail
        pass
    if extra:
        out.update(extra)
    return out
