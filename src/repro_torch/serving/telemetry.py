"""Unified serving telemetry: metrics registry, structured spans, event bus
(port of ``repro/serving/telemetry.py``).

One ``Telemetry`` hub threads through every engine via
``EngineConfig(telemetry=...)`` and watches: it never changes an emitted
token.

* Metrics registry: labelled counters, gauges and histograms (tokens, TTFT
  per tenant, expert-load imbalance and estimated drop rate per layer,
  re-plan, shed, fault and adoption totals, queue depth, per-device
  step-time EWMAs) with Prometheus text exposition and a JSON snapshot.
* Structured spans: nested, exception-safe ``span(...)`` records around
  every step callable (through the engines' ``step_wrapper`` seam),
  exported as JSONL and as Chrome trace-event JSON (Perfetto). A step
  whose engine has a BvN round schedule gets per-round ``dispatch_round``
  child spans (the measured window split evenly, marked ``estimated``):
  the ``Distributed*`` engines on the "aurora" path feed their live
  rounds to the decode, pool and lockstep spans.
* Event bus: shed, re-plan, fault, adoption and recovery notices in one
  bounded, deterministic stream that interleaves with the spans.

Disabled is free: ``EngineConfig(telemetry=None)`` composes no wrapper,
and ``Telemetry(enabled=False)`` returns a shared no-op span. With
``block_steps`` a wrapped step waits for the card (``torch.cuda.
synchronize``) when its outputs hold CUDA tensors, so a span measures
execution, not the enqueue.
"""

from __future__ import annotations

import dataclasses
import json
import math
import time
from typing import Any, Callable, Iterable

import torch

from .events import BusEvent, EventBus, RingBuffer

__all__ = [
    "Telemetry", "MetricsRegistry", "Counter", "Gauge", "Histogram",
    "SpanRecord", "record_adoption", "BusEvent", "EventBus", "RingBuffer",
    "STEP_BOUNDS", "block_until_ready", "tree_leaves",
]


def tree_leaves(tree):
    """Every leaf of a dict/list/tuple tree, in order."""
    if isinstance(tree, dict):
        for v in tree.values():
            yield from tree_leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from tree_leaves(v)
    else:
        yield tree


def block_until_ready(out):
    """Wait for the card when ``out`` holds a CUDA tensor (the counterpart
    of ``jax.block_until_ready``); returns ``out``."""
    if any(torch.is_tensor(t) and t.is_cuda for t in tree_leaves(out)):
        torch.cuda.synchronize()
    return out


# --------------------------------------------------------------------------
# JSON sanitizing: bus payloads are arbitrary dataclasses (ReplanEvent
# carries tuples of tuples; ShedEvent carries the full Request). Exports
# must never fail on a payload, so everything degrades to repr().

def _jsonable(obj, depth: int = 0):
    if depth > 6:
        return repr(obj)
    if obj is None or isinstance(obj, (bool, int, str)):
        return obj
    if isinstance(obj, float):
        return obj if math.isfinite(obj) else repr(obj)
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return {f.name: _jsonable(getattr(obj, f.name), depth + 1)
                for f in dataclasses.fields(obj)}
    if isinstance(obj, dict):
        return {str(k): _jsonable(v, depth + 1) for k, v in obj.items()}
    if isinstance(obj, (list, tuple, set, frozenset)):
        seq = list(obj)
        if len(seq) > 64:  # bound payload size (long prompts, big tables)
            return [_jsonable(v, depth + 1) for v in seq[:64]] + [
                f"... ({len(seq) - 64} more)"]
        return [_jsonable(v, depth + 1) for v in seq]
    # numpy and torch scalars, 0-d arrays and tensors
    item = getattr(obj, "item", None)
    if callable(item) and getattr(obj, "ndim", 1) == 0:
        try:
            return _jsonable(item(), depth + 1)
        except Exception:
            return repr(obj)
    tolist = getattr(obj, "tolist", None)
    if callable(tolist):
        try:
            return _jsonable(tolist(), depth + 1)
        except Exception:
            return repr(obj)
    return repr(obj)


# --------------------------------------------------------------------------
# Metrics

def _label_key(labels: dict) -> tuple:
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


def _label_str(key: tuple) -> str:
    if not key:
        return ""
    return "{" + ",".join(f'{k}="{v}"' for k, v in key) + "}"


class _Metric:
    kind = "untyped"

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self._values: dict[tuple, Any] = {}

    def labelsets(self):
        return self._values.items()


class Counter(_Metric):
    """Monotonic counter; ``inc(amount, **labels)``."""

    kind = "counter"

    def inc(self, amount: float = 1.0, **labels) -> None:
        key = _label_key(labels)
        self._values[key] = self._values.get(key, 0.0) + float(amount)

    def value(self, **labels) -> float:
        return float(self._values.get(_label_key(labels), 0.0))


class Gauge(_Metric):
    """Last-write-wins gauge; ``set(value, **labels)``."""

    kind = "gauge"

    def set(self, value: float, **labels) -> None:
        self._values[_label_key(labels)] = float(value)

    def value(self, **labels) -> float:
        return float(self._values.get(_label_key(labels), 0.0))


_DEFAULT_BOUNDS = (0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05,
                   0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0)
# Step-clock quantities (TTFT in engine steps) need integer-ish bounds.
STEP_BOUNDS = (1.0, 2.0, 4.0, 8.0, 16.0, 32.0, 64.0, 128.0, 256.0)


class Histogram(_Metric):
    """Fixed-bucket histogram; ``observe(value, **labels)``.

    Tracks per-labelset count / sum / min / max plus cumulative bucket
    counts (Prometheus ``le`` semantics, implicit ``+Inf``).
    """

    kind = "histogram"

    def __init__(self, name: str, help: str = "",
                 bounds: Iterable[float] = _DEFAULT_BOUNDS):
        super().__init__(name, help)
        self.bounds = tuple(float(b) for b in bounds)

    def observe(self, value: float, **labels) -> None:
        v = float(value)
        key = _label_key(labels)
        st = self._values.get(key)
        if st is None:
            st = {"count": 0, "sum": 0.0, "min": v, "max": v,
                  "buckets": [0] * (len(self.bounds) + 1)}
            self._values[key] = st
        st["count"] += 1
        st["sum"] += v
        st["min"] = min(st["min"], v)
        st["max"] = max(st["max"], v)
        for i, b in enumerate(self.bounds):
            if v <= b:
                st["buckets"][i] += 1
                break
        else:
            st["buckets"][-1] += 1


class MetricsRegistry:
    """Get-or-create registry of named metrics.

    ``counter(name)`` / ``gauge(name)`` / ``histogram(name)`` return the
    existing metric when already registered (re-registration with a
    different type raises).  Exposition: :meth:`prometheus_text` and
    :meth:`snapshot`.
    """

    def __init__(self):
        self._metrics: dict[str, _Metric] = {}

    def _get(self, cls, name: str, help: str, **kw) -> _Metric:
        m = self._metrics.get(name)
        if m is None:
            m = cls(name, help, **kw)
            self._metrics[name] = m
        elif not isinstance(m, cls):
            raise TypeError(f"metric {name!r} already registered as {m.kind}")
        return m

    def counter(self, name: str, help: str = "") -> Counter:
        return self._get(Counter, name, help)

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._get(Gauge, name, help)

    def histogram(self, name: str, help: str = "",
                  bounds: Iterable[float] = _DEFAULT_BOUNDS) -> Histogram:
        return self._get(Histogram, name, help, bounds=bounds)

    def __contains__(self, name: str) -> bool:
        return name in self._metrics

    def __getitem__(self, name: str) -> _Metric:
        return self._metrics[name]

    def prometheus_text(self) -> str:
        """Prometheus text exposition (``# HELP`` / ``# TYPE`` + samples)."""
        lines: list[str] = []
        for name in sorted(self._metrics):
            m = self._metrics[name]
            if m.help:
                lines.append(f"# HELP {name} {m.help}")
            lines.append(f"# TYPE {name} {m.kind}")
            for key, val in sorted(m.labelsets()):
                if m.kind == "histogram":
                    cum = 0
                    for b, n in zip(m.bounds, val["buckets"]):
                        cum += n
                        lkey = key + (("le", f"{b:g}"),)
                        lines.append(
                            f"{name}_bucket{_label_str(lkey)} {cum}")
                    lkey = key + (("le", "+Inf"),)
                    lines.append(
                        f"{name}_bucket{_label_str(lkey)} {val['count']}")
                    lines.append(f"{name}_sum{_label_str(key)} "
                                 f"{val['sum']:g}")
                    lines.append(f"{name}_count{_label_str(key)} "
                                 f"{val['count']}")
                else:
                    lines.append(f"{name}{_label_str(key)} {val:g}")
        return "\n".join(lines) + ("\n" if lines else "")

    def snapshot(self) -> dict:
        """JSON-ready snapshot: ``{name: {kind, help, values: [...]}}``."""
        out: dict[str, Any] = {}
        for name, m in sorted(self._metrics.items()):
            values = []
            for key, val in sorted(m.labelsets()):
                entry: dict[str, Any] = {"labels": dict(key)}
                if m.kind == "histogram":
                    entry.update(count=val["count"], sum=val["sum"],
                                 min=val["min"], max=val["max"])
                else:
                    entry["value"] = val
                values.append(entry)
            out[name] = {"kind": m.kind, "help": m.help, "values": values}
        return out


# --------------------------------------------------------------------------
# Spans

@dataclasses.dataclass(frozen=True)
class SpanRecord:
    """One finished span: host wall-clock window plus nesting metadata."""

    name: str
    ts: float          # start, seconds (Telemetry clock)
    dur: float         # duration, seconds
    depth: int         # nesting depth at entry (0 = top-level)
    seq: int           # per-hub monotonic finish order
    attrs: dict = dataclasses.field(default_factory=dict)
    error: str | None = None


class _NullSpan:
    """Shared no-op context manager for disabled telemetry.

    A single module-level instance is reused for every call so the
    disabled fast path allocates nothing per step; ``__enter__`` /
    ``__exit__`` hold no state, so reentrant/nested use is safe.
    """

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, exc_type, exc, tb):
        return False


_NULL_SPAN = _NullSpan()


class _Span:
    """Live span context manager; exception-safe (closes in ``__exit__``
    regardless, recording the exception type and re-raising)."""

    __slots__ = ("_hub", "name", "attrs", "ts", "dur", "depth", "record")

    def __init__(self, hub: "Telemetry", name: str, attrs: dict):
        self._hub = hub
        self.name = name
        self.attrs = attrs
        self.ts = 0.0
        self.dur = 0.0
        self.depth = 0
        self.record: SpanRecord | None = None

    def __enter__(self):
        hub = self._hub
        self.depth = len(hub._stack)
        hub._stack.append(self)
        self.ts = hub._clock()
        return self

    def __exit__(self, exc_type, exc, tb):
        hub = self._hub
        self.dur = hub._clock() - self.ts
        # Pop self even if an inner span leaked (exception paths): the
        # stack is truncated back to this span's depth.
        del hub._stack[self.depth:]
        self.record = SpanRecord(
            name=self.name, ts=self.ts, dur=self.dur, depth=self.depth,
            seq=hub._next_span_seq(), attrs=self.attrs,
            error=None if exc_type is None else exc_type.__name__)
        hub._finish_span(self.record)
        return False


# --------------------------------------------------------------------------
# Hub

class Telemetry:
    """The hub: metrics + spans + event bus + exports.

    Parameters
    ----------
    capacity:
        Ring capacity for finished spans and for the event bus
        (evictions are drop-oldest and counted in
        ``telemetry_spans_dropped_total`` / ``telemetry_events_dropped_total``).
    enabled:
        Runtime switch.  When False every hot-path entry point
        (``span`` / ``count`` / ``gauge`` / ``observe`` / ``publish`` /
        wrapped steps) is a guarded no-op with no per-call allocation.
    profiler:
        When True, wrapped steps also enter a
        ``torch.profiler.record_function`` range of the span's name, so
        host spans line up with a ``torch.profiler`` trace.
    block_steps:
        When True (default) wrapped steps wait for the card when their
        outputs hold CUDA tensors (``block_until_ready``), so span
        durations measure execution, not the enqueue.  Only affects
        enabled hubs.
    clock:
        Seconds, monotonic; injectable for deterministic exports.
    """

    def __init__(self, capacity: int = 4096, enabled: bool = True,
                 profiler: bool = False, block_steps: bool = True,
                 clock: Callable[[], float] = time.perf_counter):
        self.enabled = bool(enabled)
        self.profiler = bool(profiler)
        self.block_steps = bool(block_steps)
        self._clock = clock
        self.metrics = MetricsRegistry()
        self._spans_dropped = self.metrics.counter(
            "telemetry_spans_dropped_total",
            "finished spans evicted from the bounded span ring")
        self._events_dropped = self.metrics.counter(
            "telemetry_events_dropped_total",
            "bus events evicted from the bounded event ring")
        self.spans: RingBuffer = RingBuffer(
            capacity, on_drop=lambda _e: self._spans_dropped.inc())
        self.bus = EventBus(
            capacity, clock=self._clock,
            on_drop=lambda _e: self._events_dropped.inc())
        self._stack: list[_Span] = []
        self._span_seq = 0
        self._span_seconds = self.metrics.histogram(
            "span_seconds", "wall-clock duration of telemetry spans")

    # -- spans -------------------------------------------------------------

    def span(self, name: str, **attrs):
        """Nested span context manager; no-op singleton when disabled."""
        if not self.enabled:
            return _NULL_SPAN
        return _Span(self, name, attrs)

    def _next_span_seq(self) -> int:
        s = self._span_seq
        self._span_seq += 1
        return s

    def _finish_span(self, rec: SpanRecord) -> None:
        self.spans.append(rec)
        self._span_seconds.observe(rec.dur, name=rec.name)

    def emit_span(self, name: str, ts: float, dur: float, depth: int = 0,
                  **attrs) -> SpanRecord:
        """Record a synthetic (already-timed) span, e.g. per-round
        subdivisions of a measured step window."""
        rec = SpanRecord(name=name, ts=ts, dur=dur, depth=depth,
                         seq=self._next_span_seq(), attrs=attrs)
        self._finish_span(rec)
        return rec

    # -- metrics shorthands (no-ops when disabled) -------------------------

    def count(self, name: str, amount: float = 1.0, help: str = "",
              **labels) -> None:
        if self.enabled:
            self.metrics.counter(name, help).inc(amount, **labels)

    def gauge(self, name: str, value: float, help: str = "",
              **labels) -> None:
        if self.enabled:
            self.metrics.gauge(name, help).set(value, **labels)

    def observe(self, name: str, value: float, help: str = "",
                bounds: Iterable[float] = _DEFAULT_BOUNDS, **labels) -> None:
        if self.enabled:
            self.metrics.histogram(name, help, bounds=bounds).observe(
                value, **labels)

    # -- events ------------------------------------------------------------

    def publish(self, kind: str, payload, step: int | None = None):
        """Publish a typed event to the bus (None when disabled)."""
        if not self.enabled:
            return None
        self.metrics.counter(
            "serving_events_total",
            "events published to the unified bus").inc(kind=kind)
        return self.bus.publish(kind, payload, step=step)

    # -- step wrapping (the step_wrapper seam) -----------------------------

    def wrap_step(self, fn: Callable, name: str, tenant: str | None = None,
                  rounds: Callable[[], Any] | None = None) -> Callable:
        """Wrap a step callable so each call is a span.

        ``rounds`` (optional) returns the engine's *current* BvN round
        schedule; when present and non-empty, the measured step window
        is subdivided into per-round ``dispatch_round`` child spans
        (equal split, ``estimated=True``: a host can't see intra-step
        device timing without a device profiler).
        """
        attrs = {} if tenant is None else {"tenant": tenant}

        def wrapped(*args, **kwargs):
            if not self.enabled:
                return fn(*args, **kwargs)
            sp = _Span(self, name, dict(attrs))
            with sp:
                rng = (torch.profiler.record_function(name)
                       if self.profiler else _NULL_SPAN)
                with rng:
                    out = fn(*args, **kwargs)
                    if self.block_steps:
                        out = block_until_ready(out)
            if rounds is not None:
                self._emit_rounds(sp, rounds(), tenant)
            return out

        return wrapped

    def _emit_rounds(self, sp: _Span, rounds, tenant: str | None) -> None:
        if rounds is None:
            return
        r_list = list(rounds)
        n = len(r_list)
        if n == 0:
            return
        sub = sp.dur / n
        for i, perm in enumerate(r_list):
            attrs = {"r": i, "estimated": True, "parent": sp.name,
                     "perm": _jsonable(perm)}
            if tenant is not None:
                attrs["tenant"] = tenant
            self.emit_span("dispatch_round", ts=sp.ts + i * sub, dur=sub,
                           depth=sp.depth + 1, **attrs)
        self.metrics.counter(
            "ppermute_rounds_total",
            "BvN dispatch rounds executed (per compiled step x schedule "
            "length)").inc(n)
        self.metrics.gauge(
            "ppermute_rounds_per_step",
            "length of the live BvN round schedule").set(n)

    # -- exports -----------------------------------------------------------

    def snapshot(self) -> dict:
        """Full JSON snapshot: metrics + bus counts + ring stats."""
        return {
            "metrics": self.metrics.snapshot(),
            "events": {"counts": dict(self.bus.counts),
                       "published": sum(self.bus.counts.values()),
                       "retained": len(self.bus),
                       "dropped": self.bus.dropped},
            "spans": {"retained": len(self.spans),
                      "dropped": self.spans.dropped},
        }

    def records(self) -> list[dict]:
        """Spans + bus events as JSON-ready dicts, timeline-ordered."""
        recs: list[tuple[float, int, dict]] = []
        for s in self.spans:
            recs.append((s.ts, s.seq, {
                "type": "span", "name": s.name, "ts": s.ts, "dur": s.dur,
                "depth": s.depth, "seq": s.seq,
                "attrs": _jsonable(s.attrs), "error": s.error}))
        for e in self.bus:
            recs.append((e.ts, e.seq, {
                "type": "event", "kind": e.kind, "ts": e.ts, "seq": e.seq,
                "step": e.step, "payload": _jsonable(e.payload)}))
        recs.sort(key=lambda r: (r[0], r[1]))
        return [r[2] for r in recs]

    def jsonl(self) -> str:
        return "\n".join(json.dumps(r) for r in self.records()) + "\n"

    def write_jsonl(self, path: str) -> None:
        with open(path, "w") as f:
            f.write(self.jsonl())

    def chrome_trace(self) -> dict:
        """Chrome trace-event JSON (loads directly in Perfetto).

        Spans become ``ph: "X"`` complete events (µs since the first
        record); bus events become ``ph: "i"`` instants, so replans /
        faults / sheds interleave with the step timeline.  Tenant maps
        to ``tid`` so colocated tenants get separate tracks.
        """
        events: list[dict] = []
        t0 = None
        for s in self.spans:
            t0 = s.ts if t0 is None else min(t0, s.ts)
        for e in self.bus:
            t0 = e.ts if t0 is None else min(t0, e.ts)
        if t0 is None:
            t0 = 0.0
        tids: dict[str, int] = {}

        def tid_for(tenant) -> int:
            if tenant is None:
                return 0
            return tids.setdefault(str(tenant), len(tids) + 1)

        for s in self.spans:
            ev = {"name": s.name, "ph": "X", "cat": "span",
                  "ts": (s.ts - t0) * 1e6, "dur": s.dur * 1e6,
                  "pid": 0, "tid": tid_for(s.attrs.get("tenant")),
                  "args": _jsonable(s.attrs)}
            if s.error is not None:
                ev["args"]["error"] = s.error
            events.append(ev)
        for e in self.bus:
            events.append({"name": e.kind, "ph": "i", "cat": "event",
                           "s": "p", "ts": (e.ts - t0) * 1e6,
                           "pid": 0, "tid": 0,
                           "args": {"seq": e.seq, "step": e.step,
                                    "payload": _jsonable(e.payload)}})
        events.sort(key=lambda ev: ev["ts"])
        meta = [{"name": "process_name", "ph": "M", "pid": 0, "ts": 0,
                 "args": {"name": "serving"}},
                {"name": "thread_name", "ph": "M", "pid": 0, "tid": 0,
                 "ts": 0, "args": {"name": "engine"}}]
        meta += [{"name": "thread_name", "ph": "M", "pid": 0, "tid": t,
                  "ts": 0, "args": {"name": f"tenant:{name}"}}
                 for name, t in sorted(tids.items(), key=lambda kv: kv[1])]
        return {"traceEvents": meta + events, "displayTimeUnit": "ms"}

    def write_chrome_trace(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.chrome_trace(), f)

    def prometheus_text(self) -> str:
        return self.metrics.prometheus_text()


def record_adoption(tel: Telemetry | None, kind: str,
                    step: int | None = None, **detail) -> None:
    """Count + publish a mid-stream adoption (rounds swap, re-pairing,
    replication change, degraded rebuild).  No-op when ``tel`` is None
    or disabled — safe to call unconditionally from engine adopt paths.
    """
    if tel is None or not tel.enabled:
        return
    tel.count("serving_adoptions_total",
              help="mid-stream placement adoptions", kind=kind)
    tel.publish("adoption", {"kind": kind, **detail}, step=step)
