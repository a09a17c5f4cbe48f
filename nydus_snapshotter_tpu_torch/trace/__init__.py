"""End-to-end request tracing: propagated spans across a conversion, its
pipeline workers and the dict service's RPCs.

The ``ntpu_*`` counters/histograms can say THAT a p99 regressed; this
module says WHERE for any single request. A *span* is one timed operation
(``span("convert", image=...)``); spans form a tree through a trace id +
parent id carried in a :mod:`contextvars` context variable, and — because
contextvars do not cross thread-pool boundaries — carried EXPLICITLY over
every pool this package owns:

- ``parallel/pipeline.py``: stage workers adopt the converting caller's
  context (one span per worker, not per chunk — tracing must not tax the
  hot loop);
- ``converter/batch.py``: each layer's pack on the fan-out's threads
  adopts the image's ``convert`` span;
- ``parallel/dict_service.py``: the client sends the caller's ids as
  ``x-ntpu-trace-id`` / ``x-ntpu-parent-id`` headers and the service's
  ``dict.rpc.<op>`` spans join that trace (:func:`remote_context`).

Finished spans land in a bounded lock-striped ring (:mod:`.ring`,
drop-oldest, drops exported as ``ntpu_trace_dropped_spans_total``) and
are exported three ways (:mod:`.export`): Chrome ``trace_event`` JSON on
``/api/v1/traces`` (the dict service), a slow-op flight
recorder that logs the full reconstructed tree of any root op over
``slow_op_threshold_ms``, and over-p95 ``trace_exemplars`` on the metrics
summaries. While a ``torch.profiler`` records, every span also opens a
profiler range of its own name (utils/profiler_ranges.py), so the spans
sit in the profile on the device trace's clock.

Zero-overhead contract: with
tracing disabled, :func:`span` is one global load, one branch and a
no-op context manager — no ids, no clock reads, no allocation beyond the
kwargs dict. With no profiler recording, a live span's profiler range
costs one flag read. Sampling is decided once at the ROOT span
(``sample_ratio``) and inherited by the whole tree, so a sampled-out
request costs the same as a disabled tracer. Configuration: ``[trace]`` section
(config/config.py) overridden by ``NTPU_TRACE*`` environment variables —
the env is also how the section reaches spawned processes.
"""

from __future__ import annotations

import functools
import itertools
import json
import os
import random
import threading
import time
from contextlib import contextmanager
from contextvars import ContextVar
from dataclasses import dataclass
from time import perf_counter
from typing import Iterator, Optional

from nydus_snapshotter_tpu_torch.config.config import global_section
from nydus_snapshotter_tpu_torch.metrics import registry as _metrics
from nydus_snapshotter_tpu_torch.trace.export import (
    ExemplarStore,
    SlowOpRecorder,
    _fmt_id,
    format_tree,
    to_chrome_trace,
)
from nydus_snapshotter_tpu_torch.metrics.registry import LazyCounter
from nydus_snapshotter_tpu_torch.trace.ring import SPANS_DROPPED, SpanRing
from nydus_snapshotter_tpu_torch.utils import profiler_ranges as _prof

__all__ = [
    "Span",
    "SpanContext",
    "TraceRuntimeConfig",
    "annotate",
    "annotate_failpoint",
    "capture",
    "chrome_trace",
    "chrome_trace_bytes",
    "configure",
    "dropped",
    "dump_text",
    "enabled",
    "exemplars",
    "remote_context",
    "reset",
    "resolve_trace_config",
    "slow_ops",
    "snapshot_spans",
    "span",
    "start_span",
    "traced",
    "with_context",
]

DEFAULT_RING_CAPACITY = 8192
DEFAULT_SLOW_OP_MS = 1000.0

_reg = _metrics.default_registry
# Lazy: synced from the ring's per-stripe totals at scrape time, so the
# span hot path never touches a registry metric lock (see registry.LazyCounter).
SPANS_TOTAL = _reg.register(
    LazyCounter(
        "ntpu_trace_spans_total", "Spans recorded into the trace ring buffer"
    )
)
SLOW_OPS = _reg.register(
    _metrics.Counter(
        "ntpu_trace_slow_ops_total",
        "Root operations whose duration exceeded the slow-op threshold",
    )
)

_rng = random.random  # patchable for deterministic sampling tests


# ---------------------------------------------------------------------------
# Configuration
# ---------------------------------------------------------------------------


@dataclass
class TraceRuntimeConfig:
    """Resolved ``[trace]`` section (env > config > defaults)."""

    enabled: bool = True
    ring_capacity: int = DEFAULT_RING_CAPACITY
    slow_op_threshold_ms: float = DEFAULT_SLOW_OP_MS
    sample_ratio: float = 1.0


def _env_num(name: str, default: float) -> float:
    try:
        v = float(os.environ.get(name, ""))
        return v if v >= 0 else default
    except ValueError:
        return default


def resolve_trace_config() -> TraceRuntimeConfig:
    """Resolve the tracing knobs: ``NTPU_TRACE*`` env > ``[trace]`` config
    > defaults."""
    tc = global_section("trace")
    env = os.environ.get("NTPU_TRACE", "")
    if env:
        enabled_ = env not in ("0", "off", "false")
    else:
        got = getattr(tc, "enabled", None)
        enabled_ = True if got is None else bool(got)
    ring = int(_env_num("NTPU_TRACE_RING_CAPACITY", -1))
    if ring < 0:
        ring = getattr(tc, "ring_capacity", None) or DEFAULT_RING_CAPACITY
    slow = _env_num("NTPU_TRACE_SLOW_OP_MS", -1)
    if slow < 0:
        got = getattr(tc, "slow_op_threshold_ms", None)
        slow = DEFAULT_SLOW_OP_MS if got is None else float(got)
    sample = _env_num("NTPU_TRACE_SAMPLE_RATIO", -1)
    if sample < 0:
        got = getattr(tc, "sample_ratio", None)
        sample = 1.0 if got is None else float(got)
    return TraceRuntimeConfig(
        enabled=enabled_,
        ring_capacity=max(1, ring),
        slow_op_threshold_ms=max(0.0, slow),
        sample_ratio=min(1.0, max(0.0, sample)),
    )


# ---------------------------------------------------------------------------
# Span model + context
# ---------------------------------------------------------------------------


class Span:
    """One timed operation. To keep the per-span cost at ONE allocation,
    the span is simultaneously the record that lands in the ring, its own
    context manager, and the context value propagated to children (ids are
    read off it directly; ``span``/``sampled`` keep the
    :class:`SpanContext` reading surface).

    Ids are ints — ``(pid | boot-time) << 32 | counter`` — formatted to
    strings only at the export boundary (Chrome args, exemplars), where a
    raw 64-bit int would lose precision in JavaScript JSON consumers."""

    __slots__ = (
        "name",
        "trace_id",
        "span_id",
        "parent_id",
        "start",
        "duration_ms",
        "attrs",
        "thread",
        "_tracer",
        "_t0",
        "_token",
        "_range",
    )

    sampled = True  # a live span in the context ⇒ the trace is sampled

    def __init__(self, tracer: "Tracer", name: str, trace_id: int, span_id: int, parent_id: int, attrs: dict):
        self.name = name
        self.trace_id = trace_id
        self.span_id = span_id
        self.parent_id = parent_id
        self.start = 0.0  # epoch seconds
        self.duration_ms = 0.0
        self.attrs = attrs
        self.thread = ""
        self._tracer = tracer

    @property
    def span(self) -> "Span":
        return self

    def __enter__(self) -> "Span":
        self._range = _prof.open_range(self.name) if _prof.recording() else None
        self.thread = _thread_name()
        self._t0 = t0 = perf_counter()
        self.start = _EPOCH_OFFSET + t0
        self._token = _current.set(self)
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        self.duration_ms = (perf_counter() - self._t0) * 1000.0
        if self._range is not None:
            _prof.close_range(self._range)
            self._range = None
        if exc is not None:
            self.attrs["error"] = f"{exc_type.__name__}: {exc}"
        _current.reset(self._token)
        self._token = None
        self._tracer._record(self)
        return False

    def annotate(self, **attrs) -> None:
        self.attrs.update(attrs)

    def end(self, error: Optional[BaseException] = None) -> None:
        self.__exit__(type(error) if error is not None else None, error, None)


class SpanContext:
    """The unsampled sentinel's shape; live contexts are the spans
    themselves (same reading surface: ids + ``sampled`` + ``span``)."""

    __slots__ = ("trace_id", "span_id", "sampled", "span")

    def __init__(self, trace_id: int, span_id: int, sampled: bool, span: Optional[Span]):
        self.trace_id = trace_id
        self.span_id = span_id
        self.sampled = sampled
        self.span = span


_current: ContextVar[object] = ContextVar("ntpu_trace_ctx", default=None)
_UNSAMPLED_CTX = SpanContext(0, 0, False, None)

# Span start epochs are derived from perf_counter via this offset: one
# monotonic clock read per span edge instead of time()+perf_counter().
_EPOCH_OFFSET = time.time() - perf_counter()

_tls = threading.local()


def _thread_name() -> str:
    # threading.current_thread() costs a dict lookup + object walk per
    # call; spans on one thread all share a name, so cache it.
    try:
        return _tls.name
    except AttributeError:
        name = _tls.name = threading.current_thread().name
        return name


class _NoopSpan:
    """The disabled/unsampled-child path: one shared, stateless object."""

    __slots__ = ()

    def __enter__(self) -> "_NoopSpan":
        return self

    def __exit__(self, *exc) -> bool:
        return False

    def annotate(self, **attrs) -> None:
        pass

    def end(self, error: Optional[BaseException] = None) -> None:
        pass


_NOOP = _NoopSpan()


class _UnsampledRoot:
    """A sampled-out root still pins the unsampled decision into the
    context so the whole tree skips tracing with one roll."""

    __slots__ = ("_token",)

    def __enter__(self) -> "_UnsampledRoot":
        self._token = _current.set(_UNSAMPLED_CTX)
        return self

    def __exit__(self, *exc) -> bool:
        _current.reset(self._token)
        return False

    def annotate(self, **attrs) -> None:
        pass

    def end(self, error: Optional[BaseException] = None) -> None:
        self.__exit__(None, None, None)


# ---------------------------------------------------------------------------
# Tracer
# ---------------------------------------------------------------------------


class Tracer:
    def __init__(self, cfg: TraceRuntimeConfig):
        self.cfg = cfg
        self.ring = SpanRing(cfg.ring_capacity)
        self.recorder = SlowOpRecorder(cfg.slow_op_threshold_ms)
        self.exemplar_store = ExemplarStore()
        self._sample = cfg.sample_ratio
        # itertools.count.__next__ is atomic under the GIL — id generation
        # takes no lock on the span hot path.
        self._ids = itertools.count(1).__next__
        self._id_base = ((os.getpid() & 0xFFFF) << 48) | (
            (int(time.time()) & 0xFFFF) << 32
        )

    def _next_id(self) -> int:
        return self._id_base | self._ids()

    def span(self, name: str, attrs: dict):
        ctx = _current.get()
        if ctx is not None:
            if not ctx.sampled:
                return _NOOP
            return Span(
                self, name, ctx.trace_id, self._next_id(), ctx.span_id, attrs
            )
        # Root span: the one place the sampling decision is made.
        if self._sample < 1.0 and _rng() >= self._sample:
            return _UnsampledRoot()
        tid = self._next_id()
        return Span(self, name, tid, tid, 0, attrs)

    def _record(self, sp: Span) -> None:
        self.ring.push(sp)
        if not sp.parent_id:
            self.exemplar_store.record(sp)
            if 0 < self.cfg.slow_op_threshold_ms <= sp.duration_ms:
                SLOW_OPS.inc()
                self.recorder.record(sp, self.ring)


# ---------------------------------------------------------------------------
# Module-level API (the instrumentation surface)
# ---------------------------------------------------------------------------

_tracer: Optional[Tracer] = None
_initialized = False
_init_lock = threading.Lock()
# Totals from replaced tracers (configure()/reset() in tests and tools):
# the exported counters stay monotonic across tracer swaps.
_spans_base = 0
_drops_base = 0

SPANS_TOTAL.bind(lambda: _spans_base + (_tracer.ring.pushes() if _tracer else 0))
SPANS_DROPPED.bind(lambda: _drops_base + (_tracer.ring.dropped() if _tracer else 0))


def _retire_tracer_locked() -> None:
    """Fold the outgoing tracer's ring totals into the monotonic bases.
    Caller holds ``_init_lock``."""
    global _spans_base, _drops_base
    if _tracer is not None:
        _spans_base += _tracer.ring.pushes()
        _drops_base += _tracer.ring.dropped()


def _init() -> Optional[Tracer]:
    global _tracer, _initialized
    with _init_lock:
        if not _initialized:
            cfg = resolve_trace_config()
            _tracer = Tracer(cfg) if cfg.enabled else None
            _initialized = True
        return _tracer


def span(name: str, /, **attrs):
    """Open a span named ``name``; use as a context manager. The single
    branch on ``_tracer`` IS the disabled path. ``name`` is positional-only
    so ``name=...`` stays usable as a span attribute."""
    t = _tracer
    if t is None:
        if _initialized:
            return _NOOP
        t = _init()
        if t is None:
            return _NOOP
    return t.span(name, attrs)


def start_span(name: str, /, **attrs):
    """Imperative begin/``end()`` form of :func:`span` for call sites
    where a ``with`` block does not fit. ``end(error=...)`` closes it."""
    s = span(name, **attrs)
    s.__enter__()
    return s


def traced(name: str):
    """Decorator form of :func:`span` around a whole function/method."""

    def deco(fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)

        return wrapper

    return deco


def capture() -> Optional[SpanContext]:
    """The current span context, for explicit carry across a thread-pool
    boundary (pair with :func:`with_context` on the worker)."""
    return _current.get()


@contextmanager
def with_context(ctx: Optional[SpanContext]) -> Iterator[None]:
    """Adopt a captured context on a worker thread. ``None`` (captured
    with tracing disabled, or outside any span) is a no-op."""
    if ctx is None:
        yield
        return
    token = _current.set(ctx)
    try:
        yield
    finally:
        _current.reset(token)


def remote_context(trace_id: int, span_id: int) -> Optional[SpanContext]:
    """Reconstruct a propagated context from wire-carried ids (the dict
    service's RPC headers): spans opened under ``with_context(...)`` on
    the serving side join the caller's trace across the socket boundary,
    so one ``convert``-rooted tree spans the service RPC. Zero/absent ids
    (caller untraced) yield None, which :func:`with_context` no-ops."""
    if not trace_id or not span_id:
        return None
    return SpanContext(int(trace_id), int(span_id), True, None)


def annotate(**attrs) -> None:
    """Attach attributes to the innermost active span, if any."""
    ctx = _current.get()
    if ctx is not None and ctx.span is not None:
        ctx.span.attrs.update(attrs)


def annotate_failpoint(site: str) -> None:
    """Mark the current span as having had a failpoint fire inside it —
    called by :mod:`nydus_snapshotter_tpu_torch.failpoint` so chaos runs are
    traceable back to the injected fault."""
    ctx = _current.get()
    if ctx is not None and ctx.span is not None:
        ctx.span.attrs.setdefault("failpoints", []).append(site)


def configure(
    enabled: bool = True,
    ring_capacity: int = DEFAULT_RING_CAPACITY,
    slow_op_threshold_ms: float = DEFAULT_SLOW_OP_MS,
    sample_ratio: float = 1.0,
) -> Optional[Tracer]:
    """Install a tracer explicitly (tests, tools); bypasses env/config."""
    global _tracer, _initialized
    cfg = TraceRuntimeConfig(
        enabled=enabled,
        ring_capacity=max(1, ring_capacity),
        slow_op_threshold_ms=max(0.0, slow_op_threshold_ms),
        sample_ratio=min(1.0, max(0.0, sample_ratio)),
    )
    with _init_lock:
        _retire_tracer_locked()
        _tracer = Tracer(cfg) if enabled else None
        _initialized = True
        return _tracer


def reset() -> None:
    """Back to lazy env/config resolution on next use (tests)."""
    global _tracer, _initialized
    with _init_lock:
        _retire_tracer_locked()
        _tracer = None
        _initialized = False


def enabled() -> bool:
    t = _tracer if _initialized else _init()
    return t is not None


def snapshot_spans() -> list:
    t = _tracer
    return t.ring.snapshot() if t is not None else []


def dropped() -> int:
    t = _tracer
    return t.ring.dropped() if t is not None else 0


def exemplars(limit: int = 16) -> list[dict]:
    """Last N root trace ids whose duration exceeded the rolling p95 —
    the ``trace_exemplars`` field on the metrics summaries."""
    t = _tracer
    return t.exemplar_store.exemplars(limit) if t is not None else []


def slow_ops() -> list[dict]:
    """Roots the slow-op flight recorder fired for (newest last)."""
    t = _tracer
    return t.recorder.records() if t is not None else []


def chrome_trace() -> dict:
    """The ring as a Chrome/Perfetto ``trace_event`` document."""
    return to_chrome_trace(snapshot_spans())


def chrome_trace_bytes() -> bytes:
    return json.dumps(chrome_trace()).encode()


def dump_text() -> str:
    """Human-readable ring dump (``/debug/pprof/trace``)."""
    spans = snapshot_spans()
    head = [
        f"# spans={len(spans)} dropped={dropped()} "
        f"enabled={_tracer is not None}"
    ]
    seen: set = set()
    for sp in spans:
        if sp.trace_id not in seen:
            seen.add(sp.trace_id)
            head.append(f"trace {_fmt_id(sp.trace_id)}:")
            head.append(format_tree(spans, sp.trace_id))
    return "\n".join(head) + "\n"
