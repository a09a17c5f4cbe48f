"""Stage-parallel conversion executor: overlap chunk/digest, compression
and ordered assembly under a bounded memory footprint.

The serial convert walk (converter/pack.Pack) runs its stages
back-to-back per layer: tar scan → chunk+digest → dedup → compress →
assemble. The per-chunk work is independent — chunk cuts depend only on
the file's bytes, digests are pure functions, and every codec used
(lz4_block, zstd at a fixed level) is deterministic — so the stages can
overlap across worker threads as long as the *ordered* parts (dedup
first-wins and blob append order) stay on one thread. This module is
that discipline:

    scan (caller) ──► chunk+digest pool ──► compress pool ──► ordered
                      (GIL-dropping          (speculative,     assembler
                       native/hashlib)        digest-keyed)    (caller)

Memory is bounded at three points, all in BYTES (not item counts,
because chunk sizes are log-spread — a count bound would let a few
max-size chunks blow the budget):

- ``window``:   bytes being *actively chunked* across workers;
- ``queue``:    the compress input queue (ByteBoundedQueue);
- ``budget``:   compressed bytes in flight between a compress worker and
                the assembler pop — a :class:`MemoryBudget` that batch
                conversion SHARES across concurrently converting layers,
                so aggregate convert memory is independent of layer size
                and count.

Under budget pressure a compress worker *sheds* its item instead of
blocking forever (the assembler then compresses that chunk inline) —
speculation degrades, output bytes do not change. That shedding rule is
also what makes the stage graph deadlock-free: every blocking edge
(window → self-released at chunk completion; queue → drained by compress
workers; budget → timed try-acquire) terminates.

Byte identity with the serial walk is a hard invariant: the assembler
performs exactly the serial path's dedup decisions and ``section.add``
calls in tar order; workers only precompute values the serial path would
compute inline (pinned by tests/test_torch_pipeline.py).

Observability: per-stage busy seconds / item / byte counters, queue
depth + high-water gauges and per-run utilization land in
``metrics/registry.default_registry`` (``ntpu_convert_pipeline_*``);
``failpoint.hit`` fires at every stage boundary (``pipeline.chunk``,
``pipeline.queue``, ``pipeline.compress``, ``pipeline.assemble``) so the
overlap is chaos-testable.
"""

from __future__ import annotations

import os
import threading
from collections import deque
from dataclasses import dataclass
from time import perf_counter
from typing import Callable, Optional

from nydus_snapshotter_tpu_torch import failpoint
from nydus_snapshotter_tpu_torch.analysis import runtime as _an
from nydus_snapshotter_tpu_torch.config.config import global_section
from nydus_snapshotter_tpu_torch import trace
from nydus_snapshotter_tpu_torch.metrics import registry as _metrics

DEFAULT_QUEUE_BYTES = 32 << 20
DEFAULT_BUDGET_BYTES = 256 << 20
DEFAULT_WINDOW_BYTES = 64 << 20
MAX_WORKERS = 32
# How long a compress worker waits for budget before shedding its item
# back to the inline path. Performance-only: shedding never changes the
# output bytes, so this does not need to be deterministic.
BUDGET_SHED_TIMEOUT_S = 0.25

_reg = _metrics.default_registry
STAGE_BUSY = _reg.register(
    _metrics.Counter(
        "ntpu_convert_pipeline_stage_busy_seconds",
        "Cumulative busy wall seconds per conversion pipeline stage",
        ("stage",),
    )
)
STAGE_ITEMS = _reg.register(
    _metrics.Counter(
        "ntpu_convert_pipeline_stage_items",
        "Work items processed per conversion pipeline stage",
        ("stage",),
    )
)
STAGE_BYTES = _reg.register(
    _metrics.Counter(
        "ntpu_convert_pipeline_stage_bytes",
        "Payload bytes processed per conversion pipeline stage",
        ("stage",),
    )
)
STAGE_UTIL = _reg.register(
    _metrics.Gauge(
        "ntpu_convert_pipeline_stage_utilization",
        "Busy fraction of stage workers over the last pipeline run",
        ("stage",),
    )
)
QUEUE_DEPTH = _reg.register(
    _metrics.Gauge(
        "ntpu_convert_pipeline_queue_depth_bytes",
        "Current bytes buffered in a pipeline queue",
        ("queue",),
    )
)
QUEUE_HIGH_WATER = _reg.register(
    _metrics.Gauge(
        "ntpu_convert_pipeline_queue_high_water_bytes",
        "High-water bytes a pipeline queue reached in the last run",
        ("queue",),
    )
)
RUNS = _reg.register(
    _metrics.Counter(
        "ntpu_convert_pipeline_runs",
        "Pipelined layer conversions completed",
    )
)
SHED = _reg.register(
    _metrics.Counter(
        "ntpu_convert_pipeline_shed_bytes",
        "Bytes whose speculative compression was shed under budget pressure",
    )
)


class PipelineError(RuntimeError):
    """Internal pipeline control-flow failure (closed queue, abort)."""


# ---------------------------------------------------------------------------
# Bounded primitives
# ---------------------------------------------------------------------------


class MemoryBudget:
    """Aggregate byte budget shared by any number of pipelines.

    ``acquire(n)`` blocks until ``held + n <= total`` — except that a
    caller is always admitted when nothing is held, so one item larger
    than the whole budget degrades to serial admission instead of
    deadlocking (the classic bounded-queue discipline). ``try_acquire``
    is the shedding variant: give up after a timeout so a holder that
    cannot release soon (e.g. an assembler stuck behind this very
    worker) never forms a cycle.
    """

    def __init__(self, total_bytes: int):
        self.total = max(1, int(total_bytes))
        self._held = 0
        self._cv = _an.make_condition("pipeline.memory_budget")

    @property
    def held(self) -> int:
        with self._cv:
            return self._held

    def _admit(self, n: int) -> bool:
        if self._held == 0 or self._held + n <= self.total:
            self._held += n
            return True
        return False

    def acquire(self, n: int, aborted: Optional[Callable[[], bool]] = None) -> None:
        n = max(0, int(n))
        with self._cv:
            while not self._admit(n):
                if aborted is not None and aborted():
                    raise PipelineError("memory budget wait aborted")
                # Short poll: an aborted() flip has no notifier of its own.
                self._cv.wait(0.05)

    def try_acquire(
        self,
        n: int,
        timeout: float,
        aborted: Optional[Callable[[], bool]] = None,
    ) -> bool:
        n = max(0, int(n))
        deadline = perf_counter() + timeout
        with self._cv:
            while not self._admit(n):
                if aborted is not None and aborted():
                    return False
                left = deadline - perf_counter()
                if left <= 0:
                    return False
                self._cv.wait(min(left, 0.05))
            return True

    def release(self, n: int) -> None:
        with self._cv:
            self._held = max(0, self._held - max(0, int(n)))
            self._cv.notify_all()


_CLOSED = object()


class ByteBoundedQueue:
    """FIFO bounded by payload *bytes*. Always admits an item when empty
    (an oversized item passes through alone rather than deadlocking).

    ``close()`` ends the stream: blocked producers raise, consumers
    drain the backlog then receive :data:`CLOSED`. ``fail(exc)`` aborts:
    pending items are dropped and both sides raise ``exc``.
    """

    CLOSED = _CLOSED

    def __init__(self, max_bytes: int, name: str = "q"):
        self.max_bytes = max(1, int(max_bytes))
        self.name = name
        self.high_water = 0
        self._items: deque = deque()
        self._bytes = 0
        self._cv = _an.make_condition(f"pipeline.queue[{name}]")
        self._closed = False
        self._exc: Optional[BaseException] = None

    @property
    def depth_bytes(self) -> int:
        with self._cv:
            return self._bytes

    def put(self, item, cost: int) -> None:
        failpoint.hit("pipeline.queue")
        cost = max(0, int(cost))
        with self._cv:
            while (
                self._exc is None
                and not self._closed
                and self._items
                and self._bytes + cost > self.max_bytes
            ):
                self._cv.wait()
            if self._exc is not None:
                raise self._exc
            if self._closed:
                raise PipelineError(f"put on closed queue {self.name!r}")
            self._items.append((item, cost))
            self._bytes += cost
            if self._bytes > self.high_water:
                self.high_water = self._bytes
                QUEUE_HIGH_WATER.labels(self.name).set(self.high_water)
            QUEUE_DEPTH.labels(self.name).set(self._bytes)
            self._cv.notify_all()

    def get(self):
        with self._cv:
            while not self._items and not self._closed and self._exc is None:
                self._cv.wait()
            if self._exc is not None:
                raise self._exc
            if self._items:
                item, cost = self._items.popleft()
                self._bytes -= cost
                QUEUE_DEPTH.labels(self.name).set(self._bytes)
                self._cv.notify_all()
                return item
            return _CLOSED

    def get_nowait(self):
        """One item if immediately available, else ``None`` — the
        closed/empty stream state is left for the next blocking
        :meth:`get` (batch-draining consumers take the first item
        blocking, then top the batch up with this)."""
        with self._cv:
            if self._exc is not None:
                raise self._exc
            if not self._items:
                return None
            item, cost = self._items.popleft()
            self._bytes -= cost
            QUEUE_DEPTH.labels(self.name).set(self._bytes)
            self._cv.notify_all()
            return item

    def close(self) -> None:
        with self._cv:
            self._closed = True
            self._cv.notify_all()

    def fail(self, exc: BaseException) -> None:
        with self._cv:
            self._exc = exc
            self._items.clear()
            self._bytes = 0
            QUEUE_DEPTH.labels(self.name).set(0)
            self._cv.notify_all()


# ---------------------------------------------------------------------------
# Configuration
# ---------------------------------------------------------------------------


@dataclass
class PipelineConfig:
    enabled: bool = False
    chunk_workers: int = 2
    compress_workers: int = 2
    queue_bytes: int = DEFAULT_QUEUE_BYTES
    budget_bytes: int = DEFAULT_BUDGET_BYTES
    window_bytes: int = DEFAULT_WINDOW_BYTES


def _env_int(name: str, default: int) -> int:
    try:
        v = int(os.environ.get(name, ""))
        return v if v > 0 else default
    except ValueError:
        return default


def resolve_config(n_threads: int) -> PipelineConfig:
    """Resolve the pipeline knobs: env > ``[convert]`` config > defaults.

    ``n_threads`` is the pack-path worker request (converter/pack._pack_threads,
    already clamped to the core count unless forced); mode ``auto``
    engages the pipeline exactly when there is more than one worker to
    overlap with.
    """
    conv = global_section("convert")
    mode = os.environ.get("NTPU_PIPELINE", "") or (
        getattr(conv, "pipeline", "") or "auto"
    )
    if mode in ("0", "off", "false"):
        return PipelineConfig(enabled=False)
    forced = mode in ("1", "on", "true")
    enabled = forced or n_threads > 1
    chunk_workers = _env_int(
        "NTPU_CHUNK_THREADS", getattr(conv, "chunk_workers", 0) or n_threads
    )
    compress_workers = _env_int(
        "NTPU_COMPRESS_THREADS", getattr(conv, "compress_workers", 0) or n_threads
    )
    if forced:
        chunk_workers = max(2, chunk_workers)
        compress_workers = max(2, compress_workers)
    return PipelineConfig(
        enabled=enabled and chunk_workers >= 1,
        chunk_workers=min(MAX_WORKERS, max(1, chunk_workers)),
        compress_workers=min(MAX_WORKERS, max(1, compress_workers)),
        queue_bytes=_env_int(
            "NTPU_PIPELINE_QUEUE_MIB", getattr(conv, "queue_mib", 0) or 32
        )
        << 20,
        budget_bytes=_env_int(
            "NTPU_PIPELINE_BUDGET_MIB", getattr(conv, "memory_budget_mib", 0) or 256
        )
        << 20,
        window_bytes=_env_int(
            "NTPU_PIPELINE_WINDOW_MIB", getattr(conv, "window_mib", 0) or 64
        )
        << 20,
    )


def resolve_batch_chunks() -> int:
    """``[compression] batch_chunks``, as the codec config resolves it
    (converter/codec.resolve_codec_config: ``NTPU_COMPRESS_BATCH_CHUNKS``,
    0 allowed, > config > 16)."""
    from nydus_snapshotter_tpu_torch.converter.codec import resolve_codec_config

    return resolve_codec_config().batch_chunks


_shared_budget: Optional[MemoryBudget] = None
_shared_budget_lock = threading.Lock()


def shared_budget() -> MemoryBudget:
    """Process-wide default :class:`MemoryBudget` — every Pack without an
    explicit budget shares it, so concurrent conversions anywhere in the
    process stay under one aggregate cap."""
    global _shared_budget
    with _shared_budget_lock:
        if _shared_budget is None:
            conv = global_section("convert")
            mib = _env_int(
                "NTPU_PIPELINE_BUDGET_MIB",
                getattr(conv, "memory_budget_mib", 0) or 256,
            )
            _shared_budget = MemoryBudget(mib << 20)
        return _shared_budget


# ---------------------------------------------------------------------------
# Stage bookkeeping
# ---------------------------------------------------------------------------


@dataclass
class StageStats:
    busy_s: float = 0.0
    items: int = 0
    bytes: int = 0


_COMP_SHED = object()  # speculation shed under budget pressure


class _CompCache:
    """Digest-keyed speculative-compression results with blocking pop.

    ``pop(digest)`` mirrors the plain-dict ``comp_cache.pop`` contract of
    the serial walk: returns the compressed ``(bytes, flag)`` for a
    digest that was submitted to the compress pool (waiting for an
    in-flight worker if needed), or ``default`` for digests that never
    were — the assembler then compresses inline, byte-identically.
    """

    def __init__(self, pipeline: "ConvertPipeline"):
        self._p = pipeline
        self._cv = _an.make_condition("pipeline.comp_cache")
        self._submitted: set[bytes] = set()
        self._results: dict[bytes, object] = {}
        self._charges: dict[bytes, int] = {}

    def __bool__(self) -> bool:
        return True

    def submit_marker(self, digest: bytes) -> bool:
        """Record a digest as owned by the compress stage (once)."""
        with self._cv:
            if digest in self._submitted:
                return False
            self._submitted.add(digest)
            return True

    def deliver(self, digest: bytes, result, charge: int) -> None:
        with self._cv:
            self._results[digest] = result
            if charge:
                self._charges[digest] = charge
            self._cv.notify_all()

    def pop(self, digest: bytes, default=None):
        with self._cv:
            if digest not in self._submitted:
                return default
            while digest not in self._results:
                if self._p._error is not None:
                    raise_from_pipeline(self._p._error)
                self._cv.wait(0.05)
            result = self._results.pop(digest)
            charge = self._charges.pop(digest, 0)
        if charge:
            self._p.budget.release(charge)
        if result is _COMP_SHED:
            return default
        return result

    def drain_charges(self) -> None:
        """Release whatever the assembler never popped (abort path, or a
        submitted digest whose first occurrence turned out dict-deduped)."""
        with self._cv:
            charges = list(self._charges.values())
            self._charges.clear()
            self._results.clear()
        for c in charges:
            self._p.budget.release(c)


def raise_from_pipeline(exc: BaseException) -> None:
    raise exc


# ---------------------------------------------------------------------------
# The executor
# ---------------------------------------------------------------------------


class ConvertPipeline:
    """One layer's overlapped chunk/digest → compress → assemble run.

    Use as a context manager around the ordered assembly walk::

        pipe = ConvertPipeline(items=[(i, nbytes), ...], chunk_fn=...,
                               compress_fn=..., compress_eligible=...,
                               config=resolve_config(n_threads))
        with pipe:
            for i in plan_order:
                chunks = pipe.chunks_for(i)   # blocks; re-raises errors
                ...  # serial dedup + section.add, precomp via pipe.comp

    ``chunk_fn(key)`` must return the same ``[(view, digest|None)]`` list
    the serial walk would compute for that key (workers call it
    concurrently — it must be thread-safe). When ``compress_fn`` is set,
    every chunk passing ``compress_eligible(digest, view)`` is
    speculatively compressed once per unique digest; the assembler
    collects results through :attr:`comp`.

    The first stage error (including injected ``failpoint.Panic``) aborts
    the run: queues fail, workers drain and join, and the error re-raises
    on the caller thread from ``chunks_for``/``comp.pop``/``__exit__``.
    """

    def __init__(
        self,
        *,
        items: list[tuple],  # (key, nbytes) in deterministic order
        chunk_fn: Callable,
        compress_fn: Optional[Callable] = None,
        compress_eligible: Optional[Callable] = None,
        config: Optional[PipelineConfig] = None,
        budget: Optional[MemoryBudget] = None,
        stats: Optional[dict] = None,
    ):
        self.cfg = config or resolve_config(os.cpu_count() or 1)
        self.items = list(items)
        self.chunk_fn = chunk_fn
        self.compress_fn = compress_fn
        self.compress_eligible = compress_eligible
        self.budget = budget or shared_budget()
        self.stats = stats
        self.comp = _CompCache(self)
        self._window = MemoryBudget(self.cfg.window_bytes)
        self._q_comp = ByteBoundedQueue(self.cfg.queue_bytes, name="compress_input")
        self._next = 0  # index into items, guarded by _lock
        self._results: dict = {}
        self._result_charge: dict = {}
        self._lock = _an.make_lock("pipeline.assembly")
        self._cv = _an.make_condition("pipeline.assembly", self._lock)
        self._error: Optional[BaseException] = None
        self._abort = threading.Event()
        self._threads: list[threading.Thread] = []
        self._stage = {"chunk": StageStats(), "compress": StageStats()}
        self._assemble_wait_s = 0.0
        self._started = False
        self._wall_start = 0.0
        self._trace_ctx = None

    # -- lifecycle ----------------------------------------------------------

    def __enter__(self) -> "ConvertPipeline":
        self._wall_start = perf_counter()
        # Trace context of the converting caller: stage workers adopt it
        # so their lifetime spans land in the conversion's trace (one span
        # per WORKER, never per chunk — tracing must not tax the hot loop).
        self._trace_ctx = trace.capture()
        n_chunk = min(self.cfg.chunk_workers, max(1, len(self.items)))
        for w in range(n_chunk):
            t = threading.Thread(
                target=self._chunk_worker, name=f"ntpu-pipe-chunk-{w}", daemon=True
            )
            t.start()
            self._threads.append(t)
        if self.compress_fn is not None:
            for w in range(self.cfg.compress_workers):
                t = threading.Thread(
                    target=self._compress_worker,
                    name=f"ntpu-pipe-comp-{w}",
                    daemon=True,
                )
                t.start()
                self._threads.append(t)
        self._started = True
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        if exc is not None:
            self._fail(exc)
        self._q_comp.close()
        for t in self._threads:
            t.join()
        self.comp.drain_charges()
        self._publish()
        if exc is None and self._error is not None:
            raise_from_pipeline(self._error)
        return False

    def _aborted(self) -> bool:
        return self._abort.is_set()

    def _fail(self, exc: BaseException) -> None:
        with self._lock:
            if self._error is None:
                self._error = exc
            self._cv.notify_all()
        self._abort.set()
        self._q_comp.fail(
            exc if isinstance(exc, Exception) else PipelineError(str(exc))
        )

    # -- chunk stage --------------------------------------------------------

    def _next_item(self):
        with self._lock:
            if self._abort.is_set() or self._next >= len(self.items):
                return None
            idx = self._next
            self._next += 1
        return self.items[idx]

    def _chunk_worker(self) -> None:
        with trace.with_context(self._trace_ctx), trace.span(
            "convert.chunk.worker"
        ):
            self._chunk_worker_loop()

    def _chunk_worker_loop(self) -> None:
        st = self._stage["chunk"]
        try:
            while True:
                item = self._next_item()
                if item is None:
                    return
                key, nbytes = item
                self._window.acquire(nbytes, aborted=self._aborted)
                try:
                    failpoint.hit("pipeline.chunk")
                    t0 = perf_counter()
                    chunks = self.chunk_fn(key)
                    busy = perf_counter() - t0
                finally:
                    # Window bounds bytes being ACTIVELY chunked; results
                    # are zero-copy views into the already-resident layer.
                    self._window.release(nbytes)
                if self.compress_fn is not None:
                    for view, digest in chunks:
                        if digest is None or self._abort.is_set():
                            continue
                        if self.compress_eligible is not None and not self.compress_eligible(
                            digest, view
                        ):
                            continue
                        if self.comp.submit_marker(digest):
                            self._q_comp.put((digest, view), len(view))
                with self._lock:
                    st.busy_s += busy
                    st.items += 1
                    st.bytes += nbytes
                    self._results[key] = chunks
                    self._cv.notify_all()
        except BaseException as e:  # noqa: BLE001 — includes failpoint.Panic
            self._fail(e)

    # -- compress stage -----------------------------------------------------

    @staticmethod
    def _comp_bound(n: int) -> int:
        # LZ4_compressBound-shaped worst case; also ample for zstd.
        return n + n // 255 + 64

    def _compress_worker(self) -> None:
        with trace.with_context(self._trace_ctx), trace.span(
            "convert.compress.worker"
        ):
            self._compress_worker_loop()

    def _compress_batch_cap(self) -> int:
        """How many queued chunks one worker may drain into a single
        ``encode_many`` call (``[compression] batch_chunks``; ≤1 =
        per-chunk). Only engages when ``compress_fn`` exposes the batch
        seam (converter.convert.ThreadSafeCompressor)."""
        if not hasattr(self.compress_fn, "encode_many"):
            return 1
        return max(1, resolve_batch_chunks())

    def _compress_worker_loop(self) -> None:
        st = self._stage["compress"]
        batch_cap = self._compress_batch_cap()
        try:
            while True:
                item = self._q_comp.get()
                if item is _CLOSED:
                    return
                if batch_cap > 1:
                    self._compress_batch(st, item, batch_cap)
                    continue
                digest, view = item
                failpoint.hit("pipeline.compress")
                charge = self._comp_bound(len(view))
                if not self.budget.try_acquire(
                    charge, BUDGET_SHED_TIMEOUT_S, aborted=self._aborted
                ):
                    # Shed: the assembler compresses this chunk inline —
                    # identical bytes, bounded memory.
                    SHED.inc(len(view))
                    self.comp.deliver(digest, _COMP_SHED, 0)
                    continue
                try:
                    t0 = perf_counter()
                    result = self.compress_fn(view)
                    busy = perf_counter() - t0
                except BaseException:
                    self.budget.release(charge)
                    raise
                self.comp.deliver(digest, result, charge)
                with self._lock:
                    st.busy_s += busy
                    st.items += 1
                    st.bytes += len(view)
        except PipelineError:
            return  # queue failed during abort: first error already stored
        except BaseException as e:  # noqa: BLE001
            self._fail(e)

    def _compress_batch(self, st, first, cap: int) -> None:
        """Drain up to ``cap`` queued chunks (non-blocking past the first)
        into one ``compress_fn.encode_many`` call — a single GIL-released
        native batch for the plain-zstd frames. Budget charge, shed
        fallback and result delivery stay PER CHUNK, so memory bounds and
        the shed path are unchanged; only the codec call is amortized and
        the output stays byte-identical to the per-chunk lane."""
        items = [first]
        while len(items) < cap:
            nxt = self._q_comp.get_nowait()
            if nxt is None:
                break
            items.append(nxt)
        accepted: list = []
        try:
            for digest, view in items:
                failpoint.hit("pipeline.compress")
                charge = self._comp_bound(len(view))
                if not self.budget.try_acquire(
                    charge, BUDGET_SHED_TIMEOUT_S, aborted=self._aborted
                ):
                    SHED.inc(len(view))
                    self.comp.deliver(digest, _COMP_SHED, 0)
                    continue
                accepted.append((digest, view, charge))
            if not accepted:
                return
            t0 = perf_counter()
            results = self.compress_fn.encode_many([v for _, v, _ in accepted])
            busy = perf_counter() - t0
        except BaseException:
            for _digest, _view, charge in accepted:
                self.budget.release(charge)
            raise
        for (digest, _view, charge), result in zip(accepted, results):
            self.comp.deliver(digest, result, charge)
        with self._lock:
            st.busy_s += busy
            st.items += len(accepted)
            st.bytes += sum(len(v) for _, v, _ in accepted)

    # -- assembler side -----------------------------------------------------

    def chunks_for(self, key):
        """Blocking, in-order retrieval of one file's chunk list."""
        failpoint.hit("pipeline.assemble")
        t0 = perf_counter()
        with self._lock:
            while key not in self._results and self._error is None:
                self._cv.wait(0.05)
            if self._error is not None and key not in self._results:
                raise_from_pipeline(self._error)
            chunks = self._results.pop(key)
        self._assemble_wait_s += perf_counter() - t0
        return chunks

    # -- reporting ----------------------------------------------------------

    def _publish(self) -> None:
        wall = max(1e-9, perf_counter() - self._wall_start)
        RUNS.inc()
        n_chunk = min(self.cfg.chunk_workers, max(1, len(self.items)))
        workers = {"chunk": n_chunk, "compress": self.cfg.compress_workers}
        for name, st in self._stage.items():
            if name == "compress" and self.compress_fn is None:
                continue
            STAGE_BUSY.labels(name).inc(st.busy_s)
            STAGE_ITEMS.labels(name).inc(st.items)
            STAGE_BYTES.labels(name).inc(st.bytes)
            STAGE_UTIL.labels(name).set(
                min(1.0, st.busy_s / (wall * max(1, workers[name])))
            )
        QUEUE_HIGH_WATER.labels(self._q_comp.name).set(self._q_comp.high_water)
        if self.stats is not None:
            s = self.stats
            s["pipeline_chunk_busy"] = (
                s.get("pipeline_chunk_busy", 0.0) + self._stage["chunk"].busy_s
            )
            s["pipeline_compress_busy"] = (
                s.get("pipeline_compress_busy", 0.0)
                + self._stage["compress"].busy_s
            )
            s["pipeline_assemble_wait"] = (
                s.get("pipeline_assemble_wait", 0.0) + self._assemble_wait_s
            )
            s["pipeline_runs"] = s.get("pipeline_runs", 0.0) + 1.0


def snapshot_counters() -> dict:
    """Current cumulative pipeline metric values (bench deltas these
    around a run to report per-run stage numbers)."""
    out = {
        "runs": RUNS.value(),
        "shed_bytes": SHED.value(),
        "stage_busy_s": {},
        "stage_items": {},
        "stage_bytes": {},
        "stage_utilization": {},
        "queue_high_water_bytes": {},
    }
    for stage in ("chunk", "compress"):
        out["stage_busy_s"][stage] = STAGE_BUSY.value(stage)
        out["stage_items"][stage] = STAGE_ITEMS.value(stage)
        out["stage_bytes"][stage] = STAGE_BYTES.value(stage)
        util = STAGE_UTIL.value(stage)
        if util is not None:
            out["stage_utilization"][stage] = util
    hw = QUEUE_HIGH_WATER.value("compress_input")
    if hw is not None:
        out["queue_high_water_bytes"]["compress_input"] = hw
    return out
