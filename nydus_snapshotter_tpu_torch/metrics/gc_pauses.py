"""The interpreter's collector pauses: the port's counterpart of the
``go_gc_duration_seconds`` the reference's Prometheus exporter serves.

One ``gc.callbacks`` hook, installed at import, times every collection:
``ntpu_gc_pause_seconds{generation}`` (seconds from the collection's start
to its stop) and ``ntpu_gc_collections{generation}``. A collection can
start on any thread, including one that holds a registry or ring lock, so
the callback takes no lock: it keeps plain per-generation totals (CPython
runs one collection at a time, its callbacks included) that two
:class:`LazyCounter` fold into the exposition at scrape time. While a
``torch.profiler`` records, each gen-2 pause is a ``gc.gen2`` range in the
profile (utils/profiler_ranges.py).
"""

from __future__ import annotations

import gc
from time import perf_counter

from nydus_snapshotter_tpu_torch.metrics.registry import LazyCounter, default_registry
from nydus_snapshotter_tpu_torch.utils import profiler_ranges as _prof

GENERATIONS = (0, 1, 2)

PAUSE_SECONDS = default_registry.register(
    LazyCounter(
        "ntpu_gc_pause_seconds",
        "Seconds the interpreter's collector ran, per generation collected",
        ("generation",),
    )
)
COLLECTIONS = default_registry.register(
    LazyCounter(
        "ntpu_gc_collections",
        "Collections the interpreter's collector ran, per generation collected",
        ("generation",),
    )
)

_started = [0.0] * len(GENERATIONS)
_seconds = [0.0] * len(GENERATIONS)
_count = [0] * len(GENERATIONS)
_gen2_range = None


def _on_gc(phase: str, info: dict) -> None:
    global _gen2_range
    gen = info["generation"]
    if phase == "start":
        if gen == 2 and _prof.recording():
            _gen2_range = _prof.open_range("gc.gen2")
        _started[gen] = perf_counter()
        return
    _seconds[gen] += perf_counter() - _started[gen]
    _count[gen] += 1
    if _gen2_range is not None and gen == 2:
        _prof.close_range(_gen2_range)
        _gen2_range = None


PAUSE_SECONDS.bind(lambda: {(str(g),): _seconds[g] for g in GENERATIONS})
COLLECTIONS.bind(lambda: {(str(g),): _count[g] for g in GENERATIONS})
if _on_gc not in gc.callbacks:
    gc.callbacks.append(_on_gc)
