"""Named ranges in a recording ``torch.profiler``, without importing torch.

The tracer's spans (trace/) and the collector's gen-2 pauses
(metrics/gc_pauses.py) open a range of their own name while a profiler
records, so the program's stages sit in the profile on the same clock as
the card's kernels and copies. Neither module may import torch (the
daemon and the snapshotter stack run without it): torch is looked up in
``sys.modules``, and whether a profiler records is one attribute read of
``torch.autograd.profiler``'s process-wide flag.

A profiler started on one thread records another thread's ranges only
with ``experimental_config=torch._C._profiler._ExperimentalConfig(
profile_all_threads=True)``; otherwise the ranges of the conversion's
pool threads cost their open and close and record nothing.
"""

from __future__ import annotations

import sys

_flags = None  # torch.autograd.profiler, once torch is imported
_range_cls = None


def recording() -> bool:
    """Whether a ``torch.profiler`` records in this process."""
    global _flags
    mod = _flags
    if mod is None:
        mod = _flags = sys.modules.get("torch.autograd.profiler")
        if mod is None:
            return False
    # a collection can run while torch is still importing the module
    return getattr(mod, "_is_profiler_enabled", False)


def open_range(name: str):
    """Open a profiler range named ``name`` on this thread -> its handle
    for :func:`close_range`. Call only while :func:`recording`.

    The range is a plain ``RecordFunction`` (the profiler's op scope), not
    a user annotation: a user annotation would also put a
    ``gpu_user_annotation`` interval over the kernels it encloses on the
    device timeline, and count as device time there."""
    global _range_cls
    if _range_cls is None:
        _range_cls = sys.modules["torch"]._C._profiler._RecordFunctionFast
    rf = _range_cls(name)
    rf.__enter__()
    return rf


def close_range(handle) -> None:
    handle.__exit__(None, None, None)
