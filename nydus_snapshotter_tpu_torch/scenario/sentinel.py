"""Leak sentinels: process-resource snapshots + growth-bound fitting.

A worst-day storm proves correctness under chaos; only a long soak
proves the stack is not *slowly* losing — RSS creeping per epoch, fds
left open by a teardown path, metastore rows surviving their remove,
cache entries outliving GC, trace spans dropped because the ring never
drains. This module is the shared measurement core (grown out of
``orchestrator.audit()``, which keeps the row/cache *consistency* side):

* :func:`snapshot` — one point-in-time sample: RSS (``/proc/self/status``
  ``VmRSS``, ``resource.getrusage`` fallback), open fds
  (``/proc/self/fd``), thread count, trace-ring drop total, plus any
  caller-supplied series (the soak feeds ``metastore_rows`` /
  ``cache_entries`` from the per-epoch audit).
* :class:`SentinelSeries` — accumulates one sample per epoch and fits a
  least-squares growth slope per series. A series whose slope exceeds
  its configured per-epoch bound is a leak finding: loud, named, and
  fatal to the run that asked.

Consumers: ``scenario/soak.py`` (per-epoch, fatal on violation) and
``chip_smoke.py`` phase 25 (the storm's fd/thread growth across its
runs).
Metrics: the ``ntpu_soak_*`` gauges mirror the latest sample;
``ntpu_soak_leak_alerts_total`` counts bound violations by series.
"""

from __future__ import annotations

import os
import threading
from typing import Optional

from nydus_snapshotter_tpu_torch import trace
from nydus_snapshotter_tpu_torch.metrics import registry as _metrics

_reg = _metrics.default_registry

SOAK_RSS = _reg.register(
    _metrics.Gauge(
        "ntpu_soak_rss_bytes",
        "Resident set size at the last leak-sentinel sample",
    )
)
SOAK_FDS = _reg.register(
    _metrics.Gauge(
        "ntpu_soak_open_fds",
        "Open file descriptors at the last leak-sentinel sample",
    )
)
SOAK_THREADS = _reg.register(
    _metrics.Gauge(
        "ntpu_soak_threads",
        "Live Python threads at the last leak-sentinel sample",
    )
)
SOAK_ROWS = _reg.register(
    _metrics.Gauge(
        "ntpu_soak_metastore_rows",
        "Metastore snapshot rows at the last leak-sentinel sample",
    )
)
SOAK_CACHE_ENTRIES = _reg.register(
    _metrics.Gauge(
        "ntpu_soak_cache_entries",
        "Cache-dir entries at the last leak-sentinel sample",
    )
)
LEAK_ALERTS = _reg.register(
    _metrics.Counter(
        "ntpu_soak_leak_alerts_total",
        "Leak-sentinel growth-bound violations, by series",
        ("series",),
    )
)

# Gauge mirror for the caller-supplied series names the soak feeds.
_SERIES_GAUGES = {
    "rss_bytes": SOAK_RSS,
    "open_fds": SOAK_FDS,
    "threads": SOAK_THREADS,
    "metastore_rows": SOAK_ROWS,
    "cache_entries": SOAK_CACHE_ENTRIES,
}


def rss_bytes() -> int:
    """Resident set size, bytes. ``/proc`` when available (Linux),
    peak-RSS via ``resource`` otherwise (coarser, but monotone — a
    growth bound on it still catches a leak)."""
    try:
        with open("/proc/self/status", "r", encoding="ascii") as f:
            for line in f:
                if line.startswith("VmRSS:"):
                    return int(line.split()[1]) << 10
    except (OSError, ValueError, IndexError):
        pass
    try:
        import resource

        return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss << 10
    except Exception:
        return 0


def open_fds() -> int:
    """Open descriptor count via ``/proc/self/fd``; -1 when the platform
    has no cheap enumeration (series is then skipped by the fitter)."""
    try:
        return len(os.listdir("/proc/self/fd"))
    except OSError:
        return -1


def snapshot(extra: Optional[dict] = None) -> dict:
    """One sentinel sample; ``extra`` merges caller-owned series (e.g.
    the audit's row/cache-entry counts). Mirrors known series into the
    ``ntpu_soak_*`` gauges."""
    s = {
        "rss_bytes": rss_bytes(),
        "open_fds": open_fds(),
        "threads": threading.active_count(),
        "trace_drops": trace.dropped(),
    }
    if extra:
        s.update(extra)
    for name, gauge in _SERIES_GAUGES.items():
        if name in s and s[name] >= 0:
            gauge.set(float(s[name]))
    return s


def fit_slope(values: list, warmup: int = 1) -> float:
    """Least-squares growth per sample over a series. The first
    ``warmup`` samples are dropped once at least 2 non-warmup samples
    remain — the ramp epochs (imports, pools, per-shape JIT compiles)
    are allocation, not leak, and they dominate any short fit."""
    xs = [float(v) for v in values]
    drop = max(0, int(warmup))
    if len(xs) >= drop + 2:
        xs = xs[drop:]
    n = len(xs)
    if n < 2:
        return 0.0
    mean_i = (n - 1) / 2.0
    mean_v = sum(xs) / n
    num = sum((i - mean_i) * (v - mean_v) for i, v in enumerate(xs))
    den = sum((i - mean_i) ** 2 for i in range(n))
    return num / den if den else 0.0


class SentinelSeries:
    """One sample per epoch; slope-vs-bound verdicts on demand.

    ``bounds`` maps series name -> max allowed per-epoch growth (same
    unit as the series). Series without a bound are tracked and reported
    but never gate. A negative sample value marks the series unavailable
    on this platform and exempts it. ``warmup`` leading samples are
    excluded from every fit (see :func:`fit_slope`); gating starts at
    ``min_samples``, which is clamped to leave at least 2 fitted points
    past the warmup.
    """

    def __init__(self, bounds: dict, min_samples: int = 3, warmup: int = 1):
        self.bounds = dict(bounds)
        self.warmup = max(0, int(warmup))
        self.min_samples = max(2, self.warmup + 2, min_samples)
        self.samples: list[dict] = []

    def sample(self, extra: Optional[dict] = None) -> dict:
        s = snapshot(extra)
        self.samples.append(s)
        return s

    def series(self, name: str) -> list:
        return [s[name] for s in self.samples if name in s]

    def slopes(self) -> dict:
        names: list[str] = []
        for s in self.samples:
            for k in s:
                if k not in names:
                    names.append(k)
        out = {}
        for name in names:
            vals = self.series(name)
            if vals and min(vals) >= 0:
                out[name] = round(fit_slope(vals, warmup=self.warmup), 4)
        return out

    def check(self) -> list:
        """Bound violations as human-readable issue strings (and the
        ``ntpu_soak_leak_alerts_total`` bump) — empty means healthy."""
        issues = []
        if len(self.samples) < self.min_samples:
            return issues
        slopes = self.slopes()
        for name, bound in sorted(self.bounds.items()):
            slope = slopes.get(name)
            if slope is None:
                continue
            if slope > bound:
                LEAK_ALERTS.labels(name).inc()
                issues.append(
                    f"leak sentinel: {name} grows {slope:+.2f}/epoch "
                    f"(bound {bound:+.2f}/epoch over {len(self.samples)} samples)"
                )
        return issues

    def report(self) -> dict:
        return {
            "samples": len(self.samples),
            "slopes": self.slopes(),
            "bounds": dict(self.bounds),
            "issues": self.check(),
        }
