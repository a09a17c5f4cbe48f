"""Prometheus-compatible metric primitives + text-format registry.

Replaces the prometheus client_golang dependency (reference
pkg/metrics/registry/registry.go, types/ttl/gauge.go) with a small
threadsafe implementation that renders the v0 text exposition format.
"""

from __future__ import annotations

import math
import threading
import time
from typing import Optional, Sequence

DEFAULT_DURATION_BUCKETS = (0.5, 1, 5, 10, 50, 100, 150, 200, 250, 300, 350, 400, 600, 1000)


def _fmt_value(v: float) -> str:
    if v == math.inf:
        return "+Inf"
    if v == int(v):
        return str(int(v))
    return repr(v)


def _fmt_labels(names: Sequence[str], values: Sequence[str]) -> str:
    if not names:
        return ""
    inner = ",".join(
        f'{n}="{str(v).replace(chr(92), chr(92) * 2).replace(chr(34), chr(92) + chr(34))}"'
        for n, v in zip(names, values)
    )
    return "{" + inner + "}"


class _Metric:
    kind = "untyped"

    def __init__(self, name: str, help_: str, label_names: Sequence[str] = ()):
        self.name = name
        self.help = help_
        self.label_names = tuple(label_names)
        self._lock = threading.Lock()

    def render(self) -> str:
        raise NotImplementedError


class Counter(_Metric):
    kind = "counter"

    def __init__(self, name: str, help_: str, label_names: Sequence[str] = ()):
        super().__init__(name, help_, label_names)
        self._values: dict[tuple, float] = {}

    def labels(self, *values: str) -> "_CounterChild":
        if len(values) != len(self.label_names):
            raise ValueError(f"{self.name}: expected {len(self.label_names)} labels")
        return _CounterChild(self, tuple(str(v) for v in values))

    def inc(self, amount: float = 1.0) -> None:
        if self.label_names:
            raise ValueError(f"{self.name}: labelled counter needs .labels(...)")
        self._inc((), amount)

    def _inc(self, key: tuple, amount: float) -> None:
        with self._lock:
            self._values[key] = self._values.get(key, 0.0) + amount

    def value(self, *values: str) -> float:
        with self._lock:
            return self._values.get(tuple(str(v) for v in values), 0.0)

    def render(self) -> str:
        lines = [f"# HELP {self.name} {self.help}", f"# TYPE {self.name} {self.kind}"]
        with self._lock:
            items = sorted(self._values.items()) or ([((), 0.0)] if not self.label_names else [])
        for key, val in items:
            lines.append(f"{self.name}{_fmt_labels(self.label_names, key)} {_fmt_value(val)}")
        return "\n".join(lines)


class LazyCounter(Counter):
    """Counter whose value is pulled from a callback at read/render time.

    A hot path that must not take the registry metric lock per event (the
    span ring, the collector's callback) keeps exact totals of its own, and
    this counter folds them into the exposition only when someone actually
    looks (scrape, ``.value()``). The callback returns the total, or for a
    labelled counter ``{label values tuple: total}``.
    """

    def __init__(self, name: str, help_: str, label_names: Sequence[str] = ()):
        super().__init__(name, help_, label_names)
        self._fn = None

    def bind(self, fn) -> None:
        self._fn = fn

    def _sync(self) -> None:
        if self._fn is not None:
            got = self._fn()
            items = got.items() if isinstance(got, dict) else (((), got),)
            with self._lock:
                for key, total in items:
                    self._values[key] = float(total)

    def value(self, *values: str) -> float:
        self._sync()
        return super().value(*values)

    def render(self) -> str:
        self._sync()
        return super().render()


class _CounterChild:
    def __init__(self, parent: Counter, key: tuple):
        self._parent = parent
        self._key = key

    def inc(self, amount: float = 1.0) -> None:
        self._parent._inc(self._key, amount)


class Gauge(_Metric):
    kind = "gauge"

    def __init__(self, name: str, help_: str, label_names: Sequence[str] = ()):
        super().__init__(name, help_, label_names)
        self._values: dict[tuple, float] = {}

    def labels(self, *values: str) -> "_GaugeChild":
        if len(values) != len(self.label_names):
            raise ValueError(f"{self.name}: expected {len(self.label_names)} labels")
        return _GaugeChild(self, tuple(str(v) for v in values))

    def set(self, value: float) -> None:
        self._set((), value)

    def _set(self, key: tuple, value: float) -> None:
        with self._lock:
            self._values[key] = float(value)

    def value(self, *values: str) -> Optional[float]:
        with self._lock:
            return self._values.get(tuple(str(v) for v in values))

    def remove(self, *values: str) -> None:
        with self._lock:
            self._values.pop(tuple(str(v) for v in values), None)

    def render(self) -> str:
        lines = [f"# HELP {self.name} {self.help}", f"# TYPE {self.name} {self.kind}"]
        with self._lock:
            items = sorted(self._values.items()) or ([((), 0.0)] if not self.label_names else [])
        for key, val in items:
            lines.append(f"{self.name}{_fmt_labels(self.label_names, key)} {_fmt_value(val)}")
        return "\n".join(lines)


class _GaugeChild:
    def __init__(self, parent: Gauge, key: tuple):
        self._parent = parent
        self._key = key

    def set(self, value: float) -> None:
        self._parent._set(self._key, value)


class TTLGauge(Gauge):
    """Gauge whose series expire `ttl` seconds after their last set —
    daemon-event style metrics vanish when the daemon stops reporting
    (reference types/ttl/gauge.go)."""

    def __init__(self, name: str, help_: str, label_names: Sequence[str] = (), ttl_sec: float = 120.0,
                 clock=time.monotonic):
        super().__init__(name, help_, label_names)
        self.ttl = ttl_sec
        self._clock = clock
        self._stamps: dict[tuple, float] = {}

    def _set(self, key: tuple, value: float) -> None:
        with self._lock:
            self._values[key] = float(value)
            self._stamps[key] = self._clock()

    def _expire(self) -> None:
        now = self._clock()
        for key in [k for k, t in self._stamps.items() if now - t > self.ttl]:
            self._stamps.pop(key, None)
            self._values.pop(key, None)

    def render(self) -> str:
        with self._lock:
            self._expire()
        return super().render()


class Histogram(_Metric):
    kind = "histogram"

    def __init__(self, name: str, help_: str, label_names: Sequence[str] = (),
                 buckets: Sequence[float] = DEFAULT_DURATION_BUCKETS):
        super().__init__(name, help_, label_names)
        self.buckets = tuple(sorted(buckets))
        self._counts: dict[tuple, list[int]] = {}
        self._sums: dict[tuple, float] = {}
        self._totals: dict[tuple, int] = {}

    def labels(self, *values: str) -> "_HistChild":
        if len(values) != len(self.label_names):
            raise ValueError(f"{self.name}: expected {len(self.label_names)} labels")
        return _HistChild(self, tuple(str(v) for v in values))

    def observe(self, value: float) -> None:
        self._observe((), value)

    def _observe(self, key: tuple, value: float) -> None:
        with self._lock:
            counts = self._counts.setdefault(key, [0] * len(self.buckets))
            for i, ub in enumerate(self.buckets):
                if value <= ub:
                    counts[i] += 1
            self._sums[key] = self._sums.get(key, 0.0) + value
            self._totals[key] = self._totals.get(key, 0) + 1

    def cumulative_le(self, threshold: float) -> dict[tuple, tuple[int, int]]:
        """{label_values: (observations in buckets <= threshold, total)}.

        ``threshold`` is resolved to the smallest bucket upper bound that
        is >= it (the SLO engine aligns thresholds to bucket boundaries);
        past the last bucket every observation qualifies.
        """
        idx = None
        for i, ub in enumerate(self.buckets):
            if threshold <= ub:
                idx = i
                break
        with self._lock:
            out = {}
            for key, counts in self._counts.items():
                total = self._totals.get(key, 0)
                good = total if idx is None else counts[idx]
                out[key] = (good, total)
            return out

    def render(self) -> str:
        lines = [f"# HELP {self.name} {self.help}", f"# TYPE {self.name} {self.kind}"]
        with self._lock:
            keys = sorted(self._counts)
            for key in keys:
                cum = 0
                for i, ub in enumerate(self.buckets):
                    cum = self._counts[key][i]
                    lines.append(
                        f"{self.name}_bucket"
                        f"{_fmt_labels(tuple(self.label_names) + ('le',), key + (_fmt_value(ub),))} {cum}"
                    )
                lines.append(
                    f"{self.name}_bucket"
                    f"{_fmt_labels(tuple(self.label_names) + ('le',), key + ('+Inf',))} {self._totals[key]}"
                )
                lines.append(f"{self.name}_sum{_fmt_labels(self.label_names, key)} {_fmt_value(self._sums[key])}")
                lines.append(f"{self.name}_count{_fmt_labels(self.label_names, key)} {self._totals[key]}")
        return "\n".join(lines)


class _HistChild:
    def __init__(self, parent: Histogram, key: tuple):
        self._parent = parent
        self._key = key

    def observe(self, value: float) -> None:
        self._parent._observe(self._key, value)

    def time_ms(self):
        """Context manager observing elapsed milliseconds (the
        NewSnapshotMetricsTimer pattern wrapping snapshotter methods)."""
        return _Timer(self)


class _Timer:
    def __init__(self, child: _HistChild):
        self._child = child

    def __enter__(self):
        self._start = time.monotonic()
        return self

    def __exit__(self, *exc):
        self._child.observe((time.monotonic() - self._start) * 1000.0)
        return False


class Registry:
    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: dict[str, _Metric] = {}

    def register(self, metric: _Metric) -> _Metric:
        with self._lock:
            existing = self._metrics.get(metric.name)
            if existing is not None:
                return existing
            self._metrics[metric.name] = metric
            return metric

    def unregister(self, name: str) -> None:
        with self._lock:
            self._metrics.pop(name, None)

    def render(self) -> str:
        with self._lock:
            metrics = list(self._metrics.values())
        return "\n".join(m.render() for m in metrics) + "\n"


default_registry = Registry()
