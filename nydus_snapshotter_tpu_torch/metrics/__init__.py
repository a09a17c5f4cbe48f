"""Metrics: a dependency-free registry rendering the Prometheus text
exposition format (:mod:`.registry`). The collectors and the HTTP
listener of the reference package's ``metrics/`` are not part of this
package."""

from nydus_snapshotter_tpu_torch.metrics.registry import (
    Counter,
    Gauge,
    Histogram,
    Registry,
    TTLGauge,
    default_registry,
)

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "Registry",
    "TTLGauge",
    "default_registry",
]
