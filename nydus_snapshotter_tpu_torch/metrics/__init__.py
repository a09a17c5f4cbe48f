"""Metrics: a dependency-free registry rendering the Prometheus text
exposition format (:mod:`.registry`), the snapshotter's metric set
(:mod:`.data`), the ``/proc`` samplers (:mod:`.tool`), the periodic
collectors (:mod:`.collector`), the HTTP listener serving ``/v1/metrics``
(:mod:`.serve`, metrics/listener.go:32-53), the fleet's metrics
federation (:mod:`.federation`) and the collector's pauses
(:mod:`.gc_pauses`, hooked in at import)."""

from nydus_snapshotter_tpu_torch.metrics import gc_pauses  # noqa: F401  (installs the gc hook)
from nydus_snapshotter_tpu_torch.metrics.registry import (
    Counter,
    Gauge,
    Histogram,
    Registry,
    TTLGauge,
    default_registry,
)
from nydus_snapshotter_tpu_torch.metrics.serve import MetricsServer

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "Registry",
    "TTLGauge",
    "default_registry",
    "MetricsServer",
]
