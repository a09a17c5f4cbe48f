"""Metrics: a dependency-free registry rendering the Prometheus text
exposition format (:mod:`.registry`), the snapshotter's metric set
(:mod:`.data`), the ``/proc`` samplers (:mod:`.tool`) and the periodic
collectors (:mod:`.collector`). The reference package's HTTP listener
(``metrics/serve.py``) is not ported yet."""

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
