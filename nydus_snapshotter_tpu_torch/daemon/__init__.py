"""Daemon subsystem: the fetch side of the nydusd-equivalent data plane.

This package holds the daemon's types (:mod:`.types`), the fetch scheduler
and admission gate (:mod:`.fetch_sched`), the local blob cache
(:mod:`.blobcache`) and the peer chunk tier (:mod:`.peer`). The serving
daemon and its client are not part of this package.
"""

from nydus_snapshotter_tpu_torch.daemon.types import (  # noqa: F401
    DaemonState,
    DaemonInfo,
    FsMetrics,
    CacheMetrics,
    MountRequest,
)
