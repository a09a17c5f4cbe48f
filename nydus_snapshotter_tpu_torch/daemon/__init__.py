"""Daemon subsystem: the nydusd-equivalent process, its client, lifecycle.

The reference forks the external Rust ``nydusd`` and drives it over an
HTTP-over-UDS API (pkg/daemon/client.go:31-58). This framework ships its own
daemon process (daemon/server.py) with the same API surface — state machine,
mounts, metrics, takeover — serving RAFS reads from bootstrap + blob cache
in userspace. Its fetch side is :mod:`.fetch_sched`, :mod:`.blobcache` and
:mod:`.peer`; nothing here makes a CUDA context.
"""

from nydus_snapshotter_tpu_torch.daemon.types import (  # noqa: F401
    DaemonState,
    DaemonInfo,
    FsMetrics,
    CacheMetrics,
    MountRequest,
)
from nydus_snapshotter_tpu_torch.daemon.daemon import Daemon  # noqa: F401
from nydus_snapshotter_tpu_torch.daemon.client import NydusdClient, ClientError  # noqa: F401
