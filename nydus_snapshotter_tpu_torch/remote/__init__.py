"""Remote I/O layer (L8): registry resolver/fetcher/pusher, transport pool.

This package's equivalent of the reference's pkg/remote + pkg/resolve +
pkg/utils/transport: a stdlib OCI-distribution client (no vendored
containerd fork), with the same plain-HTTP retry heuristic
(pkg/remote/remote.go:96-115) and the pooled token-refreshing transport
(pkg/utils/transport/pool.go:24-70).
"""

from nydus_snapshotter_tpu_torch.remote.mirror import HostHealth, MirrorRouter
from nydus_snapshotter_tpu_torch.remote.reference import ParsedReference, parse_docker_ref
from nydus_snapshotter_tpu_torch.remote.registry import Descriptor, RegistryClient
from nydus_snapshotter_tpu_torch.remote.remote import Remote
from nydus_snapshotter_tpu_torch.remote.resolve import Resolver
from nydus_snapshotter_tpu_torch.remote.transport import Pool

__all__ = [
    "ParsedReference",
    "parse_docker_ref",
    "Descriptor",
    "RegistryClient",
    "Remote",
    "Resolver",
    "Pool",
    "MirrorRouter",
    "HostHealth",
]
