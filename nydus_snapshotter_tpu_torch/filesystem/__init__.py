"""L3 filesystem abstraction (reference pkg/filesystem)."""

from nydus_snapshotter_tpu_torch.filesystem.fs import Filesystem

__all__ = ["Filesystem"]
