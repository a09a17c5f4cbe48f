"""RAFS instance registry (reference pkg/rafs/rafs.go)."""

from nydus_snapshotter_tpu_torch.rafs.rafs import Rafs, RafsCache, rafs_global_cache  # noqa: F401
