"""Blob-cache accounting and GC (reference pkg/cache)."""

from nydus_snapshotter_tpu_torch.cache.manager import CacheManager

__all__ = ["CacheManager"]
