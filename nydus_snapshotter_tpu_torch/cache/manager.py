"""Blob-cache usage accounting + GC for the fusedev driver.

Reference pkg/cache/manager.go:33-122: blob caches live under one cache dir
as ``<blobID>`` plus suffixed companions (``.blob.data``, ``.chunk_map``,
``.blob.meta``, ``.image.disk``, ``.layer.disk``); usage is a du over the
matching files and removal deletes them all.

Beyond the reference's age-based removal, :meth:`CacheManager.gc_watermark`
bounds total cache *capacity*: whole entries (a blob plus companions) are
evicted least-recently-accessed-first until usage is back under a byte
watermark. Live ``CachedBlob`` instances survive eviction transparently —
they notice the dropped link and re-fetch (daemon/blobcache.py).
"""

from __future__ import annotations

import os
import threading
import time
from typing import Optional

from nydus_snapshotter_tpu_torch import failpoint
from nydus_snapshotter_tpu_torch.snapshot.metastore import Usage

# Companion-file suffixes of one blob cache entry (manager.go:99-120,
# plus the seekable-OCI checkpoint indexes — soci/index.py's gzip zran
# index and soci/zindex.py's zstd frame index — and the provenance
# plane's .heat prefetch artifact (provenance/heat.py) — all of which
# must be accounted, GC'd and watermark-evicted with the blob they
# describe).
_SUFFIXES = ("", ".blob.data", ".chunk_map", ".blob.meta", ".image.disk",
             ".layer.disk", ".soci.idx", ".soci.zidx", ".heat")


class CacheManager:
    def __init__(self, cache_dir: str, period_sec: float = 0.0, enabled: bool = True):
        self.cache_dir = cache_dir
        self.enabled = enabled
        self._period = period_sec
        self._timer: Optional[threading.Timer] = None
        self._gc_stop: Optional[threading.Event] = None
        os.makedirs(cache_dir, exist_ok=True)

    def _entries(self, blob_id: str) -> list[str]:
        return [os.path.join(self.cache_dir, blob_id + sfx) for sfx in _SUFFIXES]

    def cache_usage(self, blob_id: str) -> Usage:
        usage = Usage()
        for path in self._entries(blob_id):
            try:
                st = os.lstat(path)
            except FileNotFoundError:
                continue
            usage.size += st.st_size
            usage.inodes += 1
        return usage

    def remove_blob_cache(self, blob_id: str) -> None:
        for path in self._entries(blob_id):
            try:
                os.remove(path)
            except FileNotFoundError:
                continue

    def total_usage(self) -> Usage:
        usage = Usage()
        try:
            names = os.listdir(self.cache_dir)
        except FileNotFoundError:
            return usage
        for name in names:
            try:
                st = os.lstat(os.path.join(self.cache_dir, name))
            except FileNotFoundError:
                continue
            usage.size += st.st_size
            usage.inodes += 1
        return usage

    # -- periodic GC of caches older than `max_age` --------------------------

    @staticmethod
    def _entry_id(name: str) -> str:
        """Blob id a cache file belongs to (strip the companion suffix)."""
        for sfx in _SUFFIXES:
            if sfx and name.endswith(sfx):
                return name[: -len(sfx)]
        return name

    def gc_once(self, max_age_sec: float) -> list[str]:
        """Remove whole cache *entries* (a blob plus all its companions, the
        same grouping remove_blob_cache uses) whose most recent access is
        older than max_age; returns removed paths."""
        removed: list[str] = []
        now = time.time()
        try:
            names = os.listdir(self.cache_dir)
        except FileNotFoundError:
            return removed
        newest_atime: dict[str, float] = {}
        members: dict[str, list[str]] = {}
        for name in names:
            path = os.path.join(self.cache_dir, name)
            try:
                st = os.lstat(path)
            except FileNotFoundError:
                continue
            bid = self._entry_id(name)
            members.setdefault(bid, []).append(path)
            newest_atime[bid] = max(newest_atime.get(bid, 0.0), st.st_atime)
        for bid, paths in members.items():
            if now - newest_atime[bid] <= max_age_sec:
                continue
            for path in paths:
                try:
                    os.remove(path)
                    removed.append(path)
                except OSError:
                    continue
        return removed

    # -- capacity-watermark eviction (LRU over whole entries) ----------------

    def _scan_entries(self) -> tuple[dict[str, list[str]], dict[str, float], dict[str, int]]:
        """(members, newest_atime, sizes) per blob id, one listdir pass."""
        members: dict[str, list[str]] = {}
        newest_atime: dict[str, float] = {}
        sizes: dict[str, int] = {}
        try:
            names = os.listdir(self.cache_dir)
        except FileNotFoundError:
            return members, newest_atime, sizes
        for name in names:
            path = os.path.join(self.cache_dir, name)
            try:
                st = os.lstat(path)
            except FileNotFoundError:
                continue
            bid = self._entry_id(name)
            members.setdefault(bid, []).append(path)
            newest_atime[bid] = max(newest_atime.get(bid, 0.0), st.st_atime)
            sizes[bid] = sizes.get(bid, 0) + st.st_size
        return members, newest_atime, sizes

    def gc_watermark(self, max_bytes: int, protect: Optional[set] = None) -> list[str]:
        """Evict whole cache entries, least-recently-accessed first, until
        total usage is <= ``max_bytes``; returns removed paths. ``protect``
        names blob ids that must never be evicted (e.g. currently
        mounting). Eviction under a live reader is safe: open fds keep the
        old bytes readable and the next read re-seeds the cache."""
        removed: list[str] = []
        if max_bytes <= 0:
            return removed
        members, newest_atime, sizes = self._scan_entries()
        total = sum(sizes.values())
        if total <= max_bytes:
            return removed
        from nydus_snapshotter_tpu_torch.daemon import fetch_sched

        for bid in sorted(members, key=lambda b: newest_atime[b]):
            if total <= max_bytes:
                break
            if protect and bid in protect:
                continue
            failpoint.hit("blobcache.evict")
            entry_removed = 0
            for path in members[bid]:
                try:
                    st = os.lstat(path)
                    os.remove(path)
                except OSError:
                    continue
                entry_removed += st.st_size
                removed.append(path)
            if entry_removed:
                total -= entry_removed
                fetch_sched.EVICTED_BYTES.inc(entry_removed)
                fetch_sched.EVICTED_ENTRIES.inc()
        return removed

    def start_gc(self, max_age_sec: float, watermark_bytes: int = 0) -> None:
        if not self.enabled or self._period <= 0:
            return
        self.stop_gc()
        stop = threading.Event()
        self._gc_stop = stop

        def tick():
            if stop.is_set():
                return
            self.gc_once(max_age_sec)
            if watermark_bytes > 0:
                self.gc_watermark(watermark_bytes)
            if stop.is_set():
                return
            self._timer = threading.Timer(self._period, tick)
            self._timer.daemon = True
            self._timer.start()

        self._timer = threading.Timer(self._period, tick)
        self._timer.daemon = True
        self._timer.start()

    def stop_gc(self) -> None:
        if self._gc_stop is not None:
            self._gc_stop.set()
        if self._timer is not None:
            self._timer.cancel()
            self._timer = None
