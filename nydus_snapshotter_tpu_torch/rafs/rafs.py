"""RAFS instance records + global cache.

Reference pkg/rafs/rafs.go:37-205: one ``Rafs`` per mounted snapshot
(snapshot id, image id, owning daemon, mountpoint, annotations, persisted
sequence for replay ordering), plus a process-global instance cache.
"""

from __future__ import annotations

import os
import threading
from dataclasses import dataclass, field
from typing import Any, Optional

from nydus_snapshotter_tpu_torch.models import layout


@dataclass
class Rafs:
    snapshot_id: str
    image_id: str = ""
    daemon_id: str = ""
    fs_driver: str = ""
    snapshot_dir: str = ""
    mountpoint: str = ""
    annotations: dict[str, str] = field(default_factory=dict)
    seq: int = 0  # replay order (reference rafs.go:112-117)

    def bootstrap_file(self) -> str:
        """Path of the bootstrap within the snapshot dir, with the legacy
        fallback (reference rafs.go:187-205: fs/image/image.boot, else
        fs/image.boot)."""
        primary = os.path.join(self.snapshot_dir, "fs", layout.BOOTSTRAP_FILE)
        if os.path.exists(primary):
            return primary
        legacy = os.path.join(self.snapshot_dir, "fs", layout.LEGACY_BOOTSTRAP_FILE)
        if os.path.exists(legacy):
            return legacy
        return primary

    def fscache_work_dir(self) -> str:
        return os.path.join(self.snapshot_dir, "fs")

    def relative_mountpoint(self) -> str:
        """Mountpoint inside the daemon's FUSE namespace."""
        return f"/{self.snapshot_id}"

    def to_dict(self) -> dict[str, Any]:
        return {
            "snapshot_id": self.snapshot_id,
            "image_id": self.image_id,
            "daemon_id": self.daemon_id,
            "fs_driver": self.fs_driver,
            "snapshot_dir": self.snapshot_dir,
            "mountpoint": self.mountpoint,
            "annotations": dict(self.annotations),
            "seq": self.seq,
        }

    @classmethod
    def from_dict(cls, d: dict[str, Any]) -> "Rafs":
        return cls(**d)


class RafsCache:
    """Thread-safe snapshot-id → Rafs map (reference RafsGlobalCache)."""

    def __init__(self):
        self._lock = threading.RLock()
        self._by_snapshot: dict[str, Rafs] = {}

    def add(self, rafs: Rafs) -> None:
        with self._lock:
            self._by_snapshot[rafs.snapshot_id] = rafs

    def get(self, snapshot_id: str) -> Optional[Rafs]:
        with self._lock:
            return self._by_snapshot.get(snapshot_id)

    def remove(self, snapshot_id: str) -> Optional[Rafs]:
        with self._lock:
            return self._by_snapshot.pop(snapshot_id, None)

    def list(self) -> list[Rafs]:
        with self._lock:
            return sorted(self._by_snapshot.values(), key=lambda r: r.seq)

    def by_daemon(self, daemon_id: str) -> list[Rafs]:
        with self._lock:
            return sorted(
                (r for r in self._by_snapshot.values() if r.daemon_id == daemon_id),
                key=lambda r: r.seq,
            )

    def head(self) -> Optional[Rafs]:
        with self._lock:
            vals = list(self._by_snapshot.values())
            return min(vals, key=lambda r: r.seq) if vals else None

    def __len__(self) -> int:
        with self._lock:
            return len(self._by_snapshot)


rafs_global_cache = RafsCache()
