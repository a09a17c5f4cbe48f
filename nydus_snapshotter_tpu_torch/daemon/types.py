"""Daemon API DTOs (reference pkg/daemon/types/types.go:10-106)."""

from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import Any, Optional


class DaemonState(str, enum.Enum):
    UNKNOWN = "UNKNOWN"
    INIT = "INIT"
    READY = "READY"
    RUNNING = "RUNNING"
    DIED = "DIED"
    DESTROYED = "DESTROYED"


@dataclass
class DaemonInfo:
    id: str
    version: str
    state: str
    backend_type: str = ""
    supervisor: str = ""
    pid: int = 0

    def to_dict(self) -> dict[str, Any]:
        return {
            "id": self.id,
            "version": {"package_ver": self.version, "git_commit": ""},
            "state": self.state,
            "backend_collection": {"type": self.backend_type},
            "supervisor": self.supervisor,
            "pid": self.pid,
        }

    @classmethod
    def from_dict(cls, d: dict[str, Any]) -> "DaemonInfo":
        version = d.get("version", {})
        return cls(
            id=d.get("id", ""),
            version=version.get("package_ver", "") if isinstance(version, dict) else str(version),
            state=d.get("state", DaemonState.UNKNOWN.value),
            backend_type=(d.get("backend_collection") or {}).get("type", ""),
            supervisor=d.get("supervisor", ""),
            pid=d.get("pid", 0),
        )


@dataclass
class FsMetrics:
    files_account_enabled: bool = False
    measure_latency: bool = True
    data_read: int = 0
    block_count_read: dict[str, int] = field(default_factory=dict)
    fop_hits: dict[str, int] = field(default_factory=dict)
    fop_errors: dict[str, int] = field(default_factory=dict)
    read_latency_dist: list[int] = field(default_factory=lambda: [0] * 8)

    def to_dict(self) -> dict[str, Any]:
        return dict(self.__dict__)


@dataclass
class CacheMetrics:
    prefetch_data_amount: int = 0
    buffered_backend_size: int = 0
    underlying_files: list[str] = field(default_factory=list)

    def to_dict(self) -> dict[str, Any]:
        return dict(self.__dict__)


@dataclass
class InflightMetrics:
    values: list[dict[str, Any]] = field(default_factory=list)


@dataclass
class MountRequest:
    fs_type: str
    source: str  # bootstrap path
    config: str  # daemon runtime config JSON

    def to_dict(self) -> dict[str, Any]:
        return {"fs_type": self.fs_type, "source": self.source, "config": self.config}
