"""Daemon (nydusd-equivalent) runtime config model.

Reference: config/daemonconfig/{daemonconfig,fuse,fscache}.go — a JSON
template per fs driver, supplemented at mount time with auth, cache dir and
prefetch settings, with ``secret`` fields filtered before any API exposure
(daemonconfig.go:191-239).
"""

from __future__ import annotations

import copy
import json
from dataclasses import dataclass, field, fields
from typing import Any, Optional

from nydus_snapshotter_tpu_torch import constants

# Field names whose values are secrets; filtered from API-exposed dumps
# (reference tags `secret:"true"`).
_SECRET_FIELDS = {"auth", "registry_token", "access_key_secret", "secret_access_key", "password"}


class DaemonConfigError(ValueError):
    pass


@dataclass
class MirrorConfig:
    host: str = ""
    headers: dict[str, str] = field(default_factory=dict)
    health_check_interval: int = 5
    failure_limit: int = 5
    ping_url: str = ""


@dataclass
class BackendConfig:
    """Storage backend for lazy reads: registry / oss / s3 / localfs."""

    backend_type: str = "registry"
    # registry
    host: str = ""
    repo: str = ""
    auth: str = ""  # secret
    registry_token: str = ""  # secret
    scheme: str = "https"
    skip_verify: bool = False
    mirrors: list[MirrorConfig] = field(default_factory=list)
    # oss/s3
    endpoint: str = ""
    bucket_name: str = ""
    access_key_id: str = ""
    access_key_secret: str = ""  # secret
    # localfs
    blob_dir: str = ""
    # tuning
    connect_timeout: int = 5
    timeout: int = 5
    retry_limit: int = 2


@dataclass
class CacheConfig:
    cache_type: str = "blobcache"
    work_dir: str = ""
    disable_indexed_map: bool = False
    compressed: bool = False


@dataclass
class RafsInstanceConfig:
    mode: str = "direct"
    digest_validate: bool = False
    enable_xattr: bool = True
    amplify_io: int = 0
    prefetch_enable: bool = False
    prefetch_threads: int = 4
    prefetch_merging_size: int = 131072


@dataclass
class DaemonRuntimeConfig:
    """One daemon's full runtime config (fuse or fscache flavored)."""

    fs_driver: str = constants.FS_DRIVER_FUSEDEV
    backend: BackendConfig = field(default_factory=BackendConfig)
    cache: CacheConfig = field(default_factory=CacheConfig)
    rafs: RafsInstanceConfig = field(default_factory=RafsInstanceConfig)
    threads_number: int = 4

    @classmethod
    def from_template(cls, path: str, fs_driver: str) -> "DaemonRuntimeConfig":
        with open(path, "rb") as f:
            data = json.load(f)
        return cls.from_dict(data, fs_driver)

    @classmethod
    def from_dict(cls, data: dict[str, Any], fs_driver: str) -> "DaemonRuntimeConfig":
        cfg = cls(fs_driver=fs_driver)
        device = data.get("device", {})
        be = device.get("backend", {})
        cfg.backend.backend_type = be.get("type", cfg.backend.backend_type)
        bcfg = be.get("config", {})
        for f_ in fields(BackendConfig):
            json_key = {"backend_type": "type"}.get(f_.name, f_.name)
            if json_key in bcfg:
                setattr(cfg.backend, f_.name, bcfg[json_key])
        # Mirrors arrive as JSON objects; normalize to MirrorConfig records
        # (unknown keys dropped) so consumers get attribute access.
        cfg.backend.mirrors = [
            m
            if isinstance(m, MirrorConfig)
            else MirrorConfig(
                **{
                    k: v
                    for k, v in m.items()
                    if k in {f.name for f in fields(MirrorConfig)}
                }
            )
            for m in cfg.backend.mirrors
            if isinstance(m, (dict, MirrorConfig))
        ]
        cache = device.get("cache", {})
        cfg.cache.cache_type = cache.get("type", cfg.cache.cache_type)
        ccfg = cache.get("config", {})
        cfg.cache.work_dir = ccfg.get("work_dir", cfg.cache.work_dir)
        cfg.cache.compressed = ccfg.get("compressed", cfg.cache.compressed)
        rafs = data.get("rafs", data.get("fs", {}))
        for f_ in fields(RafsInstanceConfig):
            if f_.name in rafs:
                setattr(cfg.rafs, f_.name, rafs[f_.name])
        return cfg

    def to_dict(self, filter_secrets: bool = False) -> dict[str, Any]:
        def scrub(name: str, value: Any) -> Any:
            if filter_secrets and name in _SECRET_FIELDS:
                return ""
            return value

        backend_cfg = {
            f_.name: scrub(f_.name, getattr(self.backend, f_.name))
            for f_ in fields(BackendConfig)
            if f_.name != "backend_type"
        }
        backend_cfg["mirrors"] = [
            copy.deepcopy(m.__dict__) for m in self.backend.mirrors
        ]
        return {
            "fs_driver": self.fs_driver,
            "device": {
                "backend": {"type": self.backend.backend_type, "config": backend_cfg},
                "cache": {
                    "type": self.cache.cache_type,
                    "config": {
                        "work_dir": self.cache.work_dir,
                        "compressed": self.cache.compressed,
                    },
                },
            },
            "rafs": copy.deepcopy(self.rafs.__dict__),
            "threads_number": self.threads_number,
        }

    def dump(self, path: str) -> None:
        """Persist per-daemon config so mounts can be replayed after crash
        (reference fs.go:363-370, daemon.go:256-267)."""
        with open(path, "w") as f:
            json.dump(self.to_dict(), f, sort_keys=True, indent=2)

    def exposed(self) -> dict[str, Any]:
        """Secret-filtered view for the system controller API."""
        return self.to_dict(filter_secrets=True)

    def supplement(
        self,
        *,
        image_ref: str = "",
        auth: str = "",
        work_dir: str = "",
        prefetch_files: Optional[list[str]] = None,
        mirrors_config_dir: str = "",
    ) -> None:
        """Per-mount supplementation (reference daemonconfig.go:150-189)."""
        if image_ref:
            host, _, repo = image_ref.partition("/")
            self.backend.host = host
            self.backend.repo = repo.split(":")[0].split("@")[0]
            if mirrors_config_dir:
                # per-host mirror dirs à la containerd certs.d
                # (daemonconfig.go:165-171 + mirrors.go)
                from nydus_snapshotter_tpu_torch.config.mirrors import load_mirrors_config

                mirrors = load_mirrors_config(mirrors_config_dir, host)
                if mirrors:
                    self.backend.mirrors = mirrors
        if auth:
            self.backend.auth = auth
        if work_dir:
            self.cache.work_dir = work_dir
        if prefetch_files:
            self.rafs.prefetch_enable = True
