"""Daemon cgroup management (reference pkg/cgroup)."""

from nydus_snapshotter_tpu_torch.cgroup.cgroup import (
    Config,
    Manager,
    Mode,
    CgroupNotSupported,
    detect_mode,
)

__all__ = ["CgroupNotSupported", "Config", "Manager", "Mode", "detect_mode"]
