"""Host/system introspection (reference pkg/utils/sysinfo)."""

from __future__ import annotations

import os


def get_memory_bytes() -> int:
    """Total physical memory (sysinfo.go)."""
    try:
        with open("/proc/meminfo") as f:
            for line in f:
                if line.startswith("MemTotal:"):
                    return int(line.split()[1]) * 1024
    except OSError:
        pass
    return 0


def get_kernel_version() -> str:
    return os.uname().release


def kernel_at_least(major: int, minor: int) -> bool:
    """e.g. fscache requires >= 5.19 (fs.go driver checks)."""
    parts = get_kernel_version().split(".")
    try:
        k_major, k_minor = int(parts[0]), int(parts[1].split("-")[0])
    except (ValueError, IndexError):
        return False
    return (k_major, k_minor) >= (major, minor)
