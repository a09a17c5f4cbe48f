"""Dedicated "nydusd" cgroup with a memory limit, v1 + v2.

Reference pkg/cgroup (manager.go:24-50, cgroup.go:36-60, v1/v1.go:24-82,
v2/v2.go:41-88): daemons are corralled into ``system.slice/<name>`` with an
optional memory cap so a runaway userspace daemon can't take down the node.

The filesystem root is injectable (default ``/sys/fs/cgroup``) so tests run
against a tmpdir; mode detection mirrors containerd/cgroups: unified when
``cgroup.controllers`` exists at the root, legacy when ``memory/`` does,
unavailable otherwise.
"""

from __future__ import annotations

import enum
import logging
import os
from dataclasses import dataclass

from nydus_snapshotter_tpu_torch.utils import errdefs

logger = logging.getLogger(__name__)

DEFAULT_SLICE = "system.slice"
DEFAULT_ROOT = "/sys/fs/cgroup"


class CgroupNotSupported(errdefs.Unavailable):
    pass


class Mode(enum.Enum):
    UNAVAILABLE = "unavailable"
    LEGACY = "legacy"  # v1
    HYBRID = "hybrid"
    UNIFIED = "unified"  # v2


@dataclass
class Config:
    memory_limit_in_bytes: int = -1  # -1 = unlimited


def detect_mode(root: str = DEFAULT_ROOT) -> Mode:
    if not os.path.isdir(root):
        return Mode.UNAVAILABLE
    unified = os.path.exists(os.path.join(root, "cgroup.controllers"))
    legacy = os.path.isdir(os.path.join(root, "memory"))
    if unified and legacy:
        return Mode.HYBRID
    if unified:
        return Mode.UNIFIED
    if legacy:
        return Mode.LEGACY
    return Mode.UNAVAILABLE


class _CgroupV1:
    """v1: <root>/memory/<slice>/<name> (v1/v1.go:24-82)."""

    def __init__(self, root: str, slice_name: str, name: str, memory_limit: int):
        self.path = os.path.join(root, "memory", slice_name, name)
        os.makedirs(self.path, exist_ok=True)
        if memory_limit > 0:
            with open(os.path.join(self.path, "memory.limit_in_bytes"), "w") as f:
                f.write(str(memory_limit))

    def add_proc(self, pid: int) -> None:
        with open(os.path.join(self.path, "cgroup.procs"), "a") as f:
            f.write(f"{pid}\n")

    def delete(self) -> None:
        # a v1 cgroup dir with live procs can't be removed; mirror the
        # reference's best-effort delete (v1.go:64-82)
        try:
            os.rmdir(self.path)
        except OSError as e:
            logger.warning("delete cgroup %s: %s", self.path, e)


class _CgroupV2:
    """v2 unified: <root>/<slice>/<name> with memory.max (v2/v2.go:41-88)."""

    def __init__(self, root: str, slice_name: str, name: str, memory_limit: int):
        self.path = os.path.join(root, slice_name, name)
        os.makedirs(self.path, exist_ok=True)
        if memory_limit > 0:
            with open(os.path.join(self.path, "memory.max"), "w") as f:
                f.write(str(memory_limit))

    def add_proc(self, pid: int) -> None:
        with open(os.path.join(self.path, "cgroup.procs"), "a") as f:
            f.write(f"{pid}\n")

    def delete(self) -> None:
        try:
            os.rmdir(self.path)
        except OSError as e:
            logger.warning("delete cgroup %s: %s", self.path, e)


class Manager:
    def __init__(
        self,
        name: str,
        config: Config | None = None,
        root: str = DEFAULT_ROOT,
        slice_name: str = DEFAULT_SLICE,
    ):
        config = config or Config()
        mode = detect_mode(root)
        if mode is Mode.UNAVAILABLE:
            raise CgroupNotSupported("cgroups: cgroup not supported")
        logger.info("cgroup mode: %s", mode.value)
        self.name = name
        self.config = config
        if mode in (Mode.UNIFIED,):
            self.cgroup = _CgroupV2(root, slice_name, name, config.memory_limit_in_bytes)
        else:
            self.cgroup = _CgroupV1(root, slice_name, name, config.memory_limit_in_bytes)

    def add_proc(self, pid: int) -> None:
        self.cgroup.add_proc(pid)

    def delete(self) -> None:
        self.cgroup.delete()
