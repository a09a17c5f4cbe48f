"""mount(2)/umount(2) helpers + erofs mount (reference pkg/utils/mount,
pkg/utils/erofs).

A module-level ``backend`` hook lets tests substitute a fake mounter; the
real one shells to mount(8)/umount(8) (python has no stable mount(2)
binding and the snapshotter runs as root anyway, mirroring how
cmd/nydus-overlayfs execs mount).
"""

from __future__ import annotations

import hashlib
import logging
import os
import subprocess
import time

from nydus_snapshotter_tpu_torch.utils import errdefs

logger = logging.getLogger(__name__)


class CliMounter:
    def mount(self, source: str, target: str, fstype: str, options: str = "") -> None:
        cmd = ["mount", "-t", fstype]
        if options:
            cmd += ["-o", options]
        cmd += [source, target]
        r = subprocess.run(cmd, capture_output=True, text=True)
        if r.returncode != 0:
            raise errdefs.Unavailable(
                f"mount -t {fstype} {source} {target} failed: {r.stderr.strip()}"
            )

    def umount(self, target: str, flags: int = 0) -> None:
        cmd = ["umount"]
        if flags:  # MNT_FORCE-ish
            cmd.append("-f")
        cmd.append(target)
        r = subprocess.run(cmd, capture_output=True, text=True)
        if r.returncode != 0:
            raise errdefs.Unavailable(f"umount {target} failed: {r.stderr.strip()}")


backend = CliMounter()


def mount(source: str, target: str, fstype: str, options: str = "") -> None:
    os.makedirs(target, exist_ok=True)
    backend.mount(source, target, fstype, options)


def umount(target: str) -> None:
    backend.umount(target)


def is_mountpoint(path: str) -> bool:
    return os.path.ismount(path)


def wait_until_unmounted(path: str, timeout: float = 10.0, interval: float = 0.1) -> None:
    """Poll until ``path`` stops being a mountpoint
    (mount.go WaitUntilUnmounted)."""
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if not os.path.ismount(path):
            return
        time.sleep(interval)
    raise errdefs.Unavailable(f"{path} still mounted after {timeout}s")


# -- erofs (pkg/utils/erofs/erofs.go) ----------------------------------------


def erofs_fscache_id(snapshot_id: str) -> str:
    """fscache domain ID for a snapshot: sha256("nydus-snapshot-<id>")
    (erofs.go:46)."""
    return hashlib.sha256(f"nydus-snapshot-{snapshot_id}".encode()).hexdigest()


def erofs_mount(bootstrap_path: str, domain_id: str, fscache_id: str, mountpoint: str) -> None:
    """Mount an EROFS image backed by fscache (erofs.go:18-44)."""
    opts = f"domain_id={domain_id},fsid={fscache_id}"
    mount(bootstrap_path, mountpoint, "erofs", opts)


def erofs_umount(mountpoint: str) -> None:
    umount(mountpoint)
