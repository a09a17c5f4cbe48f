"""Loop-device attach/detach (reference tarfs.go:754-760 via go-losetup).

Implemented against the kernel loop-control API directly (LOOP_CTL_GET_FREE
+ LOOP_CONFIGURE/LOOP_SET_FD), with a ``losetup(8)`` CLI fallback. All entry
points honor a module-level ``backend`` hook so unit tests can substitute a
fake (mounting needs root, CI has none).
"""

from __future__ import annotations

import fcntl
import os
import struct
import subprocess
from dataclasses import dataclass
from typing import Optional

from nydus_snapshotter_tpu_torch.utils import errdefs

LOOP_CTL_GET_FREE = 0x4C82
LOOP_SET_FD = 0x4C00
LOOP_CLR_FD = 0x4C01
LOOP_SET_STATUS64 = 0x4C04
LOOP_GET_STATUS64 = 0x4C05
LOOP_CONTROL = "/dev/loop-control"

LO_FLAGS_READ_ONLY = 1
LO_FLAGS_AUTOCLEAR = 4


@dataclass
class LoopDevice:
    index: int

    @property
    def path(self) -> str:
        return f"/dev/loop{self.index}"

    def detach(self) -> None:
        backend.detach(self)


class KernelBackend:
    """ioctl-based loop management (what go-losetup does)."""

    def attach(
        self, blob_path: str, offset: int = 0, ro: bool = True,
    ) -> LoopDevice:
        with open(LOOP_CONTROL, "rb") as ctl:
            index = fcntl.ioctl(ctl.fileno(), LOOP_CTL_GET_FREE)
        dev = LoopDevice(index)
        flags = os.O_RDONLY if ro else os.O_RDWR
        blob_fd = os.open(blob_path, flags)
        try:
            dev_fd = os.open(dev.path, flags)
            try:
                fcntl.ioctl(dev_fd, LOOP_SET_FD, blob_fd)
                # struct loop_info64: lo_device@0, lo_inode@8, lo_rdevice@16,
                # lo_offset@24, ..., lo_flags@52, lo_file_name@56
                info = bytearray(232)
                struct.pack_into("<Q", info, 24, offset)  # lo_offset
                struct.pack_into(
                    "<I", info, 52, LO_FLAGS_READ_ONLY if ro else 0
                )  # lo_flags
                name = blob_path.encode()[:63]
                info[56 : 56 + len(name)] = name  # lo_file_name
                fcntl.ioctl(dev_fd, LOOP_SET_STATUS64, bytes(info))
            finally:
                os.close(dev_fd)
        finally:
            os.close(blob_fd)
        return dev

    def detach(self, dev: LoopDevice) -> None:
        import errno

        try:
            fd = os.open(dev.path, os.O_RDONLY)
        except OSError as e:
            if e.errno == errno.ENXIO:
                return  # already gone
            raise
        try:
            fcntl.ioctl(fd, LOOP_CLR_FD, 0)
        except OSError as e:
            # ENXIO: the device is already unbound — the kernel reaped it
            # via AUTOCLEAR when its mount went away. Idempotent success.
            if e.errno != errno.ENXIO:
                raise
        finally:
            os.close(fd)

    def backing_file(self, dev: LoopDevice) -> Optional[str]:
        """Path currently backing the device (sysfs: full, unlike
        lo_file_name's 63-byte truncation); None when unbound."""
        try:
            with open(f"/sys/block/loop{dev.index}/loop/backing_file") as f:
                return f.read().strip()
        except OSError:
            return None

    def set_autoclear(self, dev: LoopDevice) -> None:
        """Flag AUTOCLEAR on an attached device. MUST be called after a
        durable user (the erofs mount) holds the device: autoclear fires
        when the last reference drops, so setting it at attach time —
        before any mount — detaches the loop the moment the setup fd
        closes. Post-mount, the kernel reaps the loop exactly when the
        mount goes away, so crash-restarted snapshotters that unmount by
        path never strand a bound device."""
        fd = os.open(dev.path, os.O_RDONLY)
        try:
            info = bytearray(232)
            fcntl.ioctl(fd, LOOP_GET_STATUS64, info)
            flags = struct.unpack_from("<I", info, 52)[0]
            struct.pack_into("<I", info, 52, flags | LO_FLAGS_AUTOCLEAR)
            fcntl.ioctl(fd, LOOP_SET_STATUS64, bytes(info))
        finally:
            os.close(fd)


class CliBackend:
    """losetup(8) fallback."""

    def attach(
        self, blob_path: str, offset: int = 0, ro: bool = True,
    ) -> LoopDevice:
        cmd = ["losetup", "--find", "--show"]
        if ro:
            cmd.append("--read-only")
        if offset:
            cmd += ["--offset", str(offset)]
        cmd.append(blob_path)
        out = subprocess.run(cmd, capture_output=True, text=True, check=True)
        path = out.stdout.strip()
        if not path.startswith("/dev/loop"):
            raise errdefs.Unavailable(f"losetup returned {path!r}")
        return LoopDevice(int(path[len("/dev/loop") :]))

    def detach(self, dev: LoopDevice) -> None:
        subprocess.run(["losetup", "--detach", dev.path], check=True)


backend = KernelBackend()


def attach(
    blob_path: str, offset: int = 0, ro: bool = True
) -> LoopDevice:
    """Attach ``blob_path`` to a free loop device (thread-safety is the
    caller's job — reference holds mutexLoopDev, tarfs.go:754-760)."""
    try:
        return backend.attach(blob_path, offset=offset, ro=ro)
    except (PermissionError, FileNotFoundError) as e:
        raise errdefs.Unavailable(f"loop attach of {blob_path} failed: {e}") from e


def set_autoclear(dev: LoopDevice) -> None:
    """Best-effort post-mount AUTOCLEAR (see KernelBackend.set_autoclear);
    silently skipped on backends without the capability."""
    fn = getattr(backend, "set_autoclear", None)
    if fn is None:
        return
    try:
        fn(dev)
    except OSError:
        pass


def still_backed_by(dev: LoopDevice, path: str) -> bool:
    """Whether the device is still bound to ``path``.

    With AUTOCLEAR, loop lifetime belongs to the KERNEL: the device may
    have been reaped when its mount went away and even re-bound to an
    unrelated file by a later LOOP_CTL_GET_FREE. Any cached handle must
    be validated before reuse (or a mount would read the wrong backing
    file) and before detach (or LOOP_CLR_FD would land on someone else's
    live binding). Backends without introspection (test fakes) return
    "unknown" and the handle is trusted, preserving their semantics.
    """
    fn = getattr(backend, "backing_file", None)
    if fn is None:
        return True  # unknown: trust the handle (non-autoclear backends)
    try:
        bf = fn(dev)
    except OSError:
        return False
    if bf is None:
        return False  # definitely unbound
    bf = bf.removesuffix(" (deleted)")
    return bf == path or bf == os.path.realpath(path)


def detach(dev: LoopDevice) -> None:
    try:
        backend.detach(dev)
    except (PermissionError, FileNotFoundError) as e:
        raise errdefs.Unavailable(f"loop detach of {dev.path} failed: {e}") from e
