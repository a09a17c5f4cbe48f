"""FUSE session: kernel-mountable read plane for RAFS instances.

Mounts a RAFS bootstrap as a real filesystem through /dev/fuse — the role
the external Rust nydusd plays for the reference (mount flow
pkg/filesystem/fs.go:268-431; failover keeps the kernel session alive by
passing the /dev/fuse fd through the supervisor, supervisor.go:107-178).

Two entry modes mirror nydusd's:
- ``mount()``  — open /dev/fuse, mount(2) with ``fd=N``, negotiate INIT.
- ``attach(fd)`` — adopt an already-negotiated session fd (takeover after
  failover/upgrade: the previous daemon died, the supervisor kept the fd,
  the kernel mount never noticed).

The server loop is deliberately simple: one reader thread per session,
answering from the in-memory bootstrap + BlobReader chunk path. RAFS is
immutable, so every mutating opcode returns EROFS.
"""

from __future__ import annotations

import ctypes
import errno
import logging
import os
import stat as stat_mod
import threading
from typing import Callable, Optional

from nydus_snapshotter_tpu_torch.fusedev import protocol as fp
from nydus_snapshotter_tpu_torch.models.bootstrap import Bootstrap, Inode

logger = logging.getLogger(__name__)

MS_RDONLY = 1
MS_NOSUID = 2
MS_NODEV = 4
MNT_DETACH = 2


class FuseError(RuntimeError):
    pass


def fuse_available() -> bool:
    """Can this process realistically serve a kernel FUSE mount?"""
    try:
        return os.access("/dev/fuse", os.R_OK | os.W_OK) and os.geteuid() == 0
    except OSError:
        return False


def _libc():
    return ctypes.CDLL("libc.so.6", use_errno=True)


class RafsFuseOps:
    """Resolve FUSE requests against a parsed bootstrap.

    ``read_file(path, offset, size)`` is the chunk-resolving data callback
    (the daemon's _Instance.read — compression/batch/cipher handled there).
    """

    def __init__(self, bootstrap: Bootstrap, read_file: Callable[[str, int, int], bytes]):
        self.read_file = read_file
        self.by_ino: dict[int, Inode] = {}
        self.children: dict[int, dict[bytes, Inode]] = {}
        by_path: dict[str, Inode] = {}
        for inode in bootstrap.inodes:
            self.by_ino[inode.ino] = inode
            by_path[inode.path] = inode
        for inode in bootstrap.inodes:
            if inode.path == "/":
                continue
            parent = self.by_ino.get(inode.parent_ino)
            if parent is None:
                continue
            name = inode.path.rsplit("/", 1)[1].encode()
            self.children.setdefault(parent.ino, {})[name] = inode
        self._by_path = by_path
        # st_nlink: hardlink group sizes (alias + target count as links to
        # the same storage inode — what the reference nydusd reports);
        # directories report 2 + subdirectories.
        self._nlink: dict[int, int] = {}
        for inode in bootstrap.inodes:
            if stat_mod.S_ISDIR(inode.mode):
                self._nlink[inode.ino] = 2 + sum(
                    1
                    for c in self.children.get(inode.ino, {}).values()
                    if stat_mod.S_ISDIR(c.mode)
                )
            else:
                tgt = self.resolve(inode)
                self._nlink[tgt.ino] = self._nlink.get(tgt.ino, 0) + 1

    def resolve(self, inode: Inode) -> Inode:
        """Follow a hardlink to its storage inode."""
        if inode.hardlink_target:
            target = self._by_path.get(inode.hardlink_target)
            if target is not None:
                return target
        return inode

    def attr_bytes(self, inode: Inode) -> bytes:
        target = self.resolve(inode)
        return fp.pack_attr(
            ino=target.ino,
            size=target.size,
            mode=target.mode,
            nlink=self._nlink.get(target.ino, 1),
            uid=target.uid,
            gid=target.gid,
            rdev=target.rdev,
            mtime=target.mtime,
        )


class FuseSession:
    ENTRY_VALID_S = 3600  # immutable fs: cache aggressively
    _MOUNT_LOCK = threading.Lock()

    def __init__(self, ops: RafsFuseOps, mountpoint: str):
        self.ops = ops
        self.mountpoint = mountpoint
        self.fd = -1
        self._owns_mount = False
        self._thread: Optional[threading.Thread] = None
        self._closed = threading.Event()
        self._wake_r = self._wake_w = -1

    # -- lifecycle ----------------------------------------------------------

    def mount(self) -> None:
        fd = os.open("/dev/fuse", os.O_RDWR)
        opts = f"fd={fd},rootmode=40000,user_id=0,group_id=0,default_permissions,allow_other"
        libc = _libc()
        with self._MOUNT_LOCK:
            rc = libc.mount(
                b"nydus-tpu",
                self.mountpoint.encode(),
                b"fuse.nydus-tpu",
                MS_RDONLY | MS_NOSUID | MS_NODEV,
                opts.encode(),
            )
        if rc != 0:
            err = ctypes.get_errno()
            os.close(fd)
            raise FuseError(f"mount({self.mountpoint}): {os.strerror(err)}")
        self.fd = fd
        self._owns_mount = True
        self._start()

    def attach(self, fd: int) -> None:
        """Adopt an existing (INIT-negotiated) session fd after takeover."""
        self.fd = fd
        self._owns_mount = True  # the mount exists; we answer for it now
        self._start()

    def _start(self) -> None:
        self._closed.clear()
        # Self-pipe: close() writes a byte so a serve thread parked in
        # select() wakes immediately. Closing the session fd alone cannot
        # interrupt a read that is already blocked in the kernel (and during
        # handoff the open file description stays alive via the successor's
        # dup, so a stolen read would silently swallow a request).
        self._wake_r, self._wake_w = os.pipe()
        self._thread = threading.Thread(
            target=self._serve, name=f"fuse:{self.mountpoint}", daemon=True
        )
        self._thread.start()

    def close(self, unmount: bool = True) -> None:
        """Stop serving; optionally tear down the kernel mount.

        ``unmount=False`` is the handoff mode: the serve thread is stopped
        *before* the fd is closed, so any request the kernel has queued
        stays queued for the successor that adopted the fd."""
        self._closed.set()
        try:
            os.write(self._wake_w, b"x")
        except OSError:
            pass
        if self._thread is not None and self._thread is not threading.current_thread():
            self._thread.join(timeout=2)
        if unmount and self._owns_mount:
            with self._MOUNT_LOCK:
                _libc().umount2(self.mountpoint.encode(), MNT_DETACH)
        if self.fd >= 0:
            try:
                os.close(self.fd)
            except OSError:
                pass
            self.fd = -1
        for p in (self._wake_r, self._wake_w):
            try:
                os.close(p)
            except OSError:
                pass

    # -- server loop --------------------------------------------------------

    def _serve(self) -> None:
        import select

        bufsize = fp.MAX_WRITE + 8192
        while not self._closed.is_set():
            fd = self.fd
            if fd < 0:
                return
            try:
                ready, _, _ = select.select([fd, self._wake_r], [], [])
            except (OSError, ValueError):
                return
            # Re-check before reading: on handoff the pending request must
            # be left in the kernel queue for the successor, not consumed
            # by a daemon that can no longer reply.
            if self._closed.is_set():
                return
            if fd not in ready:
                continue
            try:
                req = os.read(fd, bufsize)
            except OSError as e:
                if e.errno in (errno.EINTR, errno.EAGAIN):
                    continue
                # ENODEV: unmounted. EBADF: fd released/closed underneath us.
                return
            if not req:
                return
            try:
                self._dispatch(req)
            except OSError:
                return
            except Exception:
                logger.exception("fuse dispatch error on %s", self.mountpoint)

    def _reply(self, unique: int, payload: bytes = b"", error: int = 0) -> None:
        fd = self.fd
        if fd < 0:
            return
        header = fp.OUT_HEADER.pack(fp.OUT_HEADER.size + len(payload), -error, unique)
        os.write(fd, header + payload)

    def _dispatch(self, req: bytes) -> None:
        (_length, opcode, unique, nodeid, _uid, _gid, _pid, _pad) = fp.IN_HEADER.unpack_from(req)
        body = req[fp.IN_HEADER.size :]
        if opcode == fp.INIT:
            self._op_init(unique, body)
        elif opcode in (fp.FORGET, fp.BATCH_FORGET):
            return  # no reply, ever
        elif opcode == fp.INTERRUPT:
            return
        elif opcode == fp.DESTROY:
            self._reply(unique)
            self._closed.set()
        elif opcode == fp.LOOKUP:
            self._op_lookup(unique, nodeid, body)
        elif opcode == fp.GETATTR:
            self._op_getattr(unique, nodeid)
        elif opcode == fp.READLINK:
            self._op_readlink(unique, nodeid)
        elif opcode in (fp.OPEN, fp.OPENDIR):
            self._reply(unique, fp.OPEN_OUT.pack(nodeid, 0, 0))
        elif opcode in (fp.RELEASE, fp.RELEASEDIR, fp.FLUSH, fp.FSYNC, fp.FSYNCDIR, fp.ACCESS):
            self._reply(unique)
        elif opcode == fp.READ:
            self._op_read(unique, nodeid, body)
        elif opcode == fp.READDIR:
            self._op_readdir(unique, nodeid, body)
        elif opcode == fp.READDIRPLUS:
            self._op_readdirplus(unique, nodeid, body)
        elif opcode == fp.STATFS:
            self._op_statfs(unique)
        elif opcode == fp.GETXATTR:
            self._op_getxattr(unique, nodeid, body)
        elif opcode == fp.LISTXATTR:
            self._op_listxattr(unique, nodeid, body)
        elif opcode == fp.LSEEK:
            self._op_lseek(unique, nodeid, body)
        elif opcode in fp.WRITE_OPCODES:
            self._reply(unique, error=fp.EROFS)
        else:
            self._reply(unique, error=fp.ENOSYS)

    # -- operations ---------------------------------------------------------

    def _op_init(self, unique: int, body: bytes) -> None:
        major, minor, max_readahead, _flags = fp.INIT_IN_PREFIX.unpack_from(body)
        if major != fp.FUSE_KERNEL_VERSION:
            self._reply(unique, error=fp.EIO)
            return
        out = fp.INIT_OUT.pack(
            fp.FUSE_KERNEL_VERSION,
            min(minor, fp.FUSE_KERNEL_MINOR),
            min(max_readahead, fp.MAX_READAHEAD),
            0,  # no feature flags: plain synchronous read-only serving
            16,  # max_background
            12,  # congestion_threshold
            fp.MAX_WRITE,
            1,  # time_gran
            0,
            0,
            0,
            0, 0, 0, 0, 0, 0, 0,
        )
        self._reply(unique, out)

    def _inode(self, nodeid: int) -> Optional[Inode]:
        return self.ops.by_ino.get(nodeid)

    def _entry_out(self, inode: Inode) -> bytes:
        target = self.ops.resolve(inode)
        return (
            fp.ENTRY_OUT_PREFIX.pack(
                target.ino, 0, self.ENTRY_VALID_S, self.ENTRY_VALID_S, 0, 0
            )
            + self.ops.attr_bytes(inode)
        )

    def _op_lookup(self, unique: int, nodeid: int, body: bytes) -> None:
        name = body.rstrip(b"\x00")
        kids = self.ops.children.get(nodeid)
        child = kids.get(name) if kids else None
        if child is None:
            self._reply(unique, error=fp.ENOENT)
            return
        self._reply(unique, self._entry_out(child))

    def _op_getattr(self, unique: int, nodeid: int) -> None:
        inode = self._inode(nodeid)
        if inode is None:
            self._reply(unique, error=fp.ENOENT)
            return
        out = (
            fp.ATTR_OUT_PREFIX.pack(self.ENTRY_VALID_S, 0, 0) + self.ops.attr_bytes(inode)
        )
        self._reply(unique, out)

    def _op_readlink(self, unique: int, nodeid: int) -> None:
        inode = self._inode(nodeid)
        if inode is None or not stat_mod.S_ISLNK(inode.mode):
            self._reply(unique, error=fp.EINVAL)
            return
        self._reply(unique, inode.symlink_target.encode())

    def _op_read(self, unique: int, nodeid: int, body: bytes) -> None:
        (_fh, offset, size, _rflags, _lock, _flags, _pad) = fp.READ_IN.unpack_from(body)
        inode = self._inode(nodeid)
        if inode is None:
            self._reply(unique, error=fp.ENOENT)
            return
        target = self.ops.resolve(inode)
        if not stat_mod.S_ISREG(target.mode):
            self._reply(unique, error=fp.EISDIR if stat_mod.S_ISDIR(target.mode) else fp.EINVAL)
            return
        try:
            data = self.ops.read_file(target.path, offset, size)
        except FileNotFoundError:
            self._reply(unique, error=fp.ENOENT)
            return
        except Exception:
            logger.exception("fuse read %s failed", target.path)
            self._reply(unique, error=fp.EIO)
            return
        self._reply(unique, data)

    def _dirents(self, nodeid: int) -> Optional[list[tuple[bytes, Inode]]]:
        inode = self._inode(nodeid)
        if inode is None or not stat_mod.S_ISDIR(inode.mode):
            return None
        parent = self.ops.by_ino.get(inode.parent_ino, inode)
        out: list[tuple[bytes, Inode]] = [(b".", inode), (b"..", parent)]
        out.extend(sorted(self.ops.children.get(nodeid, {}).items()))
        return out

    def _op_readdir(self, unique: int, nodeid: int, body: bytes) -> None:
        (_fh, offset, size, _rflags, _lock, _flags, _pad) = fp.READ_IN.unpack_from(body)
        entries = self._dirents(nodeid)
        if entries is None:
            self._reply(unique, error=fp.ENOTDIR)
            return
        out = bytearray()
        for i, (name, child) in enumerate(entries):
            if i < offset:
                continue
            target = self.ops.resolve(child)
            rec = fp.pack_dirent(target.ino, i + 1, name, (target.mode >> 12) & 0xF)
            if len(out) + len(rec) > size:
                break
            out += rec
        self._reply(unique, bytes(out))

    def _op_readdirplus(self, unique: int, nodeid: int, body: bytes) -> None:
        (_fh, offset, size, _rflags, _lock, _flags, _pad) = fp.READ_IN.unpack_from(body)
        entries = self._dirents(nodeid)
        if entries is None:
            self._reply(unique, error=fp.ENOTDIR)
            return
        out = bytearray()
        for i, (name, child) in enumerate(entries):
            if i < offset:
                continue
            target = self.ops.resolve(child)
            # direntplus = entry_out + dirent; "." and ".." carry an empty
            # entry (nodeid 0) so the kernel doesn't double-count lookups.
            if name in (b".", b".."):
                entry = fp.ENTRY_OUT_PREFIX.pack(0, 0, 0, 0, 0, 0) + fp.pack_attr(
                    target.ino, 0, target.mode
                )
            else:
                entry = self._entry_out(child)
            rec = entry + fp.pack_dirent(target.ino, i + 1, name, (target.mode >> 12) & 0xF)
            if len(out) + len(rec) > size:
                break
            out += rec
        self._reply(unique, bytes(out))

    def _op_statfs(self, unique: int) -> None:
        n_files = len(self.ops.by_ino)
        self._reply(unique, fp.KSTATFS.pack(0, 0, 0, n_files, 0, 4096, 255, 4096, 0))

    def _op_getxattr(self, unique: int, nodeid: int, body: bytes) -> None:
        size, _pad = fp.GETXATTR_IN.unpack_from(body)
        name = body[fp.GETXATTR_IN.size :].rstrip(b"\x00").decode("utf-8", "surrogateescape")
        inode = self._inode(nodeid)
        if inode is None:
            self._reply(unique, error=fp.ENOENT)
            return
        value = self.ops.resolve(inode).xattrs.get(name)
        if value is None:
            self._reply(unique, error=fp.ENODATA)
        elif size == 0:
            self._reply(unique, fp.GETXATTR_OUT.pack(len(value), 0))
        elif size < len(value):
            self._reply(unique, error=fp.ERANGE)
        else:
            self._reply(unique, value)

    def _op_listxattr(self, unique: int, nodeid: int, body: bytes) -> None:
        size, _pad = fp.GETXATTR_IN.unpack_from(body)
        inode = self._inode(nodeid)
        if inode is None:
            self._reply(unique, error=fp.ENOENT)
            return
        names = b"".join(
            k.encode("utf-8", "surrogateescape") + b"\x00"
            for k in sorted(self.ops.resolve(inode).xattrs)
        )
        if size == 0:
            self._reply(unique, fp.GETXATTR_OUT.pack(len(names), 0))
        elif size < len(names):
            self._reply(unique, error=fp.ERANGE)
        else:
            self._reply(unique, names)

    def _op_lseek(self, unique: int, nodeid: int, body: bytes) -> None:
        _fh, offset, whence, _pad = fp.LSEEK_IN.unpack_from(body)
        inode = self._inode(nodeid)
        if inode is None:
            self._reply(unique, error=fp.ENOENT)
            return
        size = self.ops.resolve(inode).size
        # SEEK_DATA(3): every byte is data; SEEK_HOLE(4): the hole is at EOF.
        if whence == 3:
            if offset >= size:
                self._reply(unique, error=6)  # ENXIO
            else:
                self._reply(unique, fp.LSEEK_OUT.pack(offset))
        elif whence == 4:
            self._reply(unique, fp.LSEEK_OUT.pack(size))
        else:
            self._reply(unique, error=fp.EINVAL)
