"""cachefiles ondemand daemon: the in-kernel EROFS-over-fscache data path.

Reference correspondence: nydusd's fscache mode — the daemon the
reference binds blobs through at pkg/daemon/daemon.go:275-324, mounting
EROFS with ``fsid=`` so the KERNEL pages data through cachefiles and the
userspace daemon only answers cache-miss reads. The Go side never speaks
this protocol itself (nydusd does); here the daemon is in-repo.

Protocol (kernel uapi include/uapi/linux/cachefiles.h, 5.19+ ondemand
mode):

- open ``/dev/cachefiles``; write ``dir <cache_root>``, ``tag <tag>``,
  ``bind ondemand``.
- each ``read()`` returns one ``cachefiles_msg``:
  ``{u32 msg_id, u32 object_id, u32 opcode, u32 len, u8 data[]}``.
- OPEN(0): data = ``cachefiles_open {u32 volume_key_size, u32
  cookie_key_size, u32 fd, u32 flags, u8 keys[]}``; the kernel passes an
  anon fd for the cache object; the daemon answers
  ``copen <msg_id>,<object_size>`` (negative size = error). For the
  erofs fsid domain, cookie_key is the blob/fscache id string.
- READ(2): data = ``cachefiles_read {u64 off, u64 len}``; the daemon
  pwrite()s the blob bytes into the object fd at ``off`` and acks with
  ``ioctl(fd, CACHEFILES_IOC_READ_COMPLETE, msg_id)``.
- CLOSE(1): drop the object fd.

The device is injectable (``DeviceIO``) so the message parser, copen
formatting, read servicing, and error paths are unit-tested on any
kernel (tests/test_cachefiles.py drives crafted msgs through pipes);
``supported()`` gates the real /dev/cachefiles path, which THIS
environment can never take: the container kernel exposes no cachefiles
device, no /proc/misc entry, and no module loading (see PARITY.md
environmental limits). On a cachefiles-capable kernel the same class
binds for real and `mount -t erofs -o fsid=` serves through it.
"""

from __future__ import annotations

import logging
import os
import struct
import threading
from dataclasses import dataclass
from typing import Callable, Optional

logger = logging.getLogger(__name__)

DEVICE_PATH = "/dev/cachefiles"

OP_OPEN = 0
OP_CLOSE = 1
OP_READ = 2

_MSG_HDR = struct.Struct("<IIII")  # msg_id, object_id, opcode, len
_OPEN_HDR = struct.Struct("<IIII")  # volume_key_size, cookie_key_size, fd, flags
_READ_REQ = struct.Struct("<QQ")  # off, len

# _IOW(0x98, 1, int): dir=write(1)<<30 | sizeof(int)<<16 | 0x98<<8 | 1
CACHEFILES_IOC_READ_COMPLETE = 0x40049801


class CachefilesError(RuntimeError):
    pass


def supported() -> bool:
    """True when this kernel exposes the cachefiles ondemand device."""
    return os.path.exists(DEVICE_PATH)


class DeviceIO:
    """Thin fd wrapper so tests can substitute pipes for /dev/cachefiles."""

    def __init__(self, fd: int):
        self.fd = fd

    def poll(self, timeout: float) -> bool:
        """True when a read would not block (select works on the char
        device and on the test pipes alike). The service loop polls so a
        stop() request is observed even on a quiescent device — closing
        an fd does NOT wake another thread blocked in read(2) on Linux."""
        import select

        r, _w, _x = select.select([self.fd], [], [], timeout)
        return bool(r)

    def read(self, n: int) -> bytes:
        return os.read(self.fd, n)

    def write(self, data: bytes) -> int:
        return os.write(self.fd, data)

    def ioctl(self, obj_fd: int, req: int, arg: int) -> None:
        import fcntl

        fcntl.ioctl(obj_fd, req, arg)

    def close(self) -> None:
        os.close(self.fd)


@dataclass
class _Object:
    object_id: int
    fd: int
    cookie_key: str
    volume_key: str
    size: int
    # resolved ONCE at open: READs must not re-invoke the resolver (an
    # unbind while the mount is live would kill them, and per-read
    # resolution leaked one fd per cache miss)
    reader: Callable[[int, int], bytes] = None
    closer: Optional[Callable[[], None]] = None


class CachefilesOndemandDaemon:
    """Serve cachefiles ondemand requests from a blob resolver.

    ``resolver(cookie_key) -> (size, reader[, closer])`` where
    ``reader(off, ln)`` returns exactly ``ln`` bytes of the blob — the
    blobcache's lazy read plane (daemon/blobcache.py) plugs straight in;
    the optional ``closer`` releases whatever the reader holds when the
    kernel closes the object. The resolver runs ONCE per OPEN; the
    result lives for the object's lifetime, so an unbind cannot break a
    live mount. Unknown cookies get a negative copen (the kernel fails
    the mount instead of hanging it).
    """

    def __init__(
        self,
        resolver: Callable[[str], tuple[int, Callable[[int, int], bytes]]],
        device: Optional[DeviceIO] = None,
        cache_dir: str = "",
        tag: str = "ntpu",
    ):
        self.resolver = resolver
        self.cache_dir = cache_dir
        self.tag = tag
        self.device = device
        self.objects: dict[int, _Object] = {}
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- lifecycle -----------------------------------------------------------

    def bind(self) -> None:
        """Open the real device and enter ondemand mode (kernel-gated)."""
        if self.device is None:
            if not supported():
                raise CachefilesError(f"{DEVICE_PATH} not present on this kernel")
            self.device = DeviceIO(os.open(DEVICE_PATH, os.O_RDWR))
        os.makedirs(self.cache_dir, exist_ok=True)
        for cmd in (f"dir {self.cache_dir}", f"tag {self.tag}", "bind ondemand"):
            self.device.write(cmd.encode())

    def run_forever(self) -> None:
        while not self._stop.is_set():
            try:
                if not self.device.poll(0.5):
                    continue
                buf = self.device.read(16 << 10)
            except OSError as e:
                if self._stop.is_set():
                    return
                raise CachefilesError(f"device read failed: {e}") from e
            if not buf:
                return  # device closed
            try:
                self.handle_msg(buf)
            except CachefilesError:
                # framing failure: the rest of this buffer is unparseable
                logger.exception("cachefiles framing failed; buffer dropped")

    def start(self) -> None:
        self._thread = threading.Thread(
            target=self.run_forever, name="cachefiles-ondemand", daemon=True
        )
        self._thread.start()

    def stop(self) -> None:
        # Join FIRST: the loop observes _stop within one poll interval,
        # and object fds must not be closed under an in-flight pwrite.
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
        if self.device is not None:
            try:
                self.device.close()
            except OSError:
                pass
        for obj in self.objects.values():
            self._release(obj)
        self.objects.clear()

    @staticmethod
    def _release(obj: _Object) -> None:
        try:
            os.close(obj.fd)
        except OSError:
            pass
        if obj.closer is not None:
            try:
                obj.closer()
            except Exception:
                logger.exception("cachefiles object closer failed")

    # -- protocol ------------------------------------------------------------

    def handle_msg(self, buf: bytes) -> None:
        """Parse and dispatch cachefiles_msg(s) from one read.

        The kernel returns one message per read; the embedded ``len``
        framing also lets coalesced buffers (the test pipes) carry
        several back-to-back.
        """
        while buf:
            if len(buf) < _MSG_HDR.size:
                raise CachefilesError(f"short cachefiles msg: {len(buf)} bytes")
            msg_id, object_id, opcode, ln = _MSG_HDR.unpack_from(buf)
            if ln < _MSG_HDR.size or ln > len(buf):
                raise CachefilesError(
                    f"cachefiles msg length {ln} outside read size {len(buf)}"
                )
            data = buf[_MSG_HDR.size : ln]
            buf = buf[ln:]
            # Per-message containment: one bad message (or one failing
            # blob read) must not take down the others — framing is
            # intact past this point, so later messages still serve.
            # A dead service loop would hang EVERY fscache mount.
            try:
                if opcode == OP_OPEN:
                    self._on_open(msg_id, object_id, data)
                elif opcode == OP_READ:
                    self._on_read(msg_id, object_id, data)
                elif opcode == OP_CLOSE:
                    self._on_close(object_id)
                else:
                    raise CachefilesError(f"unknown cachefiles opcode {opcode}")
            except (CachefilesError, OSError, KeyError):
                if threading.current_thread() is not self._thread:
                    raise  # direct handle_msg() callers see errors
                logger.exception("cachefiles message failed; loop continues")

    def _on_open(self, msg_id: int, object_id: int, data: bytes) -> None:
        if len(data) < _OPEN_HDR.size:
            raise CachefilesError("short cachefiles_open payload")
        vks, cks, fd, _flags = _OPEN_HDR.unpack_from(data)
        keys = data[_OPEN_HDR.size :]
        if len(keys) < vks + cks:
            raise CachefilesError("cachefiles_open keys overflow payload")
        volume_key = keys[:vks].split(b"\x00", 1)[0].decode(errors="replace")
        cookie_key = keys[vks : vks + cks].split(b"\x00", 1)[0].decode(
            errors="replace"
        )
        try:
            resolved = self.resolver(cookie_key)
            size, reader = resolved[0], resolved[1]
            closer = resolved[2] if len(resolved) > 2 else None
        except Exception:
            # ANY resolver failure (unknown cookie, unreadable bootstrap,
            # render error) must fail the open: the kernel surfaces ENOENT
            # to the mount instead of wedging it waiting for a copen that
            # would never come.
            logger.exception("cachefiles open failed for cookie %r", cookie_key)
            if fd >= 0:
                try:
                    os.close(fd)
                except OSError:
                    pass
            self.device.write(f"copen {msg_id},-2".encode())  # -ENOENT
            return
        self.objects[object_id] = _Object(
            object_id=object_id,
            fd=fd,
            cookie_key=cookie_key,
            volume_key=volume_key,
            size=size,
            reader=reader,
            closer=closer,
        )
        self.device.write(f"copen {msg_id},{size}".encode())

    def _on_read(self, msg_id: int, object_id: int, data: bytes) -> None:
        if len(data) < _READ_REQ.size:
            raise CachefilesError("short cachefiles_read payload")
        off, ln = _READ_REQ.unpack_from(data)
        obj = self.objects.get(object_id)
        if obj is None:
            raise CachefilesError(f"read for unknown object {object_id}")
        # clamp to the object: the kernel may round the window up
        end = min(off + ln, obj.size)
        chunk = obj.reader(off, max(0, end - off)) if end > off else b""
        pos = off
        view = memoryview(chunk)
        while view:
            n = os.pwrite(obj.fd, view, pos)
            pos += n
            view = view[n:]
        self.device.ioctl(obj.fd, CACHEFILES_IOC_READ_COMPLETE, msg_id)

    def _on_close(self, object_id: int) -> None:
        obj = self.objects.pop(object_id, None)
        if obj is not None:
            self._release(obj)
