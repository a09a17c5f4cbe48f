"""Liveness monitor: epoll on daemon API sockets.

Reference pkg/manager/monitor.go:26-229: subscribe a connected unix socket
per daemon and watch it; the daemon's end closing means the daemon died —
emit a death event on the notifier channel.

The socket is watched level-triggered for EPOLLIN | EPOLLRDHUP as well as
EPOLLHUP | EPOLLERR. Some kernels report the peer's close to poll(2) yet
raise no epoll edge for a mask of EPOLLHUP | EPOLLERR alone, which leaves
an edge-triggered watch blind to a SIGKILLed daemon. The daemon never
writes on this connection, so a readable socket is checked by a read for
end of stream before the death event goes out.
"""

from __future__ import annotations

import queue
import select
import socket
import threading
from dataclasses import dataclass
from typing import Optional


_WATCH = select.EPOLLIN | select.EPOLLRDHUP | select.EPOLLHUP | select.EPOLLERR
_GONE = select.EPOLLRDHUP | select.EPOLLHUP | select.EPOLLERR


def _peer_closed(sock: socket.socket) -> bool:
    """True when the daemon's end of ``sock`` is gone: end of stream or an
    error. Bytes the daemon sent unasked are read and dropped."""
    try:
        while True:
            data = sock.recv(4096)
            if not data:
                return True
    except (BlockingIOError, InterruptedError):
        return False
    except OSError:
        return True


@dataclass(frozen=True)
class DeathEvent:
    daemon_id: str
    path: str


class LivenessMonitor:
    def __init__(self):
        self._epoll = select.epoll()
        self._lock = threading.Lock()
        self._socks: dict[int, tuple[str, str, socket.socket]] = {}  # fd -> (id, path, sock)
        self._by_id: dict[str, int] = {}
        self.events: "queue.Queue[DeathEvent]" = queue.Queue()
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self._closed = False

    def subscribe(self, daemon_id: str, sock_path: str) -> None:
        """Connect to the daemon socket and watch for its close
        (reference monitor.go:81-138). Exception-safe: a failed connect
        or register never leaks the socket fd."""
        s = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        try:
            s.connect(sock_path)
            s.setblocking(False)
            fd = s.fileno()
            with self._lock:
                if self._closed:
                    raise ValueError("monitor is stopped")
                if daemon_id in self._by_id:
                    self._unsubscribe_locked(daemon_id)
                self._epoll.register(fd, _WATCH)
                self._socks[fd] = (daemon_id, sock_path, s)
                self._by_id[daemon_id] = fd
        except BaseException:
            s.close()
            raise

    def unsubscribe(self, daemon_id: str) -> None:
        with self._lock:
            self._unsubscribe_locked(daemon_id)

    def _unsubscribe_locked(self, daemon_id: str) -> None:
        """Unregister from epoll AND close the socket — the single
        teardown used by explicit unsubscribe, death events, and stop(),
        so no path can leak a watched fd."""
        fd = self._by_id.pop(daemon_id, None)
        if fd is None:
            return
        try:
            self._epoll.unregister(fd)
        except (OSError, ValueError):
            pass  # fd already gone, or epoll already closed
        entry = self._socks.pop(fd, None)
        if entry is not None:
            entry[2].close()

    def run(self) -> None:
        """Event loop (reference monitor.go:191-229)."""
        with self._lock:
            if self._closed:
                raise ValueError("monitor is stopped")
        self._stop.clear()
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def _loop(self) -> None:
        while not self._stop.is_set():
            try:
                events = self._epoll.poll(timeout=0.2)
            except (OSError, ValueError):
                return
            for fd, event in events:
                with self._lock:
                    entry = self._socks.get(fd)
                    if entry is None:
                        continue
                    daemon_id, path, sock = entry
                    if not (event & _GONE or _peer_closed(sock)):
                        continue
                    self._unsubscribe_locked(daemon_id)
                self.events.put(DeathEvent(daemon_id=daemon_id, path=path))

    def stop(self) -> None:
        """Join the poll thread, drop every subscription, close the epoll
        fd. Idempotent: repeated setup/teardown in tests must not leak or
        double-close fds."""
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2)
            self._thread = None
        with self._lock:
            if self._closed:
                return
            self._closed = True
            for daemon_id in list(self._by_id):
                self._unsubscribe_locked(daemon_id)
        self._epoll.close()
