"""Per-daemon failover state keeper with SCM_RIGHTS fd passing.

Reference pkg/supervisor/supervisor.go:66-418: each daemon gets a dedicated
UDS; the daemon pushes its runtime state plus live fds (FUSE session /
fscache) before dying or upgrading, and the replacement daemon pulls them
back — mounts survive with zero disruption.

Protocol on the per-daemon socket (SOCK_STREAM, one request per
connection):
- daemon → supervisor: sendmsg(state-bytes [+ fds])  → stored
- daemon → supervisor: b"TAKEOVER"                   → replied with
  sendmsg(state-bytes [+ stored fds])
"""

from __future__ import annotations

import logging
import os
import socket
import threading
from typing import Optional

logger = logging.getLogger(__name__)

TAKEOVER_MAGIC = b"TAKEOVER"
_MAX_STATE = 1 << 22  # 4 MiB of serialized mount state
# SCM_RIGHTS receive cap: 1 state memfd + one live FUSE session fd per
# mounted instance. The kernel silently closes fds beyond the cap, which
# would strand those kernel mounts with no reader after a failover — so the
# cap is high and _handle logs when it is hit.
_MAX_FDS = 253  # SCM_MAX_FD, the kernel's own per-message ceiling


class Supervisor:
    def __init__(self, daemon_id: str, sock_path: str):
        self.daemon_id = daemon_id
        self.sock_path = sock_path
        self._lock = threading.Lock()
        self._state: Optional[bytes] = None
        self._fds: list[int] = []
        self._listener: Optional[socket.socket] = None
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()

    # -- lifecycle ----------------------------------------------------------

    def start(self) -> None:
        os.makedirs(os.path.dirname(self.sock_path) or ".", exist_ok=True)
        if os.path.exists(self.sock_path):
            os.unlink(self.sock_path)
        self._listener = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        self._listener.bind(self.sock_path)
        self._listener.listen(4)
        self._listener.settimeout(0.2)
        self._stop.clear()
        self._thread = threading.Thread(target=self._serve, daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2)
        if self._listener is not None:
            self._listener.close()
            self._listener = None
        try:
            os.unlink(self.sock_path)
        except OSError:
            pass
        self._drop_fds()

    def _serve(self) -> None:
        while not self._stop.is_set():
            try:
                conn, _ = self._listener.accept()
            except socket.timeout:
                continue
            except OSError:
                return
            try:
                self._handle(conn)
            finally:
                conn.close()

    def _handle(self, conn: socket.socket) -> None:
        msg, fds, _flags, _addr = socket.recv_fds(conn, _MAX_STATE, _MAX_FDS)
        if len(fds) >= _MAX_FDS:
            logger.error(
                "supervisor %s: SCM_RIGHTS message hit the %d-fd cap; "
                "session fds may have been truncated", self.sock_path, _MAX_FDS,
            )
        if msg == TAKEOVER_MAGIC and not fds:
            with self._lock:
                state = self._state or b""
                out_fds = list(self._fds)
            socket.send_fds(conn, [state or b"{}"], out_fds)
        else:
            # Fresh state push replaces any previous session.
            with self._lock:
                self._drop_fds_locked()
                self._state = msg
                self._fds = list(fds)

    # -- host-side accessors (reference FetchDaemonStates / SendStatesTimeout)

    def has_state(self) -> bool:
        with self._lock:
            return self._state is not None

    def fetch_state(self) -> Optional[bytes]:
        with self._lock:
            return self._state

    def wait_for_state(self, timeout: float = 10.0) -> bool:
        """Wait until the daemon has pushed its state (failover window)."""
        import time

        deadline = time.time() + timeout
        while time.time() < deadline:
            if self.has_state():
                return True
            time.sleep(0.02)
        return False

    def _drop_fds(self) -> None:
        with self._lock:
            self._drop_fds_locked()

    def _drop_fds_locked(self) -> None:
        for fd in self._fds:
            try:
                os.close(fd)
            except OSError:
                pass
        self._fds = []


class SupervisorSet:
    """All supervisors, one per daemon (reference SupervisorsSet :350-418)."""

    def __init__(self, root: str):
        self.root = root
        self._lock = threading.Lock()
        self._by_id: dict[str, Supervisor] = {}

    def new_supervisor(self, daemon_id: str) -> Supervisor:
        path = os.path.join(self.root, f"{daemon_id}-supervisor.sock")
        with self._lock:
            if daemon_id in self._by_id:
                return self._by_id[daemon_id]
            sup = Supervisor(daemon_id, path)
            sup.start()
            self._by_id[daemon_id] = sup
            return sup

    def get(self, daemon_id: str) -> Optional[Supervisor]:
        with self._lock:
            return self._by_id.get(daemon_id)

    def destroy(self, daemon_id: str) -> None:
        with self._lock:
            sup = self._by_id.pop(daemon_id, None)
        if sup is not None:
            sup.stop()
