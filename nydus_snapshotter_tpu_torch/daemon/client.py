"""HTTP-over-UDS client for the daemon API.

Parity surface of reference pkg/daemon/client.go:31-58,62-79: daemon info,
mount/umount, metrics (fs/cache/inflight), start/exit/takeover/sendfd, plus
this framework's userspace read API.
"""

from __future__ import annotations

import errno
import http.client
import json
import os
import socket
import time
from typing import Any, Optional

from nydus_snapshotter_tpu_torch import failpoint
from nydus_snapshotter_tpu_torch.utils import errdefs
from nydus_snapshotter_tpu_torch.utils import retry as retry_lib


class ClientError(errdefs.NydusError):
    def __init__(self, status: int, message: str):
        super().__init__(f"daemon API {status}: {message}")
        self.status = status


class _UDSConnection(http.client.HTTPConnection):
    def __init__(self, sock_path: str, timeout: float = 10.0):
        super().__init__("localhost", timeout=timeout)
        self._sock_path = sock_path

    def connect(self):
        self.sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        self.sock.settimeout(self.timeout)
        # A full accept backlog surfaces as EAGAIN on UDS connect (it does
        # not queue); retry briefly so a mount storm doesn't turn into
        # spurious hard failures. ECONNREFUSED is NOT retried: it means no
        # listener (daemon dead), and liveness polling/failover detection
        # depends on that failing fast.
        deadline = time.monotonic() + self.timeout
        while True:
            try:
                self.sock.connect(self._sock_path)
                return
            except OSError as e:
                if e.errno != errno.EAGAIN or time.monotonic() >= deadline:
                    raise
                time.sleep(0.01)


class NydusdClient:
    def __init__(self, sock_path: str, timeout: float = 10.0):
        self.sock_path = sock_path
        self.timeout = timeout

    # -- plumbing -----------------------------------------------------------

    def _request(
        self, method: str, path: str, body: Optional[dict] = None, raw: bool = False
    ) -> Any:
        failpoint.hit("daemon.rpc")
        if method == "GET":
            # Idempotent reads retry through a daemon restarting mid-RPC
            # (connection torn down after connect); the deadline keeps the
            # whole loop inside this client's timeout. Non-idempotent
            # mounts/starts fail fast — their callers own recovery.
            try:
                return retry_lib.do_with_deadline(
                    lambda: self._request_once(method, path, body, raw),
                    deadline=self.timeout,
                    attempts=3,
                    delay=0.05,
                    retry_on=(ConnectionResetError, BrokenPipeError),
                )
            except retry_lib.RetryError as e:
                raise e.last
        return self._request_once(method, path, body, raw)

    def _request_once(
        self, method: str, path: str, body: Optional[dict] = None, raw: bool = False
    ) -> Any:
        conn = _UDSConnection(self.sock_path, self.timeout)
        try:
            data = json.dumps(body) if body is not None else None
            conn.request(method, path, body=data, headers={"Content-Type": "application/json"})
            resp = conn.getresponse()
            payload = resp.read()
            if resp.status >= 400:
                try:
                    message = json.loads(payload).get("error", "")
                except Exception:
                    message = payload.decode(errors="replace")
                if resp.status == 404:
                    raise errdefs.NotFound(message or path)
                if resp.status == 409:
                    raise errdefs.AlreadyExists(message or path)
                raise ClientError(resp.status, message)
            if raw:
                return payload
            return json.loads(payload) if payload else None
        finally:
            conn.close()

    def wait_until_socket_exists(self, timeout: float = 10.0) -> None:
        """Reference WaitUntilSocketExisted (client.go:171)."""
        deadline = time.time() + timeout
        while time.time() < deadline:
            if os.path.exists(self.sock_path):
                try:
                    self.get_daemon_info()
                    return
                except (OSError, errdefs.NydusError):
                    pass
            time.sleep(0.05)
        raise TimeoutError(f"daemon socket {self.sock_path} never became ready")

    # -- daemon lifecycle ---------------------------------------------------

    def get_daemon_info(self) -> dict[str, Any]:
        return self._request("GET", "/api/v1/daemon")

    def start(self) -> None:
        self._request("PUT", "/api/v1/daemon/start")

    def exit(self) -> None:
        self._request("PUT", "/api/v1/daemon/exit")

    def send_fd(self, driver: str = "fuse") -> None:
        self._request("PUT", f"/api/v1/daemon/{driver}/sendfd")

    def takeover(self, driver: str = "fuse") -> None:
        self._request("PUT", f"/api/v1/daemon/{driver}/takeover")

    # -- mounts -------------------------------------------------------------

    def mount(self, mountpoint: str, source: str, config: str, fs_type: str = "rafs") -> None:
        self._request(
            "POST",
            f"/api/v1/mount?mountpoint={mountpoint}",
            {"fs_type": fs_type, "source": source, "config": config},
        )

    def umount(self, mountpoint: str) -> None:
        self._request("DELETE", f"/api/v1/mount?mountpoint={mountpoint}")

    # -- fscache v2 blobs API (reference client.go:47-58) --------------------

    def bind_blob(self, daemon_config: str) -> None:
        self._request("PUT", "/api/v2/blobs", {"config": daemon_config})

    def unbind_blob(self, domain_id: str, blob_id: str) -> None:
        self._request("DELETE", f"/api/v2/blobs?domain_id={domain_id}&blob_id={blob_id}")

    # -- metrics ------------------------------------------------------------

    def fs_metrics(self, mountpoint: str = "") -> dict[str, Any]:
        suffix = f"?id={mountpoint}" if mountpoint else ""
        return self._request("GET", f"/api/v1/metrics{suffix}")

    def cache_metrics(self) -> dict[str, Any]:
        return self._request("GET", "/api/v1/metrics/blobcache")

    def inflight_metrics(self) -> list:
        return self._request("GET", "/api/v1/metrics/inflight") or []

    # -- userspace data plane ----------------------------------------------

    def read_file(self, mountpoint: str, path: str, offset: int = 0, size: int = -1) -> bytes:
        return self._request(
            "GET",
            f"/api/v1/fs?mountpoint={mountpoint}&op=read&path={path}"
            f"&offset={offset}&size={size}",
            raw=True,
        )

    def stat_file(self, mountpoint: str, path: str) -> dict[str, Any]:
        return self._request("GET", f"/api/v1/fs?mountpoint={mountpoint}&op=stat&path={path}")

    def list_dir(self, mountpoint: str, path: str) -> list[str]:
        return self._request("GET", f"/api/v1/fs?mountpoint={mountpoint}&op=list&path={path}")
