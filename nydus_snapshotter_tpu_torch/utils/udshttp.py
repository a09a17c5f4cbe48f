"""Tiny HTTP client over a UDS path or ``host:port`` address.

The fleet plane (member registration, metrics scrape, trace pull,
``tools/ntpuctl.py``) talks to member API sockets the same way the dict
service and peer tier do — HTTP over a unix socket, falling back to TCP
when the address has no ``/``. Connections are per-call: fleet traffic
is a low-rate control plane, and a dead member must cost one bounded
dial, never a wedged keep-alive.
"""

from __future__ import annotations

import http.client
import json
import socket
from typing import Optional


class UDSHTTPConnection(http.client.HTTPConnection):
    def __init__(self, sock_path: str, timeout: float):
        super().__init__("localhost", timeout=timeout)
        self._sock_path = sock_path

    def connect(self) -> None:
        s = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        s.settimeout(self.timeout)
        try:
            s.connect(self._sock_path)
        except BaseException:
            # A dead endpoint must not leak the half-made socket.
            s.close()
            raise
        self.sock = s


def is_uds(address: str) -> bool:
    return "/" in address


def connect(address: str, timeout: float = 5.0) -> http.client.HTTPConnection:
    if is_uds(address):
        return UDSHTTPConnection(address, timeout)
    host, _, port = address.rpartition(":")
    return http.client.HTTPConnection(host or "localhost", int(port), timeout=timeout)


def request(
    address: str,
    path: str,
    method: str = "GET",
    body: Optional[bytes] = None,
    headers: Optional[dict] = None,
    timeout: float = 5.0,
) -> tuple[int, bytes]:
    """One bounded request; returns (status, body). Raises OSError /
    http.client.HTTPException on transport failure."""
    conn = connect(address, timeout)
    try:
        # Connection: close — per-call connections must not park in the
        # member's keep-alive loop until GC.
        conn.request(
            method, path, body=body,
            headers={"Connection": "close", **(headers or {})},
        )
        resp = conn.getresponse()
        return resp.status, resp.read()
    finally:
        conn.close()


def get_json(address: str, path: str, timeout: float = 5.0):
    status, body = request(address, path, timeout=timeout)
    if status != 200:
        raise OSError(f"{address} {path} -> {status}: {body[:120]!r}")
    return json.loads(body)


def post_json(address: str, path: str, payload, timeout: float = 5.0):
    body = json.dumps(payload).encode()
    status, out = request(
        address,
        path,
        method="POST",
        body=body,
        headers={"Content-Type": "application/json"},
        timeout=timeout,
    )
    if status not in (200, 204):
        raise OSError(f"{address} {path} -> {status}: {out[:120]!r}")
    return json.loads(out) if out else {}
