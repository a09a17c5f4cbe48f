"""prefetchfiles NRI plugin: relay pod prefetch hints to the snapshotter.

Reference cmd/prefetchfiles-nri-plugin/main.go: on RunPodSandbox, read the
pod annotation ``containerd.io/nydus-prefetch`` (a JSON prefetch list) and
PUT it to the snapshotter's system controller at ``/api/v1/prefetch`` over
its UDS. Same stdin JSON-lines event feed as the optimizer plugin.
"""

from __future__ import annotations

import argparse
import http.client
import json
import logging
import socket
import sys

logger = logging.getLogger("prefetchfiles-nri-plugin")

ENDPOINT_PREFETCH = "/api/v1/prefetch"
NYDUS_PREFETCH_ANNOTATION = "containerd.io/nydus-prefetch"
DEFAULT_SYSTEM_SOCK = "/run/containerd-nydus/system.sock"


class _UDSConnection(http.client.HTTPConnection):
    def __init__(self, sock_path: str, timeout: float = 15.0):
        super().__init__("unix", timeout=timeout)
        self.sock_path = sock_path

    def connect(self) -> None:
        self.sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        self.sock.settimeout(self.timeout)
        self.sock.connect(self.sock_path)


def send_data_over_http(data: str, endpoint: str, sock_path: str) -> None:
    """PUT ``data`` to the system controller (main.go:92-117)."""
    conn = _UDSConnection(sock_path)
    try:
        conn.request("PUT", endpoint, body=data.encode())
        resp = conn.getresponse()
        resp.read()
        if resp.status != 200:
            raise RuntimeError(f"failed to send data, status code: {resp.status}")
    finally:
        conn.close()


class PrefetchPlugin:
    def __init__(self, socket_path: str = DEFAULT_SYSTEM_SOCK):
        self.socket_path = socket_path

    def run_pod_sandbox(self, pod: dict) -> None:
        """main.go RunPodSandbox :119-131."""
        prefetch_list = (pod.get("annotations") or {}).get(NYDUS_PREFETCH_ANNOTATION)
        if prefetch_list is None:
            return
        send_data_over_http(prefetch_list, ENDPOINT_PREFETCH, self.socket_path)

    def handle_event(self, event: dict) -> None:
        if event.get("event") == "RunPodSandbox":
            self.run_pod_sandbox(event.get("pod") or {})


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="prefetchfiles-nri-plugin")
    p.add_argument("--name", default="prefetch")
    p.add_argument("--idx", default="")
    p.add_argument("--socket-addr", default=DEFAULT_SYSTEM_SOCK)
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    plugin = PrefetchPlugin(socket_path=args.socket_addr)
    # readline(), not stdin iteration: avoid the iterator's read-ahead delay
    for line in iter(sys.stdin.readline, ""):
        line = line.strip()
        if not line:
            continue
        try:
            plugin.handle_event(json.loads(line))
        except Exception as e:
            logger.error("event failed: %s", e)
    return 0


if __name__ == "__main__":
    sys.exit(main())
