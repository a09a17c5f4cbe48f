"""Content-store HTTP proxy for streaming unpack.

Reference pkg/converter/cs_proxy_unix.go:33-168: ``Unpack`` with streaming
enabled doesn't buffer whole blobs — it serves the content store over a
local HTTP endpoint and hands the consumer range-addressable blob URLs
(``http://<addr>/readblob/<digest>?offset=..&size=..``). Same contract
here, over TCP on localhost or a UDS.
"""

from __future__ import annotations

import logging
import socket
import socketserver
import threading
import urllib.parse
from http.server import BaseHTTPRequestHandler
from typing import Optional

from nydus_snapshotter_tpu_torch.converter.content import LocalContentStore

logger = logging.getLogger(__name__)


class ContentStoreProxy:
    """Serve blobs by digest with Range support (cs_proxy_unix.go:56-117)."""

    def __init__(self, cs: LocalContentStore, host: str = "127.0.0.1", port: int = 0):
        self.cs = cs
        proxy = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):
                pass

            def do_GET(self):
                parsed = urllib.parse.urlsplit(self.path)
                parts = parsed.path.strip("/").split("/")
                if len(parts) != 2 or parts[0] != "readblob":
                    self.send_response(404)
                    self.end_headers()
                    return
                digest = parts[1]
                params = urllib.parse.parse_qs(parsed.query)
                try:
                    data = proxy.cs.read(digest)
                except Exception as e:
                    logger.warning("readblob %s: %s", digest, e)
                    self.send_response(404)
                    self.end_headers()
                    return
                offset = int(params.get("offset", ["0"])[0])
                size = int(params.get("size", [str(len(data))])[0])
                body = data[offset : offset + size]
                self.send_response(200)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

        class Server(socketserver.ThreadingTCPServer):
            daemon_threads = True
            allow_reuse_address = True

        self.server = Server((host, port), Handler)
        self.thread: Optional[threading.Thread] = None

    @property
    def address(self) -> str:
        host, port = self.server.server_address[:2]
        return f"{host}:{port}"

    def blob_url(self, digest: str, offset: int = 0, size: int = -1) -> str:
        url = f"http://{self.address}/readblob/{digest}?offset={offset}"
        if size >= 0:
            url += f"&size={size}"
        return url

    def start(self) -> None:
        self.thread = threading.Thread(target=self.server.serve_forever, daemon=True)
        self.thread.start()

    def stop(self) -> None:
        self.server.shutdown()
        self.server.server_close()
