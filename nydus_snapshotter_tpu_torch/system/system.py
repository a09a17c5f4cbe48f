"""System controller: REST API over a unix-domain socket.

Reference pkg/system/system.go:36-446. Endpoints:

    GET  /api/v1/daemons               — daemon + instance inventory w/ RSS, read-data
    GET  /api/v1/daemons/records       — persisted daemon records from the store
    PUT  /api/v1/daemons/upgrade       — rolling live-upgrade {nydusd_path, version, policy}
    PUT  /api/v1/prefetch              — prefetch list from the NRI plugin
    GET  /api/v1/daemons/{id}/backend  — secret-filtered storage backend config
    */*  /api/v1/dict/...               — shared chunk-dict service routes
                                          (parallel/dict_service.py), when a
                                          DictService is attached
    */*  /api/v1/fleet/...              — fleet observability plane (member
                                          registry, federated metrics,
                                          merged traces, SLO status) when a
                                          fleet.FleetPlane is attached
"""

from __future__ import annotations

import json
import logging
import os
import re
import socketserver
import threading
from http.server import BaseHTTPRequestHandler
from typing import Iterable, Optional

from nydus_snapshotter_tpu_torch.config.daemonconfig import DaemonRuntimeConfig
from nydus_snapshotter_tpu_torch.metrics import tool as metrics_tool
from nydus_snapshotter_tpu_torch.prefetch import Pm

logger = logging.getLogger(__name__)

_BACKEND_RE = re.compile(r"^/api/v1/daemons/([^/]+)/backend$")


class _UnixHTTPServer(socketserver.ThreadingUnixStreamServer):
    daemon_threads = True

    def __init__(self, sock_path: str, handler):
        super().__init__(sock_path, handler)

    # BaseHTTPRequestHandler wants a (host, port) client address.
    def finish_request(self, request, client_address):
        self.RequestHandlerClass(request, ("uds", 0), self)


class SystemController:
    def __init__(
        self,
        fs=None,
        managers: Iterable = (),
        sock_path: str = "",
        dict_service=None,
        fleet=None,
    ):
        self.fs = fs
        self.managers = list(managers)
        self.sock_path = sock_path
        # Optional parallel/dict_service.DictService: its /api/v1/dict
        # routes are served on this controller's socket too, so one UDS
        # carries both the ops surface and the shared-dict RPCs.
        self.dict_service = dict_service
        # Optional fleet.FleetPlane: member registry + /api/v1/fleet
        # surface (federated metrics, merged traces, SLO status).
        self.fleet = fleet
        self._httpd: Optional[_UnixHTTPServer] = None

    # -- handlers -------------------------------------------------------------

    def describe_daemons(self) -> list[dict]:
        """system.go describeDaemons :233-281."""
        out = []
        for mgr in self.managers:
            for d in mgr.list_daemons():
                instances = {}
                for rafs in d.instances.list():
                    instances[rafs.snapshot_id] = {
                        "snapshot_id": rafs.snapshot_id,
                        "snapshot_dir": rafs.snapshot_dir,
                        "mountpoint": rafs.mountpoint,
                        "image_id": rafs.image_id,
                    }
                # Daemon.pid is a property; the reference calls it, which
                # fails this route for every real daemon.
                pid = d.pid() if callable(d.pid) else d.pid
                read_data = 0.0
                try:
                    m = d.client().fs_metrics("")
                    read_data = m.get("data_read", 0) / 1024.0
                except Exception:
                    pass
                out.append({
                    "id": d.id,
                    "pid": pid,
                    "api_socket": d.states.api_socket,
                    "supervisor_path": d.states.supervisor_path,
                    "reference": d.ref_count(),
                    "mountpoint": getattr(d, "host_mountpoint", lambda: "")(),
                    "startup_cpu_utilization": getattr(d, "startup_cpu_utilization", 0.0),
                    "memory_rss_kb": metrics_tool.get_process_memory_rss_kb(pid) if pid else 0.0,
                    "read_data_kb": read_data,
                    "instances": instances,
                })
        return out

    def daemon_records(self) -> list[dict]:
        """Persisted daemon rows (the reference stubs this with 501; we can
        serve it because sqlite, unlike bbolt, allows concurrent readers)."""
        out = []
        for mgr in self.managers:
            try:
                out.extend(rec for rec in mgr.db.walk_daemons())
            except Exception:
                continue
        return out

    def upgrade_daemons(self, req: dict) -> None:
        """Rolling live-upgrade (system.go:309-446): for each daemon, run
        the takeover dance via its manager; abort on first failure."""
        nydusd_path = req.get("nydusd_path", "")
        if nydusd_path and not os.path.exists(nydusd_path):
            raise FileNotFoundError(f"no such daemon binary {nydusd_path}")
        for mgr in self.managers:
            for d in mgr.list_daemons():
                if nydusd_path:
                    d.states.nydusd_path = nydusd_path  # type: ignore[attr-defined]
                mgr.do_daemon_upgrade(d)

    def get_backend(self, daemon_id: str) -> Optional[dict]:
        """Secret-filtered backend config for ``--backend-source``
        (system.go getBackend :179-231)."""
        for mgr in self.managers:
            d = mgr.get_by_daemon_id(daemon_id)
            if d is None:
                continue
            cfg_path = d.states.config_path
            if not cfg_path or not os.path.exists(cfg_path):
                return {"type": "", "config": {}}
            cfg = DaemonRuntimeConfig.from_template(cfg_path, d.states.fs_driver)
            exposed = cfg.exposed()
            backend = exposed.get("device", {}).get("backend", exposed.get("backend", {}))
            return {"type": backend.get("type", "registry"), "config": backend}
        return None

    # -- server ---------------------------------------------------------------

    def run(self) -> None:
        os.makedirs(os.path.dirname(self.sock_path) or ".", exist_ok=True)
        try:
            os.remove(self.sock_path)
        except FileNotFoundError:
            pass
        controller = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):
                pass

            def _json(self, payload, status: int = 200):
                body = json.dumps(payload).encode()
                self.send_response(status)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def _error(self, message: str, status: int):
                self._json({"code": "Unknown", "message": message}, status)

            def _fleet_route(self, body: bytes) -> bool:
                if not self.path.startswith("/api/v1/fleet") or controller.fleet is None:
                    return False
                status, ctype, payload = controller.fleet.handle(
                    self.command, self.path, self.headers, body
                )
                self.send_response(status)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(payload)))
                self.end_headers()
                self.wfile.write(payload)
                return True

            def _dict_route(self, body: bytes) -> bool:
                if not self.path.startswith("/api/v1/dict") or controller.dict_service is None:
                    return False
                status, ctype, payload = controller.dict_service.handle(
                    self.command, self.path, self.headers, body
                )
                self.send_response(status)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(payload)))
                self.end_headers()
                self.wfile.write(payload)
                return True

            def do_GET(self):
                try:
                    if self._fleet_route(b"") or self._dict_route(b""):
                        return
                    if self.path == "/api/v1/daemons":
                        self._json(controller.describe_daemons())
                        return
                    if self.path == "/api/v1/daemons/records":
                        self._json(controller.daemon_records())
                        return
                    if self.path == "/api/v1/traces":
                        # The snapshotter process's span ring as a Chrome
                        # trace_event document (open in Perfetto).
                        from nydus_snapshotter_tpu_torch import trace

                        self._json(trace.chrome_trace())
                        return
                    m = _BACKEND_RE.match(self.path)
                    if m:
                        backend = controller.get_backend(m.group(1))
                        if backend is None:
                            self._error("daemon not found", 404)
                        else:
                            self._json(backend)
                        return
                    self._error("no such endpoint", 404)
                except Exception as e:
                    logger.exception("system controller GET %s", self.path)
                    self._error(str(e), 500)

            def do_POST(self):
                length = int(self.headers.get("Content-Length", 0))
                body = self.rfile.read(length)
                try:
                    if self._fleet_route(body) or self._dict_route(body):
                        return
                    self._error("no such endpoint", 404)
                except Exception as e:
                    logger.exception("system controller POST %s", self.path)
                    self._error(str(e), 500)

            def do_DELETE(self):
                length = int(self.headers.get("Content-Length", 0))
                body = self.rfile.read(length)
                try:
                    if self._fleet_route(body):
                        return
                    self._error("no such endpoint", 404)
                except Exception as e:
                    logger.exception("system controller DELETE %s", self.path)
                    self._error(str(e), 500)

            def do_PUT(self):
                length = int(self.headers.get("Content-Length", 0))
                body = self.rfile.read(length)
                try:
                    if self.path == "/api/v1/prefetch":
                        Pm.set_prefetch_files(body)
                        self._json({})
                        return
                    if self.path == "/api/v1/daemons/upgrade":
                        controller.upgrade_daemons(json.loads(body or b"{}"))
                        self._json({})
                        return
                    self._error("no such endpoint", 404)
                except FileNotFoundError as e:
                    self._error(str(e), 404)
                except ValueError as e:
                    self._error(str(e), 400)
                except Exception as e:
                    logger.exception("system controller PUT %s", self.path)
                    self._error(str(e), 500)

        self._httpd = _UnixHTTPServer(self.sock_path, Handler)
        threading.Thread(target=self._httpd.serve_forever, daemon=True).start()

    def stop(self) -> None:
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None
        try:
            os.remove(self.sock_path)
        except OSError:
            pass
