"""Metrics server: periodic collection + /v1/metrics HTTP listener.

Reference pkg/metrics/serve.go:44-189 + listener.go:32-53. Collection
cadence: 1 minute for snapshotter/fs/daemon collectors, 10 seconds for
inflight-hung IO.
"""

from __future__ import annotations

import logging
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Iterable, Optional

from nydus_snapshotter_tpu_torch.analysis import runtime as _an
from nydus_snapshotter_tpu_torch.metrics import data
from nydus_snapshotter_tpu_torch.metrics.collector import (
    DaemonResourceCollector,
    FsMetricsCollector,
    InflightMetricsCollector,
    SnapshotterMetricsCollector,
)
from nydus_snapshotter_tpu_torch.metrics.registry import Registry, default_registry

logger = logging.getLogger(__name__)

COLLECT_INTERVAL_SEC = 60.0
INFLIGHT_INTERVAL_SEC = 10.0


class MetricsServer:
    def __init__(
        self,
        managers: Iterable = (),
        cache_dir: str = "",
        registry: Optional[Registry] = None,
        collect_interval_sec: float = COLLECT_INTERVAL_SEC,
        inflight_interval_sec: float = INFLIGHT_INTERVAL_SEC,
    ):
        managers = list(managers)
        self.registry = registry or default_registry
        self.sn_collector = SnapshotterMetricsCollector(cache_dir)
        self.fs_collector = FsMetricsCollector(managers)
        self.daemon_collector = DaemonResourceCollector(managers)
        self.inflight_collector = InflightMetricsCollector(managers)
        self._collect_interval = collect_interval_sec
        self._inflight_interval = inflight_interval_sec
        self._stop = threading.Event()
        self._threads: list[threading.Thread] = []
        self._httpd: Optional[ThreadingHTTPServer] = None
        # Cached collect_once+render snapshot (see snapshot()): the fleet
        # scoreboard and other summary consumers share ONE collection
        # round per max-age window instead of re-running the collectors
        # inline per request.
        self._snap_lock = _an.make_lock("metrics.snapshot")
        self._snap_text = ""
        self._snap_time = -1.0e18
        self._snap_refreshing = False

    def snapshot(self, max_age_sec: float = 5.0) -> tuple[str, float]:
        """(rendered registry text, age in seconds) from a cached
        collection round at most ``max_age_sec`` old.

        At most one caller refreshes at a time, and the collectors run
        OUTSIDE the cache lock: while a refresh is in flight (a slow
        collector, a hung daemon RPC), every concurrent caller gets the
        previous snapshot immediately instead of queueing behind it.
        """
        now = time.monotonic()
        with self._snap_lock:
            age = now - self._snap_time
            if age <= max_age_sec or self._snap_refreshing:
                return self._snap_text, max(0.0, age)
            self._snap_refreshing = True
        try:
            self.collect_once()
            text = self.registry.render()
        finally:
            with self._snap_lock:
                self._snap_refreshing = False
        with self._snap_lock:
            self._snap_text = text
            self._snap_time = time.monotonic()
            return self._snap_text, 0.0

    def collect_once(self) -> None:
        # Per-collector isolation: one failing collector must not skip the
        # remaining ones, and each failure is counted per collector so a
        # broken collector is visible on the exposition, not just the log.
        # Each round is also timed per collector: a collector sliding
        # toward the federation deadline shows up in
        # ntpu_metrics_collector_seconds long before it wedges a round.
        for name, c in (
            ("snapshotter", self.sn_collector),
            ("fs", self.fs_collector),
            ("daemon", self.daemon_collector),
        ):
            t0 = time.perf_counter()
            try:
                c.collect()
            except Exception:
                data.MetricsCollectionErrors.labels(name).inc()
                logger.exception("metrics collection failed (collector=%s)", name)
            finally:
                data.CollectorSeconds.labels(name).observe(
                    time.perf_counter() - t0
                )

    def _collect_loop(self) -> None:
        while not self._stop.wait(self._collect_interval):
            self.collect_once()

    def _inflight_loop(self) -> None:
        while not self._stop.wait(self._inflight_interval):
            t0 = time.perf_counter()
            try:
                self.inflight_collector.collect()
            except Exception:
                data.MetricsCollectionErrors.labels("inflight").inc()
                logger.exception("inflight metrics collection failed")
            finally:
                data.CollectorSeconds.labels("inflight").observe(
                    time.perf_counter() - t0
                )

    def start_collecting(self) -> None:
        for fn in (self._collect_loop, self._inflight_loop):
            t = threading.Thread(target=fn, daemon=True)
            t.start()
            self._threads.append(t)

    # -- HTTP listener (listener.go:32-53) ------------------------------------

    def serve(self, addr: str) -> ThreadingHTTPServer:
        """Start the /v1/metrics listener on ``host:port``; returns the
        running server."""
        host, _, port = addr.rpartition(":")
        server = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):
                pass

            def do_GET(self):
                if self.path not in ("/v1/metrics", "/metrics"):
                    self.send_response(404)
                    self.end_headers()
                    return
                body = server.registry.render().encode()
                self.send_response(200)
                self.send_header("Content-Type", "text/plain; version=0.0.4")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

        self._httpd = ThreadingHTTPServer((host or "127.0.0.1", int(port)), Handler)
        t = threading.Thread(target=self._httpd.serve_forever, daemon=True)
        t.start()
        self._threads.append(t)
        return self._httpd

    @property
    def address(self) -> str:
        assert self._httpd is not None
        host, port = self._httpd.server_address[:2]
        return f"{host}:{port}"

    def stop(self) -> None:
        self._stop.set()
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None
