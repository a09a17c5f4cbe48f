"""Metric collectors (reference pkg/metrics/collector).

Each collector's ``collect()`` pulls one round of measurements into the
registry gauges; the MetricsServer schedules them (1-minute cadence for
snapshotter/fs/daemon, 10-second cadence for inflight-hung IO,
serve.go:26,160-189).
"""

from __future__ import annotations

import logging
import os
import time
from typing import Iterable, Optional

from nydus_snapshotter_tpu_torch.daemon.types import DaemonState
from nydus_snapshotter_tpu_torch.metrics import data, tool

logger = logging.getLogger(__name__)


class SnapshotterMetricsCollector:
    """Self CPU/RSS/fds/threads/cache-usage (collector/snapshotter.go)."""

    def __init__(self, cache_dir: str, pid: Optional[int] = None):
        self.cache_dir = cache_dir
        self.pid = pid or os.getpid()
        self._cpu = tool.CPUSampler(self.pid)
        self._cpu.sample()

    def _cache_usage_kb(self) -> float:
        total = 0
        try:
            names = os.listdir(self.cache_dir)
        except OSError:
            return 0.0
        for name in names:
            try:
                total += os.lstat(os.path.join(self.cache_dir, name)).st_size
            except OSError:
                continue
        return total / 1024.0

    def collect(self) -> None:
        try:
            st = tool.read_process_stat(self.pid)
            data.CPUUser.set(st.utime)
            data.CPUSystem.set(st.stime)
            data.Thread.set(st.threads)
        except (OSError, ValueError):
            pass
        data.CPUUsage.set(self._cpu.sample())
        data.MemoryUsage.set(tool.get_process_memory_rss_kb(self.pid))
        data.Fds.set(tool.get_fd_count(self.pid))
        data.RunTime.set(tool.run_time_seconds(self.pid))
        data.CacheUsage.set(self._cache_usage_kb())


class FsMetricsCollector:
    """Per-image FS metrics pulled from each running daemon's API
    (collector/fs.go + serve.go CollectFsMetrics)."""

    def __init__(self, managers: Iterable):
        self.managers = list(managers)

    def collect(self) -> None:
        for mgr in self.managers:
            for d in mgr.list_daemons():
                if d.state() != DaemonState.RUNNING:
                    continue
                for rafs in d.instances.list():
                    try:
                        m = d.client().fs_metrics(rafs.relative_mountpoint())
                    except Exception:
                        continue
                    image = rafs.image_id or rafs.snapshot_id
                    data.FsTotalRead.labels(image).set(m.get("data_read", 0) / 1024.0)
                    fop_hits = m.get("fop_hits") or []
                    # nydusd reports fop_hits indexed by fop; READ index 0 in
                    # our daemon's metrics model.
                    if fop_hits:
                        data.FsReadCount.labels(image).set(fop_hits[0])
                    data.FsOpenFdCount.labels(image).set(m.get("nr_opens", 0))
                    data.FsOpenFdMaxCount.labels(image).set(m.get("nr_max_opens", 0))
                    fop_errors = m.get("fop_errors") or []
                    if fop_errors:
                        data.FsReadErrors.labels(image).set(fop_errors[0])
                    for le, hits in zip(
                        ("1", "20", "50", "100", "500", "1000", "2000", "+Inf"),
                        m.get("read_latency_dist") or [],
                    ):
                        data.FsReadLatencyHits.labels(image, le).set(hits)

    def clear_image(self, image_ref: str) -> None:
        for g in (data.FsTotalRead, data.FsReadCount, data.FsOpenFdCount,
                  data.FsOpenFdMaxCount, data.FsReadErrors):
            g.remove(image_ref)


class DaemonResourceCollector:
    """Daemon RSS + count (serve.go CollectDaemonResourceMetrics)."""

    def __init__(self, managers: Iterable):
        self.managers = list(managers)

    def collect(self) -> None:
        count = 0
        for mgr in self.managers:
            for d in mgr.list_daemons():
                count += 1
                pid = d.pid()
                if pid:
                    data.DaemonRSS.labels(d.id).set(tool.get_process_memory_rss_kb(pid))
        data.DaemonCount.set(count)


class InflightMetricsCollector:
    """Inflight/hung IO with a hung threshold (collector wiring
    serve.go:26; default 10s)."""

    def __init__(self, managers: Iterable, hung_threshold_sec: float = 10.0, clock=time.time):
        self.managers = list(managers)
        self.hung_threshold = hung_threshold_sec
        self._clock = clock

    def collect(self) -> None:
        now = self._clock()
        for mgr in self.managers:
            for d in mgr.list_daemons():
                if d.state() != DaemonState.RUNNING:
                    continue
                try:
                    inflight = d.client().inflight_metrics()
                except Exception:
                    continue
                hung = sum(
                    1 for op in inflight
                    if now - float(op.get("timestamp_secs", now)) > self.hung_threshold
                )
                data.InflightIOCount.labels(d.id).set(len(inflight))
                data.HungIOCount.labels(d.id).set(hung)


def record_daemon_event(daemon_id: str, event: str) -> None:
    """Daemon lifecycle event marker (collector/daemon.go)."""
    data.DaemonEvent.labels(daemon_id, event).set(time.time())


class _PairTimer:
    """One timing window observed into several histogram children."""

    def __init__(self, children):
        self._children = children

    def __enter__(self):
        self._start = time.monotonic()
        return self

    def __exit__(self, *exc):
        elapsed_ms = (time.monotonic() - self._start) * 1000.0
        for child in self._children:
            child.observe(elapsed_ms)
        return False


def snapshot_timer(operation: str):
    """Latency timer wrapped around snapshotter methods
    (collector.NewSnapshotMetricsTimer, snapshot.go:303-592). Lands in
    both the reference-named histogram (dashboards keyed on the Go
    exporter) and the ntpu_snapshot_* control-plane series."""
    return _PairTimer((
        data.SnapshotEventElapsedHists.labels(operation),
        data.SnapshotOpHists.labels(operation),
    ))
