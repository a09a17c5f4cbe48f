"""Metric definitions (reference pkg/metrics/data/{snapshotter,fs,daemon}.go).

Same metric names as the reference exporter so dashboards keyed on the Go
snapshotter keep working.
"""

from __future__ import annotations

from nydus_snapshotter_tpu_torch.metrics.registry import (
    Counter,
    Gauge,
    Histogram,
    TTLGauge,
    default_registry as reg,
)

# -- snapshotter self metrics (data/snapshotter.go:19-83) ---------------------

SnapshotEventElapsedHists = reg.register(Histogram(
    "snapshotter_snapshot_operation_elapsed_milliseconds",
    "The elapsed time for snapshot events.",
    ("snapshot_operation",),
))
CacheUsage = reg.register(Gauge(
    "snapshotter_cache_usage_kilobytes", "Disk usage of snapshotter local cache."))
CPUUsage = reg.register(Gauge(
    "snapshotter_cpu_usage_percentage", "CPU usage percentage of snapshotter."))
MemoryUsage = reg.register(Gauge(
    "snapshotter_memory_usage_kilobytes", "Memory usage (RSS) of snapshotter."))
CPUSystem = reg.register(Gauge(
    "snapshotter_cpu_system_time_seconds", "CPU time of snapshotter in system."))
CPUUser = reg.register(Gauge(
    "snapshotter_cpu_user_time_seconds", "CPU time of snapshotter in user."))
Fds = reg.register(Gauge("snapshotter_fd_counts", "Fd counts of snapshotter."))
RunTime = reg.register(Gauge(
    "snapshotter_run_time_seconds", "Running time of snapshotter from starting."))
Thread = reg.register(Gauge("snapshotter_thread_counts", "Thread counts of snapshotter."))

# -- per-image FS metrics pulled from the daemon API (data/fs.go) -------------

_IMG = ("image_ref",)
FsTotalRead = reg.register(Gauge(
    "nydusd_read_data_kilobytes", "Total data read from the backend.", _IMG))
FsReadCount = reg.register(Gauge(
    "nydusd_read_count", "Total read operations.", _IMG))
FsOpenFdCount = reg.register(Gauge(
    "nydusd_open_fd_count", "Open fd count of a rafs instance.", _IMG))
FsOpenFdMaxCount = reg.register(Gauge(
    "nydusd_open_fd_max_count", "Max open fd count of a rafs instance.", _IMG))
FsReadErrors = reg.register(Gauge(
    "nydusd_read_errors", "Failed read operations.", _IMG))
FsReadLatencyHits = reg.register(Gauge(
    "nydusd_read_latency_microseconds_hits",
    "Read-latency distribution pulled from nydusd.",
    ("image_ref", "le"),
))

# -- cache metrics ------------------------------------------------------------

CacheDataSize = reg.register(Gauge(
    "nydusd_cache_data_size_kilobytes", "Blob-cache data size reported by the daemon."))

# -- daemon lifecycle metrics (data/daemon.go) --------------------------------

DaemonEvent = reg.register(TTLGauge(
    "nydusd_lifetime_event_counts", "Daemon lifetime events.", ("daemon_id", "event"),
    ttl_sec=300.0,
))
DaemonCount = reg.register(Gauge(
    "nydusd_counts", "Number of nydusd daemons managed by the snapshotter."))
DaemonRSS = reg.register(TTLGauge(
    "nydusd_memory_rss_kilobytes", "RSS memory usage of a daemon.", ("daemon_id",),
    ttl_sec=300.0,
))

# -- snapshot control plane (concurrent metastore + overlapped prepare) -------

SnapshotOpHists = reg.register(Histogram(
    "ntpu_snapshot_op_duration_milliseconds",
    "Latency of snapshot control-plane operations (mounts/prepare/remove/cleanup).",
    ("op",),
))
SnapshotWriteLockWait = reg.register(Histogram(
    "ntpu_snapshot_write_lock_wait_milliseconds",
    "Wait for the metastore's serialized writer lock.",
))
SnapshotReadPoolWait = reg.register(Histogram(
    "ntpu_snapshot_read_pool_wait_milliseconds",
    "Wait to acquire a metastore read-pool connection.",
))
SnapshotAncestorCacheHits = reg.register(Counter(
    "ntpu_snapshot_ancestor_cache_hits_total",
    "Ancestor-chain lookups served from the bounded LRU."))
SnapshotAncestorCacheMisses = reg.register(Counter(
    "ntpu_snapshot_ancestor_cache_misses_total",
    "Ancestor-chain lookups that walked the parent rows."))
SnapshotPendingPrepares = reg.register(Gauge(
    "ntpu_snapshot_pending_prepares",
    "Background prepare jobs not yet joined at mounts()."))
SnapshotPendingUsageScans = reg.register(Gauge(
    "ntpu_snapshot_pending_usage_scans",
    "Disk-usage scans queued or running in the async accountant."))

# -- collection plane health --------------------------------------------------

MetricsCollectionErrors = reg.register(Counter(
    "ntpu_metrics_collection_errors_total",
    "Collector rounds that raised (per collector); a broken collector is "
    "visible here instead of only in the log.",
    ("collector",),
))
CollectorSeconds = reg.register(Histogram(
    "ntpu_metrics_collector_seconds",
    "Wall time of one collector round, per collector — a collector "
    "sliding toward the federation deadline is visible here before it "
    "wedges a scrape round.",
    ("collector",),
    buckets=(0.001, 0.005, 0.01, 0.05, 0.1, 0.5, 1.0, 5.0, 15.0),
))

# -- request tracing ----------------------------------------------------------
# (ntpu_trace_* counters are registered by trace/ and trace/ring.py; listed
# in docs/observability.md.)

# -- inflight / hung IO (collector wiring serve.go:26, :160-189) --------------

HungIOCount = reg.register(Gauge(
    "nydusd_hung_io_counts", "Inflight IO requests older than the hung threshold.",
    ("daemon_id",),
))
InflightIOCount = reg.register(Gauge(
    "nydusd_inflight_io_counts", "Current inflight IO requests.", ("daemon_id",),
))
