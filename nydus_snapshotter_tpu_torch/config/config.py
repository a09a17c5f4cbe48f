"""Snapshotter configuration system.

Reference behavior (config/config.go:223-399, internal/constant/values.go):
a versioned TOML file with per-subsystem sections, deep-merged over defaults,
overridden by CLI parameters, validated (including the unix(7) sun_path
limit on the root path), then frozen behind package-global accessors.

Implemented as nested dataclasses + dict deep-merge: ``load_config`` is the
one entry point (defaults ← TOML ← overrides → validate).
"""

from __future__ import annotations

import dataclasses
import os
from dataclasses import dataclass, field
from typing import Any, Optional

from nydus_snapshotter_tpu_torch import constants
from nydus_snapshotter_tpu_torch.utils.tomlcompat import tomllib


class ConfigError(ValueError):
    pass


@dataclass
class SystemConfig:
    enable: bool = True
    address: str = constants.DEFAULT_SYSTEM_CONTROLLER_ADDRESS
    # pprof-equivalent debug profiler endpoint (reference DebugConfig)
    debug_profile_duration_secs: int = 5
    debug_pprof_address: str = ""


@dataclass
class MetricsConfig:
    address: str = constants.DEFAULT_METRICS_ADDRESS


@dataclass
class DaemonConfig:
    nydusd_path: str = ""
    nydusd_config_path: str = "/etc/nydus/nydusd-config.json"
    recover_policy: str = constants.RECOVER_POLICY_RESTART
    # Restart budget / circuit breaker for the restart+failover policies:
    # at most recover_max_restarts respawns per recover_window_secs, with
    # exponential backoff between them; past the budget the daemon is
    # degraded to passthrough instead of hot-looping.
    recover_max_restarts: int = 3
    recover_window_secs: float = 60.0
    recover_backoff_secs: float = 0.5
    recover_backoff_max_secs: float = 8.0
    fs_driver: str = constants.DEFAULT_FS_DRIVER
    threads_number: int = 4
    log_rotation_size: int = 100  # MiB
    # TPU sidecar (conversion data plane) settings
    accel_enable: bool = True
    accel_chunk_size: int = constants.CHUNK_SIZE_DEFAULT
    accel_backend: str = "hybrid"  # calibrated crossover, like PackOption


@dataclass
class CgroupConfig:
    enable: bool = False
    memory_limit: str = ""


@dataclass
class LoggingConfig:
    log_level: str = constants.DEFAULT_LOG_LEVEL
    log_dir: str = ""
    log_to_stdout: bool = True
    rotate_log_max_size: int = 200  # MiB
    rotate_log_max_backups: int = 5
    rotate_log_max_age: int = 0
    rotate_log_compress: bool = True


@dataclass
class MirrorConfig:
    host: str = ""
    headers: dict[str, str] = field(default_factory=dict)
    health_check_interval: int = 5
    failure_limit: int = 5
    ping_url: str = ""


@dataclass
class RemoteConfig:
    convert_vpc_registry: bool = False
    skip_ssl_verify: bool = False
    mirrors_config_dir: str = ""
    auth_config_path: str = ""


@dataclass
class SnapshotConfig:
    enable_nydus_overlayfs: bool = False
    nydus_overlayfs_path: str = "nydus-overlayfs"
    sync_remove: bool = False


@dataclass
class CacheManagerConfig:
    enable: bool = True
    gc_period: str = constants.DEFAULT_GC_PERIOD
    cache_dir: str = ""


@dataclass
class ImageConfig:
    public_key_file: str = ""
    validate_signature: bool = False
    check_pause_image: bool = False


@dataclass
class ConvertConfig:
    """Stage-parallel conversion pipeline knobs (parallel/pipeline.py).

    The pipeline overlaps chunk/digest, speculative compression and
    ordered blob assembly inside one layer, and bounds memory in BYTES:
    per-queue (``queue_mib``), actively-chunked window (``window_mib``)
    and compressed-bytes-in-flight aggregate (``memory_budget_mib``,
    shared across every concurrently converting layer). Worker counts of
    0 mean auto (the pack-path worker request, clamped to cores).
    Environment variables override per-process (``NTPU_PIPELINE``,
    ``NTPU_CHUNK_THREADS``, ``NTPU_COMPRESS_THREADS``,
    ``NTPU_PIPELINE_{QUEUE,BUDGET,WINDOW}_MIB``).
    """

    pipeline: str = "auto"  # auto | on | off
    chunk_workers: int = 0
    compress_workers: int = 0
    queue_mib: int = 32
    memory_budget_mib: int = 256
    window_mib: int = 64
    # Concurrently packing layers in batch conversion (0 = pool default).
    layer_fanout: int = 0


@dataclass
class CompressionConfig:
    """Adaptive per-chunk codec knobs (converter/codec.py).

    With ``adaptive`` on (and the pack compressor ``zstd``), every chunk
    gets a cheap compressibility probe — a sampled level-1
    trial-compress (``probe = "sample"``) or a byte-entropy estimate
    (``"entropy"``) — and is then stored raw (predicted ratio ≥
    ``bypass_ratio``: the incompressibility bypass), compressed at
    ``level_fast`` (≥ ``low_gain_ratio``), at ``level_best`` (≤
    ``high_gain_ratio``) or at ``level_default`` (0 = the fixed
    reference level). ``dict_path`` loads an epoch-stamped corpus-trained
    zstd dictionary; ``train`` trains one per namespace from chunk
    samples during batch convert (``train_dict_kib`` target size,
    ``train_sample_mib`` sample budget) and shares it through the dict
    service. OFF by default: pack output stays byte-identical to the
    reference lane. Enabling trained dictionaries is a chunk-frame
    format change — frames carry a versioned ``nZD1`` header and readers
    without the dictionary fail loudly.

    Two throughput knobs ride in this section because both are resolved
    with the codec config and both hold byte-identity: ``batch_chunks``
    sets how many queued chunks a pipeline compress worker drains into
    ONE GIL-released native batch-encode call (0/1 = per-chunk), and
    ``vectorized`` picks the CDC scan arm — ``auto`` uses the SIMD
    lane-parallel table scanner when built, ``on`` requires it, ``off``
    forces the sequential scanner; cut positions are identical across
    arms. Environment variables override per-process
    (``NTPU_COMPRESS_ADAPTIVE``, ``NTPU_COMPRESS_PROBE``,
    ``NTPU_COMPRESS_PROBE_SAMPLE_KIB``, ``NTPU_COMPRESS_BYPASS_RATIO``,
    ``NTPU_COMPRESS_DICT``, ``NTPU_COMPRESS_TRAIN``,
    ``NTPU_COMPRESS_LEVELS`` — "fast,default,best" triple,
    ``NTPU_COMPRESS_BATCH_CHUNKS``, ``NTPU_COMPRESS_VECTORIZED``) — that
    is also how the section reaches spawned converter processes.
    """

    adaptive: bool = False
    probe: str = "sample"  # sample | entropy | off
    probe_sample_kib: int = 16
    bypass_ratio: float = 0.97
    low_gain_ratio: float = 0.85
    high_gain_ratio: float = 0.35
    level_fast: int = 1
    level_default: int = 0  # 0 = constants.ZSTD_LEVEL
    level_best: int = 3  # ratio-neutral default; raise to trade speed → ratio
    dict_path: str = ""
    train: bool = False
    train_dict_kib: int = 112
    train_sample_mib: int = 8
    batch_chunks: int = 16  # compress-worker batch size (0/1 = per-chunk)
    vectorized: str = "auto"  # auto | on | off — CDC scan arm


@dataclass
class BlobcacheConfig:
    """Lazy-read data plane knobs (daemon/fetch_sched.py).

    Cache misses are scheduled on a per-blob fetch worker pool: adjacent
    miss gaps within ``merge_gap_kib`` coalesce into one ranged GET,
    sequential readers get ``readahead_kib`` of background warming, and
    all fetches draw from one ``inflight_budget_mib`` byte budget shared
    across every lazily-read blob. ``eviction_watermark_mib`` bounds
    total blob-cache capacity (0 disables; LRU whole-entry eviction in
    cache/manager.py). Environment variables override per-process
    (``NTPU_BLOBCACHE_WORKERS``, ``NTPU_BLOBCACHE_MERGE_GAP_KIB``,
    ``NTPU_BLOBCACHE_READAHEAD_KIB``, ``NTPU_BLOBCACHE_BUDGET_MIB``,
    ``NTPU_BLOBCACHE_WATERMARK_MIB``, ``NTPU_BLOBCACHE_PREFETCH``) —
    that is also how the section reaches spawned daemon processes.
    """

    fetch_workers: int = 4
    merge_gap_kib: int = 128
    readahead_kib: int = 1024
    inflight_budget_mib: int = 64
    eviction_watermark_mib: int = 0
    prefetch_replay: bool = True


@dataclass
class PeerConfig:
    """Peer chunk tier + QoS admission knobs (daemon/peer.py,
    daemon/fetch_sched.AdmissionGate).

    With ``enable`` on, the node serves ranged reads for locally cached
    chunk extents on ``listen`` (a UDS path or ``host:port``) and routes
    its own misses through the static ``peers`` list before the registry
    (registry -> peer -> local-cache waterfall): region ownership is
    rendezvous-hashed per ``region_kib`` region, the owner pull-throughs
    cold extents (``pull_through``) so a chunk leaves the origin at most
    ~once per cluster, and every peer read is bounded by ``timeout_ms``
    with transparent registry fallback. ``max_concurrent`` (0 = default
    64) bounds operations admitted through the node's QoS gate, of which
    ``demand_reserve`` slots only demand reads may use;
    ``tenant_weights`` sets weighted in-flight byte fairness between
    tenants (unlisted tenants weigh 1.0). Environment variables override
    per-process (``NTPU_PEER_ENABLE``, ``NTPU_PEER_LISTEN``,
    ``NTPU_PEER_PEERS``, ``NTPU_PEER_REGION_KIB``,
    ``NTPU_PEER_TIMEOUT_MS``, ``NTPU_PEER_PULL_THROUGH``,
    ``NTPU_PEER_MAX_CONCURRENT``, ``NTPU_PEER_DEMAND_RESERVE``,
    ``NTPU_PEER_TENANT_WEIGHTS``, ``NTPU_PEER_LOCALITY``,
    ``NTPU_PEER_HEDGE``, ``NTPU_PEER_HEDGE_WINDOW``,
    ``NTPU_PEER_TIER_BUDGETS``) — that is also how the section reaches
    spawned daemon processes.
    """

    enable: bool = False
    listen: str = ""
    peers: list[str] = field(default_factory=list)
    region_kib: int = 512
    timeout_ms: int = 1500
    pull_through: bool = True
    max_concurrent: int = 0
    demand_reserve: int = 1
    tenant_weights: dict[str, float] = field(default_factory=dict)
    # Dynamic membership (daemon/peer.PeerMembership): "fleet" discovers
    # the live peer set from the member registry (the static ``peers``
    # list stays as the seed/fallback), "static" pins the pre-dynamic
    # behavior, "auto" (default) goes dynamic exactly when a fleet
    # controller address is known to this process. Env overrides:
    # ``NTPU_PEER_MEMBERSHIP``, ``NTPU_PEER_MEMBERSHIP_REFRESH_MS``.
    membership: str = "auto"
    membership_refresh_secs: float = 2.0
    # Hierarchical topology (daemon/peer.PeerRouter): ``locality`` is a
    # ``rack:zone:region`` label (empty = flat single-tier routing);
    # lookups walk rack owner -> zone shield -> origin. ``hedge`` arms
    # the demand-lane hedged second request once a flight exceeds the
    # rolling per-tier p99 over the last ``hedge_window`` samples
    # (0 = default 64, minimum 8). ``tier_budgets`` caps in-flight bytes
    # per tier ({"zone": 32} = 32 MiB) so a melting zone cannot starve
    # rack-local service.
    locality: str = ""
    hedge: bool = True
    hedge_window: int = 0
    tier_budgets: dict[str, int] = field(default_factory=dict)


@dataclass
class SociConfig:
    """Seekable-OCI backend knobs (soci/).

    With ``enable`` on, plain OCI ``.tar.gz`` layers that carry no nydus,
    estargz or tarfs cooperation are claimed at Prepare and lazily served
    WITHOUT conversion: the first pull builds a persisted, checksummed
    zran checkpoint index (gzip inflate resume points every
    ``stride_kib`` of decompressed output + a per-layer
    file→decompressed-extent map) into the cache dir next to the blob's
    chunk map, and runtime reads resolve to compressed byte ranges of
    the original layer, fetched through the ordinary lazy-read data
    plane (fetch scheduler, eviction, peer tier, QoS lanes). A smaller
    stride means less read amplification but a bigger index (~32 KiB of
    window per checkpoint, compressed). With ``replicate`` on, a pod
    missing an index asks the blob's peer-tier region owner before
    rebuilding, so one pod's first-pull build amortizes across the
    fleet. Environment variables override per-process
    (``NTPU_SOCI_ENABLE``, ``NTPU_SOCI_STRIDE_KIB``,
    ``NTPU_SOCI_REPLICATE``) — that is also how the section reaches
    spawned daemon processes.
    """

    enable: bool = False
    stride_kib: int = 1024
    replicate: bool = True
    # zstd half of the lazy plane: frame-index zstd layers (seekable
    # seek-table parse, or a frame walk during the one first-pull pass)
    # instead of full pull + RAFS convert. NTPU_SOCI_ZSTD overrides.
    zstd: bool = True
    # Adopt a shipped TOC (eStargz / zstd:chunked) as the file→extent
    # map — zero build-pass bytes on those layers. NTPU_SOCI_TOC_ADOPT
    # overrides.
    toc_adopt: bool = True


@dataclass
class SnapshotsConfig:
    """Concurrent snapshot control-plane knobs
    (snapshot/{metastore,snapshotter,async_work}.py).

    The metastore serves reads from a pool of per-connection WAL readers
    (``read_pool``) while all mutations funnel through one serialized
    writer; ancestor chains are memoized in a bounded LRU
    (``ancestor_cache`` entries, 0 disables). Prepare's slow tail (daemon
    readiness, stargz bootstrap build) overlaps on a ``prepare_fanout``
    pool joined at ``mounts()``; commit's disk-usage scan moves to
    ``usage_workers`` async accountants joined at ``usage()``; Cleanup
    removes orphan dirs on ``cleanup_workers`` threads. A worker count of
    0 (prepare/usage) restores the fully serial control plane.
    Environment variables override per-process (``NTPU_SNAPSHOT_READ_POOL``,
    ``NTPU_SNAPSHOT_PREPARE_FANOUT``, ``NTPU_SNAPSHOT_USAGE_WORKERS``,
    ``NTPU_SNAPSHOT_CLEANUP_WORKERS``, ``NTPU_SNAPSHOT_ANCESTOR_CACHE``).
    """

    read_pool: int = 8
    prepare_fanout: int = 4
    usage_workers: int = 1
    cleanup_workers: int = 4
    ancestor_cache: int = 1024


@dataclass
class TraceConfig:
    """End-to-end request tracing knobs (trace/).

    Spans propagate a trace id from the gRPC entry points through the
    metastore, the prepare board, the daemon mount path and the lazy-read
    fetch scheduler, land in a bounded ring of ``ring_capacity`` spans
    (drop-oldest), and export as Chrome ``trace_event`` JSON on
    ``/api/v1/traces``. Any root operation slower than
    ``slow_op_threshold_ms`` gets its full span tree logged by the
    slow-op flight recorder. ``sample_ratio`` < 1 traces that fraction of
    roots (the decision is made once per trace). Environment variables
    override per-process (``NTPU_TRACE``, ``NTPU_TRACE_RING_CAPACITY``,
    ``NTPU_TRACE_SLOW_OP_MS``, ``NTPU_TRACE_SAMPLE_RATIO``) — that is
    also how the section reaches spawned daemon processes.
    """

    enabled: bool = True
    ring_capacity: int = 8192
    slow_op_threshold_ms: float = 1000.0
    sample_ratio: float = 1.0


@dataclass
class ChunkDictConfig:
    """Growable cross-repo chunk dictionary knobs
    (parallel/{sharded_dict,dict_service}.py).

    The dict builds its open-addressing tables with ``headroom``× spare
    capacity and grows in place: incremental inserts open-address into the
    spare slots (cost proportional to the inserted batch) until occupancy
    crosses ``load_factor``, at which point the table does one
    value-preserving rebuild with fresh headroom. ``service`` names the
    UDS address of a shared :class:`DictService` so converter workers
    dedup against one registry-wide table per ``namespace`` instead of
    per-process copies ("" = in-process dict, no service).
    ``service_backend`` picks the service's probe arm (``auto`` = native
    host probe on one shard, the mesh-routed ``device`` probe on a multi-
    chip mesh).

    HA replication (``ha/``, docs/chunk_dict_service.md HA section):
    ``shards`` is the placement controller's key-space shard count and
    ``replicas`` how many warm replicas each shard's primary gets
    (0 = HA off). ``replication_budget_kib`` bounds the bytes a replica
    holds in flight per record-tail pull (the bounded-memory catch-up
    contract) and ``replication_poll_ms`` the journal-tail poll cadence.

    Environment variables override per-process
    (``NTPU_DICT_LOAD_FACTOR``, ``NTPU_DICT_HEADROOM``,
    ``NTPU_DICT_SERVICE``, ``NTPU_DICT_NAMESPACE``,
    ``NTPU_DICT_HA_SHARDS``, ``NTPU_DICT_HA_REPLICAS``,
    ``NTPU_DICT_HA_BUDGET_KIB``, ``NTPU_DICT_HA_POLL_MS``) — that is
    also how the section reaches spawned converter/dict processes.
    """

    load_factor: float = 0.85
    headroom: float = 2.0
    service: str = ""
    namespace: str = "default"
    service_backend: str = "auto"
    shards: int = 1
    replicas: int = 0
    replication_budget_kib: int = 256
    replication_poll_ms: float = 50.0


@dataclass
class ProvenanceConfig:
    """Byte-provenance plane knobs (provenance/).

    With ``enable`` on, every fetched extent entering the lazy-read data
    plane is attributed to its cause (demand, readahead, prefetch,
    peer_serve, hedge_winner, hedge_loser, soci_index_build) in a
    lock-striped per-blob ledger with byte-exact conservation; overlap
    with the actually-read extent set yields per-cause wasted-bytes and
    prefetch-accuracy accounting (``ntpu_prov_*`` metrics, the
    ``/api/v1/provenance`` endpoint and the ``ntpuctl prov`` /
    ``ntpuctl waterfall`` views). With ``heat`` on, unmount distills the
    read-extent heat into a persisted, checksummed ``.heat`` prefetch
    artifact next to the blob cache, so the NEXT deploy prefetches in
    observed-heat order under a ``heat_budget_mib`` byte budget instead
    of bootstrap order; ``replicate`` shares the artifact over the peer
    artifact plane so one pod's first deploy warms the fleet's second.
    ``events`` bounds the per-blob waterfall event ring (drop-oldest).
    Environment variables override per-process (``NTPU_PROV``,
    ``NTPU_PROV_HEAT``, ``NTPU_PROV_HEAT_BUDGET_MIB``,
    ``NTPU_PROV_EVENTS``, ``NTPU_PROV_REPLICATE``) — that is also how
    the section reaches spawned daemon processes.
    """

    enable: bool = True
    heat: bool = True
    heat_budget_mib: int = 64
    events: int = 4096
    replicate: bool = True


@dataclass
class FleetConfig:
    """Fleet observability plane knobs (fleet/, metrics/federation.py,
    trace/aggregate.py).

    With ``enable`` on, the system controller keeps a member registry
    (spawned daemons, standalone dict services and peer servers
    self-register over the controller UDS), scrapes every member's
    metrics endpoint every ``scrape_interval_secs`` and serves the
    federated exposition (``node``/``component`` labels), the derived
    health scoreboard and the cluster-merged Chrome trace on
    ``/api/v1/fleet/...``. A member whose last successful scrape is
    older than ``stale_after_secs`` is flagged stale (the scoreboard
    degrades; the scrape never wedges). The scoreboard's local-process
    rows come from one cached ``collect_once`` snapshot at most
    ``scoreboard_max_age_secs`` old, so a slow collector cannot stall
    concurrent scrapes. ``controller`` is the member-side knob: the
    controller UDS a non-snapshotter process registers itself with
    ("" = don't register). Environment variables override per-process
    (``NTPU_FLEET``, ``NTPU_FLEET_CONTROLLER``, ``NTPU_FLEET_MEMBER``,
    ``NTPU_FLEET_SCRAPE_INTERVAL_SECS``, ``NTPU_FLEET_STALE_AFTER_SECS``,
    ``NTPU_FLEET_SCOREBOARD_MAX_AGE_SECS``) — the env is also how the
    controller address reaches spawned daemon processes.
    """

    enable: bool = False
    scrape_interval_secs: float = 15.0
    stale_after_secs: float = 45.0
    scoreboard_max_age_secs: float = 5.0
    controller: str = ""


@dataclass
class SloConfig:
    """Declarative service-level objectives (metrics/slo.py).

    Each ``[[slo.objectives]]`` table names an op-duration histogram
    (``metric`` + optional ``labels`` filter), a latency ``threshold_ms``
    that must align to a bucket boundary, and a ``target`` compliance
    fraction evaluated over a sliding ``window_secs`` window (plus a
    ``long_window_factor``× long window). The engine ticks every
    ``eval_interval_secs``, exports ``ntpu_slo_*`` series, accounts the
    error budget, and raises a breach event — with the slow-op flight
    recorder dump attached — when the burn rate exceeds
    ``burn_threshold`` on BOTH windows. Environment variables override
    per-process (``NTPU_SLO``, ``NTPU_SLO_EVAL_INTERVAL_SECS``,
    ``NTPU_SLO_OBJECTIVES`` — a JSON list of objective tables).
    """

    enable: bool = False
    eval_interval_secs: float = 10.0
    objectives: list[dict] = field(default_factory=list)
    # Close the loop (metrics/slo.SloActuator): with ``actuate`` on, a
    # multi-window breach sheds one more lane from ``shed_lanes`` per
    # evaluation tick (least-important first; the demand lane is not
    # sheddable) on the controller's admission gate, and member processes
    # following the published state (``follow``, applied by spawned
    # daemons) shed the same lanes on theirs. Lanes restore one per tick
    # once every objective's short-window burn drops under
    # ``restore_burn``. Env overrides: ``NTPU_SLO_ACTUATE``,
    # ``NTPU_SLO_SHED_LANES``, ``NTPU_SLO_RESTORE_BURN``,
    # ``NTPU_SLO_FOLLOW``.
    actuate: bool = False
    shed_lanes: list[str] = field(default_factory=list)
    restore_burn: float = 1.0
    follow: bool = True


@dataclass
class ScenarioConfig:
    """Scenario engine knobs (scenario/, tools/scenario_storm.py).

    ``spec_dir`` is the catalog of ``*.toml`` scenario specs
    (``ntpuctl scenario`` lists it; "" = the repo's ``misc/scenarios``).
    ``report_path`` is where the gated storm banks its last-run report
    JSON ("" = the repo's ``SCENARIO_STORM_r01.json``); ``seed`` and
    ``pods`` are the defaults a spec inherits when it doesn't pin its
    own. Environment variables override per-process
    (``NTPU_SCENARIO_SPEC_DIR``, ``NTPU_SCENARIO_REPORT``,
    ``NTPU_SCENARIO_SEED``, ``NTPU_SCENARIO_PODS``).
    """

    spec_dir: str = ""
    report_path: str = ""
    seed: int = 7
    pods: int = 16


@dataclass
class SoakConfig:
    """Endurance-soak runner knobs (scenario/soak.py, tools/soak_profile.py).

    ``epochs`` overrides the spec's ``[scenario.soak]`` epoch count
    (0 = use the spec's); ``spot_epochs`` is how many epochs the gated
    profile replays serially for the identity spot-check;
    ``report_path`` is where the profile banks its report JSON ("" =
    the repo's ``SOAK_r01.json``). Environment variables override
    per-process (``NTPU_SOAK_EPOCHS``, ``NTPU_SOAK_SPOT_EPOCHS``,
    ``NTPU_SOAK_REPORT``). The arrival/evolution/scale-up shape itself
    lives in the spec's ``[scenario.soak]`` table, not here — a soak
    must be reproducible from the spec alone.
    """

    epochs: int = 0
    spot_epochs: int = 2
    report_path: str = ""


@dataclass
class MeshConfig:
    """Device-mesh convert sharding knobs (ops/mesh_pack.py,
    __graft_entry__.sharded_convert_step).

    ``pack`` picks the pass-2 corpus operand layout: ``extent`` (default)
    gives each device only its contiguous byte shard plus the read-span
    halo (no operand is device-count-replicated; per-device addressable
    bytes stay ≤ corpus/devices + halo), ``replicated`` keeps the legacy
    whole-corpus broadcast (the differential / paired-measurement arm).
    ``devices`` caps how many local devices a default-constructed mesh
    uses (0 = all). ``halo_kib`` widens the shard halo beyond the
    engine's computed maximum read span (0 = auto) — the planner never
    shrinks it below the no-clamp minimum. Environment variables override
    per-process (``NTPU_MESH_PACK``, ``NTPU_MESH_DEVICES``,
    ``NTPU_MESH_HALO_KIB``).
    """

    pack: str = "extent"
    devices: int = 0
    halo_kib: int = 0


@dataclass
class ExperimentalConfig:
    enable_stargz: bool = False
    enable_referrer_detect: bool = False
    tarfs_enable: bool = False
    tarfs_mount_on_host: bool = False
    tarfs_export_mode: str = ""
    tarfs_max_concurrent_proc: int = 4


@dataclass
class SnapshotterConfig:
    """Top-level config: the 11 sections of the reference TOML."""

    version: int = 1
    root: str = constants.DEFAULT_ROOT_DIR
    address: str = constants.DEFAULT_ADDRESS
    daemon_mode: str = constants.DEFAULT_DAEMON_MODE
    cleanup_on_close: bool = False

    system: SystemConfig = field(default_factory=SystemConfig)
    metrics: MetricsConfig = field(default_factory=MetricsConfig)
    daemon: DaemonConfig = field(default_factory=DaemonConfig)
    cgroup: CgroupConfig = field(default_factory=CgroupConfig)
    log: LoggingConfig = field(default_factory=LoggingConfig)
    remote: RemoteConfig = field(default_factory=RemoteConfig)
    snapshot: SnapshotConfig = field(default_factory=SnapshotConfig)
    cache_manager: CacheManagerConfig = field(default_factory=CacheManagerConfig)
    image: ImageConfig = field(default_factory=ImageConfig)
    convert: ConvertConfig = field(default_factory=ConvertConfig)
    compression: CompressionConfig = field(default_factory=CompressionConfig)
    blobcache: BlobcacheConfig = field(default_factory=BlobcacheConfig)
    peer: PeerConfig = field(default_factory=PeerConfig)
    soci: SociConfig = field(default_factory=SociConfig)
    snapshots: SnapshotsConfig = field(default_factory=SnapshotsConfig)
    trace: TraceConfig = field(default_factory=TraceConfig)
    provenance: ProvenanceConfig = field(default_factory=ProvenanceConfig)
    chunk_dict: ChunkDictConfig = field(default_factory=ChunkDictConfig)
    fleet: FleetConfig = field(default_factory=FleetConfig)
    slo: SloConfig = field(default_factory=SloConfig)
    mesh: MeshConfig = field(default_factory=MeshConfig)
    scenario: ScenarioConfig = field(default_factory=ScenarioConfig)
    soak: SoakConfig = field(default_factory=SoakConfig)
    experimental: ExperimentalConfig = field(default_factory=ExperimentalConfig)

    # -- derived paths (reference config/global.go accessors) ---------------

    @property
    def socket_root(self) -> str:
        return os.path.join(self.root, "socket")

    @property
    def config_root(self) -> str:
        return os.path.join(self.root, "config")

    @property
    def cache_root(self) -> str:
        return self.cache_manager.cache_dir or os.path.join(self.root, "cache")

    @property
    def snapshots_root(self) -> str:
        return os.path.join(self.root, "snapshots")

    @property
    def database_path(self) -> str:
        return os.path.join(self.root, "nydus.db")

    def validate(self) -> None:
        if self.version != 1:
            raise ConfigError(f"unsupported config version {self.version} (expect 1)")
        # unix(7) sun_path is 108 bytes; the reference enforces root < 70 so
        # per-daemon socket paths still fit (config.go:50-59).
        if len(self.root) > constants.MAX_ROOT_PATH_LEN:
            raise ConfigError(
                f"root path {self.root!r} is longer than {constants.MAX_ROOT_PATH_LEN} bytes"
            )
        if not os.path.isabs(self.root):
            raise ConfigError("root path must be absolute")
        if self.daemon_mode not in (
            constants.DAEMON_MODE_SHARED,
            constants.DAEMON_MODE_DEDICATED,
            constants.DAEMON_MODE_NONE,
        ):
            raise ConfigError(f"invalid daemon mode {self.daemon_mode!r}")
        if self.daemon.fs_driver not in constants.FS_DRIVERS:
            raise ConfigError(f"invalid fs driver {self.daemon.fs_driver!r}")
        if self.daemon.recover_policy not in (
            constants.RECOVER_POLICY_NONE,
            constants.RECOVER_POLICY_RESTART,
            constants.RECOVER_POLICY_FAILOVER,
        ):
            raise ConfigError(f"invalid recover policy {self.daemon.recover_policy!r}")
        if self.daemon.accel_backend not in ("hybrid", "jax", "numpy"):
            raise ConfigError(f"invalid accel backend {self.daemon.accel_backend!r}")
        if self.daemon.recover_max_restarts < 1:
            raise ConfigError("daemon.recover_max_restarts must be >= 1")
        if self.daemon.recover_window_secs <= 0 or self.daemon.recover_backoff_secs < 0:
            raise ConfigError("daemon recover window/backoff must be positive")
        if self.convert.pipeline not in ("auto", "on", "off"):
            raise ConfigError(
                f"invalid convert.pipeline {self.convert.pipeline!r} "
                "(auto | on | off)"
            )
        if self.convert.chunk_workers < 0 or self.convert.compress_workers < 0:
            raise ConfigError("convert worker counts must be >= 0 (0 = auto)")
        if self.convert.layer_fanout < 0:
            raise ConfigError("convert.layer_fanout must be >= 0 (0 = auto)")
        if (
            self.convert.queue_mib <= 0
            or self.convert.memory_budget_mib <= 0
            or self.convert.window_mib <= 0
        ):
            raise ConfigError("convert queue/budget/window MiB must be positive")
        if self.compression.probe not in ("sample", "entropy", "off"):
            raise ConfigError(
                f"invalid compression.probe {self.compression.probe!r} "
                "(sample | entropy | off)"
            )
        if self.compression.probe_sample_kib < 1:
            raise ConfigError("compression.probe_sample_kib must be >= 1")
        if not (
            0.0
            < self.compression.high_gain_ratio
            < self.compression.low_gain_ratio
            < self.compression.bypass_ratio
            <= 1.0
        ):
            raise ConfigError(
                "compression ratios must satisfy 0 < high_gain_ratio < "
                "low_gain_ratio < bypass_ratio <= 1"
            )
        if not (
            1 <= self.compression.level_fast <= 19
            and 0 <= self.compression.level_default <= 19
            and 1 <= self.compression.level_best <= 19
        ):
            raise ConfigError(
                "compression levels must be in [1, 19] (level_default: 0 = "
                "the fixed reference level)"
            )
        if self.compression.train_dict_kib < 1 or self.compression.train_sample_mib < 1:
            raise ConfigError(
                "compression.train_dict_kib/train_sample_mib must be >= 1"
            )
        if self.compression.batch_chunks < 0:
            raise ConfigError(
                "compression.batch_chunks must be >= 0 (0/1 = per-chunk)"
            )
        if self.compression.vectorized not in ("auto", "on", "off"):
            raise ConfigError(
                f"invalid compression.vectorized "
                f"{self.compression.vectorized!r} (auto | on | off)"
            )
        if self.blobcache.fetch_workers < 1:
            raise ConfigError("blobcache.fetch_workers must be >= 1")
        if self.blobcache.merge_gap_kib < 0 or self.blobcache.readahead_kib < 0:
            raise ConfigError("blobcache merge_gap/readahead KiB must be >= 0")
        if self.blobcache.inflight_budget_mib <= 0:
            raise ConfigError("blobcache.inflight_budget_mib must be positive")
        if self.blobcache.eviction_watermark_mib < 0:
            raise ConfigError(
                "blobcache.eviction_watermark_mib must be >= 0 (0 = unbounded)"
            )
        if self.peer.enable and not self.peer.listen and not self.peer.peers:
            raise ConfigError(
                "peer.enable needs a listen address and/or a peers list"
            )
        if self.peer.region_kib <= 0:
            raise ConfigError("peer.region_kib must be positive")
        if self.peer.timeout_ms <= 0:
            raise ConfigError("peer.timeout_ms must be positive")
        if self.peer.max_concurrent < 0 or self.peer.demand_reserve < 0:
            raise ConfigError(
                "peer.max_concurrent/demand_reserve must be >= 0"
            )
        if any(w <= 0 for w in self.peer.tenant_weights.values()):
            raise ConfigError("peer.tenant_weights must all be positive")
        if self.peer.membership not in ("auto", "static", "fleet"):
            raise ConfigError(
                f"invalid peer.membership {self.peer.membership!r} "
                "(auto | static | fleet)"
            )
        if self.peer.membership_refresh_secs <= 0:
            raise ConfigError("peer.membership_refresh_secs must be positive")
        if self.peer.locality:
            parts = [p.strip() for p in self.peer.locality.split(":")]
            if len(parts) != 3 or not all(parts):
                raise ConfigError(
                    f"invalid peer.locality {self.peer.locality!r} "
                    "(expected rack:zone:region)"
                )
        if self.peer.hedge_window < 0:
            raise ConfigError("peer.hedge_window must be >= 0 (0 = default)")
        if any(v <= 0 for v in self.peer.tier_budgets.values()):
            raise ConfigError("peer.tier_budgets MiB caps must all be positive")
        if self.soci.stride_kib < 64:
            # Checkpoints below one deflate window apart are pure index
            # bloat: the window alone is 32 KiB.
            raise ConfigError("soci.stride_kib must be >= 64")
        if self.snapshots.read_pool < 1:
            raise ConfigError("snapshots.read_pool must be >= 1")
        if self.snapshots.prepare_fanout < 0 or self.snapshots.usage_workers < 0:
            raise ConfigError(
                "snapshots prepare_fanout/usage_workers must be >= 0 (0 = serial)"
            )
        if self.snapshots.cleanup_workers < 1:
            raise ConfigError("snapshots.cleanup_workers must be >= 1")
        if self.snapshots.ancestor_cache < 0:
            raise ConfigError("snapshots.ancestor_cache must be >= 0 (0 = disabled)")
        if self.trace.ring_capacity < 1:
            raise ConfigError("trace.ring_capacity must be >= 1")
        if self.trace.slow_op_threshold_ms < 0:
            raise ConfigError("trace.slow_op_threshold_ms must be >= 0 (0 = off)")
        if not 0.0 <= self.trace.sample_ratio <= 1.0:
            raise ConfigError("trace.sample_ratio must be within [0, 1]")
        if self.provenance.heat_budget_mib < 0:
            raise ConfigError(
                "provenance.heat_budget_mib must be >= 0 (0 = no heat warm)"
            )
        if self.provenance.events < 1:
            raise ConfigError("provenance.events must be >= 1")
        if self.fleet.scrape_interval_secs <= 0:
            raise ConfigError("fleet.scrape_interval_secs must be positive")
        if self.fleet.stale_after_secs <= 0:
            raise ConfigError("fleet.stale_after_secs must be positive")
        if self.fleet.scoreboard_max_age_secs < 0:
            raise ConfigError(
                "fleet.scoreboard_max_age_secs must be >= 0 (0 = always fresh)"
            )
        if self.slo.eval_interval_secs <= 0:
            raise ConfigError("slo.eval_interval_secs must be positive")
        if not isinstance(self.slo.objectives, list) or any(
            not isinstance(o, dict) for o in self.slo.objectives
        ):
            raise ConfigError("slo.objectives must be an array of tables")
        if not isinstance(self.slo.shed_lanes, list) or any(
            not isinstance(s, str) for s in self.slo.shed_lanes
        ):
            raise ConfigError("slo.shed_lanes must be an array of lane names")
        if "demand" in self.slo.shed_lanes:
            raise ConfigError("slo.shed_lanes: the demand lane is not sheddable")
        if self.slo.restore_burn < 0:
            raise ConfigError("slo.restore_burn must be >= 0")
        if self.mesh.pack not in ("extent", "replicated"):
            raise ConfigError(
                f"invalid mesh.pack {self.mesh.pack!r} (extent | replicated)"
            )
        if self.mesh.devices < 0:
            raise ConfigError("mesh.devices must be >= 0 (0 = all local devices)")
        if self.mesh.halo_kib < 0:
            raise ConfigError("mesh.halo_kib must be >= 0 (0 = auto read span)")
        if self.scenario.pods < 1:
            raise ConfigError("scenario.pods must be >= 1")
        if self.scenario.seed < 0:
            raise ConfigError("scenario.seed must be >= 0")
        if self.soak.epochs < 0:
            raise ConfigError("soak.epochs must be >= 0 (0 = spec's value)")
        if self.soak.spot_epochs < 1:
            raise ConfigError("soak.spot_epochs must be >= 1")
        if not 0.0 < self.chunk_dict.load_factor < 1.0:
            raise ConfigError("chunk_dict.load_factor must be within (0, 1)")
        if self.chunk_dict.headroom < 1.0:
            raise ConfigError("chunk_dict.headroom must be >= 1.0")
        if self.chunk_dict.service_backend not in ("auto", "host", "device", "pallas"):
            raise ConfigError(
                f"invalid chunk_dict.service_backend {self.chunk_dict.service_backend!r}"
            )
        if self.chunk_dict.shards < 1:
            raise ConfigError("chunk_dict.shards must be >= 1")
        if self.chunk_dict.replicas < 0:
            raise ConfigError("chunk_dict.replicas must be >= 0")
        if self.chunk_dict.replication_budget_kib < 64:
            raise ConfigError("chunk_dict.replication_budget_kib must be >= 64")
        if self.chunk_dict.replication_poll_ms <= 0:
            raise ConfigError("chunk_dict.replication_poll_ms must be > 0")
        if self.daemon.fs_driver in (constants.FS_DRIVER_BLOCKDEV, constants.FS_DRIVER_PROXY):
            # Proxy/blockdev modes run without nydusd daemons
            # (reference config.go:300-311 forces daemon_mode none).
            self.daemon_mode = constants.DAEMON_MODE_NONE


def _merge_into_dataclass(obj: Any, data: dict[str, Any], path: str = "") -> None:
    fields = {f.name: f for f in dataclasses.fields(obj)}
    for key, value in data.items():
        if key not in fields:
            raise ConfigError(f"unknown config key {path + key!r}")
        cur = getattr(obj, key)
        if dataclasses.is_dataclass(cur) and isinstance(value, dict):
            _merge_into_dataclass(cur, value, path=f"{path}{key}.")
        else:
            if cur is not None and value is not None and not isinstance(value, type(cur)):
                # tolerate int-for-bool style TOML looseness only for numbers
                if not (isinstance(cur, bool) is isinstance(value, bool) and isinstance(value, (int, float, str, list, dict))):
                    raise ConfigError(
                        f"config key {path + key!r}: expected {type(cur).__name__}, "
                        f"got {type(value).__name__}"
                    )
            setattr(obj, key, value)


def load_config(
    path: Optional[str] = None,
    overrides: Optional[dict[str, Any]] = None,
) -> SnapshotterConfig:
    """defaults ← TOML file ← CLI overrides → validate."""
    cfg = SnapshotterConfig()
    if path:
        with open(path, "rb") as f:
            data = tomllib.load(f)
        _merge_into_dataclass(cfg, data)
    if overrides:
        _merge_into_dataclass(cfg, overrides)
    cfg.validate()
    return cfg


# -- frozen global accessor (reference config/global.go:24-221) -------------

_global: Optional[SnapshotterConfig] = None


def set_global_config(cfg: SnapshotterConfig) -> None:
    global _global
    _global = cfg


def get_global_config() -> SnapshotterConfig:
    if _global is None:
        raise ConfigError("global config not initialized")
    return _global


def global_section(name: str):
    """The global config's ``[name]`` section, or None when no global
    config is set (library, tool and test use): what each resolver reads
    between its env override and its default."""
    return getattr(_global, name, None)
