"""Snapshotter process entry (reference cmd/containerd-nydus-grpc).

Flow mirrors main.go:25-81 + snapshotter.go:30-94: parse flags, layer them
over the TOML config and defaults, validate, set up logging, assemble the
stack (store → managers → filesystem → snapshotter), then serve the
containerd snapshots.v1 gRPC API on a UDS until SIGTERM/SIGINT.

Run: ``python -m nydus_snapshotter_tpu_torch.cmd.snapshotter --root <dir>
--address <dir>/grpc.sock`` or ``--config <toml>``.

``--device`` is where the tarfs manager's engine runs when
``[daemon] accel_backend = "jax"`` (with ``accel_enable``): ``''`` (the
default) means the card, so every layer index a tarfs Prepare builds runs
kernel K2 once; ``cpu`` means the kernels' plain versions; ``cuda`` or
``cuda:N`` names a card. With ``jax``, no card and no ``--device cpu``,
the process fails at start; it never carries on on the CPU. The other
backends (``hybrid``, the default, and ``numpy``) digest on the host.
torch is imported only when the tarfs arm is on: the default process,
and every daemon it spawns, makes no CUDA context.
"""

from __future__ import annotations

import argparse
import logging
import os
import signal
import sys
import threading

from nydus_snapshotter_tpu_torch import constants as C
from nydus_snapshotter_tpu_torch.api import service as grpc_service
from nydus_snapshotter_tpu_torch.cache.manager import CacheManager
from nydus_snapshotter_tpu_torch.config.config import (
    SnapshotterConfig,
    load_config,
    set_global_config,
)
from nydus_snapshotter_tpu_torch.config.daemonconfig import DaemonRuntimeConfig
from nydus_snapshotter_tpu_torch.filesystem import Filesystem
from nydus_snapshotter_tpu_torch.manager.manager import Manager
from nydus_snapshotter_tpu_torch.snapshot.snapshotter import Snapshotter
from nydus_snapshotter_tpu_torch.store.database import Database

logger = logging.getLogger("nydus-snapshotter-tpu")


def build_parser() -> argparse.ArgumentParser:
    # Flag surface mirrors internal/flags/flags.go:36-107.
    p = argparse.ArgumentParser(prog="containerd-nydus-grpc-tpu")
    p.add_argument("--config", default="", help="path to TOML config")
    p.add_argument("--root", default="", help="snapshotter state root directory")
    p.add_argument("--address", default="", help="gRPC UDS path for containerd")
    p.add_argument("--daemon-mode", default="", choices=["", "shared", "dedicated", "none"])
    p.add_argument(
        "--fs-driver", default="", choices=["", *C.FS_DRIVERS], help="filesystem driver"
    )
    p.add_argument(
        "--recover-policy", default="", choices=["", "none", "restart", "failover"]
    )
    p.add_argument("--log-level", default="", help="trace|debug|info|warn|error")
    p.add_argument("--log-to-stdout", action="store_true", default=None)
    p.add_argument("--nydusd-config", default="", help="daemon config JSON template")
    p.add_argument(
        "--device",
        default="",
        help="where the tarfs engine's device arm runs: '' (the card), cpu, cuda or cuda:N",
    )
    return p


def config_from_args(args: argparse.Namespace) -> SnapshotterConfig:
    overrides: dict = {}
    if args.root:
        overrides["root"] = args.root
    if args.address:
        overrides["address"] = args.address
    if args.daemon_mode:
        overrides["daemon_mode"] = args.daemon_mode
    daemon_over: dict = {}
    if args.fs_driver:
        daemon_over["fs_driver"] = args.fs_driver
    if args.recover_policy:
        daemon_over["recover_policy"] = args.recover_policy
    if args.nydusd_config:
        daemon_over["nydusd_config_path"] = args.nydusd_config
    if daemon_over:
        overrides["daemon"] = daemon_over
    log_over: dict = {}
    if args.log_level:
        log_over["log_level"] = args.log_level
    if args.log_to_stdout is not None:
        log_over["log_to_stdout"] = args.log_to_stdout
    if log_over:
        overrides["log"] = log_over
    return load_config(args.config or None, overrides)


def setup_logging(cfg: SnapshotterConfig) -> None:
    level = getattr(logging, cfg.log.log_level.upper(), logging.INFO)
    handlers: list[logging.Handler] = []
    if cfg.log.log_to_stdout:
        handlers.append(logging.StreamHandler(sys.stdout))
    if cfg.log.log_dir:
        os.makedirs(cfg.log.log_dir, exist_ok=True)
        from logging.handlers import RotatingFileHandler

        handlers.append(
            RotatingFileHandler(
                os.path.join(cfg.log.log_dir, "nydus-snapshotter.log"),
                maxBytes=cfg.log.rotate_log_max_size * (1 << 20),
                backupCount=cfg.log.rotate_log_max_backups,
            )
        )
    logging.basicConfig(
        level=level,
        handlers=handlers or None,
        format="%(asctime)s %(levelname).1s %(name)s %(message)s",
    )


def _parse_size(value: str) -> int:
    """'512MB' / '1GiB' / '1073741824' → bytes; empty → -1 (unlimited)."""
    value = value.strip()
    if not value:
        return -1
    units = {"kb": 1000, "mb": 1000**2, "gb": 1000**3,
             "kib": 1024, "mib": 1024**2, "gib": 1024**3,
             "k": 1024, "m": 1024**2, "g": 1024**3, "b": 1}
    lower = value.lower()
    for suffix in sorted(units, key=len, reverse=True):
        if lower.endswith(suffix):
            return int(float(lower[: -len(suffix)]) * units[suffix])
    return int(value)


def _parse_duration(value: str) -> float:
    """'24h' / '30m' / '90s' / '120' → seconds; empty/invalid → 0 (off)."""
    value = value.strip().lower()
    if not value:
        return 0.0
    units = {"h": 3600.0, "m": 60.0, "s": 1.0}
    try:
        if value[-1] in units:
            return float(value[:-1]) * units[value[-1]]
        return float(value)
    except ValueError:
        return 0.0


def build_stack(cfg: SnapshotterConfig, device: str | None = None):
    """Assemble store → managers → filesystem → snapshotter
    (reference snapshot.NewSnapshotter snapshot.go:64-299). ``device`` is
    handed to the tarfs engine (see the module docstring)."""
    os.makedirs(cfg.root, exist_ok=True)
    db = Database(cfg.database_path)

    daemon_config = None
    if os.path.exists(cfg.daemon.nydusd_config_path):
        daemon_config = DaemonRuntimeConfig.from_template(
            cfg.daemon.nydusd_config_path, cfg.daemon.fs_driver
        )
    else:
        daemon_config = DaemonRuntimeConfig.from_dict({}, cfg.daemon.fs_driver)

    managers: dict[str, Manager] = {}
    if cfg.daemon.fs_driver in (C.FS_DRIVER_FUSEDEV, C.FS_DRIVER_FSCACHE):
        mgr = Manager(cfg, db, fs_driver=cfg.daemon.fs_driver)
        mgr.run_death_handler()
        managers[cfg.daemon.fs_driver] = mgr

    gc_period_sec = _parse_duration(cfg.cache_manager.gc_period)
    cache_mgr = CacheManager(
        cfg.cache_root,
        period_sec=gc_period_sec,
        enabled=cfg.cache_manager.enable,
    )
    if gc_period_sec > 0:
        # Age GC keeps the reference behavior; the capacity watermark
        # ([blobcache].eviction_watermark_mib, NTPU_BLOBCACHE_WATERMARK_MIB
        # env override) additionally evicts whole LRU entries once total
        # usage crosses it (cache/manager.py).
        from nydus_snapshotter_tpu_torch.daemon.fetch_sched import resolve_watermark_bytes

        cache_mgr.start_gc(
            max_age_sec=gc_period_sec,
            watermark_bytes=resolve_watermark_bytes(
                cfg.blobcache.eviction_watermark_mib
            ),
        )

    # Bootstrap signature verifier (snapshot.go:65) + daemon cgroup
    # (snapshot.go:88); both optional and config-gated.
    verifier = None
    if cfg.image.validate_signature:
        from nydus_snapshotter_tpu_torch.signature import Verifier

        verifier = Verifier(
            public_key_file=cfg.image.public_key_file,
            validate_signature=cfg.image.validate_signature,
        )
    cgroup_mgr = None
    if cfg.cgroup.enable:
        from nydus_snapshotter_tpu_torch.cgroup import CgroupNotSupported
        from nydus_snapshotter_tpu_torch.cgroup import Config as CgroupCfg
        from nydus_snapshotter_tpu_torch.cgroup import Manager as CgroupManager

        try:
            cgroup_mgr = CgroupManager(
                "nydusd",
                CgroupCfg(memory_limit_in_bytes=_parse_size(cfg.cgroup.memory_limit)),
            )
        except (CgroupNotSupported, OSError, ValueError) as e:
            # cgroup problems degrade to a warning, never block startup
            logger.warning("cgroup disabled: %s", e)

    # Optional lazy-pull adaptors (fs.go:58-194 wiring of stargz/referrer).
    # Their resolvers must share the [remote] transport settings — the
    # mirror config dir (the only route to plain-http registries) and
    # skip_ssl_verify — or a deployment's registry simply never resolves
    # and the arm silently declines every layer.
    def _resolver_pool():
        from nydus_snapshotter_tpu_torch.remote import transport

        return transport.Pool(
            mirrors_config_dir=cfg.remote.mirrors_config_dir,
            insecure_tls=cfg.remote.skip_ssl_verify,
        )

    stargz_resolver = None
    stargz_adaptor = None
    if cfg.experimental.enable_stargz:
        from nydus_snapshotter_tpu_torch.snapshot.snapshotter import upper_path
        from nydus_snapshotter_tpu_torch.stargz import Resolver, StargzAdaptor

        stargz_resolver = Resolver(pool=_resolver_pool())
        stargz_adaptor = StargzAdaptor(
            lambda sid: upper_path(cfg.root, sid),
            cache_dir=cfg.cache_root,
            fs_driver=cfg.daemon.fs_driver,
        )
    soci_resolver = None
    soci_adaptor = None
    if cfg.soci.enable:
        from nydus_snapshotter_tpu_torch.snapshot.snapshotter import upper_path
        from nydus_snapshotter_tpu_torch.soci import SociAdaptor, SociResolver

        soci_resolver = SociResolver(pool=_resolver_pool())
        soci_adaptor = SociAdaptor(
            lambda sid: upper_path(cfg.root, sid),
            cache_dir=cfg.cache_root,
            fs_driver=cfg.daemon.fs_driver,
            stride=cfg.soci.stride_kib << 10,
        )
    referrer_mgr = None
    if cfg.experimental.enable_referrer_detect:
        from nydus_snapshotter_tpu_torch.referrer import ReferrerManager

        referrer_mgr = ReferrerManager()
    tarfs_mgr = None
    if cfg.experimental.tarfs_enable:
        from nydus_snapshotter_tpu_torch.ops.chunker import ChunkDigestEngine
        from nydus_snapshotter_tpu_torch.tarfs import DEFAULT_CHUNK_SIZE
        from nydus_snapshotter_tpu_torch.tarfs import Manager as TarfsManager

        tarfs_mgr = TarfsManager(
            cache_dir_path=cfg.cache_root,
            mount_on_host=cfg.experimental.tarfs_mount_on_host,
            export_mode=cfg.experimental.tarfs_export_mode,
            max_concurrent_process=cfg.experimental.tarfs_max_concurrent_proc,
            # tarfs boundaries come from the tar layout (fixed regions);
            # digests go through the configured arm (validated in
            # Config.validate; default hybrid — the control plane must
            # never make a CUDA context unless jax, the card lane, is
            # opted in), or hashlib when acceleration is disabled outright.
            engine=(
                ChunkDigestEngine(
                    chunk_size=DEFAULT_CHUNK_SIZE,
                    mode="fixed",
                    backend=cfg.daemon.accel_backend,
                    device=device,
                )
                if cfg.daemon.accel_enable
                else None
            ),
        )

    fs = Filesystem(
        managers=managers,
        cache_mgr=cache_mgr,
        root=cfg.root,
        fs_driver=cfg.daemon.fs_driver,
        daemon_mode=cfg.daemon_mode,
        daemon_config=daemon_config,
        verifier=verifier,
        stargz_resolver=stargz_resolver,
        stargz_adaptor=stargz_adaptor,
        soci_resolver=soci_resolver,
        soci_adaptor=soci_adaptor,
        referrer_mgr=referrer_mgr,
        tarfs_mgr=tarfs_mgr,
        tarfs_export=cfg.experimental.tarfs_export_mode != "",
        mirrors_config_dir=cfg.remote.mirrors_config_dir,
    )
    for mgr in managers.values():
        mgr.cgroup_mgr = cgroup_mgr
    fs.startup()

    sn = Snapshotter(
        root=cfg.root,
        fs=fs,
        fs_driver=cfg.daemon.fs_driver,
        enable_nydus_overlayfs=cfg.snapshot.enable_nydus_overlayfs,
        daemon_mode=cfg.daemon_mode,
        sync_remove=cfg.snapshot.sync_remove,
        cleanup_on_close=cfg.cleanup_on_close,
        read_pool=cfg.snapshots.read_pool,
        prepare_fanout=cfg.snapshots.prepare_fanout,
        usage_workers=cfg.snapshots.usage_workers,
        cleanup_workers=cfg.snapshots.cleanup_workers,
        ancestor_cache=cfg.snapshots.ancestor_cache,
    )
    return sn, fs, managers, db


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    cfg = config_from_args(args)
    # Publish the parsed config behind the package-global accessor BEFORE
    # anything lazily resolves a section: the resolve_*_config() helpers
    # (trace, blobcache, peer, fleet, slo, chunk_dict) read env over
    # `get_global_config()`, and without this call the TOML sections
    # never reached them in the real process.
    set_global_config(cfg)
    setup_logging(cfg)
    if args.device:  # a device asked for by name must exist
        from nydus_snapshotter_tpu_torch.tensors import resolve_device

        resolve_device(args.device)

    sn, fs, managers, _db = build_stack(cfg, device=args.device or None)

    # Observability plane (snapshot.go:181-261): metrics exporter, system
    # controller on UDS, optional profiling endpoint.
    metrics_server = None
    if cfg.metrics.address:
        from nydus_snapshotter_tpu_torch.metrics.serve import MetricsServer

        metrics_server = MetricsServer(
            managers=managers.values(), cache_dir=cfg.cache_root
        )
        metrics_server.serve(cfg.metrics.address)
        metrics_server.start_collecting()
        logger.info("metrics exporter on %s", cfg.metrics.address)
    # Fleet observability plane (fleet/, docs/observability.md): member
    # registry + federated metrics + merged traces + SLO engine, mounted
    # on the system controller's socket below. Built BEFORE the dict/peer
    # services start so this process's one member slot is claimed first
    # (a peer server in this process must not re-register it over HTTP).
    # The controller address is exported via NTPU_FLEET_CONTROLLER so
    # spawned daemon processes self-register.
    fleet_plane = None
    if cfg.fleet.enable and cfg.system.enable:
        from nydus_snapshotter_tpu_torch import fleet

        fleet_plane = fleet.FleetPlane(metrics_server=metrics_server)
        fleet_plane.register_local("snapshotter")
        fleet_plane.start()
        os.environ.setdefault("NTPU_FLEET_CONTROLLER", cfg.system.address)
        logger.info(
            "fleet plane on unix:%s (scrape every %.1fs, %d slo objectives)",
            cfg.system.address,
            fleet_plane.cfg.scrape_interval_secs,
            len(fleet_plane.slo.objectives),
        )
    # Shared chunk-dict service (parallel/dict_service.py): one growable
    # registry-wide dedup table per namespace, served to converter workers
    # over the [chunk_dict].service UDS and mounted on the system
    # controller's socket alongside the ops routes.
    dict_service = None
    if cfg.chunk_dict.service:
        from nydus_snapshotter_tpu_torch.parallel.dict_service import DictService

        dict_service = DictService()
        if cfg.chunk_dict.replicas > 0 or cfg.chunk_dict.shards > 1:
            # HA: this process's dict service is a placement candidate.
            # The process's one member slot is already claimed as
            # "snapshotter", so advertise the dict socket the same way a
            # daemon advertises its peer server — an extra annotation
            # the placement controller accepts (fleet.annotate_self).
            from nydus_snapshotter_tpu_torch.ha.replicate import HaAgent

            HaAgent(dict_service, role="unassigned")
        dict_service.run(cfg.chunk_dict.service)
        if dict_service.ha is not None:
            from nydus_snapshotter_tpu_torch import fleet

            fleet.annotate_self("dict_listen", cfg.chunk_dict.service)
    # Dict-shard HA plane (ha/, docs/chunk_dict_service.md HA section):
    # with replicas configured and the fleet plane up, the controller
    # places each shard's primary + replicas over the live dict members,
    # replicates journals, and auto-promotes on primary death. The knobs
    # reach spawned dict/converter processes via the NTPU_DICT_HA* env.
    if cfg.chunk_dict.replicas > 0 or cfg.chunk_dict.shards > 1:
        os.environ.setdefault("NTPU_DICT_HA_SHARDS", str(cfg.chunk_dict.shards))
        os.environ.setdefault("NTPU_DICT_HA_REPLICAS", str(cfg.chunk_dict.replicas))
        os.environ.setdefault(
            "NTPU_DICT_HA_BUDGET_KIB", str(cfg.chunk_dict.replication_budget_kib)
        )
        os.environ.setdefault(
            "NTPU_DICT_HA_POLL_MS", str(cfg.chunk_dict.replication_poll_ms)
        )
        if fleet_plane is not None:
            from nydus_snapshotter_tpu_torch import ha as ha_mod

            fleet_plane.attach_placement(
                ha_mod.PlacementController(
                    fleet_plane.registry.members,
                    fleet_plane.federator.liveness,
                    shards=cfg.chunk_dict.shards,
                    replicas=cfg.chunk_dict.replicas,
                    engine=fleet_plane.slo,
                )
            )
            logger.info(
                "dict-ha placement plane attached (%d shards x %d replicas)",
                cfg.chunk_dict.shards, cfg.chunk_dict.replicas,
            )
    # Peer chunk tier (daemon/peer.py): serve locally cached chunk ranges
    # to cluster peers and route this node's lazy-read misses through the
    # registry -> peer -> local-cache waterfall. The section reaches the
    # spawned daemon processes via the NTPU_PEER* environment, which the
    # daemon resolves itself (daemon/server.py) — here we start the
    # snapshotter-process server (shared daemon mode runs the data plane
    # in-process) and pre-resolve the router.
    peer_server = None
    if cfg.peer.enable:
        from nydus_snapshotter_tpu_torch.daemon import peer as peer_mod

        # Dynamic membership reaches spawned daemons the same way every
        # peer knob does — via the environment (the controller address is
        # already in NTPU_FLEET_CONTROLLER when [fleet] is on).
        os.environ.setdefault("NTPU_PEER_MEMBERSHIP", cfg.peer.membership)
        os.environ.setdefault(
            "NTPU_PEER_MEMBERSHIP_REFRESH_MS",
            str(int(cfg.peer.membership_refresh_secs * 1000)),
        )
        peer_server = peer_mod.start_from_config()
        peer_mod.default_router()
        if peer_server is not None:
            logger.info("peer chunk server on %s", peer_server.address)
    # SLO actuation (metrics/slo.py): the controller's fleet plane sheds
    # QoS lanes on burn-rate breach; spawned daemons follow the published
    # state when [slo] actuate+follow are on (env is their config path).
    if cfg.slo.actuate:
        os.environ.setdefault("NTPU_SLO_ACTUATE", "1")
        os.environ.setdefault("NTPU_SLO_FOLLOW", "1" if cfg.slo.follow else "0")
        if cfg.slo.shed_lanes:
            os.environ.setdefault(
                "NTPU_SLO_SHED_LANES", ",".join(cfg.slo.shed_lanes)
            )
        os.environ.setdefault(
            "NTPU_SLO_RESTORE_BURN", str(cfg.slo.restore_burn)
        )
    # Seekable-OCI backend (soci/): the spawned daemon process resolves
    # the section from the NTPU_SOCI* environment, like every blobcache
    # knob — export it so daemons mount checkpoint-indexed readers and
    # replicate indexes through the peer tier.
    if cfg.soci.enable:
        os.environ.setdefault("NTPU_SOCI_ENABLE", "1")
        os.environ.setdefault("NTPU_SOCI_STRIDE_KIB", str(cfg.soci.stride_kib))
        os.environ.setdefault(
            "NTPU_SOCI_REPLICATE", "1" if cfg.soci.replicate else "0"
        )
    system_controller = None
    if cfg.system.enable:
        from nydus_snapshotter_tpu_torch.system import SystemController

        system_controller = SystemController(
            fs=fs,
            managers=list(managers.values()),
            sock_path=cfg.system.address,
            dict_service=dict_service,
            fleet=fleet_plane,
        )
        system_controller.run()
        logger.info("system controller on unix:%s", cfg.system.address)
        if cfg.system.debug_pprof_address:
            from nydus_snapshotter_tpu_torch.pprof import new_pprof_http_listener

            new_pprof_http_listener(cfg.system.debug_pprof_address)
            logger.info("profiler on %s", cfg.system.debug_pprof_address)

    address = cfg.address
    os.makedirs(os.path.dirname(address) or ".", exist_ok=True)
    if os.path.exists(address):
        # ensureSocketNotExists (snapshotter.go:96-117)
        os.unlink(address)
    server = grpc_service.serve(
        sn, address, max_workers=grpc_service.worker_count(cfg.snapshots)
    )
    logger.info("serving snapshots.v1 on unix:%s (driver=%s mode=%s)",
                address, cfg.daemon.fs_driver, cfg.daemon_mode)

    stop = threading.Event()

    def _on_signal(_signum, _frame):
        stop.set()

    signal.signal(signal.SIGTERM, _on_signal)
    signal.signal(signal.SIGINT, _on_signal)
    try:
        stop.wait()
    finally:
        server.stop(grace=2).wait()
        if metrics_server is not None:
            metrics_server.stop()
        if fleet_plane is not None:
            fleet_plane.stop()
        if system_controller is not None:
            system_controller.stop()
        if dict_service is not None:
            dict_service.stop()
        if peer_server is not None:
            from nydus_snapshotter_tpu_torch.daemon import peer as peer_mod

            peer_mod.stop_default()
        sn.close()
        for mgr in managers.values():
            mgr.stop()
    return 0


if __name__ == "__main__":
    sys.exit(main())
