"""Driver-indexed filesystem facade.

Reference pkg/filesystem/fs.go:43-745: the layer between the snapshotter
and the daemon managers. Responsibilities reproduced here:

- ``mount``/``umount``/``wait_until_ready`` of RAFS instances: pick the
  manager by fs driver, shared vs dedicated daemon, supplement + persist
  the per-instance daemon config, ref-counted teardown (fs.go:268-500);
- startup recovery orchestration: reconnect live daemons, respawn dead
  ones and replay their mounts, retain/init the shared daemon
  (fs.go:58-194 ``NewFileSystem``);
- blob-cache usage/removal through the cache manager (fs.go:502-530);
- adaptor hooks for stargz / tarfs / referrer drivers — optional
  collaborators; each ``*_enabled()`` reflects whether one was wired in
  (stargz_adaptor.go / tarfs_adaptor.go / referer_adaptor.go).

The snapshotter only sees the duck type declared in
``snapshot.snapshotter.FilesystemLike``.
"""

from __future__ import annotations

import contextlib
import json
import logging
import os
import threading
from typing import Optional

from nydus_snapshotter_tpu_torch import constants as C
from nydus_snapshotter_tpu_torch import failpoint
from nydus_snapshotter_tpu_torch import trace
from nydus_snapshotter_tpu_torch.cache.manager import CacheManager
from nydus_snapshotter_tpu_torch.config.daemonconfig import DaemonRuntimeConfig
from nydus_snapshotter_tpu_torch.daemon.daemon import SHARED_DAEMON_ID, Daemon
from nydus_snapshotter_tpu_torch.daemon.types import DaemonState
from nydus_snapshotter_tpu_torch.manager.manager import Manager
from nydus_snapshotter_tpu_torch.rafs.rafs import Rafs, RafsCache
from nydus_snapshotter_tpu_torch.snapshot import labels as label
from nydus_snapshotter_tpu_torch.snapshot.metastore import Usage
from nydus_snapshotter_tpu_torch.snapshot.mount import ExtraOption
from nydus_snapshotter_tpu_torch.utils import errdefs

logger = logging.getLogger(__name__)


def _digest_hex(blob_digest: str) -> str:
    algo, _, hexpart = blob_digest.partition(":")
    if algo != "sha256" or len(hexpart) != 64:
        raise errdefs.InvalidArgument(f"invalid blob digest {blob_digest!r}")
    return hexpart


class Filesystem:
    def __init__(
        self,
        *,
        managers: dict[str, Manager],
        cache_mgr: CacheManager,
        root: str,
        fs_driver: str = C.DEFAULT_FS_DRIVER,
        daemon_mode: str = C.DEFAULT_DAEMON_MODE,
        daemon_config: Optional[DaemonRuntimeConfig] = None,
        verifier=None,
        stargz_resolver=None,
        stargz_adaptor=None,
        soci_resolver=None,
        soci_adaptor=None,
        tarfs_mgr=None,
        referrer_mgr=None,
        root_mountpoint: str = "",
        tarfs_export: bool = False,
        mirrors_config_dir: str = "",
    ):
        self.managers = managers
        self.cache_mgr = cache_mgr
        self.root = root
        self.fs_driver = fs_driver
        self.daemon_mode = daemon_mode
        self.daemon_config = daemon_config
        self.verifier = verifier
        self.stargz_resolver = stargz_resolver
        self.stargz_adaptor = stargz_adaptor
        self.soci_resolver = soci_resolver
        self.soci_adaptor = soci_adaptor
        self.tarfs_mgr = tarfs_mgr
        self.referrer_mgr = referrer_mgr
        self.root_mountpoint = root_mountpoint or os.path.join(root, "mnt")
        self._tarfs_export = tarfs_export
        self.mirrors_config_dir = mirrors_config_dir
        self.instances = RafsCache()
        self.shared_daemons: dict[str, Daemon] = {}  # fs_driver -> shared daemon
        self._lock = threading.RLock()  # shared-daemon create/stop only
        self._pending_mounts = 0  # in-flight mounts, guarded by _lock
        self._snap_locks: dict[str, list] = {}  # sid -> [lock, waiter count]
        self._snap_locks_mu = threading.Lock()

    @contextlib.contextmanager
    def _snapshot_lock(self, snapshot_id: str):
        """Per-snapshot lock: concurrent Prepare/Remove for ONE snapshot
        serialize, while mounts of unrelated snapshots proceed in parallel
        (a slow daemon spawn must not stall every other RPC). Entries are
        refcounted so an entry is only dropped when no thread holds or
        waits on it — a waiter must never be stranded on a popped lock."""
        with self._snap_locks_mu:
            entry = self._snap_locks.get(snapshot_id)
            if entry is None:
                entry = self._snap_locks[snapshot_id] = [threading.RLock(), 0]
            entry[1] += 1
        entry[0].acquire()
        try:
            yield
        finally:
            entry[0].release()
            with self._snap_locks_mu:
                entry[1] -= 1
                if entry[1] == 0 and self._snap_locks.get(snapshot_id) is entry:
                    self._snap_locks.pop(snapshot_id, None)

    # -- startup recovery (fs.go:58-194) -------------------------------------

    def startup(self) -> None:
        """Recover persisted daemons, replay their mounts, and ensure the
        shared daemon exists for shared-mode drivers."""
        for mgr in self.managers.values():
            live, dead = mgr.recover()
            failed: set[str] = set()
            for d in live + dead:
                if d.is_shared() or d.states.fs_driver == C.FS_DRIVER_FSCACHE:
                    self.shared_daemons.setdefault(d.states.fs_driver, d)
            for d in dead:
                try:
                    d.clear_vestige()
                    mgr.start_daemon(d)
                    self._replay_instances(mgr, d)
                except Exception:
                    logger.warning("failed to recover daemon %s, skipping", d.id)
                    # Don't leave a dead daemon registered as the shared one —
                    # that would wedge every shared-mode mount; let the
                    # fallback below spawn a fresh shared daemon instead.
                    if self.shared_daemons.get(d.states.fs_driver) is d:
                        self.shared_daemons.pop(d.states.fs_driver, None)
                    mgr.remove_daemon(d.id)
                    failed.add(d.id)
            for rafs_dict in self._walk_instances(mgr):
                rafs = Rafs.from_dict(rafs_dict)
                if rafs.daemon_id in failed:
                    # No daemon serves this snapshot anymore; drop the record
                    # so a later mount() re-creates it instead of silently
                    # handing out a mountpoint nothing backs.
                    mgr.db.delete_instance(rafs.snapshot_id)
                    continue
                self.instances.add(rafs)
        # fscache always runs through one shared daemon (fs.go:102-121); for
        # fusedev a shared daemon exists only in shared mode.
        if C.FS_DRIVER_FSCACHE in self.managers and C.FS_DRIVER_FSCACHE not in self.shared_daemons:
            self.init_shared_daemon(self.managers[C.FS_DRIVER_FSCACHE])
        if (
            self.daemon_mode == C.DAEMON_MODE_SHARED
            and self.fs_driver == C.FS_DRIVER_FUSEDEV
            and self.fs_driver in self.managers
            and self.fs_driver not in self.shared_daemons
        ):
            self.init_shared_daemon(self.managers[self.fs_driver])

    def _walk_instances(self, mgr: Manager):
        """Yield persisted instance dicts in seq (replay) order."""
        try:
            yield from (rec for rec, _seq in mgr.db.walk_instances())
        except Exception:
            return

    def _replay_instances(self, mgr: Manager, d: Daemon) -> None:
        instances = [
            Rafs.from_dict(rec)
            for rec in self._walk_instances(mgr)
            if rec.get("daemon_id") == d.id
        ]
        configs = {}
        for rafs in instances:
            cfg_path = self._instance_config_path(d, rafs.snapshot_id)
            if os.path.exists(cfg_path):
                with open(cfg_path) as f:
                    configs[rafs.snapshot_id] = f.read()
        d.recover_rafs_instances(instances, configs)

    def init_shared_daemon(self, mgr: Manager) -> Daemon:
        d = mgr.new_daemon(SHARED_DAEMON_ID, daemon_mode=C.DAEMON_MODE_SHARED)
        mgr.add_daemon(d)
        mgr.start_daemon(d)
        self.shared_daemons[mgr.fs_driver] = d
        return d

    def get_shared_daemon(self, fs_driver: str) -> Daemon:
        d = self.shared_daemons.get(fs_driver)
        if d is None:
            raise errdefs.NotFound(f"no shared daemon for driver {fs_driver}")
        return d

    def try_stop_shared_daemon(self) -> None:
        """Stop shared daemons not referenced by any snapshot
        (fs.go TryStopSharedDaemon)."""
        with self._lock:
            self._try_stop_shared_locked()

    def _try_stop_shared_locked(self) -> None:
        if self._pending_mounts > 0:
            return  # a mount may be about to attach to a shared daemon
        for fs_driver, d in list(self.shared_daemons.items()):
            if d.ref_count() == 0:
                mgr = self.managers.get(fs_driver)
                if mgr is not None:
                    mgr.destroy_daemon(d)
                self.shared_daemons.pop(fs_driver, None)

    # -- manager helpers ------------------------------------------------------

    def get_manager(self, fs_driver: str) -> Manager:
        mgr = self.managers.get(fs_driver)
        if mgr is None:
            raise errdefs.NotFound(f"no manager for filesystem driver {fs_driver!r}")
        return mgr

    def get_daemon_by_rafs(self, rafs: Rafs) -> Daemon:
        mgr = self.get_manager(rafs.fs_driver)
        d = mgr.get_by_daemon_id(rafs.daemon_id)
        if d is None:
            d = self.shared_daemons.get(rafs.fs_driver)
        if d is None:
            raise errdefs.NotFound(f"daemon {rafs.daemon_id} for snapshot {rafs.snapshot_id}")
        return d

    def get_daemon_by_id(self, daemon_id: str) -> Daemon:
        for mgr in self.managers.values():
            d = mgr.get_by_daemon_id(daemon_id)
            if d is not None:
                return d
        raise errdefs.NotFound(f"daemon {daemon_id}")

    # -- mount/umount (fs.go:268-500) ----------------------------------------

    def mount(self, snapshot_id: str, snap_labels: dict, snapshot=None) -> None:
        # Serialized per snapshot: concurrent Prepare RPCs for one snapshot
        # must not both pass the exists-check and race shared_mount/rollback.
        # The pending-mount count keeps try_stop_shared_daemon from tearing
        # the shared daemon down between get_shared_daemon and the refcount
        # attach inside shared_mount.
        with trace.span("daemon.mount", sid=snapshot_id):
            failpoint.hit("fs.mount")
            with self._lock:
                self._pending_mounts += 1
            try:
                with self._snapshot_lock(snapshot_id):
                    self._mount_locked(snapshot_id, snap_labels, snapshot)
            finally:
                with self._lock:
                    self._pending_mounts -= 1

    def _mount_locked(self, snapshot_id: str, snap_labels: dict, snapshot=None) -> None:
        if self.instances.get(snapshot_id) is not None:
            return  # instance already exists

        fs_driver = self.fs_driver
        if label.is_tarfs_data_layer(snap_labels):
            fs_driver = C.FS_DRIVER_BLOCKDEV

        shared_fusedev = (
            fs_driver == C.FS_DRIVER_FUSEDEV and self.daemon_mode == C.DAEMON_MODE_SHARED
        )
        use_shared = fs_driver == C.FS_DRIVER_FSCACHE or shared_fusedev

        image_id = snap_labels.get(C.CRI_IMAGE_REF) or snap_labels.get(
            "containerd.io/snapshot/remote/stargz.reference", ""
        )
        if not image_id and fs_driver not in (C.FS_DRIVER_NODEV, C.FS_DRIVER_PROXY):
            raise errdefs.InvalidArgument(
                f"failed to find image ref of snapshot {snapshot_id}, labels {snap_labels}"
            )

        snapshot_dir = os.path.join(self.root, "snapshots", snapshot_id)
        rafs = Rafs(
            snapshot_id=snapshot_id,
            image_id=image_id,
            fs_driver=fs_driver,
            snapshot_dir=snapshot_dir,
        )
        try:
            self._mount_rafs(rafs, fs_driver, use_shared, snap_labels, snapshot)
        except Exception:
            self.instances.remove(snapshot_id)
            # A dedicated daemon created for this mount must not leak: its
            # db record would be resurrected on every restart
            # (reference fs.go createDaemon defer DeleteDaemon).
            if rafs.daemon_id and rafs.daemon_id != SHARED_DAEMON_ID:
                mgr = self.managers.get(rafs.fs_driver)
                if mgr is not None:
                    orphan = mgr.get_by_daemon_id(rafs.daemon_id)
                    if orphan is not None:
                        # This mount's own instance may already be attached;
                        # detach it so the refcount reflects other users only.
                        orphan.remove_rafs_instance(snapshot_id)
                        if orphan.ref_count() == 0:
                            try:
                                mgr.destroy_daemon(orphan)
                            except Exception:
                                logger.exception(
                                    "failed to clean up daemon %s", rafs.daemon_id
                                )
            raise

    def _mount_rafs(self, rafs, fs_driver, use_shared, snap_labels, snapshot) -> None:
        mgr = self.get_manager(fs_driver) if fs_driver in self.managers else None

        if fs_driver in (C.FS_DRIVER_FSCACHE, C.FS_DRIVER_FUSEDEV):
            assert mgr is not None
            bootstrap = rafs.bootstrap_file()
            if use_shared:
                d = self.get_shared_daemon(fs_driver)
            else:
                d = mgr.new_daemon(f"nydusd-{rafs.snapshot_id}")
                try:
                    mgr.add_daemon(d)
                except errdefs.AlreadyExists:
                    d = mgr.get_by_daemon_id(d.id)
            # Record early so the mount() rollback can find (and destroy) a
            # dedicated daemon even when a later step here raises.
            rafs.daemon_id = d.id

            # Supplement + persist per-instance config for crash replay
            # (fs.go:340-370).
            config_json = "{}"
            if self.daemon_config is not None:
                cfg = DaemonRuntimeConfig.from_dict(
                    self.daemon_config.to_dict(), fs_driver
                )
                cfg.supplement(
                    image_ref=rafs.image_id,
                    auth=snap_labels.get(C.NYDUS_IMAGE_PULL_SECRET, ""),
                    work_dir=rafs.fscache_work_dir(),
                    mirrors_config_dir=self.mirrors_config_dir,
                )
                # Blob caches live in the cache manager's dir, so the daemon
                # knows where to find them (fs.go:335-338).
                if not cfg.backend.blob_dir:
                    cfg.backend.blob_dir = self.cache_mgr.cache_dir
                cfg_path = self._instance_config_path(d, rafs.snapshot_id)
                os.makedirs(os.path.dirname(cfg_path), exist_ok=True)
                cfg.dump(cfg_path)
                config_json = json.dumps(cfg.to_dict())

            if self.verifier is not None:
                self.verifier.verify(snap_labels, bootstrap)

            if use_shared:
                rafs.mountpoint = os.path.join(self.root_mountpoint, rafs.snapshot_id)
                if d.state() != DaemonState.RUNNING:
                    d.wait_until_state(DaemonState.RUNNING)
                d.shared_mount(rafs, bootstrap, config_json)
            else:
                rafs.mountpoint = os.path.join(rafs.snapshot_dir, "mnt")
                if d.state() == DaemonState.UNKNOWN:
                    mgr.start_daemon(d)
                # The dedicated daemon must actually SERVE its instance,
                # not just exist: attach via the mount API exactly like
                # the shared path (the reference's dedicated nydusd gets
                # its bootstrap on the command line; one API surface here
                # keeps supervisor state sync + failover replay uniform).
                d.shared_mount(rafs, bootstrap, config_json)
        elif fs_driver == C.FS_DRIVER_BLOCKDEV:
            if self.tarfs_mgr is None:
                raise errdefs.Unavailable("tarfs manager is not enabled")
            self.tarfs_mgr.mount_tar_erofs(rafs.snapshot_id, snapshot, snap_labels, rafs)
        elif fs_driver == C.FS_DRIVER_NODEV:
            pass
        elif fs_driver == C.FS_DRIVER_PROXY:
            if label.is_nydus_proxy_mode(snap_labels):
                if C.CRI_LAYER_DIGEST in snap_labels:
                    rafs.annotations[C.CRI_LAYER_DIGEST] = snap_labels[C.CRI_LAYER_DIGEST]
                rafs.annotations[C.NYDUS_PROXY_MODE] = "true"
                rafs.mountpoint = os.path.join(rafs.snapshot_dir, "fs")
        else:
            raise errdefs.InvalidArgument(f"unknown filesystem driver {fs_driver!r}")

        # Persist instance record with its replay sequence (rafs.go:112-117).
        self.instances.add(rafs)
        if mgr is not None:
            rafs.seq = mgr.db.next_instance_seq()
            mgr.db.save_instance(rafs.snapshot_id, rafs.to_dict(), rafs.seq)

    def umount(self, snapshot_id: str) -> None:
        failpoint.hit("fs.umount")
        with self._snapshot_lock(snapshot_id):
            self._umount_locked(snapshot_id)

    def _umount_locked(self, snapshot_id: str) -> None:
        rafs = self.instances.get(snapshot_id)
        if rafs is None:
            return
        fs_driver = rafs.fs_driver
        if fs_driver == C.FS_DRIVER_NODEV:
            self.instances.remove(snapshot_id)
            return
        if fs_driver in (C.FS_DRIVER_FSCACHE, C.FS_DRIVER_FUSEDEV):
            mgr = self.get_manager(fs_driver)
            d = self.get_daemon_by_rafs(rafs)
            try:
                d.shared_umount(rafs)
            except (OSError, errdefs.NydusError):
                d.remove_rafs_instance(snapshot_id)
            mgr.db.delete_instance(snapshot_id)
            if d.ref_count() == 0 and not d.is_shared():
                mgr.destroy_daemon(d)
        elif fs_driver == C.FS_DRIVER_BLOCKDEV:
            if self.tarfs_mgr is not None:
                # pass the persisted mountpoint: kernel mounts outlive the
                # process, the manager's in-memory status does not
                self.tarfs_mgr.umount_tar_erofs(snapshot_id, rafs.mountpoint)
            mgr = self.managers.get(fs_driver)
            if mgr is not None:
                mgr.db.delete_instance(snapshot_id)
        self.instances.remove(snapshot_id)

    def wait_until_ready(self, snapshot_id: str) -> None:
        with trace.span("daemon.wait_ready", sid=snapshot_id):
            rafs = self.instances.get(snapshot_id)
            if rafs is None:
                if self.daemon_mode == C.DAEMON_MODE_NONE:
                    return
                raise errdefs.NotFound(f"no instance {snapshot_id}")
            if rafs.fs_driver in (C.FS_DRIVER_FSCACHE, C.FS_DRIVER_FUSEDEV):
                # A daemon whose restart budget is exhausted never comes back:
                # serve the snapshot dirs as-is (nodev-style passthrough)
                # instead of blocking the mount path on a dead socket.
                mgr = self.managers.get(rafs.fs_driver)
                if mgr is not None and mgr.is_degraded(rafs.daemon_id):
                    return
                d = self.get_daemon_by_rafs(rafs)
                d.wait_until_state(DaemonState.RUNNING)

    def mount_point(self, snapshot_id: str) -> str:
        rafs = self.instances.get(snapshot_id)
        if rafs is None or not rafs.mountpoint:
            raise errdefs.NotFound(f"no mountpoint for snapshot {snapshot_id}")
        return rafs.mountpoint

    def bootstrap_file(self, snapshot_id: str) -> str:
        rafs = self.instances.get(snapshot_id)
        if rafs is None:
            raise errdefs.NotFound(f"no instance {snapshot_id}")
        return rafs.bootstrap_file()

    def _instance_config_path(self, d: Daemon, snapshot_id: str) -> str:
        return os.path.join(d.states.workdir, f"{snapshot_id}.json")

    def get_instance_annotations(self, snapshot_id: str) -> dict:
        """The mounted instance's annotations (tarfs block-info labels,
        proxy mode, …) — reference rafs.Annotations, consumed by the kata
        volume synthesis (mount_option.go:137-243)."""
        rafs = self.instances.get(snapshot_id)
        return dict(rafs.annotations) if rafs is not None else {}

    def tarfs_image_disk_path(self, blob_id: str) -> str:
        if self.tarfs_mgr is None:
            raise errdefs.Unavailable("tarfs support is not enabled")
        return self.tarfs_mgr.image_disk_file_path(blob_id)

    def tarfs_layer_disk_path(self, blob_id: str) -> str:
        if self.tarfs_mgr is None:
            raise errdefs.Unavailable("tarfs support is not enabled")
        return self.tarfs_mgr.layer_disk_file_path(blob_id)

    def get_instance_extra_option(self, snapshot_id: str) -> Optional[ExtraOption]:
        """Assemble the extraoption payload for the mount helper
        (mount_option.go:42-116)."""
        rafs = self.instances.get(snapshot_id)
        if rafs is None:
            return None
        config_content = "{}"
        try:
            d = self.get_daemon_by_rafs(rafs)
            cfg_path = self._instance_config_path(d, snapshot_id)
            if os.path.exists(cfg_path):
                with open(cfg_path) as f:
                    config_content = f.read()
        except errdefs.NotFound:
            pass
        fs_version = "6"
        bootstrap = rafs.bootstrap_file()
        if os.path.exists(bootstrap):
            from nydus_snapshotter_tpu_torch.models import layout

            with open(bootstrap, "rb") as f:
                header = f.read(4096)
            try:
                fs_version = layout.detect_fs_version(header)
            except Exception:
                pass
        return ExtraOption(
            source=bootstrap,
            config=config_content,
            snapshotdir=rafs.snapshot_dir,
            fs_version=fs_version,
        )

    # -- blob cache (fs.go:502-530) ------------------------------------------

    def cache_usage(self, blob_digest: str) -> Usage:
        return self.cache_mgr.cache_usage(_digest_hex(blob_digest))

    def remove_cache(self, blob_digest: str) -> None:
        blob_id = _digest_hex(blob_digest)
        fscache = self.shared_daemons.get(C.FS_DRIVER_FSCACHE)
        if fscache is not None:
            # Unbind first so the daemon drops its handle, then reclaim the
            # on-disk cache files.
            fscache.client().unbind_blob("", blob_id)
        self.cache_mgr.remove_blob_cache(blob_id)

    # -- teardown ------------------------------------------------------------

    def teardown(self) -> None:
        # Stop the periodic cache GC first: an eviction tick racing the
        # umounts below would churn entries that are being torn down anyway.
        try:
            self.cache_mgr.stop_gc()
        except Exception:
            logger.exception("failed to stop cache GC during teardown")
        for rafs in self.instances.list():
            try:
                self.umount(rafs.snapshot_id)
            except Exception:
                logger.exception("failed to umount %s during teardown", rafs.snapshot_id)
        for mgr in self.managers.values():
            for d in mgr.list_daemons():
                try:
                    mgr.destroy_daemon(d)
                except Exception:
                    logger.exception("failed to destroy daemon %s", d.id)
        self.shared_daemons.clear()

    # -- adaptor surface (stargz / tarfs / referrer) -------------------------

    def stargz_enabled(self) -> bool:
        return self.stargz_resolver is not None

    def is_stargz_data_layer(self, snap_labels: dict):
        if not self.stargz_enabled():
            return False, None
        ref = snap_labels.get(C.CRI_IMAGE_REF, "")
        digest = snap_labels.get(C.CRI_LAYER_DIGEST, "")
        if not ref or not digest:
            return False, None
        try:
            blob = self.stargz_resolver.get_blob(ref, digest, snap_labels)
            return blob is not None, blob
        except Exception:
            return False, None

    def prepare_stargz_meta_layer(self, blob, storage_path: str, snap_labels: dict) -> None:
        if self.stargz_adaptor is None:
            raise errdefs.Unavailable("stargz support is not enabled")
        self.stargz_adaptor.prepare_meta_layer(blob, storage_path, snap_labels)

    def merge_stargz_meta_layer(self, snapshot) -> None:
        if self.stargz_adaptor is None:
            raise errdefs.Unavailable("stargz support is not enabled")
        self.stargz_adaptor.merge_meta_layer(snapshot)

    def soci_enabled(self) -> bool:
        return self.soci_resolver is not None

    def is_soci_data_layer(self, snap_labels: dict):
        """Whether this layer is claimable by the seekable-OCI backend:
        any plain gzip layer with image/digest labels qualifies — the
        whole point is that the image was never rewritten. Runs AFTER
        the nydus/stargz arms in the processor routing, so cooperative
        formats keep their richer paths."""
        if not self.soci_enabled():
            return False, None
        ref = snap_labels.get(C.CRI_IMAGE_REF, "")
        digest = snap_labels.get(C.CRI_LAYER_DIGEST, "")
        if not ref or not digest:
            return False, None
        try:
            blob = self.soci_resolver.get_blob(ref, digest, snap_labels)
            return blob is not None, blob
        except Exception:
            return False, None

    def prepare_soci_meta_layer(self, blob, storage_path: str, snap_labels: dict) -> None:
        if self.soci_adaptor is None:
            raise errdefs.Unavailable("soci support is not enabled")
        self.soci_adaptor.prepare_meta_layer(blob, storage_path, snap_labels)

    def merge_soci_meta_layer(self, snapshot) -> None:
        if self.soci_adaptor is None:
            raise errdefs.Unavailable("soci support is not enabled")
        self.soci_adaptor.merge_meta_layer(snapshot)

    def tarfs_enabled(self) -> bool:
        return self.tarfs_mgr is not None

    def tarfs_export_enabled(self) -> bool:
        return self.tarfs_mgr is not None and self._tarfs_export

    def prepare_tarfs_layer(self, snap_labels: dict, snapshot_id: str, upper_path: str) -> None:
        """Claim an OCI layer for tarfs (reference tarfs_adaptor.go:33-64):
        gate on the image's tarfs-hint annotation, kick the async blob
        process, and LABEL the snapshot as a tarfs data layer — the label
        is what routes the container-prepare to the tarfs merge/mount path
        (process.go writable-branch is_tarfs_data_layer check), so without
        it the whole tarfs runtime is unreachable from the snapshotter."""
        if self.tarfs_mgr is None:
            raise errdefs.Unavailable("tarfs support is not enabled")
        ref = snap_labels.get(C.CRI_IMAGE_REF, "")
        manifest_digest = snap_labels.get(C.CRI_MANIFEST_DIGEST, "")
        layer_digest = snap_labels.get(C.CRI_LAYER_DIGEST, "")
        # (missing ref/digest labels are rejected by prepare_layer below)
        if not self.tarfs_mgr.check_tarfs_hint_annotation(ref, manifest_digest):
            raise errdefs.InvalidArgument("this image is not recommended for tarfs")
        # concurrency is bounded inside the manager's async blob process
        # (per-ref semaphore + LRU, tarfs.py _blob_process)
        self.tarfs_mgr.prepare_layer(snap_labels, snapshot_id, upper_path)
        snap_labels[C.NYDUS_TARFS_LAYER] = layer_digest.split(":", 1)[-1]

    def merge_tarfs_layers(self, snapshot, path_fn) -> None:
        if self.tarfs_mgr is None:
            raise errdefs.Unavailable("tarfs support is not enabled")
        self.tarfs_mgr.merge_layers(snapshot, path_fn)

    def export_block_data(self, snapshot, per_layer: bool, snap_labels: dict, path_fn):
        if self.tarfs_mgr is None:
            raise errdefs.Unavailable("tarfs support is not enabled")
        return self.tarfs_mgr.export_block_data(snapshot, per_layer, snap_labels, path_fn)

    def detach_tarfs_layer(self, snapshot_id: str) -> None:
        if self.tarfs_mgr is None:
            raise errdefs.Unavailable("tarfs support is not enabled")
        self.tarfs_mgr.detach_layer(snapshot_id)

    def referrer_detect_enabled(self) -> bool:
        return self.referrer_mgr is not None

    def check_referrer(self, snap_labels: dict) -> bool:
        if self.referrer_mgr is None:
            return False
        ref = snap_labels.get(C.CRI_IMAGE_REF, "")
        manifest_digest = snap_labels.get(C.CRI_MANIFEST_DIGEST, "")
        if not ref or not manifest_digest:
            return False
        try:
            return self.referrer_mgr.check_referrer(ref, manifest_digest)
        except Exception:
            return False

    def try_fetch_metadata(self, snap_labels: dict, metadata_path: str) -> None:
        """Pull the companion image's bootstrap next to the snapshot
        (referer_adaptor.go:41-60)."""
        if self.referrer_mgr is None:
            raise errdefs.Unavailable("referrer detect is not enabled")
        ref = snap_labels.get(C.CRI_IMAGE_REF, "")
        manifest_digest = snap_labels.get(C.CRI_MANIFEST_DIGEST, "")
        if not ref or not manifest_digest:
            raise errdefs.InvalidArgument("missing image ref / manifest digest labels")
        self.referrer_mgr.try_fetch_metadata(ref, manifest_digest, metadata_path)
