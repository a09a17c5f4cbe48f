"""The snapshotter core (reference snapshot/snapshot.go:64-1090).

Implements the containerd snapshots.v1 method surface —
Prepare/View/Mounts/Commit/Remove/Stat/Update/Usage/Walk/Cleanup/Close —
over the sqlite MetaStore, with the reference's label-driven per-layer
processor routing (snapshot/process.go:26-183) and overlay/bind/proxy/remote
mount-slice synthesis (snapshot.go:825-985, mount_option.go).

The `fs` collaborator is the L3 filesystem facade
(:mod:`nydus_snapshotter_tpu_torch.filesystem`); any object with the same duck
type works, which is how unit tests drive the routing logic without
daemons.
"""

from __future__ import annotations

import functools
import logging
import os
import shutil
import tempfile
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Optional, Protocol

from nydus_snapshotter_tpu_torch import constants as C
from nydus_snapshotter_tpu_torch import failpoint
from nydus_snapshotter_tpu_torch import trace
from nydus_snapshotter_tpu_torch.snapshot import labels as label
from nydus_snapshotter_tpu_torch.snapshot import metastore as ms
from nydus_snapshotter_tpu_torch.snapshot.async_work import (
    PrepareBoard,
    UsageAccountant,
    resolve_snapshots_config,
)
from nydus_snapshotter_tpu_torch.snapshot.metastore import Info, MetaStore, Snapshot, Usage
from nydus_snapshotter_tpu_torch.snapshot.mount import (
    KATA_IMAGE_RAW_BLOCK,
    KATA_LAYER_RAW_BLOCK,
    ExtraOption,
    Mount,
    bind_mount,
    overlay_mount,
    prepare_kata_virtual_volume,
)
from nydus_snapshotter_tpu_torch.metrics.collector import snapshot_timer
from nydus_snapshotter_tpu_torch.utils import errdefs


def upper_path(root: str, sid: str) -> str:
    """Canonical upper-dir layout ``<root>/snapshots/<sid>/fs`` — the single
    encoding shared by the snapshotter and the adaptor wiring."""
    return os.path.join(root, "snapshots", sid, "fs")


def _timed(operation: str):
    """Method-latency histogram wrapper (reference snapshot.go:303-592
    collector.NewSnapshotMetricsTimer around Mounts/Prepare/Remove/Cleanup)
    + the op's trace span, so the histograms and the span tree meter one
    and the same window."""

    def deco(fn):
        @functools.wraps(fn)
        def wrapper(self, *args, **kwargs):
            attrs = {"key": args[0]} if args and isinstance(args[0], str) else {}
            with trace.span(f"snapshot.{operation}", **attrs), snapshot_timer(
                operation
            ):
                return fn(self, *args, **kwargs)

        return wrapper

    return deco

logger = logging.getLogger(__name__)


class FilesystemLike(Protocol):
    """What the snapshotter needs from the L3 filesystem facade."""

    def mount(self, snapshot_id: str, labels: dict, snapshot: Optional[Snapshot]) -> None: ...
    def umount(self, snapshot_id: str) -> None: ...
    def wait_until_ready(self, snapshot_id: str) -> None: ...
    def mount_point(self, snapshot_id: str) -> str: ...
    def bootstrap_file(self, snapshot_id: str) -> str: ...
    def remove_cache(self, blob_digest: str) -> None: ...
    def cache_usage(self, blob_digest: str) -> Usage: ...
    def teardown(self) -> None: ...
    def try_stop_shared_daemon(self) -> None: ...
    def check_referrer(self, labels: dict) -> bool: ...
    def referrer_detect_enabled(self) -> bool: ...
    def try_fetch_metadata(self, labels: dict, meta_path: str) -> None: ...
    def stargz_enabled(self) -> bool: ...
    def is_stargz_data_layer(self, labels: dict) -> tuple[bool, object]: ...
    def prepare_stargz_meta_layer(self, blob, storage_path: str, labels: dict) -> None: ...
    def merge_stargz_meta_layer(self, snapshot: Snapshot) -> None: ...
    def soci_enabled(self) -> bool: ...
    def is_soci_data_layer(self, labels: dict) -> tuple[bool, object]: ...
    def prepare_soci_meta_layer(self, blob, storage_path: str, labels: dict) -> None: ...
    def merge_soci_meta_layer(self, snapshot: Snapshot) -> None: ...
    def tarfs_enabled(self) -> bool: ...
    def prepare_tarfs_layer(self, labels: dict, snapshot_id: str, upper_path: str) -> None: ...
    def merge_tarfs_layers(self, snapshot: Snapshot, path_fn: Callable[[str], str]) -> None: ...
    def export_block_data(
        self, snapshot: Snapshot, per_layer: bool, labels: dict, path_fn: Callable[[str], str]
    ) -> list[str]: ...
    def detach_tarfs_layer(self, snapshot_id: str) -> None: ...
    def tarfs_export_enabled(self) -> bool: ...
    def get_instance_extra_option(self, snapshot_id: str) -> Optional[ExtraOption]: ...


def _disk_usage(path: str) -> Usage:
    size = 0
    inodes = 0
    for root, dirs, files in os.walk(path):
        inodes += len(dirs) + len(files)
        for f in files:
            try:
                size += os.lstat(os.path.join(root, f)).st_size
            except OSError:
                continue
    return Usage(size=size, inodes=inodes)


class Snapshotter:
    def __init__(
        self,
        root: str,
        fs: FilesystemLike,
        fs_driver: str = C.DEFAULT_FS_DRIVER,
        enable_nydus_overlayfs: bool = False,
        enable_kata_volume: bool = False,
        daemon_mode: str = C.DEFAULT_DAEMON_MODE,
        sync_remove: bool = False,
        cleanup_on_close: bool = False,
        nydus_overlayfs_path: str = "",
        read_pool: Optional[int] = None,
        prepare_fanout: Optional[int] = None,
        usage_workers: Optional[int] = None,
        cleanup_workers: Optional[int] = None,
        ancestor_cache: Optional[int] = None,
    ):
        self.root = root
        self.fs = fs
        self.fs_driver = fs_driver
        self.enable_nydus_overlayfs = enable_nydus_overlayfs
        self.enable_kata_volume = enable_kata_volume
        self.daemon_mode = daemon_mode
        self.sync_remove = sync_remove
        self.cleanup_on_close = cleanup_on_close
        self.nydus_overlayfs_path = nydus_overlayfs_path
        # Control-plane concurrency knobs ([snapshots] / NTPU_SNAPSHOT*);
        # explicit arguments win, 0 anywhere falls back to the serial path.
        ccfg = resolve_snapshots_config()
        self.prepare_fanout = ccfg.prepare_fanout if prepare_fanout is None else prepare_fanout
        self.usage_workers = ccfg.usage_workers if usage_workers is None else usage_workers
        self.cleanup_workers = max(
            1, ccfg.cleanup_workers if cleanup_workers is None else cleanup_workers
        )
        os.makedirs(self.snapshot_root(), exist_ok=True)
        self.ms = MetaStore(
            os.path.join(root, "snapshots", "metadata.db"),
            read_pool=ccfg.read_pool if read_pool is None else read_pool,
            ancestor_cache=ancestor_cache,
        )
        self._board = PrepareBoard(self.prepare_fanout)
        self._usage_acct = UsageAccountant(
            scan=_disk_usage,
            write=self.ms.set_usages,
            workers=self.usage_workers,
            pre_wait=self._board.wait_quiet,
        )
        # In-flight prepare temp dirs ("new-*"): the Cleanup GC must not
        # reap a sibling RPC's staging dir mid-rename (the orphan sweep
        # only targets crash leftovers, which are never in this set).
        self._inflight_tmp: set[str] = set()
        self._inflight_mu = threading.Lock()

    # -- path layout ---------------------------------------------------------

    def snapshot_root(self) -> str:
        return os.path.join(self.root, "snapshots")

    def snapshot_dir(self, sid: str) -> str:
        return os.path.join(self.snapshot_root(), sid)

    def upper_path(self, sid: str) -> str:
        return upper_path(self.root, sid)

    def work_path(self, sid: str) -> str:
        return os.path.join(self.root, "snapshots", sid, "work")

    def lower_path(self, sid: str) -> str:
        """Rootdir of nydus image contents: the RAFS mountpoint when an
        instance exists, else the snapshot fs dir (snapshot.go:703-711)."""
        try:
            return self.fs.mount_point(sid)
        except errdefs.NotFound:
            return os.path.join(self.root, "snapshots", sid, "fs")

    # -- snapshots.v1 methods -------------------------------------------------

    def stat(self, key: str) -> Info:
        _, info, _ = self.ms.get_info(key)
        return info

    def update(self, info: Info, *fieldpaths: str) -> Info:
        return self.ms.update_info(info, *fieldpaths)

    def usage(self, key: str) -> Usage:
        # Join any pending async accounting scan first so the row read
        # below reflects it (a failed scan surfaces here, once).
        self._usage_acct.join(key)
        sid, info, usage = self.ms.get_info(key)
        if info.kind == ms.KIND_ACTIVE:
            usage = _disk_usage(self.upper_path(sid))
        elif info.kind == ms.KIND_COMMITTED and (
            label.is_nydus_data_layer(info.labels) or label.is_tarfs_data_layer(info.labels)
        ):
            blob_digest = info.labels.get(C.CRI_LAYER_DIGEST, "")
            if blob_digest:
                usage.add(self.fs.cache_usage(blob_digest))
        return usage

    @_timed("mounts")
    def mounts(self, key: str) -> list[Mount]:
        need_remote = False
        meta_sid = ""
        sid, info, _ = self.ms.get_info(key)
        # Join point of the overlapped prepare: background work for this
        # snapshot (daemon readiness, stargz bootstrap build) must have
        # finished — and a failed background prepare surfaces HERE, it is
        # never swallowed by the worker thread.
        self._board.join(sid)

        if info.kind == ms.KIND_VIEW:
            if label.is_nydus_meta_layer(info.labels):
                try:
                    self.fs.wait_until_ready(sid)
                    need_remote, meta_sid = True, sid
                except errdefs.NotFound:
                    # Client (e.g. buildkit) is unpacking nydus artifacts
                    # itself; no daemon was ever started (snapshot.go:385-396).
                    pass
            elif (self.fs.tarfs_enabled() and label.is_tarfs_data_layer(info.labels)) or (
                label.is_nydus_proxy_mode(info.labels)
            ):
                need_remote, meta_sid = True, sid
        elif info.kind == ms.KIND_ACTIVE and info.parent:
            p_sid, p_info, _ = self.ms.get_info(info.parent)
            self._board.join(p_sid)
            if label.is_nydus_meta_layer(p_info.labels):
                self.fs.wait_until_ready(p_sid)
                need_remote, meta_sid = True, p_sid
            elif (self.fs.tarfs_enabled() and label.is_tarfs_data_layer(p_info.labels)) or (
                label.is_nydus_proxy_mode(p_info.labels)
            ):
                need_remote, meta_sid = True, p_sid

        if self.fs.referrer_detect_enabled() and not need_remote:
            try:
                rid, _ = self._find_referrer_layer(key)
                need_remote, meta_sid = True, rid
            except errdefs.NotFound:
                pass

        snap = self.ms.get_snapshot(key)
        if self._treat_as_proxy_driver(info.labels):
            return self._mount_proxy(snap)
        if need_remote:
            return self._mount_remote(info.labels, snap, meta_sid, key)
        return self._mount_native(info.labels, snap)

    @_timed("prepare")
    def prepare(self, key: str, parent: str, snap_labels: Optional[dict] = None) -> list[Mount]:
        info, s = self._create_snapshot(ms.KIND_ACTIVE, key, parent, snap_labels)
        handler, target = self._choose_processor(s, key, parent, info.labels)
        skip, mounts = handler()
        if skip and target:
            # Remote snapshot ready: commit in place so containerd skips the
            # download (process.go skipHandler + Prepare needCommit,
            # snapshot.go:470-477).
            try:
                self.commit(target, key, snap_labels=info.labels)
            except errdefs.AlreadyExists:
                pass
            raise errdefs.AlreadyExists(f"target snapshot {target!r}")
        return mounts

    def view(self, key: str, parent: str, snap_labels: Optional[dict] = None) -> list[Mount]:
        p_sid, p_info, _ = self.ms.get_info(parent)
        self._board.join(p_sid)
        need_remote = False
        meta_sid = ""
        if label.is_nydus_meta_layer(p_info.labels):
            try:
                self.fs.wait_until_ready(p_sid)
            except errdefs.NotFound:
                self.fs.mount(p_sid, p_info.labels, None)
                self.fs.wait_until_ready(p_sid)
            need_remote, meta_sid = True, p_sid
        elif label.is_nydus_data_layer(p_info.labels):
            raise errdefs.InvalidArgument("only can view nydus topmost layer")

        base, s = self._create_snapshot(ms.KIND_VIEW, key, parent, snap_labels)

        if self.fs.tarfs_enabled() and label.is_tarfs_data_layer(p_info.labels):
            self._merge_tarfs(s, p_sid, p_info)
            self.fs.mount(p_sid, p_info.labels, s)
            need_remote, meta_sid = True, p_sid

        if need_remote:
            return self._mount_remote(base.labels, s, meta_sid, key)
        return self._mount_native(base.labels, s)

    @_timed("commit")
    def commit(self, name: str, key: str, snap_labels: Optional[dict] = None) -> None:
        failpoint.hit("snapshot.commit")
        sid, info, _ = self.ms.get_info(key)
        # One timestamp and one write transaction for the whole commit
        # (rename + label merge); the upper-dir usage scan moves off the
        # critical path into the async accountant, which backfills the row
        # and is joined by usage().
        self.ms.commit_active(
            key, name, Usage(), now=time.time(), extra_labels=snap_labels or None
        )
        self._usage_acct.submit(name, self.upper_path(sid), sid=sid)

    @_timed("remove")
    def remove(self, key: str) -> None:
        sid, info, _ = self.ms.get_info(key)
        if info.kind == ms.KIND_COMMITTED:
            blob_digest = info.labels.get(C.CRI_LAYER_DIGEST, "")
            if blob_digest:
                threading.Thread(
                    target=self._remove_cache_quietly, args=(blob_digest,), daemon=True
                ).start()
        self.ms.remove(key)
        self._board.discard(sid)
        self._usage_acct.discard(key)
        if self.sync_remove:
            for d in self._get_cleanup_directories():
                self._cleanup_snapshot_directory(d)

    def walk(self, fn: Callable[[str, Info], None]) -> None:
        self.ms.walk(fn)

    @_timed("cleanup")
    def cleanup(self) -> None:
        dirs = self._get_cleanup_directories()
        if not dirs:
            return
        if self.cleanup_workers > 1 and len(dirs) > 1:
            # Pool workers have no contextvars: carry the cleanup span's
            # context so per-dir spans hang off the Cleanup root.
            ctx = trace.capture()

            def one(d: str) -> None:
                with trace.with_context(ctx):
                    self._cleanup_snapshot_directory(d)

            with ThreadPoolExecutor(
                max_workers=min(self.cleanup_workers, len(dirs)),
                thread_name_prefix="ntpu-snap-clean",
            ) as ex:
                for fut in [ex.submit(one, d) for d in dirs]:
                    fut.result()
        else:
            for d in dirs:
                self._cleanup_snapshot_directory(d)

    def close(self) -> None:
        # Quiesce background work first: prepare jobs may still touch the
        # fs facade, and pending usage scans must land in the metastore
        # before it closes.
        self._board.close()
        self._usage_acct.flush()
        self._usage_acct.close()
        if self.cleanup_on_close:
            try:
                self.fs.teardown()
            except Exception:
                logger.exception("failed to tear down remote snapshots")
        self.fs.try_stop_shared_daemon()
        self.ms.close()

    # -- processor routing (reference snapshot/process.go) --------------------

    def _choose_processor(
        self, s: Snapshot, key: str, parent: str, snap_labels: dict
    ) -> tuple[Callable[[], tuple[bool, list[Mount]]], str]:
        """Return (handler, target). handler() -> (skip_download, mounts)."""

        def default_handler():
            return False, self._mount_native(snap_labels, s)

        def skip_handler():
            return True, []

        def remote_handler(sid: str, rl: dict):
            def run():
                # Surface any failed background prep of the layer we are
                # about to mount over, then mount synchronously (cheap
                # registration + spawn kick; the mountpoint feeds lowerdir
                # synthesis below). The slow part — daemon readiness — is
                # deferred to the board, joined at mounts().
                self._board.join(sid)
                self.fs.mount(sid, rl, s)
                self._board.submit(s.id, functools.partial(self.fs.wait_until_ready, sid))
                return False, self._mount_remote(rl, s, sid, key)

            return run

        def proxy_handler():
            return False, self._mount_proxy(s)

        target = snap_labels.get(C.TARGET_SNAPSHOT_REF, "")
        handler = None

        if target:  # ro layer during image pull
            if self.fs_driver == C.FS_DRIVER_PROXY:
                if snap_labels.get(C.CRI_LAYER_DIGEST, ""):
                    snap_labels[C.NYDUS_PROXY_MODE] = "true"
                    handler = skip_handler
                else:
                    raise errdefs.InvalidArgument(
                        f"missing CRI reference annotation for snapshot {s.id}"
                    )
            elif label.is_nydus_meta_layer(snap_labels):
                handler = default_handler
            elif label.is_nydus_data_layer(snap_labels):
                handler = skip_handler
            elif self.fs.check_referrer(snap_labels):
                handler = skip_handler
            else:
                if self.fs.stargz_enabled():
                    ok, blob = self.fs.is_stargz_data_layer(snap_labels)
                    if ok:
                        if self._board.enabled:
                            # Optimistic skip: detection already succeeded, so
                            # the heavy TOC→bootstrap build overlaps on the
                            # board while containerd issues the next layer's
                            # Prepare; a failure sticks to this snapshot id
                            # and surfaces at mounts()/the child prepare.
                            self._board.submit(
                                s.id,
                                functools.partial(
                                    self.fs.prepare_stargz_meta_layer,
                                    blob,
                                    self.upper_path(s.id),
                                    dict(snap_labels),
                                ),
                            )
                            snap_labels[C.STARGZ_LAYER] = "true"
                            handler = skip_handler
                        else:
                            try:
                                self.fs.prepare_stargz_meta_layer(
                                    blob, self.upper_path(s.id), snap_labels
                                )
                            except Exception:
                                logger.exception(
                                    "prepare stargz layer of snapshot %s", s.id
                                )
                            else:
                                snap_labels[C.STARGZ_LAYER] = "true"
                                handler = skip_handler
                if handler is None and self.fs.soci_enabled():
                    # Seekable-OCI: claim the ordinary gzip or zstd layer
                    # nobody will ever convert. Runs after the stargz arm
                    # so cooperative estargz images keep their TOC path;
                    # detection is the FormatRouter's two ranged probe
                    # reads (4 head bytes + one tail read), which pick a
                    # lazy backend by modeled cold-read cost or raise to
                    # fall through to ordinary conversion (soci/router.py).
                    ok, blob = self.fs.is_soci_data_layer(snap_labels)
                    if ok:
                        route = getattr(blob, "route", None)
                        if route is not None:
                            snap_labels[C.SOCI_ROUTE] = route.backend
                        if self._board.enabled:
                            # Optimistic skip, like stargz: the heavy
                            # first-pull index build overlaps on the board
                            # while containerd issues the next layer's
                            # Prepare; a failure sticks to this snapshot
                            # id and surfaces at mounts()/child prepare.
                            self._board.submit(
                                s.id,
                                functools.partial(
                                    self.fs.prepare_soci_meta_layer,
                                    blob,
                                    self.upper_path(s.id),
                                    dict(snap_labels),
                                ),
                            )
                            snap_labels[C.SOCI_LAYER] = "true"
                            handler = skip_handler
                        else:
                            try:
                                self.fs.prepare_soci_meta_layer(
                                    blob, self.upper_path(s.id), snap_labels
                                )
                            except Exception:
                                logger.exception(
                                    "prepare soci layer of snapshot %s", s.id
                                )
                            else:
                                snap_labels[C.SOCI_LAYER] = "true"
                                handler = skip_handler
                if handler is None and self.fs.tarfs_enabled():
                    try:
                        self.fs.prepare_tarfs_layer(snap_labels, s.id, self.upper_path(s.id))
                    except Exception:
                        logger.warning(
                            "snapshot %s can't be converted into tarfs, fallback", s.id
                        )
                    else:
                        if self.fs.tarfs_export_enabled():
                            self.fs.export_block_data(s, True, snap_labels, self.upper_path)
                        handler = skip_handler
        else:  # container writable layer
            p_sid, p_info = "", None
            p_err: Optional[Exception] = None
            try:
                p_sid, p_info, _ = self.ms.get_info(parent)
            except errdefs.NotFound as e:
                p_err = e

            if p_info is not None and self._treat_as_proxy_driver(p_info.labels):
                handler = proxy_handler
            if p_err is None and p_info is not None and label.is_nydus_proxy_mode(p_info.labels):
                handler = remote_handler(p_sid, p_info.labels)

            if handler is None:
                try:
                    mid, m_info = self._find_meta_layer(key)
                    handler = remote_handler(mid, m_info.labels)
                except errdefs.NotFound:
                    pass

            if handler is None and self.fs.referrer_detect_enabled():
                try:
                    rid, r_info = self._find_referrer_layer(key)
                    meta_path = os.path.join(self.snapshot_dir(rid), "fs", "image.boot")
                    self.fs.try_fetch_metadata(r_info.labels, meta_path)
                    handler = remote_handler(rid, r_info.labels)
                except errdefs.NotFound:
                    pass

            if (
                handler is None
                and p_err is None
                and p_info is not None
                and self.fs.stargz_enabled()
                and label.is_stargz_layer(p_info.labels)
            ):
                # The parent's bootstrap may still be building in the
                # background — this is its other join point.
                self._board.join(p_sid)
                self.fs.merge_stargz_meta_layer(s)
                handler = remote_handler(p_sid, p_info.labels)

            if (
                handler is None
                and p_err is None
                and p_info is not None
                and self.fs.soci_enabled()
                and label.is_soci_layer(p_info.labels)
            ):
                # The parent's index-on-first-pull build may still be
                # running in the background — this is its join point.
                self._board.join(p_sid)
                self.fs.merge_soci_meta_layer(s)
                handler = remote_handler(p_sid, p_info.labels)

            if (
                handler is None
                and p_err is None
                and p_info is not None
                and self.fs.tarfs_enabled()
                and label.is_tarfs_data_layer(p_info.labels)
            ):
                self._board.join(p_sid)
                self._merge_tarfs(s, p_sid, p_info)
                handler = remote_handler(p_sid, p_info.labels)

        if handler is None:
            handler = default_handler
        return handler, target

    # -- internals ------------------------------------------------------------

    def _remove_cache_quietly(self, blob_digest: str) -> None:
        try:
            self.fs.remove_cache(blob_digest)
        except Exception:
            logger.exception("failed to remove cache %s", blob_digest)

    def _treat_as_proxy_driver(self, snap_labels: dict) -> bool:
        # A snapshot prepared by another snapshotter (pause image) shows a CRI
        # image ref without nydus/proxy labels (snapshot.go:1086-1090).
        return (
            self.fs_driver == C.FS_DRIVER_PROXY
            and not label.is_nydus_proxy_mode(snap_labels)
            and C.CRI_IMAGE_REF in snap_labels
        )

    def _find_meta_layer(self, key: str) -> tuple[str, Info]:
        return self.ms.iterate_parent_snapshots(
            key, lambda _sid, info: label.is_nydus_meta_layer(info.labels)
        )

    def _find_referrer_layer(self, key: str) -> tuple[str, Info]:
        return self.ms.iterate_parent_snapshots(
            key, lambda _sid, info: self.fs.check_referrer(info.labels)
        )

    def _create_snapshot(
        self, kind: str, key: str, parent: str, snap_labels: Optional[dict]
    ) -> tuple[Info, Snapshot]:
        base_labels = dict(snap_labels or {})
        # mkdtemp + registration are atomic w.r.t. the GC's
        # list-then-check (see _get_cleanup_directories ordering): any
        # staging dir the GC can observe is already registered.
        with self._inflight_mu:
            td = tempfile.mkdtemp(prefix="new-", dir=self.snapshot_root())
            td_name = os.path.basename(td)
            self._inflight_tmp.add(td_name)
        path = ""
        s: Optional[Snapshot] = None
        try:
            os.makedirs(os.path.join(td, "fs"), exist_ok=True)
            if kind == ms.KIND_ACTIVE:
                os.makedirs(os.path.join(td, "work"), mode=0o711, exist_ok=True)
            s = self.ms.create_snapshot(kind, key, parent, base_labels)
            if s.parent_ids:
                st = os.stat(self.upper_path(s.parent_ids[0]))
                try:
                    os.chown(os.path.join(td, "fs"), st.st_uid, st.st_gid)
                except PermissionError:
                    pass
            path = self.snapshot_dir(s.id)
            os.rename(td, path)
            td = ""
        except BaseException:
            # Roll back the metastore row so a retried prepare(key) isn't
            # poisoned with AlreadyExists (the reference's bolt txn rollback).
            if s is not None:
                try:
                    self.ms.remove(key)
                except errdefs.NydusError:
                    pass
            raise
        finally:
            with self._inflight_mu:
                self._inflight_tmp.discard(td_name)
            if td:
                shutil.rmtree(td, ignore_errors=True)
        _, info, _ = self.ms.get_info(key)
        return info, s

    def _merge_tarfs(self, s: Snapshot, p_sid: str, p_info: Info) -> None:
        self.fs.merge_tarfs_layers(s, self.upper_path)
        if self.fs.tarfs_export_enabled():
            update_fields = self.fs.export_block_data(s, False, p_info.labels, self.upper_path)
            if update_fields:
                self.ms.update_info(p_info, *update_fields)

    # -- mount synthesis ------------------------------------------------------

    def _overlay_mount_type(self) -> str:
        if self.nydus_overlayfs_path:
            return f"fuse.{self.nydus_overlayfs_path}"
        return "fuse.nydus-overlayfs"

    def _mount_native(self, snap_labels: dict, s: Snapshot) -> list[Mount]:
        if not s.parent_ids:
            ro = "ro" if s.kind == ms.KIND_VIEW else "rw"
            return bind_mount(self.upper_path(s.id), ro)
        options: list[str] = []
        if s.kind == ms.KIND_ACTIVE:
            options += [f"workdir={self.work_path(s.id)}", f"upperdir={self.upper_path(s.id)}"]
            if label.is_volatile(snap_labels):
                options.append("volatile")
        elif len(s.parent_ids) == 1:
            return bind_mount(self.upper_path(s.id), "ro")
        parents = [self.upper_path(pid) for pid in s.parent_ids]
        options.append("lowerdir=" + ":".join(parents))
        return overlay_mount(options)

    def _mount_proxy(self, s: Snapshot) -> list[Mount]:
        options: list[str] = []
        if s.kind == ms.KIND_ACTIVE:
            options += [f"workdir={self.work_path(s.id)}", f"upperdir={self.upper_path(s.id)}"]
        parents = (
            [self.upper_path(pid) for pid in s.parent_ids]
            if s.parent_ids
            else [self.snapshot_root()]
        )
        options.append("lowerdir=" + ":".join(parents))
        options.append(
            prepare_kata_virtual_volume(
                C.NYDUS_PROXY_MODE,
                "dummy-image-reference",
                "image_guest_pull",
                "",
                [],
                {},
            )
        )
        return [Mount(type=self._overlay_mount_type(), source="overlay", options=options)]

    def _mount_remote(
        self, snap_labels: dict, s: Snapshot, meta_sid: str, key: str
    ) -> list[Mount]:
        options: list[str] = []
        if label.is_volatile(snap_labels):
            options.append("volatile")

        lower_paths: list[str] = []
        if self.fs.referrer_detect_enabled():
            # Layers between the upmost snapshot and the nydus meta snapshot
            # (snapshot.go:908-921).
            for pid in s.parent_ids:
                if pid == meta_sid:
                    break
                lower_paths.append(self.upper_path(pid))
        lower_paths.append(self.lower_path(meta_sid))

        if s.kind == ms.KIND_ACTIVE:
            options += [f"workdir={self.work_path(s.id)}", f"upperdir={self.upper_path(s.id)}"]
        elif s.kind == ms.KIND_VIEW:
            lower_paths.append(self.lower_path(s.id))

        options.append("lowerdir=" + ":".join(lower_paths))

        if self.enable_kata_volume:
            return self._mount_with_kata_volume(meta_sid, options, key)
        if self.enable_nydus_overlayfs or self.daemon_mode == C.DAEMON_MODE_NONE:
            return self._remote_mount_with_extra_options(s, meta_sid, options)
        return overlay_mount(options)

    def _remote_mount_with_extra_options(
        self, s: Snapshot, meta_sid: str, options: list[str]
    ) -> list[Mount]:
        extra = self.fs.get_instance_extra_option(meta_sid)
        if extra is not None:
            options.append(extra.encode())
        return [Mount(type=self._overlay_mount_type(), source="overlay", options=options)]

    def _mount_with_kata_volume(self, meta_sid: str, options: list[str], key: str) -> list[Mount]:
        """Kata-volume mount synthesis (reference mount_option.go:117-243):
        tarfs snapshots carry raw-block volumes pointing at the exported
        EROFS disk images (whole-image or one per layer, with dm-verity
        info from the block-info labels); nydus-fs snapshots carry the
        extraoption-backed image_nydus_fs volume."""
        ann = {}
        if self.fs.tarfs_enabled():
            ann = self.fs.get_instance_annotations(meta_sid)
        if C.NYDUS_TARFS_LAYER in ann:
            if C.NYDUS_IMAGE_BLOCK_INFO in ann:
                path = self.fs.tarfs_image_disk_path(ann[C.NYDUS_TARFS_LAYER])
                options.append(
                    prepare_kata_virtual_volume(
                        C.NYDUS_IMAGE_BLOCK_INFO,
                        path,
                        KATA_IMAGE_RAW_BLOCK,
                        "erofs",
                        ["ro"],
                        ann,
                    )
                )
            elif C.NYDUS_LAYER_BLOCK_INFO in ann:
                # One raw-block volume per tarfs layer, appended in
                # parent-walk order — topmost committed layer first —
                # exactly as the reference emits them while walking the
                # chain down (mount_option.go:211-242).
                vols: list[str] = []

                def visit(_sid: str, info: Info) -> bool:
                    blob_id = info.labels.get(C.NYDUS_TARFS_LAYER, "")
                    if blob_id:
                        vols.append(
                            prepare_kata_virtual_volume(
                                C.NYDUS_LAYER_BLOCK_INFO,
                                self.fs.tarfs_layer_disk_path(blob_id),
                                KATA_LAYER_RAW_BLOCK,
                                "erofs",
                                ["ro"],
                                dict(info.labels),
                            )
                        )
                    return False  # walk the whole chain

                try:
                    self.ms.iterate_parent_snapshots(key, visit)
                except errdefs.NotFound:
                    pass  # chain exhausted — expected
                options.extend(vols)  # top layer first (parent-walk order)
            return [
                Mount(
                    type=self._overlay_mount_type(),
                    source="overlay",
                    options=options,
                )
            ]
        extra = self.fs.get_instance_extra_option(meta_sid)
        if extra is not None:
            vol_opt = prepare_kata_virtual_volume(
                "",
                extra.source,
                "image_nydus_fs",
                extra.fs_version,
                [],
                {},
            )
            options.append(vol_opt)
        return [Mount(type=self._overlay_mount_type(), source="overlay", options=options)]

    # -- GC -------------------------------------------------------------------

    def _get_cleanup_directories(self) -> list[str]:
        # Ordering against concurrent prepares: list FIRST, then read the
        # id map and the in-flight set. A staging dir created after the
        # listing isn't in `dirs`; one created before is registered
        # (mkdtemp+add are atomic) and gets skipped; and a dir RENAMED to
        # its final id between the two reads had its metastore row
        # created before the rename, so a LATER id_map() must contain it
        # — reading ids before listdir reopened exactly that window (the
        # GC would reap a just-created live snapshot).
        try:
            dirs = os.listdir(self.snapshot_root())
        except FileNotFoundError:
            return []
        ids = self.ms.id_map()
        with self._inflight_mu:
            inflight = set(self._inflight_tmp)
        return [
            self.snapshot_dir(d)
            for d in dirs
            if d not in ids
            and d not in inflight  # a sibling RPC's staging dir, not an orphan
            and d != "metadata.db"
            and not d.endswith(("-wal", "-shm"))
        ]

    @trace.traced("snapshot.cleanup.dir")
    def _cleanup_snapshot_directory(self, d: str) -> None:
        failpoint.hit("snapshot.cleanup")
        sid = os.path.basename(d)
        self._board.discard(sid)
        try:
            self.fs.umount(sid)
        except (errdefs.NotFound, FileNotFoundError):
            pass
        except Exception:
            logger.exception("failed to unmount %s", d)
        if self.fs.tarfs_enabled():
            try:
                self.fs.detach_tarfs_layer(sid)
            except (errdefs.NotFound, FileNotFoundError):
                pass
        shutil.rmtree(d, ignore_errors=True)
