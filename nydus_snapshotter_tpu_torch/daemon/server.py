"""The daemon process — this framework's nydusd equivalent.

Serves the reference nydusd HTTP-over-UDS API (surface catalogued at
pkg/daemon/client.go:31-58): daemon info/state, mount/umount, blob binding,
metrics (fs/cache/inflight), start/exit, and the supervisor
sendfd/takeover dance used for failover and live upgrade
(SURVEY §3.4). The data plane is a userspace read API (stat/list/read on
mounted RAFS instances, chunks resolved from local blob cache) beside a
kernel FUSE session where the environment can mount one — lazy serving is
I/O-bound and runs on the host, with no device path, but the full control
surface exists for parity with the reference's lifecycle, failover, and
upgrade flows.

Run: ``python -m nydus_snapshotter_tpu_torch.daemon.server --id ID --apisock PATH
[--supervisor PATH] [--upgrade] [--workdir DIR]``
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import signal
import socket
import socketserver
import stat as stat_mod
import sys
import threading
import urllib.parse
from http.server import BaseHTTPRequestHandler
from typing import Any, Optional

from nydus_snapshotter_tpu_torch import constants
from nydus_snapshotter_tpu_torch import trace
from nydus_snapshotter_tpu_torch.converter.convert import BlobReader
from nydus_snapshotter_tpu_torch.daemon.types import DaemonState, FsMetrics
from nydus_snapshotter_tpu_torch.models.bootstrap import Bootstrap

__version__ = "0.1.0"

logger = logging.getLogger(__name__)


class _Instance:
    """One mounted RAFS instance."""

    def __init__(self, mountpoint: str, source: str, config_json: str):
        self.mountpoint = mountpoint
        self.source = source
        self.config_json = config_json
        with open(source, "rb") as f:
            # Either layout: native, or a real nydus-toolchain bootstrap
            # (bridged) — the daemon serves both (models/nydus_real.py).
            from nydus_snapshotter_tpu_torch.models.nydus_real import load_any_bootstrap

            self.bootstrap = load_any_bootstrap(f.read())
        self.by_path = self.bootstrap.inode_by_path()
        self.metrics = FsMetrics()
        # Per-blob readers with open fds — the per-chunk open() of the naive
        # path made every read O(chunks) syscalls.
        self._batch_map = self.bootstrap.batch_map()
        self._readers: dict[int, BlobReader] = {}
        self._reader_lock = threading.Lock()
        self._closed = False
        self.prefetched_bytes = 0
        self._cached_blobs: list = []  # CachedBlob instances (registry backend)
        self._cached_by_index: dict[int, object] = {}  # blob_index -> CachedBlob
        # blob_index -> SociStreamReader for gzip-stream blobs with a
        # persisted checkpoint index (soci backend): cold reads resume at
        # the nearest inflate checkpoint instead of from byte 0.
        self._soci_by_index: dict[int, object] = {}
        self._replayer = None  # PrefetchReplayer while a replay is running
        # In-flight data-plane requests (API and FUSE reads both funnel
        # through read()); the inflight metrics endpoint snapshots this so
        # the collector's hung-IO gauge sees real request ages
        # (reference nydusd inflight metrics, client.go:31-58).
        self._inflight: dict[int, dict] = {}
        self._inflight_seq = 0
        self._inflight_lock = threading.Lock()
        self.fuse = None  # FuseSession when a kernel mount is being served

    def start_fuse(self, default_blob_dir: str, fd: Optional[int] = None) -> bool:
        """Serve this instance's mountpoint as a real kernel filesystem.

        Returns False (API-only serving remains) when /dev/fuse is
        unavailable, the mountpoint isn't a directory, or FUSE is disabled
        via NTPU_DISABLE_FUSE. ``fd`` adopts an existing session after a
        failover/upgrade takeover instead of mounting fresh.
        """
        if os.environ.get("NTPU_DISABLE_FUSE"):
            return False
        from nydus_snapshotter_tpu_torch.fusedev.session import (
            FuseSession,
            RafsFuseOps,
            fuse_available,
        )

        if fd is None and not (fuse_available() and os.path.isdir(self.mountpoint)):
            return False
        blob_dir = self.blob_dir(default_blob_dir)
        ops = RafsFuseOps(
            self.bootstrap, lambda p, off, size: self.read(p, off, size, blob_dir)
        )
        session = FuseSession(ops, self.mountpoint)
        try:
            if fd is None:
                session.mount()
            else:
                session.attach(fd)
        except Exception:
            return False
        self.fuse = session
        return True

    def close(self, unmount: bool = True) -> None:
        if self.fuse is not None:
            self.fuse.close(unmount=unmount)
            self.fuse = None
        # Umount cancels any background prefetch replay first, so cache
        # teardown never waits behind low-priority warming fetches.
        replayer = self._replayer
        if replayer is not None:
            replayer.cancel()
        # Drop the readers; each blob file closes when its last in-flight
        # read releases the closure reference (no explicit close — closing
        # under a racing read would either raise on a closed file or, worse,
        # pread a recycled fd).
        with self._reader_lock:
            self._closed = True
            self._readers.clear()
            cached_blobs = list(self._cached_blobs)
            self._cached_blobs.clear()
            self._cached_by_index.clear()
        # CachedBlob.close joins fetch workers; doing that under
        # _reader_lock would deadlock against a worker delivering.
        if cached_blobs:
            from nydus_snapshotter_tpu_torch import provenance
            from nydus_snapshotter_tpu_torch.daemon import peer as peer_mod

            export = peer_mod.default_export()
            prov_cfg = provenance.config()
            for cached in cached_blobs:
                export.unregister(cached.blob_id, cached)
                export.unregister_soci(cached.blob_id)
                export.unregister_artifact("zsoci", cached.blob_id)
                # Heat closed loop: distill this deploy's observed read
                # heat into the blob's .heat artifact before the cache
                # closes — the next deploy (here, or a cold neighbour via
                # the peer artifact plane) prefetches only what this one
                # actually read. The artifact deliberately STAYS
                # registered past the unmount: its whole value is to the
                # next deploy.
                if prov_cfg.enable and prov_cfg.heat:
                    cache_dir = os.path.dirname(cached.data_path)
                    art = provenance.compile_heat(
                        cached.blob_id, cache_dir,
                        source_size=cached.blob_size,
                    )
                    if art is not None and prov_cfg.replicate:
                        export.register_artifact(
                            provenance.ARTIFACT_KIND,
                            cached.blob_id,
                            provenance.heat_path(cache_dir, cached.blob_id),
                        )
        for cached in cached_blobs:
            try:
                cached.close()
            except OSError:
                pass

    def _parsed_config(self):
        if not hasattr(self, "_cfg_cache"):
            from nydus_snapshotter_tpu_torch.config import daemonconfig

            try:
                data = json.loads(self.config_json) if self.config_json else {}
            except json.JSONDecodeError:
                data = {}
            try:
                self._cfg_cache = daemonconfig.DaemonRuntimeConfig.from_dict(
                    data, data.get("fs_driver", "fusedev")
                )
            except Exception:
                logger.warning("unparseable instance config", exc_info=True)
                self._cfg_cache = None
        return self._cfg_cache

    def _reader(self, blob_index: int, blob_dir: str) -> BlobReader:
        soci_args = None
        with self._reader_lock:
            if self._closed:
                # A read racing a legitimate unmount: fail instead of
                # resurrecting a reader for the discarded instance.
                raise FileNotFoundError(self.mountpoint)
            reader = self._readers.get(blob_index)
            if reader is None:
                blob_id = self.bootstrap.blobs[blob_index].blob_id
                cfg = self._parsed_config()
                if cfg is not None and cfg.backend.backend_type == "registry" and cfg.backend.host:
                    # True lazy pull: ranged registry GETs (mirrors first,
                    # origin last) written through a chunk-granular local
                    # cache — the nydusd registry backend behavior.
                    from nydus_snapshotter_tpu_torch.daemon.blobcache import (
                        CachedBlob,
                        RegistryBlobFetcher,
                    )

                    from nydus_snapshotter_tpu_torch.daemon import peer as peer_mod

                    cache_dir = cfg.cache.work_dir or os.path.join(blob_dir, "cache")
                    fetcher = RegistryBlobFetcher(cfg.backend, blob_id)
                    fetch_range = fetcher.read_range
                    # Peer waterfall: try the extent's healthy region
                    # owner before the registry (daemon/peer.py); the
                    # origin fetcher stays the transparent fallback.
                    router = peer_mod.default_router()
                    if router is not None:
                        fetch_range = peer_mod.PeerAwareFetcher(
                            blob_id, fetch_range, router
                        ).read_range
                    cached = CachedBlob(
                        cache_dir,
                        blob_id,
                        fetch_range,
                        # Clamps readahead at the blob's end (the record's
                        # compressed_size IS the published data section).
                        blob_size=self.bootstrap.blobs[blob_index].compressed_size,
                        # QoS tenant: the image repository — per-image
                        # weighted fairness under a deploy storm.
                        tenant=getattr(cfg.backend, "repo", "") or "default",
                    )
                    self._cached_blobs.append(cached)
                    self._cached_by_index[blob_index] = cached
                    # Announce to the local peer chunk server: this node
                    # can now serve the extents it caches.
                    peer_mod.default_export().register(blob_id, cached)
                    read_at = cached.read_at
                else:
                    f = open(os.path.join(blob_dir, blob_id), "rb")
                    cache_dir = os.path.join(blob_dir, "cache")

                    def read_at(off: int, size: int, _f=f) -> bytes:
                        # pread is positional: no seek state, no lock, one
                        # syscall; _f in the closure keeps the fd alive.
                        return os.pread(_f.fileno(), size, off)

                reader = BlobReader(
                    self.bootstrap, blob_index, read_at,
                    batch_map=self._batch_map,
                )
                self._readers[blob_index] = reader
                soci_args = (blob_id, read_at, [cache_dir, blob_dir])
        if soci_args is not None:
            # Index store OFF the reader lock: resolving it may touch the
            # peer tier or (rebuild-once) the origin, and other blobs'
            # reads must not queue behind that. Reads racing ahead of the
            # mount use the sequential path — identical bytes, then the
            # checkpointed reader takes over.
            stream = self._soci_stream(blob_index, *soci_args)
            if stream is not None:
                reader.mount_gzip_stream(stream)
            else:
                zstream = self._zsoci_stream(blob_index, *soci_args)
                if zstream is not None:
                    reader.mount_zstd_stream(zstream)
        return reader

    def _soci_stream(self, blob_index: int, blob_id: str, read_at, dirs):
        """A checkpoint-indexed stream reader for a gzip-stream (soci /
        OCIRef) blob, when an index can be had: persisted locally by the
        first-pull build, replicated from the blob's peer-tier region
        owner, or — with the backend enabled — rebuilt once from the
        original bytes. Returns None when this blob has no gzip-stream
        chunks or no index is obtainable (BlobReader then falls back to
        the sequential in-process reader; correctness never depends on
        the index)."""
        from nydus_snapshotter_tpu_torch.converter.zran import CHUNK_FLAG_GZIP_STREAM

        if not any(
            rec.blob_index == blob_index and rec.flags & CHUNK_FLAG_GZIP_STREAM
            for rec in self.bootstrap.chunks
        ):
            return None
        from nydus_snapshotter_tpu_torch.daemon import peer as peer_mod
        from nydus_snapshotter_tpu_torch.soci import blob as soci_blob
        from nydus_snapshotter_tpu_torch.soci.index import index_path

        cfg = soci_blob.resolve_soci_config()
        csize = self.bootstrap.blobs[blob_index].compressed_size
        fetch_remote = None
        if cfg.enable and cfg.replicate:
            router = peer_mod.default_router()
            if router is not None:
                owner = router.route(blob_id, 0)
                if owner is not None:
                    fetch_remote = lambda: peer_mod.PeerClient(  # noqa: E731
                        owner
                    ).fetch_soci_index(blob_id)
        from nydus_snapshotter_tpu_torch.daemon import fetch_sched

        def build_pull():
            # Provenance: the whole-layer pull an index (re)build costs is
            # its own cause, not "demand" — the tag scope pins it onto
            # every flight the pull plans.
            with fetch_sched.fetch_tag("soci_index_build"):
                return read_at(0, csize)

        try:
            index, outcome = soci_blob.load_or_build_index(
                [d for d in dirs if d],
                blob_id,
                csize=csize,
                # Rebuild-once (evicted/corrupt index) only when the
                # backend is on: it costs one full pull of the original
                # blob, written through the chunk cache like any fetch.
                builder=(build_pull if cfg.enable and csize else None),
                fetch_remote=fetch_remote,
                stride=cfg.stride_bytes,
            )
        except Exception:  # noqa: BLE001 — incl. an armed soci.index
            # failpoint: a broken index STORE degrades this blob to the
            # sequential in-process reader; it must never fail reads.
            logger.warning("soci index store failed for %s; serving "
                           "sequentially", blob_id[:12], exc_info=True)
            return None
        if index is None:
            return None
        stream = soci_blob.SociStreamReader(index, read_at, name=blob_id[:8])
        self._soci_by_index[blob_index] = stream
        from nydus_snapshotter_tpu_torch import provenance

        provenance.set_blob_meta(blob_id, fmt="soci_gzip")
        # Announce the index itself to the peer tier: one pod's build
        # amortizes across the fleet.
        for d in dirs:
            if d and os.path.exists(index_path(d, blob_id)):
                peer_mod.default_export().register_soci(
                    blob_id, index_path(d, blob_id)
                )
                break
        logger.info("soci index for %s: %s (%d checkpoints)",
                    blob_id[:12], outcome, len(index.checkpoints))
        return stream

    def _zsoci_stream(self, blob_index: int, blob_id: str, read_at, dirs):
        """The zstd mirror of :meth:`_soci_stream`: a frame-indexed
        stream reader for a zstd-stream (OCIRef) blob. Same store
        waterfall — persisted ``.soci.zidx``, peer replication (generic
        artifact kind ``zsoci``), rebuild-once from the original bytes —
        and the same contract: returns None when no index is obtainable
        (BlobReader then uses the sequential zstd cursor; correctness
        never depends on the index)."""
        from nydus_snapshotter_tpu_torch.converter.zstd_ref import (
            CHUNK_FLAG_ZSTD_STREAM,
        )

        if not any(
            rec.blob_index == blob_index and rec.flags & CHUNK_FLAG_ZSTD_STREAM
            for rec in self.bootstrap.chunks
        ):
            return None
        from nydus_snapshotter_tpu_torch.daemon import peer as peer_mod
        from nydus_snapshotter_tpu_torch.soci import blob as soci_blob
        from nydus_snapshotter_tpu_torch.soci import zblob
        from nydus_snapshotter_tpu_torch.soci.zindex import zindex_path

        cfg = soci_blob.resolve_soci_config()
        csize = self.bootstrap.blobs[blob_index].compressed_size
        fetch_remote = None
        if cfg.enable and cfg.replicate:
            router = peer_mod.default_router()
            if router is not None:
                owner = router.route(blob_id, 0)
                if owner is not None:
                    fetch_remote = lambda: peer_mod.PeerClient(  # noqa: E731
                        owner
                    ).fetch_artifact(zblob.ZSOCI_ARTIFACT_KIND, blob_id)
        from nydus_snapshotter_tpu_torch.daemon import fetch_sched

        def build_pull():
            with fetch_sched.fetch_tag("soci_index_build"):
                return read_at(0, csize)

        try:
            index, outcome = zblob.load_or_build_zindex(
                [d for d in dirs if d],
                blob_id,
                csize=csize,
                builder=(build_pull if cfg.enable and csize else None),
                fetch_remote=fetch_remote,
            )
        except Exception:  # noqa: BLE001 — incl. an armed soci.index
            # failpoint: a broken index STORE degrades this blob to the
            # sequential in-process reader; it must never fail reads.
            logger.warning("zstd index store failed for %s; serving "
                           "sequentially", blob_id[:12], exc_info=True)
            return None
        if index is None:
            return None
        stream = zblob.ZstdStreamReader(index, read_at, name=blob_id[:8])
        self._soci_by_index[blob_index] = stream
        from nydus_snapshotter_tpu_torch import provenance

        provenance.set_blob_meta(blob_id, fmt="soci_zstd")
        # Announce the index to the peer tier under the generic artifact
        # plane: one pod's build amortizes across the fleet.
        for d in dirs:
            if d and os.path.exists(zindex_path(d, blob_id)):
                peer_mod.default_export().register_artifact(
                    zblob.ZSOCI_ARTIFACT_KIND, blob_id, zindex_path(d, blob_id)
                )
                break
        logger.info("zstd index for %s: %s (%d frames, %s)",
                    blob_id[:12], outcome, len(index.frames),
                    index.source_name)
        return stream

    def blob_dir(self, default_dir: str) -> str:
        cfg = self._parsed_config()
        if cfg is not None and cfg.backend.blob_dir:
            return cfg.backend.blob_dir
        return default_dir

    def prefetch(self, default_blob_dir: str, extra_paths: Optional[list] = None) -> int:
        """Warm the bootstrap's prefetch-table files (reference nydusd's
        --prefetch-files behavior) through the background replayer
        (daemon/fetch_sched.PrefetchReplayer): registry-backed blobs are
        warmed at the PREFETCH lane (below demand and readahead) so
        demand reads always win the worker pool and the admission gate,
        any other backend reads through the blob reader.
        Returns bytes warmed; cancelled by umount. Errors are contained
        per file (hints, not requirements), warming counts only into
        prefetch_data_amount — not the fs read metrics, which track
        client traffic."""
        from nydus_snapshotter_tpu_torch.daemon.fetch_sched import PrefetchReplayer

        blob_dir = self.blob_dir(default_blob_dir)
        heat_covered: set = set()

        def warm_chunk(rec) -> int:
            if rec.blob_index in heat_covered:
                # This blob was already warmed from its .heat artifact —
                # replaying its bootstrap chunks on top would re-warm
                # exactly the speculative bytes the heat loop exists to
                # avoid fetching.
                return 0
            from nydus_snapshotter_tpu_torch.converter.zran import (
                CHUNK_FLAG_GZIP_STREAM,
            )
            from nydus_snapshotter_tpu_torch.converter.zstd_ref import (
                CHUNK_FLAG_ZSTD_STREAM,
            )

            # Ensure the blob's reader (and CachedBlob, for registry
            # backends) exists; raises after close(), ending the replay.
            reader = self._reader(rec.blob_index, blob_dir)
            cached = self._cached_by_index.get(rec.blob_index)
            if cached is not None and rec.flags & (
                CHUNK_FLAG_GZIP_STREAM | CHUNK_FLAG_ZSTD_STREAM
            ):
                # Stream-addressed (soci/OCIRef) chunks — gzip or zstd —
                # address the DECOMPRESSED stream; warming those offsets
                # against the compressed blob would warm garbage.
                # Translate through the mounted index when one exists,
                # else warm through the reader (sequential, still
                # background-lane contained).
                soci = self._soci_by_index.get(rec.blob_index)
                if soci is not None:
                    c0, c1 = soci.resolve_compressed(
                        rec.uncompressed_offset, rec.uncompressed_size
                    )
                    rec_off, rec_size = c0, max(0, c1 - c0)
                else:
                    n = len(reader.chunk_data(rec))
                    self.prefetched_bytes += n
                    return n
            else:
                rec_off, rec_size = rec.compressed_offset, rec.compressed_size
            if cached is not None:
                flights = cached.warm(rec_off, rec_size)
                for f in flights:
                    while not f.wait(0.1):
                        if replayer.cancelled:
                            return 0
                if any(f.error is not None for f in flights):
                    return 0
                n = rec_size
            else:
                n = len(reader.chunk_data(rec))
            self.prefetched_bytes += n
            return n

        def flush_maps() -> None:
            with self._reader_lock:
                cached_blobs = list(self._cached_blobs)
            for c in cached_blobs:
                c.flush_map()

        replayer = PrefetchReplayer(
            self.bootstrap,
            self.by_path,
            warm_chunk,
            name=self.mountpoint,
            on_file=flush_maps,
        )
        self._replayer = replayer
        try:
            # Heat-closed-loop arm first: blobs with a .heat artifact are
            # warmed in observed-read order under the byte budget and
            # their bootstrap records drop out of the replay below.
            heat_covered.update(self._prefetch_via_heat(replayer, blob_dir))
            paths = list(self.bootstrap.prefetch) + list(extra_paths or ())
            # Index-mapped paths warm straight from the soci file→extent
            # table (and accrue into replayer.warmed_bytes); the replay
            # below handles whatever the index couldn't translate.
            paths = self._prefetch_via_soci_index(paths, replayer)
            return replayer.replay(paths)
        finally:
            flush_maps()
            self._replayer = None

    def _prefetch_via_heat(self, replayer, blob_dir: str) -> set:
        """The heat-closed-loop prefetch arm: a blob with a valid
        ``.heat`` artifact (compiled by a previous deploy's close here,
        or adopted from the blob's peer-tier region owner) is warmed in
        observed first-touch order under the ``[provenance]`` byte
        budget INSTEAD of walking its bootstrap chunk list — the second
        deploy prefetches only what the first one actually read.
        Returns the covered blob indexes (their bootstrap records are
        skipped by ``warm_chunk``). Heat is a hint: any failure here
        degrades to the bootstrap-order replay the daemon always had."""
        from nydus_snapshotter_tpu_torch import provenance
        from nydus_snapshotter_tpu_torch.daemon import fetch_sched, peer as peer_mod

        covered: set = set()
        cfg = provenance.config()
        if not (cfg.enable and cfg.heat):
            return covered
        budget = max(0, cfg.heat_budget_mib) << 20
        router = peer_mod.default_router()
        for blob_index in range(len(self.bootstrap.blobs)):
            if replayer.cancelled or budget <= 0:
                break
            try:
                self._reader(blob_index, blob_dir)
            except Exception:  # noqa: BLE001 — heat is advisory
                continue
            cached = self._cached_by_index.get(blob_index)
            if cached is None:
                continue
            blob_id = cached.blob_id
            cache_dir = os.path.dirname(cached.data_path)
            fetch_remote = None
            if cfg.replicate and router is not None:
                owner = router.route(blob_id, 0)
                if owner is not None:
                    fetch_remote = lambda _o=owner, _b=blob_id: (  # noqa: E731
                        peer_mod.PeerClient(_o).fetch_artifact(
                            provenance.ARTIFACT_KIND, _b
                        )
                    )
            art = provenance.load_or_adopt_heat(
                [cache_dir, blob_dir],
                blob_id,
                source_size=cached.blob_size,
                fetch_remote=fetch_remote,
            )
            if art is None or not art.extents:
                continue
            covered.add(blob_index)
            # Re-announce on the peer artifact plane (an adopted artifact
            # makes this node a serving replica too).
            if cfg.replicate:
                peer_mod.default_export().register_artifact(
                    provenance.ARTIFACT_KIND, blob_id,
                    provenance.heat_path(cache_dir, blob_id),
                )
            warmed = 0
            for off, size in art.extents:
                if replayer.cancelled:
                    return covered
                if budget <= 0:
                    break
                flights = cached.warm(off, size)
                for f in flights:
                    while not f.wait(0.1):
                        if replayer.cancelled:
                            return covered
                budget -= size
                if all(f.error is None for f in flights):
                    warmed += size
            if warmed:
                self.prefetched_bytes += warmed
                replayer.warmed_bytes += warmed
                replayer.files_replayed += 1
                fetch_sched.PREFETCH_BYTES.inc(warmed)
            logger.info(
                "heat prefetch for %s: %d extents, %d bytes warmed",
                blob_id[:12], len(art.extents), warmed,
            )
        return covered

    def _prefetch_via_soci_index(self, paths: list, replayer) -> list:
        """The soci index as a prefetch-trace source: paths the mounted
        checkpoint index maps are warmed straight from its file →
        extent table — ONE compressed range per file at PREFETCH lane,
        no per-chunk bootstrap walk — and dropped from the bootstrap
        replay. Paths the index doesn't know fall through unchanged
        (hints, not requirements; a failed warm is contained)."""
        if not self._soci_by_index or not paths:
            return paths
        from nydus_snapshotter_tpu_torch.soci import blob as soci_blob

        remaining = list(paths)
        with self._reader_lock:
            soci_streams = dict(self._soci_by_index)
        for blob_index, stream in soci_streams.items():
            cached = self._cached_by_index.get(blob_index)
            if cached is None:
                continue
            try:
                warms, remaining = soci_blob.warm_list_from_index(
                    stream.index, remaining
                )
            except Exception:  # noqa: BLE001 — a bad map is a bad hint
                logger.warning("soci prefetch-map translation failed",
                               exc_info=True)
                continue
            for _path, c0, c1 in warms:
                if replayer.cancelled:
                    return []
                try:
                    flights = cached.warm(c0, max(0, c1 - c0))
                    for f in flights:
                        while not f.wait(0.1):
                            if replayer.cancelled:
                                return []
                    if all(f.error is None for f in flights):
                        n = max(0, c1 - c0)
                        self.prefetched_bytes += n
                        replayer.warmed_bytes += n
                        from nydus_snapshotter_tpu_torch.daemon import fetch_sched

                        fetch_sched.PREFETCH_BYTES.inc(n)
                        replayer.files_replayed += 1
                except Exception:  # noqa: BLE001 — contained per file
                    logger.warning("soci prefetch warm failed", exc_info=True)
        return remaining

    def inflight_snapshot(self) -> list[dict]:
        with self._inflight_lock:
            return [dict(v) for v in self._inflight.values()]

    def read(self, path: str, offset: int, size: int, blob_dir: str) -> bytes:
        import time as time_mod

        with self._inflight_lock:
            self._inflight_seq += 1
            token = self._inflight_seq
            self._inflight[token] = {
                "opcode": "Read",
                "inode": path,
                "unique": token,
                "timestamp_secs": time_mod.time(),
            }
        try:
            # Root span in the daemon process: FUSE and API reads funnel
            # through here, and any blobcache fetch/readahead this read
            # triggers lands in its trace (exported on /api/v1/traces).
            with trace.span("nydusd.read", path=path, offset=offset, size=size):
                return self._read_locked_out(path, offset, size, blob_dir)
        finally:
            with self._inflight_lock:
                self._inflight.pop(token, None)

    def _read_locked_out(self, path: str, offset: int, size: int, blob_dir: str) -> bytes:
        inode = self.by_path.get(path)
        if inode is None:
            raise FileNotFoundError(path)
        if inode.hardlink_target:
            inode = self.by_path[inode.hardlink_target]
        if not stat_mod.S_ISREG(inode.mode):
            raise IsADirectoryError(path)
        out = bytearray()
        pos = 0
        end = min(offset + size, inode.size) if size >= 0 else inode.size
        for rec in self.bootstrap.chunks[
            inode.chunk_index : inode.chunk_index + inode.chunk_count
        ]:
            clen = rec.uncompressed_size
            if pos + clen <= offset:
                pos += clen
                continue
            if pos >= end:
                break
            data = self._reader(rec.blob_index, blob_dir).chunk_data(rec)
            lo = max(0, offset - pos)
            hi = min(clen, end - pos)
            out += data[lo:hi]
            pos += clen
        self.metrics.data_read += len(out)
        self.metrics.fop_hits["Read"] = self.metrics.fop_hits.get("Read", 0) + 1
        return bytes(out)


class DaemonServer:
    def __init__(
        self,
        daemon_id: str,
        apisock: str,
        supervisor: str = "",
        workdir: str = "",
        upgrade: bool = False,
    ):
        self.id = daemon_id
        self.apisock = apisock
        self.supervisor = supervisor
        self.workdir = workdir or os.getcwd()
        self.state = DaemonState.INIT
        self.instances: dict[str, _Instance] = {}
        self.bound_blobs: set[str] = set()
        self._blob_bind_configs: dict[str, dict] = {}
        # fscache_id -> metadata_path: survives same-blob re-binds (two
        # snapshots sharing a layer blob clobber _blob_bind_configs[id],
        # but each keeps its own fsid cookie here until ITS unbind)
        self._meta_binds: dict[str, str] = {}
        self._erofs_meta_cache: dict[str, bytes] = {}
        self._cachefiles = None  # CachefilesOndemandDaemon on capable kernels
        self._lock = threading.RLock()
        self._httpd: Optional[socketserver.ThreadingMixIn] = None
        self._started_in_upgrade = upgrade
        if not upgrade:
            # Normal boot: nothing to restore, become READY immediately.
            self.state = DaemonState.READY

    # -- state snapshot for failover/upgrade -------------------------------

    def snapshot_state(self) -> tuple[bytes, list[int]]:
        """(state JSON, live FUSE session fds). Each instance's ``fuse_fd``
        field is a 1-based index into the fd array that accompanies the
        state on the supervisor socket (slot 0 is the state memfd)."""
        with self._lock:
            fds: list[int] = []
            instances = []
            for i in self.instances.values():
                rec = {
                    "mountpoint": i.mountpoint,
                    "source": i.source,
                    "config": i.config_json,
                    "prefetched": i.prefetched_bytes,
                }
                if i.fuse is not None and i.fuse.fd >= 0:
                    fds.append(i.fuse.fd)
                    rec["fuse_fd"] = len(fds)  # 1-based: memfd occupies slot 0
                instances.append(rec)
            state = json.dumps({"id": self.id, "instances": instances}, sort_keys=True)
            return state.encode(), fds

    def restore_state(self, blob: bytes, fds: Optional[list[int]] = None) -> None:
        data = json.loads(blob)
        fds = fds or []
        with self._lock:
            for rec in data.get("instances", []):
                inst = _Instance(rec["mountpoint"], rec["source"], rec["config"])
                # Metric continuity across failover/upgrade: already-warmed
                # bytes stay reported (the successor does not re-prefetch).
                inst.prefetched_bytes = int(rec.get("prefetched", 0))
                self.instances[rec["mountpoint"]] = inst
                idx = rec.get("fuse_fd")
                if idx and 0 < idx < len(fds):
                    # Adopt the live kernel session: the mount survived the
                    # previous daemon, reads resume as soon as we attach.
                    inst.start_fuse(self.workdir, fd=fds[idx])
                elif idx:
                    # A recorded session fd that did not arrive means the
                    # kernel mount now has no reader — every access hangs.
                    # Loud beats silent; the operator must remount.
                    logger.error(
                        "takeover state references session fd %d for %s but "
                        "only %d fds arrived; kernel mount is orphaned",
                        idx, rec["mountpoint"], len(fds),
                    )
            self.state = DaemonState.READY

    # -- supervisor interaction (SCM_RIGHTS fd passing) ---------------------

    def send_states_to_supervisor(self, handoff: bool = False) -> None:
        """Push state + live session fds to the supervisor socket (reference
        supervisor.go:107-178 receiver side). ``handoff=True`` is the
        explicit sendfd API: after pushing, this daemon stops serving its
        FUSE sessions (keeping the mounts alive) so the successor that
        takes the fds over is the only reader."""
        if not self.supervisor:
            raise RuntimeError("daemon started without --supervisor")
        state, session_fds = self.snapshot_state()
        fd = os.memfd_create(f"nydus-session-{self.id}")
        try:
            os.write(fd, state)
            with socket.socket(socket.AF_UNIX, socket.SOCK_STREAM) as s:
                s.connect(self.supervisor)
                socket.send_fds(s, [state], [fd] + session_fds)
        finally:
            os.close(fd)
        if handoff:
            with self._lock:
                for inst in self.instances.values():
                    if inst.fuse is not None:
                        # Stop serving but leave the kernel mount alive for
                        # the successor; forget the session so a later
                        # close()/umount here can't tear the mount down
                        # under the new daemon.
                        inst.fuse.close(unmount=False)
                        inst.fuse = None

    def takeover_from_supervisor(self) -> None:
        """PUT .../takeover: pull state + fds back and restore mounts."""
        if not self.supervisor:
            raise RuntimeError("daemon started without --supervisor")
        with socket.socket(socket.AF_UNIX, socket.SOCK_STREAM) as s:
            s.connect(self.supervisor)
            # Announce we want the saved session back.
            s.sendall(b"TAKEOVER")
            # 253 = SCM_MAX_FD (kernel per-message ceiling); matches the
            # supervisor's receive cap so no session fd is ever truncated.
            msg, fds, _flags, _addr = socket.recv_fds(s, 1 << 20, 253)
        consumed: set[int] = set()
        try:
            state = msg
            if fds:
                size = os.fstat(fds[0]).st_size
                os.lseek(fds[0], 0, os.SEEK_SET)
                state = os.read(fds[0], size)
                consumed.add(0)
            self.restore_state(state, fds)
            for inst in self.instances.values():
                if inst.fuse is not None:
                    consumed.add(fds.index(inst.fuse.fd))
        finally:
            for i, fd in enumerate(fds):
                if i not in consumed:
                    try:
                        os.close(fd)
                    except OSError:
                        pass

    # -- http server --------------------------------------------------------

    def serve_forever(self) -> None:
        os.makedirs(os.path.dirname(self.apisock) or ".", exist_ok=True)
        if os.path.exists(self.apisock):
            os.unlink(self.apisock)
        daemon = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, *a):  # quiet
                pass

            def _reply(self, code: int, obj: Any = None) -> None:
                body = b"" if obj is None else json.dumps(obj).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                if body:
                    self.wfile.write(body)

            def _reply_raw(self, code: int, body: bytes) -> None:
                self.send_response(code)
                self.send_header("Content-Type", "application/octet-stream")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def _body(self) -> bytes:
                n = int(self.headers.get("Content-Length") or 0)
                return self.rfile.read(n) if n else b""

            def do_GET(self):
                u = urllib.parse.urlparse(self.path)
                q = urllib.parse.parse_qs(u.query)
                if u.path == "/api/v1/daemon":
                    self._reply(200, daemon.info())
                elif u.path == "/api/v1/metrics":
                    mp = q.get("id", [""])[0]
                    self._reply(200, daemon.fs_metrics(mp))
                elif u.path == "/api/v1/metrics/blobcache":
                    from nydus_snapshotter_tpu_torch.daemon import fetch_sched
                    from nydus_snapshotter_tpu_torch.soci import blob as soci_blob

                    with daemon._lock:
                        amount = sum(
                            i.prefetched_bytes for i in daemon.instances.values()
                        )
                    body = {"prefetch_data_amount": amount}
                    body.update(fetch_sched.snapshot_counters())
                    body["soci"] = soci_blob.snapshot_counters()
                    from nydus_snapshotter_tpu_torch.soci import router as soci_router
                    from nydus_snapshotter_tpu_torch.soci import zblob as soci_zblob

                    body["soci"]["zindex_frames"] = (
                        soci_zblob.ZINDEX_FRAMES.value()
                    )
                    routes = soci_router.route_counts()
                    if routes:
                        body["soci"]["routes"] = routes
                    # Metrics → traces link: the last root trace ids whose
                    # duration exceeded the rolling p95 (fetch them from
                    # /api/v1/traces or /debug/pprof/trace).
                    body["trace_exemplars"] = trace.exemplars()
                    self._reply(200, body)
                elif u.path == "/api/v1/traces":
                    self._reply(200, trace.chrome_trace())
                elif u.path == "/api/v1/provenance":
                    # Byte-provenance accounting (provenance/ledger.py):
                    # ?blob= narrows to one blob, ?waterfall=1 returns the
                    # time-ordered cause breakdown joined to trace ids.
                    from nydus_snapshotter_tpu_torch import provenance

                    blob = q.get("blob", [""])[0]
                    if q.get("waterfall", ["0"])[0] not in ("", "0"):
                        limit = int(q.get("limit", ["0"])[0] or 0)
                        self._reply(
                            200,
                            {
                                "waterfall": provenance.waterfall(
                                    blob, limit=limit
                                ),
                                "heat": provenance.heat_counters(),
                            },
                        )
                    elif blob:
                        view = provenance.blob_snapshot(blob)
                        if view is None:
                            self._reply(404, {"error": f"no ledger for {blob}"})
                        else:
                            view["conservation"] = provenance.conservation(blob)
                            self._reply(200, view)
                    else:
                        body = provenance.snapshot()
                        body["heat"] = provenance.heat_counters()
                        self._reply(200, body)
                elif u.path in ("/metrics", "/v1/metrics"):
                    # Prometheus text exposition of this daemon process's
                    # registry — the fleet federator's per-member scrape
                    # target (metrics/federation.py).
                    from nydus_snapshotter_tpu_torch.metrics.registry import (
                        default_registry,
                    )

                    body = default_registry.render().encode()
                    self.send_response(200)
                    self.send_header("Content-Type", "text/plain; version=0.0.4")
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)
                elif u.path == "/api/v1/metrics/inflight":
                    with daemon._lock:
                        instances = list(daemon.instances.values())
                    ops = [
                        op for inst in instances for op in inst.inflight_snapshot()
                    ]
                    self._reply(200, ops)
                elif u.path == "/api/v1/fs":
                    try:
                        self._handle_fs(q)
                    except (FileNotFoundError, KeyError) as e:
                        self._reply(404, {"error": str(e)})
                    except IsADirectoryError as e:
                        self._reply(400, {"error": f"not a regular file: {e}"})
                else:
                    self._reply(404, {"error": f"no route {u.path}"})

            def _handle_fs(self, q):
                mp = q.get("mountpoint", [""])[0]
                op = q.get("op", ["stat"])[0]
                path = q.get("path", ["/"])[0]
                inst = daemon.instance(mp)
                if op == "read":
                    offset = int(q.get("offset", ["0"])[0])
                    size = int(q.get("size", ["-1"])[0])
                    data = inst.read(path, offset, size, inst.blob_dir(daemon.workdir))
                    self._reply_raw(200, data)
                elif op == "stat":
                    inode = inst.by_path.get(path)
                    if inode is None:
                        raise FileNotFoundError(path)
                    self._reply(
                        200,
                        {
                            "path": inode.path,
                            "mode": inode.mode,
                            "size": inode.size,
                            "uid": inode.uid,
                            "gid": inode.gid,
                            "symlink": inode.symlink_target,
                            "hardlink": inode.hardlink_target,
                        },
                    )
                elif op == "list":
                    prefix = path.rstrip("/") + "/" if path != "/" else "/"
                    names = sorted(
                        p[len(prefix) :]
                        for p in inst.by_path
                        if p.startswith(prefix) and p != "/" and "/" not in p[len(prefix) :]
                        and p != path
                    )
                    self._reply(200, names)
                else:
                    self._reply(400, {"error": f"bad op {op}"})

            def do_POST(self):
                u = urllib.parse.urlparse(self.path)
                q = urllib.parse.parse_qs(u.query)
                if u.path == "/api/v1/mount":
                    mp = q.get("mountpoint", [""])[0]
                    body = json.loads(self._body() or b"{}")
                    try:
                        daemon.mount(mp, body.get("source", ""), body.get("config", ""))
                        self._reply(204)
                    except FileExistsError:
                        self._reply(409, {"error": f"{mp} already mounted"})
                    except Exception as e:
                        self._reply(400, {"error": str(e)})
                else:
                    self._reply(404, {"error": f"no route {u.path}"})

            def do_PUT(self):
                u = urllib.parse.urlparse(self.path)
                if u.path == "/api/v1/daemon/start":
                    daemon.start()
                    self._reply(204)
                elif u.path == "/api/v1/daemon/exit":
                    self._reply(204)
                    threading.Thread(target=daemon.shutdown, daemon=True).start()
                elif u.path in ("/api/v1/daemon/fuse/sendfd", "/api/v1/daemon/fscache/sendfd"):
                    try:
                        # Explicit sendfd = upgrade/failover handoff: stop
                        # serving the sessions after passing them on.
                        daemon.send_states_to_supervisor(handoff=True)
                        self._reply(204)
                    except Exception as e:
                        self._reply(500, {"error": str(e)})
                elif u.path in ("/api/v1/daemon/fuse/takeover", "/api/v1/daemon/fscache/takeover"):
                    try:
                        daemon.takeover_from_supervisor()
                        self._reply(204)
                    except Exception as e:
                        self._reply(500, {"error": str(e)})
                elif u.path == "/api/v2/blobs":
                    try:
                        body = json.loads(self._body() or b"{}")
                        daemon.bind_blob(body.get("config", ""))
                        self._reply(204)
                    except Exception as e:
                        self._reply(400, {"error": str(e)})
                else:
                    self._reply(404, {"error": f"no route {u.path}"})

            def do_DELETE(self):
                u = urllib.parse.urlparse(self.path)
                q = urllib.parse.parse_qs(u.query)
                if u.path == "/api/v1/mount":
                    mp = q.get("mountpoint", [""])[0]
                    try:
                        daemon.umount(mp)
                        self._reply(204)
                    except KeyError:
                        self._reply(404, {"error": f"{mp} not mounted"})
                elif u.path == "/api/v2/blobs":
                    daemon.unbind_blob(
                        q.get("domain_id", [""])[0], q.get("blob_id", [""])[0]
                    )
                    self._reply(204)
                else:
                    self._reply(404, {"error": f"no route {u.path}"})

        class Server(socketserver.ThreadingMixIn, socketserver.UnixStreamServer):
            daemon_threads = True
            allow_reuse_address = True
            # socketserver's default backlog of 5 overflows under connect
            # storms (many snapshots mounting at once): excess UDS connects
            # fail with EAGAIN instead of queueing.
            request_queue_size = 128

            # BaseHTTPRequestHandler expects a (host, port) client address.
            def get_request(self):
                request, _ = super().get_request()
                return request, ("uds", 0)

        self._httpd = Server(self.apisock, Handler)
        self._httpd.serve_forever(poll_interval=0.1)

    # -- operations ---------------------------------------------------------

    def info(self) -> dict[str, Any]:
        return {
            "id": self.id,
            "version": {"package_ver": __version__, "git_commit": ""},
            "state": self.state.value,
            "backend_collection": {},
            "supervisor": self.supervisor,
            "pid": os.getpid(),
        }

    def instance(self, mountpoint: str) -> _Instance:
        with self._lock:
            inst = self.instances.get(mountpoint)
        if inst is None:
            raise KeyError(f"no instance mounted at {mountpoint}")
        return inst

    def mount(self, mountpoint: str, source: str, config: str) -> None:
        if not mountpoint:
            raise ValueError("mountpoint required")
        with self._lock:
            if self.state not in (DaemonState.READY, DaemonState.RUNNING):
                raise RuntimeError(f"daemon in state {self.state}, cannot mount")
            if mountpoint in self.instances:
                raise FileExistsError(mountpoint)
            inst = _Instance(mountpoint, source, config)
            self.instances[mountpoint] = inst
            # Kernel mount when the environment allows it; API-only
            # otherwise. Under the lock: a concurrent umount() popping the
            # half-mounted instance would otherwise leave an orphaned kernel
            # mount no API call can ever tear down. (mount(2) itself is
            # fast; FUSE INIT is answered async by the serve thread.)
            try:
                inst.start_fuse(self.workdir)
            except Exception:
                self.instances.pop(mountpoint, None)
                raise
        if inst.bootstrap.prefetch:
            threading.Thread(
                target=inst.prefetch, args=(self.workdir,),
                name=f"prefetch:{mountpoint}", daemon=True,
            ).start()
        self._push_state_async()

    def umount(self, mountpoint: str) -> None:
        with self._lock:
            inst = self.instances.pop(mountpoint)
        inst.close()
        self._push_state_async()

    # -- fscache v2 blobs (reference nydusd /api/v2/blobs) -------------------

    def bind_blob(self, daemon_config: str) -> None:
        with self._lock:
            try:
                cfg = json.loads(daemon_config or "{}")
            except ValueError:
                cfg = {}
            blob_id = cfg.get("id", "")
            if blob_id:
                self.bound_blobs.add(blob_id)
                self._blob_bind_configs[blob_id] = cfg
                if cfg.get("fscache_id") and cfg.get("metadata_path"):
                    self._meta_binds[cfg["fscache_id"]] = cfg["metadata_path"]
                self._ensure_cachefiles()

    def unbind_blob(self, domain_id: str, blob_id: str) -> None:
        with self._lock:
            self.bound_blobs.discard(blob_id)
            self._blob_bind_configs.pop(blob_id, None)
            # domain_id is the mount's fsid (daemon.py passes
            # erofs_fscache_id): drop exactly this mount's meta cookie and
            # its rendered image — other snapshots' binds stay live
            path = self._meta_binds.pop(domain_id, None)
            if path is not None and path not in self._meta_binds.values():
                self._erofs_meta_cache.pop(path, None)

    # -- cachefiles ondemand (the in-kernel erofs-over-fscache data path) ----

    def _ensure_cachefiles(self) -> None:
        """Start the cachefiles ondemand daemon on first blob bind, where
        the kernel has the device (daemon/cachefiles.py; the build
        environment never does — PARITY.md environmental limit #3). Bound
        blobs become resolvable cookies so `mount -t erofs -o fsid=`
        pages through this process exactly like the reference's nydusd
        fscache mode (daemon.go:275-324)."""
        from nydus_snapshotter_tpu_torch.daemon import cachefiles

        if self._cachefiles is not None or not cachefiles.supported():
            return
        try:
            d = cachefiles.CachefilesOndemandDaemon(
                self._resolve_cachefiles_cookie,
                cache_dir=os.path.join(self.workdir, "cachefiles"),
                tag=f"ntpu-{self.id}",
            )
            d.bind()
            d.start()
            self._cachefiles = d
        except Exception:
            logger.exception("cachefiles ondemand bind failed; fscache "
                             "mounts will not be served by this daemon")

    def _resolve_cachefiles_cookie(self, cookie_key: str):
        """(size, reader, closer) for a bound blob's bytes; KeyError when
        the cookie was never bound. Runs once per kernel OPEN (the
        ondemand daemon caches the result on the object, so the fd lives
        exactly as long as the kernel's cache object); the blob file is
        looked up in the bind config's backend dir, then the workdir."""
        with self._lock:
            cfg = self._blob_bind_configs.get(cookie_key)
            meta_path = None
            if cfg is None:
                # the EROFS meta cookie: the fsid mount's first open —
                # rendered from the bind's metadata_path bootstrap
                meta_path = self._meta_binds.get(cookie_key)
                if meta_path is None:
                    raise KeyError(cookie_key)
            else:
                backend = (cfg.get("device") or {}).get("backend") or {}
                bcfg = backend.get("config") or {}
                candidates = [
                    os.path.join(d, cookie_key)
                    for d in (bcfg.get("blob_dir"), bcfg.get("dir"), self.workdir)
                    if d
                ]
        if meta_path is not None:
            # render OUTSIDE the lock: building a large image under
            # self._lock would stall every concurrent API operation
            meta = self._erofs_meta_bytes(meta_path)
            return (len(meta), lambda off, ln, _m=meta: _m[off : off + ln], None)
        for path in candidates:
            if os.path.exists(path):
                size = os.path.getsize(path)
                fd = os.open(path, os.O_RDONLY)
                return (
                    size,
                    lambda off, ln, _fd=fd: os.pread(_fd, ln, off),
                    lambda _fd=fd: os.close(_fd),
                )
        raise KeyError(cookie_key)

    def _erofs_meta_bytes(self, bootstrap_path: str) -> bytes:
        """Kernel-mountable EROFS meta image rendered from a bootstrap
        (internal or real layout), cached per path — the bytes the fsid
        mount's metadata cookie reads. The render runs outside the lock;
        the image is cached only while a bind still names the path, so an
        open that races ``unbind_blob`` cannot keep an unbound image."""
        meta = self._erofs_meta_cache.get(bootstrap_path)
        if meta is None:
            from nydus_snapshotter_tpu_torch.models.erofs_image import erofs_from_rafs
            from nydus_snapshotter_tpu_torch.models.nydus_real import load_any_bootstrap

            with open(bootstrap_path, "rb") as f:
                meta = erofs_from_rafs(load_any_bootstrap(f.read()))
            with self._lock:
                if bootstrap_path in self._meta_binds.values():
                    self._erofs_meta_cache[bootstrap_path] = meta
        return meta

    def _push_state_async(self) -> None:
        """Keep the supervisor's saved session current after every mount
        change, so a SIGKILL'd daemon can still be failed over (the
        reference nydusd continuously syncs state to --supervisor)."""
        if not self.supervisor:
            return

        def push():
            try:
                self.send_states_to_supervisor()
            except OSError:
                pass  # supervisor not up yet; next change retries

        threading.Thread(target=push, daemon=True).start()

    def start(self) -> None:
        with self._lock:
            self.state = DaemonState.RUNNING

    def fs_metrics(self, mountpoint: str) -> dict[str, Any]:
        with self._lock:
            if mountpoint and mountpoint in self.instances:
                return self.instances[mountpoint].metrics.to_dict()
            total = FsMetrics()
            for inst in self.instances.values():
                total.data_read += inst.metrics.data_read
                for k, v in inst.metrics.fop_hits.items():
                    total.fop_hits[k] = total.fop_hits.get(k, 0) + v
            return total.to_dict()

    def shutdown(self) -> None:
        with self._lock:
            self.state = DaemonState.DESTROYED
            instances = list(self.instances.values())
        # Graceful exit tears down kernel mounts this daemon still serves
        # (handed-off sessions were already forgotten and stay alive).
        for inst in instances:
            inst.close(unmount=True)
        if self._cachefiles is not None:
            self._cachefiles.stop()
            self._cachefiles = None
        if self._httpd is not None:
            self._httpd.shutdown()


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="nydus-tpu-daemon")
    p.add_argument("--id", required=True)
    p.add_argument("--apisock", required=True)
    p.add_argument("--supervisor", default="")
    p.add_argument("--workdir", default="")
    p.add_argument("--upgrade", action="store_true")
    p.add_argument("--log-file", default="")
    args = p.parse_args(argv)

    if args.log_file:
        sys.stderr = sys.stdout = open(args.log_file, "a", buffering=1)

    server = DaemonServer(
        args.id,
        args.apisock,
        supervisor=args.supervisor,
        workdir=args.workdir,
        upgrade=args.upgrade,
    )
    # Peer chunk tier: the daemon process reaches the [peer] section via
    # the NTPU_PEER* environment (like every blobcache knob); when it
    # names a listen address, this daemon serves its cached extents to
    # cluster peers (daemon/peer.py).
    # Fleet plane: when NTPU_FLEET_CONTROLLER names the controller UDS
    # (exported by cmd/snapshotter.py when [fleet] is on), this daemon
    # self-registers so the controller scrapes its metrics and pulls its
    # trace ring into the cluster-merged view (fleet/__init__.py).
    # Registered BEFORE the peer server starts: one process is one
    # member, and the daemon role (full API surface) must win the slot.
    from nydus_snapshotter_tpu_torch import fleet

    fleet.register_self("daemon", args.apisock, name=args.id)
    from nydus_snapshotter_tpu_torch.daemon import peer as peer_mod

    peer_mod.start_from_config()
    # SLO actuation follower: when the controller actuates (sheds QoS
    # lanes on burn-rate breach, [slo] actuate + follow), this daemon
    # applies the published lane state to its OWN shared admission gate,
    # so actuation reaches the processes actually moving bytes.
    from nydus_snapshotter_tpu_torch.metrics import slo as slo_mod

    slo_follower = None
    _controller = os.environ.get("NTPU_FLEET_CONTROLLER", "")
    if _controller and slo_mod.resolve_slo_actuation()[0] and os.environ.get(
        "NTPU_SLO_FOLLOW", "1"
    ) not in ("0", "off", "false"):
        slo_follower = slo_mod.SloActuationFollower(_controller)
        slo_follower.start()
    # shutdown() must not run on the main (serve_forever) thread: the signal
    # handler interrupts serve_forever's select, and BaseServer.shutdown()
    # then waits for a loop exit that can never happen — deadlock, daemon
    # survives SIGTERM. Hand it to a helper thread instead.
    signal.signal(
        signal.SIGTERM,
        lambda *_: threading.Thread(target=server.shutdown, daemon=True).start(),
    )
    try:
        server.serve_forever()
    finally:
        if slo_follower is not None:
            slo_follower.stop()
        fleet.deregister_self()
        peer_mod.stop_default()
        try:
            os.unlink(args.apisock)
        except OSError:
            pass
    return 0


if __name__ == "__main__":
    sys.exit(main())
