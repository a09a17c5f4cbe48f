"""Runtime half of the zstd lazy-read plane: frame-indexed reads.

The zstd mirror of :mod:`~nydus_snapshotter_tpu_torch.soci.blob`, sharing its
metrics, failpoints and store discipline so operators see ONE soci plane
regardless of layer compression:

- :func:`build_zindex_from_zstd` is index-on-first-pull: one sequential
  pass (``zframe.build``) over the original layer yields the frame table
  AND the decompressed tar, so the layer bootstrap builds from the same
  pass. When the blob ships a seekable-format seek table the pass trusts
  its geometry (verifying every decoded size) and records the cheaper
  provenance.
- :func:`load_or_build_zindex` is the same waterfall as the gzip index:
  local cache dirs → peer replication (kind ``"zsoci"`` on the generic
  artifact plane) → rebuild once. A corrupt ``.soci.zidx`` is deleted
  and rebuilt; it can never poison reads.
- :class:`ZstdStreamReader` is what ``BlobReader`` mounts for a
  zstd-stream blob: ``read_range`` resolves a decompressed extent to its
  covering frames and pulls exactly those frames' compressed bytes
  through the caller-supplied compressed-domain reader (a
  ``CachedBlob.read_at`` in the deployed stack — singleflight,
  coalescing, readahead, peer tier and QoS all apply untouched). Frames
  decode on pooled contexts: concurrent reads need no shared lock.

Failpoints are the soci set (``soci.index`` / ``soci.resolve`` /
``soci.fetch``) — chaos drills that degrade the gzip path degrade this
one identically.
"""

from __future__ import annotations

import logging
import os
from time import perf_counter
from typing import Callable, Optional, Sequence

from nydus_snapshotter_tpu_torch import failpoint, trace
from nydus_snapshotter_tpu_torch.metrics import registry as _metrics
from nydus_snapshotter_tpu_torch.soci import zframe
from nydus_snapshotter_tpu_torch.soci.blob import (
    FETCH_BYTES,
    INDEX_BYTES,
    INDEX_EVENTS,
    OP_MS,
    READ_BYTES,
    file_extents,
)
from nydus_snapshotter_tpu_torch.soci.index import SociIndexError
from nydus_snapshotter_tpu_torch.soci.zindex import (
    SOURCE_FRAME_WALK,
    SOURCE_SEEK_TABLE,
    ZstdFrameIndex,
    ZstdIndexError,
    zindex_path,
)

logger = logging.getLogger(__name__)

# Peer artifact kind for replicated zstd frame indexes (the generic
# artifact plane's analog of the first-class soci route).
ZSOCI_ARTIFACT_KIND = "zsoci"

_reg = _metrics.default_registry
ZINDEX_FRAMES = _reg.register(
    _metrics.Counter(
        "ntpu_soci_zindex_frames_total",
        "zstd frame-table entries captured by zstd index builds",
    )
)


# ---------------------------------------------------------------------------
# Index building
# ---------------------------------------------------------------------------


def build_zindex_from_zstd(
    blob_id: str,
    raw: bytes,
    entries: Optional[list[zframe.FrameEntry]] = None,
) -> tuple[ZstdFrameIndex, bytes]:
    """One sequential pass over the original zstd layer → ``(index, tar
    bytes)``. ``entries`` — a parsed seek table — upgrades the pass from
    frame-walking to table-verified decode and stamps the cheaper
    provenance; either way the decompressed output feeds the bootstrap
    build so the layer is inflated exactly once."""
    failpoint.hit("soci.index")
    t0 = perf_counter()
    source = SOURCE_FRAME_WALK
    with trace.span("soci.zindex.build", blob=blob_id[:8], bytes=len(raw)):
        if entries is None:
            try:
                entries = zframe.read_seek_table(
                    lambda o, n: raw[o : o + n], len(raw)
                )
            except zframe.ZstdFrameError as e:
                # A broken seek table demotes to the walk, never to failure.
                logger.warning("ignoring bad zstd seek table for %s: %s",
                               blob_id[:12], e)
                entries = None
        if entries is not None:
            source = SOURCE_SEEK_TABLE
        frames, tar_bytes = zframe.build(raw, entries)
        index = ZstdFrameIndex(
            blob_id=blob_id,
            compressed_size=len(raw),
            uncompressed_size=len(tar_bytes),
            source=source,
            frames=frames,
            files=file_extents(tar_bytes),
        )
    ZINDEX_FRAMES.inc(len(frames))
    OP_MS.labels("build").observe((perf_counter() - t0) * 1000.0)
    return index, tar_bytes


# ---------------------------------------------------------------------------
# Index store: local → peer → rebuild-once (the gzip waterfall, verbatim)
# ---------------------------------------------------------------------------


def find_zindex(
    dirs: Sequence[str], blob_id: str, csize: int = 0
) -> tuple[Optional[ZstdFrameIndex], int]:
    """``(first loadable zstd index for blob_id in dirs, discarded
    count)``; corrupt or stale artifacts warn, count an error, are
    unlinked, and the search continues."""
    discarded = 0
    for d in dirs:
        if not d:
            continue
        path = zindex_path(d, blob_id)
        if not os.path.exists(path):
            continue
        try:
            return (
                ZstdFrameIndex.load(path, blob_id=blob_id, csize=csize),
                discarded,
            )
        except SociIndexError as e:
            INDEX_EVENTS.labels("error").inc()
            logger.warning("discarding bad zstd index %s: %s", path, e)
            discarded += 1
            try:
                os.unlink(path)
            except OSError:
                pass
    return None, discarded


def load_or_build_zindex(
    dirs: Sequence[str],
    blob_id: str,
    csize: int = 0,
    builder: Optional[Callable[[], bytes]] = None,
    fetch_remote: Optional[Callable[[], bytes]] = None,
    persist: bool = True,
) -> tuple[Optional[ZstdFrameIndex], str]:
    """Local cache dirs → peer replication → one local rebuild. Returns
    ``(index, outcome)``; ``(None, ...)`` means the caller falls back to
    full pull + convert — NEVER to wrong bytes. ``builder()`` returns
    the original compressed layer; ``fetch_remote()`` returns serialized
    index bytes from a peer, revalidated by checksum before adoption."""
    failpoint.hit("soci.index")
    try:
        idx, discarded = find_zindex(dirs, blob_id, csize=csize)
    except Exception:  # noqa: BLE001 — the store degrades, reads survive
        logger.warning("zstd index search failed for %s", blob_id[:12],
                       exc_info=True)
        idx, discarded = None, 1
    if idx is not None:
        INDEX_EVENTS.labels("loaded").inc()
        return idx, "loaded"

    if fetch_remote is not None:
        try:
            raw = fetch_remote()
            idx = ZstdFrameIndex.from_bytes(raw, blob_id=blob_id, csize=csize)
        except Exception as e:  # noqa: BLE001 — replication is an
            # optimization; any failure walks on to the local build
            logger.warning("zstd index replication for %s failed: %s",
                           blob_id[:12], e)
            idx = None
        if idx is not None:
            INDEX_EVENTS.labels("replicated").inc()
            if persist and dirs and dirs[0]:
                try:
                    INDEX_BYTES.inc(idx.save(zindex_path(dirs[0], blob_id)))
                except OSError:
                    logger.warning("cannot persist replicated zstd index",
                                   exc_info=True)
            return idx, "replicated"

    if builder is None:
        return None, "missing"
    try:
        raw_zstd = builder()
        idx, _ = build_zindex_from_zstd(blob_id, raw_zstd)
    except Exception as e:  # noqa: BLE001 — a failed build degrades to
        # full pull + convert, never to a broken reader
        INDEX_EVENTS.labels("error").inc()
        logger.warning("zstd index build for %s failed: %s", blob_id[:12], e)
        return None, "error"
    outcome = "rebuilt" if discarded else "built"
    INDEX_EVENTS.labels(outcome).inc()
    if persist and dirs and dirs[0]:
        try:
            INDEX_BYTES.inc(idx.save(zindex_path(dirs[0], blob_id)))
        except OSError:
            logger.warning("cannot persist zstd index", exc_info=True)
    return idx, outcome


# ---------------------------------------------------------------------------
# The reader BlobReader mounts
# ---------------------------------------------------------------------------


class ZstdStreamReader:
    """Decompressed-domain random access over a frame-indexed zstd blob.

    Interface-compatible with :class:`~nydus_snapshotter_tpu_torch.soci.blob.
    SociStreamReader` (``read_range`` / ``resolve_compressed`` /
    ``concurrent``); cold cost is bounded by the largest covering frame,
    and every read decodes on its own pooled context — no shared lock.
    """

    concurrent = True

    def __init__(
        self,
        index: ZstdFrameIndex,
        read_comp: Callable[[int, int], bytes],
        name: str = "",
    ):
        self.index = index
        self._read_comp = read_comp
        self.name = name or index.blob_id[:8]

    def read_range(self, offset: int, size: int) -> bytes:
        if size <= 0:
            return b""
        if offset + size > self.index.uncompressed_size:
            raise ZstdIndexError(
                f"read [{offset}, +{size}) beyond decompressed end "
                f"{self.index.uncompressed_size}"
            )
        t0 = perf_counter()
        failpoint.hit("soci.resolve")
        frames, comp_start, _comp_end = self.index.resolve(offset, size)
        with trace.span(
            "soci.read",
            blob=self.name,
            offset=offset,
            bytes=size,
            checkpoint=frames[0].uout if frames else 0,
        ) as sp:
            fetched = 0

            def pull(pos: int, n: int) -> bytes:
                nonlocal fetched
                failpoint.hit("soci.fetch")
                data = self._read_comp(pos, n)
                fetched += len(data)
                return data

            try:
                out = zframe.extract(
                    pull, self.index.compressed_size, frames, offset, size
                )
            except zframe.ZstdFrameError as e:
                raise ZstdIndexError(str(e)) from e
            sp.annotate(compressed_bytes=fetched)
        READ_BYTES.inc(size)
        FETCH_BYTES.inc(fetched)
        OP_MS.labels("read").observe((perf_counter() - t0) * 1000.0)
        return out

    def resolve_compressed(self, offset: int, size: int) -> tuple[int, int]:
        """Compressed ``[start, end)`` a decompressed extent needs — what
        the prefetch replayer warms (see ``SociStreamReader``)."""
        _, comp_start, comp_end = self.index.resolve(offset, size)
        return comp_start, comp_end
