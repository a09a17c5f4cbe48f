"""Runtime half of the soci backend: checkpoint-indexed lazy reads.

:class:`SociStreamReader` is what the daemon's
:class:`~nydus_snapshotter_tpu_torch.converter.convert.BlobReader` mounts for a
gzip-stream blob when a persisted index exists: ``read_range`` resolves a
decompressed extent to its compressed byte range through the index
geometry, pulls exactly those bytes through the caller-supplied
compressed-domain reader — a registry-backed
blob cache's ``read_at`` in the deployed stack, so singleflight, coalescing, readahead, watermark
eviction, the peer tier and QoS admission all apply untouched — and
inflates from the nearest checkpoint. Unlike the in-process
``GzipStreamReader`` it replaces, every call owns its own inflate state:
concurrent chunk reads proceed without a shared lock, and cold cost is
O(stride), not O(offset), in ANY process.

The index store (:func:`load_or_build_index`) implements the
first-pull amortization contract: local load (checksummed — a corrupt,
torn or stale artifact fails loudly and is deleted) → peer-tier
replication (one pod's first-pull build serves the fleet; replicated
bytes revalidate through the same checksum) → rebuild-once from the
original blob. A bad index can cost one rebuild; it can never poison
reads.

Failpoints: ``soci.index`` (store boundary), ``soci.resolve``
(read→range geometry), ``soci.fetch`` (compressed-range pull for a lazy
read). Metrics: ``ntpu_soci_*``. Config: ``[soci]`` with ``NTPU_SOCI*``
env overrides (the env is also how the section reaches spawned daemon
processes, like every blobcache knob).
"""

from __future__ import annotations

import io
import logging
import os
import tarfile
from time import perf_counter
from typing import Callable, Optional, Sequence

from nydus_snapshotter_tpu_torch import failpoint, trace
from nydus_snapshotter_tpu_torch.metrics import registry as _metrics
from nydus_snapshotter_tpu_torch.soci import zran
from nydus_snapshotter_tpu_torch.soci.index import (
    SociIndex,
    SociIndexError,
    index_path,
)

logger = logging.getLogger(__name__)

DEFAULT_STRIDE_KIB = 1024
MIN_STRIDE_KIB = 64

_reg = _metrics.default_registry
INDEX_EVENTS = _reg.register(
    _metrics.Counter(
        "ntpu_soci_index_events_total",
        "Seekable-OCI index store outcomes (loaded / built / rebuilt /"
        " replicated / error)",
        ("outcome",),
    )
)
INDEX_BYTES = _reg.register(
    _metrics.Counter(
        "ntpu_soci_index_bytes_total",
        "Bytes of persisted seekable-OCI index artifacts written",
    )
)
INDEX_CHECKPOINTS = _reg.register(
    _metrics.Counter(
        "ntpu_soci_index_checkpoints_total",
        "zran inflate checkpoints captured by index builds",
    )
)
READ_BYTES = _reg.register(
    _metrics.Counter(
        "ntpu_soci_read_bytes_total",
        "Decompressed bytes served by checkpoint-indexed lazy reads",
    )
)
FETCH_BYTES = _reg.register(
    _metrics.Counter(
        "ntpu_soci_compressed_fetch_bytes_total",
        "Compressed bytes pulled to satisfy checkpoint-indexed reads"
        " (amplification numerator vs ntpu_soci_read_bytes_total)",
    )
)
OP_MS = _reg.register(
    _metrics.Histogram(
        "ntpu_soci_op_duration_milliseconds",
        "Latency of seekable-OCI operations (index build / lazy read)",
        ("op",),
    )
)


def snapshot_counters() -> dict:
    """Cumulative ``ntpu_soci_*`` values (tools delta these around runs)."""
    return {
        "index_loaded": INDEX_EVENTS.value("loaded"),
        "index_built": INDEX_EVENTS.value("built"),
        "index_rebuilt": INDEX_EVENTS.value("rebuilt"),
        "index_replicated": INDEX_EVENTS.value("replicated"),
        "index_errors": INDEX_EVENTS.value("error"),
        "index_bytes": INDEX_BYTES.value(),
        "index_checkpoints": INDEX_CHECKPOINTS.value(),
        "read_bytes": READ_BYTES.value(),
        "compressed_fetch_bytes": FETCH_BYTES.value(),
    }


# ---------------------------------------------------------------------------
# Config resolution (env > [soci] config > defaults)
# ---------------------------------------------------------------------------


class SociRuntimeConfig:
    __slots__ = ("enable", "stride_bytes", "replicate", "zstd", "toc_adopt")

    def __init__(
        self,
        enable: bool,
        stride_bytes: int,
        replicate: bool,
        zstd: bool = True,
        toc_adopt: bool = True,
    ):
        self.enable = enable
        self.stride_bytes = stride_bytes
        self.replicate = replicate
        self.zstd = zstd
        self.toc_adopt = toc_adopt


def _global_soci_config():
    try:
        from nydus_snapshotter_tpu_torch.config import config as _cfg

        return _cfg.get_global_config().soci
    except Exception:
        return None


def _env_int(name: str, default: int) -> int:
    try:
        v = int(os.environ.get(name, ""))
        return v if v >= 0 else default
    except ValueError:
        return default


def resolve_soci_config() -> SociRuntimeConfig:
    """env (``NTPU_SOCI*``) > ``[soci]`` global config > defaults."""
    sc = _global_soci_config()

    def _bool(name: str, default: bool) -> bool:
        v = os.environ.get(name, "")
        if not v:
            return default
        return v not in ("0", "off", "false")

    stride_kib = _env_int(
        "NTPU_SOCI_STRIDE_KIB",
        getattr(sc, "stride_kib", 0) or DEFAULT_STRIDE_KIB,
    )
    return SociRuntimeConfig(
        enable=_bool("NTPU_SOCI_ENABLE", bool(getattr(sc, "enable", False))),
        stride_bytes=max(MIN_STRIDE_KIB, stride_kib) << 10,
        replicate=_bool(
            "NTPU_SOCI_REPLICATE", bool(getattr(sc, "replicate", True))
        ),
        zstd=_bool("NTPU_SOCI_ZSTD", bool(getattr(sc, "zstd", True))),
        toc_adopt=_bool(
            "NTPU_SOCI_TOC_ADOPT", bool(getattr(sc, "toc_adopt", True))
        ),
    )


# ---------------------------------------------------------------------------
# Index building
# ---------------------------------------------------------------------------


def _norm_path(name: str) -> str:
    p = "/" + name.strip("/")
    return "/" if p == "/" else p


def file_extents(tar_bytes: bytes) -> dict[str, tuple[int, int]]:
    """path → (decompressed offset, size) for every regular file's
    content region — tar semantics applied (a repeated path replaces the
    earlier entry; whiteouts carry no data and are skipped)."""
    files: dict[str, tuple[int, int]] = {}
    try:
        tf = tarfile.open(fileobj=io.BytesIO(tar_bytes), mode="r:")
        for info in tf:
            if info.isreg() and info.size > 0:
                files[_norm_path(info.name)] = (info.offset_data, info.size)
    except tarfile.TarError:
        # A gzip blob that isn't a tar: the checkpoint index still gives
        # random access to the byte stream; only the file map is empty.
        logger.warning("soci file map skipped: decompressed stream is not "
                       "a tar", exc_info=True)
    return files


def build_index_from_gzip(
    blob_id: str,
    raw_gzip: bytes,
    stride: Optional[int] = None,
) -> tuple[SociIndex, bytes]:
    """One inflate pass over the original layer → ``(index, tar bytes)``.

    The decompressed output is returned so index-on-first-pull builds the
    layer bootstrap from the same pass instead of inflating twice.
    """
    failpoint.hit("soci.index")
    stride = stride or resolve_soci_config().stride_bytes
    t0 = perf_counter()
    with trace.span("soci.index.build", blob=blob_id[:8], bytes=len(raw_gzip)):
        checkpoints, tar_bytes = zran.build(raw_gzip, stride=stride)
        index = SociIndex(
            blob_id=blob_id,
            compressed_size=len(raw_gzip),
            uncompressed_size=len(tar_bytes),
            stride=stride,
            checkpoints=checkpoints,
            files=file_extents(tar_bytes),
        )
    INDEX_CHECKPOINTS.inc(len(checkpoints))
    OP_MS.labels("build").observe((perf_counter() - t0) * 1000.0)
    return index, tar_bytes


# ---------------------------------------------------------------------------
# Index store: local → peer → rebuild-once
# ---------------------------------------------------------------------------


def find_index(
    dirs: Sequence[str], blob_id: str, csize: int = 0
) -> tuple[Optional[SociIndex], int]:
    """``(first loadable index for blob_id in dirs, discarded count)``.
    A corrupt or stale artifact fails loudly (warning + error metric),
    is deleted so it cannot fail twice, and the search continues."""
    discarded = 0
    for d in dirs:
        if not d:
            continue
        path = index_path(d, blob_id)
        if not os.path.exists(path):
            continue
        try:
            return SociIndex.load(path, blob_id=blob_id, csize=csize), discarded
        except SociIndexError as e:
            INDEX_EVENTS.labels("error").inc()
            logger.warning("discarding bad soci index %s: %s", path, e)
            discarded += 1
            try:
                os.unlink(path)
            except OSError:
                pass
    return None, discarded


def load_or_build_index(
    dirs: Sequence[str],
    blob_id: str,
    csize: int = 0,
    builder: Optional[Callable[[], bytes]] = None,
    fetch_remote: Optional[Callable[[], bytes]] = None,
    stride: Optional[int] = None,
    persist: bool = True,
) -> tuple[Optional[SociIndex], str]:
    """The store waterfall: local cache dirs → peer replication → one
    local rebuild. Returns ``(index, outcome)``; ``(None, ...)`` means
    the caller must fall back to the sequential in-process reader —
    NEVER to wrong bytes.

    ``builder()`` returns the original compressed layer (the rebuild
    source); ``fetch_remote()`` returns serialized index bytes from the
    peer tier, revalidated by checksum before adoption. A (re)build or
    adopted replica persists into ``dirs[0]``.
    """
    failpoint.hit("soci.index")
    try:
        idx, discarded = find_index(dirs, blob_id, csize=csize)
    except Exception:  # noqa: BLE001 — the store degrades, reads survive
        logger.warning("soci index search failed for %s", blob_id[:12],
                       exc_info=True)
        idx, discarded = None, 1
    if idx is not None:
        INDEX_EVENTS.labels("loaded").inc()
        return idx, "loaded"

    if fetch_remote is not None:
        try:
            raw = fetch_remote()
            idx = SociIndex.from_bytes(raw, blob_id=blob_id, csize=csize)
        except Exception as e:  # noqa: BLE001 — peer replication is an
            # optimization; any failure (dead peer, corrupt bytes) walks
            # on to the local build
            logger.warning("soci index replication for %s failed: %s",
                           blob_id[:12], e)
            idx = None
        if idx is not None:
            INDEX_EVENTS.labels("replicated").inc()
            if persist and dirs and dirs[0]:
                try:
                    INDEX_BYTES.inc(idx.save(index_path(dirs[0], blob_id)))
                except OSError:
                    logger.warning("cannot persist replicated soci index",
                                   exc_info=True)
            return idx, "replicated"

    if builder is None:
        return None, "missing"
    try:
        raw_gzip = builder()
        idx, _ = build_index_from_gzip(blob_id, raw_gzip, stride=stride)
    except Exception as e:  # noqa: BLE001 — a failed build degrades to
        # the sequential reader, never to a broken one
        INDEX_EVENTS.labels("error").inc()
        logger.warning("soci index build for %s failed: %s", blob_id[:12], e)
        return None, "error"
    outcome = "rebuilt" if discarded else "built"
    INDEX_EVENTS.labels(outcome).inc()
    if persist and dirs and dirs[0]:
        try:
            INDEX_BYTES.inc(idx.save(index_path(dirs[0], blob_id)))
        except OSError:
            logger.warning("cannot persist soci index", exc_info=True)
    return idx, outcome


# ---------------------------------------------------------------------------
# The reader BlobReader mounts
# ---------------------------------------------------------------------------


class SociStreamReader:
    """Decompressed-domain random access over an indexed gzip blob.

    Interface-compatible with ``converter/zran.GzipStreamReader``
    (``read_range(offset, size)``), but stateless per call —
    ``concurrent = True`` tells BlobReader it needs no serializing lock —
    and cold cost is bounded by the index stride. ``read_comp`` is the
    compressed-domain reader (CachedBlob.read_at in the daemon, a plain
    pread for local blobs); all caching stays in the compressed domain,
    where the fetch scheduler and eviction already manage it.
    """

    concurrent = True

    def __init__(
        self,
        index: SociIndex,
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
            raise SociIndexError(
                f"read [{offset}, +{size}) beyond decompressed end "
                f"{self.index.uncompressed_size}"
            )
        t0 = perf_counter()
        failpoint.hit("soci.resolve")
        cp, comp_start, comp_end = self.index.resolve(offset, size)
        with trace.span(
            "soci.read",
            blob=self.name,
            offset=offset,
            bytes=size,
            checkpoint=0 if cp is None else cp.uout,
        ) as sp:
            fetched = 0

            def pull(pos: int, n: int) -> bytes:
                nonlocal fetched
                failpoint.hit("soci.fetch")
                data = self._read_comp(pos, n)
                fetched += len(data)
                return data

            out = zran.extract(
                pull, self.index.compressed_size, cp, offset, size,
                comp_end=comp_end,
            )
            sp.annotate(compressed_bytes=fetched)
        READ_BYTES.inc(size)
        FETCH_BYTES.inc(fetched)
        OP_MS.labels("read").observe((perf_counter() - t0) * 1000.0)
        return out

    def resolve_compressed(self, offset: int, size: int) -> tuple[int, int]:
        """Compressed ``[start, end)`` a decompressed extent needs —
        the prefetch replayer warms THIS range (warming the decompressed
        offsets against a compressed blob would warm garbage)."""
        _, comp_start, comp_end = self.index.resolve(offset, size)
        return comp_start, comp_end


def warm_list_from_index(index, paths: list[str]) -> tuple[list, list[str]]:
    """The soci index as a prefetch-trace source: translate an ordered
    path list through the index's self-contained file → decompressed-
    extent map into ``(path, comp_start, comp_end)`` compressed warm
    ranges, one per file (vs one per bootstrap chunk record — the replay
    issues whole-file ranges the fetch scheduler then coalesces).
    Returns the warm list plus the paths the index doesn't map (the
    caller replays those through the bootstrap as before). The ranges
    are warmed at PREFETCH lane priority by the caller; order is the
    trace's access order, which IS the replay priority."""
    warms = []
    missing: list[str] = []
    for path in paths:
        ext = index.file_extent(_norm_path(path))
        if ext is None:
            missing.append(path)
            continue
        uoff, usize = ext
        _, comp_start, comp_end = index.resolve(uoff, usize)
        warms.append((path, comp_start, comp_end))
    return warms, missing
