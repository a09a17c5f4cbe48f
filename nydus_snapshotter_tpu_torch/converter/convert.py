"""Pack / Merge / Unpack: image-level conversion.

Reference surface: ``Pack`` (convert_unix.go:325), ``Merge`` (:560),
``Unpack`` (:669), as the reference package's ``converter/convert.py``
carries it. ``Pack`` and ``pack_layer`` are converter/pack.py's (the
layer lanes on the card or the host); this module adds what turns packed
layers into an image and back:

- ``Merge``: the overlay of the layers' bootstraps (whiteouts, opaque
  directories), merge-time chunk-dict dedup, a parent bootstrap, prefetch
  patterns, the bootstrap-layer tar (``with_tar``), and the image
  bootstrap in this package's layout or the reference toolchain's real
  RAFS v5 / v6 layouts (models/nydus_real_write.py);
- ``Unpack``: a bootstrap (either layout) plus its blobs back to an OCI
  tar, through :class:`BlobReader`;
- the framing helpers ``bootstrap_from_layer_blob``,
  ``bootstrap_from_bootstrap_layer``, ``frame_bootstrap_only`` and
  ``blob_data_from_layer_blob``.

Merge and Unpack are host work (tables, overlay, decompression); the
chunk lookups of merge-time dedup are host dict lookups, as in the
reference. The output is byte-identical to the reference package's.

:class:`BlobReader` decrypts encrypted blobs (seekable AES-256-CTR,
converter/crypto.py) and decodes trained-dictionary ``nZD1`` zstd frames
through the process-wide registry of converter/codec.py, which fails
loudly, naming the dictionary id, when the dictionary is not registered.

Refused with :class:`ConvertError`: the OCIRef stream chunks and readers
of the soci layer (``CHUNK_FLAG_GZIP_STREAM`` of
converter/zran.py, ``CHUNK_FLAG_ZSTD_STREAM`` of converter/zstd_ref.py,
``mount_gzip_stream`` / ``mount_zstd_stream``).
"""

from __future__ import annotations

import hashlib
import io
import stat
import tarfile
import threading
from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Callable, Optional

from nydus_snapshotter_tpu_torch import constants
from nydus_snapshotter_tpu_torch.converter import codec as codec_mod
from nydus_snapshotter_tpu_torch.converter import crypto
from nydus_snapshotter_tpu_torch.converter.pack import (  # noqa: F401  (re-exported)
    Pack,
    PackResult,
    _make_compressor,
    match_prefetch_paths,
    pack_layer,
)
from nydus_snapshotter_tpu_torch.converter.types import ConvertError, MergeOption, UnpackOption
from nydus_snapshotter_tpu_torch.models import fstree, layout, nydus_tar, toc
from nydus_snapshotter_tpu_torch.models.bootstrap import (
    CHUNK_FLAG_BATCH,
    INODE_FLAG_WHITEOUT,
    BatchRecord,
    BlobRecord,
    Bootstrap,
    ChunkRecord,
    CipherRecord,
    Inode,
)
from nydus_snapshotter_tpu_torch.models.nydus_real import RealBootstrapError, load_any_bootstrap
from nydus_snapshotter_tpu_torch.utils import lz4

# Chunk flags of the reference's OCIRef layers (converter/zran.py,
# converter/zstd_ref.py): offsets address the decompressed stream of the
# original .tar.gz / .tar.zst blob.
CHUNK_FLAG_GZIP_STREAM = 0x400
CHUNK_FLAG_ZSTD_STREAM = 0x800


class ThreadSafeCompressor:
    """Per-thread codec contexts for parallel speculative compression (the
    pipeline's ``compress_fn``).

    A zstd context is not safe for concurrent calls; the output is still
    deterministic across contexts (same level, single-threaded contexts),
    so racing threads produce identical bytes.

    With an adaptive ``codec`` the call routes straight to ``codec.encode``:
    the codec keeps its own per-worker pinned contexts and is deterministic
    in chunk content, so the same racing invariant holds.
    """

    def __init__(self, compressor: str, lz4_accel: int = 1, codec=None):
        self._kind = compressor
        self._lz4_accel = lz4_accel
        self._codec = codec if (codec is not None and compressor == "zstd") else None
        self._tls = threading.local()

    def __call__(self, data):
        if self._codec is not None:
            return self._codec.encode(data)
        fn = getattr(self._tls, "fn", None)
        if fn is None:
            fn = self._tls.fn = _make_compressor(self._kind, self._lz4_accel)
        return fn(data)

    def encode_many(self, views, n_threads: int = 1):
        """Batch counterpart of ``__call__``: ``[(payload, flag)]``
        byte-identical to ``[self(v) for v in views]``. The adaptive codec
        takes its ``encode_batch``. Otherwise, with the system libzstd, zstd
        runs as one GIL-free native batch at the fixed level
        (``ntpu_encode_batch`` is one-shot ``ZSTD_compressCCtx`` like
        ``compress_block``, so the frames match); everything else loops per
        chunk."""
        if self._codec is not None:
            return self._codec.encode_batch(views, n_threads=n_threads)
        if self._kind == "zstd" and views:
            from nydus_snapshotter_tpu_torch.ops import native_cdc
            from nydus_snapshotter_tpu_torch.utils import zstd as zstd_native

            if zstd_native.available() and native_cdc.encode_batch_available():
                buf, ext = native_cdc.concat_extents(views)
                res = native_cdc.encode_batch_native(buf, ext, constants.ZSTD_LEVEL, n_threads)
                if res is not None:
                    payloads, comp, _digests = res
                    return [
                        (
                            payloads[int(comp[k, 0]) : int(comp[k, 0]) + int(comp[k, 1])].tobytes(),
                            constants.COMPRESSOR_ZSTD,
                        )
                        for k in range(len(views))
                    ]
        return [self(v) for v in views]


@dataclass
class MergeResult:
    bootstrap: bytes
    blob_digests: list[str]  # referenced blob ids after dedup, table order


def _decompress_chunk(data: bytes, flags: int, expect_size: int) -> bytes:
    comp = flags & constants.COMPRESSOR_MASK
    if comp == constants.COMPRESSOR_ZSTD:
        from nydus_snapshotter_tpu_torch.utils import zstdcompat

        if codec_mod.is_trained_frame(data):
            # Versioned trained-dict frame (nZD1 header): decodes only with
            # the dictionary it was trained with; a reader that lacks it
            # fails loudly, never emits garbage bytes.
            try:
                return codec_mod.decode_trained_frame(data, expect_size)
            except codec_mod.CodecError as e:
                raise ConvertError(str(e)) from e
        try:
            return zstdcompat.decompress_block(data, max_output_size=max(expect_size, 1))
        except Exception:
            # Any conforming frame decodes identically on the package
            # decompressor; keep it as the compatibility net.
            return zstdcompat.zstandard.ZstdDecompressor().decompress(
                data, max_output_size=max(expect_size, 1)
            )
    if comp == constants.COMPRESSOR_LZ4_BLOCK:
        return lz4.decompress_block(data, expect_size)
    if comp == constants.COMPRESSOR_GZIP:
        # estargz chunks are whole gzip members left in place by the index
        # builder. The member carries tar padding (and possibly the next
        # entry's header member), so longer-than-expected output is normal
        # and truncated; SHORTER output means a corrupt blob.
        import gzip
        import zlib

        try:
            out = gzip.decompress(data)
        except (OSError, EOFError, zlib.error) as e:
            raise ConvertError(f"corrupt gzip chunk: {e}") from e
        if expect_size:
            if len(out) < expect_size:
                raise ConvertError(
                    f"gzip chunk inflated to {len(out)} bytes < expected {expect_size}"
                )
            return out[:expect_size]
        return out
    if comp in (constants.COMPRESSOR_NONE, 0):
        return data
    raise ConvertError(f"unsupported chunk compressor flags {flags:#x}")


class BlobReader:
    """Random-access chunk reads from one blob's data section.

    Resolves the storage transforms a chunk record can carry: per-chunk
    compression, batch packing (``CHUNK_FLAG_BATCH``: several small chunks
    share one compressed extent) and blob encryption (seekable AES-CTR,
    converter/crypto.py). ``read_at(offset, size)`` returns raw
    (still-encrypted) blob bytes. An OCIRef stream chunk raises
    :class:`ConvertError`.
    """

    # Decompressed batches kept hot per reader — bounded so a long-lived
    # reader doesn't pin every batch it ever read.
    BATCH_CACHE_BYTES = 32 << 20

    def __init__(
        self,
        bootstrap: Bootstrap,
        blob_index: int,
        read_at: Callable[[int, int], bytes],
        batch_map: Optional[dict[tuple[int, int], tuple[int, int]]] = None,
    ):
        self.bootstrap = bootstrap
        self.blob_index = blob_index
        self.read_at = read_at
        self.cipher = bootstrap.cipher_for(blob_index)
        if self.cipher is not None and self.cipher.algo != crypto.CIPHER_AES_256_CTR:
            raise ConvertError(f"unsupported blob cipher algo {self.cipher.algo}")
        # (blob_index, compressed_offset) -> (uncompressed_base, size), from
        # the bootstrap's batch table. Callers constructing several readers
        # can share one batch_map to avoid rebuilding it per blob.
        self._batch_map = bootstrap.batch_map() if batch_map is None else batch_map
        self._batch_lock = threading.Lock()
        self._batch_cache: "OrderedDict[int, bytes]" = OrderedDict()
        self._batch_cache_bytes = 0

    def mount_gzip_stream(self, stream) -> None:
        raise ConvertError("OCIRef gzip stream readers (converter/zran.py, soci) are not ported")

    def mount_zstd_stream(self, stream) -> None:
        raise ConvertError("OCIRef zstd stream readers (converter/zstd_ref.py, soci) are not ported")

    def _read_plain(self, offset: int, size: int) -> bytes:
        raw = self.read_at(offset, size)
        if len(raw) != size:
            raise ConvertError(
                f"blob {self.blob_index}: short read at {offset} "
                f"({len(raw)} of {size} bytes)"
            )
        if self.cipher is not None:
            raw = crypto.decrypt_range(raw, offset, self.cipher.key, self.cipher.iv)
        return raw

    def chunk_data(self, rec: ChunkRecord) -> bytes:
        """The uncompressed data of one chunk record."""
        if rec.blob_index != self.blob_index:
            raise ConvertError("chunk record belongs to a different blob")
        if rec.flags & (CHUNK_FLAG_GZIP_STREAM | CHUNK_FLAG_ZSTD_STREAM):
            raise ConvertError(
                "OCIRef stream chunk: the zran/zstd stream readers (converter/zran.py, "
                "converter/zstd_ref.py) are not ported"
            )
        if rec.flags & CHUNK_FLAG_BATCH:
            extent = self._batch_map.get((self.blob_index, rec.compressed_offset))
            if extent is None:
                raise ConvertError(
                    f"batched chunk at blob {self.blob_index} offset "
                    f"{rec.compressed_offset} has no batch-table entry"
                )
            base, usize = extent
            with self._batch_lock:
                batch = self._batch_cache.get(rec.compressed_offset)
                if batch is not None:
                    self._batch_cache.move_to_end(rec.compressed_offset)
            if batch is None:
                raw = self._read_plain(rec.compressed_offset, rec.compressed_size)
                batch = _decompress_chunk(raw, rec.flags, usize)
                with self._batch_lock:
                    if rec.compressed_offset not in self._batch_cache:
                        self._batch_cache[rec.compressed_offset] = batch
                        self._batch_cache_bytes += len(batch)
                    while (
                        self._batch_cache_bytes > self.BATCH_CACHE_BYTES
                        and len(self._batch_cache) > 1
                    ):
                        _, evicted = self._batch_cache.popitem(last=False)
                        self._batch_cache_bytes -= len(evicted)
            inner = rec.uncompressed_offset - base
            if inner < 0 or inner + rec.uncompressed_size > len(batch):
                raise ConvertError("batch chunk slice overflows its batch")
            return batch[inner : inner + rec.uncompressed_size]
        raw = self._read_plain(rec.compressed_offset, rec.compressed_size)
        return _decompress_chunk(raw, rec.flags, rec.uncompressed_size)


def make_bytes_reader(
    bootstrap: Bootstrap, blob_index: int, blob: bytes, batch_map=None
) -> BlobReader:
    return BlobReader(
        bootstrap, blob_index, lambda off, size: blob[off : off + size], batch_map=batch_map
    )


# ---------------------------------------------------------------------------
# Merge
# ---------------------------------------------------------------------------


@dataclass
class _Node:
    """Overlay node carrying an inode plus its chunks (blob ids resolved)."""

    inode: Inode
    chunks: list[tuple[ChunkRecord, str]] = field(default_factory=list)

    @property
    def path(self) -> str:
        return self.inode.path

    @property
    def is_dir(self) -> bool:
        return stat.S_ISDIR(self.inode.mode)

    @property
    def is_whiteout(self) -> bool:
        return bool(self.inode.flags & INODE_FLAG_WHITEOUT)

    @property
    def flags(self) -> int:
        return self.inode.flags


def _layer_nodes(bootstrap: Bootstrap) -> list[_Node]:
    blob_ids = [b.blob_id for b in bootstrap.blobs]
    nodes = []
    for inode in bootstrap.inodes:
        chunks = [
            (c, blob_ids[c.blob_index])
            for c in bootstrap.chunks[inode.chunk_index : inode.chunk_index + inode.chunk_count]
        ]
        nodes.append(_Node(inode=inode, chunks=chunks))
    return nodes


def bootstrap_from_layer_blob(blob: bytes) -> Bootstrap:
    """Extract the layer bootstrap from a packed nydus blob stream. The
    embedded section may be in either layout — native, or the real
    toolchain's v5/v6 (a reference-built framed layer) — and is bridged."""
    f = io.BytesIO(blob)
    loc = nydus_tar.seek_file_by_tar_header(f, len(blob), toc.ENTRY_BOOTSTRAP)
    if loc is None:
        raise ConvertError("layer blob carries no bootstrap section")
    off, size = loc
    return load_any_bootstrap(blob[off : off + size])


def bootstrap_from_bootstrap_layer(data: bytes) -> Bootstrap:
    """Extract the image bootstrap from a (decompressed) bootstrap *layer*:
    a standard tar carrying ``image/image.boot``
    (constant.go BootstrapFileNameInLayer, written by packToTar)."""
    try:
        with tarfile.open(fileobj=io.BytesIO(data), mode="r:") as tf:
            for member in tf:
                if member.name in (layout.BOOTSTRAP_FILE, "./" + layout.BOOTSTRAP_FILE):
                    extracted = tf.extractfile(member)
                    if extracted is None:
                        break
                    return Bootstrap.from_bytes(extracted.read())
    except (tarfile.TarError, OSError) as e:
        raise ConvertError(f"bad bootstrap layer tar: {e}") from e
    raise ConvertError("bootstrap layer carries no image/image.boot")


def _layer_bootstrap(layer: bytes) -> Bootstrap:
    # A framed layer stream (pack output) or a bare bootstrap in either
    # layout — the reference Merge takes per-layer bootstraps
    # (convert_unix.go:560-607), including real-toolchain ones.
    try:
        return bootstrap_from_layer_blob(layer)
    except (ConvertError, nydus_tar.TarFramingError, ValueError) as frame_err:
        try:
            return load_any_bootstrap(layer)
        except Exception as boot_err:
            # keep the framing diagnosis AND the caller-visible type
            raise ConvertError(
                f"layer is neither a framed blob ({frame_err}) nor a "
                f"bootstrap ({boot_err})"
            ) from frame_err


def Merge(
    layers: "list[bytes | Bootstrap]",
    opt: MergeOption,
    chunk_dict=None,
) -> MergeResult:
    """Merge per-layer bootstraps into one image bootstrap.

    ``layers`` are packed layer blobs (or already-parsed bootstraps), lowest
    first. Returns the image bootstrap plus the dedup result: the blob ids
    actually referenced (reference Merge surface convert_unix.go:560-666,
    whose blob-digest list comes from merge-output.json,
    tool/builder.go:278-294). ``chunk_dict`` passes an already-loaded dict
    object (batch conversion); ``opt.chunk_dict_path`` is the file (or
    ``service://``) fallback, opened through ``open_chunk_dict``.
    """
    if not layers:
        raise ConvertError("merge needs at least one layer")
    opened = None
    if chunk_dict is None and opt.chunk_dict_path:
        from nydus_snapshotter_tpu_torch.parallel.dict_service import open_chunk_dict

        chunk_dict = opened = open_chunk_dict(opt.chunk_dict_path)
    try:
        return _merge(layers, opt, chunk_dict)
    finally:
        if hasattr(opened, "close"):  # a service mirror's connections
            opened.close()


def _merge(layers, opt: MergeOption, chunk_dict) -> MergeResult:
    parent: Optional[Bootstrap] = None
    if opt.parent_bootstrap_path:
        with open(opt.parent_bootstrap_path, "rb") as f:
            parent = load_any_bootstrap(f.read())

    boots: list[Bootstrap] = []
    if parent is not None:
        boots.append(parent)
    for layer in layers:
        boots.append(layer if isinstance(layer, Bootstrap) else _layer_bootstrap(layer))
    chunk_size = boots[-1].chunk_size
    version = opt.fs_version or boots[-1].version
    lower: list[_Node] = []
    for b in boots:
        lower = fstree.apply_overlay(lower, _layer_nodes(b))  # type: ignore[arg-type]

    # Chunk-dict dedup at merge time: chunks whose digest is in the dict are
    # re-pointed at the dict blob.
    inodes: list[Inode] = []
    chunk_records: list[ChunkRecord] = []
    blob_index_of: dict[str, int] = {}
    blob_records: dict[str, BlobRecord] = {}
    blob_ciphers: dict[str, CipherRecord] = {}
    blob_batches: dict[tuple[str, int], tuple[int, int]] = {}
    source_boots = boots + ([chunk_dict.bootstrap] if chunk_dict is not None else [])
    for b in source_boots:
        for i, rec in enumerate(b.blobs):
            blob_records.setdefault(rec.blob_id, rec)
            cipher = b.cipher_for(i)
            if cipher is not None:
                blob_ciphers.setdefault(rec.blob_id, cipher)
        ids = [r.blob_id for r in b.blobs]
        for br in b.batches:
            if br.blob_index < len(ids):
                blob_batches.setdefault(
                    (ids[br.blob_index], br.compressed_offset),
                    (br.uncompressed_base, br.uncompressed_size),
                )

    def blob_index(bid: str) -> int:
        if bid not in blob_index_of:
            blob_index_of[bid] = len(blob_index_of)
        return blob_index_of[bid]

    for node in lower:  # already path-sorted by apply_overlay
        inode = node.inode
        inode.chunk_index = len(chunk_records)
        inode.chunk_count = len(node.chunks)
        for rec, bid in node.chunks:
            hit = chunk_dict.get(rec.digest) if chunk_dict is not None else None
            if hit is not None:
                chunk_records.append(
                    ChunkRecord(
                        digest=rec.digest,
                        blob_index=blob_index(chunk_dict.blob_id_for(hit)),
                        flags=hit.flags,
                        uncompressed_offset=hit.uncompressed_offset,
                        compressed_offset=hit.compressed_offset,
                        uncompressed_size=hit.uncompressed_size,
                        compressed_size=hit.compressed_size,
                    )
                )
            else:
                rec2 = ChunkRecord(**{**rec.__dict__})
                rec2.blob_index = blob_index(bid)
                chunk_records.append(rec2)
        inodes.append(inode)

    blob_table = []
    cipher_table = []
    for bid, _idx in sorted(blob_index_of.items(), key=lambda kv: kv[1]):
        base = blob_records.get(bid)
        if base is None:
            raise ConvertError(f"chunk references unknown blob {bid}")
        blob_table.append(base)
        cipher_table.append(blob_ciphers.get(bid) or CipherRecord())
    batch_table = sorted(
        (
            BatchRecord(blob_index_of[bid], coff, u_base, usize)
            for (bid, coff), (u_base, usize) in blob_batches.items()
            if bid in blob_index_of
        ),
        key=lambda b: (b.blob_index, b.compressed_offset),
    )

    bootstrap = Bootstrap(
        version=version,
        chunk_size=chunk_size,
        inodes=inodes,
        chunks=chunk_records,
        blobs=blob_table,
        ciphers=cipher_table if any(c.algo for c in cipher_table) else [],
        batches=batch_table,
        prefetch=match_prefetch_paths(inodes, opt.prefetch_patterns)
        if opt.prefetch_patterns
        else [],
    )
    if opt.bootstrap_format in ("rafs-v5", "rafs-v6"):
        # Emit the image bootstrap in the reference toolchain's own
        # layout so its ecosystem can mount what this package built.
        if bootstrap.ciphers or bootstrap.batches:
            raise ConvertError(
                "encrypted/batched bootstraps have no real-layout "
                "representation; use bootstrap_format='native'"
            )
        from nydus_snapshotter_tpu_torch.models.nydus_real_write import (
            real_from_bootstrap,
            write_real_v5,
            write_real_v6,
        )

        try:
            real = real_from_bootstrap(bootstrap, digester=opt.digester)
            boot_bytes = (
                write_real_v5(real)
                if opt.bootstrap_format == "rafs-v5"
                else write_real_v6(real)
            )
        except RealBootstrapError as e:
            raise ConvertError(f"real-layout emit failed: {e}") from e
    elif opt.bootstrap_format in ("", "native"):
        boot_bytes = bootstrap.to_bytes()
    else:
        raise ConvertError(
            f"unknown bootstrap_format {opt.bootstrap_format!r} "
            "(native | rafs-v5 | rafs-v6)"
        )
    if opt.with_tar:
        # Standard forward tar carrying image/image.boot — the bootstrap
        # *layer* format every consumer expects (reference packToTar;
        # referrer fetch unpacks it with plain tar, unpack.go:20-56).
        out = io.BytesIO()
        with tarfile.open(fileobj=out, mode="w:", format=tarfile.GNU_FORMAT) as tf:
            info = tarfile.TarInfo(layout.BOOTSTRAP_FILE)
            info.size = len(boot_bytes)
            info.mode = 0o444
            tf.addfile(info, io.BytesIO(boot_bytes))
        boot_bytes = out.getvalue()
    return MergeResult(
        bootstrap=boot_bytes,
        blob_digests=[b.blob_id for b in blob_table],
    )


# ---------------------------------------------------------------------------
# Unpack
# ---------------------------------------------------------------------------


def Unpack(
    bootstrap: "bytes | Bootstrap",
    blob_provider: "Callable[[str], bytes] | dict[str, bytes]",
    opt: Optional[UnpackOption] = None,
) -> bytes:
    """Rebuild the OCI tar from a bootstrap plus its blobs.

    ``blob_provider`` maps blob id → *blob data section* bytes (for a packed
    layer stream, pass the bytes of its ``image.blob`` section, see
    ``blob_data_from_layer_blob``). Reference surface convert_unix.go:669-733.
    Takes real nydus-toolchain bootstraps too (detected and bridged by
    models/nydus_real.load_any_bootstrap).
    """
    bs = bootstrap if isinstance(bootstrap, Bootstrap) else load_any_bootstrap(bootstrap)
    provider = blob_provider.__getitem__ if isinstance(blob_provider, dict) else blob_provider
    readers: dict[int, BlobReader] = {}
    batch_map = bs.batch_map()

    def reader_for(blob_index: int) -> BlobReader:
        if blob_index not in readers:
            blob = provider(bs.blobs[blob_index].blob_id)
            readers[blob_index] = make_bytes_reader(bs, blob_index, blob, batch_map)
        return readers[blob_index]

    entries: list[fstree.FileEntry] = []
    for inode in bs.inodes:
        data = b""
        if stat.S_ISREG(inode.mode) and inode.chunk_count and not inode.hardlink_target:
            parts = []
            for rec in bs.chunks[inode.chunk_index : inode.chunk_index + inode.chunk_count]:
                parts.append(reader_for(rec.blob_index).chunk_data(rec))
            data = b"".join(parts)
            if len(data) != inode.size:
                raise ConvertError(
                    f"unpacked {inode.path}: got {len(data)} bytes, inode says {inode.size}"
                )
        entries.append(fstree.inode_to_entry(inode, data))
    return fstree.tar_from_tree(entries)


def frame_bootstrap_only(boot_bytes: bytes) -> bytes:
    """Frame a metadata-only layer stream (image.boot + TOC, no data
    section) — the OCIRef/zran layer shape, consumable by Merge like any
    packed layer."""
    toc_bytes = toc.pack_toc(
        [
            toc.TOCEntry(
                name=toc.ENTRY_BOOTSTRAP,
                flags=constants.COMPRESSOR_NONE,
                uncompressed_digest=hashlib.sha256(boot_bytes).digest(),
                compressed_offset=0,
                compressed_size=len(boot_bytes),
                uncompressed_size=len(boot_bytes),
            )
        ]
    )
    return nydus_tar.pack_entries(
        [(toc.ENTRY_BOOTSTRAP, boot_bytes), (toc.ENTRY_BLOB_TOC, toc_bytes)]
    )


def blob_data_from_layer_blob(blob: bytes) -> bytes:
    """Extract the image.blob section from a packed layer stream ('' if none)."""
    f = io.BytesIO(blob)
    loc = nydus_tar.seek_file_by_tar_header(f, len(blob), toc.ENTRY_BLOB_DATA)
    if loc is None:
        return b""
    off, size = loc
    return blob[off : off + size]
