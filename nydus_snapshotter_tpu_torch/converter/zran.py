"""OCIRef ("zran") conversion: index the original tar.gz, store nothing.

The reference toolchain's ``PackOption.OCIRef`` (``create --type
targz-ref``): the registry keeps serving the original compressed OCI
layer, with no duplicate nydus blob, while the bootstrap indexes the
decompressed content so the runtime reads files lazily out of the gzip
stream. This is the reference package's ``converter/zran.py``.

Random access rides ``decompressobj.copy()`` checkpoints built at read
time (CPython's zlib has no inflatePrime): the first touch of offset O
costs a sequential inflate up to O, a later read near any visited region
resumes from the nearest checkpoint, and a read at or past where the last
one stopped resumes that read's inflate state and its last decoded step,
so reads in ascending offset order cost one inflate pass in all.
Multi-member gzip streams restart inflate at each member boundary.

Chunking is per-file fixed ``chunk_size`` slices of the decompressed tar
(not CDC); with an ``engine`` (``ops/chunker.ChunkDigestEngine``) the
chunks digest through its ``digest_many``, on the card kernel K2
(SHA-256) or K4 (BLAKE3) under ``digest_backend="jax"``; without one on
the host. Chunk records carry ``CHUNK_FLAG_GZIP_STREAM``:
``uncompressed_offset`` is the position in the decompressed stream and
the owning blob is the original ``.tar.gz``.
"""

from __future__ import annotations

import gzip
import hashlib
import io
import zlib
from typing import Callable, Optional

import numpy as np

from nydus_snapshotter_tpu_torch import constants
from nydus_snapshotter_tpu_torch.converter.types import ConvertError, PackOption
from nydus_snapshotter_tpu_torch.models import fstree
from nydus_snapshotter_tpu_torch.models.bootstrap import (
    BlobRecord,
    Bootstrap,
    ChunkRecord,
)

# Chunk flag: offsets address the decompressed stream of a whole-gzip blob.
CHUNK_FLAG_GZIP_STREAM = 0x400

_CHECKPOINT_STEP = 8 << 20  # keep an inflate state copy every 8 MiB


class GzipStreamReader:
    """Random access into a gzip stream via decompressobj checkpoints.

    ``read_at(offset, size)`` returns COMPRESSED bytes of the blob;
    ``read_range`` returns DECOMPRESSED bytes. Checkpoints accumulate as
    regions are touched, so re-reads and forward scans are cheap, and a
    read that starts at or past the last one's final decoded step resumes
    where it stopped; state lives in-process (CPython inflate state is not
    serializable).
    """

    _READ_STEP = 1 << 20

    def __init__(self, read_at: Callable[[int, int], bytes], compressed_size: int):
        self._read_at = read_at
        self._csize = compressed_size
        # (uncompressed_pos, compressed_pos, decompressobj, pending_tail)
        self._checkpoints: list[tuple[int, int, "zlib._Decompress", bytes]] = []
        # Where the last read stopped: (uncompressed_pos, compressed_pos,
        # live decompressobj, pending_tail, its last decoded step).
        self._cursor: Optional[tuple[int, int, "zlib._Decompress", bytes, bytes]] = None

    def _best_checkpoint(self, upos: int):
        best = None
        for cp in self._checkpoints:
            if cp[0] <= upos and (best is None or cp[0] > best[0]):
                best = cp
        return best

    def read_range(self, offset: int, size: int) -> bytes:
        if size <= 0:
            return b""
        out = bytearray()
        best = self._best_checkpoint(offset)
        cursor, self._cursor = self._cursor, None
        if (
            cursor is not None
            and cursor[0] - len(cursor[4]) <= offset
            and (best is None or best[0] <= cursor[0])
        ):
            upos, cpos, d, pending, held = cursor
            held_at = upos - len(held)
            out += held[offset - held_at : offset + size - held_at]
        elif best is not None:
            upos, cpos, d, pending = best[0], best[1], best[2].copy(), best[3]
            held = b""
        else:
            upos, cpos, d, pending, held = 0, 0, zlib.decompressobj(wbits=47), b"", b""
        last_checkpoint = upos - (upos % _CHECKPOINT_STEP)
        while upos < offset + size:
            if d.eof:
                # Multi-member gzip (pigz, eStargz, concatenated members):
                # gzip.decompress() joins members, so the bootstrap spans
                # them all — restart inflate at each member boundary.
                pending = d.unused_data + pending
                if not pending and cpos >= self._csize:
                    break
                d = zlib.decompressobj(wbits=47)
            if pending:
                feed, pending = pending, b""
            elif cpos < self._csize:
                feed = self._read_at(cpos, min(self._READ_STEP, self._csize - cpos))
                if not feed:
                    break
                cpos += len(feed)
            else:
                chunk = d.flush()
                if not chunk:
                    break
                feed = b""
            if feed:
                try:
                    chunk = d.decompress(feed)
                except zlib.error as e:
                    raise ConvertError(f"corrupt gzip stream: {e}") from e
            if not chunk:
                continue
            lo = max(0, offset - upos)
            hi = min(len(chunk), offset + size - upos)
            if hi > lo:
                out += chunk[lo:hi]
            upos += len(chunk)
            held = chunk
            # Drop a resumable state copy at step boundaries we cross.
            if upos - last_checkpoint >= _CHECKPOINT_STEP:
                last_checkpoint = upos - (upos % _CHECKPOINT_STEP)
                self._checkpoints.append((upos, cpos, d.copy(), b""))
                if len(self._checkpoints) > 64:
                    self._checkpoints.pop(0)
        self._cursor = (upos, cpos, d, pending, held)
        if len(out) != size:
            raise ConvertError(
                f"gzip stream range [{offset}, +{size}) beyond decompressed end"
            )
        return bytes(out)


def pack_gzip_layer(
    raw_gzip: bytes, opt: PackOption, engine=None, tar_bytes: Optional[bytes] = None
) -> Bootstrap:
    """Index an original ``.tar.gz`` layer without re-storing its data.

    Returns the layer Bootstrap, whose single blob IS the original
    compressed layer (blob id = its sha256). The decompressed stream is
    chunked per-file (the reference's targz-ref chunks the uncompressed
    content) and digested through ``engine`` when supplied
    (batched/device) or hashlib otherwise. ``tar_bytes`` lets a caller
    that already inflated the stream (the soci index build is itself one
    full inflate pass) hand the output over instead of paying a second
    decompression of a multi-hundred-MiB layer.
    """
    if tar_bytes is None:
        try:
            tar_bytes = gzip.decompress(raw_gzip)
        except (OSError, EOFError, zlib.error) as e:
            raise ConvertError(f"OCIRef layer is not valid gzip: {e}") from e
    return pack_stream_layer(
        raw_gzip, tar_bytes, opt,
        chunk_flag=CHUNK_FLAG_GZIP_STREAM,
        blob_compressor=constants.COMPRESSOR_GZIP,
        engine=engine,
    )


def pack_stream_layer(
    raw: bytes,
    tar_bytes: bytes,
    opt: PackOption,
    chunk_flag: int,
    blob_compressor: int,
    engine=None,
) -> Bootstrap:
    """The format-agnostic half of OCIRef packing: chunk the DECOMPRESSED
    tar stream per file, digest, and emit a bootstrap whose single blob
    is the original compressed layer. ``chunk_flag`` marks how runtime
    reads translate decompressed offsets back to blob bytes
    (CHUNK_FLAG_GZIP_STREAM for gzip zran, CHUNK_FLAG_ZSTD_STREAM for
    the zstd frame index — converter/zstd_ref.py)."""
    opt.validate()
    if opt.encrypt:
        # The original registry blob stays authoritative and plaintext;
        # claiming encryption would mislabel it (hooks annotates encrypted
        # blobs) and consumers would decrypt plaintext into garbage.
        raise ConvertError("oci_ref cannot be combined with encrypt")

    entries: dict[str, fstree.FileEntry] = {}
    # (path, decompressed data offset, size) per regular file, chunked.
    chunk_meta: list[tuple[str, int, int]] = []
    # path -> (start, count) into chunk_meta for the LAST occurrence (tar
    # semantics: a repeated path replaces the earlier entry entirely).
    spans: dict[str, tuple[int, int]] = {}
    import tarfile as tarfile_mod

    opaque_dirs: list[str] = []
    tf = tarfile_mod.open(fileobj=io.BytesIO(tar_bytes), mode="r:")
    for info in tf:
        path = fstree._norm(info.name)
        base = path.rsplit("/", 1)[1] if path != "/" else "/"
        # Overlay markers get the same RAFS normalization as every other
        # pack path (fstree.tree_from_tar / tarfs/bootstrap.py) — literal
        # .wh. files would resurrect deleted content after Merge.
        if base == fstree.OPAQUE_MARKER:
            opaque_dirs.append(path.rsplit("/", 1)[0] or "/")
            continue
        if base.startswith(fstree.WHITEOUT_PREFIX):
            target = fstree._norm(
                path.rsplit("/", 1)[0] + "/" + base[len(fstree.WHITEOUT_PREFIX):]
            )
            entries[target] = fstree.FileEntry(
                path=target, mode=0o020000, flags=fstree.INODE_FLAG_WHITEOUT
            )
            spans.pop(target, None)
            continue
        if getattr(info, "sparse", None):
            # GNU sparse members store only the compacted data region; the
            # in-place chunk extents would read neighbouring tar bytes.
            raise ConvertError(
                f"sparse tar member {info.name!r} cannot be indexed in place"
            )
        entry = fstree.entry_from_tarinfo(tf, info, path, with_data=False)
        entries[path] = entry
        spans.pop(path, None)
        if info.isreg() and info.size > 0:
            start = len(chunk_meta)
            off = info.offset_data
            remaining = info.size
            while remaining > 0:
                step = min(opt.chunk_size, remaining)
                chunk_meta.append((path, off, step))
                off += step
                remaining -= step
            spans[path] = (start, len(chunk_meta) - start)

    for d in opaque_dirs:
        if d not in entries:
            entries[d] = fstree.FileEntry(path=d, mode=0o040755)
        entries[d].flags |= fstree.INODE_FLAG_OPAQUE
        entries[d].xattrs[fstree.OPAQUE_XATTR] = b"y"

    ordered = fstree.ensure_parents(sorted(entries.values(), key=lambda e: e.path))

    view = memoryview(tar_bytes)  # no second copy of multi-GB content
    datas = [view[o : o + s] for _, o, s in chunk_meta]
    if engine is not None:
        # the engine carries its own digester (digest_many branches on it)
        digests = engine.digest_many(datas)
    else:
        from nydus_snapshotter_tpu_torch.ops.chunker import host_digests_for

        buf = np.frombuffer(tar_bytes, dtype=np.uint8)
        digests = host_digests_for(opt.digester)(
            [(buf, o, s) for _p, o, s in chunk_meta]
        )

    blob_id = hashlib.sha256(raw).hexdigest()

    inodes = []
    chunks: list[ChunkRecord] = []
    for e in ordered:
        inode = fstree.entry_to_inode(e)
        span = spans.get(e.path)
        if span is not None:
            start, count = span
            inode.chunk_index = len(chunks)
            inode.chunk_count = count
            inode.size = sum(s for _, _, s in chunk_meta[start : start + count])
            for (path, off, size), digest in zip(
                chunk_meta[start : start + count], digests[start : start + count]
            ):
                chunks.append(
                    ChunkRecord(
                        digest=digest,
                        blob_index=0,
                        flags=chunk_flag,
                        uncompressed_offset=off,
                        compressed_offset=off,
                        uncompressed_size=size,
                        compressed_size=size,
                    )
                )
        inodes.append(inode)

    blob = BlobRecord(
        blob_id=blob_id,
        compressed_size=len(raw),
        uncompressed_size=len(tar_bytes),
        chunk_count=len(chunks),
        flags=blob_compressor,
    )
    from nydus_snapshotter_tpu_torch.converter.pack import match_prefetch_paths

    return Bootstrap(
        version=opt.fs_version,
        chunk_size=opt.chunk_size,
        inodes=inodes,
        chunks=chunks,
        blobs=[blob],
        prefetch=match_prefetch_paths(inodes, opt.prefetch_patterns)
        if opt.prefetch_patterns
        else [],
    )
