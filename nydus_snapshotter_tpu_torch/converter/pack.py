"""pack_layer: one OCI layer tar -> nydus blob stream.

Reference semantics (convert_unix.go:325-539): uncompressed layer tar in,
tar-like nydus blob out (``image.blob`` data | ``image.boot`` layer
bootstrap | ``rafs.blob.toc``, framed per models/nydus_tar.py); chunk-dict
hits are referenced, not stored. The output is byte-identical to the
reference package's ``pack_layer`` for the options supported here:

- ``backend="fused"``: the layer's files go through the device full path
  (ops/fused_convert) — cuts and SHA-256 on the card — in as few batches
  as int32 chunk addressing allows. An input the device path cannot take
  (candidate capacity overflow, a file beyond int32 addressing) raises
  :class:`ConvertError`; it is never finished on the host instead.
- ``backend="numpy"``: the host oracle — numpy CDC and ``hashlib``.
- ``compressor="none"``, ``chunking="cdc"``, ``digester="sha256"``, RAFS v5
  or v6. Every other option value raises :class:`ConvertError`.

Dedup, blob assembly and bootstrap emission follow the reference's serial
lane: chunks in tar order, first occurrence stored, later ones referenced.
"""

from __future__ import annotations

import hashlib
import io
import stat
import tarfile
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from nydus_snapshotter_tpu_torch import constants
from nydus_snapshotter_tpu_torch.converter.types import ConvertError, PackOption
from nydus_snapshotter_tpu_torch.models import fstree, nydus_tar, toc
from nydus_snapshotter_tpu_torch.models.bootstrap import (
    BatchRecord,
    BlobRecord,
    Bootstrap,
    ChunkRecord,
    CipherRecord,
    Inode,
)
from nydus_snapshotter_tpu_torch.ops import cdc, fused_convert


@dataclass
class PackResult:
    blob_id: str  # hex sha256 of the image.blob section ("" if fully deduped)
    blob_size: int
    bootstrap: bytes
    referenced_blob_ids: list[str]


@dataclass
class _ChunkRef:
    """A file-extent's chunk before final record materialization."""

    digest: bytes
    size: int
    uniq_idx: int = -1  # index into the own-blob unique table
    dict_hit: Optional[ChunkRecord] = None


@dataclass
class _Meta:
    entry: fstree.FileEntry
    size: int = 0
    chunks: list[_ChunkRef] = field(default_factory=list)


def _check_options(opt: PackOption) -> None:
    opt.validate()
    refused = {
        "backend": opt.backend not in ("fused", "numpy"),
        "compressor": opt.compressor != "none",
        "chunking": opt.chunking != "cdc",
        "digester": opt.digester != "sha256",
        "digest_backend": opt.digest_backend != "",
        "batch_size": opt.batch_size != 0,
        "encrypt": opt.encrypt,
        "aligned_chunk": opt.aligned_chunk,
        "prefetch_patterns": opt.prefetch_patterns != "",
        "chunk_dict_path": opt.chunk_dict_path != "",
    }
    bad = [f"{k}={getattr(opt, k)!r}" for k, v in refused.items() if v]
    if bad:
        raise ConvertError(f"pack_layer does not support {', '.join(bad)}")


def _host_chunks(stream: np.ndarray, params: cdc.CDCParams) -> tuple[np.ndarray, list[bytes]]:
    """The host oracle for one file: numpy CDC cuts + hashlib digests."""
    cuts = cdc.chunk_data_np(stream, params)
    digests = []
    prev = 0
    for cut in cuts:
        digests.append(hashlib.sha256(stream[prev:int(cut)]).digest())
        prev = int(cut)
    return cuts, digests


def pack_layer(
    src_tar: bytes,
    opt: PackOption,
    chunk_dict=None,
    device: "str | torch.device | None" = None,
) -> tuple[bytes, PackResult]:
    """Pack one layer tar -> (framed layer blob bytes, PackResult).

    ``chunk_dict`` is a loaded dict object (models/bootstrap.ChunkDict or
    anything with its get/blob_id_for/bootstrap interface). ``device`` is
    where the fused backend runs (CUDA unless ``"cpu"`` is asked for).
    """
    _check_options(opt)
    params = cdc.CDCParams(opt.chunk_size)
    engine = (
        fused_convert.FusedDeviceEngine(opt.chunk_size, device=device)
        if opt.backend == "fused"
        else None
    )
    raw = memoryview(src_tar)

    metas: dict[str, _Meta] = {}
    opaque_dirs: list[str] = []
    plan: list[tuple[_Meta, int, int]] = []  # (meta, data offset, size)

    def walk_member(tf: tarfile.TarFile, info: tarfile.TarInfo) -> None:
        path = fstree.norm_path(info.name)
        special = fstree.classify_special(path)
        if special is not None:
            kind, target = special
            if kind == "opaque":
                opaque_dirs.append(target)
            else:
                metas[target] = _Meta(entry=fstree.whiteout_entry(target))
            return
        entry = fstree.entry_from_tarinfo(tf, info, path, with_data=False)
        meta = _Meta(entry=entry)
        # A path repeated in the tar: last entry wins (as in a real
        # extraction); chunks already written for the earlier one stay in
        # the blob as dead bytes.
        metas[path] = meta
        if not (entry.is_regular and info.size > 0):
            return
        if info.sparse:
            raise ConvertError(f"sparse tar member {path!r} is not supported")
        meta.size = info.size
        plan.append((meta, info.offset_data, info.size))

    try:
        tf = tarfile.open(fileobj=io.BytesIO(src_tar), mode="r:")
    except tarfile.TarError as e:
        raise ConvertError(f"bad layer tar: {e}") from e
    with tf:
        try:
            for info in tf:
                walk_member(tf, info)
        except tarfile.TarError as e:
            raise ConvertError(f"bad layer tar: {e}") from e

    # Chunk + digest every planned file: device batches, or the host oracle.
    arr_all = np.frombuffer(src_tar, dtype=np.uint8)
    streams = [arr_all[off : off + size] for _m, off, size in plan]
    if engine is not None:
        per_file = []
        try:
            for batch in engine.split_batches([s.size for s in streams]):
                fres = engine.process_many([streams[i] for i in batch])
                per_file.extend(zip(fres.cuts, fres.digests))
        except fused_convert.FusedOverflow as e:
            raise ConvertError(f"fused backend cannot take this layer: {e}") from e
    else:
        per_file = [_host_chunks(s, params) for s in streams]

    # Dedup (chunk order = tar order; deterministic) and blob assembly.
    own_chunks: dict[bytes, int] = {}
    uncomp_offsets: list[int] = []
    extents: list[tuple[int, int, int]] = []  # (coff, csize, flags) per unique chunk
    blob_parts: list[memoryview] = []
    blob_hash = hashlib.sha256()
    uoff = 0
    coff = 0
    dict_hits: dict[bytes, ChunkRecord] = {}
    dict_blobs_used: list[str] = []
    for (meta, off, _size), (cuts, digests) in zip(plan, per_file):
        prev = 0
        for cut, digest in zip(cuts, digests):
            data = raw[off + prev : off + int(cut)]
            prev = int(cut)
            ref = _ChunkRef(digest=digest, size=len(data))
            if chunk_dict is not None and digest not in dict_hits and digest not in own_chunks:
                hit = chunk_dict.get(digest)
                if hit is not None:
                    dict_hits[digest] = hit
                    bid = chunk_dict.blob_id_for(hit)
                    if bid not in dict_blobs_used:
                        dict_blobs_used.append(bid)
            if digest in dict_hits:
                ref.dict_hit = dict_hits[digest]
            else:
                idx = own_chunks.get(digest)
                if idx is None:
                    idx = len(uncomp_offsets)
                    own_chunks[digest] = idx
                    uncomp_offsets.append(uoff)
                    # compressor "none": the stored frame is the chunk itself
                    extents.append((coff, len(data), constants.COMPRESSOR_NONE))
                    blob_parts.append(data)
                    blob_hash.update(data)
                    coff += len(data)
                    uoff += len(data)
                ref.uniq_idx = idx
            meta.chunks.append(ref)

    out = io.BytesIO()
    blob_size = coff
    blob_id = blob_hash.hexdigest() if blob_size else ""
    for part in blob_parts:
        out.write(part)
    if blob_size:
        out.write(nydus_tar.make_header(toc.ENTRY_BLOB_DATA, blob_size))

    # Synthesize root + missing parents (metadata only).
    for p in fstree.missing_parents(metas):
        metas[p] = _Meta(entry=fstree.FileEntry(path=p, mode=stat.S_IFDIR | 0o755))
    for d in opaque_dirs:
        if d not in metas:
            metas[d] = _Meta(entry=fstree.FileEntry(path=d, mode=stat.S_IFDIR | 0o755))
        metas[d].entry.flags |= fstree.INODE_FLAG_OPAQUE
        metas[d].entry.xattrs[fstree.OPAQUE_XATTR] = b"y"

    # Blob + cipher + batch tables (own blob first, then dict blobs).
    blob_table: list[BlobRecord] = []
    cipher_table: list[CipherRecord] = []
    batch_table: list[BatchRecord] = []
    blob_index_of: dict[str, int] = {}
    if blob_size:
        blob_index_of[blob_id] = 0
        blob_table.append(
            BlobRecord(
                blob_id=blob_id,
                compressed_size=blob_size,
                uncompressed_size=uoff,
                chunk_count=len(uncomp_offsets),
            )
        )
        cipher_table.append(CipherRecord())
    for bid in dict_blobs_used:
        new_idx = len(blob_table)
        blob_index_of[bid] = new_idx
        dict_idx, dict_rec = next(
            (i, b) for i, b in enumerate(chunk_dict.bootstrap.blobs) if b.blob_id == bid
        )
        blob_table.append(
            BlobRecord(
                blob_id=bid,
                compressed_size=dict_rec.compressed_size,
                uncompressed_size=dict_rec.uncompressed_size,
                chunk_count=dict_rec.chunk_count,
                flags=dict_rec.flags,
            )
        )
        cipher_table.append(chunk_dict.bootstrap.cipher_for(dict_idx) or CipherRecord())
        for b in chunk_dict.bootstrap.batches:
            if b.blob_index == dict_idx:
                batch_table.append(
                    BatchRecord(new_idx, b.compressed_offset, b.uncompressed_base, b.uncompressed_size)
                )

    # Inodes + chunk table in path-sorted order (bootstrap serialization
    # order), records resolved against the final extent table.
    inodes: list[Inode] = []
    chunk_records: list[ChunkRecord] = []
    for path in sorted(metas):
        meta = metas[path]
        inode = fstree.entry_to_inode(meta.entry)
        inode.size = meta.size
        if meta.chunks:
            inode.chunk_index = len(chunk_records)
            inode.chunk_count = len(meta.chunks)
            for ref in meta.chunks:
                if ref.dict_hit is not None:
                    hit = ref.dict_hit
                    chunk_records.append(
                        ChunkRecord(
                            digest=ref.digest,
                            blob_index=blob_index_of[chunk_dict.blob_id_for(hit)],
                            flags=hit.flags,
                            uncompressed_offset=hit.uncompressed_offset,
                            compressed_offset=hit.compressed_offset,
                            uncompressed_size=hit.uncompressed_size,
                            compressed_size=hit.compressed_size,
                        )
                    )
                else:
                    coff_c, csize, cflag = extents[ref.uniq_idx]
                    chunk_records.append(
                        ChunkRecord(
                            digest=ref.digest,
                            blob_index=blob_index_of[blob_id],
                            flags=cflag,
                            uncompressed_offset=uncomp_offsets[ref.uniq_idx],
                            compressed_offset=coff_c,
                            uncompressed_size=ref.size,
                            compressed_size=csize,
                        )
                    )
        inodes.append(inode)

    bootstrap = Bootstrap(
        version=opt.fs_version,
        chunk_size=opt.chunk_size,
        inodes=inodes,
        chunks=chunk_records,
        blobs=blob_table,
        ciphers=cipher_table if any(c.algo for c in cipher_table) else [],
        batches=batch_table,
        prefetch=[],
    )
    boot_bytes = bootstrap.to_bytes()

    toc_entries = []
    if blob_size:
        toc_entries.append(
            toc.TOCEntry(
                name=toc.ENTRY_BLOB_DATA,
                flags=constants.COMPRESSOR_NONE,
                uncompressed_digest=blob_hash.digest(),
                compressed_offset=0,
                compressed_size=blob_size,
                uncompressed_size=blob_size,
            )
        )
    boot_off = out.tell()
    out.write(boot_bytes)
    out.write(nydus_tar.make_header(toc.ENTRY_BOOTSTRAP, len(boot_bytes)))
    toc_entries.append(
        toc.TOCEntry(
            name=toc.ENTRY_BOOTSTRAP,
            flags=constants.COMPRESSOR_NONE,
            uncompressed_digest=hashlib.sha256(boot_bytes).digest(),
            compressed_offset=boot_off,
            compressed_size=len(boot_bytes),
            uncompressed_size=len(boot_bytes),
        )
    )
    toc_bytes = toc.pack_toc(toc_entries)
    out.write(toc_bytes)
    out.write(nydus_tar.make_header(toc.ENTRY_BLOB_TOC, len(toc_bytes)))

    return out.getvalue(), PackResult(
        blob_id=blob_id,
        blob_size=blob_size,
        bootstrap=boot_bytes,
        referenced_blob_ids=[b.blob_id for b in blob_table],
    )
