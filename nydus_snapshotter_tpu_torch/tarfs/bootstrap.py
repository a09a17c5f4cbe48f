"""tar-tarfs bootstrap: index a plain tar file as a RAFS layer in place.

Replaces the reference's ``nydus-image create --type tar-tarfs``
(pkg/tarfs/tarfs.go:253-270): the uncompressed layer tar itself is the data
blob; the bootstrap's chunks point straight at each file's data region
inside the tar (offset = tar data offset), so the kernel can read file
contents from a loop-attached tar with zero copies.

Chunk digests are computed over the indexed regions with the same batched
engine the converter uses (``ChunkDigestEngine.digest_many``: SHA-256 on
kernel K2, BLAKE3 on K4 when the engine runs on the card), so this build
source takes the device digest path exactly like Pack does (SURVEY §7
stage 5).
"""

from __future__ import annotations

import hashlib
import stat as statmod
import tarfile
from typing import BinaryIO, Optional

from nydus_snapshotter_tpu_torch.models import fstree, layout
from nydus_snapshotter_tpu_torch.models.bootstrap import (
    INODE_FLAG_OPAQUE,
    INODE_FLAG_WHITEOUT,
    BlobRecord,
    Bootstrap,
    ChunkRecord,
    Inode,
)
from nydus_snapshotter_tpu_torch.models.fstree import (
    OPAQUE_MARKER,
    OPAQUE_XATTR,
    WHITEOUT_PREFIX,
    FileEntry,
)

DEFAULT_CHUNK_SIZE = 0x400000


def _digest_regions(
    blob: BinaryIO, regions: list[tuple[int, int]], engine=None
) -> list[bytes]:
    """sha256 per (offset, size) region; routed through the converter's
    batched engine when one is supplied, host hashlib otherwise."""
    datas = []
    for off, size in regions:
        blob.seek(off)
        datas.append(blob.read(size))
    if engine is not None:
        return engine.digest_many(datas)
    return [hashlib.sha256(d).digest() for d in datas]


def tarfs_bootstrap_from_tar(
    tar_file: BinaryIO,
    blob_id: str,
    chunk_size: int = DEFAULT_CHUNK_SIZE,
    fs_version: str = layout.RAFS_V6,
    engine=None,
) -> Bootstrap:
    """Index ``tar_file`` (seekable, uncompressed) into a layer bootstrap.

    Whiteout markers get the same RAFS normalization as the converter path
    (fstree.tree_from_tar) so converter.Merge overlays tarfs layers
    identically.
    """
    entries: dict[str, FileEntry] = {}
    opaque_dirs: list[str] = []
    # path -> list of (tar data offset, size) chunk regions
    regions: dict[str, list[tuple[int, int]]] = {}

    tar_file.seek(0)
    tf = tarfile.open(fileobj=tar_file, mode="r:")
    for info in tf:
        path = fstree._norm(info.name)
        base = path.rsplit("/", 1)[1] if path != "/" else "/"
        if base == OPAQUE_MARKER:
            opaque_dirs.append(path.rsplit("/", 1)[0] or "/")
            continue
        if base.startswith(WHITEOUT_PREFIX):
            target = fstree._norm(
                path.rsplit("/", 1)[0] + "/" + base[len(WHITEOUT_PREFIX) :]
            )
            entries[target] = FileEntry(
                path=target, mode=statmod.S_IFCHR, flags=INODE_FLAG_WHITEOUT
            )
            continue
        entry = fstree.entry_from_tarinfo(tf, info, path, with_data=False)
        entries[path] = entry
        # last member wins: a replacement entry must not inherit a prior
        # regular file's data regions
        regions.pop(path, None)
        if info.isreg() and info.size > 0:
            file_regions = []
            off = info.offset_data
            remaining = info.size
            while remaining > 0:
                step = min(chunk_size, remaining)
                file_regions.append((off, step))
                off += step
                remaining -= step
            regions[path] = file_regions

    for d in opaque_dirs:
        if d not in entries:
            entries[d] = FileEntry(path=d, mode=statmod.S_IFDIR | 0o755)
        entries[d].flags |= INODE_FLAG_OPAQUE
        entries[d].xattrs[OPAQUE_XATTR] = b"y"

    ordered = fstree.ensure_parents(sorted(entries.values(), key=lambda e: e.path))

    # Flatten all regions (stable path order) for one batched digest pass.
    flat: list[tuple[int, int]] = []
    spans: dict[str, tuple[int, int]] = {}  # path -> (start, count) in flat
    for e in ordered:
        rs = regions.get(e.path)
        if rs:
            spans[e.path] = (len(flat), len(rs))
            flat.extend(rs)
    digests = _digest_regions(tar_file, flat, engine=engine)

    tar_file.seek(0, 2)
    tar_size = tar_file.tell()

    inodes: list[Inode] = []
    chunks: list[ChunkRecord] = []
    for e in ordered:
        inode = fstree.entry_to_inode(e)
        span = spans.get(e.path)
        if span is not None:
            start, count = span
            inode.chunk_index = len(chunks)
            inode.chunk_count = count
            # regular-file size is not derivable from e.data (not loaded)
            inode.size = sum(size for _, size in flat[start : start + count])
            for (off, size), digest in zip(
                flat[start : start + count], digests[start : start + count]
            ):
                chunks.append(
                    ChunkRecord(
                        digest=digest,
                        blob_index=0,
                        # the tar IS the uncompressed blob: both offsets
                        # are tar offsets, compression is identity
                        uncompressed_offset=off,
                        compressed_offset=off,
                        uncompressed_size=size,
                        compressed_size=size,
                    )
                )
        inodes.append(inode)

    blob = BlobRecord(
        blob_id=blob_id,
        compressed_size=tar_size,
        uncompressed_size=tar_size,
        chunk_count=len(chunks),
    )
    return Bootstrap(
        version=fs_version,
        chunk_size=chunk_size,
        inodes=inodes,
        chunks=chunks,
        blobs=[blob],
    )
