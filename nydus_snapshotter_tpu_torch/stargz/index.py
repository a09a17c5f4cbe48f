"""eStargz TOC → RAFS bootstrap (the ``stargz_index`` build source).

Replaces the reference's shell-out to ``nydus-image create --source-type
stargz_index`` (pkg/filesystem/stargz_adaptor.go:227-245): the TOC already
carries per-chunk sha256 digests and compressed offsets, so the bootstrap is
emitted directly from the parsed TOC through the same ``models.bootstrap``
writer the converter uses — the image blob stays the original estargz
blob, read lazily by range.

TOC shape (stargz-snapshotter estargz jtoc): ``{"version": 1, "entries":
[{name, type, size, mode, uid, gid, linkName, offset, chunkOffset,
chunkSize, chunkDigest, devMajor, devMinor, xattrs, ...}]}`` where a regular
file's extra chunks appear as subsequent ``type=="chunk"`` entries.
"""

from __future__ import annotations

import base64
import os
import stat as statmod
from dataclasses import dataclass, field
from typing import Optional

from nydus_snapshotter_tpu_torch import constants
from nydus_snapshotter_tpu_torch.models import layout
from nydus_snapshotter_tpu_torch.models.bootstrap import (
    INODE_FLAG_HARDLINK,
    INODE_FLAG_SYMLINK,
    BlobRecord,
    Bootstrap,
    ChunkRecord,
    Inode,
)
from nydus_snapshotter_tpu_torch.utils import errdefs

DEFAULT_CHUNK_SIZE = 0x400000  # stargz_adaptor.go:237 --chunk-size


class TocError(errdefs.NydusError):
    pass


@dataclass
class TocEntry:
    name: str
    type: str
    size: int = 0
    mode: int = 0
    uid: int = 0
    gid: int = 0
    link_name: str = ""
    offset: int = 0  # compressed offset of this entry's stream in the blob
    chunk_offset: int = 0
    chunk_size: int = 0
    chunk_digest: str = ""
    digest: str = ""
    dev_major: int = 0
    dev_minor: int = 0
    xattrs: dict[str, bytes] = field(default_factory=dict)

    @classmethod
    def from_json(cls, obj: dict) -> "TocEntry":
        xattrs = {
            k: base64.b64decode(v) for k, v in (obj.get("xattrs") or {}).items()
        }
        return cls(
            name=obj.get("name", ""),
            type=obj.get("type", ""),
            size=int(obj.get("size", 0)),
            mode=int(obj.get("mode", 0)),
            uid=int(obj.get("uid", 0)),
            gid=int(obj.get("gid", 0)),
            link_name=obj.get("linkName", ""),
            offset=int(obj.get("offset", 0)),
            chunk_offset=int(obj.get("chunkOffset", 0)),
            chunk_size=int(obj.get("chunkSize", 0)),
            chunk_digest=obj.get("chunkDigest", ""),
            digest=obj.get("digest", ""),
            dev_major=int(obj.get("devMajor", 0)),
            dev_minor=int(obj.get("devMinor", 0)),
            xattrs=xattrs,
        )


def parse_toc(toc: dict) -> list[TocEntry]:
    if toc.get("version") != 1:
        raise TocError(f"unsupported stargz TOC version {toc.get('version')!r}")
    return [TocEntry.from_json(e) for e in toc.get("entries", [])]


_TYPE_BITS = {
    "dir": statmod.S_IFDIR,
    "reg": statmod.S_IFREG,
    "symlink": statmod.S_IFLNK,
    "hardlink": statmod.S_IFREG,
    "char": statmod.S_IFCHR,
    "block": statmod.S_IFBLK,
    "fifo": statmod.S_IFIFO,
}


# Go os.FileMode keeps setuid/setgid/sticky out of the low 9 permission
# bits (ModeSetuid = 1<<23, ModeSetgid = 1<<22, ModeSticky = 1<<20); the
# stargz TOC stores that representation, so translate back to Unix bits.
_GO_MODE_SETUID = 1 << 23
_GO_MODE_SETGID = 1 << 22
_GO_MODE_STICKY = 1 << 20


def _unix_perm(go_mode: int) -> int:
    perm = go_mode & 0o777
    if go_mode & _GO_MODE_SETUID:
        perm |= statmod.S_ISUID
    if go_mode & _GO_MODE_SETGID:
        perm |= statmod.S_ISGID
    if go_mode & _GO_MODE_STICKY:
        perm |= statmod.S_ISVTX
    return perm


def _norm(name: str) -> str:
    p = "/" + name.strip("/")
    return "/" if p == "/" else p


def _raw_digest(d: str) -> bytes:
    if not d.startswith("sha256:"):
        raise TocError(f"chunk digest {d!r} is not sha256")
    raw = bytes.fromhex(d[len("sha256:") :])
    if len(raw) != 32:
        raise TocError(f"bad sha256 length in {d!r}")
    return raw


def bootstrap_from_toc(
    toc: dict,
    blob_id: str,
    chunk_size: int = DEFAULT_CHUNK_SIZE,
    blob_compressed_size: int = 0,
    fs_version: str = layout.RAFS_V6,
    compressor: int = constants.COMPRESSOR_GZIP,
) -> Bootstrap:
    """Build the layer bootstrap pointing chunks at the estargz blob itself.

    ``blob_compressed_size`` (total blob size when known) bounds the last
    chunk's compressed extent; per-chunk compressed sizes are derived from
    consecutive TOC stream offsets. ``compressor`` is the per-chunk codec
    flag: gzip members for eStargz, or COMPRESSOR_ZSTD for zstd:chunked
    TOCs whose chunks are independent zstd frames at the same offsets —
    the TOC shape is identical, only the decode arm differs.
    """
    entries = parse_toc(toc)

    inodes: dict[str, Inode] = {
        "/": Inode(path="/", mode=statmod.S_IFDIR | 0o755)
    }
    chunks: list[ChunkRecord] = []
    # (chunk list index, stream offset) pairs for compressed-size fixup.
    offsets: list[tuple[int, int]] = []
    uncompressed_pos = 0

    def ensure_dir(path: str) -> None:
        if path in inodes:
            return
        parent = path.rsplit("/", 1)[0] or "/"
        if parent != path:
            ensure_dir(parent)
        inodes[path] = Inode(path=path, mode=statmod.S_IFDIR | 0o755)

    for e in entries:
        path = _norm(e.name)
        parent = path.rsplit("/", 1)[0] or "/"
        ensure_dir(parent)

        if e.type == "chunk":
            node = inodes.get(path)
            if node is None or not statmod.S_ISREG(node.mode):
                raise TocError(f"chunk entry for unknown regular file {path}")
            csize = e.chunk_size or (node.size - e.chunk_offset)
            offsets.append((len(chunks), e.offset))
            chunks.append(
                ChunkRecord(
                    digest=_raw_digest(e.chunk_digest),
                    flags=compressor,
                    uncompressed_offset=uncompressed_pos,
                    compressed_offset=e.offset,
                    uncompressed_size=csize,
                )
            )
            node.chunk_count += 1
            uncompressed_pos += csize
            continue

        bits = _TYPE_BITS.get(e.type)
        if bits is None:
            raise TocError(f"unknown TOC entry type {e.type!r} for {path}")
        mode = bits | _unix_perm(e.mode)
        inode = Inode(
            path=path,
            mode=mode,
            uid=e.uid,
            gid=e.gid,
            mtime=0,
            size=e.size,
            xattrs=e.xattrs,
        )
        if e.type == "symlink":
            inode.flags |= INODE_FLAG_SYMLINK
            inode.symlink_target = e.link_name
            inode.size = len(e.link_name)
        elif e.type == "hardlink":
            inode.flags |= INODE_FLAG_HARDLINK
            inode.hardlink_target = _norm(e.link_name)
        elif e.type in ("char", "block"):
            inode.rdev = os.makedev(e.dev_major, e.dev_minor)
        elif e.type == "reg" and e.size > 0:
            csize = e.chunk_size or e.size
            # Legacy (pre-estargz) TOCs carry no per-chunk digests, only the
            # whole-file digest; when the file is a single chunk the two are
            # the same object, so the file digest IS the chunk digest.
            digest_src = e.chunk_digest
            if not digest_src and csize >= e.size:
                digest_src = e.digest
            inode.chunk_index = len(chunks)
            inode.chunk_count = 1
            offsets.append((len(chunks), e.offset))
            chunks.append(
                ChunkRecord(
                    digest=_raw_digest(digest_src),
                    flags=compressor,
                    uncompressed_offset=uncompressed_pos,
                    compressed_offset=e.offset,
                    uncompressed_size=csize,
                )
            )
            uncompressed_pos += csize
        inodes[path] = inode

    # Derive compressed sizes from consecutive stream offsets; the final
    # chunk is bounded by the blob size (TOC region excluded upstream).
    by_offset = sorted(offsets, key=lambda t: t[1])
    for i, (ci, off) in enumerate(by_offset):
        if i + 1 < len(by_offset):
            chunks[ci].compressed_size = by_offset[i + 1][1] - off
        elif blob_compressed_size:
            chunks[ci].compressed_size = max(0, blob_compressed_size - off)

    blob = BlobRecord(
        blob_id=blob_id,
        compressed_size=blob_compressed_size,
        uncompressed_size=uncompressed_pos,
        chunk_count=len(chunks),
        flags=compressor,
    )
    ordered = sorted(inodes.values(), key=lambda i: i.path)
    return Bootstrap(
        version=fs_version,
        chunk_size=chunk_size,
        inodes=ordered,
        chunks=chunks,
        blobs=[blob],
    )
