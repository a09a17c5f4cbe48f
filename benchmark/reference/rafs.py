"""Plain readers of what the converter emits: the port's native RAFS
bootstrap layout and the nydus blob's tar-like framing.

Bootstrap (little-endian, flat tables): a 128-byte superblock at offset 0
(v5) or 1024 (v6) -- magic, version, features, block size, chunk size,
flags, then inode, chunk and blob counts and the inode, chunk, blob and
name-heap offsets and the heap size; 96-byte inode records (ino, parent,
mode, uid, gid, rdev, mtime, size, first chunk, chunk count, name offset
and length, flags, ...); 64-byte chunk records (32-byte digest, blob index,
flags, uncompressed offset, compressed offset, uncompressed size,
compressed size); 64-byte blob records (32-byte id, compressed size,
uncompressed size, chunk count, flags).

Blob: sections written as ``data | 512-byte tar header`` with no padding,
the last one a table of contents; a reader walks the headers backwards.
"""

from __future__ import annotations

import struct
import tarfile
from dataclasses import dataclass

import numpy as np

V5_MAGIC, V6_MAGIC = 0x52414653, 0xE0F5E1E2
_SB = struct.Struct("<IIIIIIQQQQQQQQ")
INODE = np.dtype([("ino", "<u8"), ("parent", "<u8"), ("mode", "<u4"), ("uid", "<u4"),
                  ("gid", "<u4"), ("rdev", "<u4"), ("mtime", "<u8"), ("size", "<u8"),
                  ("chunk_index", "<u4"), ("chunk_count", "<u4"), ("name_off", "<u4"),
                  ("name_len", "<u2"), ("flags", "<u2"), ("symlink_off", "<u4"),
                  ("symlink_len", "<u4"), ("xattr_off", "<u4"), ("xattr_len", "<u4"),
                  ("hardlink", "<u8"), ("pad", "V8")])
CHUNK = np.dtype([("digest", "S32"), ("blob_index", "<u4"), ("flags", "<u4"),
                  ("uoff", "<u8"), ("coff", "<u8"), ("usize", "<u4"), ("csize", "<u4")])
BLOB = np.dtype([("id", "S32"), ("csize", "<u8"), ("usize", "<u8"), ("chunk_count", "<u4"),
                 ("flags", "<u4"), ("pad", "V8")])
assert INODE.itemsize == 96 and CHUNK.itemsize == 64 and BLOB.itemsize == 64


class FormatError(ValueError):
    pass


@dataclass
class Boot:
    chunk_size: int
    paths: list[str]
    inodes: np.ndarray  # INODE records, in table order
    chunks: np.ndarray  # CHUNK records
    blob_ids: list[str]  # hex, by blob index
    blobs: np.ndarray  # BLOB records


def read_bootstrap(buf: bytes) -> Boot:
    if len(buf) >= 8 and struct.unpack_from("<II", buf, 0) == (V5_MAGIC, 0x500):
        sb_off = 0
    elif len(buf) >= 1024 + _SB.size and struct.unpack_from("<I", buf, 1024)[0] == V6_MAGIC:
        sb_off = 1024
    else:
        raise FormatError("not a RAFS bootstrap of the native layout")
    (_magic, _ver, _feat, _bs, chunk_size, _fl, n_ino, n_chunk, n_blob,
     ino_off, chunk_off, blob_off, heap_off, heap_size) = _SB.unpack_from(buf, sb_off)
    for off, count, size in ((ino_off, n_ino, 96), (chunk_off, n_chunk, 64),
                             (blob_off, n_blob, 64), (heap_off, heap_size, 1)):
        if off + count * size > len(buf):
            raise FormatError("a table overflows the bootstrap")
    inodes = np.frombuffer(buf, INODE, n_ino, ino_off)
    chunks = np.frombuffer(buf, CHUNK, n_chunk, chunk_off)
    blobs = np.frombuffer(buf, BLOB, n_blob, blob_off)
    heap = buf[heap_off : heap_off + heap_size]
    by_ino: dict[int, str] = {}
    paths = []
    for rec in inodes:
        name = heap[int(rec["name_off"]) : int(rec["name_off"]) + int(rec["name_len"])].decode()
        parent = int(rec["parent"])
        if parent == 0:
            path = "/"
        else:
            base = by_ino[parent]
            path = base + name if base == "/" else base + "/" + name
        by_ino[int(rec["ino"])] = path
        paths.append(path)
    # numpy's S32 drops trailing zero bytes: pad the ids back to 32
    ids = [bytes(b).ljust(32, b"\0").hex() for b in blobs["id"]]
    return Boot(chunk_size, paths, inodes, chunks, ids, blobs)


def blob_section(blob: bytes, name: str = "image.blob") -> tuple[int, int] | None:
    """(offset, size) of a named section of a framed nydus blob."""
    cursor = len(blob)
    while cursor >= 512:
        try:
            info = tarfile.TarInfo.frombuf(blob[cursor - 512 : cursor], "utf-8", "surrogateescape")
        except tarfile.TarError as e:
            raise FormatError(f"block ending at {cursor} is not a tar header") from e
        start = cursor - 512 - info.size
        if start < 0:
            raise FormatError(f"section {info.name!r} overflows the blob")
        if info.name == name:
            return start, info.size
        cursor = start
    return None
