"""Blob table-of-contents entries.

Binary-compatible with the reference's 128-byte ``TOCEntry``
(pkg/converter/types.go:147-202): little-endian, fields at the same offsets,
including the trailing alignment pad. A nydus blob that carries the
``blob-toc`` feature ends with a run of these entries describing the sections
(chunk data, inline meta, digest) inside the blob.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass

from nydus_snapshotter_tpu_torch import constants

# Flags u32 | Reserved1 u32 | Name [16] | UncompressedDigest [32]
# | CompressedOffset u64 | CompressedSize u64 | UncompressedSize u64
# | Reserved2 [44] | pad to 128 (Go struct alignment).
_TOC_STRUCT = struct.Struct("<II16s32sQQQ44s4x")
TOC_ENTRY_SIZE = 128
assert _TOC_STRUCT.size == TOC_ENTRY_SIZE

# Well-known section names inside a nydus blob
# (reference pkg/converter/convert_unix.go:45-49).
ENTRY_BLOB_DATA = "image.blob"
ENTRY_BLOB_META = "blob.meta"
ENTRY_BLOB_META_HEADER = "blob.meta.header"
ENTRY_BLOB_DIGEST = "blob.digest"
ENTRY_BLOB_TOC = "rafs.blob.toc"
ENTRY_BOOTSTRAP = "image.boot"


class TOCError(ValueError):
    pass


@dataclass
class TOCEntry:
    name: str
    flags: int = 0
    uncompressed_digest: bytes = b"\x00" * 32
    compressed_offset: int = 0
    compressed_size: int = 0
    uncompressed_size: int = 0

    def compressor(self) -> int:
        c = self.flags & constants.COMPRESSOR_MASK
        if c in (
            constants.COMPRESSOR_NONE,
            constants.COMPRESSOR_ZSTD,
            constants.COMPRESSOR_LZ4_BLOCK,
        ):
            return c
        raise TOCError(f"unsupported compressor, entry flags {self.flags:#x}")

    def pack(self) -> bytes:
        name = self.name.encode()
        if len(name) > 16:
            raise TOCError(f"TOC entry name too long: {self.name!r}")
        if len(self.uncompressed_digest) != 32:
            raise TOCError("uncompressed digest must be 32 bytes")
        return _TOC_STRUCT.pack(
            self.flags,
            0,
            name.ljust(16, b"\x00"),
            self.uncompressed_digest,
            self.compressed_offset,
            self.compressed_size,
            self.uncompressed_size,
            b"\x00" * 44,
        )

    @classmethod
    def unpack(cls, buf: bytes) -> "TOCEntry":
        if len(buf) != TOC_ENTRY_SIZE:
            raise TOCError(f"TOC entry must be {TOC_ENTRY_SIZE} bytes, got {len(buf)}")
        flags, _r1, name, digest, coff, csize, usize, _r2 = _TOC_STRUCT.unpack(buf)
        return cls(
            name=name.split(b"\x00", 1)[0].decode(),
            flags=flags,
            uncompressed_digest=digest,
            compressed_offset=coff,
            compressed_size=csize,
            uncompressed_size=usize,
        )


def pack_toc(entries: list[TOCEntry]) -> bytes:
    return b"".join(e.pack() for e in entries)


def unpack_toc(buf: bytes) -> list[TOCEntry]:
    if len(buf) % TOC_ENTRY_SIZE != 0:
        raise TOCError(f"TOC size {len(buf)} not a multiple of {TOC_ENTRY_SIZE}")
    return [
        TOCEntry.unpack(buf[i : i + TOC_ENTRY_SIZE])
        for i in range(0, len(buf), TOC_ENTRY_SIZE)
    ]
