"""RAFS bootstrap (filesystem metadata) model: write, parse, chunk-dict.

The bootstrap is the metadata half of a RAFS image: the file tree plus the
chunk table mapping file extents to (blob, offset, size, digest) records. The
reference delegates bootstrap emission to the external Rust ``nydus-image``
binary (pkg/converter/tool/builder.go:148-178); this framework owns the format
natively so the device chunk engine's output — flat (offset, len, digest,
dict-ref) arrays — serializes straight into the chunk table without
host-side re-shaping.

Layout choices (device-first, reference-compatible where it matters):

- Superblock magics/offsets match pkg/layout/layout.go:19-31 exactly, so
  ``detect_fs_version`` interoperates: v5 = magic+version at offset 0 within
  an 8 KiB superblock; v6 = EROFS magic at offset 1024 within a
  1024+128+256-byte superblock region.
- All tables are flat fixed-width little-endian records. The chunk table is
  64 bytes/record with the SHA-256 digest first, so it maps directly into a
  ``uint32[N, 16]`` device array for HBM chunk-dict probes — no parsing on
  the hot path.
- Inode records reference a shared bytes heap for names/symlinks/xattrs.
  Inodes are sorted by path; emission is fully deterministic (same tree +
  chunks ⇒ byte-identical bootstrap), which is the reference's correctness
  bar (tests/converter_test.go:380-530).
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field
from typing import Iterable, Optional

import numpy as np

from nydus_snapshotter_tpu_torch import constants
from nydus_snapshotter_tpu_torch.models import layout

# ---------------------------------------------------------------------------
# Record layouts
# ---------------------------------------------------------------------------

# Superblock body (shared between v5/v6; only its file offset differs):
# magic u32 | version u32 | features u32 | block_size u32 | chunk_size u32 |
# flags u32 | inode_count u64 | chunk_count u64 | blob_count u64 |
# inode_table_off u64 | chunk_table_off u64 | blob_table_off u64 |
# heap_off u64 | heap_size u64 | pad to 128
_SB_STRUCT = struct.Struct("<IIIIIIQQQQQQQQ")
_SB_SIZE = 128
assert _SB_STRUCT.size <= _SB_SIZE

# Optional table pointers live in the superblock's spare region (directly
# after _SB_STRUCT): cipher_table_off u64 | cipher_count u64 |
# batch_table_off u64 | batch_count u64. Each pair is meaningful only when
# its feature bit is set; zero in older bootstraps.
_SB_CIPHER_STRUCT = struct.Struct("<QQ")
_SB_CIPHER_OFF = _SB_STRUCT.size
_SB_BATCH_STRUCT = struct.Struct("<QQ")
_SB_BATCH_OFF = _SB_CIPHER_OFF + _SB_CIPHER_STRUCT.size
assert _SB_BATCH_OFF + _SB_BATCH_STRUCT.size <= _SB_SIZE
# Prefetch table pointer: u32 offset + u32 count packs into the superblock's
# last spare 8 bytes (entries are u32 inode numbers, hint order preserved —
# the reference's --prefetch-files table, consumed by nydusd at mount).
_SB_PREFETCH_STRUCT = struct.Struct("<II")
_SB_PREFETCH_OFF = _SB_BATCH_OFF + _SB_BATCH_STRUCT.size
assert _SB_PREFETCH_OFF + _SB_PREFETCH_STRUCT.size <= _SB_SIZE

# Feature bits (superblock ``features`` field).
FEATURE_CIPHER_TABLE = 0x1
FEATURE_BATCH_TABLE = 0x2
FEATURE_PREFETCH_TABLE = 0x4

_V5_HEADER_SIZE = 8 * 1024  # reference: v5 = 8K superblock region
_V6_HEADER_SIZE = layout.RAFS_V6_SUPER_BLOCK_SIZE  # 1024 + 128 + 256

# Inode record:
# ino u64 | parent u64 | mode u32 | uid u32 | gid u32 | rdev u32 |
# mtime u64 | size u64 | chunk_index u32 | chunk_count u32 |
# name_off u32 | name_len u16 | flags u16 | symlink_off u32 | symlink_len u32 |
# xattr_off u32 | xattr_len u32 | hardlink_ino u64 | pad to 96
_INODE_STRUCT = struct.Struct("<QQIIIIQQIIIHHIIIIQ")
INODE_SIZE = 96
assert _INODE_STRUCT.size <= INODE_SIZE

# Chunk record (64 B — loads as uint32[16] lanes on device):
# digest 32s | blob_index u32 | flags u32 | uncompressed_offset u64 |
# compressed_offset u64 | uncompressed_size u32 | compressed_size u32
_CHUNK_STRUCT = struct.Struct("<32sIIQQII")
CHUNK_SIZE_BYTES = 64
assert _CHUNK_STRUCT.size == CHUNK_SIZE_BYTES

# Blob record: blob_id 32s | compressed_size u64 | uncompressed_size u64 |
# chunk_count u32 | flags u32 | pad to 64
_BLOB_STRUCT = struct.Struct("<32sQQII")
BLOB_SIZE_BYTES = 64
assert _BLOB_STRUCT.size <= BLOB_SIZE_BYTES

SUPER_VERSION_V5 = layout.RAFS_V5_SUPER_VERSION
SUPER_VERSION_V6 = 0x600

# Chunk flags: low nibble carries the compressor bits (constants.COMPRESSOR_*).
CHUNK_FLAG_COMPRESSED_ZSTD = constants.COMPRESSOR_ZSTD
CHUNK_FLAG_FROM_DICT = 0x100
# Batched chunk (reference ``--batch-size``, tool/builder.go:131-134): several
# small chunks compressed as one unit. ``compressed_offset/size`` describe the
# shared batch extent in the blob; the batch's uncompressed base and size live
# in the bootstrap's batch table keyed by (blob_index, compressed_offset), so
# a bootstrap referencing only *some* members of a foreign (chunk-dict) batch
# still resolves them correctly.
CHUNK_FLAG_BATCH = 0x200

# Cipher record: algo u32 | reserved u32 | key 32s | iv 16s | pad to 64.
_CIPHER_STRUCT = struct.Struct("<II32s16s")
CIPHER_SIZE_BYTES = 64
assert _CIPHER_STRUCT.size <= CIPHER_SIZE_BYTES

# Batch record: blob_index u32 | reserved u32 | compressed_offset u64 |
# uncompressed_base u64 | uncompressed_size u64 = 32 bytes.
_BATCH_STRUCT = struct.Struct("<IIQQQ")
BATCH_SIZE_BYTES = 32
assert _BATCH_STRUCT.size == BATCH_SIZE_BYTES


class BootstrapError(ValueError):
    pass


# ---------------------------------------------------------------------------
# In-memory model
# ---------------------------------------------------------------------------


@dataclass
class ChunkRecord:
    digest: bytes  # raw 32-byte digest (SHA-256 or BLAKE3) of uncompressed chunk data
    blob_index: int = 0
    flags: int = 0
    uncompressed_offset: int = 0
    compressed_offset: int = 0
    uncompressed_size: int = 0
    compressed_size: int = 0

    def pack(self) -> bytes:
        if len(self.digest) != 32:
            raise BootstrapError("chunk digest must be raw 32 bytes")
        return _CHUNK_STRUCT.pack(
            self.digest,
            self.blob_index,
            self.flags,
            self.uncompressed_offset,
            self.compressed_offset,
            self.uncompressed_size,
            self.compressed_size,
        )

    @classmethod
    def unpack(cls, buf: bytes) -> "ChunkRecord":
        d, bi, fl, uo, co, us, cs = _CHUNK_STRUCT.unpack(buf)
        return cls(d, bi, fl, uo, co, us, cs)


@dataclass
class BlobRecord:
    blob_id: str  # hex sha256 of the blob
    compressed_size: int = 0
    uncompressed_size: int = 0
    chunk_count: int = 0
    flags: int = 0

    def pack(self) -> bytes:
        raw = bytes.fromhex(self.blob_id)
        if len(raw) != 32:
            raise BootstrapError(f"blob id must be hex sha256: {self.blob_id!r}")
        return _BLOB_STRUCT.pack(
            raw, self.compressed_size, self.uncompressed_size, self.chunk_count, self.flags
        ).ljust(BLOB_SIZE_BYTES, b"\x00")

    @classmethod
    def unpack(cls, buf: bytes) -> "BlobRecord":
        raw, csize, usize, count, flags = _BLOB_STRUCT.unpack(buf[: _BLOB_STRUCT.size])
        return cls(raw.hex(), csize, usize, count, flags)


@dataclass
class CipherRecord:
    """Per-blob cipher context (reference ``--encrypt``: blob data is
    encrypted with the context stored in image metadata, key protection
    coming from ocicrypt-encrypting the bootstrap layer itself,
    pkg/encryption/encryption.go:143-253)."""

    algo: int = 0  # converter/crypto.CIPHER_* (0 = blob not encrypted)
    key: bytes = b""
    iv: bytes = b""

    def pack(self) -> bytes:
        if self.algo and (len(self.key) != 32 or len(self.iv) != 16):
            raise BootstrapError("cipher context needs a 32-byte key and 16-byte iv")
        return _CIPHER_STRUCT.pack(
            self.algo, 0, self.key.ljust(32, b"\x00"), self.iv.ljust(16, b"\x00")
        ).ljust(CIPHER_SIZE_BYTES, b"\x00")

    @classmethod
    def unpack(cls, buf: bytes) -> "CipherRecord":
        algo, _reserved, key, iv = _CIPHER_STRUCT.unpack(buf[: _CIPHER_STRUCT.size])
        if not algo:
            return cls()
        return cls(algo=algo, key=key, iv=iv)


@dataclass
class BatchRecord:
    """One batch extent: which blob it lives in, where its compressed bytes
    are, and the uncompressed address range its members cover."""

    blob_index: int
    compressed_offset: int
    uncompressed_base: int
    uncompressed_size: int

    def pack(self) -> bytes:
        return _BATCH_STRUCT.pack(
            self.blob_index,
            0,
            self.compressed_offset,
            self.uncompressed_base,
            self.uncompressed_size,
        )

    @classmethod
    def unpack(cls, buf: bytes) -> "BatchRecord":
        bi, _reserved, coff, base, usize = _BATCH_STRUCT.unpack(buf[: _BATCH_STRUCT.size])
        return cls(bi, coff, base, usize)


# Inode flags
INODE_FLAG_SYMLINK = 0x1
INODE_FLAG_HARDLINK = 0x2
INODE_FLAG_OPAQUE = 0x4  # overlayfs whiteout-opaque directory
INODE_FLAG_WHITEOUT = 0x8


@dataclass
class Inode:
    path: str  # absolute within image, "/" for root
    mode: int = 0o755
    uid: int = 0
    gid: int = 0
    rdev: int = 0
    mtime: int = 0
    size: int = 0
    flags: int = 0
    symlink_target: str = ""
    xattrs: dict[str, bytes] = field(default_factory=dict)
    hardlink_target: str = ""  # path of link target when FLAG_HARDLINK
    chunk_index: int = 0  # first chunk in the global chunk table
    chunk_count: int = 0
    ino: int = 0  # assigned at serialize time (1-based, path order)
    parent_ino: int = 0


def _pack_xattrs(xattrs: dict[str, bytes]) -> bytes:
    out = bytearray()
    for key in sorted(xattrs):
        kb = key.encode()
        vb = xattrs[key]
        out += struct.pack("<HI", len(kb), len(vb)) + kb + vb
    return bytes(out)


def _unpack_xattrs(buf: bytes) -> dict[str, bytes]:
    out: dict[str, bytes] = {}
    off = 0
    while off < len(buf):
        try:
            klen, vlen = struct.unpack_from("<HI", buf, off)
            off += 6
            key = buf[off : off + klen].decode()
        except (struct.error, UnicodeDecodeError) as e:
            raise BootstrapError(f"corrupt xattr region at byte {off}: {e}") from e
        off += klen
        if off + vlen > len(buf):
            raise BootstrapError("xattr value overflows its region")
        out[key] = buf[off : off + vlen]
        off += vlen
    return out


@dataclass
class Bootstrap:
    """A complete RAFS metadata image."""

    version: str = layout.RAFS_V6
    chunk_size: int = 0x100000
    inodes: list[Inode] = field(default_factory=list)
    chunks: list[ChunkRecord] = field(default_factory=list)
    blobs: list[BlobRecord] = field(default_factory=list)
    # Parallel to ``blobs`` when any blob is encrypted (algo 0 entries for
    # plaintext blobs); empty when no encryption is in play.
    ciphers: list[CipherRecord] = field(default_factory=list)
    # Batch extents for CHUNK_FLAG_BATCH chunks; empty without batching.
    batches: list[BatchRecord] = field(default_factory=list)
    # Prefetch hints: inode paths in priority order (serialized as inode
    # numbers; the runtime warms these before first access).
    prefetch: list[str] = field(default_factory=list)

    def cipher_for(self, blob_index: int) -> Optional[CipherRecord]:
        """The cipher context of blob ``blob_index`` (None = plaintext)."""
        if blob_index < len(self.ciphers) and self.ciphers[blob_index].algo:
            return self.ciphers[blob_index]
        return None

    def batch_map(self) -> dict[tuple[int, int], tuple[int, int]]:
        """(blob_index, compressed_offset) -> (uncompressed_base, size)."""
        return {
            (b.blob_index, b.compressed_offset): (b.uncompressed_base, b.uncompressed_size)
            for b in self.batches
        }

    # -- serialization ------------------------------------------------------

    def to_bytes(self) -> bytes:
        if self.version not in (layout.RAFS_V5, layout.RAFS_V6):
            raise BootstrapError(f"unknown RAFS version {self.version!r}")
        header_size = _V5_HEADER_SIZE if self.version == layout.RAFS_V5 else _V6_HEADER_SIZE

        inodes = sorted(self.inodes, key=lambda i: _path_key(i.path))
        ino_by_path = {inode.path: idx + 1 for idx, inode in enumerate(inodes)}
        if len(ino_by_path) != len(inodes):
            seen: set[str] = set()
            for inode in inodes:
                if inode.path in seen:
                    raise BootstrapError(f"duplicate inode path {inode.path!r}")
                seen.add(inode.path)

        heap = bytearray()
        inode_buf = bytearray()
        for idx, inode in enumerate(inodes):
            inode.ino = idx + 1
            parent = _parent_path(inode.path)
            if inode.path == "/":
                inode.parent_ino = 0
            else:
                try:
                    inode.parent_ino = ino_by_path[parent]
                except KeyError:
                    raise BootstrapError(f"missing parent directory inode for {inode.path!r}")
            name = ("/" if inode.path == "/" else inode.path.rsplit("/", 1)[1]).encode()
            name_off = len(heap)
            heap += name
            link = inode.symlink_target.encode()
            symlink_off = len(heap) if link else 0
            heap += link
            xattr_buf = _pack_xattrs(inode.xattrs)
            xattr_off = len(heap) if xattr_buf else 0
            heap += xattr_buf
            if inode.hardlink_target:
                try:
                    hardlink_ino = ino_by_path[inode.hardlink_target]
                except KeyError:
                    raise BootstrapError(
                        f"hardlink target {inode.hardlink_target!r} of {inode.path!r} not in tree"
                    )
            else:
                hardlink_ino = 0
            inode_buf += _INODE_STRUCT.pack(
                inode.ino,
                inode.parent_ino,
                inode.mode,
                inode.uid,
                inode.gid,
                inode.rdev,
                inode.mtime,
                inode.size,
                inode.chunk_index,
                inode.chunk_count,
                name_off,
                len(name),
                inode.flags,
                symlink_off,
                len(link),
                xattr_off,
                len(xattr_buf),
                hardlink_ino,
            ).ljust(INODE_SIZE, b"\x00")

        chunk_buf = b"".join(c.pack() for c in self.chunks)
        blob_buf = b"".join(b.pack() for b in self.blobs)

        prefetch_buf = b""
        for path in self.prefetch:
            ino = ino_by_path.get(path)
            if ino is None:
                raise BootstrapError(f"prefetch path {path!r} not in tree")
            prefetch_buf += struct.pack("<I", ino)

        if self.ciphers and len(self.ciphers) != len(self.blobs):
            raise BootstrapError(
                f"cipher table has {len(self.ciphers)} entries for "
                f"{len(self.blobs)} blobs"
            )
        has_ciphers = any(c.algo for c in self.ciphers)
        cipher_buf = b"".join(c.pack() for c in self.ciphers) if has_ciphers else b""
        batch_buf = b"".join(b.pack() for b in self.batches)

        inode_table_off = header_size
        chunk_table_off = inode_table_off + len(inode_buf)
        blob_table_off = chunk_table_off + len(chunk_buf)
        cipher_table_off = blob_table_off + len(blob_buf)
        batch_table_off = cipher_table_off + len(cipher_buf)
        prefetch_table_off = batch_table_off + len(batch_buf)
        heap_off = prefetch_table_off + len(prefetch_buf)

        magic = (
            layout.RAFS_V5_SUPER_MAGIC
            if self.version == layout.RAFS_V5
            else layout.RAFS_V6_SUPER_MAGIC
        )
        sb_version = SUPER_VERSION_V5 if self.version == layout.RAFS_V5 else SUPER_VERSION_V6
        features = (
            (FEATURE_CIPHER_TABLE if has_ciphers else 0)
            | (FEATURE_BATCH_TABLE if self.batches else 0)
            | (FEATURE_PREFETCH_TABLE if self.prefetch else 0)
        )
        sb = _SB_STRUCT.pack(
            magic,
            sb_version,
            features,
            4096,
            self.chunk_size,
            0,
            len(inodes),
            len(self.chunks),
            len(self.blobs),
            inode_table_off,
            chunk_table_off,
            blob_table_off,
            heap_off,
            len(heap),
        ).ljust(_SB_SIZE, b"\x00")
        if has_ciphers:
            sb = (
                sb[:_SB_CIPHER_OFF]
                + _SB_CIPHER_STRUCT.pack(cipher_table_off, len(self.ciphers))
                + sb[_SB_CIPHER_OFF + _SB_CIPHER_STRUCT.size :]
            )
        if self.batches:
            sb = (
                sb[:_SB_BATCH_OFF]
                + _SB_BATCH_STRUCT.pack(batch_table_off, len(self.batches))
                + sb[_SB_BATCH_OFF + _SB_BATCH_STRUCT.size :]
            )
        if self.prefetch:
            sb = (
                sb[:_SB_PREFETCH_OFF]
                + _SB_PREFETCH_STRUCT.pack(prefetch_table_off, len(self.prefetch))
                + sb[_SB_PREFETCH_OFF + _SB_PREFETCH_STRUCT.size :]
            )

        header = bytearray(header_size)
        if self.version == layout.RAFS_V5:
            header[:_SB_SIZE] = sb
        else:
            # v6: EROFS-style — superblock region at offset 1024.
            header[layout.RAFS_V6_SUPER_BLOCK_OFFSET : layout.RAFS_V6_SUPER_BLOCK_OFFSET + _SB_SIZE] = sb

        return (
            bytes(header)
            + bytes(inode_buf)
            + chunk_buf
            + blob_buf
            + cipher_buf
            + batch_buf
            + prefetch_buf
            + bytes(heap)
        )

    @classmethod
    def from_bytes(cls, buf: bytes) -> "Bootstrap":
        version = layout.detect_fs_version(buf[: layout.MAX_SUPER_BLOCK_SIZE])
        sb_off = 0 if version == layout.RAFS_V5 else layout.RAFS_V6_SUPER_BLOCK_OFFSET
        (
            _magic,
            sb_version,
            features,
            _block_size,
            chunk_size,
            _flags,
            inode_count,
            chunk_count,
            blob_count,
            inode_table_off,
            chunk_table_off,
            blob_table_off,
            heap_off,
            heap_size,
        ) = _SB_STRUCT.unpack_from(buf, sb_off)
        cipher_table_off = cipher_count = 0
        if features & FEATURE_CIPHER_TABLE:
            cipher_table_off, cipher_count = _SB_CIPHER_STRUCT.unpack_from(
                buf, sb_off + _SB_CIPHER_OFF
            )
            if cipher_count != blob_count:
                raise BootstrapError(
                    f"cipher table has {cipher_count} entries for {blob_count} blobs"
                )
        batch_table_off = batch_count = 0
        if features & FEATURE_BATCH_TABLE:
            batch_table_off, batch_count = _SB_BATCH_STRUCT.unpack_from(
                buf, sb_off + _SB_BATCH_OFF
            )
        prefetch_table_off = prefetch_count = 0
        if features & FEATURE_PREFETCH_TABLE:
            prefetch_table_off, prefetch_count = _SB_PREFETCH_STRUCT.unpack_from(
                buf, sb_off + _SB_PREFETCH_OFF
            )

        # A foreign bootstrap (e.g. one written by the Rust nydus-image) or a
        # truncated file can share the magic while carrying garbage fields —
        # validate every table against the buffer before trusting it.
        expected_version = SUPER_VERSION_V5 if version == layout.RAFS_V5 else SUPER_VERSION_V6
        if sb_version != expected_version:
            raise BootstrapError(
                f"unsupported bootstrap superblock version {sb_version:#x} "
                f"(foreign {version} bootstrap?)"
            )
        for name, off, count, rec_size in (
            ("inode", inode_table_off, inode_count, INODE_SIZE),
            ("chunk", chunk_table_off, chunk_count, CHUNK_SIZE_BYTES),
            ("blob", blob_table_off, blob_count, BLOB_SIZE_BYTES),
            ("cipher", cipher_table_off, cipher_count, CIPHER_SIZE_BYTES),
            ("batch", batch_table_off, batch_count, BATCH_SIZE_BYTES),
            ("prefetch", prefetch_table_off, prefetch_count, 4),
            ("heap", heap_off, heap_size, 1),
        ):
            if off + count * rec_size > len(buf):
                raise BootstrapError(
                    f"{name} table [{off}, +{count}*{rec_size}] overflows "
                    f"bootstrap of {len(buf)} bytes"
                )

        heap = buf[heap_off : heap_off + heap_size]

        inodes: list[Inode] = []
        paths_by_ino: dict[int, str] = {0: ""}
        hardlink_inos: list[int] = []
        for i in range(inode_count):
            rec = buf[inode_table_off + i * INODE_SIZE : inode_table_off + (i + 1) * INODE_SIZE]
            (
                ino,
                parent_ino,
                mode,
                uid,
                gid,
                rdev,
                mtime,
                size,
                chunk_index,
                cc,
                name_off,
                name_len,
                flags,
                symlink_off,
                symlink_len,
                xattr_off,
                xattr_len,
                hardlink_ino,
            ) = _INODE_STRUCT.unpack(rec[: _INODE_STRUCT.size])
            for what, off, ln in (
                ("name", name_off, name_len),
                ("symlink", symlink_off, symlink_len),
                ("xattr", xattr_off, xattr_len),
            ):
                if off + ln > heap_size:
                    raise BootstrapError(
                        f"inode record {i}: {what} heap ref [{off}, +{ln}] overflows "
                        f"heap of {heap_size} bytes"
                    )
            if name_len == 0:
                raise BootstrapError(f"inode record {i} has an empty name")
            try:
                name = heap[name_off : name_off + name_len].decode()
                parent_path = paths_by_ino[parent_ino]
            except (UnicodeDecodeError, KeyError) as e:
                raise BootstrapError(f"corrupt inode record {i}: {e}") from e
            path = "/" if name == "/" else (parent_path.rstrip("/") + "/" + name)
            paths_by_ino[ino] = path
            hardlink_inos.append(hardlink_ino)
            inodes.append(
                Inode(
                    path=path,
                    mode=mode,
                    uid=uid,
                    gid=gid,
                    rdev=rdev,
                    mtime=mtime,
                    size=size,
                    flags=flags,
                    symlink_target=heap[symlink_off : symlink_off + symlink_len].decode(
                        errors="replace"
                    ),
                    xattrs=_unpack_xattrs(heap[xattr_off : xattr_off + xattr_len]),
                    chunk_index=chunk_index,
                    chunk_count=cc,
                    ino=ino,
                    parent_ino=parent_ino,
                )
            )
        # Hardlink targets may sort after the link itself; resolve once all
        # inos are known.
        for inode, hl_ino in zip(inodes, hardlink_inos):
            if hl_ino:
                if hl_ino not in paths_by_ino:
                    raise BootstrapError(
                        f"inode {inode.path!r} hardlinks to unknown ino {hl_ino}"
                    )
                inode.hardlink_target = paths_by_ino[hl_ino]

        chunks = [
            ChunkRecord.unpack(
                buf[chunk_table_off + i * CHUNK_SIZE_BYTES : chunk_table_off + (i + 1) * CHUNK_SIZE_BYTES]
            )
            for i in range(chunk_count)
        ]
        blobs = [
            BlobRecord.unpack(
                buf[blob_table_off + i * BLOB_SIZE_BYTES : blob_table_off + (i + 1) * BLOB_SIZE_BYTES]
            )
            for i in range(blob_count)
        ]
        ciphers = [
            CipherRecord.unpack(
                buf[cipher_table_off + i * CIPHER_SIZE_BYTES : cipher_table_off + (i + 1) * CIPHER_SIZE_BYTES]
            )
            for i in range(cipher_count)
        ]
        batches = [
            BatchRecord.unpack(
                buf[batch_table_off + i * BATCH_SIZE_BYTES : batch_table_off + (i + 1) * BATCH_SIZE_BYTES]
            )
            for i in range(batch_count)
        ]
        prefetch: list[str] = []
        for i in range(prefetch_count):
            (ino,) = struct.unpack_from("<I", buf, prefetch_table_off + i * 4)
            path = paths_by_ino.get(ino)
            if not path:
                raise BootstrapError(f"prefetch entry references unknown inode {ino}")
            prefetch.append(path)
        return cls(
            version=version,
            chunk_size=chunk_size,
            inodes=inodes,
            chunks=chunks,
            blobs=blobs,
            ciphers=ciphers,
            batches=batches,
            prefetch=prefetch,
        )

    # -- views --------------------------------------------------------------

    def inode_by_path(self) -> dict[str, Inode]:
        return {i.path: i for i in self.inodes}

    def chunk_digests_u32(self) -> np.ndarray:
        """Chunk digests as a uint32[N, 8] array (device-ready dict keys)."""
        if not self.chunks:
            return np.zeros((0, 8), dtype=np.uint32)
        raw = b"".join(c.digest for c in self.chunks)
        return np.frombuffer(raw, dtype="<u4").reshape(len(self.chunks), 8).copy()

    def referenced_blob_ids(self) -> list[str]:
        """Blob ids actually referenced by chunks, in blob-table order.

        This is the dedup result surface: the reference's merge step reports
        the referenced blob digest list from merge-output.json
        (pkg/converter/tool/builder.go:278-294).
        """
        used = {c.blob_index for c in self.chunks}
        return [b.blob_id for i, b in enumerate(self.blobs) if i in used]


def _parent_path(path: str) -> str:
    if path == "/":
        return ""
    parent = path.rsplit("/", 1)[0]
    return parent if parent else "/"


def _path_key(path: str) -> tuple:
    # Depth-first order with parents before children; stable across runs.
    if path == "/":
        return ("",)
    return tuple(path.strip("/").split("/"))


# ---------------------------------------------------------------------------
# Chunk dictionary
# ---------------------------------------------------------------------------


class ChunkDict:
    """Cross-image dedup dictionary backed by a dict-image bootstrap.

    Reference semantics: ``--chunk-dict bootstrap=<path>`` hands nydus-image a
    bootstrap whose chunk table seeds dedup (tool/builder.go:122-123). Here
    the dict exposes digest→(blob_id, chunk) and a flat ``uint32[N, 8]`` key
    array for the device-resident probe table.
    """

    def __init__(self, bootstrap: Bootstrap):
        self.bootstrap = bootstrap
        self._by_digest: dict[bytes, ChunkRecord] = {}
        for chunk in bootstrap.chunks:
            self._by_digest.setdefault(chunk.digest, chunk)

    @classmethod
    def from_path(cls, path: str) -> "ChunkDict":
        from nydus_snapshotter_tpu_torch.models.nydus_real import load_any_bootstrap

        with open(path, "rb") as f:
            # `--chunk-dict bootstrap=…` accepts REAL nydus bootstraps
            # too: dedup against images the reference toolchain built.
            return cls(load_any_bootstrap(f.read()))

    def __len__(self) -> int:
        return len(self._by_digest)

    def __contains__(self, digest: bytes) -> bool:
        return digest in self._by_digest

    def get(self, digest: bytes) -> Optional[ChunkRecord]:
        return self._by_digest.get(digest)

    def blob_id_for(self, chunk: ChunkRecord) -> str:
        return self.bootstrap.blobs[chunk.blob_index].blob_id

    def digests_u32(self) -> np.ndarray:
        return self.bootstrap.chunk_digests_u32()

    def blob_ids(self) -> list[str]:
        return [b.blob_id for b in self.bootstrap.blobs]


def parse_chunk_dict_arg(arg: str) -> str:
    """Parse the reference's chunk-dict argument form ``bootstrap=<path>``.

    Bare paths are accepted too (reference treats type prefix as optional).
    """
    if arg.startswith("bootstrap="):
        return arg[len("bootstrap=") :]
    return arg
