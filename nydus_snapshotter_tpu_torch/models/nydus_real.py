"""Readers for REAL nydus-toolchain bootstraps (RAFS v5 + RAFS v6/EROFS).

The framework's own bootstrap format (models/bootstrap.py) shares only the
magic numbers with the reference toolchain's; everything the runtime mounts
in the reference world was produced by the Rust `nydus-image` builder.
These readers parse that actual on-disk layout down to the full inode and
chunk tables, so the framework can inspect, unpack, and serve images it
did not convert itself. A copy of the reference package's
models/nydus_real.py, bound to this package's bootstrap model and codecs.

Layout knowledge was derived from the committed real artifacts
(the reference's pkg/filesystem/testdata/{v5-bootstrap-file-size-736032,
v6-bootstrap-chunk-pos-438272}.tar.gz) plus the reference's detection
contract (pkg/layout/layout.go:19-76: v5 magic 0x52414653
at offset 0, v6/EROFS magic 0xE0F5E1E2 at offset 1024). Field maps were
validated structurally on those fixtures: every offset below reproduces
the fixture's internal cross-references (table offsets/sizes, inode
counts, chunk counts, nlink/child relationships) exactly.

RAFS v5 bootstrap:
    [0x0000] superblock (8 KiB)
    [inode_table_offset] u32 per nid: inode offset >> 3
    [prefetch_table_offset] u32 inode numbers
    [blob_table_offset] (ra_offset u32, ra_size u32, 64-char hex id)+
    [extended_blob_table_offset] 64-B entries (chunk_count, sizes)
    inodes: 128-B fixed part + name (8-aligned) + symlink (8-aligned)
            + optional xattr table + chunk infos (80 B each)

RAFS v6 bootstrap = EROFS image + nydus extensions:
    [1024] EROFS superblock; meta_blkaddr, root_nid, devt_slotoff
    [1152] nydus extended superblock: flags, blob-table offset/size,
           chunk size, chunk-table offset/size (the fixture's chunk table
           sits at 438272 — the number in its filename)
    [devt_slotoff*128] device slots: 64-B blob-id tag per data blob
    [blob_table_offset] 256-B RafsV6Blob records
    [chunk_table_offset] 80-B chunk infos (v5 layout)
    inode tree: standard EROFS compact/extended inodes, dirents, and
    CHUNK_BASED data layout whose 8-B chunk indexes map uncompressed
    block addresses into the chunk table.
"""

from __future__ import annotations

import os
import stat
import struct
from dataclasses import dataclass, field

from nydus_snapshotter_tpu_torch.models import layout

__all__ = [
    "RealBootstrapError",
    "RealInode",
    "RealChunk",
    "RealBlob",
    "RealBootstrap",
    "parse_real_bootstrap",
]


class RealBootstrapError(ValueError):
    pass


@dataclass
class RealChunk:
    digest: bytes  # 32-B chunk digest (blake3 or sha256 per sb flags)
    blob_index: int
    flags: int
    compressed_size: int
    uncompressed_size: int
    compressed_offset: int
    uncompressed_offset: int
    file_offset: int = 0
    index: int = 0


@dataclass
class RealInode:
    path: str
    ino: int
    mode: int = 0
    uid: int = 0
    gid: int = 0
    mtime: int = 0
    size: int = 0
    nlink: int = 1
    rdev: int = 0
    flags: int = 0
    digest: bytes = b""
    symlink_target: str = ""
    xattrs: dict = field(default_factory=dict)
    chunks: list = field(default_factory=list)  # list[RealChunk]

    @property
    def is_dir(self) -> bool:
        return stat.S_ISDIR(self.mode)

    @property
    def is_regular(self) -> bool:
        return stat.S_ISREG(self.mode)

    @property
    def is_symlink(self) -> bool:
        return stat.S_ISLNK(self.mode)


@dataclass
class RealBlob:
    blob_id: str
    chunk_count: int = 0
    compressed_size: int = 0
    uncompressed_size: int = 0
    chunk_size: int = 0
    # v6: the raw 256-B RafsV6Blob record as parsed, so the writer can
    # round-trip fields beyond the ones modeled here.
    raw_rec: bytes = b""


@dataclass
class RealBootstrap:
    version: str  # layout.RAFS_V5 | layout.RAFS_V6
    flags: int
    inodes: list  # list[RealInode], root first, path-discoverable order
    blobs: list  # list[RealBlob]
    chunks: list  # list[RealChunk] — v6: the shared chunk table;
    # v5: concatenation of per-inode chunk runs
    prefetch_inos: list = field(default_factory=list)

    @property
    def compressor(self) -> str:
        """Chunk codec from the superblock flags (nydus RafsSuperFlags:
        0x1 none, 0x2 lz4_block, 0x40 gzip, 0x80 zstd; both committed
        fixtures carry 0x2 — lz4)."""
        if self.flags & 0x2:
            return "lz4_block"
        if self.flags & 0x80:
            return "zstd"
        if self.flags & 0x40:
            return "gzip"
        return "none"

    def tree(self) -> dict:
        """Nested {name: node} dict reconstruction of the directory tree;
        leaves map to their RealInode."""
        root: dict = {}
        for ino in self.inodes:
            if ino.path == "/":
                continue
            parts = ino.path.lstrip("/").split("/")
            cur = root
            for p in parts[:-1]:
                nxt = cur.get(p)
                if not isinstance(nxt, dict):
                    nxt = cur[p] = {}
                cur = nxt
            cur[parts[-1]] = {} if ino.is_dir else ino
        return root

    def by_path(self) -> dict:
        return {i.path: i for i in self.inodes}

    def to_tar(self, dest, blob_data: "dict[str, bytes] | None" = None) -> int:
        """Unpack to an OCI-style tar stream (reference Unpack semantics,
        convert_unix.go:669-733, against the REAL bootstrap layout).

        Metadata (paths, modes, owners, mtimes, symlinks, xattrs,
        hardlinks, device numbers) always round-trips. File bytes are
        reconstructed when ``blob_data`` maps blob_id -> raw blob bytes;
        chunks are sliced at their compressed extents and inflated with
        the superblock's codec (per-chunk COMPRESSED flag bit0 decides
        whether a chunk is stored raw), streamed one chunk at a time —
        never the whole file in memory. Files whose blob is not provided
        are emitted as zero-filled holes of the right size so the tree
        shape survives. Hardlink aliases (repeated ino among regular
        files) become tar LNKTYPE entries pointing at the first path.
        Returns the number of members written.
        """
        import tarfile

        decompress = _make_chunk_decoder(self.compressor)
        n = 0
        seen_ino: dict[int, str] = {}
        tf = tarfile.open(fileobj=dest, mode="w", format=tarfile.PAX_FORMAT)
        with tf:
            for ino in sorted(self.inodes, key=lambda i: i.path):
                if ino.path == "/":
                    continue
                ti = tarfile.TarInfo(ino.path.lstrip("/"))
                ti.mode = ino.mode & 0o7777
                ti.uid, ti.gid = ino.uid, ino.gid
                ti.mtime = ino.mtime
                if ino.xattrs:
                    ti.pax_headers = {
                        f"SCHILY.xattr.{k}": v.decode("utf-8", "surrogateescape")
                        for k, v in ino.xattrs.items()
                    }
                if ino.is_dir:
                    ti.type = tarfile.DIRTYPE
                    tf.addfile(ti)
                elif ino.is_symlink:
                    ti.type = tarfile.SYMTYPE
                    ti.linkname = ino.symlink_target
                    tf.addfile(ti)
                elif ino.is_regular:
                    first = seen_ino.get(ino.ino)
                    if first is not None and ino.nlink > 1:
                        ti.type = tarfile.LNKTYPE
                        ti.linkname = first
                        tf.addfile(ti)
                        n += 1
                        continue
                    seen_ino[ino.ino] = ti.name
                    ti.size = ino.size
                    tf.addfile(
                        ti,
                        _ChunkStream(
                            ino, self.blobs, blob_data or {}, decompress
                        ),
                    )
                else:
                    # device/fifo/socket nodes: metadata only
                    ti.type = (
                        tarfile.CHRTYPE
                        if stat.S_ISCHR(ino.mode)
                        else tarfile.BLKTYPE
                        if stat.S_ISBLK(ino.mode)
                        else tarfile.FIFOTYPE
                    )
                    # Linux dev_t: 12-bit major, 20-bit split minor.
                    ti.devmajor = (ino.rdev >> 8) & 0xFFF
                    ti.devminor = (ino.rdev & 0xFF) | ((ino.rdev >> 12) & 0xFFF00)
                    tf.addfile(ti)
                n += 1
        return n


def _make_chunk_decoder(compressor: str):
    """Chunk codec dispatch for the superblock's compressor identity."""
    if compressor == "lz4_block":
        from nydus_snapshotter_tpu_torch.utils import lz4 as lz4mod

        return lz4mod.decompress_block
    if compressor == "zstd":
        from nydus_snapshotter_tpu_torch.utils.zstdcompat import zstandard

        return lambda raw, usize: zstandard.ZstdDecompressor().decompress(
            raw, max_output_size=max(usize, 1)
        )
    if compressor == "none":
        return lambda raw, usize: raw
    raise RealBootstrapError(f"unsupported bootstrap compressor {compressor!r}")


class _ChunkStream:
    """Read-only file object yielding a regular file's bytes one chunk at
    a time (tarfile copies from it in bounded blocks — whole multi-GB
    files never materialize in memory). Chunks whose blob is absent from
    ``blob_data`` yield zero-filled holes; trailing bytes beyond the
    chunk run (sparse tails) are zero-filled to the inode size."""

    def __init__(self, ino: "RealInode", blobs, blob_data, decompress):
        self._ino = ino
        self._blobs = blobs
        self._blob_data = blob_data
        self._decompress = decompress
        self._chunks = iter(ino.chunks if blob_data else ())
        self._emitted = 0  # bytes handed out so far
        self._buf = memoryview(b"")

    def _next_chunk(self) -> bool:
        ck = next(self._chunks, None)
        if ck is None:
            return False
        blob = self._blob_data.get(self._blobs[ck.blob_index].blob_id)
        if blob is None:
            data = b"\0" * ck.uncompressed_size
        else:
            raw = blob[
                ck.compressed_offset : ck.compressed_offset + ck.compressed_size
            ]
            if ck.flags & 0x1:  # BlobChunkFlags::COMPRESSED
                data = self._decompress(raw, ck.uncompressed_size)
            else:
                data = raw
        self._buf = memoryview(bytes(data))
        return True

    def read(self, n: int = -1) -> bytes:
        remaining = self._ino.size - self._emitted
        if remaining <= 0:
            return b""
        if n < 0 or n > remaining:
            n = remaining
        if not self._buf:
            if not self._next_chunk():
                # sparse tail (or no blob data at all): zero-fill
                out = b"\0" * n
                self._emitted += n
                return out
        take = min(n, len(self._buf))
        out = bytes(self._buf[:take])
        self._buf = self._buf[take:]
        self._emitted += take
        return out


# ---------------------------------------------------------------------------
# RAFS v5
# ---------------------------------------------------------------------------

# Superblock prefix (fields validated on the 736032-B fixture: table
# offsets chain exactly, entries==3517, inodes==3515).
_V5_SB = struct.Struct("<IIIIQQQQQIIIIQ")
# 128-B on-disk inode (offsets confirmed by fixture decode: root at
# inode_table[0]<<3 with mode 040755, nlink 17, child_count 21, name "/").
_V5_INODE = struct.Struct("<32sQQIIIIQQQIIIHHIIQII")
# 80-B chunk info (same record the v6 chunk table reuses).
_V5_CHUNK = struct.Struct("<32sIIIIQQQII")

_V5_FLAG_SYMLINK = 0x1
_V5_FLAG_HARDLINK = 0x2
_V5_FLAG_XATTR = 0x4


def _align8(n: int) -> int:
    return (n + 7) & ~7


def parse_real_v5(data: bytes) -> RealBootstrap:
    if len(data) < 8192:
        raise RealBootstrapError("v5 bootstrap shorter than its superblock")
    (
        magic,
        fs_version,
        sb_size,
        _block_size,
        flags,
        inodes_count,
        inode_table_off,
        prefetch_table_off,
        blob_table_off,
        inode_table_entries,
        prefetch_table_entries,
        blob_table_size,
        ext_blob_entries,
        ext_blob_off,
    ) = _V5_SB.unpack_from(data, 0)
    if magic != layout.RAFS_V5_SUPER_MAGIC:
        raise RealBootstrapError(f"bad v5 magic {magic:#x}")
    if fs_version != 0x500:
        raise RealBootstrapError(f"unsupported v5 fs_version {fs_version:#x}")
    if sb_size > len(data) or inode_table_off + 4 * inode_table_entries > len(data):
        raise RealBootstrapError("v5 inode table exceeds bootstrap size")
    if blob_table_off + blob_table_size > len(data):
        raise RealBootstrapError("v5 blob table exceeds bootstrap size")

    # Blob table: (readahead_offset u32, readahead_size u32, hex id).
    blobs: list[RealBlob] = []
    boff = blob_table_off
    bend = blob_table_off + blob_table_size
    while boff + 8 < bend:
        boff += 8  # readahead fields
        idend = boff
        while idend < bend and data[idend] not in (0,):
            idend += 1
        bid = data[boff:idend].decode("ascii", "replace")
        if bid:
            # v5 keeps the chunking granularity in the superblock's
            # block_size (1 MiB on the fixture) — surface it per blob so
            # bridged bootstraps keep a valid Bootstrap.chunk_size.
            blobs.append(RealBlob(blob_id=bid, chunk_size=_block_size))
        # ids are NUL-separated when multiple entries follow
        boff = idend + 1
    # Extended blob table: 64-B entries with chunk_count + sizes. A
    # corrupted count must not spin the loop — blobs is the real bound.
    for i in range(min(ext_blob_entries, len(blobs))):
        off = ext_blob_off + 64 * i
        if off + 24 <= len(data) and i < len(blobs):
            # Field order pinned against the fixture: the per-chunk sums
            # of the walked chunk table equal (uncompressed, compressed)
            # in THIS order exactly (77298891 / 43090887).
            cc, _r, usize, csize = struct.unpack_from("<IIQQ", data, off)
            blobs[i].chunk_count = cc
            blobs[i].compressed_size = csize
            blobs[i].uncompressed_size = usize

    n_prefetch = min(
        prefetch_table_entries,
        max(0, (len(data) - prefetch_table_off) // 4) if prefetch_table_off < len(data) else 0,
    )
    prefetch_inos = [
        struct.unpack_from("<I", data, prefetch_table_off + 4 * i)[0]
        for i in range(n_prefetch)
    ]

    table = struct.unpack_from(f"<{inode_table_entries}I", data, inode_table_off)

    entries: list[tuple[RealInode, int, int]] = []  # inode, child_index, child_count
    ino_to_entry: dict[int, int] = {}
    all_chunks: list[RealChunk] = []
    for nid, slot in enumerate(table):
        off = slot << 3
        if slot == 0 or off + 128 > len(data):
            raise RealBootstrapError(f"v5 inode table entry {nid} out of range")
        (
            digest,
            _parent,
            i_ino,
            uid,
            gid,
            _projid,
            mode,
            size,
            _blocks,
            iflags,
            nlink,
            child_index,
            child_count,
            name_size,
            symlink_size,
            rdev,
            _pad,
            mtime,
            _mtime_ns,
            _rsvd,
        ) = _V5_INODE.unpack_from(data, off)
        pos = off + 128
        name = data[pos : pos + name_size].decode("utf-8", "surrogateescape")
        pos += _align8(name_size)
        target = ""
        if iflags & _V5_FLAG_SYMLINK and symlink_size:
            target = data[pos : pos + symlink_size].split(b"\0", 1)[0].decode(
                "utf-8", "surrogateescape"
            )
            pos += _align8(symlink_size)
        xattrs: dict = {}
        if iflags & _V5_FLAG_XATTR:
            if pos + 8 > len(data):
                raise RealBootstrapError(f"v5 xattr table of inode {i_ino} truncated")
            (xsize,) = struct.unpack_from("<Q", data, pos)
            if pos + 8 + xsize > len(data):
                raise RealBootstrapError(
                    f"v5 xattr table of inode {i_ino} exceeds bootstrap"
                )
            xend = pos + 8 + xsize
            xpos = pos + 8
            while xpos + 4 <= xend:
                (esize,) = struct.unpack_from("<I", data, xpos)
                if esize == 0 or xpos + 4 + esize > xend:
                    break
                pair = data[xpos + 4 : xpos + 4 + esize]
                k, _, v = pair.partition(b"\0")
                xattrs[k.decode("utf-8", "surrogateescape")] = v
                xpos += 4 + _align8(esize)
            pos = _align8(xend)
        inode = RealInode(
            path=name,  # resolved to a full path below
            ino=i_ino,
            mode=mode,
            uid=uid,
            gid=gid,
            mtime=mtime,
            size=size,
            nlink=nlink,
            rdev=rdev,
            flags=iflags,
            digest=digest,
            symlink_target=target,
            xattrs=xattrs,
        )
        if stat.S_ISREG(mode) and not (iflags & _V5_FLAG_HARDLINK):
            for ci in range(child_count):
                coff = pos + 80 * ci
                if coff + 80 > len(data):
                    raise RealBootstrapError(
                        f"v5 chunk info of inode {i_ino} out of range"
                    )
                (
                    cdigest,
                    blob_index,
                    cflags,
                    csize,
                    usize,
                    c_off,
                    u_off,
                    f_off,
                    cindex,
                    _crsvd,
                ) = _V5_CHUNK.unpack_from(data, coff)
                ck = RealChunk(
                    digest=cdigest,
                    blob_index=blob_index,
                    flags=cflags,
                    compressed_size=csize,
                    uncompressed_size=usize,
                    compressed_offset=c_off,
                    uncompressed_offset=u_off,
                    file_offset=f_off,
                    index=cindex,
                )
                inode.chunks.append(ck)
                all_chunks.append(ck)
        entries.append((inode, child_index, child_count))
        ino_to_entry.setdefault(i_ino, nid)

    if not entries:
        raise RealBootstrapError("v5 bootstrap has no inodes")

    # Path resolution: directories carry (child_index, child_count) ranges
    # into the inode table (1-based); walk from the root entry.
    root = entries[0][0]
    root.path = "/"
    stack = [(0, "")]
    seen = {0}
    while stack:
        nid, prefix = stack.pop()
        inode, child_index, child_count = entries[nid]
        if not inode.is_dir or child_count == 0:
            continue
        if child_index < 1 or child_index - 1 + child_count > len(entries):
            # a corrupted range must not spin for billions of misses
            raise RealBootstrapError(
                f"v5 child range of {inode.path!r} exceeds inode table"
            )
        for cn in range(child_index - 1, child_index - 1 + child_count):
            if cn in seen:
                continue
            seen.add(cn)
            child = entries[cn][0]
            child.path = f"{prefix}/{child.path}"
            stack.append((cn, child.path))

    inodes = [e[0] for e in entries]
    # hardlink aliases: resolve chunk lists from their target ino
    for inode in inodes:
        if inode.flags & _V5_FLAG_HARDLINK and not inode.chunks:
            tgt = ino_to_entry.get(inode.ino)
            if tgt is not None:
                inode.chunks = entries[tgt][0].chunks

    if len({i.ino for i in inodes}) != inodes_count:
        raise RealBootstrapError(
            f"v5 inode count mismatch: superblock {inodes_count}, "
            f"walked {len({i.ino for i in inodes})}"
        )
    return RealBootstrap(
        version=layout.RAFS_V5,
        flags=flags,
        inodes=inodes,
        blobs=blobs,
        chunks=all_chunks,
        prefetch_inos=prefetch_inos,
    )


# ---------------------------------------------------------------------------
# RAFS v6 (EROFS + nydus extensions)
# ---------------------------------------------------------------------------

# The reader and the writer (models/nydus_real_write.py) must agree on the
# on-disk contract: they share one set of struct definitions.
from nydus_snapshotter_tpu_torch.models.erofs_layout import (  # noqa: E402
    _CHUNK_INDEX as _EROFS_CHUNK_INDEX,
    _DIRENT as _EROFS_DIRENT,
    _INODE_COMPACT as _EROFS_INODE_COMPACT,
    _XATTR_ENTRY as _EROFS_XATTR_ENTRY,
    _XATTR_EXACT as _EROFS_XATTR_EXACT,
    _XATTR_PREFIXES as _EROFS_XATTR_PREFIX_LIST,
)

_EROFS_SB = struct.Struct("<IIIBBHQQIIII16s16sIHHH")
_EROFS_INODE_EXTENDED = struct.Struct("<HHHHQIIIIQIII")
_NYDUS_EXT_SB = struct.Struct("<QQIIQQ")
# ...followed by (prefetch_table_offset u64, prefetch_table_size u32) —
# decoded from the committed v6 fixture, whose ext sb carries
# (4352, 4): one u32 prefetch entry right after the blob table. Entries
# are EROFS nids (the fixture's single entry is nid 142).
_NYDUS_EXT_SB_PREFETCH = struct.Struct("<QI")

# index -> name prefix (reverse of the writer's registry).
_EROFS_XATTR_PREFIXES = {idx: prefix for prefix, idx in _EROFS_XATTR_PREFIX_LIST}
_EROFS_XATTR_PREFIXES.update({idx: name for name, idx in _EROFS_XATTR_EXACT.items()})

_EROFS_LAYOUT_FLAT_PLAIN = 0
_EROFS_LAYOUT_FLAT_INLINE = 2
_EROFS_LAYOUT_CHUNK_BASED = 4


def parse_real_v6(data: bytes) -> RealBootstrap:
    if len(data) < 4096:
        raise RealBootstrapError("v6 bootstrap shorter than its first block")
    (
        magic,
        _chksum,
        _feat_compat,
        blkszbits,
        _extslots,
        root_nid,
        inos,
        _btime,
        _btime_ns,
        _blocks,
        meta_blkaddr,
        _xattr_blkaddr,
        _uuid,
        _vol,
        _feat_incompat,
        _compr,
        extra_devices,
        devt_slotoff,
    ) = _EROFS_SB.unpack_from(data, 1024)
    if magic != layout.RAFS_V6_SUPER_MAGIC:
        raise RealBootstrapError(f"bad v6/EROFS magic {magic:#x}")
    if not 9 <= blkszbits <= 16:
        raise RealBootstrapError(f"implausible EROFS block size 2^{blkszbits}")
    blksz = 1 << blkszbits

    # nydus extended superblock directly after the EROFS one.
    (
        flags,
        blob_table_off,
        blob_table_size,
        chunk_size,
        chunk_table_off,
        chunk_table_size,
    ) = _NYDUS_EXT_SB.unpack_from(data, 1024 + 128)
    if chunk_table_off + chunk_table_size > len(data):
        raise RealBootstrapError("v6 chunk table exceeds bootstrap size")
    if chunk_table_size % 80:
        raise RealBootstrapError("v6 chunk table not a multiple of 80 bytes")
    prefetch_off, prefetch_size = _NYDUS_EXT_SB_PREFETCH.unpack_from(
        data, 1024 + 128 + _NYDUS_EXT_SB.size
    )
    prefetch_nids: list[int] = []
    if prefetch_off and prefetch_off + prefetch_size <= len(data):
        prefetch_nids = [
            struct.unpack_from("<I", data, prefetch_off + 4 * i)[0]
            for i in range(prefetch_size // 4)
        ]

    # Device slots name the data blobs.
    blobs: list[RealBlob] = []
    for i in range(extra_devices):
        off = devt_slotoff * 128 + 128 * i
        tag = data[off : off + 64].split(b"\0", 1)[0].decode("ascii", "replace")
        blobs.append(RealBlob(blob_id=tag, chunk_size=chunk_size))
    # RafsV6Blob records (256 B each) refine counts/sizes.
    n_blob_recs = blob_table_size // 256 if blob_table_size else 0
    for i in range(min(n_blob_recs, len(blobs))):
        off = blob_table_off + 256 * i
        if off + 112 > len(data):
            break
        bid = data[off : off + 64].split(b"\0", 1)[0].decode("ascii", "replace")
        _bidx, _csize_chunk, cc = struct.unpack_from("<III", data, off + 64)
        csize, usize = struct.unpack_from("<QQ", data, off + 88)
        if bid and bid != blobs[i].blob_id:
            raise RealBootstrapError("v6 blob table and device table disagree")
        blobs[i].chunk_count = cc
        blobs[i].compressed_size = csize
        blobs[i].uncompressed_size = usize
        if off + 256 <= len(data):
            blobs[i].raw_rec = data[off : off + 256]

    # Shared chunk table (80-B v5-layout records).
    chunks: list[RealChunk] = []
    by_uoff: dict[tuple[int, int], RealChunk] = {}
    for i in range(chunk_table_size // 80):
        (
            cdigest,
            blob_index,
            cflags,
            csize,
            usize,
            c_off,
            u_off,
            f_off,
            cindex,
            _crsvd,
        ) = _V5_CHUNK.unpack_from(data, chunk_table_off + 80 * i)
        ck = RealChunk(
            digest=cdigest,
            blob_index=blob_index,
            flags=cflags,
            compressed_size=csize,
            uncompressed_size=usize,
            compressed_offset=c_off,
            uncompressed_offset=u_off,
            file_offset=f_off,
            index=cindex,
        )
        chunks.append(ck)
        by_uoff[(blob_index, u_off)] = ck

    meta_base = meta_blkaddr * blksz

    def iloc(nid: int) -> int:
        return meta_base + 32 * nid

    def parse_inode(nid: int):
        off = iloc(nid)
        if off + 32 > len(data):
            raise RealBootstrapError(f"v6 inode nid {nid} out of range")
        fmt = struct.unpack_from("<H", data, off)[0]
        extended = fmt & 1
        data_layout = (fmt >> 1) & 0x7
        if extended:
            (
                _fmt,
                xattr_icount,
                mode,
                _rsv,
                size,
                u,
                ino,
                uid,
                gid,
                mtime,
                _mtime_ns,
                nlink,
                _rsv2a,
            ) = _EROFS_INODE_EXTENDED.unpack_from(data, off)
            isize = 64
        else:
            (
                _fmt,
                xattr_icount,
                mode,
                nlink,
                size,
                _rsv,
                u,
                ino,
                uid,
                gid,
                _rsv2,
            ) = _EROFS_INODE_COMPACT.unpack_from(data, off)
            mtime = 0
            isize = 32
        xattr_size = (xattr_icount - 1) * 4 + 12 if xattr_icount else 0
        return (
            data_layout,
            mode,
            size,
            u,
            ino,
            uid,
            gid,
            mtime,
            nlink,
            isize,
            xattr_size,
        )

    def parse_xattrs(nid: int, isize: int, xattr_size: int) -> dict:
        out: dict = {}
        if not xattr_size:
            return out
        base = iloc(nid) + isize
        _filter, shared_count = struct.unpack_from("<IB", data, base)
        pos = base + 12 + 4 * shared_count
        end = base + xattr_size
        while pos + 4 <= end:
            name_len, name_index, value_size = _EROFS_XATTR_ENTRY.unpack_from(
                data, pos
            )
            if name_len == 0 and value_size == 0:
                break
            nm = data[pos + 4 : pos + 4 + name_len].decode("utf-8", "surrogateescape")
            val = data[pos + 4 + name_len : pos + 4 + name_len + value_size]
            prefix = _EROFS_XATTR_PREFIXES.get(name_index, "")
            out[prefix + nm] = val
            pos += 4 + ((name_len + value_size + 3) & ~3)
        return out

    def data_region(nid, data_layout, size, u, isize, xattr_size):
        """Byte content of a FLAT_PLAIN / FLAT_INLINE inode."""
        if data_layout == _EROFS_LAYOUT_FLAT_INLINE:
            nblocks = size // blksz
            tail = size - nblocks * blksz
            parts = []
            if nblocks:
                parts.append(data[u * blksz : u * blksz + nblocks * blksz])
            if tail:
                base = iloc(nid) + isize + xattr_size
                parts.append(data[base : base + tail])
            return b"".join(parts)
        if data_layout == _EROFS_LAYOUT_FLAT_PLAIN:
            return data[u * blksz : u * blksz + size]
        raise RealBootstrapError(f"unhandled data layout {data_layout} for nid {nid}")

    def dirents(raw: bytes):
        # Each block is parsed independently (EROFS per-block dirents).
        for b0 in range(0, len(raw), blksz):
            blk = raw[b0 : b0 + blksz]
            if len(blk) < 12:
                continue
            first_nameoff = struct.unpack_from("<H", blk, 8)[0]
            count = first_nameoff // 12
            ents = [
                _EROFS_DIRENT.unpack_from(blk, 12 * i) for i in range(count)
            ]
            for i, (nid, nameoff, _ftype, _r) in enumerate(ents):
                name_end = ents[i + 1][1] if i + 1 < count else len(blk)
                name = blk[nameoff:name_end].split(b"\0", 1)[0].decode(
                    "utf-8", "surrogateescape"
                )
                yield nid, name

    inodes: list[RealInode] = []
    visited: set[int] = set()
    ino_of_nid: dict[int, int] = {}
    stack: list[tuple[int, str]] = [(root_nid, "/")]
    while stack:
        nid, path = stack.pop()
        (
            data_layout,
            mode,
            size,
            u,
            ino,
            uid,
            gid,
            mtime,
            nlink,
            isize,
            xattr_size,
        ) = parse_inode(nid)
        rdev = 0
        if stat.S_ISCHR(mode) or stat.S_ISBLK(mode):
            # i_u carries new_encode_dev(): minor low byte | major << 8
            # | high minor bits << 12
            rdev = os.makedev((u >> 8) & 0xFFF, (u & 0xFF) | ((u >> 12) & ~0xFF))
        inode = RealInode(
            path=path,
            ino=ino,
            mode=mode,
            uid=uid,
            gid=gid,
            mtime=mtime,
            size=size,
            nlink=nlink,
            rdev=rdev,
            xattrs=parse_xattrs(nid, isize, xattr_size),
        )
        inodes.append(inode)
        ino_of_nid.setdefault(nid, ino)
        if stat.S_ISDIR(mode):
            if nid in visited:
                continue
            visited.add(nid)
            for cnid, name in dirents(
                data_region(nid, data_layout, size, u, isize, xattr_size)
            ):
                if name in (".", ".."):
                    continue
                cpath = name if path == "/" else f"{path}/{name}"
                stack.append((cnid, "/" + cpath.lstrip("/")))
        elif stat.S_ISLNK(mode):
            inode.symlink_target = data_region(
                nid, data_layout, size, u, isize, xattr_size
            ).decode("utf-8", "surrogateescape")
        elif stat.S_ISREG(mode) and data_layout == _EROFS_LAYOUT_CHUNK_BASED:
            chunk_fmt = u & 0xFFFF
            cbits = blkszbits + (chunk_fmt & 0x1F)
            csz = 1 << cbits
            n_chunks = (size + csz - 1) // csz if size else 0
            idx_base = iloc(nid) + isize + xattr_size
            if idx_base + 8 * n_chunks > len(data):
                raise RealBootstrapError(
                    f"chunk indexes of {path!r} exceed bootstrap size"
                )
            for ci in range(n_chunks):
                advise, device_id, blkaddr = _EROFS_CHUNK_INDEX.unpack_from(
                    data, idx_base + 8 * ci
                )
                if blkaddr == 0xFFFFFFFF:
                    continue  # hole
                # EROFS device ids are 1-based for extra devices (0 is
                # the primary/meta device); nydus blob_index is 0-based.
                blob_index = device_id - 1 if device_id else 0
                ck = by_uoff.get((blob_index, blkaddr * blksz))
                if ck is None:
                    raise RealBootstrapError(
                        f"chunk index of {path!r} (dev {device_id}, "
                        f"blkaddr {blkaddr}) not in chunk table"
                    )
                inode.chunks.append(ck)

    if inos and len({i.ino for i in inodes}) > inos:
        raise RealBootstrapError("v6 walked more inodes than superblock count")
    return RealBootstrap(
        version=layout.RAFS_V6,
        flags=flags,
        inodes=inodes,
        blobs=blobs,
        chunks=chunks,
        # prefetch entries are nids on disk; surface them as the inode
        # numbers the rest of the model speaks (to_bootstrap resolves
        # them to paths exactly like the v5 table).
        prefetch_inos=[
            ino_of_nid[n] for n in prefetch_nids if n in ino_of_nid
        ],
    )


def to_bootstrap(real: RealBootstrap):
    """Bridge a REAL nydus bootstrap into the framework's internal model
    (models/bootstrap.Bootstrap) so every downstream surface — the
    userspace daemon, FUSE mounts, Unpack, EROFS export — can serve
    images the reference toolchain built, not only images this framework
    converted itself.

    Chunk compression flags translate from nydus BlobChunkFlags (bit0 =
    COMPRESSED) + the superblock codec identity into the framework's
    per-chunk compressor flags. Hardlink aliases (repeated ino) become
    hardlink_target references to the first path.
    """
    from nydus_snapshotter_tpu_torch import constants
    from nydus_snapshotter_tpu_torch.models.bootstrap import (
        INODE_FLAG_SYMLINK,
        Bootstrap,
        BlobRecord,
        ChunkRecord,
        Inode,
    )
    from nydus_snapshotter_tpu_torch.models.bootstrap import INODE_FLAG_HARDLINK

    comp_flag = {
        "lz4_block": constants.COMPRESSOR_LZ4_BLOCK,
        "zstd": constants.COMPRESSOR_ZSTD,
        "gzip": constants.COMPRESSOR_GZIP,
        "none": constants.COMPRESSOR_NONE,
    }[real.compressor]

    chunks: list = []
    inodes: list = []
    first_path_of_ino: dict[int, str] = {}
    for ri in sorted(real.inodes, key=lambda i: i.path):
        ino = Inode(
            path=ri.path,
            mode=ri.mode,
            uid=ri.uid,
            gid=ri.gid,
            rdev=ri.rdev,
            mtime=ri.mtime,
            size=ri.size,
            symlink_target=ri.symlink_target,
            xattrs=dict(ri.xattrs),
        )
        if ri.is_symlink:
            ino.flags |= INODE_FLAG_SYMLINK
        if ri.is_regular:
            first = first_path_of_ino.get(ri.ino)
            if first is not None and ri.nlink > 1:
                ino.flags |= INODE_FLAG_HARDLINK
                ino.hardlink_target = first
                inodes.append(ino)
                continue
            first_path_of_ino[ri.ino] = ri.path
        if ri.chunks:
            ino.chunk_index = len(chunks)
            ino.chunk_count = len(ri.chunks)
            for ck in ri.chunks:
                chunks.append(
                    ChunkRecord(
                        digest=ck.digest,
                        blob_index=ck.blob_index,
                        flags=comp_flag
                        if ck.flags & 0x1
                        else constants.COMPRESSOR_NONE,
                        uncompressed_offset=ck.uncompressed_offset,
                        compressed_offset=ck.compressed_offset,
                        uncompressed_size=ck.uncompressed_size,
                        compressed_size=ck.compressed_size,
                    )
                )
        inodes.append(ino)

    blobs = [
        BlobRecord(
            blob_id=b.blob_id,
            compressed_size=b.compressed_size,
            uncompressed_size=b.uncompressed_size,
            chunk_count=b.chunk_count,
        )
        for b in real.blobs
    ]
    # v5 prefetch table: inode numbers -> paths (the runtime warm list).
    path_of_ino = {}
    for ri in real.inodes:
        path_of_ino.setdefault(ri.ino, ri.path)
    # "/" is a legitimate entry (prefetch-everything policy — and what the
    # committed v5 fixture actually carries); keep it.
    prefetch = [path_of_ino[pi] for pi in real.prefetch_inos if pi in path_of_ino]
    # Assign ino/parent_ino the way Bootstrap.to_bytes does (1-based, path
    # order): consumers of the *in-memory* bridge — the daemon's FUSE
    # layer keys nodes by ino — must see the same numbering a
    # serialize/parse round trip would produce, not zeros.
    ino_by_path = {inode.path: i + 1 for i, inode in enumerate(inodes)}
    for i, inode in enumerate(inodes):
        inode.ino = i + 1
        if inode.path == "/":
            inode.parent_ino = 0
        else:
            inode.parent_ino = ino_by_path.get(
                inode.path.rsplit("/", 1)[0] or "/", 0
            )
    return Bootstrap(
        version=real.version,
        chunk_size=real.blobs[0].chunk_size if real.blobs else 0x100000,
        inodes=inodes,
        chunks=chunks,
        blobs=blobs,
        prefetch=prefetch,
    )


def load_any_bootstrap(data: bytes):
    """Load a bootstrap in EITHER layout: this framework's native format,
    or the real nydus toolchain's v5/v6 (bridged via to_bootstrap). This
    is what lets the daemon mount — and the chunk dict dedup against —
    images the reference ecosystem built, with zero caller special-casing
    (the two formats share detection magics; the field layouts identify
    which reader owns the bytes)."""
    from nydus_snapshotter_tpu_torch.models.bootstrap import Bootstrap, BootstrapError

    try:
        return Bootstrap.from_bytes(data)
    except (ValueError, struct.error, IndexError) as native_err:
        # BootstrapError and LayoutError are ValueError subclasses; bare
        # struct/index errors on truncated native headers must also fall
        # through to the real-format reader rather than escaping.
        try:
            return to_bootstrap(parse_real_bootstrap(data))
        except (RealBootstrapError, ValueError) as real_err:
            raise BootstrapError(
                f"not a native bootstrap ({native_err}) nor a real nydus "
                f"one ({real_err})"
            ) from native_err


def parse_real_bootstrap(data: bytes) -> RealBootstrap:
    """Dispatch on the reference detection contract
    (the reference's pkg/layout/layout.go:60-76)."""
    ver = layout.detect_fs_version(data)
    try:
        if ver == layout.RAFS_V5:
            return parse_real_v5(data)
        if ver == layout.RAFS_V6:
            return parse_real_v6(data)
    except RealBootstrapError:
        raise
    except (struct.error, IndexError, OverflowError, UnicodeDecodeError, MemoryError) as e:
        # Corrupt metadata must surface as the domain error, never a bare
        # struct/index crash (fuzz-pinned in test_reference_fixtures).
        raise RealBootstrapError(f"corrupt {ver} bootstrap: {e}") from e
    raise RealBootstrapError("not a RAFS bootstrap")
