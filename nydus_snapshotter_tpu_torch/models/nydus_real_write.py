"""Writers for REAL nydus-toolchain bootstrap layouts (RAFS v5, v6).

models/nydus_real.py made real bootstraps first-class *inputs*; this
module is the other direction: serialize a bootstrap in the reference
toolchain's own on-disk layout, so images this framework converts can be
consumed by the reference ecosystem (nydusd mounts v5/v6 bootstraps
produced by `nydus-image`; pkg/filesystem/fs.go:268-431 never sees any
other format). Layout knowledge is the same field maps the reader was
validated with on the committed real fixtures; the reader is the
round-trip oracle for everything written here. A copy of the reference
package's models/nydus_real_write.py.

Digest semantics (reverse-engineered structurally from the v5 fixture,
where every one of its 3,517 inode digests matches):

- regular file:  H(concat of its chunk digests)   (2602/2602 fixture inodes)
- symlink:       H(target bytes)                  (212/212)
- directory:     H(concat of child digests, children sorted by name,
                 computed bottom-up)              (678/678)
- empty file / special file: H(b"")
- hardlink alias: the target inode's digest

with H = blake3 (RafsSuperFlags 0x4, the toolchain default — see
utils/blake3.py) or sha256 (0x8). `real_from_bootstrap` computes these
when bridging the framework's internal model; fixture-parsed
RealBootstraps keep their digests verbatim.

Superblock flag bits (nydus RafsSuperFlags, validated against both
fixtures: v5 carries 0x16, v6 carries 0x6):
0x1 none / 0x2 lz4_block / 0x40 gzip / 0x80 zstd compressor;
0x4 blake3 / 0x8 sha256 digester; 0x10 explicit uid/gid; 0x20 xattrs.
"""

from __future__ import annotations

import hashlib
import io
import os
import stat as statmod
import struct

from nydus_snapshotter_tpu_torch import constants
from nydus_snapshotter_tpu_torch.models import layout
from nydus_snapshotter_tpu_torch.models.nydus_real import (
    RealBlob,
    RealBootstrap,
    RealBootstrapError,
    RealChunk,
    RealInode,
    _V5_CHUNK,
    _V5_FLAG_HARDLINK,
    _V5_FLAG_SYMLINK,
    _V5_FLAG_XATTR,
    _V5_INODE,
    _V5_SB,
)
from nydus_snapshotter_tpu_torch.utils.blake3 import blake3

__all__ = ["real_from_bootstrap", "write_real_v5", "write_real_v6"]

_FLAG_COMP_NONE = 0x1
_FLAG_COMP_LZ4 = 0x2
_FLAG_HASH_BLAKE3 = 0x4
_FLAG_HASH_SHA256 = 0x8
_FLAG_EXPLICIT_UIDGID = 0x10
_FLAG_HAS_XATTR = 0x20
_FLAG_COMP_GZIP = 0x40
_FLAG_COMP_ZSTD = 0x80

_CHUNK_FLAG_COMPRESSED = 0x1

_V5_SB_SIZE = 8192


def _align8(n: int) -> int:
    return (n + 7) & ~7


def _digester(name: str):
    if name == "blake3":
        return blake3
    if name == "sha256":
        return lambda b: hashlib.sha256(b).digest()
    raise RealBootstrapError(f"unknown digester {name!r}")


def _comp_flag_of(bootstrap) -> int:
    """Superblock compressor bit from the internal chunk flags."""
    for ck in bootstrap.chunks:
        c = ck.flags & constants.COMPRESSOR_MASK
        if c == constants.COMPRESSOR_LZ4_BLOCK:
            return _FLAG_COMP_LZ4
        if c == constants.COMPRESSOR_ZSTD:
            return _FLAG_COMP_ZSTD
        if c == constants.COMPRESSOR_GZIP:
            return _FLAG_COMP_GZIP
    return _FLAG_COMP_NONE


def real_from_bootstrap(bootstrap, digester: str = "sha256") -> RealBootstrap:
    """Bridge the framework's internal model (models/bootstrap.Bootstrap)
    into a RealBootstrap ready for the real-layout writers.

    Inode digests are computed per the reference formulas above (the
    internal model does not carry them); v5 per-inode chunk runs get
    file_offset/index fields the internal shared chunk table does not
    track. Chunk digests pass through as-is — they are sha256 from the
    pack engine, so pick digester="sha256" (the toolchain's own
    `--digester sha256` mode) unless the caller rehashed with blake3.
    """
    H = _digester(digester)

    blobs = [
        RealBlob(
            blob_id=b.blob_id,
            chunk_count=b.chunk_count,
            compressed_size=b.compressed_size,
            uncompressed_size=b.uncompressed_size,
            chunk_size=bootstrap.chunk_size,
        )
        for b in bootstrap.blobs
    ]

    # Per-blob chunk ordinals for the v5 records' index field.
    ordinal: dict[tuple[int, int], int] = {}
    per_blob: dict[int, list[int]] = {}
    for ck in bootstrap.chunks:
        per_blob.setdefault(ck.blob_index, []).append(ck.compressed_offset)
    for bi, offs in per_blob.items():
        for i, off in enumerate(sorted(set(offs))):
            ordinal[(bi, off)] = i

    by_path: dict[str, RealInode] = {}
    ino_of_path: dict[str, int] = {}
    next_ino = 1
    reals: list[RealInode] = []
    # Two passes: hardlink aliases resolve against their target inode, and
    # a tar may name the alias before the target in path order.
    ordered = sorted(bootstrap.inodes, key=lambda i: i.path)
    for ino in [i for i in ordered if not i.hardlink_target] + [
        i for i in ordered if i.hardlink_target
    ]:
        target = ino.hardlink_target
        if target:
            tpath = "/" + target.lstrip("/")
            num = ino_of_path.get(tpath)
            if num is None:
                raise RealBootstrapError(f"hardlink target missing: {target}")
        else:
            num = next_ino
            next_ino += 1
        ri = RealInode(
            path=ino.path,
            ino=num,
            mode=ino.mode,
            uid=ino.uid,
            gid=ino.gid,
            mtime=ino.mtime,
            size=ino.size,
            nlink=1,
            rdev=ino.rdev,
            flags=0,
            symlink_target=ino.symlink_target,
            xattrs=dict(ino.xattrs),
        )
        if ri.is_symlink:
            ri.flags |= _V5_FLAG_SYMLINK
            # POSIX (and the real builder): a symlink's size is its
            # target length; tar stores 0
            ri.size = len(ri.symlink_target.encode("utf-8", "surrogateescape"))
        if ri.xattrs:
            ri.flags |= _V5_FLAG_XATTR
        if target:
            # a hardlink IS its target inode: aliases carry the head's
            # attributes (v6 serializes one inode for the whole group)
            ri.flags |= _V5_FLAG_HARDLINK
            head = by_path["/" + target.lstrip("/")]
            ri.chunks = head.chunks
            ri.size = head.size
            ri.mode = head.mode
            ri.uid, ri.gid = head.uid, head.gid
            ri.mtime = head.mtime
            ri.digest = b""  # filled after head digests are computed
        elif ino.chunk_count:
            pos = 0
            for rec in bootstrap.chunks[
                ino.chunk_index : ino.chunk_index + ino.chunk_count
            ]:
                ri.chunks.append(
                    RealChunk(
                        digest=rec.digest,
                        blob_index=rec.blob_index,
                        flags=(
                            _CHUNK_FLAG_COMPRESSED
                            if (rec.flags & constants.COMPRESSOR_MASK)
                            not in (0, constants.COMPRESSOR_NONE)
                            else 0
                        ),
                        compressed_size=rec.compressed_size,
                        uncompressed_size=rec.uncompressed_size,
                        compressed_offset=rec.compressed_offset,
                        uncompressed_offset=rec.uncompressed_offset,
                        file_offset=pos,
                        index=ordinal.get(
                            (rec.blob_index, rec.compressed_offset), 0
                        ),
                    )
                )
                pos += rec.uncompressed_size
        reals.append(ri)
        by_path[ri.path] = ri
        ino_of_path[ri.path] = num
    reals.sort(key=lambda r: r.path)

    # nlink: hardlink group sizes; directories 2 + subdirectories.
    group_size: dict[int, int] = {}
    for ri in reals:
        group_size[ri.ino] = group_size.get(ri.ino, 0) + 1
    children: dict[str, list[RealInode]] = {}
    for ri in reals:
        if ri.path != "/":
            parent = ri.path.rsplit("/", 1)[0] or "/"
            children.setdefault(parent, []).append(ri)
    for ri in reals:
        if ri.is_dir:
            ri.nlink = 2 + sum(1 for c in children.get(ri.path, []) if c.is_dir)
        else:
            ri.nlink = group_size[ri.ino]

    # ino numbers follow the real builder's convention: the head's
    # 1-based slot in the v5 pre-order table (v6 images carry the same
    # numbers — fixture-verified: /etc=5, /var=22 match their v5 slots).
    probe = RealBootstrap(
        version=layout.RAFS_V5, flags=0, inodes=reals, blobs=[], chunks=[]
    )
    order, _, _ = _table_order(probe)
    slot_of: dict[int, int] = {}
    for slot, ri in enumerate(order, start=1):
        slot_of.setdefault(ri.ino, slot)
    for ri in reals:
        ri.ino = slot_of[ri.ino]
    ino_of_path = {ri.path: ri.ino for ri in reals}

    # Digests. Leaves first (files/symlinks), then hardlink aliases (their
    # head is always a non-directory, so it is final by then — an alias
    # must contribute its target's digest to its parent directory's hash,
    # not a placeholder), then directories bottom-up.
    for ri in reals:
        if ri.flags & _V5_FLAG_HARDLINK or ri.is_dir:
            continue
        if ri.is_symlink:
            ri.digest = H(ri.symlink_target.encode())
        elif ri.chunks:
            ri.digest = H(b"".join(c.digest for c in ri.chunks))
        else:
            ri.digest = H(b"")
    head_of: dict[int, RealInode] = {}
    for ri in reals:
        if not (ri.flags & _V5_FLAG_HARDLINK):
            head_of.setdefault(ri.ino, ri)
    for ri in reals:
        if ri.flags & _V5_FLAG_HARDLINK:
            ri.digest = head_of[ri.ino].digest
    # Deepest directories first; the root is depth 0, NOT the same depth
    # as "/etc" (both contain one slash) — hashing it early would fold
    # empty placeholders for every top-level subdirectory into the root
    # digest.
    depth = lambda r: 0 if r.path == "/" else r.path.count("/")  # noqa: E731
    for ri in sorted(reals, key=depth, reverse=True):
        if ri.is_dir:
            kids = sorted(children.get(ri.path, []), key=lambda k: k.path)
            ri.digest = H(b"".join(k.digest for k in kids))

    flags = (
        _comp_flag_of(bootstrap)
        | (_FLAG_HASH_BLAKE3 if digester == "blake3" else _FLAG_HASH_SHA256)
        | _FLAG_EXPLICIT_UIDGID
        | (_FLAG_HAS_XATTR if any(r.xattrs for r in reals) else 0)
    )

    # The shared chunk table (v6 shape): unique (blob, offset) locations.
    seen: set[tuple[int, int]] = set()
    shared: list[RealChunk] = []
    for ri in reals:
        if ri.flags & _V5_FLAG_HARDLINK:
            continue
        for ck in ri.chunks:
            key = (ck.blob_index, ck.compressed_offset)
            if key not in seen:
                seen.add(key)
                shared.append(ck)

    prefetch_inos = [
        ino_of_path[p if p.startswith("/") else "/" + p]
        for p in getattr(bootstrap, "prefetch", [])
        if (p if p.startswith("/") else "/" + p) in ino_of_path
    ]

    return RealBootstrap(
        version=bootstrap.version
        if bootstrap.version in (layout.RAFS_V5, layout.RAFS_V6)
        else layout.RAFS_V6,
        flags=flags,
        inodes=reals,
        blobs=blobs,
        chunks=shared,
        prefetch_inos=prefetch_inos,
    )


def _table_order(real: RealBootstrap):
    """RAFS v5 table order, matching the reference builder exactly:
    pre-order DFS over directories — each directory's children laid out
    contiguously (child_index/child_count address that run), then its
    subdirectories recursed in bytewise name order (verified slot-by-slot
    against the committed v5 fixture). Returns (ordered inodes,
    first_child_slot: {id(dir): 1-based index}, child_count)."""
    by_parent: dict[str, list[RealInode]] = {}
    root = None
    for ri in real.inodes:
        if ri.path == "/":
            root = ri
            continue
        parent = ri.path.rsplit("/", 1)[0] or "/"
        by_parent.setdefault(parent, []).append(ri)
    if root is None:
        raise RealBootstrapError("bootstrap has no root inode")
    for kids in by_parent.values():
        kids.sort(key=lambda k: k.path.rsplit("/", 1)[1].encode())

    order = [root]
    first_child: dict[int, int] = {}
    count: dict[int, int] = {}

    def emit(node: RealInode):
        kids = by_parent.get(node.path, [])
        count[id(node)] = len(kids)
        first_child[id(node)] = len(order) + 1  # 1-based table index
        order.extend(kids)
        for k in kids:
            if k.is_dir:
                emit(k)

    emit(root)
    if len(order) != len(real.inodes):
        raise RealBootstrapError(
            f"{len(real.inodes) - len(order)} inodes unreachable from the root"
        )
    return order, first_child, count


def _v5_xattr_region(xattrs: dict[str, bytes]) -> bytes:
    body = io.BytesIO()
    for key in sorted(xattrs):
        pair = key.encode("utf-8", "surrogateescape") + b"\0" + xattrs[key]
        body.write(struct.pack("<I", len(pair)))
        body.write(pair)
        body.write(b"\0" * (_align8(len(pair)) - len(pair)))
    buf = body.getvalue()
    out = struct.pack("<Q", len(buf)) + buf
    return out + b"\0" * (_align8(len(out)) - len(out))


def write_real_v5(real: RealBootstrap) -> bytes:
    """Serialize a RealBootstrap in the reference's RAFS v5 layout
    (superblock / inode table / prefetch table / blob table / extended
    blob table / inode region — the section order of the committed
    fixture). parse_real_v5 round-trips the output exactly."""
    order, first_child, child_count = _table_order(real)

    ino_by_path: dict[str, int] = {}
    for ri in order:
        ino_by_path.setdefault(ri.path, ri.ino)

    ino_bufs: list[bytes] = []
    for ri in order:
        name = "/" if ri.path == "/" else ri.path.rsplit("/", 1)[1]
        nb = name.encode("utf-8", "surrogateescape")
        if len(nb) > 0xFFFF:
            raise RealBootstrapError(f"name too long: {name!r}")
        tb = ri.symlink_target.encode("utf-8", "surrogateescape")
        # hardlink aliases carry the flag and no chunk run; their head
        # does not carry it (parse rule in parse_real_v5)
        writes_chunks = (
            ri.is_regular and not (ri.flags & _V5_FLAG_HARDLINK) and ri.chunks
        )
        if ri.path == "/":
            parent_ino = 0
        else:
            parent_path = ri.path.rsplit("/", 1)[0] or "/"
            parent_ino = ino_by_path.get(parent_path, 0)
        if ri.is_dir:
            ci, cc = first_child.get(id(ri), 0), child_count.get(id(ri), 0)
        elif writes_chunks:
            ci, cc = 0, len(ri.chunks)
        else:
            ci, cc = 0, 0
        if len(ri.digest) != 32:
            raise RealBootstrapError(f"{ri.path}: inode digest must be 32 bytes")
        buf = io.BytesIO()
        buf.write(
            _V5_INODE.pack(
                ri.digest,
                parent_ino,
                ri.ino,
                ri.uid,
                ri.gid,
                0,  # projid
                ri.mode,
                ri.size,
                (ri.size + 511) // 512,  # 512-B sectors (fixture-verified)
                ri.flags,
                ri.nlink,
                ci,
                cc,
                len(nb),
                len(tb) if ri.flags & _V5_FLAG_SYMLINK else 0,
                ri.rdev,
                0,  # pad
                ri.mtime,
                0,  # mtime_ns
                0,  # reserved
            )
        )
        buf.write(nb)
        buf.write(b"\0" * (_align8(len(nb)) - len(nb)))
        if ri.flags & _V5_FLAG_SYMLINK:
            buf.write(tb)
            buf.write(b"\0" * (_align8(len(tb)) - len(tb)))
        if ri.flags & _V5_FLAG_XATTR:
            buf.write(_v5_xattr_region(ri.xattrs))
        if writes_chunks:
            for ck in ri.chunks:
                buf.write(
                    _V5_CHUNK.pack(
                        ck.digest,
                        ck.blob_index,
                        ck.flags,
                        ck.compressed_size,
                        ck.uncompressed_size,
                        ck.compressed_offset,
                        ck.uncompressed_offset,
                        ck.file_offset,
                        ck.index,
                        0,
                    )
                )
        ino_bufs.append(buf.getvalue())

    n = len(order)
    inode_table_off = _V5_SB_SIZE
    prefetch_off = _align8(inode_table_off + 4 * n)
    prefetch_buf = b"".join(struct.pack("<I", pi) for pi in real.prefetch_inos)
    blob_table_off = _align8(prefetch_off + len(prefetch_buf))
    blob_parts = []
    for i, blob in enumerate(real.blobs):
        rec = struct.pack("<II", 0, 0) + blob.blob_id.encode("ascii")
        if i + 1 < len(real.blobs):
            rec += b"\0"
        blob_parts.append(rec)
    blob_buf = b"".join(blob_parts)
    ext_blob_off = _align8(blob_table_off + len(blob_buf))
    ext_buf = b"".join(
        struct.pack(
            "<IIQQ", b.chunk_count, 0, b.uncompressed_size, b.compressed_size
        ).ljust(64, b"\0")
        for b in real.blobs
    )
    inodes_base = _align8(ext_blob_off + len(ext_buf))

    table = []
    pos = inodes_base
    for buf in ino_bufs:
        if pos & 7:
            raise RealBootstrapError("internal: inode offset not 8-aligned")
        table.append(pos >> 3)
        pos += len(buf)

    sb = _V5_SB.pack(
        layout.RAFS_V5_SUPER_MAGIC,
        0x500,
        _V5_SB_SIZE,
        real.blobs[0].chunk_size if real.blobs else 0x100000,
        real.flags,
        len({ri.ino for ri in order}),
        inode_table_off,
        prefetch_off,
        blob_table_off,
        n,
        len(real.prefetch_inos),
        len(blob_buf),
        len(real.blobs),
        ext_blob_off,
    )

    out = io.BytesIO()
    out.write(sb)
    out.write(b"\0" * (_V5_SB_SIZE - out.tell()))
    out.write(struct.pack(f"<{n}I", *table))
    out.write(b"\0" * (prefetch_off - out.tell()))
    out.write(prefetch_buf)
    out.write(b"\0" * (blob_table_off - out.tell()))
    out.write(blob_buf)
    out.write(b"\0" * (ext_blob_off - out.tell()))
    out.write(ext_buf)
    out.write(b"\0" * (inodes_base - out.tell()))
    for buf in ino_bufs:
        out.write(buf)
    return out.getvalue()


# ---------------------------------------------------------------------------
# RAFS v6 (EROFS + nydus extensions)
# ---------------------------------------------------------------------------

# On-disk contract shared with the reader (models/erofs_layout.py).
from nydus_snapshotter_tpu_torch.models.erofs_layout import (  # noqa: E402
    _CHUNK_INDEX,
    _DEVICE_SLOT,
    _DIRENT,
    _SB as _EROFS_SB_FULL,
    _encode_xattrs,
    _file_type,
    _XATTR_IBODY_HEADER,
)
from nydus_snapshotter_tpu_torch.models.nydus_real import (  # noqa: E402
    _NYDUS_EXT_SB,
    _NYDUS_EXT_SB_PREFETCH,
)

_V6_BLKSZBITS = 12
_V6_BLKSZ = 1 << _V6_BLKSZBITS
_V6_DEVT_SLOTOFF = 11  # fixture: device slots right after the ext sb region
_V6_ROOT_SLOT = 128  # fixture: inodes start one block into the meta area
_V6_INODE_EXT = struct.Struct("<HHHHQIIIIQII")  # + 16 reserved bytes = 64
_V6_LAYOUT_PLAIN = 0
_V6_LAYOUT_INLINE = 2
_V6_LAYOUT_CHUNK = 4
_V6_CHUNK_FORMAT_INDEXES = 0x0020
_V6_FEAT_CHUNKED_FILE = 0x4
_V6_FEAT_DEVICE_TABLE = 0x8


class _V6Node:
    __slots__ = (
        "ri", "nid", "ino", "nlink", "dl", "iu", "inline", "data_blocks",
        "xattr_body", "chunks", "kids",
    )

    def __init__(self, ri: RealInode):
        self.ri = ri
        self.nid = 0
        self.ino = 0
        self.nlink = 1
        self.dl = _V6_LAYOUT_INLINE
        self.iu = 0
        self.inline = b""
        self.data_blocks = b""
        self.xattr_body = b""
        self.chunks: list[RealChunk] = []
        self.kids: list["_V6Node"] = []


def _v6_dir_blocks(entries: list[tuple[bytes, int, int]]) -> bytes:
    """Serialize sorted (name, nid, ftype) dirents: greedy per-block
    packing, names unpadded in the final block (so the byte length IS the
    directory size, matching the fixture's exact-tail sizes)."""
    entries = sorted(entries, key=lambda t: t[0])
    blocks: list[list[tuple[bytes, int, int]]] = []
    cur: list[tuple[bytes, int, int]] = []
    used = 0
    for name, nid, ft in entries:
        cost = _DIRENT.size + len(name)
        if cost > _V6_BLKSZ:
            raise RealBootstrapError(f"dirent {name!r} exceeds the 4 KiB block")
        if cur and used + cost > _V6_BLKSZ:
            blocks.append(cur)
            cur, used = [], 0
        cur.append((name, nid, ft))
        used += cost
    if cur:
        blocks.append(cur)
    out = io.BytesIO()
    for bi, ents in enumerate(blocks):
        base = out.tell()
        nameoff = len(ents) * _DIRENT.size
        names = io.BytesIO()
        for name, nid, ft in ents:
            out.write(_DIRENT.pack(nid, nameoff + names.tell(), ft, 0))
            names.write(name)
        out.write(names.getvalue())
        if bi < len(blocks) - 1:
            out.write(b"\0" * (base + _V6_BLKSZ - out.tell()))
    return out.getvalue()


def _v6_realign_uoffs(real: RealBootstrap) -> dict[tuple[int, int], int]:
    """(blob_index, compressed_offset) -> block-aligned uncompressed
    offset. v6 chunk indexes address 4 KiB blocks, so every chunk's
    virtual uncompressed offset must be block-aligned; bootstraps from
    the internal pack engine carry packed (unaligned) offsets, which are
    re-laid per blob in compressed-offset order — exactly the aligned
    virtual layout the real builder produces. Already-aligned inputs
    (parsed real bootstraps) map to themselves."""
    keys: dict[tuple[int, int], RealChunk] = {}
    for ri in real.inodes:
        for ck in ri.chunks:
            keys.setdefault((ck.blob_index, ck.compressed_offset), ck)
    for ck in real.chunks:
        keys.setdefault((ck.blob_index, ck.compressed_offset), ck)
    if all(ck.uncompressed_offset % _V6_BLKSZ == 0 for ck in keys.values()):
        return {k: ck.uncompressed_offset for k, ck in keys.items()}
    out: dict[tuple[int, int], int] = {}
    per_blob: dict[int, list[tuple[int, RealChunk]]] = {}
    for (bi, coff), ck in keys.items():
        per_blob.setdefault(bi, []).append((coff, ck))
    for bi, lst in per_blob.items():
        pos = 0
        for coff, ck in sorted(lst):
            out[(bi, coff)] = pos
            pos += ck.uncompressed_size
            pos += (-pos) % _V6_BLKSZ
    return out


def write_real_v6(real: RealBootstrap) -> bytes:
    """Serialize a RealBootstrap in the reference's RAFS v6 layout: a
    kernel-mountable EROFS image (extended inodes, FLAT_INLINE tails,
    CHUNK_BASED regular files, per-blob device slots) plus the nydus
    extended superblock, 256-B blob table, prefetch table, and shared
    80-B chunk table. parse_real_v6 round-trips the output; the layout
    parameters (devt slot 11, root one block into the meta area, blob
    table on the block after the device slots, 512-B-sector-free
    extended inodes) mirror the committed fixture.

    One deliberate divergence from the Rust builder: its chunk table is
    emitted in hash-map iteration order (irreproducible); this writer
    uses first-appearance order over the directory walk, which is
    deterministic and carries the identical record multiset."""
    # --- tree & head/alias resolution -----------------------------------
    by_path: dict[str, _V6Node] = {}
    root = None
    for ri in real.inodes:
        node = _V6Node(ri)
        by_path[ri.path] = node
        if ri.path == "/":
            root = node
    if root is None:
        raise RealBootstrapError("bootstrap has no root inode")
    head_of_ino: dict[int, _V6Node] = {}
    order_hint = {id(ri): i for i, ri in enumerate(real.inodes)}
    for ri in sorted(real.inodes, key=lambda r: order_hint[id(r)]):
        head_of_ino.setdefault(ri.ino, by_path[ri.path])
    for path, node in by_path.items():
        if path == "/":
            continue
        parent = by_path.get(path.rsplit("/", 1)[0] or "/")
        if parent is None:
            raise RealBootstrapError(f"orphan path {path!r}")
        parent.kids.append(node)
    for node in by_path.values():
        node.kids.sort(key=lambda k: k.ri.path.rsplit("/", 1)[1].encode())

    # nlink: dirs 2 + subdirs; files their hardlink-group size.
    group: dict[int, int] = {}
    for ri in real.inodes:
        group[ri.ino] = group.get(ri.ino, 0) + 1
    for node in by_path.values():
        node.nlink = (
            2 + sum(1 for k in node.kids if k.ri.is_dir)
            if node.ri.is_dir
            else group[node.ri.ino]
        )

    # Disk order: per directory, non-dir children first, then dir
    # children each with its whole subtree (fixture-verified).
    disk: list[_V6Node] = []

    def emit(node: _V6Node):
        disk.append(node)
        files = [
            k
            for k in node.kids
            if not k.ri.is_dir and head_of_ino[k.ri.ino] is k
        ]
        disk.extend(files)
        for k in node.kids:
            if k.ri.is_dir:
                emit(k)

    emit(root)

    # v6 chunk indexes address a per-file fixed grid: index ci covers file
    # bytes [ci*chunk_size, (ci+1)*chunk_size). Variable-size (CDC) chunk
    # runs cannot be represented — reject them loudly (the fixture's own
    # multi-chunk files sit on an exact 1 MiB grid, f_off included).
    grid = real.blobs[0].chunk_size if real.blobs else 0x100000
    for node in disk:
        run = node.ri.chunks
        for ci, ck in enumerate(run):
            want = min(grid, max(node.ri.size - ci * grid, 0)) if node.ri.size else 0
            if ck.uncompressed_size != want:
                raise RealBootstrapError(
                    f"{node.ri.path}: chunk {ci} has {ck.uncompressed_size} "
                    f"uncompressed bytes but the v6 fixed grid needs {want} "
                    f"(chunk_size {grid:#x}); RAFS v6 cannot carry variable "
                    "CDC chunks - pack with chunking='fixed' or emit v5"
                )

    uoff_of = _v6_realign_uoffs(real)

    # --- per-node bodies (sizes first; dirents need nids, done later) ---
    for node in disk:
        ri = node.ri
        node.xattr_body = _encode_xattrs(ri.xattrs)
        if ri.is_dir:
            node.dl = _V6_LAYOUT_INLINE
        elif ri.is_symlink:
            node.dl = _V6_LAYOUT_INLINE
            node.inline = ri.symlink_target.encode("utf-8", "surrogateescape")
        elif ri.is_regular:
            node.dl = _V6_LAYOUT_CHUNK
            node.chunks = list(ri.chunks)
        else:  # char/block/fifo/socket
            node.dl = _V6_LAYOUT_PLAIN
            major, minor = os.major(ri.rdev), os.minor(ri.rdev)
            node.iu = (minor & 0xFF) | (major << 8) | ((minor & ~0xFF) << 12)

    # Directory sizes need only names; serialize dirents with nid=0 to
    # size them, then re-serialize after nid assignment.
    def dir_entries(node: _V6Node, nids: bool) -> list[tuple[bytes, int, int]]:
        ents = [
            (b".", node.nid if nids else 0, 2),
            (b"..", (node_parent[id(node)].nid if nids else 0), 2),
        ]
        for k in node.kids:
            tgt = head_of_ino[k.ri.ino] if not k.ri.is_dir else k
            ents.append(
                (
                    k.ri.path.rsplit("/", 1)[1].encode("utf-8", "surrogateescape"),
                    tgt.nid if nids else 0,
                    _file_type(k.ri.mode),
                )
            )
        return ents

    node_parent: dict[int, _V6Node] = {id(root): root}
    for node in by_path.values():
        for k in node.kids:
            node_parent[id(k)] = node

    dir_sizes: dict[int, int] = {}
    for node in disk:
        if node.ri.is_dir:
            dir_sizes[id(node)] = len(_v6_dir_blocks(dir_entries(node, False)))

    # --- layout: slots, block-aligned full dir blocks -------------------
    # Geometry (fixture-shaped): sb + ext sb, device slots at slot 11,
    # blob table on the next block, prefetch right after it, meta area on
    # the block after that, inodes starting one block into it.
    n_blobs = len(real.blobs)
    devt_end = _V6_DEVT_SLOTOFF * 128 + 128 * n_blobs
    blob_table_off = devt_end + (-devt_end) % _V6_BLKSZ
    blob_table_size = 256 * n_blobs
    prefetch_off = blob_table_off + blob_table_size
    nid_of_ino = {}
    prefetch_nids: list[int] = []
    prefetch_size = 4 * len(real.prefetch_inos)
    meta_end = prefetch_off + prefetch_size
    meta_blkaddr = -(-meta_end // _V6_BLKSZ)
    meta_base = meta_blkaddr * _V6_BLKSZ

    def slot_bytes(node: _V6Node) -> tuple[int, int]:
        """(bytes after the 64-B inode in the slot run, inline tail len)."""
        extra = len(node.xattr_body)
        if node.dl == _V6_LAYOUT_CHUNK:
            pad = (-(64 + extra)) % 8
            return extra + pad + 8 * len(node.chunks), 0
        size = dir_sizes[id(node)] if node.ri.is_dir else len(node.inline)
        tail = size % _V6_BLKSZ if size else 0
        return extra + tail, tail

    pos = meta_base + _V6_ROOT_SLOT * 32
    for node in disk:
        size = (
            dir_sizes[id(node)]
            if node.ri.is_dir
            else len(node.inline)
            if node.dl == _V6_LAYOUT_INLINE
            else node.ri.size
        )
        full_blocks = size // _V6_BLKSZ if node.dl == _V6_LAYOUT_INLINE else 0
        extra, tail = slot_bytes(node)
        if full_blocks:
            # inode at a block start; its full data blocks on the block(s)
            # right after the inode's block (fixture rule for big dirs)
            pos += (-pos) % _V6_BLKSZ
            if 64 + extra > _V6_BLKSZ:
                raise RealBootstrapError(
                    f"{node.ri.path}: inline tail cannot fit one block"
                )
        elif tail and (pos % _V6_BLKSZ) + 64 + extra > _V6_BLKSZ:
            # the inline tail must not cross a block boundary
            pos += (-pos) % _V6_BLKSZ
        node.nid = (pos - meta_base) // 32
        if full_blocks:
            data_blk = (pos + 64 + extra + _V6_BLKSZ - 1) // _V6_BLKSZ
            node.iu = data_blk
            pos = (data_blk + full_blocks) * _V6_BLKSZ
        else:
            if node.dl == _V6_LAYOUT_INLINE:
                node.iu = (pos + 64 + len(node.xattr_body)) >> _V6_BLKSZBITS
            pos += 64 + extra
            pos += (-pos) % 32
    slots_end = pos

    for node in disk:
        node.ino = node.ri.ino
        nid_of_ino[node.ri.ino] = node.nid
    prefetch_nids = [
        nid_of_ino[i] for i in real.prefetch_inos if i in nid_of_ino
    ]

    # --- chunk table: first-appearance order over the disk walk ---------
    table_recs: list[RealChunk] = []
    seen_key: set[tuple[int, int]] = set()
    for node in disk:
        for ck in node.chunks:
            key = (ck.blob_index, ck.compressed_offset)
            if key not in seen_key:
                seen_key.add(key)
                table_recs.append(ck)
    chunk_table_off = slots_end + (-slots_end) % _V6_BLKSZ
    chunk_table_size = 80 * len(table_recs)
    total = chunk_table_off + chunk_table_size
    total += (-total) % _V6_BLKSZ

    # --- serialize ------------------------------------------------------
    out = bytearray(total)

    chunk_size = real.blobs[0].chunk_size if real.blobs else 0x100000
    if chunk_size & (chunk_size - 1) or not chunk_size:
        raise RealBootstrapError(f"v6 chunk size {chunk_size:#x} not a power of 2")
    chunk_bits = chunk_size.bit_length() - 1
    if chunk_bits < _V6_BLKSZBITS:
        raise RealBootstrapError(f"v6 chunk size {chunk_size:#x} below block size")

    feat = _V6_FEAT_DEVICE_TABLE if n_blobs else 0
    if any(node.dl == _V6_LAYOUT_CHUNK for node in disk):
        feat |= _V6_FEAT_CHUNKED_FILE
    sb = _EROFS_SB_FULL.pack(
        layout.RAFS_V6_SUPER_MAGIC,
        0,
        0,
        _V6_BLKSZBITS,
        0,
        root.nid,
        len(real.inodes),
        0,
        0,
        total // _V6_BLKSZ,
        meta_blkaddr,
        0,
        b"\0" * 16,
        b"\0" * 16,
        feat,
        0,
        n_blobs,
        _V6_DEVT_SLOTOFF if n_blobs else 0,
        0,
        0,
        0,
        0,
        0,
        b"\0" * 23,
    )
    out[1024 : 1024 + len(sb)] = sb
    ext = _NYDUS_EXT_SB.pack(
        real.flags,
        blob_table_off,
        blob_table_size,
        chunk_size,
        chunk_table_off,
        chunk_table_size,
    ) + _NYDUS_EXT_SB_PREFETCH.pack(
        prefetch_off if prefetch_nids else 0, 4 * len(prefetch_nids)
    )
    out[1152 : 1152 + len(ext)] = ext

    for i, blob in enumerate(real.blobs):
        slot_off = _V6_DEVT_SLOTOFF * 128 + 128 * i
        out[slot_off : slot_off + 128] = _DEVICE_SLOT.pack(
            blob.blob_id.encode("ascii")[:64].ljust(64, b"\0"),
            -(-(blob.uncompressed_size or blob.compressed_size) // _V6_BLKSZ),
            0,
            b"\0" * 56,
        )
        if blob.raw_rec:
            rec = blob.raw_rec
        else:
            # fields validated against the fixture record; +76/+80 carry
            # the constants the fixture does (features / cipher config)
            rec = (
                blob.blob_id.encode("ascii")[:64].ljust(64, b"\0")
                + struct.pack(
                    "<IIII", i, chunk_size, blob.chunk_count, 1
                )
                + struct.pack(
                    "<QQQ",
                    0x1_0000_0000,
                    blob.compressed_size,
                    blob.uncompressed_size,
                )
            ).ljust(256, b"\0")
        off = blob_table_off + 256 * i
        out[off : off + 256] = rec

    for i, nid in enumerate(prefetch_nids):
        struct.pack_into("<I", out, prefetch_off + 4 * i, nid)

    for node in disk:
        ri = node.ri
        off = meta_base + 32 * node.nid
        if node.dl == _V6_LAYOUT_CHUNK:
            iu = _V6_CHUNK_FORMAT_INDEXES | (chunk_bits - _V6_BLKSZBITS)
        else:
            iu = node.iu
        xic = (
            1 + (len(node.xattr_body) - _XATTR_IBODY_HEADER.size) // 4
            if node.xattr_body
            else 0
        )
        size = (
            dir_sizes[id(node)]
            if ri.is_dir
            else len(node.inline)
            if node.dl == _V6_LAYOUT_INLINE
            else ri.size
        )
        inode = _V6_INODE_EXT.pack(
            (node.dl << 1) | 1,
            xic,
            ri.mode & 0xFFFF,
            0,
            size,
            iu,
            node.ino,
            ri.uid,
            ri.gid,
            ri.mtime,
            0,
            node.nlink,
        ) + b"\0" * 16
        out[off : off + 64] = inode
        body = off + 64
        out[body : body + len(node.xattr_body)] = node.xattr_body
        body += len(node.xattr_body)
        if node.dl == _V6_LAYOUT_CHUNK:
            body += (-(body - off)) % 8
            for ci, ck in enumerate(node.chunks):
                uoff = uoff_of[(ck.blob_index, ck.compressed_offset)]
                struct.pack_into(
                    "<HHI",
                    out,
                    body + 8 * ci,
                    0,
                    ck.blob_index + 1,
                    uoff >> _V6_BLKSZBITS,
                )
        elif node.dl == _V6_LAYOUT_INLINE:
            data = (
                _v6_dir_blocks(dir_entries(node, True))
                if ri.is_dir
                else node.inline
            )
            nbl = len(data) // _V6_BLKSZ
            if nbl:
                dst = node.iu * _V6_BLKSZ
                out[dst : dst + nbl * _V6_BLKSZ] = data[: nbl * _V6_BLKSZ]
            tail = data[nbl * _V6_BLKSZ :]
            out[body : body + len(tail)] = tail

    for i, ck in enumerate(table_recs):
        off = chunk_table_off + 80 * i
        out[off : off + 80] = _V5_CHUNK.pack(
            ck.digest,
            ck.blob_index,
            ck.flags,
            ck.compressed_size,
            ck.uncompressed_size,
            ck.compressed_offset,
            uoff_of[(ck.blob_index, ck.compressed_offset)],
            ck.file_offset,
            ck.index,
            0,
        )

    return bytes(out)
