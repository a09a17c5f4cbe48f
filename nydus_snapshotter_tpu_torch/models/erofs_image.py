"""EROFS on-disk image writer: kernel-mountable block images from a file
tree.

The reference's blockdev/tarfs modes hand the kernel a *real* EROFS image
produced by ``nydus-image export --block`` (invoked at
pkg/tarfs/tarfs.go:525-541, mounted with ``mount -t erofs`` at :573-662 via
pkg/utils/erofs). This module is the native equivalent: it serializes a
file tree into the EROFS on-disk format that the in-kernel erofs driver
mounts directly — no external mkfs.erofs, no FUSE in the read path. The
kernel is the format oracle: tests loop-attach the produced images, mount
them, and compare the tree byte-for-byte.

Two shapes:
- **Self-contained** (``build_erofs``): file data inline in the image,
  FLAT_PLAIN layout — the blockdev whole-image export.
- **Chunk-based with a device table** (``chunk_map`` + ``device``): regular
  files become CHUNK_BASED inodes whose 8-byte chunk indexes point into an
  *external blob device* (the uncompressed layer tar, loop-attached and
  passed to the kernel via ``mount -o device=``). This is the tarfs shape:
  the tar IS the data plane, the EROFS image holds only metadata — chunk
  reads go straight from the kernel to the tar with zero copies. Tar file
  data is 512-aligned, so these images use 512-byte blocks (sub-page block
  support, Linux 6.3+).

Format notes (Linux fs/erofs/erofs_fs.h):
- Superblock at offset 1024 (magic 0xE0F5E1E2 — the same magic pkg/layout
  detects at that offset).
- Compact (32-byte) inodes in a metadata area starting at
  ``meta_blkaddr``; an inode's nid is its 32-byte slot index. Chunk
  indexes follow their inode in the slot array.
- Directories are arrays of 12-byte dirents per block, names packed after
  the dirent array, entries sorted bytewise (the kernel binary-searches,
  both across blocks by first-name and within a block).
- Inline xattrs (prefix-indexed entries after the inode; POSIX ACL names
  as exact-match indexes); no compression. feature_compat = 0 keeps the
  checksum optional; feature_incompat carries only
  CHUNKED_FILE|DEVICE_TABLE when used.
"""

from __future__ import annotations

import io
import os
import stat as statmod
import struct
from dataclasses import dataclass, field
from typing import Optional

from nydus_snapshotter_tpu_torch.models.fstree import FileEntry

BLKSZ = 4096
BLKSZBITS = 12
EROFS_MAGIC = 0xE0F5E1E2
SB_OFFSET = 1024

# datalayout values (i_format bits 1..3; bit 0 = 0 for compact inodes)
_LAYOUT_FLAT_PLAIN = 0
_LAYOUT_CHUNK_BASED = 4

_CHUNK_FORMAT_INDEXES = 0x0020
_FEATURE_INCOMPAT_CHUNKED_FILE = 0x00000004
_FEATURE_INCOMPAT_DEVICE_TABLE = 0x00000008

_DEVT_SLOT_SIZE = 128
_DEVT_SLOTOFF = (SB_OFFSET + 128) // _DEVT_SLOT_SIZE  # right after the sb

_FT_OF_MODE = [
    (statmod.S_ISREG, 1),
    (statmod.S_ISDIR, 2),
    (statmod.S_ISCHR, 3),
    (statmod.S_ISBLK, 4),
    (statmod.S_ISFIFO, 5),
    (statmod.S_ISSOCK, 6),
    (statmod.S_ISLNK, 7),
]

_SB = struct.Struct("<IIIBBHQQIIII16s16sIHHHBBIQB23s")
assert _SB.size == 128, _SB.size
_INODE_COMPACT = struct.Struct("<HHHHIIIIHHI")
_DIRENT = struct.Struct("<QHBB")
_CHUNK_INDEX = struct.Struct("<HHI")  # advise, device_id, blkaddr
_DEVICE_SLOT = struct.Struct("<64sII56s")
assert _DEVICE_SLOT.size == _DEVT_SLOT_SIZE
_XATTR_IBODY_HEADER = struct.Struct("<IB7s")  # name_filter, shared_count, pad
_XATTR_ENTRY = struct.Struct("<BBH")  # name_len, name_index, value_size

# Well-known xattr name prefixes (erofs_fs.h EROFS_XATTR_INDEX_*). The
# POSIX ACL names are exact matches encoded as an index with an EMPTY
# remaining name.
_XATTR_EXACT = {
    "system.posix_acl_access": 2,
    "system.posix_acl_default": 3,
}
_XATTR_PREFIXES = [
    ("user.", 1),
    ("trusted.", 4),
    ("security.", 6),
]


def _encode_xattrs(xattrs: dict[str, bytes]) -> bytes:
    """Inline xattr ibody: header + 4-aligned entries, sorted for
    determinism. Returns b'' when there are none. Names outside the EROFS
    prefix registry are rejected — index 0 entries would be unreadable on
    the mounted filesystem, a silent data loss."""
    if not xattrs:
        return b""
    body = io.BytesIO()
    body.write(_XATTR_IBODY_HEADER.pack(0, 0, b"\0" * 7))
    for key in sorted(xattrs):
        value = xattrs[key]
        if key in _XATTR_EXACT:
            index, name = _XATTR_EXACT[key], ""
        else:
            for prefix, idx in _XATTR_PREFIXES:
                if key.startswith(prefix) and len(key) > len(prefix):
                    index, name = idx, key[len(prefix) :]
                    break
            else:
                raise ErofsError(f"xattr namespace not representable: {key!r}")
        nb = name.encode()
        if len(nb) > 0xFF or len(value) > 0xFFFF:
            raise ErofsError(f"xattr {key!r} name/value too large")
        body.write(_XATTR_ENTRY.pack(len(nb), index, len(value)))
        body.write(nb)
        body.write(value)
        body.write(b"\0" * (-(_XATTR_ENTRY.size + len(nb) + len(value)) % 4))
    return body.getvalue()


class ErofsError(ValueError):
    pass


@dataclass(frozen=True)
class ChunkedData:
    """Chunk extents for one regular file (tarfs / block-disk shapes).

    ``device_id`` 0 addresses the primary device (the image itself — the
    self-contained disk layout where tar data is appended after the
    metadata); 1 addresses the first extra device (the loop-attached tar).
    """

    size: int
    chunk_size: int  # power of two, >= block size
    offsets: list[int]  # byte offset of each chunk on the target device
    device_id: int = 1


def _file_type(mode: int) -> int:
    for pred, ft in _FT_OF_MODE:
        if pred(mode):
            return ft
    return 0


@dataclass
class _Node:
    entry: FileEntry
    nid: int = 0
    ino: int = 0
    nlink: int = 1
    data: bytes = b""
    size: int = 0
    raw_blkaddr: int = 0
    chunked: Optional[ChunkedData] = None
    xattr_body: bytes = b""
    children: dict[bytes, "_Node"] = field(default_factory=dict)
    parent: Optional["_Node"] = None

    def meta_bytes(self, blkszbits: int) -> bytes:
        """Everything after the 32-byte inode struct in this inode's slot
        run: xattr ibody, then 8-aligned chunk indexes (the kernel reads
        them at ALIGN(iloc + inode_size + xattr_isize, 8))."""
        out = io.BytesIO()
        out.write(self.xattr_body)
        if self.chunked is not None:
            pos = _INODE_COMPACT.size + out.tell()
            out.write(b"\0" * (-pos % 8))
            for off in self.chunked.offsets:
                out.write(
                    _CHUNK_INDEX.pack(0, self.chunked.device_id, off >> blkszbits)
                )
        return out.getvalue()

    def slots(self, blkszbits: int) -> int:
        total = _INODE_COMPACT.size + len(self.meta_bytes(blkszbits))
        return -(-total // _INODE_COMPACT.size)


def _build_tree(entries: list[FileEntry]) -> tuple[_Node, dict[str, "_Node"]]:
    root_entry = FileEntry(path="/", mode=statmod.S_IFDIR | 0o755)
    root = _Node(entry=root_entry)
    by_path: dict[str, _Node] = {"/": root}

    def ensure_dir(path: str) -> _Node:
        node = by_path.get(path)
        if node is not None:
            if not statmod.S_ISDIR(node.entry.mode):
                raise ErofsError(f"{path} used as directory and non-directory")
            return node
        parent = ensure_dir(path.rsplit("/", 1)[0] or "/")
        node = _Node(entry=FileEntry(path=path, mode=statmod.S_IFDIR | 0o755))
        node.parent = parent
        parent.children[path.rsplit("/", 1)[1].encode()] = node
        by_path[path] = node
        return node

    for e in sorted(entries, key=lambda e: e.path):
        if e.path == "/":
            root.entry = e
            continue
        name = e.path.rsplit("/", 1)[1]
        if len(name.encode()) > 255:
            raise ErofsError(f"name too long: {name!r}")
        parent = ensure_dir(e.path.rsplit("/", 1)[0] or "/")
        existing = by_path.get(e.path)
        if existing is not None and statmod.S_ISDIR(existing.entry.mode) and e.is_dir:
            existing.entry = e  # explicit dir entry refines a placeholder
            continue
        node = _Node(entry=e)
        node.parent = parent
        parent.children[name.encode()] = node
        by_path[e.path] = node
    return root, by_path


def _dir_blocks(node: _Node, nid_of: dict[int, int], blksz: int) -> bytes:
    """Serialize one directory's dirent blocks (kernel-sorted)."""
    items: list[tuple[bytes, int, int]] = [
        (b".", id(node), _file_type(node.entry.mode)),
        (b"..", id(node.parent or node), _file_type((node.parent or node).entry.mode)),
    ]
    for name, child in node.children.items():
        items.append((name, id(child), _file_type(child.entry.mode)))
    items.sort(key=lambda t: t[0])

    blocks: list[list[tuple[bytes, int, int]]] = []
    cur: list[tuple[bytes, int, int]] = []
    used = 0
    for name, key, ft in items:
        cost = _DIRENT.size + len(name)
        if cost > blksz:
            raise ErofsError(f"dirent {name!r} exceeds block size {blksz}")
        if cur and used + cost > blksz:
            blocks.append(cur)
            cur, used = [], 0
        cur.append((name, key, ft))
        used += cost
    if cur:
        blocks.append(cur)

    out = io.BytesIO()
    for i, ents in enumerate(blocks):
        base = out.tell()
        nameoff = len(ents) * _DIRENT.size
        names = io.BytesIO()
        for name, key, ft in ents:
            out.write(_DIRENT.pack(nid_of[key], nameoff + names.tell(), ft, 0))
            names.write(name)
        out.write(names.getvalue())
        if i < len(blocks) - 1:
            out.write(b"\0" * (base + blksz - out.tell()))
    return out.getvalue()


def build_erofs(
    entries: list[FileEntry],
    volume_name: bytes = b"ntpu-erofs",
    blkszbits: int = BLKSZBITS,
    chunk_map: Optional[dict[str, ChunkedData]] = None,
    device: Optional[tuple[bytes, int]] = None,
    total_size: Optional[int] = None,
    devices: Optional[list[tuple[bytes, int]]] = None,
) -> bytes:
    """Serialize ``entries`` into a mountable EROFS image.

    Hardlinks (``entry.hardlink_target``) share the target's inode and bump
    its nlink. Whiteouts are callers' business (overlay semantics live a
    layer up); xattrs are emitted inline (user./trusted./security.
    prefixes and POSIX ACL names — anything else raises).

    ``chunk_map`` maps paths of regular files to external-device extents
    (CHUNK_BASED inodes, data read from the blob device); ``devices`` are
    the (tag, size_bytes) of the blob devices in device-table order —
    ``ChunkedData.device_id`` N addresses ``devices[N-1]``, and the kernel
    maps them positionally from the ``-o device=`` list at mount time
    (multi-layer tarfs images carry one tar device per layer). ``device``
    is single-device sugar. Chunk offsets must be block-aligned — tarfs
    callers use ``blkszbits=9`` so 512-aligned tar data qualifies.
    """
    chunk_map = chunk_map or {}
    if devices is None:
        devices = [device] if device is not None else []
    elif device is not None:
        raise ErofsError("pass device or devices, not both")
    for cd in chunk_map.values():
        if cd.device_id > len(devices):
            raise ErofsError(
                f"chunk device_id {cd.device_id} exceeds the "
                f"{len(devices)}-entry device table"
            )
    if not 9 <= blkszbits <= 12:
        raise ErofsError(f"blkszbits {blkszbits} outside the supported 9..12")
    blksz = 1 << blkszbits

    root, by_path = _build_tree(entries)
    alias_of: dict[int, _Node] = {}
    order: list[_Node] = []

    def collect(node: _Node):
        order.append(node)
        for name in sorted(node.children):
            collect(node.children[name])

    collect(root)

    real_nodes: list[_Node] = []
    for node in order:
        tgt_path = node.entry.hardlink_target
        if tgt_path and not node.entry.is_dir:
            # Resolve chains (a hardlink whose target is itself a hardlink)
            # to the final real inode; anything else would emit a dirent
            # pointing at an inode that never gets written.
            target = by_path.get("/" + tgt_path.lstrip("/"))
            seen_ids = {id(node)}
            while target is not None and target.entry.hardlink_target:
                if id(target) in seen_ids:
                    raise ErofsError(f"hardlink cycle via {tgt_path}")
                seen_ids.add(id(target))
                target = by_path.get(
                    "/" + target.entry.hardlink_target.lstrip("/")
                )
            if target is None or target.entry.is_dir:
                raise ErofsError(f"hardlink target missing: {tgt_path}")
            alias_of[id(node)] = target
            target.nlink += 1
        else:
            real_nodes.append(node)

    # nlink for directories: 2 + subdirectories.
    for node in real_nodes:
        if statmod.S_ISDIR(node.entry.mode):
            node.nlink = 2 + sum(
                1 for c in node.children.values() if statmod.S_ISDIR(c.entry.mode)
            )

    # Attach chunked extents and validate them.
    for node in real_nodes:
        cd = chunk_map.get(node.entry.path)
        if cd is None:
            continue
        if not statmod.S_ISREG(node.entry.mode):
            raise ErofsError(f"chunk_map path {node.entry.path} is not a regular file")
        if cd.chunk_size < blksz or cd.chunk_size & (cd.chunk_size - 1):
            raise ErofsError(
                f"chunk size {cd.chunk_size:#x} must be a power of two >= {blksz}"
            )
        expected = max(0, -(-cd.size // cd.chunk_size))
        if len(cd.offsets) != expected:
            raise ErofsError(
                f"{node.entry.path}: {len(cd.offsets)} chunk offsets for "
                f"size {cd.size} (expected {expected})"
            )
        if cd.device_id == 0:
            # Primary-device extents live in this image past the metadata;
            # bounds come from the declared final image size.
            if total_size is None:
                raise ErofsError(
                    f"{node.entry.path}: primary-device chunks need total_size"
                )
            dev_size = total_size
        else:
            # in-range per the device-table guard above
            dev_size = devices[cd.device_id - 1][1]
        for k, off in enumerate(cd.offsets):
            if off % blksz:
                raise ErofsError(
                    f"{node.entry.path}: chunk offset {off:#x} not {blksz}-aligned"
                )
            extent = min(cd.chunk_size, cd.size - k * cd.chunk_size)
            if off + extent > dev_size:
                raise ErofsError(
                    f"{node.entry.path}: chunk [{off:#x}, {off + extent:#x}) "
                    f"outside the {dev_size}-byte device"
                )
        node.chunked = cd

    # Assign nids: slot index in the 32-byte-unit metadata area; xattrs and
    # chunk indexes occupy the slots right after their inode.
    meta_blkaddr_bytes = SB_OFFSET + 128
    if devices:
        meta_blkaddr_bytes = (_DEVT_SLOTOFF + len(devices)) * _DEVT_SLOT_SIZE
    meta_blkaddr = -(-meta_blkaddr_bytes // blksz)
    orphans = set(chunk_map) - set(by_path)
    if orphans:
        raise ErofsError(f"chunk_map paths not in entries: {sorted(orphans)[:3]}")
    slot = 0
    for node in real_nodes:
        node.xattr_body = _encode_xattrs(node.entry.xattrs)
        node.nid = slot
        node.ino = slot + 1
        slot += node.slots(blkszbits)
    total_slots = slot
    nid_of: dict[int, int] = {}
    for node in order:
        target = alias_of.get(id(node))
        nid_of[id(node)] = (target or node).nid
    root_nid = root.nid
    if root_nid > 0xFFFF:
        raise ErofsError("root nid exceeds the superblock's le16 field")

    meta_bytes = total_slots * _INODE_COMPACT.size
    meta_blocks = max(1, -(-meta_bytes // blksz))
    data_blkaddr = meta_blkaddr + meta_blocks

    # Lay out data: in nid order.
    data = io.BytesIO()

    def alloc(payload: bytes) -> int:
        if not payload:
            return 0
        addr = data_blkaddr + data.tell() // blksz
        data.write(payload)
        data.write(b"\0" * (-len(payload) % blksz))
        return addr

    for node in real_nodes:
        e = node.entry
        if statmod.S_ISDIR(e.mode):
            node.data = _dir_blocks(node, nid_of, blksz)
        elif statmod.S_ISLNK(e.mode):
            node.data = e.symlink_target.encode()
        elif statmod.S_ISREG(e.mode) and node.chunked is None:
            node.data = e.data
        else:
            node.data = b""
        node.size = node.chunked.size if node.chunked else len(node.data)
        node.raw_blkaddr = alloc(node.data)

    # Inode table (+ inline chunk indexes).
    meta = io.BytesIO()
    for node in real_nodes:
        e = node.entry
        if node.chunked is not None:
            layout = _LAYOUT_CHUNK_BASED
            chunkbits = node.chunked.chunk_size.bit_length() - 1 - blkszbits
            i_u = _CHUNK_FORMAT_INDEXES | chunkbits
        elif statmod.S_ISCHR(e.mode) or statmod.S_ISBLK(e.mode):
            layout = _LAYOUT_FLAT_PLAIN
            # kernel new_encode_dev(): minor low byte | major << 8 | rest of
            # minor << 12
            major, minor = os.major(e.rdev), os.minor(e.rdev)
            i_u = (minor & 0xFF) | (major << 8) | ((minor & ~0xFF) << 12)
        else:
            layout = _LAYOUT_FLAT_PLAIN
            i_u = node.raw_blkaddr
        # Compact (32-byte) inodes cannot represent these; wrapping would
        # produce a silently-corrupt mount, so reject loudly.
        if node.size > 0xFFFFFFFF:
            raise ErofsError(f"{e.path}: size {node.size} exceeds compact inode")
        if node.nlink > 0xFFFF:
            raise ErofsError(f"{e.path}: nlink {node.nlink} exceeds compact inode")
        if e.uid > 0xFFFF or e.gid > 0xFFFF:
            raise ErofsError(f"{e.path}: uid/gid exceed compact inode 16-bit fields")
        # i_xattr_icount: ibody bytes = 12 + 4*(icount-1) (erofs_fs.h).
        xattr_icount = (
            1 + (len(node.xattr_body) - _XATTR_IBODY_HEADER.size) // 4
            if node.xattr_body
            else 0
        )
        meta.write(
            _INODE_COMPACT.pack(
                (layout << 1) | 0,
                xattr_icount,
                e.mode & 0xFFFF,
                node.nlink,
                node.size,
                0,
                i_u,
                node.ino,
                e.uid,
                e.gid,
                0,
            )
        )
        body = node.meta_bytes(blkszbits)
        meta.write(body)
        meta.write(b"\0" * (-(_INODE_COMPACT.size + len(body)) % _INODE_COMPACT.size))
    meta_payload = meta.getvalue()
    meta_payload += b"\0" * (meta_blocks * blksz - len(meta_payload))

    data_payload = data.getvalue()
    total_blocks = data_blkaddr + len(data_payload) // blksz
    if total_size is not None:
        if total_size % blksz:
            raise ErofsError(f"total_size {total_size} not block-aligned")
        if total_size // blksz < total_blocks:
            raise ErofsError(
                f"total_size {total_size} smaller than the metadata+data area"
            )
        total_blocks = total_size // blksz

    feature_incompat = 0
    extra_devices = 0
    devt_slotoff = 0
    if devices:
        extra_devices = len(devices)
        devt_slotoff = _DEVT_SLOTOFF
        feature_incompat |= _FEATURE_INCOMPAT_DEVICE_TABLE
    if chunk_map:
        feature_incompat |= _FEATURE_INCOMPAT_CHUNKED_FILE

    sb = _SB.pack(
        EROFS_MAGIC,
        0,  # checksum (feature_compat bit unset -> not verified)
        0,  # feature_compat
        blkszbits,
        0,  # sb_extslots
        root_nid,
        len(real_nodes),  # inos
        0,  # build_time
        0,  # build_time_nsec
        total_blocks,
        meta_blkaddr,
        0,  # xattr_blkaddr
        b"\0" * 16,  # uuid
        volume_name[:16].ljust(16, b"\0"),
        feature_incompat,
        0,  # u1 (compression info)
        extra_devices,
        devt_slotoff,
        0,  # dirblkbits
        0,  # xattr_prefix_count
        0,  # xattr_prefix_start
        0,  # packed_nid
        0,  # xattr_filter_reserved
        b"\0" * 23,
    )
    header = bytearray(meta_blkaddr * blksz)
    header[SB_OFFSET : SB_OFFSET + len(sb)] = sb
    for i, (tag, size_bytes) in enumerate(devices):
        slot_off = (_DEVT_SLOTOFF + i) * _DEVT_SLOT_SIZE
        header[slot_off : slot_off + _DEVT_SLOT_SIZE] = _DEVICE_SLOT.pack(
            tag[:64].ljust(64, b"\0"),
            -(-size_bytes // blksz),
            0,  # mapped_blkaddr: unused with explicit chunk device ids
            b"\0" * 56,
        )

    return bytes(header) + meta_payload + data_payload


def write_erofs_disk(bootstrap, tar_path_of, out) -> int:
    """Self-contained block image: EROFS metadata + the referenced tar
    blobs appended, chunks addressing the PRIMARY device — one image,
    mountable alone (the reference's ``nydus-image export --block`` whole
    -image shape, tarfs.go:466-571; Kata direct-block volumes consume it).

    ``tar_path_of(blob_id)`` locates each referenced layer tar on disk;
    ``out`` is a seekable binary stream. Returns the data size written
    (the dm-verity tree, if any, is appended by the caller after this).
    """
    import shutil

    if not bootstrap.blobs:
        raise ErofsError("bootstrap references no blobs")

    from nydus_snapshotter_tpu_torch.models import fstree

    entries: list[FileEntry] = []
    file_chunks: dict[str, list] = {}
    for inode in bootstrap.inodes:
        entries.append(fstree.inode_to_entry(inode, b""))
        if statmod.S_ISREG(inode.mode) and not inode.hardlink_target and inode.chunk_count:
            recs = bootstrap.chunks[
                inode.chunk_index : inode.chunk_index + inode.chunk_count
            ]
            for rec in recs:
                if rec.uncompressed_offset != rec.compressed_offset:
                    raise ErofsError(
                        f"{inode.path}: chunk not identity-mapped; only tarfs "
                        "bootstraps (the tar is the uncompressed blob) can "
                        "export to a block disk"
                    )
            file_chunks[inode.path] = recs

    def chunk_map_with(blob_base: list[int]) -> dict[str, ChunkedData]:
        cm: dict[str, ChunkedData] = {}
        for path, recs in file_chunks.items():
            size = sum(r.uncompressed_size for r in recs)
            cm[path] = ChunkedData(
                size=size,
                chunk_size=bootstrap.chunk_size,
                offsets=[blob_base[r.blob_index] + r.uncompressed_offset for r in recs],
                device_id=0,
            )
        return cm

    blob_sizes = []
    for blob in bootstrap.blobs:
        blob_sizes.append(os.path.getsize(tar_path_of(blob.blob_id)))

    # Pass 1: probe the metadata area size with zero offsets (same chunk
    # counts -> identical meta layout), then place the tars after it.
    # Probe bound: large enough for any real disk, small enough for the
    # le32 sb.blocks field (2^40 bytes / 512 = 2^31 blocks).
    probe_bound = 1 << 40
    zero_base = [0] * len(bootstrap.blobs)
    probe = build_erofs(
        entries,
        blkszbits=9,
        chunk_map=chunk_map_with(zero_base),
        total_size=probe_bound,
    )
    meta_size = len(probe)
    blob_base = []
    pos = meta_size
    for size in blob_sizes:
        pos += -pos % 512
        blob_base.append(pos)
        pos += size
    total = pos + (-pos % 512)

    img = build_erofs(
        entries,
        blkszbits=9,
        chunk_map=chunk_map_with(blob_base),
        total_size=total,
    )
    if len(img) != meta_size:
        raise ErofsError("metadata size changed between layout passes")
    start = out.tell()
    out.write(img)
    for blob, size, base in zip(bootstrap.blobs, blob_sizes, blob_base):
        out.write(b"\0" * (start + base - out.tell()))
        with open(tar_path_of(blob.blob_id), "rb") as tf:
            shutil.copyfileobj(tf, out, 1 << 20)
        if out.tell() != start + base + size:
            raise ErofsError(
                f"blob {blob.blob_id} wrote {out.tell() - start - base} bytes, "
                f"probed {size} — file changed during export"
            )
    out.write(b"\0" * (start + total - out.tell()))
    return total


def erofs_from_rafs(bootstrap, device_tag: bytes = b"") -> bytes:
    """RAFS bootstrap whose chunks index uncompressed blobs (the tarfs
    shape, tarfs/bootstrap.py) → kernel-mountable EROFS meta image with
    one device per blob, in blob-table order.

    This replaces the reference's ``nydus-image export --block`` for the
    tarfs path (tarfs.go:525-541): mount the returned image with
    ``-o device=<loop of tar 1>,device=<loop of tar 2>,…`` (the kernel
    maps the list positionally onto the device table) and file bytes are
    read straight from the layer tars. A merged multi-layer image carries
    one tar device per layer; single-layer bootstraps keep the original
    one-device shape. Chunks must be identity-mapped (uncompressed ==
    compressed offsets) and 512-aligned, which tarfs bootstraps are by
    construction. Opaque-directory xattrs (trusted.overlay.opaque) and
    whiteout char devices both carry through, so overlayfs layering over
    the mount behaves like the reference's.
    """
    from nydus_snapshotter_tpu_torch.models import fstree

    if not bootstrap.blobs:
        raise ErofsError("tarfs export needs at least one blob")
    if device_tag and len(bootstrap.blobs) > 1:
        raise ErofsError("device_tag override only applies to one-blob images")
    entries: list[FileEntry] = []
    chunk_map: dict[str, ChunkedData] = {}
    for inode in bootstrap.inodes:
        entries.append(fstree.inode_to_entry(inode, b""))
        if not statmod.S_ISREG(inode.mode) or inode.hardlink_target or not inode.chunk_count:
            continue
        recs = bootstrap.chunks[inode.chunk_index : inode.chunk_index + inode.chunk_count]
        for rec in recs:
            if rec.uncompressed_offset != rec.compressed_offset:
                raise ErofsError(
                    f"{inode.path}: chunk not identity-mapped; "
                    "only tarfs bootstraps export to EROFS"
                )
        blob_ids = {rec.blob_index for rec in recs}
        if len(blob_ids) != 1:
            raise ErofsError(
                f"{inode.path}: chunks span blobs {sorted(blob_ids)}; "
                "tarfs files live in exactly one layer tar"
            )
        chunk_map[inode.path] = ChunkedData(
            size=inode.size,
            chunk_size=bootstrap.chunk_size,
            offsets=[rec.uncompressed_offset for rec in recs],
            device_id=recs[0].blob_index + 1,
        )
    return build_erofs(
        entries,
        blkszbits=9,
        chunk_map=chunk_map,
        devices=[
            (
                device_tag if (i == 0 and device_tag) else b.blob_id.encode(),
                b.compressed_size,
            )
            for i, b in enumerate(bootstrap.blobs)
        ],
    )
