"""Minimal read-only bbolt (boltdb) file reader.

The reference snapshotter persists daemon/instance state in a bbolt
database (the reference's ``pkg/store/database.go``: bucket hierarchy
v1 → daemons/instances, JSON values). This framework's store is sqlite
(store/database.py), so migrating a live deployment off the reference
needs to READ its old ``nydus.db`` — that, plus consuming the reference's
committed binary fixtures (``pkg/store/testdata/*.db``,
``pkg/stargz/testdata/db/nydus.db``), is exactly what this module covers.
Read-only on purpose: nothing here ever writes the bolt format.

Format (bbolt on-disk):
  page header (16 B): id u64 | flags u16 | count u16 | overflow u32
  flags: 0x01 branch, 0x02 leaf, 0x04 meta, 0x10 freelist
  meta payload: magic u32 (0xED0CDAED) | version u32 (2) | pageSize u32 |
    flags u32 | root bucket {root pgid u64, sequence u64} | freelist u64 |
    pgid u64 | txid u64 | checksum u64 (FNV-1a over the first 64 B)
  leaf element (16 B): flags u32 | pos u32 | ksize u32 | vsize u32
    (pos is relative to the element's own offset)
  branch element (16 B): pos u32 | ksize u32 | pgid u64
  bucket value: {root pgid u64, sequence u64}; root == 0 ⇒ the bucket is
    inline and the page follows those 16 bytes.
"""

from __future__ import annotations

import struct
from typing import Iterator, Optional

MAGIC = 0xED0CDAED
VERSION = 2

_PAGE_HDR = struct.Struct("<QHHI")
_META = struct.Struct("<IIII QQ Q Q Q Q")
_LEAF_ELEM = struct.Struct("<IIII")
_BRANCH_ELEM = struct.Struct("<IIQ")

FLAG_BRANCH = 0x01
FLAG_LEAF = 0x02
FLAG_META = 0x04
LEAF_FLAG_BUCKET = 0x01


class BoltError(ValueError):
    pass


def _fnv1a(data: bytes) -> int:
    h = 0xCBF29CE484222325
    for b in data:
        h ^= b
        h = (h * 0x100000001B3) & 0xFFFFFFFFFFFFFFFF
    return h


class Bucket:
    """A bucket positioned at a root page (or an inline page buffer)."""

    def __init__(self, db: "BoltDB", root: int, inline: Optional[bytes] = None):
        self._db = db
        self._root = root
        self._inline = inline

    def _walk(
        self,
        page: Optional[bytes] = None,
        depth: int = 0,
        budget: Optional[list[int]] = None,
    ) -> Iterator[tuple[int, bytes, bytes]]:
        """Yield (elem_flags, key, value) across the bucket's B+tree.

        Defensive against corrupt/crafted files (this reader ingests
        untrusted legacy databases): element tables must fit the page,
        branch depth is capped, and total pages visited per walk is
        bounded by the file's page count — a legitimate tree visits each
        page at most once, so a cycle (even a wide one whose path count
        would explode combinatorially under a depth cap alone) raises
        instead of hanging.
        """
        if depth > 64:  # bolt trees are a few levels; a cycle is corruption
            raise BoltError("branch chain exceeds max depth (page cycle?)")
        if budget is None:
            budget = [len(self._db._buf) // max(1, self._db.page_size) + 2]
        budget[0] -= 1
        if budget[0] < 0:
            raise BoltError("walk visited more pages than the file holds (cycle?)")
        if page is None:
            page = self._inline if self._inline is not None else self._db._page(self._root)
        if len(page) < 16:
            raise BoltError("page shorter than its header")
        pid, flags, count, overflow = _PAGE_HDR.unpack_from(page, 0)
        if flags & FLAG_LEAF:
            if 16 + count * _LEAF_ELEM.size > len(page):
                raise BoltError(f"leaf page {pid}: element table beyond page")
            for i in range(count):
                off = 16 + i * _LEAF_ELEM.size
                eflags, pos, ksize, vsize = _LEAF_ELEM.unpack_from(page, off)
                k0 = off + pos
                if k0 + ksize + vsize > len(page):
                    raise BoltError(f"leaf page {pid}: element data beyond page")
                yield eflags, bytes(page[k0 : k0 + ksize]), bytes(
                    page[k0 + ksize : k0 + ksize + vsize]
                )
        elif flags & FLAG_BRANCH:
            if 16 + count * _BRANCH_ELEM.size > len(page):
                raise BoltError(f"branch page {pid}: element table beyond page")
            for i in range(count):
                off = 16 + i * _BRANCH_ELEM.size
                _pos, _ksize, child = _BRANCH_ELEM.unpack_from(page, off)
                yield from self._walk(self._db._page(child), depth + 1, budget)
        else:
            raise BoltError(f"page {pid} has unexpected flags {flags:#x}")

    def items(self) -> Iterator[tuple[bytes, bytes]]:
        """(key, value) pairs for plain entries (nested buckets excluded)."""
        for eflags, k, v in self._walk():
            if not eflags & LEAF_FLAG_BUCKET:
                yield k, v

    def buckets(self) -> Iterator[tuple[bytes, "Bucket"]]:
        for eflags, k, v in self._walk():
            if eflags & LEAF_FLAG_BUCKET:
                yield k, self._db._open_bucket_value(v)

    def bucket(self, name: bytes) -> Optional["Bucket"]:
        for k, b in self.buckets():
            if k == name:
                return b
        return None


class BoltDB:
    """Read-only view over a bbolt file (fully loaded into memory —
    reference state databases are tens of KiB)."""

    def __init__(self, path: str):
        with open(path, "rb") as f:
            self._buf = f.read()
        if len(self._buf) < 2 * 4096:
            raise BoltError("file too small for a bolt database")
        # Meta 0 sits at offset 0; meta 1 sits at offset pageSize, which
        # bolt takes from os.Getpagesize() at creation (4 KiB on x86, but
        # 16/64 KiB on some arm64/ppc64le hosts) — so meta 0's declared
        # page size locates meta 1, with a scan over common sizes as the
        # fallback when meta 0 itself is torn.
        metas = []
        m0 = self._meta_at(0)
        if m0 is not None:
            metas.append(m0)
            m1 = self._meta_at(m0["page_size"])
            if m1 is not None:
                metas.append(m1)
        else:
            for ps in (4096, 8192, 16384, 32768, 65536):
                m1 = self._meta_at(ps)
                if m1 is not None:
                    metas.append(m1)
                    break
        if not metas:
            raise BoltError("no valid bolt meta page (bad magic/version/checksum)")
        # bolt keeps two meta pages and uses the valid one with max txid
        meta = max(metas, key=lambda m: m["txid"])
        self.page_size = meta["page_size"]
        self._root = meta["root"]

    def _meta_at(self, base: int):
        hdr = self._buf[base : base + 16]
        if len(hdr) < 16:
            return None
        _pid, flags, _count, _ovf = _PAGE_HDR.unpack_from(hdr, 0)
        if not flags & FLAG_META:
            return None
        body = self._buf[base + 16 : base + 16 + _META.size]
        if len(body) < _META.size:
            return None
        (magic, version, page_size, _flags, root, _seq, _freelist, _pgid,
         txid, checksum) = _META.unpack_from(body, 0)
        if magic != MAGIC or version != VERSION:
            return None
        if checksum and checksum != _fnv1a(body[: _META.size - 8]):
            return None
        return {"page_size": page_size, "root": root, "txid": txid}

    def _page(self, pgid: int) -> bytes:
        base = pgid * self.page_size
        if base + 16 > len(self._buf):
            raise BoltError(f"page {pgid} beyond end of file")
        _pid, _flags, _count, overflow = _PAGE_HDR.unpack_from(self._buf, base)
        end = base + (1 + overflow) * self.page_size
        return self._buf[base:end]

    def _open_bucket_value(self, value: bytes) -> Bucket:
        if len(value) < 16:
            raise BoltError("bucket value shorter than bucket header")
        root, _seq = struct.unpack_from("<QQ", value, 0)
        if root == 0:  # inline bucket: page follows the header
            return Bucket(self, 0, inline=value[16:])
        return Bucket(self, root)

    def root(self) -> Bucket:
        return Bucket(self, self._root)

    def bucket(self, *names: bytes) -> Optional[Bucket]:
        b: Optional[Bucket] = self.root()
        for name in names:
            if b is None:
                return None
            b = b.bucket(name)
        return b
