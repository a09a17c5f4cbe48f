"""EROFS on-disk records shared by the real RAFS v6 reader and writer.

RAFS v6 is an EROFS image with nydus extensions (models/nydus_real.py,
models/nydus_real_write.py). The two must agree on the on-disk contract,
so they share this one set of struct definitions, a copy of those in the
reference package's ``models/erofs_image.py`` (whose kernel-mountable
image writer is not part of this package).

Format notes (Linux fs/erofs/erofs_fs.h): superblock at offset 1024,
compact 32-byte inodes, 12-byte dirents, 8-byte chunk indexes, inline
xattrs as prefix-indexed entries (POSIX ACL names as exact-match indexes).
"""

from __future__ import annotations

import io
import stat as statmod
import struct

_DEVT_SLOT_SIZE = 128

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


class ErofsError(ValueError):
    pass


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


def _file_type(mode: int) -> int:
    for pred, ft in _FT_OF_MODE:
        if pred(mode):
            return ft
    return 0
