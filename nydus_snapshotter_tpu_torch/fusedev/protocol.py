"""Raw /dev/fuse wire protocol: the subset a read-only RAFS filesystem needs.

The reference's data plane is the external Rust nydusd's FUSE server (driven
from pkg/filesystem/fs.go:268-431); this framework serves the kernel
directly. Struct layouts follow include/uapi/linux/fuse.h; the environment
ships no FUSE userspace library, so the framing lives here in ~200 lines of
struct definitions. Only the read path is implemented — RAFS is immutable,
every mutating opcode is answered with EROFS.
"""

from __future__ import annotations

import struct

FUSE_KERNEL_VERSION = 7
FUSE_KERNEL_MINOR = 36  # highest minor whose layouts are used here

# Opcodes (uapi/linux/fuse.h enum fuse_opcode).
LOOKUP = 1
FORGET = 2
GETATTR = 3
SETATTR = 4
READLINK = 5
MKNOD = 8
MKDIR = 9
UNLINK = 10
RMDIR = 11
RENAME = 12
LINK = 13
OPEN = 14
READ = 15
WRITE = 16
STATFS = 17
RELEASE = 18
FSYNC = 20
SETXATTR = 21
GETXATTR = 22
LISTXATTR = 23
REMOVEXATTR = 24
FLUSH = 25
INIT = 26
OPENDIR = 27
READDIR = 28
RELEASEDIR = 29
FSYNCDIR = 30
ACCESS = 34
CREATE = 35
INTERRUPT = 36
DESTROY = 38
BATCH_FORGET = 42
READDIRPLUS = 44
LSEEK = 46

WRITE_OPCODES = frozenset(
    {SETATTR, MKNOD, MKDIR, UNLINK, RMDIR, RENAME, LINK, WRITE, SETXATTR, REMOVEXATTR, CREATE}
)

IN_HEADER = struct.Struct("<IIQQIIII")  # len opcode unique nodeid uid gid pid pad
OUT_HEADER = struct.Struct("<IiQ")  # len error unique

INIT_IN_PREFIX = struct.Struct("<IIII")  # major minor max_readahead flags
# major minor max_readahead flags | max_background congestion | max_write
# time_gran | max_pages map_alignment | flags2 unused[7]
INIT_OUT = struct.Struct("<IIIIHHIIHHI7I")

# ino size blocks atime mtime ctime atimensec mtimensec ctimensec mode nlink
# uid gid rdev blksize flags
ATTR = struct.Struct("<QQQQQQIIIIIIIIII")
ENTRY_OUT_PREFIX = struct.Struct("<QQQQII")  # nodeid generation entry/attr valid (+nsec)
ATTR_OUT_PREFIX = struct.Struct("<QII")  # attr_valid attr_valid_nsec dummy
OPEN_OUT = struct.Struct("<QII")  # fh open_flags padding
READ_IN = struct.Struct("<QQIIQII")  # fh offset size read_flags lock_owner flags pad
GETATTR_IN = struct.Struct("<IIQ")  # flags dummy fh
GETXATTR_IN = struct.Struct("<II")  # size padding
GETXATTR_OUT = struct.Struct("<II")  # size padding
ACCESS_IN = struct.Struct("<II")  # mask padding
DIRENT_PREFIX = struct.Struct("<QQII")  # ino off namelen type
# blocks bfree bavail files ffree (u64) | bsize namelen frsize padding (u32) | spare[6]
KSTATFS = struct.Struct("<QQQQQIIII24x")
LSEEK_IN = struct.Struct("<QQII")  # fh offset whence padding
LSEEK_OUT = struct.Struct("<Q")

MAX_WRITE = 128 * 1024
MAX_READAHEAD = 128 * 1024

ENOENT = 2
EIO = 5
EACCES = 13
EINVAL = 22
EROFS = 30
ERANGE = 34
ENOSYS = 38
ENODATA = 61
ENOTDIR = 20
EISDIR = 21


def pack_attr(
    ino: int,
    size: int,
    mode: int,
    nlink: int = 1,
    uid: int = 0,
    gid: int = 0,
    rdev: int = 0,
    mtime: int = 0,
    blksize: int = 4096,
) -> bytes:
    blocks = (size + 511) // 512
    return ATTR.pack(
        ino, size, blocks, mtime, mtime, mtime, 0, 0, 0, mode, nlink, uid, gid, rdev, blksize, 0
    )


def pack_dirent(ino: int, off: int, name: bytes, dtype: int) -> bytes:
    rec = DIRENT_PREFIX.pack(ino, off, len(name), dtype) + name
    pad = (-len(rec)) % 8
    return rec + b"\x00" * pad
