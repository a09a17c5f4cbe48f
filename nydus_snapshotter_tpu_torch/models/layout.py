"""RAFS on-disk magic detection.

Parity surface of reference pkg/layout/layout.go:19-76: the same magic numbers
and offsets, so bootstraps written by this framework are recognized by tools
expecting the reference layout (and vice versa for version sniffing).
"""

from __future__ import annotations

import struct

from nydus_snapshotter_tpu_torch import constants

RAFS_V5 = "v5"
RAFS_V6 = "v6"

RAFS_V5_SUPER_VERSION = 0x500
RAFS_V5_SUPER_MAGIC = 0x5241_4653  # "RAFS"
RAFS_V6_SUPER_MAGIC = 0xE0F5_E1E2  # EROFS superblock magic
RAFS_V6_SUPER_BLOCK_SIZE = 1024 + 128 + 256
RAFS_V6_SUPER_BLOCK_OFFSET = 1024
RAFS_V6_CHUNK_INFO_OFFSET = 1024 + 128 + 24

# RafsV6 layout: 1k + SuperBlock(128) + SuperBlockExtended(256)
# RafsV5 layout: 8K superblock — read MAX_SUPER_BLOCK_SIZE to cover both.
MAX_SUPER_BLOCK_SIZE = 8 * 1024

BOOTSTRAP_FILE = constants.BOOTSTRAP_FILE_NAME_IN_LAYER  # "image/image.boot"
LEGACY_BOOTSTRAP_FILE = "image.boot"
DUMMY_MOUNTPOINT = "/dummy"


class LayoutError(ValueError):
    pass


def detect_fs_version(header: bytes) -> str:
    """Sniff RAFS version from a bootstrap header.

    Reference behavior (layout.go:60-76): v5 if the little-endian magic/version
    pair sits at offset 0; v6 if the EROFS magic sits at offset 1024.
    """
    if len(header) < 8:
        raise LayoutError("header buffer to detect_fs_version is too small")
    magic, fs_version = struct.unpack_from("<II", header, 0)
    if magic == RAFS_V5_SUPER_MAGIC and fs_version == RAFS_V5_SUPER_VERSION:
        return RAFS_V5
    if len(header) >= RAFS_V6_SUPER_BLOCK_OFFSET + 4:
        (v6_magic,) = struct.unpack_from("<I", header, RAFS_V6_SUPER_BLOCK_OFFSET)
        if v6_magic == RAFS_V6_SUPER_MAGIC:
            return RAFS_V6
    raise LayoutError("unknown file system header")


def validate_bootstrap_header(buf: bytes) -> str:
    """Detect + sanity-check a real nydus bootstrap's superblock.

    Works on actual reference-produced artifacts (the binary fixtures at
    the reference's pkg/filesystem/testdata): v5 validates the declared
    superblock size against the file; v6 validates the EROFS block-size
    exponent. Raises LayoutError on anything malformed — the same
    reject-bad-bootstraps posture as the reference's version sniffing +
    mount validation (layout.go:60-76).
    """
    version = detect_fs_version(buf)
    if version == RAFS_V5:
        if len(buf) < 12:
            raise LayoutError("v5 bootstrap truncated before superblock size")
        _magic, _ver, sb_size = struct.unpack_from("<III", buf, 0)
        if not 16 <= sb_size <= min(len(buf), MAX_SUPER_BLOCK_SIZE):
            raise LayoutError(f"v5 superblock size {sb_size} out of range")
    else:
        if len(buf) < RAFS_V6_SUPER_BLOCK_OFFSET + 16:
            raise LayoutError("v6 bootstrap truncated before superblock tail")
        blkszbits = buf[RAFS_V6_SUPER_BLOCK_OFFSET + 12]
        if not 9 <= blkszbits <= 12:
            raise LayoutError(f"v6 blkszbits {blkszbits} outside 9..12")
    return version
