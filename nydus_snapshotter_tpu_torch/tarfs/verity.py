"""dm-verity hash-tree builder for exported block images.

Reference: ``nydus-image export --block --verity`` emits the line parsed at
pkg/tarfs/tarfs.go:547-554 — ``dm-verity options: --no-superblock
--format=1 -s "" --hash=sha256 --data-block-size=512
--hash-block-size=4096 --data-blocks N --hash-offset H <root>``. This
module computes that tree in-process: a standard dm-verity Merkle tree
(sha256, empty salt, no superblock) with the hash area appended to the
data area, levels stored top-down.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass
from typing import BinaryIO

DATA_BLOCK_SIZE = 512
HASH_BLOCK_SIZE = 4096
DIGEST_SIZE = 32
_PER_BLOCK = HASH_BLOCK_SIZE // DIGEST_SIZE  # 128 digests per hash block


@dataclass
class VerityInfo:
    data_blocks: int
    hash_offset: int  # byte offset of the hash area within the image file
    root_hash: str  # hex sha256

    def block_info_label(self) -> str:
        """`<data_blocks>,<hash_offset>,sha256:<root>` — the label format
        stored under nydus-image-block / nydus-layer-block
        (tarfs.go:555-562)."""
        return f"{self.data_blocks},{self.hash_offset},sha256:{self.root_hash}"


def parse_block_info_label(value: str) -> VerityInfo:
    data_blocks, hash_offset, root = value.split(",")
    if not root.startswith("sha256:"):
        raise ValueError(f"bad verity root in block info {value!r}")
    return VerityInfo(int(data_blocks), int(hash_offset), root[len("sha256:") :])


def _level_digests(blocks: list[bytes]) -> bytes:
    return b"".join(hashlib.sha256(b).digest() for b in blocks)


def _pack_hash_blocks(digests: bytes) -> list[bytes]:
    """Pack concatenated digests into zero-padded hash blocks."""
    blocks = []
    for off in range(0, len(digests), _PER_BLOCK * DIGEST_SIZE):
        chunk = digests[off : off + _PER_BLOCK * DIGEST_SIZE]
        blocks.append(chunk.ljust(HASH_BLOCK_SIZE, b"\x00"))
    return blocks


def build_tree(data: bytes) -> tuple[bytes, VerityInfo]:
    """(hash_area_bytes, info) for ``data``.

    ``data`` must be 512-aligned (the exporter pads). Levels are laid out
    top-down (root level first) as dm-verity expects with --no-superblock;
    hash_offset is filled in by the caller once the data-area size is known
    (the returned info carries hash_offset == len(data), i.e. the tree is
    appended immediately after the data area).
    """
    if len(data) % DATA_BLOCK_SIZE:
        raise ValueError("verity data area must be a multiple of 512 bytes")
    data_blocks = len(data) // DATA_BLOCK_SIZE

    if data_blocks == 0:
        empty_root = hashlib.sha256(b"\x00" * HASH_BLOCK_SIZE).hexdigest()
        return b"", VerityInfo(0, len(data), empty_root)

    level = _pack_hash_blocks(
        _level_digests(
            [data[i : i + DATA_BLOCK_SIZE] for i in range(0, len(data), DATA_BLOCK_SIZE)]
        )
    )
    levels: list[list[bytes]] = [level]
    while len(levels[-1]) > 1:
        levels.append(_pack_hash_blocks(_level_digests(levels[-1])))

    root_hash = hashlib.sha256(levels[-1][0]).hexdigest()
    # Store top-down: root level first, widest (level 0) last.
    tree = b"".join(b for lvl in reversed(levels) for b in lvl)
    return tree, VerityInfo(data_blocks, len(data), root_hash)


def verify(data: bytes, info: VerityInfo, tree: bytes) -> bool:
    """Recompute the tree and compare the root — the integrity check a
    dm-verity target performs block-by-block, done wholesale."""
    rebuilt, rebuilt_info = build_tree(data)
    return (
        rebuilt == tree
        and rebuilt_info.data_blocks == info.data_blocks
        and rebuilt_info.root_hash == info.root_hash
    )


def append_tree(image: BinaryIO, data_size: int) -> VerityInfo:
    """Build the tree over the first ``data_size`` bytes of ``image`` and
    append it; returns the final info with hash_offset set."""
    image.seek(0)
    data = image.read(data_size)
    tree, info = build_tree(data)
    image.seek(0, 2)
    pad = (-image.tell()) % HASH_BLOCK_SIZE
    if pad:
        image.write(b"\x00" * pad)
    info.hash_offset = image.tell()
    image.write(tree)
    return info
