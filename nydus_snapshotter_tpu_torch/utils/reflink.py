"""Reflink-aware file copy (reference KarpelesLab/reflink's Auto, used by
stargz_adaptor.go:110,122).

FICLONE clones extents on filesystems that support it (btrfs/xfs);
everything else falls back to a regular copy with metadata preserved.
"""

from __future__ import annotations

import fcntl
import os
import shutil

FICLONE = 0x40049409


def reflink(src: str, dst: str) -> None:
    """Clone src -> dst via FICLONE; raises OSError when unsupported."""
    with open(src, "rb") as fsrc, open(dst, "wb") as fdst:
        fcntl.ioctl(fdst.fileno(), FICLONE, fsrc.fileno())


def auto(src: str, dst: str) -> None:
    """reflink.Auto: try FICLONE, fall back to copy2."""
    try:
        reflink(src, dst)
        shutil.copystat(src, dst)
    except OSError:
        if os.path.exists(dst):
            os.unlink(dst)
        shutil.copy2(src, dst)
