"""OCI layer tar ↔ file tree, with overlay (whiteout) semantics.

The reference delegates tar parsing to the Rust builder; here the host owns
it: an OCI layer tar becomes a list of ``FileEntry`` (metadata + bytes), the
overlay merge applies OCI whiteouts the way RAFS does (``.wh.foo`` becomes an
overlayfs char-0:0 whiteout node, ``.wh..wh..opq`` sets the opaque xattr on
its directory — so the mounted RAFS works directly as an overlayfs lowerdir),
and a tree serializes back to a deterministic tar for Unpack
(reference Unpack surface: pkg/converter/convert_unix.go:669-733).
"""

from __future__ import annotations

import io
import os
import stat
import tarfile
from dataclasses import dataclass, field
from typing import BinaryIO, Iterable, Optional

from nydus_snapshotter_tpu_torch.models.bootstrap import (
    INODE_FLAG_HARDLINK,
    INODE_FLAG_OPAQUE,
    INODE_FLAG_SYMLINK,
    INODE_FLAG_WHITEOUT,
    Inode,
)

WHITEOUT_PREFIX = ".wh."
OPAQUE_MARKER = ".wh..wh..opq"
OPAQUE_XATTR = "trusted.overlay.opaque"


class FsTreeError(ValueError):
    pass


@dataclass
class FileEntry:
    """One node of a layer's file tree."""

    path: str  # absolute, "/" separated, no trailing slash (except root)
    mode: int = 0o644  # full st_mode including file type bits
    uid: int = 0
    gid: int = 0
    rdev: int = 0
    mtime: int = 0
    symlink_target: str = ""
    hardlink_target: str = ""
    xattrs: dict[str, bytes] = field(default_factory=dict)
    data: bytes = b""
    flags: int = 0

    @property
    def is_dir(self) -> bool:
        return stat.S_ISDIR(self.mode)

    @property
    def is_regular(self) -> bool:
        return stat.S_ISREG(self.mode) and not self.hardlink_target

    @property
    def is_whiteout(self) -> bool:
        return bool(self.flags & INODE_FLAG_WHITEOUT)

    def size(self) -> int:
        return len(self.data)


def _norm(name: str) -> str:
    name = "/" + name.strip("/")
    return name if name != "//" else "/"


# Public alias: the streaming Pack normalizes paths the same way.
norm_path = _norm


def classify_special(path: str) -> Optional[tuple[str, str]]:
    """OCI special-marker classification for one normalized member path.

    Returns ("opaque", dir_path) for ``.wh..wh..opq`` markers,
    ("whiteout", target_path) for ``.wh.<name>`` markers, None for regular
    members — the single definition of whiteout naming shared by
    ``tree_from_tar`` and the streaming Pack.
    """
    base = path.rsplit("/", 1)[1] if path != "/" else "/"
    if base == OPAQUE_MARKER:
        return ("opaque", path.rsplit("/", 1)[0] or "/")
    if base.startswith(WHITEOUT_PREFIX):
        target = _norm(path.rsplit("/", 1)[0] + "/" + base[len(WHITEOUT_PREFIX):])
        return ("whiteout", target)
    return None


def whiteout_entry(target: str) -> FileEntry:
    """The RAFS/overlayfs form of a whiteout: a char-0:0 node."""
    return FileEntry(path=target, mode=stat.S_IFCHR, rdev=0, flags=INODE_FLAG_WHITEOUT)


def missing_parents(paths: Iterable[str]) -> list[str]:
    """Directories (incl. root) a path set references but does not contain."""
    have = set(paths)
    missing: set[str] = set()
    for p in have:
        q = p
        while q != "/":
            q = q.rsplit("/", 1)[0] or "/"
            if q not in have:
                missing.add(q)
    if "/" not in have:
        missing.add("/")
    return sorted(missing)


def tree_from_tar(fileobj: BinaryIO | bytes) -> list[FileEntry]:
    """Parse an (uncompressed) OCI layer tar into file entries.

    Whiteout markers are converted to RAFS/overlayfs form here so the rest
    of the stack never sees ``.wh.`` names: ``.wh.<name>`` → char-dev 0:0
    entry with the whiteout flag; ``.wh..wh..opq`` → opaque flag + xattr on
    the containing directory entry (synthesized if the tar lacks one).
    """
    if isinstance(fileobj, (bytes, bytearray)):
        fileobj = io.BytesIO(fileobj)
    entries: dict[str, FileEntry] = {}
    opaque_dirs: list[str] = []
    with tarfile.open(fileobj=fileobj, mode="r:") as tf:
        for info in tf:
            path = _norm(info.name)
            special = classify_special(path)
            if special is not None:
                kind, target = special
                if kind == "opaque":
                    opaque_dirs.append(target)
                else:
                    entries[target] = whiteout_entry(target)
                continue
            entry = entry_from_tarinfo(tf, info, path)
            entries[path] = entry
    for d in opaque_dirs:
        if d not in entries:
            entries[d] = FileEntry(path=d, mode=stat.S_IFDIR | 0o755)
        entries[d].flags |= INODE_FLAG_OPAQUE
        entries[d].xattrs[OPAQUE_XATTR] = b"y"
    return sorted(entries.values(), key=lambda e: e.path)


def entry_from_tarinfo(
    tf: tarfile.TarFile, info: tarfile.TarInfo, path: str, with_data: bool = True
) -> FileEntry:
    # tarfile decodes pax values as utf-8 with surrogateescape; encoding back
    # the same way round-trips arbitrary binary xattrs (e.g. the
    # security.capability on ping/sudo) losslessly.
    xattrs = {
        k[len("SCHILY.xattr.") :]: (
            v.encode("utf-8", "surrogateescape") if isinstance(v, str) else v
        )
        for k, v in (info.pax_headers or {}).items()
        if k.startswith("SCHILY.xattr.")
    }
    try:
        # RAFS stores mtime as u64; a pre-epoch (negative, GNU base-256)
        # tar mtime clamps to the epoch rather than crashing serialization.
        mtime = max(0, int(info.mtime))
        if mtime > 0xFFFF_FFFF_FFFF_FFFF:
            raise ValueError("mtime exceeds u64")
    except (ValueError, OverflowError) as exc:
        # pax can smuggle nan/inf/1e300 through float(); surface the
        # documented conversion error type instead of a bare
        # ValueError/struct.error downstream.
        from nydus_snapshotter_tpu_torch.converter.types import ConvertError

        raise ConvertError(
            f"tar member {path!r} has invalid mtime {info.mtime!r}"
        ) from exc
    e = FileEntry(
        path=path,
        uid=info.uid,
        gid=info.gid,
        mtime=mtime,
        xattrs=xattrs,
    )
    perm = info.mode & 0o7777
    if info.isdir():
        e.mode = stat.S_IFDIR | perm
    elif info.issym():
        e.mode = stat.S_IFLNK | perm
        e.symlink_target = info.linkname
        e.flags |= INODE_FLAG_SYMLINK
    elif info.islnk():
        e.mode = stat.S_IFREG | perm
        e.hardlink_target = _norm(info.linkname)
        e.flags |= INODE_FLAG_HARDLINK
    elif info.ischr():
        e.mode = stat.S_IFCHR | perm
        e.rdev = os.makedev(info.devmajor, info.devminor)
    elif info.isblk():
        e.mode = stat.S_IFBLK | perm
        e.rdev = os.makedev(info.devmajor, info.devminor)
    elif info.isfifo():
        e.mode = stat.S_IFIFO | perm
    elif info.isreg():
        e.mode = stat.S_IFREG | perm
        if with_data:
            f = tf.extractfile(info)
            e.data = f.read() if f is not None else b""
    else:
        raise FsTreeError(f"unsupported tar entry type {info.type!r} at {path}")
    return e


def ensure_parents(entries: list[FileEntry]) -> list[FileEntry]:
    """Synthesize the root and any parent directories a tar omitted."""
    by_path = {e.path: e for e in entries}
    for p in missing_parents(by_path):
        by_path[p] = FileEntry(path=p, mode=stat.S_IFDIR | 0o755)
    return sorted(by_path.values(), key=lambda e: e.path)


def apply_overlay(lower: Iterable[FileEntry], upper: Iterable[FileEntry]) -> list[FileEntry]:
    """Overlay-merge two layers (upper wins), applying whiteouts.

    Mirrors the merge semantics the reference gets from ``nydus-image merge``
    (pkg/converter/convert_unix.go:560-666): upper entries replace lower
    ones; a whiteout deletes the lower path (and subtree); an opaque
    directory hides the whole lower subtree.
    """
    merged: dict[str, FileEntry] = {e.path: e for e in lower}
    for e in upper:
        if e.is_whiteout:
            merged.pop(e.path, None)
            _drop_subtree(merged, e.path)
            continue
        if e.flags & INODE_FLAG_OPAQUE:
            _drop_subtree(merged, e.path)
        old = merged.get(e.path)
        if old is not None and old.is_dir and not e.is_dir:
            _drop_subtree(merged, e.path)
        merged[e.path] = e
    return sorted(merged.values(), key=lambda x: x.path)


def _drop_subtree(merged: dict[str, FileEntry], path: str) -> None:
    prefix = path.rstrip("/") + "/"
    for p in [p for p in merged if p.startswith(prefix)]:
        del merged[p]


def tar_from_tree(entries: list[FileEntry]) -> bytes:
    """Serialize a tree back to a deterministic tar (Unpack surface).

    Whiteout nodes are re-encoded as ``.wh.`` markers so a round trip
    reproduces OCI layer semantics.
    """
    out = io.BytesIO()
    with tarfile.open(fileobj=out, mode="w:", format=tarfile.PAX_FORMAT) as tf:
        for e in sorted(entries, key=lambda x: x.path):
            if e.path == "/":
                continue
            name = e.path.lstrip("/")
            if e.is_whiteout:
                parent, _, base = e.path.rpartition("/")
                info = tarfile.TarInfo((parent + "/" + WHITEOUT_PREFIX + base).lstrip("/"))
                info.size = 0
                tf.addfile(info)
                continue
            info = tarfile.TarInfo(name)
            info.mode = e.mode & 0o7777
            info.uid, info.gid, info.mtime = e.uid, e.gid, e.mtime
            if e.xattrs:
                info.pax_headers.update(
                    {
                        f"SCHILY.xattr.{k}": v.decode("utf-8", "surrogateescape")
                        for k, v in e.xattrs.items()
                    }
                )
            data = None
            if e.hardlink_target:
                info.type = tarfile.LNKTYPE
                info.linkname = e.hardlink_target.lstrip("/")
            elif stat.S_ISDIR(e.mode):
                info.type = tarfile.DIRTYPE
            elif stat.S_ISLNK(e.mode):
                info.type = tarfile.SYMTYPE
                info.linkname = e.symlink_target
            elif stat.S_ISCHR(e.mode):
                info.type = tarfile.CHRTYPE
                info.devmajor, info.devminor = os.major(e.rdev), os.minor(e.rdev)
            elif stat.S_ISBLK(e.mode):
                info.type = tarfile.BLKTYPE
                info.devmajor, info.devminor = os.major(e.rdev), os.minor(e.rdev)
            elif stat.S_ISFIFO(e.mode):
                info.type = tarfile.FIFOTYPE
            else:
                info.type = tarfile.REGTYPE
                info.size = len(e.data)
                data = io.BytesIO(e.data)
            tf.addfile(info, data)
    return out.getvalue()


# -- bootstrap bridging ------------------------------------------------------


def entry_to_inode(e: FileEntry) -> Inode:
    return Inode(
        path=e.path,
        mode=e.mode,
        uid=e.uid,
        gid=e.gid,
        rdev=e.rdev,
        mtime=e.mtime,
        size=len(e.data),
        flags=e.flags,
        symlink_target=e.symlink_target,
        hardlink_target=e.hardlink_target,
        xattrs=dict(e.xattrs),
    )


def inode_to_entry(inode: Inode, data: bytes = b"") -> FileEntry:
    return FileEntry(
        path=inode.path,
        mode=inode.mode,
        uid=inode.uid,
        gid=inode.gid,
        rdev=inode.rdev,
        mtime=inode.mtime,
        symlink_target=inode.symlink_target,
        hardlink_target=inode.hardlink_target,
        xattrs=dict(inode.xattrs),
        data=data,
        flags=inode.flags,
    )
