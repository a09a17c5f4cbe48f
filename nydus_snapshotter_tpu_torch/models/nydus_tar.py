"""Nydus "tar-like" blob framing.

A nydus blob is a tar-like stream where every 512-byte tar header *follows*
its data, with **no padding** between data and header: ``data | tar_header |
data | tar_header | [TOC]`` (reference pkg/converter/convert_unix.go:314-317).
Readers locate sections by walking headers backwards from the end — each
entry's data sits exactly ``hdr.size`` bytes before its header
(``seekFileByTarHeader``, convert_unix.go:162-218, ``cur - hdr.Size - 512``)
— or via the trailing TOC (``seekFileByTOC``, :220-284).

Headers are deterministic USTAR: zero mtime/uid/gid, fixed mode, no user
names — two packs of the same content are byte-identical.
"""

from __future__ import annotations

import io
import tarfile
from typing import BinaryIO, Iterator, Optional

from nydus_snapshotter_tpu_torch.models.toc import (
    ENTRY_BLOB_TOC,
    TOC_ENTRY_SIZE,
    TOCEntry,
    unpack_toc,
)

TAR_BLOCK = 512


class TarFramingError(ValueError):
    pass


def make_header(name: str, size: int) -> bytes:
    info = tarfile.TarInfo(name=name)
    info.size = size
    info.mode = 0o444
    info.mtime = 0
    info.uid = 0
    info.gid = 0
    info.uname = ""
    info.gname = ""
    # USTAR caps size at 8 GiB - 1; larger sections use GNU base-256 size
    # encoding, which tar header parsers (incl. the reference's archive/tar)
    # accept.
    fmt = tarfile.USTAR_FORMAT if size < 8 * 1024**3 else tarfile.GNU_FORMAT
    buf = info.tobuf(format=fmt)
    if len(buf) != TAR_BLOCK:
        raise TarFramingError(f"entry {name!r} does not fit a single tar header block")
    return buf


def parse_header(buf: bytes) -> Optional[tarfile.TarInfo]:
    """Parse one 512-byte tar header; None if it isn't a valid header."""
    if len(buf) != TAR_BLOCK or buf.count(0) == TAR_BLOCK:
        return None
    try:
        return tarfile.TarInfo.frombuf(buf, encoding="utf-8", errors="surrogateescape")
    except tarfile.TarError:
        return None


def append_entry(out: BinaryIO, name: str, data: bytes) -> tuple[int, int]:
    """Append ``data | header`` (unpadded) to the stream; returns (data_offset, size)."""
    offset = out.tell()
    out.write(data)
    out.write(make_header(name, len(data)))
    return offset, len(data)


def iter_entries_backward(blob: BinaryIO, blob_size: int) -> Iterator[tuple[tarfile.TarInfo, int]]:
    """Yield (tarinfo, data_offset) for each entry, last entry first.

    Every 512-byte block reached by the walk must parse as a header — in a
    well-formed blob the walk lands exactly on offset 0. A block that fails
    to parse is corruption and raises, matching the reference's error
    propagation (convert_unix.go:181-185).
    """
    cursor = blob_size
    while cursor >= TAR_BLOCK:
        blob.seek(cursor - TAR_BLOCK)
        raw = blob.read(TAR_BLOCK)
        info = parse_header(raw)
        if info is None:
            raise TarFramingError(f"block ending at {cursor} is not a tar header")
        data_offset = cursor - TAR_BLOCK - info.size
        if data_offset < 0:
            raise TarFramingError(f"entry {info.name!r} overflows blob start")
        yield info, data_offset
        cursor = data_offset
    if cursor != 0:
        raise TarFramingError(f"{cursor} residual bytes before first entry")


def seek_file_by_tar_header(blob: BinaryIO, blob_size: int, name: str) -> Optional[tuple[int, int]]:
    """Find a section by scanning trailing tar headers; (offset, size) or None."""
    for info, data_offset in iter_entries_backward(blob, blob_size):
        if info.name == name:
            return data_offset, info.size
    return None


def read_toc(blob: BinaryIO, blob_size: int) -> Optional[list[TOCEntry]]:
    """Read the trailing TOC section if the blob carries one."""
    loc = seek_file_by_tar_header(blob, blob_size, ENTRY_BLOB_TOC)
    if loc is None:
        return None
    offset, size = loc
    if size % TOC_ENTRY_SIZE != 0:
        raise TarFramingError(f"TOC size {size} not a multiple of {TOC_ENTRY_SIZE}")
    blob.seek(offset)
    return unpack_toc(blob.read(size))


def seek_file_by_toc(blob: BinaryIO, blob_size: int, name: str) -> Optional[tuple[int, int]]:
    """Find a section via the TOC (TOC names are 16-byte-truncated)."""
    toc = read_toc(blob, blob_size)
    if toc is None:
        return None
    for entry in toc:
        if entry.name == name[:16]:
            return entry.compressed_offset, entry.compressed_size
    return None


def pack_entries(entries: list[tuple[str, bytes]]) -> bytes:
    """Convenience: frame a list of (name, data) sections into one blob."""
    out = io.BytesIO()
    for name, data in entries:
        append_entry(out, name, data)
    return out.getvalue()
