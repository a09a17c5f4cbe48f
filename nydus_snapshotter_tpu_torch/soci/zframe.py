"""zstd frame geometry: random access into foreign zstd streams.

The zstd analog of :mod:`~nydus_snapshotter_tpu_torch.soci.zran`. Where gzip
needs bit-level inflate checkpoints, zstd's native unit of independent
decode is the FRAME: every frame starts clean (no cross-frame window),
so a frame-boundary table ``(uout, cin, usize, csize)`` is a complete,
persistable random-access index — no window bytes, no bit offsets. Three
sources, cheapest first:

- **seek table** (facebook/zstd ``contrib/seekable_format``): a trailing
  skippable frame listing every frame's compressed/decompressed size.
  Parsing it is a pure struct walk over the blob TAIL — zero
  decompression, zero extra origin bytes beyond one ranged tail read.
- **frame walk**: ``ZSTD_findFrameCompressedSize`` measures each frame
  without decoding it; one sequential pass decodes each frame once to
  learn its decompressed size when the header omits it (and
  index-on-first-pull wants the decompressed bytes anyway, for the
  bootstrap build — same single-pass discipline as ``zran.build``).
- the degenerate case: a single-frame blob yields a 1-entry table, which
  makes every cold read a decompress-from-zero — the FormatRouter's cost
  model routes those layers to rafs-convert instead.

``extract`` resumes at a frame boundary and decodes only the frames the
read overlaps: cold cost is O(frame size), not O(offset), from a
persisted table in any process. Skippable frames (metadata, seek tables,
zstd:chunked manifests) are measured in the walk but never become
entries — reads never decode them.

``available()`` gates on the system libzstd's frame surface
(utils/zstd.py); without it the soci backend's router refuses zstd
layers and they fall back to full pull + RAFS convert, never to wrong
bytes.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass
from typing import Callable, Optional

from nydus_snapshotter_tpu_torch.utils import errdefs
from nydus_snapshotter_tpu_torch.utils import zstd as _zstd

# facebook/zstd seekable format constants.
SEEK_TABLE_SKIPPABLE_MAGIC = 0x184D2A5E
SEEKABLE_MAGIC = 0x8F92EAB1
_FOOTER = struct.Struct("<IBI")  # n_frames, descriptor, seekable magic
_DESC_CHECKSUM = 0x80
_DESC_RESERVED = 0x7C  # reserved bits must be zero per the spec

# A writer bound: the seekable spec caps frame decompressed size at 1 GiB.
MAX_FRAME_USIZE = 1 << 30
DEFAULT_FRAME_USIZE = 1 << 20


class ZstdFrameError(errdefs.NydusError):
    pass


def available() -> bool:
    """Whether frame-table random access is usable on this host."""
    return _zstd.frames_available()


@dataclass
class FrameEntry:
    """One zstd frame's span: decompressed offset/size, compressed
    offset/size. Frames decode independently, so the entry IS the resume
    point — no window, no bit offset."""

    uout: int  # decompressed offset of the frame's first byte
    cin: int  # compressed offset of the frame header
    usize: int  # decompressed size of the frame
    csize: int  # on-wire size of the frame (header + blocks + checksum)


# ---------------------------------------------------------------------------
# Seek-table parse (pure struct walk, no decompression)
# ---------------------------------------------------------------------------


def seek_table_frame_size(tail: bytes) -> Optional[int]:
    """On-wire size of the trailing seek-table skippable frame, derived
    from the blob's last 9 bytes — or ``None`` when the tail carries no
    seekable footer. Callers use this to size the one ranged tail read
    that fetches the whole table."""
    if len(tail) < _FOOTER.size:
        return None
    n_frames, desc, magic = _FOOTER.unpack(tail[-_FOOTER.size:])
    if magic != SEEKABLE_MAGIC or desc & _DESC_RESERVED:
        return None
    entry_size = 12 if desc & _DESC_CHECKSUM else 8
    return 8 + n_frames * entry_size + _FOOTER.size


def parse_seek_table(table: bytes, blob_size: int) -> list[FrameEntry]:
    """Decode a complete seek-table frame (header through footer) into
    the frame-entry table. Validates the skippable magic, the declared
    content length, and that the listed compressed sizes tile the blob
    exactly up to the table itself — a stale or foreign table fails
    loudly here, never at read time."""
    if len(table) < 8 + _FOOTER.size:
        raise ZstdFrameError("seek table truncated")
    skip_magic, content_len = struct.unpack_from("<II", table, 0)
    if skip_magic != SEEK_TABLE_SKIPPABLE_MAGIC:
        raise ZstdFrameError(
            f"seek table skippable magic {skip_magic:#x} != "
            f"{SEEK_TABLE_SKIPPABLE_MAGIC:#x}"
        )
    if content_len != len(table) - 8:
        raise ZstdFrameError(
            f"seek table declares {content_len} content bytes, "
            f"frame carries {len(table) - 8}"
        )
    n_frames, desc, magic = _FOOTER.unpack(table[-_FOOTER.size:])
    if magic != SEEKABLE_MAGIC:
        raise ZstdFrameError("seekable footer magic missing")
    if desc & _DESC_RESERVED:
        raise ZstdFrameError(f"seekable descriptor reserved bits set: {desc:#x}")
    entry_size = 12 if desc & _DESC_CHECKSUM else 8
    want = 8 + n_frames * entry_size + _FOOTER.size
    if want != len(table):
        raise ZstdFrameError(
            f"seek table size {len(table)} != {want} for {n_frames} frames"
        )
    entries: list[FrameEntry] = []
    upos = cpos = 0
    pos = 8
    for _ in range(n_frames):
        csize, usize = struct.unpack_from("<II", table, pos)
        pos += entry_size  # checksum (when present) is skipped, not verified
        if csize == 0:
            raise ZstdFrameError("seek table lists a zero-byte frame")
        # Skippable frames appear in the table with usize 0; they are
        # walked over, never decoded, so they produce no entry.
        if usize:
            entries.append(FrameEntry(upos, cpos, usize, csize))
        upos += usize
        cpos += csize
    if blob_size and cpos + len(table) != blob_size:
        raise ZstdFrameError(
            f"seek table covers {cpos} compressed bytes + {len(table)} table "
            f"bytes, blob is {blob_size}"
        )
    return entries


def read_seek_table(
    read_at: Callable[[int, int], bytes], blob_size: int
) -> Optional[list[FrameEntry]]:
    """Fetch + parse the seek table with two ranged reads (9-byte footer,
    then the exact table frame). Returns ``None`` when the blob has no
    seekable footer; raises on a footer that promises a table the blob
    cannot hold."""
    if blob_size < _FOOTER.size:
        return None
    tail = read_at(blob_size - _FOOTER.size, _FOOTER.size)
    size = seek_table_frame_size(tail)
    if size is None:
        return None
    if size > blob_size:
        raise ZstdFrameError(
            f"seekable footer promises a {size}-byte table in a "
            f"{blob_size}-byte blob"
        )
    table = read_at(blob_size - size, size)
    if len(table) != size:
        raise ZstdFrameError("short read fetching seek table")
    return parse_seek_table(table, blob_size)


# ---------------------------------------------------------------------------
# Frame walk + one-pass build
# ---------------------------------------------------------------------------


def build(
    raw: bytes, entries: Optional[list[FrameEntry]] = None
) -> tuple[list[FrameEntry], bytes]:
    """One sequential pass over a whole zstd blob → ``(frame table,
    decompressed bytes)`` — the zstd mirror of ``zran.build``.

    Without ``entries`` the pass walks frame boundaries with
    ``ZSTD_findFrameCompressedSize`` and decodes each data frame once
    (headers that omit the content size take the streaming decoder).
    With ``entries`` (a parsed seek table) the boundaries are trusted as
    geometry but every decoded size is still verified against the table
    — a lying table fails the build, it cannot mis-index reads.
    """
    if not available():
        raise ZstdFrameError("system libzstd lacks the frame surface")
    out = bytearray()
    table: list[FrameEntry] = []
    if entries is not None:
        for e in entries:
            frame = raw[e.cin : e.cin + e.csize]
            if len(frame) != e.csize:
                raise ZstdFrameError(
                    f"frame at {e.cin} (+{e.csize}) past blob end {len(raw)}"
                )
            data = _decode_frame(frame, e.usize)
            if len(data) != e.usize or len(out) != e.uout:
                raise ZstdFrameError(
                    f"seek table lies: frame at {e.cin} decodes to "
                    f"{len(data)} bytes, table says {e.usize} at {e.uout}"
                )
            table.append(FrameEntry(len(out), e.cin, len(data), e.csize))
            out += data
        return table, bytes(out)

    pos = 0
    while pos < len(raw):
        csize = _zstd.find_frame_compressed_size(raw, pos)
        if csize <= 0 or pos + csize > len(raw):
            raise ZstdFrameError(f"corrupt zstd frame at byte {pos}")
        if not _zstd.is_skippable_frame(raw, pos):
            frame = raw[pos : pos + csize]
            data = _decode_frame(frame, _zstd.frame_content_size(raw, pos))
            if data:
                table.append(FrameEntry(len(out), pos, len(data), csize))
                out += data
        pos += csize
    return table, bytes(out)


def _decode_frame(frame: bytes, usize_hint: Optional[int]) -> bytes:
    """One data frame → bytes: exact one-shot decode when the header (or
    table) declares the content size, streaming decode when it doesn't."""
    try:
        if usize_hint:
            return _zstd.decompress_block(frame, max_output_size=usize_hint)
        return _zstd.stream_decompress(frame)
    except _zstd.ZstdError as e:
        raise ZstdFrameError(str(e)) from e


# ---------------------------------------------------------------------------
# Extraction (decompress-from-frame-boundary)
# ---------------------------------------------------------------------------


def extract(
    read_comp: Callable[[int, int], bytes],
    csize: int,
    entries: list[FrameEntry],
    offset: int,
    size: int,
) -> bytes:
    """Decompressed ``[offset, offset + size)`` from the frames in
    ``entries`` (the resolve geometry's covering slice, ascending).
    ``read_comp(pos, n)`` supplies compressed bytes on demand —
    extraction pulls exactly the overlapped frames' on-wire bytes, never
    the blob. Each frame decodes on its own pooled context: concurrent
    extracts are safe."""
    if size <= 0:
        return b""
    if not entries:
        raise ZstdFrameError(f"no frame covers [{offset}, +{size})")
    out = bytearray()
    end = offset + size
    for e in entries:
        if e.uout >= end:
            break
        if e.uout + e.usize <= offset:
            continue
        if e.cin + e.csize > csize:
            raise ZstdFrameError(
                f"frame at {e.cin} (+{e.csize}) past compressed end {csize}"
            )
        frame = read_comp(e.cin, e.csize)
        if len(frame) != e.csize:
            raise ZstdFrameError(
                f"short compressed read at {e.cin}: {len(frame)} of {e.csize}"
            )
        data = _decode_frame(frame, e.usize)
        if len(data) != e.usize:
            raise ZstdFrameError(
                f"frame at {e.cin} decoded to {len(data)} bytes, "
                f"table says {e.usize}"
            )
        lo = max(0, offset - e.uout)
        hi = min(e.usize, end - e.uout)
        out += data[lo:hi]
    if len(out) != size:
        raise ZstdFrameError(
            f"range [{offset}, +{size}) yielded {len(out)} bytes from "
            f"{len(entries)} frames"
        )
    return bytes(out)


# ---------------------------------------------------------------------------
# Writers (tests, profiles, scenario corpora — no seekable writer ships
# with the system library, so synthesize spec-shaped blobs here)
# ---------------------------------------------------------------------------


def write_frames(
    raw: bytes, frame_usize: int = DEFAULT_FRAME_USIZE, level: int = 3
) -> bytes:
    """Compress ``raw`` as independent fixed-stride zstd frames with NO
    seek table — the "opaque multi-frame" shape (what a chunked encoder
    emits when it drops the index). Deterministic for a given input and
    level, so scenario serial replays keep blob-id identity."""
    if not 0 < frame_usize <= MAX_FRAME_USIZE:
        raise ZstdFrameError(f"frame_usize {frame_usize} out of range")
    parts = []
    for pos in range(0, len(raw), frame_usize):
        parts.append(_zstd.compress_block(raw[pos : pos + frame_usize], level))
    return b"".join(parts)


def write_seekable(
    raw: bytes, frame_usize: int = DEFAULT_FRAME_USIZE, level: int = 3
) -> bytes:
    """Compress ``raw`` into the facebook/zstd seekable format:
    independent frames of ``frame_usize`` decompressed bytes each, plus
    the trailing seek-table skippable frame (no per-frame checksums).
    Any seekable-format reader — including :func:`read_seek_table` —
    can random-access the result."""
    if not 0 < frame_usize <= MAX_FRAME_USIZE:
        raise ZstdFrameError(f"frame_usize {frame_usize} out of range")
    parts = []
    sizes: list[tuple[int, int]] = []
    for pos in range(0, len(raw), frame_usize):
        chunk = raw[pos : pos + frame_usize]
        frame = _zstd.compress_block(chunk, level)
        parts.append(frame)
        sizes.append((len(frame), len(chunk)))
    table = bytearray()
    for fcsize, fusize in sizes:
        table += struct.pack("<II", fcsize, fusize)
    table += _FOOTER.pack(len(sizes), 0, SEEKABLE_MAGIC)
    parts.append(
        struct.pack("<II", SEEK_TABLE_SKIPPABLE_MAGIC, len(table)) + table
    )
    return b"".join(parts)
