"""The persisted zstd frame-index artifact (``<blob_id>.soci.zidx``).

The zstd sibling of :mod:`~nydus_snapshotter_tpu_torch.soci.index`: one file
per lazily-read zstd layer, living in the blob cache dir as a
cache-entry companion (watermark eviction and GC remove it with the
blob), peer-replicated through the generic artifact plane under kind
``"zsoci"``. It carries:

- the **frame table** (:class:`~nydus_snapshotter_tpu_torch.soci.zframe.FrameEntry`
  rows — zstd frames decode independently, so unlike gzip checkpoints
  there are no windows to compress and no bit offsets: 32 bytes/frame);
- the **file → decompressed-extent map** (same shape as the gzip index);
- blob geometry plus the index ``source`` (parsed seek table vs
  sequential frame walk), surfaced on ``ntpuctl soci``.

Persistence discipline is byte-for-byte the same as ``.soci.idx``:
payload written first, the fixed header (magic, counts, payload SHA-256)
written last, fsync + atomic rename — a crashed writer leaves the old
index or none. Validation failures raise :class:`ZstdIndexError`, a
:class:`~nydus_snapshotter_tpu_torch.soci.index.SociIndexError` subclass, so
the load→replicate→rebuild-once waterfall in :mod:`soci.zblob` handles
torn, stale and foreign files identically: delete, rebuild once, never
poison reads.
"""

from __future__ import annotations

import hashlib
import io
import os
import struct
import tempfile
from bisect import bisect_right
from dataclasses import dataclass, field
from typing import Optional

from nydus_snapshotter_tpu_torch.soci.index import SociIndexError, _FILE_HEAD
from nydus_snapshotter_tpu_torch.soci.zframe import FrameEntry

ZINDEX_SUFFIX = ".soci.zidx"

_MAGIC = b"NTPUZSTD"
_VERSION = 1
# magic, version, source, csize, usize, n_frames, n_files, payload_len,
# payload sha256, blob_id (64 hex, space-padded), reserved.
_HEADER = struct.Struct("<8sIQQQIIQ32s64s16s")
_FRAME = struct.Struct("<QQQQ")

# How the frame table was obtained — a seek table costs two ranged tail
# reads, a frame walk costs the one sequential first-pull pass.
SOURCE_FRAME_WALK = 0
SOURCE_SEEK_TABLE = 1
_SOURCE_NAMES = {SOURCE_FRAME_WALK: "frame_walk", SOURCE_SEEK_TABLE: "seek_table"}


class ZstdIndexError(SociIndexError):
    """The zstd index artifact is corrupt, torn, or stale for its blob."""


def zindex_path(cache_dir: str, blob_id: str) -> str:
    return os.path.join(cache_dir, blob_id + ZINDEX_SUFFIX)


@dataclass
class ZstdFrameIndex:
    blob_id: str
    compressed_size: int
    uncompressed_size: int
    source: int = SOURCE_FRAME_WALK
    frames: list[FrameEntry] = field(default_factory=list)
    # path -> (decompressed offset, size) of every regular file's content.
    files: dict[str, tuple[int, int]] = field(default_factory=dict)

    def __post_init__(self):
        self.frames.sort(key=lambda e: e.uout)
        self._uouts = [e.uout for e in self.frames]

    @property
    def source_name(self) -> str:
        return _SOURCE_NAMES.get(self.source, f"source_{self.source}")

    # -- resolve geometry ----------------------------------------------------

    def resolve(
        self, offset: int, size: int
    ) -> tuple[list[FrameEntry], int, int]:
        """Frames covering decompressed ``[offset, offset+size)``.

        Returns ``(frames, comp_start, comp_end)``: the ascending slice
        of frame entries the read overlaps, and the compressed byte span
        ``[comp_start, comp_end)`` that feeds them — contiguous by frame
        adjacency, so one ranged fetch (or the CachedBlob waterfall's
        coalesced chunk reads) covers every needed frame.
        """
        end = offset + max(0, size)
        i = bisect_right(self._uouts, offset) - 1
        if i < 0:
            i = 0
        j = bisect_right(self._uouts, max(offset, end - 1))
        covering = self.frames[i:j]
        if not covering:
            return [], 0, 0
        return (
            covering,
            covering[0].cin,
            covering[-1].cin + covering[-1].csize,
        )

    def file_extent(self, path: str) -> Optional[tuple[int, int]]:
        return self.files.get(path)

    # -- (de)serialization ---------------------------------------------------

    def _payload(self) -> bytes:
        out = io.BytesIO()
        for e in self.frames:
            out.write(_FRAME.pack(e.uout, e.cin, e.usize, e.csize))
        for path, (uoff, usize) in sorted(self.files.items()):
            p = path.encode()
            out.write(_FILE_HEAD.pack(len(p), uoff, usize))
            out.write(p)
        return out.getvalue()

    def to_bytes(self) -> bytes:
        payload = self._payload()
        header = _HEADER.pack(
            _MAGIC,
            _VERSION,
            self.source,
            self.compressed_size,
            self.uncompressed_size,
            len(self.frames),
            len(self.files),
            len(payload),
            hashlib.sha256(payload).digest(),
            self.blob_id.encode().ljust(64),
            b"\0" * 16,
        )
        return header + payload

    def save(self, path: str) -> int:
        """Persist atomically, payload-first/header-last (the discipline
        of ``SociIndex.save``): the header that makes the bytes loadable
        lands after the payload is fsynced, then an atomic rename.
        Returns bytes written."""
        payload = self._payload()
        blob = self.to_bytes()
        d = os.path.dirname(path) or "."
        os.makedirs(d, exist_ok=True)
        fd, tmp = tempfile.mkstemp(prefix=".soci-zidx-", dir=d)
        try:
            with os.fdopen(fd, "wb") as f:
                f.write(b"\0" * _HEADER.size)  # placeholder until payload lands
                f.write(payload)
                f.flush()
                os.fsync(f.fileno())
                f.seek(0)
                f.write(blob[: _HEADER.size])
                f.flush()
                os.fsync(f.fileno())
            os.rename(tmp, path)
        except BaseException:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise
        return len(blob)

    @classmethod
    def from_bytes(
        cls, raw: bytes, blob_id: str = "", csize: int = 0
    ) -> "ZstdFrameIndex":
        """Parse + validate; ``blob_id``/``csize`` (when given) pin the
        index to the blob it is about to serve — a stale index for a
        different or re-pushed blob fails here, loudly."""
        if len(raw) < _HEADER.size:
            raise ZstdIndexError("zstd index truncated before header")
        (magic, version, source, hcsize, usize, n_frames, n_files,
         payload_len, digest, hblob, _reserved) = _HEADER.unpack_from(raw, 0)
        if magic != _MAGIC:
            raise ZstdIndexError("bad zstd index magic (torn or foreign file)")
        if version != _VERSION:
            raise ZstdIndexError(f"unsupported zstd index version {version}")
        payload = raw[_HEADER.size : _HEADER.size + payload_len]
        if len(payload) != payload_len:
            raise ZstdIndexError("zstd index payload truncated")
        if hashlib.sha256(payload).digest() != digest:
            raise ZstdIndexError("zstd index payload checksum mismatch")
        hblob_id = hblob.rstrip(b" \0").decode()
        if blob_id and hblob_id != blob_id:
            raise ZstdIndexError(
                f"zstd index is for blob {hblob_id[:12]}…, not {blob_id[:12]}…"
            )
        if csize and hcsize != csize:
            raise ZstdIndexError(
                f"zstd index is stale: built for {hcsize}-byte blob, "
                f"blob is {csize} bytes"
            )
        pos = 0
        frames: list[FrameEntry] = []
        for _ in range(n_frames):
            if pos + _FRAME.size > len(payload):
                raise ZstdIndexError("zstd index frame table truncated")
            uout, cin, fusize, fcsize = _FRAME.unpack_from(payload, pos)
            pos += _FRAME.size
            frames.append(FrameEntry(uout, cin, fusize, fcsize))
        files: dict[str, tuple[int, int]] = {}
        for _ in range(n_files):
            if pos + _FILE_HEAD.size > len(payload):
                raise ZstdIndexError("zstd index file map truncated")
            plen, uoff, fsize = _FILE_HEAD.unpack_from(payload, pos)
            pos += _FILE_HEAD.size
            p = payload[pos : pos + plen]
            if len(p) != plen:
                raise ZstdIndexError("zstd index file map truncated")
            pos += plen
            files[p.decode()] = (uoff, fsize)
        return cls(
            blob_id=hblob_id,
            compressed_size=hcsize,
            uncompressed_size=usize,
            source=source,
            frames=frames,
            files=files,
        )

    @classmethod
    def load(cls, path: str, blob_id: str = "", csize: int = 0) -> "ZstdFrameIndex":
        try:
            with open(path, "rb") as f:
                raw = f.read()
        except OSError as e:
            raise ZstdIndexError(f"cannot read zstd index {path}: {e}") from e
        return cls.from_bytes(raw, blob_id=blob_id, csize=csize)
