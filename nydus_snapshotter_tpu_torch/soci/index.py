"""The persisted seekable-OCI index artifact (``<blob_id>.soci.idx``).

One file per indexed layer, living in the blob cache dir next to the
chunk map (cache/manager.py treats it as a cache-entry companion, so
watermark eviction and GC remove it with the blob it describes). It
carries everything a fresh process needs to read the unconverted layer
lazily:

- the zran **checkpoint table** (:mod:`~nydus_snapshotter_tpu_torch.soci.zran`
  resume points at the build stride, windows zlib-compressed);
- the **file → decompressed-extent map** (path, offset, size per regular
  file) — self-contained resolve geometry for tooling and peers, without
  needing the layer bootstrap;
- blob geometry (id, compressed/uncompressed size, stride).

Torn-write hardening follows the v5 dict format's tail-first/header-last
discipline, belt and braces: the payload is written first and the fixed
header — whose magic, counts and payload SHA-256 are what ``load``
validates — is written last (then fsync + atomic rename, so a crashed
writer leaves either the old index or none). A corrupt, truncated or
stale index NEVER poisons reads: ``load`` fails loudly with
:class:`SociIndexError` and the store rebuilds once
(:mod:`~nydus_snapshotter_tpu_torch.soci.blob`).
"""

from __future__ import annotations

import hashlib
import io
import os
import struct
import tempfile
import zlib
from bisect import bisect_right
from dataclasses import dataclass, field
from typing import Optional

from nydus_snapshotter_tpu_torch.soci.zran import DEFAULT_STRIDE, Checkpoint
from nydus_snapshotter_tpu_torch.utils import errdefs

INDEX_SUFFIX = ".soci.idx"

_MAGIC = b"NTPUSOCI"
_VERSION = 1
# magic, version, stride, csize, usize, n_checkpoints, n_files,
# payload_len, payload sha256, blob_id (64 hex, space-padded), reserved.
_HEADER = struct.Struct("<8sIQQQIIQ32s64s16s")
_CP_HEAD = struct.Struct("<QQBBI")
_FILE_HEAD = struct.Struct("<IQQ")


class SociIndexError(errdefs.NydusError):
    """The index artifact is corrupt, torn, or stale for its blob."""


def index_path(cache_dir: str, blob_id: str) -> str:
    return os.path.join(cache_dir, blob_id + INDEX_SUFFIX)


@dataclass
class SociIndex:
    blob_id: str
    compressed_size: int
    uncompressed_size: int
    stride: int = DEFAULT_STRIDE
    checkpoints: list[Checkpoint] = field(default_factory=list)
    # path -> (decompressed offset, size) of every regular file's content.
    files: dict[str, tuple[int, int]] = field(default_factory=dict)

    def __post_init__(self):
        self.checkpoints.sort(key=lambda c: c.uout)
        self._uouts = [c.uout for c in self.checkpoints]

    # -- resolve geometry ----------------------------------------------------

    def resolve(
        self, offset: int, size: int
    ) -> tuple[Optional[Checkpoint], int, int]:
        """Compressed bytes needed for decompressed ``[offset, offset+size)``.

        Returns ``(checkpoint, comp_start, comp_end)``: resume at
        ``checkpoint`` (None = stream start), feeding compressed bytes
        from ``comp_start`` (includes the checkpoint's shared partial
        byte) up to at most ``comp_end`` — the input position of the
        first checkpoint at or past the read's end, which has by
        construction consumed enough input to produce it.
        """
        end = offset + max(0, size)
        i = bisect_right(self._uouts, offset) - 1
        cp = self.checkpoints[i] if i >= 0 else None
        comp_start = 0 if cp is None else cp.cin - (1 if cp.bits else 0)
        # First checkpoint with uout >= end has consumed enough input to
        # produce the whole read; its cin bounds the compressed range.
        j = bisect_right(self._uouts, max(offset, end - 1))
        comp_end = (
            self.checkpoints[j].cin
            if j < len(self.checkpoints)
            else self.compressed_size
        )
        return cp, comp_start, comp_end

    def file_extent(self, path: str) -> Optional[tuple[int, int]]:
        return self.files.get(path)

    # -- (de)serialization ---------------------------------------------------

    def _payload(self) -> bytes:
        out = io.BytesIO()
        for cp in self.checkpoints:
            win = zlib.compress(cp.window, 1) if cp.window else b""
            out.write(
                _CP_HEAD.pack(cp.uout, cp.cin, cp.bits, int(cp.fresh), len(win))
            )
            out.write(win)
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
            self.stride,
            self.compressed_size,
            self.uncompressed_size,
            len(self.checkpoints),
            len(self.files),
            len(payload),
            hashlib.sha256(payload).digest(),
            self.blob_id.encode().ljust(64),
            b"\0" * 16,
        )
        return header + payload

    def save(self, path: str) -> int:
        """Persist atomically, payload-first/header-last: the header that
        makes the bytes loadable is the final write before fsync+rename,
        so no crash window leaves a half-index under the real name.
        Returns bytes written."""
        payload = self._payload()
        blob = self.to_bytes()
        d = os.path.dirname(path) or "."
        os.makedirs(d, exist_ok=True)
        fd, tmp = tempfile.mkstemp(prefix=".soci-idx-", dir=d)
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
    def from_bytes(cls, raw: bytes, blob_id: str = "", csize: int = 0) -> "SociIndex":
        """Parse + validate; ``blob_id``/``csize`` (when given) pin the
        index to the blob it is about to serve — a stale index for a
        different or re-pushed blob fails here, loudly."""
        if len(raw) < _HEADER.size:
            raise SociIndexError("soci index truncated before header")
        (magic, version, stride, hcsize, usize, n_cp, n_files, payload_len,
         digest, hblob, _reserved) = _HEADER.unpack_from(raw, 0)
        if magic != _MAGIC:
            raise SociIndexError("bad soci index magic (torn or foreign file)")
        if version != _VERSION:
            raise SociIndexError(f"unsupported soci index version {version}")
        payload = raw[_HEADER.size : _HEADER.size + payload_len]
        if len(payload) != payload_len:
            raise SociIndexError("soci index payload truncated")
        if hashlib.sha256(payload).digest() != digest:
            raise SociIndexError("soci index payload checksum mismatch")
        hblob_id = hblob.rstrip(b" \0").decode()
        if blob_id and hblob_id != blob_id:
            raise SociIndexError(
                f"soci index is for blob {hblob_id[:12]}…, not {blob_id[:12]}…"
            )
        if csize and hcsize != csize:
            raise SociIndexError(
                f"soci index is stale: built for {hcsize}-byte blob, "
                f"blob is {csize} bytes"
            )
        pos = 0
        checkpoints: list[Checkpoint] = []
        for _ in range(n_cp):
            uout, cin, bits, fresh, wlen = _CP_HEAD.unpack_from(payload, pos)
            pos += _CP_HEAD.size
            win = payload[pos : pos + wlen]
            if len(win) != wlen:
                raise SociIndexError("soci index checkpoint window truncated")
            pos += wlen
            try:
                window = zlib.decompress(win) if win else b""
            except zlib.error as e:
                raise SociIndexError(f"corrupt checkpoint window: {e}") from e
            checkpoints.append(Checkpoint(uout, cin, bits, window, bool(fresh)))
        files: dict[str, tuple[int, int]] = {}
        for _ in range(n_files):
            plen, uoff, fsize = _FILE_HEAD.unpack_from(payload, pos)
            pos += _FILE_HEAD.size
            p = payload[pos : pos + plen]
            if len(p) != plen:
                raise SociIndexError("soci index file map truncated")
            pos += plen
            files[p.decode()] = (uoff, fsize)
        return cls(
            blob_id=hblob_id,
            compressed_size=hcsize,
            uncompressed_size=usize,
            stride=stride,
            checkpoints=checkpoints,
            files=files,
        )

    @classmethod
    def load(cls, path: str, blob_id: str = "", csize: int = 0) -> "SociIndex":
        try:
            with open(path, "rb") as f:
                raw = f.read()
        except OSError as e:
            raise SociIndexError(f"cannot read soci index {path}: {e}") from e
        return cls.from_bytes(raw, blob_id=blob_id, csize=csize)
