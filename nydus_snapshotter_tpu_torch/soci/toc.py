"""zstd:chunked TOC support: footer probe, ranged manifest read, writer.

zstd:chunked (containers/storage) is the zstd ecosystem's eStargz: the
layer is a sequence of independent per-chunk zstd frames, a
zstd-compressed TOC manifest near the tail, and a fixed-size skippable
FOOTER frame ending in the ``GnUlInUx`` magic that locates the manifest
without any out-of-band annotation. A cooperating layer therefore needs
NO build pass at all — the TOC *is* the file→extent map, and chunks
decode through the ordinary per-chunk ``COMPRESSOR_ZSTD`` arm of
``converter/convert._decompress_chunk`` over the original blob
(index adoption, zero extra origin bytes).

The manifest this module reads and writes is the eStargz jtoc shape
(``{"version": 1, "entries": [...]}`` — ``stargz/index.py`` parses it),
so adoption is one call: ``bootstrap_from_toc(toc, ...,
compressor=COMPRESSOR_ZSTD)``. The real zstd:chunked manifest differs
in field spelling but not in content; this repo's writer exists to
exercise the adoption path end-to-end, not to interoperate with
containers/storage blobs byte-for-byte.
"""

from __future__ import annotations

import hashlib
import json
import struct
from typing import Callable, Optional

from nydus_snapshotter_tpu_torch.utils import errdefs
from nydus_snapshotter_tpu_torch.utils import zstd as _zstd

ZSTD_CHUNKED_MAGIC = b"GnUlInUx"
_FOOTER_SKIPPABLE_MAGIC = 0x184D2A50
# manifest offset, compressed length, uncompressed length, manifest type,
# trailing magic — the footer payload of the zstd:chunked format.
_FOOTER_PAYLOAD = struct.Struct("<QQQQ8s")
FOOTER_SIZE = 8 + _FOOTER_PAYLOAD.size  # skippable header + payload
_MANIFEST_TYPE_TOC = 1

DEFAULT_CHUNK_SIZE = 0x400000


class ZstdChunkedError(errdefs.NydusError):
    pass


def parse_footer(tail: bytes) -> Optional[tuple[int, int, int]]:
    """``(manifest_offset, manifest_csize, manifest_usize)`` from the
    blob's last ``FOOTER_SIZE`` bytes, or ``None`` when the tail is not
    a zstd:chunked footer (the probe path — absence is routing, not an
    error)."""
    if len(tail) < FOOTER_SIZE:
        return None
    frame = tail[-FOOTER_SIZE:]
    magic, content_len = struct.unpack_from("<II", frame, 0)
    if magic != _FOOTER_SKIPPABLE_MAGIC or content_len != _FOOTER_PAYLOAD.size:
        return None
    off, csize, usize, mtype, tag = _FOOTER_PAYLOAD.unpack_from(frame, 8)
    if tag != ZSTD_CHUNKED_MAGIC or mtype != _MANIFEST_TYPE_TOC:
        return None
    return off, csize, usize


def read_toc(
    read_at: Callable[[int, int], bytes], blob_size: int
) -> Optional[dict]:
    """Fetch + decode the TOC manifest with two ranged reads (footer,
    then the exact manifest frame). Returns ``None`` when the blob has
    no zstd:chunked footer; raises on a footer that promises a manifest
    the blob cannot hold or a manifest that fails to decode."""
    if blob_size < FOOTER_SIZE:
        return None
    loc = parse_footer(read_at(blob_size - FOOTER_SIZE, FOOTER_SIZE))
    if loc is None:
        return None
    off, csize, usize = loc
    if off + csize > blob_size or csize <= 0:
        raise ZstdChunkedError(
            f"zstd:chunked footer promises manifest [{off}, +{csize}) in a "
            f"{blob_size}-byte blob"
        )
    raw = read_at(off, csize)
    if len(raw) != csize:
        raise ZstdChunkedError("short read fetching zstd:chunked manifest")
    try:
        plain = _zstd.decompress_block(raw, max_output_size=max(usize, 1))
    except _zstd.ZstdError as e:
        raise ZstdChunkedError(f"corrupt zstd:chunked manifest: {e}") from e
    if len(plain) != usize:
        raise ZstdChunkedError(
            f"zstd:chunked manifest decoded to {len(plain)} bytes, "
            f"footer says {usize}"
        )
    try:
        return json.loads(plain)
    except ValueError as e:
        raise ZstdChunkedError(f"zstd:chunked manifest is not JSON: {e}") from e


def write_zstd_chunked(
    files: dict[str, bytes],
    chunk_size: int = DEFAULT_CHUNK_SIZE,
    level: int = 3,
) -> bytes:
    """Synthesize a zstd:chunked-shaped layer blob from ``files``
    (path → content): one independent zstd frame per chunk, a
    zstd-compressed version-1 TOC, and the ``GnUlInUx`` footer.
    Deterministic for fixed input/level, so scenario serial replays keep
    blob-id identity. Used by tests, the profile tool and the scenario
    corpus — production blobs arrive pre-chunked from the registry."""
    parts: list[bytes] = []
    entries: list[dict] = []
    pos = 0
    for name, data in sorted(files.items()):
        clean = name.strip("/")
        first = True
        coff = 0
        while first or coff < len(data):
            piece = data[coff : coff + chunk_size]
            frame = _zstd.compress_block(piece, level) if piece else b""
            digest = "sha256:" + hashlib.sha256(piece).hexdigest()
            if first:
                entries.append({
                    "name": clean,
                    "type": "reg",
                    "size": len(data),
                    "mode": 0o644,
                    "offset": pos,
                    "chunkOffset": 0,
                    "chunkSize": len(piece),
                    "chunkDigest": digest,
                })
            else:
                entries.append({
                    "name": clean,
                    "type": "chunk",
                    "offset": pos,
                    "chunkOffset": coff,
                    "chunkSize": len(piece),
                    "chunkDigest": digest,
                })
            parts.append(frame)
            pos += len(frame)
            coff += len(piece)
            first = False
    toc = json.dumps(
        {"version": 1, "entries": entries}, sort_keys=True
    ).encode()
    manifest = _zstd.compress_block(toc, level)
    footer = struct.pack(
        "<II", _FOOTER_SKIPPABLE_MAGIC, _FOOTER_PAYLOAD.size
    ) + _FOOTER_PAYLOAD.pack(
        pos, len(manifest), len(toc), _MANIFEST_TYPE_TOC, ZSTD_CHUNKED_MAGIC
    )
    return b"".join(parts) + manifest + footer
