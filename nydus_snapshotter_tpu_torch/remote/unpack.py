"""Pull a single file out of a (possibly compressed) tar stream.

Reference pkg/remote/unpack.go:20-56 — used to extract the nydus bootstrap
(``image/image.boot``) from a fetched metadata layer.
"""

from __future__ import annotations

import gzip
import io
import tarfile
import zlib

from nydus_snapshotter_tpu_torch.utils import errdefs


def decompress_stream(data: bytes) -> bytes:
    """containerd compression.DecompressStream equivalent: sniff gzip/zstd,
    fall through to plain."""
    if data[:2] == b"\x1f\x8b":
        return gzip.decompress(data)
    if data[:4] == b"\x28\xb5\x2f\xfd":
        from nydus_snapshotter_tpu_torch.utils import zstdcompat

        if not zstdcompat.available():
            raise errdefs.Unavailable("zstd layer but no zstd implementation")
        return zstdcompat.zstandard.ZstdDecompressor().decompress(data)
    if data[:2] == b"\x78\x9c" or data[:2] == b"\x78\xda":
        return zlib.decompress(data)
    return data


def unpack(reader, source: str, target: str) -> None:
    """Stream ``reader`` (bytes or file-like tar, optionally compressed),
    find member ``source``, write its contents to path ``target``."""
    data = reader if isinstance(reader, bytes) else reader.read()
    data = decompress_stream(data)
    with tarfile.open(fileobj=io.BytesIO(data), mode="r:") as tf:
        for member in tf:
            if member.name == source or member.name == "./" + source:
                extracted = tf.extractfile(member)
                if extracted is None:
                    break
                with open(target, "wb") as out:
                    while True:
                        buf = extracted.read(1 << 20)
                        if not buf:
                            break
                        out.write(buf)
                return
    raise errdefs.NotFound(f"not found file {source} in tar")
