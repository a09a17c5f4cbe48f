"""OCIRef conversion for zstd layers: index the original blob, store nothing.

The zstd sibling of :mod:`~nydus_snapshotter_tpu_torch.converter.zran`
(the reference package's ``converter/zstd_ref.py``): the bootstrap indexes
the decompressed tar of an original ``.tar.zst`` layer. Chunk records carry
``CHUNK_FLAG_ZSTD_STREAM``: offsets address the decompressed stream of a
whole-zstd blob, and ``BlobReader`` translates them through a mounted
frame-indexed reader or the in-process :class:`ZstdSequentialReader`.

A ``ZSTD_DCtx`` cannot be checkpoint-copied as ``decompressobj`` can, so
the sequential reader keeps one forward cursor: forward reads are
incremental, a backward seek re-decodes from stream start.
"""

from __future__ import annotations

from typing import Callable, Optional

from nydus_snapshotter_tpu_torch import constants
from nydus_snapshotter_tpu_torch.converter.types import ConvertError, PackOption
from nydus_snapshotter_tpu_torch.converter.zran import pack_stream_layer
from nydus_snapshotter_tpu_torch.models.bootstrap import Bootstrap
from nydus_snapshotter_tpu_torch.utils import zstd as _zstd

# Chunk flag: offsets address the decompressed stream of a whole-zstd blob.
CHUNK_FLAG_ZSTD_STREAM = 0x800


class ZstdSequentialReader:
    """Index-less random access into a zstd stream: one forward decode
    cursor over caller-supplied compressed bytes.

    ``read_at(offset, size)`` returns COMPRESSED blob bytes;
    ``read_range`` returns DECOMPRESSED bytes. Forward reads resume the
    held :class:`~nydus_snapshotter_tpu_torch.utils.zstd.StreamDecoder`
    and the last decoded step it emitted, so reads in ascending offset
    order cost one decode pass in all; reading behind that step resets
    the cursor to stream start (zstd decode state is not copyable — see
    module docstring).
    """

    _READ_STEP = 1 << 20

    def __init__(self, read_at: Callable[[int, int], bytes], compressed_size: int):
        self._read_at = read_at
        self._csize = compressed_size
        self._dec: Optional[_zstd.StreamDecoder] = None
        self._upos = 0  # decompressed bytes emitted so far
        self._cpos = 0  # compressed bytes consumed so far
        self._held = b""  # the last decoded step, ending at _upos

    def _rewind(self) -> None:
        if self._dec is None:
            self._dec = _zstd.StreamDecoder()
        else:
            self._dec.reset()
        self._upos = self._cpos = 0
        self._held = b""

    def read_range(self, offset: int, size: int) -> bytes:
        if size <= 0:
            return b""
        if self._dec is None or offset < self._upos - len(self._held):
            try:
                self._rewind()
            except _zstd.ZstdError as e:
                raise ConvertError(str(e)) from e
        end = offset + size
        held_at = self._upos - len(self._held)
        out = bytearray(self._held[offset - held_at : end - held_at])
        while self._upos < end:
            if self._cpos >= self._csize:
                break
            feed = self._read_at(
                self._cpos, min(self._READ_STEP, self._csize - self._cpos)
            )
            if not feed:
                break
            self._cpos += len(feed)
            try:
                chunk = self._dec.feed(feed)
            except _zstd.ZstdError as e:
                self._dec = None
                raise ConvertError(f"corrupt zstd stream: {e}") from e
            if not chunk:
                continue
            lo = max(0, offset - self._upos)
            hi = min(len(chunk), end - self._upos)
            if hi > lo:
                out += chunk[lo:hi]
            self._upos += len(chunk)
            self._held = chunk
        if len(out) != size:
            raise ConvertError(
                f"zstd stream range [{offset}, +{size}) beyond decompressed end"
            )
        return bytes(out)

    def close(self) -> None:
        if self._dec is not None:
            self._dec.close()
            self._dec = None


def pack_zstd_layer(
    raw_zstd: bytes, opt: PackOption, engine=None, tar_bytes: Optional[bytes] = None
) -> Bootstrap:
    """Index an original ``.tar.zst`` layer without re-storing its data.

    Returns the layer Bootstrap whose single blob IS the original
    compressed layer (blob id = its sha256). ``tar_bytes`` lets a caller
    that already decoded the stream (the zstd index build is itself one
    full decode pass) hand the output over instead of decoding twice.
    """
    if tar_bytes is None:
        try:
            tar_bytes = _zstd.stream_decompress(raw_zstd)
        except _zstd.ZstdError as e:
            raise ConvertError(f"OCIRef layer is not valid zstd: {e}") from e
    return pack_stream_layer(
        raw_zstd, tar_bytes, opt,
        chunk_flag=CHUNK_FLAG_ZSTD_STREAM,
        blob_compressor=constants.COMPRESSOR_ZSTD,
        engine=engine,
    )
