"""The chunk codecs as the configuration states them, through the system
libraries bound with ctypes: liblz4's ``LZ4_compress_fast`` at the stated
acceleration (1 is ``LZ4_compress_default``) and libzstd's
``ZSTD_compressCCtx`` at the stated level (the bytes of one-shot
``ZSTD_compress``). The reference compresses each chunk and compares the
stored frame with it byte for byte, so a frame at another setting (a faster
level, a larger blob for every node that pulls it) is found, and so is one
that does not hold its chunk.

Chunk flag bits, low nibble (nydus's compressor bits): 0x1 none, 0x2 zstd,
0x4 lz4_block.
"""

from __future__ import annotations

import ctypes
import ctypes.util

import numpy as np

FLAG = {"none": 0x1, "zstd": 0x2, "lz4_block": 0x4}
MASK = 0xF


class CodecError(ValueError):
    pass


def _cdll(names: tuple[str, ...], short: str) -> ctypes.CDLL:
    for name in names + tuple(filter(None, [ctypes.util.find_library(short)])):
        try:
            return ctypes.CDLL(name)
        except OSError:
            continue
    raise CodecError(f"no system lib{short} to compress chunks with")


def setting(config: dict) -> int:
    """The codec's stated parameter: lz4's acceleration or zstd's level."""
    if config["compressor"] == "lz4_block":
        return int(config["lz4_acceleration"])
    if config["compressor"] == "zstd":
        return int(config["zstd_level"])
    return 0


class Encoder:
    """Compress chunks with one codec at one setting. One encoder a thread:
    it keeps its own output buffer (and zstd context)."""

    def __init__(self, codec: str, param: int):
        if codec not in FLAG:
            raise CodecError(f"unknown codec {codec!r}")
        self.codec, self.flag, self.param = codec, FLAG[codec], int(param)
        self._out = ctypes.create_string_buffer(1)
        vp, sz = ctypes.c_void_p, ctypes.c_size_t
        if codec == "lz4_block":
            lib = _cdll(("liblz4.so.1", "liblz4.so"), "lz4")
            self._fn = lib.LZ4_compress_fast
            self._fn.argtypes = [vp, vp, ctypes.c_int, ctypes.c_int, ctypes.c_int]
            self._fn.restype = ctypes.c_int
            self._bound = lambda n: n + n // 255 + 16  # LZ4_COMPRESSBOUND
        elif codec == "zstd":
            lib = _cdll(("libzstd.so.1", "libzstd.so"), "zstd")
            lib.ZSTD_createCCtx.restype = vp
            lib.ZSTD_freeCCtx.argtypes = [vp]
            self._fn = lib.ZSTD_compressCCtx
            self._fn.argtypes = [vp, vp, sz, vp, sz, ctypes.c_int]
            self._fn.restype = sz
            lib.ZSTD_isError.argtypes = [sz]
            lib.ZSTD_isError.restype = ctypes.c_uint
            lib.ZSTD_compressBound.argtypes = [sz]
            lib.ZSTD_compressBound.restype = sz
            self._err, self._bound = lib.ZSTD_isError, lib.ZSTD_compressBound
            self._cctx = lib.ZSTD_createCCtx()
            if not self._cctx:
                raise CodecError("ZSTD_createCCtx failed")
            self._free = lib.ZSTD_freeCCtx

    def __del__(self):
        if getattr(self, "_cctx", None):
            self._free(self._cctx)
            self._cctx = None

    def encode(self, chunk) -> memoryview:
        """The chunk as the codec stores it (a view valid until the next
        call)."""
        n = len(chunk)
        if self.codec == "none":
            return memoryview(chunk)
        cap = int(self._bound(n))
        if cap > len(self._out):
            self._out = ctypes.create_string_buffer(cap)
        arr = np.frombuffer(chunk, dtype=np.uint8)  # a view: ``chunk`` holds the bytes
        src = arr.ctypes.data if n else None
        dst = ctypes.addressof(self._out)
        if self.codec == "lz4_block":
            got = self._fn(src, dst, n, cap, self.param)
            if got <= 0 and n:
                raise CodecError(f"LZ4_compress_fast failed on {n} bytes")
        else:
            got = self._fn(self._cctx, dst, cap, src, n, self.param)
            if self._err(got):
                raise CodecError(f"ZSTD_compressCCtx failed on {n} bytes")
        return memoryview(self._out)[:got]
