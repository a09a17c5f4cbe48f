"""LZ4 block codec via the system liblz4, with a pure-Python fallback.

lz4_block is the nydus default compressor (reference PackOption surface,
pkg/converter/types.go:62-66; passed as ``--compressor`` at
tool/builder.go:128-130). The environment ships no ``lz4`` Python module but
does ship ``liblz4.so.1``, so the fast path binds the three block-API symbols
with ctypes. When the library is absent the fallback still speaks the LZ4
block format: decompression is implemented in Python, and compression emits
a valid literals-only block (format-correct, ratio 1.0) — honest degradation
rather than a hard dependency.

The PyTorch port's own copy of the reference package's ``utils/lz4.py``
(the port imports nothing of that package), with :func:`library` added.
"""

from __future__ import annotations

import ctypes
import ctypes.util


class LZ4Error(ValueError):
    pass


_LIB_CANDIDATES = ("liblz4.so.1", "liblz4.so", "liblz4.dylib")


def _load_lib():
    for name in _LIB_CANDIDATES:
        try:
            lib = ctypes.CDLL(name)
        except OSError:
            continue
        try:
            return _wrap(lib)
        except AttributeError:
            continue
    found = ctypes.util.find_library("lz4")
    if found:
        try:
            return _wrap(ctypes.CDLL(found))
        except (OSError, AttributeError):
            pass
    return None


def _wrap(lib):
    """Single home for the ctypes signatures (both load paths share it).

    src as c_void_p: accepts bytes directly AND raw addresses, so
    memoryview/ndarray chunks compress without a bytes() copy.
    """
    lib.LZ4_compress_default.argtypes = [
        ctypes.c_void_p,
        ctypes.c_char_p,
        ctypes.c_int,
        ctypes.c_int,
    ]
    lib.LZ4_compress_default.restype = ctypes.c_int
    lib.LZ4_compress_fast.argtypes = [
        ctypes.c_void_p,
        ctypes.c_char_p,
        ctypes.c_int,
        ctypes.c_int,
        ctypes.c_int,
    ]
    lib.LZ4_compress_fast.restype = ctypes.c_int
    lib.LZ4_decompress_safe.argtypes = [
        ctypes.c_char_p,
        ctypes.c_char_p,
        ctypes.c_int,
        ctypes.c_int,
    ]
    lib.LZ4_decompress_safe.restype = ctypes.c_int
    lib.LZ4_compressBound.argtypes = [ctypes.c_int]
    lib.LZ4_compressBound.restype = ctypes.c_int
    return lib


_lib = _load_lib()

_MAX_BLOCK = 0x7E000000  # LZ4_MAX_INPUT_SIZE

import threading as _threading

_tls = _threading.local()


def native_available() -> bool:
    return _lib is not None


def library() -> "tuple[str, str] | None":
    """(file, version) of the bound liblz4 (``LZ4_versionNumber``), or None
    when the literal-only fallback is in use."""
    if _lib is None:
        return None
    from nydus_snapshotter_tpu_torch.utils.dl import object_path

    version = _lib.LZ4_versionNumber
    version.argtypes, version.restype = [], ctypes.c_int
    v = version()
    return object_path(_lib.LZ4_compress_default), f"{v // 10000}.{v // 100 % 100}.{v % 100}"


def compress_block(data: "bytes | bytearray | memoryview", accel: int = 1) -> bytes:
    """LZ4 block compress (no frame header, like nydus per-chunk blocks).

    Accepts any contiguous buffer (memoryview chunk slices from the
    streaming packer compress without a bytes() copy). ``accel`` > 1 maps
    to LZ4_compress_fast (accel 1 is bit-identical to the default codec);
    the pure-Python fallback ignores it (literals-only either way).
    """
    size = len(data)
    if size > _MAX_BLOCK:
        raise LZ4Error(f"block of {size} bytes exceeds LZ4 max input size")
    if not size:
        return b""
    if _lib is None:
        return _compress_literals(bytes(data))
    if isinstance(data, bytes):
        src: "bytes | int" = data
    else:
        import numpy as np

        src = np.frombuffer(data, dtype=np.uint8).ctypes.data
    bound = _lib.LZ4_compressBound(size)
    # Reusable per-thread scratch: create_string_buffer zero-fills a fresh
    # allocation per call, which costs more than the compression itself on
    # 64 KiB chunks.
    dst = getattr(_tls, "scratch", None)
    if dst is None or ctypes.sizeof(dst) < bound:
        dst = ctypes.create_string_buffer(max(bound, 1 << 20))
        _tls.scratch = dst
    if accel > 1:
        n = _lib.LZ4_compress_fast(src, dst, size, bound, accel)
    else:
        n = _lib.LZ4_compress_default(src, dst, size, bound)
    if n <= 0:
        raise LZ4Error(f"LZ4 compress failed on {size}-byte block")
    return ctypes.string_at(dst, n)


def decompress_block(data: bytes, uncompressed_size: int) -> bytes:
    """LZ4 block decompress; the caller supplies the exact original size
    (stored in the chunk record, as nydus does — LZ4 blocks carry no size)."""
    if uncompressed_size == 0:
        if data:
            raise LZ4Error("non-empty block with zero uncompressed size")
        return b""
    if not data:
        raise LZ4Error("empty block with non-zero uncompressed size")
    if _lib is None:
        return _decompress_py(data, uncompressed_size)
    dst = ctypes.create_string_buffer(uncompressed_size)
    n = _lib.LZ4_decompress_safe(data, dst, len(data), uncompressed_size)
    if n < 0:
        raise LZ4Error("corrupt LZ4 block")
    if n != uncompressed_size:
        raise LZ4Error(f"LZ4 block decompressed to {n} bytes, expected {uncompressed_size}")
    return dst.raw[:n]


# ---------------------------------------------------------------------------
# Pure-Python fallback
# ---------------------------------------------------------------------------


def _compress_literals(data: bytes) -> bytes:
    """A valid LZ4 block containing only literal runs (the final sequence of
    a block legally omits the match part)."""
    out = bytearray()
    n = len(data)
    # One sequence: token literal nibble 15 + extension bytes, then literals.
    if n < 15:
        out.append(n << 4)
    else:
        out.append(0xF0)
        rem = n - 15
        while rem >= 255:
            out.append(255)
            rem -= 255
        out.append(rem)
    out += data
    return bytes(out)


def _decompress_py(src: bytes, expected: int) -> bytes:
    out = bytearray()
    i = 0
    n = len(src)
    try:
        while i < n:
            token = src[i]
            i += 1
            lit = token >> 4
            if lit == 15:
                while True:
                    b = src[i]
                    i += 1
                    lit += b
                    if b != 255:
                        break
            if i + lit > n:
                raise LZ4Error("literal run overflows block")
            out += src[i : i + lit]
            i += lit
            if i >= n:
                break  # last sequence: literals only
            off = src[i] | (src[i + 1] << 8)
            i += 2
            if off == 0 or off > len(out):
                raise LZ4Error("match offset outside window")
            mlen = (token & 0xF) + 4
            if (token & 0xF) == 15:
                while True:
                    b = src[i]
                    i += 1
                    mlen += b
                    if b != 255:
                        break
            start = len(out) - off
            for k in range(mlen):  # byte-wise: matches may overlap themselves
                out.append(out[start + k])
    except IndexError as e:
        raise LZ4Error("truncated LZ4 block") from e
    if len(out) != expected:
        raise LZ4Error(f"LZ4 block decompressed to {len(out)} bytes, expected {expected}")
    return bytes(out)
