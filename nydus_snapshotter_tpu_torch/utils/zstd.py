"""zstd codec via the SYSTEM libzstd, for cross-lane byte identity.

The reference's modern chunk compressor default is zstd (PackOption
surface, pkg/converter/types.go:62-66). The ``zstandard`` package bundles
its OWN libzstd, whose output can differ from the system library's
(measured: a 1.3 MiB mixed chunk compresses to 920,855 bytes under system
1.5.4 vs 921,118 under the bundled build). So compression binds the system
``libzstd.so.1`` with ctypes, as the reference package's
``utils/zstd.py`` does, and every lane shares one codec.

The PyTorch port's own copy of the part of that module that chunk
compression and decompression need: the loader, the CCtx/DCtx pools,
:func:`available`, :func:`compress_block`, :func:`compress_with_ctx` and
:func:`decompress_block`, with :func:`library` added. The trained
dictionary, frame-walk and streaming surfaces are not carried.

When the system library is absent, callers fall back to
``utils/zstdcompat.zstandard``.
"""

from __future__ import annotations

import ctypes
import ctypes.util
import threading

import numpy as np

from nydus_snapshotter_tpu_torch.constants import ZSTD_LEVEL as LEVEL  # single source


class ZstdError(ValueError):
    pass


_LIB_CANDIDATES = ("libzstd.so.1", "libzstd.so", "libzstd.dylib")

_CONTENTSIZE_UNKNOWN = 2**64 - 1
_CONTENTSIZE_ERROR = 2**64 - 2


class _Api:
    # A CCtx is not concurrency-safe and each one holds a multi-MiB
    # workspace, so contexts live in a small bounded pool instead of
    # thread-locals; contexts beyond the cap are freed immediately.
    POOL_CAP = 8

    def __init__(self, lib: ctypes.CDLL):
        lib.ZSTD_compressBound.restype = ctypes.c_size_t
        lib.ZSTD_compressBound.argtypes = [ctypes.c_size_t]
        lib.ZSTD_isError.restype = ctypes.c_uint
        lib.ZSTD_isError.argtypes = [ctypes.c_size_t]
        # ZSTD_compressCCtx produces the same output as one-shot
        # ZSTD_compress at the same level, without the per-call CCtx
        # alloc/free.
        lib.ZSTD_createCCtx.restype = ctypes.c_void_p
        lib.ZSTD_freeCCtx.restype = ctypes.c_size_t
        lib.ZSTD_freeCCtx.argtypes = [ctypes.c_void_p]
        lib.ZSTD_compressCCtx.restype = ctypes.c_size_t
        lib.ZSTD_compressCCtx.argtypes = [
            ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_size_t,
            ctypes.c_void_p, ctypes.c_size_t,
            ctypes.c_int,
        ]
        self.lib = lib
        self._lock = threading.Lock()
        self._pool: list[int] = []
        self._dpool: list[int] = []
        self.has_dctx = self._bind_dctx(lib)

    @staticmethod
    def _bind_dctx(lib) -> bool:
        try:
            lib.ZSTD_createDCtx.restype = ctypes.c_void_p
            lib.ZSTD_freeDCtx.restype = ctypes.c_size_t
            lib.ZSTD_freeDCtx.argtypes = [ctypes.c_void_p]
            lib.ZSTD_decompressDCtx.restype = ctypes.c_size_t
            lib.ZSTD_decompressDCtx.argtypes = [
                ctypes.c_void_p,
                ctypes.c_void_p, ctypes.c_size_t,
                ctypes.c_void_p, ctypes.c_size_t,
            ]
            lib.ZSTD_getFrameContentSize.restype = ctypes.c_ulonglong
            lib.ZSTD_getFrameContentSize.argtypes = [
                ctypes.c_void_p, ctypes.c_size_t,
            ]
        except AttributeError:
            return False
        return True

    def acquire(self) -> int:
        with self._lock:
            if self._pool:
                return self._pool.pop()
        ctx = self.lib.ZSTD_createCCtx()
        if not ctx:  # NULL on allocation failure — never hand it out
            raise ZstdError("ZSTD_createCCtx failed (out of memory)")
        return ctx

    def release(self, ctx: int) -> None:
        if not ctx:
            return
        with self._lock:
            if len(self._pool) < self.POOL_CAP:
                self._pool.append(ctx)
                return
        self.lib.ZSTD_freeCCtx(ctx)

    def acquire_d(self) -> int:
        with self._lock:
            if self._dpool:
                return self._dpool.pop()
        ctx = self.lib.ZSTD_createDCtx()
        if not ctx:
            raise ZstdError("ZSTD_createDCtx failed (out of memory)")
        return ctx

    def release_d(self, ctx: int) -> None:
        if not ctx:
            return
        with self._lock:
            if len(self._dpool) < self.POOL_CAP:
                self._dpool.append(ctx)
                return
        self.lib.ZSTD_freeDCtx(ctx)


def _load():
    for name in _LIB_CANDIDATES:
        try:
            return _Api(ctypes.CDLL(name))
        except (OSError, AttributeError):
            continue
    found = ctypes.util.find_library("zstd")
    if found:
        try:
            return _Api(ctypes.CDLL(found))
        except (OSError, AttributeError):
            pass
    return None


_API = _load()


def available() -> bool:
    """True when the system libzstd is bound."""
    return _API is not None


def library() -> "tuple[str, str] | None":
    """(file, version) of the bound libzstd (``ZSTD_versionNumber``), or
    None when it is not bound."""
    if _API is None:
        return None
    from nydus_snapshotter_tpu_torch.utils.dl import object_path

    version = _API.lib.ZSTD_versionNumber
    version.argtypes, version.restype = [], ctypes.c_uint
    v = version()
    return object_path(_API.lib.ZSTD_compressCCtx), f"{v // 10000}.{v // 100 % 100}.{v % 100}"


def compress_block(data: bytes | memoryview, level: int = LEVEL) -> bytes:
    """One zstd frame via the system library (ZSTD_compressCCtx on a pooled
    context == one-shot ZSTD_compress at the same level)."""
    if _API is None:
        raise ZstdError("system libzstd not available")
    ctx = _API.acquire()
    try:
        return compress_with_ctx(ctx, data, level)
    finally:
        _API.release(ctx)


def compress_with_ctx(ctx: int, data: bytes | memoryview, level: int = LEVEL) -> bytes:
    """One zstd frame on a caller-owned CCtx: no context allocation, no
    pool lock. Output is byte-identical to :func:`compress_block` at the
    same level."""
    # zero-copy source: memoryview chunk slices of the tar buffer go
    # straight to libzstd (same contract as utils/lz4.compress_block)
    src = np.frombuffer(data, dtype=np.uint8)
    n = src.size
    cap = _API.lib.ZSTD_compressBound(n)
    buf = np.empty(cap, dtype=np.uint8)  # uninitialized: no bound memset
    w = _API.lib.ZSTD_compressCCtx(ctx, buf.ctypes.data, cap, src.ctypes.data, n, level)
    if _API.lib.ZSTD_isError(w):
        raise ZstdError(f"zstd compress failed for {n}-byte input")
    return buf[:w].tobytes()


def dctx_available() -> bool:
    return _API is not None and _API.has_dctx


def _frame_capacity(src, n: int, max_output_size: int) -> int:
    size = _API.lib.ZSTD_getFrameContentSize(src.ctypes.data, n)
    if size == _CONTENTSIZE_ERROR:
        raise ZstdError("not a valid zstd frame")
    if size == _CONTENTSIZE_UNKNOWN:
        if max_output_size <= 0:
            raise ZstdError("could not determine content size in frame header")
        return max_output_size
    if 0 < max_output_size < int(size):
        # A frame whose declared content exceeds the caller's bound is an
        # error, not a big allocation (the zstandard package's contract).
        raise ZstdError(
            f"decompressed size {int(size)} would exceed max_output_size {max_output_size}"
        )
    return max(int(size), 1)


def decompress_block(data: bytes | memoryview, max_output_size: int = 0) -> bytes:
    """One zstd frame -> bytes via a pooled DCtx."""
    if not dctx_available():
        raise ZstdError("system libzstd decompress contexts not available")
    src = np.frombuffer(data, dtype=np.uint8)
    n = src.size
    if n == 0:
        raise ZstdError("empty zstd frame")
    cap = _frame_capacity(src, n, max_output_size)
    buf = np.empty(cap, dtype=np.uint8)
    ctx = _API.acquire_d()
    try:
        w = _API.lib.ZSTD_decompressDCtx(ctx, buf.ctypes.data, cap, src.ctypes.data, n)
    finally:
        _API.release_d(ctx)
    if _API.lib.ZSTD_isError(w):
        raise ZstdError(f"zstd decompress failed for {n}-byte input")
    return buf[:w].tobytes()
