"""``zstandard``-package compatibility layer.

Prefers the real ``zstandard`` package when it is installed. When it is
not, exposes an API-compatible shim (``ZstdCompressor``/
``ZstdDecompressor`` with the calling conventions this codebase uses)
backed by the *system* ``libzstd`` over ctypes — the same library
:mod:`nydus_snapshotter_tpu_torch.utils.zstd` binds for the compression lane,
so the converter keeps its cross-lane byte-identity invariant.

Import ``zstandard`` from here instead of directly: a missing wheel must
degrade to the system library, not take the converter stack down with an
ImportError.

The PyTorch port's own copy of the reference package's
``utils/zstdcompat.py``: the port takes ``zstandard`` from here and never
imports the wheel directly.
"""

from __future__ import annotations

import ctypes
import ctypes.util

try:  # pragma: no cover - branch depends on the environment
    import zstandard  # type: ignore

    _HAVE_PACKAGE = True
except ModuleNotFoundError:
    _HAVE_PACKAGE = False

_CONTENTSIZE_UNKNOWN = 2**64 - 1
_CONTENTSIZE_ERROR = 2**64 - 2


class _ShimError(Exception):
    pass


def _load_lib():
    for name in ("libzstd.so.1", "libzstd.so", "libzstd.dylib"):
        try:
            lib = ctypes.CDLL(name)
            break
        except OSError:
            continue
    else:
        found = ctypes.util.find_library("zstd")
        if not found:
            return None
        try:
            lib = ctypes.CDLL(found)
        except OSError:
            return None
    try:
        lib.ZSTD_isError.restype = ctypes.c_uint
        lib.ZSTD_isError.argtypes = [ctypes.c_size_t]
        lib.ZSTD_getFrameContentSize.restype = ctypes.c_ulonglong
        lib.ZSTD_getFrameContentSize.argtypes = [ctypes.c_void_p, ctypes.c_size_t]
        lib.ZSTD_decompress.restype = ctypes.c_size_t
        lib.ZSTD_decompress.argtypes = [
            ctypes.c_void_p, ctypes.c_size_t, ctypes.c_void_p, ctypes.c_size_t,
        ]
    except AttributeError:
        return None
    return lib


# Loaded unconditionally: the pooled decompress path below (used by chunk
# decode even when the real package is installed) binds
# the same system library utils/zstd.py does.
_LIB = _load_lib()

import threading as _threading

_TLS = _threading.local()


def decompress_block(data, max_output_size: int = 0) -> bytes:
    """One zstd frame → bytes WITHOUT a per-call context allocation.

    Routes through the pooled system ``ZSTD_DCtx`` (utils/zstd.py) when
    available, else a per-thread
    cached package decompressor, else the one-shot shim. Any conforming
    frame decodes identically on every arm.
    """
    from nydus_snapshotter_tpu_torch.utils import zstd as zstd_native

    if zstd_native.dctx_available():
        try:
            return zstd_native.decompress_block(data, max_output_size)
        except zstd_native.ZstdError as e:
            raise _ShimError(str(e)) from e
    if _HAVE_PACKAGE:
        dctx = getattr(_TLS, "dctx", None)
        if dctx is None:
            dctx = _TLS.dctx = zstandard.ZstdDecompressor()
        return dctx.decompress(data, max_output_size=max(max_output_size, 1))
    return _ShimDecompressor().decompress(data, max_output_size)


if not _HAVE_PACKAGE:

    class _ShimCompressor:
        def __init__(self, level: int = 3):
            from nydus_snapshotter_tpu_torch.utils import zstd as zstd_native

            if not zstd_native.available():
                raise _ShimError("neither zstandard nor system libzstd available")
            self._level = level
            self._native = zstd_native

        def compress(self, data) -> bytes:
            return self._native.compress_block(data, self._level)

    class _ShimDecompressor:
        def __init__(self):
            if _LIB is None:
                raise _ShimError("neither zstandard nor system libzstd available")

        def decompress(self, data, max_output_size: int = 0) -> bytes:
            from nydus_snapshotter_tpu_torch.utils import zstd as zstd_native

            if zstd_native.dctx_available():
                # Pooled DCtx fast path (no per-call context allocation).
                try:
                    return zstd_native.decompress_block(data, max_output_size)
                except zstd_native.ZstdError as e:
                    raise _ShimError(str(e)) from e
            import numpy as np

            src = np.frombuffer(data, dtype=np.uint8)
            n = src.size
            if n == 0:
                raise _ShimError("empty zstd frame")
            size = _LIB.ZSTD_getFrameContentSize(src.ctypes.data, n)
            if size == _CONTENTSIZE_ERROR:
                raise _ShimError("not a valid zstd frame")
            if size == _CONTENTSIZE_UNKNOWN:
                if max_output_size <= 0:
                    raise _ShimError(
                        "could not determine content size in frame header"
                    )
                cap = max_output_size
            else:
                cap = max(int(size), 1)
            buf = np.empty(cap, dtype=np.uint8)
            w = _LIB.ZSTD_decompress(buf.ctypes.data, cap, src.ctypes.data, n)
            if _LIB.ZSTD_isError(w):
                raise _ShimError(f"zstd decompress failed for {n}-byte input")
            return buf[:w].tobytes()

    class _Shim:
        """Module-shaped stand-in for the ``zstandard`` package."""

        ZstdError = _ShimError
        ZstdCompressor = _ShimCompressor
        ZstdDecompressor = _ShimDecompressor

    zstandard = _Shim()  # type: ignore[assignment]


def available() -> bool:
    """Whether *some* zstd implementation is usable (package or shim)."""
    if _HAVE_PACKAGE:
        return True
    from nydus_snapshotter_tpu_torch.utils import zstd as zstd_native

    return _LIB is not None and zstd_native.available()


__all__ = ["zstandard", "available", "decompress_block"]
