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
:func:`available`, :func:`compress_block`, :func:`compress_with_ctx`,
:func:`decompress_block` (with :func:`dctx_stats`), the pinned-context pool the adaptive codec's
workers take (:func:`cctx_acquire`/:func:`cctx_release`) and the trained
dictionary arms (ZDICT training, digested :class:`CDict`/:class:`DDict`
handles), the frame-walk and streaming arms the OCIRef zstd layers need
(:func:`frames_available`, :func:`is_skippable_frame`,
:func:`find_frame_compressed_size`, :func:`frame_content_size`,
:func:`stream_decompress`, :class:`StreamDecoder`), with :func:`library`
added.

When the system library is absent, callers fall back to
``utils/zstdcompat.zstandard``.
"""

from __future__ import annotations

import ctypes
import ctypes.util
import threading
import weakref

import numpy as np

from nydus_snapshotter_tpu_torch.constants import ZSTD_LEVEL as LEVEL  # single source


class ZstdError(ValueError):
    pass


_LIB_CANDIDATES = ("libzstd.so.1", "libzstd.so", "libzstd.dylib")

_CONTENTSIZE_UNKNOWN = 2**64 - 1
_CONTENTSIZE_ERROR = 2**64 - 2


class _InBuffer(ctypes.Structure):
    _fields_ = [
        ("src", ctypes.c_void_p),
        ("size", ctypes.c_size_t),
        ("pos", ctypes.c_size_t),
    ]


class _OutBuffer(ctypes.Structure):
    _fields_ = [
        ("dst", ctypes.c_void_p),
        ("size", ctypes.c_size_t),
        ("pos", ctypes.c_size_t),
    ]


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
        self.dctx_reuses = 0
        self.dctx_creates = 0
        self.has_dctx = self._bind_dctx(lib)
        self.has_dict = self._bind_dict(lib)
        self.has_zdict = self._bind_zdict(lib)
        self.has_frames = self._bind_frames(lib)

    @staticmethod
    def _bind_frames(lib) -> bool:
        """Frame walk and streaming decode: per-frame compressed size
        without decoding, and a DStream decode for frames whose header
        omits the content size. ``ZSTD_isSkippableFrame`` is not bound
        (older system builds lack it); the magic is checked in Python."""
        try:
            lib.ZSTD_findFrameCompressedSize.restype = ctypes.c_size_t
            lib.ZSTD_findFrameCompressedSize.argtypes = [ctypes.c_void_p, ctypes.c_size_t]
            # DStream == DCtx in every libzstd this binds, so the pooled
            # decompress contexts double as streaming decoders.
            lib.ZSTD_initDStream.restype = ctypes.c_size_t
            lib.ZSTD_initDStream.argtypes = [ctypes.c_void_p]
            lib.ZSTD_decompressStream.restype = ctypes.c_size_t
            lib.ZSTD_decompressStream.argtypes = [
                ctypes.c_void_p,
                ctypes.POINTER(_OutBuffer),
                ctypes.POINTER(_InBuffer),
            ]
        except AttributeError:
            return False
        return True

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

    @staticmethod
    def _bind_dict(lib) -> bool:
        """Digested-dictionary arms: CDict/DDict pre-process the trained
        dictionary ONCE, so per-chunk dict compression costs no dict load."""
        try:
            lib.ZSTD_createCDict.restype = ctypes.c_void_p
            lib.ZSTD_createCDict.argtypes = [
                ctypes.c_void_p, ctypes.c_size_t, ctypes.c_int,
            ]
            lib.ZSTD_freeCDict.restype = ctypes.c_size_t
            lib.ZSTD_freeCDict.argtypes = [ctypes.c_void_p]
            lib.ZSTD_compress_usingCDict.restype = ctypes.c_size_t
            lib.ZSTD_compress_usingCDict.argtypes = [
                ctypes.c_void_p,
                ctypes.c_void_p, ctypes.c_size_t,
                ctypes.c_void_p, ctypes.c_size_t,
                ctypes.c_void_p,
            ]
            lib.ZSTD_createDDict.restype = ctypes.c_void_p
            lib.ZSTD_createDDict.argtypes = [ctypes.c_void_p, ctypes.c_size_t]
            lib.ZSTD_freeDDict.restype = ctypes.c_size_t
            lib.ZSTD_freeDDict.argtypes = [ctypes.c_void_p]
            lib.ZSTD_decompress_usingDDict.restype = ctypes.c_size_t
            lib.ZSTD_decompress_usingDDict.argtypes = [
                ctypes.c_void_p,
                ctypes.c_void_p, ctypes.c_size_t,
                ctypes.c_void_p, ctypes.c_size_t,
                ctypes.c_void_p,
            ]
        except AttributeError:
            return False
        return True

    @staticmethod
    def _bind_zdict(lib) -> bool:
        try:
            lib.ZDICT_trainFromBuffer.restype = ctypes.c_size_t
            lib.ZDICT_trainFromBuffer.argtypes = [
                ctypes.c_void_p, ctypes.c_size_t,
                ctypes.c_void_p,
                ctypes.POINTER(ctypes.c_size_t), ctypes.c_uint,
            ]
            lib.ZDICT_isError.restype = ctypes.c_uint
            lib.ZDICT_isError.argtypes = [ctypes.c_size_t]
            lib.ZDICT_getDictID.restype = ctypes.c_uint
            lib.ZDICT_getDictID.argtypes = [ctypes.c_void_p, ctypes.c_size_t]
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
                self.dctx_reuses += 1
                return self._dpool.pop()
            self.dctx_creates += 1
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


def cctx_acquire() -> int:
    """Take a compression context out of the pool for exclusive, pinned
    use (one per compress worker); return it with :func:`cctx_release`."""
    if _API is None:
        raise ZstdError("system libzstd not available")
    return _API.acquire()


def cctx_release(ctx: int) -> None:
    if _API is not None:
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


def dict_support() -> bool:
    """True when the bound libzstd exposes the dictionary arms this
    module needs (ZDICT training + CDict/DDict digested handles)."""
    return _API is not None and _API.has_dict and _API.has_zdict and _API.has_dctx


def train_dict(samples: "list[bytes]", capacity_bytes: int) -> bytes:
    """ZDICT_trainFromBuffer over concatenated samples -> dictionary bytes.

    Raises :class:`ZstdError` when training fails (too few / too uniform
    samples: callers fall back to untrained compression)."""
    if not dict_support():
        raise ZstdError("system libzstd lacks ZDICT support")
    if not samples:
        raise ZstdError("cannot train a dictionary from zero samples")
    joined = np.frombuffer(b"".join(samples), dtype=np.uint8)
    sizes = (ctypes.c_size_t * len(samples))(*[len(s) for s in samples])
    cap = max(1024, int(capacity_bytes))
    out = np.empty(cap, dtype=np.uint8)
    w = _API.lib.ZDICT_trainFromBuffer(out.ctypes.data, cap, joined.ctypes.data, sizes, len(samples))
    if _API.lib.ZDICT_isError(w):
        raise ZstdError(f"ZDICT training failed over {len(samples)} samples ({joined.size} bytes)")
    return out[:w].tobytes()


def dict_id_of(dict_bytes: bytes) -> int:
    """The dictionary's embedded ZDICT id (0 = not a ZDICT dictionary)."""
    if _API is None or not _API.has_zdict:
        raise ZstdError("system libzstd lacks ZDICT support")
    arr = np.frombuffer(dict_bytes, dtype=np.uint8)
    return int(_API.lib.ZDICT_getDictID(arr.ctypes.data, arr.size))


class CDict:
    """A digested compression dictionary at one level: the dictionary is
    pre-processed ONCE, so per-chunk dict compression pays no dict load."""

    def __init__(self, dict_bytes: bytes, level: int = LEVEL):
        if not dict_support():
            raise ZstdError("system libzstd lacks dictionary support")
        self._keep = np.frombuffer(dict_bytes, dtype=np.uint8)  # pin memory
        self.level = level
        self.handle = _API.lib.ZSTD_createCDict(self._keep.ctypes.data, self._keep.size, level)
        if not self.handle:
            raise ZstdError("ZSTD_createCDict failed")
        self._fin = weakref.finalize(self, _API.lib.ZSTD_freeCDict, self.handle)


class DDict:
    """A digested decompression dictionary (level-independent)."""

    def __init__(self, dict_bytes: bytes):
        if not dict_support():
            raise ZstdError("system libzstd lacks dictionary support")
        self._keep = np.frombuffer(dict_bytes, dtype=np.uint8)
        self.handle = _API.lib.ZSTD_createDDict(self._keep.ctypes.data, self._keep.size)
        if not self.handle:
            raise ZstdError("ZSTD_createDDict failed")
        self._fin = weakref.finalize(self, _API.lib.ZSTD_freeDDict, self.handle)


def compress_with_cdict(ctx: int, data: bytes | memoryview, cdict: CDict) -> bytes:
    """One dict-trained zstd frame on a caller-owned CCtx. The frame
    header carries the dictionary id, so decoding without the dictionary
    fails instead of producing garbage."""
    src = np.frombuffer(data, dtype=np.uint8)
    n = src.size
    cap = _API.lib.ZSTD_compressBound(n)
    buf = np.empty(cap, dtype=np.uint8)
    w = _API.lib.ZSTD_compress_usingCDict(ctx, buf.ctypes.data, cap, src.ctypes.data, n, cdict.handle)
    if _API.lib.ZSTD_isError(w):
        raise ZstdError(f"zstd dict compress failed for {n}-byte input")
    return buf[:w].tobytes()


def dctx_available() -> bool:
    return _API is not None and _API.has_dctx


def dctx_stats() -> dict:
    """Pool accounting for the decompress path ({'reuses', 'creates'})."""
    if _API is None:
        return {"reuses": 0, "creates": 0}
    with _API._lock:
        return {"reuses": _API.dctx_reuses, "creates": _API.dctx_creates}


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


def decompress_with_ddict(data: bytes | memoryview, ddict: DDict, max_output_size: int = 0) -> bytes:
    """One dict-trained zstd frame -> bytes (pooled DCtx + digested
    DDict). Raises when the frame needs a different dictionary."""
    if not dict_support():
        raise ZstdError("system libzstd lacks dictionary support")
    src = np.frombuffer(data, dtype=np.uint8)
    n = src.size
    if n == 0:
        raise ZstdError("empty zstd frame")
    cap = _frame_capacity(src, n, max_output_size)
    buf = np.empty(cap, dtype=np.uint8)
    ctx = _API.acquire_d()
    try:
        w = _API.lib.ZSTD_decompress_usingDDict(ctx, buf.ctypes.data, cap, src.ctypes.data, n, ddict.handle)
    finally:
        _API.release_d(ctx)
    if _API.lib.ZSTD_isError(w):
        raise ZstdError(f"zstd dict decompress failed for {n}-byte input (wrong or missing dictionary?)")
    return buf[:w].tobytes()


# ---------------------------------------------------------------------------
# Frame walk and streaming decode (the OCIRef zstd layers, converter/zstd_ref.py)
# ---------------------------------------------------------------------------

# Skippable-frame magic range: 0x184D2A50 .. 0x184D2A5F (little-endian on
# the wire), checked by hand.
_SKIPPABLE_LO = 0x184D2A50
_SKIPPABLE_HI = 0x184D2A5F


def frames_available() -> bool:
    """True when the bound libzstd exposes the frame-walk and streaming
    surface (findFrameCompressedSize / decompressStream)."""
    return _API is not None and _API.has_frames and _API.has_dctx


def is_skippable_frame(data: bytes | memoryview, offset: int = 0) -> bool:
    """Skippable-frame probe on the 4-byte magic at ``offset``."""
    head = bytes(data[offset : offset + 4])
    if len(head) < 4:
        return False
    return _SKIPPABLE_LO <= int.from_bytes(head, "little") <= _SKIPPABLE_HI


def find_frame_compressed_size(data: bytes | memoryview, offset: int = 0) -> int:
    """Compressed size of the frame starting at ``offset`` (header, blocks
    and checksum; a skippable frame's full size) without decoding it."""
    if not frames_available():
        raise ZstdError("system libzstd lacks the frame surface")
    src = np.frombuffer(data, dtype=np.uint8)
    if not 0 <= offset < src.size:
        raise ZstdError(f"frame offset {offset} outside {src.size}-byte blob")
    w = _API.lib.ZSTD_findFrameCompressedSize(src.ctypes.data + offset, src.size - offset)
    if _API.lib.ZSTD_isError(w):
        raise ZstdError(f"not a complete zstd frame at offset {offset}")
    return int(w)


def frame_content_size(data: bytes | memoryview, offset: int = 0):
    """Declared decompressed size of the frame at ``offset``, or ``None``
    when the header omits it (skippable frames report 0). Raises on a
    malformed header."""
    if _API is None or not _API.has_dctx:
        raise ZstdError("system libzstd not available")
    src = np.frombuffer(data, dtype=np.uint8)
    if not 0 <= offset < src.size:
        raise ZstdError(f"frame offset {offset} outside {src.size}-byte blob")
    size = _API.lib.ZSTD_getFrameContentSize(src.ctypes.data + offset, src.size - offset)
    if size == _CONTENTSIZE_ERROR:
        raise ZstdError(f"not a valid zstd frame at offset {offset}")
    if size == _CONTENTSIZE_UNKNOWN:
        return None
    return int(size)


def stream_decompress(data: bytes | memoryview, max_output_size: int = 0) -> bytes:
    """Streaming decode of one or more concatenated frames (skippable
    frames skipped) on a pooled context: the decode for frames whose
    header omits the content size."""
    if not frames_available():
        raise ZstdError("system libzstd lacks the frame surface")
    src = np.frombuffer(data, dtype=np.uint8)
    n = src.size
    if n == 0:
        return b""
    ctx = _API.acquire_d()
    out = bytearray()
    step = 1 << 17
    chunk = np.empty(step, dtype=np.uint8)
    try:
        w = _API.lib.ZSTD_initDStream(ctx)
        if _API.lib.ZSTD_isError(w):
            raise ZstdError("ZSTD_initDStream failed")
        ib = _InBuffer(src.ctypes.data, n, 0)
        while ib.pos < ib.size:
            ob = _OutBuffer(chunk.ctypes.data, step, 0)
            w = _API.lib.ZSTD_decompressStream(ctx, ctypes.byref(ob), ctypes.byref(ib))
            if _API.lib.ZSTD_isError(w):
                raise ZstdError(f"zstd stream decode failed at input byte {ib.pos}")
            out += chunk[: ob.pos].tobytes()
            if max_output_size and len(out) > max_output_size:
                raise ZstdError(
                    f"decompressed stream exceeds max_output_size {max_output_size}"
                )
            if w == 0 and ib.pos >= ib.size:
                break
            if ob.pos == 0 and ib.pos >= ib.size and w != 0:
                raise ZstdError("truncated zstd frame (stream ended early)")
        if w != 0:
            raise ZstdError("truncated zstd frame (stream ended early)")
    except BaseException:
        # A context abandoned mid-frame must not rejoin the pool.
        _API.lib.ZSTD_freeDCtx(ctx)
        ctx = 0
        raise
    finally:
        _API.release_d(ctx)
    return bytes(out)


class StreamDecoder:
    """A held streaming decode cursor for sequential zstd reads.

    A ZSTD_DCtx cannot be copied as zlib's ``decompressobj`` can, so the
    sequential reader (converter/zstd_ref.py) keeps one forward cursor per
    blob: ``feed`` the next compressed bytes, get the decompressed bytes
    they complete; ``reset`` rewinds to stream start. The context comes
    from the pool and rejoins it on ``close`` after a clean re-init; a
    decode error frees it instead.
    """

    def __init__(self):
        if not frames_available():
            raise ZstdError("system libzstd lacks the frame surface")
        self._ctx = _API.acquire_d()
        self._init()

    def _init(self) -> None:
        w = _API.lib.ZSTD_initDStream(self._ctx)
        if _API.lib.ZSTD_isError(w):
            _API.lib.ZSTD_freeDCtx(self._ctx)
            self._ctx = 0
            raise ZstdError("ZSTD_initDStream failed")

    def reset(self) -> None:
        if not self._ctx:
            raise ZstdError("stream decoder is closed")
        self._init()

    def feed(self, data: bytes | memoryview) -> bytes:
        """Decode ``data`` (the next compressed bytes in stream order) and
        return every decompressed byte it completes."""
        if not self._ctx:
            raise ZstdError("stream decoder is closed")
        src = np.frombuffer(data, dtype=np.uint8)
        n = src.size
        if n == 0:
            return b""
        out = bytearray()
        step = 1 << 17
        chunk = np.empty(step, dtype=np.uint8)
        ib = _InBuffer(src.ctypes.data, n, 0)
        while True:
            ob = _OutBuffer(chunk.ctypes.data, step, 0)
            w = _API.lib.ZSTD_decompressStream(self._ctx, ctypes.byref(ob), ctypes.byref(ib))
            if _API.lib.ZSTD_isError(w):
                _API.lib.ZSTD_freeDCtx(self._ctx)
                self._ctx = 0
                raise ZstdError(f"zstd stream decode failed at input byte {ib.pos}")
            out += chunk[: ob.pos].tobytes()
            if ib.pos >= ib.size and ob.pos < step:
                break
        return bytes(out)

    def close(self) -> None:
        ctx, self._ctx = self._ctx, 0
        if not ctx:
            return
        # Re-init before rejoining the pool so no borrower inherits
        # mid-frame state; a failed init frees instead.
        w = _API.lib.ZSTD_initDStream(ctx)
        if _API.lib.ZSTD_isError(w):
            _API.lib.ZSTD_freeDCtx(ctx)
            return
        _API.release_d(ctx)

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
