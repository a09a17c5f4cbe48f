"""zran: random access into foreign gzip streams via the SYSTEM libz.

CPython's ``zlib`` cannot build a *persistable* gzip index: resuming an
inflate mid-stream needs the bit-level offset of the deflate block
boundary (``inflatePrime``) and the preceding 32 KiB of output
(``inflateSetDictionary``), neither of which the module exposes — which
is why ``converter/zran.py``'s ``GzipStreamReader`` keeps live
``decompressobj.copy()`` checkpoints that die with the process. This
module binds the system ``libz`` with ctypes (the same system-library
discipline as utils/zstd.py) and implements the classic zran scheme
(madler/zlib examples/zran.c, the technique behind AWS SOCI's zTOC):

- **build**: one sequential inflate with ``Z_BLOCK`` stops at every
  deflate block boundary; whenever ``stride`` decompressed bytes have
  passed since the last checkpoint, record ``(uout, cin, bits, window)``
  — output offset, input byte offset, unconsumed bits of the byte at
  ``cin-1``, and the trailing 32 KiB of output;
- **extract**: raw-init (``wbits=-15``), ``inflatePrime`` the partial
  byte, ``inflateSetDictionary`` the window, then inflate forward from
  ``cin`` — so a read at decompressed offset O costs O(stride) inflate
  work instead of O(O), from a *persisted* checkpoint in any process.

Multi-member gzip (pigz, eStargz, concatenated members) is handled in
both directions: the build pass restarts header parsing at member
boundaries and records member-start checkpoints as ``fresh`` (no window,
``wbits=47`` resume), and extraction re-inits across ``Z_STREAM_END``.

``available()`` gates everything: without a loadable libz the soci
backend falls back to the in-process ``GzipStreamReader`` (correct,
sequential-cost cold reads — documented degraded mode, never wrong
bytes).
"""

from __future__ import annotations

import ctypes
import ctypes.util
from dataclasses import dataclass
from typing import Callable, Optional

from nydus_snapshotter_tpu_torch.analysis import runtime as _an
from nydus_snapshotter_tpu_torch.utils import errdefs

WINDOW_SIZE = 32768  # deflate's maximum back-reference distance
DEFAULT_STRIDE = 1 << 20

_Z_OK = 0
_Z_STREAM_END = 1
_Z_BUF_ERROR = -5
_Z_BLOCK = 5

_IN_STEP = 1 << 20
_OUT_STEP = 256 << 10


class ZranError(errdefs.NydusError):
    pass


class _ZStream(ctypes.Structure):
    # zlib.h z_stream — layout stable since zlib 1.0.
    _fields_ = [
        ("next_in", ctypes.POINTER(ctypes.c_ubyte)),
        ("avail_in", ctypes.c_uint),
        ("total_in", ctypes.c_ulong),
        ("next_out", ctypes.POINTER(ctypes.c_ubyte)),
        ("avail_out", ctypes.c_uint),
        ("total_out", ctypes.c_ulong),
        ("msg", ctypes.c_char_p),
        ("state", ctypes.c_void_p),
        ("zalloc", ctypes.c_void_p),
        ("zfree", ctypes.c_void_p),
        ("opaque", ctypes.c_void_p),
        ("data_type", ctypes.c_int),
        ("adler", ctypes.c_ulong),
        ("reserved", ctypes.c_ulong),
    ]


class _Api:
    def __init__(self, lib: ctypes.CDLL):
        lib.zlibVersion.restype = ctypes.c_char_p
        self.version = lib.zlibVersion()
        for name in ("inflateInit2_", "inflate", "inflateEnd",
                     "inflatePrime", "inflateSetDictionary", "inflateReset2"):
            getattr(lib, name).restype = ctypes.c_int
        self.lib = lib

    def init(self, strm: _ZStream, wbits: int) -> None:
        rc = self.lib.inflateInit2_(
            ctypes.byref(strm), wbits, self.version, ctypes.sizeof(_ZStream)
        )
        if rc != _Z_OK:
            raise ZranError(f"inflateInit2({wbits}) -> {rc}")

    def reset(self, strm: _ZStream, wbits: int) -> None:
        rc = self.lib.inflateReset2(ctypes.byref(strm), wbits)
        if rc != _Z_OK:
            raise ZranError(f"inflateReset2({wbits}) -> {rc}")

    def prime(self, strm: _ZStream, bits: int, value: int) -> None:
        rc = self.lib.inflatePrime(ctypes.byref(strm), bits, value)
        if rc != _Z_OK:
            raise ZranError(f"inflatePrime -> {rc}")

    def set_dictionary(self, strm: _ZStream, window: bytes) -> None:
        buf = (ctypes.c_ubyte * len(window)).from_buffer_copy(window)
        rc = self.lib.inflateSetDictionary(ctypes.byref(strm), buf, len(window))
        if rc != _Z_OK:
            raise ZranError(f"inflateSetDictionary -> {rc}")

    def end(self, strm: _ZStream) -> None:
        self.lib.inflateEnd(ctypes.byref(strm))


_api: Optional[_Api] = None
_api_failed = False
_api_lock = _an.make_lock("soci.zran.api")

_LIB_CANDIDATES = ("libz.so.1", "libz.so", "libz.dylib")


def _load_api() -> Optional[_Api]:
    global _api, _api_failed
    with _api_lock:
        if _api is not None or _api_failed:
            return _api
        names = list(_LIB_CANDIDATES)
        found = ctypes.util.find_library("z")
        if found:
            names.insert(0, found)
        for name in names:
            try:
                lib = ctypes.CDLL(name)
                # inflatePrime landed in zlib 1.2.2.4; probe for it so a
                # prehistoric libz degrades instead of AttributeError-ing
                # mid-read.
                lib.inflatePrime
                _api = _Api(lib)
                return _api
            except (OSError, AttributeError):
                continue
        _api_failed = True
        return None


def available() -> bool:
    """Whether checkpointed random access is usable on this host."""
    return _load_api() is not None


@dataclass
class Checkpoint:
    """One inflate resume point.

    ``uout``/``cin`` are the decompressed/compressed offsets; ``bits`` is
    how many bits of the byte at ``cin - 1`` belong to the next block;
    ``window`` is the preceding (up to) 32 KiB of decompressed output.
    ``fresh`` marks a gzip member start: resume parses a fresh header
    (``wbits=47``) and needs no prime/window.
    """

    uout: int
    cin: int
    bits: int
    window: bytes
    fresh: bool = False


def build(
    raw: bytes, stride: int = DEFAULT_STRIDE
) -> tuple[list[Checkpoint], bytes]:
    """One sequential inflate of a whole gzip blob, capturing resume
    checkpoints roughly every ``stride`` decompressed bytes.

    Returns ``(checkpoints, decompressed bytes)`` — the build pass IS a
    full decompression, so index-on-first-pull reuses its output for the
    bootstrap build instead of inflating twice. The implicit stream-start
    checkpoint is not stored (extraction from offset 0 just inits fresh).
    """
    api = _load_api()
    if api is None:
        raise ZranError("system libz with inflatePrime is not available")
    stride = max(WINDOW_SIZE, int(stride))
    strm = _ZStream()
    api.init(strm, 47)
    inbuf = (ctypes.c_ubyte * len(raw)).from_buffer_copy(raw)
    strm.next_in = ctypes.cast(inbuf, ctypes.POINTER(ctypes.c_ubyte))
    strm.avail_in = len(raw)
    outchunk = (ctypes.c_ubyte * _OUT_STEP)()
    out = bytearray()
    points: list[Checkpoint] = []
    last = 0
    try:
        while True:
            strm.next_out = ctypes.cast(outchunk, ctypes.POINTER(ctypes.c_ubyte))
            strm.avail_out = _OUT_STEP
            # Z_BLOCK (stop at every deflate block boundary) costs ~5x
            # the bare inflate rate in call overhead; only pay it while
            # hunting the next checkpointable boundary — plain inflate
            # covers the stretch between checkpoints at full speed.
            flush = _Z_BLOCK if len(out) - last >= stride else 0
            rc = api.lib.inflate(ctypes.byref(strm), flush)
            produced = _OUT_STEP - strm.avail_out
            if produced:
                out += ctypes.string_at(outchunk, produced)
            if rc == _Z_STREAM_END:
                if strm.avail_in == 0:
                    break
                # Multi-member blob: restart header parsing; the member
                # boundary itself is a natural (windowless) checkpoint.
                api.reset(strm, 47)
                if len(out) - last >= stride:
                    points.append(
                        Checkpoint(len(out), len(raw) - strm.avail_in, 0, b"",
                                   fresh=True)
                    )
                    last = len(out)
                continue
            if rc not in (_Z_OK, _Z_BUF_ERROR):
                msg = strm.msg.decode() if strm.msg else f"rc={rc}"
                raise ZranError(f"corrupt gzip stream at byte "
                                f"{len(raw) - strm.avail_in}: {msg}")
            if rc == _Z_BUF_ERROR and strm.avail_in == 0 and produced == 0:
                raise ZranError("gzip stream truncated")
            # Block boundary (data_type bit 7, not at end of stream):
            # the only place bit-exact resume is possible.
            if (strm.data_type & 0xC0) == 0x80 and len(out) - last >= stride:
                points.append(
                    Checkpoint(
                        len(out),
                        len(raw) - strm.avail_in,
                        strm.data_type & 7,
                        bytes(out[-WINDOW_SIZE:]),
                    )
                )
                last = len(out)
    finally:
        api.end(strm)
    return points, bytes(out)


def extract(
    read_comp: Callable[[int, int], bytes],
    csize: int,
    checkpoint: Optional[Checkpoint],
    offset: int,
    size: int,
    comp_end: Optional[int] = None,
) -> bytes:
    """Decompressed ``[offset, offset + size)`` resumed at ``checkpoint``
    (None = stream start). ``read_comp(pos, n)`` supplies compressed
    bytes on demand — extraction pulls only what inflate consumes, in
    ``_IN_STEP`` steps, never past ``comp_end`` (the resolve geometry's
    upper bound, default: the whole blob).

    Each call owns a private z_stream: concurrent extracts are safe.
    """
    if size <= 0:
        return b""
    api = _load_api()
    if api is None:
        raise ZranError("system libz with inflatePrime is not available")
    if comp_end is None or comp_end > csize:
        comp_end = csize
    strm = _ZStream()
    raw_mode = checkpoint is not None and not checkpoint.fresh
    if not raw_mode:
        api.init(strm, 47)
        upos = 0 if checkpoint is None else checkpoint.uout
        cpos = 0 if checkpoint is None else checkpoint.cin
    else:
        api.init(strm, -15)
        upos = checkpoint.uout
        cpos = checkpoint.cin
        try:
            if checkpoint.bits:
                ch = read_comp(checkpoint.cin - 1, 1)
                if len(ch) != 1:
                    raise ZranError("short read priming checkpoint byte")
                api.prime(strm, checkpoint.bits, ch[0] >> (8 - checkpoint.bits))
            if checkpoint.window:
                api.set_dictionary(strm, checkpoint.window)
        except ZranError:
            api.end(strm)
            raise
    out = bytearray()
    skip = offset - upos
    if skip < 0:
        api.end(strm)
        raise ZranError(f"checkpoint at {upos} is past read offset {offset}")
    buf = (ctypes.c_ubyte * _OUT_STEP)()
    pending = b""
    skip_in = 0  # gzip member trailer bytes a raw-mode inflate leaves behind
    try:
        while len(out) < size:
            if not pending:
                if cpos >= comp_end:
                    break
                pending = read_comp(cpos, min(_IN_STEP, comp_end - cpos))
                if not pending:
                    break
                cpos += len(pending)
            if skip_in:
                drop = min(skip_in, len(pending))
                pending = pending[drop:]
                skip_in -= drop
                continue
            inbuf = (ctypes.c_ubyte * len(pending)).from_buffer_copy(pending)
            strm.next_in = ctypes.cast(inbuf, ctypes.POINTER(ctypes.c_ubyte))
            strm.avail_in = len(pending)
            while len(out) < size:
                strm.next_out = ctypes.cast(buf, ctypes.POINTER(ctypes.c_ubyte))
                strm.avail_out = _OUT_STEP
                rc = api.lib.inflate(ctypes.byref(strm), 0)
                produced = _OUT_STEP - strm.avail_out
                if produced:
                    if skip >= produced:
                        skip -= produced
                    else:
                        want = size - len(out)
                        out += ctypes.string_at(
                            ctypes.addressof(buf) + skip,
                            min(produced - skip, want),
                        )
                        skip = 0
                if rc == _Z_STREAM_END:
                    # Member boundary. A raw (-15) resume stops at the
                    # final deflate block and never consumes the 8-byte
                    # gzip trailer (CRC32 + ISIZE) — drop it before the
                    # next member's header parse; a 47-mode inflate ate
                    # it already.
                    pending = pending[len(pending) - strm.avail_in :]
                    if raw_mode:
                        skip_in = 8
                        raw_mode = False
                    api.reset(strm, 47)
                    break
                if rc not in (_Z_OK, _Z_BUF_ERROR):
                    msg = strm.msg.decode() if strm.msg else f"rc={rc}"
                    raise ZranError(
                        f"inflate failed resuming at {upos}: {msg}"
                    )
                if strm.avail_in == 0:
                    pending = b""
                    break
                if rc == _Z_BUF_ERROR and produced == 0:
                    pending = b""
                    break
    finally:
        api.end(strm)
    if len(out) != size:
        raise ZranError(
            f"range [{offset}, +{size}) yielded {len(out)} bytes "
            f"(checkpoint at {upos}, compressed [{cpos}, {comp_end}))"
        )
    return bytes(out)
