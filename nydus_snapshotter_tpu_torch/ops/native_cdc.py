"""ctypes bridge to the port's copy of the native chunk engine.

``native/chunk_engine/`` holds the port's own copy of the C++ chunk engine
(``chunk_engine.cpp``, ``sha256.h``, ``blake3.h``). ``g++`` compiles it at
first use into ``build/`` (git-ignored), with the reference Makefile's
flags, to a library named by a hash of the sources and flags: a fresh
checkout builds on first call and an edited source never loads a stale
library. The compile writes to a temporary name and renames into place,
under a file lock so that concurrent processes build once. A failed build
raises :class:`BuildError` with the compiler's stderr; nothing falls back
to numpy on its own. :func:`load` binds every ``ntpu_*`` entry with the
reference's argtypes, so an ``*_available()`` here is a symbol check on
the port's own library, never a way to hide a failed build.

The arms, each with the reference's return conventions
(nydus_snapshotter_tpu/ops/native_cdc.py):

- chunkers: :func:`chunk_data_native` (sequential gear scan),
  :func:`chunk_data_vec_native` (striped table scan), :func:`chunk_data_best`
  (the ``hybrid`` backend's dispatch between them), :func:`gear_hashes_native`;
- fused chunk + digest: :func:`chunk_digest_native` (one stream) and
  :func:`chunk_digest_multi` (many file extents in one call), SHA-256
  (SHA-NI when the CPU has it) or BLAKE3;
- batch digests: :func:`sha256_many_native`, :func:`blake3_many_native`;
- sections and layers: :func:`pack_section` (compress, append and hash a
  blob data section over ``n_threads`` workers), :func:`pack_files` (chunk,
  digest, dedup and assemble a whole layer), :func:`encode_batch_native`
  (per-chunk zstd frames);
- chunk-dict tables: ``ntpu_dict_build``/``insert``/``upsert``/``probe``,
  which ``parallel/sharded_dict`` grows, persists and host-probes with.

The SIMD arms are chosen at run time; ``NTPU_GEAR_FORCE_ISA``,
``NTPU_CDC_FORCE_ISA`` and ``NTPU_B3_FORCE_ISA`` pin them, read once per
process inside the library (:func:`gear_active_isa`, :func:`cdc_active_isa`
and :func:`b3_active_isa` report the arm that runs). Not ported from the
reference: its config plane (:func:`vectorized_mode` reads
``NTPU_COMPRESS_VECTORIZED`` only) and its failpoints (the ``chunk.vec``
failpoint of the vectorized scan).

Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

from nydus_snapshotter_tpu_torch.ops import cdc, gear

PKG_DIR = Path(__file__).resolve().parent.parent
SRC_DIR = PKG_DIR / "native" / "chunk_engine"
BUILD_DIR = PKG_DIR / "build"
SOURCES = ("chunk_engine.cpp", "sha256.h", "blake3.h")
# The reference's native/Makefile: CXXFLAGS, then the library's own flags.
CXX_FLAGS = ("-O2", "-Wall", "-Wextra", "-std=c++17", "-O3", "-shared", "-fPIC", "-pthread")
LIBS = ("-ldl",)

_lib_lock = threading.Lock()
_lib: "ctypes.CDLL | None" = None


class BuildError(RuntimeError):
    """g++ refused the chunk engine (message carries its stderr)."""


def library_path() -> Path:
    h = hashlib.sha256()
    for name in SOURCES:
        h.update((SRC_DIR / name).read_bytes())
    h.update("\0".join(CXX_FLAGS + LIBS).encode())
    return BUILD_DIR / f"libchunk_engine-{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the engine unless its library exists -> its path."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / ".chunk_engine.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)  # released when the process dies
        if out.exists():  # another process built it while we waited
            return out
        tmp = out.with_name(f".{out.stem}.{os.getpid()}.tmp.so")
        try:
            proc = subprocess.run(
                [os.environ.get("CXX", "g++"), *CXX_FLAGS, "-o", str(tmp),
                 str(SRC_DIR / SOURCES[0]), *LIBS],
                capture_output=True,
                text=True,
            )
            if proc.returncode != 0:
                raise BuildError(f"g++ failed on {SOURCES[0]}:\n{proc.stderr}")
            os.replace(tmp, out)
        finally:
            tmp.unlink(missing_ok=True)
    return out


def load() -> ctypes.CDLL:
    """The engine library, built on first use per checkout and bound with
    the reference's argtypes."""
    global _lib
    with _lib_lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(str(build()))
        i64, u32, vp = ctypes.c_int64, ctypes.c_uint32, ctypes.c_void_p
        cdc_args = [
            vp, i64,  # data, n
            vp,  # table
            u32, u32,  # masks
            i64, i64, i64,  # min/normal/max
            vp, i64,  # cuts_out, cap
        ]
        signatures = {
            "ntpu_cdc_chunk": (i64, cdc_args),
            "ntpu_cdc_chunk_vec": (i64, cdc_args),
            "ntpu_cdc_active_isa": (i64, []),
            "ntpu_gear_active_isa": (i64, []),
            "ntpu_b3_active_isa": (i64, []),
            "ntpu_gear_hashes": (None, [vp, i64, vp, vp]),  # data, n, table, out
            "ntpu_encode_batch": (i64, [
                vp, vp, i64,  # data, extents, m
                i64, i64,  # level, n_threads
                vp, i64,  # out, out_cap
                vp,  # comp_extents
                vp, i64,  # digests_out (nullable), algo
            ]),
            "ntpu_chunk_digest": (i64, [
                vp, i64,  # data, n
                u32, u32,  # masks
                i64, i64, i64,  # min/normal/max
                vp, i64,  # cuts_out, cap
                vp,  # digests_out (nullable)
                i64,  # algo (0 = sha256, 1 = blake3)
            ]),
            "ntpu_sha256_many": (None, [vp, vp, i64, vp]),  # data, extents, m, out
            "ntpu_blake3_many": (None, [vp, vp, i64, vp]),
            "ntpu_chunk_digest_multi": (i64, [
                vp, vp, i64,  # data, extents, m
                u32, u32,  # masks
                i64, i64, i64,  # min/normal/max
                vp,  # file_ncuts
                vp, i64,  # cuts_out, cap
                vp,  # digests_out
                i64,  # algo
            ]),
            "ntpu_pack_files": (i64, [
                vp, i64,  # data, n
                vp, i64,  # extents, m
                u32, u32,  # masks
                i64, i64, i64,  # min/normal/max
                i64, i64, i64,  # comp, accel, threads
                vp,  # file_nchunks
                vp, vp, vp,  # digests, sizes, uniq
                i64,  # refs_cap
                vp,  # comp_extents
                vp, i64,  # out_blob, out_cap
                vp,  # blob_digest32
                vp, vp,  # n_uniq_out, blob_size_out
                i64,  # algo
            ]),
            "ntpu_pack_section": (i64, [
                vp, vp,  # src0, src1
                vp, i64,  # extents (i64 triples), m
                i64, i64, i64,  # comp, accel, threads
                vp, i64,  # out, out_cap
                vp, vp,  # comp_extents, blob_digest32
            ]),
            "ntpu_dict_build": (i64, [
                vp, i64,  # digests, n
                i64, i64, i64,  # shards, cap, max_probe
                vp, vp,  # keys, values
            ]),
            "ntpu_dict_insert": (i64, [
                vp, vp, i64,  # digests, vals, k
                i64, i64, i64,  # shards, cap, max_probe
                vp, vp,  # keys, values
            ]),
            "ntpu_dict_upsert": (i64, [
                vp, i64, i64,  # digests, n, base
                i64, i64, i64,  # shards, cap, max_probe
                vp, vp, vp,  # keys, values, out
            ]),
            "ntpu_dict_probe": (None, [
                vp, i64,  # queries, m
                vp, vp,  # keys, values
                i64, i64, i64,  # shards, cap, max_probe
                vp,  # out
            ]),
        }
        for name, (restype, argtypes) in signatures.items():
            fn = getattr(lib, name)
            fn.restype = restype
            fn.argtypes = argtypes
        _lib = lib
        return lib


def _check(name: str, a: np.ndarray, dtype) -> None:
    if a.dtype != dtype or not a.flags.c_contiguous:
        raise ValueError(f"{name} must be C-contiguous {np.dtype(dtype).name}, got {a.dtype}")


def _has(name: str) -> bool:
    return hasattr(load(), name)


def _u8(data) -> np.ndarray:
    if isinstance(data, (bytes, bytearray)):
        return np.frombuffer(data, dtype=np.uint8)
    return np.ascontiguousarray(data, dtype=np.uint8)


def available() -> bool:
    """The engine library loads (it builds first if need be; a failed
    build raises :class:`BuildError`)."""
    return load() is not None


def gear_active_isa() -> int:
    """The gear-bitmap arm of the fused chunk+digest scan on this host and
    environment: 3 = AVX-512, 2 = AVX2, 1 = scalar."""
    return int(load().ntpu_gear_active_isa())


def cdc_active_isa() -> int:
    """The table-scan arm :func:`chunk_data_vec_native` dispatches to:
    2 = AVX2 striped, 1 = portable scalar. Tests assert on this, not on
    ``NTPU_CDC_FORCE_ISA``: forcing AVX2 on a host without it falls back
    to scalar."""
    return int(load().ntpu_cdc_active_isa())


def b3_active_isa() -> int:
    """The BLAKE3 leaf arm: 3 = AVX-512, 2 = AVX2, 1 = scalar."""
    return int(load().ntpu_b3_active_isa())


def forced_isa() -> str:
    """``NTPU_CDC_FORCE_ISA`` as the library sees it ("avx2", "scalar", or
    "" for host dispatch). The library reads it once per process, so a
    change mid-process has no effect: tests pin it in a child process."""
    return os.environ.get("NTPU_CDC_FORCE_ISA", "")


def _cuts(fn, data, params: cdc.CDCParams) -> np.ndarray:
    arr = _u8(data)
    if arr.size == 0:
        return np.asarray([], dtype=np.int64)
    table = np.ascontiguousarray(gear.gear_table())
    cap = arr.size // max(1, params.min_size) + 2
    cuts = np.empty(cap, dtype=np.int64)
    n = fn(
        arr.ctypes.data, arr.size, table.ctypes.data,
        np.uint32(params.mask_small), np.uint32(params.mask_large),
        params.min_size, params.normal_size, params.max_size,
        cuts.ctypes.data, cap,
    )
    if n < 0:
        raise RuntimeError("native chunker failed (cut buffer overflow or OOM)")
    return cuts[:n].copy()


def chunk_data_native(data, params: cdc.CDCParams) -> np.ndarray:
    """Cut offsets (exclusive ends) by the sequential native gear scan,
    cut-identical to ops/cdc.chunk_data_np."""
    return _cuts(load().ntpu_cdc_chunk, data, params)


def vectorized_available() -> bool:
    """The striped table-scan arm (``ntpu_cdc_chunk_vec``)."""
    return _has("ntpu_cdc_chunk_vec")


def chunk_data_vec_native(data, params: cdc.CDCParams) -> np.ndarray:
    """Cut offsets by the vectorized table scan: whole-stream candidate
    bitmaps resolved with the shared region discipline, cut-identical to
    :func:`chunk_data_native` and cdc.chunk_sequential_reference."""
    return _cuts(load().ntpu_cdc_chunk_vec, data, params)


def vectorized_mode() -> str:
    """``NTPU_COMPRESS_VECTORIZED``: "auto" (the vectorized scan when
    built, the default), "on" (require it) or "off" (always sequential)."""
    v = os.environ.get("NTPU_COMPRESS_VECTORIZED", "").strip().lower()
    return v if v in ("auto", "on", "off") else "auto"


def chunk_data_best(data, params: cdc.CDCParams) -> np.ndarray:
    """The ``hybrid`` backend's scan: the vectorized table scan when
    :func:`vectorized_mode` allows it and the arm is built, else the
    sequential chunker; cut-identical either way. "on" without the arm
    raises."""
    mode = vectorized_mode()
    if mode != "off" and vectorized_available():
        return chunk_data_vec_native(data, params)
    if mode == "on":
        raise RuntimeError("NTPU_COMPRESS_VECTORIZED=on but ntpu_cdc_chunk_vec is not available")
    return chunk_data_native(data, params)


def gear_hashes_native(data) -> np.ndarray:
    """The rolling gear hash at every position (uint32[n]), from a zero
    state: past the first 32 positions it equals ops/gear.gear_hashes_np
    (a test aid)."""
    arr = _u8(data)
    table = np.ascontiguousarray(gear.gear_table())
    out = np.empty(arr.size, dtype=np.uint32)
    load().ntpu_gear_hashes(arr.ctypes.data, arr.size, table.ctypes.data, out.ctypes.data)
    return out


def concat_extents(views) -> "tuple[np.ndarray, np.ndarray]":
    """Chunk views -> (one u8 buffer, i64[m, 2] (offset, size) extents):
    the input of the batch entries, at one copy per chunk."""
    ext = np.empty((len(views), 2), dtype=np.int64)
    buf = np.empty(sum(len(v) for v in views), dtype=np.uint8)
    off = 0
    for k, v in enumerate(views):
        a = np.frombuffer(v, dtype=np.uint8)
        buf[off : off + a.size] = a
        ext[k, 0], ext[k, 1] = off, a.size
        off += a.size
    return buf, ext


DIGEST_ALGO = {"sha256": 0, "blake3": 1}


def encode_batch_available() -> bool:
    """The batched per-chunk zstd arm, which needs the system libzstd."""
    from nydus_snapshotter_tpu_torch.utils import zstd as zstd_native

    return _has("ntpu_encode_batch") and zstd_native.available()


def encode_batch_native(
    data: np.ndarray,
    extents: np.ndarray,
    level: int,
    n_threads: int = 1,
    digester: "str | None" = None,
) -> "tuple[np.ndarray, np.ndarray, bytes] | None":
    """m independent zstd frames at ``level`` in one GIL-free call.

    ``extents``: i64[m, 2] (offset, size) into ``data``. Returns (the
    frames packed back to back, i64[m, 2] (offset, size) of each frame,
    the 32-byte digests of the uncompressed chunks when ``digester`` is
    set, else b""). Each frame equals utils/zstd.compress_with_ctx at the
    same level. None when the engine cannot dlopen the system libzstd.
    """
    lib = load()
    arr = np.ascontiguousarray(data, dtype=np.uint8)
    ext = np.ascontiguousarray(extents, dtype=np.int64)
    m = ext.shape[0]
    if m == 0:
        return np.empty(0, np.uint8), np.empty((0, 2), np.int64), b""
    cap = _comp_bound_total(int(ext[:, 1].sum()), m, 2)
    out = np.empty(max(cap, 1), dtype=np.uint8)
    comp = np.empty((m, 2), dtype=np.int64)
    digests = np.empty(m * 32, dtype=np.uint8) if digester is not None else None
    total = lib.ntpu_encode_batch(
        arr.ctypes.data, ext.ctypes.data, m,
        level, max(1, n_threads),
        out.ctypes.data, out.size,
        comp.ctypes.data,
        digests.ctypes.data if digests is not None else None,
        DIGEST_ALGO[digester] if digester is not None else 0,
    )
    if total == -2:
        return None  # no system libzstd: the caller's per-chunk loop
    if total < 0:
        raise RuntimeError("native batch encode failed (overflow or codec error)")
    return out[:total], comp, digests.tobytes() if digests is not None else b""


def chunk_digest_available() -> bool:
    """The fused single-pass chunk + digest arm (SIMD bitmaps, SHA-NI or
    BLAKE3 leaves)."""
    return _has("ntpu_chunk_digest")


def chunk_digest_native(
    data, params: cdc.CDCParams, want_digests: bool = True, digester: str = "sha256",
) -> tuple[np.ndarray, bytes]:
    """One native pass: cut offsets and each chunk's digest (32 bytes a
    chunk; b"" without ``want_digests``). Cuts equal
    :func:`chunk_data_native`'s; ``digester`` is "sha256" or "blake3"."""
    lib = load()
    arr = _u8(data)
    if arr.size == 0:
        return np.asarray([], dtype=np.int64), b""
    cap = arr.size // max(1, params.min_size) + 2
    cuts = np.empty(cap, dtype=np.int64)
    digests = np.empty(cap * 32, dtype=np.uint8) if want_digests else None
    n = lib.ntpu_chunk_digest(
        arr.ctypes.data, arr.size,
        np.uint32(params.mask_small), np.uint32(params.mask_large),
        params.min_size, params.normal_size, params.max_size,
        cuts.ctypes.data, cap,
        digests.ctypes.data if digests is not None else None,
        DIGEST_ALGO[digester],
    )
    if n < 0:
        raise RuntimeError("native fused chunker failed (cut overflow or OOM)")
    return cuts[:n].copy(), digests[: n * 32].tobytes() if digests is not None else b""


def chunk_digest_multi_available() -> bool:
    return _has("ntpu_chunk_digest_multi")


def chunk_digest_multi(
    data: np.ndarray, extents: np.ndarray, params: cdc.CDCParams, digester: str = "sha256",
) -> "tuple[np.ndarray, np.ndarray, bytes]":
    """Fused chunk + digest over m (offset, size) file extents in one call
    -> (i64[m] cuts per file, i64[total] file-relative cut ends in file
    order, 32 * total digest bytes), equal to per-file
    :func:`chunk_digest_native` calls."""
    lib = load()
    arr = np.ascontiguousarray(data, dtype=np.uint8)
    ext = np.ascontiguousarray(extents, dtype=np.int64)
    m = ext.shape[0]
    if m == 0:
        return np.zeros(0, np.int64), np.zeros(0, np.int64), b""
    cap = int((ext[:, 1] // max(1, params.min_size)).sum()) + 2 * m
    file_ncuts = np.empty(m, dtype=np.int64)
    cuts = np.empty(cap, dtype=np.int64)
    digests = np.empty(cap * 32, dtype=np.uint8)
    total = lib.ntpu_chunk_digest_multi(
        arr.ctypes.data, ext.ctypes.data, m,
        np.uint32(params.mask_small), np.uint32(params.mask_large),
        params.min_size, params.normal_size, params.max_size,
        file_ncuts.ctypes.data, cuts.ctypes.data, cap, digests.ctypes.data,
        DIGEST_ALGO[digester],
    )
    if total < 0:
        raise RuntimeError("native multi chunk+digest failed (overflow or OOM)")
    return file_ncuts, cuts[:total], digests[: total * 32].tobytes()


def _many(fn, data: np.ndarray, extents: np.ndarray) -> bytes:
    arr = np.ascontiguousarray(data, dtype=np.uint8)
    ext = np.ascontiguousarray(extents, dtype=np.int64)
    m = ext.shape[0] if ext.ndim == 2 else len(ext) // 2
    out = np.empty(m * 32, dtype=np.uint8)
    fn(arr.ctypes.data, ext.ctypes.data, m, out.ctypes.data)
    return out.tobytes()


def sha256_many_native(data: np.ndarray, extents: np.ndarray) -> bytes:
    """SHA-256 of m (offset, size) extents (i64[m, 2]) in one GIL-free
    call -> 32 * m digest bytes (SHA-NI when the CPU has it)."""
    return _many(load().ntpu_sha256_many, data, extents)


def blake3_many_available() -> bool:
    return _has("ntpu_blake3_many")


def blake3_many_native(data: np.ndarray, extents: np.ndarray) -> bytes:
    """BLAKE3 of m (offset, size) extents in one GIL-free call -> 32 * m
    digest bytes (the oracle is utils/blake3.py)."""
    return _many(load().ntpu_blake3_many, data, extents)


def _comp_bound_total(total_bytes: int, n_chunks: int, compressor: int) -> int:
    """Worst-case section size for ``n_chunks`` chunks of ``total_bytes``:
    it must dominate the engine's per-chunk bound (lz4: n + n/255 + 16;
    zstd: ZSTD_compressBound, over-provisioned as n/128 + 128 a chunk)."""
    if compressor == 1:
        return total_bytes + total_bytes // 255 + 16 * n_chunks
    if compressor == 2:
        return total_bytes + total_bytes // 128 + 128 * n_chunks
    return total_bytes


def pack_files_available() -> bool:
    """The whole-layer arm: chunk, digest, dedup, compress, assemble."""
    return _has("ntpu_pack_files")


def pack_files(
    data: np.ndarray,
    extents: np.ndarray,
    params: cdc.CDCParams,
    compressor: int,
    accel: int = 1,
    n_threads: int = 1,
    digester: str = "sha256",
):
    """One native pass over a layer's file extents: CDC cuts, chunk digests
    (``digester``), first-wins dedup, compression of each unique chunk,
    blob assembly and the blob's SHA-256. -> dict of ``file_nchunks``,
    ``digests``, ``chunk_sizes``, ``chunk_uniq``, ``uniq_sizes``,
    ``comp_extents``, ``blob`` (a numpy view) and ``blob_digest``; None when
    the engine cannot dlopen the compressor's system library."""
    lib = load()
    arr = np.ascontiguousarray(data, dtype=np.uint8)
    ext = np.ascontiguousarray(extents, dtype=np.int64)
    m = ext.shape[0]
    if m == 0:
        return {
            "file_nchunks": np.zeros(0, np.int64),
            "digests": b"",
            "chunk_sizes": np.zeros(0, np.int64),
            "chunk_uniq": np.zeros(0, np.int64),
            "uniq_sizes": np.zeros(0, np.int64),
            "comp_extents": np.zeros((0, 2), np.int64),
            "blob": np.zeros(0, np.uint8),
            "blob_digest": hashlib.sha256(b"").digest(),
        }
    sizes = ext[:, 1]
    refs_cap = int((sizes // max(1, params.min_size)).sum()) + 2 * m
    out_cap = _comp_bound_total(int(sizes.sum()), refs_cap, compressor)
    file_nchunks = np.empty(m, np.int64)
    digests = np.empty(refs_cap * 32, np.uint8)
    chunk_sizes = np.empty(refs_cap, np.int64)
    chunk_uniq = np.empty(refs_cap, np.int64)
    comp = np.empty((refs_cap, 2), np.int64)
    blob = np.empty(max(out_cap, 1), np.uint8)
    blob_digest = np.empty(32, np.uint8)
    n_uniq = np.zeros(1, np.int64)
    blob_size = np.zeros(1, np.int64)
    total = lib.ntpu_pack_files(
        arr.ctypes.data, arr.size,
        ext.ctypes.data, m,
        np.uint32(params.mask_small), np.uint32(params.mask_large),
        params.min_size, params.normal_size, params.max_size,
        compressor, accel, max(1, n_threads),
        file_nchunks.ctypes.data,
        digests.ctypes.data, chunk_sizes.ctypes.data, chunk_uniq.ctypes.data,
        refs_cap,
        comp.ctypes.data,
        blob.ctypes.data, blob.size,
        blob_digest.ctypes.data,
        n_uniq.ctypes.data, blob_size.ctypes.data,
        DIGEST_ALGO[digester],
    )
    if total == -2:
        return None
    if total < 0:
        raise RuntimeError("native pack_files failed (overflow or OOM)")
    nu = int(n_uniq[0])
    uniq_first = np.zeros(nu, dtype=np.int64)
    # first wins: walking the refs backward leaves each unique's first ref
    uniq_first[chunk_uniq[:total][::-1]] = np.arange(total - 1, -1, -1)
    return {
        "file_nchunks": file_nchunks,
        "digests": digests[: total * 32].tobytes(),
        "chunk_sizes": chunk_sizes[:total],
        "chunk_uniq": chunk_uniq[:total],
        "uniq_sizes": chunk_sizes[:total][uniq_first],
        "comp_extents": comp[:nu],
        "blob": blob[: int(blob_size[0])],
        "blob_digest": blob_digest.tobytes(),
    }


def pack_section_available() -> bool:
    """The blob-section arm: compress, append and hash in one call."""
    return _has("ntpu_pack_section")


def pack_section(
    src0: np.ndarray,
    src1: np.ndarray,
    extents: np.ndarray,
    compressor: int,
    accel: int = 1,
    n_threads: int = 1,
) -> "tuple[np.ndarray, np.ndarray, bytes] | None":
    """Assemble a blob data section in one native pass over ``n_threads``
    workers (the bytes do not depend on the count).

    ``extents``: i64[m, 3] (source, offset, size); source 0 slices
    ``src0`` (the tar buffer, zero-copy), source 1 ``src1`` (loose bytes).
    ``compressor``: 0 stores, 1 is LZ4 block (``accel`` its acceleration),
    2 is zstd (``accel`` carries the level: constants.ZSTD_LEVEL). ->
    (section bytes, i64[m, 2] (offset, size) of each frame, the section's
    SHA-256), each frame equal to utils/lz4 or utils/zstd at the same
    setting; None when the engine cannot dlopen the system liblz4 or
    libzstd, and the caller replays through its Python codec.
    """
    lib = load()
    ext = np.ascontiguousarray(extents, dtype=np.int64)
    m = ext.shape[0]
    if m == 0:
        return np.empty(0, dtype=np.uint8), np.empty((0, 2), dtype=np.int64), b""
    cap = _comp_bound_total(int(ext[:, 2].sum()), m, compressor)
    out = np.empty(max(cap, 1), dtype=np.uint8)
    comp = np.empty((m, 2), dtype=np.int64)
    digest = np.empty(32, dtype=np.uint8)
    total = lib.ntpu_pack_section(
        src0.ctypes.data if src0.size else None,
        src1.ctypes.data if src1.size else None,
        ext.ctypes.data, m,
        compressor, accel, max(1, n_threads),
        out.ctypes.data, out.size,
        comp.ctypes.data, digest.ctypes.data,
    )
    if total == -2:
        return None  # no system codec library: the Python replay
    if total < 0:
        raise RuntimeError("native pack_section failed (overflow or OOM)")
    return out[:total], comp, digest.tobytes()


def dict_build_available() -> bool:
    return hasattr(load(), "ntpu_dict_build")


def dict_build_native(
    digests: np.ndarray, n_shards: int, cap: int, max_probe: int,
    keys: np.ndarray, values: np.ndarray,
) -> bool:
    """Sequential first-wins table build into caller-zeroed keys/values.

    Returns False when a probe chain overflowed max_probe (grow cap and
    retry)."""
    lib = load()
    _check("digests", digests, np.uint32)
    _check("keys", keys, np.uint32)
    _check("values", values, np.int32)
    rc = lib.ntpu_dict_build(
        digests.ctypes.data, len(digests), n_shards, cap, max_probe,
        keys.ctypes.data, values.ctypes.data,
    )
    return rc == 0


def dict_insert_available() -> bool:
    return hasattr(load(), "ntpu_dict_insert")


def dict_insert_native(
    digests: np.ndarray, values_i32: np.ndarray,
    n_shards: int, cap: int, max_probe: int,
    keys: np.ndarray, values: np.ndarray,
) -> int:
    """Insert unique absent digests with explicit stored values (+1 form)
    into a built table. Returns the deepest chain reached, or -1 on a
    max_probe overflow (caller rebuilds)."""
    lib = load()
    _check("digests", digests, np.uint32)
    _check("values_i32", values_i32, np.int32)
    _check("keys", keys, np.uint32)
    _check("values", values, np.int32)
    return int(
        lib.ntpu_dict_insert(
            digests.ctypes.data, values_i32.ctypes.data, len(digests),
            n_shards, cap, max_probe,
            keys.ctypes.data, values.ctypes.data,
        )
    )


def dict_upsert_available() -> bool:
    return hasattr(load(), "ntpu_dict_upsert")


def dict_upsert_native(
    digests: np.ndarray, base: int,
    n_shards: int, cap: int, max_probe: int,
    keys: np.ndarray, values: np.ndarray,
) -> "tuple[int, int, np.ndarray] | None":
    """Probe-or-insert a whole batch in one sequential pass: (depth, n_new,
    indices i64[n]), or None on a chain overflow (the placed prefix carries
    final values and stays in the tables)."""
    lib = load()
    _check("digests", digests, np.uint32)
    _check("keys", keys, np.uint32)
    _check("values", values, np.int32)
    out = np.empty(len(digests), dtype=np.int64)
    rc = int(
        lib.ntpu_dict_upsert(
            digests.ctypes.data, len(digests), base,
            n_shards, cap, max_probe,
            keys.ctypes.data, values.ctypes.data, out.ctypes.data,
        )
    )
    if rc < 0:
        return None
    return rc >> 32, rc & 0xFFFFFFFF, out


def dict_probe_available() -> bool:
    return hasattr(load(), "ntpu_dict_probe")


def dict_probe_native(
    queries: np.ndarray, keys: np.ndarray, values: np.ndarray,
    n_shards: int, cap: int, max_probe: int,
) -> np.ndarray:
    """Probe u32[M,8] queries against a built table on the host -> i64[M]
    dict indices (-1 = miss). A chain ends at its first empty slot."""
    lib = load()
    queries = np.ascontiguousarray(queries, dtype=np.uint32)
    _check("keys", keys, np.uint32)
    _check("values", values, np.int32)
    out = np.empty(len(queries), dtype=np.int64)
    lib.ntpu_dict_probe(
        queries.ctypes.data, len(queries),
        keys.ctypes.data, values.ctypes.data,
        n_shards, cap, max_probe,
        out.ctypes.data,
    )
    return out
