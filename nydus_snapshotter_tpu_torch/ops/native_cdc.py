"""ctypes bridge to the port's copy of the native chunk engine: the dict arms.

``native/chunk_engine/`` holds the port's own copy of the C++ chunk engine
(``chunk_engine.cpp``, ``sha256.h``, ``blake3.h``). ``g++`` compiles it at
first use into ``build/`` (git-ignored), with the reference Makefile's
flags, to a library named by a hash of the sources and flags: a fresh
checkout builds on first call and an edited source never loads a stale
library. The compile writes to a temporary name and renames into place,
under a file lock so that concurrent processes build once. A failed build
raises :class:`BuildError` with the compiler's stderr; nothing falls back
to numpy on its own.

This slice binds the four chunk-dict entries that ``parallel/sharded_dict``
grows, persists and host-probes its table with: ``ntpu_dict_build``,
``ntpu_dict_insert``, ``ntpu_dict_upsert`` and ``ntpu_dict_probe``. The
chunking, digest, encode and pack arms of the same library (the
reference's ``backend="hybrid"`` host lane) wait for the slice that ports
``hybrid``.

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
        i64, vp = ctypes.c_int64, ctypes.c_void_p
        lib.ntpu_dict_build.restype = i64
        lib.ntpu_dict_build.argtypes = [
            vp, i64,  # digests, n
            i64, i64, i64,  # shards, cap, max_probe
            vp, vp,  # keys, values
        ]
        lib.ntpu_dict_insert.restype = i64
        lib.ntpu_dict_insert.argtypes = [
            vp, vp, i64,  # digests, vals, k
            i64, i64, i64,  # shards, cap, max_probe
            vp, vp,  # keys, values
        ]
        lib.ntpu_dict_upsert.restype = i64
        lib.ntpu_dict_upsert.argtypes = [
            vp, i64, i64,  # digests, n, base
            i64, i64, i64,  # shards, cap, max_probe
            vp, vp, vp,  # keys, values, out
        ]
        lib.ntpu_dict_probe.restype = None
        lib.ntpu_dict_probe.argtypes = [
            vp, i64,  # queries, m
            vp, vp,  # keys, values
            i64, i64, i64,  # shards, cap, max_probe
            vp,  # out
        ]
        _lib = lib
        return lib


def _check(name: str, a: np.ndarray, dtype) -> None:
    if a.dtype != dtype or not a.flags.c_contiguous:
        raise ValueError(f"{name} must be C-contiguous {np.dtype(dtype).name}, got {a.dtype}")


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
