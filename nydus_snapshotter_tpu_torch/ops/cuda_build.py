"""Build the hand-written CUDA kernels at first use and bind them with ctypes.

Each kernel source in ``csrc/`` has a plain C interface: pointers, sizes and
the CUDA stream in, ``cudaGetLastError()`` out. ``nvcc`` compiles it for
``sm_90a`` into a shared library under ``build/`` (git-ignored), named by a
hash of the source and flags, so a fresh checkout builds on first call and
an edited source never loads a stale library. The compile writes to a
temporary name (keyed by process and thread) and renames into place: a
failed or interrupted build leaves neither a lock nor a partial library
behind.

Safe under concurrent callers (layers packed on a thread pool reach their
kernels first from several threads at once): one lock per source covers
the exists-check, compile and rename, and each ``Kernel`` loads and counts
its ``launches`` under its own lock.

Nothing here runs at import time: the CPU tests import every module, and
this host has no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "build"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)


class BuildError(RuntimeError):
    """nvcc refused a kernel source (message carries its stderr)."""


class KernelError(RuntimeError):
    """A kernel launch returned a CUDA error."""


def _nvcc() -> str:
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
        "/usr/local/cuda/bin/nvcc",
    ):
        if cand and os.path.isfile(cand):
            return cand
    found = shutil.which("nvcc")
    if found is None:
        raise BuildError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")
    return found


_source_locks: dict[str, threading.Lock] = {}
_source_locks_guard = threading.Lock()


def _source_lock(source: str) -> threading.Lock:
    with _source_locks_guard:
        return _source_locks.setdefault(source, threading.Lock())


def library_path(source: str) -> Path:
    src = (CSRC_DIR / source).read_bytes()
    key = hashlib.sha256(src + "\0".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{Path(source).stem}-{key}.so"


def build(source: str) -> tuple[Path, str]:
    """Compile ``csrc/<source>`` unless its library exists -> (path, log).

    The log is nvcc's stderr (ptxas register/shared-memory report) for a
    fresh build, "" for a cached one.
    """
    out = library_path(source)
    with _source_lock(source):
        if out.exists():
            return out, ""
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f".{out.stem}.{os.getpid()}.{threading.get_ident()}.tmp.so")
        try:
            proc = subprocess.run(
                [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / source)],
                capture_output=True,
                text=True,
            )
            if proc.returncode != 0:
                raise BuildError(f"nvcc failed on {source}:\n{proc.stderr}")
            os.replace(tmp, out)
        finally:
            tmp.unlink(missing_ok=True)
    return out, proc.stderr


class Kernel:
    """One C entry point of one kernel source, loaded on first launch.

    ``launches`` counts successful launches and nothing else, so a caller
    can show that a code path really went through the kernel.
    """

    def __init__(self, source: str, symbol: str, argtypes: list):
        self.source = source
        self.symbol = symbol
        self.argtypes = argtypes
        self.launches = 0
        self.build_log = ""
        self._lib = None
        self._fn = None
        self._lock = threading.Lock()

    def load(self):
        if self._fn is None:
            with self._lock:
                if self._fn is None:
                    path, log = build(self.source)
                    self.build_log = log or self.build_log
                    lib = ctypes.CDLL(str(path))
                    fn = getattr(lib, self.symbol)
                    fn.argtypes = self.argtypes
                    fn.restype = ctypes.c_int
                    self._lib, self._fn = lib, fn
        return self._fn

    def launch(self, *args) -> None:
        err = self.load()(*args)
        if err != 0:
            raise KernelError(f"{self.symbol}: CUDA error {err} at launch")
        with self._lock:
            self.launches += 1


def build_all(kernels: list[Kernel]) -> None:
    """Compile every kernel source concurrently (one nvcc per source, however
    many entry points it has), then load every entry point."""
    sources = sorted({k.source for k in kernels})
    with ThreadPoolExecutor(max_workers=max(1, len(sources))) as pool:
        logs = dict(zip(sources, pool.map(lambda s: build(s)[1], sources)))
    for k in kernels:
        k.build_log = logs[k.source] or k.build_log
        k.load()
