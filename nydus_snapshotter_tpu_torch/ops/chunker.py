"""ChunkDigestEngine: windowed hash -> cut resolution -> batched digests.

Port of the reference package's ops/chunker.py, the data-plane replacement
for ``nydus-image create``'s chunk + digest loop:

1. **Hash (device).** A stream is cut into power-of-two windows, each row
   prefixed by the 31 bytes before it, so windowed hashing is bit-identical
   to whole-stream hashing. Kernel K1 (ops/gear_cuda.py) turns the rows
   into two packed candidate bitmaps (one bit per position and mask). The
   rows go up from a ring of pinned staging slots on a side CUDA stream and
   the bitmaps come back into the slot behind an event, so the card hashes
   stream i+1 while the host resolves stream i (``boundaries_many``).
2. **Cut resolution (host).** ops/cdc.resolve_cuts over the sparse
   candidates.
3. **Digest (device).** Chunks are joined into one 16-byte-aligned pinned
   buffer per int32-addressable piece and digested by one launch of kernel
   K2 (SHA-256, ops/sha256_cuda.py) or K4 (BLAKE3, ops/blake3_cuda.py) per
   piece (:class:`DeviceDigester`).

The backend names are the reference's, so an option that works there means
the same here: ``"jax"`` is the windowed device lane (on CUDA in this
package), ``"fused"`` the full-path engine (ops/fused_convert.py) with the
windowed lane behind it, ``"hybrid"`` the host lane of the native chunk
engine (ops/native_cdc.py: cuts by ``chunk_data_best``, streams chunked on a
thread pool, and with host digests one fused chunk+digest call per stream;
no CUDA context unless ``digest_backend="jax"``), ``"numpy"`` the host
oracle. Fixed-size mode skips the hash and the cut resolution. ``digester``
is ``"sha256"`` or ``"blake3"`` (the reference toolchain's default): with
the ``"jax"`` digest backend BLAKE3 runs on the card, with the others on the
native engine's host arm (``ntpu_blake3_many``). Host SHA-256 batches of 8
or more chunks go through ``ntpu_sha256_many`` (SHA-NI when the CPU has
it), smaller ones through ``hashlib``.
"""

from __future__ import annotations

import hashlib
import os
from collections import deque
from contextlib import nullcontext
from dataclasses import dataclass
from time import perf_counter

import numpy as np
import torch

from nydus_snapshotter_tpu_torch.ops import cdc, fused_convert, gear, gear_cuda, native_cdc
from nydus_snapshotter_tpu_torch.tensors import as_int32, resolve_device

DEFAULT_WINDOW = 1 << 22  # 4 MiB per device window
MIN_WINDOW = 1 << 19  # smallest window: a small stream's row is pow2_ceil(size) >= this
TAIL = gear.GEAR_WINDOW - 1
DEPTH = 2  # streams in flight in boundaries_many, and staging slots per window size
# K2 and K4 address a piece's chunks with int32 offsets: a piece's joined,
# 16-byte-padded buffer stays at or below this.
MAX_PIECE_BYTES = (1 << 31) - 16


def _pow2_ceil(n: int) -> int:
    return 1 << (n - 1).bit_length() if n > 1 else 1


@dataclass(frozen=True)
class ChunkMeta:
    offset: int
    size: int
    digest: bytes  # raw 32-byte digest of the chunk data (the engine's digester)


def _hash_bitmaps_kernel(x: torch.Tensor, mask_s: int, mask_l: int, n: int):
    """Batch of windows -> packed candidate bitmaps.

    x: uint8[B, n + GEAR_WINDOW - 1] (window prefixed by its 31-byte tail)
    returns (int32[B, n//32], int32[B, n//32]) u32 bit patterns; bit j of
    word w is position 32w + j. The plain PyTorch version of kernel K1.
    """
    h = gear.windowed_gear_sum(gear.mix32_torch(x))[:, gear.GEAR_WINDOW - 1 :]
    lanes = torch.ones(32, dtype=torch.int64, device=x.device) << torch.arange(
        32, dtype=torch.int64, device=x.device
    )

    def pack(bits: torch.Tensor) -> torch.Tensor:
        words = (bits.reshape(-1, n // 32, 32).to(torch.int64) * lanes).sum(-1)
        return as_int32(words)

    return pack((h & mask_s) == 0), pack((h & mask_l) == 0)


def _unpack_positions(words: np.ndarray, valid_len: int) -> np.ndarray:
    """uint32 packed bitmap -> sorted candidate positions < valid_len."""
    bits = np.unpackbits(words.view(np.uint8), bitorder="little")
    pos = np.nonzero(bits)[0]
    return pos[pos < valid_len]


def _as_array(data) -> np.ndarray:
    if isinstance(data, np.ndarray):
        return data
    return np.frombuffer(data, dtype=np.uint8)


def _cpu_count() -> int:
    return os.cpu_count() or 4


def _map_threads(fn, items: list, min_batch: int = 2) -> list:
    """Thread-pool map for GIL-dropping work (native ctypes calls, hashlib
    over buffers larger than 2 KiB); sequential below ``min_batch``."""
    if len(items) < min_batch:
        return [fn(i) for i in items]
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(max_workers=min(32, _cpu_count())) as pool:
        return list(pool.map(fn, items))


def _grouped_native_digests(items: list[tuple[np.ndarray, int, int]], native_fn) -> list[bytes]:
    """(array, offset, size) items -> digests, by GIL-dropping native batch
    calls: runs of extents that share an array make one call each, and with
    fewer runs than cores a run is split so one large stream still spreads
    over the cores. ``native_fn(arr, extents_i64) -> bytes`` (32 bytes an
    extent) is ``sha256_many_native`` or ``blake3_many_native``."""
    groups: list[tuple[np.ndarray, list[tuple[int, int]]]] = []
    for arr, off, size in items:
        if groups and groups[-1][0] is arr:
            groups[-1][1].append((off, size))
        else:
            groups.append((arr, [(off, size)]))
    ncpu = _cpu_count()
    if ncpu > 1 and len(groups) < ncpu:
        per = max(8, -(-len(items) // ncpu))
        groups = [(arr, exts[i : i + per]) for arr, exts in groups for i in range(0, len(exts), per)]
    flat = _map_threads(lambda g: native_fn(g[0], np.asarray(g[1], dtype=np.int64)), groups)
    return [blob[32 * i : 32 * (i + 1)] for blob in flat for i in range(len(blob) // 32)]


def _host_digests(items: list[tuple[np.ndarray, int, int]]) -> list[bytes]:
    """Host SHA-256 over (array, offset, size) extents: threaded native
    batch calls (SHA-NI when the CPU has it) for 8 items or more, below
    that ``hashlib`` in this thread, as the reference routes."""
    if len(items) >= 8:
        return _grouped_native_digests(items, native_cdc.sha256_many_native)
    return [hashlib.sha256(memoryview(a)[o : o + s]).digest() for a, o, s in items]


def _host_digests_blake3(items: list[tuple[np.ndarray, int, int]]) -> list[bytes]:
    """Threaded host BLAKE3 over (array, offset, size) extents, on the
    native engine's BLAKE3 arm (``ntpu_blake3_many``) whatever the batch
    size. (The pure-Python utils/blake3.py is the tests' oracle.)"""
    return _grouped_native_digests(items, native_cdc.blake3_many_native)


def host_digests_for(digester: str):
    """The (array, offset, size)-extents host digest fan-out of an
    algorithm."""
    return _host_digests_blake3 if digester == "blake3" else _host_digests


def _pieces(items: list[tuple[np.ndarray, int, int]]) -> list[list[tuple[np.ndarray, int, int]]]:
    """Consecutive runs of items whose joined, 16-byte-padded bytes stay
    within int32 chunk addressing (``MAX_PIECE_BYTES``)."""
    out: list[list] = []
    total = MAX_PIECE_BYTES + 1
    for item in items:
        size = item[2]
        if size > MAX_PIECE_BYTES:
            raise ValueError(f"a chunk of {size} bytes is beyond int32 chunk addressing")
        if total + size > MAX_PIECE_BYTES:
            out.append([])
            total = 0
        out[-1].append(item)
        total += size
    return out


class DeviceDigester:
    """Chunk digests on the engine's device, one launch of K2 (SHA-256) or
    K4 (BLAKE3) per batch.

    ``submit`` joins the batch's chunks into one 16-byte-aligned pinned
    buffer, queues its upload, the kernel and the digests' download into pinned
    memory behind an event, and returns without waiting on the card;
    ``collect`` waits on that event. One batch in flight while the host
    reads and chunks the next is the double-buffered infeed of the
    reference's ``_DeviceDigester`` (converter/stream.py:217-263). A batch
    must fit int32 chunk addressing (``MAX_PIECE_BYTES``).
    """

    def __init__(self, device: "str | torch.device | None" = None, digester: str = "sha256"):
        self.device = resolve_device(device)
        self._pin = self.device.type == "cuda"
        self.digester = digester

    def submit(self, items: list[tuple[np.ndarray, int, int]]):
        """items: (array, offset, size) extents -> an opaque handle."""
        m = len(items)
        sizes = np.fromiter((s for _a, _o, s in items), dtype=np.int64, count=m)
        starts = np.zeros(m, dtype=np.int64)
        np.cumsum(sizes[:-1], out=starts[1:])
        total = int(sizes.sum())
        if total > MAX_PIECE_BYTES:
            raise ValueError(f"a batch of {total} bytes is beyond int32 chunk addressing")
        host = torch.empty(-(-max(total, 1) // 16) * 16, dtype=torch.uint8, pin_memory=self._pin)
        buf = host.numpy()
        # Chunks of one file arrive contiguous: copy each run once.
        pos, i = 0, 0
        while i < m:
            arr, off, size = items[i]
            j = i + 1
            while j < m and items[j][0] is arr and items[j][1] == off + size:
                size += items[j][2]
                j += 1
            buf[pos : pos + size] = arr[off : off + size]
            pos += size
            i = j
        buf[pos:] = 0
        offs = torch.from_numpy(starts.astype(np.int32))
        lens = torch.from_numpy(sizes.astype(np.int32))
        if not self._pin:
            return fused_convert.chunk_digests(self.digester, host, offs, lens), None
        with torch.cuda.device(self.device):
            states = fused_convert.chunk_digests(
                self.digester, host.to(self.device, non_blocking=True), offs, lens
            )
            out = torch.empty((m, 8), dtype=torch.int32, pin_memory=True)
            out.copy_(states, non_blocking=True)
            done = torch.cuda.Event()
            done.record()
        return out, done

    def collect(self, handle) -> list[bytes]:
        out, done = handle
        if done is not None:
            done.synchronize()
        raw = fused_convert.state_bytes(out.numpy().view(np.uint32), self.digester)
        return [raw[32 * i : 32 * i + 32] for i in range(out.shape[0])]


class HostDigester:
    """Synchronous batch digests on the host (threaded hashlib, or the host
    BLAKE3 arm), with the submit/collect shape of :class:`DeviceDigester`."""

    def __init__(self, digester: str = "sha256"):
        self._digest = host_digests_for(digester)

    def submit(self, items: list[tuple[np.ndarray, int, int]]):
        return self._digest(items)

    def collect(self, handle) -> list[bytes]:
        return handle


class _Slot:
    """One pinned staging slot of the window ring: rows in, bitmaps out,
    and the event after which both may be reused."""

    def __init__(self, rows: int, w: int, pin: bool):
        self.rows = torch.empty((rows, TAIL + w), dtype=torch.uint8, pin_memory=pin)
        self.bits = torch.empty((2, rows, w // 32), dtype=torch.int32, pin_memory=pin)
        self.done = torch.cuda.Event() if pin else None


class ChunkDigestEngine:
    """Chunk + digest byte streams on the card (or numpy for differential
    runs).

    Parameters mirror the reference's: ``chunk_size`` (power-of-two
    average; pkg/converter/types.go:76-79), ``mode`` ``cdc`` or ``fixed``,
    ``backend`` ``jax`` (the windowed device lane), ``fused``, ``hybrid``
    (the native host lane) or ``numpy``, ``digest_backend`` ``jax`` (K2, or
    K4 for BLAKE3), ``host`` (threaded native batches; ``hybrid``'s
    default) or ``numpy`` (hashlib), by default the backend's own, and
    ``digester`` ``sha256`` or ``blake3`` (whose ``host`` and ``numpy``
    digests run on the native BLAKE3 arm). ``device`` is where
    the device arms run: CUDA unless ``"cpu"`` is asked for, which takes the
    kernels' plain versions; the ``numpy`` and ``hybrid`` backends take a
    device only with ``digest_backend="jax"``. ``stats`` accumulates the wall seconds of the
    windowed ``process_many``'s two halves: ``boundaries_many`` (upload,
    K1, bitmap download, cut resolution) and ``digest_all`` (staging,
    upload, K2, digest download), and counts in ``fused_fallbacks`` the
    ``process_many`` calls that the fused backend handed to the windowed
    path.
    """

    def __init__(
        self,
        chunk_size: int = 0x100000,
        mode: str = "cdc",
        backend: str = "jax",
        window: int = DEFAULT_WINDOW,
        digest_backend: str | None = None,
        digester: str = "sha256",
        device: "str | torch.device | None" = None,
    ):
        if mode not in ("cdc", "fixed"):
            raise ValueError(f"unknown chunking mode {mode!r}")
        if backend not in ("jax", "numpy", "hybrid", "fused"):
            raise ValueError(f"unknown backend {backend!r}")
        if window % 32 or window <= 0:
            raise ValueError("window must be a positive multiple of 32")
        self.digest_backend = digest_backend or (
            "host" if backend == "hybrid" else "jax" if backend == "fused" else backend
        )
        if self.digest_backend not in ("jax", "numpy", "host"):
            raise ValueError(f"unknown digest backend {self.digest_backend!r}")
        if digester not in ("sha256", "blake3"):
            raise ValueError(f"unknown digester {digester!r}")
        self.chunk_size = chunk_size
        self.mode = mode
        self.backend = backend
        self.window = window
        self.digester = digester
        self.params = cdc.CDCParams(chunk_size) if mode == "cdc" else None
        hashes_on_device = mode == "cdc" and backend in ("jax", "fused")
        self.device = (
            resolve_device(device) if hashes_on_device or self.digest_backend == "jax" else None
        )
        self._pin = self.device is not None and self.device.type == "cuda"
        self._stream = torch.cuda.Stream(self.device) if self._pin else None
        self._rings: dict[int, list[_Slot | None]] = {}
        self._turn: dict[int, int] = {}
        # K2 or K4 in batches, on the engine's device; callers that batch
        # their own chunks (converter/pack.py) share it
        self.device_digester = (
            DeviceDigester(self.device, digester) if self.digest_backend == "jax" else None
        )
        self.stats = {"boundaries_s": 0.0, "digest_s": 0.0, "fused_fallbacks": 0}

    # -- boundaries ---------------------------------------------------------

    def boundaries(self, data) -> np.ndarray:
        """Cut offsets for one stream (exclusive ends, last == len)."""
        arr = _as_array(data)
        if self.mode == "fixed":
            return cdc.chunk_fixed(arr.size, self.chunk_size)
        if arr.size == 0:
            return np.asarray([], dtype=np.int64)
        if self.backend == "hybrid":
            return native_cdc.chunk_data_best(arr, self.params)
        if self.backend == "numpy":
            return cdc.chunk_data_np(arr, self.params)
        cand_s, cand_l = self._candidates_windowed(arr)
        return cdc.resolve_cuts(cand_s, cand_l, arr.size, self.params)

    def _slot(self, w: int, rows: int) -> _Slot:
        """The next staging slot of window size ``w``'s ring, holding at
        least ``rows`` rows. Its previous use is waited out first: the host
        must not overwrite rows still being copied up, nor bitmaps not yet
        read."""
        ring = self._rings.setdefault(w, [None] * DEPTH)
        k = self._turn.get(w, 0)
        self._turn[w] = (k + 1) % DEPTH
        slot = ring[k]
        if slot is not None and slot.done is not None:
            slot.done.synchronize()
        if slot is None or slot.rows.shape[0] < rows:
            slot = ring[k] = _Slot(rows, w, self._pin)
        return slot

    def _dispatch_windows(self, arr: np.ndarray):
        """Queue the device hash of one stream -> a handle for
        :meth:`_collect_windows`. On CUDA nothing here waits on the card, so
        a caller can queue stream i+1 before collecting stream i."""
        # Power-of-two windows in [MIN_WINDOW, window]: a small stream is not
        # hashed in a full 4 MiB row.
        w = min(self.window, max(MIN_WINDOW, _pow2_ceil(max(1, arr.size))))
        n = -(-arr.size // w)
        slot = self._slot(w, n)
        rows = slot.rows.numpy()
        for i in range(n):
            lo = i * w
            hi = min(lo + w, arr.size)
            rows[i, :TAIL] = arr[lo - TAIL : lo] if lo else 0
            rows[i, TAIL : TAIL + hi - lo] = arr[lo:hi]
        rows[n - 1, TAIL + arr.size - (n - 1) * w :] = 0
        p = self.params
        with torch.cuda.stream(self._stream) if self._pin else nullcontext():
            x = slot.rows[:n].to(self.device, non_blocking=True)
            bm_s, bm_l = gear_cuda.gear_bitmaps(x, p.mask_small, p.mask_large, w)
            slot.bits[0, :n].copy_(bm_s, non_blocking=True)
            slot.bits[1, :n].copy_(bm_l, non_blocking=True)
            if slot.done is not None:
                slot.done.record(self._stream)
        return slot, w, n

    def _collect_windows(self, handle, arr: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        slot, w, n = handle
        if slot.done is not None:
            slot.done.synchronize()
        bits = slot.bits.numpy().view(np.uint32)
        parts_s, parts_l = [], []
        for i in range(n):
            valid = min(w, arr.size - i * w)
            # only the words that hold valid positions: a small stream's
            # row is mostly padding
            words = -(-valid // 32)
            parts_s.append(_unpack_positions(bits[0, i, :words], valid) + i * w)
            parts_l.append(_unpack_positions(bits[1, i, :words], valid) + i * w)
        return np.concatenate(parts_s), np.concatenate(parts_l)

    def _candidates_windowed(self, arr: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        return self._collect_windows(self._dispatch_windows(arr), arr)

    def boundaries_many(self, arrs: list[np.ndarray]) -> list[np.ndarray]:
        """Per-stream cut offsets for many streams.

        On the windowed lanes: at most ``DEPTH`` streams in flight,
        collected in order, so the card hashes stream i+1 while the host
        resolves stream i; one K1 launch per non-empty stream. On
        ``hybrid``: a thread pool (the native chunker drops the GIL).
        """
        if self.backend == "hybrid":
            return _map_threads(self.boundaries, arrs)
        if self.mode != "cdc" or self.backend == "numpy":
            return [self.boundaries(a) for a in arrs]
        arrs = [_as_array(a) for a in arrs]
        out = [np.asarray([], dtype=np.int64) for _ in arrs]
        todo = deque((i, a) for i, a in enumerate(arrs) if a.size)
        inflight: deque = deque()
        while todo or inflight:
            while todo and len(inflight) < DEPTH:
                i, a = todo.popleft()
                inflight.append((i, a, self._dispatch_windows(a)))
            i, a, h = inflight.popleft()
            cand_s, cand_l = self._collect_windows(h, a)
            out[i] = cdc.resolve_cuts(cand_s, cand_l, a.size, self.params)
        return out

    # -- digesting ----------------------------------------------------------

    def _digest_items(self, items: list[tuple[np.ndarray, int, int]]) -> list[bytes]:
        if self.digester == "blake3" and self.digest_backend != "jax":
            return _host_digests_blake3(items)
        if self.digest_backend == "numpy":
            return [hashlib.sha256(memoryview(a)[o : o + s]).digest() for a, o, s in items]
        if self.digest_backend == "host":
            return _host_digests(items)
        if not items:
            return []
        # every piece queued before the first is collected
        handles = [self.device_digester.submit(piece) for piece in _pieces(items)]
        return [d for h in handles for d in self.device_digester.collect(h)]

    def digests(self, data, cuts: np.ndarray) -> list[bytes]:
        arr = _as_array(data)
        return self._digest_items([(arr, o, s) for o, s in cdc.cuts_to_extents(cuts)])

    def digest_all(
        self,
        arrs: list[np.ndarray],
        per_file_extents: list[list[tuple[int, int]]],
    ) -> list[bytes]:
        """Flat digests for pre-computed per-file extents, in file order:
        one pass over every file (on the card, one K2 or K4 launch per
        int32-addressable piece)."""
        return self._digest_items(
            [(arr, o, s) for arr, extents in zip(arrs, per_file_extents) for o, s in extents]
        )

    def digest_many(self, datas: list[bytes]) -> list[bytes]:
        """Digests of pre-delimited chunks (no CDC): the tarfs and index
        build sources, whose boundaries come from the tar layout."""
        return self._digest_items([(_as_array(d), 0, len(d)) for d in datas])

    # -- end to end ---------------------------------------------------------

    def process(self, data) -> list[ChunkMeta]:
        """Chunk one stream and digest every chunk."""
        arr = _as_array(data)
        cuts = self.boundaries(arr)
        return [
            ChunkMeta(offset=o, size=s, digest=d)
            for (o, s), d in zip(cdc.cuts_to_extents(cuts), self.digests(arr, cuts))
        ]

    def process_many(self, streams: list) -> list[list[ChunkMeta]]:
        """Per-file chunking (nydus chunks each file independently): the
        boundaries of every stream, then every chunk digested in one pass.
        ``backend="fused"`` runs the full-path engine and, when it cannot
        take the input (:class:`fused_convert.FusedOverflow`), this
        windowed path, as the reference does; ``hybrid`` with host digests
        one native chunk+digest call per stream, on a thread pool."""
        if not streams:
            return []
        arrs = [_as_array(s) for s in streams]
        if self.backend == "fused" and self.mode == "cdc":
            out = self._process_many_device_fused(arrs)
            if out is not None:
                return out
            self.stats["fused_fallbacks"] += 1
        if self._fused_available():
            return self._process_many_fused(arrs)
        t0 = perf_counter()
        per_file_extents = [cdc.cuts_to_extents(c) for c in self.boundaries_many(arrs)]
        t1 = perf_counter()
        flat = iter(self.digest_all(arrs, per_file_extents))
        self.stats["boundaries_s"] += t1 - t0
        self.stats["digest_s"] += perf_counter() - t1
        return [
            [ChunkMeta(offset=o, size=s, digest=next(flat)) for o, s in extents]
            for extents in per_file_extents
        ]

    def _process_many_device_fused(self, arrs: list[np.ndarray]) -> list[list[ChunkMeta]] | None:
        """The full-path engine over batches below int32 addressing; None
        on ``FusedOverflow`` (candidate capacity, or one stream beyond int32
        addressing) so ``process_many`` takes the windowed path."""
        eng = fused_convert.FusedDeviceEngine(
            chunk_size=self.chunk_size, digester=self.digester, device=self.device
        )
        out: list[list[ChunkMeta]] = []
        try:
            for batch in eng.split_batches([a.size for a in arrs]):
                res = eng.process_many([arrs[i] for i in batch])
                out.extend(
                    [
                        ChunkMeta(offset=o, size=s, digest=d)
                        for (o, s), d in zip(cdc.cuts_to_extents(cuts), digests)
                    ]
                    for cuts, digests in zip(res.cuts, res.digests)
                )
        except fused_convert.FusedOverflow:
            return None
        return out

    def _fused_available(self) -> bool:
        """The native single-pass chunk+digest arm (SIMD bitmaps, SHA-NI or
        BLAKE3 leaves) takes ``hybrid`` CDC with host digests."""
        return (
            self.mode == "cdc"
            and self.backend == "hybrid"
            and self.digest_backend == "host"
            and native_cdc.chunk_digest_available()
        )

    def _process_many_fused(self, arrs: list[np.ndarray]) -> list[list[ChunkMeta]]:
        def one(arr: np.ndarray) -> list[ChunkMeta]:
            cuts, digests = native_cdc.chunk_digest_native(arr, self.params, digester=self.digester)
            return [
                ChunkMeta(offset=o, size=s, digest=digests[32 * i : 32 * i + 32])
                for i, (o, s) in enumerate(cdc.cuts_to_extents(cuts))
            ]

        return _map_threads(one, arrs)
