"""Pack: one OCI layer tar -> nydus blob stream.

Reference semantics (convert_unix.go:325-539): uncompressed layer tar in,
tar-like nydus blob out (``image.blob`` data | ``image.boot`` layer
bootstrap | ``rafs.blob.toc``, framed per models/nydus_tar.py); chunk-dict
hits are referenced, not stored. The output is byte-identical to the
reference package's ``Pack``/``pack_layer`` for the same options:

- ``backend="fused"``: the layer's in-memory files go through
  ``ChunkDigestEngine(backend="fused").process_many``: the device full path
  (ops/fused_convert), cuts and digests on the card, in as few batches as
  int32 chunk addressing allows. An input that path cannot take
  (candidate capacity overflow, a file beyond int32 addressing) falls to
  the engine's per-file windowed lane, still on the card, as the reference
  falls through to its per-file paths (converter/stream.py:1051-1075).
  The fused path is CDC only: ``chunking="fixed"`` takes the per-file path.
- ``backend="jax"``: the reference's windowed device lane. Each file is
  cut by ``ChunkDigestEngine.boundaries`` (kernel K1 per file) and its
  chunks are digested on the card in 32 MiB batches (kernel K2), one batch
  in flight while the host cuts the next files.
- ``backend="hybrid"``: the native chunk engine's host lane
  (ops/native_cdc), no device. At ``_pack_threads() == 1`` the whole layer
  goes through one native call: ``pack_files`` (chunk, digest, dedup,
  compress, assemble and hash) when there is no chunk dict and the
  deferred section writer is in use, else ``chunk_digest_multi`` (cuts and
  digests) before the dedup lane. With more threads each file takes one
  fused chunk+digest call, and files no larger than the minimum chunk are
  digested in one batch. With more than one such file the calls run on
  the stage-parallel pipeline (parallel/pipeline.py: a chunk+digest pool,
  a speculative compress pool for the serial section writer, the ordered
  dedup and assembly on the caller's thread), else in tar order on one
  thread; the bytes are the same.
- ``backend="numpy"``: the host oracle, numpy CDC and host digests; at more
  than one thread on the same pipeline, each worker digesting its file's
  chunks on the host.
- ``digest_backend``: ``"jax"`` digests every lane's batches on the card;
  ``"host"`` digests the ``numpy`` and ``fused`` lanes' batches on the host
  (the ``jax`` lane digests on the card whatever it says, as the
  reference's does, converter/stream.py:790-797).
- ``digester="sha256"`` or ``"blake3"``. BLAKE3 changes only the chunk
  digests in the bootstrap (the blob and its sha256 id stay the same). The
  device digests take K4 where SHA-256 takes K2; host digests run on the
  host BLAKE3 arm. (The reference's device digester is SHA-256 only and
  digests BLAKE3 on its host arm; the bytes are the same.)
- ``compressor`` ``"lz4_block"`` (the default, ``lz4_acceleration``),
  ``"zstd"`` (level 3) or ``"none"``; ``batch_size`` packs chunks below it
  into jointly compressed batches (``CHUNK_FLAG_BATCH``, batch records in
  the bootstrap); ``aligned_chunk`` aligns each stored frame to 4096 bytes
  on RAFS v5. Which writer compresses is the reference's choice
  (converter/stream.py:771-790): an in-memory tar (``bytes``) packed with
  ``none``, ``lz4_block`` or ``zstd``, with no ``batch_size``, v5
  alignment, adaptive codec or ``encrypt``, takes
  :class:`_DeferredSectionWriter` on every lane. It records each unique
  chunk's extent (a zero-copy offset into the tar, or loose bytes in a
  side buffer) and after the chunk lane compresses, assembles and hashes
  the whole section in one GIL-free native call
  (``native_cdc.pack_section``) over ``_pack_threads()`` workers, by default
  the core count; the bytes do not depend on the count. Without the system
  codec library the engine can dlopen, the extents replay through the
  Python codec. Otherwise (a file-like ``src_tar``, ``batch_size``, v5
  ``aligned_chunk``, the adaptive codec, ``encrypt``) :class:`_SectionWriter`
  compresses chunk by chunk in the dedup lane, on one thread. Codecs are
  the system liblz4 and libzstd (utils/lz4.py, utils/zstd.py, and the
  engine's own dlopen of the same names), never a bundled build.
- ``prefetch_patterns`` fill the bootstrap's prefetch table;
  ``chunk_dict_path`` opens a chunk dict when none is passed, through
  parallel/dict_service.open_chunk_dict: ``service://<uds>[|<replica>...]
  [,<uds>...][#namespace]`` is a mirror of a chunk-dict service's
  namespace (``,`` separates rendezvous shards, ``|`` a shard's failover
  replicas), ``service+ha://<controller>[#namespace]`` the same with the
  shards and replicas taken from the controller's placement map, and
  ``bootstrap=<file>`` or a bare path a bootstrap of this package's layout.
  ``chunk_dict`` takes any dict with the ``get``/``blob_id_for``/
  ``bootstrap`` interface: ``ChunkDict``, ``GrowingChunkDict``,
  ``ServiceChunkDict``.
- RAFS v5 or v6.
- ``compressor="zstd"`` under the adaptive codec (``NTPU_COMPRESS_ADAPTIVE``
  or ``[compression] adaptive``, or a ``codec=`` passed in): per-chunk
  probe, store-raw bypass, per-class levels and trained-dictionary
  ``nZD1`` frames (converter/codec.py). ``encrypt=True``: the data section
  as one AES-256-CTR stream under a fresh per-blob key, recorded in the
  bootstrap's cipher table (converter/crypto.py). Either takes
  :class:`_SectionWriter` on every lane, as in the reference
  (converter/stream.py:775-788): cuts and digests stay where the lane puts
  them (on the card for ``fused`` and ``jax``), and the codec and the
  cipher run on the host.

A ``chunk_dict_path`` bootstrap may be in this package's layout or the
real nydus v5/v6 layouts (models/nydus_real.load_any_bootstrap).

An in-memory tar's headers are read by :func:`_fast_tar_members` (the
reference's header walk; ``tarfile`` where it bails). A file-like
``src_tar`` streams: each member is read in 4 MiB segments
through :class:`IncrementalChunker`, whose carry is bounded by the largest
chunk. Sparse members take the same chunker. Blob bytes go to ``dest`` as
chunks are stored; only metadata accumulates. Dedup, blob assembly and
bootstrap emission follow the reference's serial lane: chunks in tar
order, first occurrence stored, later ones referenced.
"""

from __future__ import annotations

import contextlib
import hashlib
import io
import math
import os
import stat
import tarfile
from dataclasses import dataclass, field
from time import perf_counter
from typing import BinaryIO, Optional

import numpy as np
import torch

from nydus_snapshotter_tpu_torch import constants, failpoint, trace
from nydus_snapshotter_tpu_torch.converter import codec as codec_mod
from nydus_snapshotter_tpu_torch.converter import crypto
from nydus_snapshotter_tpu_torch.converter.types import ConvertError, PackOption
from nydus_snapshotter_tpu_torch.metrics import registry as _metrics
from nydus_snapshotter_tpu_torch.models import fstree, layout, nydus_tar, toc
from nydus_snapshotter_tpu_torch.models.bootstrap import (
    CHUNK_FLAG_BATCH,
    BatchRecord,
    BlobRecord,
    Bootstrap,
    ChunkRecord,
    CipherRecord,
    Inode,
)
from nydus_snapshotter_tpu_torch.ops import native_cdc
from nydus_snapshotter_tpu_torch.ops.chunker import (
    ChunkDigestEngine,
    DeviceDigester,
    HostDigester,
    host_digests_for,
)
from nydus_snapshotter_tpu_torch.utils import lz4
from nydus_snapshotter_tpu_torch.utils import zstd as zstd_native

SEGMENT_BYTES = 4 << 20  # tar read granularity
DIGEST_BATCH_BYTES = 32 << 20  # chunk bytes per digest batch

_reg = _metrics.default_registry
_STAGE_SECONDS = _reg.register(
    _metrics.Counter("ntpu_pack_stage_seconds", "Wall seconds per Pack stage", ("stage",))
)
_LAYERS = _reg.register(_metrics.Counter("ntpu_pack_layers", "Layers Pack converted"))
# Pack's stage split: the ``stats=`` keys, summed over every pack
_STAGES = {
    k: _STAGE_SECONDS.labels(k)
    for k in ("scan", "chunk_digest", "fused_pack", "dedup", "assemble", "bootstrap")
}


@dataclass
class PackResult:
    blob_id: str  # hex sha256 of the image.blob section ("" if fully deduped)
    blob_size: int
    bootstrap: bytes
    referenced_blob_ids: list[str]
    # How the pack ran: ``lane`` (the lane that took the in-memory files:
    # "pack_files", "chunk_digest_multi", "fused" or "per_file"; "stream"
    # for a file-like tar), ``writer`` ("deferred" or "serial"), and for the
    # deferred writer ``native`` (False when its section replayed through
    # the Python codec), ``threads`` and the unique chunks it recorded from
    # the tar buffer (``src0``) and from loose bytes (``src1``).
    route: dict = field(default_factory=dict)


@dataclass
class _ChunkRef:
    """A file-extent's chunk before final record materialization."""

    digest: bytes
    size: int
    uniq_idx: int = -1  # index into the own-blob unique table
    dict_hit: Optional[ChunkRecord] = None


@dataclass
class _Meta:
    entry: fstree.FileEntry
    size: int = 0
    chunks: list[_ChunkRef] = field(default_factory=list)


class _CountingWriter:
    """Tracks the write position so ``dest`` needn't be seekable."""

    def __init__(self, f: BinaryIO):
        self.f = f
        self.pos = 0

    def write(self, b) -> int:
        self.f.write(b)
        self.pos += len(b)
        return len(b)

    def tell(self) -> int:
        return self.pos


def _make_compressor(compressor: str, lz4_accel: int = 1, codec=None):
    """One reusable codec per Pack: ``data -> (frame, chunk flag)``, the
    reference's ``converter/convert._make_compressor``. An adaptive
    ``codec`` (converter/codec.AdaptiveCodec) takes over the zstd lane
    (probe, bypass, per-class levels, trained dictionary). Otherwise zstd
    goes through the system libzstd when it is bound and through the
    ``zstandard`` of utils/zstdcompat only when it is not."""
    if codec is not None and compressor == "zstd":
        return codec.encode
    if compressor == "zstd":
        if zstd_native.available():
            return lambda data: (
                zstd_native.compress_block(data, constants.ZSTD_LEVEL),
                constants.COMPRESSOR_ZSTD,
            )
        from nydus_snapshotter_tpu_torch.utils.zstdcompat import zstandard

        ctx = zstandard.ZstdCompressor(level=constants.ZSTD_LEVEL)
        return lambda data: (ctx.compress(data), constants.COMPRESSOR_ZSTD)
    if compressor == "lz4_block":
        return lambda data: (lz4.compress_block(data, lz4_accel), constants.COMPRESSOR_LZ4_BLOCK)
    return lambda data: (data, constants.COMPRESSOR_NONE)


class _SectionWriter:
    """Streams the image.blob data section: alignment, batch packing,
    compression, encryption, hashing, extent accounting (the reference's
    converter/stream.py:270-340). With ``opt.encrypt`` every section byte
    goes through one AES-256-CTR stream keyed by a fresh
    ``crypto.generate_context()``, recorded as ``cipher``; the section
    digest is over the ciphertext."""

    def __init__(self, out: _CountingWriter, opt: PackOption, compress):
        self.out = out
        self.compress = compress
        self.align = 4096 if (opt.aligned_chunk and opt.fs_version == layout.RAFS_V5) else 1
        self.batch_size = opt.batch_size
        self.hasher = hashlib.sha256()
        self.cipher: Optional[CipherRecord] = None
        self._encryptor = None
        if opt.encrypt:
            key, iv = crypto.generate_context()
            self.cipher = CipherRecord(algo=crypto.CIPHER_AES_256_CTR, key=key, iv=iv)
            self._encryptor = crypto.stream_encryptor(key, iv)
        self.coff = 0  # current offset within the data section
        self.extents: list[Optional[tuple[int, int, int]]] = []  # per unique chunk
        self.batches: list[tuple[int, int, int]] = []  # (coff, uncomp_base, usize)
        self._pending: list[tuple[int, bytes, int]] = []  # (uniq_idx, data, uoff)
        self._pending_bytes = 0

    def _write_raw(self, b) -> None:
        if self._encryptor is not None:
            b = self._encryptor.update(b)
        self.hasher.update(b)
        self.out.write(b)
        self.coff += len(b)

    def _emit(self, comp) -> int:
        pad = (-self.coff) % self.align
        if pad:
            self._write_raw(b"\x00" * pad)
        start = self.coff
        self._write_raw(comp)
        return start

    def _flush_batch(self) -> None:
        if not self._pending:
            return
        comp, cflag = self.compress(b"".join(d for _, d, _ in self._pending))
        start = self._emit(comp)
        for idx, _d, _u in self._pending:
            self.extents[idx] = (start, len(comp), cflag | CHUNK_FLAG_BATCH)
        self.batches.append((start, self._pending[0][2], self._pending_bytes))
        self._pending = []
        self._pending_bytes = 0

    def add(self, uniq_idx: int, data, uoff: int, precomp=None) -> None:
        """Store unique chunk ``uniq_idx`` (uncompressed offset ``uoff``);
        unique chunks arrive in index order. ``precomp``: the chunk's
        ``(frame, flag)`` compressed off-thread by the pipeline (the same
        deterministic codec, so the same bytes)."""
        assert uniq_idx == len(self.extents)
        self.extents.append(None)
        if self.batch_size and len(data) < self.batch_size:
            if self._pending_bytes + len(data) > self.batch_size:
                self._flush_batch()
            self._pending.append((uniq_idx, data, uoff))
            self._pending_bytes += len(data)
        else:
            self._flush_batch()
            comp, cflag = precomp if precomp is not None else self.compress(data)
            self.extents[uniq_idx] = (self._emit(comp), len(comp), cflag)

    def finish(self) -> None:
        self._flush_batch()
        if self._encryptor is not None:
            tail = self._encryptor.finalize()
            if tail:
                self.hasher.update(tail)
                self.out.write(tail)
                self.coff += len(tail)


class _SectionDigest:
    """The ``hasher`` of :class:`_DeferredSectionWriter`: the section
    digest the native pass computed."""

    def __init__(self) -> None:
        self._d = b""

    def digest(self) -> bytes:
        return self._d

    def hexdigest(self) -> str:
        return self._d.hex()


class _DeferredSectionWriter:
    """The blob data section assembled in one native pass at ``finish``
    (the reference's converter/stream.py:356-463).

    ``add`` only records each unique chunk's extent: a chunk that is a view
    into the tar buffer becomes a zero-copy (0, offset, size) extent, any
    other chunk (``bytes``, or a view of another buffer) is copied into a
    side buffer as (1, offset, size). ``finish`` hands the extents to
    ``native_cdc.pack_section``, which compresses, appends and hashes over
    ``_pack_threads()`` workers. It writes what :class:`_SectionWriter`
    writes for packed chunks (align 1, no batches, no cipher). When the
    engine cannot dlopen the codec's system library, the extents replay
    through the Python codec: the same bytes, on one thread.
    """

    def __init__(self, out: _CountingWriter, opt: PackOption, compress, raw: memoryview):
        self.out = out
        self.compress = compress  # the replay only
        self.hasher = _SectionDigest()
        self.cipher = None  # never encrypted: encrypt=True takes _SectionWriter
        self.coff = 0
        self.extents: list[Optional[tuple[int, int, int]]] = []
        self.batches: list[tuple[int, int, int]] = []
        self._kind = {"lz4_block": 1, "zstd": 2}.get(opt.compressor, 0)
        # the codec parameter: lz4's acceleration, or zstd's level
        self._accel = constants.ZSTD_LEVEL if self._kind == 2 else opt.lz4_acceleration
        self._cflag = {
            "lz4_block": constants.COMPRESSOR_LZ4_BLOCK,
            "zstd": constants.COMPRESSOR_ZSTD,
        }.get(opt.compressor, constants.COMPRESSOR_NONE)
        self._raw_arr = np.frombuffer(raw, dtype=np.uint8)
        self._base = self._raw_arr.ctypes.data
        self._raw_len = len(raw)
        self._items: list[tuple[int, int, int]] = []
        self._side = bytearray()
        self.native: Optional[bool] = None  # set by finish: native pass, or replay
        self.threads = 0

    def add(self, uniq_idx: int, data, uoff: int, precomp=None) -> None:
        assert uniq_idx == len(self._items)
        size = len(data)
        if isinstance(data, memoryview):
            off = np.frombuffer(data, dtype=np.uint8).ctypes.data - self._base
            if 0 <= off and off + size <= self._raw_len:
                self._items.append((0, off, size))
                return
            data = bytes(data)
        self._items.append((1, len(self._side), size))
        self._side += data

    def source_counts(self) -> tuple[int, int]:
        """(extents recorded from the tar buffer, from loose bytes)."""
        src1 = sum(1 for src, _o, _s in self._items if src)
        return len(self._items) - src1, src1

    def finish(self) -> None:
        if not self._items:
            return
        with trace.span("pack.assemble", chunks=len(self._items)):
            self._finish()

    def _finish(self) -> None:
        ext = np.asarray(self._items, dtype=np.int64)
        side = np.frombuffer(self._side, dtype=np.uint8) if self._side else np.empty(0, np.uint8)
        self.threads = _pack_threads()
        res = native_cdc.pack_section(self._raw_arr, side, ext, self._kind, self._accel, self.threads)
        self.native = res is not None
        if res is None:
            hasher = hashlib.sha256()
            for src, off, size in self._items:
                buf = self._raw_arr[off : off + size] if src == 0 else side[off : off + size]
                comp, cflag = self.compress(memoryview(buf))
                self.extents.append((self.coff, len(comp), cflag))
                hasher.update(comp)
                self.out.write(comp)
                self.coff += len(comp)
            self.hasher._d = hasher.digest()
            return
        self._adopt(*res)

    def _adopt(self, blob, comp_extents, digest: bytes) -> None:
        """Take a native pass's assembled section (``finish`` and
        ``finish_fused``)."""
        self.extents = [
            (int(comp_extents[j, 0]), int(comp_extents[j, 1]), self._cflag)
            for j in range(comp_extents.shape[0])
        ]
        self.hasher._d = digest
        if blob.size:
            self.out.write(memoryview(blob))
        self.coff = int(blob.size)

    def finish_fused(self, blob, comp_extents, digest: bytes) -> None:
        """Take the output of the whole-layer ``pack_files`` pass, which
        already compressed, assembled and hashed; nothing was ``add``ed, so
        ``finish`` stays a no-op."""
        self.native = True
        self._adopt(blob, comp_extents, digest)


def _pack_threads() -> int:
    """Workers of the native section pass (and the test of the
    single-thread host lanes): ``NTPU_PACK_THREADS`` asks for a count,
    capped at ``os.cpu_count()`` unless ``NTPU_PACK_THREADS_FORCE`` is set
    (not "" or "0"); by default the core count."""
    try:
        n = int(os.environ.get("NTPU_PACK_THREADS", ""))
    except ValueError:
        n = 0
    ncpu = os.cpu_count() or 1
    if n >= 1:
        if os.environ.get("NTPU_PACK_THREADS_FORCE", "") not in ("", "0"):
            return n
        return min(n, ncpu)
    return ncpu


def match_prefetch_paths(inodes, patterns: str) -> list[str]:
    """Resolve prefetch patterns to regular-file inode paths, hint order.

    Reference semantics (--prefetch-files, one path per line,
    daemon_adaptor.go:179-185): each line names a file or a directory
    prefix; directories expand to every regular file beneath them. Unknown
    patterns are skipped (hints, not requirements).
    """
    wanted: list[str] = []
    seen: set[str] = set()
    lines = [ln.strip() for ln in patterns.splitlines() if ln.strip()]
    reg_paths = [i.path for i in inodes if stat.S_ISREG(i.mode)]
    for line in lines:
        norm = "/" + line.strip("/") if line != "/" else "/"
        prefix = norm if norm == "/" else norm + "/"
        for path in reg_paths:
            if (path == norm or path.startswith(prefix)) and path not in seen:
                seen.add(path)
                wanted.append(path)
    return wanted


def _check_options(opt: PackOption) -> None:
    opt.validate()
    if opt.backend not in ("fused", "jax", "hybrid", "numpy"):
        raise ConvertError(f"Pack does not support backend={opt.backend!r}")


def _tar_num(field: memoryview) -> int:
    """Tar numeric field: octal decoded inline (the ~100% case — int(_, 8)
    over the NUL-terminated, space-stripped text, exactly tarfile.nti's
    octal branch), GNU base-256 (lead byte 0x80/0xFF, e.g. >8 GiB sizes or
    pre-epoch mtimes) delegated to tarfile's decoder — one source of truth
    for the exotic branch; malformed fields raise ValueError so the fast
    scanner bails to tarfile."""
    b = bytes(field)
    if b and b[0] in (0x80, 0xFF):
        try:
            return tarfile.nti(b)
        except tarfile.InvalidHeaderError as e:
            raise ValueError(str(e)) from e
    end = b.find(0)
    s = (b if end < 0 else b[:end]).strip()
    if not s:
        return 0
    return int(s, 8)  # ValueError on garbage, as tarfile.nti raises


_TAR_PLAIN_TYPES = (b"0", b"\x00", b"1", b"2", b"3", b"4", b"5", b"6", b"7")


def _parse_pax_records(data: bytes) -> "dict[str, str] | None":
    """Decode a pax extended header block ("%d key=value\\n" records);
    None on malformed framing. Values decode utf-8/surrogateescape — the
    same round-trip tarfile uses, so binary xattrs survive."""
    out: dict[str, str] = {}
    pos = 0
    n = len(data)
    while pos < n:
        if data[pos] == 0:
            break  # zero padding after the last record
        sp = data.find(b" ", pos, pos + 20)
        if sp < 0:
            return None
        try:
            length = int(data[pos:sp])
        except ValueError:
            return None
        end = pos + length
        if length < sp - pos + 3 or end > n or data[end - 1] != 0x0A:
            return None
        eq = data.find(b"=", sp + 1, end)
        if eq < 0:
            return None
        key = data[sp + 1 : eq].decode("utf-8", "surrogateescape")
        out[key] = data[eq + 1 : end - 1].decode("utf-8", "surrogateescape")
        pos = end
    return out


def _fast_tar_members(raw: memoryview):
    """Header walk over an in-memory tar: [(TarInfo, data_offset)], or
    None when the archive needs tarfile's full machinery.

    tarfile.TarInfo.frombuf costs ~30 µs/member (field-by-field parse,
    encoding fallbacks) — ~20% of full-path convert on a node_modules-
    shaped layer. This scanner handles plain ustar/GNU members plus pax
    ``x`` extended headers (Go's archive/tar — the writer behind real
    docker layers — emits pax for xattrs/long names/big files) with
    checksum verification, and bails to tarfile for anything else: pax
    globals (g), GNU longname/longlink (L/K), sparse (S), non-ustar
    magic, truncated data, or a non-regular member carrying data. A None
    return loses nothing but the speedup.
    """
    out: list[tuple[tarfile.TarInfo, int]] = []
    pos = 0
    n = len(raw)
    saw_end = False
    pending_pax: "dict[str, str] | None" = None
    while pos + 512 <= n:
        hdr = raw[pos : pos + 512]
        hb = bytes(hdr)
        if hb[0] == 0:
            if hb.count(0) == 512:
                saw_end = True
                break  # end-of-archive
            return None
        if hb[257:263] not in (b"ustar\x00", b"ustar "):
            return None
        typ = hb[156:157]
        if typ not in _TAR_PLAIN_TYPES and typ != b"x":
            return None
        try:
            mode = _tar_num(hdr[100:108])
            uid = _tar_num(hdr[108:116])
            gid = _tar_num(hdr[116:124])
            size = _tar_num(hdr[124:136])
            mtime = _tar_num(hdr[136:148])
            chksum = _tar_num(hdr[148:156])
        except ValueError:
            return None
        if size < 0:
            # GNU base-256 can encode negative values; a negative size
            # would make the scan position stop advancing (infinite loop)
            # — bail and let tarfile reject the archive.
            return None
        if chksum != sum(hb) - sum(hb[148:156]) + 8 * 0x20:
            return None
        if typ == b"x":
            # pax extended header: records apply to the NEXT member.
            end = pos + 512 + size
            if end > n:
                return None
            pax = _parse_pax_records(bytes(raw[pos + 512 : end]))
            if pax is None:
                return None
            if any(k.startswith("GNU.sparse") for k in pax):
                # pax-sparse members need tarfile's sparse-map handling
                # (_proc_gnusparse_*): the data region is a packed map +
                # holes, not the file bytes.
                return None
            pending_pax = pax
            pos = pos + 512 + 512 * ((size + 511) // 512)
            continue
        if typ not in (b"0", b"\x00", b"7"):
            if size != 0:
                return None  # non-regular member carrying data: exotic
            data_size = 0
        else:
            data_size = size
        name = hb[:100].split(b"\x00", 1)[0].decode("utf-8", "surrogateescape")
        if hb[257:263] == b"ustar\x00":
            prefix = hb[345:500].split(b"\x00", 1)[0]
            if prefix:
                name = prefix.decode("utf-8", "surrogateescape") + "/" + name
        # tarfile semantics: a trailing slash marks a directory (even with
        # a regular typeflag) and is stripped from the stored name.
        if name.endswith("/"):
            if typ in (b"0", b"\x00"):
                typ = b"5"
            name = name.rstrip("/")
        ti = tarfile.TarInfo(name)
        ti.mode = mode
        ti.uid = uid
        ti.gid = gid
        ti.size = size
        ti.mtime = mtime
        ti.type = typ
        ti.linkname = hb[157:257].split(b"\x00", 1)[0].decode(
            "utf-8", "surrogateescape"
        )
        if typ in (b"3", b"4"):
            try:
                ti.devmajor = _tar_num(hdr[329:337])
                ti.devminor = _tar_num(hdr[337:345])
            except ValueError:
                return None  # malformed device numbers: let tarfile decide
        if pending_pax is not None:
            # Apply overrides exactly as tarfile._apply_pax_info does for
            # the fields this pipeline consumes.
            p = pending_pax
            try:
                if "path" in p:
                    # tarfile._apply_pax_info only rstrips; it never
                    # retypes on a trailing slash (that V7 rule applies to
                    # base-header names only).
                    ti.name = p["path"].rstrip("/")
                if "linkpath" in p:
                    ti.linkname = p["linkpath"]
                if "size" in p:
                    ti.size = int(p["size"])
                    if ti.size < 0:
                        # Bailing to tarfile is NOT safe here: tarfile
                        # walks backwards off the member and silently
                        # yields nothing more — a data-losing "valid"
                        # image. Reject outright.
                        raise ConvertError(
                            f"bad layer tar: negative pax size for {ti.name!r}"
                        )
                    if typ in (b"0", b"\x00", b"7"):
                        data_size = ti.size
                if "mtime" in p:
                    ti.mtime = float(p["mtime"])
                    if not math.isfinite(ti.mtime):
                        # nan/inf would escape later as a bare ValueError
                        # from int(mtime); bail to tarfile instead.
                        return None
                if "uid" in p:
                    ti.uid = int(p["uid"])
                if "gid" in p:
                    ti.gid = int(p["gid"])
            except ValueError:
                return None
            ti.pax_headers = p
            pending_pax = None
        data_off = pos + 512
        pos = data_off + 512 * ((data_size + 511) // 512)
        if pos > n:
            return None  # truncated member data: let tarfile raise
        out.append((ti, data_off))
    # Without the end-of-archive zero block the input is truncated or not
    # a tar at all (e.g. a few garbage bytes) — bail so tarfile raises the
    # proper error instead of silently converting to an empty image.
    return out if saw_end else None


class IncrementalChunker:
    """Per-file CDC with bounded carry.

    A FastCDC cut ending the chunk that starts at ``s`` depends only on
    bytes ``[s, s + max_size)``, so any cut whose chunk start has a full
    ``max_size`` of lookahead in the buffer is final; the rest is carried.
    Produces exactly the cuts a whole-stream run produces. Boundaries go
    through the engine (``jax``/``fused``: the windowed device lane;
    ``hybrid``: the native chunker; ``numpy``: the host); callers packing
    many files share one engine. When the engine's native chunk+digest arm
    applies (``hybrid`` CDC with host digests) every chunk comes with its
    digest; otherwise the digest is None.
    """

    def __init__(self, opt: PackOption, engine: ChunkDigestEngine | None = None, device=None):
        self._engine = engine or ChunkDigestEngine(
            chunk_size=opt.chunk_size,
            mode=opt.chunking,
            backend=opt.backend,
            digest_backend=opt.digest_backend or None,
            digester=opt.digester,
            device=device,
        )
        params = self._engine.params
        self.lookahead = params.max_size if params else opt.chunk_size
        self.fused = self._engine._fused_available()
        self._buf = bytearray()

    def _cuts(self, arr: np.ndarray) -> tuple[np.ndarray, Optional[bytes]]:
        if self.fused:
            return native_cdc.chunk_digest_native(
                arr, self._engine.params, digester=self._engine.digester
            )
        return self._engine.boundaries(arr), None

    def feed(self, seg: bytes) -> list[tuple[bytes, Optional[bytes]]]:
        self._buf += seg
        if len(self._buf) < 2 * self.lookahead:
            return []
        return self._drain(final=False)

    def finish(self) -> list[tuple[bytes, Optional[bytes]]]:
        out = self._drain(final=True)
        self._buf = bytearray()
        return out

    def _drain(self, final: bool) -> list[tuple[bytes, Optional[bytes]]]:
        buf = self._buf
        if not buf:
            return []
        cuts, digests = self._cuts(np.frombuffer(buf, dtype=np.uint8))
        out = []
        s = 0
        for i, c in enumerate(cuts):
            c = int(c)
            if not final and s + self.lookahead > len(buf):
                break
            digest = digests[32 * i : 32 * i + 32] if digests is not None else None
            out.append((bytes(buf[s:c]), digest))
            s = c
        self._buf = bytearray(buf[s:]) if not final else bytearray()
        return out

    def chunk_whole(self, view: memoryview) -> list[tuple[memoryview, Optional[bytes]]]:
        """Chunks of a complete in-memory file as zero-copy views, with
        their digests where the native arm made them."""
        if len(view) == 0:
            return []
        cuts, digests = self._cuts(np.frombuffer(view, dtype=np.uint8))
        out = []
        s = 0
        for i, c in enumerate(cuts):
            digest = digests[32 * i : 32 * i + 32] if digests is not None else None
            out.append((view[s : int(c)], digest))
            s = int(c)
        return out


def _pipeline_for(plan, raw, arr_all, n_threads, opt, shared, section, chunk_dict, budget, stats, codec):
    """The stage-parallel pipeline for the per-file lane, or None where the
    reference's ``pack_stream`` walks serially (converter/stream.py:1109-1183):
    the host backends (``hybrid``, ``numpy``) without device digests, more
    than one thread and more than one file above the minimum chunk, and the
    pipeline enabled (``NTPU_PIPELINE`` / ``[convert] pipeline``)."""
    from nydus_snapshotter_tpu_torch.parallel import pipeline as pipeline_mod

    file_idxs = [i for i, (tag, *_r) in enumerate(plan) if tag == "file"]
    if not (
        n_threads > 1
        and len(file_idxs) > 1
        and opt.backend in ("hybrid", "numpy")
        and opt.digest_backend != "jax"
    ):
        return None
    pcfg = pipeline_mod.resolve_config(n_threads)
    if not pcfg.enabled:
        return None
    # Engines that cut without digesting: the worker digests its file's
    # chunks on the host (the same digests the batched dispatch makes), so
    # dedup and speculative compression can run ahead of the ordered walk.
    digest_fn = None if shared.fused else host_digests_for(opt.digester)

    def chunk_one(i: int):
        _tag, _meta, off, size = plan[i]
        chunks = shared.chunk_whole(raw[off : off + size])
        if digest_fn is not None and chunks:
            items, s = [], off
            for view, _d in chunks:
                items.append((arr_all, s, len(view)))
                s += len(view)
            chunks = [(v, d) for (v, _d), d in zip(chunks, digest_fn(items))]
        return chunks

    compress_fn = compress_eligible = None
    if opt.compressor in ("lz4_block", "zstd") and not isinstance(section, _DeferredSectionWriter):
        # The deferred writer compresses in its own native pass; speculating
        # here would do the work twice. Per-thread codec contexts, every
        # codec deterministic in chunk content (the adaptive one too).
        from nydus_snapshotter_tpu_torch.converter.convert import ThreadSafeCompressor

        compress_fn = ThreadSafeCompressor(opt.compressor, opt.lz4_acceleration, codec=codec)
        batch_limit = opt.batch_size

        def compress_eligible(digest, view):
            if batch_limit and len(view) < batch_limit:
                return False  # batch-packed: compressed jointly
            if chunk_dict is not None and chunk_dict.get(digest):
                return False  # a dict hit is never stored
            return True

    return pipeline_mod.ConvertPipeline(
        items=[(i, plan[i][3]) for i in file_idxs],
        chunk_fn=chunk_one,
        compress_fn=compress_fn,
        compress_eligible=compress_eligible,
        config=pcfg,
        budget=budget,
        stats=stats,
    )


def Pack(
    dest: BinaryIO,
    src_tar: "BinaryIO | bytes",
    opt: PackOption,
    chunk_dict=None,
    device: "str | torch.device | None" = None,
    stats: "Optional[dict]" = None,
    budget=None,
    codec=None,
) -> PackResult:
    """Stream one OCI layer tar into a nydus blob written to ``dest``.

    ``src_tar`` is the whole tar in memory (bytes) or a file-like object,
    read once, front to back. ``chunk_dict`` is a loaded dict object
    (``ChunkDict``, ``GrowingChunkDict``, ``ServiceChunkDict`` or anything
    with their get/blob_id_for/bootstrap interface); without one,
    ``opt.chunk_dict_path`` opens one (``open_chunk_dict``: a service
    mirror, closed when the pack ends, or a bootstrap file). ``device`` is
    where the device backends run (CUDA unless ``"cpu"`` is asked for).

    ``stats``: optional dict that accumulates wall seconds per stage, with
    the reference's keys, from the start of the tar walk (every pack adds
    the same seconds to ``ntpu_pack_stage_seconds{stage}``): ``scan`` (tar
    walk and metadata), ``chunk_digest`` (cuts and chunk digests: engine
    and chunker calls, digest batch submit and collect), ``assemble``
    (compression, blob append, blob digest: with the deferred writer its
    native pass at the end), ``fused_pack`` (the ``hybrid`` lane's
    whole-layer ``pack_files`` call, which chunks, dedups and assembles at
    once), ``dedup`` (the rest of the chunk lane: dedup, dict lookups,
    bookkeeping) and ``bootstrap`` (tables, serialization, TOC). Chunk-digest
    and assemble seconds are timed where they are spent, during the walk
    too. ``PackResult.route`` says which lane and section writer ran. A
    pipelined pack adds the pipeline's keys (``pipeline_chunk_busy``,
    ``pipeline_compress_busy``, ``pipeline_assemble_wait``,
    ``pipeline_runs``).

    ``budget``: a :class:`parallel.pipeline.MemoryBudget` bounding this
    pack's speculative-compression bytes in flight on the pipelined lane
    (``BatchConverter`` passes one budget for every layer it packs at
    once); None draws from the process-wide ``shared_budget()``.

    ``codec``: an adaptive codec (converter/codec.AdaptiveCodec) for the
    zstd lane; None resolves one from the ``[compression]`` settings as the
    reference's ``pack_stream`` does (``codec.resolve_codec``: None unless
    the adaptive engine is on and the compressor is zstd).
    """
    failpoint.hit("converter.pack")
    _check_options(opt)
    opened = None
    if chunk_dict is None and opt.chunk_dict_path:
        from nydus_snapshotter_tpu_torch.parallel.dict_service import open_chunk_dict

        chunk_dict = opened = open_chunk_dict(opt.chunk_dict_path)
    try:
        return _pack(dest, src_tar, opt, chunk_dict, device, stats, budget, codec)
    finally:
        if hasattr(opened, "close"):  # a service mirror's connections
            opened.close()


def _pack(dest, src_tar, opt: PackOption, chunk_dict, device, stats, budget, codec) -> PackResult:
    shared = IncrementalChunker(opt, device=device)
    engine = shared._engine
    # Device digests (K2, or K4 for BLAKE3) for the jax lane whatever
    # digest_backend says, and wherever the engine's digest backend is the
    # device's (the fused lane's default, or digest_backend="jax").
    if opt.backend == "jax" or engine.digest_backend == "jax":
        digester = engine.device_digester or DeviceDigester(engine.device or device, opt.digester)
    else:
        digester = HostDigester(opt.digester)
    raw: Optional[memoryview] = None
    if isinstance(src_tar, (bytes, bytearray)):
        raw = memoryview(src_tar)
        src_tar = io.BytesIO(src_tar)
    if codec is None:
        codec = codec_mod.resolve_codec(opt)
    out = _CountingWriter(dest)
    compress = _make_compressor(opt.compressor, opt.lz4_acceleration, codec=codec)
    align_needed = opt.aligned_chunk and opt.fs_version == layout.RAFS_V5
    if (
        raw is not None
        and opt.compressor in ("none", "lz4_block", "zstd")
        # an active codec owns the per-chunk frame decisions and the cipher
        # is a stream over the whole section: the native section pass does
        # neither, so both take the serial writer on every lane
        and codec is None
        and not opt.encrypt
        and not opt.batch_size
        and not align_needed
        and native_cdc.pack_section_available()
    ):
        section = _DeferredSectionWriter(out, opt, compress, raw)
    else:
        section = _SectionWriter(out, opt, compress)

    metas: dict[str, _Meta] = {}
    opaque_dirs: list[str] = []
    # In-memory files, in tar order: (tag, meta, data offset, size). On the
    # native host lane files no larger than the minimum chunk (one chunk
    # each) are tagged "small" and digested together in one batch.
    plan: list[tuple[str, _Meta, int, int]] = []
    params = engine.params
    small_max = params.min_size if params is not None else opt.chunk_size
    defer_small = raw is not None and shared.fused

    # Dedup state (chunk order = tar order; deterministic).
    own_chunks: dict[bytes, int] = {}
    uncomp_offsets: list[int] = []
    uoff = 0
    dict_hits: dict[bytes, ChunkRecord] = {}
    dict_blobs_used: list[str] = []

    # One digest batch in flight: (handle, [(meta, data)]).
    pending: list[tuple[_Meta, memoryview]] = []
    pending_bytes = 0
    in_flight = None
    t_chunk = t_asm = t_fused = 0.0  # stage seconds timed at their call sites

    def _process(batch: list[tuple[_Meta, memoryview]], digests: list[bytes], comp_cache=None) -> None:
        nonlocal uoff, t_asm
        for (meta, data), digest in zip(batch, digests):
            ref = _ChunkRef(digest=digest, size=len(data))
            if chunk_dict is not None and digest not in dict_hits and digest not in own_chunks:
                hit = chunk_dict.get(digest)
                if hit is not None:
                    dict_hits[digest] = hit
                    bid = chunk_dict.blob_id_for(hit)
                    if bid not in dict_blobs_used:
                        dict_blobs_used.append(bid)
            if digest in dict_hits:
                ref.dict_hit = dict_hits[digest]
            else:
                idx = own_chunks.get(digest)
                if idx is None:
                    idx = len(uncomp_offsets)
                    own_chunks[digest] = idx
                    uncomp_offsets.append(uoff)
                    t0 = perf_counter()
                    # pop: each unique digest reaches here once, so the
                    # pipeline's speculative frame is released as it is used
                    section.add(idx, data, uoff,
                                precomp=comp_cache.pop(digest, None) if comp_cache else None)
                    t_asm += perf_counter() - t0
                    uoff += len(data)
                ref.uniq_idx = idx
            meta.chunks.append(ref)

    def _dispatch() -> None:
        nonlocal pending, pending_bytes, in_flight, t_chunk
        if in_flight is not None:
            handle, batch = in_flight
            in_flight = None
            t0 = perf_counter()
            digests = digester.collect(handle)
            t_chunk += perf_counter() - t0
            _process(batch, digests)
        if pending:
            items = [(np.frombuffer(d, dtype=np.uint8), 0, len(d)) for _m, d in pending]
            t0 = perf_counter()
            in_flight = (digester.submit(items), pending)
            t_chunk += perf_counter() - t0
            pending, pending_bytes = [], 0

    def _add_chunk(meta: _Meta, data, digest: Optional[bytes] = None) -> None:
        nonlocal pending_bytes
        if digest is not None:
            # the native arm digested it with its cuts: store it now, in order
            _process([(meta, data)], [digest])
            return
        pending.append((meta, data))
        pending_bytes += len(data)
        if pending_bytes >= DIGEST_BATCH_BYTES:
            _dispatch()

    def walk_member(tf: "tarfile.TarFile | None", info: tarfile.TarInfo, data_off) -> None:
        nonlocal t_chunk
        path = fstree.norm_path(info.name)
        special = fstree.classify_special(path)
        if special is not None:
            kind, target = special
            if kind == "opaque":
                opaque_dirs.append(target)
            else:
                metas[target] = _Meta(entry=fstree.whiteout_entry(target))
            return
        entry = fstree.entry_from_tarinfo(tf, info, path, with_data=False)
        meta = _Meta(entry=entry)
        # A path repeated in the tar: last entry wins (as in a real
        # extraction); chunks already written for the earlier one stay in
        # the blob as dead bytes.
        metas[path] = meta
        if not (entry.is_regular and info.size > 0):
            return
        meta.size = info.size
        if data_off is not None and not getattr(info, "sparse", None):
            # zero-copy: the member's bytes are a slice of the caller's buffer
            tag = "small" if defer_small and info.size <= small_max else "file"
            plan.append((tag, meta, data_off, info.size))
            return
        # streaming input, or a sparse member (its data is stored compacted)
        f = tf.extractfile(info)
        if f is None:
            raise ConvertError(f"tar member {path!r} has no data stream")
        chunker = IncrementalChunker(opt, engine=engine)
        while True:
            seg = f.read(SEGMENT_BYTES)
            if not seg:
                break
            t0 = perf_counter()
            chunks = chunker.feed(seg)
            t_chunk += perf_counter() - t0
            for chunk, digest in chunks:
                _add_chunk(meta, chunk, digest)
        t0 = perf_counter()
        chunks = chunker.finish()
        t_chunk += perf_counter() - t0
        for chunk, digest in chunks:
            _add_chunk(meta, chunk, digest)

    t_walk = perf_counter()
    members = _fast_tar_members(raw) if raw is not None else None
    if members is not None:
        for info, data_off in members:
            walk_member(None, info, data_off)  # the data is read through raw
    else:
        try:
            # random access for in-memory layers, one pass for a stream
            tf = tarfile.open(fileobj=src_tar, mode="r:" if raw is not None else "r|")
        except tarfile.TarError as e:
            raise ConvertError(f"bad layer tar: {e}") from e
        with tf:
            try:
                for info in tf:
                    walk_member(tf, info, info.offset_data if raw is not None else None)
            except tarfile.TarError as e:
                raise ConvertError(f"bad layer tar: {e}") from e
    t_lane = perf_counter()
    walk_chunk, walk_asm = t_chunk, t_asm
    lane = "per_file" if raw is not None else "stream"

    n_threads = _pack_threads()
    arr_all = np.frombuffer(raw, dtype=np.uint8) if raw is not None else None
    # The single-thread host lanes (converter/stream.py:955-1045): one
    # native call for every planned file.
    use_multi = (
        plan
        and n_threads == 1
        and shared.fused
        and opt.chunking == "cdc"
        and native_cdc.chunk_digest_multi_available()
    )
    if (
        use_multi
        and chunk_dict is None
        and isinstance(section, _DeferredSectionWriter)
        and native_cdc.pack_files_available()
        # the pass owns the whole dedup and storage state: nothing may
        # have been stored during the walk (sparse members stream then)
        and uoff == 0
        and not own_chunks
        and not pending
        and in_flight is None
        and not section._items
    ):
        ext = np.asarray([(off, size) for _t, _m, off, size in plan], dtype=np.int64)
        t0 = perf_counter()
        fused = native_cdc.pack_files(
            arr_all, ext, params, section._kind, section._accel, n_threads, digester=opt.digester
        )
        if fused is not None:
            digs, sizes, uniq = fused["digests"], fused["chunk_sizes"], fused["chunk_uniq"]
            pos = 0
            for (_tag, meta, _off, _size), nc in zip(plan, fused["file_nchunks"]):
                for k in range(pos, pos + int(nc)):
                    meta.chunks.append(
                        _ChunkRef(digest=digs[32 * k : 32 * k + 32], size=int(sizes[k]),
                                  uniq_idx=int(uniq[k]))
                    )
                pos += int(nc)
            usz = fused["uniq_sizes"]
            if len(usz):
                uncomp_offsets = np.concatenate([[0], np.cumsum(usz[:-1])]).astype(np.int64).tolist()
                uoff = int(usz.sum())
            section.threads = n_threads
            section.finish_fused(fused["blob"], fused["comp_extents"], fused["blob_digest"])
            plan = []
            lane = "pack_files"
        t_fused += perf_counter() - t0
    if use_multi and plan:
        ext = np.asarray([(off, size) for _t, _m, off, size in plan], dtype=np.int64)
        t0 = perf_counter()
        ncuts, cuts_all, digs_all = native_cdc.chunk_digest_multi(
            arr_all, ext, params, digester=opt.digester
        )
        t_chunk += perf_counter() - t0
        pos = 0
        for (_tag, meta, off, size), nc in zip(plan, ncuts):
            view = raw[off : off + size]
            batch, dlist, s0 = [], [], 0
            for k in range(pos, pos + int(nc)):
                c = int(cuts_all[k])
                batch.append((meta, view[s0:c]))
                dlist.append(digs_all[32 * k : 32 * k + 32])
                s0 = c
            _process(batch, dlist)
            pos += int(nc)
        plan = []
        lane = "chunk_digest_multi"

    if plan and opt.backend == "fused" and opt.chunking == "cdc":
        # The whole layer through the engine's device full path, which falls
        # to its per-file windowed lane on FusedOverflow.
        fallbacks = engine.stats["fused_fallbacks"]
        t0 = perf_counter()
        per_file = engine.process_many([arr_all[off : off + size] for _t, _m, off, size in plan])
        t_chunk += perf_counter() - t0
        if engine.stats["fused_fallbacks"] > fallbacks:
            # The reference's per-file lane queues these chunks behind the
            # walk's streamed ones (converter/stream.py:1198-1221): store
            # those first.
            _dispatch()
            _dispatch()
        for (_tag, meta, off, _size), chunks in zip(plan, per_file):
            _process(
                [(meta, raw[off + c.offset : off + c.offset + c.size]) for c in chunks],
                [c.digest for c in chunks],
            )
        plan = []
        lane = "fused"
    small = [(arr_all, off, size) for tag, _m, off, size in plan if tag == "small"]
    if small:
        t0 = perf_counter()
        small_digests = iter(host_digests_for(opt.digester)(small))
        t_chunk += perf_counter() - t0
    pipe = _pipeline_for(
        plan, raw, arr_all, n_threads, opt, shared, section, chunk_dict, budget, stats, codec
    )
    if pipe is not None:
        # Walk-time chunks (sparse members) wait in the digest batches and
        # the serial lane stores them before the plan's: store them now, as
        # the pipelined lane stores each file at once.
        _dispatch()
        _dispatch()
        lane = "pipeline"
    comp_cache = pipe.comp if pipe is not None and pipe.compress_fn is not None else None
    # The per-file lane, files in tar order: their chunks from the pipeline's
    # workers, or cut here on one thread.
    with pipe if pipe is not None else contextlib.nullcontext():
        for i, (tag, meta, off, size) in enumerate(plan):
            view = raw[off : off + size]
            if tag == "small":
                _process([(meta, view)], [next(small_digests)])
                continue
            t0 = perf_counter()
            chunks = pipe.chunks_for(i) if pipe is not None else shared.chunk_whole(view)
            t_chunk += perf_counter() - t0
            if chunks and chunks[0][1] is not None:
                _process([(meta, c) for c, _d in chunks], [d for _c, d in chunks], comp_cache)
            else:
                for chunk, _d in chunks:
                    _add_chunk(meta, chunk)
    _dispatch()  # collects the batch in flight, submits the rest
    _dispatch()  # collects the rest
    t0 = perf_counter()
    section.finish()
    t_end = perf_counter()
    t_asm += t_end - t0
    if isinstance(section, _DeferredSectionWriter):
        src0, src1 = section.source_counts()
        route = {"lane": lane, "writer": "deferred", "native": section.native,
                 "threads": section.threads, "src0": src0, "src1": src1}
    else:
        route = {"lane": lane, "writer": "serial"}

    blob_size = section.coff
    blob_id = section.hasher.hexdigest() if blob_size else ""
    if blob_size:
        out.write(nydus_tar.make_header(toc.ENTRY_BLOB_DATA, blob_size))

    # Synthesize root + missing parents (metadata only).
    for p in fstree.missing_parents(metas):
        metas[p] = _Meta(entry=fstree.FileEntry(path=p, mode=stat.S_IFDIR | 0o755))
    for d in opaque_dirs:
        if d not in metas:
            metas[d] = _Meta(entry=fstree.FileEntry(path=d, mode=stat.S_IFDIR | 0o755))
        metas[d].entry.flags |= fstree.INODE_FLAG_OPAQUE
        metas[d].entry.xattrs[fstree.OPAQUE_XATTR] = b"y"

    # Blob + cipher + batch tables (own blob first, then dict blobs).
    blob_table: list[BlobRecord] = []
    cipher_table: list[CipherRecord] = []
    batch_table: list[BatchRecord] = []
    blob_index_of: dict[str, int] = {}
    if blob_size:
        blob_index_of[blob_id] = 0
        blob_table.append(
            BlobRecord(
                blob_id=blob_id,
                compressed_size=blob_size,
                uncompressed_size=uoff,
                chunk_count=len(uncomp_offsets),
            )
        )
        cipher_table.append(section.cipher or CipherRecord())
        for coff_b, base_u, usize in section.batches:
            batch_table.append(BatchRecord(0, coff_b, base_u, usize))
    for bid in dict_blobs_used:
        new_idx = len(blob_table)
        blob_index_of[bid] = new_idx
        dict_idx, dict_rec = next(
            (i, b) for i, b in enumerate(chunk_dict.bootstrap.blobs) if b.blob_id == bid
        )
        blob_table.append(
            BlobRecord(
                blob_id=bid,
                compressed_size=dict_rec.compressed_size,
                uncompressed_size=dict_rec.uncompressed_size,
                chunk_count=dict_rec.chunk_count,
                flags=dict_rec.flags,
            )
        )
        cipher_table.append(chunk_dict.bootstrap.cipher_for(dict_idx) or CipherRecord())
        for b in chunk_dict.bootstrap.batches:
            if b.blob_index == dict_idx:
                batch_table.append(
                    BatchRecord(new_idx, b.compressed_offset, b.uncompressed_base, b.uncompressed_size)
                )

    # Inodes + chunk table in path-sorted order (bootstrap serialization
    # order), records resolved against the final extent table.
    inodes: list[Inode] = []
    chunk_records: list[ChunkRecord] = []
    for path in sorted(metas):
        meta = metas[path]
        inode = fstree.entry_to_inode(meta.entry)
        inode.size = meta.size
        if meta.chunks:
            inode.chunk_index = len(chunk_records)
            inode.chunk_count = len(meta.chunks)
            for ref in meta.chunks:
                if ref.dict_hit is not None:
                    hit = ref.dict_hit
                    chunk_records.append(
                        ChunkRecord(
                            digest=ref.digest,
                            blob_index=blob_index_of[chunk_dict.blob_id_for(hit)],
                            flags=hit.flags,
                            uncompressed_offset=hit.uncompressed_offset,
                            compressed_offset=hit.compressed_offset,
                            uncompressed_size=hit.uncompressed_size,
                            compressed_size=hit.compressed_size,
                        )
                    )
                else:
                    coff_c, csize, cflag = section.extents[ref.uniq_idx]
                    chunk_records.append(
                        ChunkRecord(
                            digest=ref.digest,
                            blob_index=blob_index_of[blob_id],
                            flags=cflag,
                            uncompressed_offset=uncomp_offsets[ref.uniq_idx],
                            compressed_offset=coff_c,
                            uncompressed_size=ref.size,
                            compressed_size=csize,
                        )
                    )
        inodes.append(inode)

    bootstrap = Bootstrap(
        version=opt.fs_version,
        chunk_size=opt.chunk_size,
        inodes=inodes,
        chunks=chunk_records,
        blobs=blob_table,
        ciphers=cipher_table if any(c.algo for c in cipher_table) else [],
        batches=batch_table,
        prefetch=match_prefetch_paths(inodes, opt.prefetch_patterns) if opt.prefetch_patterns else [],
    )
    boot_bytes = bootstrap.to_bytes()

    toc_entries = []
    if blob_size:
        toc_entries.append(
            toc.TOCEntry(
                name=toc.ENTRY_BLOB_DATA,
                flags=constants.COMPRESSOR_NONE,
                uncompressed_digest=section.hasher.digest(),
                compressed_offset=0,
                compressed_size=blob_size,
                uncompressed_size=blob_size,
            )
        )
    boot_off = out.tell()
    out.write(boot_bytes)
    out.write(nydus_tar.make_header(toc.ENTRY_BOOTSTRAP, len(boot_bytes)))
    toc_entries.append(
        toc.TOCEntry(
            name=toc.ENTRY_BOOTSTRAP,
            flags=constants.COMPRESSOR_NONE,
            uncompressed_digest=hashlib.sha256(boot_bytes).digest(),
            compressed_offset=boot_off,
            compressed_size=len(boot_bytes),
            uncompressed_size=len(boot_bytes),
        )
    )
    toc_bytes = toc.pack_toc(toc_entries)
    out.write(toc_bytes)
    out.write(nydus_tar.make_header(toc.ENTRY_BLOB_TOC, len(toc_bytes)))

    split = (
        ("scan", t_lane - t_walk - walk_chunk - walk_asm),
        ("chunk_digest", t_chunk),
        # the whole-layer pack_files call: chunk, dedup and assemble in one
        ("fused_pack", t_fused),
        ("dedup", t_end - t_lane - (t_chunk - walk_chunk) - (t_asm - walk_asm) - t_fused),
        ("assemble", t_asm),
        ("bootstrap", perf_counter() - t_end),
    )
    for key, s in split:
        _STAGES[key].inc(s)
        if stats is not None:
            stats[key] = stats.get(key, 0.0) + s
    _LAYERS.inc()

    return PackResult(
        blob_id=blob_id,
        blob_size=blob_size,
        bootstrap=boot_bytes,
        referenced_blob_ids=[b.blob_id for b in blob_table],
        route=route,
    )


def pack_layer(
    src_tar: "BinaryIO | bytes",
    opt: PackOption,
    chunk_dict=None,
    device: "str | torch.device | None" = None,
    stats: "Optional[dict]" = None,
    budget=None,
    codec=None,
) -> tuple[bytes, PackResult]:
    """Pack to bytes -> (framed layer blob, PackResult)."""
    dest = io.BytesIO()
    res = Pack(
        dest, src_tar, opt, chunk_dict=chunk_dict, device=device, stats=stats, budget=budget,
        codec=codec,
    )
    return dest.getvalue(), res
