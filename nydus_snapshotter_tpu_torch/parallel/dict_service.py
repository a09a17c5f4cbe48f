"""Shared chunk-dict service: one growing dedup table per namespace, served
to converters over a unix socket (``service://``).

- **ServiceDict** (one per namespace) pairs the record store — a
  :class:`~nydus_snapshotter_tpu_torch.converter.batch.GrowingChunkDict`
  bootstrap holding the chunk/blob/batch/cipher tables — with a
  :class:`~nydus_snapshotter_tpu_torch.parallel.sharded_dict.ShardedChunkDict`
  probe index grown by ``insert_digests``, on the service's mesh (one
  shard on one device unless the caller passes a wider ``mesh``). A
  digest's index value is its position in the record store's chunk table:
  a merge inserts exactly the records it appended, in append order. Every
  ``/probe`` RPC is one ``lookup_u32`` of the index: on one shard one
  launch of kernel K3 on the index's device (its plain version on the
  CPU), on more the mesh probe (K3 once per shard); answers are copied to
  the host before they are serialized.
- **DictService** serves the namespaces over HTTP/1.1 on a unix socket from
  a ``ThreadingUnixStreamServer``. Probe and merge RPCs are batched: one
  request per image, not per chunk.
- **ServiceChunkDict** is the converter's view: a local mirror of the
  namespace's tables that Pack probes like a private ``GrowingChunkDict``,
  reconciled between images by replaying the append-only record tail
  (``/entries``). ``add_bootstrap`` ships an image's bootstrap to the
  service, whose first-wins merge is the single ordering authority across
  converters. With several ``,``-separated addresses, the namespace's
  key-space is split by rendezvous hash (:func:`shard_for`) and the mirror
  combines every shard's tail.

The HA plane (``ha/``) rides on the same service: a replica's
``ServiceDict.apply_replica_tail`` applies its primary's record tail
verbatim and grows its own probe index (K3 on the replica's device); a
member with an ``HaAgent`` attached (``DictService.ha``) serves the
``/api/v1/ha`` routes and answers write RPCs with 503
(:class:`NotPrimaryError`) unless it is the primary. ``ServiceChunkDict``
fails a shard over to its replicas (``|`` groups, or the controller's
placement map under ``service+ha://``), replays the un-acked batch and
repairs the record tail the promoted replica lacks, so the table stays
position-identical to the no-failure path.

The wire formats are the reference package's (parallel/dict_service.py):
probe bodies are concatenated raw 32-byte digests, answers little-endian
``<i8`` indices (-1 = miss), record deltas fixed-width ``_CHUNK_DT``/
``_BLOB_DT``/``_BATCH_DT``/``_CIPHER_DT`` rows behind a ``<u8`` header. A
client of either package talks to a service of the other, and a replica of
either package tails a primary of the other.

The controller that serves the placement map (``/api/v1/fleet/placement``)
is the fleet plane (``fleet.FleetPlane``) on the system controller's
socket; ``service+ha://`` clients and runners work against either
package's.
"""

from __future__ import annotations

import hashlib
import http.client
import json
import logging
import os
import re
import socket
import socketserver
import threading
import time
from http.server import BaseHTTPRequestHandler
from time import perf_counter
from typing import Optional
from urllib.parse import parse_qs, urlparse

import numpy as np
import torch

from nydus_snapshotter_tpu_torch import failpoint, trace
from nydus_snapshotter_tpu_torch.analysis import runtime as _an
from nydus_snapshotter_tpu_torch.config.config import global_section
from nydus_snapshotter_tpu_torch.converter.batch import GrowingChunkDict
from nydus_snapshotter_tpu_torch.models.bootstrap import (
    BatchRecord,
    BlobRecord,
    Bootstrap,
    ChunkDict,
    ChunkRecord,
    CipherRecord,
    parse_chunk_dict_arg,
)
from nydus_snapshotter_tpu_torch.metrics import registry as _metrics
from nydus_snapshotter_tpu_torch.parallel import mesh as mesh_lib
from nydus_snapshotter_tpu_torch.parallel.sharded_dict import DictEpochError, ShardedChunkDict
from nydus_snapshotter_tpu_torch.utils import udshttp

logger = logging.getLogger(__name__)

DEFAULT_NAMESPACE = "default"
_NS_RE = re.compile(r"^[A-Za-z0-9][A-Za-z0-9._-]{0,100}$")
_DICT_ROUTE = re.compile(r"^/api/v1/dict(?:/([^/]+)(?:/([a-z]+))?)?$")

# Fixed-width delta rows (all little-endian; digests/keys as u1 lanes —
# numpy S-dtypes strip trailing NULs, which raw digest bytes may contain).
_CHUNK_DT = np.dtype([
    ("digest", "u1", 32), ("blob_index", "<u4"), ("flags", "<u4"),
    ("uoff", "<u8"), ("coff", "<u8"), ("usize", "<u4"), ("csize", "<u4"),
])
_BLOB_DT = np.dtype([
    ("blob_id", "S64"), ("csize", "<u8"), ("usize", "<u8"),
    ("chunk_count", "<u4"), ("flags", "<u4"),
])
_BATCH_DT = np.dtype([
    ("blob_index", "<u8"), ("coff", "<u8"), ("ubase", "<u8"), ("usize", "<u8"),
])
_CIPHER_DT = np.dtype([("algo", "<u4"), ("key", "u1", 32), ("iv", "u1", 16)])
# Delta header: n_chunks, n_blobs, n_batches, n_ciphers, epoch,
# rebuild_epoch, chunk_size, total_chunks.
_DELTA_HDR_FIELDS = 8
_RPC_TOTAL = _metrics.Counter(
    "ntpu_dict_rpc_total", "Chunk-dict service RPCs served", ("op",)
)
_RPC_ERRORS = _metrics.Counter(
    "ntpu_dict_rpc_errors_total", "Chunk-dict service RPCs that failed", ("op",)
)
_RPC_MS = _metrics.Histogram(
    "ntpu_dict_rpc_duration_milliseconds",
    "Chunk-dict service RPC handler latency",
    ("op",),
)
_SHARD_BATCHES = _metrics.Counter(
    "ntpu_dict_shard_batches_total",
    "Per-shard batches the sharded client routed, by op (merge / sync)",
    ("op",),
)
# since-RPC header: n_entries, epoch, rebuild_epoch, reserved.
_SINCE_HDR_FIELDS = 4

def _service_mesh(mesh: Optional[mesh_lib.Mesh], device) -> mesh_lib.Mesh:
    """An index's mesh: ``mesh``, else one shard on ``device`` (the
    reference's ``make_mesh(1)``)."""
    if mesh is not None and device is not None:
        raise ValueError("pass a mesh or a device, not both")
    return mesh if mesh is not None else mesh_lib.Mesh([device])


class DictServiceError(RuntimeError):
    """An RPC failed on the service side (the message carries the op)."""


class NotPrimaryError(DictServiceError):
    """A write RPC reached a replica (wire status 503): the caller must
    fail over to the shard's current primary (ha/ placement map)."""


# ---------------------------------------------------------------------------
# Shard routing: a namespace's key-space split across N service processes
# ---------------------------------------------------------------------------

# splitmix64 finalizer constants: the rendezvous score is
# mix(digest[:8] ^ addr_key) per shard; a content digest is already
# uniform, so one integer mix spreads it.
_MIX_M1 = np.uint64(0xBF58476D1CE4E5B9)
_MIX_M2 = np.uint64(0x94D049BB133111EB)


def _mix_u64(x: np.ndarray) -> np.ndarray:
    x = x ^ (x >> np.uint64(30))
    x = x * _MIX_M1
    x = x ^ (x >> np.uint64(27))
    x = x * _MIX_M2
    return x ^ (x >> np.uint64(31))


def _addr_key(addr: str) -> np.uint64:
    """64-bit key of the full shard address (blake2b once per address)."""
    h = hashlib.blake2b(addr.encode(), digest_size=8)
    return np.uint64(int.from_bytes(h.digest(), "little"))


def _shard_owners(digests: list[bytes], addrs: list[str]) -> np.ndarray:
    """Rendezvous owner index per digest, vectorized over the batch."""
    if all(len(d) == 32 for d in digests[:8]) and len(digests) * 32 == sum(map(len, digests)):
        d64 = np.frombuffer(b"".join(digests), dtype="<u8")[::4]
    else:  # non-32-byte digests: slow path
        d64 = np.asarray(
            [int.from_bytes(d[:8].ljust(8, b"\0"), "little") for d in digests],
            dtype=np.uint64,
        )
    with np.errstate(over="ignore"):
        scores = np.stack([_mix_u64(d64 ^ _addr_key(a)) for a in addrs])
    return np.argmax(scores, axis=0)


def shard_for(digest: bytes, addrs: list[str]) -> int:
    """Rendezvous owner of ``digest`` among ``addrs`` (index into the list).
    Every client with the same shard list routes a digest to the same
    shard, so each shard's first-wins merge order is the global order for
    its digests."""
    if len(addrs) == 1:
        return 0
    return int(_shard_owners([digest], addrs)[0])


def partition_digests(digests: list[bytes], addrs: list[str]) -> list[list[int]]:
    """Positions of ``digests`` grouped by owning shard (order kept)."""
    if not digests:
        return [[] for _ in addrs]
    if len(addrs) == 1:
        return [list(range(len(digests)))]
    owners = _shard_owners(digests, addrs)
    return [np.flatnonzero(owners == i).tolist() for i in range(len(addrs))]


# ---------------------------------------------------------------------------
# Config resolution (env > [chunk_dict] config > defaults)
# ---------------------------------------------------------------------------


def _env_float(name: str, default: float) -> float:
    try:
        return float(os.environ[name])
    except (KeyError, ValueError):
        return default


class DictRuntimeConfig:
    """Resolved ``[chunk_dict]`` knobs for this process."""

    __slots__ = ("load_factor", "headroom", "service", "namespace", "backend")

    def __init__(self, load_factor, headroom, service, namespace, backend):
        self.load_factor = load_factor
        self.headroom = headroom
        self.service = service
        self.namespace = namespace
        self.backend = backend


def resolve_dict_config() -> DictRuntimeConfig:
    """env (``NTPU_DICT*``) > ``[chunk_dict]`` global config > defaults.
    Env overrides are also how the section reaches spawned converter
    processes, which have no global config."""
    cd = global_section("chunk_dict")
    return DictRuntimeConfig(
        load_factor=_env_float("NTPU_DICT_LOAD_FACTOR", getattr(cd, "load_factor", 0.85)),
        headroom=_env_float("NTPU_DICT_HEADROOM", getattr(cd, "headroom", 2.0)),
        service=os.environ.get("NTPU_DICT_SERVICE", getattr(cd, "service", "")),
        namespace=os.environ.get(
            "NTPU_DICT_NAMESPACE", getattr(cd, "namespace", DEFAULT_NAMESPACE)
        ),
        backend=os.environ.get("NTPU_DICT_BACKEND", getattr(cd, "service_backend", "auto")),
    )


def _chunk_rows(recs) -> np.ndarray:
    """Chunk records -> ``_CHUNK_DT`` rows, a column at a time (a replica's
    catch-up ships millions)."""
    ca = np.zeros(len(recs), dtype=_CHUNK_DT)
    if recs:
        ca["digest"] = np.frombuffer(b"".join(r.digest for r in recs), np.uint8).reshape(-1, 32)
        for col, attr in (("blob_index", "blob_index"), ("flags", "flags"),
                          ("uoff", "uncompressed_offset"), ("coff", "compressed_offset"),
                          ("usize", "uncompressed_size"), ("csize", "compressed_size")):
            ca[col] = [getattr(r, attr) for r in recs]
    return ca


def _chunk_records(ca) -> list[ChunkRecord]:
    """``_CHUNK_DT`` rows -> chunk records, a column at a time."""
    raw = np.ascontiguousarray(ca["digest"]).tobytes()
    return [
        ChunkRecord(digest=raw[32 * i : 32 * i + 32], blob_index=b, flags=f,
                    uncompressed_offset=uo, compressed_offset=co, uncompressed_size=us,
                    compressed_size=cs)
        for i, (b, f, uo, co, us, cs) in enumerate(zip(
            ca["blob_index"].tolist(), ca["flags"].tolist(), ca["uoff"].tolist(),
            ca["coff"].tolist(), ca["usize"].tolist(), ca["csize"].tolist()))
    ]


def _blob_records(ba) -> list[BlobRecord]:
    return [
        BlobRecord(
            blob_id=row["blob_id"].decode(),
            compressed_size=int(row["csize"]),
            uncompressed_size=int(row["usize"]),
            chunk_count=int(row["chunk_count"]),
            flags=int(row["flags"]),
        )
        for row in ba
    ]


def _batch_records(ta) -> list[BatchRecord]:
    return [
        BatchRecord(int(row["blob_index"]), int(row["coff"]), int(row["ubase"]), int(row["usize"]))
        for row in ta
    ]


def _cipher_records(ea) -> list[CipherRecord]:
    out = []
    for row in ea:
        algo = int(row["algo"])
        out.append(
            CipherRecord(
                algo=algo,
                key=row["key"].tobytes() if algo else b"",
                iv=row["iv"].tobytes() if algo else b"",
            )
        )
    return out


# ---------------------------------------------------------------------------
# ServiceDict: one namespace's table
# ---------------------------------------------------------------------------


class ServiceDict:
    """Record store + growable probe index for one namespace.

    The GrowingChunkDict bootstrap is the merge authority (first-wins per
    digest, append-only tables); the ShardedChunkDict index, fed exactly
    the appended digests, answers probes. One lock serializes mutation;
    probes read the index's published snapshot without it.
    """

    def __init__(
        self,
        namespace: str = DEFAULT_NAMESPACE,
        cfg: Optional[DictRuntimeConfig] = None,
        device: "str | torch.device | None" = None,
        mesh: Optional[mesh_lib.Mesh] = None,
    ):
        cfg = cfg or resolve_dict_config()
        self.namespace = namespace
        self.records = GrowingChunkDict()
        self.index = ShardedChunkDict(
            np.zeros((0, 8), dtype=np.uint32),
            _service_mesh(mesh, device),
            capacity_factor=cfg.headroom,
            probe_backend=cfg.backend,
            load_factor=cfg.load_factor,
        )
        self._mu = _an.make_lock("dict_service.namespace")
        # The namespace's trained zstd dictionary blob, adopted whole;
        # the highest epoch wins.
        self._zdict: Optional[bytes] = None
        self._zdict_meta: Optional[tuple[int, int]] = None  # (dict_id, epoch)

    def merge_bootstrap_bytes(self, data: bytes) -> dict:
        """Merge one converted image's bootstrap (first-wins per digest);
        the digests the merge appends grow the index in the same order.
        Returns the post-merge stats."""
        source = Bootstrap.from_bytes(data)
        with self._mu:
            added = self.records.add_bootstrap(source)
            if added:
                new = self.records.bootstrap.chunks[-added:]
                got = self.index.insert_digests([c.digest for c in new])
                base = len(self.records.bootstrap.chunks) - added
                if got[0] != base:
                    raise DictServiceError(
                        f"index/record skew: insert returned {got[0]}, records at {base}"
                    )
            return self._stats_locked(added=added)

    def probe(self, digests: bytes) -> np.ndarray:
        """Batched probe: concatenated raw 32-byte digests -> int64 chunk
        positions (-1 = miss), on the host."""
        if len(digests) % 32:
            raise ValueError("probe body must be a multiple of 32 bytes")
        q = np.frombuffer(digests, dtype="<u4").reshape(-1, 8)
        return self.index.lookup_u32(q)

    def _stats_locked(self, added: Optional[int] = None) -> dict:
        bs = self.records.bootstrap
        out = {
            "namespace": self.namespace,
            "chunks": len(bs.chunks),
            "blobs": len(bs.blobs),
            "batches": len(bs.batches),
            "ciphers": len(bs.ciphers),
            "chunk_size": bs.chunk_size,
            "epoch": self.index.epoch,
            "rebuild_epoch": self.index.rebuild_epoch,
            "index_capacity": self.index.capacity * self.index.n_shards,
        }
        if added is not None:
            out["added"] = added
        if self._zdict_meta is not None:
            out["zdict_id"], out["zdict_epoch"] = self._zdict_meta
        return out

    def stats(self) -> dict:
        with self._mu:
            return self._stats_locked()

    def put_zdict(self, blob: bytes) -> dict:
        """Adopt a serialized epoch-stamped trained dictionary
        (converter/codec.TrainedDict wire format; validated, raising
        ``CodecError``). An older epoch never replaces a newer one."""
        from nydus_snapshotter_tpu_torch.converter import codec as codec_mod

        td = codec_mod.TrainedDict.deserialize(blob)
        with self._mu:
            if self._zdict_meta is None or td.epoch >= self._zdict_meta[1]:
                self._zdict = bytes(blob)
                self._zdict_meta = (td.dict_id, td.epoch)
            dict_id, epoch = self._zdict_meta
            return {
                "namespace": self.namespace,
                "zdict_id": dict_id,
                "zdict_epoch": epoch,
                "bytes": len(self._zdict or b""),
            }

    def get_zdict(self) -> bytes:
        """The namespace's trained dictionary blob (b'' when untrained)."""
        with self._mu:
            return self._zdict or b""

    def entries_delta(
        self, chunks: int, blobs: int, batches: int, ciphers: int, limit: int = 0
    ) -> bytes:
        """The append-only record tail past the caller's counts: a header
        and four fixed-width sections. ``limit`` (> 0) caps the chunk rows;
        the header's last field is the service's total chunk count."""
        with self._mu:
            bs = self.records.bootstrap
            c_rows = bs.chunks[chunks : chunks + limit] if limit > 0 else bs.chunks[chunks:]
            b_rows = bs.blobs[blobs:]
            t_rows = bs.batches[batches:]
            e_rows = bs.ciphers[ciphers:]
            epoch, rebuild_epoch = self.index.epoch, self.index.rebuild_epoch
            chunk_size = bs.chunk_size
            total_chunks = len(bs.chunks)
        ca = _chunk_rows(c_rows)
        ba = np.zeros(len(b_rows), dtype=_BLOB_DT)
        for i, r in enumerate(b_rows):
            ba[i] = (r.blob_id.encode(), r.compressed_size, r.uncompressed_size,
                     r.chunk_count, r.flags)
        ta = np.zeros(len(t_rows), dtype=_BATCH_DT)
        for i, r in enumerate(t_rows):
            ta[i] = (r.blob_index, r.compressed_offset, r.uncompressed_base, r.uncompressed_size)
        ea = np.zeros(len(e_rows), dtype=_CIPHER_DT)
        for i, r in enumerate(e_rows):
            key = np.zeros(32, np.uint8)
            iv = np.zeros(16, np.uint8)
            if r.algo:
                key = np.frombuffer(r.key, dtype=np.uint8)
                iv = np.frombuffer(r.iv, dtype=np.uint8)
            ea[i] = (r.algo, key, iv)
        hdr = np.asarray(
            [len(c_rows), len(b_rows), len(t_rows), len(e_rows),
             epoch, rebuild_epoch, chunk_size, total_chunks],
            dtype=np.uint64,
        )
        return b"".join([hdr.tobytes(), ca.tobytes(), ba.tobytes(), ta.tobytes(), ea.tobytes()])

    def entries_since(self, since_epoch: int, count_only: bool = False) -> bytes:
        """The index journal past ``since_epoch``: header (n, epoch,
        rebuild_epoch, 0), raw digests u32[n, 8] and indices i64[n] unless
        ``count_only``. An epoch before the last rebuild raises
        :class:`DictEpochError` (wire status 409)."""
        with self._mu:
            digs, vals, epoch = self.index.entries_since(int(since_epoch))
            rebuild_epoch = self.index.rebuild_epoch
        hdr = np.asarray([len(vals), epoch, rebuild_epoch, 0], dtype=np.uint64)
        if count_only:
            return hdr.tobytes()
        return b"".join(
            [hdr.tobytes(), np.ascontiguousarray(digs, dtype="<u4").tobytes(),
             np.ascontiguousarray(vals, dtype="<i8").tobytes()]
        )

    def apply_replica_tail(self, meta, ca, ba, ta, ea, base) -> int:
        """Apply a primary's record tail verbatim (HA replication,
        ``ha/replicate.py``): rows land at exactly the table positions the
        primary holds them, so a promoted replica honors the surviving
        clients' counts-based replay cursors. ``base`` is the (chunks,
        blobs, batches, ciphers) cursor the tail was requested at; a
        mismatch means the stream has a gap, raised as
        :class:`DictServiceError` (the tailer resyncs). The chunk digests
        grow the probe index in the same order, under the namespace lock;
        the index restages its device tables after the insert."""
        with self._mu:
            bs = self.records.bootstrap
            have = (len(bs.chunks), len(bs.blobs), len(bs.batches), len(bs.ciphers))
            if have != tuple(base):
                raise DictServiceError(
                    f"replica tail base mismatch: have {have}, tail expects "
                    f"{tuple(base)}: the replication stream has a gap, resync"
                )
            if meta.get("chunk_size"):
                bs.chunk_size = int(meta["chunk_size"])
            self.records.append_records(
                _chunk_records(ca), _blob_records(ba), _batch_records(ta), _cipher_records(ea)
            )
            if len(ca):
                got = self.index.insert_u32(
                    np.ascontiguousarray(ca["digest"]).view("<u4").reshape(-1, 8)
                )
                if got[0] != base[0]:
                    raise DictServiceError(
                        f"replica index/record skew: insert returned {got[0]}, "
                        f"records at {base[0]}"
                    )
            return len(ca)

    def save(self, path: str) -> dict:
        """Persist both faces: the dict-image bootstrap at ``path`` and the
        epoch-stamped index at ``path + '.idx'`` (appended to when the file
        matches the table, rewritten after a rebuild)."""
        with self._mu:
            self.records.save(path)
            idx = self.index.save_incremental(path + ".idx")
            zd = self._zdict
        out = {"bootstrap": path, "index": path + ".idx", "index_save": idx}
        if zd:
            tmp = path + ".zdict.tmp"
            with open(tmp, "wb") as f:
                f.write(zd)
            os.replace(tmp, path + ".zdict")
            out["zdict"] = path + ".zdict"
        return out


# ---------------------------------------------------------------------------
# DictService: HTTP over a unix socket
# ---------------------------------------------------------------------------


class _UnixHTTPServer(socketserver.ThreadingUnixStreamServer):
    daemon_threads = True

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        # Open kept-alive connections, so stop() can sever them: a stopped
        # service looks exactly like a killed process to its clients.
        self._conns_lock = threading.Lock()
        self._conns: set = set()

    def finish_request(self, request, client_address):
        with self._conns_lock:
            self._conns.add(request)
        try:
            self.RequestHandlerClass(request, ("uds", 0), self)
        finally:
            with self._conns_lock:
                self._conns.discard(request)

    def sever_connections(self) -> None:
        with self._conns_lock:
            conns = list(self._conns)
        for sock in conns:
            try:
                sock.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass


class DictService:
    """One dict per namespace behind batched HTTP RPCs.

    ``handle()`` is transport-agnostic; ``run()`` serves on a unix socket.
    Every namespace's index lives on ``mesh``, by default one shard on
    ``device`` (CUDA unless the caller asks for the CPU), where its probes
    run. ``ha`` is the attached ``ha.replicate.HaAgent``, if any: the role
    gate of the write ops and the ``/api/v1/ha`` routes.
    """

    # Write ops a non-primary member rejects (wire 503, the HA role gate);
    # reads stay allowed, so replicas serve warm probes and the replication
    # stream itself.
    _WRITE_OPS = ("merge", "save", "zdict")

    def __init__(
        self,
        cfg: Optional[DictRuntimeConfig] = None,
        device: "str | torch.device | None" = None,
        mesh: Optional[mesh_lib.Mesh] = None,
    ):
        self.mesh = _service_mesh(mesh, device)
        self.device = self.mesh.devices[0]
        self.cfg = cfg or resolve_dict_config()
        self._dicts: dict[str, ServiceDict] = {}
        self._mu = _an.make_lock("dict_service.registry")
        self._httpd: Optional[_UnixHTTPServer] = None
        self.sock_path = ""
        self.ha = None

    def dict_for(self, namespace: str) -> ServiceDict:
        if not _NS_RE.match(namespace):
            raise ValueError(f"invalid dict namespace {namespace!r}")
        with self._mu:
            sd = self._dicts.get(namespace)
            if sd is None:
                sd = self._dicts[namespace] = ServiceDict(namespace, self.cfg, mesh=self.mesh)
            return sd

    def reset_namespace(self, namespace: str) -> None:
        """Drop one namespace's tables, its device tables with them (the HA
        replica's loud full resync: the tailer re-pulls from record zero)."""
        if not _NS_RE.match(namespace):
            raise ValueError(f"invalid dict namespace {namespace!r}")
        with self._mu:
            self._dicts.pop(namespace, None)

    def reset_all(self) -> int:
        """Drop every namespace and its device tables (a replica retargeted
        to another shard's primary must not replay a foreign table);
        returns how many namespaces were dropped."""
        with self._mu:
            n = len(self._dicts)
            self._dicts.clear()
            return n

    def namespace_stats(self) -> list[dict]:
        """Stats for every namespace (the HA status surface)."""
        with self._mu:
            dicts = list(self._dicts.values())
        return [sd.stats() for sd in dicts]

    def handle(self, method: str, path: str, headers, body: bytes) -> tuple[int, str, bytes]:
        """(method, path?query, headers, body) -> (status, ctype, payload).
        Adopts the caller's trace context from the ``x-ntpu-*`` headers so
        the server-side span joins the converter's ``convert`` root."""
        parsed = urlparse(path)
        if parsed.path.startswith("/api/v1/ha"):
            # HA control surface (ha/replicate.HaAgent): role pushes and
            # promotion from the placement controller, status for its
            # most-caught-up ranking.
            if self.ha is None:
                return 404, "application/json", b'{"message": "ha plane not attached"}'
            return self.ha.handle(method, parsed.path, body)
        if parsed.path == "/api/v1/traces" and method == "GET":
            # the span ring (dict.rpc.* spans) as a Chrome trace document
            return 200, "application/json", trace.chrome_trace_bytes()
        if parsed.path in ("/metrics", "/v1/metrics") and method == "GET":
            return (
                200,
                "text/plain; version=0.0.4",
                _metrics.default_registry.render().encode(),
            )
        m = _DICT_ROUTE.match(parsed.path)
        if not m:
            return 404, "application/json", b'{"message": "no such endpoint"}'
        ns, op = m.group(1), m.group(2)
        if ns is None:
            op = "list"
        elif op is None:
            op = "stats"
        try:
            tid = int(headers.get("x-ntpu-trace-id", "0"), 16)
            pid = int(headers.get("x-ntpu-parent-id", "0"), 16)
        except ValueError:
            tid = pid = 0
        t0 = perf_counter()
        try:
            with trace.with_context(trace.remote_context(tid, pid)):
                with trace.span(f"dict.rpc.{op}", namespace=ns or "*"):
                    failpoint.hit("dict.rpc")
                    payload = self._dispatch(method, op, ns, parsed.query, body)
            _RPC_TOTAL.labels(op).inc()
            _RPC_MS.labels(op).observe((perf_counter() - t0) * 1000.0)
        except (ValueError, KeyError) as e:
            _RPC_ERRORS.labels(op).inc()
            return 400, "application/json", json.dumps({"message": str(e)}).encode()
        except NotPrimaryError as e:
            _RPC_ERRORS.labels(op).inc()
            # HA role gate: a write reached a replica; 503 tells the client
            # to fail over to the placement map's primary.
            return 503, "application/json", json.dumps({"message": str(e)}).encode()
        except DictEpochError as e:
            _RPC_ERRORS.labels(op).inc()
            # A journal tail compacted away: the caller must resync from a
            # full snapshot, not silently miss entries.
            return 409, "application/json", json.dumps({"message": str(e)}).encode()
        except Exception as e:  # noqa: BLE001 - the server keeps serving; mapped to 500
            _RPC_ERRORS.labels(op).inc()
            logger.exception("dict service %s %s", method, path)
            return 500, "application/json", json.dumps({"message": str(e)}).encode()
        if isinstance(payload, bytes):
            return 200, "application/octet-stream", payload
        return 200, "application/json", json.dumps(payload).encode()

    def _dispatch(self, method: str, op: str, ns: Optional[str], query: str, body: bytes):
        if (
            self.ha is not None
            and method == "POST"
            and op in self._WRITE_OPS
            and not self.ha.is_primary()
        ):
            raise NotPrimaryError(
                f"dict member is {self.ha.role}, not primary: fail over to the "
                "placement map's primary for this shard"
            )
        if op == "list":
            with self._mu:
                dicts = [self._dicts[n] for n in sorted(self._dicts)]
            return [sd.stats() for sd in dicts]
        sd = self.dict_for(ns)
        if op == "stats" and method == "GET":
            return sd.stats()
        if op == "probe" and method == "POST":
            return sd.probe(body).astype("<i8").tobytes()
        if op == "merge" and method == "POST":
            return sd.merge_bootstrap_bytes(body)
        if op == "entries" and method == "GET":
            q = parse_qs(query)

            def count(name: str) -> int:
                v = int(q.get(name, ["0"])[0])
                if v < 0:
                    raise ValueError(f"{name} must be >= 0")
                return v

            return sd.entries_delta(
                count("chunks"), count("blobs"), count("batches"), count("ciphers"),
                limit=count("limit"),
            )
        if op == "since" and method == "GET":
            q = parse_qs(query)
            epoch = int(q.get("epoch", ["0"])[0])
            if epoch < 0:
                raise ValueError("epoch must be >= 0")
            count_only = q.get("count_only", ["0"])[0] not in ("", "0")
            return sd.entries_since(epoch, count_only=count_only)
        if op == "save" and method == "POST":
            req = json.loads(body or b"{}")
            path = req.get("path", "")
            if not path:
                raise ValueError("save needs a path")
            return sd.save(path)
        if op == "zdict" and method == "GET":
            return sd.get_zdict()
        if op == "zdict" and method == "POST":
            from nydus_snapshotter_tpu_torch.converter.codec import CodecError

            try:
                return sd.put_zdict(body)
            except CodecError as e:
                raise ValueError(str(e)) from e
        raise ValueError(f"no such dict op {method} {op!r}")

    def run(self, sock_path: str) -> None:
        """Serve on ``sock_path`` from a daemon thread (returns at once)."""
        os.makedirs(os.path.dirname(sock_path) or ".", exist_ok=True)
        try:
            os.remove(sock_path)
        except FileNotFoundError:
            pass
        service = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, *a):
                pass

            def _serve(self, body: bytes) -> None:
                status, ctype, payload = service.handle(self.command, self.path, self.headers, body)
                self.send_response(status)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(payload)))
                self.end_headers()
                self.wfile.write(payload)

            def do_GET(self):
                self._serve(b"")

            def do_POST(self):
                length = int(self.headers.get("Content-Length", 0))
                self._serve(self.rfile.read(length))

        self._httpd = _UnixHTTPServer(sock_path, Handler)
        self.sock_path = sock_path
        threading.Thread(target=self._httpd.serve_forever, name="dict-service", daemon=True).start()
        logger.info("chunk-dict service on unix:%s", sock_path)
        # A standalone dict-service process self-registers with the fleet
        # controller when one is configured (the placement controller's
        # candidate pool); a no-op without one.
        from nydus_snapshotter_tpu_torch import fleet

        fleet.register_self("dict", sock_path)

    def stop(self) -> None:
        tailer = getattr(self.ha, "tailer", None)
        if tailer is not None:
            tailer.stop()
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.sever_connections()
            self._httpd.server_close()
            self._httpd = None
        if self.sock_path:
            try:
                os.remove(self.sock_path)
            except OSError:
                pass
            self.sock_path = ""


# ---------------------------------------------------------------------------
# Client
# ---------------------------------------------------------------------------


class _UDSHTTPConnection(http.client.HTTPConnection):
    def __init__(self, sock_path: str, timeout: float):
        super().__init__("localhost", timeout=timeout)
        self._sock_path = sock_path

    def connect(self) -> None:
        s = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        s.settimeout(self.timeout)
        s.connect(self._sock_path)
        self.sock = s


class DictClient:
    """Batched RPCs to a dict service over its unix socket. One persistent
    HTTP/1.1 connection, re-dialed once on error (not thread-safe: one
    client per converter thread)."""

    def __init__(self, sock_path: str, timeout: float = 60.0):
        self.sock_path = sock_path
        self.timeout = timeout
        self._conn: Optional[_UDSHTTPConnection] = None

    def close(self) -> None:
        if self._conn is not None:
            self._conn.close()
            self._conn = None

    def _request(self, method: str, path: str, body: bytes = b"") -> tuple[str, bytes]:
        headers = {"Content-Length": str(len(body))}
        ctx = trace.capture()
        if ctx is not None and ctx.sampled:
            headers["x-ntpu-trace-id"] = f"{ctx.trace_id:x}"
            headers["x-ntpu-parent-id"] = f"{ctx.span_id:x}"
        for attempt in (0, 1):
            if self._conn is None:
                self._conn = _UDSHTTPConnection(self.sock_path, self.timeout)
            try:
                self._conn.request(method, path, body=body, headers=headers)
                resp = self._conn.getresponse()
                payload = resp.read()
                break
            except (http.client.HTTPException, OSError):
                # stale kept-alive connection: re-dial once
                self.close()
                if attempt:
                    raise
        if resp.status != 200:
            try:
                message = json.loads(payload).get("message", "")
            except ValueError:
                message = payload[:200].decode("utf-8", "replace")
            err = NotPrimaryError if resp.status == 503 else DictServiceError
            raise err(f"dict service {method} {path} -> {resp.status}: {message}")
        return resp.headers.get("Content-Type", ""), payload

    def namespaces(self) -> list[dict]:
        return json.loads(self._request("GET", "/api/v1/dict")[1])

    def stats(self, namespace: str = DEFAULT_NAMESPACE) -> dict:
        return json.loads(self._request("GET", f"/api/v1/dict/{namespace}/stats")[1])

    def probe(self, digests: list[bytes], namespace: str = DEFAULT_NAMESPACE) -> np.ndarray:
        if not digests:
            return np.zeros(0, dtype=np.int64)
        _ctype, payload = self._request("POST", f"/api/v1/dict/{namespace}/probe", b"".join(digests))
        return np.frombuffer(payload, dtype="<i8")

    def merge(self, bootstrap: bytes, namespace: str = DEFAULT_NAMESPACE) -> dict:
        return json.loads(self._request("POST", f"/api/v1/dict/{namespace}/merge", bootstrap)[1])

    def entries(
        self,
        namespace: str = DEFAULT_NAMESPACE,
        chunks: int = 0,
        blobs: int = 0,
        batches: int = 0,
        ciphers: int = 0,
        limit: int = 0,
    ) -> tuple[dict, np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
        path = (
            f"/api/v1/dict/{namespace}/entries?chunks={chunks}&blobs={blobs}"
            f"&batches={batches}&ciphers={ciphers}"
        )
        if limit:
            # HA replication's byte budget: cap the chunk rows per pull.
            path += f"&limit={int(limit)}"
        _ctype, payload = self._request("GET", path)
        hdr = np.frombuffer(payload, dtype=np.uint64, count=_DELTA_HDR_FIELDS)
        nc, nb, nt, ne = (int(x) for x in hdr[:4])
        off = hdr.nbytes
        ca = np.frombuffer(payload, dtype=_CHUNK_DT, count=nc, offset=off)
        off += ca.nbytes
        ba = np.frombuffer(payload, dtype=_BLOB_DT, count=nb, offset=off)
        off += ba.nbytes
        ta = np.frombuffer(payload, dtype=_BATCH_DT, count=nt, offset=off)
        off += ta.nbytes
        ea = np.frombuffer(payload, dtype=_CIPHER_DT, count=ne, offset=off)
        meta = {
            "epoch": int(hdr[4]),
            "rebuild_epoch": int(hdr[5]),
            "chunk_size": int(hdr[6]),
            "total_chunks": int(hdr[7]),
        }
        return meta, ca, ba, ta, ea

    def entries_since(
        self, namespace: str = DEFAULT_NAMESPACE, epoch: int = 0, count_only: bool = False
    ) -> tuple[dict, np.ndarray, np.ndarray]:
        """The index journal past ``epoch``: (meta, digests u32[k, 8],
        indices i64[k]); empty arrays with ``count_only``. Raises
        :class:`DictEpochError` when the epoch predates the service's last
        rebuild (wire 409)."""
        path = f"/api/v1/dict/{namespace}/since?epoch={int(epoch)}"
        if count_only:
            path += "&count_only=1"
        try:
            _ctype, payload = self._request("GET", path)
        except DictServiceError as e:
            if "409" in str(e):
                raise DictEpochError(str(e)) from e
            raise
        hdr = np.frombuffer(payload, dtype=np.uint64, count=_SINCE_HDR_FIELDS)
        n = int(hdr[0])
        meta = {"entries": n, "epoch": int(hdr[1]), "rebuild_epoch": int(hdr[2])}
        if count_only or n == 0:
            return meta, np.zeros((0, 8), dtype="<u4"), np.zeros(0, dtype="<i8")
        off = hdr.nbytes
        digs = np.frombuffer(payload, dtype="<u4", count=n * 8, offset=off)
        off += digs.nbytes
        vals = np.frombuffer(payload, dtype="<i8", count=n, offset=off)
        return meta, digs.reshape(-1, 8), vals

    def save(self, path: str, namespace: str = DEFAULT_NAMESPACE) -> dict:
        return json.loads(
            self._request(
                "POST", f"/api/v1/dict/{namespace}/save", json.dumps({"path": path}).encode()
            )[1]
        )

    def put_zdict(self, blob: bytes, namespace: str = DEFAULT_NAMESPACE) -> dict:
        """Publish a serialized trained compression dictionary."""
        return json.loads(self._request("POST", f"/api/v1/dict/{namespace}/zdict", blob)[1])

    def get_zdict(self, namespace: str = DEFAULT_NAMESPACE) -> "Optional[bytes]":
        """The namespace's trained dictionary blob, or None when untrained."""
        _ctype, payload = self._request("GET", f"/api/v1/dict/{namespace}/zdict")
        return payload or None


# ---------------------------------------------------------------------------
# Converter-facing mirror
# ---------------------------------------------------------------------------


class _ShardState:
    """One shard's replication cursor inside a (sharded) mirror."""

    __slots__ = (
        "client", "chunks", "blobs", "batches", "ciphers", "epoch", "rebuild_epoch",
        "blob_map", "route_key", "alternates",
        "hist_chunks", "hist_blobs", "hist_batches", "hist_ciphers",
    )

    def __init__(self, client: DictClient, route_key: str = "",
                 alternates: Optional[list[str]] = None):
        self.client = client
        self.chunks = 0
        self.blobs = 0
        self.batches = 0
        self.ciphers = 0
        self.epoch = 0
        self.rebuild_epoch = 0
        self.blob_map: list[int] = []  # shard-local blob index -> mirror blob index
        # HA: the stable rendezvous key of this shard. Digest -> shard
        # routing must not move when a replica is promoted (the key-space
        # split is the first-wins ordering authority), so the key is pinned
        # at construction (the first address, or "dict-shard-<i>" under
        # placement resolution) and never follows the current client.
        self.route_key = route_key or client.sock_path
        # HA: replica addresses to fail over to.
        self.alternates: list[str] = list(alternates or ())
        # HA: the shard-local record rows this mirror replayed, in order:
        # the repair source when a promoted replica lags the dead primary
        # (every mirror's knowledge of a shard is a prefix of its record
        # sequence, so concurrent repairs compose position-identically).
        self.hist_chunks: list = []
        self.hist_blobs: list = []
        self.hist_batches: list = []
        self.hist_ciphers: list = []


class ServiceChunkDict:
    """GrowingChunkDict-shaped view of one service namespace, over one
    service or a rendezvous-sharded set of them.

    Pack probes the local mirror (``get``/``blob_id_for``/``.bootstrap``)
    as it would a private dict: no RPC sits on the per-chunk path.
    ``add_bootstrap*`` ships an image to the service (partitioned per shard
    when there are several) and ``sync()`` replays every shard's
    append-only record tail into one combined mirror, remapping shard-local
    blob indices onto the combined blob table. A shard whose epoch or
    chunk count went backwards (a restart with a younger table) raises
    :class:`DictEpochError`: the mirror cannot un-merge.

    HA: ``failover`` lists each shard's replica addresses,
    ``resolver(shard_idx)`` re-reads the placement map (``[primary,
    *replicas]``) so a promotion mid-merge is found, and ``route_keys``
    pins the rendezvous keys where addresses are not stable identities
    (``service+ha://``). With either, a shard RPC that fails in transport
    or with a 503 fails over: the un-acked operation is re-run against the
    shard's new primary after the record tail it lacks is re-merged from
    this mirror's history.
    """

    def __init__(
        self,
        client,
        namespace: str = DEFAULT_NAMESPACE,
        sync_on_init: bool = True,
        failover=None,
        resolver=None,
        route_keys: Optional[list[str]] = None,
        failover_deadline_s: float = 15.0,
    ):
        clients = list(client) if isinstance(client, (list, tuple)) else [client]
        if not clients:
            raise ValueError("ServiceChunkDict needs at least one client")
        self._resolver = resolver
        self._failover_deadline_s = failover_deadline_s
        self._ha = bool(failover) or resolver is not None
        alts = list(failover) if failover else [None] * len(clients)
        keys = list(route_keys) if route_keys else [c.sock_path for c in clients]
        if len(alts) != len(clients) or len(keys) != len(clients):
            raise ValueError("failover/route_keys must match the shard count")
        self._shards = [
            _ShardState(c, route_key=k, alternates=a) for c, k, a in zip(clients, keys, alts)
        ]
        self.shard_addrs = keys
        self.namespace = namespace
        self.bootstrap = Bootstrap(inodes=[])
        self._by_digest: dict[bytes, ChunkRecord] = {}
        self._blob_index_of: dict[str, int] = {}
        self._batch_seen: set[tuple[int, int]] = set()
        self.epoch = 0
        if sync_on_init:
            self.sync()

    @property
    def client(self) -> DictClient:
        return self._shards[0].client

    def close(self) -> None:
        """Close every shard's client connection."""
        for shard in self._shards:
            shard.client.close()

    @property
    def n_shards(self) -> int:
        return len(self._shards)

    def shard_epochs(self) -> list[dict]:
        return [
            {"address": s.client.sock_path, "route_key": s.route_key, "epoch": s.epoch,
             "rebuild_epoch": s.rebuild_epoch, "chunks": s.chunks}
            for s in self._shards
        ]

    # -- probe interface (mirror-local) --------------------------------------

    def __len__(self) -> int:
        return len(self.bootstrap.chunks)

    def __contains__(self, digest: bytes) -> bool:
        return digest in self._by_digest

    def get(self, digest: bytes):
        return self._by_digest.get(digest)

    def blob_id_for(self, chunk) -> str:
        return self.bootstrap.blobs[chunk.blob_index].blob_id

    def digests_u32(self):
        return self.bootstrap.chunk_digests_u32()

    def blob_ids(self) -> list[str]:
        return [b.blob_id for b in self.bootstrap.blobs]

    # -- reconciliation ------------------------------------------------------

    def _combined_blob_index(self, shard: _ShardState, row) -> int:
        """Adopt one shard blob row into the combined mirror (dedup by blob
        id: two shards may reference one blob)."""
        bs = self.bootstrap
        bid = row["blob_id"].decode()
        idx = self._blob_index_of.get(bid)
        if idx is None:
            idx = len(bs.blobs)
            self._blob_index_of[bid] = idx
            bs.blobs.append(
                BlobRecord(
                    blob_id=bid,
                    compressed_size=int(row["csize"]),
                    uncompressed_size=int(row["usize"]),
                    chunk_count=int(row["chunk_count"]),
                    flags=int(row["flags"]),
                )
            )
            if bs.ciphers:
                # keep the cipher table parallel to blobs once any blob is
                # encrypted (Bootstrap serialization invariant)
                while len(bs.ciphers) < len(bs.blobs):
                    bs.ciphers.append(CipherRecord())
        shard.blob_map.append(idx)
        return idx

    def _sync_shard(self, shard: _ShardState) -> int:
        bs = self.bootstrap
        meta, ca, ba, ta, ea = shard.client.entries(
            self.namespace,
            chunks=shard.chunks,
            blobs=shard.blobs,
            batches=shard.batches,
            ciphers=shard.ciphers,
        )
        # The service's epoch only advances: a regression means the shard
        # restarted with a younger table, and a counts-based tail would
        # silently resume mid-stream.
        if meta["epoch"] < shard.epoch or meta["total_chunks"] < shard.chunks:
            raise DictEpochError(
                f"dict shard {shard.client.sock_path} went backwards "
                f"(epoch {meta['epoch']} < {shard.epoch} or "
                f"{meta['total_chunks']} chunks < the {shard.chunks} already "
                "replayed): shard restarted, rebuild the mirror"
            )
        if meta["chunk_size"]:
            bs.chunk_size = meta["chunk_size"]
        for row in ba:
            self._combined_blob_index(shard, row)
        for j, row in enumerate(ea):
            algo = int(row["algo"])
            cipher = CipherRecord(
                algo=algo,
                key=row["key"].tobytes() if algo else b"",
                iv=row["iv"].tobytes() if algo else b"",
            )
            # Cipher row j is parallel to shard blob j; place it where
            # that blob landed in the mirror.
            combined = shard.blob_map[shard.ciphers + j]
            while len(bs.ciphers) < len(bs.blobs):
                bs.ciphers.append(CipherRecord())
            if algo:
                bs.ciphers[combined] = cipher
        for rec in _chunk_records(ca):
            rec.blob_index = shard.blob_map[rec.blob_index]
            bs.chunks.append(rec)
            self._by_digest.setdefault(rec.digest, rec)
        for row in ta:
            combined = shard.blob_map[int(row["blob_index"])]
            key = (combined, int(row["coff"]))
            if key not in self._batch_seen:
                self._batch_seen.add(key)
                bs.batches.append(
                    BatchRecord(combined, int(row["coff"]), int(row["ubase"]), int(row["usize"]))
                )
        shard.chunks += len(ca)
        shard.blobs += len(ba)
        shard.batches += len(ta)
        shard.ciphers += len(ea)
        shard.epoch = meta["epoch"]
        shard.rebuild_epoch = meta["rebuild_epoch"]
        if self._ha and (len(ca) or len(ba) or len(ta) or len(ea)):
            # The raw replayed rows: the failover repair source (~64 B a
            # chunk record; kept only under HA).
            shard.hist_chunks.append(np.array(ca))
            shard.hist_blobs.append(np.array(ba))
            shard.hist_batches.append(np.array(ta))
            shard.hist_ciphers.append(np.array(ea))
        return len(ca)

    def sync(self) -> int:
        """Replay every shard's tail into the mirror; returns how many
        chunk records arrived."""
        got = 0
        for i, shard in enumerate(self._shards):
            if len(self._shards) > 1:
                failpoint.hit("dict.shard")
                _SHARD_BATCHES.labels("sync").inc()
            got += self._with_failover(i, lambda s=shard: self._sync_shard(s))
        self.epoch = sum(s.epoch for s in self._shards)
        return got

    # -- HA failover ---------------------------------------------------------

    def _with_failover(self, shard_idx: int, fn):
        """Run one shard RPC; on a transport failure or a 503 role gate,
        fail over to the shard's promoted replica and retry (merge is
        first-wins idempotent and sync resumes from the counts cursor).
        :class:`DictEpochError` passes through: an epoch regression is a
        loud failure, never papered over by a retry."""
        attempts = 0
        while True:
            try:
                return fn()
            except (DictServiceError, OSError) as e:
                if not self._ha or attempts >= 2:
                    raise
                attempts += 1
                self._failover_shard(shard_idx, e)

    def _failover_shard(self, shard_idx: int, cause: Exception) -> None:
        """Re-resolve the shard's primary (placement map, replica list),
        adopt it, and repair the record tail this mirror holds beyond the
        promoted replica's tables."""
        from nydus_snapshotter_tpu_torch import ha as _ha_mod

        shard = self._shards[shard_idx]
        dead = shard.client.sock_path
        logger.warning(
            "dict shard %s: primary %s failed (%s); failing over", shard.route_key, dead, cause
        )
        deadline = time.monotonic() + self._failover_deadline_s
        while True:
            candidates: list[str] = []
            if self._resolver is not None:
                try:
                    candidates = list(self._resolver(shard_idx) or ())
                except Exception:  # noqa: BLE001 - the controller may lag the kill
                    candidates = []
            candidates += [a for a in shard.alternates if a not in candidates]
            ordered = [c for c in candidates if c and c != dead]
            if dead in candidates:
                ordered.append(dead)  # it may have come back
            for addr in ordered:
                cli = DictClient(addr, timeout=shard.client.timeout)
                try:
                    try:
                        st = json.loads(cli._request("GET", "/api/v1/ha/status")[1])
                        if st.get("role") != "primary":
                            cli.close()
                            continue
                    except DictServiceError as e:
                        if "404" not in str(e):
                            raise
                        # No HA agent on this member: primary-capable.
                    stats = cli.stats(self.namespace)
                except (DictServiceError, OSError):
                    cli.close()
                    continue
                shard.client.close()
                shard.client = cli
                _ha_mod.FAILOVERS.inc()
                repaired = self._repair_shard(shard, int(stats.get("chunks", 0)))
                # The promoted primary's index epochs count its own insert
                # batches: the counts cursor stays valid (tables are
                # position-identical), the epoch cursor re-bases.
                shard.epoch = 0
                shard.rebuild_epoch = 0
                logger.warning(
                    "dict shard %s: failed over to %s (repaired %d records)",
                    shard.route_key, addr, repaired,
                )
                return
            if time.monotonic() > deadline:
                raise DictServiceError(
                    f"dict shard {shard.route_key}: no live primary within "
                    f"{self._failover_deadline_s:.1f}s (last error: {cause})"
                )
            time.sleep(0.1)

    def _repair_shard(self, shard: _ShardState, new_total: int) -> int:
        """Re-merge the shard-local record history this mirror holds past
        the promoted replica's tables. The history is a prefix of the dead
        primary's record sequence and merge is first-wins: replicated rows
        dedup away and lost rows append in their original order, so the
        table is position-identical however many clients repair at once."""
        if new_total >= shard.chunks or not shard.hist_chunks:
            return 0
        sub = Bootstrap(chunk_size=self.bootstrap.chunk_size, inodes=[])
        for arr in shard.hist_blobs:
            sub.blobs += _blob_records(arr)
        for arr in shard.hist_ciphers:
            sub.ciphers += _cipher_records(arr)
        for arr in shard.hist_chunks:
            sub.chunks += _chunk_records(arr)
        for arr in shard.hist_batches:
            sub.batches += _batch_records(arr)
        if sub.ciphers:
            while len(sub.ciphers) < len(sub.blobs):
                sub.ciphers.append(CipherRecord())
        res = shard.client.merge(sub.to_bytes(), self.namespace)
        return int(res.get("added", 0))

    def _partition_bootstrap(self, data: bytes) -> list[Optional[bytes]]:
        """Split one image's bootstrap into per-shard sub-bootstraps: each
        shard receives exactly the chunks it owns, with the blobs, ciphers
        and batches those chunks reference, reindexed. Shards owning nothing
        get None."""
        source = Bootstrap.from_bytes(data)
        addrs = self.shard_addrs
        subs: list[Optional[Bootstrap]] = [None] * len(addrs)
        maps: list[dict[int, int]] = [{} for _ in addrs]
        src_batches = {(b.blob_index, b.compressed_offset): b for b in source.batches}
        batch_sent: list[set] = [set() for _ in addrs]
        owners = _shard_owners([r.digest for r in source.chunks], addrs) if source.chunks else []
        for rec, i in zip(source.chunks, owners):
            i = int(i)
            sub = subs[i]
            if sub is None:
                sub = subs[i] = Bootstrap(chunk_size=source.chunk_size, inodes=[])
            bmap = maps[i]
            idx = bmap.get(rec.blob_index)
            if idx is None:
                idx = bmap[rec.blob_index] = len(sub.blobs)
                sub.blobs.append(source.blobs[rec.blob_index])
                cipher = source.cipher_for(rec.blob_index)
                if cipher is not None or sub.ciphers:
                    while len(sub.ciphers) < idx:
                        sub.ciphers.append(CipherRecord())
                    sub.ciphers.append(cipher or CipherRecord())
            rec2 = ChunkRecord(**{**rec.__dict__})
            rec2.blob_index = idx
            sub.chunks.append(rec2)
            batch = src_batches.get((rec.blob_index, rec.compressed_offset))
            if batch is not None and (idx, batch.compressed_offset) not in batch_sent[i]:
                batch_sent[i].add((idx, batch.compressed_offset))
                sub.batches.append(
                    BatchRecord(idx, batch.compressed_offset, batch.uncompressed_base,
                                batch.uncompressed_size)
                )
        out: list[Optional[bytes]] = []
        for sub in subs:
            if sub is None:
                out.append(None)
                continue
            if sub.ciphers:
                while len(sub.ciphers) < len(sub.blobs):
                    sub.ciphers.append(CipherRecord())
            out.append(sub.to_bytes())
        return out

    def add_bootstrap_bytes(self, data: bytes) -> int:
        """Merge a converted image into the service (routed per shard when
        the namespace is sharded), then pull the resulting tails (with
        whatever other converters added first) into the mirror. Returns how
        many chunks this merge added."""
        if len(self._shards) == 1:
            res = self._with_failover(0, lambda: self.client.merge(data, self.namespace))
            added = int(res.get("added", 0))
        else:
            added = 0
            for i, (shard, sub) in enumerate(zip(self._shards, self._partition_bootstrap(data))):
                if sub is None:
                    continue
                failpoint.hit("dict.shard")
                _SHARD_BATCHES.labels("merge").inc()
                # Mid-merge failover: the un-acked sub-bootstrap is the
                # replay unit, re-merged against the promoted replica
                # (first-wins makes the replay idempotent).
                res = self._with_failover(
                    i, lambda s=shard, b=sub: s.client.merge(b, self.namespace)
                )
                added += int(res.get("added", 0))
        self.sync()
        return added

    def add_bootstrap(self, source: Bootstrap) -> int:
        return self.add_bootstrap_bytes(source.to_bytes())

    def save(self, path: str) -> None:
        """Service-side persistence (see :meth:`ServiceDict.save`); a
        sharded namespace persists one partition per shard
        (``<path>.shard<i>-of-<n>``)."""
        if len(self._shards) == 1:
            self._with_failover(0, lambda: self.client.save(path, self.namespace))
            return
        n = len(self._shards)
        for i, shard in enumerate(self._shards):
            self._with_failover(
                i,
                lambda s=shard, p=f"{path}.shard{i}-of-{n}": s.client.save(p, self.namespace),
            )


def placement_resolver(controller: str, timeout: float = 5.0):
    """``resolver(shard_idx) -> [primary_addr, *replica_addrs]`` backed by
    the controller's ``/api/v1/fleet/placement`` map (ha/placement.py):
    the candidates a failing client retries against; a promotion shows up
    as soon as the controller's epoch bumps."""

    def resolve(shard_idx: int) -> list[str]:
        doc = udshttp.get_json(controller, "/api/v1/fleet/placement", timeout=timeout)
        assignments = doc.get("assignments", [])
        if shard_idx >= len(assignments):
            return []
        a = assignments[shard_idx]
        out = [a.get("primary", {}).get("address", "")]
        out += [r.get("address", "") for r in a.get("replicas", [])]
        return [x for x in out if x]

    return resolve


def open_ha_chunk_dict(
    controller: str,
    namespace: str = DEFAULT_NAMESPACE,
    resolve_deadline_s: float = 15.0,
) -> ServiceChunkDict:
    """Placement-resolved HA mirror: shard primaries come from the
    controller's placement map, the rendezvous keys are the stable shard
    names (``dict-shard-<i>``) so a promotion never moves the key-space
    split, and failover re-resolves the map mid-merge."""
    resolver = placement_resolver(controller)
    deadline = time.monotonic() + resolve_deadline_s
    while True:
        try:
            doc = udshttp.get_json(controller, "/api/v1/fleet/placement")
            primaries = [a.get("primary", {}).get("address", "") for a in doc.get("assignments", [])]
            if primaries and all(primaries):
                break
        except Exception:  # noqa: BLE001 - the controller may still be placing
            pass
        if time.monotonic() > deadline:
            raise DictServiceError(
                f"placement map on {controller} has no full primary set "
                f"within {resolve_deadline_s:.1f}s"
            )
        time.sleep(0.1)
    return ServiceChunkDict(
        [DictClient(p) for p in primaries],
        namespace,
        resolver=resolver,
        route_keys=[f"dict-shard-{i}" for i in range(len(primaries))],
    )


def open_chunk_dict(arg: str):
    """Resolve a ``chunk_dict_path``-shaped argument:

    - ``service://<uds>[|<replica-uds>...][,<uds>...][#namespace]`` — a
      :class:`ServiceChunkDict` mirror; comma-separated groups are the
      rendezvous shards, ``|``-separated addresses inside a group a
      shard's failover candidates (primary first; the first address stays
      the shard's routing key across failovers);
    - ``service+ha://<controller-uds>[#namespace]`` — the shard set and
      failover candidates resolved live from the controller's placement
      map (:func:`open_ha_chunk_dict`);
    - anything else is the file-based dict (``bootstrap=…`` prefixed or a
      bare path)."""
    if arg.startswith("service+ha://"):
        controller, _, ns = arg[len("service+ha://"):].partition("#")
        return open_ha_chunk_dict(controller.strip(), ns or DEFAULT_NAMESPACE)
    if arg.startswith("service://"):
        socks, _, ns = arg[len("service://"):].partition("#")
        groups = [[a.strip() for a in g.split("|") if a.strip()] for g in socks.split(",") if g.strip()]
        clients = [DictClient(g[0]) for g in groups]
        failover = [g[1:] for g in groups]
        if any(failover):
            return ServiceChunkDict(clients, ns or DEFAULT_NAMESPACE, failover=failover)
        return ServiceChunkDict(clients, ns or DEFAULT_NAMESPACE)
    return ChunkDict.from_path(parse_chunk_dict_arg(arg))
