"""Batch conversion: many images, one growing cross-image chunk dict.

The reference achieves cross-repo dedup by feeding ``nydus-image`` a chunk
dict bootstrap per conversion (``--chunk-dict bootstrap=…``,
tool/builder.go:122-123) that an operator refreshes out of band. Here, as
in the reference package's ``converter/batch.py``, the dict is a growing
object: each converted image's new chunks join the dict before the next
image converts (first-wins per digest), so every image after the first
dedups against everything before it, and ``save`` writes a dict-image
bootstrap that ``ChunkDict.from_path`` (and so
``PackOption.chunk_dict_path``) loads. The order in which ``add_bootstrap``
merges images is also the ordering authority of the chunk-dict service
(parallel/dict_service.py): a chunk's position in the dict's chunk table
is its index there.

``BatchConverter`` packs each image's layers on a thread pool (every lane
of converter/pack.py: on the card, the fused lane launches K1 and K2, or
K4, once per layer, each layer on a CUDA stream of its own), merges them with converter/convert.Merge against the
dict, and grows the dict. Images convert in caller order and the dict is
read-only inside an image, so the result does not depend on the fan-out.

With the adaptive codec (``codec=``, or ``[compression] adaptive`` with
zstd) one codec serves the whole batch: its trainer samples chunks across
images, a dictionary trained between images (``[compression] train``)
applies to every image after it, and a service-backed batch adopts the
namespace's dictionary before its first image and publishes the one it
trains.

Refused with ``ConvertError``: the HA dict service (``service+ha://``,
``|`` failover groups) with ``GrowingChunkDict.append_records``, its
replica path.
"""

from __future__ import annotations

import contextlib
import io
import threading
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import Optional

import torch

from nydus_snapshotter_tpu_torch import trace
from nydus_snapshotter_tpu_torch.converter.convert import Merge, Pack, PackResult
from nydus_snapshotter_tpu_torch.converter.types import ConvertError, MergeOption, PackOption
from nydus_snapshotter_tpu_torch.models.bootstrap import (
    BatchRecord,
    Bootstrap,
    ChunkDict,
    ChunkRecord,
    CipherRecord,
)
from nydus_snapshotter_tpu_torch.tensors import resolve_device


class GrowingChunkDict:
    """A chunk dict that accumulates chunks across conversions.

    Exposes the probe interface Pack consumes (``get``, ``blob_id_for``,
    ``__contains__``, ``.bootstrap``) backed by a dict-image bootstrap
    (chunk/blob/batch/cipher tables, no inodes).
    """

    def __init__(self, seed: Optional[Bootstrap] = None, chunk_size: int = 0x100000):
        self.bootstrap = Bootstrap(chunk_size=seed.chunk_size if seed else chunk_size, inodes=[])
        self._by_digest: dict[bytes, ChunkRecord] = {}
        self._blob_index_of: dict[str, int] = {}
        self._batch_seen: set[tuple[int, int]] = set()
        self._lock = threading.Lock()
        if seed is not None:
            self.add_bootstrap(seed)

    # -- ChunkDict probe interface -----------------------------------------

    def __len__(self) -> int:
        return len(self._by_digest)

    def __contains__(self, digest: bytes) -> bool:
        return digest in self._by_digest

    def get(self, digest: bytes) -> Optional[ChunkRecord]:
        return self._by_digest.get(digest)

    def blob_id_for(self, chunk: ChunkRecord) -> str:
        return self.bootstrap.blobs[chunk.blob_index].blob_id

    def digests_u32(self):
        return self.bootstrap.chunk_digests_u32()

    def blob_ids(self) -> list[str]:
        return [b.blob_id for b in self.bootstrap.blobs]

    # -- growth -------------------------------------------------------------

    def _blob_index(self, source: Bootstrap, src_idx: int) -> int:
        bid = source.blobs[src_idx].blob_id
        idx = self._blob_index_of.get(bid)
        if idx is None:
            idx = len(self.bootstrap.blobs)
            self._blob_index_of[bid] = idx
            self.bootstrap.blobs.append(source.blobs[src_idx])
            cipher = source.cipher_for(src_idx)
            if cipher is not None or self.bootstrap.ciphers:
                # keep the cipher table parallel to blobs once any blob is
                # encrypted (Bootstrap serialization invariant)
                while len(self.bootstrap.ciphers) < idx:
                    self.bootstrap.ciphers.append(CipherRecord())
                self.bootstrap.ciphers.append(cipher or CipherRecord())
        return idx

    def add_bootstrap_bytes(self, data: bytes) -> int:
        """Merge a serialized bootstrap (what pack results and the
        dict-service merge RPC carry)."""
        return self.add_bootstrap(Bootstrap.from_bytes(data))

    def add_bootstrap(self, source: Bootstrap) -> int:
        """Merge a converted image's chunks into the dict (first-wins per
        digest). Returns how many new chunks joined."""
        added = 0
        with self._lock:
            src_batches = {(b.blob_index, b.compressed_offset): b for b in source.batches}
            for rec in source.chunks:
                if rec.digest in self._by_digest:
                    continue
                if rec.blob_index >= len(source.blobs):
                    raise ConvertError(
                        f"chunk references blob index {rec.blob_index} "
                        f"outside the source blob table"
                    )
                new_idx = self._blob_index(source, rec.blob_index)
                rec2 = ChunkRecord(**{**rec.__dict__})
                rec2.blob_index = new_idx
                self._by_digest[rec2.digest] = rec2
                self.bootstrap.chunks.append(rec2)
                added += 1
                batch = src_batches.get((rec.blob_index, rec.compressed_offset))
                if batch is not None and (new_idx, batch.compressed_offset) not in self._batch_seen:
                    self._batch_seen.add((new_idx, batch.compressed_offset))
                    self.bootstrap.batches.append(
                        BatchRecord(
                            new_idx,
                            batch.compressed_offset,
                            batch.uncompressed_base,
                            batch.uncompressed_size,
                        )
                    )
        return added

    # -- persistence ---------------------------------------------------------

    def save(self, path: str) -> None:
        """Write a dict-image bootstrap loadable by ChunkDict.from_path."""
        with self._lock:
            if self.bootstrap.ciphers:
                while len(self.bootstrap.ciphers) < len(self.bootstrap.blobs):
                    self.bootstrap.ciphers.append(CipherRecord())
            data = self.bootstrap.to_bytes()
        with open(path, "wb") as f:
            f.write(data)

    @classmethod
    def load(cls, path: str) -> "GrowingChunkDict":
        return cls(seed=ChunkDict.from_path(path).bootstrap)


@dataclass
class ImageResult:
    """One converted image: merged bootstrap + referenced blobs + the layer
    blobs this conversion actually produced (already-deduped content is
    referenced, not re-stored)."""

    name: str
    bootstrap: bytes
    blob_digests: list[str]
    layer_blobs: dict[str, bytes] = field(default_factory=dict)  # blob_id -> packed blob
    new_dict_chunks: int = 0


class BatchConverter:
    """Convert an ordered stream of images with cross-image dedup.

    Layers inside one image pack in parallel (the dict is read-only during
    an image); the dict grows between images, so image N dedups against
    images 0..N-1 plus any seeded dict (``dict_path``) — the top-100 /
    cross-repo shape of BASELINE configs #3 and #5. ``layer_fanout`` caps
    the concurrently packing layers (0/None = ``max_workers``, then the
    pool default). ``device`` is where the device lanes run (CUDA unless
    ``"cpu"`` is asked for).

    The fan-out runs under one aggregate memory budget: every layer's
    stage-parallel pipeline (parallel/pipeline.py) draws its speculative
    compression bytes from the same ``MemoryBudget``, so batch memory is
    bounded however many layers are in flight. ``memory_budget_mib`` sizes
    a converter-private budget instead of the process-shared one. Each
    image is one ``convert`` trace span; its layers' spans join it from the
    pool's threads.

    With a dict service configured (``dict_service=`` unix-socket address,
    ``,``-separated shard addresses or a ``service://`` argument, or
    ``NTPU_DICT_SERVICE``), the dict is a ``ServiceChunkDict`` mirror of
    one registry-wide table instead of a private copy: probes stay local,
    each converted image merges through one batched RPC, and the mirror
    re-syncs from the service's record tail.
    """

    def __init__(
        self,
        opt: PackOption,
        dict_path: Optional[str] = None,
        max_workers: Optional[int] = None,
        memory_budget_mib: Optional[int] = None,
        layer_fanout: Optional[int] = None,
        dict_service: Optional[str] = None,
        namespace: Optional[str] = None,
        codec=None,
        device=None,
    ):
        if opt.chunk_dict_path:
            raise ConvertError(
                "BatchConverter owns the chunk dict; use dict_path= instead "
                "of PackOption.chunk_dict_path"
            )
        from nydus_snapshotter_tpu_torch.converter import codec as codec_mod
        from nydus_snapshotter_tpu_torch.parallel import dict_service as dict_service_mod
        from nydus_snapshotter_tpu_torch.parallel import pipeline as pipeline_mod

        self.opt = opt
        self.device = device
        self.max_workers = max_workers
        self.layer_fanout = layer_fanout
        self.budget = (
            pipeline_mod.MemoryBudget(memory_budget_mib << 20)
            if memory_budget_mib
            else pipeline_mod.shared_budget()
        )
        dcfg = dict_service_mod.resolve_dict_config()
        service = dict_service if dict_service is not None else dcfg.service
        self.namespace = namespace or dcfg.namespace
        # Adaptive codec engine (off by default): one codec for the whole
        # batch so the dict trainer samples across images and the trained
        # dictionary applies to everything converted after it.
        self.codec = codec if codec is not None else codec_mod.resolve_codec(opt)
        if service:
            if dict_path:
                raise ConvertError(
                    "dict_path seeds a private dict; a service-backed batch "
                    "seeds through the service (merge the seed bootstrap "
                    "into the namespace instead)"
                )
            if service.startswith("service+ha://") or "|" in service:
                raise ConvertError(
                    f"dict service {service!r}: the HA dict service (service+ha://, '|' "
                    "failover groups; ROADMAP.md Queue A item 6) is not ported"
                )
            # Comma-separated addresses = a rendezvous-sharded namespace
            # (one DictService process per shard); one address keeps the
            # single-service path byte-for-byte.
            if service.startswith("service://"):
                arg = service if "#" in service else service + "#" + self.namespace
                self.dict = dict_service_mod.open_chunk_dict(arg)
            else:
                self.dict = dict_service_mod.ServiceChunkDict(
                    [
                        dict_service_mod.DictClient(s.strip())
                        for s in service.split(",")
                        if s.strip()
                    ],
                    self.namespace,
                )
            if self.codec is not None and self.codec.trained is None:
                # Cross-host sharing: adopt the namespace's already-trained
                # dictionary (epoch-stamped) before converting anything.
                blob = self.dict.client.get_zdict(self.namespace)
                if blob:
                    self.codec.set_trained(codec_mod.TrainedDict.deserialize(blob))
        else:
            self.dict = GrowingChunkDict.load(dict_path) if dict_path else GrowingChunkDict()

    def _layer_stream(self):
        """A CUDA stream of its own for one layer's pack, on the lanes that
        use the card. Threads share the default stream otherwise, and one
        layer's host sync (pass 1's candidate download, a digest batch's
        event) would wait for every other layer's copies and kernels."""
        opt = self.opt
        if opt.backend in ("fused", "jax") or opt.digest_backend == "jax":
            dev = resolve_device(self.device)
            if dev.type == "cuda":
                return torch.cuda.stream(torch.cuda.Stream(dev))
        return contextlib.nullcontext()

    def convert_image(self, name: str, layer_tars: list[bytes]) -> ImageResult:
        if not layer_tars:
            raise ConvertError(f"image {name}: no layers")
        chunk_dict = self.dict if len(self.dict) else None

        def pack_one(tar: bytes, ctx) -> tuple[bytes, PackResult]:
            with trace.with_context(ctx), self._layer_stream():
                out = io.BytesIO()
                res = Pack(out, tar, self.opt, chunk_dict=chunk_dict, device=self.device,
                           budget=self.budget, codec=self.codec)
                return out.getvalue(), res

        with trace.span("convert", image=name, layers=len(layer_tars)):
            ctx = trace.capture()  # contextvars do not cross the pool: carry the span
            if len(layer_tars) > 1:
                fanout = self.layer_fanout or self.max_workers
                with ThreadPoolExecutor(max_workers=fanout) as pool:
                    packed = list(pool.map(lambda t: pack_one(t, ctx), layer_tars))
            else:
                packed = [pack_one(layer_tars[0], ctx)]

            merged = Merge(
                [blob for blob, _ in packed],
                MergeOption(fs_version=self.opt.fs_version),
                chunk_dict=chunk_dict,
            )
            added = self.dict.add_bootstrap_bytes(merged.bootstrap)
        self._maybe_train_codec()
        layer_blobs = {res.blob_id: blob for blob, res in packed if res.blob_id}
        return ImageResult(
            name=name,
            bootstrap=merged.bootstrap,
            blob_digests=merged.blob_digests,
            layer_blobs=layer_blobs,
            new_dict_chunks=added,
        )

    def _maybe_train_codec(self, force: bool = False):
        """Between-images dictionary training: once the codec's sample
        reservoir fills, train the namespace dictionary and (when
        service-backed) publish it so converters on other hosts adopt it.
        Training failure is not fatal: the batch continues untrained."""
        if self.codec is None:
            return None
        td = self.codec.maybe_train(force=force)
        if td is None:
            return None
        client = getattr(self.dict, "client", None)
        if client is not None:
            try:
                client.put_zdict(td.serialize(), self.namespace)
            except Exception:
                # The dictionary still applies locally; sharing is
                # best-effort (the service may predate the endpoint).
                pass
        return td

    def train_codec_dict(self):
        """Force dictionary training now from whatever the sampler holds
        (the between-images path waits for a full sample budget). Returns
        the TrainedDict, or None (no codec, no samples, or training
        failed: the batch continues untrained)."""
        return self._maybe_train_codec(force=True)

    def convert_many(self, images: list[tuple[str, list[bytes]]]) -> list[ImageResult]:
        """Caller order IS the dedup order; results come back in it too."""
        return [self.convert_image(name, layers) for name, layers in images]

    def save_dict(self, path: str) -> None:
        self.dict.save(path)

    def save_trained_dict(self, path: str) -> bool:
        """Persist the codec's trained dictionary (epoch-stamped, beside the
        chunk dict); False when none was trained."""
        if self.codec is None or self.codec.trained is None:
            return False
        self.codec.trained.save(path)
        return True
