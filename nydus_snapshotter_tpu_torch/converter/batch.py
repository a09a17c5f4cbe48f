"""A chunk dict that grows across conversions: ``GrowingChunkDict``.

Each converted image's new chunks join the dict before the next image
converts, first-wins per digest, so every image after the first dedups
against everything before it; ``save`` writes a dict-image bootstrap that
``ChunkDict.from_path`` (and so ``PackOption.chunk_dict_path``) loads. The
order in which ``add_bootstrap`` merges images is the ordering authority of
the chunk-dict service (parallel/dict_service.py): a chunk's position in
the dict's chunk table is its index there.

The reference's ``BatchConverter`` and its HA replica path
(``append_records``) are not part of this module yet.
"""

from __future__ import annotations

import threading
from typing import Optional

from nydus_snapshotter_tpu_torch.converter.types import ConvertError
from nydus_snapshotter_tpu_torch.models.bootstrap import (
    BatchRecord,
    Bootstrap,
    ChunkDict,
    ChunkRecord,
    CipherRecord,
)


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
