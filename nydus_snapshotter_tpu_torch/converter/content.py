"""Local content-addressed blob store (containerd content.Store shape).

The reference converter and encryption paths run against containerd's
content store; this is the framework-native equivalent used by the
conversion surface, the encryption helpers, and tests: a directory of blobs
keyed ``sha256:<hex>`` with JSON label sidecars (labels back the GC refs +
the conversion-cache label, convert_unix.go:842-844). The PyTorch port's copy
of the reference package's ``converter/content.py``.
"""

from __future__ import annotations

import hashlib
import json
import os
import tempfile
from dataclasses import dataclass, field
from typing import Iterator, Optional

from nydus_snapshotter_tpu_torch.utils import errdefs


@dataclass
class BlobInfo:
    digest: str
    size: int
    labels: dict[str, str] = field(default_factory=dict)


class LocalContentStore:
    def __init__(self, root: str):
        self.root = root
        os.makedirs(os.path.join(root, "blobs"), exist_ok=True)

    def _blob_path(self, digest: str) -> str:
        algo, _, hexd = digest.partition(":")
        if not hexd or algo != "sha256":
            raise errdefs.InvalidArgument(f"unsupported digest {digest!r}")
        return os.path.join(self.root, "blobs", hexd)

    def _label_path(self, digest: str) -> str:
        return self._blob_path(digest) + ".labels.json"

    # -- readers --------------------------------------------------------------

    def reader_at(self, digest: str):
        path = self._blob_path(digest)
        if not os.path.exists(path):
            raise errdefs.NotFound(f"content {digest} not found")
        return open(path, "rb")

    def read(self, digest: str) -> bytes:
        with self.reader_at(digest) as f:
            return f.read()

    def info(self, digest: str) -> BlobInfo:
        path = self._blob_path(digest)
        if not os.path.exists(path):
            raise errdefs.NotFound(f"content {digest} not found")
        labels: dict[str, str] = {}
        if os.path.exists(self._label_path(digest)):
            with open(self._label_path(digest)) as f:
                labels = json.load(f)
        return BlobInfo(digest=digest, size=os.path.getsize(path), labels=labels)

    def exists(self, digest: str) -> bool:
        return os.path.exists(self._blob_path(digest))

    def walk(self) -> Iterator[BlobInfo]:
        blob_dir = os.path.join(self.root, "blobs")
        for name in sorted(os.listdir(blob_dir)):
            if name.endswith(".labels.json"):
                continue
            yield self.info("sha256:" + name)

    # -- writers --------------------------------------------------------------

    def write_blob(
        self, data: bytes, labels: Optional[dict[str, str]] = None,
        expected_digest: str = "",
    ) -> BlobInfo:
        digest = "sha256:" + hashlib.sha256(data).hexdigest()
        if expected_digest and digest != expected_digest:
            raise errdefs.InvalidArgument(
                f"content digest mismatch: got {digest}, want {expected_digest}"
            )
        path = self._blob_path(digest)
        if not os.path.exists(path):
            fd, tmp = tempfile.mkstemp(dir=os.path.dirname(path))
            try:
                with os.fdopen(fd, "wb") as f:
                    f.write(data)
                os.rename(tmp, path)
            except BaseException:
                if os.path.exists(tmp):
                    os.unlink(tmp)
                raise
        if labels:
            self.update_labels(digest, labels)
        return self.info(digest)

    def update_labels(self, digest: str, labels: dict[str, str]) -> None:
        info = self.info(digest)
        merged = {**info.labels, **labels}
        # a label set to None deletes (containerd update semantics)
        merged = {k: v for k, v in merged.items() if v is not None}
        with open(self._label_path(digest), "w") as f:
            json.dump(merged, f)

    def delete(self, digest: str) -> None:
        for path in (self._blob_path(digest), self._label_path(digest)):
            if os.path.exists(path):
                os.unlink(path)
