"""Local-filesystem blob backend (reference pkg/backend/localfs.go:24-99)."""

from __future__ import annotations

import os

from nydus_snapshotter_tpu_torch.backend.backend import Backend, BlobSource, _read_source, digest_hex
from nydus_snapshotter_tpu_torch.utils import errdefs


class LocalFSBackend(Backend):
    def __init__(self, config: dict, force_push: bool = False):
        dir_ = config.get("dir")
        if not dir_:
            raise errdefs.InvalidArgument("no `dir` option is specified")
        self.dir = dir_
        self.force_push = force_push

    def _dst_path(self, blob_id: str) -> str:
        return os.path.join(self.dir, blob_id)

    def push(self, data: BlobSource, digest: str) -> None:
        try:
            self.check(digest)
            if not self.force_push:
                return
        except errdefs.NotFound:
            pass
        os.makedirs(self.dir, exist_ok=True)
        path = self._dst_path(digest_hex(digest))
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            f.write(_read_source(data))
        os.replace(tmp, path)

    def check(self, digest: str) -> str:
        path = self._dst_path(digest_hex(digest))
        st = None
        try:
            st = os.stat(path)
        except FileNotFoundError:
            raise errdefs.NotFound(f"blob {digest} not in localfs backend") from None
        if not os.path.isfile(path) or st is None:
            raise errdefs.NotFound(f"{path} is not a regular file")
        return path

    def type(self) -> str:
        return "localfs"
