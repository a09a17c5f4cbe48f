"""Blob storage backends for conversion push (reference pkg/backend).

``new_backend(type, config, force_push)`` mirrors backend.go:46-57 with the
same three types: ``oss``, ``s3``, ``localfs``. The cloud backends are
stdlib HTTP clients (OSS header signing, AWS SigV4) instead of vendored
SDKs; multipart uploads use the same 500 MiB default part size
(backend.go:24-28).
"""

from nydus_snapshotter_tpu_torch.backend.backend import (
    MULTIPART_CHUNK_SIZE,
    Backend,
    new_backend,
)
from nydus_snapshotter_tpu_torch.backend.localfs import LocalFSBackend
from nydus_snapshotter_tpu_torch.backend.oss import OSSBackend
from nydus_snapshotter_tpu_torch.backend.s3 import S3Backend

__all__ = [
    "Backend",
    "new_backend",
    "MULTIPART_CHUNK_SIZE",
    "LocalFSBackend",
    "OSSBackend",
    "S3Backend",
]
