"""Backend interface + factory (reference pkg/backend/backend.go:31-57)."""

from __future__ import annotations

import json
from abc import ABC, abstractmethod
from typing import Union

from nydus_snapshotter_tpu_torch.utils import errdefs

BACKEND_TYPE_OSS = "oss"
BACKEND_TYPE_S3 = "s3"
BACKEND_TYPE_LOCALFS = "localfs"

# Default multipart part size (backend.go:24-28).
MULTIPART_CHUNK_SIZE = 500 * 1024 * 1024

BlobSource = Union[bytes, bytearray, str]  # raw bytes or a file path


def _read_source(data: BlobSource) -> bytes:
    if isinstance(data, (bytes, bytearray)):
        return bytes(data)
    with open(data, "rb") as f:
        return f.read()


def _source_size(data: BlobSource) -> int:
    if isinstance(data, (bytes, bytearray)):
        return len(data)
    import os

    return os.path.getsize(data)


def _iter_parts(data: BlobSource, part_size: int):
    """Yield part-sized byte chunks without loading file sources whole."""
    if isinstance(data, (bytes, bytearray)):
        for off in range(0, len(data), part_size):
            yield bytes(data[off : off + part_size])
        return
    with open(data, "rb") as f:
        while True:
            part = f.read(part_size)
            if not part:
                return
            yield part


def digest_hex(digest: str) -> str:
    return digest.split(":", 1)[-1]


def multipart_upload(request, key: str, data: BlobSource, part_size: int,
                     upload_id_tags: tuple[str, ...], service: str) -> None:
    """Generic multipart-upload driver shared by S3 and OSS (both speak the
    same initiate / per-part PUT / complete-XML / abort protocol).

    ``request(method, key, query=None, body=b"")`` returns
    ``(status, headers, body)``. Parts are streamed one at a time; the
    session is aborted on failure so no orphaned parts accrue storage.
    """
    import xml.etree.ElementTree as ET

    from nydus_snapshotter_tpu_torch.utils import errdefs as _errdefs

    status, _, body = request("POST", key, query={"uploads": ""})
    if status // 100 != 2:
        raise _errdefs.Unavailable(f"{service} InitiateMultipartUpload: HTTP {status}")
    root = ET.fromstring(body)
    upload_id = ""
    for tag in upload_id_tags:
        upload_id = root.findtext(tag) or upload_id
    try:
        etags: list[tuple[int, str]] = []
        for idx, part in enumerate(_iter_parts(data, part_size), start=1):
            status, hdrs, _ = request(
                "PUT", key, query={"partNumber": str(idx), "uploadId": upload_id}, body=part
            )
            if status // 100 != 2:
                raise _errdefs.Unavailable(f"{service} UploadPart {idx}: HTTP {status}")
            etags.append((idx, {k.lower(): v for k, v in hdrs.items()}.get("etag", "")))
        parts_xml = "".join(
            f"<Part><PartNumber>{n}</PartNumber><ETag>{e}</ETag></Part>" for n, e in etags
        )
        complete = f"<CompleteMultipartUpload>{parts_xml}</CompleteMultipartUpload>".encode()
        status, _, _ = request("POST", key, query={"uploadId": upload_id}, body=complete)
        if status // 100 != 2:
            raise _errdefs.Unavailable(f"{service} CompleteMultipartUpload: HTTP {status}")
    except BaseException:
        try:
            request("DELETE", key, query={"uploadId": upload_id})
        except Exception:
            pass
        raise


class Backend(ABC):
    """Uploads conversion blobs to remote storage (backend.go:31-40)."""

    @abstractmethod
    def push(self, data: BlobSource, digest: str) -> None:
        """Push blob content for ``digest`` (skip if present, unless
        force_push)."""

    @abstractmethod
    def check(self, digest: str) -> str:
        """Return the backend path/key if the blob exists; raise NotFound
        otherwise."""

    @abstractmethod
    def type(self) -> str:
        ...


def new_backend(backend_type: str, config: bytes | str | dict, force_push: bool = False) -> Backend:
    from nydus_snapshotter_tpu_torch.backend.localfs import LocalFSBackend
    from nydus_snapshotter_tpu_torch.backend.oss import OSSBackend
    from nydus_snapshotter_tpu_torch.backend.s3 import S3Backend

    if isinstance(config, (bytes, str)):
        config = json.loads(config)
    if backend_type == BACKEND_TYPE_OSS:
        return OSSBackend(config, force_push)
    if backend_type == BACKEND_TYPE_S3:
        return S3Backend(config, force_push)
    if backend_type == BACKEND_TYPE_LOCALFS:
        return LocalFSBackend(config, force_push)
    raise errdefs.InvalidArgument(f"unsupported backend type {backend_type}")
