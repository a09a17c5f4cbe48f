"""Aliyun OSS blob backend with header signing.

Reference pkg/backend/oss.go:25-192 (aliyun SDK there). Config keys:
endpoint, bucket_name, object_prefix, access_key_id, access_key_secret.
Signing follows the OSS "Authorization: OSS AccessKeyId:Signature" header
scheme (HMAC-SHA1 over verb/md5/type/date/canonicalized resource).
"""

from __future__ import annotations

import base64
import email.utils
import hashlib
import hmac
import http.client
import urllib.parse
from typing import Optional

from nydus_snapshotter_tpu_torch.backend.backend import (
    MULTIPART_CHUNK_SIZE,
    Backend,
    BlobSource,
    _read_source,
    _source_size,
    digest_hex,
    multipart_upload,
)
from nydus_snapshotter_tpu_torch.utils import errdefs


class OSSBackend(Backend):
    def __init__(self, config: dict, force_push: bool = False, part_size: int = MULTIPART_CHUNK_SIZE):
        endpoint = config.get("endpoint", "")
        self.bucket = config.get("bucket_name", "")
        if not endpoint or not self.bucket:
            raise errdefs.InvalidArgument("invalid OSS configuration: missing 'endpoint' or 'bucket_name'")
        self.scheme = "https"
        if "://" in endpoint:
            self.scheme, endpoint = endpoint.split("://", 1)
        self.endpoint = endpoint
        self.object_prefix = config.get("object_prefix", "")
        self.access_key = config.get("access_key_id", "")
        self.secret_key = config.get("access_key_secret", "")
        self.force_push = force_push
        self.part_size = part_size

    def _sign(self, verb: str, key: str, date: str, content_type: str = "", subresource: str = "") -> str:
        resource = f"/{self.bucket}/{key}{subresource}"
        to_sign = f"{verb}\n\n{content_type}\n{date}\n{resource}"
        mac = hmac.new(self.secret_key.encode(), to_sign.encode(), hashlib.sha1)
        return base64.b64encode(mac.digest()).decode()

    def _request(self, method: str, key: str, query: Optional[dict] = None, body: bytes = b"",
                 content_type: str = ""):
        query = query or {}
        date = email.utils.formatdate(usegmt=True)
        # Subresources (uploads, uploadId, partNumber) join the signed resource.
        signed_q = {k: v for k, v in query.items() if k in ("uploads", "uploadId", "partNumber")}
        subresource = ""
        if signed_q:
            parts = [k if v == "" else f"{k}={v}" for k, v in sorted(signed_q.items())]
            subresource = "?" + "&".join(parts)
        sig = self._sign(method, key, date, content_type, subresource)
        hdrs = {
            "Host": f"{self.bucket}.{self.endpoint}",
            "Date": date,
            "Authorization": f"OSS {self.access_key}:{sig}",
        }
        if content_type:
            hdrs["Content-Type"] = content_type
        if body:
            hdrs["Content-Length"] = str(len(body))
        conn_cls = http.client.HTTPSConnection if self.scheme == "https" else http.client.HTTPConnection
        conn = conn_cls(f"{self.bucket}.{self.endpoint}", timeout=60)
        qs = "?" + urllib.parse.urlencode(query) if query else ""
        try:
            conn.request(method, f"/{urllib.parse.quote(key)}{qs}", body=body or None, headers=hdrs)
            resp = conn.getresponse()
            data = resp.read()
            return resp.status, dict(resp.getheaders()), data
        finally:
            conn.close()

    def _object_key(self, digest: str) -> str:
        return self.object_prefix + digest_hex(digest)

    def _exists(self, key: str) -> bool:
        status, _, _ = self._request("HEAD", key)
        if status == 200:
            return True
        if status in (403, 404):
            return False
        raise errdefs.Unavailable(f"OSS HEAD {key}: HTTP {status}")

    def push(self, data: BlobSource, digest: str) -> None:
        key = self._object_key(digest)
        if self._exists(key) and not self.force_push:
            return
        # The reference multipart-splits large blobs (oss.go:99-157); same
        # threshold here, via the shared streaming multipart driver.
        if _source_size(data) <= self.part_size:
            blob = _read_source(data)
            status, _, body = self._request("PUT", key, body=blob)
            if status // 100 != 2:
                raise errdefs.Unavailable(f"OSS PUT {key}: HTTP {status} {body[:200]!r}")
            return
        multipart_upload(self._request, key, data, self.part_size, ("UploadId",), "OSS")

    def check(self, digest: str) -> str:
        key = self._object_key(digest)
        if self._exists(key):
            return key
        raise errdefs.NotFound(f"blob {digest} not in oss backend")

    def type(self) -> str:
        return "oss"
