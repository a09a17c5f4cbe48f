"""S3 blob backend with stdlib AWS SigV4 signing.

Reference pkg/backend/s3.go:29-187 (aws-sdk-go-v2 there). Same config
schema (access_key_id/secret, endpoint, scheme, bucket_name, region,
object_prefix), same existence-check-then-upload flow, multipart upload
for blobs over the part size.
"""

from __future__ import annotations

import datetime
import hashlib
import hmac
import http.client
import urllib.parse
from typing import Mapping, Optional

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


def _sign(key: bytes, msg: str) -> bytes:
    return hmac.new(key, msg.encode(), hashlib.sha256).digest()


def sigv4_headers(
    method: str,
    host: str,
    path: str,
    query: Mapping[str, str],
    region: str,
    access_key: str,
    secret_key: str,
    payload_sha256: str,
    now: Optional[datetime.datetime] = None,
) -> dict[str, str]:
    """AWS Signature V4 for the s3 service; returns headers to attach."""
    now = now or datetime.datetime.now(datetime.timezone.utc)
    amz_date = now.strftime("%Y%m%dT%H%M%SZ")
    datestamp = now.strftime("%Y%m%d")

    canonical_query = "&".join(
        f"{urllib.parse.quote(k, safe='')}={urllib.parse.quote(v, safe='')}"
        for k, v in sorted(query.items())
    )
    headers = {
        "host": host,
        "x-amz-content-sha256": payload_sha256,
        "x-amz-date": amz_date,
    }
    signed_headers = ";".join(sorted(headers))
    canonical_headers = "".join(f"{k}:{headers[k]}\n" for k in sorted(headers))
    canonical_request = "\n".join(
        [method, urllib.parse.quote(path), canonical_query, canonical_headers, signed_headers, payload_sha256]
    )
    scope = f"{datestamp}/{region}/s3/aws4_request"
    string_to_sign = "\n".join(
        ["AWS4-HMAC-SHA256", amz_date, scope, hashlib.sha256(canonical_request.encode()).hexdigest()]
    )
    k = _sign(_sign(_sign(_sign(b"AWS4" + secret_key.encode(), datestamp), region), "s3"), "aws4_request")
    signature = hmac.new(k, string_to_sign.encode(), hashlib.sha256).hexdigest()
    return {
        "Host": host,
        "x-amz-content-sha256": payload_sha256,
        "x-amz-date": amz_date,
        "Authorization": (
            f"AWS4-HMAC-SHA256 Credential={access_key}/{scope}, "
            f"SignedHeaders={signed_headers}, Signature={signature}"
        ),
    }


class S3Backend(Backend):
    def __init__(self, config: dict, force_push: bool = False, part_size: int = MULTIPART_CHUNK_SIZE):
        endpoint = config.get("endpoint") or "s3.amazonaws.com"
        scheme = config.get("scheme") or "https"
        self.bucket = config.get("bucket_name", "")
        self.region = config.get("region", "")
        if not self.bucket or not self.region:
            raise errdefs.InvalidArgument("invalid S3 configuration: missing 'bucket_name' or 'region'")
        self.endpoint = endpoint
        self.scheme = scheme
        self.object_prefix = config.get("object_prefix", "")
        self.access_key = config.get("access_key_id", "")
        self.secret_key = config.get("access_key_secret", "")
        self.force_push = force_push
        self.part_size = part_size

    # -- raw signed request ---------------------------------------------------

    def _request(self, method: str, key: str, query: Optional[dict] = None, body: bytes = b""):
        query = query or {}
        path = f"/{self.bucket}/{urllib.parse.quote(key)}"
        payload_hash = hashlib.sha256(body).hexdigest()
        hdrs = sigv4_headers(
            method, self.endpoint, f"/{self.bucket}/{key}", query,
            self.region, self.access_key, self.secret_key, payload_hash,
        )
        if body:
            hdrs["Content-Length"] = str(len(body))
        conn_cls = http.client.HTTPSConnection if self.scheme == "https" else http.client.HTTPConnection
        conn = conn_cls(self.endpoint, timeout=60)
        qs = "?" + urllib.parse.urlencode(query) if query else ""
        try:
            conn.request(method, path + qs, body=body or None, headers=hdrs)
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
        raise errdefs.Unavailable(f"S3 HEAD {key}: HTTP {status}")

    # -- Backend --------------------------------------------------------------

    def push(self, data: BlobSource, digest: str) -> None:
        key = self._object_key(digest)
        if self._exists(key) and not self.force_push:
            return
        if _source_size(data) <= self.part_size:
            blob = _read_source(data)
            status, _, body = self._request("PUT", key, body=blob)
            if status // 100 != 2:
                raise errdefs.Unavailable(f"S3 PUT {key}: HTTP {status} {body[:200]!r}")
            return
        multipart_upload(
            self._request, key, data, self.part_size,
            ("{http://s3.amazonaws.com/doc/2006-03-01/}UploadId", "UploadId"), "S3",
        )

    def check(self, digest: str) -> str:
        key = self._object_key(digest)
        if self._exists(key):
            return key
        raise errdefs.NotFound(f"blob {digest} not in s3 backend")

    def type(self) -> str:
        return "s3"
