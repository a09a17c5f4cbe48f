"""Remote facade: per-request resolver construction + plain-HTTP fallback.

Reference pkg/remote/remote.go:40-127. Each fetch gets a fresh
RegistryClient (tokens are short-lived; the reference rebuilds the
containerd resolver per request, remote.go:41-46). The plain-HTTP retry
heuristic flips the whole Remote to http after an error that looks like
"server gave HTTP response to HTTPS client" or a refused TLS connection
mentioning this ref's host (remote.go:96-115).
"""

from __future__ import annotations

from typing import Optional

from nydus_snapshotter_tpu_torch.remote.reference import parse_docker_ref, registry_host
from nydus_snapshotter_tpu_torch.remote.registry import Descriptor, RegistryClient


def _is_http_response_to_https(err: BaseException) -> bool:
    msg = str(err)
    return "HTTP response to HTTPS client" in msg or "WRONG_VERSION_NUMBER" in msg or "record layer failure" in msg


def _is_connection_refused(err: BaseException) -> bool:
    return "onnection refused" in str(err) or isinstance(err, ConnectionRefusedError)


class Remote:
    def __init__(self, keychain=None, insecure: bool = False):
        self.keychain = keychain
        self.insecure = insecure
        self.with_plain_http = False

    def client(self, ref: str) -> RegistryClient:
        parsed = parse_docker_ref(ref)
        return RegistryClient(
            registry_host(parsed.domain),
            keychain=self.keychain,
            plain_http=self.with_plain_http,
            insecure_tls=self.insecure,
        )

    def retry_with_plain_http(self, ref: str, err: Optional[BaseException]) -> bool:
        """Flip to plain HTTP when the error signature says the host speaks
        http; returns whether the caller should retry (remote.go:96-115)."""
        if err is None or not (_is_http_response_to_https(err) or _is_connection_refused(err)):
            return False
        self.with_plain_http = True
        return True

    # -- convenience wrappers (remote.go Resolve/Fetcher/Pusher) --------------

    def resolve(self, ref: str) -> Descriptor:
        parsed = parse_docker_ref(ref)
        return self.client(ref).resolve(parsed.path, parsed.digest or parsed.tag or "latest")

    def fetch_manifest(self, ref: str) -> tuple[Descriptor, bytes]:
        parsed = parse_docker_ref(ref)
        return self.client(ref).fetch_manifest(parsed.path, parsed.digest or parsed.tag or "latest")

    def fetch_blob(self, ref: str, digest: str):
        parsed = parse_docker_ref(ref)
        return self.client(ref).fetch_blob(parsed.path, digest)

    def push_blob(self, ref: str, digest: str, data) -> None:
        parsed = parse_docker_ref(ref)
        self.client(ref).push_blob(parsed.path, digest, data)
