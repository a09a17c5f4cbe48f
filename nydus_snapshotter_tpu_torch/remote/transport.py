"""Pooled authenticated blob transport with redirect probing.

Reference pkg/utils/transport/pool.go:24-108: an LRU of authenticated
clients keyed by image ref; ``resolve`` probes the blob endpoint with a
``Range: bytes=0-0`` request, returning either the endpoint itself or the
redirect target (CDN URL), evicting and re-authenticating on failure.

Hardened failure handling on top of the reference:

- HTTP 429 honors the ``Retry-After`` header with one bounded in-place
  retry before the pooled client is thrown away (re-auth is expensive;
  a throttle is not an auth failure).
- On 5xx or connect failure from the upstream host, configured registry
  mirrors (config/mirrors.py hosts.toml dirs) are tried in order with
  per-host health scoring and cooldown before the error is surfaced.
"""

from __future__ import annotations

import threading
import time
from collections import OrderedDict
from typing import Optional

from nydus_snapshotter_tpu_torch import failpoint
from nydus_snapshotter_tpu_torch.remote.mirror import MirrorRouter, split_mirror_host
from nydus_snapshotter_tpu_torch.remote.reference import ParsedReference, registry_host
from nydus_snapshotter_tpu_torch.remote.registry import HTTPError, RegistryClient
from nydus_snapshotter_tpu_torch.utils import errdefs

HTTP_CLIENT_TIMEOUT = 60.0
_POOL_CAP = 3000
# Throttle pauses are bounded: a registry demanding more than this gets
# the normal evict + re-resolve path instead of a blocking sleep.
RETRY_AFTER_CAP = 5.0


class Pool:
    def __init__(
        self,
        plain_http: bool = False,
        insecure_tls: bool = False,
        mirrors_config_dir: str = "",
        sleep=time.sleep,
    ):
        self._lock = threading.Lock()
        self._clients: OrderedDict[str, RegistryClient] = OrderedDict()
        self.plain_http = plain_http
        self.insecure_tls = insecure_tls
        self.mirrors = MirrorRouter(mirrors_config_dir)
        self._sleep = sleep

    def _get(self, key: str) -> Optional[RegistryClient]:
        with self._lock:
            client = self._clients.get(key)
            if client is not None:
                self._clients.move_to_end(key)
            return client

    def _put(self, key: str, client: RegistryClient) -> None:
        with self._lock:
            self._clients[key] = client
            self._clients.move_to_end(key)
            while len(self._clients) > _POOL_CAP:
                self._clients.popitem(last=False)

    def _evict(self, key: str) -> None:
        with self._lock:
            self._clients.pop(key, None)

    def _probe(self, client: RegistryClient, repo: str, digest: str) -> str:
        """Range-probe the blob endpoint; return the final (possibly CDN)
        URL serving it (pool.go redirect :72-108)."""
        failpoint.hit("transport.probe")
        r = client.fetch_blob(repo, digest, byte_range=(0, 0))
        try:
            return r.url or f"/v2/{repo}/blobs/{digest}"
        finally:
            r.close()

    def _probe_throttled(self, client: RegistryClient, repo: str, digest: str) -> str:
        """Probe with one bounded Retry-After retry on 429: the client's
        token is still good, the registry is just shedding load."""
        try:
            return self._probe(client, repo, digest)
        except HTTPError as e:
            if e.code != 429:
                raise
            self._sleep(min(max(e.retry_after, 0.0), RETRY_AFTER_CAP))
            return self._probe(client, repo, digest)

    @staticmethod
    def _should_failover(err: BaseException) -> bool:
        """Mirror-worthy failures: server-side errors and connect-level
        failures. Auth problems and 404s must surface unchanged."""
        if isinstance(err, HTTPError):
            return err.code >= 500 or err.code == 429
        return isinstance(err, OSError)

    def _resolve_via_mirror(
        self, ref: ParsedReference, digest: str, keychain, upstream_host: str
    ) -> Optional[tuple[str, RegistryClient]]:
        for m in self.mirrors.candidates(upstream_host):
            netloc, plain = split_mirror_host(m.host)
            mclient = RegistryClient(
                netloc,
                keychain=keychain,
                plain_http=plain or self.plain_http,
                insecure_tls=self.insecure_tls,
                timeout=HTTP_CLIENT_TIMEOUT,
                headers=m.headers,
            )
            try:
                url = self._probe_throttled(mclient, ref.path, digest)
            except (HTTPError, errdefs.NydusError, OSError):
                self.mirrors.record(m, ok=False)
                continue
            self.mirrors.record(m, ok=True)
            # Subsequent fetches for this ref ride the mirror until it is
            # evicted by its own failure.
            self._put(ref.name, mclient)
            return url, mclient
        return None

    def resolve(self, ref: ParsedReference, digest: str, keychain=None) -> tuple[str, RegistryClient]:
        """(blob path, authenticated client) for ref@digest, reusing a
        cached authenticated client when its token still works; on 5xx or
        connect failure, failing over to configured registry mirrors."""
        failpoint.hit("transport.resolve")
        key = ref.name
        host = registry_host(ref.domain)
        client = self._get(key)
        if client is not None:
            try:
                return self._probe_throttled(client, ref.path, digest), client
            except (HTTPError, errdefs.NydusError, OSError):
                self._evict(key)
        client = RegistryClient(
            host, keychain=keychain, plain_http=self.plain_http,
            insecure_tls=self.insecure_tls, timeout=HTTP_CLIENT_TIMEOUT,
        )
        try:
            url = self._probe_throttled(client, ref.path, digest)
        except (HTTPError, errdefs.NydusError, OSError) as e:
            if self._should_failover(e):
                mirrored = self._resolve_via_mirror(ref, digest, keychain, host)
                if mirrored is not None:
                    return mirrored
            raise
        self._put(key, client)
        return url, client
