"""High-level blob resolver: ref + digest + snapshot labels -> stream.

Reference pkg/resolve/resolver.go:23-69: parse the ref, derive the
keychain from labels/docker-config (auth.GetRegistryKeyChain), resolve an
authenticated transport from the pool, GET the blob with retries. Retries
here are deadline- and jitter-aware: the whole retry loop fits inside one
HTTP client timeout instead of multiplying it (three 60 s attempts must
not become a 180 s hang on a dead registry).
"""

from __future__ import annotations

from typing import Mapping, Optional

from nydus_snapshotter_tpu_torch.remote.reference import parse_docker_ref
from nydus_snapshotter_tpu_torch.remote.transport import HTTP_CLIENT_TIMEOUT, Pool
from nydus_snapshotter_tpu_torch.utils import retry as retry_lib


class Resolver:
    def __init__(
        self,
        plain_http: bool = False,
        insecure_tls: bool = False,
        mirrors_config_dir: str = "",
    ):
        self._pool = Pool(
            plain_http=plain_http,
            insecure_tls=insecure_tls,
            mirrors_config_dir=mirrors_config_dir,
        )

    def resolve(self, ref: str, digest: str, labels: Optional[Mapping[str, str]] = None):
        """Streaming reader over the blob ``digest`` of image ``ref``."""
        from nydus_snapshotter_tpu_torch.auth.keychain import get_registry_keychain

        parsed = parse_docker_ref(ref)
        keychain = get_registry_keychain(parsed.domain, ref, labels or {})

        def fetch():
            _, client = self._pool.resolve(parsed, digest, keychain)
            return client.fetch_blob(parsed.path, digest)

        return retry_lib.do_with_deadline(
            fetch, deadline=HTTP_CLIENT_TIMEOUT, attempts=3, delay=0.2
        )
