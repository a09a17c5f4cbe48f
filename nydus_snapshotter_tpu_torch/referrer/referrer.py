"""Find a companion nydus image for a plain OCI image via the distribution
referrers API.

Reference pkg/referrer/referrer.go:43-138 + manager.go:39-101: ask the
registry for referrers of the image's manifest digest, take the first
manifest in the returned index, and accept it when its last layer carries
the nydus-bootstrap annotation. Results are LRU-cached and concurrent
lookups for one digest are deduplicated (singleflight). ``fetch_metadata``
downloads that metadata layer and unpacks ``image/image.boot`` from it.
"""

from __future__ import annotations

import json
import logging
import threading
from collections import OrderedDict
from typing import Optional

from nydus_snapshotter_tpu_torch import constants
from nydus_snapshotter_tpu_torch.auth import keychain as authmod
from nydus_snapshotter_tpu_torch.remote.registry import Descriptor
from nydus_snapshotter_tpu_torch.remote.reference import parse_docker_ref
from nydus_snapshotter_tpu_torch.remote.remote import Remote
from nydus_snapshotter_tpu_torch.remote.unpack import unpack
from nydus_snapshotter_tpu_torch.utils import errdefs, singleflight

logger = logging.getLogger(__name__)

# Containerd restricts the max size of a manifest index to 8M (referrer.go:27).
MAX_MANIFEST_INDEX_SIZE = 0x800000
METADATA_NAME_IN_LAYER = "image/image.boot"

_CACHE_SIZE = 500


class Referrer:
    """One-shot referrer prober bound to a keychain (referrer.go:30-41)."""

    def __init__(self, keychain=None, insecure: bool = False):
        self.remote = Remote(keychain=keychain, insecure=insecure)

    def check_referrer(self, ref: str, manifest_digest: str) -> Descriptor:
        """Nydus metadata-layer descriptor for ``ref``'s companion image
        (referrer.go:43-104)."""

        def handle() -> Descriptor:
            parsed = parse_docker_ref(ref)
            client = self.remote.client(ref)
            referrers = client.fetch_referrers(parsed.path, manifest_digest)
            if not referrers:
                raise errdefs.NotFound("empty referrer list")
            # Prefer the first (most recent) referrer manifest; refuse
            # oversized ones before downloading (referrer.go:27,59).
            if referrers[0].size > MAX_MANIFEST_INDEX_SIZE:
                raise errdefs.InvalidArgument("referrer manifest too large")
            body = client.fetch_by_digest(parsed.path, referrers[0].digest)
            if len(body) > MAX_MANIFEST_INDEX_SIZE:
                raise errdefs.InvalidArgument("referrer manifest too large")
            manifest = json.loads(body)
            layers = manifest.get("layers") or []
            if not layers:
                raise errdefs.InvalidArgument("invalid manifest")
            meta_layer = Descriptor.from_json(layers[-1])
            annos = meta_layer.annotations or {}
            if constants.LAYER_ANNOTATION_NYDUS_BOOTSTRAP not in annos:
                raise errdefs.InvalidArgument("invalid nydus manifest")
            return meta_layer

        try:
            return handle()
        except Exception as e:
            if self.remote.retry_with_plain_http(ref, e):
                return handle()
            raise

    def fetch_metadata(self, ref: str, desc: Descriptor, metadata_path: str) -> None:
        """Fetch the metadata layer and unpack ``image/image.boot`` to
        ``metadata_path`` (referrer.go:107-138)."""

        def handle() -> None:
            parsed = parse_docker_ref(ref)
            client = self.remote.client(ref)
            r = client.fetch_blob(parsed.path, desc.digest)
            try:
                data = r.read()
            finally:
                r.close()
            unpack(data, METADATA_NAME_IN_LAYER, metadata_path)

        try:
            handle()
        except Exception as e:
            if self.remote.retry_with_plain_http(ref, e):
                handle()
            else:
                raise


class ReferrerManager:
    """LRU + singleflight front of Referrer (manager.go:21-101)."""

    def __init__(self, insecure: bool = False):
        self.insecure = insecure
        self._cache: OrderedDict[str, Descriptor] = OrderedDict()
        self._mu = threading.Lock()
        self._sg = singleflight.Group()

    def _cache_get(self, key: str) -> Optional[Descriptor]:
        with self._mu:
            desc = self._cache.get(key)
            if desc is not None:
                self._cache.move_to_end(key)
            return desc

    def _cache_put(self, key: str, desc: Descriptor) -> None:
        with self._mu:
            self._cache[key] = desc
            self._cache.move_to_end(key)
            while len(self._cache) > _CACHE_SIZE:
                self._cache.popitem(last=False)

    def check_referrer(self, ref: str, manifest_digest: str) -> Descriptor:
        def lookup() -> Descriptor:
            cached = self._cache_get(manifest_digest)
            if cached is not None:
                return cached
            keychain = authmod.get_keychain_by_ref(ref, {})
            referrer = Referrer(keychain=keychain, insecure=self.insecure)
            desc = referrer.check_referrer(ref, manifest_digest)
            self._cache_put(manifest_digest, desc)
            return desc

        desc, _ = self._sg.do(manifest_digest, lookup)
        return desc

    def try_fetch_metadata(
        self, ref: str, manifest_digest: str, metadata_path: str
    ) -> None:
        """CheckReferrer then pull the bootstrap next to the snapshot
        (manager.go:76-101)."""
        desc = self.check_referrer(ref, manifest_digest)
        keychain = authmod.get_keychain_by_ref(ref, {})
        referrer = Referrer(keychain=keychain, insecure=self.insecure)
        referrer.fetch_metadata(ref, desc, metadata_path)
