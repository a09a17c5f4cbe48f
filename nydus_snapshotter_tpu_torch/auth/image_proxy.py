"""CRI image-proxy credential capture.

Reference pkg/auth/image_proxy.go:52-130 proxies containerd's CRI
ImageService over a UDS and records the auth carried by each PullImage
request, so later snapshot mounts can reuse the kubelet-supplied
credentials. This package keeps the same capture surface as an
in-process store fed by the gRPC layer (the CRI wire hookup lives in
cmd/snapshotter when an image service address is configured); lookup
semantics mirror the reference: most-recent credential whose image ref
matches the requested ref/host wins.
"""

from __future__ import annotations

import threading
from typing import Optional

from nydus_snapshotter_tpu_torch.auth.keychain import PassKeyChain
from nydus_snapshotter_tpu_torch.remote.reference import parse_docker_ref

_lock = threading.Lock()
# ref -> keychain, insertion-ordered; newest matching entry wins.
_captured: dict[str, PassKeyChain] = {}
_MAX_ENTRIES = 512


def capture(ref: str, keychain: PassKeyChain) -> None:
    """Record credentials observed on a PullImage request."""
    with _lock:
        _captured.pop(ref, None)
        _captured[ref] = keychain
        while len(_captured) > _MAX_ENTRIES:
            _captured.pop(next(iter(_captured)))


def from_cri(host: str, ref: str) -> Optional[PassKeyChain]:
    """Credential for ref (exact match first, then same-registry match)."""
    with _lock:
        kc = _captured.get(ref)
        if kc is not None:
            return kc
        for seen_ref, kc in reversed(list(_captured.items())):
            try:
                if parse_docker_ref(seen_ref).domain == host:
                    return kc
            except ValueError:
                continue
    return None


def reset() -> None:
    with _lock:
        _captured.clear()
