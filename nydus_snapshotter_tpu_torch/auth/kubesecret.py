"""Kubernetes dockerconfigjson secret store.

Reference pkg/auth/kubesecret.go:33-175 runs a client-go informer over
`kubernetes.io/dockerconfigjson` secrets and indexes their auth entries by
registry host. No kubernetes API client is baked into this environment, so
this package watches a secrets *directory* (the standard
projected-secret mount shape: one file per secret containing a
.dockerconfigjson document) and keeps the same host-indexed lookup; the
in-memory feed path (`add_dockerconfigjson`) is what an informer would
call on Add/Update events.
"""

from __future__ import annotations

import json
import os
import threading
from typing import Optional

from nydus_snapshotter_tpu_torch.auth.keychain import PassKeyChain, entry_keychain

_lock = threading.Lock()
_by_host: dict[str, PassKeyChain] = {}


def add_dockerconfigjson(doc: bytes | str) -> None:
    """Index one .dockerconfigjson document (informer Add/Update path)."""
    if isinstance(doc, (bytes, bytearray)):
        doc = doc.decode()
    try:
        cfg = json.loads(doc)
    except ValueError:
        return
    with _lock:
        for key, entry in (cfg.get("auths") or {}).items():
            host = key.split("://", 1)[-1].rstrip("/").split("/")[0]
            kc = entry_keychain(entry)
            if kc is not None:
                _by_host[host] = kc


def load_secrets_dir(path: str) -> int:
    """Scan a projected-secrets directory; returns entries indexed."""
    count = 0
    try:
        names = os.listdir(path)
    except OSError:
        return 0
    for name in names:
        full = os.path.join(path, name)
        if not os.path.isfile(full):
            continue
        try:
            with open(full, "rb") as f:
                add_dockerconfigjson(f.read())
                count += 1
        except OSError:
            continue
    return count


def from_kube_secret(host: str) -> Optional[PassKeyChain]:
    if host == "docker.io":
        host = "index.docker.io"
    with _lock:
        return _by_host.get(host)


def reset() -> None:
    with _lock:
        _by_host.clear()
