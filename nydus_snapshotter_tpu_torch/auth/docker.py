"""Docker config.json credential lookup.

Reference pkg/auth/docker.go:22-50: read `auths` from the default docker
config file, mapping the docker-hub endpoint `registry-1.docker.io` back to
its config key `https://index.docker.io/v1/`.
"""

from __future__ import annotations

import json
import os
from typing import Optional

from nydus_snapshotter_tpu_torch.auth.keychain import PassKeyChain, entry_keychain

DOCKER_HUB_KEY = "https://index.docker.io/v1/"
CONVERTED_DOCKER_HOST = "registry-1.docker.io"


def default_config_path() -> str:
    base = os.environ.get("DOCKER_CONFIG") or os.path.join(os.path.expanduser("~"), ".docker")
    return os.path.join(base, "config.json")


def from_docker_config(host: str, config_path: Optional[str] = None) -> Optional[PassKeyChain]:
    if not host:
        return None
    if host in (CONVERTED_DOCKER_HOST, "docker.io"):
        host = DOCKER_HUB_KEY
    path = config_path or default_config_path()
    try:
        with open(path, "rb") as f:
            cfg = json.load(f)
    except (OSError, ValueError):
        return None
    auths = cfg.get("auths") or {}
    for key, entry in auths.items():
        # Keys may be bare hosts or full URLs; match on the host part.
        key_host = key
        if "://" in key_host:
            key_host = key_host.split("://", 1)[1]
        key_host = key_host.rstrip("/")
        if key == host or key_host == host or key_host.split("/")[0] == host:
            return entry_keychain(entry)
    return None
