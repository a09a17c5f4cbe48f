"""User/password keychain + the layered credential lookup.

Reference pkg/auth/keychain.go:30-140.
"""

from __future__ import annotations

import base64
from dataclasses import dataclass
from typing import Mapping, Optional

from nydus_snapshotter_tpu_torch import constants as C
from nydus_snapshotter_tpu_torch.remote.reference import parse_docker_ref


@dataclass(frozen=True)
class PassKeyChain:
    username: str = ""
    password: str = ""

    def empty(self) -> bool:
        return not self.username and not self.password

    def token_base(self) -> bool:
        """Token-based when only a password (= registry token) is present
        (keychain.go:57-60)."""
        return self.username == "" and self.password != ""

    def to_base64(self) -> str:
        if self.empty():
            return ""
        return base64.b64encode(f"{self.username}:{self.password}".encode()).decode()


def from_base64(value: str) -> PassKeyChain:
    decoded = base64.b64decode(value).decode()
    user, sep, password = decoded.partition(":")
    # partition, not split: GCR-style passwords (JSON service-account keys)
    # legitimately contain colons.
    if not sep:
        raise ValueError("invalid registry auth token")
    return PassKeyChain(user, password)


def entry_keychain(entry: Mapping) -> Optional[PassKeyChain]:
    """Decode one dockerconfig ``auths`` entry (base64 ``auth`` field with
    username/password fallback); shared by the docker-config and
    kube-secret lookups."""
    auth_b64 = entry.get("auth", "")
    if auth_b64:
        try:
            kc = from_base64(auth_b64)
        except Exception:
            kc = None
        if kc is not None and kc.username and kc.password:
            return kc
    user, pw = entry.get("username", ""), entry.get("password", "")
    if user and pw:
        return PassKeyChain(user, pw)
    return None


def from_labels(labels: Mapping[str, str]) -> Optional[PassKeyChain]:
    """Image pull username/secret from snapshot labels
    (keychain.go:63-80); None means nothing usable was passed."""
    username = labels.get(C.NYDUS_IMAGE_PULL_USERNAME, "")
    secret = labels.get(C.NYDUS_IMAGE_PULL_SECRET, "")
    if not username or not secret:
        return None
    return PassKeyChain(username, secret)


def get_registry_keychain(host: str, ref: str, labels: Mapping[str, str]) -> Optional[PassKeyChain]:
    """Ordered lookup: labels, CRI proxy captures, docker config, k8s
    secret store (keychain.go:85-105)."""
    from nydus_snapshotter_tpu_torch.auth import docker as docker_cfg
    from nydus_snapshotter_tpu_torch.auth import image_proxy, kubesecret

    kc = from_labels(labels)
    if kc is not None:
        return kc
    kc = image_proxy.from_cri(host, ref)
    if kc is not None:
        return kc
    kc = docker_cfg.from_docker_config(host)
    if kc is not None:
        return kc
    return kubesecret.from_kube_secret(host)


def get_keychain_by_ref(ref: str, labels: Mapping[str, str]) -> Optional[PassKeyChain]:
    parsed = parse_docker_ref(ref)
    return get_registry_keychain(parsed.domain, ref, labels)
