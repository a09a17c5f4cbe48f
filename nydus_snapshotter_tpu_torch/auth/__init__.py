"""Registry credential chain (reference pkg/auth).

Order of precedence (keychain.go:85-105): snapshot labels -> CRI
image-proxy captured creds -> docker config file -> kubernetes
dockerconfigjson secrets.
"""

from nydus_snapshotter_tpu_torch.auth.keychain import (
    PassKeyChain,
    from_base64,
    from_labels,
    get_keychain_by_ref,
    get_registry_keychain,
)

__all__ = [
    "PassKeyChain",
    "from_base64",
    "from_labels",
    "get_keychain_by_ref",
    "get_registry_keychain",
]
