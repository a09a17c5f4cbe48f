"""Encrypt/decrypt the nydus bootstrap layer (OCI image-encryption shape).

Reference pkg/encryption/encryption.go:28-253 (itself lifted from
containerd/imgcrypt): the bootstrap layer descriptor is rewritten to an
``+encrypted`` media type, the payload is symmetrically encrypted, and the
wrapped symmetric key travels in the ``org.opencontainers.image.enc.keys.
jwe`` annotation — one wrapped copy per recipient public key.

Scheme here: AES-256-GCM for the layer payload; RSA-OAEP(SHA-256) wrapping
of a JSON ``{symkey, nonce}`` bundle per recipient (the ocicrypt JWE role).
Same annotation contract and media-type mapping as the reference, so
manifests round-trip structurally. The PyTorch port's copy of the
reference package's ``encryption/encryption.py``: a layer encrypted by
either package decrypts with the other.
"""

from __future__ import annotations

import base64
import json
import os
import secrets
from typing import Optional

from nydus_snapshotter_tpu_torch.converter.content import BlobInfo, LocalContentStore
from nydus_snapshotter_tpu_torch.remote.registry import Descriptor
from nydus_snapshotter_tpu_torch.utils import errdefs

try:
    from cryptography.hazmat.primitives import hashes, serialization
    from cryptography.hazmat.primitives.asymmetric import padding
    from cryptography.hazmat.primitives.ciphers.aead import AESGCM

    _HAVE_CRYPTO = True
except ImportError:  # pragma: no cover
    _HAVE_CRYPTO = False

# ocicrypt spec media types (encocispec)
MEDIA_TYPE_LAYER_ENC = "application/vnd.oci.image.layer.v1.tar+encrypted"
MEDIA_TYPE_LAYER_GZIP_ENC = "application/vnd.oci.image.layer.v1.tar+gzip+encrypted"
MEDIA_TYPE_LAYER_ZSTD_ENC = "application/vnd.oci.image.layer.v1.tar+zstd+encrypted"

ANNOTATION_ENC_KEYS_JWE = "org.opencontainers.image.enc.keys.jwe"
_ENC_ANNOTATION_PREFIX = "org.opencontainers.image.enc"

_PLAIN_TO_ENC = {
    "application/vnd.docker.image.rootfs.diff.tar.gzip": MEDIA_TYPE_LAYER_GZIP_ENC,
    "application/vnd.docker.image.rootfs.diff.tar": MEDIA_TYPE_LAYER_ENC,
    "application/vnd.oci.image.layer.v1.tar+gzip": MEDIA_TYPE_LAYER_GZIP_ENC,
    "application/vnd.oci.image.layer.v1.tar+zstd": MEDIA_TYPE_LAYER_ZSTD_ENC,
    "application/vnd.oci.image.layer.v1.tar": MEDIA_TYPE_LAYER_ENC,
    # already-encrypted types pass through (encryption.go:64-69)
    MEDIA_TYPE_LAYER_ENC: MEDIA_TYPE_LAYER_ENC,
    MEDIA_TYPE_LAYER_GZIP_ENC: MEDIA_TYPE_LAYER_GZIP_ENC,
    MEDIA_TYPE_LAYER_ZSTD_ENC: MEDIA_TYPE_LAYER_ZSTD_ENC,
}

_ENC_TO_PLAIN = {
    MEDIA_TYPE_LAYER_GZIP_ENC: "application/vnd.docker.image.rootfs.diff.tar.gzip",
    MEDIA_TYPE_LAYER_ZSTD_ENC: "application/vnd.oci.image.layer.v1.tar+zstd",
    MEDIA_TYPE_LAYER_ENC: "application/vnd.docker.image.rootfs.diff.tar",
}


class EncryptionError(errdefs.NydusError):
    pass


def _require_crypto() -> None:
    if not _HAVE_CRYPTO:
        raise errdefs.Unavailable("cryptography module unavailable")


def filter_out_annotations(annotations: Optional[dict]) -> dict:
    """Drop org.opencontainers.image.enc.* (ocicrypt FilterOutAnnotations)."""
    return {
        k: v
        for k, v in (annotations or {}).items()
        if not k.startswith(_ENC_ANNOTATION_PREFIX)
    }


def _wrap_key(recipient_pem: bytes, bundle: bytes) -> str:
    key = serialization.load_pem_public_key(recipient_pem)
    wrapped = key.encrypt(
        bundle,
        padding.OAEP(
            mgf=padding.MGF1(algorithm=hashes.SHA256()),
            algorithm=hashes.SHA256(),
            label=None,
        ),
    )
    return base64.b64encode(wrapped).decode()


def _unwrap_key(private_pem: bytes, wrapped_b64: str) -> Optional[bytes]:
    key = serialization.load_pem_private_key(private_pem, password=None)
    try:
        return key.decrypt(
            base64.b64decode(wrapped_b64),
            padding.OAEP(
                mgf=padding.MGF1(algorithm=hashes.SHA256()),
                algorithm=hashes.SHA256(),
                label=None,
            ),
        )
    except ValueError:
        return None


def encrypt_layer(
    data: bytes, desc: Descriptor, recipients: list[bytes]
) -> tuple[Descriptor, bytes]:
    """(new_desc, ciphertext) — media type remapped, wrapped keys in
    annotations (encryptLayer, encryption.go:28-86)."""
    _require_crypto()
    if not recipients:
        raise EncryptionError("no encryption recipients")
    new_media = _PLAIN_TO_ENC.get(desc.media_type)
    if new_media is None:
        raise EncryptionError(f"unsupported layer MediaType: {desc.media_type}")

    symkey = AESGCM.generate_key(256)
    nonce = secrets.token_bytes(12)
    ciphertext = AESGCM(symkey).encrypt(nonce, data, None)

    bundle = json.dumps(
        {
            "symkey": base64.b64encode(symkey).decode(),
            "nonce": base64.b64encode(nonce).decode(),
            "cipher": "AES_256_GCM",
        }
    ).encode()
    wrapped = ",".join(_wrap_key(pem, bundle) for pem in recipients)

    import hashlib

    annotations = filter_out_annotations(desc.annotations)
    annotations[ANNOTATION_ENC_KEYS_JWE] = wrapped
    new_desc = Descriptor(
        media_type=new_media,
        digest="sha256:" + hashlib.sha256(ciphertext).hexdigest(),
        size=len(ciphertext),
        annotations=annotations,
        platform=desc.platform,
    )
    return new_desc, ciphertext


def decrypt_layer(
    data: bytes, desc: Descriptor, keys: list[bytes], unwrap_only: bool = False
) -> tuple[Optional[Descriptor], Optional[bytes]]:
    """Inverse of encrypt_layer (decryptLayer, encryption.go:90-117).
    With ``unwrap_only`` the key is unwrapped (proving access) but the
    payload stays encrypted — (None, None) is returned on success."""
    _require_crypto()
    plain_media = _ENC_TO_PLAIN.get(desc.media_type)
    if plain_media is None:
        raise EncryptionError(f"unsupported layer MediaType: {desc.media_type}")
    wrapped = (desc.annotations or {}).get(ANNOTATION_ENC_KEYS_JWE, "")
    if not wrapped:
        raise EncryptionError("missing wrapped key annotation")

    bundle = None
    for candidate in wrapped.split(","):
        for pem in keys:
            bundle = _unwrap_key(pem, candidate)
            if bundle is not None:
                break
        if bundle is not None:
            break
    if bundle is None:
        raise EncryptionError("no private key could unwrap the layer key")
    if unwrap_only:
        return None, None

    params = json.loads(bundle)
    symkey = base64.b64decode(params["symkey"])
    nonce = base64.b64decode(params["nonce"])
    try:
        plaintext = AESGCM(symkey).decrypt(nonce, data, None)
    except Exception as e:
        raise EncryptionError(f"bootstrap layer decryption failed: {e}") from e

    import hashlib

    new_desc = Descriptor(
        media_type=plain_media,
        digest="sha256:" + hashlib.sha256(plaintext).hexdigest(),
        size=len(plaintext),
        annotations=filter_out_annotations(desc.annotations),
        platform=desc.platform,
    )
    return new_desc, plaintext


def encrypt_nydus_bootstrap(
    cs: LocalContentStore, desc: Descriptor, recipients: list[bytes]
) -> Descriptor:
    """EncryptNydusBootstrap (encryption.go:143-202): read the bootstrap
    layer from the content store, store the encrypted copy, return the
    rewritten descriptor."""
    data = cs.read(desc.digest)
    new_desc, ciphertext = encrypt_layer(data, desc, recipients)
    cs.write_blob(ciphertext, expected_digest=new_desc.digest)
    return new_desc


def decrypt_nydus_bootstrap(
    cs: LocalContentStore,
    desc: Descriptor,
    keys: list[bytes],
    unwrap_only: bool = False,
) -> Optional[Descriptor]:
    """DeryptNydusBootstrap (encryption.go:206-253)."""
    data = cs.read(desc.digest)
    new_desc, plaintext = decrypt_layer(data, desc, keys, unwrap_only)
    if unwrap_only or new_desc is None:
        return None
    cs.write_blob(plaintext, expected_digest=new_desc.digest)
    return new_desc
