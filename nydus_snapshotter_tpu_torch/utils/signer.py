"""RSA-PKCS1v15-SHA256 sign/verify (reference pkg/utils/signer/signer.go).

The reference verifies bootstrap signatures with an RSA public key in PKCS#1
PEM form; ``Signer.verify`` mirrors signer.go:33-40. A ``sign`` helper (used
by tooling/tests to produce label values) accepts the matching private key.
"""

from __future__ import annotations

import hashlib
from typing import BinaryIO, Union

from nydus_snapshotter_tpu_torch.utils import errdefs

try:
    from cryptography.exceptions import InvalidSignature
    from cryptography.hazmat.primitives import hashes, serialization
    from cryptography.hazmat.primitives.asymmetric import padding, rsa
    from cryptography.hazmat.primitives.asymmetric.utils import Prehashed

    _HAVE_CRYPTO = True
except ImportError:  # pragma: no cover - cryptography is in the image
    _HAVE_CRYPTO = False


class SignatureError(errdefs.NydusError):
    pass


def _read_all(data: Union[bytes, BinaryIO]) -> bytes:
    return data if isinstance(data, (bytes, bytearray)) else data.read()


class Signer:
    def __init__(self, public_key_pem: bytes):
        if not _HAVE_CRYPTO:
            raise errdefs.Unavailable("cryptography module unavailable")
        try:
            key = serialization.load_pem_public_key(public_key_pem)
        except ValueError as e:
            raise SignatureError(f"cannot parse public key: {e}") from e
        if not isinstance(key, rsa.RSAPublicKey):
            raise SignatureError("bootstrap signing requires an RSA public key")
        self.public_key = key

    def verify(self, data: Union[bytes, BinaryIO], signature: bytes) -> None:
        """Raise SignatureError unless ``signature`` is a valid
        PKCS1v15-SHA256 signature over ``data`` (signer.go:33-40)."""
        digest = hashlib.sha256(_read_all(data)).digest()
        try:
            self.public_key.verify(
                signature, digest, padding.PKCS1v15(), Prehashed(hashes.SHA256())
            )
        except InvalidSignature as e:
            raise SignatureError("bootstrap signature mismatch") from e


def sign(private_key_pem: bytes, data: Union[bytes, BinaryIO]) -> bytes:
    """Produce the signature ``Signer.verify`` accepts."""
    if not _HAVE_CRYPTO:
        raise errdefs.Unavailable("cryptography module unavailable")
    key = serialization.load_pem_private_key(private_key_pem, password=None)
    digest = hashlib.sha256(_read_all(data)).digest()
    return key.sign(digest, padding.PKCS1v15(), Prehashed(hashes.SHA256()))


def generate_keypair(bits: int = 2048) -> tuple[bytes, bytes]:
    """(private_pem, public_pem) — test/tooling helper."""
    if not _HAVE_CRYPTO:
        raise errdefs.Unavailable("cryptography module unavailable")
    key = rsa.generate_private_key(public_exponent=65537, key_size=bits)
    priv = key.private_bytes(
        serialization.Encoding.PEM,
        serialization.PrivateFormat.TraditionalOpenSSL,
        serialization.NoEncryption(),
    )
    pub = key.public_key().public_bytes(
        serialization.Encoding.PEM,
        serialization.PublicFormat.SubjectPublicKeyInfo,
    )
    return priv, pub
