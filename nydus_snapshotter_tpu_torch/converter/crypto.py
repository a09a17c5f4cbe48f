"""Blob data encryption: seekable AES-256-CTR over the blob address space.

The reference's ``--encrypt`` makes the builder encrypt blob data, with the
cipher context stored in the image metadata (the bootstrap), while key
protection comes from separately encrypting the bootstrap *layer* with
ocicrypt (pkg/encryption/encryption.go:143-253, in encryption/encryption.py).
This module is the blob half: chunks are laid out first, then the whole
data section is transformed with AES-256-CTR keyed per blob. CTR is
length-preserving (chunk extents are unchanged) and seekable (counter =
byte_offset // 16), so a reader can decrypt one chunk without touching the
rest of the blob.

The PyTorch port's copy of the reference package's ``converter/crypto.py``:
the same key, IV and counter layout, so each package decrypts the other's
blobs. The cipher is the ``cryptography`` package's AES, on the host.
"""

from __future__ import annotations

import os

try:  # optional: only the --encrypt feature needs a cipher backend
    from cryptography.hazmat.primitives.ciphers import Cipher, algorithms, modes

    _HAVE_CRYPTOGRAPHY = True
except ModuleNotFoundError:  # gate, don't break converter imports
    _HAVE_CRYPTOGRAPHY = False

CIPHER_NONE = 0
CIPHER_AES_256_CTR = 1

KEY_LEN = 32
IV_LEN = 16


class CryptoError(ValueError):
    pass


def generate_context() -> tuple[bytes, bytes]:
    """Fresh (key, iv) for one blob."""
    return os.urandom(KEY_LEN), os.urandom(IV_LEN)


def _ctr_at(key: bytes, iv: bytes, block_index: int):
    """CTR cipher positioned at 16-byte block ``block_index`` of the stream."""
    if not _HAVE_CRYPTOGRAPHY:
        raise CryptoError("blob encryption needs the 'cryptography' package")
    if len(key) != KEY_LEN or len(iv) != IV_LEN:
        raise CryptoError("AES-256-CTR needs a 32-byte key and 16-byte IV")
    counter = (int.from_bytes(iv, "big") + block_index) % (1 << 128)
    return Cipher(algorithms.AES(key), modes.CTR(counter.to_bytes(16, "big")))


def encrypt(data: bytes, key: bytes, iv: bytes) -> bytes:
    """Encrypt a whole blob data section (offset 0)."""
    enc = _ctr_at(key, iv, 0).encryptor()
    return enc.update(data) + enc.finalize()


def stream_encryptor(key: bytes, iv: bytes):
    """Incremental encryptor positioned at offset 0 — feed section bytes in
    order via .update(); byte-identical to ``encrypt`` over the whole
    section, and the single definition the seekable ``decrypt_range``
    counter layout is guaranteed against."""
    return _ctr_at(key, iv, 0).encryptor()


def decrypt_range(data: bytes, offset: int, key: bytes, iv: bytes) -> bytes:
    """Decrypt ``data`` that was taken from absolute blob ``offset``.

    Seeks the keystream to the enclosing 16-byte block and drops the
    intra-block prefix — the random-access read path.
    """
    dec = _ctr_at(key, iv, offset // 16).decryptor()
    skip = offset % 16
    out = dec.update(bytes(skip) + data) + dec.finalize()
    return out[skip:]
