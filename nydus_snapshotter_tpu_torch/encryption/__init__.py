"""OCI layer encryption for nydus bootstraps (reference pkg/encryption)."""

from nydus_snapshotter_tpu_torch.encryption.encryption import (
    ANNOTATION_ENC_KEYS_JWE,
    MEDIA_TYPE_LAYER_ENC,
    MEDIA_TYPE_LAYER_GZIP_ENC,
    MEDIA_TYPE_LAYER_ZSTD_ENC,
    decrypt_layer,
    decrypt_nydus_bootstrap,
    encrypt_layer,
    encrypt_nydus_bootstrap,
    filter_out_annotations,
)

__all__ = [
    "ANNOTATION_ENC_KEYS_JWE",
    "MEDIA_TYPE_LAYER_ENC",
    "MEDIA_TYPE_LAYER_GZIP_ENC",
    "MEDIA_TYPE_LAYER_ZSTD_ENC",
    "decrypt_layer",
    "decrypt_nydus_bootstrap",
    "encrypt_layer",
    "encrypt_nydus_bootstrap",
    "filter_out_annotations",
]
