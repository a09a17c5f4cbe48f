"""Verify RSA signatures of bootstraps carried in snapshot labels.

Reference pkg/signature/signature.go:20-84: the signature arrives
base64-encoded under the label ``containerd.io/snapshot/nydus-signature``;
``validate_signature`` (force mode) makes a missing signature an error.
"""

from __future__ import annotations

import base64
import binascii
import os
from typing import Mapping, Optional

from nydus_snapshotter_tpu_torch import constants
from nydus_snapshotter_tpu_torch.utils import errdefs
from nydus_snapshotter_tpu_torch.utils.signer import SignatureError, Signer


class Verifier:
    def __init__(self, public_key_file: str = "", validate_signature: bool = False):
        self.force = validate_signature
        self.signer: Optional[Signer] = None
        if not validate_signature:
            return
        if not public_key_file:
            raise errdefs.InvalidArgument("publicKeyFile is required")
        if not os.path.exists(public_key_file):
            raise errdefs.NotFound(f"failed to find publicKeyFile {public_key_file!r}")
        with open(public_key_file, "rb") as f:
            self.signer = Signer(f.read())

    def verify(self, labels: Mapping[str, str], bootstrap_file: str) -> None:
        signature = _from_label(labels)
        if signature is None:
            if self.force:
                raise SignatureError(
                    "bootstrap signature is required when force validation"
                )
            return
        if self.signer is None:
            return
        with open(bootstrap_file, "rb") as f:
            self.signer.verify(f, signature)


def _from_label(labels: Mapping[str, str]) -> Optional[bytes]:
    value = labels.get(constants.NYDUS_SIGNATURE)
    if value is None:
        return None
    try:
        return base64.standard_b64decode(value)
    except (binascii.Error, ValueError) as e:
        raise SignatureError(f"bad base64 in signature label: {e}") from e
