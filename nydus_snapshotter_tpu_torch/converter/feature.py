"""Engine feature detection (reference pkg/converter/tool/feature.go).

The reference probes the external ``nydus-image`` binary once by parsing
``create -h`` output (feature.go:116-146) and gates tar-rafs / batch-size /
encrypt paths on the result. Here the "builder" is the in-process engine,
so detection inspects the installed engine + environment instead — but the
same Feature surface and one-shot caching semantics are kept so converter
call-sites stay shaped like the reference.

``DEVICE_DIGEST`` says whether the device lanes can run on the device asked
for: a CUDA card (the default), or the CPU when the caller asks for
``"cpu"``, where the kernels' plain versions run.
"""

from __future__ import annotations

import threading
from enum import Enum
from typing import Optional

from nydus_snapshotter_tpu_torch.tensors import resolve_device


class Feature(str, Enum):
    TAR_RAFS = "--type tar-rafs"  # feature.go:25-38
    BATCH_SIZE = "--batch-size"
    ENCRYPT = "--encrypt"
    CDC_CHUNKING = "--chunking cdc"  # accel-only: content-defined chunking
    DEVICE_DIGEST = "--digest-device"  # batched SHA-256 on device


class Features:
    def __init__(self, features: set[Feature]):
        self._features = features

    def contains(self, feature: Feature) -> bool:
        return feature in self._features

    def __iter__(self):
        return iter(self._features)


_lock = threading.Lock()
_detected: dict[Optional[str], Features] = {}


def detect_features(force: bool = False, device=None) -> Features:
    """One-shot probe per device asked for, cached like
    tool.DetectFeatures (feature.go:116). ``device`` None means the card."""
    key = None if device is None else str(device)
    with _lock:
        if key in _detected and not force:
            return _detected[key]
        feats = {Feature.TAR_RAFS, Feature.CDC_CHUNKING}
        try:
            resolve_device(device)
            feats.add(Feature.DEVICE_DIGEST)
        except RuntimeError:  # no CUDA and no "cpu" asked for: host digests only
            pass
        try:
            from cryptography.hazmat.primitives.ciphers.aead import AESGCM  # noqa: F401

            feats.add(Feature.ENCRYPT)
        except ImportError:
            pass
        # batch (chunk-merging) packing is not implemented yet — mirrors a
        # builder without --batch-size support
        _detected[key] = Features(feats)
        return _detected[key]
