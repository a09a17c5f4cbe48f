"""Bootstrap signature verification (reference pkg/signature)."""

from nydus_snapshotter_tpu_torch.signature.signature import Verifier

__all__ = ["Verifier"]
