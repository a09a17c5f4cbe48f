"""OCI referrers-API detection of companion nydus images
(reference pkg/referrer)."""

from nydus_snapshotter_tpu_torch.referrer.referrer import (
    METADATA_NAME_IN_LAYER,
    Referrer,
    ReferrerManager,
)

__all__ = ["METADATA_NAME_IN_LAYER", "Referrer", "ReferrerManager"]
