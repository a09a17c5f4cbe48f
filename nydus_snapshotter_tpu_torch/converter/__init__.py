"""Conversion surface: ``Pack`` and ``pack_layer`` with the reference's option model."""

from nydus_snapshotter_tpu_torch.converter.pack import (  # noqa: F401
    IncrementalChunker,
    Pack,
    PackResult,
    pack_layer,
)
from nydus_snapshotter_tpu_torch.converter.types import ConvertError, PackOption  # noqa: F401
