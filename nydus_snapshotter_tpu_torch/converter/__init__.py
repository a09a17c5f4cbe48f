"""Conversion surface: ``pack_layer`` with the reference's option model."""

from nydus_snapshotter_tpu_torch.converter.pack import PackResult, pack_layer  # noqa: F401
from nydus_snapshotter_tpu_torch.converter.types import ConvertError, PackOption  # noqa: F401
