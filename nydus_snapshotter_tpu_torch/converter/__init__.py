"""Conversion surface: ``Pack``/``Merge``/``Unpack`` and ``pack_layer`` with the
reference's option model (convert_unix.go:325,560,669; types.go:58-145)."""

from nydus_snapshotter_tpu_torch.converter.convert import (  # noqa: F401
    Merge,
    MergeResult,
    Unpack,
)
from nydus_snapshotter_tpu_torch.converter.types import (  # noqa: F401
    ConvertError,
    MergeOption,
    PackOption,
    UnpackOption,
)

# The layer lanes import torch; they load on first use, so a reader of
# packed images (the daemon) starts without it.
_PACK_EXPORTS = ("IncrementalChunker", "Pack", "PackResult", "pack_layer")


def __getattr__(name: str):
    if name in _PACK_EXPORTS:
        from nydus_snapshotter_tpu_torch.converter import pack

        return getattr(pack, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
