"""Conversion surface: ``Pack``/``Merge``/``Unpack`` and ``pack_layer`` with the
reference's option model (convert_unix.go:325,560,669; types.go:58-145)."""

from nydus_snapshotter_tpu_torch.converter.convert import (  # noqa: F401
    Merge,
    MergeResult,
    Unpack,
)
from nydus_snapshotter_tpu_torch.converter.pack import (  # noqa: F401
    IncrementalChunker,
    Pack,
    PackResult,
    pack_layer,
)
from nydus_snapshotter_tpu_torch.converter.types import (  # noqa: F401
    ConvertError,
    MergeOption,
    PackOption,
    UnpackOption,
)
