"""eStargz lazy-pull support (reference pkg/stargz +
pkg/filesystem/stargz_adaptor.go)."""

from nydus_snapshotter_tpu_torch.stargz.adaptor import StargzAdaptor
from nydus_snapshotter_tpu_torch.stargz.index import (
    DEFAULT_CHUNK_SIZE,
    TocEntry,
    bootstrap_from_toc,
    parse_toc,
)
from nydus_snapshotter_tpu_torch.stargz.resolver import (
    ESTARGZ_FOOTER_SIZE,
    FOOTER_SIZE,
    TOC_FILENAME,
    Blob,
    Resolver,
    StargzError,
    parse_footer,
)

__all__ = [
    "Blob",
    "DEFAULT_CHUNK_SIZE",
    "ESTARGZ_FOOTER_SIZE",
    "FOOTER_SIZE",
    "Resolver",
    "StargzAdaptor",
    "StargzError",
    "TOC_FILENAME",
    "TocEntry",
    "bootstrap_from_toc",
    "parse_footer",
    "parse_toc",
]
