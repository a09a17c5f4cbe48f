"""Tarfs mode: plain-tar layers indexed in place and served as
EROFS-over-loop block devices (reference pkg/tarfs)."""

from nydus_snapshotter_tpu_torch.tarfs.bootstrap import (
    DEFAULT_CHUNK_SIZE,
    tarfs_bootstrap_from_tar,
)
from nydus_snapshotter_tpu_torch.tarfs.tarfs import (
    IMAGE_BOOTSTRAP_NAME,
    IMAGE_DISK_NAME,
    LAYER_BOOTSTRAP_NAME,
    LAYER_DISK_NAME,
    TARFS_STATUS_FAILED,
    TARFS_STATUS_INIT,
    TARFS_STATUS_PREPARE,
    TARFS_STATUS_READY,
    ExportFlags,
    Manager,
)
from nydus_snapshotter_tpu_torch.tarfs.verity import (
    VerityInfo,
    build_tree,
    parse_block_info_label,
    verify,
)

__all__ = [
    "DEFAULT_CHUNK_SIZE",
    "ExportFlags",
    "IMAGE_BOOTSTRAP_NAME",
    "IMAGE_DISK_NAME",
    "LAYER_BOOTSTRAP_NAME",
    "LAYER_DISK_NAME",
    "Manager",
    "TARFS_STATUS_FAILED",
    "TARFS_STATUS_INIT",
    "TARFS_STATUS_PREPARE",
    "TARFS_STATUS_READY",
    "VerityInfo",
    "build_tree",
    "parse_block_info_label",
    "tarfs_bootstrap_from_tar",
    "verify",
]
