"""Tarfs mode: plain-tar layers indexed in place (reference pkg/tarfs).

The tar-tarfs bootstrap builder and the dm-verity tree. The manager that
attaches, mounts and exports tarfs layers (the reference's
``tarfs/tarfs.py``) needs the registry client, loop devices and mounts,
which the port does not have yet.
"""

from nydus_snapshotter_tpu_torch.tarfs.bootstrap import (
    DEFAULT_CHUNK_SIZE,
    tarfs_bootstrap_from_tar,
)
from nydus_snapshotter_tpu_torch.tarfs.verity import (
    VerityInfo,
    build_tree,
    parse_block_info_label,
    verify,
)

__all__ = [
    "DEFAULT_CHUNK_SIZE",
    "VerityInfo",
    "build_tree",
    "parse_block_info_label",
    "tarfs_bootstrap_from_tar",
    "verify",
]
