"""Snapshot label predicates (reference pkg/label/label.go:17-88).

All key strings live in :mod:`nydus_snapshotter_tpu_torch.constants` so converter
annotations and snapshot labels share one vocabulary; this module adds the
predicates the processor routing (snapshot/process.go) keys off.
"""

from __future__ import annotations

from typing import Mapping

from nydus_snapshotter_tpu_torch import constants as C


def is_nydus_data_layer(labels: Mapping[str, str]) -> bool:
    return C.NYDUS_DATA_LAYER in labels


def is_nydus_meta_layer(labels: Mapping[str, str]) -> bool:
    return C.NYDUS_META_LAYER in labels


def is_tarfs_data_layer(labels: Mapping[str, str]) -> bool:
    return C.NYDUS_TARFS_LAYER in labels


def is_nydus_proxy_mode(labels: Mapping[str, str]) -> bool:
    return C.NYDUS_PROXY_MODE in labels


def has_tarfs_hint(labels: Mapping[str, str]) -> bool:
    return C.TARFS_HINT in labels


def is_stargz_layer(labels: Mapping[str, str]) -> bool:
    return C.STARGZ_LAYER in labels


def is_soci_layer(labels: Mapping[str, str]) -> bool:
    return C.SOCI_LAYER in labels


def is_volatile(labels: Mapping[str, str]) -> bool:
    return C.OVERLAYFS_VOLATILE_OPT in labels
