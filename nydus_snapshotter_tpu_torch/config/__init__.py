"""Layered configuration: defaults ← TOML ← CLI, validated then frozen."""

from nydus_snapshotter_tpu_torch.config.config import (  # noqa: F401
    SnapshotterConfig,
    ConfigError,
    load_config,
    set_global_config,
    get_global_config,
    global_section,
)
