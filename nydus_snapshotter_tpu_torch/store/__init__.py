"""Persistence for daemon + RAFS instance states (reference pkg/store)."""

from nydus_snapshotter_tpu_torch.store.database import Database, StoreError  # noqa: F401
