"""Re-export shim for embedding the snapshotter in other programs
(reference export/snapshotter/snapshotter.go)."""

from nydus_snapshotter_tpu_torch.cmd.snapshotter import build_stack
from nydus_snapshotter_tpu_torch.config.config import SnapshotterConfig, load_config
from nydus_snapshotter_tpu_torch.snapshot.snapshotter import Snapshotter

__all__ = ["SnapshotterConfig", "Snapshotter", "build_stack", "load_config"]
