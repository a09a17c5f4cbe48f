"""Daemon lifecycle manager + liveness monitoring (reference pkg/manager)."""

from nydus_snapshotter_tpu_torch.manager.monitor import LivenessMonitor, DeathEvent  # noqa: F401
from nydus_snapshotter_tpu_torch.manager.manager import Manager  # noqa: F401
