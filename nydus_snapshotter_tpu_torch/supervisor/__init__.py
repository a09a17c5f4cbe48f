"""Failover state keeper (reference pkg/supervisor)."""

from nydus_snapshotter_tpu_torch.supervisor.supervisor import (  # noqa: F401
    Supervisor,
    SupervisorSet,
)
