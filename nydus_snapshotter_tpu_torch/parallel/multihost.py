"""Multi-host batch coordination: membership and a barrier, nothing more.

Port of the reference's parallel/multihost.py. The reference scales
conversion by running independent converters against the shared registry
(the storage boundary); there is no inter-converter state. Hosts
coordinate *membership* through ``torch.distributed`` (a gloo process
group, where the reference uses ``jax.distributed``), partition the image
list deterministically, and convert their slice against their own growing
dict (converter/batch.py): the registry/blob store remains the merge
point, so no conversion state crosses hosts. The device mesh inside each
host (parallel/mesh.py) is single-process; the process group carries only
control.

The rendezvous reads the reference's launcher contract unchanged: the
``JAX_COORDINATOR_ADDRESS`` (``host:port``), ``JAX_PROCESS_ID`` and
``JAX_NUM_PROCESSES`` environment variables, so one launcher drives a
fleet of either package.

Everything here is usable without a cluster: ``runtime()`` degrades to a
single-process view when no coordinator is configured, which is how the
unit tests drive the partition logic.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from datetime import timedelta
from typing import Optional, Sequence


@dataclass(frozen=True)
class HostRuntime:
    """This process's place in the batch-conversion fleet."""

    index: int
    count: int

    def shard(self, items: Sequence) -> list:
        """Deterministic strided partition of ``items`` for this host.

        Strided (not contiguous) so differently-sized images spread evenly;
        stable for a fixed item order, which callers provide by sorting —
        every host computes the same global assignment with no exchange.
        """
        return list(items[self.index :: self.count])

    def barrier(self, name: str) -> None:
        """Fleet-wide sync point (no-op single-host).

        The one control primitive batch pipelines need beyond membership:
        phase handoffs like "every host finished building the shared dict
        artifact" before dependents load it from the storage boundary.
        ``name`` labels the handoff for readers; a process group's barriers
        match by order.
        """
        if self.count > 1:
            import torch.distributed as dist

            dist.barrier()


def runtime(
    coordinator: Optional[str] = None,
    process_id: Optional[int] = None,
    num_processes: Optional[int] = None,
    init_timeout_s: Optional[int] = None,
) -> HostRuntime:
    """Resolve this host's (index, count), joining a gloo process group at
    ``tcp://<coordinator>`` when a coordinator is configured (args or
    JAX_COORDINATOR_ADDRESS / JAX_PROCESS_ID / JAX_NUM_PROCESSES env),
    else a single-host view. ``init_timeout_s`` bounds the join.
    """
    coordinator = coordinator or os.environ.get("JAX_COORDINATOR_ADDRESS")
    if coordinator:
        import torch.distributed as dist

        pid = process_id if process_id is not None else int(os.environ.get("JAX_PROCESS_ID", "0"))
        n = num_processes if num_processes is not None else int(os.environ.get("JAX_NUM_PROCESSES", "1"))
        # Only re-entry into the group this process already joined is
        # benign. A genuine join failure (coordinator unreachable, id
        # clash) raises and must NOT degrade to a (0, 1) singleton: that
        # host would silently re-convert the whole image list and break
        # the deterministic partition.
        if not dist.is_initialized():
            kwargs = {}
            if init_timeout_s is not None:
                kwargs["timeout"] = timedelta(seconds=init_timeout_s)
            dist.init_process_group(
                "gloo", init_method=f"tcp://{coordinator}", rank=pid, world_size=n, **kwargs
            )
        return HostRuntime(index=dist.get_rank(), count=dist.get_world_size())
    if process_id is not None and num_processes is not None:
        return HostRuntime(index=process_id, count=num_processes)
    return HostRuntime(index=0, count=1)
