"""Dict-shard HA plane: placement, journal-streaming replication and
automatic replica promotion, as the reference package's ``ha/`` has them.

- :mod:`ha.placement`: a placement controller assigns each shard a
  primary and R replicas across the live ``dict`` members (rendezvous
  placement, sticky primaries), publishes the map with an epoch and
  pushes role assignments to the members' ``/api/v1/ha`` surface.
- :mod:`ha.replicate`: each replica tails its primary's ``since`` journal
  (epoch probe, count only) and pulls the append-only record tail in
  byte-budgeted slices (``replication_budget_kib``), applying the rows
  verbatim at the primary's table positions
  (``ServiceDict.apply_replica_tail``), where they grow the replica's
  probe index: every probe RPC on a replica, as on a primary, is one
  launch of kernel K3 on the service's device. A replica whose primary
  regressed resyncs from a full snapshot, loudly.
- automatic promotion: when a primary goes stale, dead or is reported
  down, the controller promotes the most-caught-up live replica and bumps
  the placement epoch. ``ServiceChunkDict`` clients fail over mid-merge
  (parallel/dict_service.py) and repair any record tail their mirror holds
  beyond the promoted replica's tables, so converter output stays
  byte-identical to the no-failure path.

Config: ``[chunk_dict]`` ``shards`` / ``replicas`` /
``replication_budget_kib`` / ``replication_poll_ms`` with the
``NTPU_DICT_HA_SHARDS`` / ``NTPU_DICT_HA_REPLICAS`` /
``NTPU_DICT_HA_BUDGET_KIB`` / ``NTPU_DICT_HA_POLL_MS`` env overrides (the
env is how the section reaches spawned dict-service processes).
Failpoints: ``ha.place`` / ``ha.replicate`` / ``ha.promote``. Metrics:
``ntpu_dict_ha_*``. The controller side that serves the map
(``/api/v1/fleet/placement``) is ``fleet.FleetPlane`` on the system
controller (``cmd/snapshotter.py`` attaches a ``PlacementController``).
"""

from __future__ import annotations

import os

from nydus_snapshotter_tpu_torch.config.config import global_section
from nydus_snapshotter_tpu_torch.metrics import registry as _metrics

_reg = _metrics.default_registry

PLACEMENT_EPOCH = _reg.register(
    _metrics.Gauge(
        "ntpu_dict_ha_placement_epoch",
        "Current dict-shard placement map epoch (controller)",
    )
)
PROMOTIONS = _reg.register(
    _metrics.Counter(
        "ntpu_dict_ha_promotions_total",
        "Automatic replica promotions performed, by shard",
        ("shard",),
    )
)
REPLICATION_PULLS = _reg.register(
    _metrics.Counter(
        "ntpu_dict_ha_replication_pulls_total",
        "Byte-budgeted record-tail pulls performed by replica tailers",
    )
)
REPLICATION_BYTES = _reg.register(
    _metrics.Counter(
        "ntpu_dict_ha_replication_bytes_total",
        "Record-tail payload bytes replicated onto this replica",
    )
)
REPLICA_LAG = _reg.register(
    _metrics.Gauge(
        "ntpu_dict_ha_replica_lag_chunks",
        "Chunk records this replica is behind its primary, per namespace",
        ("namespace",),
    )
)
RESYNCS = _reg.register(
    _metrics.Counter(
        "ntpu_dict_ha_resyncs_total",
        "Loud full-snapshot resyncs after a replica failed to reconcile",
    )
)
FAILOVERS = _reg.register(
    _metrics.Counter(
        "ntpu_dict_ha_failovers_total",
        "Client-side shard failovers (un-acked batch replayed onto the "
        "promoted replica)",
    )
)

DEFAULT_BUDGET_KIB = 256
DEFAULT_POLL_MS = 50.0


class HaRuntimeConfig:
    """Resolved dict-HA knobs for this process."""

    __slots__ = ("shards", "replicas", "budget_bytes", "poll_s")

    def __init__(self, shards: int, replicas: int, budget_bytes: int, poll_s: float):
        self.shards = shards
        self.replicas = replicas
        self.budget_bytes = budget_bytes
        self.poll_s = poll_s

    @property
    def enabled(self) -> bool:
        return self.replicas > 0


def _env_num(name: str, default: float) -> float:
    try:
        return float(os.environ[name])
    except (KeyError, ValueError):
        return default


def resolve_ha_config() -> HaRuntimeConfig:
    """env (``NTPU_DICT_HA*``) > ``[chunk_dict]`` global config >
    defaults. The env is also how the knobs reach spawned dict-service
    processes, which carry no global snapshotter config."""
    cd = global_section("chunk_dict")
    shards = int(_env_num("NTPU_DICT_HA_SHARDS", getattr(cd, "shards", 1)))
    replicas = int(_env_num("NTPU_DICT_HA_REPLICAS", getattr(cd, "replicas", 0)))
    budget_kib = _env_num(
        "NTPU_DICT_HA_BUDGET_KIB",
        getattr(cd, "replication_budget_kib", DEFAULT_BUDGET_KIB),
    )
    poll_ms = _env_num(
        "NTPU_DICT_HA_POLL_MS", getattr(cd, "replication_poll_ms", DEFAULT_POLL_MS)
    )
    return HaRuntimeConfig(
        shards=max(1, shards),
        replicas=max(0, replicas),
        budget_bytes=max(64 << 10, int(budget_kib * 1024)),
        poll_s=max(0.001, poll_ms / 1000.0),
    )


from nydus_snapshotter_tpu_torch.ha.placement import (  # noqa: E402
    PlacementController,
    ShardAssignment,
)
from nydus_snapshotter_tpu_torch.ha.replicate import HaAgent, ReplicaTailer  # noqa: E402

__all__ = [
    "HaAgent",
    "HaRuntimeConfig",
    "PlacementController",
    "ReplicaTailer",
    "ShardAssignment",
    "resolve_ha_config",
]
