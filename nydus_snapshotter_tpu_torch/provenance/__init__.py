"""Provenance plane: byte-exact attribution of every fetched extent
(cause / tier / tenant / format), waste accounting against the actually
read extent set, and the heat-closed-loop ``.heat`` prefetch artifact.

See provenance/ledger.py (the attribution ledger and its conservation
invariant) and provenance/heat.py (the optimizer loop).
"""

from nydus_snapshotter_tpu_torch.provenance.ledger import (  # noqa: F401
    CAUSE_DEMAND,
    CAUSE_HEDGE_LOSER,
    CAUSE_HEDGE_WINNER,
    CAUSE_INDEX_BUILD,
    CAUSE_PEER_SERVE,
    CAUSE_PREFETCH,
    CAUSE_READAHEAD,
    CAUSES,
    LEDGER,
    Ledger,
    ProvenanceRuntimeConfig,
    blob_snapshot,
    config,
    conservation,
    disabled,
    enabled,
    heat_extents,
    invalidate_config,
    record_fetch,
    record_hedge_loss,
    record_read,
    reset,
    resolve_provenance_config,
    set_blob_meta,
    snapshot,
    waterfall,
)
from nydus_snapshotter_tpu_torch.provenance.heat import (  # noqa: F401
    ARTIFACT_KIND,
    HEAT_SUFFIX,
    HeatArtifact,
    HeatError,
    compile_heat,
    find_heat,
    heat_counters,
    heat_path,
    load_or_adopt_heat,
)
