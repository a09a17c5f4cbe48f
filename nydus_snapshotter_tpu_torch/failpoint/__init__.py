"""Process-wide failpoint registry (fault-injection layer).

Named fault sites are threaded through every I/O and process boundary of
the snapshotter (``failpoint.hit("transport.fetch_blob")`` …) and do
*nothing* unless armed. Sites are armed either through the
``NYDUS_TPU_FAILPOINTS`` environment variable (parsed once at import —
see :mod:`nydus_snapshotter_tpu_torch.failpoint.spec` for the grammar) or
programmatically via :func:`inject` / :func:`configure` / the
:func:`injected` context manager.

Zero-overhead contract: with nothing armed, :func:`hit` is a truthiness
check on an empty dict and a return — no locks, no allocation. With at
least one site armed, un-armed sites cost one additional dict miss.

The full site catalog lives in ``KNOWN_SITES`` and is documented in
``docs/robustness.md``.
"""

from __future__ import annotations

import os
import random
import threading
import time
from contextlib import contextmanager
from typing import Iterator, Optional, Union

from nydus_snapshotter_tpu_torch.analysis import runtime as _an
from nydus_snapshotter_tpu_torch.failpoint.spec import (
    Action,
    Panic,
    SpecError,
    build_error,
    check_portable,
    parse_action,
    parse_spec,
)

__all__ = [
    "Action",
    "ENV_VAR",
    "KNOWN_SITES",
    "Panic",
    "SpecError",
    "active",
    "clear",
    "configure",
    "configure_from_env",
    "counts",
    "hit",
    "inject",
    "injected",
]

ENV_VAR = "NYDUS_TPU_FAILPOINTS"

# Catalog of sites threaded through the codebase. Arming an unknown site
# is allowed (forward compatibility), but tools/chaos_matrix.py and the
# docs sweep this list.
KNOWN_SITES = (
    "transport.resolve",     # remote/transport.py Pool.resolve entry
    "transport.probe",       # remote/transport.py blob range-probe
    "transport.fetch_blob",  # remote/registry.py RegistryClient.fetch_blob
    "daemon.spawn",          # daemon/daemon.py Daemon.spawn
    "daemon.rpc",            # daemon/client.py NydusdClient._request
    "manager.restart",       # manager/manager.py do_daemon_restart
    "fs.mount",              # filesystem/fs.py Filesystem.mount
    "fs.umount",             # filesystem/fs.py Filesystem.umount
    "metastore.create",      # snapshot/metastore.py create_snapshot
    "metastore.commit",      # snapshot/metastore.py commit_active
    "metastore.remove",      # snapshot/metastore.py remove
    "converter.pack",        # converter/convert.py Pack dispatch
    "compress.probe",        # converter/codec.py per-chunk compressibility probe
    "compress.train",        # converter/codec.py ZDICT corpus training
    "compress.encode",       # converter/codec.py adaptive encode entry
    "pipeline.chunk",        # parallel/pipeline.py chunk-worker item entry
    "pipeline.queue",        # parallel/pipeline.py ByteBoundedQueue.put
    "pipeline.compress",     # parallel/pipeline.py compress-worker item entry
    "pipeline.assemble",     # parallel/pipeline.py ordered chunks_for fetch
    "fused.dispatch",        # ops/fused_convert.py device batch dispatch
    "blobcache.fetch",       # daemon/fetch_sched.py worker ranged-GET entry
    "blobcache.coalesce",    # daemon/fetch_sched.py miss-gap merge decision
    "blobcache.readahead",   # daemon/blobcache.py sequential window extension
    "blobcache.evict",       # cache/manager.py watermark entry eviction
    "blobcache.replay",      # daemon/fetch_sched.py prefetch-replay per file
    "snapshot.prepare",      # snapshot/async_work.py background prepare work
    "snapshot.commit",       # snapshot/snapshotter.py commit entry
    "snapshot.usage",        # snapshot/async_work.py async usage scan
    "snapshot.cleanup",      # snapshot/snapshotter.py per-dir cleanup
    "dict.insert",           # parallel/sharded_dict.py incremental insert batch
    "dict.rebuild",          # parallel/sharded_dict.py load-factor/overflow rebuild
    "dict.rpc",              # parallel/dict_service.py service request entry
    "peer.serve",            # daemon/peer.py chunk-server request entry
    "peer.fetch",            # daemon/peer.py peer-tier ranged read attempt
    "peer.admit",            # daemon/fetch_sched.py AdmissionGate.acquire entry
    "peer.member",           # daemon/peer.py membership registry refresh
    "dict.shard",            # parallel/dict_service.py per-shard batch routing
    "slo.actuate",           # metrics/slo.py lane shed/restore transition
    "soci.index",            # soci/blob.py index build / store boundary
    "soci.resolve",          # soci/blob.py read -> compressed-range resolution
    "soci.fetch",            # soci/blob.py compressed-range pull for a lazy read
    "fleet.scrape",          # metrics/federation.py per-member metrics scrape
    "fleet.collect",         # trace/aggregate.py per-member trace-ring pull
    "scenario.phase",        # scenario/orchestrator.py phase entry
    "ha.place",              # ha/placement.py PlacementController.tick entry
    "ha.replicate",          # ha/replicate.py ReplicaTailer.poll_once entry
    "ha.promote",            # ha/{placement,replicate}.py promotion transition
    "soak.wave",             # scenario/soak.py per-epoch wave entry
    "soak.evolve",           # scenario/soak.py corpus-evolution convert step
    "soak.scaleup",          # metrics/slo.py scale-up spawn attempt
    "chunk.vec",             # ops/native_cdc.py vectorized table-scan entry
    "compress.batch",        # converter/codec.py batched encode entry
    "peer.tier",             # daemon/peer.py per-tier waterfall attempt entry
    "peer.hedge",            # daemon/fetch_sched.py hedged second-request launch
    "prov.record",           # provenance/ledger.py per-extent attribution record
    "prov.compile",          # provenance/heat.py .heat compile/persist boundary
    "prov.adopt",            # provenance/heat.py peer heat-artifact adoption
)

_lock = _an.make_lock("failpoint.table")
_active: dict[str, Action] = {}
_fired: dict[str, int] = {}
_rng = random.random  # patchable for deterministic probability tests
_sleep = time.sleep


def hit(site: str) -> None:
    """Fault site marker. No-op unless ``site`` is armed."""
    if not _active:
        return
    act = _active.get(site)
    if act is None:
        return
    _fire(site, act)


def _fire(site: str, act: Action) -> None:
    with _lock:
        # Re-read under the lock: a concurrent clear()/n-shot exhaustion wins.
        act = _active.get(site)
        if act is None:
            return
        if act.prob is not None and _rng() >= act.prob:
            return
        if act.count is not None:
            act.count -= 1
            if act.count <= 0:
                _active.pop(site, None)
        _fired[site] = _fired.get(site, 0) + 1
        kind, arg = act.kind, act.arg
    # Tag the active trace span (if any) so chaos runs are attributable:
    # a span whose site fired carries `failpoints=[...]` in its attrs.
    # Lazy import: failpoint must stay import-light, and this only runs
    # when a site actually fires.
    try:
        from nydus_snapshotter_tpu_torch import trace as _trace

        _trace.annotate_failpoint(site)
    except Exception:
        pass
    if kind == "error":
        raise build_error(arg, site)
    if kind == "delay":
        _sleep(float(arg))
        return
    if kind == "panic":
        raise Panic(arg or f"failpoint panic at {site}")


def inject(site: str, action: Union[str, Action]) -> None:
    """Arm one site. ``action`` is an Action or a spec like ``"error(OSError)*2"``."""
    if isinstance(action, str):
        action = parse_action(action)
    else:
        check_portable(action)
    with _lock:
        _active[site] = action


def configure(spec: str) -> None:
    """Replace the whole table from a multi-site spec string."""
    table = parse_spec(spec)
    with _lock:
        _active.clear()
        _active.update(table)


def configure_from_env(environ=os.environ) -> bool:
    """Arm from ``NYDUS_TPU_FAILPOINTS``; returns whether anything was set.

    A malformed env spec is reported and ignored — this runs at import
    time, and a typo in a chaos knob must not take the whole snapshotter
    down harder than the fault it was trying to inject.
    """
    spec = environ.get(ENV_VAR, "")
    if not spec:
        return False
    try:
        configure(spec)
    except SpecError as e:
        import logging

        logging.getLogger(__name__).warning("ignoring bad %s: %s", ENV_VAR, e)
        return False
    return bool(_active)


def clear(site: Optional[str] = None) -> None:
    """Disarm one site, or everything (also resets fire counters)."""
    with _lock:
        if site is None:
            _active.clear()
            _fired.clear()
        else:
            _active.pop(site, None)


def active() -> dict[str, str]:
    """{site: action-spec} snapshot of the armed table."""
    with _lock:
        return {site: str(act) for site, act in _active.items()}


def counts() -> dict[str, int]:
    """{site: times fired} since the last full clear()."""
    with _lock:
        return dict(_fired)


@contextmanager
def injected(site: str, action: Union[str, Action]) -> Iterator[None]:
    """Scoped arm/disarm for tests."""
    inject(site, action)
    try:
        yield
    finally:
        clear(site)


configure_from_env()
