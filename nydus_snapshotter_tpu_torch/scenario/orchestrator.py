"""Scenario orchestrator: drive a spec through the REAL stack.

One :class:`ScenarioRunner` owns a workdir and executes a
:class:`~nydus_snapshotter_tpu_torch.scenario.spec.ScenarioSpec` phase by
phase against the real subsystems:

- **convert** — ``converter.convert.pack_layer`` (optionally through the
  adaptive codec) over the spec's corpora; converted blobs are
  registered with the in-process origin;
- **deploy** — per pod, the real snapshot control plane
  (``Snapshotter`` prepare/commit/mounts/usage over a crash-able
  filesystem facade) plus a real lazy-read data plane: a per-pod
  ``CachedBlob`` behind its own ``AdmissionGate``, wired through the
  peer chunk tier (``PeerChunkServer``/``PeerRouter``/
  ``PeerAwareFetcher``) when the phase enables it — including a
  HOSTILE peer arm (:class:`CorruptPeerServer`: payload corrupted after
  the CRC header is stamped, exactly transit corruption) and a soci arm
  (unconverted gzip layers read through a first-pull checkpoint index);
- **remove** — children-first removal of a deterministic subset of
  deployed pods, then the orphan-dir cleanup sweep;
- **gc** — watermark / age eviction over every pod cache dir
  (``cache.manager.CacheManager``);
- **crash_restart** — close the control plane mid-run and reopen it
  over the same metastore (also available mid-deploy via
  ``crash = "mid"``: in-flight pods quiesce at an op checkpoint, the
  snapshotter restarts, the storm resumes).

Determinism contract: ``ScenarioRunner(spec, serial=True)`` replays the
same spec with pods sequential, control-plane workers serial, peers off
and faults disarmed — the oracle. The concurrent chaos run must match
it byte for byte on :meth:`fingerprint` (id-normalized metastore dump +
per-pod read digests + blob ids), and :meth:`audit` must come back
clean (no leaked snapshot rows, no orphan snapshot dirs, no
unaccounted cache entries).

The SLO engine rides along as the in-run judge: every demand read lands
in the ``scenario_demand`` op histogram, a judge thread ticks a
:class:`~nydus_snapshotter_tpu_torch.metrics.slo.SloEngine` built from
``[scenario.slo]``, and any multi-window burn breach fails the run.
"""

from __future__ import annotations

import gzip as _gzip
import hashlib
import os
import shutil
import threading
import time
from typing import TYPE_CHECKING, Callable, Optional

from nydus_snapshotter_tpu_torch import constants as C
from nydus_snapshotter_tpu_torch import failpoint, scenario, trace
from nydus_snapshotter_tpu_torch.analysis import runtime as _an
from nydus_snapshotter_tpu_torch.cache.manager import CacheManager
from nydus_snapshotter_tpu_torch.scenario import corpus as corpus_gen
from nydus_snapshotter_tpu_torch.scenario.spec import PhaseSpec, ScenarioSpec
from nydus_snapshotter_tpu_torch.snapshot.metastore import Usage
from nydus_snapshotter_tpu_torch.tensors import resolve_device
from nydus_snapshotter_tpu_torch.utils import errdefs

if TYPE_CHECKING:
    import torch

# Demand-read granule (also the peer region size). 256 KiB balances the
# per-read HTTP/bookkeeping overhead against per-request service time:
# bigger granules halve request count but double service time, which
# doubles queue-wait tails at the region owners under a storm.
READ_CHUNK = 256 << 10
POD_BUDGET_BYTES = 8 << 20
SLO_OP = "scenario_demand"


class ScenarioRunError(RuntimeError):
    pass


# ---------------------------------------------------------------------------
# Simulated origin + crash-able filesystem facade
# ---------------------------------------------------------------------------


class SimRegistry:
    """In-process origin for every converted/unconverted blob of a run.

    Counts egress per blob so storm arms can bound origin traffic;
    ``latency_s`` models a slow uplink when a scenario wants demand
    latency pressure.
    """

    def __init__(self, latency_s: float = 0.0):
        self.latency_s = latency_s
        self._lock = _an.make_lock("scenario.registry")
        self._blobs: dict[str, bytes] = {}
        self._retired: set = set()
        self.egress = 0
        self.calls = 0

    def register(self, blob_id: str, data: bytes) -> None:
        with self._lock:
            self._blobs[blob_id] = data

    def blob(self, blob_id: str) -> bytes:
        with self._lock:
            return self._blobs[blob_id]

    def blob_ids(self) -> set:
        with self._lock:
            return set(self._blobs) | set(self._retired)

    def retire_except(self, live: set) -> int:
        """Drop blob BYTES for everything outside ``live`` but keep the
        ids known (a real registry GC deletes layer data while the ids
        stay resolvable in catalogs). The soak calls this per epoch so a
        year of corpus evolution doesn't read as an RSS leak; a fetch of
        a retired blob still fails loudly (KeyError), it does not
        silently resurrect."""
        with self._lock:
            stale = [bid for bid in self._blobs if bid not in live]
            for bid in stale:
                del self._blobs[bid]
                self._retired.add(bid)
            return len(stale)

    def fetch(self, blob_id: str, off: int, size: int) -> bytes:
        with self._lock:
            data = self._blobs[blob_id]
            self.egress += size
            self.calls += 1
        if off + size > len(data):
            raise OSError(f"range [{off}, {off + size}) past blob end")
        if self.latency_s:
            time.sleep(self.latency_s)
        return data[off : off + size]

    def fetcher(self, blob_id: str) -> Callable[[int, int], bytes]:
        return lambda off, size: self.fetch(blob_id, off, size)


class SimFs:
    """Thread-safe FilesystemLike facade with daemon latency and a crash
    switch. ``crash()`` drops every mounted instance (the daemons died
    with the process); ``wait_until_ready`` on an unknown snapshot
    REMOUNTS it first — the ``recover_policy = "restart"`` contract, so
    a post-crash join point recovers instead of failing."""

    def __init__(self, mount_ms: float = 1.0, ready_ms: float = 4.0):
        self.mount_ms = mount_ms
        self.ready_ms = ready_ms
        self._lock = _an.make_lock("scenario.simfs")
        self._ready_at: dict[str, float] = {}
        self.mounted: dict[str, dict] = {}
        self.remounts = 0

    def crash(self) -> None:
        with self._lock:
            self.mounted.clear()
            self._ready_at.clear()

    def mount(self, sid, labels, snapshot):
        time.sleep(self.mount_ms / 1000.0)
        with self._lock:
            self.mounted[sid] = dict(labels or {})
            self._ready_at[sid] = time.monotonic() + self.ready_ms / 1000.0

    def umount(self, sid):
        with self._lock:
            self.mounted.pop(sid, None)
            self._ready_at.pop(sid, None)

    def wait_until_ready(self, sid):
        with self._lock:
            at = self._ready_at.get(sid)
        if at is None:
            # Daemon recovery: the restart policy respawns and remounts.
            self.mount(sid, {}, None)
            with self._lock:
                self.remounts += 1
                at = self._ready_at[sid]
        delay = at - time.monotonic()
        if delay > 0:
            time.sleep(delay)

    def mount_point(self, sid):
        with self._lock:
            if sid in self.mounted:
                return f"/mnt/nydus/{sid}"
        raise errdefs.NotFound(sid)

    def bootstrap_file(self, sid):
        return f"/snap/{sid}/fs/image/image.boot"

    def remove_cache(self, digest):
        pass

    def cache_usage(self, digest):
        return Usage()

    def teardown(self):
        pass

    def try_stop_shared_daemon(self):
        pass

    def check_referrer(self, labels):
        return False

    def referrer_detect_enabled(self):
        return False

    def try_fetch_metadata(self, labels, meta_path):
        pass

    def stargz_enabled(self):
        return False

    def is_stargz_data_layer(self, labels):
        return False, None

    def prepare_stargz_meta_layer(self, blob, storage_path, labels):
        pass

    def merge_stargz_meta_layer(self, snapshot):
        pass

    def soci_enabled(self):
        return False

    def is_soci_data_layer(self, labels):
        return False, None

    def prepare_soci_meta_layer(self, blob, storage_path, labels):
        pass

    def merge_soci_meta_layer(self, snapshot):
        pass

    def tarfs_enabled(self):
        return False

    def prepare_tarfs_layer(self, labels, sid, upper):
        pass

    def merge_tarfs_layers(self, snapshot, path_fn):
        pass

    def export_block_data(self, snapshot, per_layer, labels, path_fn):
        return []

    def detach_tarfs_layer(self, sid):
        pass

    def tarfs_export_enabled(self):
        return False

    def get_instance_extra_option(self, sid):
        return None


class _GrpcControlPlane:
    """The ``deploy_api = "grpc"`` client: pods issue their control-plane
    RPC mix through the REAL snapshots.v1 gRPC surface on a UDS
    (api/service.py), exactly as containerd's proxy plugin would —
    instead of calling the Snapshotter object directly. The server wraps
    the SAME Snapshotter, so the metastore fingerprint stays comparable
    with the in-process client (and with the serial replay, which runs
    the same deploy_api). gRPC status codes map back onto the errdefs
    the pod logic already handles."""

    def __init__(self, sn, sock: str):
        from nydus_snapshotter_tpu_torch.api.client import SnapshotsClient
        from nydus_snapshotter_tpu_torch.api.service import serve

        self.sock = sock
        self.server = serve(sn, sock)
        self.client = SnapshotsClient(sock, timeout=30.0)

    def close(self) -> None:
        self.client.close()
        self.server.stop(grace=None)

    @staticmethod
    def _map(call):
        import grpc

        try:
            return call()
        except grpc.RpcError as e:
            if e.code() == grpc.StatusCode.ALREADY_EXISTS:
                raise errdefs.AlreadyExists(e.details()) from e
            if e.code() == grpc.StatusCode.NOT_FOUND:
                raise errdefs.NotFound(e.details()) from e
            raise ScenarioRunError(
                f"grpc control plane: {e.code().name}: {e.details()}"
            ) from e

    def prepare(self, key, parent, labels=None):
        return self._map(lambda: self.client.prepare(key, parent, labels))

    def commit(self, name, key, labels=None):
        return self._map(lambda: self.client.commit(name, key, labels))

    def mounts(self, key):
        return self._map(lambda: self.client.mounts(key))

    def usage(self, key):
        return self._map(lambda: self.client.usage(key))


class CorruptPeerServer:
    """Hostile peer: wraps a real PeerChunkServer and corrupts blob
    payloads AFTER the CRC header is stamped — exactly what transit
    corruption looks like on the wire, so the requester's CRC check MUST
    reject it and fall back to the registry (never caching poisoned
    bytes). Index/stat routes pass through untouched.

    The serve loop dispatches through the INNER server's ``handle``
    attribute (``run()`` closes over ``self``), so the corrupting hook is
    installed as an instance attribute on it.
    """

    def __init__(self, inner, seed: int):
        self._inner = inner
        self._seed = seed
        self.corrupted = 0
        inner_handle = inner.handle

        def handle(method, path, headers):
            status, extra, body = inner_handle(method, path, headers)
            if status == 200 and "/api/v1/peer/blob/" in path and body:
                body = corpus_gen.corrupt_variant(body, self._seed, "flip")
                self.corrupted += 1
            return status, extra, body

        inner.handle = handle
        self.handle = handle

    def __getattr__(self, name):
        return getattr(self._inner, name)


# ---------------------------------------------------------------------------
# The runner
# ---------------------------------------------------------------------------


class _Pod:
    """One simulated node of a deploy phase: CachedBlob + admission gate
    (+ peer server when the tier is on)."""

    def __init__(self, idx, cache_dir, blob_id, blob_len, origin_fetch,
                 addrs, peers_on, health, corrupt_seed=None,
                 localities=None, serve=True):
        from nydus_snapshotter_tpu_torch.daemon import peer
        from nydus_snapshotter_tpu_torch.daemon.blobcache import CachedBlob
        from nydus_snapshotter_tpu_torch.daemon.fetch_sched import (
            AdmissionGate,
            FetchConfig,
            MemoryBudget,
        )

        self.idx = idx
        self.cache_dir = cache_dir
        self.gate = AdmissionGate(
            budget=MemoryBudget(POD_BUDGET_BYTES),
            max_concurrent=8,
            demand_reserve=1,
            name=f"scn-pod{idx}",
        )
        fetch_range = origin_fetch
        self.server = None
        if peers_on:
            locs = localities or {}
            router = peer.PeerRouter(
                addrs,
                self_address=addrs[idx],
                region_bytes=READ_CHUNK,
                health_registry=health,
                locality=locs.get(addrs[idx], ""),
                localities=locs,
            )
            fetch_range = peer.PeerAwareFetcher(
                blob_id, origin_fetch, router, timeout_s=5.0
            ).read_range
        self.cb = CachedBlob(
            cache_dir,
            blob_id,
            fetch_range,
            blob_size=blob_len,
            config=FetchConfig(fetch_workers=2, merge_gap=0, readahead=0),
            gate=self.gate,
            tenant=f"scn-pod{idx}",
        )
        if peers_on and serve:
            export = peer.PeerExport()
            export.register(blob_id, self.cb)
            srv = peer.PeerChunkServer(
                export, gate=self.gate, pull_through=True, router=router
            )
            if corrupt_seed is not None:
                srv = CorruptPeerServer(srv, corrupt_seed)
            srv.run(addrs[idx])
            self.server = srv

    def close(self) -> None:
        if self.server is not None:
            self.server.stop()
            self.server = None
        self.cb.close()


class ScenarioRunner:
    def __init__(
        self,
        spec: ScenarioSpec,
        workdir: str,
        serial: bool = False,
        pods: Optional[int] = None,
        arm_faults: Optional[bool] = None,
        origin_latency_s: float = 0.0,
        pods_sequential: bool = False,
        device: "str | torch.device | None" = None,
    ):
        self.spec = spec
        # Where the shard-failover arm's dict services and its oracle keep
        # their indexes: CUDA unless the caller asks for the CPU.
        self.device = resolve_device(device)
        self.workdir = workdir
        self.serial = serial
        # Unloaded-baseline shape: pods run one at a time (zero
        # contention) but keep the storm's topology — peer tier on,
        # concurrent control plane — so a p95 comparison isolates LOAD,
        # not the peer hop.
        self.pods_sequential = pods_sequential
        self.pods_default = pods if pods is not None else spec.pods
        self.arm_faults = (not serial) if arm_faults is None else arm_faults
        self.registry = SimRegistry(latency_s=origin_latency_s)
        self.fs = SimFs()
        self.sn = None
        self.images: dict[str, dict] = {}  # corpus id -> blob/blob_id/...
        self.deployed: list[dict] = []  # one entry per deployed pod chain
        self.read_digests: dict[str, str] = {}
        self.demand_ms: list[float] = []
        self.expected_keys: set = set()
        self.corrupt_served = 0
        self.soci_outcomes: list[str] = []
        self.crashes = 0
        self.ha_promotions = 0
        # Serve-only peer members beyond the wave's demand pods: the
        # soak's scale-up actuation raises this between epochs so the
        # rendezvous ring spreads region ownership across more servers.
        # Always 0 for the serial replay (peers are off there), so the
        # identity surface never sees it.
        self.extra_serve_pods = 0
        self.last_demand_pressure: dict = {}
        # Optional node-level admission gate over the DEMAND READ window
        # (not the pods' fetch schedulers — sharing those would let a
        # flash crowd's queued demand waiters starve the strict-priority
        # PEER_SERVE lane into its timeout). The soak installs one per
        # epoch sized to the cluster's serving capacity, so a flash
        # crowd queues HERE and the scale-up loop has a real signal.
        # None = no cluster ceiling (the worst-day storm shape).
        self.node_gate = None
        self._engine = None
        self._engine_stop = threading.Event()
        self._engine_thread = None
        self._demand_mu = _an.make_lock("scenario.demand")
        self._grpc: Optional[_GrpcControlPlane] = None
        self._grpc_mu = _an.make_lock("scenario.grpc")

    # -- control plane lifecycle --------------------------------------------

    def _snap_root(self) -> str:
        return os.path.join(self.workdir, "snapshotter")

    def _open_control_plane(self):
        from nydus_snapshotter_tpu_torch.snapshot.snapshotter import Snapshotter

        os.makedirs(self._snap_root(), exist_ok=True)
        kw = dict(read_pool=1, prepare_fanout=0, usage_workers=0,
                  cleanup_workers=1) if self.serial else dict(
            read_pool=4, prepare_fanout=4, usage_workers=1, cleanup_workers=2)
        self.sn = Snapshotter(root=self._snap_root(), fs=self.fs, **kw)

    def _grpc_plane(self) -> _GrpcControlPlane:
        """The lazily-opened gRPC control-plane client over the current
        Snapshotter (re-opened on crash/restart with it)."""
        with self._grpc_mu:
            if self._grpc is None:
                self._grpc = _GrpcControlPlane(
                    self.sn, os.path.join(self.workdir, "scn-grpc.sock")
                )
            return self._grpc

    def _crash_restart(self) -> None:
        """Close the control plane mid-run (daemons die with it) and
        reopen it over the same persisted metastore.

        Never called concurrently by construction: a deploy phase's
        crash controller is joined before the phase ends, and standalone
        ``crash_restart`` phases run on the main thread between phases —
        so no lock is held across the close (which joins the usage
        accountant's workers)."""
        with self._grpc_mu:
            grpc_was_open = self._grpc is not None
            plane, self._grpc = self._grpc, None
        if plane is not None:
            plane.close()
        if self.sn is not None:
            self.sn.close()
            self.sn = None
        self.fs.crash()
        self.crashes += 1
        self._open_control_plane()
        if grpc_was_open:
            # The gRPC surface died with the control plane; reopen it on
            # the same socket so parked pods resume over the same API.
            self._grpc_plane()

    # -- corpora -------------------------------------------------------------

    def _corpus_tar(self, cid: str) -> bytes:
        cs = self.spec.corpus_by_id(cid)
        idx = list(self.spec.corpus).index(cs)
        seed = self.spec.seed * 1000 + idx
        if cs.kind == "real_tree":
            return corpus_gen.members_to_tar(corpus_gen.real_tree_members())
        if cs.kind == "real_tree2":
            return corpus_gen.members_to_tar(corpus_gen.real_tree2_members())
        if cs.kind == "incompressible":
            return corpus_gen.incompressible_layer(seed, cs.mib)
        if cs.kind == "compressible":
            return corpus_gen.compressible_layer(seed, cs.mib)
        if cs.kind == "cdc_resonant":
            return corpus_gen.cdc_resonant_layer(
                seed, cs.mib, cs.avg_kib << 10, cs.mode
            )
        if cs.kind == "tiny_files":
            return corpus_gen.tiny_files_layer(seed, cs.count)
        if cs.kind == "huge_file":
            return corpus_gen.single_huge_file_layer(seed, cs.mib)
        raise ScenarioRunError(f"unhandled corpus kind {cs.kind!r}")

    # -- phases --------------------------------------------------------------

    def _phase_convert(self, idx: int, phase: PhaseSpec) -> dict:
        from nydus_snapshotter_tpu_torch.converter.codec import AdaptiveCodec, CodecConfig
        from nydus_snapshotter_tpu_torch.converter.convert import pack_layer
        from nydus_snapshotter_tpu_torch.converter.types import PackOption
        from nydus_snapshotter_tpu_torch.utils import zstd as zstd_native

        adaptive = phase.adaptive and zstd_native.available()
        opt = PackOption(
            backend="numpy",
            chunking="cdc",
            compressor="zstd" if adaptive else "lz4_block",
        )

        def convert_one(cid: str) -> dict:
            tar = self._corpus_tar(cid)
            codec = (
                AdaptiveCodec(CodecConfig(adaptive=True)) if adaptive else None
            )
            blob, res = pack_layer(tar, opt, codec=codec)
            return {
                "cid": cid,
                "tar_len": len(tar),
                "blob": blob,
                "blob_id": res.blob_id,
                "bootstrap": res.bootstrap,
                "digest": hashlib.sha256(blob).hexdigest(),
            }

        results = []
        if self.serial or len(phase.corpus) == 1:
            results = [convert_one(c) for c in phase.corpus]
        else:
            from concurrent.futures import ThreadPoolExecutor

            with ThreadPoolExecutor(
                max_workers=min(4, len(phase.corpus)),
                thread_name_prefix="ntpu-scn-convert",
            ) as ex:
                results = [
                    f.result()
                    for f in [ex.submit(convert_one, c) for c in phase.corpus]
                ]
        out = {}
        for r in results:
            self.images[r["cid"]] = r
            self.registry.register(r["blob_id"], r["blob"])
            out[r["cid"]] = {
                "blob_id": r["blob_id"],
                "tar_mib": round(r["tar_len"] / (1 << 20), 2),
                "blob_mib": round(len(r["blob"]) / (1 << 20), 2),
            }
        detail = {"converted": out}
        if phase.shard_failover and not self.serial:
            detail["shard_failover"] = self._shard_failover_arm(idx, results)
        return detail

    def _shard_failover_arm(self, idx: int, results: list) -> dict:
        """The ``shard_failover`` fault arm: drive the dict-HA plane end
        to end with this phase's real converted bootstraps. A primary +
        replica dict-service pair replicates under a placement
        controller; the PRIMARY DIES mid-merge-sequence, the controller
        promotes the replica (scrape-liveness path), the mirror client
        fails over and replays its un-acked batch — and the surviving
        table must be byte-identical to a straight-line single-service
        oracle fed the same bootstraps in the same order. Skipped in the
        serial replay (like the corrupt-peer probe, it is a fault arm,
        not part of the identity surface)."""
        from nydus_snapshotter_tpu_torch import fleet as fleet_mod
        from nydus_snapshotter_tpu_torch.ha import PlacementController
        from nydus_snapshotter_tpu_torch.ha.replicate import HaAgent
        from nydus_snapshotter_tpu_torch.parallel.dict_service import (
            DictClient,
            DictService,
            ServiceChunkDict,
            ServiceDict,
        )

        # Converted bootstraps in deterministic (corpus) order; the arm
        # needs at least two merges so the kill lands mid-sequence.
        boots = [
            self.images[r["cid"]].get("bootstrap")
            for r in sorted(results, key=lambda r: r["cid"])
        ]
        boots = [b for b in boots if b]
        if len(boots) < 2:
            return {"skipped": "needs >= 2 converted bootstraps"}
        sockdir = os.path.join(self.workdir, f"ph{idx}-ha")
        os.makedirs(sockdir, exist_ok=True)
        services, members = [], []
        liveness = {}
        for i in range(2):
            svc = DictService(device=self.device)
            HaAgent(svc, role="unassigned")
            svc.run(os.path.join(sockdir, f"dict{i}.sock"))
            services.append(svc)
            members.append(
                fleet_mod.Member(
                    name=f"scn-dict-{i}", component="dict",
                    address=svc.sock_path, pid=os.getpid(),
                )
            )
            liveness[f"scn-dict-{i}"] = {"up": True, "stale": False}
        controller = PlacementController(
            lambda: members, lambda: dict(liveness), shards=1, replicas=1
        )
        oracle = ServiceDict("scnha", device=self.device)
        promotions = 0
        try:
            controller.tick()
            primary_name = controller.map()["assignments"][0]["primary"]["name"]
            primary_i = int(primary_name.rsplit("-", 1)[1])
            replica_i = 1 - primary_i
            scd = ServiceChunkDict(
                [DictClient(services[primary_i].sock_path)], "scnha",
                failover=[[services[replica_i].sock_path]],
            )
            for b in boots:
                oracle.merge_bootstrap_bytes(b)
            half = max(1, len(boots) // 2)
            for b in boots[:half]:
                scd.add_bootstrap_bytes(b)
            # Let the replica catch up to the acked half, then kill the
            # primary without ceremony (its threads die unanswered).
            deadline = time.monotonic() + 10.0
            want = len(services[primary_i].dict_for("scnha").records.bootstrap.chunks)
            while time.monotonic() < deadline:
                got = len(
                    services[replica_i].dict_for("scnha").records.bootstrap.chunks
                )
                if got >= want:
                    break
                time.sleep(0.02)
            services[primary_i].stop()
            liveness[primary_name] = {"up": False, "stale": True}
            controller.tick()  # promotes the replica
            promotions = controller.map()["promotions"]
            for b in boots[half:]:
                scd.add_bootstrap_bytes(b)  # mid-merge failover path
            survivor = services[replica_i].dict_for("scnha")
            identical = (
                survivor.records.bootstrap.to_bytes()
                == oracle.records.bootstrap.to_bytes()
            )
            scd.close()
            if not identical:
                raise ScenarioRunError(
                    "shard_failover arm: post-promotion table diverged "
                    "from the straight-line oracle"
                )
            if promotions < 1:
                raise ScenarioRunError(
                    "shard_failover arm: controller performed no promotion"
                )
            self.ha_promotions += promotions
            return {
                "promotions": promotions,
                "chunks": len(survivor.records.bootstrap.chunks),
                "identical": identical,
            }
        finally:
            for svc in services:
                svc.stop()

    def _image_for_deploy(self, cid: str, soci: bool, fmt: str = "gzip") -> dict:
        """Converted image, or (soci arm) the UNCONVERTED layer in one of
        the lazy formats the FormatRouter recognizes — registered lazily
        so a deploy can reference a corpus no convert phase touched."""
        key = f"soci:{fmt}:{cid}" if soci else cid
        if key in self.images:
            return self.images[key]
        if soci:
            tar = self._corpus_tar(cid)
            # Every writer here is deterministic (gzip mtime=0, fixed
            # zstd level): wall-clock in a header would fork the serial
            # replay's blob id from the storm's.
            blob = self._format_blob(tar, fmt)
            blob_id = hashlib.sha256(blob).hexdigest()
            img = {
                "cid": key, "blob": blob, "blob_id": blob_id,
                "digest": hashlib.sha256(blob).hexdigest(),
                "tar": tar, "soci": True, "format": fmt,
            }
            self.images[key] = img
            self.registry.register(blob_id, blob)
            return img
        raise ScenarioRunError(
            f"deploy references corpus {cid!r} with no converted image "
            "(add a convert phase or set soci = true)"
        )

    @staticmethod
    def _format_blob(tar: bytes, fmt: str) -> bytes:
        """The corpus tar in one deployable lazy format. zstd shapes need
        the system libzstd; a spec asking for them on a box without it is
        a hard run error, not silent gzip."""
        if fmt == "gzip":
            return _gzip.compress(tar, compresslevel=6, mtime=0)
        from nydus_snapshotter_tpu_torch.soci import toc as ztoc
        from nydus_snapshotter_tpu_torch.soci import zframe
        from nydus_snapshotter_tpu_torch.utils import zstd as _zstd

        if not (zframe.available() and _zstd.dctx_available()):
            raise ScenarioRunError(
                f"soci format {fmt!r} needs the system libzstd"
            )
        if fmt == "zstd-seekable":
            return zframe.write_seekable(tar, frame_usize=256 << 10)
        if fmt == "zstd-opaque":
            return zframe.write_frames(tar, frame_usize=256 << 10)
        if fmt == "zstd-chunked":
            import io
            import tarfile

            files: dict[str, bytes] = {}
            with tarfile.open(fileobj=io.BytesIO(tar), mode="r:") as tf:
                for m in tf:
                    if m.isreg():
                        files[m.name] = tf.extractfile(m).read()
            return ztoc.write_zstd_chunked(files, chunk_size=256 << 10)
        raise ScenarioRunError(f"unhandled soci format {fmt!r}")

    def _control_plane_pod(self, prefix: str, layers: int, cp=None) -> dict:
        """The containerd cold-start RPC mix for one pod: layer chain +
        meta layer + writable container layer, then usage for every
        name. ``cp`` is the control-plane client — the Snapshotter
        itself, or the gRPC facade when the phase sets
        ``deploy_api = "grpc"``. Returns the chain record removal
        needs."""
        sn = cp if cp is not None else self.sn
        parent = ""
        names = []
        for j in range(layers - 1):
            key = f"{prefix}-extract-{j}"
            name = f"{prefix}-layer-{j}"
            labels = {
                C.TARGET_SNAPSHOT_REF: name,
                C.NYDUS_DATA_LAYER: "true",
                C.CRI_LAYER_DIGEST: "sha256:" + hashlib.sha256(
                    name.encode()).hexdigest(),
            }
            try:
                sn.prepare(key, parent, labels)
            except errdefs.AlreadyExists:
                pass  # skip handler committed under the target name
            names.append(name)
            parent = name
        meta_key = f"{prefix}-extract-meta"
        meta_name = f"{prefix}-meta"
        meta_labels = {C.NYDUS_META_LAYER: "true", C.CRI_IMAGE_REF: prefix}
        sn.prepare(
            meta_key, parent, {C.TARGET_SNAPSHOT_REF: meta_name, **meta_labels}
        )
        # Upper-dir writes stay process-local (the gRPC surface carries
        # no file I/O, exactly as with containerd).
        sid = self.sn.ms.get_snapshot(meta_key).id
        upper = self.sn.upper_path(sid)
        for i in range(8):
            with open(os.path.join(upper, f"f{i:02d}.bin"), "wb") as f:
                f.write(bytes([(i * 7) % 251]) * (512 + 16 * i))
        sn.commit(meta_name, meta_key, meta_labels)
        names.append(meta_name)
        ctr = f"{prefix}-ctr"
        sn.prepare(ctr, meta_name, {})
        sn.mounts(ctr)
        for name in names:
            sn.usage(name)
        return {"prefix": prefix, "names": names, "ctr": ctr}

    def _demand_read(
        self, cb, off: int, size: int, tenant: str = "scn-demand"
    ) -> bytes:
        from nydus_snapshotter_tpu_torch.daemon.fetch_sched import OP_HIST

        t0 = time.perf_counter()
        gate = self.node_gate
        if gate is not None:
            # Queue wait is part of the demand latency on purpose: the
            # SLO judge and the p95 gates must see what a pod sees.
            gate.acquire(size, tenant=tenant)
        try:
            data = cb.read_at(off, size)
        finally:
            if gate is not None:
                gate.release(size, tenant=tenant)
        ms = (time.perf_counter() - t0) * 1000.0
        OP_HIST.labels(SLO_OP).observe(ms)
        with self._demand_mu:
            self.demand_ms.append(ms)
        return data

    def _phase_deploy(self, idx: int, phase: PhaseSpec) -> dict:
        pods = phase.pods or self.pods_default
        peers_on = phase.peers and not self.serial and pods > 1
        layers = phase.layers
        fmts = phase.soci_formats or ("gzip",) * len(phase.corpus)
        images = [
            self._image_for_deploy(cid, phase.soci, fmt)
            for cid, fmt in zip(phase.corpus, fmts)
        ]
        from nydus_snapshotter_tpu_torch.remote.mirror import HostHealthRegistry

        health = HostHealthRegistry()
        sockdir = os.path.join(self.workdir, f"ph{idx}-sock")
        os.makedirs(sockdir, exist_ok=True)
        extra = self.extra_serve_pods if peers_on else 0
        addrs = [
            os.path.join(sockdir, f"p{i}.sock") for i in range(pods + extra)
        ]
        errors: list[str] = []
        chains: list = [None] * pods
        # Topology fault arm: deterministic rack:zone:region localities
        # (zone by pod-index parity, racks alternating in pairs) so the
        # kill controller can SIGKILL-equivalent one whole zone's peer
        # servers mid-deploy. Survivors must degrade to shield/origin;
        # the serial replay (peers off) proves read identity.
        kill_zone_on = phase.kill_zone and peers_on
        localities = (
            {
                a: f"r{(i // 2) % 2}:z{i % 2}:reg0"
                for i, a in enumerate(addrs)
            }
            if kill_zone_on
            else None
        )
        zone_dead = threading.Event()
        kill_done = threading.Event()
        killed: list[int] = []
        suppressed: list[int] = []
        crash_done = threading.Event()
        pause = threading.Event()
        resume = threading.Event()
        quiesced = _an.make_condition("scenario.quiesce")
        state = {"completed": 0, "cp_active": 0}

        def enter_cp():
            """Gate into the control-plane window. While a restart is
            pending, pods park HERE — so the metastore only ever closes
            with zero control-plane RPCs in flight (a restart between
            requests, not data loss mid-transaction)."""
            while True:
                if pause.is_set():
                    resume.wait()
                with quiesced:
                    if not pause.is_set():
                        state["cp_active"] += 1
                        return

        def exit_cp():
            with quiesced:
                state["cp_active"] -= 1
                state["completed"] += 1
                quiesced.notify_all()

        def crash_controller():
            # Fire once half the pods completed their control-plane ops.
            while not crash_done.is_set():
                with quiesced:
                    if state["completed"] >= max(1, pods // 2):
                        break
                time.sleep(0.005)
            if crash_done.is_set():
                return
            pause.set()
            try:
                with quiesced:
                    while state["cp_active"] > 0:
                        quiesced.wait(timeout=0.05)
                self._crash_restart()
            finally:
                # Always release parked pods, even if the restart itself
                # blew up — their next op will surface the broken plane.
                crash_done.set()
                resume.set()
                pause.clear()

        open_pods: list = []
        pods_mu = _an.make_lock("scenario.pods")

        def kill_zone_controller():
            # Fire once half the pods completed their control-plane ops
            # (the crash_controller trigger shape), then sweep until the
            # phase ends: every registered zone-1 peer server goes down,
            # including any that raced past the creation guard.
            # Late-arriving zone-1 pods see zone_dead and never serve.
            while not kill_done.is_set():
                with quiesced:
                    if state["completed"] >= max(1, pods // 2):
                        break
                time.sleep(0.005)
            if kill_done.is_set():
                return
            zone_dead.set()
            while True:
                with pods_mu:
                    targets = [
                        (i, pod) for i, pod in open_pods
                        if i % 2 == 1 and pod.server is not None
                    ]
                for i, pod in targets:
                    srv, pod.server = pod.server, None
                    srv.stop()
                    killed.append(i)
                if kill_done.is_set():
                    return
                time.sleep(0.005)
        # Pod threads open trace spans (prepare/commit/blobcache): carry
        # the phase's trace context so their spans don't detach.
        phase_ctx = trace.capture()

        def run_pod(i: int) -> None:
            img = images[i % len(images)]
            try:
                with trace.with_context(phase_ctx):
                    _run_pod_traced(i, img)
            except BaseException as e:  # noqa: BLE001 — surfaced as run failure
                errors.append(f"pod{i}: {e!r}")

        def _run_pod_traced(i: int, img: dict) -> None:
            enter_cp()
            try:
                # Resolve the control-plane client INSIDE the cp window:
                # a crash/restart replaces both the Snapshotter and the
                # gRPC plane, and enter_cp guarantees neither happens
                # while this pod's RPC mix is in flight.
                cp = (
                    self._grpc_plane() if phase.deploy_api == "grpc" else None
                )
                chains[i] = self._control_plane_pod(
                    f"ph{idx}-{img['cid'].replace(':', '_')}-pod{i}", layers,
                    cp=cp,
                )
            finally:
                exit_cp()
            # Data plane: cold-read the image through the waterfall.
            corrupt_seed = (
                self.spec.seed if (phase.corrupt_peer and i == 0) else None
            )
            serve = not (
                kill_zone_on and zone_dead.is_set() and i % 2 == 1
            )
            if kill_zone_on and not serve:
                with pods_mu:
                    suppressed.append(i)
            pod = _Pod(
                i,
                os.path.join(self.workdir, f"ph{idx}-pod{i}"),
                img["blob_id"],
                len(img["blob"]),
                self.registry.fetcher(img["blob_id"]),
                addrs,
                peers_on,
                health,
                corrupt_seed=corrupt_seed,
                localities=localities,
                serve=serve,
            )
            with pods_mu:
                open_pods.append((i, pod))
            # Demand-read window: read_mib bounds per-pod volume so a
            # big image's storm stays latency-dominated on a small
            # box (blob-id equality with the serial replay still
            # proves full-content identity).
            total = len(img["blob"])
            if phase.read_mib:
                total = min(total, phase.read_mib << 20)
            h = hashlib.sha256()
            for off in range(0, total, READ_CHUNK):
                n = min(READ_CHUNK, total - off)
                h.update(
                    self._demand_read(pod.cb, off, n, tenant=f"scn-pod{i}")
                )
            self.read_digests[f"ph{idx}-pod{i}"] = h.hexdigest()
            if phase.corrupt_peer and peers_on and i == 1:
                self._corrupt_probe(img, addrs[0])
            if img.get("soci"):
                self._soci_reads(pod, img, f"ph{idx}-pod{i}")

        # Serve-only members (scale-up capacity): open BEFORE the demand
        # pods so their peer servers are listening when the rendezvous
        # ring routes regions at them. They issue no control-plane ops
        # and no demand reads — pure extra serving capacity, pulled
        # through from the origin on first touch.
        for j in range(pods, pods + extra):
            img = images[j % len(images)]
            pod = _Pod(
                j,
                os.path.join(self.workdir, f"ph{idx}-pod{j}"),
                img["blob_id"],
                len(img["blob"]),
                self.registry.fetcher(img["blob_id"]),
                addrs,
                True,
                health,
            )
            with pods_mu:
                open_pods.append((j, pod))

        gc_stop = threading.Event()
        gc_thread = None
        if phase.gc_watermark_mib and not self.serial:
            def gc_tick():
                while not gc_stop.wait(0.05):
                    self._gc_all(phase.gc_watermark_mib << 20)
            gc_thread = threading.Thread(
                target=gc_tick, name="ntpu-scn-gc", daemon=True
            )
            gc_thread.start()

        kill_t = None
        if kill_zone_on:
            kill_t = threading.Thread(
                target=kill_zone_controller, name="ntpu-scn-killzone"
            )
            kill_t.start()

        crash_t = None
        if phase.crash == "mid":
            if self.serial:
                # Serial replay: the restart happens at the same logical
                # point — between pods, after half of them.
                pass
            else:
                crash_t = threading.Thread(
                    target=crash_controller, name="ntpu-scn-crash"
                )
                crash_t.start()

        if self.serial or self.pods_sequential:
            for i in range(pods):
                if phase.crash == "mid" and i == max(1, pods // 2):
                    self._crash_restart()
                run_pod(i)
        else:
            threads = [
                threading.Thread(
                    target=run_pod, args=(i,), name=f"ntpu-scn-pod{i}"
                )
                for i in range(pods)
            ]
            for t in threads:
                t.start()
            for t in threads:
                t.join()
        if kill_t is not None:
            kill_done.set()
            kill_t.join()
        if crash_t is not None:
            crash_done.set()
            crash_t.join()
        if gc_thread is not None:
            gc_stop.set()
            gc_thread.join()
        if phase.gc_watermark_mib and self.serial:
            self._gc_all(phase.gc_watermark_mib << 20)
        # Pods stay open (serving peers) until the whole phase is done —
        # exactly the deployed shape; teardown collects the hostile
        # peer's corruption count before closing it.
        with pods_mu:
            teardown = list(open_pods)
            open_pods.clear()
        # Aggregate the demand-lane pressure signal (queue depth + wait
        # EWMA) across the wave's gates before they close — the soak's
        # scale-up policy reads this to decide spawn/retire.
        press = [pod.gate.demand_pressure() for i, pod in teardown if i < pods]
        samples = sum(p["samples"] for p in press)
        self.last_demand_pressure = {
            "queued": sum(p["queued"] for p in press),
            "queued_peak": max(
                (p.get("queued_peak", 0) for p in press), default=0
            ),
            "wait_ms": (
                sum(p["wait_ms"] * p["samples"] for p in press) / samples
                if samples else 0.0
            ),
            "samples": samples,
            "gates": len(press),
            "extra_serve_pods": extra,
        }
        if self.node_gate is not None:
            # The node ceiling is where a crowd actually queues; its
            # signal supersedes the per-pod schedulers' (whose 8-wide
            # gates a 2-worker fetch pool can never saturate).
            node = self.node_gate.demand_pressure()
            self.last_demand_pressure.update({
                "queued": node["queued"],
                "queued_peak": node["queued_peak"],
                "wait_ms": node["wait_ms"],
                "node_samples": node["samples"],
            })
        for i, pod in teardown:
            if phase.corrupt_peer and i == 0 and pod.server is not None:
                self.corrupt_served += getattr(pod.server, "corrupted", 0)
            pod.close()
        if errors:
            raise ScenarioRunError(f"deploy pod failures: {errors[:4]}")
        for ch in chains:
            if ch is not None:
                self.deployed.append(ch)
                self.expected_keys.update(ch["names"])
                self.expected_keys.add(ch["ctr"])
        # Analytic demand volume of the wave (the capacity model's
        # numerator): each pod cold-reads its image's window.
        window = (phase.read_mib << 20) if phase.read_mib else (1 << 62)
        demand_bytes = sum(
            min(len(images[i % len(images)]["blob"]), window)
            for i in range(pods)
        )
        out = {
            "pods": pods,
            "peers": peers_on,
            "extra_serve_pods": extra,
            "demand_bytes": demand_bytes,
            "corrupt_served": self.corrupt_served if phase.corrupt_peer else 0,
            "crashes": self.crashes,
        }
        if kill_zone_on:
            out["kill_zone"] = {
                "zone": "z1",
                "killed": sorted(killed),
                "suppressed": sorted(suppressed),
            }
        return out

    def _corrupt_probe(self, img: dict, hostile_addr: str) -> None:
        """Deterministically engage the hostile-peer arm: rendezvous
        ownership hashes over this run's socket paths, so a bounded read
        window may never land on the hostile peer's regions by luck.
        Pod 1 contacts the hostile peer DIRECTLY for one region — the
        poisoned payload must fail the CRC check (a clean payload from a
        corrupting peer would mean the corruption hook is dead)."""
        from nydus_snapshotter_tpu_torch.daemon.peer import PeerClient, PeerError, PeerMiss

        n = min(READ_CHUNK, len(img["blob"]))
        deadline = time.monotonic() + 10.0
        while True:
            try:
                PeerClient(hostile_addr, timeout_s=2.0).read_range(
                    img["blob_id"], 0, n
                )
            except PeerError as e:
                if "CRC32" in str(e):
                    return  # poisoned payload detected and rejected
                # Server not listening yet (pod 0 may still be in its
                # control-plane phase) — retry until the deadline.
            except PeerMiss:
                pass
            else:
                raise ScenarioRunError(
                    "hostile peer served a payload that passed the CRC check"
                )
            if time.monotonic() > deadline:
                raise ScenarioRunError(
                    "hostile-peer probe never got a corrupt response"
                )
            time.sleep(0.05)

    def _soci_reads(self, pod, img, tag: str) -> None:
        """The unconverted arm: lazy per-file reads over the pod's
        CachedBlob, verified against the original tar — the read path the
        soci backend deploys for whichever format the image ships.
        gzip → checkpoint index, zstd-seekable/opaque → frame index,
        zstd-chunked → TOC adoption (zero index-build bytes)."""
        fmt = img.get("format", "gzip")
        if fmt == "zstd-chunked":
            self._soci_reads_toc(pod, img, tag)
            return
        from nydus_snapshotter_tpu_torch.soci import blob as soci_blob

        if fmt == "gzip":
            index, outcome = soci_blob.load_or_build_index(
                [pod.cache_dir],
                img["blob_id"],
                csize=len(img["blob"]),
                builder=lambda: pod.cb.read_at(0, len(img["blob"])),
                stride=64 << 10,
            )
        else:  # zstd-seekable / zstd-opaque: the frame-index twin
            from nydus_snapshotter_tpu_torch.soci import zblob as soci_zblob

            index, outcome = soci_zblob.load_or_build_zindex(
                [pod.cache_dir],
                img["blob_id"],
                csize=len(img["blob"]),
                builder=lambda: pod.cb.read_at(0, len(img["blob"])),
            )
        self.soci_outcomes.append(outcome)
        if index is None:
            raise ScenarioRunError(f"{tag}: soci index unavailable ({outcome})")
        if fmt == "gzip":
            reader = soci_blob.SociStreamReader(index, pod.cb.read_at, name=tag)
        else:
            from nydus_snapshotter_tpu_torch.soci.zblob import ZstdStreamReader

            reader = ZstdStreamReader(index, pod.cb.read_at, name=tag)
        tar = img["tar"]
        extents = sorted(soci_blob.file_extents(tar).items())
        h = hashlib.sha256()
        want = hashlib.sha256()
        for path, (off, size) in extents[:: max(1, len(extents) // 8)]:
            h.update(reader.read_range(off, min(size, READ_CHUNK)))
            want.update(tar[off : off + min(size, READ_CHUNK)])
        if h.hexdigest() != want.hexdigest():
            raise ScenarioRunError(f"{tag}: soci reads diverge from the tar")
        self.read_digests[f"{tag}-soci"] = h.hexdigest()

    def _soci_reads_toc(self, pod, img, tag: str) -> None:
        """The toc-adopt arm: the shipped zstd:chunked TOC IS the
        file→extent map — adopt it into a bootstrap, read files through
        per-chunk ranged fetches of the ORIGINAL blob, verify against the
        tar. No index artifact exists for this format, by design."""
        from nydus_snapshotter_tpu_torch.converter.convert import BlobReader
        from nydus_snapshotter_tpu_torch.soci import blob as soci_blob
        from nydus_snapshotter_tpu_torch.soci import toc as ztoc
        from nydus_snapshotter_tpu_torch.constants import COMPRESSOR_ZSTD
        from nydus_snapshotter_tpu_torch.stargz.index import bootstrap_from_toc

        failpoint.hit("soci.index")
        size = len(img["blob"])
        toc = ztoc.read_toc(pod.cb.read_at, size)
        loc = ztoc.parse_footer(
            pod.cb.read_at(size - ztoc.FOOTER_SIZE, ztoc.FOOTER_SIZE)
        )
        if toc is None or loc is None:
            raise ScenarioRunError(f"{tag}: zstd:chunked TOC unreadable")
        bs = bootstrap_from_toc(
            toc,
            img["blob_id"],
            chunk_size=256 << 10,
            blob_compressed_size=loc[0],
            compressor=COMPRESSOR_ZSTD,
        )
        self.soci_outcomes.append("toc-adopt")
        br = BlobReader(bs, 0, pod.cb.read_at)
        tar = img["tar"]
        contents = {
            p.lstrip("/"): tar[off : off + sz]
            for p, (off, sz) in soci_blob.file_extents(tar).items()
        }
        import stat as statmod

        inodes = sorted(
            (i for i in bs.inodes if statmod.S_ISREG(i.mode)),
            key=lambda i: i.path,
        )
        h = hashlib.sha256()
        want = hashlib.sha256()
        for ino in inodes[:: max(1, len(inodes) // 8)]:
            recs = bs.chunks[ino.chunk_index : ino.chunk_index + ino.chunk_count]
            got = b"".join(br.chunk_data(r) for r in recs)
            h.update(got[:READ_CHUNK])
            want.update(contents[ino.path.lstrip("/")][:READ_CHUNK])
        if h.hexdigest() != want.hexdigest():
            raise ScenarioRunError(f"{tag}: toc-adopt reads diverge from the tar")
        self.read_digests[f"{tag}-soci"] = h.hexdigest()

    def _phase_remove(self, idx: int, phase: PhaseSpec) -> dict:
        count = max(1, int(len(self.deployed) * phase.fraction)) if self.deployed else 0
        victims, keep = self.deployed[:count], self.deployed[count:]
        removed = 0
        for ch in victims:
            # Children first: the writable layer, then the chain top-down
            # refusal order (metastore refuses while children exist).
            for key in [ch["ctr"], *reversed(ch["names"])]:
                self.sn.remove(key)
                self.expected_keys.discard(key)
                removed += 1
        self.deployed = keep
        self.sn.cleanup()
        return {"removed_snapshots": removed, "removed_pods": count}

    def _gc_all(self, watermark_bytes: int) -> list:
        removed = []
        for name in sorted(os.listdir(self.workdir)):
            if "-pod" not in name:
                continue
            mgr = CacheManager(os.path.join(self.workdir, name))
            if watermark_bytes > 0:
                removed += mgr.gc_watermark(watermark_bytes)
            else:
                removed += mgr.gc_once(0.0)
        return removed

    def _phase_gc(self, idx: int, phase: PhaseSpec) -> dict:
        removed = self._gc_all(phase.watermark_mib << 20)
        return {"evicted_files": len(removed)}

    # -- the run -------------------------------------------------------------

    def _start_judge(self) -> None:
        from nydus_snapshotter_tpu_torch.metrics.slo import SloEngine, SloObjective

        budget = self.spec.slo
        self._engine = SloEngine([
            SloObjective(
                name=f"{self.spec.name}-demand",
                metric="ntpu_blobcache_op_duration_milliseconds",
                labels={"op": SLO_OP},
                threshold_ms=budget.demand_threshold_ms,
                target=budget.target,
                window_secs=budget.window_secs,
                long_window_factor=2.0,
                burn_threshold=budget.burn_threshold,
            )
        ])

        def judge():
            while not self._engine_stop.wait(0.05):
                self._engine.tick()

        self._engine_thread = threading.Thread(
            target=judge, name="ntpu-scn-judge", daemon=True
        )
        self._engine_thread.start()

    def _stop_judge(self) -> None:
        if self._engine_thread is not None:
            self._engine_stop.set()
            self._engine_thread.join()
            self._engine_thread = None
            self._engine.tick()

    def run(self) -> dict:
        report = {
            "scenario": self.spec.name,
            "serial": self.serial,
            "seed": self.spec.seed,
            "phases": [],
            "ok": True,
            "error": "",
        }
        self._open_control_plane()
        if any(p.op == "deploy" for p in self.spec.phases):
            self._start_judge()
        dispatch = {
            "convert": self._phase_convert,
            "deploy": self._phase_deploy,
            "remove": self._phase_remove,
            "gc": self._phase_gc,
            "crash_restart": lambda i, p: (self._crash_restart() or
                                           {"crashes": self.crashes}),
        }
        try:
            for i, phase in enumerate(self.spec.phases):
                armed = []
                if self.arm_faults:
                    for f in self.spec.faults:
                        if f.phase == i:
                            failpoint.inject(f.site, f.action)
                            scenario.FAULTS_ARMED.inc()
                            armed.append(f.site)
                t0 = time.perf_counter()
                try:
                    failpoint.hit("scenario.phase")
                    detail = dispatch[phase.op](i, phase)
                finally:
                    for site in armed:
                        failpoint.clear(site)
                scenario.PHASES_TOTAL.labels(phase.op).inc()
                report["phases"].append({
                    "op": phase.op,
                    "wall_s": round(time.perf_counter() - t0, 4),
                    "faults": armed,
                    **detail,
                })
        except BaseException as e:  # noqa: BLE001 — the run fails loudly
            report["ok"] = False
            report["error"] = (
                f"phase {len(report['phases'])} "
                f"({self.spec.phases[len(report['phases'])].op}): {e!r}"
            )
        finally:
            self._stop_judge()
        if self._engine is not None:
            status = self._engine.status()
            breaches = status.get("breaches", [])
            report["slo"] = {
                "breaches": len(breaches),
                "objectives": [
                    {k: o.get(k) for k in
                     ("objective", "compliance_short", "burn_short",
                      "burn_long", "breached")}
                    for o in status.get("objectives", [])
                ],
                "demand_p95_ms": self.demand_p95_ms(),
            }
            if breaches and report["ok"]:
                report["ok"] = False
                report["error"] = (
                    f"SLO judge: {len(breaches)} multi-window burn breach(es) "
                    "— demand latency out of budget"
                )
        report["origin"] = {
            "egress_bytes": self.registry.egress,
            "calls": self.registry.calls,
        }
        report["soci_outcomes"] = self.soci_outcomes
        scenario.RUNS_TOTAL.labels("pass" if report["ok"] else "fail").inc()
        return report

    def demand_p95_ms(self) -> float:
        with self._demand_mu:
            xs = sorted(self.demand_ms)
        return round(xs[int(len(xs) * 0.95)], 3) if xs else 0.0

    # -- identity + audit ----------------------------------------------------

    def fingerprint(self) -> dict:
        """The serial-replay identity surface: id-normalized metastore
        dump, per-pod demand-read digests, per-corpus blob ids."""
        return {
            "metastore": self.sn.ms.dump() if self.sn is not None else "",
            "reads": dict(sorted(self.read_digests.items())),
            "blobs": {
                cid: img["blob_id"] for cid, img in sorted(self.images.items())
            },
        }

    def audit(self) -> dict:
        """End-state audit: no leaked snapshot rows, no orphan snapshot
        dirs, no unaccounted cache entries (blob + companions must map to
        a registered blob id), no staging leftovers."""
        issues = []
        rows = []
        if self.sn is not None:
            self.sn.walk(lambda sid, info: rows.append(info.name))
            leaked = set(rows) - self.expected_keys
            missing = self.expected_keys - set(rows)
            for k in sorted(leaked):
                issues.append(f"leaked snapshot row {k!r}")
            for k in sorted(missing):
                issues.append(f"expected snapshot row {k!r} missing")
            snap_dir = os.path.join(self._snap_root(), "snapshots")
            ids = set(self.sn.ms.id_map())
            try:
                names = sorted(os.listdir(snap_dir))
            except OSError:
                names = []
            for name in names:
                if name == "metadata.db" or name.startswith("metadata.db"):
                    continue
                if name.startswith("new-") or name.startswith("rm-"):
                    issues.append(f"staging leftover {name!r} in snapshots dir")
                elif name not in ids:
                    issues.append(f"orphan snapshot dir {name!r}")
        known = self.registry.blob_ids()
        cache_files = 0
        for name in sorted(os.listdir(self.workdir)):
            if "-pod" not in name:
                continue
            pod_dir = os.path.join(self.workdir, name)
            for fn in sorted(os.listdir(pod_dir)):
                cache_files += 1
                bid = CacheManager._entry_id(fn)
                if bid not in known:
                    issues.append(f"unaccounted cache entry {name}/{fn}")
        return {
            "clean": not issues,
            "issues": issues,
            "metastore_rows": len(rows),
            "cache_files": cache_files,
        }

    def close(self) -> None:
        if self._grpc is not None:
            self._grpc.close()
            self._grpc = None
        if self.sn is not None:
            self.sn.close()
            self.sn = None


def run_scenario(
    spec: ScenarioSpec,
    workdir: Optional[str] = None,
    serial: bool = False,
    pods: Optional[int] = None,
    device: "str | torch.device | None" = None,
) -> tuple[dict, dict, dict]:
    """One-shot convenience: run a spec in a (temp) workdir; returns
    ``(report, fingerprint, audit)``. ``device`` as for
    :class:`ScenarioRunner`."""
    import tempfile

    own = workdir is None
    if own:
        workdir = tempfile.mkdtemp(prefix="ntpu-scenario-")
    runner = ScenarioRunner(spec, workdir, serial=serial, pods=pods, device=device)
    try:
        report = runner.run()
        return report, runner.fingerprint(), runner.audit()
    finally:
        runner.close()
        if own:
            shutil.rmtree(workdir, ignore_errors=True)
