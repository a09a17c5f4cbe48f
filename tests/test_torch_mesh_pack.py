"""The PyTorch port's extent-packed convert sharding against the JAX package's.

Mirrors tests/test_mesh_pack.py case by case (ops/mesh_pack and
``sharded_convert_step``): repartitioning pass 2 onto per-shard byte
shards plus the read-span halo changes where bytes live and nothing else.
Every case also holds the port against the reference on the same files:
the planner's geometry, and the sharded step's cuts, digests, bootstrap
bytes and report (the per-shard byte map by value: its keys name each
package's devices). The reference runs on its virtual CPU mesh, the port
on a mesh of repeated ``cpu`` devices (the plain versions of K1 and K2).
"""

import os
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import __graft_entry__ as graft  # noqa: E402
from nydus_snapshotter_tpu.ops import fused_convert as jfc  # noqa: E402
from nydus_snapshotter_tpu.ops import mesh_pack as jmp  # noqa: E402
from nydus_snapshotter_tpu.ops.chunker import ChunkDigestEngine as JEngine  # noqa: E402
from nydus_snapshotter_tpu.parallel import mesh as jmesh  # noqa: E402
from nydus_snapshotter_tpu_torch import entry  # noqa: E402
from nydus_snapshotter_tpu_torch.ops import fused_convert, mesh_pack  # noqa: E402
from nydus_snapshotter_tpu_torch.parallel import mesh as pmesh  # noqa: E402

CHUNK = 0x1000


def _mk_files(seed: int, n: int, scale: int = 8192) -> list[bytes]:
    rng = np.random.default_rng(seed)
    return [
        rng.integers(
            0, 256, int(rng.integers(1, 5)) * scale + int(rng.integers(0, 997)),
            dtype=np.uint8,
        ).tobytes()
        for _ in range(n)
    ]


def _oracle(files):
    eng = JEngine(chunk_size=CHUNK, backend="numpy", digest_backend="numpy")
    truth = eng.process_many(files)
    cuts = [np.asarray([m.offset + m.size for m in metas], dtype=np.int64) for metas in truth]
    digs = [[m.digest for m in metas] for metas in truth]
    return cuts, digs


def _mesh(n: int) -> pmesh.Mesh:
    return pmesh.make_mesh(n, devices=["cpu"] * n)


def _same_plan(a, b) -> None:
    assert (a.n_devices, a.total_bytes, a.shard_bytes, a.halo_bytes, a.pack_len, a.order) == (
        b.n_devices, b.total_bytes, b.shard_bytes, b.halo_bytes, b.pack_len, b.order
    )
    assert len(a.buckets) == len(b.buckets)
    for x, y in zip(a.buckets, b.buckets):
        assert (x.cap_blocks, x.rows_per_device, x.counts) == (y.cap_blocks, y.rows_per_device, y.counts)
        for f in ("offsets_local", "offsets_abs", "sizes"):
            assert np.array_equal(getattr(x, f), getattr(y, f))


def _plan_for(files, n_devices, chunk=CHUNK):
    """The port's plan over the port engine's buckets, held equal to the
    reference planner over the reference engine's."""
    eng = fused_convert.FusedDeviceEngine(chunk_size=chunk, device="cpu")
    jeng = jfc.FusedDeviceEngine(chunk_size=chunk)
    table = []
    total = 0
    for f in files:
        table.append((total, len(f)))
        total += len(f)
    cuts, _ = _oracle(files)
    buckets, order = eng.plan_buckets(table, cuts)
    plan = mesh_pack.plan_mesh_pack(buckets, order, total, n_devices, halo_bytes=eng.max_read_span())
    jbuckets, jorder = jeng.plan_buckets(table, cuts)
    jplan = jmp.plan_mesh_pack(jbuckets, jorder, total, n_devices, halo_bytes=jeng.max_read_span())
    _same_plan(plan, jplan)
    return plan, buckets, order, total


def _ref_step(files, n, pack=None, report=None):
    return graft.sharded_convert_step(files, CHUNK, n, jmesh.make_mesh(n), pack=pack, report=report)


def _same_report(rep: dict, jrep: dict) -> None:
    assert rep.keys() == jrep.keys()
    for k in rep:
        if k == "addressable_bytes_per_device":
            assert list(rep[k].values()) == list(jrep[k].values())
        else:
            assert rep[k] == jrep[k], k


class TestPlanner:
    """Host-side geometry: pure numpy, no mesh involved."""

    def test_local_offsets_and_devices(self):
        files = _mk_files(1, 6)
        n = 4
        plan, buckets, order, total = _plan_for(files, n)
        assert plan.shard_bytes == -(-total // n)
        assert plan.pack_len == plan.shard_bytes + plan.halo_bytes
        for b, sb in zip(buckets, plan.buckets):
            assert sum(sb.counts) == b.count
            for d in range(n):
                lo = d * sb.rows_per_device
                for i in range(sb.counts[d]):
                    row = lo + i
                    off = int(sb.offsets_abs[row])
                    assert plan.device_of(off) == d
                    assert sb.offsets_local[row] == off - d * plan.shard_bytes
                    # the no-clamp invariant: every read fits the slab
                    assert sb.offsets_local[row] + sb.cap_blocks * 64 <= plan.pack_len

    def test_order_covers_every_chunk_once(self):
        files = _mk_files(2, 5)
        n = 8
        plan, buckets, _order, _total = _plan_for(files, n)
        n_chunks = sum(b.count for b in buckets)
        assert len(plan.order) == n_chunks
        seen = set()
        for cap, row in plan.order:
            assert (cap, row) not in seen
            seen.add((cap, row))
            sb = next(b for b in plan.buckets if b.cap_blocks == cap)
            d, i = divmod(row, sb.rows_per_device)
            assert i < sb.counts[d], "order points at a padding row"

    def test_pack_buffers_shard_plus_halo(self):
        files = _mk_files(3, 4)
        n = 4
        plan, _b, _o, total = _plan_for(files, n)
        buf = np.frombuffer(b"".join(files), dtype=np.uint8)
        packed = mesh_pack.pack_buffers(buf, plan)
        assert np.array_equal(packed, jmp.pack_buffers(buf, plan))
        assert packed.shape == (n, plan.pack_len)
        S = plan.shard_bytes
        for d in range(n):
            lo = d * S
            hi = min(lo + plan.pack_len, total)
            assert (packed[d, : hi - lo] == buf[lo:hi]).all()
            assert (packed[d, hi - lo :] == 0).all()

    def test_chunk_spanning_shard_cut_stays_whole(self):
        """A chunk whose bytes straddle k*S is readable entirely from shard
        k's slab: the halo rule."""
        files = _mk_files(4, 6)
        n = 4
        plan, buckets, _o, _total = _plan_for(files, n)
        S = plan.shard_bytes
        straddlers = 0
        for b in buckets:
            for off, size in zip(b.offsets[: b.count], b.sizes[: b.count]):
                d = plan.device_of(int(off))
                if int(off) + int(size) > (d + 1) * S:
                    straddlers += 1
                    assert int(off) - d * S + b.cap_blocks * 64 <= plan.pack_len
        assert straddlers > 0, "corpus produced no shard-cut straddler; enlarge it"

    def test_unordered_bucket_rejected(self):
        for fc, mp in ((fused_convert, mesh_pack), (jfc, jmp)):
            b = fc.Bucket(
                cap_blocks=2,
                offsets=np.asarray([500, 100], np.int32),
                sizes=np.asarray([64, 64], np.int32),
                count=2,
            )
            with pytest.raises(ValueError, match="offset-ordered"):
                mp.plan_mesh_pack([b], [(2, 0), (2, 1)], 600, 2)

    def test_more_devices_than_bytes(self):
        plans = []
        for fc, mp in ((fused_convert, mesh_pack), (jfc, jmp)):
            b = fc.Bucket(
                cap_blocks=1,
                offsets=np.asarray([0, 2], np.int32),
                sizes=np.asarray([2, 3], np.int32),
                count=2,
            )
            plans.append(mp.plan_mesh_pack([b], [(1, 0), (1, 1)], 5, 8))
        plan = plans[0]
        _same_plan(plan, plans[1])
        assert plan.shard_bytes == 1
        assert [plan.device_of(0), plan.device_of(2)] == [0, 2]
        assert sum(plan.buckets[0].counts) == 2


@pytest.mark.parametrize("n_devices", [1, 2, 4, 8])
class TestByteIdentity:
    """extent == replicated == host oracle == the reference, across mesh sizes."""

    def test_convert_identity_and_bytes_bound(self, n_devices):
        files = _mk_files(10 + n_devices, max(2, n_devices))
        mesh = _mesh(n_devices)
        cuts_t, digs_t = _oracle(files)
        boots = []
        for pack in ("extent", "replicated"):
            rep, jrep = {}, {}
            cuts, digs, boot = entry.sharded_convert_step(
                files, CHUNK, n_devices, mesh, pack=pack, report=rep
            )
            jcuts, jdigs, jboot = _ref_step(files, n_devices, pack=pack, report=jrep)
            for a, b, t in zip(cuts, jcuts, cuts_t):
                assert np.array_equal(a, t) and np.array_equal(b, t)
            assert digs == jdigs == digs_t
            assert boot == jboot
            _same_report(rep, jrep)
            assert len(rep["addressable_bytes_per_device"]) == n_devices
            boots.append(boot)
            if pack == "extent":
                # the no-replication gate
                assert rep["max_device_bytes"] <= rep["bound_bytes"]
                bound = rep["bound_bytes"]
            elif n_devices > 1:
                # and proof the gate detects replication
                assert rep["max_device_bytes"] > bound, (
                    "replicated arm should trip the addressable-bytes bound"
                )
        assert boots[0] == boots[1] == entry._emit_bootstrap(files, cuts_t, digs_t)


class TestEdgeCases:
    def test_empty_file_in_batch(self):
        files = [b"", _mk_files(20, 1)[0], b""]
        cuts, digs, boot = entry.sharded_convert_step(files, CHUNK, 2, _mesh(2), pack="extent")
        cuts_t, digs_t = _oracle(files)
        assert [len(c) for c in cuts] == [0, len(cuts_t[1]), 0]
        assert digs == digs_t
        assert boot == _ref_step(files, 2, pack="extent")[2]

    def test_all_empty_batch(self):
        rep, jrep = {}, {}
        cuts, digs, boot = entry.sharded_convert_step(
            [b"", b""], CHUNK, 2, _mesh(2), pack="extent", report=rep
        )
        assert digs == [[], []]
        assert isinstance(boot, bytes) and boot
        assert boot == _ref_step([b"", b""], 2, pack="extent", report=jrep)[2]
        assert rep == jrep

    def test_files_smaller_than_one_extent(self):
        # every file far below shard_bytes: chunks cluster on low shards, the
        # plan still covers all of them and stays byte-identical
        rng = np.random.default_rng(7)
        files = [
            rng.integers(0, 256, int(rng.integers(1100, 2500)), np.uint8).tobytes()
            for _ in range(5)
        ]
        rep, jrep = {}, {}
        cuts, digs, boot = entry.sharded_convert_step(
            files, CHUNK, 8, _mesh(8), pack="extent", report=rep
        )
        _cuts_t, digs_t = _oracle(files)
        assert digs == digs_t
        assert rep["max_device_bytes"] <= rep["bound_bytes"]
        assert boot == _ref_step(files, 8, pack="extent", report=jrep)[2]
        _same_report(rep, jrep)

    def test_env_pack_override(self, monkeypatch):
        monkeypatch.setenv("NTPU_MESH_PACK", "replicated")
        assert mesh_pack.resolve_mesh_config() == mesh_pack.MeshRuntimeConfig(
            pack="replicated", devices=0, halo_kib=0
        )
        assert jmp.resolve_mesh_config().pack == "replicated"
        files = _mk_files(30, 2)
        rep: dict = {}
        entry.sharded_convert_step(files, CHUNK, 2, _mesh(2), report=rep)
        assert rep["pack"] == "replicated"
        monkeypatch.setenv("NTPU_MESH_PACK", "extent")
        rep2: dict = {}
        entry.sharded_convert_step(files, CHUNK, 2, _mesh(2), report=rep2)
        assert rep2["pack"] == "extent"
        monkeypatch.setenv("NTPU_MESH_PACK", "bogus")  # an unknown value reads as the default
        assert mesh_pack.resolve_mesh_config().pack == jmp.resolve_mesh_config().pack == "extent"

    def test_env_halo_override(self, monkeypatch):
        monkeypatch.setenv("NTPU_MESH_HALO_KIB", "64")
        files = _mk_files(31, 2)
        rep, jrep = {}, {}
        cuts, digs, boot = entry.sharded_convert_step(
            files, CHUNK, 2, _mesh(2), pack="extent", report=rep
        )
        assert rep["halo_bytes"] >= 64 << 10
        _cuts_t, digs_t = _oracle(files)
        assert digs == digs_t
        assert boot == _ref_step(files, 2, pack="extent", report=jrep)[2]
        _same_report(rep, jrep)

    def test_mesh_size_must_match(self):
        with pytest.raises(ValueError):
            entry.sharded_convert_step(_mk_files(32, 1), CHUNK, 4, _mesh(2))
        with pytest.raises(ValueError):
            entry.sharded_convert_step(_mk_files(32, 1), CHUNK, 2, _mesh(2), pack="bogus")
