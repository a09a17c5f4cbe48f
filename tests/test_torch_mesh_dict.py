"""The PyTorch port's multi-shard chunk dict against the JAX package's.

Mirrors the mesh cases of tests/test_sharded_dict.py at 2, 4 and 8 shards:
both packages build, grow, save and load from the same numpy-seeded
digests, the reference on its virtual CPU mesh with its native host arms,
the port on a mesh of repeated ``cpu`` devices, where kernel K3's plain
version answers every shard's probe. Tables and files are held byte for
byte, answers exactly.
"""

import numpy as np
import pytest

from nydus_snapshotter_tpu.parallel import dict_service as jds
from nydus_snapshotter_tpu.parallel import mesh as jmesh
from nydus_snapshotter_tpu.parallel.sharded_dict import DictBuildError as JDictBuildError
from nydus_snapshotter_tpu.parallel.sharded_dict import DictEpochError as JDictEpochError
from nydus_snapshotter_tpu.parallel.sharded_dict import ShardedChunkDict as JDict
from nydus_snapshotter_tpu_torch import entry
from nydus_snapshotter_tpu_torch.parallel import dict_service as pds
from nydus_snapshotter_tpu_torch.parallel import mesh as pmesh
from nydus_snapshotter_tpu_torch.parallel.sharded_dict import (
    DictBuildError,
    DictEpochError,
    ShardedChunkDict,
)

SHARDS = [2, 4, 8]


def _digests(seed: int, n: int) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, 2**32, (n, 8), dtype=np.uint32)


def _mesh(n: int) -> pmesh.Mesh:
    return pmesh.make_mesh(n, devices=["cpu"] * n)


def _port(digests, n, **kw):
    return ShardedChunkDict(digests, _mesh(n), **kw)


def _ref(digests, n, **kw):
    kw.setdefault("probe_backend", "host")
    return JDict(digests, jmesh.make_mesh(n), **kw)


def _same_tables(pd: ShardedChunkDict, jd: JDict) -> None:
    assert pd.n_shards == jd.n_shards and pd.capacity == jd.capacity
    assert np.array_equal(pd._keys, jd._host_keys)
    assert np.array_equal(pd._values, jd._host_values)
    assert (pd.max_depth, pd.epoch, pd.rebuild_epoch, pd.n_entries) == (
        jd.max_depth, jd.epoch, jd.rebuild_epoch, jd.n_entries
    )
    assert pd._ensure_unique_count() == jd._ensure_unique_count()


@pytest.mark.parametrize("n", SHARDS)
class TestBuildAndProbe:
    def test_tables_and_lookups(self, n):
        d = _digests(10 + n, 10_000)
        d[9990:] = d[:10]  # duplicates: first insertion wins
        pd, jd = _port(d, n), _ref(d, n)
        _same_tables(pd, jd)
        rng = np.random.default_rng(n)
        idx = rng.integers(0, 9990, 700)
        assert np.array_equal(pd.lookup_u32(d[idx]), idx)
        misses = _digests(20 + n, 300)
        assert (pd.lookup_u32(misses) == -1).all()
        # 13 rows: not a multiple of the shard count, padded with zero rows
        q = np.concatenate([d[:7], _digests(30 + n, 6)])
        assert np.array_equal(pd.lookup_u32(q), jd.lookup_u32(q))
        assert np.array_equal(pd.lookup_u32(d[9990:]), np.arange(10))
        raw = [d[i].astype("<u4").tobytes() for i in (3, 9, 4242)]
        assert list(pd.lookup_digests(raw)) == [3, 9, 4242]

    def test_empty_dict_and_empty_query(self, n):
        pd, jd = _port(np.zeros((0, 8), np.uint32), n), _ref(np.zeros((0, 8), np.uint32), n)
        _same_tables(pd, jd)
        assert (pd.lookup_u32(_digests(40, 5)) == -1).all()
        assert pd.lookup_u32(np.zeros((0, 8), np.uint32)).size == 0

    def test_skewed_shard_load(self, n):
        """Every digest on one shard: the table grows to the fullest shard,
        chains stay within bounds, lookups stay exact."""
        d = _digests(50 + n, 2000)
        d[:, 0] = (d[:, 0] // n) * n
        pd, jd = _port(d, n), _ref(d, n)
        _same_tables(pd, jd)
        assert np.array_equal(pd.lookup_u32(d[::17]), np.arange(2000)[::17])

    def test_duplicate_heavy_queries(self, n):
        """Deduped before routing, or the buckets of one shard overflow."""
        d = _digests(60 + n, 3000)
        pd = _port(d, n)
        assert (pd.lookup_u32(np.tile(d[7], (5000, 1))) == 7).all()

    def test_fused_surfaces_refuse(self, n):
        d = _digests(70 + n, 100)
        pd, jd = _port(d, n), _ref(d, n)
        with pytest.raises(JDictBuildError):
            jd.fused_probe_tables()
        with pytest.raises(DictBuildError):
            pd.fused_probe_tables()
        with pytest.raises(DictBuildError):
            pd.device_snapshot()
        shards, cap, depth = pd.device_shards()
        assert len(shards) == n and cap == pd.capacity and depth == pd.max_depth
        assert pd.restages == 1


@pytest.mark.parametrize("n", SHARDS)
class TestGrowth:
    def test_insert_rebuild_and_journal(self, n):
        base = _digests(80 + n, 4000)
        pd, jd = _port(base, n), _ref(base, n)
        small = np.concatenate([_digests(81, 300), base[:5]])
        assert np.array_equal(pd.insert_u32(small), jd.insert_u32(small))
        _same_tables(pd, jd)
        # past the load factor: a value-preserving rebuild on both sides
        big = np.concatenate([_digests(82, 12_000), small[:3], base[10:12]])
        assert np.array_equal(pd.insert_u32(big), jd.insert_u32(big))
        _same_tables(pd, jd)
        assert pd.rebuild_epoch == jd.rebuild_epoch == 2
        after = _digests(83, 200)
        assert np.array_equal(pd.insert_u32(after), jd.insert_u32(after))
        _same_tables(pd, jd)
        for since in (2, 3):
            pdig, pval, pep = pd.entries_since(since)
            jdig, jval, jep = jd.entries_since(since)
            assert np.array_equal(pdig, jdig) and np.array_equal(pval, jval) and pep == jep
        with pytest.raises(DictEpochError):
            pd.entries_since(1)
        with pytest.raises(JDictEpochError):
            jd.entries_since(1)
        q = np.concatenate([base[::9], small, big[::13], after, _digests(84, 100)])
        assert np.array_equal(pd.lookup_u32(q), jd.lookup_u32(q))
        first = len(base) + len(small) + len(big)
        assert np.array_equal(pd.lookup_u32(after), np.arange(first, first + 200))

    def test_copy_keeps_mesh_and_state(self, n):
        pd = _port(_digests(85 + n, 1000), n)
        pd.insert_u32(_digests(86, 50))
        c = pd.copy()
        assert c.mesh is pd.mesh and c.n_shards == n
        assert np.array_equal(c._keys, pd._keys) and c.epoch == pd.epoch
        c.insert_u32(_digests(87, 10))
        assert c.epoch == pd.epoch + 1


@pytest.mark.parametrize("n", SHARDS)
class TestFiles:
    def test_save_and_save_incremental_bytes(self, n, tmp_path):
        base = _digests(90 + n, 3000)
        pd, jd = _port(base, n), _ref(base, n)
        pp, jp = str(tmp_path / "p.dict"), str(tmp_path / "j.dict")
        pd.save(pp)
        jd.save(jp)
        assert open(pp, "rb").read() == open(jp, "rb").read()
        b = _digests(91, 400)
        pd.insert_u32(b)
        jd.insert_u32(b)
        assert pd.save_incremental(pp) == jd.save_incremental(jp) == {"mode": "append", "appended": 400}
        assert open(pp, "rb").read() == open(jp, "rb").read()
        big = _digests(92, 12_000)  # forces a rebuild: the next save compacts
        pd.insert_u32(big)
        jd.insert_u32(big)
        res = pd.save_incremental(pp)
        assert res == jd.save_incremental(jp) and res["mode"] == "full"
        assert open(pp, "rb").read() == open(jp, "rb").read()
        # nothing new since: an empty append on both
        assert pd.save_incremental(pp) == jd.save_incremental(jp) == {"mode": "append", "appended": 0}
        assert open(pp, "rb").read() == open(jp, "rb").read()

    @pytest.mark.parametrize("to", ["same", 1, "other"])
    def test_cross_load_both_ways(self, n, to, tmp_path):
        m = n if to == "same" else to if to == 1 else {2: 4, 4: 8, 8: 2}[n]
        base = _digests(100 + n, 3000)
        b = _digests(101, 300)
        q = np.concatenate([base[::7], b, _digests(102, 100)])
        # files with a tail: saved, grown, appended
        pd, jd = _port(base, n), _ref(base, n)
        pp, jp = str(tmp_path / "p.dict"), str(tmp_path / "j.dict")
        for d, path in ((pd, pp), (jd, jp)):
            d.save(path)
            d.insert_u32(b)
            assert d.save_incremental(path)["mode"] == "append"
        # a reference file into the port, a port file into the reference,
        # each against the other package loading the same file
        pl = ShardedChunkDict.load(jp, _mesh(m))
        jl = JDict.load(jp, jmesh.make_mesh(m), probe_backend="host")
        _same_tables(pl, jl)
        assert np.array_equal(pl.lookup_u32(q), jd.lookup_u32(q))
        jl2 = JDict.load(pp, jmesh.make_mesh(m), probe_backend="host")
        pl2 = ShardedChunkDict.load(pp, _mesh(m))
        _same_tables(pl2, jl2)
        assert np.array_equal(jl2.lookup_u32(q), pd.lookup_u32(q))
        # growth after a cross load stays in step
        c = _digests(103, 200)
        assert np.array_equal(pl.insert_u32(c), jl.insert_u32(c))
        _same_tables(pl, jl)

    def test_load_takes_a_mesh_or_a_device(self, n, tmp_path):
        path = str(tmp_path / "d.dict")
        _port(_digests(110 + n, 500), n).save(path)
        one = ShardedChunkDict.load(path, device="cpu")
        assert one.n_shards == 1
        with pytest.raises(ValueError):
            ShardedChunkDict.load(path, _mesh(n), device="cpu")
        with pytest.raises(ValueError):
            ShardedChunkDict(_digests(111, 10), _mesh(n), device="cpu")


def test_dict_service_on_a_four_shard_mesh():
    """A service namespace indexed on 4 shards merges and probes as the
    reference's on its 4-device mesh."""
    rng = np.random.default_rng(120)
    psvc = pds.DictService(mesh=_mesh(4))
    jsvc = jds.DictService(mesh=jmesh.make_mesh(4))
    digests = [rng.integers(0, 256, 32, dtype=np.uint8).tobytes() for _ in range(3000)]
    for lo, hi in ((0, 1800), (1200, 3000)):
        files = [bytes(100 * (hi - lo))]
        boot = entry._emit_bootstrap(files, [np.arange(1, hi - lo + 1) * 100], [digests[lo:hi]])
        p_stats = psvc.dict_for("ns").merge_bootstrap_bytes(boot)
        j_stats = jsvc.dict_for("ns").merge_bootstrap_bytes(boot)
        assert p_stats == j_stats
    assert psvc.dict_for("ns").index.n_shards == 4
    q = b"".join(digests[::7]) + rng.integers(0, 256, 32 * 50, dtype=np.uint8).tobytes()
    got = psvc.dict_for("ns").probe(q)
    assert np.array_equal(got, jsvc.dict_for("ns").probe(q))
    assert np.array_equal(got[: len(digests[::7])], np.arange(0, 3000, 7))
    with pytest.raises(ValueError):
        pds.DictService(mesh=_mesh(2), device="cpu")
