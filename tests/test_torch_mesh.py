"""The PyTorch port's device mesh and mesh probes against the JAX package's.

The reference runs on its virtual 8-device CPU mesh (tests/conftest.py),
the port on a mesh of repeated ``cpu`` devices, where kernel K3's plain
version answers every shard's probe. Both build their dicts from the same
numpy-seeded digests; answers and overflow flags are integers and
booleans: equality is exact.
"""

import types

import jax
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec

from nydus_snapshotter_tpu.config import config as jcfg
from nydus_snapshotter_tpu.parallel import mesh as jmesh
from nydus_snapshotter_tpu.parallel import sharded_dict as jsd
from nydus_snapshotter_tpu_torch.config import config as tcfg
from nydus_snapshotter_tpu_torch.parallel import mesh as pmesh
from nydus_snapshotter_tpu_torch.parallel import sharded_dict as psd

SHARDS = [1, 2, 4, 5, 8]


def _digests(seed: int, n: int) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, 2**32, (n, 8), dtype=np.uint32)


def _cpu_mesh(n: int) -> pmesh.Mesh:
    return pmesh.make_mesh(n, devices=["cpu"] * n)


def _pad(q: np.ndarray, n: int) -> np.ndarray:
    pad = (-len(q)) % n
    return np.concatenate([q, np.zeros((pad, 8), np.uint32)]) if pad else q


def _skewed(dict_digests: np.ndarray, n: int, seed: int) -> np.ndarray:
    """dryrun_multichip's phase-2 queries: 384 digests whose word 0 is a
    multiple of n (hits first, then misses), all owned by shard 0."""
    hits = dict_digests[dict_digests[:, 0] % np.uint32(n) == 0][:192]
    misses = _digests(seed, 384 - len(hits))
    misses[:, 0] -= misses[:, 0] % np.uint32(n)
    return np.concatenate([hits, misses])


@pytest.fixture
def _clean_mesh_config(monkeypatch):
    for k in ("NTPU_MESH_PACK", "NTPU_MESH_DEVICES", "NTPU_MESH_HALO_KIB"):
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setattr(tcfg, "_global", None)
    monkeypatch.setattr(jcfg, "_global", None)


class TestMakeMesh:
    def test_explicit_devices_and_width(self, _clean_mesh_config):
        m = pmesh.make_mesh(devices=["cpu"] * 8)
        assert m.size == 8 == len(jmesh.make_mesh().devices.reshape(-1))
        assert m.shape == {pmesh.AXIS_DATA: 8}
        assert int(np.prod(list(m.shape.values()))) == 8
        assert pmesh.make_mesh(3, devices=["cpu"] * 8).size == 3 == jmesh.make_mesh(3).size
        with pytest.raises(ValueError):
            pmesh.make_mesh(9, devices=["cpu"] * 8)
        with pytest.raises(ValueError):
            jmesh.make_mesh(9)

    def test_env_caps_the_default_width(self, _clean_mesh_config, monkeypatch):
        monkeypatch.setenv("NTPU_MESH_DEVICES", "3")
        assert pmesh.make_mesh(devices=["cpu"] * 8).size == 3 == jmesh.make_mesh().size
        # an explicit width is not capped
        assert pmesh.make_mesh(5, devices=["cpu"] * 8).size == 5 == jmesh.make_mesh(5).size

    def test_config_caps_the_default_width(self, _clean_mesh_config, monkeypatch):
        cfg = types.SimpleNamespace(mesh=types.SimpleNamespace(pack="extent", devices=2, halo_kib=0))
        monkeypatch.setattr(tcfg, "_global", cfg)
        monkeypatch.setattr(jcfg, "_global", cfg)
        assert pmesh.make_mesh(devices=["cpu"] * 8).size == 2 == jmesh.make_mesh().size
        monkeypatch.setenv("NTPU_MESH_DEVICES", "6")  # env wins over the section
        assert pmesh.make_mesh(devices=["cpu"] * 8).size == 6 == jmesh.make_mesh().size

    def test_needs_cuda_without_devices(self):
        if torch.cuda.is_available():
            return  # only meaningful on a host without CUDA, such as CI
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            pmesh.make_mesh()
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            pmesh.make_mesh(1)


class TestCollectives:
    @pytest.mark.parametrize("n", SHARDS)
    def test_against_numpy(self, n):
        mesh = _cpu_mesh(n)
        rng = np.random.default_rng(n)
        a = rng.integers(-(2**31), 2**31, (2 * n * n, 9), dtype=np.int64).astype(np.int32)
        parts = pmesh.shard_rows(a, mesh)
        assert [p.device for p in parts] == list(mesh.devices)
        assert all(np.array_equal(p.numpy(), x) for p, x in zip(parts, np.split(a, n)))
        # copies, never views of the caller's array
        parts[0].fill_(0)
        assert a.any()
        rep = pmesh.replicate(a, mesh)
        assert len(rep) == n and all(np.array_equal(r.numpy(), a) for r in rep)
        parts = pmesh.shard_rows(a, mesh)
        gathered = pmesh.all_gather(parts, mesh)
        assert len(gathered) == n and all(np.array_equal(g.numpy(), a) for g in gathered)
        swapped = pmesh.all_to_all(parts, mesh)
        want = [
            np.concatenate([np.split(np.split(a, n)[i], n)[j] for i in range(n)]) for j in range(n)
        ]
        assert all(np.array_equal(s.numpy(), w) for s, w in zip(swapped, want))
        # all_to_all is its own inverse
        back = pmesh.all_to_all(swapped, mesh)
        assert all(np.array_equal(b.numpy(), x) for b, x in zip(back, np.split(a, n)))
        total = pmesh.sum_shards([p.to(torch.int64) for p in parts])
        assert np.array_equal(total.numpy(), sum(np.split(a.astype(np.int64), n)))

    def test_uneven_split_raises(self):
        mesh = _cpu_mesh(4)
        with pytest.raises(ValueError):
            pmesh.shard_rows(np.zeros((6, 8), np.int32), mesh)
        with pytest.raises(ValueError):
            pmesh.all_to_all([torch.zeros((3, 2))] * 4, mesh)


def _pair(n: int, digests: np.ndarray, **kw):
    pd = psd.ShardedChunkDict(digests, _cpu_mesh(n), **kw)
    jd = jsd.ShardedChunkDict(digests, jmesh.make_mesh(n), probe_backend="host")
    assert np.array_equal(pd._keys, jd._host_keys) and np.array_equal(pd._values, jd._host_values)
    assert pd.max_depth == jd.max_depth and pd.n_shards == jd.n_shards == n
    return pd, jd


def _both_probes(pd, jd, q: np.ndarray):
    """(port routed answers, port overflow, port dense) and the reference's."""
    n = pd.n_shards
    shards, cap, depth = pd.device_shards()
    keys, values = [k for k, _ in shards], [v for _, v in shards]
    qp = pmesh.shard_rows(q.view(np.int32), pd.mesh)
    p_routed, p_over = psd._probe_routed(keys, values, qp, n, pd.mesh, depth, cap)
    p_dense = psd._probe_sharded(keys, values, qp, n, pd.mesh, depth, cap)
    qj = jax.device_put(q, NamedSharding(jd.mesh, PartitionSpec(jmesh.AXIS_DATA)))
    dk, dv = jd._device_tables()
    j_routed, j_over = jsd._probe_routed(dk, dv, qj, n, jd.mesh)
    j_dense = jsd._probe_sharded(dk, dv, qj, n, jd.mesh)
    return (
        (p_routed.numpy(), p_over.numpy(), p_dense.numpy()),
        (np.asarray(j_routed), np.asarray(j_over), np.asarray(j_dense)),
    )


@pytest.mark.parametrize("n", SHARDS)
class TestMeshProbes:
    def test_uniform_queries(self, n):
        d = _digests(100 + n, 6000)
        pd, jd = _pair(n, d)
        q = _pad(np.concatenate([d[::29], _digests(200 + n, 150)]), n)
        (pr, po, pdn), (jr, jo, jdn) = _both_probes(pd, jd, q)
        assert np.array_equal(pr, jr) and np.array_equal(pdn, jdn) and np.array_equal(po, jo)
        assert not po.any()
        assert np.array_equal(pr, pdn)
        assert np.array_equal(pr[: len(d[::29])] - 1, np.arange(0, 6000, 29))

    def test_forced_overflow_queries(self, n):
        """dryrun_multichip's skew: every query owned by shard 0. All-to-one
        skew overflows the 4x+8 buckets only at n >= 5; the flags must be
        the reference's in every case, the dense answers always exact."""
        d = _digests(300 + n, 1 << 14)
        pd, jd = _pair(n, d)
        q = _pad(_skewed(d, n, 400 + n), n)
        (pr, po, pdn), (jr, jo, jdn) = _both_probes(pd, jd, q)
        assert np.array_equal(po, jo)
        assert bool(po.any()) == (n >= 5)
        assert np.array_equal(pr, jr) and np.array_equal(pdn, jdn)
        truth = jd.lookup_u32(q)
        assert np.array_equal(pdn.astype(np.int64) - 1, truth)

    def test_zero_padding_rows_count_against_shard_zero(self, n):
        """Zero rows pad the queries to the mesh; they hash to shard 0 and
        take slots of its buckets, as the reference's do."""
        d = _digests(500 + n, 4000)
        pd, jd = _pair(n, d)
        q = np.concatenate([d[:3], np.zeros((8 * n - 3, 8), np.uint32)])
        (pr, po, pdn), (jr, jo, jdn) = _both_probes(pd, jd, q)
        assert np.array_equal(po, jo) and np.array_equal(pr, jr) and np.array_equal(pdn, jdn)

    @pytest.mark.parametrize("backend", ["auto", "device", "pallas", "host"])
    def test_lookup_every_backend(self, n, backend):
        d = _digests(600 + n, 5000)
        d[4000:4010] = d[:10]  # duplicates: first insertion wins
        pd, jd = _pair(n, d, probe_backend=backend)
        jb = jsd.ShardedChunkDict(d, jmesh.make_mesh(n), probe_backend="pallas" if backend == "pallas" else "device")
        q = np.concatenate([
            d[::7], d[[4000, 4005, 7, 7, 7]], _digests(700 + n, 77),
            _skewed(d, n, 800 + n)[:50], np.zeros((2, 8), np.uint32),
        ])
        got = pd.lookup_u32(q)
        want = jd.lookup_u32(q)
        assert np.array_equal(got, want)
        if backend != "host":
            assert np.array_equal(got, jb.lookup_u32(q))
        idx = np.arange(0, 5000, 7)
        assert np.array_equal(got[: len(idx)], np.where((idx >= 4000) & (idx < 4010), idx - 4000, idx))

    def test_skewed_lookup_falls_back_dense(self, n):
        d = _digests(900 + n, 1 << 14)
        pd = psd.ShardedChunkDict(d, _cpu_mesh(n), probe_backend="device")
        jd = jsd.ShardedChunkDict(d, jmesh.make_mesh(n), probe_backend="host")
        q = _skewed(d, n, 1000 + n)
        assert np.array_equal(pd.lookup_u32(q), jd.lookup_u32(q))
