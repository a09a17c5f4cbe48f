"""The PyTorch port's chunk-dict service against the JAX package's.

Bootstraps come from the reference's ``BatchConverter`` (test side only).
The port's ``DictService`` runs with ``device="cpu"``: every probe RPC is one
``lookup_u32`` through kernel K3's plain version. Clients and services of
the two packages talk to each other over the same wire formats; answers,
record deltas and packs must be identical.
"""

import io
import tarfile

import numpy as np
import pytest

from nydus_snapshotter_tpu.converter.batch import BatchConverter
from nydus_snapshotter_tpu.converter.batch import GrowingChunkDict as JGrowingChunkDict
from nydus_snapshotter_tpu.converter.codec import TrainedDict
from nydus_snapshotter_tpu.converter.convert import pack_layer as j_pack_layer
from nydus_snapshotter_tpu.converter.types import PackOption as JPackOption
from nydus_snapshotter_tpu.models.bootstrap import Bootstrap as JBootstrap
from nydus_snapshotter_tpu.parallel import dict_service as jds
from nydus_snapshotter_tpu.parallel.sharded_dict import DictEpochError as JDictEpochError
from nydus_snapshotter_tpu.parallel.sharded_dict import ShardedChunkDict as JDict
from nydus_snapshotter_tpu_torch.converter import codec
from nydus_snapshotter_tpu_torch.converter import ConvertError, PackOption, pack_layer
from nydus_snapshotter_tpu_torch.converter.batch import GrowingChunkDict
from nydus_snapshotter_tpu_torch.models.bootstrap import Bootstrap, ChunkDict
from nydus_snapshotter_tpu_torch.ops import probe_cuda
from nydus_snapshotter_tpu_torch.parallel import dict_service as pds
from nydus_snapshotter_tpu_torch.parallel.sharded_dict import DictEpochError, ShardedChunkDict

RNG = np.random.default_rng(17)
POOL = [
    RNG.integers(0, 256, int(RNG.integers(4_000, 80_000)), dtype=np.uint8).tobytes()
    for _ in range(24)
]
OPT = JPackOption(chunk_size=0x10000, chunking="cdc")


def mk_image(seed: int, layers: int = 2, files: int = 6) -> list[bytes]:
    """The reference dict-service tests' images: layers of files drawn
    from a shared pool, so images share content."""
    r = np.random.default_rng(seed)
    out = []
    for _li in range(layers):
        buf = io.BytesIO()
        with tarfile.open(fileobj=buf, mode="w", format=tarfile.GNU_FORMAT) as tf:
            for fi in range(files):
                data = POOL[int(r.integers(0, len(POOL)))]
                ti = tarfile.TarInfo(f"d/f{seed}_{fi}")
                ti.size = len(data)
                tf.addfile(ti, io.BytesIO(data))
        out.append(buf.getvalue())
    return out


def image_bootstraps(seeds) -> list[bytes]:
    bc = BatchConverter(OPT)
    return [bc.convert_image(f"img{s}", mk_image(s)).bootstrap for s in seeds]


@pytest.fixture()
def pool(tmp_path):
    """Factory of running services: ``pool("port")`` or ``pool("ref")``."""
    started = []

    def make(kind: str = "port"):
        svc = pds.DictService(device="cpu") if kind == "port" else jds.DictService()
        svc.run(str(tmp_path / f"{kind}{len(started)}.sock"))
        started.append(svc)
        return svc

    yield make
    for svc in started:
        svc.stop()


def _digests(boot: bytes) -> list[bytes]:
    return [c.digest for c in Bootstrap.from_bytes(boot).chunks]


class TestServiceRPC:
    def test_probe_merge_stats_roundtrip(self, pool):
        svc = pool()
        cli = pds.DictClient(svc.sock_path)
        boot = image_bootstraps([1])[0]
        out = cli.merge(boot, "ns1")
        assert out["added"] > 0 and out["epoch"] == 1
        st = cli.stats("ns1")
        assert st["chunks"] == out["chunks"] == len(GrowingChunkDict(Bootstrap.from_bytes(boot)))
        records = svc.dict_for("ns1").records.bootstrap.chunks
        digs = [c.digest for c in records]
        launches = []
        real = probe_cuda.probe_padded

        def counted(*a):
            launches.append(a[2].shape[0])
            return real(*a)

        probe_cuda.probe_padded = counted
        try:
            ans = cli.probe(digs, "ns1")
        finally:
            probe_cuda.probe_padded = real
        assert np.array_equal(ans, np.arange(len(digs)))
        assert launches == [len(digs)]  # one K3 call per probe RPC
        miss = [bytes(RNG.integers(0, 256, 32, dtype=np.uint8)) for _ in range(5)]
        assert (cli.probe(miss, "ns1") == -1).all()

    def test_merge_is_idempotent_per_digest(self, pool):
        cli = pds.DictClient(pool().sock_path)
        boot = image_bootstraps([2])[0]
        first = cli.merge(boot, "ns")
        again = cli.merge(boot, "ns")
        assert again["added"] == 0
        assert (again["chunks"], again["epoch"]) == (first["chunks"], first["epoch"])

    def test_namespaces_are_isolated(self, pool):
        cli = pds.DictClient(pool().sock_path)
        boot = image_bootstraps([3])[0]
        cli.merge(boot, "a")
        digs = _digests(boot)[:4]
        assert (cli.probe(digs, "a") >= 0).all()
        assert (cli.probe(digs, "b") == -1).all()
        assert {"a", "b"} <= {d["namespace"] for d in cli.namespaces()}

    def test_invalid_namespace_rejected(self, pool):
        cli = pds.DictClient(pool().sock_path)
        with pytest.raises(pds.DictServiceError, match="404"):
            cli.stats("../escape")
        with pytest.raises(pds.DictServiceError, match="400|invalid"):
            cli.stats(".hidden")

    def test_probe_body_must_be_digest_multiple(self, pool):
        cli = pds.DictClient(pool().sock_path)
        with pytest.raises(pds.DictServiceError, match="multiple of 32"):
            cli._request("POST", "/api/v1/dict/ns/probe", b"short")
        with pytest.raises(pds.DictServiceError, match="400"):
            cli._request("POST", "/api/v1/dict/ns/merge", b"not a bootstrap")
        assert cli.stats("ns")["chunks"] == 0  # the service keeps serving

    def test_save_writes_bootstrap_and_index(self, pool, tmp_path):
        cli = pds.DictClient(pool().sock_path)
        for boot in image_bootstraps([4, 5]):
            cli.merge(boot, "ns")
        path = str(tmp_path / "dict.boot")
        out = cli.save(path, "ns")
        assert out["index_save"]["mode"] == "full"
        cd = ChunkDict.from_path(path)
        assert len(cd) == cli.stats("ns")["chunks"]
        digs = [c.digest for c in cd.bootstrap.chunks]
        for idx in (
            ShardedChunkDict.load(path + ".idx", device="cpu"),
            JDict.load(path + ".idx", probe_backend="host"),
        ):
            assert np.array_equal(idx.lookup_digests(digs), np.arange(len(digs)))
        cli.merge(image_bootstraps([6])[0], "ns")
        again = cli.save(path, "ns")["index_save"]
        assert again["mode"] == "append" and again["appended"] > 0

    def test_trained_zdict_roundtrip(self, pool):
        cli = pds.DictClient(pool().sock_path)
        assert cli.get_zdict("z") is None
        zbytes = (0xEC30A437).to_bytes(4, "little") + (77).to_bytes(4, "little") + b"\x01" * 64
        blob = TrainedDict(zbytes, epoch=3).serialize()
        td = codec.TrainedDict.deserialize(blob)
        assert (td.dict_id, td.epoch) == (77, 3)
        assert cli.put_zdict(blob, "z")["zdict_epoch"] == 3
        older = TrainedDict(zbytes, epoch=2).serialize()
        assert cli.put_zdict(older, "z")["zdict_epoch"] == 3  # highest epoch wins
        assert cli.get_zdict("z") == blob and cli.stats("z")["zdict_id"] == 77
        with pytest.raises(pds.DictServiceError, match="400"):
            cli.put_zdict(blob[:-1] + bytes([blob[-1] ^ 1]), "z")


class TestMirror:
    def test_mirror_replays_service_tail(self, pool):
        svc = pool()
        cli = pds.DictClient(svc.sock_path)
        b1, b2 = image_bootstraps([5, 6])
        cli.merge(b1, "ns")
        mirror = pds.ServiceChunkDict(pds.DictClient(svc.sock_path), "ns")
        private = GrowingChunkDict(Bootstrap.from_bytes(b1))
        assert len(mirror) == len(private)
        for c in private.bootstrap.chunks:
            hit = mirror.get(c.digest)
            assert mirror.blob_id_for(hit) == private.blob_id_for(private.get(c.digest))
        cli.merge(b2, "ns")
        assert mirror.sync() > 0
        private.add_bootstrap_bytes(b2)
        for table in ("chunks", "blobs", "batches", "ciphers"):
            assert getattr(mirror.bootstrap, table) == getattr(private.bootstrap, table), table
        assert mirror.sync() == 0
        mirror.close()

    def test_two_converters_share_one_table(self, pool):
        """Converter B dedups against chunks converter A merged."""
        svc = pool()
        a = pds.ServiceChunkDict(pds.DictClient(svc.sock_path), "shared")
        b = pds.ServiceChunkDict(pds.DictClient(svc.sock_path), "shared")
        boot_a, boot_b = image_bootstraps([7, 7])  # the same content: b's are all known
        added_a = a.add_bootstrap_bytes(boot_a)
        assert added_a > 0 and len(b) == 0
        assert b.sync() == added_a
        assert b.add_bootstrap_bytes(boot_b) == 0
        assert a.sync() == 0 and len(a) == len(b) == added_a
        layer = mk_image(7)[1]
        got = pack_layer(layer, PackOption(backend="numpy", chunk_size=0x10000), chunk_dict=b,
                         device="cpu")
        # foreign-blob references through the shared table
        assert set(got[1].referenced_blob_ids) - {got[1].blob_id}

    def test_shard_restart_detected_loudly(self, pool, tmp_path):
        svc = pool()
        sock = svc.sock_path
        m = pds.ServiceChunkDict(pds.DictClient(sock), "rst")
        m.add_bootstrap_bytes(image_bootstraps([23])[0])
        svc.stop()
        fresh = pds.DictService(device="cpu")  # an empty table on the same address
        fresh.run(sock)
        try:
            m.close()
            with pytest.raises(DictEpochError, match="backwards"):
                m.sync()
        finally:
            fresh.stop()


class TestSharding:
    def test_shard_for_stable_and_spreads(self):
        addrs = [f"/run/s{i}.sock" for i in range(4)]
        digs = [bytes([i]) * 32 for i in range(64)]
        owners = [pds.shard_for(d, addrs) for d in digs]
        assert owners == [jds.shard_for(d, addrs) for d in digs]
        assert len(set(owners)) > 1
        assert all(pds.shard_for(d, addrs[:1]) == 0 for d in digs)
        parts = pds.partition_digests(digs * 3, addrs[:3])
        assert parts == jds.partition_digests(digs * 3, addrs[:3])
        assert sorted(p for part in parts for p in part) == list(range(len(digs) * 3))

    @pytest.mark.parametrize("shards", [2, 4])
    def test_multi_address_identical_to_one_address(self, pool, shards):
        boots = image_bootstraps(range(300, 305))
        one = pds.ServiceChunkDict(pds.DictClient(pool().sock_path), "shrd")
        svcs = [pool() for _ in range(shards)]
        addrs = [s.sock_path for s in svcs]
        many = pds.open_chunk_dict("service://" + ",".join(addrs) + "#shrd")
        assert isinstance(many, pds.ServiceChunkDict) and many.n_shards == shards
        for boot in boots:
            assert one.add_bootstrap_bytes(boot) == many.add_bootstrap_bytes(boot)
        assert len(one) == len(many)
        per_shard = [e["chunks"] for e in many.shard_epochs()]
        assert sum(per_shard) == len(many) and sum(1 for c in per_shard if c) > 1
        for c in one.bootstrap.chunks:
            h1, h2 = one.get(c.digest), many.get(c.digest)
            assert one.blob_id_for(h1) == many.blob_id_for(h2)
            assert (h1.compressed_offset, h1.compressed_size) == (h2.compressed_offset, h2.compressed_size)
        layer = mk_image(302)[0]
        opt = PackOption(backend="numpy", chunk_size=0x10000)
        assert pack_layer(layer, opt, chunk_dict=one, device="cpu") == pack_layer(
            layer, opt, chunk_dict=many, device="cpu"
        )
        # the reference's client mirrors the port's shards alike
        fresh = pds.ServiceChunkDict([pds.DictClient(a) for a in addrs], "shrd")
        jmirror = jds.ServiceChunkDict([jds.DictClient(a) for a in addrs], "shrd")
        assert jmirror.bootstrap.to_bytes() == fresh.bootstrap.to_bytes()
        for m in (one, many, fresh, jmirror):
            m.close()


class TestEpochs:
    def test_entries_since_tail_and_count_only(self, pool):
        cli = pds.DictClient(pool().sock_path)
        boot = image_bootstraps([21])[0]
        cli.merge(boot, "since")
        meta, digs, vals = cli.entries_since("since", epoch=0)
        assert meta["entries"] == len(vals) == cli.stats("since")["chunks"]
        assert digs.shape == (len(vals), 8) and np.array_equal(vals, np.arange(len(vals)))
        meta2, d2, v2 = cli.entries_since("since", epoch=0, count_only=True)
        assert meta2["entries"] == meta["entries"] and len(d2) == len(v2) == 0
        meta3, d3, _v3 = cli.entries_since("since", epoch=meta["epoch"])
        assert meta3["entries"] == 0 and meta3["epoch"] == meta["epoch"]

    def test_compacted_journal_is_a_409_epoch_error(self, pool):
        svc = pool()
        cli = pds.DictClient(svc.sock_path)
        cli.merge(image_bootstraps([22])[0], "cmp")
        sd = svc.dict_for("cmp")
        with sd._mu:
            sd.index._rebuild()
        with pytest.raises(DictEpochError):
            cli.entries_since("cmp", epoch=0)
        with pytest.raises(JDictEpochError, match="409"):
            jds.DictClient(svc.sock_path).entries_since("cmp", epoch=0)


def _session(client_mod, sock: str, boots: list[bytes]) -> list:
    """One converter's conversation with a service -> everything it saw."""
    cli = client_mod.DictClient(sock)
    seen = []
    for boot in boots:
        st = cli.merge(boot, "wire")
        seen.append({k: st[k] for k in ("added", "chunks", "blobs", "batches", "epoch")})
    digs = _digests(boots[-1]) + _digests(boots[0]) + [b"\x07" * 32]
    seen.append(cli.probe(digs, "wire").tolist())
    meta, ca, ba, ta, ea = cli.entries("wire", chunks=3, blobs=1)
    seen.append((meta, ca.tobytes(), ba.tobytes(), ta.tobytes(), ea.tobytes()))
    meta, d, v = cli.entries_since("wire", epoch=1)
    seen.append((meta, d.tobytes(), v.tolist()))
    cli.close()
    return seen


class TestWireParity:
    @pytest.mark.parametrize("client", ["port", "ref"])
    @pytest.mark.parametrize("service", ["port", "ref"])
    def test_cross_package_sessions_agree(self, pool, client, service):
        """Port client <-> reference service and reference client <-> port
        service: equal answers and record deltas."""
        boots = image_bootstraps([31, 32, 33])
        want = _session(jds, pool("ref").sock_path, boots)
        got = _session(pds if client == "port" else jds, pool(service).sock_path, boots)
        assert got == want


class TestPackThroughService:
    @pytest.mark.parametrize("backend", ["numpy", "fused", "jax"])
    def test_service_pack_equals_private_dict_pack(self, pool, backend):
        """``chunk_dict_path="service://<uds>#ns"`` packs what a private
        ``GrowingChunkDict`` of the same merges packs, and what the
        reference packs with its own GrowingChunkDict, byte for byte."""
        boots = image_bootstraps([15, 16])
        svc = pool()
        cli = pds.DictClient(svc.sock_path)
        for boot in boots:
            cli.merge(boot, "pk")
        private = GrowingChunkDict()
        jprivate = JGrowingChunkDict()
        for boot in boots:
            private.add_bootstrap_bytes(boot)
            jprivate.add_bootstrap(JBootstrap.from_bytes(boot))
        layer = mk_image(15)[1]
        kw = dict(chunk_size=0x4000)
        via = pack_layer(
            layer, PackOption(backend=backend, chunk_dict_path=f"service://{svc.sock_path}#pk", **kw),
            device="cpu",
        )
        assert via == pack_layer(layer, PackOption(backend=backend, **kw), chunk_dict=private,
                                 device="cpu")
        ref_blob, ref_res = j_pack_layer(layer, JPackOption(backend="numpy", **kw), chunk_dict=jprivate)
        assert via[0] == ref_blob and via[1].bootstrap == ref_res.bootstrap
        assert via[1].blob_id == ref_res.blob_id
        assert set(via[1].referenced_blob_ids) - {via[1].blob_id}

    def test_ha_paths_refused(self):
        with pytest.raises(ConvertError, match="HA"):
            pds.open_chunk_dict("service+ha:///run/ctl.sock")
        with pytest.raises(ConvertError, match="HA"):
            pds.open_chunk_dict("service:///run/a.sock|/run/b.sock#ns")


def test_config_env_overrides(monkeypatch):
    monkeypatch.setenv("NTPU_DICT_LOAD_FACTOR", "0.5")
    monkeypatch.setenv("NTPU_DICT_HEADROOM", "4.0")
    monkeypatch.setenv("NTPU_DICT_SERVICE", "/tmp/x.sock")
    monkeypatch.setenv("NTPU_DICT_NAMESPACE", "team-a")
    monkeypatch.setenv("NTPU_DICT_BACKEND", "host")
    cfg = pds.resolve_dict_config()
    assert (cfg.load_factor, cfg.headroom, cfg.service, cfg.namespace, cfg.backend) == (
        0.5, 4.0, "/tmp/x.sock", "team-a", "host"
    )
    sd = pds.ServiceDict("ns", cfg, device="cpu")
    assert (sd.index.load_factor, sd.index.capacity_factor, sd.index.probe_backend) == (
        0.5, 4.0, "host"
    )
