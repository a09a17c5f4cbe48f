"""The port's fault, trace and metrics planes against the JAX package's.

Both packages keep process-wide tables (the armed failpoints, the tracer,
the metrics registry); every test here resets both. Each case runs the
same calls in the two packages and compares: failpoint spec parsing and
the inject / clear / n-shot / probability / panic rules, the site
catalog, every site of a ported module firing in both packages, the span
tree, errors, sampling, env resolution, context carried across pipeline
workers, ``BatchConverter`` layers and the dict service's RPCs, the
Chrome export, and the registry's exposition text.
"""

import gzip
import importlib
import io
import json
import os
import re
import tarfile
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

from nydus_snapshotter_tpu import failpoint as jfp
from nydus_snapshotter_tpu import trace as jtrace
from nydus_snapshotter_tpu.converter.batch import BatchConverter as JBatchConverter
from nydus_snapshotter_tpu.converter.convert import pack_layer as j_pack_layer
from nydus_snapshotter_tpu.converter.types import PackOption as JPackOption
from nydus_snapshotter_tpu.failpoint import spec as jspec
from nydus_snapshotter_tpu.metrics import registry as jreg
from nydus_snapshotter_tpu.ops import cdc as jcdc
from nydus_snapshotter_tpu.ops import fused_convert as jfused
from nydus_snapshotter_tpu.ops import native_cdc as jnative
from nydus_snapshotter_tpu.parallel import dict_service as jds
from nydus_snapshotter_tpu.parallel import sharded_dict as jsd
from nydus_snapshotter_tpu.utils import errdefs as jerrdefs
from nydus_snapshotter_tpu_torch import failpoint as tfp
from nydus_snapshotter_tpu_torch import trace as ttrace
from nydus_snapshotter_tpu_torch.converter import PackOption, pack_layer
from nydus_snapshotter_tpu_torch.converter.batch import BatchConverter
from nydus_snapshotter_tpu_torch.failpoint import spec as tspec
from nydus_snapshotter_tpu_torch.metrics import registry as treg
from nydus_snapshotter_tpu_torch.ops import cdc as tcdc
from nydus_snapshotter_tpu_torch.ops import fused_convert as tfused
from nydus_snapshotter_tpu_torch.ops import native_cdc as tnative
from nydus_snapshotter_tpu_torch.parallel import dict_service as tds
from nydus_snapshotter_tpu_torch.parallel import sharded_dict as tsd
from nydus_snapshotter_tpu_torch.utils import errdefs as terrdefs

PORT = Path(__file__).resolve().parent.parent / "nydus_snapshotter_tpu_torch"

PKG = {
    "port": SimpleNamespace(fp=tfp, spec=tspec, trace=ttrace, reg=treg, errdefs=terrdefs),
    "ref": SimpleNamespace(fp=jfp, spec=jspec, trace=jtrace, reg=jreg, errdefs=jerrdefs),
}

# The sites this package's modules fire: since the scenario runner, the
# reference's whole catalog.
PORTED_SITES = {
    "converter.pack", "pipeline.chunk", "pipeline.queue", "pipeline.compress",
    "pipeline.assemble", "fused.dispatch", "dict.insert", "dict.rebuild", "dict.rpc",
    "dict.shard", "chunk.vec", "compress.probe", "compress.train", "compress.encode",
    "compress.batch", "ha.place", "ha.replicate", "ha.promote",
    "transport.probe", "transport.resolve", "transport.fetch_blob",
    "soci.index", "soci.resolve", "soci.fetch",
    "blobcache.fetch", "blobcache.coalesce", "blobcache.readahead", "blobcache.evict",
    "blobcache.replay", "peer.serve", "peer.fetch", "peer.admit", "peer.member", "peer.tier",
    "peer.hedge", "prov.record", "prov.compile", "prov.adopt", "slo.actuate", "soak.scaleup",
    "daemon.spawn", "daemon.rpc",
    "metastore.create", "metastore.commit", "metastore.remove", "snapshot.prepare",
    "snapshot.commit", "snapshot.usage", "snapshot.cleanup", "fs.mount", "fs.umount",
    "manager.restart", "fleet.scrape", "fleet.collect",
    "scenario.phase", "soak.wave", "soak.evolve",
}


@pytest.fixture(autouse=True)
def _clean_planes():
    for p in PKG.values():
        p.fp.clear()
        p.trace.configure(enabled=True, ring_capacity=4096, slow_op_threshold_ms=0)
    yield
    for p in PKG.values():
        p.fp.clear()
        p.trace.reset()


def _tar(n_files=6, seed=5, size=(30_000, 200_000)) -> bytes:
    rng = np.random.default_rng(seed)
    buf = io.BytesIO()
    with tarfile.open(fileobj=buf, mode="w", format=tarfile.GNU_FORMAT) as tf:
        for i in range(n_files):
            data = rng.integers(0, 256, int(rng.integers(*size)), dtype=np.uint8).tobytes()
            ti = tarfile.TarInfo(f"c/f{i}")
            ti.size = len(data)
            tf.addfile(ti, io.BytesIO(data))
    return buf.getvalue()


LAYER = _tar()
PIPE = dict(chunk_size=0x10000, backend="hybrid", batch_size=0x4000)


# ---------------------------------------------------------------- failpoint


@pytest.mark.parametrize("pkg", ["port", "ref"])
class TestFailpointSpec:
    def test_parse_multi_site_spec(self, pkg):
        table = PKG[pkg].spec.parse_spec(
            "transport.fetch_blob=error(OSError:503)%0.5;daemon.spawn=delay(0.2);metastore.commit=panic"
        )
        assert set(table) == {"transport.fetch_blob", "daemon.spawn", "metastore.commit"}
        a = table["transport.fetch_blob"]
        assert (a.kind, a.arg, a.prob) == ("error", "OSError:503", 0.5)
        assert (table["daemon.spawn"].kind, table["metastore.commit"].kind) == ("delay", "panic")

    def test_parse_count_and_off(self, pkg):
        table = PKG[pkg].spec.parse_spec("a=error(OSError)*2;b=off;;")
        assert table["a"].count == 2 and "b" not in table

    @pytest.mark.parametrize("bad", ["a=explode", "a=error(X)%1.5", "noequals", "=error(X)",
                                     "a=delay(x)"])
    def test_bad_specs_rejected(self, pkg, bad):
        with pytest.raises(PKG[pkg].spec.SpecError):
            PKG[pkg].spec.parse_spec(bad)

    def test_action_roundtrips_through_str(self, pkg):
        a = PKG[pkg].spec.parse_action("error(OSError:boom)%0.25*3")
        assert PKG[pkg].spec.parse_action(str(a)) == a

    def test_build_error_mapping(self, pkg):
        p = PKG[pkg]
        assert isinstance(p.spec.build_error("OSError:boom", "s"), OSError)
        assert isinstance(p.spec.build_error("TimeoutError", "s"), TimeoutError)
        assert isinstance(p.spec.build_error("Unavailable:down", "s"), p.errdefs.Unavailable)
        assert type(p.spec.build_error("NoSuchThing", "s")) is RuntimeError


def test_http_error_refused_at_arming():
    """``error(HTTPError:<code>)`` arms alike in both packages (the port
    has the registry client since its read path was ported), and each
    raises its own ``remote.registry.HTTPError`` with that code at the
    site; a code that is not a number falls back to 503 in both."""
    from nydus_snapshotter_tpu.remote import registry as jregistry
    from nydus_snapshotter_tpu_torch.remote import registry as tregistry

    for spec in ("error(HTTPError:503)", "error(HTTPError:429)*2", "error(HTTPError)%0.5"):
        assert str(tspec.parse_action(spec)) == str(jspec.parse_action(spec))
    table = "transport.fetch_blob=error(HTTPError:503);transport.probe=error(HTTPError:429)*1"
    assert {k: str(a) for k, a in tspec.parse_spec(table).items()} == \
        {k: str(a) for k, a in jspec.parse_spec(table).items()}
    for p, registry in ((PKG["port"], tregistry), (PKG["ref"], jregistry)):
        for arg, code in (("HTTPError:503", 503), ("HTTPError:429", 429), ("HTTPError", 503),
                          ("HTTPError:teapot", 503)):
            p.fp.inject("x", f"error({arg})*1")
            with pytest.raises(registry.HTTPError) as ei:
                p.fp.hit("x")
            assert ei.value.code == code and ei.value.url == "failpoint://x"
        assert p.fp.configure_from_env({p.fp.ENV_VAR: "x=error(HTTPError:503)"})
        assert p.fp.active() == {"x": "error(HTTPError:503)"}
        p.fp.clear()


@pytest.mark.parametrize("pkg", ["port", "ref"])
class TestFailpointRegistry:
    def test_disabled_hit_is_noop(self, pkg):
        fp = PKG[pkg].fp
        assert fp.active() == {}
        fp.hit("converter.pack")

    def test_unarmed_site_is_noop_while_others_armed(self, pkg):
        fp = PKG[pkg].fp
        with fp.injected("some.site", "error(OSError)"):
            fp.hit("other.site")
        assert fp.counts().get("other.site") is None

    def test_inject_fire_clear(self, pkg):
        fp = PKG[pkg].fp
        fp.inject("x", "error(OSError:kaboom)")
        with pytest.raises(OSError, match="kaboom"):
            fp.hit("x")
        fp.clear("x")
        fp.hit("x")
        assert fp.counts()["x"] == 1

    def test_n_shot_disarms(self, pkg):
        fp = PKG[pkg].fp
        fp.inject("x", "error(OSError)*2")
        for _ in range(2):
            with pytest.raises(OSError):
                fp.hit("x")
        fp.hit("x")
        assert "x" not in fp.active() and fp.counts()["x"] == 2

    def test_probability_extremes(self, pkg):
        fp = PKG[pkg].fp
        fp.inject("never", "error(OSError)%0.0")
        for _ in range(20):
            fp.hit("never")
        fp.inject("always", "error(OSError)%1.0")
        with pytest.raises(OSError):
            fp.hit("always")

    def test_delay_sleeps(self, pkg):
        fp = PKG[pkg].fp
        fp.inject("z", "delay(0.02)")
        t0 = time.monotonic()
        fp.hit("z")
        assert time.monotonic() - t0 >= 0.015

    def test_panic_bypasses_except_exception(self, pkg):
        fp = PKG[pkg].fp
        fp.inject("p", "panic(boom)")
        with pytest.raises(fp.Panic):
            try:
                fp.hit("p")
            except Exception:  # noqa: BLE001 - what a panic must get past
                pytest.fail("Panic was caught as an Exception")

    def test_env_activation_and_malformed_env(self, pkg):
        fp = PKG[pkg].fp
        assert fp.configure_from_env({fp.ENV_VAR: "a=error(OSError)*1;b=delay(0)"})
        assert fp.active() == {"a": "error(OSError)*1", "b": "delay(0)"}
        fp.clear()
        assert not fp.configure_from_env({fp.ENV_VAR: "not a spec!!"})
        assert fp.active() == {}


def test_catalog_equal_and_ported_sites_wired():
    """The port keeps the reference's whole catalog, every site its
    modules fire is cataloged, and no cataloged site is left unwired."""
    assert tfp.KNOWN_SITES == jfp.KNOWN_SITES
    wired = set()
    for path in PORT.rglob("*.py"):
        if path.parent.name not in ("failpoint", "analysis"):  # their docstrings' examples
            wired |= set(re.findall(r'hit\("([a-z_.]+)"\)', path.read_text()))
    assert wired == PORTED_SITES
    assert PORTED_SITES <= set(tfp.KNOWN_SITES)
    not_ported = set(tfp.KNOWN_SITES) - PORTED_SITES
    assert not_ported == set()


def _drive_pack(pkg):
    if pkg == "port":
        return pack_layer(LAYER, PackOption(**PIPE), device="cpu")
    return j_pack_layer(LAYER, JPackOption(**PIPE))


def _drive_fused(pkg):
    if pkg == "port":
        return tfused.FusedDeviceEngine(chunk_size=0x10000, device="cpu").process_many([b"x" * 1024])
    return jfused.FusedDeviceEngine(chunk_size=0x10000).process_many([b"x" * 1024])


def _drive_vec(pkg):
    data = np.random.default_rng(3).integers(0, 256, 50_000, dtype=np.uint8)
    if pkg == "port":
        return tnative.chunk_data_vec_native(data, tcdc.CDCParams(0x1000))
    return jnative.chunk_data_vec_native(data, jcdc.CDCParams(0x1000))


def _dict(pkg, n=16, load_factor=0.85):
    digs = np.random.default_rng(4).integers(0, 2**32, (n, 8), dtype=np.uint32)
    if pkg == "port":
        return tsd.ShardedChunkDict(digs, device="cpu", load_factor=load_factor)
    return jsd.ShardedChunkDict(digs, load_factor=load_factor)


def _drive_insert(pkg):
    return _dict(pkg).insert_u32(np.random.default_rng(5).integers(0, 2**32, (4, 8), dtype=np.uint32))


def _drive_rebuild(pkg):
    # far past the load factor: the insert rebuilds the table
    d = _dict(pkg, n=8, load_factor=0.5)
    return d.insert_u32(np.random.default_rng(6).integers(0, 2**32, (400, 8), dtype=np.uint32))


def _drive_rpc(pkg):
    svc = tds.DictService(device="cpu") if pkg == "port" else jds.DictService()
    status, _ctype, body = svc.handle("GET", "/api/v1/dict/ns/stats", {}, b"")
    if status != 200:
        raise OSError(f"status {status}: {body!r}")


def _drive_shard(pkg, tmp_path):
    mod = tds if pkg == "port" else jds
    svcs = []
    for i in range(2):
        svcs.append(tds.DictService(device="cpu") if pkg == "port" else jds.DictService())
        svcs[-1].run(str(tmp_path / f"{pkg}{i}.sock"))
    try:
        mirror = mod.ServiceChunkDict([mod.DictClient(s.sock_path) for s in svcs], "ns")
        try:
            mirror.sync()
        finally:
            mirror.close()
    finally:
        for s in svcs:
            s.stop()


def _codec_mod(pkg):
    from nydus_snapshotter_tpu.converter import codec as jcodec
    from nydus_snapshotter_tpu_torch.converter import codec as tcodec

    return tcodec if pkg == "port" else jcodec


def _codec(pkg, **kw):
    mod = _codec_mod(pkg)
    return mod.AdaptiveCodec(mod.CodecConfig(adaptive=True, **kw))


def _drive_probe(pkg):
    c = _codec(pkg)
    c.encode(np.random.default_rng(7).integers(0, 256, 32 << 10, dtype=np.uint8).tobytes())
    if c.counts["fallback"]:  # the probe's failure degrades, it does not raise
        raise OSError("site-chaos: the probe fell back to always-compress")


def _drive_train(pkg):
    c = _codec(pkg, train=True, train_sample_mib=1, train_dict_kib=16)
    c.attach_trainer()
    rng = np.random.default_rng(8)
    words = [bytes(rng.integers(97, 123, 6, dtype=np.uint8)) for _ in range(300)]
    for _ in range(60):
        c.encode(b" ".join(words[int(k)] for k in rng.integers(0, 300, 3000)))
    td = c.maybe_train(force=True)
    if td is None:  # a failed training degrades, it does not raise
        raise OSError("site-chaos: training fell back to untrained")
    _codec_mod(pkg).unregister_trained_dict(td.dict_id)  # the registry is process-wide


def _drive_encode(pkg):
    return _codec(pkg).encode(b"x" * 8192)


def _drive_batch(pkg):
    return _codec(pkg).encode_batch([b"x" * 8192, b"y" * 9000])


def _ha_mods(pkg):
    from nydus_snapshotter_tpu.ha import placement as jplacement
    from nydus_snapshotter_tpu.ha import replicate as jreplicate
    from nydus_snapshotter_tpu_torch.ha import placement as tplacement
    from nydus_snapshotter_tpu_torch.ha import replicate as treplicate

    return (tplacement, treplicate) if pkg == "port" else (jplacement, jreplicate)


def _service(pkg):
    return tds.DictService(device="cpu") if pkg == "port" else jds.DictService()


def _drive_place(pkg):
    from nydus_snapshotter_tpu.fleet import Member

    members = [Member(name=f"dict-{i}", component="dict", address=f"/tmp/m{i}.sock", pid=i)
               for i in range(2)]
    pc = _ha_mods(pkg)[0].PlacementController(
        lambda: members, lambda: {}, shards=1, replicas=1)
    pc._push_role = lambda name, addr, payload: True
    return pc.tick()


def _drive_replicate(pkg, tmp_path):
    prim = _service(pkg)
    prim.run(str(tmp_path / f"{pkg}-primary.sock"))
    tailer = _ha_mods(pkg)[1].ReplicaTailer(_service(pkg), prim.sock_path)
    try:
        return tailer.poll_once()
    finally:
        tailer.stop()
        prim.stop()


def _drive_promote(pkg):
    return _ha_mods(pkg)[1].HaAgent(_service(pkg), role="replica").promote()


def _registry_mods(pkg):
    from nydus_snapshotter_tpu.remote import reference as jreference
    from nydus_snapshotter_tpu.remote import registry as jregistry
    from nydus_snapshotter_tpu.remote import transport as jtransport
    from nydus_snapshotter_tpu_torch.remote import reference as treference
    from nydus_snapshotter_tpu_torch.remote import registry as tregistry
    from nydus_snapshotter_tpu_torch.remote import transport as ttransport

    if pkg == "port":
        return treference, tregistry, ttransport
    return jreference, jregistry, jtransport


def _with_registry(fn):
    from tests.test_remote import FakeRegistry

    reg = FakeRegistry(require_auth=False)
    try:
        return fn(reg, reg.add_blob(b"site-blob" * 10))
    finally:
        reg.close()


def _drive_fetch_blob(pkg):
    _ref, registry, _tr = _registry_mods(pkg)

    def fetch(reg, digest):
        r = registry.RegistryClient(reg.host, plain_http=True).fetch_blob("x/y", digest)
        try:
            return r.read()
        finally:
            r.close()

    return _with_registry(fetch)


def _drive_pool(pkg):
    reference, _reg, transport = _registry_mods(pkg)
    return _with_registry(lambda reg, digest: transport.Pool(plain_http=True).resolve(
        reference.parse_docker_ref(f"{reg.host}/x/y:v1"), digest))


SOCI_TAR = _tar(n_files=8, size=(40_000, 90_000))
SOCI_GZ = b"".join(gzip.compress(SOCI_TAR[i:i + 200_000], 1, mtime=0)
                   for i in range(0, len(SOCI_TAR), 200_000))


def _soci_blob(pkg):
    from nydus_snapshotter_tpu.soci import blob as jblob
    from nydus_snapshotter_tpu_torch.soci import blob as tblob

    return tblob if pkg == "port" else jblob


def _drive_soci_index(pkg):
    return _soci_blob(pkg).build_index_from_gzip("ab" * 32, SOCI_GZ, stride=64 << 10)


def _drive_soci_read(pkg):
    """A checkpoint-indexed read: ``soci.resolve`` then ``soci.fetch``."""
    blob = _soci_blob(pkg)
    idx, _ = blob.build_index_from_gzip("ab" * 32, SOCI_GZ, stride=64 << 10)
    reader = blob.SociStreamReader(idx, lambda o, n: SOCI_GZ[o:o + n])
    off = len(SOCI_TAR) // 2
    if reader.read_range(off, 5000) != SOCI_TAR[off:off + 5000]:
        raise AssertionError("indexed read differs")


DRIVERS = {
    "converter.pack": _drive_pack,
    "pipeline.chunk": _drive_pack,
    "pipeline.queue": _drive_pack,
    "pipeline.compress": _drive_pack,
    "pipeline.assemble": _drive_pack,
    "fused.dispatch": _drive_fused,
    "chunk.vec": _drive_vec,
    "dict.insert": _drive_insert,
    "dict.rebuild": _drive_rebuild,
    "dict.rpc": _drive_rpc,
    "dict.shard": _drive_shard,
    "compress.probe": _drive_probe,
    "compress.train": _drive_train,
    "compress.encode": _drive_encode,
    "compress.batch": _drive_batch,
    "ha.place": _drive_place,
    "ha.replicate": _drive_replicate,
    "ha.promote": _drive_promote,
    "transport.probe": _drive_pool,
    "transport.resolve": _drive_pool,
    "transport.fetch_blob": _drive_fetch_blob,
    "soci.index": _drive_soci_index,
    "soci.resolve": _drive_soci_read,
    "soci.fetch": _drive_soci_read,
}


def _fetch_side(pkg):
    import importlib

    root = "nydus_snapshotter_tpu_torch" if pkg == "port" else "nydus_snapshotter_tpu"
    return SimpleNamespace(**{name: importlib.import_module(f"{root}.{mod}") for name, mod in (
        ("blobcache", "daemon.blobcache"), ("fs", "daemon.fetch_sched"), ("peer", "daemon.peer"),
        ("prov", "provenance"), ("cache", "cache.manager"), ("slo", "metrics.slo"))})


FETCH_BLOB = np.random.default_rng(18).integers(0, 256, 64 << 10, dtype=np.uint8).tobytes()


def _drive_blobcache(pkg, tmp_path):
    """A read that plans a fetch, one that coalesces two gaps around a
    cached hole, and a sequential one that plans readahead."""
    m = _fetch_side(pkg)
    cb = m.blobcache.CachedBlob(str(tmp_path / pkg), "fc" * 32, lambda o, n: FETCH_BLOB[o:o + n],
                                blob_size=len(FETCH_BLOB),
                                config=m.fs.FetchConfig(fetch_workers=1, merge_gap=4096, readahead=4096))
    try:
        for off, n in ((1000, 10), (0, 3000), (3000, 100)):
            try:
                cb.read_at(off, n)
            except OSError:
                pass
    finally:
        cb.close()


def _drive_evict(pkg, tmp_path):
    d = tmp_path / pkg
    d.mkdir(exist_ok=True)
    (d / ("ee" * 32 + ".blob.data")).write_bytes(b"x" * 100)
    _fetch_side(pkg).cache.CacheManager(str(d)).gc_watermark(1)


def _drive_replay(pkg, tmp_path):
    ino = SimpleNamespace(chunk_index=0, chunk_count=1, hardlink_target="")
    bs = SimpleNamespace(chunks=[SimpleNamespace(compressed_offset=0, compressed_size=1)])
    _fetch_side(pkg).fs.PrefetchReplayer(bs, {"/a": ino}, lambda rec: 1).replay(["/a"])


def _drive_peer(pkg, tmp_path):
    """A serve request, and a waterfall read whose peer is gone."""
    m = _fetch_side(pkg)
    export = m.peer.PeerExport()
    m.peer.PeerChunkServer(export, pull_through=False).handle(
        "GET", f"/api/v1/peer/blob/{'ab' * 32}?offset=0&size=10", {})
    router = m.peer.PeerRouter([str(tmp_path / "gone.sock")])
    m.peer.PeerAwareFetcher("ab" * 32, lambda o, n: FETCH_BLOB[o:o + n], router).read_range(0, 10)


def _drive_admit(pkg, tmp_path):
    m = _fetch_side(pkg)
    gate = m.fs.AdmissionGate(budget=m.fs.MemoryBudget(1 << 20), name="site")
    gate.acquire(10)
    gate.release(10)


def _drive_member(pkg, tmp_path):
    _fetch_side(pkg).peer.PeerMembership(seed=["/tmp/s.sock"], fetch=lambda: [], refresh_secs=0.0).addresses()


def _drive_hedge(pkg, tmp_path):
    m = _fetch_side(pkg)
    h = m.fs.Hedger(gate=m.fs.AdmissionGate(budget=m.fs.MemoryBudget(1 << 20), name="site"), name="site")
    for _ in range(m.fs.HEDGE_MIN_SAMPLES + 5):
        h.record("rack", 1.0)
    h.fetch(64, "rack", lambda: (time.sleep(0.03), b"P")[1], "zone", lambda: b"H")


def _drive_prov(pkg, tmp_path):
    prov = _fetch_side(pkg).prov
    bid = "9d" * 32
    prov.record_fetch(bid, 0, 10, prov.CAUSE_DEMAND)
    prov.record_read(bid, 0, 10)
    prov.compile_heat(bid, str(tmp_path))
    prov.load_or_adopt_heat([], bid, fetch_remote=lambda: b"")


def _drive_slo(pkg, tmp_path):
    m = _fetch_side(pkg)
    engine = SimpleNamespace(breached=lambda: ["o"], max_burn_short=lambda: 9.0,
                             record_event=lambda *a, **k: {})
    gate = m.fs.AdmissionGate(budget=m.fs.MemoryBudget(1 << 20), name="site")
    try:
        m.slo.SloActuator(engine, gate=gate).tick()
    except OSError:
        pass
    engine.breached = lambda: []
    m.slo.SloScaleUp(engine, lambda: {"queued": 9}, lambda n: None).tick()


# The fetch side's sites: most are contained by design (a failed readahead,
# replay file, attribution, heat compile or adoption, membership refresh,
# peer tier or hedge degrades and the read goes on), so their cases arm a
# site, drive it and count its one fire rather than expect an error.
FETCH_DRIVERS = {
    "blobcache.fetch": _drive_blobcache,
    "blobcache.coalesce": _drive_blobcache,
    "blobcache.readahead": _drive_blobcache,
    "blobcache.evict": _drive_evict,
    "blobcache.replay": _drive_replay,
    "peer.serve": _drive_peer,
    "peer.fetch": _drive_peer,
    "peer.tier": _drive_peer,
    "peer.admit": _drive_admit,
    "peer.member": _drive_member,
    "peer.hedge": _drive_hedge,
    "prov.record": _drive_prov,
    "prov.compile": _drive_prov,
    "prov.adopt": _drive_prov,
    "slo.actuate": _drive_slo,
    "soak.scaleup": _drive_slo,
}


def _drive_daemon_spawn(pkg, tmp_path):
    m = importlib.import_module(f"{_root(pkg)}.daemon.daemon")
    m.Daemon(m.ConfigState(daemon_id="site", api_socket=str(tmp_path / f"{pkg}.sock"))).spawn()


def _drive_daemon_rpc(pkg, tmp_path):
    client = importlib.import_module(f"{_root(pkg)}.daemon.client")
    client.NydusdClient(str(tmp_path / f"{pkg}-none.sock"), timeout=1.0).get_daemon_info()


def _root(pkg):
    return "nydus_snapshotter_tpu_torch" if pkg == "port" else "nydus_snapshotter_tpu"


# The serving daemon's sites: the spawn fails before any process starts,
# the RPC before it connects.
DAEMON_DRIVERS = {"daemon.spawn": _drive_daemon_spawn, "daemon.rpc": _drive_daemon_rpc}


def _snapshotter(pkg, tmp_path, **kw):
    """A snapshotter over tools/snapshot_profile.py's ``LatencyFs`` (the
    port's copy of the tool for the port) with every worker inline."""
    if pkg == "port":
        from tests.test_torch_fetch_sched import port_tool

        latency_fs = port_tool("snapshot_profile").LatencyFs
    else:
        latency_fs = importlib.import_module("tools.snapshot_profile").LatencyFs
    sn = importlib.import_module(f"{_root(pkg)}.snapshot.snapshotter")
    return sn.Snapshotter(root=str(tmp_path / f"sn-{pkg}"), fs=latency_fs(0, 0), prepare_fanout=0,
                          usage_workers=0, **kw)


def _drive_metastore(site):
    def drive(pkg, tmp_path):
        ms = importlib.import_module(f"{_root(pkg)}.snapshot.metastore")
        store = ms.MetaStore(str(tmp_path / f"ms-{pkg}-{site}.db"))
        try:
            store.create_snapshot(ms.KIND_ACTIVE, "k")
            store.commit_active("k", "layer", ms.Usage())
            store.remove("layer")
        finally:
            store.close()

    return drive


def _drive_snapshotter(pkg, tmp_path):
    C = importlib.import_module(f"{_root(pkg)}.constants")
    s = _snapshotter(pkg, tmp_path)
    try:
        meta = {C.NYDUS_META_LAYER: "true", C.CRI_IMAGE_REF: "img"}
        s.prepare("p-m", "", {C.TARGET_SNAPSHOT_REF: "r", **meta})
        s.commit("meta-c", "p-m", meta)
        s.prepare("rw", "meta-c")
        s.remove("rw")
        s.cleanup()
    finally:
        s.close()


def _filesystem(pkg, tmp_path):
    m = lambda name: importlib.import_module(f"{_root(pkg)}.{name}")
    C = m("constants")
    return m("filesystem").Filesystem(
        managers={}, cache_mgr=m("cache.manager").CacheManager(str(tmp_path / f"c-{pkg}")),
        root=str(tmp_path / f"fs-{pkg}"), fs_driver=C.FS_DRIVER_FUSEDEV,
        daemon_mode=C.DAEMON_MODE_NONE,
        daemon_config=m("config.daemonconfig").DaemonRuntimeConfig.from_dict({}, C.FS_DRIVER_FUSEDEV),
    )


def _drive_fs_mount(pkg, tmp_path):
    _filesystem(pkg, tmp_path).mount("1", {})


def _drive_fs_umount(pkg, tmp_path):
    _filesystem(pkg, tmp_path).umount("1")


def _drive_manager_restart(pkg, tmp_path):
    importlib.import_module(f"{_root(pkg)}.manager.manager").Manager.do_daemon_restart(object(), object())


# The control plane's sites: each fires at its entry, before any state
# changes, and its error reaches the caller (the usage scan runs inline).
CONTROL_DRIVERS = {
    "metastore.create": _drive_metastore("metastore.create"),
    "metastore.commit": _drive_metastore("metastore.commit"),
    "metastore.remove": _drive_metastore("metastore.remove"),
    "snapshot.prepare": _drive_snapshotter,
    "snapshot.commit": _drive_snapshotter,
    "snapshot.usage": _drive_snapshotter,
    "snapshot.cleanup": _drive_snapshotter,
    "fs.mount": _drive_fs_mount,
    "fs.umount": _drive_fs_umount,
    "manager.restart": _drive_manager_restart,
}


def _fleet_plane(pkg):
    fleet = importlib.import_module(f"{_root(pkg)}.fleet")
    plane = fleet.FleetPlane(cfg=fleet.FleetRuntimeConfig(enable=True, scrape_interval_secs=60.0))
    plane.register_local("site")
    return plane


def _drive_fleet_scrape(pkg, tmp_path):
    if _fleet_plane(pkg).federator.scrape_once()["errors"]:
        raise OSError("site-chaos: a member's scrape failed")


def _drive_fleet_collect(pkg, tmp_path):
    if _fleet_plane(pkg).collector.collect()["fleet"]["errors"]:
        raise OSError("site-chaos: a member's trace pull failed")


# The fleet controller's sites: a member's failed scrape or trace pull is
# counted against that member and the federated answer goes on, so the
# drivers raise when the answer counts an error.
FLEET_DRIVERS = {"fleet.scrape": _drive_fleet_scrape, "fleet.collect": _drive_fleet_collect}


@pytest.mark.parametrize("site", sorted(FLEET_DRIVERS))
def test_each_fleet_site_fires_in_both_packages(monkeypatch, tmp_path, site):
    for pkg in ("port", "ref"):
        # the plane claims the process's member slot: give it back after
        monkeypatch.setattr(importlib.import_module(f"{_root(pkg)}.fleet"), "_self_member", None)
        fp = PKG[pkg].fp
        fed = importlib.import_module(f"{_root(pkg)}.metrics.federation")
        before = fed.FLEET_SCRAPE_ERRORS.value("site") or 0
        fp.inject(site, "error(OSError:site-chaos)*1")
        with pytest.raises(OSError, match="site-chaos"):
            FLEET_DRIVERS[site](pkg, tmp_path)
        assert fp.counts().get(site) == 1, pkg
        assert fed.FLEET_SCRAPE_ERRORS.value("site") == before + 1, pkg
        other = PKG["ref" if pkg == "port" else "port"].fp
        assert site not in other.counts(), pkg
        FLEET_DRIVERS[site](pkg, tmp_path)  # one shot spent: the next round is clean
        fp.clear()


SITE_SPEC = """
[scenario]
name = "site"
seed = 1
pods = 1

[scenario.soak]
epochs = 1
base_pods = 1
flash_prob = 0.0

[[scenario.corpus]]
id = "img"
kind = "compressible"
mib = 1

[[scenario.phases]]
op = "convert"
corpus = ["img"]
"""


def _scenario_run(pkg, tmp_path, soak: bool):
    """One serial scenario (or soak) run of ``SITE_SPEC``; a failed run's
    report error is raised."""
    spec = importlib.import_module(f"{_root(pkg)}.scenario.spec").loads(SITE_SPEC)
    kw = {"device": "cpu"} if pkg == "port" else {}
    if soak:
        runner = importlib.import_module(f"{_root(pkg)}.scenario.soak").SoakRunner(
            spec, str(tmp_path / f"soak-{pkg}"), serial=True, **kw)
        run = runner.run_soak
    else:
        runner = importlib.import_module(f"{_root(pkg)}.scenario.orchestrator").ScenarioRunner(
            spec, str(tmp_path / f"scn-{pkg}"), serial=True, **kw)
        run = runner.run
    try:
        report = run()
    finally:
        runner.close()
    if not report["ok"]:
        raise OSError(report["error"])


# The scenario runner's sites: an armed error fails the run loudly (the
# report names the phase or the epoch); the drivers raise it.
SCENARIO_DRIVERS = {
    "scenario.phase": lambda pkg, tmp_path: _scenario_run(pkg, tmp_path, soak=False),
    "soak.wave": lambda pkg, tmp_path: _scenario_run(pkg, tmp_path, soak=True),
    "soak.evolve": lambda pkg, tmp_path: _scenario_run(pkg, tmp_path, soak=True),
}


@pytest.mark.parametrize("site", sorted(SCENARIO_DRIVERS))
def test_each_scenario_site_fires_in_both_packages(tmp_path, site):
    for pkg in ("port", "ref"):
        fp = PKG[pkg].fp
        fp.inject(site, "error(OSError:site-chaos)*1")
        with pytest.raises(OSError, match="site-chaos"):
            SCENARIO_DRIVERS[site](pkg, tmp_path / f"{pkg}1")
        assert fp.counts().get(site) == 1, pkg
        other = PKG["ref" if pkg == "port" else "port"].fp
        assert site not in other.counts(), pkg
        SCENARIO_DRIVERS[site](pkg, tmp_path / f"{pkg}2")  # one shot spent: the next run is clean
        fp.clear()


GROUPS = (DRIVERS, FETCH_DRIVERS, DAEMON_DRIVERS, CONTROL_DRIVERS, FLEET_DRIVERS, SCENARIO_DRIVERS)
ALL_DRIVERS = {site: drive for group in GROUPS for site, drive in group.items()}


def test_every_ported_site_has_one_driver():
    """The driver tables below fire every ported site, each from one table."""
    assert set(ALL_DRIVERS) == PORTED_SITES
    assert len(ALL_DRIVERS) == sum(map(len, GROUPS))


@pytest.mark.parametrize("site", sorted(CONTROL_DRIVERS))
def test_each_control_plane_site_fires_in_both_packages(tmp_path, site):
    for pkg in ("port", "ref"):
        fp = PKG[pkg].fp
        fp.inject(site, "error(OSError:site-chaos)*1")
        with pytest.raises(OSError, match="site-chaos"):
            CONTROL_DRIVERS[site](pkg, tmp_path / f"{pkg}1")
        assert fp.counts().get(site) == 1, pkg
        other = PKG["ref" if pkg == "port" else "port"].fp
        assert site not in other.counts(), pkg
        fp.clear()


@pytest.mark.parametrize("site", sorted(DAEMON_DRIVERS))
def test_each_daemon_site_fires_in_both_packages(tmp_path, site):
    for pkg in ("port", "ref"):
        fp = PKG[pkg].fp
        fp.inject(site, "error(OSError:site-chaos)*1")
        with pytest.raises(OSError, match="site-chaos"):
            DAEMON_DRIVERS[site](pkg, tmp_path)
        assert fp.counts().get(site) == 1, pkg
        other = PKG["ref" if pkg == "port" else "port"].fp
        assert site not in other.counts(), pkg
        if site == "daemon.rpc":  # one shot spent: the next call reaches the socket
            with pytest.raises(OSError) as exc:
                DAEMON_DRIVERS[site](pkg, tmp_path)
            assert "site-chaos" not in str(exc.value), pkg
        fp.clear()


@pytest.mark.parametrize("site", sorted(FETCH_DRIVERS))
def test_each_fetch_side_site_fires_in_both_packages(tmp_path, site):
    for pkg in ("port", "ref"):
        fp = PKG[pkg].fp
        fp.inject(site, "error(OSError:site-chaos)*1")
        try:
            FETCH_DRIVERS[site](pkg, tmp_path)
        except OSError as e:
            assert "site-chaos" in str(e), (pkg, e)
        assert fp.counts().get(site) == 1, pkg
        other = PKG["ref" if pkg == "port" else "port"].fp
        assert site not in other.counts(), pkg
        fp.clear()


@pytest.mark.parametrize("site", sorted(DRIVERS))
def test_each_ported_site_fires_in_both_packages(monkeypatch, tmp_path, site):
    monkeypatch.setenv("NTPU_PACK_THREADS", "4")
    monkeypatch.setenv("NTPU_PACK_THREADS_FORCE", "1")
    for pkg in ("port", "ref"):
        fp = PKG[pkg].fp
        drive = DRIVERS[site]
        with_path = site in ("dict.shard", "ha.replicate")
        run = (lambda: drive(pkg, tmp_path)) if with_path else (lambda: drive(pkg))
        fp.inject(site, "error(OSError:site-chaos)*1")
        with pytest.raises(OSError, match="site-chaos|status 500"):
            run()
        assert fp.counts().get(site) == 1, pkg
        other = PKG["ref" if pkg == "port" else "port"].fp
        assert site not in other.counts(), pkg  # never the other package's site
        run()  # one shot spent: the next call goes through
        fp.clear()


def test_fused_dispatch_counts_and_propagates_out_of_pack():
    """``fused.dispatch`` fires at the device batch boundary; an injected
    error leaves the fused pack (only FusedOverflow falls back), and the
    dispatch counters move as the reference's do."""
    disp = treg.default_registry.register(treg.Counter("ntpu_fused_convert_dispatches", ""))
    stage = treg.default_registry.register(
        treg.Counter("ntpu_fused_convert_stage_seconds", "", ("stage",)))
    before = disp.value(), stage.value("pass1_gear")
    opt = dict(chunk_size=0x10000, backend="fused")
    with tfp.injected("fused.dispatch", "error(OSError:fused-chaos)*1"):
        with pytest.raises(OSError, match="fused-chaos"):
            pack_layer(LAYER, PackOption(**opt), device="cpu")
    with jfp.injected("fused.dispatch", "error(OSError:fused-chaos)*1"):
        with pytest.raises(OSError, match="fused-chaos"):
            j_pack_layer(LAYER, JPackOption(**opt))
    assert tfp.counts()["fused.dispatch"] == 1
    blob, _ = pack_layer(LAYER, PackOption(**opt), device="cpu")
    assert blob == j_pack_layer(LAYER, JPackOption(**opt))[0]
    assert disp.value() == before[0] + 1 and stage.value("pass1_gear") > before[1]


def test_pipeline_panic_escapes_batch_converter(monkeypatch):
    monkeypatch.setenv("NTPU_PACK_THREADS", "4")
    monkeypatch.setenv("NTPU_PACK_THREADS_FORCE", "1")
    tfp.inject("pipeline.compress", "panic(boom)")
    bc = BatchConverter(PackOption(**PIPE), layer_fanout=2, device="cpu")
    with pytest.raises(tfp.Panic):
        bc.convert_many([("img", [LAYER, _tar(seed=6)])])


# -------------------------------------------------------------------- trace


@pytest.mark.parametrize("pkg", ["port", "ref"])
class TestTrace:
    def test_span_tree_parent_links(self, pkg):
        tr = PKG[pkg].trace
        with tr.span("root", k=1) as root:
            with tr.span("child") as child:
                with tr.span("grandchild") as gc:
                    pass
        assert child.parent_id == root.span_id and gc.parent_id == child.span_id
        assert {s.trace_id for s in (root, child, gc)} == {root.trace_id}
        assert [s.name for s in tr.snapshot_spans()] == ["root", "child", "grandchild"]

    def test_span_records_error_attr(self, pkg):
        tr = PKG[pkg].trace
        with pytest.raises(ValueError):
            with tr.span("op"):
                raise ValueError("bad thing")
        assert tr.snapshot_spans()[-1].attrs["error"] == "ValueError: bad thing"

    def test_sample_ratio_zero_produces_zero_spans(self, pkg):
        tr = PKG[pkg].trace
        tr.configure(enabled=True, sample_ratio=0.0)
        with tr.span("root"):
            with tr.span("child"):
                assert tr.capture() is not None and not tr.capture().sampled
        assert tr.snapshot_spans() == []

    def test_disabled_is_noop_and_capture_none(self, pkg):
        tr = PKG[pkg].trace
        tr.configure(enabled=False)
        with tr.span("x"):
            assert tr.capture() is None
        assert tr.snapshot_spans() == [] and not tr.enabled()

    def test_failpoint_annotates_current_span(self, pkg):
        p = PKG[pkg]
        p.fp.inject("site.a", "delay(0)")
        with p.trace.span("op"):
            p.fp.hit("site.a")
        assert p.trace.snapshot_spans()[-1].attrs["failpoints"] == ["site.a"]


@pytest.mark.parametrize("pkg", ["port", "ref"])
@pytest.mark.parametrize("capacity", [1, 7, 64])
def test_ring_concurrent_writers_keep_count(pkg, capacity):
    """len + dropped == pushes under concurrent writers, oldest first."""
    import threading

    ring_mod = __import__(PKG[pkg].trace.__name__ + ".ring", fromlist=["SpanRing"])
    ring = ring_mod.SpanRing(capacity)

    def write(base):
        for i in range(500):
            ring.push(SimpleNamespace(start=float(base + i)))

    threads = [threading.Thread(target=write, args=(k * 1000,)) for k in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert len(ring) + ring.dropped() == ring.pushes() == 4000
    assert len(ring) <= capacity
    starts = [sp.start for sp in ring.snapshot()]
    assert starts == sorted(starts)


@pytest.mark.parametrize(
    "env",
    [{}, {"NTPU_TRACE": "0"}, {"NTPU_TRACE_RING_CAPACITY": "17", "NTPU_TRACE_SLOW_OP_MS": "5",
                               "NTPU_TRACE_SAMPLE_RATIO": "0.25"},
     {"NTPU_TRACE_SAMPLE_RATIO": "7", "NTPU_TRACE_SLOW_OP_MS": "x"}],
    ids=["defaults", "off", "knobs", "clamped"],
)
def test_env_resolution_matches_reference(monkeypatch, env):
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    assert ttrace.resolve_trace_config().__dict__ == jtrace.resolve_trace_config().__dict__


def test_chrome_export_matches_reference():
    spans = [
        SimpleNamespace(name=f"s{i}", trace_id=7, span_id=10 + i, parent_id=(10 if i else 0),
                        start=1000.0 + i, duration_ms=2.5 * i, attrs={"i": i}, thread="t")
        for i in range(3)
    ]
    from nydus_snapshotter_tpu.trace import export as jexport
    from nydus_snapshotter_tpu_torch.trace import export as texport

    assert texport.to_chrome_trace(spans) == jexport.to_chrome_trace(spans)
    assert texport.format_tree(spans, 7) == jexport.format_tree(spans, 7)
    with ttrace.span("a"):
        pass
    doc = json.loads(ttrace.chrome_trace_bytes())
    assert [e["name"] for e in doc["traceEvents"] if e.get("ph") == "X"] == ["a"]


def test_propagation_across_pipeline_workers(monkeypatch):
    """Each pipeline worker opens one span in the converting caller's
    trace, as the reference's do."""
    monkeypatch.setenv("NTPU_PACK_THREADS", "4")
    monkeypatch.setenv("NTPU_PACK_THREADS_FORCE", "1")
    for tr, pack in ((ttrace, lambda: pack_layer(LAYER, PackOption(**PIPE), device="cpu")),
                     (jtrace, lambda: j_pack_layer(LAYER, JPackOption(**PIPE)))):
        with tr.span("convert") as root:
            pack()
        workers = [s for s in tr.snapshot_spans() if s.name.startswith("convert.")]
        assert {s.name for s in workers} == {"convert.chunk.worker", "convert.compress.worker"}
        assert all(s.trace_id == root.trace_id and s.parent_id == root.span_id for s in workers)


def test_propagation_across_batch_converter_layers(monkeypatch):
    """One ``convert`` span per image; every layer's pipeline workers,
    run on the fan-out's threads, join its trace."""
    monkeypatch.setenv("NTPU_PACK_THREADS", "4")
    monkeypatch.setenv("NTPU_PACK_THREADS_FORCE", "1")
    layers = [LAYER, _tar(seed=6)]
    for tr, bc in ((ttrace, BatchConverter(PackOption(**PIPE), layer_fanout=2, device="cpu")),
                   (jtrace, JBatchConverter(JPackOption(**PIPE), layer_fanout=2))):
        bc.convert_many([("img", layers)])
        spans = tr.snapshot_spans()
        roots = [s for s in spans if s.name == "convert"]
        assert len(roots) == 1 and roots[0].attrs == {"image": "img", "layers": 2}
        workers = [s for s in spans if s.name == "convert.chunk.worker"]
        assert len(workers) >= 2 and {s.trace_id for s in workers} == {roots[0].trace_id}


def test_dict_rpc_span_joins_client_trace(tmp_path):
    """A probe RPC from inside a span: the service's ``dict.rpc.probe``
    span carries the client's trace id and parents on the client's span;
    ``/metrics`` shows the RPC counters and ``/api/v1/traces`` the span."""
    import http.client
    import socket

    boot = pack_layer(LAYER, PackOption(chunk_size=0x10000, backend="hybrid"), device="cpu")[1].bootstrap
    svc = tds.DictService(device="cpu")
    svc.run(str(tmp_path / "d.sock"))
    try:
        cli = tds.DictClient(svc.sock_path)
        cli.merge(boot, "ns")
        digs = [c.digest for c in tds.Bootstrap.from_bytes(boot).chunks][:3]
        with ttrace.span("convert") as root:
            assert list(cli.probe(digs, "ns")) == [0, 1, 2]
        rpc = [s for s in ttrace.snapshot_spans() if s.name == "dict.rpc.probe"]
        assert len(rpc) == 1
        assert (rpc[0].trace_id, rpc[0].parent_id) == (root.trace_id, root.span_id)
        assert rpc[0].attrs["namespace"] == "ns"
        jcli = jds.DictClient(svc.sock_path)  # the reference's client sends the same headers
        with jtrace.span("convert") as jroot:
            jcli.probe(digs, "ns")
        assert [s.trace_id for s in ttrace.snapshot_spans() if s.name == "dict.rpc.probe"][-1] == \
            jroot.trace_id

        class Conn(http.client.HTTPConnection):
            def connect(self):
                self.sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
                self.sock.connect(svc.sock_path)

        # the RPC counters live outside the default registry, as the
        # reference's do; /metrics renders the default registry
        assert tds._RPC_TOTAL.value("probe") >= 2 and tds._RPC_MS.labels("probe")
        for path, want in (("/metrics", "# TYPE ntpu_trace_spans_total counter"),
                           ("/api/v1/traces", '"dict.rpc.probe"')):
            c = Conn("localhost")
            c.request("GET", path)
            resp = c.getresponse()
            body = resp.read().decode()
            c.close()
            assert resp.status == 200 and want in body
        cli.close()
        jcli.close()
    finally:
        svc.stop()


# ------------------------------------------------------------------ metrics


def _metric_updates(reg_mod):
    clock = SimpleNamespace(now=0.0)
    r = reg_mod.Registry()
    c = r.register(reg_mod.Counter("ntpu_x_total", "x help", ("op",)))
    c.labels("probe").inc()
    c.labels("merge").inc(2.5)
    c.labels('we"ird\\').inc(3)
    plain = r.register(reg_mod.Counter("ntpu_plain_total", "plain"))
    plain.inc(4)
    r.register(reg_mod.Counter("ntpu_plain_total", "registered twice"))
    g = r.register(reg_mod.Gauge("ntpu_g", "g help", ("q",)))
    g.labels("a").set(1.5)
    g.labels("b").set(float("inf"))
    r.register(reg_mod.Gauge("ntpu_empty", "no series"))
    h = r.register(reg_mod.Histogram("ntpu_ms", "h help", ("op",), buckets=(1, 5, 10)))
    for v in (0.5, 3, 7, 20):
        h.labels("probe").observe(v)
    t = r.register(reg_mod.TTLGauge("ntpu_ttl", "ttl", ("d",), ttl_sec=10, clock=lambda: clock.now))
    t.labels("old").set(1)
    clock.now = 20.0
    t.labels("new").set(2)
    return r.render()


def test_registry_render_matches_reference():
    """The same sequence of updates renders the same exposition text."""
    got = _metric_updates(treg)
    assert got == _metric_updates(jreg)
    assert 'ntpu_x_total{op="we\\"ird\\\\"} 3' in got and "ntpu_ttl{d=\"old\"}" not in got


def test_pipeline_metrics_render_equal_after_same_pack(monkeypatch):
    """The pipeline's series exist under the reference's names in the
    port's default registry after a pipelined pack."""
    monkeypatch.setenv("NTPU_PACK_THREADS", "4")
    monkeypatch.setenv("NTPU_PACK_THREADS_FORCE", "1")
    from nydus_snapshotter_tpu_torch.parallel import pipeline as tpl

    before = tpl.snapshot_counters()
    pack_layer(LAYER, PackOption(**PIPE), device="cpu")
    after = tpl.snapshot_counters()
    assert after["runs"] == before["runs"] + 1
    assert after["stage_items"]["chunk"] == before["stage_items"]["chunk"] + 6
    text = treg.default_registry.render()
    for name in ("ntpu_convert_pipeline_stage_busy_seconds", "ntpu_convert_pipeline_runs",
                 "ntpu_trace_spans_total"):
        assert f"# TYPE {name} " in text
