"""The PyTorch port stands alone: no JAX, no reference package, no silent CPU.

tests/conftest.py imports jax into every test process, so the import check
runs the port's main path in a fresh interpreter.
"""

import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from nydus_snapshotter_tpu_torch import entry
from nydus_snapshotter_tpu_torch.converter import PackOption, pack_layer
from nydus_snapshotter_tpu_torch.converter.batch import BatchConverter
from nydus_snapshotter_tpu_torch.ops.chunker import ChunkDigestEngine, DeviceDigester
from nydus_snapshotter_tpu_torch.ops.fused_convert import FusedDeviceEngine
from nydus_snapshotter_tpu_torch.parallel import dict_service, mesh, sharded_dict

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_CHILD = textwrap.dedent(
    """
    import hashlib, io, sys, tarfile
    import numpy as np
    from nydus_snapshotter_tpu_torch import entry
    from nydus_snapshotter_tpu_torch.converter import PackOption, pack_layer
    from nydus_snapshotter_tpu_torch.ops.chunker import ChunkDigestEngine
    from nydus_snapshotter_tpu_torch.ops.fused_convert import FusedDeviceEngine
    from nydus_snapshotter_tpu_torch.parallel import sharded_dict

    data = np.random.default_rng(1).integers(0, 256, 20_000, dtype=np.uint8).tobytes()
    eng = FusedDeviceEngine(chunk_size=0x1000, device="cpu")
    res = eng.process_many([data, b"abc"])
    assert res.digests[1] == [hashlib.sha256(b"abc").digest()]
    buf = io.BytesIO()
    with tarfile.open(fileobj=buf, mode="w") as tf:
        ti = tarfile.TarInfo("f"); ti.size = 3; tf.addfile(ti, io.BytesIO(b"abc"))
    pack_layer(buf.getvalue(), PackOption(chunk_size=0x1000), device="cpu")
    pack_layer(buf.getvalue(), PackOption(chunk_size=0x1000, backend="jax"), device="cpu")
    # the compressed lanes: lz4_block (the default, above) and zstd with the
    # rest of the option surface
    import os, tempfile
    _b, res = pack_layer(buf.getvalue(), PackOption(chunk_size=0x1000, compressor="zstd",
                                                     batch_size=0x1000), device="cpu")
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "dict.boot")
        open(path, "wb").write(res.bootstrap)
        for backend in ("fused", "jax", "numpy"):
            _b, r2 = pack_layer(buf.getvalue(), PackOption(
                chunk_size=0x1000, backend=backend, compressor="zstd", prefetch_patterns="/f",
                chunk_dict_path="bootstrap=" + path), device="cpu")
            assert r2.referenced_blob_ids == [res.blob_id]
    metas = ChunkDigestEngine(chunk_size=0x1000, device="cpu").process_many([data, b"abc"])
    assert [m.digest for m in metas[1]] == [hashlib.sha256(b"abc").digest()]
    from nydus_snapshotter_tpu_torch.utils import blake3 as pyb3
    b3 = FusedDeviceEngine(chunk_size=0x1000, digester="blake3", device="cpu").process_many([b"abc"])
    assert b3.digests[0] == [pyb3.blake3(b"abc")]
    for backend in ("fused", "jax", "hybrid", "numpy"):
        pack_layer(buf.getvalue(), PackOption(chunk_size=0x1000, backend=backend, digester="blake3"),
                   device="cpu")
        metas = ChunkDigestEngine(chunk_size=0x1000, backend=backend, digester="blake3",
                                  device="cpu").process_many([b"abc"])
        assert [m.digest for m in metas[0]] == [pyb3.blake3(b"abc")]
    # the growing dict: grow, save, load, save_incremental; the dict service
    d = sharded_dict.ShardedChunkDict(np.random.default_rng(2).integers(
        0, 2**32, (500, 8), dtype=np.uint32), device="cpu")
    grow = np.random.default_rng(3).integers(0, 2**32, (100, 8), dtype=np.uint32)
    assert list(d.insert_u32(grow)) == list(range(500, 600))
    from nydus_snapshotter_tpu_torch.parallel import dict_service
    with tempfile.TemporaryDirectory() as t:
        path = os.path.join(t, "d.dict")
        d.save(path)
        d.insert_u32(grow[:10] + 1)
        assert d.save_incremental(path) == {"mode": "append", "appended": 10}
        again = sharded_dict.ShardedChunkDict.load(path, device="cpu")
        assert list(again.lookup_u32(grow[:10] + 1)) == list(range(600, 610))
        svc = dict_service.DictService(device="cpu")
        svc.run(os.path.join(t, "dict.sock"))
        try:
            cli = dict_service.DictClient(svc.sock_path)
            assert cli.merge(res.bootstrap, "ns")["added"] > 0
            digs = [c.digest for c in dict_service.Bootstrap.from_bytes(res.bootstrap).chunks]
            assert list(cli.probe(digs[:1], "ns")) == [0]
            cli.close()
        finally:
            svc.stop()
    # image-level conversion: Merge (native and real layouts), Unpack, the
    # real-format reader and writers, BatchConverter
    from nydus_snapshotter_tpu_torch.converter import Merge, MergeOption, Unpack
    from nydus_snapshotter_tpu_torch.converter import batch, convert
    from nydus_snapshotter_tpu_torch.models import nydus_real, nydus_real_write
    blob, res = pack_layer(buf.getvalue(), PackOption(chunk_size=0x1000, chunking="fixed"),
                           device="cpu")
    for fmt in ("native", "rafs-v5", "rafs-v6"):
        boot = Merge([blob], MergeOption(bootstrap_format=fmt)).bootstrap
        out = Unpack(nydus_real.load_any_bootstrap(boot),
                     {res.blob_id: convert.blob_data_from_layer_blob(blob)})
        assert tarfile.open(fileobj=io.BytesIO(out)).extractfile("f").read() == b"abc"
    real = nydus_real_write.real_from_bootstrap(convert.bootstrap_from_layer_blob(blob))
    assert nydus_real.parse_real_v6(nydus_real_write.write_real_v6(real)).inodes
    results = batch.BatchConverter(PackOption(chunk_size=0x1000), layer_fanout=2,
                                   device="cpu").convert_many([("i", [buf.getvalue()] * 2)])
    assert results[0].blob_digests == [res.blob_id]
    # the planes and the stage-parallel pipeline
    from nydus_snapshotter_tpu_torch import analysis, failpoint, metrics, trace
    from nydus_snapshotter_tpu_torch.analysis import runtime
    from nydus_snapshotter_tpu_torch.config import config as cfg_mod
    from nydus_snapshotter_tpu_torch.metrics import registry
    from nydus_snapshotter_tpu_torch.parallel import pipeline
    from nydus_snapshotter_tpu_torch.trace import export, ring
    cfg_mod.set_global_config(cfg_mod.load_config(overrides={"convert": {"pipeline": "on"}}))
    many = io.BytesIO()
    with tarfile.open(fileobj=many, mode="w") as tf:
        for i in range(3):
            ti = tarfile.TarInfo(f"m{i}"); ti.size = len(data); tf.addfile(ti, io.BytesIO(data))
    os.environ["NTPU_PACK_THREADS"] = "4"; os.environ["NTPU_PACK_THREADS_FORCE"] = "1"
    with trace.span("convert"):
        _b, res = pack_layer(many.getvalue(), PackOption(chunk_size=0x2000, backend="hybrid",
                                                          batch_size=0x1000))
    assert res.route["lane"] == "pipeline", res.route
    assert any(s.name == "convert.chunk.worker" for s in trace.snapshot_spans())
    assert "ntpu_convert_pipeline_runs" in metrics.default_registry.render()
    failpoint.inject("converter.pack", "error(OSError:x)*1")
    try:
        pack_layer(many.getvalue(), PackOption(chunk_size=0x1000, backend="hybrid"))
        raise AssertionError("converter.pack did not fire")
    except OSError:
        pass
    failpoint.clear()
    # the adaptive codec (a trained dictionary's nZD1 frames read back), the
    # blob cipher, and the bootstrap-layer encryption with its content store
    from nydus_snapshotter_tpu_torch.converter import codec, content, crypto
    from nydus_snapshotter_tpu_torch.encryption import decrypt_layer, encrypt_layer
    from nydus_snapshotter_tpu_torch.remote.registry import Descriptor
    from nydus_snapshotter_tpu_torch.utils import zstd
    text = b" ".join(b"w%d" % (i % 89) for i in range(20_000))
    words = io.BytesIO()
    with tarfile.open(fileobj=words, mode="w") as tf:
        ti = tarfile.TarInfo("t"); ti.size = len(text); tf.addfile(ti, io.BytesIO(text))
    td = codec.TrainedDict(zstd.train_dict([text[i:i + 2000] for i in range(0, len(text), 2000)],
                                           8 << 10), epoch=1)
    c = codec.AdaptiveCodec(codec.CodecConfig(adaptive=True), trained=td)
    for opt in (PackOption(chunk_size=0x1000, compressor="zstd", backend="fused"),
                PackOption(chunk_size=0x1000, compressor="zstd", backend="fused", encrypt=True)):
        blob, res = pack_layer(words.getvalue(), opt, device="cpu", codec=c)
        assert res.route["writer"] == "serial"
        out = Unpack(res.bootstrap, {res.blob_id: convert.blob_data_from_layer_blob(blob)})
        assert tarfile.open(fileobj=io.BytesIO(out)).extractfile("t").read() == text
    assert c.stats()["counts"]["default"] > 0
    from cryptography.hazmat.primitives import serialization
    from cryptography.hazmat.primitives.asymmetric import rsa
    key = rsa.generate_private_key(public_exponent=65537, key_size=2048)
    priv = key.private_bytes(serialization.Encoding.PEM, serialization.PrivateFormat.PKCS8,
                             serialization.NoEncryption())
    pub = key.public_key().public_bytes(serialization.Encoding.PEM,
                                        serialization.PublicFormat.SubjectPublicKeyInfo)
    with tempfile.TemporaryDirectory() as t:
        cs = content.LocalContentStore(t)
        info = cs.write_blob(blob)
        desc = Descriptor(media_type="application/vnd.oci.image.layer.v1.tar", digest=info.digest,
                          size=info.size)
        enc_desc, ct = encrypt_layer(blob, desc, [pub])
        assert decrypt_layer(ct, enc_desc, [priv])[1] == blob
    assert crypto.decrypt_range(crypto.encrypt(text, b"k" * 32, b"i" * 16)[5:9], 5, b"k" * 32,
                                b"i" * 16) == text[5:9]
    fwd, args = entry.entry(device="cpu")
    # the device mesh: a multi-shard dict through both mesh probes, the
    # sharded convert step, the multi-host runtime's single-host view
    from nydus_snapshotter_tpu_torch.ops import mesh_pack
    from nydus_snapshotter_tpu_torch.parallel import mesh, multihost
    m4 = mesh.make_mesh(4, devices=["cpu"] * 4)
    md = sharded_dict.ShardedChunkDict(grow, m4, probe_backend="device")
    assert list(md.lookup_u32(grow[:9])) == list(range(9))
    rep = {}
    cuts, digs, boot = entry.sharded_convert_step([data, b"abc"], 0x1000, 4, m4, report=rep)
    assert digs[1] == [hashlib.sha256(b"abc").digest()] and rep["pack"] == "extent"
    assert mesh_pack.resolve_mesh_config().pack == "extent"
    assert multihost.runtime().count == 1
    # the HA dict plane: placement pushes roles, a replica tails its
    # primary, a down report promotes it, a failover group's mirror repairs
    # and replays onto it; the fleet member half and the runner module
    import gzip, json, time
    from nydus_snapshotter_tpu_torch import fleet, ha
    from nydus_snapshotter_tpu_torch.ha import placement, replicate, runner
    from nydus_snapshotter_tpu_torch.utils import udshttp
    assert ha.resolve_ha_config().budget_bytes == 256 << 10 and callable(runner.main)
    boot_a = pack_layer(buf.getvalue(), PackOption(chunk_size=0x1000), device="cpu")[1].bootstrap
    boot_b = pack_layer(many.getvalue(), PackOption(chunk_size=0x1000, backend="hybrid"))[1].bootstrap
    with tempfile.TemporaryDirectory() as t:
        svcs = [dict_service.DictService(device="cpu") for _ in range(2)]
        for i, svc in enumerate(svcs):
            replicate.HaAgent(svc, role="unassigned")
            svc.run(os.path.join(t, f"m{i}.sock"))
        try:
            members = [fleet.Member(name=f"d{i}", component="dict", address=s.sock_path, pid=i)
                       for i, s in enumerate(svcs)]
            pc = placement.PlacementController(lambda: members, lambda: {}, shards=1, replicas=1)
            assert pc.tick()
            seat = pc.map()["assignments"][0]["primary"]
            prim = next(s for s in svcs if s.sock_path == seat["address"])
            repl = next(s for s in svcs if s is not prim)
            mirror = dict_service.open_chunk_dict(f"service://{prim.sock_path}|{repl.sock_path}")
            mirror.add_bootstrap_bytes(boot_a)
            deadline = time.monotonic() + 30
            while len(repl.dict_for("default").records.bootstrap.chunks) < len(mirror):
                assert time.monotonic() < deadline
                time.sleep(0.02)
            prim.stop()
            pc.report_down(seat["name"])
            assert pc.tick() and repl.ha.is_primary()
            assert udshttp.get_json(repl.sock_path, "/api/v1/ha/status")["role"] == "primary"
            mirror.add_bootstrap_bytes(boot_b)
            assert len(repl.dict_for("default").records.bootstrap.chunks) == len(mirror)
            mirror.close()
        finally:
            for s in svcs:
                s.stop()
    # the OCIRef paths: a gzip and a zstd ref layer read lazily and unpacked,
    # the hooks over a content store (packed and oci_ref), decompress_stream
    from nydus_snapshotter_tpu_torch.converter import hooks, zran, zstd_ref
    from nydus_snapshotter_tpu_torch.remote import unpack
    raw = gzip.compress(many.getvalue(), mtime=0)
    assert unpack.decompress_stream(raw) == many.getvalue()
    refs = [(zran.pack_gzip_layer(raw, PackOption(chunk_size=0x4000, oci_ref=True)), raw)]
    if zstd.frames_available():
        zraw = zstd.compress_block(many.getvalue(), 3)
        refs.append((zstd_ref.pack_zstd_layer(zraw, PackOption(chunk_size=0x4000)), zraw))
    for bs, blob in refs:
        out = Unpack(bs, {bs.blobs[0].blob_id: blob})
        assert tarfile.open(fileobj=io.BytesIO(out)).extractfile("m2").read() == data
    with tempfile.TemporaryDirectory() as t:
        cs = content.LocalContentStore(t)
        layer = cs.write_blob(raw)
        cfg = cs.write_blob(json.dumps({"rootfs": {"diff_ids": []}}).encode())
        man = cs.write_blob(json.dumps({
            "schemaVersion": 2, "mediaType": "application/vnd.oci.image.manifest.v1+json",
            "config": {"mediaType": "application/vnd.oci.image.config.v1+json",
                       "digest": cfg.digest, "size": cfg.size},
            "layers": [{"mediaType": "application/vnd.oci.image.layer.v1.tar+gzip",
                        "digest": layer.digest, "size": layer.size}]}).encode())
        desc = Descriptor("application/vnd.oci.image.manifest.v1+json", man.digest, man.size)
        for oci_ref in (False, True):
            new = hooks.convert_image(cs, desc, PackOption(chunk_size=0x4000, oci_ref=oci_ref),
                                      MergeOption(oci=True), device="cpu")
            assert hooks.is_nydus_image(json.loads(cs.read(new.digest)))
    # the converter CLI (a device-lane pack on the CPU, then every verb on
    # its output), the tar-tarfs builder and its EROFS export, the corpora
    import contextlib, json
    from nydus_snapshotter_tpu_torch import tarfs
    from nydus_snapshotter_tpu_torch.cmd import convert as cli
    from nydus_snapshotter_tpu_torch.converter import cs_proxy, feature
    from nydus_snapshotter_tpu_torch.models import erofs_image
    from nydus_snapshotter_tpu_torch.scenario import arrivals, corpus, evolution, spec
    assert feature.detect_features(device="cpu").contains(feature.Feature.DEVICE_DIGEST)
    layer = corpus.cdc_resonant_layer(1, 1, 0x1000, "min")
    with tempfile.TemporaryDirectory() as t:
        src = os.path.join(t, "l.tar")
        open(src, "wb").write(layer)
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            assert cli.main(["--device", "cpu", "pack", "--backend", "fused", "--chunk-size", "0x1000",
                             "--in", src, "--out", os.path.join(t, "l.nydus")]) == 0
            assert cli.main(["merge", os.path.join(t, "l.nydus"), "--out", os.path.join(t, "i.boot")]) == 0
            assert cli.main(["check", "--boot", os.path.join(t, "i.boot")]) == 0
        assert json.loads(out.getvalue().splitlines()[0])["blob_size"] > 0
        bs = tarfs.tarfs_bootstrap_from_tar(io.BytesIO(layer), "t" * 64, chunk_size=0x1000,
                                            engine=ChunkDigestEngine(chunk_size=0x1000, device="cpu"))
        assert int.from_bytes(erofs_image.erofs_from_rafs(bs)[1024:1028], "little") == erofs_image.EROFS_MAGIC
    assert spec.list_specs(os.path.join(os.getcwd(), "misc", "scenarios"))
    assert 0 < evolution.shared_fraction(corpus.load_manifest(), 23, 0.08, 8) < 1
    # the registry read path and the tarfs manager, against a small
    # in-process registry over plain HTTP
    import base64, gzip, threading
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
    from nydus_snapshotter_tpu_torch import failpoint
    from nydus_snapshotter_tpu_torch.api.filters import compile_filters
    from nydus_snapshotter_tpu_torch.auth import keychain
    from nydus_snapshotter_tpu_torch.backend import new_backend
    from nydus_snapshotter_tpu_torch.backend.oss import OSSBackend
    from nydus_snapshotter_tpu_torch.backend.s3 import S3Backend
    from nydus_snapshotter_tpu_torch.config import daemonconfig, mirrors
    from nydus_snapshotter_tpu_torch.remote import (
        MirrorRouter, Pool, RegistryClient, Remote, Resolver, parse_docker_ref, registry, schema1)
    from nydus_snapshotter_tpu_torch.utils import losetup, mount, retry, singleflight
    blobs = {}

    class H(BaseHTTPRequestHandler):
        def log_message(self, *a):
            pass

        def do_GET(self):
            key = self.path.rsplit("/", 1)[-1]
            body = blobs.get(key)
            if body is None:
                self.send_response(404); self.end_headers(); return
            rng = self.headers.get("Range")
            if rng:
                lo, hi = (int(x) for x in rng[6:].split("-"))
                body = body[lo:hi + 1]
            self.send_response(206 if rng else 200)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

    srv = ThreadingHTTPServer(("127.0.0.1", 0), H)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    host = f"127.0.0.1:{srv.server_address[1]}"

    def add(body):
        d = "sha256:" + hashlib.sha256(body).hexdigest()
        blobs[d] = body
        return d

    ltar = buf.getvalue()
    ldig = add(gzip.compress(ltar))
    cfg = json.dumps({"rootfs": {"diff_ids": ["sha256:" + hashlib.sha256(ltar).hexdigest()]}}).encode()
    mdig = add(json.dumps({"schemaVersion": 2, "config": {"digest": add(cfg)},
                           "layers": [{"digest": ldig}]}).encode())
    client = RegistryClient(host, plain_http=True)
    r = client.fetch_blob("x/y", mdig, byte_range=(0, 9)); assert len(r.read()) == 10; r.close()
    assert Pool(plain_http=True).resolve(parse_docker_ref(f"{host}/x/y:v1"), ldig)[0].endswith(ldig)
    r = Resolver(plain_http=True).resolve(f"{host}/x/y:v1", ldig, labels={}); r.read(); r.close()
    failpoint.inject("transport.fetch_blob", "error(HTTPError:503)*1")
    try:
        client.fetch_blob("x/y", ldig)
        raise AssertionError("failpoint did not fire")
    except registry.HTTPError as e:
        assert e.code == 503
    assert schema1.is_schema1("application/vnd.docker.distribution.manifest.v1+json")
    assert retry.do_with_deadline(lambda: 7, deadline=1.0, attempts=2, delay=0.0) == 7
    assert singleflight.Group().do("k", lambda: 3) == (3, False)
    assert compile_filters(["name==a"])(type("I", (), {"name": "a", "labels": {}})())
    assert keychain.from_labels({}) is None
    with tempfile.TemporaryDirectory() as t:
        os.makedirs(os.path.join(t, "m", "docker.io"))
        open(os.path.join(t, "m", "docker.io", "hosts.toml"), "w").write('[host."https://m.example"]\\n')
        assert [m.host for m in MirrorRouter(os.path.join(t, "m")).candidates("docker.io")] == ["https://m.example"]
        assert mirrors.load_mirrors_config(os.path.join(t, "m"), "docker.io")[0].failure_limit == 5
        assert daemonconfig.DaemonRuntimeConfig.from_dict({}, "fusedev").to_dict()
        b = new_backend("localfs", {"dir": os.path.join(t, "b")}); b.push(b"x", add(b"x")); b.check(add(b"x"))
        assert S3Backend({"bucket_name": "b", "region": "r"}).type() == "s3"
        assert OSSBackend({"endpoint": "e.example", "bucket_name": "b"}).type() == "oss"
        orig = Remote.__init__
        def plain(self, keychain=None, insecure=False):
            orig(self, keychain=keychain, insecure=insecure)
            self.with_plain_http = True
        Remote.__init__ = plain

        class Rec:
            def attach(self, path, offset=0, ro=True):
                return losetup.LoopDevice(0)
            def detach(self, dev):
                pass
            def mount(self, source, target, fstype, options=""):
                pass
            def umount(self, target, flags=0):
                pass
        losetup.backend = mount.backend = Rec()
        mgr = tarfs.Manager(os.path.join(t, "cache"), export_mode="image_block_with_verity",
                            engine=ChunkDigestEngine(chunk_size=0x1000, device="cpu"))
        upper = os.path.join(t, "s", "1", "fs")
        os.makedirs(upper)
        from nydus_snapshotter_tpu_torch import constants as C
        mgr.prepare_layer({C.CRI_IMAGE_REF: f"{host}/x/y:v1", C.CRI_MANIFEST_DIGEST: mdig,
                           C.CRI_LAYER_DIGEST: ldig}, "1", upper)
        mgr.wait_layer_ready("1")
        snap = type("S", (), {"id": "0", "parent_ids": ["1"]})()
        mgr.merge_layers(snap, lambda sid: upper)
        labels = {C.NYDUS_TARFS_LAYER: ldig.split(":")[1]}
        mgr.export_block_data(snap, False, labels, lambda sid: upper)
        assert tarfs.parse_block_info_label(labels[C.NYDUS_IMAGE_BLOCK_INFO]).data_blocks > 0
        mgr.mount_on_host = True
        rafs = type("R", (), {"snapshot_dir": os.path.join(t, "s", "1"), "mountpoint": "", "annotations": {}})()
        mgr.mount_tar_erofs("1", snap, labels, rafs)
        mgr.umount_tar_erofs("1"); mgr.detach_layer("1")
    # the fetch side: a CachedBlob over RegistryBlobFetcher against the
    # registry above, its ledger and heat; a peer server and the waterfall
    # fetcher over UDS; prefetch replay; the cache manager; the SLO loop
    from types import SimpleNamespace
    from nydus_snapshotter_tpu_torch import cache, daemon, prefetch, provenance
    from nydus_snapshotter_tpu_torch.daemon import blobcache, fetch_sched, peer
    from nydus_snapshotter_tpu_torch.metrics import slo
    from nydus_snapshotter_tpu_torch.metrics.registry import Histogram, Registry
    gzb = blobs[ldig]
    lhex = ldig.split(":")[1]
    fetcher = blobcache.RegistryBlobFetcher(SimpleNamespace(host=host, repo="x/y", scheme="http", auth="",
                                                            skip_verify=False, mirrors=[]), lhex)
    with tempfile.TemporaryDirectory(prefix="i", dir="/tmp") as t:
        cb = blobcache.CachedBlob(os.path.join(t, "a"), lhex, fetcher.read_range, blob_size=len(gzb))
        assert cb.read_at(3, 40) == gzb[3:43] and cb.read_at(0, len(gzb)) == gzb
        cons = provenance.conservation(lhex)
        assert cons["exact"] and cons["fetched_bytes"] >= cb.coverage_bytes() == len(gzb)
        assert provenance.compile_heat(lhex, os.path.join(t, "a"), source_size=len(gzb)) is not None
        assert provenance.load_or_adopt_heat([os.path.join(t, "a")], lhex, source_size=len(gzb))
        export = peer.PeerExport(); export.register(lhex, cb)
        server = peer.PeerChunkServer(export, pull_through=False)
        server.run(os.path.join(t, "p.sock"))
        router = peer.PeerRouter([os.path.join(t, "p.sock")], region_bytes=4096)
        pf = peer.PeerAwareFetcher(lhex, lambda o, n: 1 / 0, router)
        cb2 = blobcache.CachedBlob(os.path.join(t, "b"), lhex, pf.read_range, blob_size=len(gzb))
        assert cb2.read_at(0, len(gzb)) == gzb
        server.stop(); cb2.close()
        rec = SimpleNamespace(compressed_offset=0, compressed_size=16)
        bs = SimpleNamespace(chunks=[rec])
        ino = SimpleNamespace(chunk_index=0, chunk_count=1, hardlink_target="")
        warm = lambda r: ([f.wait() for f in cb.warm(r.compressed_offset, r.compressed_size)], 16)[1]
        assert fetch_sched.PrefetchReplayer(bs, {"/f": ino}, warm).replay(["/f"]) == 16
        cb.close()
        mgr = cache.CacheManager(os.path.join(t, "a"))
        assert mgr.cache_usage(lhex).inodes == 3
        mgr.gc_watermark(1)
        assert mgr.cache_usage(lhex).inodes == 0
    assert prefetch.Pm.paths_for("none") == [] and daemon.DaemonState
    hist = Histogram("op_ms", "t", buckets=(100,)); reg = Registry(); reg.register(hist)
    eng = slo.SloEngine([slo.SloObjective(name="o", metric="op_ms", threshold_ms=100.0, target=0.9,
                                          window_secs=10.0)], source=slo.local_source(reg))
    eng.tick()
    slo.SloActuator(eng, gate=fetch_sched.AdmissionGate(name="iso")).tick()
    srv.shutdown(); srv.server_close()
    # the lazy formats: a gzip layer routed, indexed and prepared by the
    # soci adaptor, its index reloaded and read; a seekable zstd layer
    # routed; an eStargz TOC built into a bootstrap; the referrer manager
    from nydus_snapshotter_tpu_torch import referrer, soci, stargz
    from nydus_snapshotter_tpu_torch.soci import toc as ztoc, zblob, zframe
    mtar = many.getvalue()
    gzl = gzip.compress(mtar, mtime=0)
    hexd = hashlib.sha256(gzl).hexdigest()
    with tempfile.TemporaryDirectory() as t:
        ad = soci.SociAdaptor(lambda s: os.path.join(t, "up", s), cache_dir=os.path.join(t, "cache"),
                              chunk_size=0x1000)
        ad.prepare_meta_layer(stargz.Blob("r", "sha256:" + hexd, lambda o, n: gzl[o:o + n], len(gzl)),
                              os.path.join(t, "up", "1"))
        idx, outcome = soci.load_or_build_index([os.path.join(t, "cache")], hexd, csize=len(gzl))
        assert outcome == "loaded"
        assert soci.SociStreamReader(idx, lambda o, n: gzl[o:o + n]).read_range(700, 9000) == mtar[700:9700]
    zs = zframe.write_seekable(mtar, frame_usize=16 << 10)
    assert soci.FormatRouter().route(lambda o, n: zs[o:o + n], len(zs)).backend == "seekable-index"
    zidx, _ = zblob.build_zindex_from_zstd("ef" * 32, zs)
    assert soci.ZstdStreamReader(zidx, lambda o, n: zs[o:o + n]).read_range(30_000, 5000) == mtar[30_000:35_000]
    chunked = ztoc.write_zstd_chunked({"m0": data}, chunk_size=0x2000)
    assert ztoc.read_toc(lambda o, n: chunked[o:o + n], len(chunked))
    toc = {"version": 1, "entries": [{"name": "a/b", "type": "reg", "size": 3, "offset": 0,
                                      "chunkDigest": "sha256:" + hashlib.sha256(b"abc").hexdigest()}]}
    assert "/a/b" in {i.path for i in stargz.bootstrap_from_toc(toc, "cd" * 32).inodes}
    assert referrer.ReferrerManager().insecure is False
    bad = sorted(m for m in sys.modules if m == "jax" or m.startswith("jax.")
                 or m == "nydus_snapshotter_tpu" or m.startswith("nydus_snapshotter_tpu."))
    print("LEAKED", bad)
    sys.exit(1 if bad else 0)
    """
)


_HYBRID_CHILD = textwrap.dedent(
    """
    import hashlib, io, os, sys, tarfile
    import numpy as np
    import torch

    def refuse(*a, **k):
        raise AssertionError("the hybrid lane touched CUDA")

    for name in ("is_available", "init", "current_device", "device_count", "set_device",
                 "Stream", "Event", "synchronize", "current_stream"):
        setattr(torch.cuda, name, refuse)
    from nydus_snapshotter_tpu_torch.converter import PackOption, pack_layer
    from nydus_snapshotter_tpu_torch.ops.chunker import ChunkDigestEngine

    rng = np.random.default_rng(4)
    data = rng.integers(0, 256, 90_000, dtype=np.uint8).tobytes()
    buf = io.BytesIO()
    with tarfile.open(fileobj=buf, mode="w") as tf:
        for i, n in enumerate((3, 900, 90_000)):
            ti = tarfile.TarInfo(f"f{i}"); ti.size = n; tf.addfile(ti, io.BytesIO(data[:n]))
    for digester in ("sha256", "blake3"):
        eng = ChunkDigestEngine(chunk_size=0x1000, backend="hybrid", digester=digester)
        assert eng.device is None and eng.device_digester is None
        metas = eng.process_many([data, b"abc"])
        assert sum(m.size for m in metas[0]) == len(data)
        os.environ["NTPU_PACK_THREADS_FORCE"] = "1"
        for threads in ("1", "4"):
            os.environ["NTPU_PACK_THREADS"] = threads
            for compressor in ("lz4_block", "zstd"):
                _b, res = pack_layer(buf.getvalue(), PackOption(
                    chunk_size=0x1000, backend="hybrid", compressor=compressor, digester=digester))
                assert res.route["lane"] == ("pack_files" if threads == "1" else "per_file"), res.route
    from nydus_snapshotter_tpu_torch.converter import Unpack
    from nydus_snapshotter_tpu_torch.converter.batch import BatchConverter
    from nydus_snapshotter_tpu_torch.converter.convert import blob_data_from_layer_blob
    res = BatchConverter(PackOption(chunk_size=0x1000, backend="hybrid"), layer_fanout=2).convert_many(
        [("i", [buf.getvalue(), buf.getvalue()])])[0]
    Unpack(res.bootstrap, {k: blob_data_from_layer_blob(v) for k, v in res.layer_blobs.items()})
    assert not torch.cuda.is_initialized()
    bad = sorted(m for m in sys.modules if m == "jax" or m.startswith("jax.")
                 or m == "nydus_snapshotter_tpu" or m.startswith("nydus_snapshotter_tpu."))
    print("LEAKED", bad)
    sys.exit(1 if bad else 0)
    """
)


_DAEMON_CHILD = textwrap.dedent(
    """
    import io, json, os, socket, sys, tarfile, tempfile, threading
    import numpy as np
    import torch

    def refuse(*a, **k):
        raise AssertionError("the daemon touched CUDA")

    for name in ("is_available", "init", "current_device", "device_count", "set_device",
                 "Stream", "Event", "synchronize", "current_stream"):
        setattr(torch.cuda, name, refuse)
    os.environ["NTPU_DISABLE_FUSE"] = "1"
    from nydus_snapshotter_tpu_torch.converter import Merge, MergeOption, PackOption, pack_layer
    from nydus_snapshotter_tpu_torch.converter.convert import blob_data_from_layer_blob
    from nydus_snapshotter_tpu_torch.daemon import NydusdClient, cachefiles
    from nydus_snapshotter_tpu_torch.daemon.server import DaemonServer
    from nydus_snapshotter_tpu_torch.fusedev import protocol
    from nydus_snapshotter_tpu_torch.supervisor import Supervisor

    rng = np.random.default_rng(9)
    files = {f"app/f{i}": rng.integers(0, 256, 30_000 * i + 7, dtype=np.uint8).tobytes() for i in range(4)}
    buf = io.BytesIO()
    with tarfile.open(fileobj=buf, mode="w") as tf:
        for name, data in files.items():
            ti = tarfile.TarInfo(name); ti.size = len(data); tf.addfile(ti, io.BytesIO(data))
    blob, res = pack_layer(buf.getvalue(), PackOption(chunk_size=0x1000, backend="numpy",
                                                      prefetch_patterns="/app/f1"), device="cpu")
    d = tempfile.mkdtemp(prefix="iso", dir="/tmp")
    open(os.path.join(d, res.blob_id), "wb").write(blob_data_from_layer_blob(blob))
    boot = os.path.join(d, "image.boot")
    open(boot, "wb").write(Merge([blob], MergeOption()).bootstrap)
    cfg = json.dumps({"device": {"backend": {"type": "localfs", "config": {"blob_dir": d}}}})
    sup = Supervisor("iso", os.path.join(d, "sup.sock")); sup.start()
    srv = DaemonServer("iso", os.path.join(d, "api.sock"), supervisor=sup.sock_path, workdir=d)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    cli = NydusdClient(srv.apisock); cli.wait_until_socket_exists(10)
    cli.mount("/m", boot, cfg); cli.start()
    assert cli.read_file("/m", "/app/f2") == files["app/f2"]
    assert cli.read_file("/m", "/app/f3", 1000, 500) == files["app/f3"][1000:1500]
    assert cli.list_dir("/m", "/app") == sorted(f"f{i}" for i in range(4))
    assert cli.stat_file("/m", "/app/f1")["size"] == len(files["app/f1"])
    assert srv.instances["/m"].fuse is None  # API-only under NTPU_DISABLE_FUSE
    assert sup.wait_for_state(10)
    srv2 = DaemonServer("iso", os.path.join(d, "api2.sock"), supervisor=sup.sock_path, workdir=d,
                        upgrade=True)
    srv2.takeover_from_supervisor()
    assert srv2.instances["/m"].read("/app/f0", 0, -1, d) == files["app/f0"]
    r, w = os.pipe()
    served = cachefiles.CachefilesOndemandDaemon(lambda k: (3, lambda o, n: b"abc"[o:o + n]),
                                                 device=cachefiles.DeviceIO(r))
    assert protocol.IN_HEADER.size == 40 and served.objects == {}
    os.close(w); os.close(r)
    cli.umount("/m"); srv.shutdown(); srv2.shutdown(); sup.stop()
    import shutil; shutil.rmtree(d)
    assert not torch.cuda.is_initialized()
    bad = sorted(m for m in sys.modules if m == "jax" or m.startswith("jax.")
                 or m == "nydus_snapshotter_tpu" or m.startswith("nydus_snapshotter_tpu."))
    print("LEAKED", bad)
    sys.exit(1 if bad else 0)
    """
)


_SNAPSHOTTER_CHILD = textwrap.dedent(
    """
    import os, shutil, sys, tempfile
    from nydus_snapshotter_tpu_torch import constants as C
    from nydus_snapshotter_tpu_torch.api import snapshots_pb2 as pb
    from nydus_snapshotter_tpu_torch.api.client import SnapshotsClient
    from nydus_snapshotter_tpu_torch.api.service import serve
    from nydus_snapshotter_tpu_torch.cache.manager import CacheManager
    from nydus_snapshotter_tpu_torch.config.config import SnapshotterConfig
    from nydus_snapshotter_tpu_torch.config.daemonconfig import DaemonRuntimeConfig
    from nydus_snapshotter_tpu_torch.manager import Manager
    from nydus_snapshotter_tpu_torch.metrics import collector
    from nydus_snapshotter_tpu_torch.snapshot.snapshotter import Snapshotter
    from nydus_snapshotter_tpu_torch.store import Database
    from nydus_snapshotter_tpu_torch.store import boltdb

    # the snapshot, store, api and manager packages load no tensor library
    assert "torch" not in sys.modules, "torch imported by the control plane"
    from nydus_snapshotter_tpu_torch.filesystem import Filesystem

    # a root within the 70-byte limit: the temp directory where it is short
    base = tempfile.gettempdir()
    d = tempfile.mkdtemp(prefix="isn", dir=base if len(base) <= 48 else "/tmp")
    cfg = SnapshotterConfig(root=os.path.join(d, "r"))
    cfg.daemon_mode = C.DAEMON_MODE_NONE
    cfg.validate()
    db = Database(cfg.database_path)
    mgr = Manager(cfg, db, fs_driver=C.FS_DRIVER_FUSEDEV)
    fs = Filesystem(managers={C.FS_DRIVER_FUSEDEV: mgr}, cache_mgr=CacheManager(cfg.cache_root),
                    root=cfg.root, fs_driver=C.FS_DRIVER_FUSEDEV, daemon_mode=C.DAEMON_MODE_NONE,
                    daemon_config=DaemonRuntimeConfig.from_dict({}, C.FS_DRIVER_FUSEDEV))
    fs.startup()
    sn = Snapshotter(root=cfg.root, fs=fs)
    server = serve(sn, os.path.join(d, "g.sock"))
    client = SnapshotsClient(os.path.join(d, "g.sock"), timeout=10.0)
    client.prepare("extract-1", "")
    client.commit("sha256:l1", "extract-1")
    client.prepare("ctr", "sha256:l1")
    assert sorted(i.name for i in client.list()) == ["ctr", "sha256:l1"]
    assert client.stat("sha256:l1").kind == pb.COMMITTED
    assert client.mounts("ctr")[0].type in ("bind", "overlay")
    client.remove("ctr"); client.remove("sha256:l1"); client.cleanup()
    client.close(); server.stop(grace=None); fs.teardown(); sn.close(); mgr.stop()
    assert list(db.walk_daemons()) == [] and boltdb.MAGIC == 0xED0CDAED
    assert collector.snapshot_timer is not None
    db.close()
    shutil.rmtree(d)
    assert "torch" not in sys.modules, "torch imported by the filesystem facade"
    bad = sorted(m for m in sys.modules if m == "jax" or m.startswith("jax.")
                 or m == "nydus_snapshotter_tpu" or m.startswith("nydus_snapshotter_tpu."))
    print("LEAKED", bad)
    sys.exit(1 if bad else 0)
    """
)


_CLI_CHILD = textwrap.dedent(
    """
    import os, shutil, signal, sys, tempfile, threading, time
    from nydus_snapshotter_tpu_torch.cmd import snapshotter as cli

    base = tempfile.gettempdir()
    d = tempfile.mkdtemp(prefix="isc", dir=base if len(base) <= 48 else "/tmp")
    backend = sys.argv[1]
    toml = os.path.join(d, "config.toml")
    with open(toml, "w") as f:
        f.write(f'root = "{d}/r"\\naddress = "{d}/grpc.sock"\\ndaemon_mode = "none"\\n'
                f'[system]\\naddress = "{d}/system.sock"\\n[metrics]\\naddress = "127.0.0.1:0"\\n'
                f'[fleet]\\nenable = true\\n[log]\\nlog_to_stdout = false\\n'
                f'[experimental]\\ntarfs_enable = {"true" if backend == "jax" else "false"}\\n'
                f'[daemon]\\naccel_backend = "{backend}"\\n')
    argv = ["--config", toml] + (["--device", "cpu"] if backend == "jax" else [])
    cfg = cli.config_from_args(cli.build_parser().parse_args(argv))
    assert cfg.system.enable and cfg.fleet.enable and cfg.daemon.accel_backend == backend
    if backend == "jax":
        sn, fs, managers, db = cli.build_stack(cfg, device="cpu")
        assert fs.tarfs_mgr.engine.device.type == "cpu" and fs.tarfs_mgr.engine.backend == "jax"
        sn.close()
        assert "torch" in sys.modules, "the card lane's engine loaded no torch"
    else:
        served = []

        def drive():
            from nydus_snapshotter_tpu_torch.api.client import SnapshotsClient
            from nydus_snapshotter_tpu_torch.utils import udshttp

            deadline = time.time() + 60
            while not (os.path.exists(cfg.address) and os.path.exists(cfg.system.address)):
                assert time.time() < deadline, "the snapshotter never served"
                time.sleep(0.02)
            client = SnapshotsClient(cfg.address, timeout=10.0)
            client.prepare("ctr", "")
            served.append(sorted(i.name for i in client.list()))
            client.close()
            served.append([m["name"] for m in udshttp.get_json(cfg.system.address, "/api/v1/fleet/members")])
            os.kill(os.getpid(), signal.SIGTERM)

        t = threading.Thread(target=drive)
        t.start()
        assert cli.main(argv) == 0
        t.join()
        assert served == [["ctr"], ["snapshotter"]], served
        assert not os.path.exists(cfg.system.address)
        assert "torch" not in sys.modules, "torch imported by the default snapshotter"
    shutil.rmtree(d)
    bad = sorted(m for m in sys.modules if m == "jax" or m.startswith("jax.")
                 or m == "nydus_snapshotter_tpu" or m.startswith("nydus_snapshotter_tpu."))
    print("LEAKED", bad)
    sys.exit(1 if bad else 0)
    """
)


@pytest.mark.parametrize("backend", ["hybrid", "jax"])
def test_snapshotter_cli_imports_neither_jax_nor_reference(backend):
    """``cmd.snapshotter`` in a fresh interpreter. Under the default config
    (``hybrid``, tarfs off; here with ``daemon_mode = "none"`` and the
    sockets in a temporary directory) ``main`` serves a Prepare, the system
    controller lists the fleet plane's own member, SIGTERM ends it with 0,
    and neither jax, the reference package nor torch is loaded. With
    ``accel_backend = "jax"`` and tarfs on, ``build_stack`` gives the tarfs
    manager the card lane's engine (here on ``--device cpu``): torch is
    loaded, jax and the reference still are not."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH" and not k.startswith("NTPU_")}
    env["PYTHONPATH"] = REPO
    proc = subprocess.run(
        [sys.executable, "-c", _CLI_CHILD, backend], cwd=REPO, env=env, capture_output=True, text=True,
        timeout=300,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "LEAKED []" in proc.stdout


def test_snapshotter_stack_imports_neither_jax_nor_reference_nor_torch():
    """The snapshotter stack in a fresh interpreter: the snapshots service
    and client, the snapshotter and its metastore, the daemon store and
    manager, the filesystem facade and the collectors drive a Prepare,
    Commit, List, Stat, Mounts, Remove and Cleanup over a UDS without
    loading jax, the reference package or torch."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    proc = subprocess.run(
        [sys.executable, "-c", _SNAPSHOTTER_CHILD], cwd=REPO, env=env, capture_output=True, text=True,
        timeout=300,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "LEAKED []" in proc.stdout


def test_daemon_server_imports_neither_jax_nor_reference():
    """The serving daemon in a fresh interpreter: a mount under
    ``NTPU_DISABLE_FUSE=1``, API reads, a supervisor handoff and the
    cachefiles and FUSE modules, with every CUDA call refused."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    proc = subprocess.run(
        [sys.executable, "-c", _DAEMON_CHILD], cwd=REPO, env=env, capture_output=True, text=True,
        timeout=300,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "LEAKED []" in proc.stdout


def test_daemon_spawn_starts_the_port_server(tmp_path):
    """``Daemon.spawn`` starts ``python -m nydus_snapshotter_tpu_torch.daemon.server``,
    from any working directory; the process maps no JAX or torch library
    and serves the API."""
    import tempfile

    from nydus_snapshotter_tpu_torch.daemon import Daemon, DaemonState
    from nydus_snapshotter_tpu_torch.daemon.daemon import ConfigState

    d = tempfile.mkdtemp(prefix="sp", dir="/tmp")
    cwd = os.getcwd()
    os.chdir(str(tmp_path))
    try:
        daemon = Daemon(ConfigState(daemon_id="spawned", api_socket=os.path.join(d, "api.sock"), workdir=d))
        pid = daemon.spawn()
    finally:
        os.chdir(cwd)
    try:
        daemon.wait_until_state(DaemonState.READY, timeout=60)
        with open(f"/proc/{pid}/cmdline", "rb") as f:
            argv = [a.decode() for a in f.read().split(b"\0") if a]
        assert argv[1:3] == ["-m", "nydus_snapshotter_tpu_torch.daemon.server"], argv
        assert daemon.client().get_daemon_info()["pid"] == pid
        with open(f"/proc/{pid}/maps") as f:
            maps = f.read()
        # no JAX, and no torch either: the serving side loads no tensor library
        assert "jaxlib" not in maps and "libtpu" not in maps and "libtorch" not in maps
    finally:
        daemon.terminate()
        daemon.wait(timeout=20)
        import shutil

        shutil.rmtree(d, ignore_errors=True)
    assert not os.path.exists(os.path.join(d, "api.sock"))


def test_hybrid_makes_no_cuda_context():
    """``backend="hybrid"`` runs without a device argument, touches no CUDA
    call (each raises in the child) and imports neither jax nor the
    reference package."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    proc = subprocess.run(
        [sys.executable, "-c", _HYBRID_CHILD], cwd=REPO, env=env, capture_output=True, text=True,
        timeout=300,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "LEAKED []" in proc.stdout


def test_main_path_imports_neither_jax_nor_reference():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    proc = subprocess.run(
        [sys.executable, "-c", _CHILD], cwd=REPO, env=env, capture_output=True, text=True, timeout=300
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "LEAKED []" in proc.stdout


def _adaptive():
    from nydus_snapshotter_tpu_torch.converter import codec

    return codec.AdaptiveCodec(codec.CodecConfig(adaptive=True))


@pytest.mark.parametrize(
    "call",
    [
        lambda: FusedDeviceEngine(),
        lambda: sharded_dict.ShardedChunkDict(np.zeros((0, 8), np.uint32)),
        lambda: sharded_dict.from_tables(np.zeros((64, 8), np.uint32), np.zeros(64, np.int32), 1),
        lambda: entry.entry(),
        lambda: pack_layer(b"", PackOption(backend="fused")),
        lambda: ChunkDigestEngine(),
        lambda: pack_layer(b"", PackOption(backend="jax")),
        lambda: FusedDeviceEngine(digester="blake3"),
        lambda: ChunkDigestEngine(digester="blake3"),
        lambda: ChunkDigestEngine(backend="fused", digester="blake3"),
        lambda: DeviceDigester(digester="blake3"),
        lambda: pack_layer(b"", PackOption(digester="blake3")),
        lambda: pack_layer(b"", PackOption(backend="jax", digester="blake3")),
        lambda: pack_layer(b"", PackOption(backend="jax", compressor="zstd")),
        lambda: sharded_dict.ShardedChunkDict.load("/nonexistent.dict"),
        lambda: dict_service.DictService(),
        lambda: BatchConverter(PackOption()).convert_image("i", [b""]),
        lambda: BatchConverter(PackOption()).convert_image("i", [b"", b""]),
        lambda: pack_layer(b"", PackOption(encrypt=True)),
        lambda: pack_layer(b"", PackOption(compressor="zstd"), codec=_adaptive()),
        lambda: BatchConverter(PackOption(compressor="zstd"), codec=_adaptive()).convert_image("i", [b""]),
        lambda: mesh.make_mesh(),
        lambda: entry.sharded_convert_step([b"abc"], 0x1000, 1),
        lambda: __import__("nydus_snapshotter_tpu_torch.ha.runner", fromlist=["main"]).main(
            ["--listen", "/nonexistent/r.sock"]),
        lambda: __import__("nydus_snapshotter_tpu_torch.converter.hooks", fromlist=["hooks"])
        .layer_convert_func(PackOption(oci_ref=True)),
    ],
    ids=["engine", "dict", "from_tables", "entry", "pack_layer", "chunk_engine", "pack_layer_jax",
         "engine_blake3", "chunk_engine_blake3", "chunk_engine_fused_blake3",
         "device_digester_blake3", "pack_layer_blake3", "pack_layer_jax_blake3",
         "pack_layer_jax_zstd", "dict_load", "dict_service", "batch_one_layer",
         "batch_fanout", "pack_layer_encrypt", "pack_layer_adaptive", "batch_adaptive",
         "make_mesh", "sharded_convert_step", "ha_runner", "hooks_oci_ref"],
)
def test_entry_points_refuse_missing_cuda(call):
    if torch.cuda.is_available():
        return  # only meaningful on a host without CUDA, such as CI
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        call()


def test_forward_step_on_cpu():
    import hashlib

    fwd, args = entry.entry(device="cpu")
    bm_s, bm_l, digests = fwd(*args)
    windows, _ms, _ml, buf, offs, sizes = args
    assert bm_s.shape == (windows.shape[0], entry.WINDOW // 32) == bm_l.shape
    raw = buf.numpy()
    for i in range(offs.numel()):
        o, s = int(offs[i]), int(sizes[i])
        want = hashlib.sha256(raw[o : o + s].tobytes()).digest()
        assert digests[i].numpy().view(np.uint32).astype(">u4").tobytes() == want
