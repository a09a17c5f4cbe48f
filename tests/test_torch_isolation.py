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
    ],
    ids=["engine", "dict", "from_tables", "entry", "pack_layer", "chunk_engine", "pack_layer_jax",
         "engine_blake3", "chunk_engine_blake3", "chunk_engine_fused_blake3",
         "device_digester_blake3", "pack_layer_blake3", "pack_layer_jax_blake3",
         "pack_layer_jax_zstd", "dict_load", "dict_service", "batch_one_layer",
         "batch_fanout", "pack_layer_encrypt", "pack_layer_adaptive", "batch_adaptive",
         "make_mesh", "sharded_convert_step"],
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
