"""The port's adaptive zstd codec against the JAX package's.

Mirrors tests/test_codec_adaptive.py class by class, each case run in both
packages on the same numpy-seeded inputs: encode and ``encode_batch``
frames and flags, probe classes, pack blobs, blob ids and bootstraps on
the ``numpy``, ``hybrid`` (1 and 8 threads) and ``fused`` lanes (device
``cpu``), trained dictionaries (their ``NTPUZDCT`` files and the ``nZD1``
frames made with them), the chaos fallbacks at the four ``compress.*``
failpoint sites, the decompress-context pool, the dict service's
``zdict`` route and the ``[compression]`` config. Cross-reads: a blob one
package packs with a trained dictionary unpacks in the other once that
one has registered the dictionary; without it both raise, naming its id.

Both packages keep a process-wide trained-dict registry and failpoint
table: every test leaves both as it found them. ``TrainedDict`` stamps
``int(time.time())`` as its epoch, so tests that train pin the clock in
both codec modules.
"""

from __future__ import annotations

import concurrent.futures
import dataclasses
import io
import tarfile
import types

import numpy as np
import pytest

from nydus_snapshotter_tpu import constants as jconstants
from nydus_snapshotter_tpu import failpoint as jfailpoint
from nydus_snapshotter_tpu.converter import codec as jcodec
from nydus_snapshotter_tpu.converter import convert as jconvert
from nydus_snapshotter_tpu.converter.batch import BatchConverter as JBatchConverter
from nydus_snapshotter_tpu.converter.types import ConvertError as JConvertError
from nydus_snapshotter_tpu.converter.types import PackOption as JPackOption
from nydus_snapshotter_tpu.ops import native_cdc as jnative_cdc
from nydus_snapshotter_tpu.utils import zstd as jzstd
from nydus_snapshotter_tpu_torch import constants, failpoint
from nydus_snapshotter_tpu_torch.converter import codec
from nydus_snapshotter_tpu_torch.converter import convert
from nydus_snapshotter_tpu_torch.converter.batch import BatchConverter
from nydus_snapshotter_tpu_torch.converter.types import ConvertError, PackOption
from nydus_snapshotter_tpu_torch.ops import native_cdc
from nydus_snapshotter_tpu_torch.utils import zstd
from nydus_snapshotter_tpu_torch.utils import zstdcompat

pytestmark = pytest.mark.skipif(
    not (zstd.available() and jzstd.available()), reason="system libzstd not available"
)
needs_dict = pytest.mark.skipif(
    not (zstd.dict_support() and jzstd.dict_support()),
    reason="libzstd lacks ZDICT/CDict support",
)

_rng = np.random.default_rng(1234)
_WORDS = [bytes(_rng.integers(97, 123, int(_rng.integers(3, 10)), dtype=np.uint8)) for _ in range(300)]


def textgen(n: int, seed: int) -> bytes:
    r = np.random.default_rng(seed)
    return b" ".join(_WORDS[int(i)] for i in r.integers(0, 300, n // 6))[:n]


def randgen(n: int, seed: int) -> bytes:
    return np.random.default_rng(seed).integers(0, 256, n, dtype=np.uint8).tobytes()


def mktar(files) -> bytes:
    buf = io.BytesIO()
    with tarfile.open(fileobj=buf, mode="w", format=tarfile.GNU_FORMAT) as tf:
        for name, data in files:
            ti = tarfile.TarInfo(name)
            ti.size = len(data)
            tf.addfile(ti, io.BytesIO(data))
    return buf.getvalue()


def _mixed_tar(seed: int = 0, scale: int = 1) -> bytes:
    return mktar(
        [
            ("a/text1.txt", textgen((180 << 10) // scale, 100 + seed)),
            ("a/rand.bin", randgen((200 << 10) // scale, 101 + seed)),
            ("b/text2.txt", textgen((50 << 10) // scale, 102 + seed)),
            ("b/more.bin", randgen((64 << 10) // scale, 103 + seed)),
        ]
    )


OPT = dict(compressor="zstd", chunk_size=0x10000, backend="numpy")
# The device lanes run their plain SHA-256 on the CPU: small chunks, small tars.
SMALL = dict(compressor="zstd", chunk_size=0x1000)
FIXED_EPOCH = 1_700_000_000


def unpack(blob: bytes, mod=convert) -> bytes:
    bs = mod.bootstrap_from_layer_blob(blob)
    data = mod.blob_data_from_layer_blob(blob)
    return mod.Unpack(bs, {bs.blobs[0].blob_id: data} if bs.blobs else {})


def codecs(**kw):
    """(port codec, reference codec) with the same config."""
    return (
        codec.AdaptiveCodec(codec.CodecConfig(adaptive=True, **kw)),
        jcodec.AdaptiveCodec(jcodec.CodecConfig(adaptive=True, **kw)),
    )


def trained_dicts(seed: int = 0, epoch: int = 7):
    """(port TrainedDict, reference TrainedDict) over the same ZDICT bytes,
    trained by each package's libzstd binding on the same samples."""
    samples = [textgen(2048, 1000 + seed * 500 + i) for i in range(300)]
    pb, jb = zstd.train_dict(samples, 32 << 10), jzstd.train_dict(samples, 32 << 10)
    assert pb == jb
    return codec.TrainedDict(pb, epoch=epoch), jcodec.TrainedDict(jb, epoch=epoch)


def _batch_views(seed: int = 0) -> list[bytes]:
    views = []
    for i in range(30):
        n = 2048 + 977 * i
        views.append(textgen(n, seed + i) if i % 2 else randgen(n, seed + i))
    return views + [b"", b"q", bytes(50_000)]


def pack_both(tar, backend="numpy", pc=None, jc=None, **kw):
    """The port's pack_layer (CPU) and the reference's with the same options;
    asserts blob, blob id and bootstrap equal -> the port's (blob, result)."""
    kw = {**OPT, **kw, "backend": backend}
    got = convert.pack_layer(tar, PackOption(**kw), device="cpu", codec=pc)
    want = jconvert.pack_layer(tar, JPackOption(**kw), codec=jc)
    assert got[1].blob_id == want[1].blob_id
    assert got[1].bootstrap == want[1].bootstrap
    assert got[0] == want[0]
    return got


@pytest.fixture(autouse=True)
def _clean_planes():
    """Both packages' failpoint tables and trained-dict registries."""
    before = (set(codec._dict_registry), set(jcodec._dict_registry))
    for fp in (failpoint, jfailpoint):
        fp.clear()
    yield
    for fp in (failpoint, jfailpoint):
        fp.clear()
    for mod, keep in zip((codec, jcodec), before):
        for dict_id in set(mod._dict_registry) - keep:
            mod.unregister_trained_dict(dict_id)


def _pin_clock(monkeypatch):
    clock = types.SimpleNamespace(time=lambda: float(FIXED_EPOCH))
    for mod in (codec, jcodec):
        monkeypatch.setattr(mod, "time", clock)


def _threads(monkeypatch, n):
    monkeypatch.setenv("NTPU_PACK_THREADS", str(n))
    monkeypatch.setenv("NTPU_PACK_THREADS_FORCE", "1")


class TestEncodeBatch:
    """``encode_batch`` equals the per-chunk loop in each package, and the
    two packages' frames and flags are equal."""

    def test_identical_to_per_chunk(self):
        views = _batch_views()
        pc, jc = codecs()
        ref = [jc.encode(v) for v in views]
        assert [pc.encode(v) for v in views] == ref
        assert codecs()[0].encode_batch(views) == ref
        assert codecs()[0].encode_batch(views, n_threads=3) == ref
        assert codecs()[1].encode_batch(views, n_threads=3) == ref

    def test_identical_without_native_arm(self, monkeypatch):
        views = _batch_views(3)
        ref = [codecs()[1].encode(v) for v in views]
        for mod in (native_cdc, jnative_cdc):
            monkeypatch.setattr(mod, "encode_batch_available", lambda: False)
        pc, jc = codecs()
        assert pc.encode_batch(views) == ref == jc.encode_batch(views)

    @needs_dict
    def test_identical_with_trained_dict(self):
        ptd, jtd = trained_dicts(seed=4)
        views = _batch_views(8)
        pc, jc = codecs()
        pc.set_trained(ptd)
        jc.set_trained(jtd)
        ref = [jc.encode(v) for v in views]
        assert [pc.encode(v) for v in views] == ref
        pc2, _ = codecs()
        pc2.set_trained(ptd)
        assert pc2.encode_batch(views) == ref

    def test_fallback_class_identical(self):
        views = _batch_views(5)
        with failpoint.injected("compress.probe", "error(OSError:probe-down)"), \
                jfailpoint.injected("compress.probe", "error(OSError:probe-down)"):
            pc, jc = codecs()
            ref = [jc.encode(v) for v in views]
            assert [pc.encode(v) for v in views] == ref
            assert codecs()[0].encode_batch(views) == ref
            assert pc.counts == jc.counts and pc.counts["fallback"] > 0
        for (payload, flag), v in zip(ref, views):
            if flag == constants.COMPRESSOR_ZSTD:
                assert zstdcompat.decompress_block(payload, max_output_size=max(len(v), 1)) == v

    def test_batch_failpoint_site(self):
        for fp, c in zip((failpoint, jfailpoint), codecs()):
            with fp.injected("compress.batch", "error(OSError:batch-down)"):
                with pytest.raises(OSError, match="batch-down"):
                    c.encode_batch([b"x" * 8192])


class TestProbe:
    @pytest.mark.parametrize("probe", ["sample", "entropy", "off"])
    def test_classes_match_reference(self, probe):
        pc, jc = codecs(probe=probe)
        for data in (randgen(64 << 10, 1), textgen(64 << 10, 2), randgen(1000, 3) + textgen(60 << 10, 4),
                     b"z" * 100, bytes(64 << 10)):
            assert pc.classify(data) == jc.classify(data)

    def test_random_bypasses_text_compresses(self):
        pc, jc = codecs()
        assert pc.classify(randgen(64 << 10, 1)) == jc.classify(randgen(64 << 10, 1)) == "bypass"
        assert pc.classify(textgen(64 << 10, 2)) in ("default", "best")

    def test_probe_deterministic(self):
        pc, _ = codecs()
        assert {pc.classify(randgen(128 << 10, 3)) for _ in range(5)} == {"bypass"}

    def test_tiny_chunks_skip_probe(self):
        assert codecs()[0].classify(b"z" * 100) == "default"

    def test_entropy_probe_bypasses_random(self):
        pc, _ = codecs(probe="entropy")
        assert pc.classify(randgen(64 << 10, 5)) == "bypass"
        assert pc.classify(textgen(64 << 10, 6)) != "bypass"


class TestEncodeRoundtrip:
    @pytest.mark.parametrize(
        "data",
        [
            b"",
            b"x",
            b"ab" * 10,
            randgen(64 << 10, 10),
            textgen(64 << 10, 11),
            randgen(100, 12) + textgen(200 << 10, 13),
        ],
        ids=["empty", "one", "tiny", "incompressible", "compressible", "mixed"],
    )
    def test_roundtrip(self, data):
        pc, jc = codecs()
        payload, flag = pc.encode(data)
        assert (payload, flag) == jc.encode(data)
        assert convert._decompress_chunk(payload, flag, len(data)) == data
        assert jconvert._decompress_chunk(payload, flag, len(data)) == data

    def test_incompressible_stored_raw(self):
        data = randgen(64 << 10, 14)
        for c in codecs():
            assert c.encode(data) == (data, constants.COMPRESSOR_NONE)

    def test_never_grows_payload(self):
        pc, _ = codecs()
        for seed in range(5):
            data = randgen(32 << 10, 20 + seed)
            assert len(pc.encode(data)[0]) <= max(len(data), 1)

    def test_ctx_reuse_counted(self):
        pc, _ = codecs()
        before = codec.CTX_REUSE.value()
        for i in range(4):
            pc.encode(textgen(32 << 10, 30 + i))
        assert codec.CTX_REUSE.value() >= before + 3

    def test_threaded_encode_deterministic(self):
        pc, jc = codecs()
        chunks = [textgen(32 << 10, 40 + i) for i in range(8)] + [randgen(32 << 10, 50 + i) for i in range(8)]
        serial = [jc.encode(d) for d in chunks]
        with concurrent.futures.ThreadPoolExecutor(max_workers=4) as pool:
            assert list(pool.map(pc.encode, chunks)) == serial


class TestPackAdaptive:
    def test_default_config_resolves_no_codec(self, monkeypatch):
        monkeypatch.delenv("NTPU_COMPRESS_ADAPTIVE", raising=False)
        assert codec.resolve_codec(PackOption(**OPT)) is None
        assert codec.resolve_codec(PackOption(compressor="lz4_block")) is None

    def test_default_pack_byte_stable(self):
        tar = _mixed_tar()
        a, _ = pack_both(tar)
        assert convert.pack_layer(tar, PackOption(**OPT), codec=None, device="cpu")[0] == a

    @pytest.mark.parametrize("backend,threads", [("numpy", 1), ("numpy", 8), ("hybrid", 1), ("hybrid", 8)])
    def test_lanes_match_reference(self, monkeypatch, backend, threads):
        """An explicit codec per package; the same blob on every host lane,
        serial and pipelined, and the same class counts."""
        _threads(monkeypatch, threads)
        tar = _mixed_tar(1)
        pc, jc = codecs()
        blob, res = pack_both(tar, backend, pc=pc, jc=jc)
        assert res.route["writer"] == "serial"
        assert pc.counts == jc.counts and pc.class_bytes == jc.class_bytes
        assert unpack(blob) == unpack(pack_both(tar, backend)[0])

    @pytest.mark.parametrize("backend", ["fused", "jax"])
    def test_device_lanes_match_reference(self, monkeypatch, backend):
        """``NTPU_COMPRESS_ADAPTIVE=1`` resolves a codec in each package: the
        fused and jax lanes (device cpu) pack the reference's bytes through
        the serial writer."""
        monkeypatch.setenv("NTPU_COMPRESS_ADAPTIVE", "1")
        tar = _mixed_tar(2, scale=8)
        blob, res = pack_both(tar, backend, **SMALL)
        assert res.route == {"lane": "fused" if backend == "fused" else "per_file", "writer": "serial"}
        flags = {r.flags & constants.COMPRESSOR_MASK for r in convert.bootstrap_from_layer_blob(blob).chunks}
        assert flags == {constants.COMPRESSOR_NONE, constants.COMPRESSOR_ZSTD}

    def test_bypass_engages_on_incompressible_corpus(self):
        tar = mktar([(f"r/{i}", randgen(96 << 10, 200 + i)) for i in range(4)])
        pc, jc = codecs()
        blob, _ = pack_both(tar, pc=pc, jc=jc)
        assert pc.counts["bypass"] == jc.counts["bypass"] > 0
        flags = {r.flags & constants.COMPRESSOR_MASK for r in convert.bootstrap_from_layer_blob(blob).chunks}
        assert constants.COMPRESSOR_NONE in flags
        assert unpack(blob) == unpack(pack_both(tar)[0])

    def test_bypass_never_fires_on_compressible_corpus(self):
        tar = mktar([(f"t/{i}", textgen(96 << 10, 300 + i)) for i in range(4)])
        pc, jc = codecs()
        blob, _ = pack_both(tar, pc=pc, jc=jc)
        assert pc.counts["bypass"] == 0 and pc.class_bytes["bypass"] == 0
        assert all(r.flags & constants.COMPRESSOR_MASK == constants.COMPRESSOR_ZSTD
                   for r in convert.bootstrap_from_layer_blob(blob).chunks)

    def test_adaptive_pipelined_matches_serial(self, monkeypatch):
        tar = _mixed_tar(2)
        serial, _ = pack_both(tar, "hybrid", pc=codecs()[0], jc=codecs()[1])
        _threads(monkeypatch, 4)
        piped, res = pack_both(tar, "hybrid", pc=codecs()[0], jc=codecs()[1])
        assert res.route["lane"] == "pipeline" and piped == serial

    def test_blake3_reference_defaults_arm(self):
        tar = _mixed_tar(3)
        pc, jc = codecs()
        on, _ = pack_both(tar, pc=pc, jc=jc, digester="blake3")
        assert unpack(on) == unpack(pack_both(tar, digester="blake3")[0])


@needs_dict
class TestTrainedDict:
    def test_serialize_roundtrip(self, tmp_path):
        ptd, jtd = trained_dicts()
        assert ptd.serialize() == jtd.serialize()
        td2 = codec.TrainedDict.deserialize(jtd.serialize())
        assert (td2.dict_id, td2.epoch, td2.bytes) == (jtd.dict_id, jtd.epoch, jtd.bytes)
        p = str(tmp_path / "zd")
        ptd.save(p)
        td3 = jcodec.TrainedDict.load(p)
        assert (td3.dict_id, td3.epoch) == (ptd.dict_id, ptd.epoch)

    def test_corrupt_blob_rejected(self):
        blob = bytearray(trained_dicts()[0].serialize())
        blob[len(blob) // 2] ^= 0xFF
        for mod in (codec, jcodec):
            with pytest.raises(mod.CodecError, match="checksum|id skew"):
                mod.TrainedDict.deserialize(bytes(blob))

    def test_unknown_format_version_rejected(self):
        blob = bytearray(trained_dicts()[0].serialize())
        blob[8] = 99
        for mod in (codec, jcodec):
            with pytest.raises(mod.CodecError, match="unsupported"):
                mod.TrainedDict.deserialize(bytes(blob))

    def test_dict_frames_carry_versioned_header(self):
        ptd, jtd = trained_dicts(seed=1)
        pc = codec.AdaptiveCodec(codec.CodecConfig(adaptive=True), trained=ptd)
        jc = jcodec.AdaptiveCodec(jcodec.CodecConfig(adaptive=True), trained=jtd)
        data = textgen(64 << 10, 400)
        payload, flag = pc.encode(data)
        assert (payload, flag) == jc.encode(data)
        assert flag == constants.COMPRESSOR_ZSTD and payload[:4] == codec.TRAINED_FRAME_MAGIC
        assert codec.is_trained_frame(payload)
        assert convert._decompress_chunk(payload, flag, len(data)) == data

    def test_decode_without_dict_fails_loudly(self):
        ptd, jtd = trained_dicts(seed=2)
        pc = codec.AdaptiveCodec(codec.CodecConfig(adaptive=True), trained=ptd)
        data = textgen(64 << 10, 401)
        payload, flag = pc.encode(data)
        codec.unregister_trained_dict(ptd.dict_id)
        for mod, cmod, err in ((convert, codec, ConvertError), (jconvert, jcodec, JConvertError)):
            with pytest.raises(err, match=str(ptd.dict_id)):
                mod._decompress_chunk(payload, flag, len(data))
            with pytest.raises(cmod.CodecError, match="not loaded"):
                cmod.decode_trained_frame(payload, len(data))

    def test_trained_zstd_frame_decodes_or_names_its_dict(self):
        """A hand-made ``nZD1`` frame whose dictionary no package holds: both
        readers raise, naming the id; with the dictionary registered in each,
        a real frame decodes the same in both."""
        frame = codec.TRAINED_FRAME_MAGIC + b"\1\0\0\0" + b"\0" * 16
        with pytest.raises(JConvertError, match="id=1 "):
            jconvert._decompress_chunk(frame, jconstants.COMPRESSOR_ZSTD, 10)
        with pytest.raises(ConvertError, match="id=1 "):
            convert._decompress_chunk(frame, constants.COMPRESSOR_ZSTD, 10)

    def test_plain_frames_never_look_trained(self):
        frame = zstd.compress_block(textgen(32 << 10, 402))
        assert not codec.is_trained_frame(frame)
        blob, _ = pack_both(_mixed_tar(4))
        bs = convert.bootstrap_from_layer_blob(blob)
        data = convert.blob_data_from_layer_blob(blob)
        for rec in bs.chunks:
            raw = data[rec.compressed_offset : rec.compressed_offset + rec.compressed_size]
            if rec.flags & constants.COMPRESSOR_MASK == constants.COMPRESSOR_ZSTD:
                assert not codec.is_trained_frame(raw)
                assert len(convert._decompress_chunk(raw, rec.flags, rec.uncompressed_size)) \
                    == rec.uncompressed_size

    @pytest.mark.parametrize("backend,threads", [("numpy", 1), ("hybrid", 1), ("hybrid", 8)])
    def test_pack_with_dict_matches_reference(self, monkeypatch, backend, threads):
        _threads(monkeypatch, threads)
        ptd, jtd = trained_dicts(seed=3)
        tar = _mixed_tar(5)
        pc = codec.AdaptiveCodec(codec.CodecConfig(adaptive=True), trained=ptd)
        jc = jcodec.AdaptiveCodec(jcodec.CodecConfig(adaptive=True), trained=jtd)
        on, _ = pack_both(tar, backend, pc=pc, jc=jc)
        assert unpack(on) == unpack(pack_both(tar)[0])

    def test_fused_pack_with_dict_file_matches_reference(self, monkeypatch, tmp_path):
        """``NTPU_COMPRESS_DICT`` loads the same file in each package; the
        fused lane (device cpu) packs the reference's nZD1 frames."""
        path = str(tmp_path / "zd")
        trained_dicts(seed=6)[1].save(path)
        monkeypatch.setenv("NTPU_COMPRESS_ADAPTIVE", "1")
        monkeypatch.setenv("NTPU_COMPRESS_DICT", path)
        blob, _ = pack_both(_mixed_tar(6, scale=8), "fused", **SMALL)
        data = convert.blob_data_from_layer_blob(blob)
        recs = convert.bootstrap_from_layer_blob(blob).chunks
        assert any(codec.is_trained_frame(data[r.compressed_offset : r.compressed_offset + 8])
                   for r in recs)

    @pytest.mark.parametrize("packer", ["reference", "port"])
    def test_cross_read_needs_the_dict(self, packer):
        """A blob one package packed with a trained dictionary: the other
        package's Unpack raises naming the id until it registers that
        dictionary, then reads the tar back."""
        ptd, jtd = trained_dicts(seed=7)
        tar = _mixed_tar(7)
        plain = unpack(pack_both(tar)[0])
        if packer == "reference":
            blob, _ = jconvert.pack_layer(
                tar, JPackOption(**OPT), codec=jcodec.AdaptiveCodec(jcodec.CodecConfig(adaptive=True), trained=jtd)
            )
            reader, rcodec, rtd, err = convert, codec, ptd, ConvertError
        else:
            blob, _ = convert.pack_layer(
                tar, PackOption(**OPT), device="cpu",
                codec=codec.AdaptiveCodec(codec.CodecConfig(adaptive=True), trained=ptd),
            )
            reader, rcodec, rtd, err = jconvert, jcodec, jtd, JConvertError
        rcodec.unregister_trained_dict(rtd.dict_id)
        with pytest.raises(err, match=str(rtd.dict_id)):
            unpack(blob, reader)
        rcodec.register_trained_dict(rtd)
        assert unpack(blob, reader) == plain


class TestChaos:
    def test_probe_failure_falls_back_to_always_compress(self):
        tar = mktar([("r/big.bin", randgen(128 << 10, 500))])
        pc, jc = codecs()
        with failpoint.injected("compress.probe", "error(OSError:probe died)"), \
                jfailpoint.injected("compress.probe", "error(OSError:probe died)"):
            blob, _ = pack_both(tar, pc=pc, jc=jc)
        assert pc.counts["fallback"] > 0 and pc.counts["bypass"] == 0
        assert unpack(blob) == unpack(pack_both(tar)[0])

    def test_encode_failure_fails_the_pack(self):
        tar = _mixed_tar(6)
        with failpoint.injected("compress.encode", "error(OSError:codec died)"):
            with pytest.raises(OSError, match="codec died"):
                convert.pack_layer(tar, PackOption(**OPT), device="cpu", codec=codecs()[0])
        with jfailpoint.injected("compress.encode", "error(OSError:codec died)"):
            with pytest.raises(OSError, match="codec died"):
                jconvert.pack_layer(tar, JPackOption(**OPT), codec=codecs()[1])

    @pytest.mark.parametrize("site", ["compress.probe", "compress.train", "compress.encode", "compress.batch"])
    def test_every_site_fires_in_both(self, site):
        """Each ``compress.*`` site armed with an error fires once in each
        package: the probe degrades to the fallback class, training to
        untrained, encode and batch raise."""
        for fp, c in zip((failpoint, jfailpoint), codecs(train=True)):
            c.attach_trainer()
            with fp.injected(site, "error(OSError:site-down)"):
                if site == "compress.probe":
                    c.encode(randgen(32 << 10, 1))
                    assert c.counts["fallback"] == 1
                elif site == "compress.train":
                    assert c.maybe_train(force=True) is None and c.trained is None
                else:
                    with pytest.raises(OSError, match="site-down"):
                        c.encode_batch([b"x" * 8192]) if site == "compress.batch" else c.encode(b"x")
            assert fp.counts() == {site: 1}

    def test_panic_escapes_probe_and_train(self):
        """``failpoint.Panic`` is a BaseException: classify and maybe_train
        re-raise it instead of degrading."""
        for fp, c in zip((failpoint, jfailpoint), codecs(train=True)):
            c.attach_trainer()
            with fp.injected("compress.probe", "panic"):
                with pytest.raises(fp.Panic):
                    c.classify(randgen(32 << 10, 2))
            with fp.injected("compress.train", "panic"):
                with pytest.raises(fp.Panic):
                    c.maybe_train(force=True)

    @needs_dict
    def test_train_failure_falls_back_to_untrained(self):
        layers = [mktar([(f"f{i}", textgen(20 << 10, 600 + i)) for i in range(48)])]
        img2 = [mktar([(f"g{i}", textgen(20 << 10, 700 + i)) for i in range(8)])]
        out = []
        for bcls, cmod, fp, kw in ((BatchConverter, codec, failpoint, {"device": "cpu"}),
                                   (JBatchConverter, jcodec, jfailpoint, {})):
            c = cmod.AdaptiveCodec(cmod.CodecConfig(adaptive=True, train=True, train_sample_mib=1,
                                                    train_dict_kib=16))
            c.attach_trainer()
            bc = bcls((PackOption if cmod is codec else JPackOption)(**OPT), codec=c, **kw)
            bc.convert_image("img1", layers)
            before = cmod.TRAIN_TOTAL.value("failed")
            with fp.injected("compress.train", "error(OSError:train died)"):
                assert bc.train_codec_dict() is None
            assert cmod.TRAIN_TOTAL.value("failed") == before + 1 and c.trained is None
            out.append(bc.convert_image("img2", img2).bootstrap)
        assert out[0] == out[1]

    @needs_dict
    def test_train_success_after_sampling(self, monkeypatch):
        """At one pack thread the trainer sees the chunks in tar order in
        both packages, so the dictionaries are equal too."""
        _pin_clock(monkeypatch)
        _threads(monkeypatch, 1)
        layers = [mktar([(f"f{i}", textgen(20 << 10, 800 + i)) for i in range(60)])]
        img2 = [mktar([(f"g{i}", textgen(20 << 10, 900 + i)) for i in range(8)])]
        got = []
        for bcls, cmod, kw in ((BatchConverter, codec, {"device": "cpu"}), (JBatchConverter, jcodec, {})):
            c = cmod.AdaptiveCodec(cmod.CodecConfig(adaptive=True, train=True, train_sample_mib=1,
                                                    train_dict_kib=16))
            c.attach_trainer()
            bc = bcls((PackOption if cmod is codec else JPackOption)(**OPT), codec=c, **kw)
            r1 = bc.convert_image("img1", layers)
            td = bc.train_codec_dict()
            assert td is not None and c.trained is td and td.epoch == FIXED_EPOCH
            before = cmod.DICT_BYTES.value()
            r2 = bc.convert_image("img2", img2)
            assert cmod.DICT_BYTES.value() > before
            got.append((td.serialize(), r1.bootstrap, r2.bootstrap, r2.layer_blobs))
        assert got[0] == got[1]


class TestTrainedBatch:
    @needs_dict
    @pytest.mark.parametrize("backend", ["numpy", "hybrid"])
    def test_two_images_train_between(self, monkeypatch, backend):
        """``[compression] adaptive`` and ``train`` from the global config of
        each package, ``layer_fanout=1`` and one pack thread: image A fills
        the sample reservoir (1 MiB), the dictionary trains between the
        images, and image B carries nZD1 frames. Dictionary, bootstraps and
        blobs equal the reference's; each package unpacks the other's B."""
        from nydus_snapshotter_tpu.config import config as jconfig
        from nydus_snapshotter_tpu_torch.config import config as pconfig

        _pin_clock(monkeypatch)
        _threads(monkeypatch, 1)
        for mod in (pconfig, jconfig):
            cfg = mod.SnapshotterConfig()
            cfg.compression.adaptive = True
            cfg.compression.train = True
            cfg.compression.train_sample_mib = 1
            cfg.compression.train_dict_kib = 16
            monkeypatch.setattr(mod, "_global", cfg)
        img_a = [mktar([(f"a/{i}", textgen(280 << 10, 1200 + i)) for i in range(24)]),
                 mktar([(f"a/r{i}", randgen(40 << 10, 1300 + i)) for i in range(2)])]
        img_b = [mktar([(f"b/{i}", textgen(24 << 10, 1400 + i)) for i in range(12)])]
        out = []
        for bcls, popt, kw in ((BatchConverter, PackOption, {"device": "cpu"}), (JBatchConverter, JPackOption, {})):
            bc = bcls(popt(**{**OPT, "backend": backend}), layer_fanout=1, **kw)
            res = bc.convert_many([("A", img_a), ("B", img_b)])
            assert bc.codec.trained is not None
            out.append((bc.codec.trained.serialize(), res))
        (pdict, pres), (jdict, jres) = out
        assert pdict == jdict
        for p, j in zip(pres, jres):
            assert (p.bootstrap, p.blob_digests, p.layer_blobs) == (j.bootstrap, j.blob_digests, j.layer_blobs)
        b_blob = next(iter(pres[1].layer_blobs.values()))
        data = convert.blob_data_from_layer_blob(b_blob)
        recs = convert.bootstrap_from_layer_blob(b_blob).chunks
        assert any(codec.is_trained_frame(data[r.compressed_offset : r.compressed_offset + 8]) for r in recs)
        assert unpack(b_blob) == unpack(b_blob, jconvert)


class TestDecompressPool:
    def test_pooled_equals_fresh(self):
        data = textgen(256 << 10, 1000)
        frame = zstd.compress_block(data)
        assert frame == jzstd.compress_block(data)
        assert zstd.decompress_block(frame) == data
        assert jzstd.decompress_block(frame, pooled=False) == data
        assert zstdcompat.decompress_block(frame, len(data)) == data
        assert zstdcompat.zstandard.ZstdDecompressor().decompress(frame) == data

    def test_pool_reuses_contexts(self):
        frame = zstd.compress_block(textgen(32 << 10, 1001))
        zstd.decompress_block(frame)
        before = zstd.dctx_stats()
        for _ in range(16):
            zstd.decompress_block(frame)
        after = zstd.dctx_stats()
        assert after["reuses"] >= before["reuses"] + 16
        assert after["creates"] == before["creates"]

    def test_max_output_bound_enforced(self):
        frame = zstd.compress_block(textgen(64 << 10, 1002))
        for mod in (zstd, jzstd):
            with pytest.raises(mod.ZstdError, match="exceed"):
                mod.decompress_block(frame, max_output_size=100)


@needs_dict
class TestServiceZdict:
    def test_put_get_epoch_precedence(self):
        from nydus_snapshotter_tpu_torch.parallel.dict_service import DictService

        svc = DictService(device="cpu")
        ptd, _ = trained_dicts(seed=4, epoch=50)
        sd = svc.dict_for("nsz")
        assert sd.get_zdict() == b""
        out = sd.put_zdict(ptd.serialize())
        assert out["zdict_epoch"] == 50 and out["zdict_id"] == ptd.dict_id
        assert sd.put_zdict(codec.TrainedDict(ptd.bytes, epoch=9).serialize())["zdict_epoch"] == 50
        assert jcodec.TrainedDict.deserialize(sd.get_zdict()).epoch == 50
        status, _ctype, payload = svc.handle("GET", "/api/v1/dict/nsz/zdict", {}, b"")
        assert status == 200 and payload == ptd.serialize()

    def test_garbage_zdict_rejected(self):
        from nydus_snapshotter_tpu_torch.parallel.dict_service import DictService

        svc = DictService(device="cpu")
        status, _ctype, _payload = svc.handle("POST", "/api/v1/dict/nsz/zdict", {}, b"not a dict blob")
        assert status == 400
        with pytest.raises(codec.CodecError, match="too short"):
            svc.dict_for("nsz").put_zdict(b"not a dict blob")

    @pytest.mark.parametrize("client", ["port", "reference"])
    def test_batch_converter_adopts_service_dict(self, tmp_path, client):
        """A port DictService holds the namespace's dictionary; the port's
        and the reference's BatchConverter both adopt it before the first
        image and pack the same bytes."""
        from nydus_snapshotter_tpu_torch.parallel.dict_service import DictService

        sock = str(tmp_path / "dict.sock")
        svc = DictService(device="cpu")
        svc.run(sock)
        ptd, jtd = trained_dicts(seed=5, epoch=60)
        tar = mktar([("f", textgen(64 << 10, 1100))])
        try:
            svc.dict_for("default").put_zdict(ptd.serialize())
            if client == "port":
                bc = BatchConverter(PackOption(**OPT), dict_service=sock, codec=codecs()[0], device="cpu")
            else:
                bc = JBatchConverter(JPackOption(**OPT), dict_service=sock, codec=codecs()[1])
            assert bc.codec.trained is not None and bc.codec.trained.dict_id == ptd.dict_id
            r = bc.convert_image("img", [tar])
            bc.dict.client.close()
            c = codec.AdaptiveCodec(codec.CodecConfig(adaptive=True), trained=ptd)
            want, _ = convert.pack_layer(tar, PackOption(**OPT), device="cpu", codec=c)
            assert list(r.layer_blobs.values()) == [want]
        finally:
            svc.stop()


class TestConfig:
    def test_validation(self):
        from nydus_snapshotter_tpu_torch.config.config import ConfigError, SnapshotterConfig

        cfg = SnapshotterConfig()
        cfg.validate()
        cfg.compression.probe = "magic"
        with pytest.raises(ConfigError, match="compression.probe"):
            cfg.validate()
        cfg.compression.probe = "sample"
        cfg.compression.bypass_ratio = 0.2
        with pytest.raises(ConfigError, match="ratios"):
            cfg.validate()
        cfg.compression.bypass_ratio = 0.97
        cfg.compression.level_best = 99
        with pytest.raises(ConfigError, match="levels"):
            cfg.validate()

    @pytest.mark.parametrize(
        "env",
        [
            {},
            {"NTPU_COMPRESS_ADAPTIVE": "1", "NTPU_COMPRESS_PROBE": "entropy",
             "NTPU_COMPRESS_BYPASS_RATIO": "0.9", "NTPU_COMPRESS_LEVELS": "2,4,8"},
            {"NTPU_COMPRESS_ADAPTIVE": "yes", "NTPU_COMPRESS_PROBE_SAMPLE_KIB": "4",
             "NTPU_COMPRESS_TRAIN": "1", "NTPU_COMPRESS_BATCH_CHUNKS": "0",
             "NTPU_COMPRESS_LEVELS": "bad"},
            {"NTPU_COMPRESS_ADAPTIVE": "off", "NTPU_COMPRESS_DICT": "/x/zd",
             "NTPU_COMPRESS_VECTORIZED": "sideways"},
        ],
        ids=["defaults", "levels", "train", "off"],
    )
    def test_env_overrides_match_reference(self, monkeypatch, env):
        for k, v in env.items():
            monkeypatch.setenv(k, v)
        got = dataclasses.asdict(codec.resolve_codec_config())
        assert got == dataclasses.asdict(jcodec.resolve_codec_config())
        if env.get("NTPU_COMPRESS_LEVELS") == "2,4,8":
            assert (got["level_fast"], got["level_default"], got["level_best"]) == (2, 4, 8)
            c = codec.resolve_codec(PackOption(**OPT))
            assert c is not None and c.cfg.probe == "entropy"

    def test_config_section_read_after_env(self, monkeypatch):
        """``[compression]`` of the global config sits between the env and
        the defaults, in each package's config plane."""
        from nydus_snapshotter_tpu.config import config as jconfig
        from nydus_snapshotter_tpu_torch.config import config as pconfig

        for mod in (pconfig, jconfig):
            cfg = mod.SnapshotterConfig()
            cfg.compression.adaptive = True
            cfg.compression.probe = "entropy"
            cfg.compression.level_best = 7
            monkeypatch.setattr(mod, "_global", cfg)
        monkeypatch.delenv("NTPU_COMPRESS_ADAPTIVE", raising=False)
        got = dataclasses.asdict(codec.resolve_codec_config())
        assert got == dataclasses.asdict(jcodec.resolve_codec_config())
        assert got["adaptive"] and got["probe"] == "entropy" and got["level_best"] == 7
        monkeypatch.setenv("NTPU_COMPRESS_ADAPTIVE", "0")
        assert codec.resolve_codec(PackOption(**OPT)) is None

    def test_adaptive_off_by_default(self, monkeypatch):
        monkeypatch.delenv("NTPU_COMPRESS_ADAPTIVE", raising=False)
        assert not codec.resolve_codec_config().adaptive
