"""BatchConverter of the PyTorch port against the JAX package's.

A three-image corpus shaped like the reference suite's
(tests/test_batch_converter.py: a shared 300 000-byte file, a unique file
per image, here spread over several layers so the layer fan-out has work)
goes through both packages' ``BatchConverter.convert_many`` on the host
lanes (the port on ``device="cpu"``). Per image the merged bootstrap,
``blob_digests``, ``layer_blobs`` and ``new_dict_chunks`` must be equal,
byte for byte, at every fan-out, with a persisted dict, and through a
``service://`` dict on the port's ``DictService``; every refusal raises
``ConvertError``.
"""

import io
import tarfile

import numpy as np
import pytest

from nydus_snapshotter_tpu.converter.batch import BatchConverter as JBatchConverter
from nydus_snapshotter_tpu.converter.convert import Unpack as j_unpack
from nydus_snapshotter_tpu.converter.types import PackOption as JPackOption
from nydus_snapshotter_tpu_torch.converter import ConvertError, PackOption, Unpack
from nydus_snapshotter_tpu_torch.converter.batch import BatchConverter, GrowingChunkDict, ImageResult
from nydus_snapshotter_tpu_torch.converter.convert import blob_data_from_layer_blob
from nydus_snapshotter_tpu_torch.models import fstree
from nydus_snapshotter_tpu_torch.models.bootstrap import ChunkDict
from nydus_snapshotter_tpu_torch.parallel import dict_service as pds
from nydus_snapshotter_tpu_torch.utils import zstd as zstd_native

OPT = dict(chunk_size=0x1000, chunking="cdc")


def mk_tar(files: dict, whiteouts=()) -> bytes:
    buf = io.BytesIO()
    with tarfile.open(fileobj=buf, mode="w") as tf:
        for name, data in files.items():
            ti = tarfile.TarInfo(name)
            ti.size = len(data)
            tf.addfile(ti, io.BytesIO(data))
        for name in whiteouts:
            parent, _, base = name.rpartition("/")
            tf.addfile(tarfile.TarInfo(f"{parent}/.wh.{base}"))
    return buf.getvalue()


@pytest.fixture(scope="module")
def corpus():
    """[(name, [layer tar, ...])] for three images: img0 holds the shared
    file, img1 copies it under another path and whites out one of img0's
    paths it re-creates, img2 re-uses both."""
    rng = np.random.default_rng(0xBA7C4)
    shared = rng.integers(0, 256, 300_000, dtype=np.uint8).tobytes()
    uniq = [rng.integers(0, 256, 60_000, dtype=np.uint8).tobytes() for _ in range(3)]
    small = [rng.integers(0, 256, int(n), dtype=np.uint8).tobytes() for n in (0, 100, 5000, 9000)]
    return [
        ("img0", [mk_tar({"base/shared.bin": shared, "base/u0": uniq[0]}),
                  mk_tar({"etc/a": small[1], "etc/b": small[2]}),
                  mk_tar({"etc/c": small[3], "etc/empty": small[0]})]),
        ("img1", [mk_tar({"app/copy.bin": shared}),
                  mk_tar({"app/u1": uniq[1], "etc/a": small[2]}),
                  mk_tar({"app/late": small[3]}, whiteouts=["app/copy.bin"])]),
        ("img2", [mk_tar({"x/again.bin": shared, "x/u2": uniq[2]}),
                  mk_tar({"x/u1": uniq[1], "x/u0": uniq[0]})]),
    ]


def _same(got: list[ImageResult], want) -> None:
    assert [r.name for r in got] == [r.name for r in want]
    for g, w in zip(got, want):
        assert g.bootstrap == w.bootstrap, g.name
        assert g.blob_digests == w.blob_digests, g.name
        assert g.layer_blobs == w.layer_blobs, g.name
        assert g.new_dict_chunks == w.new_dict_chunks, g.name


@pytest.fixture(scope="module")
def reference(corpus):
    """The JAX package's batch per backend."""
    return {b: JBatchConverter(JPackOption(backend=b, **OPT)).convert_many(corpus)
            for b in ("hybrid", "numpy")}


class TestConvertMany:
    @pytest.mark.parametrize("backend", ["hybrid", "numpy"])
    @pytest.mark.parametrize("fanout", [1, 4])
    def test_convert_many_equals_reference(self, corpus, reference, backend, fanout):
        bc = BatchConverter(PackOption(backend=backend, **OPT), layer_fanout=fanout, device="cpu")
        got = bc.convert_many(corpus)
        _same(got, reference[backend])
        assert len(bc.dict) == sum(r.new_dict_chunks for r in got)
        # the shared file is stored once: later images reference img0's blob
        assert set(got[0].blob_digests) & set(got[1].blob_digests)
        assert set(got[0].blob_digests) & set(got[2].blob_digests)

    @pytest.mark.parametrize("max_workers", [None, 2])
    def test_max_workers(self, corpus, reference, max_workers):
        bc = BatchConverter(PackOption(backend="hybrid", **OPT), max_workers=max_workers,
                            device="cpu")
        _same(bc.convert_many(corpus), reference["hybrid"])

    def test_fused_lane_through_the_pool(self):
        """The fused lane (its kernels' plain versions on the CPU) from four
        threads equals the hybrid batch and the reference's."""
        rng = np.random.default_rng(5)
        files = [rng.integers(0, 256, n, dtype=np.uint8).tobytes() for n in (9000, 3000, 12000)]
        images = [("a", [mk_tar({"f0": files[0]}), mk_tar({"f1": files[1]}),
                         mk_tar({"f2": files[2]})]),
                  ("b", [mk_tar({"g0": files[0], "g1": files[2]}), mk_tar({"g2": files[1][:999]})])]
        want = JBatchConverter(JPackOption(backend="hybrid", **OPT)).convert_many(images)
        for backend in ("fused", "hybrid"):
            got = BatchConverter(PackOption(backend=backend, **OPT), layer_fanout=4,
                                 device="cpu").convert_many(images)
            _same(got, want)

    @pytest.mark.parametrize("compressor", ["none", "zstd"])
    def test_compressors(self, corpus, compressor):
        opt = dict(backend="hybrid", compressor=compressor, **OPT)
        got = BatchConverter(PackOption(**opt), device="cpu").convert_many(corpus)
        _same(got, JBatchConverter(JPackOption(**opt)).convert_many(corpus))

    def test_every_image_unpacks_to_its_overlay(self, corpus, reference):
        got = BatchConverter(PackOption(backend="hybrid", **OPT), device="cpu").convert_many(corpus)
        blobs = {}
        for (name, tars), res in zip(corpus, got):
            blobs.update({bid: blob_data_from_layer_blob(b) for bid, b in res.layer_blobs.items()})
            out = Unpack(res.bootstrap, blobs)
            assert out == j_unpack(res.bootstrap, blobs)
            want = []
            for t in tars:
                want = fstree.apply_overlay(want, fstree.tree_from_tar(t))
            tree = {e.path: e.data for e in fstree.tree_from_tar(out) if e.data}
            assert tree == {e.path: e.data for e in want if e.data}, name

    def test_empty_image_refused(self):
        with pytest.raises(ConvertError, match="no layers"):
            BatchConverter(PackOption(**OPT), device="cpu").convert_image("e", [])


class TestDictPersistence:
    def test_save_and_reload(self, corpus, tmp_path):
        opt = dict(backend="hybrid", **OPT)
        bc, jbc = BatchConverter(PackOption(**opt), device="cpu"), JBatchConverter(JPackOption(**opt))
        _same(bc.convert_many(corpus[:1]), jbc.convert_many(corpus[:1]))
        path, jpath = tmp_path / "d.boot", tmp_path / "j.boot"
        bc.save_dict(str(path))
        jbc.save_dict(str(jpath))
        assert path.read_bytes() == jpath.read_bytes()
        # a new converter seeded from the file dedups the rest as the reference's
        again = BatchConverter(PackOption(**opt), dict_path=str(path), device="cpu")
        jagain = JBatchConverter(JPackOption(**opt), dict_path=str(jpath))
        _same(again.convert_many(corpus[1:]), jagain.convert_many(corpus[1:]))
        assert len(ChunkDict.from_path(str(path))) == len(GrowingChunkDict.load(str(path)))

    def test_seeded_from_a_real_bootstrap(self, corpus, reference, tmp_path):
        """dict_path may be a real RAFS v5 bootstrap (models/nydus_real)."""
        from nydus_snapshotter_tpu_torch.converter import Merge, MergeOption

        opt = dict(backend="hybrid", **OPT)
        blobs = list(reference["hybrid"][0].layer_blobs.values())
        path = tmp_path / "v5.boot"
        path.write_bytes(Merge(blobs, MergeOption(bootstrap_format="rafs-v5")).bootstrap)
        got = BatchConverter(PackOption(**opt), dict_path=str(path), device="cpu").convert_many(
            corpus[1:])
        want = JBatchConverter(JPackOption(**opt), dict_path=str(path)).convert_many(corpus[1:])
        _same(got, want)

    def test_codec_dict_surface(self):
        bc = BatchConverter(PackOption(**OPT), device="cpu")
        jbc = JBatchConverter(JPackOption(**OPT))
        assert bc.train_codec_dict() is None and jbc.train_codec_dict() is None
        assert bc.save_trained_dict("/nonexistent/x") is False
        assert jbc.save_trained_dict("/nonexistent/x") is False


@pytest.fixture()
def services(tmp_path):
    started = []

    def make():
        svc = pds.DictService(device="cpu")
        svc.run(str(tmp_path / f"s{len(started)}.sock"))
        started.append(svc)
        return svc.sock_path

    yield make
    for svc in started:
        svc.stop()


class TestServiceDict:
    @pytest.mark.parametrize("form", ["address", "service://", "env", "shards"])
    def test_service_batch_equals_private_dict(self, corpus, reference, services, form,
                                               monkeypatch):
        opt = PackOption(backend="hybrid", **OPT)
        if form == "address":
            bc = BatchConverter(opt, dict_service=services(), device="cpu")
        elif form == "service://":
            bc = BatchConverter(opt, dict_service=f"service://{services()}", namespace="ns1",
                                device="cpu")
        elif form == "env":
            monkeypatch.setenv("NTPU_DICT_SERVICE", services())
            bc = BatchConverter(opt, device="cpu")
        else:
            bc = BatchConverter(opt, dict_service=f"{services()},{services()}", device="cpu")
        assert isinstance(bc.dict, pds.ServiceChunkDict)
        try:
            _same(bc.convert_many(corpus), reference["hybrid"])
        finally:
            bc.dict.close()

    def test_two_converters_share_one_namespace(self, corpus, reference, services):
        """A second converter's mirror, opened after the first converted
        img0, dedups against img0 through the service alone."""
        sock = services()
        first = BatchConverter(PackOption(backend="hybrid", **OPT), dict_service=sock, device="cpu")
        try:
            got = first.convert_many(corpus[:1])
        finally:
            first.dict.close()
        second = BatchConverter(PackOption(backend="hybrid", **OPT), dict_service=sock, device="cpu")
        try:
            got += second.convert_many(corpus[1:])
        finally:
            second.dict.close()
        _same(got, reference["hybrid"])


class TestRefusals:
    @pytest.mark.parametrize(
        "kw, match",
        [
            # accepted since the pipeline was ported: a private budget
            (dict(memory_budget_mib=64), None),
            (dict(codec=object()), "adaptive codec"),
            (dict(dict_service="service+ha://a|b"), "HA dict service"),
            (dict(dict_service="/tmp/a.sock|/tmp/b.sock"), "HA dict service"),
            (dict(dict_service="/tmp/a.sock", dict_path="/tmp/d.boot"), "dict_path"),
        ],
        ids=["memory_budget", "codec", "service+ha", "failover-group", "service-and-dict_path"],
    )
    def test_refused(self, kw, match):
        if match is None:
            assert BatchConverter(PackOption(**OPT), device="cpu", **kw).budget.total == 64 << 20
            return
        with pytest.raises(ConvertError, match=match):
            BatchConverter(PackOption(**OPT), device="cpu", **kw)

    def test_pack_option_dict_path_refused(self):
        with pytest.raises(ConvertError, match="owns the chunk dict"):
            BatchConverter(PackOption(chunk_dict_path="/tmp/x.boot", **OPT), device="cpu")

    @pytest.mark.skipif(not zstd_native.available(), reason="the system libzstd is not bound")
    def test_adaptive_codec_setting_refused(self, monkeypatch):
        monkeypatch.setenv("NTPU_COMPRESS_ADAPTIVE", "1")
        with pytest.raises(ConvertError, match="adaptive codec"):
            BatchConverter(PackOption(compressor="zstd", **OPT), device="cpu")
        # lz4_block is not the adaptive codec's: the reference packs as usual
        BatchConverter(PackOption(compressor="lz4_block", **OPT), device="cpu")
