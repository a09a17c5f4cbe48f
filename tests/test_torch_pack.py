"""pack_layer of the PyTorch port against the JAX package's.

The layer tar of the reference's fused pack-lane test (file sizes 0 to
400 000 bytes and a symlink) is packed by both packages, for each of the
port's backends and for the reference's option surface (compressors,
batching, alignment, prefetch, file-based chunk dicts, fixed chunking,
digest backends): the framed layer blob, the bootstrap and the blob id must
be byte-identical.
"""

import hashlib
import io
import os
import tarfile

import numpy as np
import pytest

from nydus_snapshotter_tpu.converter.convert import Pack as j_Pack
from nydus_snapshotter_tpu.converter.convert import Unpack as j_unpack
from nydus_snapshotter_tpu.converter.convert import blob_data_from_layer_blob
from nydus_snapshotter_tpu.converter.convert import pack_layer as j_pack_layer
from nydus_snapshotter_tpu.converter.stream import IncrementalChunker as JIncrementalChunker
from nydus_snapshotter_tpu.converter.types import PackOption as JPackOption
from nydus_snapshotter_tpu.models.bootstrap import Bootstrap as JBootstrap
from nydus_snapshotter_tpu.models.bootstrap import ChunkDict as JChunkDict
from nydus_snapshotter_tpu.models.nydus_real_write import real_from_bootstrap, write_real_v6
from nydus_snapshotter_tpu.ops import cdc as jcdc
from nydus_snapshotter_tpu.ops import fused_convert as jfc
from nydus_snapshotter_tpu_torch.converter import (
    ConvertError,
    IncrementalChunker,
    Pack,
    PackOption,
    pack_layer,
)
from nydus_snapshotter_tpu_torch import constants
from nydus_snapshotter_tpu_torch.models import layout
from nydus_snapshotter_tpu_torch.models.bootstrap import (
    CHUNK_FLAG_BATCH,
    Bootstrap,
    BootstrapError,
    ChunkDict,
)
from nydus_snapshotter_tpu_torch.converter import pack as native_pack
from nydus_snapshotter_tpu_torch.ops import fused_convert


def _layer_tar(seed: int = 5, files: int = 24) -> bytes:
    rng = np.random.default_rng(seed)
    buf = io.BytesIO()
    with tarfile.open(fileobj=buf, mode="w") as tf:
        for i in range(files):
            size = int(rng.choice([0, 100, 5000, 80_000, 400_000]))
            data = rng.integers(0, 256, size, dtype=np.uint8).tobytes()
            ti = tarfile.TarInfo(f"d/f{i}")
            ti.size = size
            tf.addfile(ti, io.BytesIO(data))
        ti = tarfile.TarInfo("d/link")
        ti.type = tarfile.SYMTYPE
        ti.linkname = "f0"
        tf.addfile(ti)
    return buf.getvalue()


def _overflow_tar(files: int = 6) -> bytes:
    """The reference's overflow-fallback tar: 150 000-byte random files."""
    rng = np.random.default_rng(41)
    buf = io.BytesIO()
    with tarfile.open(fileobj=buf, mode="w") as tf:
        for i in range(files):
            data = rng.integers(0, 256, 150_000, dtype=np.uint8).tobytes()
            ti = tarfile.TarInfo(f"o/f{i}")
            ti.size = len(data)
            tf.addfile(ti, io.BytesIO(data))
    return buf.getvalue()


def _sparse_tar() -> bytes:
    """A GNU sparse member (old-style map in the header) between two
    regular files; its data region holds two 20 000-byte runs."""
    rng = np.random.default_rng(43)
    runs = [rng.integers(0, 256, 20_000, dtype=np.uint8).tobytes() for _ in range(2)]
    buf = io.BytesIO()
    with tarfile.open(fileobj=buf, mode="w", format=tarfile.GNU_FORMAT) as tf:
        ti = tarfile.TarInfo("s/a")
        ti.size = 30_000
        tf.addfile(ti, io.BytesIO(rng.integers(0, 256, 30_000, dtype=np.uint8).tobytes()))
        head = bytearray(tarfile.TarInfo("s/sparse").tobuf(tarfile.GNU_FORMAT))
    # Rewrite the header as type 'S' with a sparse map: (0, 20 000) and
    # (50 000, 20 000), real size 70 000, 40 000 bytes of data stored.
    head[156:157] = tarfile.GNUTYPE_SPARSE
    head[124:136] = b"%011o\0" % 40_000
    for k, (off, num) in enumerate([(0, 20_000), (50_000, 20_000)]):
        base = 386 + 24 * k
        head[base : base + 12] = b"%011o\0" % off
        head[base + 12 : base + 24] = b"%011o\0" % num
    head[483:495] = b"%011o\0" % 70_000
    head[148:156] = b" " * 8
    head[148:156] = b"%06o\0 " % sum(head)
    body = b"".join(runs)
    tail = io.BytesIO()
    with tarfile.open(fileobj=tail, mode="w", format=tarfile.GNU_FORMAT) as tf:
        ti = tarfile.TarInfo("s/b")
        ti.size = 9_000
        tf.addfile(ti, io.BytesIO(rng.integers(0, 256, 9_000, dtype=np.uint8).tobytes()))
    first = buf.getvalue()[: -tarfile.RECORDSIZE]
    first = first[: len(first) - len(first) % 512]
    while first.endswith(b"\0" * 512):
        first = first[:-512]
    return first + bytes(head) + body + b"\0" * (-len(body) % 512) + tail.getvalue()


@pytest.fixture(scope="module")
def tar():
    return _layer_tar()


@pytest.fixture(scope="module")
def reference(tar):
    return j_pack_layer(tar, JPackOption(chunk_size=0x10000, backend="numpy", compressor="none"))


class TestPackByteIdentity:
    # RAFS v5 only changes emission, which both backends share: the fused
    # backend (the slow one on the CPU) runs once.
    @pytest.mark.parametrize(
        "backend,fs_version",
        [
            ("fused", layout.RAFS_V6),
            ("jax", layout.RAFS_V6),
            ("numpy", layout.RAFS_V6),
            ("numpy", layout.RAFS_V5),
        ],
    )
    def test_matches_reference(self, tar, backend, fs_version):
        blob, res = pack_layer(
            tar,
            PackOption(chunk_size=0x10000, backend=backend, compressor="none", fs_version=fs_version),
            device="cpu",
        )
        jblob, jres = j_pack_layer(
            tar,
            JPackOption(chunk_size=0x10000, backend=backend, compressor="none", fs_version=fs_version),
        )
        assert blob == jblob
        assert res.bootstrap == jres.bootstrap
        assert res.blob_id == jres.blob_id and res.blob_size == jres.blob_size
        assert res.referenced_blob_ids == jres.referenced_blob_ids

    def test_chunk_dict_hits_match_reference(self, tar, reference):
        """A dict built from the same layer: every chunk is a dict hit and
        nothing is stored, in both packages."""
        _jblob, jres = reference
        jdict = JChunkDict(JBootstrap.from_bytes(jres.bootstrap))
        pdict = ChunkDict(Bootstrap.from_bytes(jres.bootstrap))
        blob, res = pack_layer(
            tar, PackOption(chunk_size=0x10000, backend="numpy", compressor="none"), chunk_dict=pdict
        )
        jblob, jres2 = j_pack_layer(
            tar, JPackOption(chunk_size=0x10000, backend="numpy", compressor="none"), chunk_dict=jdict
        )
        assert blob == jblob and res.bootstrap == jres2.bootstrap
        assert res.blob_size == 0 and res.referenced_blob_ids == [jres.blob_id]

    def test_empty_layer(self):
        buf = io.BytesIO()
        with tarfile.open(fileobj=buf, mode="w"):
            pass
        opt = dict(chunk_size=0x10000, compressor="none")
        blob, res = pack_layer(buf.getvalue(), PackOption(backend="fused", **opt), device="cpu")
        jblob, jres = j_pack_layer(buf.getvalue(), JPackOption(backend="numpy", **opt))
        assert blob == jblob and res.blob_id == "" == jres.blob_id


class TestFusedBatches:
    def test_split_layer_matches_reference(self, monkeypatch):
        """A layer split over several device batches packs byte-identically
        (shrunken window and batch limit, so a small tar needs several)."""
        buf = io.BytesIO()
        rng = np.random.default_rng(9)
        with tarfile.open(fileobj=buf, mode="w") as tf:
            for i, size in enumerate([1_500, 1_500, 700, 0, 3_000, 1_500, 2_000, 1_200]):
                ti = tarfile.TarInfo(f"d/f{i}")
                ti.size = size
                tf.addfile(ti, io.BytesIO(rng.integers(0, 256, size, dtype=np.uint8).tobytes()))
        tar = buf.getvalue()
        monkeypatch.setattr(fused_convert, "WINDOW", 1 << 12)
        monkeypatch.setattr(fused_convert, "MAX_BATCH_PAD", (5 << 12) + 1)
        calls = []
        real = fused_convert.FusedDeviceEngine.process_many
        monkeypatch.setattr(
            fused_convert.FusedDeviceEngine,
            "process_many",
            lambda self, streams, **kw: calls.append(len(streams)) or real(self, streams, **kw),
        )
        # small chunks keep every chunk short for the plain SHA-256
        opt = dict(chunk_size=0x1000, compressor="none")
        blob, res = pack_layer(tar, PackOption(backend="fused", **opt), device="cpu")
        jblob, jres = j_pack_layer(tar, JPackOption(backend="numpy", **opt))
        assert len(calls) > 2 and sum(calls) == 7
        assert blob == jblob and res.bootstrap == jres.bootstrap and res.blob_id == jres.blob_id

    @pytest.mark.parametrize("make_tar", [_overflow_tar, _sparse_tar], ids=["plain", "sparse"])
    def test_candidate_overflow_falls_back(self, monkeypatch, make_tar):
        """On a candidate-capacity overflow the fused backend falls to the
        per-file windowed lane, still on the device, and packs the bytes the
        reference's fallback packs (as
        tests/test_fused_convert.py::test_pack_stream_overflow_falls_back_identically
        pins for the reference), in its order: a sparse member's chunks,
        streamed during the tar walk, are stored before the in-memory
        files' chunks."""
        tar = make_tar()
        monkeypatch.setattr(jfc, "_wcap_for", lambda n, bits, floor=1024: 2)
        monkeypatch.setattr(fused_convert, "_wcap_for", lambda n, bits, floor=1024: 2)
        opt = dict(chunk_size=0x1000, compressor="none", backend="fused")
        blob, res = pack_layer(tar, PackOption(**opt), device="cpu")
        jblob, jres = j_pack_layer(tar, JPackOption(**opt))
        assert blob == jblob and res.bootstrap == jres.bootstrap and res.blob_id == jres.blob_id

    def test_file_beyond_int32_addressing_falls_back(self, monkeypatch):
        """A file too large for any fused batch takes the per-file windowed
        lane, byte-identical to the reference."""
        tar = _overflow_tar()
        monkeypatch.setattr(fused_convert, "MAX_BATCH_PAD", fused_convert.WINDOW)
        opt = dict(chunk_size=0x1000, compressor="none")
        blob, res = pack_layer(tar, PackOption(backend="fused", **opt), device="cpu")
        jblob, jres = j_pack_layer(tar, JPackOption(backend="numpy", **opt))
        assert blob == jblob and res.bootstrap == jres.bootstrap and res.blob_id == jres.blob_id


class TestStreamingPack:
    def test_stream_and_bytes_inputs_identical(self):
        """A file-like tar streams through IncrementalChunker and packs the
        bytes of the in-memory walk, as the reference's do
        (tests/test_stream_pack.py::test_stream_and_bytes_inputs_identical)."""
        tar = _overflow_tar(files=3)
        opt = PackOption(chunk_size=0x1000, backend="jax", compressor="none")
        blob, res = pack_layer(tar, opt, device="cpu")
        out = io.BytesIO()
        res2 = Pack(out, io.BytesIO(tar), opt, device="cpu")
        jblob, jres = j_pack_layer(
            tar, JPackOption(chunk_size=0x1000, backend="numpy", compressor="none")
        )
        assert out.getvalue() == blob == jblob
        assert res2.blob_id == res.blob_id == jres.blob_id
        assert res2.bootstrap == res.bootstrap == jres.bootstrap

    @pytest.mark.parametrize("seg", [1 << 12, 1 << 16, 1 << 20])
    def test_incremental_chunker_matches_whole_stream(self, seg):
        """Cuts of a stream fed in segments equal the reference's
        IncrementalChunker and whole-stream chunking."""
        data = np.random.default_rng(23).integers(0, 256, 600_000, dtype=np.uint8).tobytes()
        ch = IncrementalChunker(PackOption(chunk_size=0x1000, backend="jax"), device="cpu")
        jch = JIncrementalChunker(JPackOption(chunk_size=0x1000, backend="numpy"))
        chunks, jchunks = [], []
        for off in range(0, len(data), seg):
            chunks.extend(c for c, _ in ch.feed(data[off : off + seg]))
            jchunks.extend(c for c, _ in jch.feed(data[off : off + seg]))
        chunks.extend(c for c, _ in ch.finish())
        jchunks.extend(c for c, _ in jch.finish())
        assert b"".join(chunks) == data and chunks == jchunks
        want = jcdc.chunk_data_np(np.frombuffer(data, np.uint8), jcdc.CDCParams(0x1000))
        assert np.array_equal(np.cumsum([len(c) for c in chunks]), want)

    @pytest.mark.parametrize("digester", ["sha256", "blake3"])
    def test_incremental_chunker_native_arm(self, digester):
        """On ``hybrid`` the chunker's native arm hands each chunk with its
        digest, in the reference's chunks."""
        from nydus_snapshotter_tpu_torch.utils import blake3 as pyb3

        data = np.random.default_rng(29).integers(0, 256, 300_000, dtype=np.uint8).tobytes()
        opt = dict(chunk_size=0x1000, backend="hybrid", digester=digester)
        ch = IncrementalChunker(PackOption(**opt))
        jch = JIncrementalChunker(JPackOption(**opt))
        assert ch.fused and jch.fused
        got, want = [], []
        for off in range(0, len(data), 1 << 14):
            got.extend(ch.feed(data[off : off + (1 << 14)]))
            want.extend(jch.feed(data[off : off + (1 << 14)]))
        got.extend(ch.finish())
        want.extend(jch.finish())
        assert got == want and b"".join(c for c, _ in got) == data
        h = pyb3.blake3 if digester == "blake3" else (lambda b: hashlib.sha256(b).digest())
        assert all(d == h(c) for c, d in got)
        whole = ch.chunk_whole(memoryview(data))
        assert [(bytes(c), d) for c, d in whole] == got

    def test_sparse_member_matches_reference(self):
        """A GNU sparse member goes through the same chunker, in the
        reference's order (during the walk, before the in-memory files)."""
        tar = _sparse_tar()
        opt = dict(chunk_size=0x1000, compressor="none")
        blob, res = pack_layer(tar, PackOption(backend="jax", **opt), device="cpu")
        jblob, jres = j_pack_layer(tar, JPackOption(backend="numpy", **opt))
        assert blob == jblob and res.bootstrap == jres.bootstrap


def _assert_same(got, want):
    blob, res = got
    jblob, jres = want
    assert blob == jblob
    assert res.bootstrap == jres.bootstrap
    assert res.blob_id == jres.blob_id and res.blob_size == jres.blob_size
    assert res.referenced_blob_ids == jres.referenced_blob_ids


def _pack_both(tar, backend, ref_backend=None, chunk_dict=None, jchunk_dict=None, **kw):
    """The port's ``pack_layer`` on the CPU and the reference's, with the
    same options -> the port's (blob, result) after checking equality."""
    got = pack_layer(tar, PackOption(backend=backend, **kw), chunk_dict=chunk_dict, device="cpu")
    _assert_same(
        got, j_pack_layer(tar, JPackOption(backend=ref_backend or backend, **kw), chunk_dict=jchunk_dict)
    )
    return got


# Small chunks keep the plain SHA-256 of the device lanes quick on the CPU.
SMALL = dict(chunk_size=0x1000)
BACKENDS = ["fused", "jax", "hybrid", "numpy"]


@pytest.fixture(scope="module")
def small_tar():
    return _layer_tar(seed=7, files=8)


def _third_tar(seed: int = 7, files: int = 8) -> bytes:
    """Every third file of ``_layer_tar(seed, files)``: a chunk-dict source."""
    src = tarfile.open(fileobj=io.BytesIO(_layer_tar(seed, files)))
    buf = io.BytesIO()
    with tarfile.open(fileobj=buf, mode="w") as tf:
        for i, m in enumerate(m for m in src if m.isreg()):
            if i % 3 == 0:
                tf.addfile(m, src.extractfile(m))
    return buf.getvalue()


class TestCompressedPack:
    @pytest.mark.parametrize("fs_version", [layout.RAFS_V6, layout.RAFS_V5])
    @pytest.mark.parametrize("backend", BACKENDS)
    @pytest.mark.parametrize("compressor", ["lz4_block", "zstd"])
    def test_matches_reference(self, small_tar, compressor, backend, fs_version):
        _blob, res = _pack_both(small_tar, backend, compressor=compressor, fs_version=fs_version, **SMALL)
        flags = {c.flags for c in Bootstrap.from_bytes(res.bootstrap).chunks}
        want = constants.COMPRESSOR_ZSTD if compressor == "zstd" else constants.COMPRESSOR_LZ4_BLOCK
        assert flags == {want}

    def test_default_is_lz4_block(self, small_tar):
        assert PackOption().compressor == JPackOption().compressor == "lz4_block"
        _pack_both(small_tar, "numpy", **SMALL)

    @pytest.mark.parametrize("backend", BACKENDS)
    def test_zstd_blake3_matches_reference(self, backend):
        # the reference's numpy lane: its fused lane compiles the XLA
        # BLAKE3, and every lane packs the same bytes
        tar = _layer_tar(seed=11, files=4)
        _pack_both(tar, backend, ref_backend="numpy", compressor="zstd", digester="blake3", **SMALL)

    @pytest.mark.parametrize("backend", BACKENDS)
    def test_lz4_acceleration_matches_reference(self, small_tar, backend):
        _pack_both(small_tar, backend, compressor="lz4_block", lz4_acceleration=8, **SMALL)

    @pytest.mark.parametrize("backend", BACKENDS)
    def test_batch_align_prefetch_together(self, small_tar, backend):
        """Batches (flushed before every chunk at or above batch_size, 8 KiB here),
        4096-byte alignment on v5 and the prefetch table, at once."""
        _blob, res = _pack_both(
            small_tar, backend, compressor="zstd", batch_size=0x2000, aligned_chunk=True,
            fs_version=layout.RAFS_V5, prefetch_patterns="/d/f3\n/d\n/nothing", **SMALL,
        )
        boot = Bootstrap.from_bytes(res.bootstrap)
        assert boot.batches and boot.prefetch[0] == "/d/f3"
        assert any(c.flags & CHUNK_FLAG_BATCH for c in boot.chunks)
        assert all(c.compressed_offset % 4096 == 0 for c in boot.chunks)

    @pytest.mark.parametrize("backend", BACKENDS)
    def test_chunk_dict_path_matches_reference(self, tmp_path, small_tar, backend):
        """``chunk_dict_path="bootstrap=<file>"``: the bootstrap of a batched
        pack of a third of the files; its hits, blob and batch records go
        into the new bootstrap as the reference puts them."""
        _dblob, dres = j_pack_layer(
            _third_tar(), JPackOption(backend="numpy", compressor="zstd", batch_size=0x2000, **SMALL)
        )
        path = tmp_path / "dict.boot"
        path.write_bytes(dres.bootstrap)
        _blob, res = _pack_both(
            small_tar, backend, compressor="zstd", chunk_dict_path=f"bootstrap={path}", **SMALL
        )
        assert res.referenced_blob_ids[1:] == [dres.blob_id]
        boot = Bootstrap.from_bytes(res.bootstrap)
        assert any(b.blob_index == 1 for b in boot.batches)
        # a passed dict takes the place of the path, as in the reference
        _pack_both(
            small_tar, backend, compressor="zstd", chunk_dict_path="/nonexistent",
            chunk_dict=ChunkDict(Bootstrap.from_bytes(dres.bootstrap)),
            jchunk_dict=JChunkDict(JBootstrap.from_bytes(dres.bootstrap)), **SMALL,
        )

    def test_real_bootstrap_dict_raises(self, tmp_path, small_tar):
        """A real nydus v6 bootstrap as the dict: both packages read it
        (models/nydus_real.load_any_bootstrap) and pack the same bytes
        against it; bytes that neither reader takes raise BootstrapError."""
        # v6's fixed chunk grid: the real layout carries no CDC chunks
        _b, jres = j_pack_layer(small_tar, JPackOption(backend="numpy", chunking="fixed", **SMALL))
        path = tmp_path / "real.boot"
        path.write_bytes(write_real_v6(real_from_bootstrap(JBootstrap.from_bytes(jres.bootstrap))))
        opt = dict(chunk_dict_path=f"bootstrap={path}", chunking="fixed", **SMALL)
        _blob, res = _pack_both(small_tar, "numpy", **opt)
        assert res.blob_id == "" and res.referenced_blob_ids == [jres.blob_id]
        bad = tmp_path / "bad.boot"
        bad.write_bytes(b"\0" * 9000)
        with pytest.raises(BootstrapError, match="real nydus"):
            pack_layer(small_tar, PackOption(backend="numpy", chunk_dict_path=str(bad), **SMALL),
                       device="cpu")

    def test_streaming_pack_zstd(self):
        """The file-like ``Pack`` compresses as the in-memory walk does."""
        tar = _overflow_tar(files=3)
        opt = dict(compressor="zstd", batch_size=0x2000, **SMALL)
        out = io.BytesIO()
        res = Pack(out, io.BytesIO(tar), PackOption(backend="jax", **opt), device="cpu")
        _assert_same((out.getvalue(), res), j_pack_layer(tar, JPackOption(backend="jax", **opt)))
        _assert_same((out.getvalue(), res), pack_layer(tar, PackOption(backend="jax", **opt), device="cpu"))

    @pytest.mark.parametrize("make_tar", [_overflow_tar, _sparse_tar], ids=["plain", "sparse"])
    def test_fused_fallback_zstd(self, monkeypatch, make_tar):
        """The fused lane forced onto its fallback stores the walk's
        streamed chunks first, into the same batches as the reference."""
        tar = make_tar()
        monkeypatch.setattr(jfc, "_wcap_for", lambda n, bits, floor=1024: 2)
        monkeypatch.setattr(fused_convert, "_wcap_for", lambda n, bits, floor=1024: 2)
        _pack_both(tar, "fused", compressor="zstd", batch_size=0x2000, **SMALL)

    def test_reference_unpacks_port_zstd_blob(self, small_tar):
        blob, res = pack_layer(
            small_tar, PackOption(backend="fused", compressor="zstd", batch_size=0x2000, **SMALL),
            device="cpu",
        )
        out = j_unpack(res.bootstrap, {res.blob_id: blob_data_from_layer_blob(blob)})
        src = tarfile.open(fileobj=io.BytesIO(small_tar))
        got = tarfile.open(fileobj=io.BytesIO(out))
        want = {m.name: src.extractfile(m).read() for m in src if m.isreg()}
        back = {m.name.lstrip("/"): got.extractfile(m).read() for m in got if m.isreg()}
        assert back == want

    def test_stats_split(self, small_tar):
        """``stats`` gets the reference's stage keys and accumulates; the
        whole-layer ``fused_pack`` key stays 0 off the hybrid lane."""
        opt = PackOption(backend="jax", compressor="zstd", **SMALL)
        stats, jstats = {}, {}
        pack_layer(small_tar, opt, device="cpu", stats=stats)
        first = dict(stats)
        pack_layer(small_tar, opt, device="cpu", stats=stats)
        j_pack_layer(small_tar, JPackOption(backend="jax", compressor="zstd", **SMALL), stats=jstats)
        assert set(stats) == set(jstats) == {
            "scan", "chunk_digest", "fused_pack", "dedup", "assemble", "bootstrap"
        }
        assert first["fused_pack"] == stats["fused_pack"] == 0
        assert all(0 <= first[k] < stats[k] for k in stats if k != "fused_pack")
        assert first["assemble"] > 0


class TestPackOptions:
    @pytest.mark.parametrize(
        "kw",
        [
            pytest.param({"compressor": "lz4_block"}, id="kw0"),
            pytest.param({"compressor": "zstd"}, id="kw1"),
            pytest.param({"digest_backend": "jax"}, id="kw3"),
            pytest.param({"chunking": "fixed"}, id="kw4"),
            pytest.param({"batch_size": 0x2000}, id="kw6"),
            pytest.param({"aligned_chunk": True, "fs_version": layout.RAFS_V5}, id="kw8"),
            pytest.param({"prefetch_patterns": "/d"}, id="kw9"),
            pytest.param({"digest_backend": "host"}, id="kw11"),
            pytest.param({"backend": "hybrid"}, id="kw2"),
        ],
    )
    def test_option_matches_reference(self, monkeypatch, small_tar, kw):
        """Options that test_unsupported_options_raise refused before they
        were ported (same ids): every lane packs the reference's bytes. The
        hybrid backend packs them at one thread (its whole-layer lane) and at
        four (its per-file lane on the stage-parallel pipeline), and the
        file-like Pack too."""
        kw = {"compressor": "none", **SMALL, **kw}
        if "backend" not in kw:
            for backend in BACKENDS:
                _pack_both(small_tar, backend, **kw)
            return
        monkeypatch.setenv("NTPU_PACK_THREADS_FORCE", "1")
        for threads, lane in (("1", "pack_files"), ("4", "pipeline")):
            monkeypatch.setenv("NTPU_PACK_THREADS", threads)
            blob, res = _pack_both(small_tar, **kw)
            assert res.route["lane"] == lane
            out = io.BytesIO()
            Pack(out, io.BytesIO(small_tar), PackOption(**kw), device="cpu")
            assert out.getvalue() == blob

    @pytest.mark.parametrize(
        "kw", [pytest.param({"chunk_dict_path": "service://{sock}#ns"}, id="service")]
    )
    def test_dict_service_matches_reference(self, tmp_path, small_tar, kw):
        """``chunk_dict_path="service://..."`` (refused before it was ported,
        same id): a port DictService on the CPU holds the bootstrap of a pack
        of a third of the files. Every port lane packs through its mirror
        what the reference's pack_layer packs through its own client of the
        same service."""
        from nydus_snapshotter_tpu_torch.parallel.dict_service import DictClient, DictService

        _dblob, dres = j_pack_layer(_third_tar(), JPackOption(backend="numpy", **SMALL))
        svc = DictService(device="cpu")
        svc.run(str(tmp_path / "dict.sock"))
        try:
            assert DictClient(svc.sock_path).merge(dres.bootstrap, "ns")["added"] > 0
            path = kw["chunk_dict_path"].format(sock=svc.sock_path)
            for backend in BACKENDS:
                _blob, res = _pack_both(small_tar, backend, chunk_dict_path=path, **SMALL)
                assert res.referenced_blob_ids[1:] == [dres.blob_id]
        finally:
            svc.stop()

    @pytest.mark.parametrize(
        "kw",
        [
            pytest.param({"digester": "md5"}, id="kw5"),
            pytest.param({"encrypt": True}, id="kw7"),
            pytest.param({"chunk_dict_path": "/nonexistent"}, id="kw10"),
            pytest.param({"chunk_dict_path": "service+ha:///run/ctl.sock"}, id="service_ha"),
            pytest.param({"chunk_dict_path": "service:///run/a.sock|/run/b.sock#ns"},
                         id="service_group"),
            pytest.param({"lz4_acceleration": 0}, id="lz4_acceleration"),
        ],
    )
    def test_unsupported_options_raise(self, kw):
        """Refused options raise ConvertError; a missing dict file raises
        what the reference raises there."""
        tar = _layer_tar(files=1)
        want = ConvertError
        if kw.get("chunk_dict_path") == "/nonexistent":
            with pytest.raises(Exception) as ref:
                j_pack_layer(tar, JPackOption(**{"compressor": "none", **kw}))
            want = type(ref.value)
            assert want is FileNotFoundError
        with pytest.raises(want):
            pack_layer(tar, PackOption(**{"compressor": "none", **kw}), device="cpu")

    def test_bad_tar_raises(self):
        with pytest.raises(ConvertError):
            pack_layer(b"not a tar", PackOption(compressor="none"), device="cpu")

    @pytest.mark.skipif(not native_pack.zstd_native.available(),
                        reason="the system libzstd is not bound")
    @pytest.mark.parametrize("backend", BACKENDS)
    def test_adaptive_codec_setting_refused(self, monkeypatch, backend):
        """Under NTPU_COMPRESS_ADAPTIVE=1 the reference packs zstd through its
        adaptive codec (converter/codec.resolve_codec), whose blob differs
        from its fixed-level one; the port has no such codec and refuses the
        setting instead of packing the fixed-level bytes. lz4_block is not
        the codec's: both pack as usual."""
        rng = np.random.default_rng(11)
        buf = io.BytesIO()
        with tarfile.open(fileobj=buf, mode="w") as tf:
            for i in range(6):
                data = (b"the quick brown fox jumps over the lazy dog %d " % i) * 3000 if i % 2 \
                    else rng.integers(0, 256, 100_000, dtype=np.uint8).tobytes()
                ti = tarfile.TarInfo(f"a/f{i}")
                ti.size = len(data)
                tf.addfile(ti, io.BytesIO(data))
        tar = buf.getvalue()
        opt = dict(compressor="zstd", **SMALL)
        monkeypatch.setenv("NTPU_COMPRESS_ADAPTIVE", "0")
        fixed_blob, _r = _pack_both(tar, backend, **opt)
        monkeypatch.setenv("NTPU_COMPRESS_ADAPTIVE", "1")
        adaptive_blob, _jr = j_pack_layer(tar, JPackOption(backend=backend, **opt))
        assert adaptive_blob != fixed_blob
        with pytest.raises(ConvertError, match="adaptive codec"):
            pack_layer(tar, PackOption(backend=backend, **opt), device="cpu")
        _pack_both(tar, backend, compressor="lz4_block", **SMALL)


def _file_like_pair(tar, backend, **kw) -> bool:
    """The port's and the reference's file-like ``Pack`` of ``tar`` (every
    member streamed in tar order, so a sparse member's chunks are not
    stored first as on the in-memory walk) write the same bytes, through
    the serial writer."""
    out, jout = io.BytesIO(), io.BytesIO()
    res = Pack(out, io.BytesIO(tar), PackOption(backend=backend, **kw), device="cpu")
    jres = j_Pack(jout, io.BytesIO(tar), JPackOption(backend=backend, **kw))
    return (res.route["writer"] == "serial" and out.getvalue() == jout.getvalue()
            and res.bootstrap == jres.bootstrap)


class TestSectionWriters:
    """The reference's writer choice (converter/stream.py:771-790): an
    in-memory tar with none/lz4_block/zstd and no batching, v5 alignment or
    encryption takes the deferred native section writer on every lane; the
    rest, and every file-like tar, the serial ``_SectionWriter``. The bytes
    are the reference's either way."""

    @pytest.mark.parametrize("backend", BACKENDS)
    @pytest.mark.parametrize("compressor", ["lz4_block", "zstd", "none"])
    def test_deferred_writer_on_every_lane(self, small_tar, backend, compressor):
        kw = dict(compressor=compressor, **SMALL)
        blob, res = _pack_both(small_tar, backend, **kw)
        route = res.route
        assert route["writer"] == "deferred" and route["native"] is True
        assert route["threads"] == native_pack._pack_threads()
        # every unique chunk of an in-memory tar is a zero-copy view into it
        n_unique = Bootstrap.from_bytes(res.bootstrap).blobs[0].chunk_count
        assert (route["src0"], route["src1"]) == (n_unique, 0)
        out = io.BytesIO()
        fres = Pack(out, io.BytesIO(small_tar), PackOption(backend=backend, **kw), device="cpu")
        assert fres.route == {"lane": "stream", "writer": "serial"}
        assert out.getvalue() == blob and fres.bootstrap == res.bootstrap

    @pytest.mark.parametrize(
        "kw",
        [
            pytest.param({"batch_size": 0x2000}, id="batch_size"),
            pytest.param({"aligned_chunk": True, "fs_version": layout.RAFS_V5}, id="aligned_v5"),
        ],
    )
    @pytest.mark.parametrize("backend", ["jax", "hybrid", "numpy"])
    def test_serial_writer_options(self, small_tar, backend, kw):
        _blob, res = _pack_both(small_tar, backend, compressor="zstd", **SMALL, **kw)
        assert res.route["writer"] == "serial"

    def test_aligned_chunk_on_v6_stays_deferred(self, small_tar):
        _blob, res = _pack_both(small_tar, "numpy", aligned_chunk=True, **SMALL)
        assert res.route["writer"] == "deferred"

    @pytest.mark.parametrize("backend", ["jax", "hybrid", "numpy"])
    def test_streamed_chunks_go_to_the_side_buffer(self, backend):
        """A sparse member streams during the walk: its chunks are bytes,
        copied into the side buffer (source 1); the in-memory files' chunks
        stay views into the tar (source 0)."""
        tar = _sparse_tar()
        blob, res = _pack_both(tar, backend, compressor="lz4_block", **SMALL)
        src0, src1 = res.route["src0"], res.route["src1"]
        assert src0 > 0 and src1 > 0
        assert src0 + src1 == Bootstrap.from_bytes(res.bootstrap).blobs[0].chunk_count
        assert _file_like_pair(tar, backend, compressor="lz4_block", **SMALL)

    @pytest.mark.parametrize("make_tar", [lambda: _layer_tar(seed=7, files=8), _sparse_tar],
                             ids=["plain", "sparse"])
    @pytest.mark.parametrize("compressor", ["lz4_block", "zstd"])
    def test_forced_replay(self, monkeypatch, make_tar, compressor):
        """Without a codec library the engine can dlopen, pack_section
        returns None and the extents replay through the Python codec: the
        same bytes."""
        monkeypatch.setattr(native_pack.native_cdc, "pack_section", lambda *a, **k: None)
        for backend in ("jax", "hybrid", "numpy"):
            _blob, res = _pack_both(make_tar(), backend, compressor=compressor, **SMALL)
            assert res.route["writer"] == "deferred" and res.route["native"] is False

    @pytest.mark.parametrize("backend", ["fused", "jax", "hybrid", "numpy"])
    def test_thread_count_does_not_change_bytes(self, monkeypatch, small_tar, backend):
        monkeypatch.setenv("NTPU_PACK_THREADS_FORCE", "1")
        got = {}
        for threads in ("1", "4"):
            monkeypatch.setenv("NTPU_PACK_THREADS", threads)
            blob, res = pack_layer(small_tar, PackOption(backend=backend, compressor="zstd", **SMALL),
                                   device="cpu")
            assert res.route["threads"] == int(threads)
            got[threads] = (blob, res.bootstrap, res.blob_id)
        assert got["1"] == got["4"]

    def test_pack_threads_as_the_reference_reads_them(self, monkeypatch):
        from nydus_snapshotter_tpu.converter import stream as jstream

        ncpu = os.cpu_count() or 1
        for threads, force, want in (
            (None, None, ncpu), ("1", None, 1), ("3", None, min(3, ncpu)),
            (str(ncpu + 5), None, ncpu), (str(ncpu + 5), "1", ncpu + 5), (str(ncpu + 5), "0", ncpu),
            ("0", None, ncpu), ("many", "1", ncpu),
        ):
            for var, value in (("NTPU_PACK_THREADS", threads), ("NTPU_PACK_THREADS_FORCE", force)):
                if value is None:
                    monkeypatch.delenv(var, raising=False)
                else:
                    monkeypatch.setenv(var, value)
            assert native_pack._pack_threads() == jstream._pack_threads() == want


class TestHybridLanes:
    """The hybrid backend's single-thread lanes (NTPU_PACK_THREADS=1) under
    the reference's guards (converter/stream.py:955-1045): the whole-layer
    ``pack_files`` lane with no chunk dict and the deferred writer, else the
    ``chunk_digest_multi`` lane; at more threads the serial per-file lane.
    Each packs the reference's bytes, the file-like Pack's and the fused
    lane's."""

    @pytest.mark.parametrize("digester", ["sha256", "blake3"])
    @pytest.mark.parametrize("compressor", ["lz4_block", "zstd", "none"])
    def test_pack_files_lane(self, monkeypatch, small_tar, compressor, digester):
        monkeypatch.setenv("NTPU_PACK_THREADS", "1")
        kw = dict(compressor=compressor, digester=digester, **SMALL)
        stats = {}
        blob, res = pack_layer(small_tar, PackOption(backend="hybrid", **kw), stats=stats)
        _assert_same((blob, res), j_pack_layer(small_tar, JPackOption(backend="hybrid", **kw)))
        assert res.route == {"lane": "pack_files", "writer": "deferred", "native": True,
                             "threads": 1, "src0": 0, "src1": 0}
        assert stats["fused_pack"] > 0
        out = io.BytesIO()
        Pack(out, io.BytesIO(small_tar), PackOption(backend="hybrid", **kw))
        assert out.getvalue() == blob
        if digester == "sha256":
            fblob, fres = pack_layer(small_tar, PackOption(backend="fused", **kw), device="cpu")
            assert fblob == blob and fres.bootstrap == res.bootstrap

    @pytest.mark.parametrize(
        "case", ["dict", "sparse", "batch_size"],
    )
    def test_chunk_digest_multi_lane(self, monkeypatch, tmp_path, small_tar, case):
        """A chunk dict, a sparse member streamed during the walk, or the
        serial writer each keep the whole-layer lane off."""
        monkeypatch.setenv("NTPU_PACK_THREADS", "1")
        kw = dict(compressor="lz4_block", digester="blake3", **SMALL)
        tar = small_tar
        if case == "dict":
            _dblob, dres = j_pack_layer(_third_tar(), JPackOption(backend="numpy", **kw))
            path = tmp_path / "dict.boot"
            path.write_bytes(dres.bootstrap)
            kw["chunk_dict_path"] = f"bootstrap={path}"
        elif case == "sparse":
            tar = _sparse_tar()
        else:
            kw["batch_size"] = 0x2000
        blob, res = _pack_both(tar, "hybrid", **kw)
        assert res.route["lane"] == "chunk_digest_multi"
        if case == "dict":
            assert res.referenced_blob_ids[1:] == [dres.blob_id]
        assert _file_like_pair(tar, "hybrid", **kw)

    def test_per_file_lane_digests_small_files_in_one_batch(self, monkeypatch, small_tar):
        """At several threads each file takes one chunk+digest call (on the
        pipeline's workers), and the files of at most the minimum chunk one
        batch digest."""
        import threading

        monkeypatch.setenv("NTPU_PACK_THREADS", "4")
        monkeypatch.setenv("NTPU_PACK_THREADS_FORCE", "1")
        calls = {"file": 0, "batch": 0}
        lock = threading.Lock()

        def count(key):
            with lock:  # the pipeline's workers call from several threads
                calls[key] += 1

        real_cd = native_pack.native_cdc.chunk_digest_native
        real_b = native_pack.host_digests_for
        monkeypatch.setattr(native_pack.native_cdc, "chunk_digest_native",
                            lambda *a, **k: count("file") or real_cd(*a, **k))
        monkeypatch.setattr(native_pack, "host_digests_for",
                            lambda d: lambda items: count("batch") or real_b(d)(items))
        blob, res = _pack_both(small_tar, "hybrid", compressor="lz4_block", **SMALL)
        assert res.route["lane"] == "pipeline" and res.route["threads"] == 4
        with tarfile.open(fileobj=io.BytesIO(small_tar)) as tf:
            sizes = [m.size for m in tf if m.isreg() and m.size]
        small = sum(1 for s in sizes if s <= SMALL["chunk_size"] // 4)
        assert calls == {"file": len(sizes) - small, "batch": 1 if small else 0}
