"""pack_layer of the PyTorch port against the JAX package's.

The layer tar of the reference's fused pack-lane test (file sizes 0 to
400 000 bytes and a symlink) is packed by both packages, for both of the
port's backends: the framed layer blob, the bootstrap and the blob id must
be byte-identical.
"""

import io
import tarfile

import numpy as np
import pytest

from nydus_snapshotter_tpu.converter.convert import pack_layer as j_pack_layer
from nydus_snapshotter_tpu.converter.stream import IncrementalChunker as JIncrementalChunker
from nydus_snapshotter_tpu.converter.types import PackOption as JPackOption
from nydus_snapshotter_tpu.models.bootstrap import Bootstrap as JBootstrap
from nydus_snapshotter_tpu.models.bootstrap import ChunkDict as JChunkDict
from nydus_snapshotter_tpu.ops import cdc as jcdc
from nydus_snapshotter_tpu.ops import fused_convert as jfc
from nydus_snapshotter_tpu_torch.converter import (
    ConvertError,
    IncrementalChunker,
    Pack,
    PackOption,
    pack_layer,
)
from nydus_snapshotter_tpu_torch.models import layout
from nydus_snapshotter_tpu_torch.models.bootstrap import Bootstrap, ChunkDict
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
            chunks.extend(ch.feed(data[off : off + seg]))
            jchunks.extend(c for c, _ in jch.feed(data[off : off + seg]))
        chunks.extend(ch.finish())
        jchunks.extend(c for c, _ in jch.finish())
        assert b"".join(chunks) == data and chunks == jchunks
        want = jcdc.chunk_data_np(np.frombuffer(data, np.uint8), jcdc.CDCParams(0x1000))
        assert np.array_equal(np.cumsum([len(c) for c in chunks]), want)

    def test_sparse_member_matches_reference(self):
        """A GNU sparse member goes through the same chunker, in the
        reference's order (during the walk, before the in-memory files)."""
        tar = _sparse_tar()
        opt = dict(chunk_size=0x1000, compressor="none")
        blob, res = pack_layer(tar, PackOption(backend="jax", **opt), device="cpu")
        jblob, jres = j_pack_layer(tar, JPackOption(backend="numpy", **opt))
        assert blob == jblob and res.bootstrap == jres.bootstrap


class TestPackOptions:
    @pytest.mark.parametrize(
        "kw",
        [
            {"compressor": "lz4_block"},
            {"compressor": "zstd"},
            {"backend": "hybrid"},
            {"digest_backend": "jax"},
            {"chunking": "fixed"},
            {"digester": "md5"},
            {"batch_size": 0x10000},
            {"encrypt": True},
            {"aligned_chunk": True},
            {"prefetch_patterns": "/d"},
            {"chunk_dict_path": "/nonexistent"},
            {"digest_backend": "host"},
        ],
    )
    def test_unsupported_options_raise(self, kw):
        with pytest.raises(ConvertError):
            pack_layer(_layer_tar(files=1), PackOption(**{"compressor": "none", **kw}), device="cpu")

    def test_bad_tar_raises(self):
        with pytest.raises(ConvertError):
            pack_layer(b"not a tar", PackOption(compressor="none"), device="cpu")
