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
from nydus_snapshotter_tpu.converter.types import PackOption as JPackOption
from nydus_snapshotter_tpu.models.bootstrap import Bootstrap as JBootstrap
from nydus_snapshotter_tpu.models.bootstrap import ChunkDict as JChunkDict
from nydus_snapshotter_tpu_torch.converter import ConvertError, PackOption, pack_layer
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
        [("fused", layout.RAFS_V6), ("numpy", layout.RAFS_V6), ("numpy", layout.RAFS_V5)],
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

    def test_candidate_overflow_raises(self, tar, monkeypatch):
        """An input the device path cannot take is refused, never finished
        on the host under the fused backend's name."""
        monkeypatch.setattr(fused_convert, "_wcap_for", lambda n, bits, floor=1024: 2)
        with pytest.raises(ConvertError):
            pack_layer(tar, PackOption(chunk_size=0x10000, backend="fused", compressor="none"), device="cpu")

    def test_file_beyond_int32_addressing_raises(self, tar, monkeypatch):
        monkeypatch.setattr(fused_convert, "MAX_BATCH_PAD", fused_convert.WINDOW)
        with pytest.raises(ConvertError):
            pack_layer(tar, PackOption(chunk_size=0x10000, backend="fused", compressor="none"), device="cpu")


class TestPackOptions:
    @pytest.mark.parametrize(
        "kw",
        [
            {"compressor": "lz4_block"},
            {"compressor": "zstd"},
            {"backend": "hybrid"},
            {"backend": "jax"},
            {"chunking": "fixed"},
            {"digester": "blake3"},
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
