"""The port's blob encryption against the JAX package's.

Mirrors the encrypt cases of tests/test_converter_parity.py (bytes are
encrypted, ``Merge`` carries the cipher, mixed encrypted and plain layers)
and the encrypt arms of its ``TestFullMatrix``, each case in both
packages. ``crypto.generate_context`` draws ``os.urandom``; where blobs
must be byte-identical both packages' ``generate_context`` are patched to
one seeded key: then blobs and bootstraps are equal on the ``numpy``,
``hybrid`` (1 and 8 threads), ``jax`` and ``fused`` lanes (device
``cpu``). Cross-reads: each package's ``BlobReader`` and ``Unpack`` read
the other's encrypted blob under its own random key. ``decrypt_range`` is
held at unaligned offsets.
"""

from __future__ import annotations

import importlib.util
import io
import itertools
import tarfile

import numpy as np
import pytest

from nydus_snapshotter_tpu.converter import Merge as JMerge
from nydus_snapshotter_tpu.converter import MergeOption as JMergeOption
from nydus_snapshotter_tpu.converter import convert as jconvert
from nydus_snapshotter_tpu.converter import crypto as jcrypto
from nydus_snapshotter_tpu.converter.types import ConvertError as JConvertError
from nydus_snapshotter_tpu.converter.types import PackOption as JPackOption
from nydus_snapshotter_tpu.models.bootstrap import Bootstrap as JBootstrap
from nydus_snapshotter_tpu_torch.converter import Merge, MergeOption, Pack, PackOption
from nydus_snapshotter_tpu_torch.converter import convert, crypto
from nydus_snapshotter_tpu_torch.converter.types import ConvertError
from nydus_snapshotter_tpu_torch.models import layout
from nydus_snapshotter_tpu_torch.models.bootstrap import Bootstrap, CipherRecord

pytestmark = pytest.mark.skipif(
    importlib.util.find_spec("cryptography") is None, reason="cryptography not installed"
)

KEY = np.random.default_rng(2026).integers(0, 256, 32, dtype=np.uint8).tobytes()
IV = np.random.default_rng(2027).integers(0, 256, 16, dtype=np.uint8).tobytes()


def _rand(n: int, seed: int) -> bytes:
    return np.random.default_rng(seed).integers(0, 256, n, dtype=np.uint8).tobytes()


def build_tar(files, dirs=()) -> bytes:
    out = io.BytesIO()
    with tarfile.open(fileobj=out, mode="w:") as tf:
        for d in dirs:
            info = tarfile.TarInfo(d.strip("/") + "/")
            info.type = tarfile.DIRTYPE
            info.mode = 0o755
            tf.addfile(info)
        for name, data in files:
            info = tarfile.TarInfo(name.strip("/"))
            info.size = len(data)
            info.mode = 0o644
            tf.addfile(info, io.BytesIO(data))
    return out.getvalue()


def tar_tree(tar_bytes: bytes) -> dict:
    out = {}
    with tarfile.open(fileobj=io.BytesIO(tar_bytes), mode="r:") as tf:
        for info in tf:
            name = "/" + info.name.strip("/")
            out[name] = tf.extractfile(info).read() if info.isreg() else info.type
    return out


def small_files_tar() -> bytes:
    """Many sub-4K files (batch candidates) plus one big file and a text file."""
    files = [(f"cfg/file-{i}", _rand(200 + 37 * i, i)) for i in range(12)]
    files.append(("data/big", _rand(120_000, 99)))
    files.append(("data/text", b"SECRET-MARKER-0123456789" * 2000))
    return build_tar(files, dirs=["cfg", "data"])


@pytest.fixture
def fixed_context(monkeypatch):
    """One seeded (key, iv) for every blob either package encrypts."""
    for mod in (crypto, jcrypto):
        monkeypatch.setattr(mod, "generate_context", lambda: (KEY, IV))


def _threads(monkeypatch, n):
    monkeypatch.setenv("NTPU_PACK_THREADS", str(n))
    monkeypatch.setenv("NTPU_PACK_THREADS_FORCE", "1")


def pack_both(tar, **kw):
    """Port (device cpu) and reference pack_layer -> the port's (blob, res)
    after checking blob, blob id and bootstrap are equal."""
    got = convert.pack_layer(tar, PackOption(**kw), device="cpu")
    want = jconvert.pack_layer(tar, JPackOption(**kw))
    assert got[1].blob_id == want[1].blob_id
    assert got[1].bootstrap == want[1].bootstrap
    assert got[0] == want[0]
    return got


def roundtrip(blob: bytes, res, mod=convert) -> dict:
    bs = (Bootstrap if mod is convert else JBootstrap).from_bytes(res.bootstrap)
    return tar_tree(mod.Unpack(bs, {res.blob_id: mod.blob_data_from_layer_blob(blob)}))


class TestEncryption:
    def test_blob_bytes_are_encrypted(self, fixed_context):
        payload = b"SECRET-MARKER-0123456789" * 400
        src = build_tar([("s/secret", payload)], dirs=["s"])
        blob, res = pack_both(src, encrypt=True, compressor="none", backend="numpy")
        assert roundtrip(blob, res) == tar_tree(src)
        bs = Bootstrap.from_bytes(res.bootstrap)
        assert bs.ciphers and bs.ciphers[0].algo == crypto.CIPHER_AES_256_CTR
        assert (bs.ciphers[0].key, bs.ciphers[0].iv) == (KEY, IV)
        data = convert.blob_data_from_layer_blob(blob)
        assert b"SECRET-MARKER" not in data
        assert crypto.encrypt(data, KEY, IV) == jcrypto.encrypt(data, KEY, IV)
        bs2 = Bootstrap.from_bytes(bs.to_bytes())
        assert (bs2.ciphers[0].key, bs2.ciphers[0].iv) == (KEY, IV)

    def test_random_contexts_differ_per_blob(self):
        src = build_tar([("s/f", _rand(20_000, 1))], dirs=["s"])
        a, ra = convert.pack_layer(src, PackOption(encrypt=True, backend="numpy"), device="cpu")
        b, rb = convert.pack_layer(src, PackOption(encrypt=True, backend="numpy"), device="cpu")
        assert ra.blob_id != rb.blob_id
        assert roundtrip(a, ra) == roundtrip(b, rb) == tar_tree(src)

    def test_merge_carries_cipher(self, fixed_context):
        lower = build_tar([("a/f1", _rand(9_000, 2))], dirs=["a"])
        upper = build_tar([("b/f2", _rand(7_000, 3))], dirs=["b"])
        blob_l, res_l = pack_both(lower, encrypt=True, backend="numpy")
        blob_u, res_u = pack_both(upper, encrypt=True, backend="numpy")
        merged = Merge([blob_l, blob_u], MergeOption())
        assert merged.bootstrap == JMerge([blob_l, blob_u], JMergeOption()).bootstrap
        bs = Bootstrap.from_bytes(merged.bootstrap)
        assert len(bs.ciphers) == len(bs.blobs) and all(c.algo != 0 for c in bs.ciphers)
        out = convert.Unpack(bs, {res_l.blob_id: convert.blob_data_from_layer_blob(blob_l),
                                  res_u.blob_id: convert.blob_data_from_layer_blob(blob_u)})
        tree = tar_tree(out)
        assert tree["/a/f1"] == tar_tree(lower)["/a/f1"] and tree["/b/f2"] == tar_tree(upper)["/b/f2"]

    def test_mixed_encrypted_and_plain_layers(self, fixed_context):
        lower = build_tar([("a/f1", _rand(9_000, 4))], dirs=["a"])
        upper = build_tar([("b/f2", _rand(7_000, 5))], dirs=["b"])
        blob_l, res_l = pack_both(lower, encrypt=True, backend="numpy")
        blob_u, res_u = pack_both(upper, encrypt=False, backend="numpy")
        merged = Merge([blob_l, blob_u], MergeOption())
        assert merged.bootstrap == JMerge([blob_l, blob_u], JMergeOption()).bootstrap
        bs = Bootstrap.from_bytes(merged.bootstrap)
        algos = {b.blob_id: c.algo for b, c in zip(bs.blobs, bs.ciphers)}
        assert algos[res_l.blob_id] != 0 and algos[res_u.blob_id] == 0
        out = convert.Unpack(bs, {res_l.blob_id: convert.blob_data_from_layer_blob(blob_l),
                                  res_u.blob_id: convert.blob_data_from_layer_blob(blob_u)})
        assert tar_tree(out)["/a/f1"] == tar_tree(lower)["/a/f1"]

    def test_missing_cryptography_raises_crypto_error(self, monkeypatch):
        """Without the ``cryptography`` package both packages raise the
        reference's CryptoError before writing a byte."""
        src = build_tar([("s/f", _rand(5_000, 6))], dirs=["s"])
        for mod, pack, popt in ((crypto, Pack, PackOption), (jcrypto, jconvert.Pack, JPackOption)):
            monkeypatch.setattr(mod, "_HAVE_CRYPTOGRAPHY", False)
            out = io.BytesIO()
            kw = {"device": "cpu"} if mod is crypto else {}
            with pytest.raises(mod.CryptoError, match="cryptography"):
                pack(out, src, popt(encrypt=True, backend="numpy"), **kw)
            assert out.getvalue() == b""


class TestLanes:
    @pytest.mark.parametrize(
        "backend,threads",
        [("numpy", 1), ("numpy", 8), ("hybrid", 1), ("hybrid", 8), ("jax", 1), ("fused", 1)],
    )
    @pytest.mark.parametrize("compressor", ["zstd", "lz4_block", "none"])
    def test_encrypted_lanes_match_reference(self, monkeypatch, fixed_context, backend, threads, compressor):
        _threads(monkeypatch, threads)
        src = small_files_tar()
        blob, res = pack_both(src, encrypt=True, compressor=compressor, backend=backend, chunk_size=0x1000)
        assert res.route["writer"] == "serial"
        assert roundtrip(blob, res) == tar_tree(src)

    def test_encrypted_adaptive_pack_matches_reference(self, monkeypatch, fixed_context):
        from nydus_snapshotter_tpu_torch.utils import zstd

        if not zstd.available():
            pytest.skip("system libzstd not available")
        monkeypatch.setenv("NTPU_COMPRESS_ADAPTIVE", "1")
        src = small_files_tar()
        blob, res = pack_both(src, encrypt=True, compressor="zstd", backend="numpy", chunk_size=0x4000)
        assert roundtrip(blob, res) == tar_tree(src)

    def test_decrypted_section_equals_plain_pack(self, fixed_context):
        """CTR preserves length and the serial and deferred writers give the
        same bytes: the encrypted section, decrypted, is the plain pack's."""
        src = small_files_tar()
        enc, _ = pack_both(src, encrypt=True, compressor="zstd", backend="numpy")
        plain, pres = pack_both(src, compressor="zstd", backend="numpy")
        assert pres.route["writer"] == "deferred"
        sec = convert.blob_data_from_layer_blob(enc)
        assert crypto.decrypt_range(sec, 0, KEY, IV) == convert.blob_data_from_layer_blob(plain)


class TestFullMatrix:
    @pytest.mark.parametrize("fs_version", [layout.RAFS_V5, layout.RAFS_V6])
    def test_matrix_roundtrip(self, fixed_context, fs_version):
        src = small_files_tar()
        want = tar_tree(src)
        for comp, batch in itertools.product(["none", "zstd", "lz4_block"], [0, 0x1000]):
            kw = dict(fs_version=fs_version, compressor=comp, batch_size=batch, encrypt=True,
                      backend="numpy")
            if fs_version == layout.RAFS_V6:
                kw["chunking"] = "fixed"
            blob, res = pack_both(src, **kw)
            assert roundtrip(blob, res) == want, (fs_version, comp, batch)

    def test_matrix_with_chunk_dict(self, fixed_context, tmp_path):
        shared = _rand(30_000, 7)
        dict_src = build_tar([("d/shared", shared)], dirs=["d"])
        dict_blob, dict_res = pack_both(dict_src, backend="numpy")
        path = tmp_path / "dict.boot"
        path.write_bytes(dict_res.bootstrap)
        src = build_tar([("x/shared", shared), ("x/own", _rand(10_000, 8))]
                        + [(f"x/tiny-{i}", _rand(300, 9 + i)) for i in range(8)], dirs=["x"])
        for batch in (0, 0x1000):
            blob, res = pack_both(src, chunk_dict_path=str(path), compressor="zstd", batch_size=batch,
                                  encrypt=True, backend="numpy")
            assert dict_res.blob_id in res.referenced_blob_ids
            out = convert.Unpack(res.bootstrap, {res.blob_id: convert.blob_data_from_layer_blob(blob),
                                                 dict_res.blob_id: convert.blob_data_from_layer_blob(dict_blob)})
            assert tar_tree(out)["/x/shared"] == shared


class TestCrossRead:
    @pytest.mark.parametrize("packer", ["reference", "port"])
    def test_reader_and_unpack_read_the_other_package(self, packer):
        """Random keys: each package reads what the other encrypted, chunk by
        chunk through BlobReader and whole through Unpack."""
        src = small_files_tar()
        if packer == "reference":
            blob, res = jconvert.pack_layer(src, JPackOption(encrypt=True, compressor="zstd",
                                                             backend="numpy", batch_size=0x1000))
            reader_mod = convert
        else:
            blob, res = convert.pack_layer(src, PackOption(encrypt=True, compressor="zstd",
                                                           backend="numpy", batch_size=0x1000), device="cpu")
            reader_mod = jconvert
        assert roundtrip(blob, res, reader_mod) == tar_tree(src)
        bs = (Bootstrap if reader_mod is convert else JBootstrap).from_bytes(res.bootstrap)
        data = reader_mod.blob_data_from_layer_blob(blob)
        reader = reader_mod.make_bytes_reader(bs, 0, data)
        files = {("/" + i.path.strip("/")): i for i in bs.inodes}
        tree = tar_tree(src)
        for path, inode in files.items():
            if inode.chunk_count:
                got = b"".join(reader.chunk_data(bs.chunks[k])
                               for k in range(inode.chunk_index, inode.chunk_index + inode.chunk_count))
                assert got == tree[path]

    def test_unknown_cipher_algo_refused(self):
        src = build_tar([("s/f", _rand(5_000, 10))], dirs=["s"])
        blob, res = convert.pack_layer(src, PackOption(encrypt=True, backend="numpy"), device="cpu")
        bs = Bootstrap.from_bytes(res.bootstrap)
        bs.ciphers[0] = CipherRecord(algo=2, key=bs.ciphers[0].key, iv=bs.ciphers[0].iv)
        jbs = JBootstrap.from_bytes(bs.to_bytes())
        with pytest.raises(ConvertError, match="unsupported blob cipher algo 2"):
            convert.make_bytes_reader(bs, 0, b"")
        with pytest.raises(JConvertError, match="unsupported blob cipher algo 2"):
            jconvert.make_bytes_reader(jbs, 0, b"")


class TestDecryptRange:
    @pytest.mark.parametrize("offset", [0, 1, 7, 15, 16, 17, 31, 4095, 4097, 65_521])
    @pytest.mark.parametrize("size", [1, 15, 16, 33, 1000])
    def test_unaligned_ranges(self, offset, size):
        plain = _rand(70_000, 11)
        enc = crypto.encrypt(plain, KEY, IV)
        assert enc == jcrypto.encrypt(plain, KEY, IV)
        part = enc[offset : offset + size]
        got = crypto.decrypt_range(part, offset, KEY, IV)
        assert got == plain[offset : offset + size] == jcrypto.decrypt_range(part, offset, KEY, IV)

    def test_stream_encryptor_equals_whole(self):
        plain = _rand(10_000, 12)
        enc = crypto.stream_encryptor(KEY, IV)
        pieces = [enc.update(plain[i : i + 777]) for i in range(0, len(plain), 777)] + [enc.finalize()]
        assert b"".join(pieces) == crypto.encrypt(plain, KEY, IV)

    def test_counter_wraps_like_reference(self):
        iv = b"\xff" * 16
        plain = _rand(100, 13)
        enc = crypto.encrypt(plain, KEY, iv)
        assert enc == jcrypto.encrypt(plain, KEY, iv)
        assert crypto.decrypt_range(enc[40:], 40, KEY, iv) == plain[40:]

    def test_bad_key_length_refused(self):
        for mod in (crypto, jcrypto):
            with pytest.raises(mod.CryptoError, match="32-byte key"):
                mod.encrypt(b"x", b"short", IV)
