"""Merge, Unpack and the real RAFS v5/v6 bootstraps of the PyTorch port
against the JAX package's.

Seeded layer tars (directories, regular files, symlinks, hardlinks,
whiteouts, an opaque directory, a binary xattr) are packed by both packages
on the host lanes (``hybrid``, ``numpy``; the port on ``device="cpu"``) and
merged, unpacked and emitted in the real layouts by both. The tolerance is
zero: every bootstrap, tar and blob-digest list must be byte-identical, and
every refusal of the reference must be the port's too.
"""

import gzip
import hashlib
import io
import tarfile

import numpy as np
import pytest

from nydus_snapshotter_tpu.converter import convert as jconv
from nydus_snapshotter_tpu.converter.types import ConvertError as JConvertError
from nydus_snapshotter_tpu.converter.types import MergeOption as JMergeOption
from nydus_snapshotter_tpu.converter.types import PackOption as JPackOption
from nydus_snapshotter_tpu.models import nydus_real as jreal
from nydus_snapshotter_tpu.models import nydus_real_write as jreal_write
from nydus_snapshotter_tpu.models.bootstrap import ChunkDict as JChunkDict
from nydus_snapshotter_tpu_torch import constants
from nydus_snapshotter_tpu_torch.converter import (
    ConvertError,
    Merge,
    MergeOption,
    PackOption,
    Unpack,
    UnpackOption,
    pack_layer,
)
from nydus_snapshotter_tpu_torch.converter import convert
from nydus_snapshotter_tpu_torch.models import nydus_real, nydus_real_write
from nydus_snapshotter_tpu_torch.models.bootstrap import (
    Bootstrap,
    BootstrapError,
    ChunkDict,
    ChunkRecord,
    CipherRecord,
)

CHUNK = 0x1000


def _rand(rng, n: int) -> bytes:
    return rng.integers(0, 256, n, dtype=np.uint8).tobytes()


def build_tar(files=(), dirs=(), symlinks=(), hardlinks=(), whiteouts=(), opaques=(),
              xattrs=None) -> bytes:
    """An OCI layer tar in memory (the reference suite's build_tar, with
    PAX xattrs: ``xattrs`` maps a file name to {name: bytes})."""
    xattrs = xattrs or {}
    out = io.BytesIO()
    with tarfile.open(fileobj=out, mode="w:", format=tarfile.PAX_FORMAT) as tf:
        for d in dirs:
            info = tarfile.TarInfo(d.strip("/") + "/")
            info.type = tarfile.DIRTYPE
            info.mode = 0o755
            tf.addfile(info)
        for name, data in files:
            info = tarfile.TarInfo(name.strip("/"))
            info.size = len(data)
            info.mode = 0o644
            info.mtime = 1_700_000_000
            for key, value in xattrs.get(name, {}).items():
                info.pax_headers["SCHILY.xattr." + key] = value.decode("utf-8", "surrogateescape")
            tf.addfile(info, io.BytesIO(data))
        for name, target in symlinks:
            info = tarfile.TarInfo(name.strip("/"))
            info.type = tarfile.SYMTYPE
            info.linkname = target
            tf.addfile(info)
        for name, target in hardlinks:
            info = tarfile.TarInfo(name.strip("/"))
            info.type = tarfile.LNKTYPE
            info.linkname = target.strip("/")
            tf.addfile(info)
        for name in whiteouts:
            parent, _, base = name.strip("/").rpartition("/")
            tf.addfile(tarfile.TarInfo((parent + "/" if parent else "") + ".wh." + base))
        for d in opaques:
            tf.addfile(tarfile.TarInfo(d.strip("/") + "/.wh..wh..opq"))
    return out.getvalue()


CAP = b"\x01\x00\x00\x02\xff\x00\xde\xad"


@pytest.fixture(scope="module")
def layers():
    """Three layer tars, lowest first: a base with links, an
    upper layer that overrides, whites out and makes a directory opaque,
    and a top layer that re-adds content already in the base."""
    rng = np.random.default_rng(0xC0DE)
    shared = _rand(rng, 60_000)
    base = build_tar(
        files=[
            ("dir-1/file-2", _rand(rng, 20_000)),
            ("dir-2/file-1", b"lower-file-1-content" * 500),
            ("dir-2/file-3", _rand(rng, 5_000)),
            ("dir-2/empty", b""),
            ("od/keep", b"low"),
            ("od/sub/deep", _rand(rng, 3_000)),
            ("bin/ping", b"ELF!" * 300),
            ("lib/shared.so", shared),
        ],
        dirs=["dir-1", "dir-2", "od", "od/sub", "bin", "lib"],
        symlinks=[("dir-2/link-1", "../dir-1/file-2")],
        hardlinks=[("dir-2/hard-1", "dir-2/file-1")],
    )
    upper = build_tar(
        files=[("dir-2/file-1", b"upper-overrides" * 300), ("dir-3/file-4", _rand(rng, 8_000)),
               ("od/newf", b"up")],
        dirs=["dir-2", "dir-3", "od"],
        whiteouts=["dir-2/file-3"],
        opaques=["od"],
    )
    top = build_tar(
        files=[("app/copy.so", shared), ("app/new", _rand(rng, 30_000))],
        dirs=["app"],
        symlinks=[("app/link", "/lib/shared.so")],
    )
    return [base, upper, top]


def _pack(tar, backend="hybrid", **kw):
    """Both packages' pack_layer -> (blob, result) once their outputs agree."""
    blob, res = pack_layer(tar, PackOption(backend=backend, **kw), device="cpu")
    jblob, jres = jconv.pack_layer(tar, JPackOption(backend=backend, **kw))
    assert blob == jblob and res.bootstrap == jres.bootstrap and res.blob_id == jres.blob_id
    return blob, res


@pytest.fixture(scope="module")
def xattr_layer():
    """A layer whose file carries a binary xattr and whose directory a
    text one: both packages' packs at fixed chunking."""
    tar = build_tar(files=[("bin/ping", b"ELF!" * 300), ("bin/sh", b"#!" * 40)], dirs=["bin"],
                    xattrs={"bin/ping": {"security.capability": CAP},
                            "bin/sh": {"user.origin": b"base"}})
    return _pack(tar, chunk_size=CHUNK, chunking="fixed")


@pytest.fixture(scope="module")
def packed(layers):
    """(blob, result) per layer, per chunking."""
    return {
        chunking: [_pack(t, chunk_size=CHUNK, chunking=chunking) for t in layers]
        for chunking in ("cdc", "fixed")
    }


def _merge_both(blobs, chunk_dict=None, jchunk_dict=None, **kw):
    got = Merge(blobs, MergeOption(**kw), chunk_dict=chunk_dict)
    want = jconv.Merge(blobs, JMergeOption(**kw), chunk_dict=jchunk_dict)
    assert got.bootstrap == want.bootstrap
    assert got.blob_digests == want.blob_digests
    return got


def _data_sections(packed_layers):
    return {r.blob_id: convert.blob_data_from_layer_blob(b) for b, r in packed_layers if r.blob_id}


def _tree(tar_bytes: bytes) -> dict:
    out = {}
    with tarfile.open(fileobj=io.BytesIO(tar_bytes), mode="r:") as tf:
        for info in tf:
            name = "/" + info.name.strip("/")
            if info.isreg():
                out[name] = ("reg", tf.extractfile(info).read(), info.mode)
            elif info.issym():
                out[name] = ("sym", info.linkname)
            elif info.islnk():
                out[name] = ("lnk", "/" + info.linkname.strip("/"))
            elif info.isdir():
                out[name] = ("dir",)
            else:
                out[name] = (info.type,)
    return out


FORMATS = ["native", "rafs-v5", "rafs-v6"]


def _chunking(fmt: str) -> str:
    # the reference's v6 writer takes chunks on the fixed grid only
    return "fixed" if fmt == "rafs-v6" else "cdc"


class TestMerge:
    @pytest.mark.parametrize("fmt", FORMATS)
    @pytest.mark.parametrize("n_layers", [1, 2, 3])
    def test_merge_bytes(self, packed, fmt, n_layers):
        blobs = [b for b, _r in packed[_chunking(fmt)][:n_layers]]
        _merge_both(blobs, bootstrap_format=fmt)

    @pytest.mark.parametrize("fmt", FORMATS)
    def test_merge_with_chunk_dict(self, packed, fmt, tmp_path):
        """The base layer's merged bootstrap is the dict; the top layer's
        re-added content re-points at its blob, by object and by path."""
        layers = packed[_chunking(fmt)]
        dict_boot = _merge_both([layers[0][0]]).bootstrap
        path = tmp_path / "dict.boot"
        path.write_bytes(dict_boot)
        blobs = [b for b, _r in layers[1:]]
        got = _merge_both(blobs, chunk_dict=ChunkDict(Bootstrap.from_bytes(dict_boot)),
                          jchunk_dict=JChunkDict.from_path(str(path)), bootstrap_format=fmt)
        assert layers[0][1].blob_id in got.blob_digests
        _merge_both(blobs, chunk_dict_path=f"bootstrap={path}", bootstrap_format=fmt)

    @pytest.mark.parametrize("fmt", FORMATS)
    @pytest.mark.parametrize("parent_fmt", FORMATS)
    def test_merge_with_parent_bootstrap(self, packed, fmt, parent_fmt, tmp_path):
        """The parent is the upper layer's image in each layout."""
        layers = packed["fixed" if "rafs-v6" in (fmt, parent_fmt) else "cdc"]
        parent = tmp_path / "parent.boot"
        parent.write_bytes(_merge_both([layers[1][0]], bootstrap_format=parent_fmt).bootstrap)
        _merge_both([layers[2][0]], parent_bootstrap_path=str(parent), bootstrap_format=fmt)

    @pytest.mark.parametrize("fmt", FORMATS)
    def test_merge_with_tar_and_prefetch(self, packed, fmt):
        blobs = [b for b, _r in packed[_chunking(fmt)]]
        got = _merge_both(blobs, bootstrap_format=fmt, with_tar=True,
                          prefetch_patterns="/app\n/bin/ping\n/missing\n")
        if fmt == "native":
            bs = convert.bootstrap_from_bootstrap_layer(got.bootstrap)
            want = jconv.bootstrap_from_bootstrap_layer(got.bootstrap)
            assert bs.to_bytes() == want.to_bytes()
            assert bs.prefetch == ["/app/copy.so", "/app/new", "/bin/ping"]

    @pytest.mark.parametrize("digester", ["sha256", "blake3"])
    def test_merge_real_v5_digester(self, packed, digester):
        _merge_both([b for b, _r in packed["cdc"]], bootstrap_format="rafs-v5", digester=digester)

    @pytest.mark.parametrize("fs_version", ["", "v5", "v6"])
    def test_merge_fs_version(self, layers, fs_version):
        blob, _r = _pack(layers[0], chunk_size=CHUNK, fs_version="v5")
        _merge_both([blob], fs_version=fs_version)

    def test_merge_takes_bootstraps_and_real_layers(self, packed):
        """Bare bootstraps in either layout stand in for framed layers."""
        blobs = [b for b, _r in packed["fixed"]]
        native = [convert.bootstrap_from_layer_blob(b).to_bytes() for b in blobs]
        _merge_both(native)
        real = [_merge_both([b], bootstrap_format="rafs-v6").bootstrap for b in blobs]
        _merge_both(real)
        _merge_both(real, bootstrap_format="rafs-v5")

    def test_merge_batched_compressed_layers(self, layers):
        packed = [_pack(t, chunk_size=CHUNK, compressor="zstd", batch_size=0x2000) for t in layers]
        _merge_both([b for b, _r in packed])


class TestMergeRefusals:
    """Each input the reference refuses, the port refuses with the same type."""

    def test_merge_real_v6_rejects_cdc(self, packed):
        blob = packed["cdc"][0][0]
        with pytest.raises(JConvertError, match="fixed|real-layout"):
            jconv.Merge([blob], JMergeOption(bootstrap_format="rafs-v6"))
        with pytest.raises(ConvertError, match="fixed|real-layout"):
            Merge([blob], MergeOption(bootstrap_format="rafs-v6"))

    def test_merge_empty_layers_rejected(self):
        with pytest.raises(JConvertError):
            jconv.Merge([], JMergeOption())
        with pytest.raises(ConvertError, match="at least one layer"):
            Merge([], MergeOption())

    def test_merge_unknown_format_rejected(self, packed):
        blob = packed["cdc"][0][0]
        with pytest.raises(JConvertError):
            jconv.Merge([blob], JMergeOption(bootstrap_format="erofs"))
        with pytest.raises(ConvertError, match="bootstrap_format"):
            Merge([blob], MergeOption(bootstrap_format="erofs"))

    @pytest.mark.parametrize("fmt", ["rafs-v5", "rafs-v6"])
    def test_merge_real_layout_rejects_batches(self, layers, fmt):
        blob, _r = _pack(layers[0], chunk_size=CHUNK, chunking="fixed", batch_size=0x2000)
        with pytest.raises(JConvertError, match="real-layout"):
            jconv.Merge([blob], JMergeOption(bootstrap_format=fmt))
        with pytest.raises(ConvertError, match="real-layout"):
            Merge([blob], MergeOption(bootstrap_format=fmt))

    def test_opaque_marker_without_parents_refused_by_both(self):
        """Shared with the reference: an opaque marker two levels below any
        other entry of its layer makes Pack raise BootstrapError (the opaque
        directory is added after the missing parents are synthesized); with
        the directory entries, as container engines write them, both pack
        the same bytes."""
        from nydus_snapshotter_tpu.models.bootstrap import BootstrapError as JBootstrapError

        bare = build_tar(files=[("x/f", b"abc")], opaques=["a/b"])
        with pytest.raises(JBootstrapError, match="missing parent"):
            jconv.pack_layer(bare, JPackOption(backend="hybrid", chunk_size=CHUNK))
        with pytest.raises(BootstrapError, match="missing parent"):
            pack_layer(bare, PackOption(backend="hybrid", chunk_size=CHUNK), device="cpu")
        _pack(build_tar(files=[("x/f", b"abc")], dirs=["a", "a/b"], opaques=["a/b"]),
              chunk_size=CHUNK)

    def test_merge_rejects_garbage_layer(self):
        with pytest.raises(JConvertError):
            jconv.Merge([b"\0" * 5000], JMergeOption())
        with pytest.raises(ConvertError, match="neither a framed blob"):
            Merge([b"\0" * 5000], MergeOption())


class TestUnpack:
    @pytest.mark.parametrize("fmt", FORMATS)
    def test_unpack_bytes(self, packed, fmt):
        layers = packed[_chunking(fmt)]
        merged = _merge_both([b for b, _r in layers], bootstrap_format=fmt)
        blobs = _data_sections(layers)
        got = Unpack(merged.bootstrap, blobs, UnpackOption())
        assert got == jconv.Unpack(merged.bootstrap, blobs)
        tree = _tree(got)
        assert tree["/dir-2/file-1"][1] == b"upper-overrides" * 300  # the upper layer wins
        assert "/dir-2/file-3" not in tree  # whiteout applied
        assert "/od/keep" not in tree and "/od/sub/deep" not in tree  # opaque directory
        assert tree["/od/newf"][1] == b"up"
        assert tree["/app/copy.so"][1] == tree["/lib/shared.so"][1]
        assert tree["/dir-2/link-1"] == ("sym", "../dir-1/file-2")
        assert tree["/dir-2/hard-1"][0] == "lnk"

    @pytest.mark.parametrize("fmt", ["native", "rafs-v5"])
    def test_unpack_binary_xattr(self, xattr_layer, fmt):
        merged = _merge_both([xattr_layer[0]], bootstrap_format=fmt)
        blobs = _data_sections([xattr_layer])
        out = Unpack(nydus_real.load_any_bootstrap(merged.bootstrap), blobs)
        assert out == jconv.Unpack(merged.bootstrap, blobs)
        with tarfile.open(fileobj=io.BytesIO(out), mode="r:") as tf:
            v = tf.getmember("bin/ping").pax_headers["SCHILY.xattr.security.capability"]
        assert v.encode("utf-8", "surrogateescape") == CAP

    @pytest.mark.parametrize(
        "codec", [dict(compressor="none"), dict(compressor="lz4_block"), dict(compressor="zstd"),
                  dict(compressor="zstd", batch_size=0x2000),
                  dict(compressor="lz4_block", batch_size=0x4000)],
        ids=["none", "lz4_block", "zstd", "zstd-batched", "lz4-batched"],
    )
    def test_unpack_compressed(self, layers, codec):
        packed = [_pack(t, chunk_size=CHUNK, **codec) for t in layers]
        merged = _merge_both([b for b, _r in packed])
        blobs = _data_sections(packed)
        assert Unpack(merged.bootstrap, blobs) == jconv.Unpack(merged.bootstrap, blobs)

    def test_unpack_through_chunk_dict(self, packed, tmp_path):
        """An image merged against a dict reads its shared chunks from the
        dict's blob: the provider is a function, as a registry fetch is."""
        layers = packed["cdc"]
        path = tmp_path / "dict.boot"
        path.write_bytes(_merge_both([layers[0][0]]).bootstrap)
        merged = _merge_both([b for b, _r in layers[1:]], chunk_dict_path=str(path))
        blobs = _data_sections(layers)
        got = Unpack(merged.bootstrap, lambda bid: blobs[bid])
        assert got == jconv.Unpack(merged.bootstrap, blobs)
        assert _tree(got)["/app/copy.so"][1] == _tree(Unpack(_merge_both(
            [layers[0][0]]).bootstrap, blobs))["/lib/shared.so"][1]

    def test_unpack_short_blob_refused(self, packed):
        layers = packed["cdc"]
        merged = _merge_both([layers[0][0]])
        blobs = {bid: data[:-10] for bid, data in _data_sections(layers[:1]).items()}
        with pytest.raises(JConvertError):
            jconv.Unpack(merged.bootstrap, blobs)
        with pytest.raises(ConvertError, match="short read"):
            Unpack(merged.bootstrap, blobs)


class TestRealBootstraps:
    @pytest.mark.parametrize("fmt", ["rafs-v5", "rafs-v6"])
    def test_load_any_bootstrap_of_reference_writer(self, packed, fmt):
        bs = jconv.bootstrap_from_layer_blob(packed[_chunking(fmt)][0][0])
        real = jreal_write.real_from_bootstrap(bs)
        data = jreal_write.write_real_v5(real) if fmt == "rafs-v5" else jreal_write.write_real_v6(real)
        assert nydus_real.load_any_bootstrap(data).to_bytes() == \
            jreal.load_any_bootstrap(data).to_bytes()
        parse = nydus_real.parse_real_v5 if fmt == "rafs-v5" else nydus_real.parse_real_v6
        got = parse(data)
        assert [(i.path, i.mode, i.size, [c.digest for c in i.chunks]) for i in got.inodes] == [
            (i.path, i.mode, i.size, [c.digest for c in i.chunks])
            for i in jreal.parse_real_bootstrap(data).inodes
        ]

    @pytest.mark.parametrize("fmt", ["rafs-v5", "rafs-v6"])
    @pytest.mark.parametrize("digester", ["sha256", "blake3"])
    def test_writers_equal(self, packed, fmt, digester):
        bs = convert.bootstrap_from_layer_blob(packed[_chunking(fmt)][0][0])
        jbs = jconv.bootstrap_from_layer_blob(packed[_chunking(fmt)][0][0])
        write = nydus_real_write.write_real_v5 if fmt == "rafs-v5" else nydus_real_write.write_real_v6
        jwrite = jreal_write.write_real_v5 if fmt == "rafs-v5" else jreal_write.write_real_v6
        assert write(nydus_real_write.real_from_bootstrap(bs, digester=digester)) == \
            jwrite(jreal_write.real_from_bootstrap(jbs, digester=digester))

    @pytest.mark.parametrize("fmt", ["rafs-v5", "rafs-v6"])
    def test_chunk_dict_from_real_path(self, packed, fmt, tmp_path):
        layers = packed[_chunking(fmt)]
        path = tmp_path / "real.boot"
        path.write_bytes(_merge_both([b for b, _r in layers], bootstrap_format=fmt).bootstrap)
        got, want = ChunkDict.from_path(str(path)), JChunkDict.from_path(str(path))
        assert got.bootstrap.to_bytes() == want.bootstrap.to_bytes()
        assert len(got) == len(want) and got.blob_ids() == want.blob_ids()
        assert np.array_equal(got.digests_u32(), want.digests_u32())

    def test_real_bootstrap_dict_dedups_a_pack(self, packed, tmp_path):
        """A real v6 dict file dedups a pack as the reference's does."""
        layers = packed["fixed"]
        path = tmp_path / "real.boot"
        path.write_bytes(_merge_both([layers[0][0]], bootstrap_format="rafs-v6").bootstrap)
        tar = build_tar(files=[("x/copy.so", _tree(Unpack(
            _merge_both([layers[0][0]]).bootstrap, _data_sections(layers)))["/lib/shared.so"][1])])
        _blob, res = _pack(tar, chunk_size=CHUNK, chunking="fixed", chunk_dict_path=f"bootstrap={path}")
        assert res.referenced_blob_ids == [layers[0][1].blob_id]

    def test_real_v6_xattr_file_reads_back_in_neither(self, xattr_layer):
        """Shared with the reference: its v6 writer and reader disagree on
        where a regular file's chunk indexes sit behind inline xattrs, so
        neither package reads back a v6 emit of a file with an xattr."""
        data = _merge_both([xattr_layer[0]], bootstrap_format="rafs-v6").bootstrap
        with pytest.raises(ValueError, match="not in chunk table"):
            jreal.load_any_bootstrap(data)
        with pytest.raises(BootstrapError, match="not in chunk table"):
            nydus_real.load_any_bootstrap(data)

    @pytest.mark.parametrize("data", [b"", b"\0" * 9000, b"RAFS" + b"\xff" * 9000],
                             ids=["empty", "zeros", "garbage"])
    def test_garbage_refused(self, data):
        with pytest.raises(ValueError):
            jreal.load_any_bootstrap(data)
        with pytest.raises(BootstrapError):
            nydus_real.load_any_bootstrap(data)


class TestFraming:
    def test_frame_bootstrap_only(self, packed):
        boot = _merge_both([packed["cdc"][0][0]]).bootstrap
        framed = convert.frame_bootstrap_only(boot)
        assert framed == jconv.frame_bootstrap_only(boot)
        assert convert.bootstrap_from_layer_blob(framed).to_bytes() == boot
        assert convert.blob_data_from_layer_blob(framed) == b""

    def test_layer_without_bootstrap_refused(self):
        from nydus_snapshotter_tpu_torch.models import nydus_tar, toc

        framed = nydus_tar.pack_entries([(toc.ENTRY_BLOB_DATA, b"abc")])
        with pytest.raises(JConvertError):
            jconv.bootstrap_from_layer_blob(framed)
        with pytest.raises(ConvertError, match="no bootstrap"):
            convert.bootstrap_from_layer_blob(framed)
        with pytest.raises(ConvertError, match="image.boot"):
            convert.bootstrap_from_bootstrap_layer(build_tar(files=[("x", b"y")]))


class TestBlobReader:
    def test_gzip_member_chunks(self):
        """estargz gzip members inflate and truncate as the reference's."""
        payload = _rand(np.random.default_rng(3), 3000)
        member = gzip.compress(payload + b"\0" * 512, mtime=0)
        for expect in (3000, 0):
            assert convert._decompress_chunk(member, constants.COMPRESSOR_GZIP, expect) == \
                jconv._decompress_chunk(member, constants.COMPRESSOR_GZIP, expect)
        with pytest.raises(ConvertError, match="inflated"):
            convert._decompress_chunk(member, constants.COMPRESSOR_GZIP, 10_000)
        with pytest.raises(ConvertError, match="corrupt gzip"):
            convert._decompress_chunk(b"not gzip", constants.COMPRESSOR_GZIP, 10)

    def _one_chunk_bootstrap(self, flags: int, cipher: bool = False) -> Bootstrap:
        from nydus_snapshotter_tpu_torch.models.bootstrap import BlobRecord

        data = b"abc" * 100
        rec = ChunkRecord(digest=hashlib.sha256(data).digest(), blob_index=0, flags=flags,
                          uncompressed_offset=0, compressed_offset=0, uncompressed_size=len(data),
                          compressed_size=len(data))
        return Bootstrap(chunks=[rec], blobs=[BlobRecord(blob_id="a" * 64, compressed_size=300,
                                                         uncompressed_size=300, chunk_count=1)],
                         ciphers=[CipherRecord(algo=1, key=b"k" * 32, iv=b"i" * 16)] if cipher else [],
                         inodes=[])

    def test_reader_plain_chunk(self):
        bs = self._one_chunk_bootstrap(constants.COMPRESSOR_NONE)
        assert convert.make_bytes_reader(bs, 0, b"abc" * 100).chunk_data(bs.chunks[0]) == b"abc" * 100

    @pytest.mark.parametrize("flag", [convert.CHUNK_FLAG_GZIP_STREAM, convert.CHUNK_FLAG_ZSTD_STREAM],
                             ids=["gzip-stream", "zstd-stream"])
    def test_stream_chunks_refused(self, flag):
        """Refused until the OCIRef readers were ported (same name): a
        stream chunk reads through the blob's gzip or zstd stream, the
        default sequential reader or a mounted one, as the reference's."""
        import gzip

        from nydus_snapshotter_tpu.converter import convert as jconvert
        from nydus_snapshotter_tpu.models.bootstrap import Bootstrap as JBootstrap
        from nydus_snapshotter_tpu_torch.utils import zstd as zstd_native

        plain = b"abc" * 100
        if flag == convert.CHUNK_FLAG_ZSTD_STREAM:
            if not zstd_native.frames_available():
                pytest.skip("the system libzstd's frame surface is not bound")
            blob = zstd_native.compress_block(plain, 3)
        else:
            blob = gzip.compress(plain, mtime=0)
        bs = self._one_chunk_bootstrap(flag)
        bs.blobs[0].compressed_size = len(blob)
        reader = convert.make_bytes_reader(bs, 0, blob)
        assert reader.chunk_data(bs.chunks[0]) == plain
        jbs = JBootstrap.from_bytes(bs.to_bytes())
        assert jconvert.make_bytes_reader(jbs, 0, blob).chunk_data(jbs.chunks[0]) == plain

        class Mounted:
            concurrent = True

            def read_range(self, off, size):
                return b"m" * size

        for mount in (reader.mount_gzip_stream, reader.mount_zstd_stream):
            mount(Mounted())
        assert reader.chunk_data(bs.chunks[0]) == b"m" * len(plain)

    def test_encrypted_blob_reads_back_as_reference(self):
        """An AES-256-CTR blob: both readers decrypt the raw range before
        decompressing, to the same bytes."""
        from nydus_snapshotter_tpu.models.bootstrap import Bootstrap as JBootstrap
        from nydus_snapshotter_tpu_torch.converter import crypto

        bs = self._one_chunk_bootstrap(constants.COMPRESSOR_NONE, cipher=True)
        blob = crypto.encrypt(b"abc" * 100, b"k" * 32, b"i" * 16)
        assert blob != b"abc" * 100
        got = convert.make_bytes_reader(bs, 0, blob).chunk_data(bs.chunks[0])
        jbs = JBootstrap.from_bytes(bs.to_bytes())
        assert got == b"abc" * 100 == jconv.make_bytes_reader(jbs, 0, blob).chunk_data(jbs.chunks[0])

    def test_trained_zstd_frame_decodes_with_its_dict(self):
        """An ``nZD1`` frame: without its dictionary both packages raise,
        naming the id; once each has registered the dictionary both decode
        a frame the port's codec made."""
        from nydus_snapshotter_tpu.converter import codec as jcodec
        from nydus_snapshotter_tpu_torch.converter import codec
        from nydus_snapshotter_tpu_torch.utils import zstd

        frame = codec.TRAINED_FRAME_MAGIC + b"\1\0\0\0" + b"\0" * 16
        with pytest.raises(JConvertError, match="id=1 "):
            jconv._decompress_chunk(frame, constants.COMPRESSOR_ZSTD, 10)
        with pytest.raises(ConvertError, match="id=1 "):
            convert._decompress_chunk(frame, constants.COMPRESSOR_ZSTD, 10)
        if not zstd.dict_support():
            return
        samples = [(b"word%d " % (i % 97)) * (40 + i % 13) for i in range(200)]
        td = codec.TrainedDict(zstd.train_dict(samples, 8 << 10), epoch=1)
        c = codec.AdaptiveCodec(codec.CodecConfig(adaptive=True), trained=td)
        data = b"word7 word11 " * 600
        payload, flag = c.encode(data)
        try:
            jcodec.register_trained_dict(jcodec.TrainedDict(td.bytes, epoch=1))
            assert convert._decompress_chunk(payload, flag, len(data)) == data
            assert jconv._decompress_chunk(payload, flag, len(data)) == data
        finally:
            codec.unregister_trained_dict(td.dict_id)
            jcodec.unregister_trained_dict(td.dict_id)
