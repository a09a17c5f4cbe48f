"""The port's OCIRef conversion (converter/zran.py, converter/zstd_ref.py)
against the JAX package's.

The reference suite's cases (tests/test_zran.py, all but the one that
needs ``prefetch/``) run in both packages (``pkg``): random access into a
gzip stream and its checkpoints, the ref-layer bootstrap, lazy reads
through ``BlobReader``, ``Unpack``, refusals, the hooks' ``oci_ref`` arm,
multi-member gzip, duplicate paths, prefetch patterns, whiteouts and the
opaque marker, sparse members, ``encrypt``, and a ``Merge`` that mixes an
OCIRef layer with a packed one. Then parity: on the same gzip and zstd
bytes the two packages' bootstraps, lazy reads and ``Unpack`` output are
byte-identical, and the port's device engine (``digest_many``: kernel K2,
or K4 under BLAKE3, here their plain versions on the CPU) gives the host
path's bootstrap.
"""

import gzip
import hashlib
import io
import tarfile
from types import SimpleNamespace

import numpy as np
import pytest

from nydus_snapshotter_tpu import constants as JC
from nydus_snapshotter_tpu.converter import convert as jconvert
from nydus_snapshotter_tpu.converter import hooks as jhooks
from nydus_snapshotter_tpu.converter import zran as jzran
from nydus_snapshotter_tpu.converter import zstd_ref as jzstd_ref
from nydus_snapshotter_tpu.converter.content import LocalContentStore as JContentStore
from nydus_snapshotter_tpu.converter.types import ConvertError as JConvertError
from nydus_snapshotter_tpu.converter.types import MergeOption as JMergeOption
from nydus_snapshotter_tpu.converter.types import PackOption as JPackOption
from nydus_snapshotter_tpu.models import fstree as jfstree
from nydus_snapshotter_tpu.models.bootstrap import Bootstrap as JBootstrap
from nydus_snapshotter_tpu.remote.registry import Descriptor as JDescriptor
from nydus_snapshotter_tpu_torch import constants as TC
from nydus_snapshotter_tpu_torch.converter import convert as tconvert
from nydus_snapshotter_tpu_torch.converter import hooks as thooks
from nydus_snapshotter_tpu_torch.converter import zran as tzran
from nydus_snapshotter_tpu_torch.converter import zstd_ref as tzstd_ref
from nydus_snapshotter_tpu_torch.converter.content import LocalContentStore as TContentStore
from nydus_snapshotter_tpu_torch.converter.types import ConvertError as TConvertError
from nydus_snapshotter_tpu_torch.converter.types import MergeOption as TMergeOption
from nydus_snapshotter_tpu_torch.converter.types import PackOption as TPackOption
from nydus_snapshotter_tpu_torch.models import fstree as tfstree
from nydus_snapshotter_tpu_torch.models import layout
from nydus_snapshotter_tpu_torch.models.bootstrap import Bootstrap as TBootstrap
from nydus_snapshotter_tpu_torch.ops.chunker import ChunkDigestEngine
from nydus_snapshotter_tpu_torch.remote.registry import Descriptor as TDescriptor
from nydus_snapshotter_tpu_torch.utils import zstd as tzstd

PKG = {
    "port": SimpleNamespace(
        zran=tzran, zstd_ref=tzstd_ref, convert=tconvert, C=TC, fstree=tfstree,
        hooks=SimpleNamespace(
            layer_convert_func=lambda opt: thooks.layer_convert_func(opt, device="cpu")),
        Bootstrap=TBootstrap, PackOption=TPackOption, MergeOption=TMergeOption,
        ConvertError=TConvertError, ContentStore=TContentStore, Descriptor=TDescriptor,
        pack_layer=lambda tar, opt: tconvert.pack_layer(tar, opt, device="cpu"),
    ),
    "ref": SimpleNamespace(
        zran=jzran, zstd_ref=jzstd_ref, convert=jconvert, hooks=jhooks, C=JC, fstree=jfstree,
        Bootstrap=JBootstrap, PackOption=JPackOption, MergeOption=JMergeOption,
        ConvertError=JConvertError, ContentStore=JContentStore, Descriptor=JDescriptor,
        pack_layer=jconvert.pack_layer,
    ),
}
BOTH = pytest.mark.parametrize("pkg", ["port", "ref"])
needs_frames = pytest.mark.skipif(not tzstd.frames_available(),
                                  reason="the system libzstd's frame surface is not bound")

RNG = np.random.default_rng(0x02A4)
FILES = {
    "app/big.bin": RNG.integers(0, 256, 2_500_000, dtype=np.uint8).tobytes(),
    "app/small.txt": b"ref layer\n",
    "etc/conf": b"a=b\n",
}
PLAIN_3M = RNG.integers(0, 256, 3_000_000, dtype=np.uint8).tobytes()
MEMBER_A = RNG.integers(0, 256, 120_000, dtype=np.uint8).tobytes()
MEMBER_B = RNG.integers(0, 256, 130_000, dtype=np.uint8).tobytes()


def mk_tar(entries) -> bytes:
    """GNU tar of (name, data) pairs; duplicates and markers kept."""
    buf = io.BytesIO()
    with tarfile.open(fileobj=buf, mode="w", format=tarfile.GNU_FORMAT) as tf:
        for name, data in entries:
            ti = tarfile.TarInfo(name)
            ti.size = len(data)
            tf.addfile(ti, io.BytesIO(data))
    return buf.getvalue()


def mk_targz(files: dict) -> tuple[bytes, bytes]:
    tar = mk_tar(files.items())
    return gzip.compress(tar, mtime=0), tar


def file_bytes(reader, bs, path: str) -> bytes:
    ino = bs.inode_by_path()[path]
    return b"".join(
        reader.chunk_data(c) for c in bs.chunks[ino.chunk_index : ino.chunk_index + ino.chunk_count]
    )


def _ref_opt(pkg, **kw):
    return PKG[pkg].PackOption(oci_ref=True, **kw)


class TestGzipStreamReader:
    @BOTH
    def test_random_access_matches_plain_decompress(self, pkg):
        comp = gzip.compress(PLAIN_3M, mtime=0)
        r = PKG[pkg].zran.GzipStreamReader(lambda o, s: comp[o : o + s], len(comp))
        for off, size in [(len(PLAIN_3M) - 500, 500), (0, 1000), (1_500_000, 10_000),
                          (2_999_000, 1000), (100, 64)]:
            assert r.read_range(off, size) == PLAIN_3M[off : off + size], (off, size)

    @BOTH
    def test_checkpoints_make_rereads_cheap(self, pkg):
        plain = np.random.default_rng(9).integers(0, 256, 20_000_000, dtype=np.uint8).tobytes()
        comp = gzip.compress(plain, compresslevel=1, mtime=0)
        calls = []

        def read_at(o, s):
            calls.append((o, s))
            return comp[o : o + s]

        r = PKG[pkg].zran.GzipStreamReader(read_at, len(comp))
        r.read_range(19_000_000, 1000)
        first_scan = len(calls)
        calls.clear()
        r.read_range(18_900_000, 1000)
        assert len(calls) < first_scan / 4, (len(calls), first_scan)

    @BOTH
    def test_out_of_range_raises(self, pkg):
        comp = gzip.compress(b"short")
        r = PKG[pkg].zran.GzipStreamReader(lambda o, s: comp[o : o + s], len(comp))
        with pytest.raises(PKG[pkg].ConvertError):
            r.read_range(3, 100)


class TestPackGzipLayer:
    @BOTH
    def test_bootstrap_references_original_blob(self, pkg):
        p = PKG[pkg]
        raw, tar = mk_targz(FILES)
        bs = p.zran.pack_gzip_layer(raw, _ref_opt(pkg, chunk_size=0x100000))
        assert len(bs.blobs) == 1
        assert bs.blobs[0].blob_id == hashlib.sha256(raw).hexdigest()
        assert (bs.blobs[0].compressed_size, bs.blobs[0].uncompressed_size) == (len(raw), len(tar))
        bs2 = p.Bootstrap.from_bytes(bs.to_bytes())
        assert {i.path for i in bs2.inodes} >= {"/app/big.bin", "/etc/conf"}

    @BOTH
    def test_lazy_reads_through_blob_reader(self, pkg):
        p = PKG[pkg]
        raw, _ = mk_targz(FILES)
        bs = p.zran.pack_gzip_layer(raw, _ref_opt(pkg, chunk_size=0x100000))
        reader = p.convert.BlobReader(bs, 0, lambda o, s: raw[o : o + s])
        for name, want in FILES.items():
            assert file_bytes(reader, bs, "/" + name) == want, name

    @BOTH
    def test_unpack_rebuilds_the_tar_content(self, pkg):
        p = PKG[pkg]
        raw, _ = mk_targz(FILES)
        bs = p.zran.pack_gzip_layer(raw, _ref_opt(pkg, chunk_size=0x100000))
        out = p.convert.Unpack(bs, {bs.blobs[0].blob_id: raw})
        with tarfile.open(fileobj=io.BytesIO(out)) as tf:
            for name, want in FILES.items():
                assert tf.extractfile(name).read() == want, name

    @BOTH
    def test_not_gzip_rejected(self, pkg):
        with pytest.raises(PKG[pkg].ConvertError):
            PKG[pkg].zran.pack_gzip_layer(b"plain tar, not gzip", PKG[pkg].PackOption(chunk_size=0x1000))

    @BOTH
    def test_chunk_digests_cover_decompressed_content(self, pkg):
        raw, _ = mk_targz(FILES)
        bs = PKG[pkg].zran.pack_gzip_layer(raw, _ref_opt(pkg, chunk_size=0x100000))
        rec = bs.chunks[bs.inode_by_path()["/app/small.txt"].chunk_index]
        assert rec.digest == hashlib.sha256(b"ref layer\n").digest()


class TestHooksOciRef:
    @BOTH
    def test_layer_convert_keeps_original_and_emits_ref_layer(self, tmp_path, pkg):
        p = PKG[pkg]
        raw, _ = mk_targz(FILES)
        cs = p.ContentStore(str(tmp_path))
        digest = "sha256:" + hashlib.sha256(raw).hexdigest()
        cs.write_blob(raw, expected_digest=digest)
        desc = p.Descriptor(media_type="application/vnd.oci.image.layer.v1.tar+gzip",
                            digest=digest, size=len(raw))
        new_desc = p.hooks.layer_convert_func(_ref_opt(pkg, chunk_size=0x100000))(cs, desc)
        assert new_desc is not None
        assert new_desc.annotations[p.C.NYDUS_REF_LAYER] == digest
        stream = cs.read(new_desc.digest)
        bs = p.convert.bootstrap_from_layer_blob(stream)
        assert bs.blobs[0].blob_id == digest.split(":")[1]
        assert len(stream) < len(raw) / 2


class TestMultiMemberAndDuplicates:
    @BOTH
    def test_multi_member_gzip_reads_past_first_member(self, pkg):
        comp = gzip.compress(MEMBER_A, mtime=0) + gzip.compress(MEMBER_B, mtime=0)
        plain = MEMBER_A + MEMBER_B
        r = PKG[pkg].zran.GzipStreamReader(lambda o, s: comp[o : o + s], len(comp))
        for off, size in [(len(MEMBER_A) - 50, 100), (len(MEMBER_A) + 1000, 5000),
                          (len(plain) - 10, 10), (0, 64)]:
            assert r.read_range(off, size) == plain[off : off + size], (off, size)

    @BOTH
    def test_multi_member_layer_packs_and_reads(self, pkg):
        p = PKG[pkg]
        comp, data = _multi_member_layer()
        bs = p.zran.pack_gzip_layer(comp, _ref_opt(pkg, chunk_size=0x10000))
        reader = p.convert.BlobReader(bs, 0, lambda o, s: comp[o : o + s])
        for name, want in data.items():
            assert file_bytes(reader, bs, name) == want, name

    @BOTH
    def test_duplicate_tar_path_last_wins(self, pkg):
        p = PKG[pkg]
        raw = gzip.compress(mk_tar([("a/f", b"OLDOLDOLD"), ("a/f", b"NEW")]), mtime=0)
        bs = p.zran.pack_gzip_layer(raw, _ref_opt(pkg, chunk_size=0x1000))
        assert bs.inode_by_path()["/a/f"].size == 3
        reader = p.convert.BlobReader(bs, 0, lambda o, s: raw[o : o + s])
        assert file_bytes(reader, bs, "/a/f") == b"NEW"

    @BOTH
    def test_zran_carries_prefetch_patterns(self, pkg):
        raw, _ = mk_targz(FILES)
        bs = PKG[pkg].zran.pack_gzip_layer(
            raw, _ref_opt(pkg, chunk_size=0x100000, prefetch_patterns="app\n"))
        assert bs.prefetch == ["/app/big.bin", "/app/small.txt"]


class TestZranOverlaySemantics:
    @BOTH
    def test_whiteouts_and_opaque_normalized(self, pkg):
        p = PKG[pkg]
        raw = gzip.compress(_overlay_tar(), mtime=0)
        bs = p.zran.pack_gzip_layer(raw, _ref_opt(pkg, chunk_size=0x1000))
        by_path = bs.inode_by_path()
        assert "/app/.wh.deleted" not in by_path
        assert "/app/.wh..wh..opq" not in by_path
        assert by_path["/app/deleted"].flags & p.fstree.INODE_FLAG_WHITEOUT
        assert by_path["/app"].flags & p.fstree.INODE_FLAG_OPAQUE

    @BOTH
    def test_sparse_member_rejected(self, pkg):
        with pytest.raises(PKG[pkg].ConvertError):
            PKG[pkg].zran.pack_gzip_layer(gzip.compress(_sparse_tar()),
                                          PKG[pkg].PackOption(chunk_size=0x1000))

    @BOTH
    def test_encrypt_rejected(self, pkg):
        raw, _ = mk_targz({"f": b"x"})
        with pytest.raises(PKG[pkg].ConvertError):
            PKG[pkg].zran.pack_gzip_layer(raw, _ref_opt(pkg, chunk_size=0x1000, encrypt=True))


@BOTH
def test_merge_mixes_zran_and_packed_layers(pkg):
    p = PKG[pkg]
    got = _mixed_image(pkg)
    merged, provider, zran_id, upper_id = got
    assert set(merged.blob_digests) == {zran_id, upper_id}
    out = p.convert.Unpack(merged.bootstrap, provider)
    with tarfile.open(fileobj=io.BytesIO(out)) as tf:
        assert tf.extractfile("base/data.bin").read() == SHARED
        assert tf.extractfile("base/low.txt").read() == b"UPPER\n"
        assert tf.extractfile("top/new.bin").read() == b"n" * 5000


# ---------------------------------------------------------------------------
# Inputs shared by the cases and the parity checks
# ---------------------------------------------------------------------------

SHARED = RNG.integers(0, 256, 300_000, dtype=np.uint8).tobytes()


def _multi_member_layer():
    data = {
        "/first.bin": RNG.integers(0, 256, 90_000, dtype=np.uint8).tobytes(),
        "/second.bin": RNG.integers(0, 256, 70_000, dtype=np.uint8).tobytes(),
    }
    whole = mk_tar((k[1:], v) for k, v in data.items())
    comp = gzip.compress(whole[:100_000], mtime=0) + gzip.compress(whole[100_000:], mtime=0)
    return comp, data


_MULTI = _multi_member_layer()


def _overlay_tar() -> bytes:
    return mk_tar([("app/keep", b"k"), ("app/.wh.deleted", b""), ("app/.wh..wh..opq", b"")])


def _sparse_tar() -> bytes:
    name = b"sparse.bin".ljust(100, b"\0")
    hdr = bytearray(512)
    hdr[0:100] = name
    hdr[100:108] = b"0000644\x00"
    hdr[108:116] = b"0000000\x00"
    hdr[116:124] = b"0000000\x00"
    hdr[124:136] = b"00000000100\x00"  # 64 bytes of stored data
    hdr[136:148] = b"00000000000\x00"
    hdr[156] = ord("S")  # GNUTYPE_SPARSE
    hdr[257:265] = b"ustar  \x00"
    hdr[386:398] = b"00000000000\x00"
    hdr[398:410] = b"00000000100\x00"
    hdr[483:495] = b"00004000000\x00"  # realsize
    chksum = sum(hdr) - sum(hdr[148:156]) + 8 * 0x20
    hdr[148:156] = ("%06o\0 " % chksum).encode()
    return bytes(hdr) + b"x" * 64 + b"\0" * (512 - 64) + b"\0" * 1024


def _mixed_image(pkg):
    """An OCIRef lower layer and a packed upper layer, merged; returns
    (MergeResult, blob provider, zran blob id, upper blob id)."""
    p = PKG[pkg]
    raw_gz, _ = mk_targz({"base/data.bin": SHARED, "base/low.txt": b"lower\n"})
    zran_bs = p.zran.pack_gzip_layer(raw_gz, _ref_opt(pkg, chunk_size=0x10000))
    zran_stream = p.convert.frame_bootstrap_only(zran_bs.to_bytes())
    upper = mk_tar([("base/low.txt", b"UPPER\n"), ("top/new.bin", b"n" * 5000)])
    upper_blob, upper_res = p.pack_layer(
        upper, p.PackOption(chunk_size=0x1000, backend="numpy"))
    merged = p.convert.Merge([zran_stream, upper_blob], p.MergeOption())
    provider = {
        zran_bs.blobs[0].blob_id: raw_gz,
        upper_res.blob_id: p.convert.blob_data_from_layer_blob(upper_blob),
    }
    return merged, provider, zran_bs.blobs[0].blob_id, upper_res.blob_id


# ---------------------------------------------------------------------------
# Parity: the same compressed bytes through both packages
# ---------------------------------------------------------------------------

PARITY_TAR = mk_tar([
    ("app/big.bin", FILES["app/big.bin"][:700_000]),
    ("app/small.txt", b"ref layer\n"),
    ("app/dup", b"first version"),
    ("app/.wh.gone", b""),
    ("app/sub/.wh..wh..opq", b""),
    ("app/sub/x", b"x" * 9000),
    ("app/dup", b"second"),
    ("etc/conf", b"a=b\n"),
    ("etc/empty", b""),
])
GZIP_CASES = {
    "single-member": gzip.compress(PARITY_TAR, mtime=0),
    "multi-member": gzip.compress(PARITY_TAR[:300_000], mtime=0)
    + gzip.compress(PARITY_TAR[300_000:], mtime=0),
    "level-1": gzip.compress(PARITY_TAR, compresslevel=1, mtime=0),
}
OPTS = {
    "v6": dict(chunk_size=0x10000),
    "v5-prefetch": dict(chunk_size=0x4000, fs_version=layout.RAFS_V5,
                        prefetch_patterns="app/sub\netc\n"),
    "blake3": dict(chunk_size=0x10000, digester="blake3"),
}


@pytest.mark.parametrize("opt", OPTS, ids=list(OPTS))
@pytest.mark.parametrize("case", GZIP_CASES, ids=list(GZIP_CASES))
def test_gzip_bootstrap_reads_and_unpack_equal_reference(case, opt):
    raw = GZIP_CASES[case]
    t = tzran.pack_gzip_layer(raw, TPackOption(oci_ref=True, **OPTS[opt]))
    j = jzran.pack_gzip_layer(raw, JPackOption(oci_ref=True, **OPTS[opt]))
    assert t.to_bytes() == j.to_bytes()
    treader = tconvert.BlobReader(t, 0, lambda o, s: raw[o : o + s])
    jreader = jconvert.BlobReader(j, 0, lambda o, s: raw[o : o + s])
    order = np.random.default_rng(5).permutation(len(t.chunks))
    for i in order:
        assert treader.chunk_data(t.chunks[i]) == jreader.chunk_data(j.chunks[i])
    assert tconvert.Unpack(t, {t.blobs[0].blob_id: raw}) == jconvert.Unpack(
        j, {j.blobs[0].blob_id: raw})


def test_tar_bytes_handover_equals_decompression():
    raw = GZIP_CASES["single-member"]
    opt = TPackOption(oci_ref=True, chunk_size=0x10000)
    assert tzran.pack_gzip_layer(raw, opt, tar_bytes=PARITY_TAR).to_bytes() == \
        tzran.pack_gzip_layer(raw, opt).to_bytes()


@pytest.mark.parametrize("digester", ["sha256", "blake3"])
def test_device_engine_equals_host_path(digester):
    """``engine=`` digests through ``digest_many`` (K2 or K4 on the card;
    their plain versions here), to the host path's bootstrap, in both
    formats."""
    tar = mk_tar([("a/one", SHARED[:70_000]), ("a/two", b"2" * 5000), ("b/three", SHARED[-9000:]),
                  ("b/empty", b"")])
    raw = gzip.compress(tar, mtime=0)
    opt = TPackOption(oci_ref=True, chunk_size=0x4000, digester=digester)
    eng = ChunkDigestEngine(chunk_size=0x4000, backend="jax", digest_backend="jax",
                            digester=digester, device="cpu")
    host = tzran.pack_gzip_layer(raw, opt)
    assert tzran.pack_gzip_layer(raw, opt, engine=eng).to_bytes() == host.to_bytes()
    if tzstd.frames_available():
        zraw = tzstd.compress_block(tar, 3)
        assert tzstd_ref.pack_zstd_layer(zraw, opt, engine=eng).to_bytes() == \
            tzstd_ref.pack_zstd_layer(zraw, opt).to_bytes()


@needs_frames
@pytest.mark.parametrize("frames", [1, 3], ids=["one-frame", "three-frames"])
def test_zstd_bootstrap_reads_and_unpack_equal_reference(frames):
    cut = [0, 250_000, 500_000, len(PARITY_TAR)] if frames == 3 else [0, len(PARITY_TAR)]
    raw = b"".join(tzstd.compress_block(PARITY_TAR[a:b], 3) for a, b in zip(cut, cut[1:]))
    opt = dict(chunk_size=0x10000, prefetch_patterns="app\n")
    t = tzstd_ref.pack_zstd_layer(raw, TPackOption(oci_ref=True, **opt))
    j = jzstd_ref.pack_zstd_layer(raw, JPackOption(oci_ref=True, **opt))
    assert t.to_bytes() == j.to_bytes()
    assert t.blobs[0].flags == TC.COMPRESSOR_ZSTD
    treader = tconvert.BlobReader(t, 0, lambda o, s: raw[o : o + s])
    order = np.random.default_rng(6).permutation(len(t.chunks))  # backward seeks rewind
    for i in order:
        rec = t.chunks[i]
        want = PARITY_TAR[rec.uncompressed_offset : rec.uncompressed_offset + rec.uncompressed_size]
        assert treader.chunk_data(rec) == want
    assert tconvert.Unpack(t, {t.blobs[0].blob_id: raw}) == jconvert.Unpack(
        j, {j.blobs[0].blob_id: raw})
    with pytest.raises(TConvertError):
        tzstd_ref.pack_zstd_layer(b"\x28\xb5\x2f\xfd broken", TPackOption(chunk_size=0x1000))


@needs_frames
def test_zstd_stream_arms_equal_reference():
    from nydus_snapshotter_tpu.utils import zstd as jzstd

    a, b = tzstd.compress_block(MEMBER_A, 3), tzstd.compress_block(MEMBER_B, 1)
    skippable = (0x184D2A50).to_bytes(4, "little") + (5).to_bytes(4, "little") + b"hello"
    blob = a + skippable + b
    for mod in (tzstd, jzstd):
        assert mod.find_frame_compressed_size(blob, 0) == len(a)
        assert mod.is_skippable_frame(blob, len(a))
        assert mod.find_frame_compressed_size(blob, len(a)) == len(skippable)
        assert mod.frame_content_size(blob, 0) == len(MEMBER_A)
        assert mod.stream_decompress(blob) == MEMBER_A + MEMBER_B
    dec = tzstd.StreamDecoder()
    got = b"".join(dec.feed(blob[i : i + 4099]) for i in range(0, len(blob), 4099))
    assert got == MEMBER_A + MEMBER_B
    dec.reset()
    assert dec.feed(a) == MEMBER_A
    dec.close()
    with pytest.raises(tzstd.ZstdError):
        tzstd.stream_decompress(a[:-7])


@pytest.mark.parametrize("case", ["gzip", "zstd", "zlib", "plain"])
def test_decompress_stream_equals_reference(case):
    from nydus_snapshotter_tpu.remote import unpack as junpack
    from nydus_snapshotter_tpu_torch.remote import unpack as tunpack

    data = PARITY_TAR[:50_000]
    enc = {
        "gzip": lambda d: gzip.compress(d, mtime=0),
        "zstd": lambda d: tzstd.compress_block(d, 3),
        "zlib": __import__("zlib").compress,
        "plain": lambda d: d,
    }[case](data)
    assert tunpack.decompress_stream(enc) == junpack.decompress_stream(enc) == data


def test_mixed_merge_and_unpack_equal_reference():
    t_merged, t_provider, _tz, _tu = _mixed_image("port")
    j_merged, j_provider, _jz, _ju = _mixed_image("ref")
    assert t_merged.bootstrap == j_merged.bootstrap
    assert t_merged.blob_digests == j_merged.blob_digests
    assert tconvert.Unpack(t_merged.bootstrap, t_provider) == jconvert.Unpack(
        j_merged.bootstrap, j_provider)


def test_mounted_stream_reader_is_used():
    """``mount_gzip_stream`` swaps in an indexed reader; a ``concurrent``
    one is called without the reader lock."""
    raw = GZIP_CASES["single-member"]
    bs = tzran.pack_gzip_layer(raw, TPackOption(oci_ref=True, chunk_size=0x10000))
    calls = []

    class Indexed:
        concurrent = True

        def read_range(self, off, size):
            calls.append((off, size))
            return PARITY_TAR[off : off + size]

    reader = tconvert.BlobReader(bs, 0, lambda o, s: raw[o : o + s])
    reader.mount_gzip_stream(Indexed())
    rec = bs.chunks[0]
    assert reader.chunk_data(rec) == PARITY_TAR[rec.uncompressed_offset:][: rec.uncompressed_size]
    assert calls == [(rec.uncompressed_offset, rec.uncompressed_size)]


def _counting(raw: bytes, fed: list):
    def read_at(o, s):
        fed.append(s)
        return raw[o : o + s]

    return read_at


@pytest.mark.parametrize("fmt", ["gzip", "multi-member-gzip", "zstd"])
def test_ascending_reads_cost_one_decode_pass(fmt):
    """Reads in ascending offset order resume where the last one stopped
    (its inflate state and last decoded step): the compressed stream is
    fed once in all, and every range equals the plain bytes."""
    if fmt == "zstd" and not tzstd.frames_available():
        pytest.skip("the system libzstd's frame surface is not bound")
    plain = PLAIN_3M + MEMBER_A
    if fmt == "gzip":
        raw = gzip.compress(plain, compresslevel=1, mtime=0)
    elif fmt == "multi-member-gzip":
        raw = gzip.compress(PLAIN_3M, mtime=0) + gzip.compress(MEMBER_A, mtime=0)
    else:
        raw = tzstd.compress_block(plain, 3)
    fed: list = []
    cls = tzstd_ref.ZstdSequentialReader if fmt == "zstd" else tzran.GzipStreamReader
    r = cls(_counting(raw, fed), len(raw))
    ranges = [(o, 70_001) for o in range(0, len(plain) - 70_001, 70_001 + 3)] + [
        (len(plain) - 9, 9)]
    for off, size in ranges:
        assert r.read_range(off, size) == plain[off : off + size], (off, size)
    assert sum(fed) == len(raw), (sum(fed), len(raw))


@pytest.mark.parametrize("fmt", ["gzip", "zstd"])
def test_unpack_reads_stream_chunks_in_offset_order(fmt, monkeypatch):
    """A ref layer whose tar order runs against path order unpacks equal
    to the reference's Unpack, with one decode pass over the blob."""
    if fmt == "zstd" and not tzstd.frames_available():
        pytest.skip("the system libzstd's frame surface is not bound")
    rng = np.random.default_rng(17)
    files = [(f"d/f{i:02d}", rng.integers(0, 256, 40_000 + 997 * i, dtype=np.uint8).tobytes())
             for i in range(24)][::-1]
    tar = mk_tar(files)
    if fmt == "gzip":
        raw = gzip.compress(tar, mtime=0)
        t = tzran.pack_gzip_layer(raw, TPackOption(oci_ref=True, chunk_size=0x4000))
        j = jzran.pack_gzip_layer(raw, JPackOption(oci_ref=True, chunk_size=0x4000))
    else:
        raw = tzstd.compress_block(tar, 3)
        t = tzstd_ref.pack_zstd_layer(raw, TPackOption(oci_ref=True, chunk_size=0x4000))
        j = jzstd_ref.pack_zstd_layer(raw, JPackOption(oci_ref=True, chunk_size=0x4000))
    fed: list = []
    real = tconvert.make_bytes_reader

    def counted_reader(bs, blob_index, blob, batch_map):
        reader = real(bs, blob_index, blob, batch_map)
        reader.read_at = _counting(blob, fed)
        return reader

    monkeypatch.setattr(tconvert, "make_bytes_reader", counted_reader)
    out = tconvert.Unpack(t, {t.blobs[0].blob_id: raw})
    assert out == jconvert.Unpack(j, {j.blobs[0].blob_id: raw})
    with tarfile.open(fileobj=io.BytesIO(out)) as tf:
        assert {m.name.lstrip("/"): tf.extractfile(m).read() for m in tf if m.isreg()} == dict(files)
    assert sum(fed) == len(raw), (sum(fed), len(raw))
