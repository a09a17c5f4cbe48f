"""The port's tar-tarfs bootstrap builder and dm-verity trees against the
JAX package's.

``TestTarfsBootstrap`` and ``TestVerity`` of tests/test_tarfs.py run in
both packages (``pkg``); every bootstrap and tree is also held byte for
byte against the reference's. The builder's device route digests the
indexed regions through ``ChunkDigestEngine.digest_many`` (kernel K2, or
K4 for BLAKE3, on the card; their plain versions on ``device="cpu"``),
against the reference's engine and hashlib. The manager cases
(``TestManager``, ``test_export_flags_modes``) need the port's
``tarfs/tarfs.py``, which waits for the registry client, loop devices and
mounts.
"""

from __future__ import annotations

import hashlib
import io
import os
import tarfile
from types import SimpleNamespace

import numpy as np
import pytest

from nydus_snapshotter_tpu.models import bootstrap as jbootstrap
from nydus_snapshotter_tpu.ops.chunker import ChunkDigestEngine as JEngine
from nydus_snapshotter_tpu.tarfs import bootstrap as jtb
from nydus_snapshotter_tpu.tarfs import verity as jverity
from nydus_snapshotter_tpu_torch import tarfs as ttarfs
from nydus_snapshotter_tpu_torch.models import bootstrap as tbootstrap
from nydus_snapshotter_tpu_torch.ops.chunker import ChunkDigestEngine as TEngine
from nydus_snapshotter_tpu_torch.tarfs import bootstrap as ttb
from nydus_snapshotter_tpu_torch.tarfs import verity as tverity
from nydus_snapshotter_tpu_torch.utils import blake3 as pyb3

PKG = {
    "ref": SimpleNamespace(build=jtb.tarfs_bootstrap_from_tar, verity=jverity, models=jbootstrap),
    "port": SimpleNamespace(build=ttarfs.tarfs_bootstrap_from_tar, verity=tverity, models=tbootstrap),
}


@pytest.fixture(params=["ref", "port"])
def pkg(request):
    return PKG[request.param]


def make_tar(files: dict[str, bytes]) -> bytes:
    buf = io.BytesIO()
    with tarfile.open(fileobj=buf, mode="w:", format=tarfile.GNU_FORMAT) as tf:
        for name, data in files.items():
            if name.endswith("/"):
                info = tarfile.TarInfo(name.rstrip("/"))
                info.type = tarfile.DIRTYPE
                info.mode = 0o755
                tf.addfile(info)
            else:
                info = tarfile.TarInfo(name)
                info.size = len(data)
                info.mode = 0o644
                tf.addfile(info, io.BytesIO(data))
    return buf.getvalue()


def both(raw: bytes, blob_id: str, **kw) -> bytes:
    """The bootstrap of ``raw`` from both builders, held equal."""
    got = {side: p.build(io.BytesIO(raw), blob_id, **kw).to_bytes() for side, p in PKG.items()}
    assert got["port"] == got["ref"]
    return got["port"]


class TestTarfsBootstrap:
    def test_chunks_point_into_tar(self, pkg):
        files = {"etc/": b"", "etc/hosts": b"127.0.0.1 localhost\n", "big": b"Z" * 5000}
        raw = make_tar(files)
        bs = pkg.build(io.BytesIO(raw), "ab" * 32)
        hosts = {i.path: i for i in bs.inodes}["/etc/hosts"]
        assert hosts.chunk_count == 1
        chunk = bs.chunks[hosts.chunk_index]
        # the chunk's offset indexes the file data inside the tar itself
        off = chunk.uncompressed_offset
        assert raw[off:off + chunk.uncompressed_size] == files["etc/hosts"]
        assert chunk.digest == hashlib.sha256(files["etc/hosts"]).digest()
        both(raw, "ab" * 32)

    def test_large_file_split_by_chunk_size(self, pkg):
        data = bytes(range(256)) * 64  # 16 KiB
        raw = make_tar({"blob": data})
        bs = pkg.build(io.BytesIO(raw), "cd" * 32, chunk_size=4096)
        blob_inode = next(i for i in bs.inodes if i.path == "/blob")
        assert blob_inode.chunk_count == 4 and blob_inode.size == len(data)
        got = b"".join(
            raw[c.uncompressed_offset:c.uncompressed_offset + c.uncompressed_size]
            for c in bs.chunks[blob_inode.chunk_index:blob_inode.chunk_index + 4]
        )
        assert got == data
        both(raw, "cd" * 32, chunk_size=4096)

    def test_whiteout_normalization(self, pkg):
        raw = make_tar({"dir/": b"", "dir/.wh.gone": b"", "dir/.wh..wh..opq": b""})
        by_path = {i.path: i for i in pkg.build(io.BytesIO(raw), "ef" * 32).inodes}
        assert by_path["/dir/gone"].flags & pkg.models.INODE_FLAG_WHITEOUT
        assert by_path["/dir"].flags & pkg.models.INODE_FLAG_OPAQUE
        both(raw, "ef" * 32)

    def test_duplicate_member_last_wins_without_stale_chunks(self, pkg):
        buf = io.BytesIO()
        with tarfile.open(fileobj=buf, mode="w:", format=tarfile.GNU_FORMAT) as tf:
            info = tarfile.TarInfo("foo")
            info.size = 5120
            tf.addfile(info, io.BytesIO(b"A" * 5120))
            info2 = tarfile.TarInfo("foo")
            info2.size = 0
            tf.addfile(info2)
        foo = next(i for i in pkg.build(io.BytesIO(buf.getvalue()), "aa" * 32).inodes if i.path == "/foo")
        assert foo.chunk_count == 0 and foo.size == 0
        both(buf.getvalue(), "aa" * 32)

    def test_serialized_roundtrip(self, pkg):
        raw = make_tar({"a/b/c": b"deep"})
        bs = pkg.build(io.BytesIO(raw), "12" * 32)
        again = pkg.models.Bootstrap.from_bytes(bs.to_bytes())
        assert {i.path for i in again.inodes} == {i.path for i in bs.inodes}
        assert again.blobs[0].uncompressed_size == len(raw)
        both(raw, "12" * 32, fs_version="v5")


RNG = np.random.default_rng(0x7A5F)
ENGINE_TAR = make_tar({
    "usr/": b"",
    "usr/lib/libx.so": RNG.integers(0, 256, 70_000, dtype=np.uint8).tobytes(),
    "usr/share/doc": b"text " * 900,
    "usr/empty": b"",
    "usr/one": b"1",
    "etc/conf": RNG.integers(0, 256, 4096, dtype=np.uint8).tobytes(),
})


@pytest.mark.parametrize("backend", ["fused", "jax", "hybrid", "numpy"])
def test_engine_digests_equal_reference_engine_and_hashlib(backend):
    """``engine=``: the port's engine on the CPU (``jax``/``fused`` run K2's
    plain version there) gives the reference engine's bootstrap, whose
    digests are hashlib's."""
    chunk = 0x1000
    want = jtb.tarfs_bootstrap_from_tar(
        io.BytesIO(ENGINE_TAR), "e" * 64, chunk_size=chunk,
        engine=JEngine(chunk_size=chunk, backend=backend if backend != "hybrid" else "numpy"))
    got = ttb.tarfs_bootstrap_from_tar(
        io.BytesIO(ENGINE_TAR), "e" * 64, chunk_size=chunk,
        engine=TEngine(chunk_size=chunk, backend=backend, device="cpu"))
    assert got.to_bytes() == want.to_bytes()
    assert got.to_bytes() == ttb.tarfs_bootstrap_from_tar(io.BytesIO(ENGINE_TAR), "e" * 64,
                                                          chunk_size=chunk).to_bytes()
    for c in got.chunks:
        region = ENGINE_TAR[c.uncompressed_offset:c.uncompressed_offset + c.uncompressed_size]
        assert c.digest == hashlib.sha256(region).digest()


@pytest.mark.parametrize("backend", ["fused", "hybrid"])
def test_blake3_engine_digests_regions(backend):
    """A BLAKE3 engine digests the regions with BLAKE3 (K4's plain version
    on ``device="cpu"`` for the device lanes), as the reference's does."""
    chunk = 0x2000
    eng = TEngine(chunk_size=chunk, backend=backend, digester="blake3", device="cpu")
    got = ttb.tarfs_bootstrap_from_tar(io.BytesIO(ENGINE_TAR), "f" * 64, chunk_size=chunk, engine=eng)
    want = jtb.tarfs_bootstrap_from_tar(
        io.BytesIO(ENGINE_TAR), "f" * 64, chunk_size=chunk,
        engine=JEngine(chunk_size=chunk, backend="numpy", digester="blake3"))
    assert got.to_bytes() == want.to_bytes()
    for c in got.chunks:
        region = ENGINE_TAR[c.uncompressed_offset:c.uncompressed_offset + c.uncompressed_size]
        assert c.digest == pyb3.blake3(region)


class TestVerity:
    def test_tree_roundtrip(self, pkg):
        data = os.urandom(512 * 300)
        tree, info = pkg.verity.build_tree(data)
        assert info.data_blocks == 300
        assert pkg.verity.verify(data, info, tree)

    def test_tamper_detected(self, pkg):
        data = bytearray(os.urandom(512 * 64))
        tree, info = pkg.verity.build_tree(bytes(data))
        data[100] ^= 0xFF
        assert not pkg.verity.verify(bytes(data), info, tree)

    def test_multi_level_tree(self, pkg):
        data = b"\xAA" * (512 * 200)  # level0: 200 digests -> 2 hash blocks; level1: 1 block
        tree, info = pkg.verity.build_tree(data)
        assert len(tree) == 3 * pkg.verity.HASH_BLOCK_SIZE
        assert pkg.verity.verify(data, info, tree)

    def test_unaligned_rejected(self, pkg):
        with pytest.raises(ValueError):
            pkg.verity.build_tree(b"x" * 777)

    def test_block_info_label_roundtrip(self, pkg):
        info = pkg.verity.VerityInfo(123, 4096, "ab" * 32)
        assert pkg.verity.parse_block_info_label(info.block_info_label()) == info


@pytest.mark.parametrize("blocks", [1, 127, 128, 129, 200, 16_385])
def test_verity_trees_equal_reference(blocks):
    """Trees, roots and labels byte for byte, across level boundaries
    (128 digests per hash block: a third level past 16 384 blocks)."""
    data = np.random.default_rng(blocks).integers(0, 256, 512 * blocks, dtype=np.uint8).tobytes()
    t_tree, t_info = tverity.build_tree(data)
    j_tree, j_info = jverity.build_tree(data)
    assert t_tree == j_tree
    assert t_info.block_info_label() == j_info.block_info_label()
    assert tverity.verify(data, t_info, t_tree)


def test_package_exports_only_what_is_ported():
    assert sorted(ttarfs.__all__) == sorted(
        ["DEFAULT_CHUNK_SIZE", "VerityInfo", "build_tree", "parse_block_info_label",
         "tarfs_bootstrap_from_tar", "verify"])
    assert ttarfs.DEFAULT_CHUNK_SIZE == jtb.DEFAULT_CHUNK_SIZE


def test_append_tree_equals_reference():
    """``append_tree``: the hash area appended after an image's data, and
    its ``VerityInfo``, as the reference's."""
    data = np.random.default_rng(3).integers(0, 256, 512 * 333, dtype=np.uint8).tobytes()
    out = {}
    for side, p in PKG.items():
        f = io.BytesIO(data)
        f.seek(0, 2)
        info = p.verity.append_tree(f, len(data))
        out[side] = (f.getvalue(), info.block_info_label())
    assert out["port"] == out["ref"]
    info = tverity.parse_block_info_label(out["port"][1])
    assert tverity.verify(data, info, out["port"][0][info.hash_offset:])
