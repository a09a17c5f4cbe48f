"""The port's EROFS image writer (models/erofs_image.py) against the JAX
package's.

The structural cases of tests/test_erofs_image.py run in both packages
(``pkg``), and every image those tests build, the kernel-mount cases'
included, is built by both and must be byte-identical. The mount cases
themselves run on the port's images and skip under the reference's
condition (root, loop devices and the erofs driver).
"""

from __future__ import annotations

import ctypes
import io
import os
import stat as statmod
import struct
import subprocess
import tarfile
from types import SimpleNamespace

import numpy as np
import pytest

from nydus_snapshotter_tpu.converter import convert as jconvert
from nydus_snapshotter_tpu.converter.types import PackOption as JPackOption
from nydus_snapshotter_tpu.models import erofs_image as jerofs
from nydus_snapshotter_tpu.models import fstree as jfstree
from nydus_snapshotter_tpu.models import layout as jlayout
from nydus_snapshotter_tpu.tarfs import bootstrap as jtarfs
from nydus_snapshotter_tpu_torch.converter import convert as tconvert
from nydus_snapshotter_tpu_torch.converter.types import PackOption as TPackOption
from nydus_snapshotter_tpu_torch.models import erofs_image as terofs
from nydus_snapshotter_tpu_torch.models import fstree as tfstree
from nydus_snapshotter_tpu_torch.models import layout as tlayout
from nydus_snapshotter_tpu_torch.tarfs import bootstrap as ttarfs

PKG = {
    "ref": SimpleNamespace(erofs=jerofs, fstree=jfstree, layout=jlayout, tarfs=jtarfs,
                           convert=jconvert, PackOption=JPackOption, pack_kw={}),
    "port": SimpleNamespace(erofs=terofs, fstree=tfstree, layout=tlayout, tarfs=ttarfs,
                            convert=tconvert, PackOption=TPackOption, pack_kw={"device": "cpu"}),
}


@pytest.fixture(params=["ref", "port"])
def pkg(request):
    return PKG[request.param]


def payload(n: int, seed: int) -> bytes:
    return np.random.default_rng(seed).integers(0, 256, n, dtype=np.uint8).tobytes()


BIG = payload(150_000, 0xE20F5)


def sample_entries(p):
    e = p.fstree.FileEntry
    return [
        e(path="/etc", mode=statmod.S_IFDIR | 0o755),
        e(path="/etc/hosts", mode=statmod.S_IFREG | 0o644, data=b"127.0.0.1 localhost\n"),
        e(path="/etc/empty", mode=statmod.S_IFREG | 0o600, data=b""),
        e(path="/bin", mode=statmod.S_IFDIR | 0o755),
        e(path="/bin/app", mode=statmod.S_IFREG | 0o755, data=BIG),
        e(path="/bin/link", mode=statmod.S_IFLNK | 0o777, symlink_target="app"),
        e(path="/bin/hard", mode=statmod.S_IFREG | 0o755, hardlink_target="/bin/app"),
        e(path="/deep", mode=statmod.S_IFDIR | 0o755),
        e(path="/deep/a", mode=statmod.S_IFDIR | 0o755),
        e(path="/deep/a/b", mode=statmod.S_IFDIR | 0o755),
        e(path="/deep/a/b/leaf", mode=statmod.S_IFREG | 0o644, data=b"leaf-data"),
    ]


def ent(p, path, mode, data=b"", **kw):
    return p.fstree.FileEntry(path=path, mode=mode, data=data, **kw)


class TestStructure:
    def test_superblock_fields(self, pkg):
        img = pkg.erofs.build_erofs(sample_entries(pkg))
        assert len(img) % pkg.erofs.BLKSZ == 0
        magic, _cs, _fc, blkszbits = struct.unpack_from("<IIIB", img, 1024)
        assert magic == pkg.erofs.EROFS_MAGIC and blkszbits == 12
        assert pkg.layout.detect_fs_version(img) == pkg.layout.RAFS_V6

    def test_many_files_multiblock_dir(self, pkg):
        entries = [ent(pkg, "/d", statmod.S_IFDIR | 0o755)] + [
            ent(pkg, f"/d/file-{i:04d}", statmod.S_IFREG | 0o644, bytes([i % 256]) * 10)
            for i in range(600)  # > one 4K dirent block
        ]
        assert len(pkg.erofs.build_erofs(entries)) % pkg.erofs.BLKSZ == 0

    def test_hardlink_to_missing_target_rejected(self, pkg):
        with pytest.raises(pkg.erofs.ErofsError):
            pkg.erofs.build_erofs([ent(pkg, "/x", statmod.S_IFREG | 0o644, hardlink_target="/gone")])

    def test_long_name_rejected(self, pkg):
        with pytest.raises(pkg.erofs.ErofsError):
            pkg.erofs.build_erofs([ent(pkg, "/" + "n" * 300, statmod.S_IFREG | 0o644)])


class TestHardlinkChains:
    def test_chained_hardlink_resolves_to_real_inode(self, pkg, tmp_path):
        entries = [
            ent(pkg, "/c", statmod.S_IFREG | 0o644, b"real-data"),
            ent(pkg, "/b", statmod.S_IFREG | 0o644, hardlink_target="/c"),
            ent(pkg, "/a", statmod.S_IFREG | 0o644, hardlink_target="/b"),
        ]
        img = pkg.erofs.build_erofs(entries)  # must not point /a at nid 0
        if _mount_available():
            image_path = str(tmp_path / "img")
            with open(image_path, "wb") as f:
                f.write(img)
            mp = str(tmp_path / "mnt")
            os.mkdir(mp)
            with _Mounted(image_path, mp):
                for name in ("a", "b", "c"):
                    with open(os.path.join(mp, name), "rb") as f:
                        assert f.read() == b"real-data", name
                assert os.stat(os.path.join(mp, "c")).st_nlink == 3

    def test_hardlink_cycle_rejected(self, pkg):
        with pytest.raises(pkg.erofs.ErofsError):
            pkg.erofs.build_erofs([
                ent(pkg, "/a", statmod.S_IFREG | 0o644, hardlink_target="/b"),
                ent(pkg, "/b", statmod.S_IFREG | 0o644, hardlink_target="/a"),
            ])

    def test_oversized_metadata_rejected(self, pkg):
        with pytest.raises(pkg.erofs.ErofsError):
            pkg.erofs.build_erofs([ent(pkg, "/u", statmod.S_IFREG | 0o644, uid=70_000)])


class TestChunkMapChecks:
    def test_chunk_offsets_must_be_aligned(self, pkg):
        with pytest.raises(pkg.erofs.ErofsError):
            pkg.erofs.build_erofs(
                [ent(pkg, "/f", statmod.S_IFREG | 0o644)],
                blkszbits=9,
                chunk_map={"/f": pkg.erofs.ChunkedData(size=10, chunk_size=512, offsets=[100])},
                device=(b"t", 4096),
            )

    def test_chunk_map_requires_device(self, pkg):
        with pytest.raises(pkg.erofs.ErofsError):
            pkg.erofs.build_erofs(
                [ent(pkg, "/f", statmod.S_IFREG | 0o644)],
                chunk_map={"/f": pkg.erofs.ChunkedData(size=10, chunk_size=4096, offsets=[0])},
            )

    def test_non_tarfs_bootstrap_refused_by_exports(self, pkg):
        """A packed (compressed) layer is not identity-mapped: neither export
        takes it."""
        tar = _gnu_tar([("f", payload(9000, 3))])
        _blob, res = pkg.convert.pack_layer(tar, pkg.PackOption(chunk_size=0x1000, backend="numpy"))
        bs = pkg.convert.Bootstrap.from_bytes(res.bootstrap)
        with pytest.raises(pkg.erofs.ErofsError):
            pkg.erofs.erofs_from_rafs(bs)
        with pytest.raises(pkg.erofs.ErofsError):
            pkg.erofs.write_erofs_disk(bs, lambda _b: "/nonexistent", io.BytesIO())


# ---------------------------------------------------------------------------
# Every image the reference's tests build, built by both packages
# ---------------------------------------------------------------------------


def _gnu_tar(members) -> bytes:
    """GNU tar of ``(name, bytes | None | ("sym", target))``: None = a dir."""
    buf = io.BytesIO()
    with tarfile.open(fileobj=buf, mode="w", format=tarfile.GNU_FORMAT) as tf:
        for name, data in members:
            ti = tarfile.TarInfo(name)
            if data is None:
                ti.type, ti.mode = tarfile.DIRTYPE, 0o755
                tf.addfile(ti)
            elif isinstance(data, tuple):
                ti.type, ti.linkname = tarfile.SYMTYPE, data[1]
                tf.addfile(ti)
            else:
                ti.size = len(data)
                tf.addfile(ti, io.BytesIO(data))
    return buf.getvalue()


TARFS_TAR = _gnu_tar([("usr", None), ("usr/lib", None), ("usr/lib/libbig.so", payload(600_000, 5)),
                      ("usr/hello", b"tarfs-hello\n"), ("usr/ln", ("sym", "hello"))])
OPAQUE_TAR = _gnu_tar([("d", None), ("d/.wh..wh..opq", b""), ("d/keep", b"keep")])
DISK_TAR = _gnu_tar([("data", None), ("data/blob.bin", payload(300_000, 6)), ("data/note", b"hello")])
CHUNKED_TAR = _gnu_tar([("app", None), ("app/big.bin", payload(2_500_000, 7)),
                        ("app/small.txt", b"tarfs says hi\n")])


def _chunked_image(p) -> bytes:
    """The reference's tar-is-the-data-plane image: 1 MiB chunks into the tar."""
    chunk = 1 << 20
    chunk_map = {}
    with tarfile.open(fileobj=io.BytesIO(CHUNKED_TAR)) as tf:
        for m in tf.getmembers():
            if m.isreg():
                offsets = [m.offset_data + k * chunk for k in range(-(-m.size // chunk))]
                chunk_map["/" + m.name] = p.erofs.ChunkedData(size=m.size, chunk_size=chunk, offsets=offsets)
    entries = [ent(p, "/app", statmod.S_IFDIR | 0o755), ent(p, "/app/big.bin", statmod.S_IFREG | 0o644),
               ent(p, "/app/small.txt", statmod.S_IFREG | 0o644)]
    return p.erofs.build_erofs(entries, blkszbits=9, chunk_map=chunk_map,
                               device=(b"layer-tar", len(CHUNKED_TAR)))


def _converted_layer_image(p) -> bytes:
    """OCI tar -> pack -> the layer's tree read back -> EROFS image."""
    tar = _gnu_tar([("app", None), ("app/data.bin", payload(90_000, 8))])
    blob, _res = p.convert.pack_layer(tar, p.PackOption(chunk_size=0x1000), **p.pack_kw)
    bs = p.convert.bootstrap_from_layer_blob(blob)
    reader = p.convert.make_bytes_reader(bs, 0, p.convert.blob_data_from_layer_blob(blob))
    entries = []
    for inode in bs.inodes:
        data = b""
        if statmod.S_ISREG(inode.mode) and inode.chunk_count and not inode.hardlink_target:
            data = b"".join(reader.chunk_data(c)
                            for c in bs.chunks[inode.chunk_index:inode.chunk_index + inode.chunk_count])
        entries.append(p.fstree.inode_to_entry(inode, data))
    return p.erofs.build_erofs(entries)


def _overlay_entries(p):
    """The reference's two overlay lowers: upper wins, a whiteout, an opaque dir."""
    lower1 = [ent(p, "/app", statmod.S_IFDIR | 0o755),
              ent(p, "/app/keep.txt", statmod.S_IFREG | 0o644, b"from-lower"),
              ent(p, "/app/replaced.txt", statmod.S_IFREG | 0o644, b"old"),
              ent(p, "/app/deleted.txt", statmod.S_IFREG | 0o644, b"bye"),
              ent(p, "/shadowed", statmod.S_IFDIR | 0o755),
              ent(p, "/shadowed/old.txt", statmod.S_IFREG | 0o644, b"hidden")]
    lower2 = [ent(p, "/app", statmod.S_IFDIR | 0o755),
              ent(p, "/app/replaced.txt", statmod.S_IFREG | 0o644, b"new"),
              ent(p, "/app/deleted.txt", statmod.S_IFCHR, rdev=0),
              ent(p, "/shadowed", statmod.S_IFDIR | 0o755, xattrs={"trusted.overlay.opaque": b"y"}),
              ent(p, "/shadowed/fresh.txt", statmod.S_IFREG | 0o644, b"visible")]
    return lower1, lower2


def _overlay_lowers(p) -> bytes:
    return b"".join(p.erofs.build_erofs(lower) for lower in _overlay_entries(p))


def _disk(p, tmp_path) -> bytes:
    tar_path = tmp_path / "layer.tar"
    tar_path.write_bytes(DISK_TAR)
    bs = p.tarfs.tarfs_bootstrap_from_tar(io.BytesIO(DISK_TAR), blob_id="b0")
    out = io.BytesIO()
    size = p.erofs.write_erofs_disk(bs, lambda _bid: str(tar_path), out)
    assert size == len(out.getvalue())
    return out.getvalue()


def _two_blob_rafs(p) -> bytes:
    """A merged two-layer tarfs image: one device per layer tar."""
    a = p.tarfs.tarfs_bootstrap_from_tar(io.BytesIO(TARFS_TAR), blob_id="layer-a")
    b = p.tarfs.tarfs_bootstrap_from_tar(io.BytesIO(OPAQUE_TAR), blob_id="layer-b")
    for c in b.chunks:
        c.blob_index = 1
    base = len(a.chunks)
    for ino in b.inodes:
        if ino.chunk_count:
            ino.chunk_index += base
    a.inodes = [i for i in a.inodes if i.path != "/"] + b.inodes
    a.inodes.sort(key=lambda i: i.path)
    a.chunks += b.chunks
    a.blobs += b.blobs
    return p.erofs.erofs_from_rafs(a)


IMAGES = {
    "sample": lambda p, t: p.erofs.build_erofs(sample_entries(p)),
    "dir_600": lambda p, t: p.erofs.build_erofs(
        [ent(p, "/d", statmod.S_IFDIR | 0o755)]
        + [ent(p, f"/d/file-{i:04d}", statmod.S_IFREG | 0o644, b"%d" % i) for i in range(600)]),
    "hardlink_chain": lambda p, t: p.erofs.build_erofs(
        [ent(p, "/c", statmod.S_IFREG | 0o644, b"real-data"),
         ent(p, "/b", statmod.S_IFREG | 0o644, hardlink_target="/c"),
         ent(p, "/a", statmod.S_IFREG | 0o644, hardlink_target="/b")]),
    "xattrs": lambda p, t: p.erofs.build_erofs(
        [ent(p, "/opq", statmod.S_IFDIR | 0o755, xattrs={"trusted.overlay.opaque": b"y"}),
         ent(p, "/opq/f", statmod.S_IFREG | 0o644, b"inside"),
         ent(p, "/tagged", statmod.S_IFREG | 0o644, b"data",
             xattrs={"user.color": b"blue", "user.size": b"xl"})]),
    "overlay_lowers": lambda p, t: _overlay_lowers(p),
    "chunk_based_tar": lambda p, t: _chunked_image(p),
    "tarfs_export": lambda p, t: p.erofs.erofs_from_rafs(
        p.tarfs.tarfs_bootstrap_from_tar(io.BytesIO(TARFS_TAR), blob_id="tarblob")),
    "tarfs_export_tagged": lambda p, t: p.erofs.erofs_from_rafs(
        p.tarfs.tarfs_bootstrap_from_tar(io.BytesIO(TARFS_TAR), blob_id="tarblob"), device_tag=b"tag"),
    "tarfs_opaque": lambda p, t: p.erofs.erofs_from_rafs(
        p.tarfs.tarfs_bootstrap_from_tar(io.BytesIO(OPAQUE_TAR), blob_id="t")),
    "tarfs_two_layers": lambda p, t: _two_blob_rafs(p),
    "whole_disk": _disk,
    "converted_layer": lambda p, t: _converted_layer_image(p),
}


@pytest.mark.parametrize("name", sorted(IMAGES))
def test_image_bytes_equal_reference(name, tmp_path):
    imgs = {}
    for side, p in PKG.items():
        d = tmp_path / side
        d.mkdir()
        imgs[side] = IMAGES[name](p, d)
    assert imgs["port"] == imgs["ref"]
    assert struct.unpack_from("<I", imgs["port"], 1024)[0] == terofs.EROFS_MAGIC


# ---------------------------------------------------------------------------
# Kernel mounts of the port's images (the reference's condition)
# ---------------------------------------------------------------------------


def _mount_available() -> bool:
    if os.geteuid() != 0 or not os.path.exists("/dev/loop-control"):
        return False
    try:
        with open("/proc/filesystems") as f:
            return "\terofs" in f.read()
    except OSError:
        return False


requires_erofs = pytest.mark.skipif(
    not _mount_available(), reason="need root + loop devices + erofs kernel driver"
)


def _losetup(path: str) -> str:
    return subprocess.run(["losetup", "--find", "--show", "--read-only", path],
                          capture_output=True, text=True, check=True).stdout.strip()


class _Mounted:
    """losetup + mount -t erofs (optionally -o device=<blob loop>)."""

    def __init__(self, image_path: str, mountpoint: str, blob_path: str = ""):
        self.image_path, self.mountpoint, self.blob_path = image_path, mountpoint, blob_path
        self.loops: list[str] = []

    def __enter__(self):
        self.loops.append(_losetup(self.image_path))
        opts = b""
        if self.blob_path:
            self.loops.append(_losetup(self.blob_path))
            opts = f"device={self.loops[1]}".encode()
        libc = ctypes.CDLL("libc.so.6", use_errno=True)
        if libc.mount(self.loops[0].encode(), self.mountpoint.encode(), b"erofs", 1, opts) != 0:
            err = os.strerror(ctypes.get_errno())
            for lo in self.loops:
                subprocess.run(["losetup", "-d", lo], check=False)
            raise RuntimeError(f"mount -t erofs failed: {err}")
        return self

    def __exit__(self, *exc):
        ctypes.CDLL("libc.so.6", use_errno=True).umount2(self.mountpoint.encode(), 2)
        for lo in self.loops:
            subprocess.run(["losetup", "-d", lo], check=False)


def _mount(tmp_path, img: bytes, blob: bytes = b""):
    image_path = str(tmp_path / "img.erofs")
    with open(image_path, "wb") as f:
        f.write(img)
    blob_path = ""
    if blob:
        blob_path = str(tmp_path / "layer.tar")
        with open(blob_path, "wb") as f:
            f.write(blob + b"\0" * (-len(blob) % 512))
    mp = str(tmp_path / "mnt")
    os.mkdir(mp)
    return _Mounted(image_path, mp, blob_path), mp


def _read(mp, rel) -> bytes:
    with open(os.path.join(mp, rel), "rb") as f:
        return f.read()


@requires_erofs
class TestKernelMount:
    def test_mount_walk_byte_for_byte(self, tmp_path):
        m, mp = _mount(tmp_path, terofs.build_erofs(sample_entries(PKG["port"])))
        with m:
            assert _read(mp, "etc/hosts") == b"127.0.0.1 localhost\n"
            assert _read(mp, "bin/app") == BIG == _read(mp, "bin/hard")
            assert os.readlink(os.path.join(mp, "bin/link")) == "app"
            assert os.stat(os.path.join(mp, "bin/app")).st_nlink == 2
            assert _read(mp, "deep/a/b/leaf") == b"leaf-data"
            assert sorted(os.listdir(mp)) == ["bin", "deep", "etc"]

    def test_mount_600_entry_directory(self, tmp_path):
        m, mp = _mount(tmp_path, IMAGES["dir_600"](PKG["port"], tmp_path))
        with m:
            assert len(os.listdir(os.path.join(mp, "d"))) == 600
            for i in (0, 1, 299, 300, 598, 599):
                assert _read(mp, f"d/file-{i:04d}") == b"%d" % i

    def test_converted_layer_to_erofs_mount(self, tmp_path):
        m, mp = _mount(tmp_path, _converted_layer_image(PKG["port"]))
        with m:
            assert _read(mp, "app/data.bin") == payload(90_000, 8)

    def test_tar_is_the_data_plane(self, tmp_path):
        m, mp = _mount(tmp_path, _chunked_image(PKG["port"]), CHUNKED_TAR)
        with m:
            assert _read(mp, "app/small.txt") == b"tarfs says hi\n"
            assert _read(mp, "app/big.bin") == payload(2_500_000, 7)

    def test_tarfs_bootstrap_to_kernel_mount(self, tmp_path):
        m, mp = _mount(tmp_path, IMAGES["tarfs_export"](PKG["port"], tmp_path), TARFS_TAR)
        with m:
            assert _read(mp, "usr/lib/libbig.so") == payload(600_000, 5)
            assert _read(mp, "usr/hello") == b"tarfs-hello\n"
            assert os.readlink(os.path.join(mp, "usr/ln")) == "hello"

    def test_xattrs_visible_through_kernel(self, tmp_path):
        m, mp = _mount(tmp_path, IMAGES["xattrs"](PKG["port"], tmp_path))
        with m:
            assert os.getxattr(os.path.join(mp, "opq"), "trusted.overlay.opaque") == b"y"
            assert os.getxattr(os.path.join(mp, "tagged"), "user.color") == b"blue"
            assert _read(mp, "tagged") == b"data"

    def test_tarfs_opaque_dirs_export(self, tmp_path):
        m, mp = _mount(tmp_path, IMAGES["tarfs_opaque"](PKG["port"], tmp_path), OPAQUE_TAR)
        with m:
            assert os.getxattr(os.path.join(mp, "d"), "trusted.overlay.opaque") == b"y"
            assert _read(mp, "d/keep") == b"keep"

    def test_whole_image_disk_mounts_alone(self, tmp_path):
        m, mp = _mount(tmp_path, _disk(PKG["port"], tmp_path))
        with m:  # single device, no -o device=
            assert _read(mp, "data/blob.bin") == payload(300_000, 6)
            assert _read(mp, "data/note") == b"hello"

    def test_two_erofs_layers_under_overlayfs(self, tmp_path):
        """overlayfs over two kernel-mounted port images: upper wins, the
        whiteout deletes, the opaque directory hides the lower's files."""
        mounts, lowers = [], []
        libc = ctypes.CDLL("libc.so.6", use_errno=True)
        try:
            for i, entries in enumerate(_overlay_entries(PKG["port"])):
                d = tmp_path / f"l{i}"
                d.mkdir()
                m, mp = _mount(d, terofs.build_erofs(entries))
                m.__enter__()
                mounts.append(m)
                lowers.append(mp)
            merged = str(tmp_path / "merged")
            os.mkdir(merged)
            opts = f"lowerdir={lowers[1]}:{lowers[0]}".encode()
            assert libc.mount(b"overlay", merged.encode(), b"overlay", 1, opts) == 0, \
                os.strerror(ctypes.get_errno())
            try:
                assert _read(merged, "app/keep.txt") == b"from-lower"
                assert _read(merged, "app/replaced.txt") == b"new"
                assert not os.path.exists(os.path.join(merged, "app/deleted.txt"))
                assert sorted(os.listdir(os.path.join(merged, "shadowed"))) == ["fresh.txt"]
            finally:
                libc.umount2(merged.encode(), 2)
        finally:
            for m in mounts:
                m.__exit__(None, None, None)
