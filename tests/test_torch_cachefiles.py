"""The port's fscache ondemand daemon and FUSE wire protocol against the
JAX package's.

Every case of tests/test_cachefiles.py runs in both packages (``pkg``,
through ``ported_cases``; its meta-cookie case packs with the port's
``pack_layer`` on the host, ``device="cpu"``), and so do the three
``TestFuseProtocolLayouts`` cases of tests/test_utils_infra.py. The
kernel-gated ``TestKernelCachefilesE2E`` keeps the reference's skip
condition (no /dev/cachefiles).

Cross-package cases, on numpy-seeded inputs: the FUSE structs, opcodes
and packers are byte-identical; a ``FuseSession`` of each package answers
one seeded request stream (INIT, lookups, getattr, reads, readdir(plus),
xattrs, lseek, a write, an unknown opcode) with the same reply bytes over
a socket pair; the cachefiles daemons answer one message stream with the
same copen writes, READ_COMPLETE ioctls and object-file bytes; and each
``DaemonServer`` renders the same EROFS meta cookie, equal to
``erofs_from_rafs`` of the bootstrap.
"""

from __future__ import annotations

import importlib
import io
import json
import os
import socket
import stat
import struct
import tarfile
from types import SimpleNamespace

import numpy as np
import pytest

from tests.test_torch_fetch_sched import ROOTS, SIDES, other_package_still, ported_cases

ported_cases(
    "test_cachefiles",
    globals(),
    subs=(("pack_layer(buf.getvalue(), PackOption())", "pack_layer(buf.getvalue(), PackOption(), device=\"cpu\")"),),
)
ported_cases(
    "test_utils_infra",
    globals(),
    keep=("from nydus_snapshotter_tpu.utils import native_build, retry",),
    only=(
        "TestFuseProtocolLayouts::test_header_sizes",
        "TestFuseProtocolLayouts::test_opcode_values_match_kernel",
        "TestFuseProtocolLayouts::test_attr_pack_roundtrip",
    ),
)
_other_package_still = other_package_still()

MODULES = {
    "protocol": "fusedev.protocol",
    "session": "fusedev.session",
    "cachefiles": "daemon.cachefiles",
    "server": "daemon.server",
    "erofs": "models.erofs_image",
    "real": "models.nydus_real",
}
PKG = {
    side: SimpleNamespace(**{k: importlib.import_module(f"{ROOTS[side]}.{m}") for k, m in MODULES.items()})
    for side in SIDES
}
REF, PORT = PKG["ref"], PKG["port"]


# ------------------------------------------------------------------ images


def _tree(seed: int) -> dict:
    """A numpy-seeded tree: dirs, regular files of several chunks, a
    symlink, a hardlink and an xattr-free layout the daemon serves."""
    rng = np.random.default_rng(seed)
    files = {}
    for i in range(6):
        d = f"d{i % 3}"
        n = int(rng.integers(0, 40_000)) if i else 0
        files[f"{d}/f{i}"] = rng.integers(0, 256, n, dtype=np.uint8).tobytes()
    return files


def _tar(files: dict) -> bytes:
    buf = io.BytesIO()
    with tarfile.open(fileobj=buf, mode="w", format=tarfile.GNU_FORMAT) as tf:
        for d in sorted({p.split("/")[0] for p in files}):
            ti = tarfile.TarInfo(d)
            ti.type = tarfile.DIRTYPE
            ti.mode = 0o755
            tf.addfile(ti)
        for path, data in files.items():
            ti = tarfile.TarInfo(path)
            ti.size = len(data)
            ti.mode = 0o644
            ti.mtime = 1_700_000_000
            tf.addfile(ti, io.BytesIO(data))
        ti = tarfile.TarInfo("d0/link")
        ti.type = tarfile.SYMTYPE
        ti.linkname = "f0"
        tf.addfile(ti)
        ti = tarfile.TarInfo("d1/hard")
        ti.type = tarfile.LNKTYPE
        ti.linkname = "d1/f1"
        tf.addfile(ti)
    return buf.getvalue()


@pytest.fixture(scope="module")
def image(tmp_path_factory):
    """One image in a blob dir: the reference packs it (the port's packs
    are held byte-identical in tests/test_torch_pack.py)."""
    from nydus_snapshotter_tpu.converter.convert import Merge, blob_data_from_layer_blob, pack_layer
    from nydus_snapshotter_tpu.converter.types import MergeOption, PackOption

    files = _tree(19)
    tar = _tar(files)
    blob, res = pack_layer(tar, PackOption(chunk_size=0x1000, backend="numpy", compressor="lz4_block"))
    d = tmp_path_factory.mktemp("cf-image")
    (d / res.blob_id).write_bytes(blob_data_from_layer_blob(blob))
    boot = d / "image.boot"
    boot.write_bytes(Merge([blob], MergeOption()).bootstrap)
    return SimpleNamespace(files=files, tar=tar, blob_dir=str(d), boot=str(boot), blob_id=res.blob_id)


# ------------------------------------------------------------ FUSE structs


def _structs(mod) -> dict:
    return {k: v.format for k, v in vars(mod).items() if isinstance(v, struct.Struct)}


def _ints(mod) -> dict:
    return {k: v for k, v in vars(mod).items() if k.isupper() and isinstance(v, (int, frozenset))}


def test_fuse_protocol_tables_equal():
    assert _structs(PORT.protocol) == _structs(REF.protocol)
    assert _ints(PORT.protocol) == _ints(REF.protocol)
    assert len(_structs(PORT.protocol)) >= 15


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_fuse_packers_byte_identical(seed):
    rng = np.random.default_rng(seed)
    for _ in range(50):
        kw = dict(
            ino=int(rng.integers(1, 1 << 40)), size=int(rng.integers(0, 1 << 40)),
            mode=int(rng.choice([0o100644, 0o40755, 0o120777])), nlink=int(rng.integers(1, 9)),
            uid=int(rng.integers(0, 70000)), gid=int(rng.integers(0, 70000)),
            rdev=int(rng.integers(0, 1 << 20)), mtime=int(rng.integers(0, 1 << 33)),
            blksize=4096,
        )
        assert PORT.protocol.pack_attr(**kw) == REF.protocol.pack_attr(**kw)
        name = bytes(rng.integers(97, 123, int(rng.integers(1, 40)), dtype=np.uint8))
        args = (int(rng.integers(1, 1 << 30)), int(rng.integers(0, 1000)), name, int(rng.integers(0, 16)))
        assert PORT.protocol.pack_dirent(*args) == REF.protocol.pack_dirent(*args)


def _requests(p, bs, seed: int) -> list[bytes]:
    """One seeded FUSE request stream over ``bs``'s inodes."""
    rng = np.random.default_rng(seed)
    reqs = []
    unique = [0]

    def req(opcode, nodeid, body=b""):
        unique[0] += 1
        hdr = p.IN_HEADER.pack(p.IN_HEADER.size + len(body), opcode, unique[0], nodeid, 0, 0, 1, 0)
        reqs.append(hdr + body)

    req(p.INIT, 0, p.INIT_IN_PREFIX.pack(7, 38, 1 << 20, 0) + b"\0" * 48)
    for inode in bs.inodes:
        if inode.path != "/":
            req(p.LOOKUP, inode.parent_ino, inode.path.rsplit("/", 1)[1].encode() + b"\0")
        req(p.GETATTR, inode.ino, p.GETATTR_IN.pack(0, 0, 0))
        req(p.OPEN, inode.ino, b"\0" * 8)
        if stat.S_ISLNK(inode.mode):
            req(p.READLINK, inode.ino)
        if stat.S_ISDIR(inode.mode):
            for op in (p.READDIR, p.READDIRPLUS):
                for off in (0, 1, 3):
                    req(op, inode.ino, p.READ_IN.pack(0, off, int(rng.integers(64, 4096)), 0, 0, 0, 0))
        else:
            req(p.READ, inode.ino, p.READ_IN.pack(0, 0, inode.size + 1, 0, 0, 0, 0))
            for _ in range(3):
                off = int(rng.integers(0, inode.size + 2))
                req(p.READ, inode.ino, p.READ_IN.pack(0, off, int(rng.integers(1, 70_000)), 0, 0, 0, 0))
            for whence in (3, 4, 0):
                req(p.LSEEK, inode.ino, p.LSEEK_IN.pack(0, int(rng.integers(0, inode.size + 2)), whence, 0))
        req(p.GETXATTR, inode.ino, p.GETXATTR_IN.pack(0, 0) + b"user.x\0")
        req(p.LISTXATTR, inode.ino, p.GETXATTR_IN.pack(int(rng.integers(0, 64)), 0))
    req(p.LOOKUP, 1, b"no-such-name\0")
    req(p.GETATTR, 999_999, p.GETATTR_IN.pack(0, 0, 0))
    req(p.STATFS, 1)
    req(p.WRITE, 2, b"\0" * 40)
    req(p.MKDIR, 1, b"\0" * 8 + b"x\0")
    req(99, 1)
    req(p.FORGET, 2, b"\0" * 8)
    return reqs


def _session_replies(pkg, image, seed: int) -> list[bytes]:
    with open(image.boot, "rb") as f:
        bs = pkg.real.load_any_bootstrap(f.read())
    inst = pkg.server._Instance("/fuse-replies", image.boot, "{}")
    ops = pkg.session.RafsFuseOps(bs, lambda path, off, size: inst.read(path, off, size, image.blob_dir))
    sess = pkg.session.FuseSession(ops, "/fuse-replies")
    ours, theirs = socket.socketpair(socket.AF_UNIX, socket.SOCK_SEQPACKET)
    theirs.settimeout(5)
    sess.fd = ours.fileno()
    out = []
    try:
        for r in _requests(pkg.protocol, bs, seed):
            sess._dispatch(r)
            opcode = pkg.protocol.IN_HEADER.unpack_from(r)[1]
            if opcode != pkg.protocol.FORGET:
                out.append(theirs.recv(1 << 20))
    finally:
        sess.fd = -1
        ours.close()
        theirs.close()
        inst.close()
    return out


@pytest.mark.parametrize("seed", [5, 6])
def test_fuse_session_replies_byte_identical(image, seed):
    ref = _session_replies(REF, image, seed)
    port = _session_replies(PORT, image, seed)
    assert len(port) == len(ref) > 100
    for i, (a, b) in enumerate(zip(port, ref)):
        assert a == b, f"reply {i} differs"
    # the whole-file reads carry the tree's bytes
    payloads = {r[16:] for r in ref}
    assert all(data in payloads for data in image.files.values() if data)


# ------------------------------------------------------------- cachefiles


class _Capture:
    def __init__(self):
        self.writes, self.ioctls = [], []

    def write(self, b):
        self.writes.append(bytes(b))
        return len(b)

    def ioctl(self, fd, req, arg):
        self.ioctls.append((req, arg))

    def close(self):
        pass


def _cf_stream(cf, blob: bytes, seed: int, tmp) -> tuple[list[bytes], dict[int, str], list[tuple]]:
    """Three OPENs (the third of an unknown cookie), twelve seeded READs
    of the first two objects, one CLOSE."""
    rng = np.random.default_rng(seed)
    msgs, paths, reads = [], {}, []
    msg_id = 0
    for obj in range(1, 4):
        msg_id += 1
        path = os.path.join(tmp, f"obj{obj}")
        fd = os.open(path, os.O_RDWR | os.O_CREAT | os.O_TRUNC)
        paths[obj] = path
        cookie = b"blob" if obj != 3 else b"unknown"
        payload = cf._OPEN_HDR.pack(3, len(cookie) + 1, fd, 0) + b"vk\0" + cookie + b"\0"
        msgs.append(cf._MSG_HDR.pack(msg_id, obj, cf.OP_OPEN, 16 + len(payload)) + payload)
    for _ in range(12):
        msg_id += 1
        obj = int(rng.integers(1, 3))
        off = int(rng.integers(0, len(blob) + 100))
        ln = int(rng.integers(1, 40_000))
        reads.append((obj, off, ln))
        msgs.append(cf._MSG_HDR.pack(msg_id, obj, cf.OP_READ, 32) + cf._READ_REQ.pack(off, ln))
    msg_id += 1
    msgs.append(cf._MSG_HDR.pack(msg_id, 2, cf.OP_CLOSE, 16))
    return msgs, paths, reads


@pytest.mark.parametrize("seed", [7, 8])
def test_cachefiles_answers_byte_identical(tmp_path, seed):
    blob = np.random.default_rng(seed).integers(0, 256, 100_000, dtype=np.uint8).tobytes()
    got = {}
    for side in SIDES:
        cf = PKG[side].cachefiles
        d = tmp_path / side
        d.mkdir()

        def resolver(key):
            if key != "blob":
                raise KeyError(key)
            return len(blob), lambda off, ln: blob[off : off + ln]

        dev = _Capture()
        daemon = cf.CachefilesOndemandDaemon(resolver, device=dev)
        msgs, paths, reads = _cf_stream(cf, blob, seed, str(d))
        for m in msgs:
            daemon.handle_msg(m)
        live = sorted(daemon.objects)
        daemon.stop()  # releases the objects' fds (the daemon owns them)
        files = {}
        for obj, path in paths.items():
            with open(path, "rb") as f:
                files[obj] = f.read()
        got[side] = (dev.writes, dev.ioctls, files, live)
    assert got["port"] == got["ref"]
    writes, ioctls, files, live = got["port"]
    assert writes == [b"copen 1,100000", b"copen 2,100000", b"copen 3,-2"]
    assert [arg for _req, arg in ioctls] == list(range(4, 16)) and live == [1]
    want = {1: bytearray(), 2: bytearray(), 3: bytearray()}
    for obj, off, ln in reads:
        end = min(off + ln, len(blob))
        if end > off:
            buf = want[obj]
            buf.extend(b"\0" * max(0, end - len(buf)))
            buf[off:end] = blob[off:end]
    assert files == {k: bytes(v) for k, v in want.items()}


@pytest.mark.parametrize("side", SIDES)
def test_meta_cookie_equals_erofs_from_rafs(tmp_path, image, monkeypatch, side):
    """Each package's daemon renders a bind's metadata_path as the
    reference's ``erofs_from_rafs`` does (a tarfs bootstrap: EROFS export
    needs identity-mapped chunks), refuses the compressed image's meta
    cookie in both packages alike, and a READ window of the data cookie
    equals the blob's bytes."""
    from nydus_snapshotter_tpu.tarfs.bootstrap import tarfs_bootstrap_from_tar

    p = PKG[side]
    tarfs_boot = tmp_path / "tarfs.boot"
    tarfs_boot.write_bytes(tarfs_bootstrap_from_tar(io.BytesIO(image.tar), "ab" * 32).to_bytes())
    monkeypatch.setattr(p.cachefiles, "supported", lambda: False)
    srv = p.server.DaemonServer(f"cf-{side}", str(tmp_path / "api.sock"), workdir=str(tmp_path))
    for fsid, meta in (("fsid-19", str(tarfs_boot)), ("fsid-20", image.boot)):
        srv.bind_blob(json.dumps({
            "id": image.blob_id, "metadata_path": meta, "fscache_id": fsid,
            "device": {"backend": {"type": "localfs", "config": {"blob_dir": image.blob_dir}}},
        }))
    size, reader, _ = srv._resolve_cachefiles_cookie("fsid-19")
    want = REF.erofs.erofs_from_rafs(REF.real.load_any_bootstrap(tarfs_boot.read_bytes()))
    assert size == len(want) and reader(0, size) == want
    with pytest.raises(p.erofs.ErofsError, match="identity-mapped"):
        srv._resolve_cachefiles_cookie("fsid-20")
    size, reader, closer = srv._resolve_cachefiles_cookie(image.blob_id)
    with open(os.path.join(image.blob_dir, image.blob_id), "rb") as f:
        blob = f.read()
    assert size == len(blob) and reader(1000, 5000) == blob[1000:6000]
    closer()
