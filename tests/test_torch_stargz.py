"""The port's stargz package against the JAX package's: the footer, TOC
reads, the TOC -> bootstrap build and the adaptor.

Every case of tests/test_stargz.py runs in both packages (``pkg``), on
the synthetic eStargz blobs its ``build_estargz`` makes. Cross-package
cases feed both packages the same numpy-seeded trees and hold equal: the
parsed footers and TOCs, ``parse_toc``'s entries, ``bootstrap_from_toc``
bytes, the adaptor's per-layer files and merged ``image.boot``; a
hypothesis case builds random trees through both.
"""

from __future__ import annotations

import hashlib
import importlib
import json
import os
import stat
from types import SimpleNamespace

import numpy as np
import pytest
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from tests.test_remote import FakeRegistry
from tests.test_stargz import _footer, _gzip_member, build_estargz

SIDES = ("ref", "port")
ROOTS = {"ref": "nydus_snapshotter_tpu", "port": "nydus_snapshotter_tpu_torch"}
MODULES = {
    "C": "constants",
    "stargz": "stargz",
    "resolver": "stargz.resolver",
    "index": "stargz.index",
    "bootstrap": "models.bootstrap",
    "transport": "remote.transport",
}


def _load(side: str) -> SimpleNamespace:
    ns = SimpleNamespace(side=side)
    for attr, mod in MODULES.items():
        setattr(ns, attr, importlib.import_module(f"{ROOTS[side]}.{mod}"))
    return ns


PKG = {side: _load(side) for side in SIDES}
REF, PORT = PKG["ref"], PKG["port"]


@pytest.fixture(params=SIDES)
def pkg(request):
    return PKG[request.param]


def mem_blob(pkg, raw: bytes, digest: str = "", ref: str = "example.com/repo:tag"):
    digest = digest or "sha256:" + hashlib.sha256(raw).hexdigest()
    return pkg.stargz.Blob(ref, digest, lambda off, ln: raw[off : off + ln], len(raw))


def np_files(seed: int, n: int) -> dict[str, bytes]:
    rng = np.random.default_rng(seed)
    return {f"opt/s{seed}/p{i % 5}/f{i:03d}": rng.integers(0, 256, int(rng.integers(0, 9000)),
                                                     dtype=np.uint8).tobytes()
            for i in range(n)}


# ---------------------------------------------------------------------------
# footer / TOC (test_stargz.TestFooter)
# ---------------------------------------------------------------------------


class TestFooter:
    def test_legacy_footer_roundtrip(self, pkg):
        off, ok = pkg.stargz.parse_footer(_footer(0xDEAD, legacy=True))
        assert ok and off == 0xDEAD

    def test_estargz_footer_roundtrip(self, pkg):
        off, ok = pkg.stargz.parse_footer(_footer(0xBEEF, legacy=False))
        assert ok and off == 0xBEEF

    def test_plain_gzip_is_not_a_footer(self, pkg):
        _, ok = pkg.stargz.parse_footer(_gzip_member(b"data"))
        assert not ok

    def test_garbage_is_not_a_footer(self, pkg):
        _, ok = pkg.stargz.parse_footer(b"\x00" * pkg.stargz.FOOTER_SIZE)
        assert not ok

    @pytest.mark.parametrize("legacy", [True, False])
    def test_blob_toc_offset(self, pkg, legacy):
        raw = build_estargz({"etc/hosts": b"localhost\n"}, legacy_footer=legacy)
        off = mem_blob(pkg, raw).get_toc_offset()
        assert 0 < off < len(raw)

    def test_read_toc(self, pkg):
        raw = build_estargz({"bin/sh": b"#!/bin/sh\n", "etc/os": b"linux"})
        toc = json.loads(mem_blob(pkg, raw).read_toc())
        names = [e["name"] for e in toc["entries"]]
        assert "bin/sh" in names and "etc/os" in names

    def test_non_stargz_blob_raises(self, pkg):
        with pytest.raises(pkg.stargz.StargzError):
            mem_blob(pkg, b"not a stargz blob at all, too short" * 4).get_toc_offset()


# ---------------------------------------------------------------------------
# TOC -> bootstrap (test_stargz.TestIndexBuild)
# ---------------------------------------------------------------------------


class TestIndexBuild:
    def toc(self, pkg, files):
        raw = build_estargz(files)
        return json.loads(mem_blob(pkg, raw).read_toc()), raw

    def test_bootstrap_paths_and_digests(self, pkg):
        files = {"etc/hosts": b"localhost\n", "usr/bin/true": b"\x7fELF"}
        toc, raw = self.toc(pkg, files)
        bs = pkg.stargz.bootstrap_from_toc(toc, "ab" * 32, blob_compressed_size=len(raw))
        paths = {i.path for i in bs.inodes}
        assert {"/", "/etc", "/etc/hosts", "/usr", "/usr/bin", "/usr/bin/true"} <= paths
        assert len(bs.chunks) == 2
        assert hashlib.sha256(b"localhost\n").digest() in {c.digest for c in bs.chunks}
        assert all(c.flags & pkg.C.COMPRESSOR_GZIP for c in bs.chunks)

    def test_compressed_sizes_from_offset_deltas(self, pkg):
        toc, raw = self.toc(pkg, {"a": b"A" * 100, "b": b"B" * 200})
        bs = pkg.stargz.bootstrap_from_toc(toc, "cd" * 32, blob_compressed_size=len(raw))
        by_off = sorted(bs.chunks, key=lambda c: c.compressed_offset)
        assert by_off[0].compressed_size == by_off[1].compressed_offset - by_off[0].compressed_offset
        assert by_off[1].compressed_size > 0

    def test_special_entries(self, pkg):
        toc = {"version": 1, "entries": [
            {"name": "dev", "type": "dir", "mode": 0o755},
            {"name": "dev/null", "type": "char", "mode": 0o666, "devMajor": 1, "devMinor": 3},
            {"name": "lnk", "type": "symlink", "linkName": "dev/null", "mode": 0o777},
            {"name": "fifo", "type": "fifo", "mode": 0o600},
        ]}
        bs = pkg.stargz.bootstrap_from_toc(toc, "ef" * 32)
        by_path = {i.path: i for i in bs.inodes}
        assert by_path["/dev/null"].rdev == os.makedev(1, 3)
        assert by_path["/lnk"].symlink_target == "dev/null"

    def test_go_mode_setuid_translated(self, pkg):
        toc = {"version": 1, "entries": [{
            "name": "usr/bin/sudo", "type": "reg", "size": 4, "offset": 0,
            "mode": (1 << 23) | 0o755, "chunkDigest": "sha256:" + "a" * 64}]}
        bs = pkg.stargz.bootstrap_from_toc(toc, "bb" * 32)
        sudo = next(i for i in bs.inodes if i.path == "/usr/bin/sudo")
        assert sudo.mode & stat.S_ISUID
        assert stat.S_IMODE(sudo.mode) == 0o4755

    def test_chunked_file(self, pkg):
        toc = {"version": 1, "entries": [
            {"name": "big", "type": "reg", "size": 8 << 20, "offset": 0, "chunkSize": 4 << 20,
             "chunkDigest": "sha256:" + "0" * 64},
            {"name": "big", "type": "chunk", "offset": 1000, "chunkOffset": 4 << 20,
             "chunkSize": 4 << 20, "chunkDigest": "sha256:" + "1" * 64},
        ]}
        bs = pkg.stargz.bootstrap_from_toc(toc, "aa" * 32)
        big = next(i for i in bs.inodes if i.path == "/big")
        assert big.chunk_count == 2
        assert bs.chunks[1].uncompressed_offset == 4 << 20

    def test_serialized_roundtrip(self, pkg):
        toc, raw = self.toc(pkg, {"x/y/z": b"payload"})
        bs = pkg.stargz.bootstrap_from_toc(toc, "12" * 32, blob_compressed_size=len(raw))
        again = pkg.bootstrap.Bootstrap.from_bytes(bs.to_bytes())
        assert {i.path for i in again.inodes} == {i.path for i in bs.inodes}
        assert again.chunks[0].digest == bs.chunks[0].digest

    def test_bad_version_rejected(self, pkg):
        with pytest.raises(Exception):
            pkg.stargz.bootstrap_from_toc({"version": 2, "entries": []}, "ab" * 32)


# ---------------------------------------------------------------------------
# adaptor (test_stargz.TestAdaptor)
# ---------------------------------------------------------------------------


def _snap(ids):
    return type("Snap", (), {"parent_ids": ids})()


class TestAdaptor:
    def _adaptor(self, pkg, tmp_path):
        snapdir, cache = tmp_path / "snapshots", tmp_path / "cache"
        snapdir.mkdir()
        cache.mkdir()
        return pkg.stargz.StargzAdaptor(lambda sid: str(snapdir / sid / "fs"), cache_dir=str(cache)), \
            snapdir, cache

    def test_prepare_writes_bootstrap_toc_and_meta(self, pkg, tmp_path):
        adaptor, snapdir, cache = self._adaptor(pkg, tmp_path)
        blob = mem_blob(pkg, build_estargz({"app/run.sh": b"echo hi\n"}))
        hexd = blob.digest.split(":")[1]
        storage = snapdir / "1" / "fs"
        storage.mkdir(parents=True)
        adaptor.prepare_meta_layer(blob, str(storage), {})
        assert (storage / hexd).exists()
        assert (storage / pkg.stargz.TOC_FILENAME).exists()
        assert (cache / f"{hexd}.blob.meta").exists()
        bs = pkg.bootstrap.Bootstrap.from_bytes((storage / hexd).read_bytes())
        assert "/app/run.sh" in {i.path for i in bs.inodes}

    def test_prepare_is_idempotent(self, pkg, tmp_path):
        adaptor, snapdir, _ = self._adaptor(pkg, tmp_path)
        blob = mem_blob(pkg, build_estargz({"f": b"data"}))
        storage = snapdir / "1" / "fs"
        storage.mkdir(parents=True)
        adaptor.prepare_meta_layer(blob, str(storage), {})
        first = (storage / blob.digest.split(":")[1]).read_bytes()
        adaptor.prepare_meta_layer(blob, str(storage), {})
        assert (storage / blob.digest.split(":")[1]).read_bytes() == first

    def test_merge_two_layers(self, pkg, tmp_path):
        adaptor, snapdir, _ = self._adaptor(pkg, tmp_path)
        for sid, files in {"2": {"etc/lower": b"lower data"}, "1": {"etc/upper": b"upper data"}}.items():
            storage = snapdir / sid / "fs"
            storage.mkdir(parents=True)
            adaptor.prepare_meta_layer(mem_blob(pkg, build_estargz(files)), str(storage), {})
        adaptor.merge_meta_layer(_snap(["1", "2"]))
        merged = snapdir / "1" / "fs" / "image.boot"
        bs = pkg.bootstrap.Bootstrap.from_bytes(merged.read_bytes())
        paths = {i.path for i in bs.inodes}
        assert "/etc/lower" in paths and "/etc/upper" in paths
        assert len(bs.blobs) == 2

    def test_merge_single_layer_copies(self, pkg, tmp_path):
        adaptor, snapdir, _ = self._adaptor(pkg, tmp_path)
        storage = snapdir / "9" / "fs"
        storage.mkdir(parents=True)
        adaptor.prepare_meta_layer(mem_blob(pkg, build_estargz({"only": b"one"})), str(storage), {})
        adaptor.merge_meta_layer(_snap(["9"]))
        assert (storage / "image.boot").exists()

    def test_merge_missing_bootstrap_raises(self, pkg, tmp_path):
        adaptor, snapdir, _ = self._adaptor(pkg, tmp_path)
        (snapdir / "5" / "fs").mkdir(parents=True)
        with pytest.raises(Exception):
            adaptor.merge_meta_layer(_snap(["5"]))


def test_resolver_get_blob_live(pkg):
    """``Resolver.get_blob`` against the fake registry: the footer checked
    at resolve time, the TOC read over HTTP ranges, a plain layer refused."""
    reg = FakeRegistry(require_auth=False)
    try:
        raw = build_estargz({"etc/app.conf": b"key=val\n"})
        digest = reg.add_blob(raw)
        plain = reg.add_blob(b"just a plain layer " * 100)
        resolver = pkg.resolver.Resolver(pool=pkg.transport.Pool(plain_http=True))
        ref = f"{reg.host}/library/app:latest"
        blob = resolver.get_blob(ref, digest)
        assert blob.size == len(raw)
        toc = json.loads(blob.read_toc())
        assert any(e["name"] == "etc/app.conf" for e in toc["entries"])
        with pytest.raises(pkg.stargz.StargzError):
            resolver.get_blob(ref, plain)
    finally:
        reg.close()


def test_blob_size_probe(pkg):
    class FakeResp:
        headers = {"content-range": "bytes 0-0/12345"}

        def read(self):
            return b"x"

        def close(self):
            pass

    class FakeClient:
        def fetch_blob(self, repo, digest, byte_range=None):
            assert byte_range == (0, 0)
            return FakeResp()

    assert pkg.resolver._blob_size(FakeClient(), "library/app", "sha256:" + "0" * 64) == 12345


# ---------------------------------------------------------------------------
# Cross-package: the same numpy-seeded trees through both packages
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("legacy", [True, False])
def test_footers_and_tocs_equal(legacy):
    raw = build_estargz(np_files(3, 40), legacy_footer=legacy)
    blobs = {side: mem_blob(PKG[side], raw) for side in SIDES}
    tail = raw[-REF.stargz.ESTARGZ_FOOTER_SIZE:]
    assert PORT.stargz.parse_footer(tail) == REF.stargz.parse_footer(tail)
    assert blobs["port"].get_toc_offset() == blobs["ref"].get_toc_offset()
    assert blobs["port"].read_toc() == blobs["ref"].read_toc()
    toc = blobs["port"].toc()
    assert toc == blobs["ref"].toc()
    ref_entries = [vars(e) for e in REF.index.parse_toc(toc)]
    assert [vars(e) for e in PORT.index.parse_toc(toc)] == ref_entries and ref_entries


@pytest.mark.parametrize("chunk_size", [0x1000, 0x10000, PORT.index.DEFAULT_CHUNK_SIZE])
def test_bootstrap_from_toc_bytes_equal(chunk_size):
    files = np_files(5, 60)
    raw = build_estargz(files)
    toc = json.loads(mem_blob(REF, raw).read_toc())
    kw = dict(chunk_size=chunk_size, blob_compressed_size=len(raw))
    ref = REF.stargz.bootstrap_from_toc(toc, "ab" * 32, **kw).to_bytes()
    assert PORT.stargz.bootstrap_from_toc(toc, "ab" * 32, **kw).to_bytes() == ref


def test_adaptor_files_and_merge_equal(tmp_path):
    """Three layers through both adaptors: every file each writes (the
    bootstrap, the TOC, the blob meta) and the merged ``image.boot`` equal."""
    layers = [build_estargz(np_files(11 + i, 30)) for i in range(3)]
    out = {}
    for side in SIDES:
        p = PKG[side]
        snapdir, cache = tmp_path / side / "snap", tmp_path / side / "cache"
        adaptor = p.stargz.StargzAdaptor(lambda sid, d=snapdir: str(d / sid / "fs"), cache_dir=str(cache))
        for i, raw in enumerate(layers):
            adaptor.prepare_meta_layer(mem_blob(p, raw), str(snapdir / str(3 - i) / "fs"), {})
        adaptor.merge_meta_layer(_snap(["1", "2", "3"]))
        out[side] = {str(f.relative_to(tmp_path / side)): f.read_bytes()
                     for f in sorted((tmp_path / side).rglob("*")) if f.is_file()}
    assert out["port"] == out["ref"]
    assert "snap/1/fs/image.boot" in out["port"]
    bs = PORT.bootstrap.Bootstrap.from_bytes(out["port"]["snap/1/fs/image.boot"])
    assert len(bs.blobs) == 3


@settings(max_examples=25, deadline=None, derandomize=True,
          suppress_health_check=[HealthCheck.too_slow])
@given(st.dictionaries(st.from_regex(r"[a-z]{1,6}(/[a-z0-9]{1,6}){0,2}", fullmatch=True),
                       st.binary(max_size=3000), min_size=1, max_size=12),
       st.booleans())
def test_random_trees_equal(files, legacy):
    # a path that is also another's directory is not a tree
    names = set(files)
    files = {k: v for k, v in files.items() if not any(n.startswith(k + "/") for n in names)}
    raw = build_estargz(files, legacy_footer=legacy)
    toc = {side: json.loads(mem_blob(PKG[side], raw).read_toc()) for side in SIDES}
    assert toc["port"] == toc["ref"]
    boot = {side: PKG[side].stargz.bootstrap_from_toc(toc[side], "cd" * 32, chunk_size=0x1000,
                                                      blob_compressed_size=len(raw)).to_bytes()
            for side in SIDES}
    assert boot["port"] == boot["ref"]


def test_chip_smoke_estargz_layer_is_build_estargz():
    """chip_smoke.py's phase 20 builds its eStargz layer with a copy of
    ``build_estargz`` (it may not import this test package): the same
    bytes, its members compressed on threads."""
    import chip_smoke

    files = np_files(21, 25)
    assert chip_smoke.estargz_blob(files) == build_estargz(files)
