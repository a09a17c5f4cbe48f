"""The port's soci package against the JAX package's: the gzip checkpoint
index, the zstd frame index, the zstd:chunked TOC, the indexed stream
readers, the format router and the adaptor.

Every portable case of tests/test_soci_formats.py and
tests/test_soci_backend.py runs in both packages (``pkg``): the readers
over a plain ``read_at`` and over the blob cache's ``CachedBlob.read_at``
(``daemon.blobcache``, ``daemon.fetch_sched``), the index artifacts
replicated through the peer tier (``daemon.peer``) and the cache
manager's accounting of the index companions (``cache.manager``).
``TestSociOverGrpc`` (the gRPC snapshotter) runs in
tests/test_torch_grpc_stargz.py beside the other snapshots-service twins.
``TestChaos::test_daemon_store_chaos_degrades_to_sequential`` reads through
each package's serving daemon (``daemon.server._Instance``). Cross-package
cases feed both
packages the same numpy-seeded layers and hold equal: the index files'
bytes, a file written by one package and loaded by the other, the
router's decisions, the parsed TOCs, the adaptor's bootstraps and merged
``image.boot``; a hypothesis case reads random ranges through both
packages' readers. The backward-read case pins the indexed reads of
OCIRef layers through ``BlobReader``: each read fetches the compressed
bytes of its checkpoint span or frames, not the stream from its start.
"""

from __future__ import annotations

import gzip
import hashlib
import importlib
import io
import os
import random
import shutil
import tarfile
import tempfile
import threading
from types import SimpleNamespace

import numpy as np
import pytest
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from tests.test_soci_backend import build_layer as backend_layer
from tests.test_soci_formats import build_layer as formats_layer
from tests.test_stargz import build_estargz

SIDES = ("ref", "port")
ROOTS = {"ref": "nydus_snapshotter_tpu", "port": "nydus_snapshotter_tpu_torch"}
MODULES = {
    "failpoint": "failpoint",
    "zran": "soci.zran",
    "index": "soci.index",
    "zframe": "soci.zframe",
    "zindex": "soci.zindex",
    "toc": "soci.toc",
    "blob": "soci.blob",
    "zblob": "soci.zblob",
    "router": "soci.router",
    "adaptor": "soci.adaptor",
    "soci": "soci",
    "sresolver": "stargz.resolver",
    "convert": "converter.convert",
    "types": "converter.types",
    "czran": "converter.zran",
    "zstd_ref": "converter.zstd_ref",
    "zstd": "utils.zstd",
    "bootstrap": "models.bootstrap",
    "blobcache": "daemon.blobcache",
    "fetch_sched": "daemon.fetch_sched",
    "peer": "daemon.peer",
    "cache_manager": "cache.manager",
    "server": "daemon.server",
}


def _load(side: str) -> SimpleNamespace:
    ns = SimpleNamespace(side=side)
    for attr, mod in MODULES.items():
        setattr(ns, attr, importlib.import_module(f"{ROOTS[side]}.{mod}"))
    return ns


PKG = {side: _load(side) for side in SIDES}
REF, PORT = PKG["ref"], PKG["port"]

pytestmark = pytest.mark.skipif(
    not (PORT.zframe.available() and PORT.zran.available()),
    reason="system libzstd with the frame API and libz with inflatePrime required",
)

FRAME_USIZE = 32 << 10
STRIDE = 128 << 10
ZBLOB_ID = "ef" * 32
GBLOB_ID = "ab" * 32


@pytest.fixture(params=SIDES)
def pkg(request):
    return PKG[request.param]


@pytest.fixture(autouse=True)
def _clear_failpoints():
    for p in PKG.values():
        p.failpoint.clear()
    yield
    for p in PKG.values():
        p.failpoint.clear()


def _reader_for(blob):
    return lambda o, s: blob[o : o + s]


def _other(pkg):
    return REF if pkg is PORT else PORT


# -------------------------------------------------------------- shared layers


@pytest.fixture(scope="module")
def zlayer():
    """tests/test_soci_formats.py's layer: (tar bytes, {path: content})."""
    return formats_layer()


@pytest.fixture(scope="module")
def seekable(zlayer):
    return REF.zframe.write_seekable(zlayer[0], frame_usize=FRAME_USIZE)


@pytest.fixture(scope="module")
def opaque(zlayer):
    return REF.zframe.write_frames(zlayer[0], frame_usize=FRAME_USIZE)


@pytest.fixture(scope="module")
def glayer():
    """tests/test_soci_backend.py's layer: (tar, gzip, {path: content})."""
    return backend_layer()


def np_tree(seed: int, n_files: int, lo: int = 100, hi: int = 6000) -> dict[str, bytes]:
    """A numpy-seeded tree: text-like and random files, sorted paths."""
    rng = np.random.default_rng(seed)
    files = {}
    for i in range(n_files):
        size = int(rng.integers(lo, hi))
        if i % 3:  # lowercase letters and spaces
            letters = rng.integers(0, 27, size)
            data = np.where(letters == 26, 0x20, letters + 0x61).astype(np.uint8).tobytes()
        else:
            data = rng.integers(0, 256, size, dtype=np.uint8).tobytes()
        files[f"srv/d{i % 7}/f{i:04d}.bin"] = data
    return files


def np_tar(files: dict[str, bytes]) -> bytes:
    buf = io.BytesIO()
    with tarfile.open(fileobj=buf, mode="w:", format=tarfile.GNU_FORMAT) as tf:
        for name, data in files.items():
            ti = tarfile.TarInfo(name)
            ti.size = len(data)
            ti.mtime = 0
            tf.addfile(ti, io.BytesIO(data))
    return buf.getvalue()


@pytest.fixture(scope="module")
def np_layers():
    """The cross-package layers, made once from numpy seeds: a tree, its
    tar, gzip (one member and four), seekable and opaque zstd,
    zstd:chunked and eStargz."""
    files = np_tree(17, 400)
    tar = np_tar(files)
    step = -(-len(tar) // 4)
    return SimpleNamespace(
        files=files,
        tar=tar,
        gzip=gzip.compress(tar, 6, mtime=0),
        gzip_mm=b"".join(gzip.compress(tar[i : i + step], 1, mtime=0)
                         for i in range(0, len(tar), step)),
        seekable=REF.zframe.write_seekable(tar, frame_usize=FRAME_USIZE),
        opaque=REF.zframe.write_frames(tar, frame_usize=FRAME_USIZE),
        chunked=REF.toc.write_zstd_chunked(files, chunk_size=FRAME_USIZE),
        estargz=build_estargz(files),
        single=REF.zstd.compress_block(tar),
    )


# ---------------------------------------------------------------------------
# FormatRouter (test_soci_formats.TestFormatRouter)
# ---------------------------------------------------------------------------


class TestFormatRouter:
    def _route(self, pkg, blob, **kw):
        return pkg.router.FormatRouter(**kw).route(_reader_for(blob), len(blob), record=False)

    def test_zstd_seekable_routes_seekable(self, pkg, seekable):
        d = self._route(pkg, seekable)
        assert (d.backend, d.format) == (pkg.router.BACKEND_SEEKABLE, pkg.router.FORMAT_ZSTD_SEEKABLE)

    def test_zstd_opaque_routes_seekable(self, pkg, opaque):
        d = self._route(pkg, opaque)
        assert (d.backend, d.format) == (pkg.router.BACKEND_SEEKABLE, pkg.router.FORMAT_ZSTD_OPAQUE)

    def test_zstd_chunked_routes_toc_adopt(self, pkg, zlayer):
        blob = pkg.toc.write_zstd_chunked({k.lstrip("/"): v for k, v in zlayer[1].items()},
                                          chunk_size=FRAME_USIZE)
        d = self._route(pkg, blob)
        assert (d.backend, d.format) == (pkg.router.BACKEND_TOC_ADOPT, pkg.router.FORMAT_ZSTD_CHUNKED)
        assert d.toc_location is not None

    def test_plain_gzip_routes_zran(self, pkg, zlayer):
        d = self._route(pkg, gzip.compress(zlayer[0], 6))
        assert (d.backend, d.format) == (pkg.router.BACKEND_ZRAN, pkg.router.FORMAT_GZIP)

    def test_estargz_routes_toc_adopt(self, pkg, zlayer):
        blob = build_estargz({k.lstrip("/"): v for k, v in zlayer[1].items()})
        d = self._route(pkg, blob)
        r = pkg.router
        assert (d.backend, d.format) == (r.BACKEND_TOC_ADOPT, r.FORMAT_ESTARGZ)
        assert d.costs[r.BACKEND_TOC_ADOPT] < d.costs[r.BACKEND_ZRAN]
        assert d.costs[r.BACKEND_TOC_ADOPT] < d.costs[r.BACKEND_RAFS]

    def test_unknown_magic_routes_rafs(self, pkg):
        d = self._route(pkg, b"\x00" * 4096)
        assert (d.backend, d.format) == (pkg.router.BACKEND_RAFS, pkg.router.FORMAT_UNKNOWN)

    def test_probe_is_two_small_ranged_reads(self, pkg, seekable):
        calls = []

        def read_at(o, s):
            calls.append((o, s))
            return seekable[o : o + s]

        d = pkg.router.FormatRouter().route(read_at, len(seekable), record=False)
        assert len(calls) == 2
        assert d.probe_bytes <= 64

    def test_cost_ordering_stable_across_sizes(self, pkg, zlayer):
        raw = zlayer[0]
        for cut in (len(raw), 8 << 10):
            blob = pkg.zframe.write_seekable(raw[:cut], frame_usize=4 << 10)
            d = self._route(pkg, blob)
            assert d.backend == pkg.router.BACKEND_SEEKABLE, cut
            assert d.costs[pkg.router.BACKEND_SEEKABLE] < d.costs[pkg.router.BACKEND_RAFS], cut

    def test_disable_toc_falls_back_to_index(self, pkg, zlayer):
        blob = pkg.toc.write_zstd_chunked({k.lstrip("/"): v for k, v in zlayer[1].items()},
                                          chunk_size=FRAME_USIZE)
        assert self._route(pkg, blob, enable_toc=False).backend == pkg.router.BACKEND_SEEKABLE

    def test_disable_zstd_routes_rafs(self, pkg, seekable):
        d = self._route(pkg, seekable, enable_zstd=False, enable_toc=False)
        assert d.backend == pkg.router.BACKEND_RAFS

    def test_route_metric_counts(self, pkg, seekable):
        """Each package counts on its own registry; the other's counter
        does not move."""
        other = _other(pkg)
        seek = pkg.router.BACKEND_SEEKABLE
        before, before_other = pkg.router.ROUTE_TOTAL.value(seek), other.router.ROUTE_TOTAL.value(seek)
        pkg.router.FormatRouter().route(_reader_for(seekable), len(seekable))
        assert pkg.router.ROUTE_TOTAL.value(seek) == before + 1
        assert pkg.router.route_counts()[seek] == before + 1
        assert other.router.ROUTE_TOTAL.value(seek) == before_other


# ---------------------------------------------------------------------------
# zstd frame index (test_soci_formats.TestZstdIndexGeometry)
# ---------------------------------------------------------------------------


class TestZstdIndexGeometry:
    def test_seek_table_adopted_as_source(self, pkg, zlayer, seekable):
        raw = zlayer[0]
        idx, out = pkg.zblob.build_zindex_from_zstd(ZBLOB_ID, seekable)
        assert out == raw
        assert idx.source == pkg.zindex.SOURCE_SEEK_TABLE and idx.source_name == "seek_table"
        assert len(idx.frames) == (len(raw) + FRAME_USIZE - 1) // FRAME_USIZE

    def test_frame_walk_fallback(self, pkg, zlayer, opaque):
        idx, out = pkg.zblob.build_zindex_from_zstd(ZBLOB_ID, opaque)
        assert out == zlayer[0]
        assert idx.source == pkg.zindex.SOURCE_FRAME_WALK and idx.source_name == "frame_walk"

    def test_frame_tiling(self, pkg, zlayer, seekable):
        idx, _ = pkg.zblob.build_zindex_from_zstd(ZBLOB_ID, seekable)
        upos = cpos = 0
        for fr in idx.frames:
            assert (fr.uout, fr.cin) == (upos, cpos)
            upos += fr.usize
            cpos += fr.csize
        assert upos == len(zlayer[0])
        assert cpos <= len(seekable)

    def test_resolve_covers_reads(self, pkg, seekable):
        idx, _ = pkg.zblob.build_zindex_from_zstd(ZBLOB_ID, seekable)
        frames, cs, ce = idx.resolve(FRAME_USIZE + 17, 10)
        assert frames and frames[0].uout <= FRAME_USIZE + 17
        assert frames[-1].uout + frames[-1].usize >= FRAME_USIZE + 27
        assert 0 < cs < ce <= len(seekable)

    def test_random_extract_identity(self, pkg, zlayer, seekable):
        raw = zlayer[0]
        idx, _ = pkg.zblob.build_zindex_from_zstd(ZBLOB_ID, seekable)
        reader = pkg.zblob.ZstdStreamReader(idx, _reader_for(seekable))
        rng = random.Random(4)
        for _ in range(40):
            off = rng.randrange(0, len(raw) - 1)
            size = rng.randrange(1, min(150_000, len(raw) - off))
            assert reader.read_range(off, size) == raw[off : off + size]

    def test_extract_pulls_only_covering_frames(self, pkg, zlayer, seekable):
        raw = zlayer[0]
        idx, _ = pkg.zblob.build_zindex_from_zstd(ZBLOB_ID, seekable)
        pulled = []

        def tracking(pos, n):
            pulled.append(n)
            return seekable[pos : pos + n]

        reader = pkg.zblob.ZstdStreamReader(idx, tracking)
        off = 3 * FRAME_USIZE + 5
        assert reader.read_range(off, 100) == raw[off : off + 100]
        assert sum(pulled) < len(seekable) / 4

    def test_file_map_matches_tar(self, pkg, zlayer, seekable):
        contents = zlayer[1]
        idx, _ = pkg.zblob.build_zindex_from_zstd(ZBLOB_ID, seekable)
        assert set(idx.files) == set(contents)
        reader = pkg.zblob.ZstdStreamReader(idx, _reader_for(seekable))
        for path, (off, size) in idx.files.items():
            assert reader.read_range(off, size) == contents[path], path

    def test_read_past_end_fails_loudly(self, pkg, zlayer, seekable):
        idx, _ = pkg.zblob.build_zindex_from_zstd(ZBLOB_ID, seekable)
        reader = pkg.zblob.ZstdStreamReader(idx, _reader_for(seekable))
        with pytest.raises(pkg.zindex.ZstdIndexError):
            reader.read_range(len(zlayer[0]) - 5, 10)

    def test_corrupt_seek_table_demotes_to_walk(self, pkg, zlayer, seekable):
        bad = bytearray(seekable)
        bad[-6] ^= 0xFF
        idx, out = pkg.zblob.build_zindex_from_zstd(ZBLOB_ID, bytes(bad))
        assert out == zlayer[0]
        assert idx.source == pkg.zindex.SOURCE_FRAME_WALK


# ---------------------------------------------------------------------------
# .soci.zidx persistence (test_soci_formats.TestZstdIndexPersistence)
# ---------------------------------------------------------------------------

MUTATIONS = ["truncate", "flip_payload", "flip_header", "empty"]


def _mutate(path: str, mutation: str) -> None:
    raw = bytearray(open(path, "rb").read())
    if mutation == "truncate":
        raw = raw[: len(raw) // 2]
    elif mutation == "flip_payload":
        raw[len(raw) // 2] ^= 0xFF
    elif mutation == "flip_header":
        raw[0] ^= 0xFF
    else:
        raw = bytearray()
    open(path, "wb").write(bytes(raw))


class TestZstdIndexPersistence:
    def _saved(self, pkg, tmp_path, seekable):
        idx, _ = pkg.zblob.build_zindex_from_zstd(ZBLOB_ID, seekable)
        path = pkg.zindex.zindex_path(str(tmp_path), ZBLOB_ID)
        idx.save(path)
        return idx, path

    def test_roundtrip(self, pkg, tmp_path, seekable):
        idx, path = self._saved(pkg, tmp_path, seekable)
        got = pkg.zindex.ZstdFrameIndex.load(path, blob_id=ZBLOB_ID, csize=len(seekable))
        assert got.files == idx.files
        assert got.source == idx.source
        assert got.uncompressed_size == idx.uncompressed_size
        assert [(f.uout, f.cin, f.usize, f.csize) for f in got.frames] == [
            (f.uout, f.cin, f.usize, f.csize) for f in idx.frames]

    @pytest.mark.parametrize("mutation", MUTATIONS)
    def test_corruption_fails_loudly(self, pkg, tmp_path, seekable, mutation):
        _, path = self._saved(pkg, tmp_path, seekable)
        _mutate(path, mutation)
        with pytest.raises(pkg.zindex.ZstdIndexError):
            pkg.zindex.ZstdFrameIndex.load(path, blob_id=ZBLOB_ID, csize=len(seekable))

    def test_stale_index_rejected(self, pkg, tmp_path, seekable):
        _, path = self._saved(pkg, tmp_path, seekable)
        with pytest.raises(pkg.zindex.ZstdIndexError):
            pkg.zindex.ZstdFrameIndex.load(path, blob_id="cd" * 32)
        with pytest.raises(pkg.zindex.ZstdIndexError):
            pkg.zindex.ZstdFrameIndex.load(path, blob_id=ZBLOB_ID, csize=len(seekable) + 1)

    def test_corrupt_index_rebuilt_once_never_poisons(self, pkg, tmp_path, zlayer, seekable):
        raw = zlayer[0]
        _, path = self._saved(pkg, tmp_path, seekable)
        _mutate(path, "flip_payload")
        builds = []

        def builder():
            builds.append(1)
            return seekable

        _idx, outcome = pkg.zblob.load_or_build_zindex(
            [str(tmp_path)], ZBLOB_ID, csize=len(seekable), builder=builder)
        assert outcome == "rebuilt" and len(builds) == 1
        idx2, outcome2 = pkg.zblob.load_or_build_zindex(
            [str(tmp_path)], ZBLOB_ID, csize=len(seekable), builder=builder)
        assert outcome2 == "loaded" and len(builds) == 1
        reader = pkg.zblob.ZstdStreamReader(idx2, _reader_for(seekable))
        assert reader.read_range(1000, 5000) == raw[1000:6000]

    def test_missing_without_builder_degrades(self, pkg, tmp_path):
        idx, outcome = pkg.zblob.load_or_build_zindex([str(tmp_path)], ZBLOB_ID, csize=1)
        assert idx is None and outcome == "missing"

    def test_fetch_remote_adopts_checksummed_bytes(self, pkg, tmp_path, seekable):
        """The store's peer tier comes in as a callable: a replica's bytes
        are adopted after their checksum, persisted, then loaded."""
        idx, _ = pkg.zblob.build_zindex_from_zstd(ZBLOB_ID, seekable)
        got, outcome = pkg.zblob.load_or_build_zindex(
            [str(tmp_path)], ZBLOB_ID, csize=len(seekable), fetch_remote=idx.to_bytes)
        assert outcome == "replicated" and len(got.frames) == len(idx.frames)
        _, outcome2 = pkg.zblob.load_or_build_zindex([str(tmp_path)], ZBLOB_ID, csize=len(seekable))
        assert outcome2 == "loaded"
        bad = bytearray(idx.to_bytes())
        bad[len(bad) // 2] ^= 0xFF
        got, outcome3 = pkg.zblob.load_or_build_zindex(
            [str(tmp_path / "other")], ZBLOB_ID, csize=len(seekable),
            fetch_remote=lambda: bytes(bad), builder=lambda: seekable)
        assert outcome3 == "built" and len(got.frames) == len(idx.frames)


# ---------------------------------------------------------------------------
# TOC adoption and the adaptor (test_soci_formats.TestTocAdoption)
# ---------------------------------------------------------------------------


def _prepare(pkg, tmp_path, blob, chunk_size=FRAME_USIZE):
    digest = "sha256:" + hashlib.sha256(blob).hexdigest()
    fetched = []

    def read_at(off, ln):
        fetched.append(ln)
        return blob[off : off + ln]

    b = pkg.sresolver.Blob("ref", digest, read_at, len(blob))
    adaptor = pkg.adaptor.SociAdaptor(
        lambda s: os.path.join(str(tmp_path), "up", s),
        cache_dir=os.path.join(str(tmp_path), "cache"),
        chunk_size=chunk_size,
    )
    store = os.path.join(str(tmp_path), "store")
    adaptor.prepare_meta_layer(b, store)
    boot = open(os.path.join(store, digest.split(":")[1]), "rb").read()
    return boot, digest.split(":")[1], sum(fetched)


def _unpacked_files(pkg, boot, blob_id, blob):
    out_tar = pkg.convert.Unpack(boot, {blob_id: blob})
    got = {}
    with tarfile.open(fileobj=io.BytesIO(out_tar)) as tf:
        for m in tf:
            if m.isreg():
                got["/" + m.name] = tf.extractfile(m).read()
    return got


class TestTocAdoption:
    def test_zstd_chunked_adoption_zero_build_pass(self, pkg, tmp_path, zlayer):
        contents = zlayer[1]
        blob = pkg.toc.write_zstd_chunked({k.lstrip("/"): v for k, v in contents.items()},
                                          chunk_size=FRAME_USIZE)
        boot, blob_id, fetched = _prepare(pkg, tmp_path, blob)
        assert fetched < len(blob) // 2
        assert _unpacked_files(pkg, boot, blob_id, blob) == contents
        assert not os.path.exists(pkg.zindex.zindex_path(os.path.join(str(tmp_path), "cache"), blob_id))

    def test_estargz_adoption_zero_build_pass(self, pkg, tmp_path, zlayer):
        contents = zlayer[1]
        blob = build_estargz({k.lstrip("/"): v for k, v in contents.items()})
        boot, blob_id, fetched = _prepare(pkg, tmp_path, blob)
        assert fetched < len(blob) // 2
        assert _unpacked_files(pkg, boot, blob_id, blob) == contents

    def test_seekable_prepare_persists_zidx(self, pkg, tmp_path, zlayer, seekable):
        boot, blob_id, fetched = _prepare(pkg, tmp_path, seekable)
        assert fetched >= len(seekable)
        assert os.path.exists(pkg.zindex.zindex_path(os.path.join(str(tmp_path), "cache"), blob_id))
        assert _unpacked_files(pkg, boot, blob_id, seekable) == zlayer[1]

    def test_single_frame_zstd_demotes_to_rafs(self, pkg, tmp_path, zlayer):
        blob = pkg.zstd.compress_block(zlayer[0])
        rafs = pkg.router.BACKEND_RAFS
        before, before_other = pkg.router.ROUTE_TOTAL.value(rafs), _other(pkg).router.ROUTE_TOTAL.value(rafs)
        with pytest.raises(pkg.adaptor.SociError):
            _prepare(pkg, tmp_path, blob)
        assert pkg.router.ROUTE_TOTAL.value(rafs) == before + 1
        assert _other(pkg).router.ROUTE_TOTAL.value(rafs) == before_other

    def test_gzip_prepare_persists_idx(self, pkg, tmp_path, glayer):
        """The zran arm: the one full pull, the persisted ``.soci.idx``,
        a bootstrap whose files unpack from the original blob."""
        _raw, gz, contents = glayer
        boot, blob_id, fetched = _prepare(pkg, tmp_path, gz)
        assert fetched >= len(gz)
        cache = os.path.join(str(tmp_path), "cache")
        idx = pkg.index.SociIndex.load(pkg.index.index_path(cache, blob_id), blob_id=blob_id,
                                       csize=len(gz))
        assert set(idx.files) == set(contents)
        assert _unpacked_files(pkg, boot, blob_id, gz) == contents


# ---------------------------------------------------------------------------
# Chaos: soci.{index,resolve,fetch} (both test files' TestChaos)
# ---------------------------------------------------------------------------


class TestChaos:
    def test_zindex_site_fails_store_loudly(self, pkg, tmp_path, seekable):
        with pkg.failpoint.injected("soci.index", "error(OSError)"):
            with pytest.raises(OSError):
                pkg.zblob.load_or_build_zindex([str(tmp_path)], ZBLOB_ID, csize=len(seekable),
                                               builder=lambda: seekable)
        idx, outcome = pkg.zblob.load_or_build_zindex(
            [str(tmp_path)], ZBLOB_ID, csize=len(seekable), builder=lambda: seekable)
        assert idx is not None and outcome == "built"

    def test_zindex_site_fails_build_at_prepare(self, pkg, seekable):
        with pkg.failpoint.injected("soci.index", "error(OSError)"):
            with pytest.raises(OSError):
                pkg.zblob.build_zindex_from_zstd(ZBLOB_ID, seekable)

    def test_zstd_resolve_site_fails_read_never_wrong_bytes(self, pkg, zlayer, seekable):
        idx, _ = pkg.zblob.build_zindex_from_zstd(ZBLOB_ID, seekable)
        reader = pkg.zblob.ZstdStreamReader(idx, _reader_for(seekable))
        with pkg.failpoint.injected("soci.resolve", "error(OSError)*1"):
            with pytest.raises(OSError):
                reader.read_range(100, 100)
        assert reader.read_range(100, 100) == zlayer[0][100:200]

    def test_zstd_fetch_site_fails_read_then_recovers(self, pkg, zlayer, seekable):
        idx, _ = pkg.zblob.build_zindex_from_zstd(ZBLOB_ID, seekable)
        reader = pkg.zblob.ZstdStreamReader(idx, _reader_for(seekable))
        with pkg.failpoint.injected("soci.fetch", "error(OSError)*1"):
            with pytest.raises(OSError):
                reader.read_range(0, 1000)
        assert reader.read_range(0, 1000) == zlayer[0][:1000]

    def test_index_site_fails_store_loudly(self, pkg, tmp_path, glayer):
        gz = glayer[1]
        with pkg.failpoint.injected("soci.index", "error(OSError)"):
            with pytest.raises(OSError):
                pkg.blob.load_or_build_index([str(tmp_path)], GBLOB_ID, csize=len(gz),
                                             builder=lambda: gz)
        idx, outcome = pkg.blob.load_or_build_index(
            [str(tmp_path)], GBLOB_ID, csize=len(gz), builder=lambda: gz, stride=STRIDE)
        assert idx is not None and outcome == "built"

    def test_index_site_fails_build_at_prepare(self, pkg, glayer):
        with pkg.failpoint.injected("soci.index", "error(OSError)"):
            with pytest.raises(OSError):
                pkg.blob.build_index_from_gzip(GBLOB_ID, glayer[1], stride=STRIDE)

    def test_resolve_site_fails_read_never_wrong_bytes(self, pkg, glayer):
        raw, gz, _ = glayer
        idx, _ = pkg.blob.build_index_from_gzip(GBLOB_ID, gz, stride=STRIDE)
        reader = pkg.blob.SociStreamReader(idx, _reader_for(gz))
        with pkg.failpoint.injected("soci.resolve", "error(OSError)*1"):
            with pytest.raises(OSError):
                reader.read_range(100, 100)
        assert reader.read_range(100, 100) == raw[100:200]

    def test_fetch_site_fails_read_then_recovers(self, pkg, glayer):
        """The reference's case reads through a ``CachedBlob``; here the
        compressed-domain reader is a plain ``read_at``."""
        raw, gz, _ = glayer
        idx, _ = pkg.blob.build_index_from_gzip(GBLOB_ID, gz, stride=STRIDE)
        reader = pkg.blob.SociStreamReader(idx, _reader_for(gz))
        with pkg.failpoint.injected("soci.fetch", "error(OSError)*1"):
            with pytest.raises(OSError):
                reader.read_range(0, 1000)
        assert reader.read_range(0, 1000) == raw[:1000]

    def test_daemon_store_chaos_degrades_to_sequential(self, pkg, tmp_path, glayer):
        """An armed soci.index site must not fail daemon reads: the
        instance falls back to the sequential in-process reader."""
        raw, gz, contents = glayer
        blob_hex = hashlib.sha256(gz).hexdigest()
        bs = pkg.czran.pack_gzip_layer(gz, pkg.types.PackOption(chunk_size=0x10000, oci_ref=True),
                                       tar_bytes=raw)
        blob_dir = str(tmp_path)
        with open(os.path.join(blob_dir, blob_hex), "wb") as f:
            f.write(gz)
        boot = os.path.join(blob_dir, "boot")
        with open(boot, "wb") as f:
            f.write(bs.to_bytes())
        # Index present next to the blob, but the store is chaos-armed.
        idx, _ = pkg.blob.build_index_from_gzip(blob_hex, gz, stride=STRIDE)
        idx.save(pkg.index.index_path(blob_dir, blob_hex))
        path, want = next(iter(contents.items()))
        with pkg.failpoint.injected("soci.index", "error(OSError)"):
            inst = pkg.server._Instance("/mnt/x", boot, "{}")
            got = inst.read(path, 0, -1, blob_dir)
            assert got == want  # degraded, correct
            assert not inst._soci_by_index  # sequential fallback took over
        assert pkg.failpoint.counts().get("soci.index", 0) >= 1
        assert _other(pkg).failpoint.counts().get("soci.index", 0) == 0
        inst.close()

    @pytest.mark.parametrize("site", ["soci.index", "soci.resolve", "soci.fetch"])
    def test_site_fires_only_its_own_package(self, pkg, glayer, site):
        """An armed site of one package never fires the other's."""
        raw, gz, _ = glayer
        other = _other(pkg)
        idx, _ = other.blob.build_index_from_gzip(GBLOB_ID, gz, stride=STRIDE)
        with pkg.failpoint.injected(site, "error(OSError)"):
            assert other.blob.SociStreamReader(idx, _reader_for(gz)).read_range(7, 900) == raw[7:907]
        assert pkg.failpoint.counts().get(site, 0) == 0


# ---------------------------------------------------------------------------
# gzip checkpoint geometry (test_soci_backend.TestCheckpointGeometry)
# ---------------------------------------------------------------------------


class TestCheckpointGeometry:
    def test_stride_spacing_and_monotonicity(self, pkg, glayer):
        raw, gz, _ = glayer
        cps, out = pkg.zran.build(gz, stride=STRIDE)
        assert out == raw and cps
        last_u, last_c = 0, 0
        for cp in cps:
            assert cp.uout - last_u >= STRIDE
            assert cp.cin > last_c
            assert 0 <= cp.bits < 8
            assert len(cp.window) <= pkg.zran.WINDOW_SIZE
            last_u, last_c = cp.uout, cp.cin

    def test_resolve_geometry(self, pkg, glayer):
        raw, gz, _ = glayer
        idx, _ = pkg.blob.build_index_from_gzip(GBLOB_ID, gz, stride=STRIDE)
        assert len(idx.checkpoints) >= 3
        cp, cs, ce = idx.resolve(0, 10)
        assert cp is None and cs == 0 and ce == idx.checkpoints[0].cin
        mid = idx.checkpoints[1].uout + 17
        cp, cs, ce = idx.resolve(mid, 1000)
        assert cp is idx.checkpoints[1]
        assert cs == cp.cin - (1 if cp.bits else 0)
        assert ce == idx.checkpoints[2].cin
        cp, cs, ce = idx.resolve(len(raw) - 10, 10)
        assert ce == len(gz)
        cp, _, _ = idx.resolve(idx.checkpoints[0].uout, 1)
        assert cp is idx.checkpoints[0]

    def test_extract_pulls_only_resolved_range(self, pkg, glayer):
        raw, gz, _ = glayer
        idx, _ = pkg.blob.build_index_from_gzip(GBLOB_ID, gz, stride=STRIDE)
        off, size = idx.checkpoints[0].uout + 100, 64 << 10
        cp, cs, ce = idx.resolve(off, size)
        pulled = []

        def tracking(pos, n):
            pulled.append((pos, n))
            assert cs <= pos and pos + n <= max(ce, cs + 1)
            return gz[pos : pos + n]

        got = pkg.zran.extract(tracking, len(gz), cp, off, size, comp_end=ce)
        assert got == raw[off : off + size]
        assert sum(n for _, n in pulled) <= (ce - cs) + 1
        assert sum(n for _, n in pulled) < len(gz) / 2

    def test_random_extract_identity(self, pkg, glayer):
        raw, gz, _ = glayer
        idx, _ = pkg.blob.build_index_from_gzip(GBLOB_ID, gz, stride=STRIDE)
        reader = pkg.blob.SociStreamReader(idx, _reader_for(gz))
        rng = random.Random(1)
        for _ in range(40):
            off = rng.randrange(0, len(raw) - 1)
            size = rng.randrange(1, min(200_000, len(raw) - off))
            assert reader.read_range(off, size) == raw[off : off + size]

    def test_multi_member_gzip(self, pkg, glayer):
        raw = glayer[0]
        mm = b"".join(gzip.compress(raw[i : i + 150_000], 1) for i in range(0, len(raw), 150_000))
        idx, out = pkg.blob.build_index_from_gzip(GBLOB_ID, mm, stride=64 << 10)
        assert out == raw
        reader = pkg.blob.SociStreamReader(idx, _reader_for(mm))
        rng = random.Random(2)
        for _ in range(20):
            off = rng.randrange(0, len(raw) - 1)
            size = rng.randrange(1, min(100_000, len(raw) - off))
            assert reader.read_range(off, size) == raw[off : off + size]

    def test_read_past_end_fails_loudly(self, pkg, glayer):
        raw, gz, _ = glayer
        idx, _ = pkg.blob.build_index_from_gzip(GBLOB_ID, gz, stride=STRIDE)
        reader = pkg.blob.SociStreamReader(idx, _reader_for(gz))
        with pytest.raises(pkg.index.SociIndexError):
            reader.read_range(len(raw) - 5, 10)

    def test_file_map_matches_tar(self, pkg, glayer):
        _raw, gz, contents = glayer
        idx, _ = pkg.blob.build_index_from_gzip(GBLOB_ID, gz, stride=STRIDE)
        assert set(idx.files) == set(contents)
        reader = pkg.blob.SociStreamReader(idx, _reader_for(gz))
        for path, (off, size) in idx.files.items():
            assert reader.read_range(off, size) == contents[path], path

    def test_warm_list_geometry_and_order(self, pkg, glayer):
        """test_soci_backend.TestPrefetchFromIndex's first case (its second
        warms a ``CachedBlob``, which the port does not have)."""
        _raw, gz, contents = glayer
        idx, _ = pkg.blob.build_index_from_gzip(GBLOB_ID, gz, stride=STRIDE)
        paths = ["/usr/lib/f0005.so", "usr/lib/f0100.so", "/no/such/file"]
        warms, missing = pkg.blob.warm_list_from_index(idx, paths)
        assert missing == ["/no/such/file"]
        assert [w[0] for w in warms] == paths[:2]
        reader = pkg.blob.SociStreamReader(idx, _reader_for(gz))
        for path, c0, c1 in warms:
            assert 0 <= c0 < c1 <= len(gz)
            uoff, usize = idx.file_extent("/" + path.strip("/"))
            assert reader.read_range(uoff, usize) == contents["/" + path.strip("/")]

    def test_concurrent_readers_lock_free(self, pkg, glayer):
        """test_soci_backend's case over a plain ``read_at``: four threads
        share one reader."""
        raw, gz, _ = glayer
        idx, _ = pkg.blob.build_index_from_gzip(GBLOB_ID, gz, stride=STRIDE)
        reader = pkg.blob.SociStreamReader(idx, _reader_for(gz))
        assert reader.concurrent
        errors = []

        def worker(seed):
            rng = random.Random(seed)
            try:
                for _ in range(12):
                    off = rng.randrange(0, len(raw) - 1)
                    size = rng.randrange(1, min(100_000, len(raw) - off))
                    assert reader.read_range(off, size) == raw[off : off + size]
            except BaseException as e:  # noqa: BLE001
                errors.append(e)

        threads = [threading.Thread(target=worker, args=(i,)) for i in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert not errors, errors


# ---------------------------------------------------------------------------
# .soci.idx persistence (test_soci_backend.TestIndexPersistence)
# ---------------------------------------------------------------------------


class TestIndexPersistence:
    def _saved(self, pkg, tmp_path, gz):
        idx, _ = pkg.blob.build_index_from_gzip(GBLOB_ID, gz, stride=STRIDE)
        path = pkg.index.index_path(str(tmp_path), GBLOB_ID)
        idx.save(path)
        return idx, path

    def test_roundtrip(self, pkg, tmp_path, glayer):
        gz = glayer[1]
        idx, path = self._saved(pkg, tmp_path, gz)
        got = pkg.index.SociIndex.load(path, blob_id=GBLOB_ID, csize=len(gz))
        assert len(got.checkpoints) == len(idx.checkpoints)
        assert got.files == idx.files
        assert got.uncompressed_size == idx.uncompressed_size
        for a, b in zip(got.checkpoints, idx.checkpoints):
            assert (a.uout, a.cin, a.bits, a.window, a.fresh) == (b.uout, b.cin, b.bits, b.window, b.fresh)

    @pytest.mark.parametrize("mutation", MUTATIONS)
    def test_corruption_fails_loudly(self, pkg, tmp_path, glayer, mutation):
        gz = glayer[1]
        _, path = self._saved(pkg, tmp_path, gz)
        _mutate(path, mutation)
        with pytest.raises(pkg.index.SociIndexError):
            pkg.index.SociIndex.load(path, blob_id=GBLOB_ID, csize=len(gz))

    def test_stale_index_rejected(self, pkg, tmp_path, glayer):
        gz = glayer[1]
        _, path = self._saved(pkg, tmp_path, gz)
        with pytest.raises(pkg.index.SociIndexError):
            pkg.index.SociIndex.load(path, blob_id="cd" * 32)
        with pytest.raises(pkg.index.SociIndexError):
            pkg.index.SociIndex.load(path, blob_id=GBLOB_ID, csize=len(gz) + 1)

    def test_corrupt_index_rebuilt_once_never_poisons(self, pkg, tmp_path, glayer):
        raw, gz, _ = glayer
        _, path = self._saved(pkg, tmp_path, gz)
        _mutate(path, "flip_payload")
        builds = []

        def builder():
            builds.append(1)
            return gz

        _idx, outcome = pkg.blob.load_or_build_index(
            [str(tmp_path)], GBLOB_ID, csize=len(gz), builder=builder, stride=STRIDE)
        assert outcome == "rebuilt" and len(builds) == 1
        idx2, outcome2 = pkg.blob.load_or_build_index(
            [str(tmp_path)], GBLOB_ID, csize=len(gz), builder=builder)
        assert outcome2 == "loaded" and len(builds) == 1
        reader = pkg.blob.SociStreamReader(idx2, _reader_for(gz))
        assert reader.read_range(1000, 5000) == raw[1000:6000]

    def test_missing_without_builder_degrades(self, pkg, tmp_path):
        idx, outcome = pkg.blob.load_or_build_index([str(tmp_path)], GBLOB_ID, csize=1)
        assert idx is None and outcome == "missing"

    def test_fetch_remote_adopts_checksummed_bytes(self, pkg, tmp_path, glayer):
        """The peer tier as a callable (test_soci_backend.TestPeerReplication
        without ``daemon.peer``): good bytes are adopted and persisted,
        poisoned bytes walk on to the build."""
        raw, gz, _ = glayer
        idx, _ = pkg.blob.build_index_from_gzip(GBLOB_ID, gz, stride=STRIDE)
        got, outcome = pkg.blob.load_or_build_index(
            [str(tmp_path)], GBLOB_ID, csize=len(gz), fetch_remote=idx.to_bytes)
        assert outcome == "replicated" and len(got.checkpoints) == len(idx.checkpoints)
        _, outcome2 = pkg.blob.load_or_build_index([str(tmp_path)], GBLOB_ID, csize=len(gz))
        assert outcome2 == "loaded"
        bad = bytearray(idx.to_bytes())
        bad[len(bad) // 2] ^= 0xFF
        got, outcome3 = pkg.blob.load_or_build_index(
            [str(tmp_path / "other")], GBLOB_ID, csize=len(gz), fetch_remote=lambda: bytes(bad),
            builder=lambda: gz, stride=STRIDE)
        assert outcome3 == "built"
        assert pkg.blob.SociStreamReader(got, _reader_for(gz)).read_range(500, 4000) == raw[500:4500]


# ---------------------------------------------------------------------------
# BlobReader integration (both test files)
# ---------------------------------------------------------------------------


class TestBlobReaderIntegration:
    def test_blobreader_mounts_soci_stream(self, pkg, glayer):
        raw, gz, _ = glayer
        bs = pkg.czran.pack_gzip_layer(gz, pkg.types.PackOption(chunk_size=0x10000, oci_ref=True),
                                       tar_bytes=raw)
        idx, _ = pkg.blob.build_index_from_gzip(GBLOB_ID, gz, stride=STRIDE)
        read_at = _reader_for(gz)
        plain = pkg.convert.BlobReader(bs, 0, read_at)
        indexed = pkg.convert.BlobReader(bs, 0, read_at, gzip_stream=pkg.blob.SociStreamReader(idx, read_at))
        for rec in bs.chunks[:: max(1, len(bs.chunks) // 25)]:
            assert indexed.chunk_data(rec) == plain.chunk_data(rec)

    def test_blobreader_mounts_zstd_stream(self, pkg, zlayer, seekable):
        raw = zlayer[0]
        bs = pkg.zstd_ref.pack_zstd_layer(seekable, pkg.types.PackOption(chunk_size=0x8000, oci_ref=True),
                                          tar_bytes=raw)
        idx, _ = pkg.zblob.build_zindex_from_zstd(ZBLOB_ID, seekable)
        read_at = _reader_for(seekable)
        plain = pkg.convert.BlobReader(bs, 0, read_at)
        indexed = pkg.convert.BlobReader(bs, 0, read_at)
        indexed.mount_zstd_stream(pkg.zblob.ZstdStreamReader(idx, read_at))
        for rec in bs.chunks[:: max(1, len(bs.chunks) // 25)]:
            assert indexed.chunk_data(rec) == plain.chunk_data(rec)

    def test_mixed_format_merge(self, pkg, zlayer, seekable):
        raw, contents = zlayer
        raw2, contents2 = formats_layer(n_files=20, seed=9)
        gz = gzip.compress(raw2, 6)
        opt = pkg.types.PackOption(chunk_size=0x8000, oci_ref=True)
        bs_z = pkg.zstd_ref.pack_zstd_layer(seekable, opt, tar_bytes=raw)
        bs_g = pkg.czran.pack_gzip_layer(gz, opt, tar_bytes=raw2)
        merged = pkg.convert.Merge([bs_z, bs_g], pkg.types.MergeOption(oci_ref=True)).bootstrap
        blob_map = {hashlib.sha256(seekable).hexdigest(): seekable, hashlib.sha256(gz).hexdigest(): gz}
        out = pkg.convert.Unpack(merged, blob_map)
        got = {}
        with tarfile.open(fileobj=io.BytesIO(out)) as tf:
            for m in tf:
                if m.isreg():
                    got["/" + m.name] = tf.extractfile(m).read()
        assert got == {**contents, **contents2}


def test_exports_match_reference():
    names = ["SociAdaptor", "SociResolver", "SociStreamReader", "SociIndex", "SociIndexError",
             "FormatRouter", "RouteDecision", "ZstdStreamReader", "ZstdFrameIndex", "ZstdIndexError",
             "load_or_build_index", "resolve_soci_config", "load_or_build_zindex"]
    ref_names = sorted(n for n in dir(REF.soci) if not n.startswith("_")
                       and not isinstance(getattr(REF.soci, n), type(REF.soci)))
    port_names = sorted(n for n in dir(PORT.soci) if not n.startswith("_")
                        and not isinstance(getattr(PORT.soci, n), type(PORT.soci)))
    assert ref_names == port_names
    assert set(names) <= set(port_names)


def test_resolve_soci_config_env_over_defaults(pkg, monkeypatch):
    cfg = pkg.blob.resolve_soci_config()
    assert (cfg.enable, cfg.replicate, cfg.zstd, cfg.toc_adopt) == (False, True, True, True)
    monkeypatch.setenv("NTPU_SOCI_STRIDE_KIB", "512")
    monkeypatch.setenv("NTPU_SOCI_ENABLE", "1")
    monkeypatch.setenv("NTPU_SOCI_ZSTD", "off")
    cfg = pkg.blob.resolve_soci_config()
    assert (cfg.stride_bytes, cfg.enable, cfg.zstd) == (512 << 10, True, False)
    monkeypatch.setenv("NTPU_SOCI_STRIDE_KIB", "bad")
    assert pkg.blob.resolve_soci_config().stride_bytes == pkg.blob.DEFAULT_STRIDE_KIB << 10


# ---------------------------------------------------------------------------
# Cross-package: the same numpy-seeded layers through both packages
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["gzip", "gzip_mm"])
def test_soci_index_bytes_equal(np_layers, kind):
    gz = getattr(np_layers, kind)
    ref, ref_tar = REF.blob.build_index_from_gzip(GBLOB_ID, gz, stride=64 << 10)
    port, port_tar = PORT.blob.build_index_from_gzip(GBLOB_ID, gz, stride=64 << 10)
    assert ref_tar == port_tar == np_layers.tar
    assert len(port.checkpoints) >= 3
    assert port.to_bytes() == ref.to_bytes()


@pytest.mark.parametrize("kind", ["seekable", "opaque", "chunked"])
def test_zstd_frame_index_bytes_equal(np_layers, kind):
    blob = getattr(np_layers, kind)
    ref, ref_tar = REF.zblob.build_zindex_from_zstd(ZBLOB_ID, blob)
    port, port_tar = PORT.zblob.build_zindex_from_zstd(ZBLOB_ID, blob)
    assert ref_tar == port_tar
    assert port.source == ref.source and len(port.frames) > 1
    assert port.to_bytes() == ref.to_bytes()


@pytest.mark.parametrize("writer,loader", [("ref", "port"), ("port", "ref")])
def test_index_files_load_across_packages(tmp_path, np_layers, writer, loader):
    """A ``.soci.idx`` and a ``.soci.zidx`` written by one package load in
    the other into an equal index, through its store (``find_index`` /
    ``find_zindex``), and the other's readers serve its bytes."""
    w, r = PKG[writer], PKG[loader]
    gz, zs = np_layers.gzip_mm, np_layers.seekable
    gidx, _ = w.blob.build_index_from_gzip(GBLOB_ID, gz, stride=64 << 10)
    zidx, _ = w.zblob.build_zindex_from_zstd(ZBLOB_ID, zs)
    gidx.save(w.index.index_path(str(tmp_path), GBLOB_ID))
    zidx.save(w.zindex.zindex_path(str(tmp_path), ZBLOB_ID))
    g2, discarded = r.blob.find_index([str(tmp_path)], GBLOB_ID, csize=len(gz))
    z2, zdiscarded = r.zblob.find_zindex([str(tmp_path)], ZBLOB_ID, csize=len(zs))
    assert (discarded, zdiscarded) == (0, 0)
    assert g2.to_bytes() == gidx.to_bytes() and z2.to_bytes() == zidx.to_bytes()
    assert g2.files == gidx.files and z2.files == zidx.files
    tar = np_layers.tar
    for path, (off, size) in list(g2.files.items())[::9]:
        assert r.blob.SociStreamReader(g2, _reader_for(gz)).read_range(off, size) == tar[off : off + size]
        assert r.zblob.ZstdStreamReader(z2, _reader_for(zs)).read_range(off, size) == tar[off : off + size]


def _decision(d) -> tuple:
    return (d.backend, d.format, d.costs, d.toc_location, d.probe_bytes, d.reason, d.describe())


@pytest.mark.parametrize("kind", ["gzip", "gzip_mm", "seekable", "opaque", "chunked", "estargz",
                                  "single", "tar"])
@pytest.mark.parametrize("flags", [{}, {"enable_toc": False}, {"enable_zstd": False, "enable_toc": False}])
def test_router_decisions_equal(np_layers, kind, flags):
    blob = getattr(np_layers, kind)
    calls = {side: [] for side in SIDES}

    def reader(side):
        def read_at(o, n):
            calls[side].append((o, n))
            return blob[o : o + n]
        return read_at

    ref = REF.router.FormatRouter(**flags).route(reader("ref"), len(blob), record=False)
    port = PORT.router.FormatRouter(**flags).route(reader("port"), len(blob), record=False)
    assert _decision(port) == _decision(ref)
    assert calls["port"] == calls["ref"]


@pytest.mark.parametrize("kind", ["chunked", "estargz"])
def test_parsed_tocs_equal(np_layers, kind):
    blob = getattr(np_layers, kind)
    if kind == "chunked":
        ref = REF.toc.read_toc(_reader_for(blob), len(blob))
        port = PORT.toc.read_toc(_reader_for(blob), len(blob))
        tail = blob[-PORT.toc.FOOTER_SIZE:]
        assert PORT.toc.parse_footer(tail) == REF.toc.parse_footer(tail)
    else:
        ref = REF.sresolver.Blob("r", "sha256:" + "0" * 64, _reader_for(blob), len(blob)).toc()
        port = PORT.sresolver.Blob("r", "sha256:" + "0" * 64, _reader_for(blob), len(blob)).toc()
    assert port == ref and port["entries"]


def test_zstd_chunked_writer_equal(np_layers):
    assert PORT.toc.write_zstd_chunked(np_layers.files, chunk_size=FRAME_USIZE) == np_layers.chunked
    assert PORT.zframe.write_seekable(np_layers.tar, frame_usize=FRAME_USIZE) == np_layers.seekable
    assert PORT.zframe.write_frames(np_layers.tar, frame_usize=FRAME_USIZE) == np_layers.opaque


@pytest.mark.parametrize("kind", ["gzip_mm", "seekable", "chunked", "estargz"])
def test_adaptor_bootstraps_equal(tmp_path, np_layers, kind):
    """``SociAdaptor.prepare_meta_layer`` writes the same bootstrap in both
    packages, and the same persisted index where the route builds one."""
    blob = getattr(np_layers, kind)
    boots, caches = {}, {}
    for side in SIDES:
        boots[side], blob_id, _ = _prepare(PKG[side], tmp_path / side, blob, chunk_size=0x10000)
        cache = tmp_path / side / "cache"
        caches[side] = {p.name: p.read_bytes() for p in cache.iterdir()} if cache.exists() else {}
    assert boots["port"] == boots["ref"]
    assert caches["port"] == caches["ref"]
    assert (kind in ("gzip_mm", "seekable")) == bool(caches["port"])
    want = {"/" + k: v for k, v in np_layers.files.items()}
    assert _unpacked_files(PORT, boots["port"], blob_id, blob) == want


def _snap(ids):
    return type("Snap", (), {"parent_ids": ids})()


def test_adaptor_merge_equal(tmp_path, np_layers):
    """Four layers of four formats merge into the same ``image.boot``."""
    kinds = ["gzip_mm", "seekable", "chunked", "estargz"]
    groups = [{k: v for j, (k, v) in enumerate(np_layers.files.items()) if j % 4 == i} for i in range(4)]
    blobs = [gzip.compress(np_tar(groups[0]), 1, mtime=0),
             REF.zframe.write_seekable(np_tar(groups[1]), frame_usize=FRAME_USIZE),
             REF.toc.write_zstd_chunked(groups[2], chunk_size=FRAME_USIZE),
             build_estargz(groups[3])]
    merged = {}
    for side in SIDES:
        p = PKG[side]
        up = lambda sid, side=side: str(tmp_path / side / "snap" / sid / "fs")  # noqa: E731
        adaptor = p.adaptor.SociAdaptor(up, cache_dir=str(tmp_path / side / "cache"), chunk_size=0x10000)
        for i, blob in enumerate(blobs):
            digest = "sha256:" + hashlib.sha256(blob).hexdigest()
            adaptor.prepare_meta_layer(p.sresolver.Blob("ref", digest, _reader_for(blob), len(blob)),
                                       up(str(len(kinds) - i)))
        adaptor.merge_meta_layer(_snap([str(len(kinds) - i) for i in range(len(kinds))][::-1]))
        merged[side] = (tmp_path / side / "snap" / "1" / "fs" / "image.boot").read_bytes()
    assert merged["port"] == merged["ref"]
    bs = PORT.bootstrap.Bootstrap.from_bytes(merged["port"])
    assert len(bs.blobs) == len(kinds)


# ---------------------------------------------------------------------------
# Hypothesis: random ranges through both packages' indexed readers
# ---------------------------------------------------------------------------

_HYP = {}


def _hyp_readers():
    if not _HYP:
        files = np_tree(23, 60)
        tar = np_tar(files)
        step = -(-len(tar) // 3)
        gz = b"".join(gzip.compress(tar[i : i + step], 1, mtime=0) for i in range(0, len(tar), step))
        zs = REF.zframe.write_seekable(tar, frame_usize=16 << 10)
        readers = []
        for p in PKG.values():
            gidx, _ = p.blob.build_index_from_gzip(GBLOB_ID, gz, stride=64 << 10)
            zidx, _ = p.zblob.build_zindex_from_zstd(ZBLOB_ID, zs)
            readers += [p.blob.SociStreamReader(gidx, _reader_for(gz)),
                        p.zblob.ZstdStreamReader(zidx, _reader_for(zs))]
        _HYP.update(tar=tar, readers=readers)
    return _HYP["tar"], _HYP["readers"]


@settings(max_examples=60, deadline=None, derandomize=True,
          suppress_health_check=[HealthCheck.too_slow])
@given(st.floats(0, 1, exclude_max=True), st.integers(1, 200_000))
def test_random_ranges_both_readers_both_packages(frac, size):
    tar, readers = _hyp_readers()
    off = int(frac * len(tar))
    size = min(size, len(tar) - off)
    want = tar[off : off + size]
    for reader in readers:
        assert reader.read_range(off, size) == want


# ---------------------------------------------------------------------------
# Backward OCIRef reads through the indexes (ROADMAP Queue C)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("fmt", ["gzip", "zstd"])
def test_backward_ref_reads_fetch_one_span(np_layers, fmt):
    """A multi-member gzip ref layer and a seekable zstd ref layer, each
    packed by the port, read file by file in descending offsets through a
    ``BlobReader`` with the indexed reader mounted: the bytes are the
    tar's, and each read fetches (``ntpu_soci_compressed_fetch_bytes_total``)
    no more than its checkpoint span or covering frames, never the stream
    from its start. The sequential readers decode from far back."""
    tar = np_layers.tar
    opt = PORT.types.PackOption(chunk_size=0x10000, oci_ref=True)
    if fmt == "gzip":
        blob = np_layers.gzip_mm
        bs = PORT.czran.pack_gzip_layer(blob, opt)
        idx, _ = PORT.blob.build_index_from_gzip(GBLOB_ID, blob, stride=64 << 10)
        reader = PORT.blob.SociStreamReader(idx, _reader_for(blob))
    else:
        blob = np_layers.seekable
        bs = PORT.zstd_ref.pack_zstd_layer(blob, opt)
        idx, _ = PORT.zblob.build_zindex_from_zstd(ZBLOB_ID, blob)
        reader = PORT.zblob.ZstdStreamReader(idx, _reader_for(blob))
    br = PORT.convert.BlobReader(bs, 0, _reader_for(blob))
    getattr(br, f"mount_{fmt}_stream")(reader)
    regs = sorted((i for i in bs.inodes if i.chunk_count),
                  key=lambda i: -bs.chunks[i.chunk_index].uncompressed_offset)
    assert len(regs) == len(np_layers.files)
    fetch = PORT.blob.FETCH_BYTES
    ref_fetch = REF.blob.FETCH_BYTES.value()
    # the index's stride: the widest compressed span between two
    # checkpoints, or the largest frame; the first resume point past 0
    if fmt == "gzip":
        cuts = [0] + [cp.cin for cp in idx.checkpoints] + [len(blob)]
        widest = max(b - a for a, b in zip(cuts, cuts[1:])) + 1
        first_step = idx.checkpoints[0].uout
    else:
        widest = max(f.csize for f in idx.frames)
        first_step = idx.frames[1].uout
    for ino in regs:
        recs = bs.chunks[ino.chunk_index : ino.chunk_index + ino.chunk_count]
        lo = recs[0].uncompressed_offset
        before = fetch.value()
        assert b"".join(br.chunk_data(c) for c in recs) == tar[lo : lo + ino.size]
        got = fetch.value() - before
        bound = 0
        for c in recs:  # the checkpoint span, or the covering frames, of each chunk
            span, start, end = idx.resolve(c.uncompressed_offset, c.uncompressed_size)
            bound += end - start + 1 if fmt == "gzip" else sum(f.csize for f in span)
            if c.uncompressed_offset >= first_step:
                assert start > 0, (ino.path, "decoded from the stream's start")
        assert 0 < got <= bound <= len(recs) * 2 * widest, (ino.path, got, bound, widest)
    assert REF.blob.FETCH_BYTES.value() == ref_fetch
    # the sequential reader of the same layer decodes from a checkpoint or
    # from the stream's start: the last (lowest) file costs far more
    seq = PORT.convert.BlobReader(bs, 0, _reader_for(blob))
    pulled = []
    seq.read_at = lambda o, s: (pulled.append(s), blob[o : o + s])[1]
    for ino in regs[:2][::-1] + regs[-1:]:
        recs = bs.chunks[ino.chunk_index : ino.chunk_index + ino.chunk_count]
        lo = recs[0].uncompressed_offset
        assert b"".join(seq.chunk_data(c) for c in recs) == tar[lo : lo + ino.size]
    assert sum(pulled) >= len(blob) / 2


# ---------------------------------------------------------------------------
# The readers over the blob cache, the index artifacts over the peer tier,
# the cache manager's companions (test_soci_backend.TestPrefetchFromIndex,
# TestFullStackIdentity, TestPeerReplication, TestChaos; test_soci_formats
# TestZstdIndexPersistence, TestPeerReplication, TestChaos)
# ---------------------------------------------------------------------------

CONFIG_MATRIX = [(1, 0, 0), (4, 0, 0), (4, 64 << 10, 256 << 10), (2, 128 << 10, 1 << 20)]


def _cached_blob(pkg, tmp_path, blob, blob_id, tag, workers, gap=0, ra=0):
    return pkg.blobcache.CachedBlob(
        os.path.join(str(tmp_path), tag),
        blob_id,
        _reader_for(blob),
        blob_size=len(blob),
        config=pkg.fetch_sched.FetchConfig(fetch_workers=workers, merge_gap=gap, readahead=ra),
    )


@pytest.fixture()
def peer_server(pkg):
    export = pkg.peer.PeerExport()
    server = pkg.peer.PeerChunkServer(export, pull_through=False)
    sock = os.path.join(tempfile.mkdtemp(prefix="p", dir="/tmp"), "peer.sock")
    server.run(sock)
    yield export, server, sock
    server.stop()
    shutil.rmtree(os.path.dirname(sock), ignore_errors=True)


class TestOverCachedBlob:
    def test_warm_ranges_through_cached_blob_at_prefetch_lane(self, pkg, tmp_path, glayer):
        raw, gz, contents = glayer
        idx, _ = pkg.blob.build_index_from_gzip(GBLOB_ID, gz, stride=STRIDE)
        cb = _cached_blob(pkg, tmp_path, gz, GBLOB_ID, "pf", 2)
        try:
            paths = [f"/usr/lib/f{i:04d}.so" for i in range(0, 40, 5)]
            warms, missing = pkg.blob.warm_list_from_index(idx, paths)
            assert not missing
            for _path, c0, c1 in warms:
                for f in cb.warm(c0, c1 - c0):  # PREFETCH lane inside
                    assert f.wait(10)
                    assert f.error is None
            calls = []
            reader = pkg.blob.SociStreamReader(
                idx, lambda o, s: (calls.append((o, s)), cb.read_at(o, s))[1]
            )
            for p in paths:
                uoff, usize = idx.file_extent(p)
                assert reader.read_range(uoff, usize) == contents[p]
            for off, size in calls:
                assert cb.covered(off, size)  # cache-resident, pre-warmed
        finally:
            cb.close()

    @pytest.mark.parametrize("workers,gap,ra", CONFIG_MATRIX)
    def test_byte_identity_property(self, pkg, tmp_path, glayer, workers, gap, ra):
        raw, gz, contents = glayer
        idx, _ = pkg.blob.build_index_from_gzip(GBLOB_ID, gz, stride=STRIDE)
        cb = _cached_blob(pkg, tmp_path, gz, GBLOB_ID, f"w{workers}g{gap}r{ra}", workers, gap, ra)
        try:
            reader = pkg.blob.SociStreamReader(idx, cb.read_at)
            with tarfile.open(fileobj=io.BytesIO(raw)) as tf:
                for m in tf.getmembers()[::7]:
                    if not m.isreg():
                        continue
                    off, size = idx.files["/" + m.name]
                    assert reader.read_range(off, size) == contents["/" + m.name]
            rng = random.Random(workers)
            for _ in range(10):
                off = rng.randrange(0, len(raw) - 1)
                size = rng.randrange(1, min(150_000, len(raw) - off))
                assert reader.read_range(off, size) == raw[off : off + size]
        finally:
            cb.close()

    def test_concurrent_readers_lock_free_cached_blob(self, pkg, tmp_path, glayer):
        """test_soci_backend's case as written: four threads share one
        reader over one ``CachedBlob``."""
        raw, gz, _ = glayer
        idx, _ = pkg.blob.build_index_from_gzip(GBLOB_ID, gz, stride=STRIDE)
        cb = _cached_blob(pkg, tmp_path, gz, GBLOB_ID, "conc", 4)
        reader = pkg.blob.SociStreamReader(idx, cb.read_at)
        assert reader.concurrent
        errors = []

        def worker(seed):
            rng = random.Random(seed)
            try:
                for _ in range(12):
                    off = rng.randrange(0, len(raw) - 1)
                    size = rng.randrange(1, min(100_000, len(raw) - off))
                    assert reader.read_range(off, size) == raw[off : off + size]
            except BaseException as e:  # noqa: BLE001
                errors.append(e)

        threads = [threading.Thread(target=worker, args=(i,)) for i in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        cb.close()
        assert not errors, errors

    def test_eviction_while_reading_indexed_layer(self, pkg, tmp_path, glayer):
        """A watermark eviction unlinking the blob's cache files (and the
        index companion) under a live indexed reader never gives wrong
        bytes: the ``CachedBlob`` revalidates and re-fetches."""
        raw, gz, _ = glayer
        idx, _ = pkg.blob.build_index_from_gzip(GBLOB_ID, gz, stride=STRIDE)
        cb = _cached_blob(pkg, tmp_path, gz, GBLOB_ID, "evict", 2)
        reader = pkg.blob.SociStreamReader(idx, cb.read_at)
        rng = random.Random(3)
        for i in range(15):
            if i % 5 == 2:
                for sfx in (".blob.data", ".chunk_map", ".soci.idx"):
                    try:
                        os.unlink(os.path.join(str(tmp_path), "evict", GBLOB_ID + sfx))
                    except FileNotFoundError:
                        pass
            off = rng.randrange(0, len(raw) - 1)
            size = rng.randrange(1, min(100_000, len(raw) - off))
            assert reader.read_range(off, size) == raw[off : off + size]
        cb.close()

    def test_fetch_site_fails_read_then_recovers_cached_blob(self, pkg, tmp_path, glayer):
        raw, gz, _ = glayer
        idx, _ = pkg.blob.build_index_from_gzip(GBLOB_ID, gz, stride=STRIDE)
        cb = _cached_blob(pkg, tmp_path, gz, GBLOB_ID, "chaos", 2)
        reader = pkg.blob.SociStreamReader(idx, cb.read_at)
        with pkg.failpoint.injected("soci.fetch", "error(OSError)*1"):
            with pytest.raises(OSError):
                reader.read_range(0, 1000)
        assert reader.read_range(0, 1000) == raw[:1000]
        cb.close()

    def test_zstd_fetch_site_fails_read_then_recovers_cached_blob(self, pkg, tmp_path, zlayer, seekable):
        idx, _ = pkg.zblob.build_zindex_from_zstd(ZBLOB_ID, seekable)
        cb = pkg.blobcache.CachedBlob(
            os.path.join(str(tmp_path), "chaos"), ZBLOB_ID, _reader_for(seekable),
            blob_size=len(seekable), config=pkg.fetch_sched.FetchConfig(fetch_workers=2),
        )
        reader = pkg.zblob.ZstdStreamReader(idx, cb.read_at)
        with pkg.failpoint.injected("soci.fetch", "error(OSError)*1"):
            with pytest.raises(OSError):
                reader.read_range(0, 1000)
        assert reader.read_range(0, 1000) == zlayer[0][:1000]
        cb.close()

    @pytest.mark.parametrize("suffix", [".soci.idx", ".soci.zidx"])
    def test_cache_manager_accounts_companion(self, pkg, tmp_path, suffix):
        """test_cache_manager_accounts_{index,zidx}_companion."""
        mgr = pkg.cache_manager.CacheManager(str(tmp_path / "cache"))
        for sfx in ("", ".blob.data", suffix):
            with open(os.path.join(mgr.cache_dir, "aa" * 32 + sfx), "wb") as f:
                f.write(b"x" * 10)
        assert mgr.cache_usage("aa" * 32).inodes == 3
        mgr.remove_blob_cache("aa" * 32)
        assert mgr.cache_usage("aa" * 32).inodes == 0


class TestPeerReplication:
    def test_index_replicates_from_owner(self, pkg, tmp_path, glayer, peer_server):
        _, gz, _ = glayer
        export, _server, sock = peer_server
        idx, _ = pkg.blob.build_index_from_gzip(GBLOB_ID, gz, stride=STRIDE)
        path = pkg.index.index_path(os.path.join(str(tmp_path), "owner"), GBLOB_ID)
        idx.save(path)
        export.register_soci(GBLOB_ID, path)
        local_dir = os.path.join(str(tmp_path), "local")
        os.makedirs(local_dir)
        got, outcome = pkg.blob.load_or_build_index(
            [local_dir], GBLOB_ID, csize=len(gz),
            fetch_remote=lambda: pkg.peer.PeerClient(sock).fetch_soci_index(GBLOB_ID),
        )
        assert outcome == "replicated"
        assert len(got.checkpoints) == len(idx.checkpoints)
        _, outcome2 = pkg.blob.load_or_build_index([local_dir], GBLOB_ID, csize=len(gz))
        assert outcome2 == "loaded"

    def test_corrupt_replica_falls_back_to_build(self, pkg, tmp_path, glayer, peer_server):
        raw, gz, _ = glayer
        export, _server, sock = peer_server
        idx, _ = pkg.blob.build_index_from_gzip(GBLOB_ID, gz, stride=STRIDE)
        path = pkg.index.index_path(os.path.join(str(tmp_path), "owner"), GBLOB_ID)
        idx.save(path)
        blob = bytearray(open(path, "rb").read())
        blob[len(blob) // 2] ^= 0xFF  # the owner's artifact is corrupt
        open(path, "wb").write(bytes(blob))
        export.register_soci(GBLOB_ID, path)
        local_dir = os.path.join(str(tmp_path), "local")
        os.makedirs(local_dir)
        builds = []

        def builder():
            builds.append(1)
            return gz

        got, outcome = pkg.blob.load_or_build_index(
            [local_dir], GBLOB_ID, csize=len(gz),
            fetch_remote=lambda: pkg.peer.PeerClient(sock).fetch_soci_index(GBLOB_ID),
            builder=builder, stride=STRIDE,
        )
        assert outcome == "built" and len(builds) == 1
        reader = pkg.blob.SociStreamReader(got, _reader_for(gz))
        assert reader.read_range(500, 4000) == raw[500:4500]

    def test_peer_miss_walks_to_builder(self, pkg, tmp_path, glayer, peer_server):
        _, gz, _ = glayer
        _export, _server, sock = peer_server  # nothing registered
        local_dir = os.path.join(str(tmp_path), "local")
        os.makedirs(local_dir)
        got, outcome = pkg.blob.load_or_build_index(
            [local_dir], GBLOB_ID, csize=len(gz),
            fetch_remote=lambda: pkg.peer.PeerClient(sock).fetch_soci_index(GBLOB_ID),
            builder=lambda: gz, stride=STRIDE,
        )
        assert outcome == "built" and got is not None

    def test_zindex_replicates_from_owner(self, pkg, tmp_path, seekable, peer_server):
        export, _server, sock = peer_server
        idx, _ = pkg.zblob.build_zindex_from_zstd(ZBLOB_ID, seekable)
        path = pkg.zindex.zindex_path(os.path.join(str(tmp_path), "owner"), ZBLOB_ID)
        idx.save(path)
        export.register_artifact(pkg.zblob.ZSOCI_ARTIFACT_KIND, ZBLOB_ID, path)
        local_dir = os.path.join(str(tmp_path), "local")
        os.makedirs(local_dir)
        got, outcome = pkg.zblob.load_or_build_zindex(
            [local_dir], ZBLOB_ID, csize=len(seekable),
            fetch_remote=lambda: pkg.peer.PeerClient(sock).fetch_artifact(
                pkg.zblob.ZSOCI_ARTIFACT_KIND, ZBLOB_ID),
        )
        assert outcome == "replicated"
        assert len(got.frames) == len(idx.frames)
        _, outcome2 = pkg.zblob.load_or_build_zindex([local_dir], ZBLOB_ID, csize=len(seekable))
        assert outcome2 == "loaded"

    def test_zindex_corrupt_replica_falls_back_to_build(self, pkg, tmp_path, zlayer, seekable, peer_server):
        raw = zlayer[0]
        export, _server, sock = peer_server
        idx, _ = pkg.zblob.build_zindex_from_zstd(ZBLOB_ID, seekable)
        path = pkg.zindex.zindex_path(os.path.join(str(tmp_path), "owner"), ZBLOB_ID)
        idx.save(path)
        blob = bytearray(open(path, "rb").read())
        blob[len(blob) // 2] ^= 0xFF  # the owner's artifact is corrupt
        open(path, "wb").write(bytes(blob))
        export.register_artifact(pkg.zblob.ZSOCI_ARTIFACT_KIND, ZBLOB_ID, path)
        local_dir = os.path.join(str(tmp_path), "local")
        os.makedirs(local_dir)
        builds = []

        def builder():
            builds.append(1)
            return seekable

        got, outcome = pkg.zblob.load_or_build_zindex(
            [local_dir], ZBLOB_ID, csize=len(seekable),
            fetch_remote=lambda: pkg.peer.PeerClient(sock).fetch_artifact(
                pkg.zblob.ZSOCI_ARTIFACT_KIND, ZBLOB_ID),
            builder=builder,
        )
        assert outcome == "built" and len(builds) == 1
        reader = pkg.zblob.ZstdStreamReader(got, _reader_for(seekable))
        assert reader.read_range(500, 4000) == raw[500:4500]

    def test_artifacts_cross_packages(self, pkg, tmp_path, glayer, seekable, peer_server):
        """The other package's client replicates both index artifacts from
        this package's server: same bytes, same outcome."""
        other = _other(pkg)
        export, _server, sock = peer_server
        _, gz, _ = glayer
        gidx, _ = pkg.blob.build_index_from_gzip(GBLOB_ID, gz, stride=STRIDE)
        gpath = pkg.index.index_path(os.path.join(str(tmp_path), "owner"), GBLOB_ID)
        gidx.save(gpath)
        export.register_soci(GBLOB_ID, gpath)
        zidx, _ = pkg.zblob.build_zindex_from_zstd(ZBLOB_ID, seekable)
        zpath = pkg.zindex.zindex_path(os.path.join(str(tmp_path), "owner"), ZBLOB_ID)
        zidx.save(zpath)
        export.register_artifact(pkg.zblob.ZSOCI_ARTIFACT_KIND, ZBLOB_ID, zpath)
        client = other.peer.PeerClient(sock)
        assert client.fetch_soci_index(GBLOB_ID) == open(gpath, "rb").read()
        assert client.fetch_artifact(other.zblob.ZSOCI_ARTIFACT_KIND, ZBLOB_ID) == open(zpath, "rb").read()
        local_dir = os.path.join(str(tmp_path), "local")
        os.makedirs(local_dir)
        got, outcome = other.blob.load_or_build_index(
            [local_dir], GBLOB_ID, csize=len(gz), fetch_remote=lambda: client.fetch_soci_index(GBLOB_ID))
        assert outcome == "replicated" and len(got.checkpoints) == len(gidx.checkpoints)
