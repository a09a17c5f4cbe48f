"""The port's cache manager against the JAX package's: usage accounting of
a blob and its companions (``.blob.data``, ``.chunk_map``, ``.blob.meta``,
``.image.disk``, ``.layer.disk``, the ``.soci.idx``/``.soci.zidx``
indexes and the ``.heat`` artifact), whole-entry removal, age GC, and
least-recently-accessed watermark eviction with its protect set, the
``blobcache.evict`` failpoint site and the ``ntpu_blobcache_evicted_*``
counters.

The reference exercises the cache manager in tests/test_blobcache_sched.py
(``TestEviction``, in tests/test_torch_blobcache.py) and in the soci files
(``test_cache_manager_accounts_{index,zidx}_companion``, in
tests/test_torch_soci.py). This file holds the cross-package cases: both
packages' managers over copies of one numpy-seeded cache dir (sizes and
access times drawn from a seed) give equal usage, equal age-GC and
watermark removals, and each counts the eviction on its own registry only;
a ``CachedBlob`` of either package survives the other's eviction. One
case pins, in both packages, that an eviction goes unseen where an open,
unlinked file keeps its link count.
"""

from __future__ import annotations

import importlib
import os
import threading
import time

import numpy as np
import pytest

from tests.test_torch_fetch_sched import ROOTS, SIDES

SUFFIXES = ("", ".blob.data", ".chunk_map", ".blob.meta", ".image.disk", ".layer.disk",
            ".soci.idx", ".soci.zidx", ".heat")


def _cm(side: str):
    return importlib.import_module(f"{ROOTS[side]}.cache.manager")


def _fs(side: str):
    return importlib.import_module(f"{ROOTS[side]}.daemon.fetch_sched")


def _copies(tmp_path, seed):
    """One cache dir per package holding the same entries: random
    companions, sizes and access times. Returns the dirs and each entry's
    newest access time."""
    rng = np.random.default_rng(seed)
    now = time.time()
    files = []
    for i in range(24):
        bid = f"{i:02x}" * 32
        picks = [s for s in SUFFIXES if rng.integers(0, 3)] or [".blob.data"]
        for sfx in picks:
            atime = now - float(rng.integers(0, 10_000)) - i * 0.5
            files.append((bid + sfx, int(rng.integers(0, 50_000)), atime))
    dirs = {}
    for side in SIDES:
        dirs[side] = str(tmp_path / side)
        os.makedirs(dirs[side])
        for name, size, atime in files:
            p = os.path.join(dirs[side], name)
            with open(p, "wb") as f:
                f.write(b"x" * size)
            os.utime(p, (atime, atime))
    newest = {}
    for name, _size, atime in files:
        bid = name[:64]
        newest[bid] = max(newest.get(bid, 0.0), atime)
    return dirs, newest


def _names(paths, root):
    return sorted(os.path.relpath(p, root) for p in paths)


@pytest.mark.parametrize("seed", [1, 2])
def test_usage_equal(tmp_path, seed):
    dirs, newest = _copies(tmp_path, seed)
    mgrs = {side: _cm(side).CacheManager(dirs[side]) for side in SIDES}
    ref, port = mgrs["ref"], mgrs["port"]
    tot_r, tot_p = ref.total_usage(), port.total_usage()
    assert (tot_r.size, tot_r.inodes) == (tot_p.size, tot_p.inodes)
    for bid in newest:
        r, p = ref.cache_usage(bid), port.cache_usage(bid)
        assert (r.size, r.inodes) == (p.size, p.inodes)
    victim = sorted(newest)[3]
    for m in mgrs.values():
        m.remove_blob_cache(victim)
        assert m.cache_usage(victim).inodes == 0
    assert sorted(os.listdir(dirs["ref"])) == sorted(os.listdir(dirs["port"]))


@pytest.mark.parametrize("seed", [3, 4])
def test_age_gc_equal(tmp_path, seed):
    dirs, _ = _copies(tmp_path, seed)
    removed = {side: _names(_cm(side).CacheManager(dirs[side]).gc_once(800), dirs[side]) for side in SIDES}
    assert removed["ref"] == removed["port"] and removed["ref"]
    assert sorted(os.listdir(dirs["ref"])) == sorted(os.listdir(dirs["port"])) != []


@pytest.mark.parametrize("seed", [5, 6, 7])
def test_watermark_eviction_equal_and_counted_apart(tmp_path, seed):
    dirs, newest = _copies(tmp_path, seed)
    protect = {sorted(newest, key=newest.get)[0]}  # the oldest entry stays
    removed = {}
    for side in SIDES:
        mgr = _cm(side).CacheManager(dirs[side])
        limit = mgr.total_usage().size // 2
        other = _fs(SIDES[1 - SIDES.index(side)])
        before_other = (other.EVICTED_BYTES.value(), other.EVICTED_ENTRIES.value())
        fs = _fs(side)
        before = (fs.EVICTED_BYTES.value(), fs.EVICTED_ENTRIES.value())
        removed[side] = _names(mgr.gc_watermark(limit, protect=protect), dirs[side])
        assert mgr.total_usage().size <= limit
        entries = {n[:64] for n in removed[side]}
        assert fs.EVICTED_ENTRIES.value() - before[1] == len(entries)
        assert fs.EVICTED_BYTES.value() > before[0]
        assert (other.EVICTED_BYTES.value(), other.EVICTED_ENTRIES.value()) == before_other
        assert not protect & entries
    assert removed["ref"] == removed["port"]


@pytest.mark.parametrize("evictor,reader", [("ref", "port"), ("port", "ref")])
def test_eviction_under_other_package_cached_blob(tmp_path, evictor, reader):
    """One package's watermark eviction removes a live ``CachedBlob`` of the
    other package; its next reads re-fetch and stay equal."""
    blob = np.random.default_rng(12).integers(0, 256, 400_000, dtype=np.uint8).tobytes()
    calls = []
    lock = threading.Lock()

    def fetch(off, size):
        with lock:
            calls.append((off, size))
        return blob[off : off + size]

    blobcache = importlib.import_module(f"{ROOTS[reader]}.daemon.blobcache")
    cb = blobcache.CachedBlob(str(tmp_path), "5c" * 32, fetch, blob_size=len(blob),
                              config=_fs(reader).FetchConfig(fetch_workers=2, merge_gap=0, readahead=0))
    try:
        assert cb.read_at(0, 200_000) == blob[:200_000]
        removed = _cm(evictor).CacheManager(str(tmp_path)).gc_watermark(1)
        assert any(p.endswith(".blob.data") for p in removed)
        n = len(calls)
        assert cb.read_at(1000, 50_000) == blob[1000:51_000]
        assert len(calls) > n
        assert cb.read_at(300_000, 50_000) == blob[300_000:350_000]
    finally:
        cb.close()


@pytest.mark.parametrize("side", SIDES)
def test_eviction_unseen_where_unlinked_file_keeps_its_link(tmp_path, monkeypatch, side):
    """Both packages notice an eviction through ``fstat(fd).st_nlink == 0``.
    A filesystem that reports an open, unlinked file with a link count of 1
    (9p, the card machine's root) hides it: the ``CachedBlob`` goes on
    serving the evicted bytes from its open file, equal, and fetches
    nothing; the evicted files stay gone. Pinned in both packages
    (ROADMAP.md Queue C)."""
    real_fstat = os.fstat

    def fstat_9p(fd):
        st = real_fstat(fd)
        return os.stat_result((st.st_mode, st.st_ino, st.st_dev, max(1, st.st_nlink)) + tuple(st)[4:])

    blob = np.random.default_rng(13).integers(0, 256, 300_000, dtype=np.uint8).tobytes()
    calls = []
    blobcache = importlib.import_module(f"{ROOTS[side]}.daemon.blobcache")
    cb = blobcache.CachedBlob(str(tmp_path), "9f" * 32, lambda o, n: (calls.append(o), blob[o:o + n])[1],
                              blob_size=len(blob),
                              config=_fs(side).FetchConfig(fetch_workers=1, merge_gap=0, readahead=0))
    try:
        assert cb.read_at(0, 100_000) == blob[:100_000]
        monkeypatch.setattr(os, "fstat", fstat_9p)
        assert _cm(side).CacheManager(str(tmp_path)).gc_watermark(1)
        n = len(calls)
        assert cb.read_at(10, 50_000) == blob[10:50_010]
        assert len(calls) == n  # the eviction went unseen: nothing re-fetched
        assert not os.path.exists(tmp_path / ("9f" * 32 + ".blob.data"))
    finally:
        monkeypatch.undo()
        cb.close()
