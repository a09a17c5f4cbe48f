"""The port's blob cache against the JAX package's: ``CachedBlob`` over the
fetch scheduler (singleflight, coalescing, readahead, the batched chunk
map), watermark eviction, prefetch replay, ``RegistryBlobFetcher``'s host
health and ``Retry-After``, the ``blobcache.*`` failpoint sites and the
config resolution.

Every case of tests/test_blobcache_sched.py runs in both packages
(``pkg``, through ``ported_cases``: the reference's own bodies, sizes and
tolerances), and the other package's counters must not move in any of
them. Cross-package cases, on numpy-seeded blobs:

- a cache dir (``<blob_id>.blob.data`` + ``.chunk_map`` of ``<QI``
  records, the last one torn) written by one package's ``CachedBlob`` and
  loaded by the other's: the same intervals, nothing covered re-fetched;
- a hypothesis case: random read sequences through both packages'
  ``CachedBlob`` over one deterministic ``fetch_range`` give the same
  bytes and fetch the same intervals.
"""

from __future__ import annotations

import importlib
import struct
import threading

import numpy as np
import pytest
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from tests.test_torch_fetch_sched import ROOTS, SIDES, other_package_still, ported_cases

ported_cases("test_blobcache_sched", globals())
_other_package_still = other_package_still()

_RECORD = struct.Struct("<QI")


def _mods(side: str):
    root = ROOTS[side]
    return (
        importlib.import_module(f"{root}.daemon.blobcache"),
        importlib.import_module(f"{root}.daemon.fetch_sched"),
    )


def _np_blob(n: int, seed: int) -> bytes:
    return np.random.default_rng(seed).integers(0, 256, n, dtype=np.uint8).tobytes()


class _Origin:
    """A deterministic ``fetch_range`` that records every ranged GET."""

    def __init__(self, blob: bytes):
        self.blob = blob
        self.calls: list[tuple[int, int]] = []
        self._lock = threading.Lock()

    def __call__(self, off: int, size: int) -> bytes:
        with self._lock:
            self.calls.append((off, size))
        return self.blob[off : off + size]


def _cached(side, cache_dir, blob_id, origin, workers=2, gap=0, ra=0):
    blobcache, fs = _mods(side)
    return blobcache.CachedBlob(
        str(cache_dir), blob_id, origin, blob_size=len(origin.blob),
        config=fs.FetchConfig(fetch_workers=workers, merge_gap=gap, readahead=ra),
    )


@pytest.mark.parametrize("writer,loader", [("ref", "port"), ("port", "ref")])
def test_cache_dir_loads_across_packages(tmp_path, writer, loader):
    """One package writes the cache files, its last chunk-map record torn;
    the other loads them: the intervals are the writer's minus the torn
    record, the covered extents read with no fetch, the torn one re-fetches."""
    blob = _np_blob(300_000, 21)
    rng = np.random.default_rng(5)
    blob_id = "c1" * 32
    extents = []
    for _ in range(6):
        off = int(rng.integers(0, len(blob) - 20_000))
        extents.append((off, int(rng.integers(1, 20_000))))
    cb = _cached(writer, tmp_path, blob_id, _Origin(blob))
    for off, size in extents:
        assert cb.read_at(off, size) == blob[off : off + size]
    written = cb._intervals.spans()
    cb.close()
    map_path = tmp_path / f"{blob_id}.chunk_map"
    raw = map_path.read_bytes()
    assert len(raw) % _RECORD.size == 0
    records = [_RECORD.unpack_from(raw, i) for i in range(0, len(raw), _RECORD.size)]
    map_path.write_bytes(raw[:-_RECORD.size] + raw[-_RECORD.size : -_RECORD.size + 5])
    torn_off, torn_size = records[-1]

    fs_writer = _mods(writer)[1]
    want = fs_writer.IntervalSet()
    for off, size in records[:-1]:
        want.add(off, off + size)
    origin = _Origin(blob)
    cb2 = _cached(loader, tmp_path, blob_id, origin)
    assert cb2._intervals.spans() == want.spans()
    assert all(any(s <= a and b <= e for s, e in written) for a, b in want.spans())
    for off, size in records[:-1]:
        assert cb2.read_at(off, size) == blob[off : off + size]
    assert origin.calls == []
    assert cb2.read_at(torn_off, torn_size) == blob[torn_off : torn_off + torn_size]
    assert origin.calls and all(want.missing(o, o + s) for o, s in origin.calls)
    cb2.close()


_READS = st.lists(st.tuples(st.integers(0, 199_999), st.integers(1, 30_000)), min_size=1, max_size=12)


@settings(max_examples=25, deadline=None, suppress_health_check=[HealthCheck.function_scoped_fixture, HealthCheck.too_slow])
@given(reads=_READS, workers=st.sampled_from([1, 2, 4]), gap=st.sampled_from([0, 4096, 64 << 10]))
def test_random_reads_same_bytes_and_fetches(tmp_path_factory, reads, workers, gap):
    blob = _np_blob(200_000, 33)
    got = {}
    for side in SIDES:
        origin = _Origin(blob)
        cb = _cached(side, tmp_path_factory.mktemp(side), "d2" * 32, origin, workers, gap)
        out = []
        for off, size in reads:
            size = min(size, len(blob) - off)
            out.append(cb.read_at(off, size))
            assert out[-1] == blob[off : off + size]
        spans = cb._intervals.spans()
        cb.close()
        got[side] = (out, sorted(origin.calls), spans)
    assert got["ref"] == got["port"]
